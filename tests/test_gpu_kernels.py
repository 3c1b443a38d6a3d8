"""The Triton kernels compiled for the card (no interpret mode) against the
plain references at small shapes. Marked `gpu`: they skip without a card.
chip_smoke.py repeats these comparisons at the presets' real widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poi_tpu.ops import online_lse as ol
from poi_tpu.ops.topk import chunked_topk, xla_topk

pytestmark = pytest.mark.gpu


def _ref(q, t, b, rid=None, cid=None):
    qb = q.astype(jnp.bfloat16).astype(jnp.float32)
    tb = t.astype(jnp.bfloat16).astype(jnp.float32)
    with jax.default_matmul_precision("highest"):
        s = qb @ tb.T + b
    if rid is not None:
        s = jnp.where(rid[:, None] == cid[None, :], ol.NEG, s)
    return jax.nn.logsumexp(s, axis=1)


@pytest.mark.parametrize("n,v,d,exclude", [(1000, 3000, 128, False), (777, 1024, 256, True), (512, 4096, 512, True)])
def test_online_lse_on_card_matches_reference(gpu, n, v, d, exclude):
    rng = np.random.default_rng(n)
    q = jnp.asarray(rng.normal(size=(n, d)) * 0.3, jnp.float32)
    t = jnp.asarray(rng.normal(size=(v, d)) * 0.3, jnp.float32)
    b = jnp.asarray(rng.normal(size=(v,)) * 0.1, jnp.float32)
    rid = cid = None
    if exclude:
        rid = jnp.asarray(rng.integers(0, 64, n), jnp.int32)
        cid = jnp.asarray(rng.integers(0, 64, v), jnp.int32)
    w = jnp.asarray(rng.normal(size=(n,)), jnp.float32)
    val_k, g_k = jax.jit(jax.value_and_grad(lambda *a: jnp.sum(w * ol.online_lse(*a, rid, cid)), argnums=(0, 1, 2)))(q, t, b)
    val_r, g_r = jax.jit(jax.value_and_grad(lambda *a: jnp.sum(w * _ref(*a, rid, cid)), argnums=(0, 1, 2)))(q, t, b)
    np.testing.assert_allclose(
        np.asarray(jax.jit(lambda *a: ol.online_lse(*a, rid, cid))(q, t, b)), np.asarray(_ref(q, t, b, rid, cid)), atol=2e-3
    )
    for a, r in zip(g_k, g_r):
        assert float(jnp.linalg.norm(a - r) / jnp.linalg.norm(r)) < 1e-2


def test_chunked_topk_on_card_matches_oracle(gpu):
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(64, 128)), jnp.float32)
    t = jnp.asarray(rng.normal(size=(50000, 128)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(50000,)), jnp.float32)
    vals, ids = jax.jit(chunked_topk, static_argnums=(3, 4))(q, t, b, 10, 4096)
    rv, rid = jax.jit(xla_topk, static_argnums=3)(q, t, b, 11)
    clear = np.asarray(rv[:, 9] - rv[:, 10] > 1e-3)
    same = np.array([set(a) == set(r) for a, r in zip(np.asarray(ids), np.asarray(rid[:, :10]))])
    assert clear.any() and not (clear & ~same).any()

"""The streamed log-sum-exp kernel (ops/online_lse.py) in Pallas interpret
mode vs a plain jax.numpy reference: values and gradients, ragged rows and
columns, widths that need padding, the exclusion mask, NEG-biased columns,
and the split dtable launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poi_tpu.ops import online_lse as ol


def _ref(q, t, b, rid=None, cid=None):
    """Reference on the same bf16-rounded operands, fp32 products."""
    qb = q.astype(jnp.bfloat16).astype(jnp.float32)
    tb = t.astype(jnp.bfloat16).astype(jnp.float32)
    with jax.default_matmul_precision("highest"):
        s = qb @ tb.T + b
    if rid is not None:
        s = jnp.where(rid[:, None] == cid[None, :], ol.NEG, s)
    return jax.nn.logsumexp(s, axis=1)


def _case(n, v, d, exclude, seed):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(n, d)) * 0.4, jnp.float32)
    t = jnp.asarray(rng.normal(size=(v, d)) * 0.4, jnp.float32)
    b = jnp.asarray(rng.normal(size=(v,)) * 0.2, jnp.float32)
    ids = None, None
    if exclude:
        ids = (jnp.asarray(rng.integers(0, 40, n), jnp.int32), jnp.asarray(rng.integers(0, 40, v), jnp.int32))
    w = jnp.asarray(rng.normal(size=(n,)), jnp.float32)
    return q, t, b, ids, w


def _rel(a, b):
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


# (N, V, D, exclude): ragged N and V, D below / at / above the padded width.
SHAPES = [
    (37, 300, 24, False),
    (130, 200, 64, True),
    (64, 128, 128, False),
    (70, 517, 256, True),
    (33, 130, 512, False),
    (5, 1000, 16, True),
]


@pytest.mark.parametrize("n,v,d,exclude", SHAPES)
def test_value_matches_reference(n, v, d, exclude):
    q, t, b, (rid, cid), _ = _case(n, v, d, exclude, seed=n + v)
    got = ol.online_lse(q, t, b, rid, cid, True)
    want = _ref(q, t, b, rid, cid)
    assert got.shape == (n,) and got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("n,v,d,exclude", SHAPES[:4])
def test_grads_match_reference(n, v, d, exclude):
    q, t, b, (rid, cid), w = _case(n, v, d, exclude, seed=n * v)
    g_k = jax.grad(lambda *a: jnp.sum(w * ol.online_lse(*a, rid, cid, True)), argnums=(0, 1, 2))(q, t, b)
    g_r = jax.grad(lambda *a: jnp.sum(w * _ref(*a, rid, cid)), argnums=(0, 1, 2))(q, t, b)
    for a, r, name in zip(g_k, g_r, ("dq", "dtable", "dbias")):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        # The kernels round softmax weights to bf16 before the products.
        assert _rel(a, r) < 1e-2, (name, _rel(a, r))


def test_neg_bias_columns_are_inert():
    """-1e30-biased columns (vocab padding) change neither value nor any
    gradient, and get exactly zero table gradient."""
    q, t, b, _, w = _case(40, 96, 32, False, seed=3)
    tp = jnp.pad(t, ((0, 32), (0, 0)), constant_values=0.7)
    bp = jnp.pad(b, (0, 32), constant_values=ol.NEG)
    np.testing.assert_allclose(
        np.asarray(ol.online_lse(q, tp, bp, interpret=True)), np.asarray(_ref(q, t, b)), atol=2e-5
    )
    g = jax.grad(lambda t_: jnp.sum(w * ol.online_lse(q, t_, bp, interpret=True)))(tp)
    assert float(jnp.abs(g[96:]).max()) == 0.0


def test_excluded_columns_get_no_gradient():
    """A column excluded for every row contributes nothing."""
    q, t, b, _, w = _case(16, 64, 32, False, seed=4)
    rid = jnp.zeros((16,), jnp.int32)
    cid = jnp.where(jnp.arange(64) < 8, 0, 1 + jnp.arange(64)).astype(jnp.int32)
    g = jax.grad(lambda t_: jnp.sum(w * ol.online_lse(q, t_, b, rid, cid, True)))(t)
    assert float(jnp.abs(g[:8]).max()) == 0.0
    np.testing.assert_allclose(
        np.asarray(ol.online_lse(q, t, b, rid, cid, True)), np.asarray(_ref(q, t[8:], b[8:])), atol=2e-5
    )


def test_ids_must_come_together():
    q, t, b, _, _ = _case(8, 16, 16, False, seed=5)
    with pytest.raises(ValueError, match="together"):
        ol.online_lse(q, t, b, jnp.zeros((8,), jnp.int32), None, True)


@pytest.mark.parametrize("d,want", [(1, 16), (16, 16), (24, 32), (128, 128), (200, 256), (512, 512)])
def test_padded_width(d, want):
    assert ol.padded_width(d) == want


@pytest.mark.parametrize("d", [16, 64, 128, 256, 512])
def test_blocks_are_powers_of_two(d):
    bl = ol.blocks(d)
    for k, val in bl.items():
        assert k == "stages" or (val > 0 and val & (val - 1) == 0), (k, val)
    # The dq and dtable accumulators stay within 64 KiB of fp32 per program.
    assert bl["dq_rows"] * d * 4 <= 64 * 1024 and bl["dt_cols"] * d * 4 <= 64 * 1024


def test_split_dtable_launch_matches_unsplit(monkeypatch):
    """Few vocab blocks → the dtable kernel splits its row loop across a
    second grid axis; the summed partials equal the single-program result."""
    q, t, b, (rid, cid), w = _case(512, 64, 32, True, seed=6)
    f = lambda *a: jnp.sum(w * ol.online_lse(*a, rid, cid, True))  # noqa: E731
    split = jax.grad(f, argnums=(1, 2))(q, t, b)
    monkeypatch.setattr(ol, "_MIN_PROGRAMS", 1)
    whole = jax.grad(f, argnums=(1, 2))(q, t, b)
    for a, r in zip(split, whole):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_jit_and_vmap_free_shapes():
    q, t, b, (rid, cid), _ = _case(48, 200, 64, True, seed=7)
    f = jax.jit(lambda q, t, b: jax.value_and_grad(lambda q: jnp.sum(ol.online_lse(q, t, b, rid, cid, True)))(q))
    val, dq = f(q, t, b)
    assert np.isfinite(float(val)) and dq.shape == q.shape

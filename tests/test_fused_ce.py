"""Chunked (XLA scan, custom-VJP) and streamed (Pallas kernel) CE vs the
dense oracle: values and grads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poi_tpu.ops.fused_ce import fused_ce_loss
from poi_tpu.train.losses import ce_loss


def _case(B=4, T=3, D=16, V=100, seed=0):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(V, D)), jnp.float32)
    bias = jnp.asarray(rng.normal(size=(V,)), jnp.float32)
    y = jnp.asarray(rng.integers(0, V, (B, T)), jnp.int32)
    mask = jnp.asarray(rng.random((B, T)) > 0.2, jnp.float32)
    return q, table, bias, y, mask


@pytest.mark.parametrize("chunk_v", [32, 64, 100, 256])
def test_fused_ce_value_matches_dense(chunk_v):
    q, table, bias, y, mask = _case()
    got = float(fused_ce_loss(q, table, bias, y, mask, chunk_v=chunk_v))
    want = float(ce_loss(q, table, bias, y, mask))
    assert abs(got - want) < 1e-3 * max(1.0, abs(want)), (got, want, chunk_v)


def test_fused_ce_grads_match_dense():
    q, table, bias, y, mask = _case(seed=1)

    g_f = jax.grad(lambda *a: fused_ce_loss(*a, y, mask, chunk_v=32), argnums=(0, 1, 2))(q, table, bias)
    g_d = jax.grad(lambda *a: ce_loss(*a, y, mask), argnums=(0, 1, 2))(q, table, bias)
    for a, b, name in zip(g_f, g_d, ("dq", "dtable", "dbias")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3, rtol=2e-2, err_msg=name)


def test_fused_ce_padded_vocab_bias():
    """NEG bias rows (vocab padding) must not affect value or gradient."""
    q, table, bias, y, mask = _case(V=96, seed=2)
    v_pad = 128
    table_p = jnp.pad(table, ((0, v_pad - 96), (0, 0)), constant_values=0.5)
    bias_p = jnp.pad(bias, (0, v_pad - 96), constant_values=-1e30)
    got = float(fused_ce_loss(q, table_p, bias_p, y, mask, chunk_v=64))
    want = float(ce_loss(q, table, bias, y, mask))
    assert abs(got - want) < 1e-3
    g = jax.grad(lambda t: fused_ce_loss(q, t, bias_p, y, mask, chunk_v=64))(table_p)
    assert np.abs(np.asarray(g)[96:]).max() == 0.0


def test_fused_ce_under_jit_and_value_and_grad():
    q, table, bias, y, mask = _case(seed=3)
    f = jax.jit(lambda q, t, b: jax.value_and_grad(fused_ce_loss)(q, t, b, y, mask))
    loss, dq = f(q, table, bias)
    assert np.isfinite(float(loss)) and np.isfinite(np.asarray(dq)).all()


@pytest.mark.parametrize("shape", [(3, 4, 32, 180), (2, 5, 100, 300)])
def test_pallas_ce_interpret_matches_dense(shape):
    """The streamed CE (the Pallas kernel of ops/online_lse.py, in
    interpreter mode) vs the dense oracle: value and every gradient."""
    from poi_tpu.train.losses import streamed_ce_loss

    B, T, D, V = shape
    q, table, bias, y, mask = _case(B=B, T=T, D=D, V=V, seed=4)
    got, g_p = jax.value_and_grad(
        lambda *a: streamed_ce_loss(*a, y, mask, interpret=True), argnums=(0, 1, 2)
    )(q, table, bias)
    want, g_d = jax.value_and_grad(
        lambda *a: ce_loss(*a, y, mask), argnums=(0, 1, 2)
    )(q, table, bias)
    assert abs(float(got) - float(want)) < 1e-3 * max(1.0, abs(float(want)))
    for a, b, name in zip(g_p, g_d, ("dq", "dtable", "dbias")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3, rtol=2e-2, err_msg=name)

"""Streamed sampled softmax (``impl="triton"``: the Pallas kernel of
ops/online_lse.py, in interpret mode here) vs the XLA implementation of
train/losses.sampled_softmax_loss — same PRNG draw means identical negative
pools, so value and every gradient must agree to bf16-matmul tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poi_tpu.train.losses import sampled_softmax_loss


def _setup(B=2, T=8, D=128, V=300, seed=0):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(V, D)) * 0.3, jnp.float32)
    bias = jnp.asarray(rng.normal(size=(V,)) * 0.1, jnp.float32)
    targets = jnp.asarray(rng.integers(0, V, size=(B, T)), jnp.int32)
    mask = jnp.asarray(rng.random((B, T)) < 0.8, jnp.float32)
    key = jax.random.key(seed + 7)
    return q, table, bias, targets, mask, key


def _streamed(*a):
    return sampled_softmax_loss(*a, impl="triton", interpret=True)


# Small V makes accidental hits certain with S=256 draws; odd S covers the
# pool-padding path.
@pytest.mark.parametrize("num_sampled", [256, 200])
def test_fused_sampled_matches_xla(num_sampled):
    q, table, bias, targets, mask, key = _setup()
    V = table.shape[0]

    def ref(q, t, b):
        return sampled_softmax_loss(q, t, b, targets, mask, key, num_sampled, V)

    def fused(q, t, b):
        return _streamed(q, t, b, targets, mask, key, num_sampled, V)

    l_ref, g_ref = jax.value_and_grad(ref, argnums=(0, 1, 2))(q, table, bias)
    l_f, g_f = jax.value_and_grad(fused, argnums=(0, 1, 2))(q, table, bias)
    # Hits must exist for the hit-masking path to be exercised.
    neg = jax.random.randint(key, (num_sampled,), 0, V)
    assert bool(jnp.any(neg[None, None, :] == targets[..., None]))
    np.testing.assert_allclose(float(l_f), float(l_ref), rtol=2e-3)
    for a, b_ in zip(g_f, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_), atol=3e-3, rtol=2e-2)


def test_fused_sampled_multi_rowblock_and_chunks():
    """Rows spanning several row blocks + pool spanning several vocab tiles."""
    q, table, bias, targets, mask, key = _setup(B=4, T=80, D=128, V=5000, seed=3)
    V = table.shape[0]
    S = 1000

    l_ref = sampled_softmax_loss(q, table, bias, targets, mask, key, S, V)
    l_f = _streamed(q, table, bias, targets, mask, key, S, V)
    np.testing.assert_allclose(float(l_f), float(l_ref), rtol=2e-3)


def test_fused_sampled_grad_flows_only_to_sampled_rows():
    """dtable must be nonzero only at drawn negatives and targets."""
    q, table, bias, targets, mask, key = _setup(B=1, T=4, D=128, V=1000, seed=5)
    V = table.shape[0]
    S = 128

    g = jax.grad(lambda t: _streamed(q, t, bias, targets, mask, key, S, V))(table)
    touched = set(np.asarray(jax.random.randint(key, (S,), 0, V)).tolist())
    touched |= set(np.asarray(targets).reshape(-1).tolist())
    nz = set(np.flatnonzero(np.abs(np.asarray(g)).sum(axis=1)).tolist())
    assert nz <= touched, nz - touched


def test_sampled_nll_rejects_unknown_impl():
    from poi_tpu.train.losses import sampled_nll

    q, table, bias, targets, mask, key = _setup(B=1, T=2, D=16, V=50)
    with pytest.raises(ValueError, match="impl"):
        sampled_nll(q, table[:8], bias[:8], jnp.zeros((1, 2)), targets, jnp.arange(8), 8, 50, "cuda")

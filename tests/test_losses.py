"""Loss unit tests vs closed-form / oracle computations on tiny catalogs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poi_tpu.train import losses


def softmax_np(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_ce_matches_numpy():
    rng = np.random.default_rng(0)
    B, T, D, V = 2, 3, 4, 7
    q = rng.normal(size=(B, T, D)).astype(np.float32)
    table = rng.normal(size=(V, D)).astype(np.float32)
    bias = rng.normal(size=(V,)).astype(np.float32)
    y = rng.integers(0, V, (B, T))
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)

    got = float(losses.ce_loss(jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias), jnp.asarray(y), jnp.asarray(mask)))

    logits = q @ table.T + bias
    p = softmax_np(logits)
    nll = -np.log(p[np.arange(B)[:, None], np.arange(T)[None, :], y])
    want = (nll * mask).sum() / mask.sum()
    # bf16 matmul operands → loose tolerance
    assert abs(got - want) < 2e-2 * max(1.0, abs(want))


def test_ce_uniform_equals_log_v():
    """Zero queries + zero bias → loss == log(V) exactly."""
    B, T, D, V = 2, 2, 4, 11
    got = float(
        losses.ce_loss(
            jnp.zeros((B, T, D)), jnp.zeros((V, D)), jnp.zeros((V,)),
            jnp.zeros((B, T), jnp.int32), jnp.ones((B, T)),
        )
    )
    assert abs(got - np.log(V)) < 1e-5


def test_bpr_zero_params_is_log2():
    """All scores equal → -log sigmoid(0) = log 2."""
    B, T, D, V = 2, 3, 4, 9
    got = float(
        losses.bpr_loss(
            jnp.zeros((B, T, D)), jnp.zeros((V, D)), jnp.zeros((V,)),
            jnp.ones((B, T), jnp.int32), jnp.ones((B, T)),
            jax.random.key(0), num_negatives=3, num_pois=V,
        )
    )
    assert abs(got - np.log(2)) < 1e-5


def test_bpr_prefers_higher_positive_score():
    B, T, D, V = 1, 1, 2, 5
    q = jnp.ones((B, T, D))
    table = jnp.zeros((V, D)).at[2].set(5.0)  # positive id 2 has big score
    y = jnp.full((B, T), 2, jnp.int32)
    low = losses.bpr_loss(q, table, jnp.zeros((V,)), y, jnp.ones((B, T)), jax.random.key(1), 4, V)
    high = losses.bpr_loss(-q, table, jnp.zeros((V,)), y, jnp.ones((B, T)), jax.random.key(1), 4, V)
    assert float(low) < float(high)


def test_sampled_softmax_approximates_full_ce():
    """With many samples, sampled softmax ≈ dense CE (logQ-corrected)."""
    rng = np.random.default_rng(1)
    B, T, D, V = 4, 4, 8, 50
    q = rng.normal(size=(B, T, D)).astype(np.float32) * 0.1
    table = rng.normal(size=(V, D)).astype(np.float32) * 0.1
    bias = np.zeros(V, np.float32)
    y = rng.integers(0, V, (B, T))
    mask = np.ones((B, T), np.float32)
    dense = float(losses.ce_loss(jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias), jnp.asarray(y), jnp.asarray(mask)))
    vals = [
        float(
            losses.sampled_softmax_loss(
                jnp.asarray(q), jnp.asarray(table), jnp.asarray(bias), jnp.asarray(y),
                jnp.asarray(mask), jax.random.key(s), num_sampled=4000, num_pois=V,
            )
        )
        for s in range(3)
    ]
    assert abs(np.mean(vals) - dense) < 0.05 * max(1.0, dense)


def test_losses_differentiable():
    B, T, D, V = 2, 3, 4, 7
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(V, D)), jnp.float32)
    bias = jnp.zeros((V,))
    y = jnp.asarray(rng.integers(0, V, (B, T)))
    mask = jnp.ones((B, T))
    key = jax.random.key(0)
    for fn in (
        lambda t: losses.ce_loss(q, t, bias, y, mask),
        lambda t: losses.bpr_loss(q, t, bias, y, mask, key, 2, V),
        lambda t: losses.sampled_softmax_loss(q, t, bias, y, mask, key, 16, V),
    ):
        g = jax.grad(fn)(table)
        assert np.isfinite(np.asarray(g)).all()
        assert np.abs(np.asarray(g)).sum() > 0


@pytest.mark.parametrize(
    "kind,extra",
    [("ce", {}), ("ce", {"loss.label_smoothing": "0.1"}), ("bpr", {}), ("sampled_softmax", {"loss.num_sampled": "64"})],
)
def test_build_loss_fn_on_cpu_matches_plain_losses(kind, extra):
    """On the CPU every objective dispatches to its plain XLA implementation
    (backend.ce_impl / sampled_impl), with the same value as calling it."""
    from poi_tpu.configs.presets import get_config
    from poi_tpu.train.losses import build_loss_fn

    cfg = get_config("smoke").with_overrides({"loss.kind": kind, **extra}).loss
    rng = np.random.default_rng(1)
    V, D = 50, 8
    q = jnp.asarray(rng.normal(size=(2, 3, D)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(V, D)), jnp.float32)
    bias = jnp.zeros((V,), jnp.float32)
    y = jnp.asarray(rng.integers(0, V, (2, 3)), jnp.int32)
    mask = jnp.ones((2, 3))
    key = jax.random.key(0)
    got = float(build_loss_fn(cfg, V)(q, table, bias, y, mask, key))
    want = {
        "ce": lambda: losses.ce_loss(q, table, bias, y, mask, cfg.label_smoothing),
        "bpr": lambda: losses.bpr_loss(q, table, bias, y, mask, key, cfg.num_negatives, V),
        "sampled_softmax": lambda: losses.sampled_softmax_loss(q, table, bias, y, mask, key, cfg.num_sampled, V),
    }[kind]()
    assert got == pytest.approx(float(want), rel=1e-6)

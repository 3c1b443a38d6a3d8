"""Top-k tests: the chunked top-k vs the whole-catalog XLA oracle vs NumPy,
plus the vocab-sharded merge path (SURVEY.md §2.2 T9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poi_tpu.ops.topk import NEG, chunked_topk, make_sharded_topk, xla_topk
from poi_tpu.parallel.mesh import make_mesh


def _case(B, D, V, seed=0):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(B, D)), jnp.float32)
    table = jnp.asarray(rng.normal(size=(V, D)), jnp.float32)
    bias = jnp.asarray(rng.normal(size=(V,)), jnp.float32)
    return q, table, bias


def test_xla_topk_matches_numpy():
    q, table, bias = _case(4, 16, 100)
    vals, ids = xla_topk(q, table, bias, 5)
    scores = (np.asarray(q).astype(np.float32) @ np.asarray(table).astype(np.float32).T) + np.asarray(bias)
    want = np.argsort(-scores, axis=1)[:, :5]
    # bf16 matmul can flip near-ties; compare score values instead of ids
    got_scores = np.take_along_axis(scores, np.asarray(ids), axis=1)
    want_scores = np.take_along_axis(scores, want, axis=1)
    np.testing.assert_allclose(got_scores, want_scores, rtol=2e-2)


# (B, D, V, k, chunk): evenly divided catalogs, ragged tails, a tail shorter
# than k, a catalog inside one chunk, and k larger than the chunk.
@pytest.mark.parametrize(
    "shape",
    [
        (8, 16, 512, 5, 128),
        (16, 32, 1000, 10, 128),
        (8, 16, 1536, 16, 512),
        (4, 8, 1030, 20, 256),
        (5, 8, 300, 10, 512),
        (3, 8, 700, 64, 32),
    ],
)
def test_chunked_topk_matches_oracle(shape):
    B, D, V, k, chunk = shape
    q, table, bias = _case(B, D, V, seed=B + V)
    vals_c, ids_c = chunked_topk(q, table, bias, k, chunk)
    vals_x, ids_x = xla_topk(q, table, bias, k)
    assert ids_c.shape == (B, k) and ids_c.dtype == jnp.int32
    assert np.array_equal(np.asarray(ids_c), np.asarray(ids_x))
    np.testing.assert_allclose(np.asarray(vals_c), np.asarray(vals_x), atol=1e-5)


@pytest.mark.parametrize("chunk", [128, 500])
def test_chunked_topk_ties_resolve_to_lowest_id(chunk):
    """All scores equal: the lowest catalog ids win, as with lax.top_k."""
    B, D, V, k = 4, 8, 1000, 6
    q = jnp.ones((B, D), jnp.float32)
    table = jnp.zeros((V, D), jnp.float32)
    bias = jnp.zeros((V,), jnp.float32)
    _, ids = chunked_topk(q, table, bias, k, chunk)
    assert np.array_equal(np.asarray(ids), np.tile(np.arange(k), (B, 1)))


def test_chunked_topk_never_returns_neg_biased_rows():
    """Vocab padding (NEG bias) never enters the top-k, even in a chunk of
    its own."""
    q, table, bias = _case(6, 16, 900, seed=9)
    bias = jnp.where(jnp.arange(900) >= 700, NEG, bias)
    _, ids = chunked_topk(q, table, bias, 10, 128)
    assert int(np.asarray(ids).max()) < 700
    _, want = xla_topk(q, table[:700], bias[:700], 10)
    assert np.array_equal(np.asarray(ids), np.asarray(want))


@pytest.mark.parametrize("batch,k,want", [(512, 10, 2**31 // 2048), (1, 10, 2**29), (2**30, 16, 16)])
def test_chunk_rows_from_score_budget(batch, k, want):
    from poi_tpu.ops.topk import chunk_rows

    assert chunk_rows(batch, k) == want


def test_chunked_topk_under_jit():
    q, table, bias = _case(8, 16, 3000, seed=2)
    f = jax.jit(chunked_topk, static_argnums=(3, 4))
    _, ids = f(q, table, bias, 10, 512)
    assert np.array_equal(np.asarray(ids), np.asarray(xla_topk(q, table, bias, 10)[1]))


@pytest.mark.parametrize("data,model,chunk", [(4, 2, None), (2, 4, None), (4, 2, 40)])
def test_sharded_topk_matches_dense(eight_devices, data, model, chunk):
    mesh = make_mesh(data=data, model=model)
    q, table, bias = _case(8, 16, 256, seed=3)
    vals_s, ids_s = make_sharded_topk(mesh, k=10, chunk=chunk)(q, table, bias)
    vals_x, ids_x = xla_topk(q, table, bias, 10)
    assert np.array_equal(np.asarray(ids_s), np.asarray(ids_x))
    np.testing.assert_allclose(np.asarray(vals_s), np.asarray(vals_x), atol=1e-4)


def test_evaluate_chunked_matches_whole_catalog(eight_devices, monkeypatch):
    """End-to-end evaluate() with a chunk much smaller than the catalog gives
    the same metrics as scoring the catalog in one piece."""
    import poi_tpu.ops.topk as topk_mod
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.eval.evaluate import evaluate
    from poi_tpu.models.base import DataDims, build_model

    cfg = get_config("smoke")
    ds = load_dataset(cfg.data)
    model = build_model(cfg.model, DataDims.from_dataset(ds))
    params = model.init(jax.random.key(0))
    m_whole = evaluate(model, params, ds, cfg)
    model._topk_cache = {}
    import poi_tpu.eval.evaluate as eval_mod

    monkeypatch.setattr(
        eval_mod, "chunked_topk", lambda q, t, b, k: topk_mod.chunked_topk(q, t, b, k, 64)
    )
    m_chunked = evaluate(model, params, ds, cfg)
    for key in m_whole:
        assert abs(m_whole[key] - m_chunked[key]) < 1e-6, (key, m_whole, m_chunked)

"""Full-catalog scoring + top-k (SURVEY.md §2.2 T9).

Replaces the reference's per-user dense scoring loop (score all POIs, argsort
in NumPy — SURVEY.md §3.1b) with one jitted function per batch.

``chunked_topk`` scores the catalog with bf16 matrix products (fp32
accumulation) and ``lax.top_k``. One [B, V] fp32 score tile is used while it
fits ``SCORE_TILE_BYTES``; beyond that the catalog is walked in chunks under
``lax.scan``, each chunk's top-k merged into the running [B, k] candidates,
so memory stays bounded whatever the catalog size. On the H100 one
whole-catalog pass was the fastest at V = 1M, B = 512 (a 2 GB tile; chunks
of 32k rows took about twice as long — PERF.md), hence the large budget.
Ties resolve to the lower catalog id, as ``lax.top_k`` does on the whole
row: the running candidates, which come from earlier chunks, are placed
first in every merge.

``xla_topk`` scores the whole catalog at once and is the correctness
oracle. ``make_sharded_topk`` runs the chunked top-k on each vocab shard and
merges the shards' candidates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG = -1e30
# Largest [B, chunk] fp32 score tile held at once.
SCORE_TILE_BYTES = 2**31


def chunk_rows(batch: int, k: int) -> int:
    """Catalog rows scored per chunk for ``batch`` queries."""
    return max(k, SCORE_TILE_BYTES // (4 * max(batch, 1)))


def _scores(q: jax.Array, table: jax.Array, bias: jax.Array) -> jax.Array:
    return (
        jnp.dot(q.astype(jnp.bfloat16), table.astype(jnp.bfloat16).T, preferred_element_type=jnp.float32)
        + bias
    )


def xla_topk(q: jax.Array, table: jax.Array, bias: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Correctness oracle: dense [B, V] scores + lax.top_k."""
    return jax.lax.top_k(_scores(q, table, bias), k)


def _merge(vals, ids, new_vals, new_ids, k):
    v, pos = jax.lax.top_k(jnp.concatenate([vals, new_vals], axis=1), k)
    return v, jnp.take_along_axis(jnp.concatenate([ids, new_ids], axis=1), pos, axis=1)


def chunked_topk(
    q: jax.Array,  # [B, D]
    table: jax.Array,  # [V, D]
    bias: jax.Array,  # [V]
    k: int,
    chunk: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """(values [B, k] fp32 descending, ids [B, k] int32): the same result as
    ``xla_topk`` with at most one [B, chunk] score tile alive (``chunk``
    defaults to ``chunk_rows``)."""
    v = table.shape[0]
    chunk = max(chunk or chunk_rows(q.shape[0], k), k)
    if v <= chunk:
        return xla_topk(q, table, bias, k)
    n_full = v // chunk

    def chunk_topk(start):
        t = jax.lax.dynamic_slice_in_dim(table, start, chunk)
        b = jax.lax.dynamic_slice_in_dim(bias, start, chunk)
        cv, ci = jax.lax.top_k(_scores(q, t, b), k)
        return cv, ci + start

    def body(carry, i):
        return _merge(*carry, *chunk_topk(i * chunk), k), None

    (vals, ids), _ = jax.lax.scan(body, chunk_topk(0), jnp.arange(1, n_full))
    tail = n_full * chunk
    if tail < v:
        kt = min(k, v - tail)
        cv, ci = xla_topk(q, table[tail:], bias[tail:], kt)
        vals, ids = _merge(vals, ids, cv, ci + tail, k)
    return vals, ids


def make_sharded_topk(mesh, k: int, chunk: int | None = None):
    """Top-k over a vocab-sharded catalog (SURVEY.md §2.2 T9, eval side).

    Each 'model' shard scores its [V/M, D] rows and takes a LOCAL top-k
    (k per shard >= global k guarantees correctness of the merge), then the
    k·M candidates are all-gathered and reduced with a final top-k. Returns
    (values [B, k], global ids [B, k]); batch stays sharded over 'data'.
    """
    import functools

    from jax.sharding import PartitionSpec as P

    from poi_tpu.parallel import collectives as cc
    from poi_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(MODEL_AXIS, None), P(MODEL_AXIS)),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
        check_vma=False,
    )
    def topk(q_blk, t_blk, b_blk):
        rows = t_blk.shape[0]
        vals, ids = chunked_topk(q_blk, t_blk, b_blk, min(k, rows), chunk)
        ids = ids + cc.axis_index(MODEL_AXIS) * rows
        vals_all = cc.all_gather(vals, MODEL_AXIS, gather_axis=1)  # [b, M*k]
        ids_all = cc.all_gather(ids, MODEL_AXIS, gather_axis=1)
        v, pos = jax.lax.top_k(vals_all, k)
        return v, jnp.take_along_axis(ids_all, pos, axis=1)

    return topk

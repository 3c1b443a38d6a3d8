"""Full-catalog evaluation (reference R10 → SURVEY.md §3.2b call stack).

The reference scores every POI per test user in a Python loop and argsorts a
dense [V] vector. Here the whole eval set is batched: one jit'd function maps
a batch of contexts to top-K candidate ids by scoring against the (possibly
vocab-sharded) output table with the chunked top-k of ``ops/topk.py``.
Metrics (Recall@{1,5,10}, NDCG) are then O(N·K) on host.

Sharded eval (the north star's eval sentence, SURVEY.md §2.2 T9): when a
mesh with ``model > 1`` is passed, the vocab-sharded table NEVER leaves its
``P('model', None)`` layout — each shard runs the chunked top-k over its own
rows, and only the [B, M·k] candidate set is gathered. A 1M×512 catalog
therefore costs V/M·D bytes of device memory per card end-to-end instead of
being all-gathered to every card per sweep.

Multi-host: with ``jax.process_count() > 1`` each process feeds only the
global-batch rows its addressable devices own (assembled with
``jax.make_array_from_process_local_data``), computes hit/gain counts on its
local top-k shards, and the final metric sums are reduced across processes —
every test example is counted exactly once (SURVEY.md §2.2 T7, eval side).
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import jax
import numpy as np

from poi_tpu.data.dataset import Dataset
from poi_tpu.data.pipeline import eval_batches
from poi_tpu.eval.metrics import ranking_metrics
from poi_tpu.models import base as model_base
from poi_tpu.ops.topk import chunked_topk, make_sharded_topk
from poi_tpu.utils.config import Config

log = logging.getLogger(__name__)


def last_valid_queries(model, params: dict, batch) -> jax.Array:
    """[B, D] query at each sequence's final valid position.

    Routed through ``model.queries_last`` — the tower's recurrence still
    traverses T, but attention/projection/user-add run once per row instead
    of once per position (VERDICT r4 Weak #1; parity with the full-T path is
    tested per model in tests/test_models.py)."""
    return model.queries_last(params, batch)


class PreparedCatalog(NamedTuple):
    """The output table an eval sweep or a server scores against, taken out
    of the params once (sharded like the params when a mesh is given)."""

    table: jax.Array  # [V', D]
    bias: jax.Array  # [V']


def _is_sharded(mesh) -> bool:
    from poi_tpu.parallel.mesh import MODEL_AXIS

    return mesh is not None and mesh.shape[MODEL_AXIS] > 1


def prepare_catalog(params: dict, cfg: Config) -> PreparedCatalog:
    """(table, bias) that ``make_topk_fn``'s function scores against. Rows
    are catalog ids; on a vocab-sharded mesh the table keeps its
    P('model', None) layout."""
    table, bias = model_base.output_table(params, cfg.model)
    return PreparedCatalog(*jax.block_until_ready((table, bias)))


def make_topk_fn(model, cfg: Config, k: int, mesh=None):
    """jit'd (params, table, bias, batch) -> [B, k] catalog ids.

    The jit closures are cached ON the model instance (``model._topk_cache``),
    keyed by (k, mesh): periodic in-training evals must not recompile every
    sweep, and the cache's lifetime is exactly the model's — no module-global
    keyed on a reusable ``id()`` that could serve a stale closure to a new
    model, and no unbounded growth in a long-lived serving process (VERDICT
    r2 Weak #2). The model→cache→closure→model cycle is ordinary cyclic
    garbage, collected when the last external reference goes.
    """
    sharded = _is_sharded(mesh)
    per_model = model.__dict__.setdefault("_topk_cache", {})
    key = (k, mesh if sharded else None)
    if key in per_model:
        return per_model[key]

    if sharded:
        core = make_sharded_topk(mesh, k)

        @jax.jit
        def fn(params, table, bias, batch):
            ql = last_valid_queries(model, params, batch)
            return core(ql, table, bias)[1]

    else:

        @jax.jit
        def fn(params, table, bias, batch):
            ql = last_valid_queries(model, params, batch)
            return chunked_topk(ql, table, bias, k)[1]

    per_model[key] = fn
    return fn


def _local_batch_rows(sharding, batch_size: int) -> np.ndarray:
    """Global-batch row indices owned by this process's addressable devices
    (sorted ascending — the order make_array_from_process_local_data expects
    the local rows concatenated in)."""
    idx_map = sharding.addressable_devices_indices_map((batch_size,))
    rows: set[int] = set()
    for sl in idx_map.values():
        (s,) = sl
        rows.update(range(*s.indices(batch_size)))
    return np.asarray(sorted(rows), dtype=np.int64)


def evaluate(
    model, params: dict, dataset: Dataset, cfg: Config, mesh=None, split: str = "test"
) -> dict[str, float]:
    ks = cfg.eval.recall_ks
    k = max(ks)
    sharded = _is_sharded(mesh)
    multiproc = jax.process_count() > 1
    prep = prepare_catalog(params, cfg)
    topk_fn = make_topk_fn(model, cfg, k, mesh=mesh if sharded else None)

    test = getattr(dataset, split)
    if test is None:
        raise ValueError(
            f"dataset has no {split!r} split (set data.val_fraction > 0 for val)"
        )
    if cfg.eval.max_eval_users and len(test) > cfg.eval.max_eval_users:
        test = test.take(np.arange(cfg.eval.max_eval_users))

    batch_shardings = None
    local_rows = None
    if sharded or multiproc:
        from poi_tpu.parallel.shardings import batch_shardings as make_batch_shardings

        assert mesh is not None, "multi-process evaluate() needs the trainer mesh"
        bsz = cfg.eval.batch_size

    all_topk, all_tgt = [], []
    for batch, targets, n_valid in eval_batches(test, cfg.eval.batch_size):
        if sharded or multiproc:
            if batch_shardings is None:
                batch_shardings = make_batch_shardings(batch, mesh)
            if multiproc:
                if local_rows is None:
                    local_rows = _local_batch_rows(jax.tree.leaves(batch_shardings)[0], bsz)
                local = jax.tree.map(lambda x: np.asarray(x)[local_rows], batch)
                batch = jax.tree.map(
                    lambda x, s: jax.make_array_from_process_local_data(s, x),
                    local,
                    batch_shardings,
                )
            else:
                batch = jax.device_put(batch, batch_shardings)
        ids_dev = topk_fn(params, prep.table, prep.bias, batch)
        if multiproc:
            # Only addressable shards can be read; the [B, k] result is
            # replicated over 'model', so dedupe data blocks by start index.
            blocks = {}
            for s in ids_dev.addressable_shards:
                blocks.setdefault(s.index[0].start or 0, s.data)
            ids = np.concatenate([np.asarray(blocks[b]) for b in sorted(blocks)])
            rows = local_rows
            keep = rows < n_valid
            ids = ids[keep]
            tgt = targets[rows[keep]]
        else:
            ids = np.asarray(ids_dev)[:n_valid]
            tgt = targets[:n_valid]
        all_topk.append(ids)
        all_tgt.append(tgt)
    topk = np.concatenate(all_topk)
    tgt = np.concatenate(all_tgt)
    if multiproc:
        return _reduce_metrics_across_processes(topk, tgt, ks)
    metrics = ranking_metrics(topk, tgt, ks)
    metrics["eval_examples"] = float(len(tgt))
    return metrics


def _reduce_metrics_across_processes(topk: np.ndarray, tgt: np.ndarray, ks) -> dict[str, float]:
    """Sum per-process hit/gain counts over all processes, then normalize —
    each process only scored the rows its devices own."""
    from jax.experimental import multihost_utils

    kmax = max(ks)
    eq = topk[:, :kmax] == tgt[:, None] if len(tgt) else np.zeros((0, kmax), bool)
    sums = [float(eq[:, :k].any(axis=1).sum()) for k in ks]
    found = eq.any(axis=1)
    ranks = np.where(found, eq.argmax(axis=1), 0)
    sums.append(float(np.where(found, 1.0 / np.log2(ranks + 2.0), 0.0).sum()))
    sums.append(float(len(tgt)))
    total = np.asarray(multihost_utils.process_allgather(np.asarray(sums))).sum(axis=0)
    n = max(float(total[-1]), 1.0)
    out = {f"recall@{k}": float(total[i]) / n for i, k in enumerate(ks)}
    out[f"ndcg@{kmax}"] = float(total[len(ks)]) / n
    out["eval_examples"] = float(total[-1])
    return out


def popularity_baseline(dataset: Dataset, ks=(1, 5, 10), split: str = "test") -> dict[str, float]:
    """Recall of always recommending the globally most-popular POIs — the
    sanity floor any trained model must clear (SURVEY.md §4 Integration)."""
    k = max(ks)
    examples = getattr(dataset, split)
    if examples is None:
        raise ValueError(f"dataset has no {split!r} split")
    top = np.argsort(dataset.poi_counts)[::-1][:k]
    topk = np.broadcast_to(top, (len(examples), k))
    return ranking_metrics(topk, examples.target, ks)

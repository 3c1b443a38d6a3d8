"""Touched-rows-only ("lazy") Adam for catalog-sized embedding tables.

Motivation (VERDICT r4 Next #1, BASELINE.json:11 scale): at config #5
(V=1M, D=512, sampled softmax S=4096, B=512, T=64) only ~70k table rows can
carry non-zero gradient per step — inputs ∪ targets ∪ the negative pool —
yet dense Adam reads AND writes params+m+v over all 1M rows every step
(~14 GB of device-memory traffic spent on arithmetic on zeros).

This optimizer updates the table rows that the step actually touched, by id:

- The touched-id sets are known *a priori* from the batch and the loss's
  negative draw (``train.losses.draw_*_negatives`` — the single shared draw
  used by every loss implementation), not discovered from the gradient. A
  test pins the invariant that rows outside the touched set have exactly
  zero dense gradient.
- Per-table moments (m, v) stay dense in device memory but are read/written only at
  the touched rows via gather → Adam-on-rows → scatter. Duplicate ids are
  deduplicated (sort + first-occurrence mask) so each row gets exactly one
  Adam step; the dense gradient has already summed duplicate contributions.
- Untouched rows receive no moment decay and no momentum-tail update — the
  standard "lazy Adam" semantics for embedding tables. When every row is
  touched every step this is EXACTLY dense Adam + global-norm clipping
  (parity-tested in tests/test_sparse_opt.py).
- The global-norm clip reads table gradients only at the touched rows
  (mathematically equal to the dense norm, since everything else is zero),
  so the [V, D] gradient is never scanned in full.

Small params (tower, projection, time/geo tables) get the ordinary dense
Adam update with the same schedule/clip, so the only semantic difference
from ``optax.chain(clip_by_global_norm, adam)`` is the lazy moments on the
big tables.

Notes: all shapes are static (the id vectors have fixed length
2·B·T + S; dedup pads duplicates to an out-of-bounds sentinel whose gathers
fill 0 and whose scatters drop), so the whole update jits into the train
step and shards over the mesh — the moment tables row-shard over 'model'
exactly like their params (parallel/shardings.py matches by leading dim).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from poi_tpu.train.state import lr_schedule
from poi_tpu.utils.config import Config

# Keys inside params["embed"] that hold catalog-sized tables, mapped to the
# name of the id set that touches them (see ``touched_ids``).
_TABLE_ID_SOURCE = {"poi": "poi", "out": "poi", "out_bias": "poi", "user": "user"}

# Tables at or below this size take the MASKED-DENSE lazy-Adam path: the same
# semantics (update + moment decay only on touched rows) computed as
# streaming elementwise ops over the full table gated by a [V] touched mask.
# Below ~0.5 GiB a full-table pass is cheap next to the gather/dedup/scatter
# machinery; above it (config #5's 2 GiB tables) the seven full-table passes
# are the larger cost and the scatter path takes over. The threshold has not
# been measured on the GPU yet (ROADMAP.md). Tests monkeypatch this to pin
# both paths.
DENSE_LAZY_MAX_BYTES = 512 * 2**20


class SparseAdamState(NamedTuple):
    count: jax.Array  # scalar int32, shared step count (bias correction + lr)
    m: Any  # pytree like params
    v: Any  # pytree like params


def validate_config(cfg: Config) -> None:
    """train.table_update="sparse" preconditions, checked at Trainer build."""
    if cfg.train.optimizer != "adam" or cfg.train.weight_decay:
        raise ValueError(
            "train.table_update='sparse' implements lazy Adam; it requires "
            "train.optimizer='adam' and train.weight_decay=0 "
            f"(got {cfg.train.optimizer!r}, wd={cfg.train.weight_decay})"
        )
    if cfg.loss.kind not in ("bpr", "sampled_softmax"):
        raise ValueError(
            "train.table_update='sparse' needs a sampled objective (bpr or "
            "sampled_softmax): full-softmax CE gradients are dense over the "
            f"catalog, so every row is touched (got loss.kind={cfg.loss.kind!r})"
        )


def rows_mode_enabled(cfg: Config, dims, n_model: int) -> bool:
    """Whether the train step differentiates w.r.t. gathered table ROWS
    (Stage B) instead of the dense table. The single source of truth for
    this dispatch — the Trainer and scripts/mem_budget.py both call it.

    Requirements: sparse update + unsharded vocab + tied-table sampled
    softmax, AND a table too big for the masked-dense path (below
    ``DENSE_LAZY_MAX_BYTES`` the dense cotangent + streaming masked update
    cost well under a millisecond, while rows-mode dedup/scatter machinery
    costs several)."""
    return (
        cfg.train.table_update == "sparse"
        and n_model == 1
        and cfg.loss.kind == "sampled_softmax"
        and cfg.model.tie_output_embedding
        and dims.num_pois_padded * cfg.model.embed_dim * 4 > DENSE_LAZY_MAX_BYTES
    )


def touched_ids(cfg: Config, batch, rng: jax.Array, num_pois: int) -> dict[str, jax.Array]:
    """The id sets that can carry gradient this step, per table family.

    ``rng`` must be the SAME key the loss function receives, so the negative
    draw here replays the loss's draw exactly (shared helpers in
    train/losses.py — the draw lives in one place by construction).
    """
    from poi_tpu.train.losses import draw_bpr_negatives, draw_sampled_negatives

    B, T = batch.poi_tgt.shape
    if cfg.loss.kind == "bpr":
        neg = draw_bpr_negatives(rng, B, T, cfg.loss.num_negatives, num_pois)
    else:
        neg = draw_sampled_negatives(rng, cfg.loss.num_sampled, num_pois)
    ids = {
        "poi": jnp.concatenate(
            [batch.poi_in.ravel(), batch.poi_tgt.ravel(), neg.ravel()]
        ).astype(jnp.int32)
    }
    if batch.user is not None:
        ids["user"] = batch.user.ravel().astype(jnp.int32)
    return ids


def _compact_unique(s: jax.Array, oob: int) -> tuple[jax.Array, jax.Array]:
    """From SORTED ids ``s``: (compacted unique-id vector, segment index).

    The result places the unique ids first (ascending) and fills the tail
    with DISTINCT out-of-bounds sentinels ``oob + j`` — so the whole vector
    is strictly sorted with no duplicates, and every downstream gather/
    scatter can legally assert ``unique_indices`` + ``indices_are_sorted``
    (without those hints a scatter lowering may serialize combining).
    """
    n = s.shape[0]
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    seg = jnp.cumsum(first) - 1
    pad = oob + jnp.arange(n, dtype=s.dtype)
    return pad.at[seg].set(s), seg


def dedup_ids(ids: jax.Array, oob: int) -> jax.Array:
    """Compacted strictly-sorted unique ids: uniques first (ascending), then
    distinct out-of-bounds sentinels (fill 0 on gather, drop on scatter)."""
    u, _ = _compact_unique(jnp.sort(ids), oob)
    return u


def dedup_sum(ids: jax.Array, g: jax.Array, oob: int) -> tuple[jax.Array, jax.Array]:
    """(compacted unique ids, per-unique-id summed row grads).

    The rows-gradient step (Stage B) yields one gradient row per id
    OCCURRENCE; Adam needs one summed gradient per unique row — exactly what
    the dense scatter-add would have produced, computed here on [N, D]
    instead of [V, D]. Static shapes: tail positions beyond the unique count
    keep zero grads and distinct out-of-bounds sentinels."""
    order = jnp.argsort(ids)
    s = ids[order]
    uids, seg = _compact_unique(s, oob)
    g_sum = jax.ops.segment_sum(g[order], seg, num_segments=ids.shape[0])
    return uids, g_sum


def _is_table(path: tuple, leaf) -> str | None:
    """Return the id-source name when this param path is a sparse table."""
    keys = [p.key for p in path if hasattr(p, "key")]
    if len(keys) == 2 and keys[0] == "embed" and keys[1] in _TABLE_ID_SOURCE:
        return _TABLE_ID_SOURCE[keys[1]]
    return None


class SparseTableOptimizer:
    """Drop-in for the Trainer's optax optimizer, with an ids-aware update.

    ``init(params)`` mirrors ``optax.GradientTransformation.init``;
    ``update_apply(grads, state, params, ids)`` fuses the update computation
    with its application (the sparse scatter IS the apply) and returns
    ``(new_params, new_state)``.
    """

    def __init__(self, cfg: Config, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        validate_config(cfg)
        self.schedule: Callable = lr_schedule(cfg.train)
        self.clip = cfg.train.grad_clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Any) -> SparseAdamState:
        return SparseAdamState(
            count=jnp.zeros((), jnp.int32),
            m=jax.tree.map(jnp.zeros_like, params),
            v=jax.tree.map(jnp.zeros_like, params),
        )

    def update_apply(
        self,
        grads: Any,
        state: SparseAdamState,
        params: Any,
        ids: dict[str, jax.Array],
        row_grads: dict[str, tuple[jax.Array, jax.Array]] | None = None,
    ) -> tuple[Any, SparseAdamState, jax.Array]:
        """Apply the update; returns (new_params, new_state, grad_norm).

        Two gradient representations per table, by embed-key:
        - default: ``grads`` holds the DENSE [V, ...] gradient; touched rows
          are gathered at the deduped ``ids`` (duplicates already summed by
          the autodiff scatter-add).
        - ``row_grads[key] = (occurrence_ids, per-occurrence rows)``: the
          rows-gradient step (Stage B) never materialized the dense
          gradient; duplicates are summed here via ``dedup_sum`` and the
          corresponding ``grads`` leaf is a placeholder (ignored).

        ``grad_norm`` is the exact global norm of the mathematical gradient
        (dense leaves in full, table leaves from their touched rows) — the
        same quantity optax.global_norm reports on the dense path; it is
        computed for clipping anyway, so callers get it for free.
        """
        b1, b2, eps = self.b1, self.b2, self.eps
        row_grads = row_grads or {}
        uids = {k: None for k in ids}  # deduped lazily, once per id set
        masks: dict[str, jax.Array] = {}  # [V] touched masks, once per id set

        def table_rows(path, g):
            """Update plan for table leaves: ("rows", uids, summed grads) for
            the gather/scatter path, ("masked", src) for the masked-dense
            path (small tables), None for ordinary dense leaves."""
            src = _is_table(path, g)
            if src is None:
                return None
            keys = [p.key for p in path if hasattr(p, "key")]
            if keys[1] in row_grads:
                occ_ids, occ_rows = row_grads[keys[1]]
                oob = params["embed"][keys[1]].shape[0]
                return ("rows", *dedup_sum(occ_ids, occ_rows, oob))
            if src not in ids:
                return None
            if g.size * g.dtype.itemsize <= DENSE_LAZY_MAX_BYTES:
                if src not in masks:
                    masks[src] = (
                        jnp.zeros(g.shape[0], bool).at[ids[src]].set(True)
                    )
                return ("masked", src)
            if uids[src] is None:
                uids[src] = dedup_ids(ids[src], g.shape[0])
            u = uids[src]
            return ("rows", u, g.at[u].get(
                mode="fill", fill_value=0.0,
                unique_indices=True, indices_are_sorted=True,
            ))

        paths_grads = jax.tree_util.tree_flatten_with_path(grads)[0]
        rows = {path: table_rows(path, g) for path, g in paths_grads}

        # Global grad norm: dense/masked leaves in full (rows outside the
        # touched set are exactly zero — tested), rows leaves from their
        # touched rows only.
        sumsq = jnp.float32(0.0)
        for path, g in paths_grads:
            r = rows[path]
            x = g if (r is None or r[0] == "masked") else r[2]
            sumsq = sumsq + jnp.sum(jnp.square(x.astype(jnp.float32)))
        gnorm = jnp.sqrt(sumsq)
        scale = jnp.float32(1.0)
        if self.clip > 0:
            # optax.clip_by_global_norm: scale by clip/norm only when over.
            scale = jnp.where(gnorm > self.clip, self.clip / gnorm, 1.0)

        count = state.count + 1
        bc1 = 1.0 - b1 ** count.astype(jnp.float32)
        bc2 = 1.0 - b2 ** count.astype(jnp.float32)
        lr_t = self.schedule(state.count)

        def upd(path_leaf, g, p, m, v):
            r = rows[path_leaf]
            if r is None:  # dense Adam
                g = g * scale
                m_n = b1 * m + (1 - b1) * g
                v_n = b2 * v + (1 - b2) * jnp.square(g)
                step = lr_t * (m_n / bc1) / (jnp.sqrt(v_n / bc2) + eps)
                return p - step, m_n, v_n
            if r[0] == "masked":  # lazy Adam as streaming masked-dense ops
                mask = masks[r[1]].reshape((p.shape[0],) + (1,) * (p.ndim - 1))
                g = g * scale
                m_n = jnp.where(mask, b1 * m + (1 - b1) * g, m)
                v_n = jnp.where(mask, b2 * v + (1 - b2) * jnp.square(g), v)
                step = lr_t * (m_n / bc1) / (jnp.sqrt(v_n / bc2) + eps)
                return jnp.where(mask, p - step.astype(p.dtype), p), m_n, v_n
            _, u, g_u = r
            hint = dict(unique_indices=True, indices_are_sorted=True)
            g_u = g_u * scale
            m_u = m.at[u].get(mode="fill", fill_value=0.0, **hint)
            v_u = v.at[u].get(mode="fill", fill_value=0.0, **hint)
            m_n = b1 * m_u + (1 - b1) * g_u
            v_n = b2 * v_u + (1 - b2) * jnp.square(g_u)
            step = (lr_t * (m_n / bc1) / (jnp.sqrt(v_n / bc2) + eps)).astype(p.dtype)
            return (
                p.at[u].add(-step, mode="drop", **hint),
                m.at[u].set(m_n, mode="drop", **hint),
                v.at[u].set(v_n, mode="drop", **hint),
            )

        flat_p, treedef = jax.tree_util.tree_flatten_with_path(params)
        flat_g = [g for _, g in paths_grads]
        flat_m = jax.tree.leaves(state.m)
        flat_v = jax.tree.leaves(state.v)
        out = [
            upd(path, g, p, m, v)
            for (path, p), g, m, v in zip(flat_p, flat_g, flat_m, flat_v)
        ]
        unflatten = jax.tree_util.tree_structure(params).unflatten
        new_p = unflatten([o[0] for o in out])
        new_m = unflatten([o[1] for o in out])
        new_v = unflatten([o[2] for o in out])
        return new_p, SparseAdamState(count=count, m=new_m, v=new_v), gnorm

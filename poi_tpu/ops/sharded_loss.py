"""Vocab-sharded training losses (SURVEY.md §2.2 T10).

The dense full-catalog softmax becomes a two-pass sharded log-sum-exp: each
model shard computes logits only against its [V/M, D] rows, the global max
rides ``pmax`` and the partition function rides ``psum`` over 'model'
(numerically stable in fp32 accumulation even for the 1M-POI bf16 config —
SURVEY.md §7 "hard parts"). The target logit is recovered with a masked
local gather + psum. The final scalar is psum-reduced over BOTH mesh axes, so
every device returns the identical global mean loss.

BPR / sampled-softmax don't need catalog-wide matmuls — their negatives go
through the sharded embedding lookup (ops/embedding.py) — so ``ce`` is the
only loss needing its own collective implementation.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from poi_tpu.parallel import collectives as cc
from poi_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def _sharded_ce_local(
    q: jax.Array,  # [b, t, D] this data-shard's queries (replicated over model)
    table_local: jax.Array,  # [V/M, D]
    bias_local: jax.Array,  # [V/M]
    targets: jax.Array,  # [b, t]
    mask: jax.Array,  # [b, t]
    dtype=jnp.bfloat16,
) -> jax.Array:
    rows = table_local.shape[0]
    shard = cc.axis_index(MODEL_AXIS)
    lo = shard * rows

    # Local logits against owned rows only. Padded catalog rows carry a
    # -1e30 bias from init, so they vanish from the partition function.
    logits = (
        jnp.dot(q.astype(dtype), table_local.astype(dtype).T, preferred_element_type=jnp.float32)
        + bias_local
    )  # [b, t, V/M]

    # Two-pass stable LSE across shards. The max shift is a constant w.r.t.
    # gradients, so stop_gradient keeps the backward pass clean.
    # stop_gradient BEFORE pmax: the shift is gradient-free mathematically,
    # and pmax has no differentiation rule to trace through.
    local_max = jax.lax.stop_gradient(jnp.max(logits, axis=-1))
    gmax = cc.pmax(local_max, MODEL_AXIS)  # [b, t]
    sumexp = jnp.sum(jnp.exp(logits - gmax[..., None]), axis=-1)
    lse = jnp.log(cc.psum(sumexp, MODEL_AXIS)) + gmax  # [b, t]

    # Target logit: owned on exactly one shard; masked gather + psum.
    local_tgt = targets - lo
    owned = (local_tgt >= 0) & (local_tgt < rows)
    idx = jnp.clip(local_tgt, 0, rows - 1)
    tl = jnp.take_along_axis(logits, idx[..., None], axis=-1)[..., 0]
    tgt_logit = cc.psum(jnp.where(owned, tl, 0.0), MODEL_AXIS)

    nll = lse - tgt_logit
    m = mask.astype(jnp.float32)
    num = cc.psum(jnp.sum(nll * m), DATA_AXIS)
    den = cc.psum(jnp.sum(m), DATA_AXIS)
    return num / jnp.maximum(den, 1.0)


def make_sharded_bpr(mesh: Mesh, lookup: Callable, num_negatives: int, num_pois: int) -> Callable:
    """BPR over a vocab-sharded table: positive/negative embedding rows and
    bias entries come through the sharded ``lookup`` (psum or a2a routing);
    the pairwise scores themselves are local to each data shard. Matches
    ``train.losses.bpr_loss`` exactly for the same rng."""

    def loss(q, table, bias, targets, mask, rng):
        B, T = targets.shape
        from poi_tpu.train.losses import draw_bpr_negatives

        neg = draw_bpr_negatives(rng, B, T, num_negatives, num_pois)
        bias2d = bias[:, None]  # lookup expects a [V, D] table
        e_pos = lookup(table, targets)  # [B, T, D]
        e_neg = lookup(table, neg.reshape(B, -1)).reshape(B, T, num_negatives, -1)
        b_pos = lookup(bias2d, targets)[..., 0]
        b_neg = lookup(bias2d, neg.reshape(B, -1)).reshape(B, T, num_negatives)
        s_pos = jnp.einsum("btd,btd->bt", q, e_pos, preferred_element_type=jnp.float32) + b_pos
        s_neg = jnp.einsum("btd,btnd->btn", q, e_neg, preferred_element_type=jnp.float32) + b_neg
        diff = s_pos[..., None] - s_neg
        pair_ok = (neg != targets[..., None]) & mask[..., None].astype(bool)
        losses = -jax.nn.log_sigmoid(diff)
        m = pair_ok.astype(jnp.float32)
        return jnp.sum(losses * m) / jnp.maximum(jnp.sum(m), 1.0)

    return loss


def make_sharded_sampled_softmax(
    mesh: Mesh,
    lookup: Callable,
    num_sampled: int,
    num_pois: int,
    impl: str = "xla",
    interpret: bool = False,
) -> Callable:
    """Sampled softmax over a vocab-sharded table: positives come through the
    data-sharded ``lookup``; the shared negative pool (replicated across the
    mesh) comes through a replicated psum lookup. The negative logits are
    local to each data shard — no vocab-wide matmul. Matches
    ``train.losses.sampled_softmax_loss`` for the same rng.

    Each data shard reduces its own rows against the replicated pool inside
    ``shard_map`` with ``train.losses.sampled_nll`` — ``impl`` and
    ``interpret`` as there ("triton" streams the pool through
    ops/online_lse.py).
    """
    from poi_tpu.ops.embedding import make_replicated_lookup
    from poi_tpu.train.losses import draw_sampled_negatives, sampled_nll

    rep_lookup = make_replicated_lookup(mesh)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None, None),  # q
            P(),  # e_neg (replicated pool)
            P(),  # b_neg
            P(DATA_AXIS, None),  # s_pos
            P(DATA_AXIS, None),  # targets
            P(),  # pool ids
        ),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    def _nll(q, e_neg, b_neg, s_pos, targets, neg):
        return sampled_nll(
            q, e_neg, b_neg, s_pos, targets, neg, num_sampled, num_pois, impl, interpret
        )

    def loss(q, table, bias, targets, mask, rng):
        neg = draw_sampled_negatives(rng, num_sampled, num_pois)
        bias2d = bias[:, None]
        e_neg = rep_lookup(table, neg)  # [S, D]
        e_pos = lookup(table, targets)  # [B, T, D]
        b_neg = rep_lookup(bias2d, neg)[:, 0]
        b_pos = lookup(bias2d, targets)[..., 0]
        s_pos = jnp.einsum("btd,btd->bt", q, e_pos, preferred_element_type=jnp.float32) + b_pos
        nll = _nll(q, e_neg, b_neg, s_pos, targets, neg)
        m = mask.astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

    return loss


def make_sharded_ce(mesh: Mesh) -> Callable:
    """loss(q, table, bias, targets, mask, rng) — same signature as the dense
    losses in train/losses.py (rng unused), drop-in for the Trainer."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None, None),  # q
            P(MODEL_AXIS, None),  # table
            P(MODEL_AXIS),  # bias
            P(DATA_AXIS, None),  # targets
            P(DATA_AXIS, None),  # mask
        ),
        out_specs=P(),
        check_vma=False,
    )
    def _loss(q, table, bias, targets, mask):
        return _sharded_ce_local(q, table, bias, targets, mask)

    def loss(q, table, bias, targets, mask, rng=None):
        return _loss(q, table, bias, targets, mask)

    return loss

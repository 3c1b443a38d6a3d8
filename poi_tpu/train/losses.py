"""Training objectives (reference R8 — SURVEY.md §2.1).

Three objectives, matching the reference capability surface:

- ``ce``              dense full-catalog softmax cross-entropy (configs #1, #3)
- ``bpr``             pairwise BPR with sampled negatives (config #2)
- ``sampled_softmax`` shared-negative sampled softmax (configs #4, #5)

These are the single-device/dense implementations; the vocab-sharded variants
(log-sum-exp with cross-shard psum — SURVEY.md §2.2 T10) live in
``poi_tpu.ops.sharded_loss`` and are property-tested for equivalence against
these.

All losses take ``q`` [B, T, D] query vectors, the output table ``table``
[V, D] + ``bias`` [V], and reduce with the validity ``mask`` [B, T]; logits
are computed in bf16 inputs with fp32 accumulation and softmaxed in fp32.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from poi_tpu.utils.config import LossConfig

NEG = -1e30


def _masked_mean(x: jax.Array, mask: jax.Array) -> jax.Array:
    m = mask.astype(jnp.float32)
    return jnp.sum(x * m) / jnp.maximum(jnp.sum(m), 1.0)


def draw_bpr_negatives(rng: jax.Array, B: int, T: int, num_negatives: int, num_pois: int) -> jax.Array:
    """The BPR negative draw, shared by every loss implementation AND the
    sparse table optimizer's touched-row computation (train/sparse_opt.py):
    both must see the identical id set, so the draw lives in one place."""
    return jax.random.randint(rng, (B, T, num_negatives), 0, num_pois)


def draw_sampled_negatives(rng: jax.Array, num_sampled: int, num_pois: int) -> jax.Array:
    """The shared sampled-softmax negative pool draw (see draw_bpr_negatives)."""
    return jax.random.randint(rng, (num_sampled,), 0, num_pois)


def full_logits(q: jax.Array, table: jax.Array, bias: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """[.., D] x [V, D]^T → [.., V] in fp32 (bf16 operands, fp32 accumulate)."""
    return (
        jnp.dot(q.astype(dtype), table.astype(dtype).T, preferred_element_type=jnp.float32)
        + bias
    )


def ce_loss(
    q: jax.Array,
    table: jax.Array,
    bias: jax.Array,
    targets: jax.Array,
    mask: jax.Array,
    label_smoothing: float = 0.0,
) -> jax.Array:
    """Dense full-catalog softmax CE; numerically stable log-sum-exp in fp32."""
    logits = full_logits(q, table, bias)  # [B, T, V]
    lse = jax.nn.logsumexp(logits, axis=-1)
    tgt_logit = jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    nll = lse - tgt_logit
    if label_smoothing > 0.0:
        v = logits.shape[-1]
        mean_logit = jnp.mean(logits, axis=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (lse - mean_logit) * (v / (v - 1.0))
    return _masked_mean(nll, mask)


def bpr_loss(
    q: jax.Array,
    table: jax.Array,
    bias: jax.Array,
    targets: jax.Array,
    mask: jax.Array,
    rng: jax.Array,
    num_negatives: int,
    num_pois: int,
) -> jax.Array:
    """Bayesian Personalized Ranking: -log sigmoid(s_pos - s_neg) over sampled
    negatives (reference R5 pairing — BASELINE.json:8). Negatives are drawn
    uniformly; collisions with the positive are masked out of the mean."""
    B, T = targets.shape
    neg = draw_bpr_negatives(rng, B, T, num_negatives, num_pois)
    e_pos = jnp.take(table, targets, axis=0)  # [B, T, D]
    e_neg = jnp.take(table, neg, axis=0)  # [B, T, N, D]
    s_pos = jnp.einsum("btd,btd->bt", q, e_pos, preferred_element_type=jnp.float32) + bias[targets]
    s_neg = jnp.einsum("btd,btnd->btn", q, e_neg, preferred_element_type=jnp.float32) + bias[neg]
    diff = s_pos[..., None] - s_neg  # [B, T, N]
    pair_ok = (neg != targets[..., None]) & mask[..., None].astype(bool)
    losses = -jax.nn.log_sigmoid(diff)
    return _masked_mean(losses, pair_ok)


def sampled_softmax_loss(
    q: jax.Array,
    table: jax.Array,
    bias: jax.Array,
    targets: jax.Array,
    mask: jax.Array,
    rng: jax.Array,
    num_sampled: int,
    num_pois: int,
    impl: str = "xla",
    interpret: bool = False,
) -> jax.Array:
    """Sampled softmax with a shared negative pool per batch (reference R7
    objective — BASELINE.json:10).

    Negatives are uniform over the catalog; the standard logQ correction
    (subtract log expected-count) is applied to negative logits so the
    sampled objective is a consistent estimator of full softmax CE.
    Accidental hits (a negative equal to the row's positive) are masked.
    ``impl`` picks how the [rows, S] negative logits are reduced (see
    ``sampled_nll``); every choice sees the same PRNG draw.
    """
    neg = draw_sampled_negatives(rng, num_sampled, num_pois)  # shared pool
    e_neg = jnp.take(table, neg, axis=0)  # [S, D]
    e_pos = jnp.take(table, targets, axis=0)  # [B, T, D]
    s_pos = jnp.einsum("btd,btd->bt", q, e_pos, preferred_element_type=jnp.float32) + bias[targets]
    nll = sampled_nll(q, e_neg, bias[neg], s_pos, targets, neg, num_sampled, num_pois, impl, interpret)
    return _masked_mean(nll, mask)


def sampled_nll(
    q: jax.Array,  # [B, T, D]
    e_neg: jax.Array,  # [S, D]
    b_neg: jax.Array,  # [S] raw negative biases (logQ applied here)
    s_pos: jax.Array,  # [B, T]
    targets: jax.Array,  # [B, T]
    neg: jax.Array,  # [S]
    num_sampled: int,
    num_pois: int,
    impl: str = "xla",
    interpret: bool = False,
) -> jax.Array:
    """[B, T] per-position sampled-softmax NLL from pre-gathered rows — the
    shared core of ``sampled_softmax_loss``, its vocab-sharded twin and the
    rows-gradient train step (train/loop.py sparse mode).

    logQ correction: uniform sampling w/ replacement, E[count_j] = S/V.
    Accidental hits (negative == row's positive) are masked. The combined
    log-sum-exp is computed as logaddexp(LSE(s_neg), s_pos) — identical to
    LSE([s_pos | s_neg]) but without materializing the [B, T, 1+S]
    concatenation.

    ``impl="xla"`` forms the [B, T, S] negative logits; ``impl="triton"``
    streams the pool through ``ops.online_lse`` and never stores them
    (``interpret`` runs that kernel in Pallas interpret mode, for tests).
    """
    b_neg = b_neg - jnp.log(num_sampled / num_pois)
    if impl == "triton":
        from poi_tpu.ops.online_lse import online_lse

        B, T, D = q.shape
        lse_neg = online_lse(
            q.reshape(B * T, D), e_neg, b_neg, targets.reshape(-1), neg, interpret
        ).reshape(B, T)
    elif impl == "xla":
        s_neg = (
            jnp.einsum(
                "btd,sd->bts",
                q.astype(jnp.bfloat16),
                e_neg.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
            + b_neg
        )
        hit = neg[None, None, :] == targets[..., None]
        lse_neg = jax.nn.logsumexp(jnp.where(hit, NEG, s_neg), axis=-1)
    else:
        raise ValueError(f"unknown sampled-softmax impl {impl!r}")
    return jnp.logaddexp(lse_neg, s_pos) - s_pos


def streamed_ce_loss(q, table, bias, targets, mask, interpret: bool = False) -> jax.Array:
    """Full-catalog CE through the streamed kernel (ops/online_lse.py): the
    same value as ``ce_loss`` without the [B, T, V] logits."""
    from poi_tpu.ops.online_lse import online_lse

    B, T, D = q.shape
    q2 = q.reshape(B * T, D)
    y = targets.reshape(-1)
    tgt_logit = (
        jnp.einsum(
            "nd,nd->n",
            q2.astype(jnp.bfloat16),
            jnp.take(table, y, axis=0).astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        + bias[y]
    )
    nll = online_lse(q2, table, bias, interpret=interpret) - tgt_logit
    return _masked_mean(nll, mask.reshape(-1))


def build_loss_fn(cfg: LossConfig, num_pois: int) -> Callable:
    """Returns loss(q, table, bias, targets, mask, rng) -> scalar, with the
    implementation chosen by ``poi_tpu.backend`` from platform and shape."""
    from poi_tpu import backend

    # The choice is made when the loss is traced, from the query width.
    if cfg.kind == "ce":

        def ce(q, t, b, y, m, rng):
            impl = backend.ce_impl(num_pois, q.shape[-1], cfg.label_smoothing)
            if impl == "triton":
                return streamed_ce_loss(q, t, b, y, m)
            if impl == "chunked":
                from poi_tpu.ops.fused_ce import fused_ce_loss

                return fused_ce_loss(q, t, b, y, m)
            return ce_loss(q, t, b, y, m, cfg.label_smoothing)

        return ce
    if cfg.kind == "bpr":
        return lambda q, t, b, y, m, rng: bpr_loss(q, t, b, y, m, rng, cfg.num_negatives, num_pois)
    if cfg.kind == "sampled_softmax":
        return lambda q, t, b, y, m, rng: sampled_softmax_loss(
            q, t, b, y, m, rng, cfg.num_sampled, num_pois,
            backend.sampled_impl(cfg.num_sampled, q.shape[-1]),
        )
    raise ValueError(f"unknown loss {cfg.kind!r}")

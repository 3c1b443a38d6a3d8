"""Chunked full-softmax cross-entropy in plain XLA (SURVEY.md §2.2 T10).

The textbook CE over a big catalog materializes [B·T, V] logits in device
memory three times (forward, softmax, backward). This implementation never
materializes more than one [B·T, chunk] tile at a time:

- forward: ``lax.scan`` over vocab chunks with online log-sum-exp (running
  max + rescaled partition sum) and a masked target-logit accumulator;
- backward (custom VJP): a second scan recomputes each chunk's logits (flash
  style: trade FLOPs for memory traffic), forms the chunk's softmax, and accumulates
  dq, dtable-chunk, dbias-chunk in place.

Peak extra memory: O(B·T·chunk). FLOPs: 3 matmuls over the catalog — the
same as the dense path. Each [B·T, chunk] tile still makes a round trip
through device memory; ``ops/online_lse.py`` is the GPU kernel that keeps
tiles on chip, and ``poi_tpu.backend.ce_impl`` chooses between them.

Numerics: bf16 operands / fp32 accumulation, exact log-sum-exp (two-pass max
via the online rescale). Property-tested against ``train.losses.ce_loss``
for values and all gradients.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -1e30


def _chunk(table: jax.Array, bias: jax.Array, chunk_v: int):
    v, d = table.shape
    n = -(-v // chunk_v)
    pad = n * chunk_v - v
    if pad:
        table = jnp.pad(table, ((0, pad), (0, 0)))
        bias = jnp.pad(bias, (0, pad), constant_values=NEG)
    return table.reshape(n, chunk_v, d), bias.reshape(n, chunk_v), n, pad


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def fused_ce_rows(q, table, bias, targets, chunk_v=2048):
    """Per-row negative log-likelihood of ``targets`` under softmax(q·Eᵀ+b).

    q: [N, D]; table: [V, D]; bias: [V]; targets: [N] int. Returns [N] fp32.
    """
    nll, _ = _forward(q, table, bias, targets, chunk_v)
    return nll


def _forward(q, table, bias, targets, chunk_v):
    n_rows = q.shape[0]
    tc, bc, n_chunks, _ = _chunk(table, bias, chunk_v)
    qb = q.astype(jnp.bfloat16)

    def body(carry, chunk):
        m, l, tgt = carry
        t_blk, b_blk, idx = chunk
        logits = (
            jnp.dot(qb, t_blk.astype(jnp.bfloat16).T, preferred_element_type=jnp.float32)
            + b_blk
        )  # [N, C]
        m_new = jnp.maximum(m, jnp.max(logits, axis=-1))
        l = l * jnp.exp(m - m_new) + jnp.sum(jnp.exp(logits - m_new[:, None]), axis=-1)
        # Target logit if it lives in this chunk.
        local = targets - idx * chunk_v
        hit = (local >= 0) & (local < chunk_v)
        picked = jnp.take_along_axis(logits, jnp.clip(local, 0, chunk_v - 1)[:, None], axis=1)[:, 0]
        tgt = tgt + jnp.where(hit, picked, 0.0)
        return (m_new, l, tgt), None

    m0 = jnp.full((n_rows,), NEG, jnp.float32)
    l0 = jnp.zeros((n_rows,), jnp.float32)
    t0 = jnp.zeros((n_rows,), jnp.float32)
    (m, l, tgt), _ = jax.lax.scan(body, (m0, l0, t0), (tc, bc, jnp.arange(n_chunks)))
    lse = jnp.log(l) + m
    return lse - tgt, lse


def _fwd(q, table, bias, targets, chunk_v):
    nll, lse = _forward(q, table, bias, targets, chunk_v)
    return nll, (q, table, bias, targets, lse)


def _bwd(chunk_v, res, g):
    q, table, bias, targets, lse = res
    v, d = table.shape
    tc, bc, n_chunks, pad = _chunk(table, bias, chunk_v)
    qb = q.astype(jnp.bfloat16)
    gb = g.astype(jnp.float32)

    def body(dq, chunk):
        t_blk, b_blk, idx = chunk
        logits = (
            jnp.dot(qb, t_blk.astype(jnp.bfloat16).T, preferred_element_type=jnp.float32)
            + b_blk
        )
        p = jnp.exp(logits - lse[:, None])  # softmax chunk [N, C]
        gp = (p * gb[:, None]).astype(jnp.bfloat16)
        # dNLL/dq += P_chunk @ E_chunk
        dq = dq + jnp.dot(gp, t_blk.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        # dNLL/dE_chunk = P_chunkᵀ @ q ; dNLL/db_chunk = colsum(P)
        dt_blk = jnp.dot(gp.T, qb, preferred_element_type=jnp.float32)
        db_blk = jnp.sum(p * gb[:, None], axis=0)
        return dq, (dt_blk, db_blk)

    dq0 = jnp.zeros(q.shape, jnp.float32)
    dq, (dt, db) = jax.lax.scan(body, dq0, (tc, bc, jnp.arange(n_chunks)))
    dtable = dt.reshape(-1, d)[:v]
    dbias = db.reshape(-1)[:v]
    # Subtract the one-hot target terms.
    e_tgt = jnp.take(table, targets, axis=0)
    dq = dq - gb[:, None] * e_tgt
    dtable = dtable.at[targets].add(-gb[:, None] * q)
    dbias = dbias.at[targets].add(-gb)
    return dq, dtable, dbias, None


fused_ce_rows.defvjp(_fwd, _bwd)


def fused_ce_loss(q, table, bias, targets, mask, chunk_v: int = 2048) -> jax.Array:
    """Masked-mean fused CE over [B, T, D] queries — drop-in for
    ``train.losses.ce_loss`` (same signature semantics). XLA-chunked path."""
    B, T, D = q.shape
    nll = fused_ce_rows(q.reshape(B * T, D), table, bias, targets.reshape(-1), chunk_v)
    m = mask.reshape(-1).astype(jnp.float32)
    return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

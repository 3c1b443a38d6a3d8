"""Windowed causal multi-head attention over check-in hidden states.

The attention model (reference R7, config #4 — BASELINE.json:10) attends over
the last-k check-ins. Implementations, all numerically equivalent:

- ``vanilla``:   full [T, T] masked scores. Simplest; fine for short T.
- ``blockwise``: flash-style online-softmax over KV blocks inside a
  ``lax.scan`` — O(T · block) memory, the long-context baseline
  (SURVEY.md §5 "Long-context/sequence parallelism").

Sequence-parallel modes (``ring`` / ``ulysses``) live in
``poi_tpu.parallel.sp_attention`` and reuse the blockwise inner loop here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def window_mask(t_q: int, t_kv: int, window: int, q_offset: int = 0, kv_offset: int = 0) -> jax.Array:
    """[t_q, t_kv] bool mask: query i attends key j iff j <= i and i - j < window.

    Offsets express global positions when the sequence is blocked/sharded:
    query block starts at ``q_offset``, key block at ``kv_offset``.
    """
    qi = q_offset + jnp.arange(t_q)[:, None]
    kj = kv_offset + jnp.arange(t_kv)[None, :]
    return (kj <= qi) & (qi - kj < window)


def vanilla_attention(q, k, v, window: int) -> jax.Array:
    """q, k, v: [B, H, T, Dh] → [B, H, T, Dh]. fp32 softmax."""
    T = q.shape[2]
    scale = q.shape[-1] ** -0.5
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * scale
    s = jnp.where(window_mask(T, T, window)[None, None], s, NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p.astype(v.dtype), v, preferred_element_type=jnp.float32)


def _online_block_update(carry, qk_inputs):
    """One online-softmax accumulation step (shared with ring attention).

    carry: (m [.., T_q, 1], l [.., T_q, 1], acc [.., T_q, Dh])
    qk_inputs: (s [.., T_q, T_kv] raw masked scores, v [.., T_kv, Dh])
    """
    m, l, acc = carry
    s, v = qk_inputs
    m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
    # Renormalize the existing accumulator, then fold in this block.
    alpha = jnp.exp(m - m_new)
    p = jnp.exp(s - m_new)
    l_new = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
    acc_new = acc * alpha + jnp.einsum(
        "...qk,...kd->...qd", p.astype(v.dtype), v, preferred_element_type=jnp.float32
    )
    return m_new, l_new, acc_new


def blockwise_attention(q, k, v, window: int, block_size: int = 128, kv_offset: int = 0) -> jax.Array:
    """Flash-style attention: scan over KV blocks with online softmax.

    q, k, v: [B, H, T, Dh]. ``kv_offset`` is the global position of k[...,0,:]
    relative to q's global positions (used by the ring mode where the local
    KV shard starts elsewhere in the sequence).
    """
    B, H, T, Dh = q.shape
    Tk = k.shape[2]
    scale = Dh ** -0.5
    nblocks = -(-Tk // block_size)
    pad = nblocks * block_size - Tk
    if pad:
        k = jnp.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0)))
        v = jnp.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0)))
    kb = k.reshape(B, H, nblocks, block_size, Dh).transpose(2, 0, 1, 3, 4)
    vb = v.reshape(B, H, nblocks, block_size, Dh).transpose(2, 0, 1, 3, 4)

    qi = jnp.arange(T)[:, None]

    def body(carry, inp):
        blk_idx, k_blk, v_blk = inp
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k_blk, preferred_element_type=jnp.float32) * scale
        kj = kv_offset + blk_idx * block_size + jnp.arange(block_size)[None, :]
        mask = (kj <= qi) & (qi - kj < window) & (kj < kv_offset + Tk)
        s = jnp.where(mask[None, None], s, NEG_INF)
        return _online_block_update(carry, (s, v_blk)), None

    m0 = jnp.full((B, H, T, 1), NEG_INF, jnp.float32)
    l0 = jnp.zeros((B, H, T, 1), jnp.float32)
    acc0 = jnp.zeros((B, H, T, Dh), jnp.float32)
    (m, l, acc), _ = jax.lax.scan(body, (m0, l0, acc0), (jnp.arange(nblocks), kb, vb))
    return acc / jnp.maximum(l, 1e-30)


def banded_attention(q, k, v, window: int) -> jax.Array:
    """Windowed attention computed only on the band that can be unmasked.

    ``blockwise``/``vanilla`` score every query against T (or block_size)
    keys and mask most of them away: with window W ≪ T that is T/W× wasted
    score work and softmax traffic. Here queries are grouped into W-sized
    blocks; block m can only attend keys in blocks m-1 and m (j ∈ (i-W, i]),
    so scores are [.., T, 2W] instead of [.., T, T] — pure reshapes, no
    gathers, numerically identical to ``vanilla_attention`` (equivalence
    tested across T/W shapes incl. ragged T).
    """
    B, H, T, Dh = q.shape
    W = window
    scale = Dh ** -0.5
    nb = -(-T // W)
    pad = nb * W - T
    if pad:
        q = jnp.pad(q, ((0, 0), (0, 0), (0, pad), (0, 0)))
        k = jnp.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0)))
        v = jnp.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0)))
    qb = q.reshape(B, H, nb, W, Dh)
    kb = k.reshape(B, H, nb, W, Dh)
    vb = v.reshape(B, H, nb, W, Dh)
    # Previous block (zeros before block 0), concatenated: [.., nb, 2W, Dh].
    k_prev = jnp.pad(kb, ((0, 0), (0, 0), (1, 0), (0, 0), (0, 0)))[:, :, :-1]
    v_prev = jnp.pad(vb, ((0, 0), (0, 0), (1, 0), (0, 0), (0, 0)))[:, :, :-1]
    k2 = jnp.concatenate([k_prev, kb], axis=3)
    v2 = jnp.concatenate([v_prev, vb], axis=3)
    s = jnp.einsum("bhmqd,bhmkd->bhmqk", qb, k2, preferred_element_type=jnp.float32) * scale
    # Query a (within block m) sits at i = mW+a; key b at j = (m-1)W+b:
    # j <= i and i-j < W  ⇔  a < b <= a+W; block 0's "previous" half is pad.
    a = jnp.arange(W)[:, None]
    b = jnp.arange(2 * W)[None, :]
    band = (b > a) & (b <= a + W)  # [W, 2W]
    first = jnp.arange(nb)[:, None, None] > 0
    mask = band[None] & (first | (b[None] >= W))  # [nb, W, 2W]
    s = jnp.where(mask[None, None], s, NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhmqk,bhmkd->bhmqd", p.astype(v2.dtype), v2, preferred_element_type=jnp.float32)
    return o.reshape(B, H, nb * W, Dh)[:, :, :T]


def multihead_attention_last(
    x: jax.Array,
    p: dict,
    num_heads: int,
    window: int,
    last: jax.Array,
    dtype=jnp.bfloat16,
) -> jax.Array:
    """Windowed causal MHA evaluated at ONE query position per row.

    ``x``: [B, T, D]; ``last``: [B] int — the (final valid) position to
    produce. Returns [B, D], numerically equal to
    ``multihead_attention(x, ...)[arange(B), last]``.

    Eval/serving fast path (VERDICT r4 Weak #1): the full-T path projects
    q/k/v and scores attention for every position and then keeps one — T×
    wasted attention/projection work per eval batch. Here k/v are projected
    only for the W-position window ending at ``last`` (query i attends
    j ∈ (i-W, i]), so the work is O(B·W·D) instead of O(B·T·D + B·T·W·D).
    """
    B, T, D = x.shape
    Dh = D // num_heads
    scale = Dh ** -0.5
    xd = x.astype(dtype)
    idx = last[:, None] - window + 1 + jnp.arange(window)[None, :]  # [B, W]
    valid = idx >= 0  # positions ≤ last are valid prefixes by construction
    idxc = jnp.clip(idx, 0, T - 1)
    xw = jnp.take_along_axis(xd, idxc[:, :, None], axis=1)  # [B, W, D]
    xq = jnp.take_along_axis(xd, last[:, None, None], axis=1)  # [B, 1, D]

    def proj(inp, w, t):
        y = jnp.dot(inp, w.astype(dtype), preferred_element_type=jnp.float32)
        return y.reshape(B, t, num_heads, Dh).transpose(0, 2, 1, 3).astype(dtype)

    q = proj(xq, p["wq"], 1)  # [B, H, 1, Dh]
    k = proj(xw, p["wk"], window)
    v = proj(xw, p["wv"], window)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * scale
    s = jnp.where(valid[:, None, None, :], s, NEG_INF)
    w_att = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum(
        "bhqk,bhkd->bhqd", w_att.astype(v.dtype), v, preferred_element_type=jnp.float32
    )
    o = o.transpose(0, 2, 1, 3).reshape(B, D)
    return jnp.dot(o.astype(dtype), p["wo"].astype(dtype), preferred_element_type=jnp.float32)


def multihead_attention(
    x: jax.Array,
    p: dict,
    num_heads: int,
    window: int,
    impl: str = "blockwise",
    block_size: int = 128,
    dtype=jnp.bfloat16,
) -> jax.Array:
    """[B, T, D] → [B, T, D] windowed causal MHA with projection params ``p``
    (wq, wk, wv, wo: [D, D])."""
    B, T, D = x.shape
    Dh = D // num_heads
    xd = x.astype(dtype)

    def proj(w):
        y = jnp.dot(xd, w.astype(dtype), preferred_element_type=jnp.float32)
        return y.reshape(B, T, num_heads, Dh).transpose(0, 2, 1, 3)

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    q, k, v = q.astype(dtype), k.astype(dtype), v.astype(dtype)
    if impl == "vanilla":
        o = vanilla_attention(q, k, v, window)
    elif impl == "banded" or (impl == "blockwise" and window >= 128 and T >= 2 * window):
        # The band formulation is numerically identical and skips the
        # provably-masked score tiles, but its [W, 2W] score matmuls are
        # far smaller than a good matrix-unit tile at config #4's W=16, so
        # the automatic dispatch requires window >= 128. The SP modes keep
        # the true blockwise inner loop (they need kv_offset).
        o = banded_attention(q, k, v, window)
    elif impl == "blockwise":
        o = blockwise_attention(q, k, v, window, block_size)
    else:
        raise ValueError(f"unknown attention impl {impl!r} (SP modes are applied in parallel/sp_attention)")
    o = o.transpose(0, 2, 1, 3).reshape(B, T, D)
    return jnp.dot(o.astype(dtype), p["wo"].astype(dtype), preferred_element_type=jnp.float32)

"""Sequence-parallel attention: ring and Ulysses modes (SURVEY.md §2.2 T4/T5).

The recurrent towers are step-serial (``lax.scan``) and cannot shard time;
the attention model's windowed MHA can. Both modes shard the TIME axis over
the 'model' mesh axis (SP borrows the model axis — batch stays sharded over
'data' only) and are numerically equivalent to local blockwise attention:

- **ring**: each device keeps its local KV block; blocks rotate around the
  'model' ring via ``ppermute`` while queries stay put, accumulating with the
  online-softmax update shared with ``ops.attention.blockwise_attention``.
  Comm per step = [B, 2, H, T/M, Dh] between cards, overlappable with the
  partial-attention matmuls.

- **ulysses**: one ``all_to_all`` resharding (seq-sharded → head-sharded),
  full-sequence local attention on H/M heads, ``all_to_all`` back. Cheaper
  than ring when #heads >= #shards and the window spans many blocks.

Both run inside ``shard_map``; the projections (wq/wk/wv/wo) are replicated
and applied shard-locally since they are pointwise over time.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from poi_tpu.ops.attention import NEG_INF, _online_block_update, blockwise_attention
from poi_tpu.parallel import collectives as cc
from poi_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def _ring_attention_local(q, k, v, window: int, axis: str):
    """Per-device body: q, k, v are [B, H, Tl, Dh] local (time-sharded)."""
    B, H, Tl, Dh = q.shape
    m_sz = cc.axis_size(axis)
    my = cc.axis_index(axis)
    scale = Dh ** -0.5
    q_off = my * Tl
    qi = q_off + jnp.arange(Tl)[:, None]

    def body(carry, step):
        m, l, acc, kv = carry
        k_blk, v_blk = kv
        src = (my - step) % m_sz
        kv_off = src * Tl
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k_blk, preferred_element_type=jnp.float32) * scale
        kj = kv_off + jnp.arange(Tl)[None, :]
        mask = (kj <= qi) & (qi - kj < window)
        s = jnp.where(mask[None, None], s, NEG_INF)
        m, l, acc = _online_block_update((m, l, acc), (s, v_blk))
        # Rotate KV around the ring (send right, receive from left).
        kv = jax.tree.map(lambda x: cc.ppermute_ring(x, axis, shift=1), kv)
        return (m, l, acc, kv), None

    m0 = jnp.full((B, H, Tl, 1), NEG_INF, jnp.float32)
    l0 = jnp.zeros((B, H, Tl, 1), jnp.float32)
    acc0 = jnp.zeros((B, H, Tl, Dh), jnp.float32)
    (m, l, acc, _), _ = jax.lax.scan(body, (m0, l0, acc0, (k, v)), jnp.arange(m_sz))
    return acc / jnp.maximum(l, 1e-30)


def _ulysses_attention_local(q, k, v, window: int, axis: str, block_size: int):
    """Per-device body: reshard seq→heads, local full-seq attention, back."""
    m_sz = cc.axis_size(axis)
    my = cc.axis_index(axis)
    B, H, Tl, Dh = q.shape
    if H % m_sz != 0:
        raise ValueError(f"ulysses needs heads ({H}) divisible by model shards ({m_sz})")

    def to_heads(x):  # [B, H, Tl, Dh] -> [B, H/M, T, Dh]
        # Head axis splits across devices; local seq blocks concatenate into
        # the full sequence (device order == global block order).
        return cc.all_to_all(x, axis, split_axis=1, concat_axis=2, tiled=True)

    def to_seq(o):  # [B, H/M, T, Dh] -> [B, H, Tl, Dh]
        return cc.all_to_all(o, axis, split_axis=2, concat_axis=1, tiled=True)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    o = blockwise_attention(qh, kh, vh, window, block_size)
    return to_seq(o.astype(q.dtype))


def make_sp_attention(mesh: Mesh, num_heads: int, window: int, impl: str, block_size: int = 128):
    """[B, T, D] (batch over 'data', time over 'model') windowed causal MHA.

    Returns mha(x, p) with projection params p = {wq, wk, wv, wo: [D, D]}.
    Input/output sharding: P('data', 'model', None).
    """
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown SP attention impl {impl!r}")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, MODEL_AXIS, None), P(None, None)),
        out_specs=P(DATA_AXIS, MODEL_AXIS, None),
        check_vma=False,
    )
    def mha_sharded(x, wqkvo):
        wq, wk, wv, wo = wqkvo
        B, Tl, D = x.shape
        Dh = D // num_heads

        def proj(w):
            y = jnp.einsum("btd,de->bte", x, w, preferred_element_type=jnp.float32)
            return y.reshape(B, Tl, num_heads, Dh).transpose(0, 2, 1, 3)

        q, k, v = proj(wq), proj(wk), proj(wv)
        if impl == "ring":
            o = _ring_attention_local(q, k, v, window, MODEL_AXIS)
        else:
            o = _ulysses_attention_local(q, k, v, window, MODEL_AXIS, block_size)
        o = o.transpose(0, 2, 1, 3).reshape(B, Tl, D)
        return jnp.einsum("btd,de->bte", o, wo, preferred_element_type=jnp.float32)

    def mha(x: jax.Array, p: dict) -> jax.Array:
        return mha_sharded(x, (p["wq"], p["wk"], p["wv"], p["wo"]))

    return mha

"""Attention-augmented sequence model (reference R7, config #4 —
BASELINE.json:10): a GRU tower whose states are refined by windowed causal
multi-head attention over the last-k check-ins, trained with sampled softmax.

Structure: embeddings → GRU layer → MHA(window=k) + residual → LayerNorm.
The attention implementation is selectable (vanilla / blockwise locally;
ring / Ulysses sequence-parallel via ``parallel.sp_attention`` when the
sequence axis is sharded).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from poi_tpu.models import base
from poi_tpu.models.base import register_model
from poi_tpu.models.gru import gru_layer, init_gru_layer
from poi_tpu.ops.attention import multihead_attention, multihead_attention_last


def init_mha(rng: jax.Array, d: int) -> dict:
    ks = jax.random.split(rng, 4)
    s = (1.0 / d) ** 0.5
    return {name: s * jax.random.normal(k, (d, d), jnp.float32) for name, k in zip(("wq", "wk", "wv", "wo"), ks)}


def layer_norm(p: dict, x: jax.Array) -> jax.Array:
    x32 = x.astype(jnp.float32)
    mu = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.var(x32, axis=-1, keepdims=True)
    return p["scale"] * (x32 - mu) * jax.lax.rsqrt(var + 1e-6) + p["bias"]


@register_model("attention")
class AttentionModel(base.SequenceModel):
    def init_tower(self, rng: jax.Array) -> dict:
        cfg = self.cfg
        k_gru, k_mha = jax.random.split(rng)
        return {
            "gru": init_gru_layer(k_gru, cfg.embed_dim, cfg.hidden_dim),
            "mha": init_mha(k_mha, cfg.hidden_dim),
            "ln": {
                "scale": jnp.ones((cfg.hidden_dim,), jnp.float32),
                "bias": jnp.zeros((cfg.hidden_dim,), jnp.float32),
            },
        }

    # Injected by the Trainer when attn_impl is 'ring'/'ulysses' and the
    # 'model' mesh axis is >1 (parallel/sp_attention.make_sp_attention).
    sp_mha = None

    def tower(self, tower_params: dict, x: jax.Array, batch) -> jax.Array:
        cfg = self.cfg
        dtype = base.compute_dtype(cfg)
        h = gru_layer(tower_params["gru"], x, batch.mask, dtype, remat=cfg.remat_cell)
        if self.sp_mha is not None:
            o = self.sp_mha(h, tower_params["mha"])
        else:
            attn_impl = cfg.attn_impl if cfg.attn_impl in ("vanilla", "blockwise") else "blockwise"
            o = multihead_attention(
                h,
                tower_params["mha"],
                num_heads=cfg.attn_heads,
                window=cfg.attn_window,
                impl=attn_impl,
                block_size=cfg.attn_block_size,
                dtype=dtype,
            )
        return layer_norm(tower_params["ln"], h + o)

    def tower_last(self, tower_params: dict, x: jax.Array, batch, last: jax.Array) -> jax.Array:
        """Eval/serving fast path: the GRU still scans all T, but attention +
        LayerNorm run only at the final valid position (its W-window), not
        for every position (VERDICT r4 Weak #1). Works for any attn_impl —
        a single query's windowed attention needs no blocking or sequence
        sharding."""
        cfg = self.cfg
        dtype = base.compute_dtype(cfg)
        h = gru_layer(tower_params["gru"], x, batch.mask, dtype, remat=cfg.remat_cell)
        o = multihead_attention_last(
            h, tower_params["mha"], num_heads=cfg.attn_heads,
            window=cfg.attn_window, last=last, dtype=dtype,
        )
        h_last = jnp.take_along_axis(h, last[:, None, None], axis=1)[:, 0]
        return layer_norm(tower_params["ln"], h_last + o)

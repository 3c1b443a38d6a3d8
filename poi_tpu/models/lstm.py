"""LSTM tower with user embedding, paired with BPR loss in config #2
(reference R5 — BASELINE.json:8).

Same layout as the GRU: hoisted [B*T, D] x [D, 4H] input projection, scan
body is one [B, H] x [H, 4H] matmul + elementwise gates. The user-embedding
addition to the scoring query is handled by ``base.add_user_query``
(cfg.use_user_embedding).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from poi_tpu.models import base
from poi_tpu.models.base import register_model


def init_lstm_layer(rng: jax.Array, d_in: int, d_h: int) -> dict:
    k1, k2 = jax.random.split(rng)
    b = jnp.zeros((4 * d_h,), jnp.float32)
    # Forget-gate bias starts at 1.0 (standard trick for gradient flow).
    b = b.at[d_h : 2 * d_h].set(1.0)
    return {
        "wx": (1.0 / d_in) ** 0.5 * jax.random.normal(k1, (d_in, 4 * d_h), jnp.float32),
        "wh": (1.0 / d_h) ** 0.5 * jax.random.normal(k2, (d_h, 4 * d_h), jnp.float32),
        "b": b,
    }


def lstm_layer(
    p: dict,
    x: jax.Array,
    mask: jax.Array | None,
    dtype,
    remat: bool = False,
) -> jax.Array:
    B, T, _ = x.shape
    H = p["wh"].shape[0]
    xw = (
        jnp.dot(x.astype(dtype), p["wx"].astype(dtype), preferred_element_type=jnp.float32)
        + p["b"]
    )
    wh = p["wh"].astype(dtype)

    def step(carry, xw_t):
        h, c = carry["h"], carry["c"]
        hw = jnp.dot(h.astype(dtype), wh, preferred_element_type=jnp.float32)
        xi, xf, xg, xo = jnp.split(xw_t, 4, axis=-1)
        hi, hf, hg, ho = jnp.split(hw, 4, axis=-1)
        i = jax.nn.sigmoid(xi + hi)
        f = jax.nn.sigmoid(xf + hf)
        g = jnp.tanh(xg + hg)
        o = jax.nn.sigmoid(xo + ho)
        c_new = f * c + i * g
        h_new = o * jnp.tanh(c_new)
        return {"h": h_new, "c": c_new}, h_new

    carry0 = {"h": jnp.zeros((B, H), jnp.float32), "c": jnp.zeros((B, H), jnp.float32)}
    return base.scan_time_major(step, carry0, xw, mask, remat=remat)


@register_model("lstm")
class LSTMModel(base.SequenceModel):
    def init_tower(self, rng: jax.Array) -> dict:
        cfg = self.cfg
        keys = jax.random.split(rng, cfg.num_layers)
        layers = []
        d_in = cfg.embed_dim
        for i in range(cfg.num_layers):
            layers.append(init_lstm_layer(keys[i], d_in, cfg.hidden_dim))
            d_in = cfg.hidden_dim
        return {"layers": layers}

    def tower(self, tower_params: dict, x: jax.Array, batch) -> jax.Array:
        dtype = base.compute_dtype(self.cfg)
        h = x
        for p in tower_params["layers"]:
            h = lstm_layer(p, h, batch.mask, dtype, remat=self.cfg.remat_cell)
        return h

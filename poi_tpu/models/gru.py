"""GRU next-POI tower (reference R4, config #1 — BASELINE.json:7).

Layout: the input-to-gate projection for ALL timesteps is one big
[B*T, D] x [D, 3H] matmul done outside the scan, so the ``lax.scan`` body is
a single [B, H] x [H, 3H] matmul plus elementwise gate math — the recurrent
serial chain does the minimum possible work per step. This replaces the
reference's ``theano.scan`` GRU recurrence (SURVEY.md §3.1a).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from poi_tpu.models import base
from poi_tpu.models.base import register_model


def init_gru_layer(rng: jax.Array, d_in: int, d_h: int) -> dict:
    k1, k2 = jax.random.split(rng)
    return {
        "wx": (1.0 / d_in) ** 0.5 * jax.random.normal(k1, (d_in, 3 * d_h), jnp.float32),
        "wh": (1.0 / d_h) ** 0.5 * jax.random.normal(k2, (d_h, 3 * d_h), jnp.float32),
        "b": jnp.zeros((3 * d_h,), jnp.float32),
    }


def gru_layer(
    p: dict,
    x: jax.Array,
    mask: jax.Array | None,
    dtype,
    remat: bool = False,
) -> jax.Array:
    """[B, T, D] → [B, T, H]."""
    B, T, _ = x.shape
    H = p["wh"].shape[0]
    # Hoisted input projection: one large matmul for all timesteps.
    xw = (
        jnp.dot(x.astype(dtype), p["wx"].astype(dtype), preferred_element_type=jnp.float32)
        + p["b"]
    )  # [B, T, 3H]
    wh = p["wh"].astype(dtype)

    def step(h, xw_t):
        hw = jnp.dot(h.astype(dtype), wh, preferred_element_type=jnp.float32)
        xz, xr, xn = jnp.split(xw_t, 3, axis=-1)
        hz, hr, hn = jnp.split(hw, 3, axis=-1)
        z = jax.nn.sigmoid(xz + hz)
        r = jax.nn.sigmoid(xr + hr)
        n = jnp.tanh(xn + r * hn)
        h_new = (1.0 - z) * h + z * n
        return h_new, h_new

    h0 = jnp.zeros((B, H), jnp.float32)
    return base.scan_time_major(step, h0, xw, mask, remat=remat)


@register_model("gru")
class GRUModel(base.SequenceModel):
    """Plain GRU tower; 64-d / batch-32 scale in config #1."""

    def init_tower(self, rng: jax.Array) -> dict:
        cfg = self.cfg
        keys = jax.random.split(rng, cfg.num_layers)
        layers = []
        d_in = cfg.embed_dim
        for i in range(cfg.num_layers):
            layers.append(init_gru_layer(keys[i], d_in, cfg.hidden_dim))
            d_in = cfg.hidden_dim
        return {"layers": layers}

    def tower(self, tower_params: dict, x: jax.Array, batch) -> jax.Array:
        dtype = base.compute_dtype(self.cfg)
        mask = batch.mask
        h = x
        for p in tower_params["layers"]:
            h = gru_layer(p, h, mask, dtype, remat=self.cfg.remat_cell)
        return h

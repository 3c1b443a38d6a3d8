"""ST-RNN tower: spatial-temporal transition interpolation (reference R6,
config #3 — BASELINE.json:9; ST-RNN, Liu et al. AAAI'16 lineage).

The recurrence is

    h_t = tanh( T(dt_t) @ S(dd_t) @ x_t  +  C @ h_{t-1}  + b )

where ``T(dt)`` / ``S(dd)`` are d×d matrices linearly interpolated between
learned bucket-endpoint matrices by the continuous time-gap / geo-distance
since the previous check-in. The loader precomputes (lower-bucket index,
fraction) pairs at data quantiles (``data/dataset.py:bucketize_interp``), so
the model never bucketizes on device.

Trick (SURVEY.md §7 "hard parts"): instead of gathering a per-step
[B, d, d] interpolated matrix (memory-bandwidth bound), we apply EVERY
endpoint matrix to the inputs with one einsum — K+1 matmuls over the whole
[B, T] block — and then lerp between the two relevant results per step:

    S(dd) x = (1-w) * (x @ S_lo^T) + w * (x @ S_hi^T)

Both applications happen OUTSIDE the scan; the scan body is a single
[B, H] x [H, H] matmul, identical in cost to a vanilla RNN step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from poi_tpu.models import base
from poi_tpu.models.base import register_model


def apply_interpolated(tables: jax.Array, x: jax.Array, idx: jax.Array, frac: jax.Array, dtype) -> jax.Array:
    """y[b,t] = lerp(tables[idx], tables[idx+1], frac) @ x[b,t].

    tables: [K+1, D, D] endpoint matrices (applied as x @ M^T)
    x:      [B, T, D]
    idx:    [B, T] int32 in [0, K-1]; frac: [B, T] in [0, 1]
    """
    # One batched einsum applies all endpoints: [B, T, K+1, D].
    all_applied = jnp.einsum(
        "btd,ked->btke",
        x.astype(dtype),
        tables.astype(dtype),
        preferred_element_type=jnp.float32,
    )
    lo = jnp.take_along_axis(all_applied, idx[:, :, None, None], axis=2)[:, :, 0]
    hi = jnp.take_along_axis(all_applied, (idx + 1)[:, :, None, None], axis=2)[:, :, 0]
    w = frac[:, :, None]
    return (1.0 - w) * lo + w * hi


def init_strnn_layer(rng, d: int, h: int, k_time: int, k_dist: int) -> dict:
    ks = jax.random.split(rng, 4)
    # Endpoint matrices near identity so early training behaves like a vanilla RNN.
    eye = jnp.eye(d, dtype=jnp.float32)
    noise = lambda k, n: 0.02 * jax.random.normal(k, (n, d, d), jnp.float32)  # noqa: E731
    return {
        "t_tab": eye[None] + noise(ks[0], k_time + 1),  # [Kt+1, D, D]
        "s_tab": eye[None] + noise(ks[1], k_dist + 1),  # [Kd+1, D, D]
        "w_in": (1.0 / d) ** 0.5 * jax.random.normal(ks[2], (d, h), jnp.float32),
        "c": (1.0 / h) ** 0.5 * jax.random.normal(ks[3], (h, h), jnp.float32),
        "b": jnp.zeros((h,), jnp.float32),
    }


@register_model("strnn")
class STRNNModel(base.SequenceModel):
    def init_tower(self, rng: jax.Array) -> dict:
        cfg, dims = self.cfg, self.dims
        return {
            "layer": init_strnn_layer(
                rng, cfg.embed_dim, cfg.hidden_dim, dims.num_tgap_buckets, dims.num_dist_buckets
            )
        }

    def tower(self, tower_params: dict, x: jax.Array, batch) -> jax.Array:
        p = tower_params["layer"]
        cfg = self.cfg
        dtype = base.compute_dtype(cfg)
        B = x.shape[0]

        # Spatial then temporal transition applied to inputs, fully hoisted.
        sx = apply_interpolated(p["s_tab"], x, batch.dist_idx, batch.dist_frac, dtype)
        tsx = apply_interpolated(p["t_tab"], sx, batch.tgap_idx, batch.tgap_frac, dtype)
        xin = (
            jnp.dot(tsx.astype(dtype), p["w_in"].astype(dtype), preferred_element_type=jnp.float32)
            + p["b"]
        )  # [B, T, H]

        c = p["c"].astype(dtype)

        def step(h, xin_t):
            h_new = jnp.tanh(
                xin_t + jnp.dot(h.astype(dtype), c, preferred_element_type=jnp.float32)
            )
            return h_new, h_new

        h0 = jnp.zeros((B, cfg.hidden_dim), jnp.float32)
        return base.scan_time_major(step, h0, xin, batch.mask, remat=cfg.remat_cell)

"""Model layer common machinery.

Models are pure-functional: ``init(rng) -> params`` (a plain dict pytree) and
``queries(params, batch) -> [B, T, D]`` producing, for every sequence
position, the scoring query vector. Scoring against the (possibly
vocab-sharded) POI output table is owned by the loss / eval layers, so the
tower code never materializes catalog-wide logits.

Capability parity (SURVEY.md §2.1): R3 embedding tables (POI / user / time /
geo) live here; R4-R7 towers are one file per model, registered in
``MODEL_REGISTRY``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from poi_tpu.data.pipeline import Batch
from poi_tpu.utils.config import ModelConfig

# lookup_fn(table [V, D], ids [...]) -> [..., D]; injected so the same tower
# runs with a dense gather (single chip) or the sharded lookup (ops/embedding).
LookupFn = Callable[[jax.Array, jax.Array], jax.Array]


def dense_lookup(table: jax.Array, ids: jax.Array) -> jax.Array:
    return jnp.take(table, ids, axis=0)


@dataclass(frozen=True)
class DataDims:
    """Catalog sizes the parameter shapes depend on.

    ``num_pois_padded`` >= num_pois rounds the catalog up to a multiple of the
    'model' mesh axis so tables row-shard evenly (shard_map requires even
    blocks). Padded rows are neutralized by a -1e30 output bias at init: they
    never appear in a softmax partition function or a top-k, and their zero
    softmax probability means zero gradient, so they stay inert forever.
    """

    num_users: int
    num_pois: int
    num_time_buckets: int
    num_geo_buckets: int
    num_tgap_buckets: int
    num_dist_buckets: int
    num_pois_padded: int = 0  # 0 → defaults to num_pois

    def __post_init__(self):
        if self.num_pois_padded == 0:
            object.__setattr__(self, "num_pois_padded", self.num_pois)

    def padded_to(self, model_shards: int) -> "DataDims":
        """Rounds the padded catalog up to a multiple of ``model_shards``
        (keeping any larger padding already applied, so a one-card run can
        hold the same table shapes as a sharded one)."""
        import dataclasses

        pad = -(-self.num_pois_padded // model_shards) * model_shards
        return dataclasses.replace(self, num_pois_padded=pad)

    @classmethod
    def from_dataset(cls, ds) -> "DataDims":
        return cls(
            num_users=ds.num_users,
            num_pois=ds.num_pois,
            num_time_buckets=ds.num_time_buckets,
            num_geo_buckets=ds.num_geo_buckets,
            num_tgap_buckets=ds.num_tgap_buckets,
            num_dist_buckets=ds.num_dist_buckets,
        )


def compute_dtype(cfg: ModelConfig):
    return jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32


# --------------------------------------------------------------------------- #
# Embedding tables (reference R3)
# --------------------------------------------------------------------------- #


def init_embed_params(rng: jax.Array, cfg: ModelConfig, dims: DataDims) -> dict:
    """POI/user/time/geo tables + output bias (+ untied output table)."""
    keys = jax.random.split(rng, 6)
    scale = 0.02
    d = cfg.embed_dim
    vp = dims.num_pois_padded
    # Padded rows get a -1e30 bias: zero softmax probability, never in top-k,
    # zero gradient — the one-line answer to uneven vocab sharding.
    bias = jnp.where(jnp.arange(vp) < dims.num_pois, 0.0, -1e30).astype(jnp.float32)
    p = {
        "poi": scale * jax.random.normal(keys[0], (vp, d), jnp.float32),
        "out_bias": bias,
    }
    if cfg.use_user_embedding:
        p["user"] = scale * jax.random.normal(keys[1], (dims.num_users, d), jnp.float32)
    if cfg.use_time_embedding:
        p["time"] = scale * jax.random.normal(keys[2], (dims.num_time_buckets, d), jnp.float32)
    if cfg.use_geo_embedding:
        p["geo"] = scale * jax.random.normal(keys[3], (dims.num_geo_buckets, d), jnp.float32)
    if not cfg.tie_output_embedding:
        p["out"] = scale * jax.random.normal(keys[4], (vp, d), jnp.float32)
    return p


def input_embeddings(
    embed: dict,
    batch: Batch,
    cfg: ModelConfig,
    lookup: LookupFn = dense_lookup,
    poi_rows: jax.Array | None = None,
) -> jax.Array:
    """Sum of POI + time + geo embeddings per input step → [B, T, D].

    Only the POI table goes through the (possibly sharded) ``lookup``; the
    small time/geo tables are replicated and use a local gather.

    ``poi_rows`` ([B, T, D], = table[batch.poi_in]) substitutes for the POI
    lookup when the caller pre-gathered the rows — the rows-gradient train
    step (train/loop.py sparse mode) differentiates w.r.t. these rows so the
    dense [V, D] table cotangent is never materialized; ``embed`` may then
    omit the "poi" entry entirely.
    """
    x = poi_rows if poi_rows is not None else lookup(embed["poi"], batch.poi_in)
    if cfg.use_time_embedding:
        x = x + jnp.take(embed["time"], batch.time_bucket, axis=0)
    if cfg.use_geo_embedding:
        x = x + jnp.take(embed["geo"], batch.geo_bucket, axis=0)
    return x


def output_table(params: dict, cfg: ModelConfig) -> tuple[jax.Array, jax.Array]:
    """The [V, D] table + [V] bias that queries are scored against."""
    embed = params["embed"]
    table = embed["poi"] if cfg.tie_output_embedding else embed["out"]
    return table, embed["out_bias"]


def add_user_query(q: jax.Array, params: dict, batch: Batch, cfg: ModelConfig) -> jax.Array:
    """Reference R5 behavior: add the user vector to the scoring query."""
    if cfg.use_user_embedding:
        q = q + jnp.take(params["embed"]["user"], batch.user, axis=0)[:, None, :]
    return q


# --------------------------------------------------------------------------- #
# Dense layers
# --------------------------------------------------------------------------- #


def dropout(x: jax.Array, rate: float, rng: jax.Array | None) -> jax.Array:
    """Inverted dropout. Identity when ``rng`` is None (eval mode) or rate 0 —
    so the same ``queries`` call site serves train and eval."""
    if rng is None or rate <= 0.0:
        return x
    keep = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0.0)


def init_linear(rng: jax.Array, n_in: int, n_out: int, scale: float | None = None) -> dict:
    if scale is None:
        scale = (1.0 / n_in) ** 0.5
    return {
        "kernel": scale * jax.random.normal(rng, (n_in, n_out), jnp.float32),
        "bias": jnp.zeros((n_out,), jnp.float32),
    }


def linear(p: dict, x: jax.Array, dtype=jnp.float32) -> jax.Array:
    return (
        jnp.dot(x.astype(dtype), p["kernel"].astype(dtype), preferred_element_type=jnp.float32)
        + p["bias"]
    )


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

MODEL_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def build_model(cfg: ModelConfig, dims: DataDims, lookup: LookupFn = dense_lookup):
    if cfg.kind not in MODEL_REGISTRY:
        # Import side-effect registration.
        import poi_tpu.models.gru  # noqa: F401
        import poi_tpu.models.lstm  # noqa: F401
        import poi_tpu.models.strnn  # noqa: F401
        import poi_tpu.models.attention  # noqa: F401
    if cfg.kind not in MODEL_REGISTRY:
        raise KeyError(f"unknown model kind {cfg.kind!r}: have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[cfg.kind](cfg, dims, lookup)


class SequenceModel:
    """Base: embeddings + tower + output projection to query space."""

    def __init__(self, cfg: ModelConfig, dims: DataDims, lookup: LookupFn = dense_lookup):
        self.cfg = cfg
        self.dims = dims
        self.lookup = lookup

    # -- subclass surface ---------------------------------------------------
    def init_tower(self, rng: jax.Array) -> dict:
        raise NotImplementedError

    def tower(self, tower_params: dict, x: jax.Array, batch: Batch) -> jax.Array:
        """[B, T, D] inputs → [B, T, H] hidden states."""
        raise NotImplementedError

    # -- shared -------------------------------------------------------------
    def init(self, rng: jax.Array) -> dict:
        k_embed, k_tower, k_proj = jax.random.split(rng, 3)
        params = {
            "embed": init_embed_params(k_embed, self.cfg, self.dims),
            "tower": self.init_tower(k_tower),
        }
        if self.cfg.hidden_dim != self.cfg.embed_dim or not self.cfg.tie_output_embedding:
            params["proj"] = init_linear(k_proj, self.cfg.hidden_dim, self.cfg.embed_dim)
        return params

    def queries(
        self,
        params: dict,
        batch: Batch,
        rng: jax.Array | None = None,
        poi_rows: jax.Array | None = None,
    ) -> jax.Array:
        """[B, T, D] scoring queries (fp32). named_scope regions show up in
        profiler traces (SURVEY.md §5 tracing).

        ``rng`` enables train-mode dropout (``cfg.dropout``) on the summed
        input embeddings and the tower output; eval passes no rng and gets
        the deterministic path. ``poi_rows`` pre-gathered input rows — see
        ``input_embeddings``.
        """
        k_in = k_out = None
        if rng is not None and self.cfg.dropout > 0.0:
            k_in, k_out = jax.random.split(rng)
        with jax.named_scope("embed_lookup"):
            x = input_embeddings(params["embed"], batch, self.cfg, self.lookup, poi_rows)
            x = dropout(x, self.cfg.dropout, k_in)
        with jax.named_scope(f"tower_{self.cfg.kind}"):
            h = self.tower(params["tower"], x, batch)
            h = dropout(h, self.cfg.dropout, k_out)
        with jax.named_scope("query_proj"):
            q = linear(params["proj"], h, compute_dtype(self.cfg)) if "proj" in params else h
            return add_user_query(q.astype(jnp.float32), params, batch, self.cfg)

    def tower_last(self, tower_params: dict, x: jax.Array, batch: Batch, last: jax.Array) -> jax.Array:
        """[B, H] hidden state at position ``last`` per row. Default: run the
        full tower (a recurrence must traverse T anyway) and select; models
        with per-position work beyond the recurrence (attention) override
        this to compute only the final position's share."""
        h = self.tower(tower_params, x, batch)
        return jnp.take_along_axis(h, last[:, None, None], axis=1)[:, 0]

    def queries_last(self, params: dict, batch: Batch) -> jax.Array:
        """[B, D] scoring query at each sequence's final valid position — the
        eval/serving fast path (VERDICT r4 Weak #1). Numerically equal to
        ``queries(params, batch)`` gathered at the last valid position (the
        validity mask is a prefix, so positions after it cannot influence the
        causal tower there; parity-tested per model in tests/test_models.py),
        but the output projection, user-add, and (for the attention model)
        the windowed attention run once per row instead of once per position.
        Always deterministic (eval mode — no dropout)."""
        with jax.named_scope("embed_lookup"):
            x = input_embeddings(params["embed"], batch, self.cfg, self.lookup)
        last = jnp.maximum(jnp.sum(batch.mask.astype(jnp.int32), axis=1) - 1, 0)
        with jax.named_scope(f"tower_{self.cfg.kind}_last"):
            h = self.tower_last(params["tower"], x, batch, last)
        with jax.named_scope("query_proj"):
            q = linear(params["proj"], h, compute_dtype(self.cfg)) if "proj" in params else h
            # One user-add implementation: route through the shared helper
            # (which works on [B, T, D]) with a singleton time axis.
            return add_user_query(
                q.astype(jnp.float32)[:, None, :], params, batch, self.cfg
            )[:, 0]


def scan_time_major(
    step_fn, carry_init, xs_btx: tuple, mask: jax.Array | None = None, remat: bool = False
):
    """Run ``step_fn`` over the time axis of [B, T, ...] arrays via lax.scan.

    ``step_fn(carry, xs_t) -> (carry, h_t)``. When ``mask`` is given, padded
    steps pass the carry through unchanged (functional equivalent of the
    reference's ragged per-user loops, but compiled once with static shapes).
    Returns [B, T, H] stacked outputs.

    ``remat=True`` wraps the cell in ``jax.checkpoint``: the backward pass
    recomputes per-step gate intermediates from the carried state instead of
    storing them for all T — O(T·B·H) saved residual memory shrinks to the
    stacked outputs alone, trading a second cell evaluation per step
    (SURVEY.md §5 "long-context": optional remat on the cell for long T).
    """
    if remat:
        step_fn = jax.checkpoint(step_fn)
    xs_tb = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), xs_btx)

    if mask is not None:
        mask_tb = jnp.swapaxes(mask, 0, 1)

        def masked_step(carry, inp):
            m_t, xs_t = inp
            new_carry, h_t = step_fn(carry, xs_t)
            keep = m_t[:, None]
            new_carry = jax.tree.map(
                lambda n, o: jnp.where(keep, n, o), new_carry, carry
            )
            return new_carry, h_t

        _, h = jax.lax.scan(masked_step, carry_init, (mask_tb, xs_tb))
    else:
        _, h = jax.lax.scan(step_fn, carry_init, xs_tb)
    return jnp.swapaxes(h, 0, 1)

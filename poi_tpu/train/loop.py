"""The pjit'd training loop (reference R9 → SURVEY.md §3.2a call stack).

``Trainer`` owns: model, loss, optimizer, mesh, and the compiled train step.
The step is a single jit-compiled function over the global mesh — batch
sharded on 'data', vocab tables sharded on 'model' — so XLA GSPMD inserts the
gradient psum over 'data' and the table collectives over 'model'
automatically; the explicitly-collective embedding/loss paths (shard_map)
plug in through the model's ``lookup`` and the loss builder.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from poi_tpu import backend
from poi_tpu.data.dataset import Dataset
from poi_tpu.data.pipeline import Batch, make_train_loader
from poi_tpu.models import base as model_base
from poi_tpu.parallel import mesh as mesh_lib
from poi_tpu.parallel.shardings import batch_shardings, replicated_shardings, state_shardings
from poi_tpu.train.losses import build_loss_fn
from poi_tpu.train.state import TrainState, init_state, make_optimizer
from poi_tpu.utils.config import Config

log = logging.getLogger(__name__)



class FaultInjected(RuntimeError):
    """Raised by --set train.fault_inject_step=N to exercise resume (SURVEY.md §5)."""


@dataclass
class Trainer:
    cfg: Config
    dims: model_base.DataDims
    mesh: Any = None
    lookup: Callable | None = None  # injected sharded lookup (ops/embedding)
    loss_override: Callable | None = None  # injected sharded loss
    sampler: Any = None  # data.device_sampler.DeviceSampler for in-graph batches
    active_loader: Any = field(init=False, default=None)  # set by train(); lets callbacks checkpoint loader state
    _step_fn: Callable = field(init=False, default=None)
    _chunk_fn: Callable = field(init=False, default=None)
    _chunk_len: int = field(init=False, default=0)

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = mesh_lib.make_mesh(self.cfg.mesh.data, self.cfg.mesh.model)
        n_model = self.mesh.shape[mesh_lib.MODEL_AXIS]
        self.dims = self.dims.padded_to(n_model)
        lookup = self.lookup
        if lookup is None:
            if n_model > 1:
                from poi_tpu.ops.embedding import make_lookup

                lookup = make_lookup(
                    self.mesh, self.cfg.mesh.embedding_mode, self.cfg.mesh.a2a_capacity_factor
                )
            else:
                lookup = model_base.dense_lookup
        self.model = model_base.build_model(self.cfg.model, self.dims, lookup)
        if (
            self.cfg.model.kind == "attention"
            and self.cfg.model.attn_impl in ("ring", "ulysses")
        ):
            if n_model > 1:
                from poi_tpu.parallel.sp_attention import make_sp_attention

                self.model.sp_mha = make_sp_attention(
                    self.mesh,
                    self.cfg.model.attn_heads,
                    self.cfg.model.attn_window,
                    self.cfg.model.attn_impl,
                    self.cfg.model.attn_block_size,
                )
            else:
                # SP attention needs a model axis to shard the sequence over.
                log.info(
                    "model.attn_impl=%r requested but mesh model axis is 1; "
                    "falling back to single-device blockwise attention",
                    self.cfg.model.attn_impl,
                )
        loss_fn = self.loss_override
        if loss_fn is None:
            if n_model > 1:
                from poi_tpu.ops import sharded_loss

                kind = self.cfg.loss.kind
                if kind == "ce":
                    loss_fn = sharded_loss.make_sharded_ce(self.mesh)
                elif kind == "bpr":
                    loss_fn = sharded_loss.make_sharded_bpr(
                        self.mesh, lookup, self.cfg.loss.num_negatives, self.dims.num_pois
                    )
                elif kind == "sampled_softmax":
                    loss_fn = sharded_loss.make_sharded_sampled_softmax(
                        self.mesh, lookup, self.cfg.loss.num_sampled, self.dims.num_pois,
                        impl=backend.sampled_impl(
                            self.cfg.loss.num_sampled, self.cfg.model.embed_dim
                        ),
                    )
            if loss_fn is None:
                loss_fn = build_loss_fn(self.cfg.loss, self.dims.num_pois)
        self.loss_fn = loss_fn
        if self.cfg.train.table_update == "sparse":
            from poi_tpu.train.sparse_opt import SparseTableOptimizer

            self.optimizer = SparseTableOptimizer(self.cfg)
        elif self.cfg.train.table_update == "dense":
            self.optimizer = make_optimizer(self.cfg.train)
        else:
            raise ValueError(
                f"unknown train.table_update {self.cfg.train.table_update!r}"
            )

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int | None = None) -> TrainState:
        """Params are born sharded: init is jit'd with out_shardings so large
        tables never materialize unsharded on one host (SURVEY.md §3.2c)."""
        seed = self.cfg.train.seed if seed is None else seed
        rng = jax.random.key(seed)

        def _init(rng):
            k_param, k_state = jax.random.split(rng)
            params = self.model.init(k_param)
            return init_state(k_state, params, self.optimizer)

        shapes = jax.eval_shape(_init, rng)
        shardings = state_shardings(shapes, self.mesh, self.dims.num_pois_padded)
        return jax.jit(_init, out_shardings=shardings)(rng)

    # ------------------------------------------------------------------ step
    def _step_core(self):
        model, loss_fn, optimizer = self.model, self.loss_fn, self.optimizer
        cfg = self.cfg
        n_model = self.mesh.shape[mesh_lib.MODEL_AXIS]
        a2a_shards = n_model if (cfg.mesh.embedding_mode == "a2a" and n_model > 1) else 1
        use_sparse = cfg.train.table_update == "sparse"
        # Rows-gradient mode (the full VERDICT r4 Next #1 treatment): with a
        # tied-table sampled-softmax objective on an unsharded vocab, the
        # step differentiates w.r.t. the GATHERED table rows instead of the
        # table — the dense [V, D] cotangent (zeros + scatter-add over the
        # whole table) never exists.
        # Other sparse configs (bpr, vocab-sharded, untied) keep dense
        # gradients and only the optimizer reads/writes turn sparse.
        from poi_tpu.train import sparse_opt as _sparse_opt

        use_rows = _sparse_opt.rows_mode_enabled(cfg, self.dims, n_model)
        sampled_impl = backend.sampled_impl(cfg.loss.num_sampled, cfg.model.embed_dim)

        def step_fn(state: TrainState, batch: Batch):
            rng = jax.random.fold_in(state.rng, state.step)
            # Dropout gets its own stream ONLY when enabled, so dropout=0 runs
            # keep the exact sampling streams of older golden-metric runs.
            rng_drop = None
            if cfg.model.dropout > 0.0:
                rng, rng_drop = jax.random.split(rng)

            def compute_loss(params):
                q = model.queries(params, batch, rng=rng_drop)
                table, bias = model_base.output_table(params, cfg.model)
                return loss_fn(q, table, bias, batch.poi_tgt, batch.mask, rng)

            grad_norm_free = None  # exact global grad norm, when free
            if use_rows:
                loss, params, opt_state, grad_norm_free = self._rows_step(
                    state, batch, rng, rng_drop, sampled_impl
                )
            elif use_sparse:
                from poi_tpu.train.sparse_opt import touched_ids

                loss, grads = jax.value_and_grad(compute_loss)(state.params)
                ids = touched_ids(cfg, batch, rng, self.dims.num_pois)
                params, opt_state, grad_norm_free = optimizer.update_apply(
                    grads, state.opt_state, state.params, ids
                )
            else:
                loss, grads = jax.value_and_grad(compute_loss)(state.params)
                updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
                params = optax.apply_updates(state.params, updates)
            from poi_tpu.train.state import lr_schedule

            # The two global norms are observability-only and cost two full
            # param+grad tree reductions. Every consumer (history rows, the
            # log line) reads them only on steps where
            # (step+1) % log_every == 0, so they are computed exactly there
            # and reported 0.0 elsewhere (VERDICT r3 Next #3). The sparse paths compute the grad norm for
            # clipping anyway, so it is reported on every step there.
            # The final history row also reports norms even when num_steps is
            # not a multiple of log_every (ADVICE r4: it logged grad 0.000).
            is_log_step = ((state.step + 1) % max(1, cfg.train.log_every) == 0) | (
                state.step + 1 == cfg.train.num_steps
            )
            if grad_norm_free is not None:
                grad_norm = grad_norm_free.astype(jnp.float32)
                param_norm = jax.lax.cond(
                    is_log_step,
                    lambda: optax.global_norm(params).astype(jnp.float32),
                    lambda: jnp.float32(0.0),
                )
            else:
                grad_norm, param_norm = jax.lax.cond(
                    is_log_step,
                    lambda: (optax.global_norm(grads).astype(jnp.float32),
                             optax.global_norm(params).astype(jnp.float32)),
                    lambda: (jnp.float32(0.0), jnp.float32(0.0)),
                )
            metrics = {
                "loss": loss,
                "grad_norm": grad_norm,
                "param_norm": param_norm,
                "lr": lr_schedule(cfg.train)(state.step),
            }
            if a2a_shards > 1:
                # MoE-style capacity guard (SURVEY.md §7 "ragged all-to-all"):
                # fraction of ids that would overflow the fixed a2a buckets.
                from poi_tpu.ops.embedding import lookup_overflow_fraction

                metrics["a2a_overflow"] = lookup_overflow_fraction(
                    batch.poi_in,
                    a2a_shards,
                    self.dims.num_pois_padded // a2a_shards,
                    cfg.mesh.a2a_capacity_factor,
                    data_shards=self.mesh.shape[mesh_lib.DATA_AXIS],
                )
            new_state = TrainState(state.step + 1, params, opt_state, state.rng)
            return new_state, metrics

        metric_keys = {"loss": 0.0, "grad_norm": 0.0, "param_norm": 0.0, "lr": 0.0}
        if a2a_shards > 1:
            metric_keys["a2a_overflow"] = 0.0
        return step_fn, metric_keys

    def _rows_step(self, state: TrainState, batch: Batch, rng, rng_drop, impl: str):
        """One rows-gradient train step body (traced inside step_fn).

        Gathers every POI-table row the step can touch — inputs, targets,
        and the shared negative pool — ONCE up front, then differentiates
        w.r.t. those [N, D] rows (plus the bias rows and the non-table
        params). The dense [V, D] table cotangent is never built; duplicate
        occurrences are summed by the optimizer's ``dedup_sum`` exactly as
        the dense scatter-add would have (identical updates to the
        dense-grad sparse path — parity-tested in tests/test_sparse_opt.py).
        """
        from poi_tpu.train.losses import draw_sampled_negatives, sampled_nll

        cfg, model = self.cfg, self.model
        B, T = batch.poi_tgt.shape
        BT = B * T
        S = cfg.loss.num_sampled
        V = self.dims.num_pois
        neg = draw_sampled_negatives(rng, S, V)
        ids_all = jnp.concatenate(
            [batch.poi_in.ravel(), batch.poi_tgt.ravel(), neg]
        ).astype(jnp.int32)
        table = state.params["embed"]["poi"]
        bias = state.params["embed"]["out_bias"]
        rows0 = jnp.take(table, ids_all, axis=0)  # [N, D]
        brows0 = jnp.take(bias, ids_all, axis=0)  # [N]
        rest = {
            k: ({kk: vv for kk, vv in v.items() if kk not in ("poi", "out_bias")}
                if k == "embed" else v)
            for k, v in state.params.items()
        }

        def compute_loss(rest_p, rows, brows):
            x_rows = rows[:BT].reshape(B, T, -1)
            q = model.queries(rest_p, batch, rng=rng_drop, poi_rows=x_rows)
            e_pos = rows[BT : 2 * BT].reshape(B, T, -1)
            b_pos = brows[BT : 2 * BT].reshape(B, T)
            e_neg = rows[2 * BT :]
            b_neg = brows[2 * BT :]
            s_pos = (
                jnp.einsum("btd,btd->bt", q, e_pos, preferred_element_type=jnp.float32)
                + b_pos
            )
            nll = sampled_nll(q, e_neg, b_neg, s_pos, batch.poi_tgt, neg, S, V, impl)
            m = batch.mask.astype(jnp.float32)
            return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

        loss, (g_rest, g_rows, g_brows) = jax.value_and_grad(
            compute_loss, argnums=(0, 1, 2)
        )(rest, rows0, brows0)
        # Rebuild a params-structured grads tree; the table leaves carry
        # placeholders — their gradients travel as rows via row_grads.
        g_embed = dict(g_rest["embed"])
        g_embed["poi"] = jnp.zeros((), jnp.float32)
        g_embed["out_bias"] = jnp.zeros((), jnp.float32)
        grads = {**g_rest, "embed": g_embed}
        ids = {"user": batch.user.ravel().astype(jnp.int32)}
        params, opt_state, gnorm = self.optimizer.update_apply(
            grads, state.opt_state, state.params, ids,
            row_grads={"poi": (ids_all, g_rows), "out_bias": (ids_all, g_brows)},
        )
        return loss, params, opt_state, gnorm

    def _build_step(self, example_batch: Batch, num_steps: int = 1):
        """jit'd train step. ``num_steps > 1`` scans over a leading stack of
        batches inside ONE dispatch — host→device dispatch latency is
        amortized 1/num_steps. Metrics come back stacked [num_steps] so
        per-step logging is preserved."""
        step_fn, metric_keys = self._step_core()

        # Shardings: derive from an abstract state + the example batch.
        abstract_state = jax.eval_shape(self.init_state)
        st_shard = state_shardings(abstract_state, self.mesh, self.dims.num_pois_padded)
        b_shard = batch_shardings(example_batch, self.mesh)
        m_shard = replicated_shardings(metric_keys, self.mesh)
        if num_steps == 1:
            return jax.jit(
                step_fn,
                in_shardings=(st_shard, b_shard),
                out_shardings=(st_shard, m_shard),
                donate_argnums=(0,),
            )

        def chunk_fn(state: TrainState, batches: Batch):
            return jax.lax.scan(step_fn, state, batches)

        bs_stacked = jax.tree.map(
            lambda x: jax.sharding.NamedSharding(
                self.mesh,
                jax.sharding.PartitionSpec(None, mesh_lib.DATA_AXIS, *([None] * (x.ndim - 1))),
            ),
            example_batch,
        )
        ms_stacked = jax.tree.map(
            lambda sh: jax.sharding.NamedSharding(self.mesh, jax.sharding.PartitionSpec()),
            m_shard,
        )
        return jax.jit(
            chunk_fn,
            in_shardings=(st_shard, bs_stacked),
            out_shardings=(st_shard, ms_stacked),
            donate_argnums=(0,),
        )

    def _put_batch(self, batch: Batch, stacked: bool = False):
        if stacked:  # leading axis is the scan (steps) axis, not batch
            shardings = jax.tree.map(
                lambda x: jax.sharding.NamedSharding(
                    self.mesh,
                    jax.sharding.PartitionSpec(
                        None, mesh_lib.DATA_AXIS, *([None] * (x.ndim - 2))
                    ),
                ),
                batch,
            )
        else:
            shardings = batch_shardings(batch, self.mesh)
        if jax.process_count() == 1:
            return jax.device_put(batch, shardings)
        # Multi-host: each process holds a disjoint slice of the global batch
        # (loader host sharding); assemble the global array from local data.
        return jax.tree.map(
            lambda x, s: jax.make_array_from_process_local_data(s, np.asarray(x)),
            batch,
            shardings,
        )

    def _build_sampled_steps(self, num_steps: int):
        """jit'd K-step chunk with batches drawn IN-GRAPH by the device
        sampler — zero per-step host payload (data/device_sampler.py)."""
        step_fn, metric_keys = self._step_core()

        def sampled_step(state: TrainState, _):
            return step_fn(state, self.sampler.sample(state.step))

        def chunk_fn(state: TrainState):
            return jax.lax.scan(sampled_step, state, None, length=num_steps)

        abstract_state = jax.eval_shape(self.init_state)
        st_shard = state_shardings(abstract_state, self.mesh, self.dims.num_pois_padded)
        ms = jax.tree.map(
            lambda _: jax.sharding.NamedSharding(self.mesh, jax.sharding.PartitionSpec()),
            metric_keys,
        )
        return jax.jit(
            chunk_fn,
            in_shardings=(st_shard,),
            out_shardings=(st_shard, ms),
            donate_argnums=(0,),
        )

    def step_sampled(self, state: TrainState, num_steps: int):
        """Run ``num_steps`` device-sampled steps in one dispatch."""
        assert self.sampler is not None, "Trainer needs a DeviceSampler"
        if self._chunk_fn is None or self._chunk_len != num_steps:
            self._chunk_fn = self._build_sampled_steps(num_steps)
            self._chunk_len = num_steps
        return self._chunk_fn(state)

    def step(self, state: TrainState, batch: Batch):
        """One train step. ``batch`` may be host numpy or already device-put
        (e.g. via a ``DevicePrefetcher`` wrapping ``put_single``)."""
        if self._step_fn is None:
            self._step_fn = self._build_step(batch)
        if not isinstance(batch.poi_in, jax.Array):
            batch = self._put_batch(batch)
        return self._step_fn(state, batch)

    def put_single(self, batch: Batch):
        return self._put_batch(batch)

    def put_chunk(self, batches: list[Batch]):
        stacked = jax.tree.map(lambda *xs: np.stack(xs), *batches)
        return self._put_batch(stacked, stacked=True)

    def step_chunk(self, state: TrainState, batches):
        """Run K train steps in ONE device dispatch (scan). ``batches`` is a
        list of host batches or a device-put stack from ``put_chunk``.
        Returns (state, metrics with leading [K] axis)."""
        if isinstance(batches, list):
            k = len(batches)
            example = batches[0]
            device_stack = None
        else:
            k = batches.poi_in.shape[0]
            example = jax.tree.map(lambda x: x[0], batches)
            device_stack = batches
        if self._chunk_fn is None or self._chunk_len != k:
            self._chunk_fn = self._build_step(example, num_steps=k)
            self._chunk_len = k
        if device_stack is None:
            device_stack = self.put_chunk(batches)
        return self._chunk_fn(state, device_stack)


def _aligned_steps_per_call(cfg, callbacks) -> int:
    """Chunk length that never strides across a checkpoint/eval/log boundary.

    Callbacks only see state at chunk ends (interior states live inside the
    scan and are never materialized), so when callbacks are active the chunk
    length must divide every period a callback keys on — otherwise a
    ``step % checkpoint_every == 0`` boundary falling inside a chunk would be
    silently skipped or served a later step's state (VERDICT r1 Weak #8).
    Without callbacks nothing consumes interior states and the user's
    steps_per_call is used as-is.
    """
    import math

    spc = max(1, cfg.train.steps_per_call)
    if spc == 1 or not callbacks:
        return spc
    g = 0
    for p in (cfg.train.log_every, cfg.train.checkpoint_every, cfg.train.eval_every):
        if p and p > 0:
            g = math.gcd(g, p)
    if g == 0:
        return spc
    k = min(spc, g)
    while g % k:
        k -= 1
    if k != spc:
        log.info(
            "steps_per_call %d -> %d (aligned to checkpoint/eval/log boundaries)", spc, k
        )
    return k


def _train_sampled(cfg, trainer, state, start_step, num_steps, callbacks):
    """Training loop for the device sampler: no loader, no host feed — just
    K-step dispatches. Fault injection still works (it is a host-side raise
    between dispatches); resume is trivial (sampling is stateless in step)."""
    history: list[dict] = []
    end = start_step + num_steps
    fault = cfg.train.fault_inject_step
    spc = _aligned_steps_per_call(cfg, callbacks)
    t0 = time.perf_counter()
    seqs = 0
    i = start_step
    while i < end:
        if fault == i:
            raise FaultInjected(f"fault injected at step {i}")
        # Full steps_per_call dispatches even when spc > log_every: metrics
        # come back stacked per step, so every interior log boundary still
        # gets its own history row below (VERDICT r4 Weak #4 — the old path
        # silently clamped the chunk to log_every).
        k = min(spc, end - i)
        if callbacks:
            k = min(k, spc - i % spc)  # realign after an odd resume point
        if fault > i:
            k = min(k, fault - i)
        state, metrics_k = trainer.step_sampled(state, k)
        seqs += k * cfg.train.batch_size
        i += k
        bounds = [
            j for j in range(1, k + 1)
            if (i - k + j) % cfg.train.log_every == 0 or (i - k + j) == end
        ]
        if bounds:
            # float() is the device fence: it must happen BEFORE the window
            # is timed, or the rate measures dispatch speed, not execution
            # (the host runs ahead of the device through the async queue).
            rows_v = [
                {m: float(v[j - 1]) for m, v in metrics_k.items()} for j in bounds
            ]
            dt = time.perf_counter() - t0
            rate = seqs / max(dt, 1e-9)  # chunk-level rate; shared by interior rows
            for j, row in zip(bounds, rows_v):
                row.update(step=i - k + j, seqs_per_sec=rate)
                history.append(row)
                log.info(
                    "step %d loss %.4f grad %.3f %.1f seq/s",
                    row["step"], row["loss"], row["grad_norm"], row["seqs_per_sec"],
                )
            t0, seqs = time.perf_counter(), 0
        for cb in callbacks or []:
            cb(i, state, jax.tree.map(lambda v: v[-1], metrics_k))
    return trainer, state, history


def train(
    cfg: Config,
    dataset: Dataset,
    num_steps: int | None = None,
    state: TrainState | None = None,
    trainer: Trainer | None = None,
    callbacks: list[Callable] | None = None,
    loader_state: dict | None = None,
) -> tuple[Trainer, TrainState, list[dict]]:
    """Run the training loop; returns (trainer, final state, metric history).

    ``loader_state`` (from a checkpoint's extra payload) restores the data
    loader to its exact consumed position; without it, resume falls back to
    the deterministic ``seek(step)`` fast-forward (equivalent for the built-in
    backends, but the explicit state also carries the seed).
    """
    num_steps = num_steps if num_steps is not None else cfg.train.num_steps
    dims = model_base.DataDims.from_dataset(dataset)
    if trainer is None and cfg.data.sampler == "device":
        from poi_tpu.data.device_sampler import DeviceSampler

        trainer = Trainer(
            cfg, dims,
            sampler=DeviceSampler(dataset.train, cfg.train.batch_size, cfg.train.seed),
        )
    trainer = trainer or Trainer(cfg, dims)
    if state is None:
        state = trainer.init_state()
    start_step = int(state.step)

    if trainer.sampler is not None:
        trainer.active_loader = None
        return _train_sampled(cfg, trainer, state, start_step, num_steps, callbacks)

    loader = make_train_loader(
        dataset.train,
        batch_size=mesh_lib.local_data_batch(cfg.train.batch_size, trainer.mesh),
        seed=cfg.train.seed,
        host_id=jax.process_index(),
        num_hosts=jax.process_count(),
        backend=cfg.data.loader_backend,
    )
    trainer.active_loader = loader  # exposed so callbacks can checkpoint it
    if loader_state:
        loader.restore(loader_state)
    elif start_step:
        # Resume: deterministic fast-forward so step N always sees batch N.
        loader.seek(start_step)
    history: list[dict] = []
    t0 = time.perf_counter()
    seqs = 0
    spc = _aligned_steps_per_call(cfg, callbacks)
    if callbacks and spc > 1 and start_step % spc:
        # A misaligned resume point would force a partial chunk mid-run (which
        # drops loader batches on the feed path); step singly instead.
        log.info("steps_per_call -> 1 (resume step %d not chunk-aligned)", start_step)
        spc = 1

    def log_and_callbacks(i, state, metrics, rate=None):
        """``rate``: pre-measured chunk-level seq/s (chunk paths fence the
        whole dispatch before timing — a per-boundary window INSIDE a chunk
        would otherwise time only metric transfer, not execution)."""
        nonlocal t0, seqs
        seqs += cfg.train.batch_size
        if (i + 1) % cfg.train.log_every == 0 or i + 1 == start_step + num_steps:
            # Fence (float) BEFORE timing the window — see _train_sampled.
            row = {k: float(v) for k, v in metrics.items()}
            if rate is None:
                dt = time.perf_counter() - t0
                rate = seqs / max(dt, 1e-9)
            row.update(step=i + 1, seqs_per_sec=rate)
            history.append(row)
            log.info(
                "step %d loss %.4f grad %.3f %.1f seq/s",
                row["step"], row["loss"], row["grad_norm"], row["seqs_per_sec"],
            )
            t0, seqs = time.perf_counter(), 0
        for cb in callbacks or []:
            cb(i + 1, state, metrics)

    def fence_chunk(metrics_k, k, tc0):
        """Materialize a chunk's per-step metric floats (the device fence),
        then compute the chunk-level rate every boundary in it reports."""
        floated = [{m: float(v[j]) for m, v in metrics_k.items()} for j in range(k)]
        rate = k * cfg.train.batch_size / max(time.perf_counter() - tc0, 1e-9)
        return floated, rate

    end = start_step + num_steps
    fault = cfg.train.fault_inject_step
    fault_active = start_step <= fault < end
    # Device prefetch: a worker thread assembles AND ships batches ahead so
    # host work overlaps device compute. Off during the fault-injection drill
    # (the drill needs exact step-by-step control, not throughput) and where
    # the backend module says there is no transfer to hide.
    feed = None
    if not fault_active and backend.prefetch_to_device():
        from poi_tpu.data.pipeline import DevicePrefetcher

        if spc > 1:
            feed = DevicePrefetcher(
                lambda: trainer.put_chunk([next(loader) for _ in range(spc)]), depth=2
            )
        else:
            feed = DevicePrefetcher(lambda: trainer.put_single(next(loader)), depth=3)
    try:
        i = start_step
        while i < end:
            if fault == i:
                raise FaultInjected(f"fault injected at step {i}")
            k = min(spc, end - i)
            if fault > i:
                k = min(k, fault - i)
            if feed is not None and spc > 1:
                chunk = next(feed)
                if k == spc:
                    tc0 = time.perf_counter()
                    state, metrics_k = trainer.step_chunk(state, chunk)
                    floated, rate = fence_chunk(metrics_k, spc, tc0)
                    for j in range(spc):
                        log_and_callbacks(i + j, state, floated[j], rate=rate)
                else:
                    # Tail (< spc steps): replay leading slices of the chunk.
                    for j in range(k):
                        single = jax.tree.map(lambda x, jj=j: x[jj], chunk)
                        state, metrics = trainer.step(state, single)
                        log_and_callbacks(i + j, state, metrics)
            elif k > 1:
                tc0 = time.perf_counter()
                state, metrics_k = trainer.step_chunk(state, [next(loader) for _ in range(k)])
                floated, rate = fence_chunk(metrics_k, k, tc0)
                for j in range(k):
                    log_and_callbacks(i + j, state, floated[j], rate=rate)
            else:
                batch = next(feed) if feed is not None else next(loader)
                state, metrics = trainer.step(state, batch)
                log_and_callbacks(i, state, metrics)
            i += k
    finally:
        if feed is not None:
            feed.close()
        loader.close()
    return trainer, state, history

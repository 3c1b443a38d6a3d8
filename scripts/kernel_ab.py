"""Each hand-written kernel against what XLA makes of the plain version,
timed over a whole train step (or the top-k sweep) on the GPU.

    python scripts/kernel_ab.py [--reps 6] [--out kernel_ab.json]

Cells (real widths, random weights from fixed seeds, data from the presets):

- ``ce_bench``   GRU 128-d, full-catalog CE, V = 44,170, B = 512, T = 64:
                 streamed kernel vs XLA's chunked scan vs XLA's dense logits;
- ``sampled_c4`` config #4 (attention 256-d, S = 1,024, B = 64, T = 128):
                 streamed kernel vs XLA's dense [rows, S] logits;
- ``sampled_c5`` config #5 on one card as shipped (its catalog filters to
                 ~0.2M POIs, so lazy Adam runs masked-dense; S = 4,096,
                 D = 512, B = 512, T = 64): the same two;
- ``topk_*``     chunked top-k vs one whole-catalog ``lax.top_k`` at
                 V = 1M, D = 512, B = 512 and at config #4's catalog;
- ``tower_*``    the ``lax.scan`` towers' forward + backward at the widths
                 of configs #1-#5 (no kernel left to compare with).

Train steps run on the device sampler, ten steps per dispatch; every timed
window ends in ``block_until_ready``. Variants of a cell alternate window by
window (A B B A ...), and the median per-step time is reported beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS_PER_CALL = 10


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def alternate(variants: dict, reps: int) -> dict:
    """{name: thunk} → {name: median seconds}; the thunk must block."""
    names = list(variants)
    times = {n: [] for n in names}
    for r in range(reps):
        for n in names if r % 2 == 0 else names[::-1]:
            times[n].append(_timed(variants[n]))
    return {n: statistics.median(t) for n, t in times.items()}


def train_cell(cfg, ds, builders: dict, reps: int) -> dict:
    """Per-step ms of one config under each loss implementation.
    ``builders``: name → (loss_override or None, setup thunk run before the
    step is traced)."""
    import jax

    from poi_tpu.data.device_sampler import DeviceSampler
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.loop import Trainer

    runs = {}
    for name, (override, setup) in builders.items():
        setup()
        trainer = Trainer(
            cfg, DataDims.from_dataset(ds), loss_override=override,
            sampler=DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed),
        )
        box = {"state": trainer.init_state()}
        t0 = time.perf_counter()
        box["state"], m = trainer.step_sampled(box["state"], STEPS_PER_CALL)
        jax.block_until_ready(m)
        compile_s = time.perf_counter() - t0

        def run(trainer=trainer, box=box):
            box["state"], m = trainer.step_sampled(box["state"], STEPS_PER_CALL)
            jax.block_until_ready((box["state"], m))

        runs[name] = (run, compile_s, float(m["loss"][-1]))
    med = alternate({n: r[0] for n, r in runs.items()}, reps)
    return {
        n: {"step_ms": 1e3 * med[n] / STEPS_PER_CALL, "first_window_s": runs[n][1], "loss": runs[n][2]}
        for n in runs
    }


def topk_cell(b: int, v: int, d: int, k: int, reps: int) -> dict:
    import jax

    from poi_tpu.ops.topk import chunked_topk, xla_topk

    ks = jax.random.split(jax.random.key(0), 3)
    q = jax.random.normal(ks[0], (b, d))
    table = 0.05 * jax.random.normal(ks[1], (v, d))
    bias = 0.1 * jax.random.normal(ks[2], (v,))
    fns = {"chunked": jax.jit(chunked_topk, static_argnums=3), "whole": jax.jit(xla_topk, static_argnums=3)}
    for f in fns.values():
        jax.block_until_ready(f(q, table, bias, k))
    med = alternate({n: (lambda f=f: jax.block_until_ready(f(q, table, bias, k))) for n, f in fns.items()}, reps * 3)
    return {n: {"call_ms": 1e3 * t} for n, t in med.items()}


def topk_sweep(b: int, v: int, d: int, k: int, chunks: list[int], reps: int) -> dict:
    """Chunked top-k at several chunk sizes (a chunk >= V is one piece)."""
    import jax

    from poi_tpu.ops.topk import chunked_topk

    ks = jax.random.split(jax.random.key(0), 3)
    q = jax.random.normal(ks[0], (b, d))
    table = 0.05 * jax.random.normal(ks[1], (v, d))
    bias = 0.1 * jax.random.normal(ks[2], (v,))
    f = jax.jit(chunked_topk, static_argnums=(3, 4))
    for c in chunks:
        jax.block_until_ready(f(q, table, bias, k, c))
    med = alternate({str(c): (lambda c=c: jax.block_until_ready(f(q, table, bias, k, c))) for c in chunks}, reps * 3)
    return {f"chunk_{c}": {"call_ms": 1e3 * t} for c, t in med.items()}


# Tile sets tried for the streamed kernel at D = 512 (see ops.online_lse.blocks).
D512_TILES = {
    "a_current": dict(fwd_rows=64, fwd_cols=64, dq_rows=32, dq_cols=64, dt_cols=32, dt_rows=64, warps=8, stages=2),
    "b_stages3": dict(fwd_rows=64, fwd_cols=64, dq_rows=32, dq_cols=64, dt_cols=32, dt_rows=64, warps=8, stages=3),
    "c_rows64": dict(fwd_rows=64, fwd_cols=64, dq_rows=64, dq_cols=32, dt_cols=64, dt_rows=32, warps=8, stages=2),
    "d_cols128": dict(fwd_rows=128, fwd_cols=32, dq_rows=32, dq_cols=128, dt_cols=32, dt_rows=128, warps=8, stages=2),
    "e_warps4": dict(fwd_rows=64, fwd_cols=64, dq_rows=32, dq_cols=64, dt_cols=32, dt_rows=64, warps=4, stages=2),
}


def sampled_loss_cell(n: int, s: int, d: int, reps: int) -> dict:
    """fwd + bwd of the sampled NLL alone at one shape: XLA vs the kernel
    under each tile set of D512_TILES (D = 512) or its default tiles."""
    import jax
    import jax.numpy as jnp

    from poi_tpu.ops import online_lse
    from poi_tpu.train.losses import sampled_nll

    ks = jax.random.split(jax.random.key(3), 5)
    q = jax.random.normal(ks[0], (1, n, d))
    e = 0.05 * jax.random.normal(ks[1], (s, d))
    b = jnp.zeros((s,))
    s_pos = jax.random.normal(ks[2], (1, n))
    y = jax.random.randint(ks[3], (1, n), 0, 1_000_000)
    neg = jax.random.randint(ks[4], (s,), 0, 1_000_000)

    def build(impl):
        f = lambda q, e, b, sp: jnp.sum(sampled_nll(q, e, b, sp, y, neg, s, 1_000_000, impl))  # noqa: E731
        return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))

    default = online_lse.blocks
    fns, errors = {"xla": build("xla")}, {}
    tiles = D512_TILES if d == 512 else {"default": None}
    for name, bl in tiles.items():
        online_lse.blocks = default if bl is None else (lambda _d, bl=bl: dict(bl))
        try:
            g = build("triton")
            jax.block_until_ready(g(q, e, b, s_pos))
            fns[name] = g
        except Exception as err:  # a tile set the compiler refuses is a result
            errors[name] = f"{type(err).__name__}: {str(err)[:300]}"
        finally:
            online_lse.blocks = default
    jax.block_until_ready(fns["xla"](q, e, b, s_pos))
    med = alternate({n_: (lambda f=f: jax.block_until_ready(f(q, e, b, s_pos))) for n_, f in fns.items()}, reps * 3)
    return {**{n_: {"fwd_bwd_ms": 1e3 * t} for n_, t in med.items()}, "errors": errors}


def tower_cell(cfg, reps: int) -> dict:
    """lax.scan tower forward + backward at a preset's (B, T, D, H)."""
    import jax
    import jax.numpy as jnp

    from poi_tpu.data.pipeline import Batch
    from poi_tpu.models.base import DataDims, build_model

    B, T, D = cfg.train.batch_size, cfg.data.max_seq_len, cfg.model.embed_dim
    dims = DataDims(num_users=8, num_pois=8, num_time_buckets=168, num_geo_buckets=64,
                    num_tgap_buckets=cfg.data.time_gap_buckets, num_dist_buckets=cfg.data.dist_buckets)
    model = build_model(cfg.model, dims)
    params = model.init_tower(jax.random.key(0))
    zi = jnp.zeros((B, T), jnp.int32)
    zf = jnp.full((B, T), 0.5, jnp.float32)
    batch = Batch(user=jnp.zeros((B,), jnp.int32), poi_in=zi, poi_tgt=zi, mask=jnp.ones((B, T)),
                  time_bucket=zi, geo_bucket=zi, tgap_idx=zi, tgap_frac=zf, dist_idx=zi, dist_frac=zf)
    x = jax.random.normal(jax.random.key(1), (B, T, D))
    f = jax.jit(jax.grad(lambda p, x: jnp.sum(jnp.square(model.tower(p, x, batch))), argnums=(0, 1)))
    jax.block_until_ready(f(params, x))
    med = alternate({"scan": lambda: jax.block_until_ready(f(params, x))}, reps * 3)
    return {"fwd_bwd_ms": 1e3 * med["scan"], "B": B, "T": T, "D": D, "H": cfg.model.hidden_dim}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--cells", default="ce_bench,sampled_c4,sampled_c5,topk,towers")
    # Further cells, off by default: sampled_loss (tile sets for the kernel
    # alone) and topk_sweep (chunk sizes).
    args = ap.parse_args()

    import jax

    from poi_tpu import backend

    backend.init()
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.ops.fused_ce import fused_ce_loss
    from poi_tpu.train.losses import ce_loss, sampled_softmax_loss, streamed_ce_loss

    dev = jax.devices()[0]
    result = {"device": {"kind": dev.device_kind, "count": len(jax.devices())},
              "card": backend.card_name_and_power_limit(), "cells": {}}
    print(result["card"], flush=True)
    cells = args.cells.split(",")
    nothing = lambda: None  # noqa: E731

    def put(name, r):
        result["cells"][name] = r
        print(name, json.dumps(r), flush=True)

    if "ce_bench" in cells:
        cfg = get_config("smoke").with_overrides({
            "data.num_users": "4000", "data.num_pois": "50000", "data.mean_checkins_per_user": "60",
            "data.max_seq_len": "64", "data.min_user_checkins": "8", "model.kind": "gru",
            "model.embed_dim": "128", "model.hidden_dim": "128", "loss.kind": "ce",
            "train.warmup_steps": "0", "train.batch_size": "512", "data.sampler": "device",
        })
        ds = load_dataset(cfg.data)
        put("ce_bench", {"V": ds.num_pois, **train_cell(cfg, ds, {
            "triton": (lambda q, t, b, y, m, rng: streamed_ce_loss(q, t, b, y, m), nothing),
            "xla_chunked": (lambda q, t, b, y, m, rng: fused_ce_loss(q, t, b, y, m), nothing),
            "xla_dense": (lambda q, t, b, y, m, rng: ce_loss(q, t, b, y, m), nothing),
        }, args.reps)})

    def sampled(impl, cfg, n):
        return lambda q, t, b, y, m, rng: sampled_softmax_loss(q, t, b, y, m, rng, cfg.loss.num_sampled, n, impl)

    if "sampled_c4" in cells:
        cfg = get_config("attention_gowalla").with_overrides({"data.sampler": "device"})
        ds = load_dataset(cfg.data)
        put("sampled_c4", train_cell(cfg, ds, {
            "triton": (sampled("triton", cfg, ds.num_pois), nothing),
            "xla": (sampled("xla", cfg, ds.num_pois), nothing),
        }, args.reps))

    if "sampled_c5" in cells:
        # The loss reads its implementation from the backend module when it
        # is traced; the width limit picks the variant.
        limit = backend.STREAMED_MAX_WIDTH

        def use(width_limit):
            return lambda: setattr(backend, "STREAMED_MAX_WIDTH", width_limit)

        cfg = get_config("multihost_1m").with_overrides({"mesh.model": "1", "data.sampler": "device"})
        ds = load_dataset(cfg.data)
        put("sampled_c5", train_cell(cfg, ds, {
            "triton": (None, use(10**9)),
            "xla": (None, use(0)),
        }, args.reps))
        backend.STREAMED_MAX_WIDTH = limit

    if "topk" in cells:
        put("topk_1m", {"B": 512, "V": 1_000_000, "D": 512, **topk_cell(512, 1_000_000, 512, 10, args.reps)})
        put("topk_c4", {"B": 256, "V": 36969, "D": 256, **topk_cell(256, 36969, 256, 10, args.reps)})

    if "sampled_loss" in cells:
        put("sampled_loss_c5", {"N": 32768, "S": 4096, "D": 512, **sampled_loss_cell(32768, 4096, 512, args.reps)})
        put("sampled_loss_c4", {"N": 8192, "S": 1024, "D": 256, **sampled_loss_cell(8192, 1024, 256, args.reps)})

    if "topk_sweep" in cells:
        put("topk_sweep_1m", {"B": 512, "V": 1_000_000, "D": 512, **topk_sweep(
            512, 1_000_000, 512, 10, [32768, 131072, 262144, 1_000_000], args.reps)})

    if "towers" in cells:
        for name in ("gru_foursquare_nyc", "lstm_bpr_foursquare", "strnn_gowalla",
                     "attention_gowalla", "multihost_1m"):
            put(f"tower_{name}", tower_cell(get_config(name), args.reps))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

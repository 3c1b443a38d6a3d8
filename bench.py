"""Training-throughput benchmark on one GPU: prints ONE JSON line.

Metric: training throughput (sequences/sec/card) on a full-Foursquare-scale
workload (GRU tower, ~44k POI catalog after filtering, 128-d, T=64,
full-softmax CE — the capability point of BASELINE.json:8 with the
reference's own objective), with model FLOP/s utilization against the
card's published bf16 peak.

vs_baseline_live: ratio against a "reference-shaped" run measured on the
SAME card in the same process — the Theano reference's configuration (batch
32 [BASELINE.json:7], fp32 everywhere, dense full-catalog softmax), still
jit-compiled. The reference itself cannot run here (Theano, no network — see
SURVEY.md §0/§6), so this proxy is the same-hardware comparison.

Runs only on a GPU (poi_tpu/backend.py); every timed window ends in
``block_until_ready``.
"""

from __future__ import annotations

import json
import sys
import time

# Published dense bf16 peak FLOP/s by jax device_kind. Source: NVIDIA H100
# Tensor Core GPU data sheet (SXM5 part, without sparsity), at its full
# 700 W power limit. A card that is not listed is an error, not a default.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_bf16_flops(device_kind: str) -> float:
    if device_kind not in PEAK_BF16_FLOPS:
        raise KeyError(f"no published bf16 peak for device kind {device_kind!r}; add it to PEAK_BF16_FLOPS")
    return PEAK_BF16_FLOPS[device_kind]


def _step_flops(cfg, dims) -> float:
    """Analytic whole-step matmul FLOPs (fwd + bwd ≈ 3x fwd for matmuls):
    tower input/recurrent projections (+ MHA for the attention model) + the
    loss logits matmul (full catalog for CE, the sampled set for sampled
    softmax)."""
    b, t = cfg.train.batch_size, cfg.data.max_seq_len
    d, h = cfg.model.embed_dim, cfg.model.hidden_dim
    v = dims.num_pois_padded
    gates = {"gru": 3, "lstm": 4, "strnn": 1, "attention": 3}.get(cfg.model.kind, 1)
    tower = 2 * b * t * (d + h) * gates * h * cfg.model.num_layers
    if cfg.model.kind == "attention":  # qkvo projections + windowed scores/values
        tower += 4 * 2 * b * t * h * h + 2 * 2 * b * t * cfg.model.attn_window * h
    proj = 2 * b * t * h * d if (h != d or not cfg.model.tie_output_embedding) else 0
    if cfg.loss.kind == "sampled_softmax":
        cols = cfg.loss.num_sampled + 1
    elif cfg.loss.kind == "bpr":
        cols = cfg.loss.num_negatives + 1
    else:
        cols = v
    loss = 2 * b * t * d * cols
    return 3.0 * (tower + proj + loss)


def _throughput(cfg, ds, steps=30, warmup=5, repeats=7, dims=None) -> float:
    """Best-of-``repeats`` timed windows of ``steps`` train steps; each
    window ends when the device has finished (``block_until_ready``)."""
    import jax

    from poi_tpu.data.device_sampler import DeviceSampler
    from poi_tpu.data.pipeline import DevicePrefetcher, TrainLoader
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.loop import Trainer

    sampler = None
    if cfg.data.sampler == "device":
        sampler = DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed)
    trainer = Trainer(cfg, dims or DataDims.from_dataset(ds), sampler=sampler)
    state = trainer.init_state()
    best = 0.0
    spc = max(1, cfg.train.steps_per_call)
    loader = feed = None
    if sampler is None:
        loader = TrainLoader(ds.train, batch_size=cfg.train.batch_size, seed=0)
        if spc > 1:
            feed = DevicePrefetcher(
                lambda: trainer.put_chunk([next(loader) for _ in range(spc)]), depth=2
            )
        else:
            feed = DevicePrefetcher(lambda: trainer.put_single(next(loader)), depth=3)

    def run(n):
        nonlocal state
        m = None
        for _ in range(n // spc):
            if sampler is not None:
                state, m = trainer.step_sampled(state, spc)
            elif spc > 1:
                state, m = trainer.step_chunk(state, next(feed))
            else:
                state, m = trainer.step(state, next(feed))
        jax.block_until_ready((state, m))

    try:
        run(max(warmup, spc))  # compile + drain the async dispatch queue
        for _ in range(repeats):
            n = max(spc, steps - steps % spc)  # at least one dispatch
            t0 = time.perf_counter()
            run(n)
            dt = time.perf_counter() - t0
            best = max(best, n * cfg.train.batch_size / dt)
    finally:
        if feed is not None:
            feed.close()
        if loader is not None:
            loader.close()
    return best


def main() -> int:
    import jax

    from poi_tpu import backend
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset

    backend.init()
    device = jax.devices()[0]
    peak = peak_bf16_flops(device.device_kind)
    card = backend.card_name_and_power_limit()
    print(f"card: {card}", file=sys.stderr)

    base_overrides = {
        "data.num_users": "4000",
        "data.num_pois": "50000",
        "data.mean_checkins_per_user": "60",
        "data.max_seq_len": "64",
        "data.min_user_checkins": "8",
        "model.kind": "gru",
        "model.embed_dim": "128",
        "model.hidden_dim": "128",
        "loss.kind": "ce",
        "train.warmup_steps": "0",
    }
    cfg_ours = get_config("smoke").with_overrides(
        {
            **base_overrides,
            "train.batch_size": "512",
            "model.compute_dtype": "bfloat16",
            "train.steps_per_call": "40",
            "data.sampler": "device",
        }
    )
    # Reference-shaped: batch 32 (BASELINE.json:7), fp32, same dense softmax.
    cfg_ref = get_config("smoke").with_overrides(
        {**base_overrides, "train.batch_size": "32", "model.compute_dtype": "float32"}
    )

    print("synthesizing dataset...", file=sys.stderr)
    ds = load_dataset(cfg_ours.data)
    print(
        f"dataset: {ds.num_users} users {ds.num_pois} pois {len(ds.train)} examples",
        file=sys.stderr,
    )

    print("benchmarking reference-shaped baseline (fp32, batch 32)...", file=sys.stderr)
    ref = _throughput(cfg_ref, ds, steps=120)
    print(f"baseline: {ref:.1f} seq/s", file=sys.stderr)

    print("benchmarking bf16, batch 512...", file=sys.stderr)
    ours = _throughput(cfg_ours, ds, steps=120)
    print(f"ours: {ours:.1f} seq/s", file=sys.stderr)

    from poi_tpu.models.base import DataDims

    flops = _step_flops(cfg_ours, DataDims.from_dataset(ds))
    mfu = flops * (ours / cfg_ours.train.batch_size) / peak
    print(f"whole-step MFU: {mfu:.1%} (analytic {flops / 1e9:.1f} GFLOP/step)", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": "train_seqs_per_sec_per_card",
                "value": ours,
                "unit": "seq/s",
                "vs_baseline_live": ours / ref,
                "baseline_live_seqs_per_sec": ref,
                "whole_step_mfu": mfu,
                "card": card,
                "device": {"platform": device.platform, "kind": device.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

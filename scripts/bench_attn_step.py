"""Whole-step MFU of config #4's attention workload (VERDICT r3 Next #3).

Same methodology as bench.py (device-sampled batches, K-step dispatch,
windows ending in block_until_ready), at the preset's own shapes and at the
bench batch size, so the attention tower's step efficiency is on the record
next to the GRU bench point.

    python scripts/bench_attn_step.py
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import bench  # repo-root bench.py


def main() -> int:
    import jax

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.models.base import DataDims

    base = get_config("attention_gowalla").with_overrides(
        {
            "data.val_fraction": "0",  # throughput only; no val machinery
            "data.sampler": "device",
            "train.steps_per_call": "10",
            "train.warmup_steps": "0",
            "model.dropout": "0",  # measure the serving-relevant compute path
        }
    )
    ds = load_dataset(base.data)
    dims = DataDims.from_dataset(ds)
    print(f"dataset: {ds.num_users} users {ds.num_pois} pois", file=sys.stderr, flush=True)
    import os

    modes = [m.strip() for m in os.environ.get("ATTN_BENCH_MODES", "sparse,dense").split(",") if m.strip()]
    bad = set(modes) - {"sparse", "dense"}
    if bad or not modes:
        raise SystemExit(f"ATTN_BENCH_MODES must be a comma list of sparse|dense, got {bad or 'nothing'}")
    for bs in (64, 256):
        for tu in modes:
            cfg = base.with_overrides(
                {"train.batch_size": str(bs), "train.table_update": tu}
            )
            sps = bench._throughput(cfg, ds, steps=40, repeats=4, dims=dims)
            flops = bench._step_flops(cfg, dims)
            mfu = flops * (sps / bs) / bench.peak_bf16_flops(jax.devices()[0].device_kind)
            print(
                f"attention batch={bs:4d} ({tu:6s}): {sps:9,.0f} seq/s "
                f"({bs / (sps / 1e3):6.3f} ms/step, whole-step MFU {mfu:.1%}, "
                f"analytic {flops / 1e9:.1f} GFLOP/step)",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())

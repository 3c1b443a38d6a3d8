"""Dev-only sweep over bench-workload knobs (batch size, steps_per_call)
to find the fastest honest headline point for bench.py and quantify the
dispatch-amortization and batch-efficiency levers behind the whole-step MFU
gap (VERDICT r2 Missing #4). Reuses bench._throughput (device-sampled path,
windows ending in block_until_ready).

    python scripts/bench_variants.py [repeats]
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

    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    base = {
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
        "model.compute_dtype": "bfloat16",
        "data.sampler": "device",
    }
    cfg0 = get_config("smoke").with_overrides(base)
    ds = load_dataset(cfg0.data)
    dims = DataDims.from_dataset(ds)
    for bs in (256, 512, 1024):
        for spc in (10, 20, 40):
            cfg = cfg0.with_overrides(
                {"train.batch_size": str(bs), "train.steps_per_call": str(spc)}
            )
            steps = max(40, 2 * spc)
            sps = bench._throughput(cfg, ds, steps=steps, repeats=repeats, dims=dims)
            flops = bench._step_flops(cfg, dims)
            mfu = flops * (sps / bs) / bench.peak_bf16_flops(jax.devices()[0].device_kind)
            print(
                f"batch={bs:5d} spc={spc:3d}: {sps:9,.0f} seq/s  "
                f"({bs / (sps / 1e3):6.3f} ms/step, MFU {mfu:.1%})",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end serving benchmark: Recommender.recommend() latency + QPS.

Measures the full online path — featurize raw histories → batched chunked
top-k over the catalog → visited-filter — the production surface the
reference family never had (eval/serve.py docstring). The batch sweep
separates the fixed per-call cost (intercept) from the marginal
per-request cost (slope).

    python scripts/bench_serve.py [num_pois] [embed_dim]
"""

from __future__ import annotations

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import numpy as np

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.eval.serve import Checkin, Recommender
    from poi_tpu.train.loop import Trainer
    from poi_tpu.models.base import DataDims

    num_pois = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    dim = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    cfg = get_config("smoke").with_overrides(
        {
            "data.num_users": "4000",
            "data.num_pois": str(num_pois),
            "data.mean_checkins_per_user": "60",
            "data.max_seq_len": "64",
            "data.min_user_checkins": "8",
            "model.kind": "gru",
            "model.embed_dim": str(dim),
            "model.hidden_dim": str(dim),
            "model.compute_dtype": "bfloat16",
        }
    )
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds))
    state = trainer.init_state()
    rec = Recommender(trainer.model, state.params, cfg, ds)
    print(
        f"catalog V={ds.num_pois} D={dim} k=10 (untrained params — serving cost "
        f"is shape-dependent only)",
        flush=True,
    )

    rng = np.random.default_rng(0)

    def make_requests(n, hist_len=20):
        out = []
        for _ in range(n):
            pois = rng.integers(0, ds.num_pois, size=hist_len)
            t0 = 1.3e9 + float(rng.integers(0, 86400 * 30))
            out.append(
                [Checkin(int(p), t0 + 3600.0 * i) for i, p in enumerate(pois)]
            )
        return out

    rows = []
    for bs in (1, 8, 64, 256):
        reqs = make_requests(bs)
        rec.recommend(reqs, k=10)  # compile + warm the jit cache for this bucket
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            ids = rec.recommend(reqs, k=10)
            lat.append(time.perf_counter() - t0)
        assert ids.shape == (bs, 10)
        lat.sort()
        p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        rows.append((bs, p50, p99, bs / p50))
        print(
            f"batch={bs:4d}: p50 {p50 * 1e3:7.2f} ms  p99 {p99 * 1e3:7.2f} ms  "
            f"{bs / p50:10,.0f} req/s (at p50)",
            flush=True,
        )
    # Marginal per-request cost: slope between the two largest batch points —
    # the fixed per-call host cost cancels in the difference.
    (b1, t1, _, _), (b2, t2, _, _) = rows[-2], rows[-1]
    slope_us = (t2 - t1) / (b2 - b1) * 1e6
    print(
        f"marginal cost {slope_us:.1f} us/request -> {1e6 / slope_us:,.0f} req/s "
        f"sustained (fixed dispatch cost excluded)",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

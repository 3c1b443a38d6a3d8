"""Full-budget quality runs for the named configs (VERDICT r2 Missing #3).

Runs a preset to its FULL step budget on the card, evaluates, prints the
quality-row ingredients (metrics, popularity floor, steady-state seq/s).
When the config defines a validation split (data.val_fraction > 0), training
tracks the best-on-val params (train/selection.py) and the test row reports
the SELECTED checkpoint — standard model selection; the test split is scored
once, at the end.

    python scripts/quality_runs.py <preset> [k=v ...]

e.g.  python scripts/quality_runs.py lstm_bpr_foursquare
      python scripts/quality_runs.py attention_gowalla model.dropout=0.3
"""

from __future__ import annotations

import logging
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
logging.getLogger("absl").setLevel(logging.WARNING)


def main() -> int:
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.eval.evaluate import evaluate, popularity_baseline
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.loop import Trainer, train

    preset = sys.argv[1]
    overrides = dict(a.split("=", 1) for a in sys.argv[2:])
    cfg = get_config(preset).with_overrides(overrides)
    print(f"config: {preset} + {overrides} ({cfg.train.num_steps} steps)", flush=True)
    ds = load_dataset(cfg.data)
    print(f"dataset: {ds.num_users} users {ds.num_pois} pois "
          f"{len(ds.train)} train / {len(ds.test)} test"
          + (f" / {len(ds.val)} val" if ds.val is not None else ""), flush=True)

    trainer = None
    tracker = None
    callbacks = None
    if ds.val is not None:
        from poi_tpu.data.device_sampler import DeviceSampler
        from poi_tpu.train.selection import BestOnVal

        sampler = None
        if cfg.data.sampler == "device":
            sampler = DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed)
        trainer = Trainer(cfg, DataDims.from_dataset(ds), sampler=sampler)
        tracker = BestOnVal(trainer, ds, cfg)
        callbacks = [tracker]

    t0 = time.time()
    trainer, state, history = train(cfg, ds, trainer=trainer, callbacks=callbacks)
    dt = time.time() - t0
    params = state.params
    sel = ""
    if tracker is not None:
        params = tracker.best_params(state.params)
        sel = (f" [selected step {tracker.best_step} "
               f"val {tracker.metric}={tracker.best_score:.4f}]")
    m = evaluate(trainer.model, params, ds, cfg, mesh=trainer.mesh)
    pop = popularity_baseline(ds, cfg.eval.recall_ks)
    # Steady-state throughput: median of the per-window seq/s history (skips
    # the compile window and transient host stalls).
    sps = sorted(h["seqs_per_sec"] for h in history[1:] or history)
    sps = sps[len(sps) // 2]
    print(
        f"ROW {preset}: steps={cfg.train.num_steps} loss={history[-1]['loss']:.3f} "
        f"r@1={m['recall@1']:.4f} r@5={m['recall@5']:.4f} r@10={m['recall@10']:.4f} "
        f"ndcg@10={m['ndcg@10']:.4f}{sel} | pop r@1={pop['recall@1']:.4f} "
        f"r@5={pop['recall@5']:.4f} r@10={pop['recall@10']:.4f} "
        f"ndcg={pop['ndcg@10']:.4f} | {sps:,.0f} seq/s (median window) "
        f"batch={cfg.train.batch_size} wall={dt:.0f}s "
        f"{'BEATS POP %.2fx' % (m['recall@10'] / max(pop['recall@10'], 1e-9)) if m['recall@10'] > pop['recall@10'] else 'BELOW FLOOR'}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

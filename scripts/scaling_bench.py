"""Multi-host scaling benchmark harness (SURVEY.md §7 step 8:
"Examples/s scaling efficiency, 1 -> N hosts").

On a real multi-host cluster, run this ON EVERY HOST with the
same coordinator (weak scaling: the per-host batch stays fixed, the global
batch grows with N):

    python scripts/scaling_bench.py --config multihost_1m \
        --coordinator $COORD_HOST:8476 --num-processes $N --process-id $I \
        --per-host-batch 256 --steps 100 --out /shared/scaling.json

Process 0 appends one row per run to ``--out`` and prints the efficiency
table against the N=1 row (run N=1 first). Without a cluster, the same
binary validates degenerately:

    python scripts/scaling_bench.py --local-processes 2 --config smoke

spawns N local processes over gloo CPU collectives with 4 fake devices each —
the exact code path a real cluster runs, minus the hardware (SURVEY.md §4
"Distributed (no cluster)").
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="scaling_bench")
    p.add_argument("--config", default="smoke")
    p.add_argument("--set", nargs="*", default=[], help="dotted overrides key=value")
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--per-host-batch", type=int, default=None,
                   help="per-host batch (global = N * this); default: config batch_size")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", default=None, help="JSON results file (rows appended by process 0)")
    p.add_argument("--local-processes", type=int, default=0,
                   help="degenerate mode: spawn N local gloo-CPU processes (smoke test)")
    p.add_argument("--platform", default=None, help="force jax platform (e.g. cpu)")
    return p.parse_args(argv)


# ----------------------------------------------------------------- worker
def run_worker(args) -> dict:
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.coordinator:
        if args.platform == "cpu":
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.data.pipeline import TrainLoader
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.loop import Trainer
    from poi_tpu.utils.config import parse_set_flags

    n_proc = jax.process_count()
    cfg = get_config(args.config).with_overrides(parse_set_flags(args.set))
    per_host = args.per_host_batch or cfg.train.batch_size
    cfg = cfg.with_overrides(
        {"train.batch_size": str(per_host * n_proc), "train.warmup_steps": "0"}
    )

    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds))
    state = trainer.init_state()
    loader = TrainLoader(
        ds.train, batch_size=per_host, seed=0,
        host_id=jax.process_index(), num_hosts=n_proc,
    )

    spc = max(1, cfg.train.steps_per_call)
    steps = max(spc, args.steps - args.steps % spc)

    def run(n):
        nonlocal state
        m = None
        for _ in range(n // spc):
            if spc > 1:
                state, m = trainer.step_chunk(state, [next(loader) for _ in range(spc)])
            else:
                state, m = trainer.step(state, next(loader))
        # Device->host fence: the scalar's value depends on every step above.
        return float(m["loss"] if m["loss"].ndim == 0 else m["loss"][-1])

    run(max(args.warmup, spc))  # compile + warm
    best = 0.0
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        run(steps)
        dt = time.perf_counter() - t0
        best = max(best, steps * cfg.train.batch_size / dt)
    loader.close()

    row = {
        "processes": n_proc,
        "devices": jax.device_count(),
        "global_batch": cfg.train.batch_size,
        "global_seqs_per_sec": round(best, 1),
        "per_process_seqs_per_sec": round(best / n_proc, 1),
        "config": args.config,
        "steps": steps,
    }
    if jax.process_index() == 0:
        _record(args.out, row)
        print("SCALING " + json.dumps(row))
    return row


def _record(out: str | None, row: dict) -> None:
    if not out:
        return
    path = pathlib.Path(out)
    rows = json.loads(path.read_text()) if path.exists() else []
    rows = [r for r in rows if r["processes"] != row["processes"] or r["config"] != row["config"]]
    rows.append(row)
    rows.sort(key=lambda r: (r["config"], r["processes"]))
    path.write_text(json.dumps(rows, indent=2))
    base = next((r for r in rows if r["config"] == row["config"] and r["processes"] == 1), None)
    print(f"{'N':>3} {'global seq/s':>14} {'per-proc':>10} {'efficiency':>10}")
    for r in (r for r in rows if r["config"] == row["config"]):
        eff = "-" if base is None else f"{r['per_process_seqs_per_sec'] / base['per_process_seqs_per_sec']:.1%}"
        print(f"{r['processes']:>3} {r['global_seqs_per_sec']:>14} {r['per_process_seqs_per_sec']:>10} {eff:>10}")


# ------------------------------------------------- degenerate local launcher
def run_local(args) -> int:
    """Spawn --local-processes gloo-CPU workers on this machine (4 fake
    devices each) — validates the exact multi-host code path hardware-free."""
    n = args.local_processes
    port = os.environ.get("SCALING_BENCH_PORT", "29871")
    procs = []
    for i in range(n):
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        cmd = [
            sys.executable, __file__,
            "--config", args.config,
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(n),
            "--process-id", str(i),
            "--steps", str(args.steps),
            "--warmup", str(args.warmup),
            "--repeats", str(args.repeats),
            "--platform", "cpu",
        ]
        if args.per_host_batch:
            cmd += ["--per-host-batch", str(args.per_host_batch)]
        if args.out:
            cmd += ["--out", args.out]
        if args.set:
            cmd += ["--set", *args.set]
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(REPO),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    rc = 0
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            rc = p.returncode
            print(f"process {i} failed:\n{out[-2000:]}", file=sys.stderr)
        elif i == 0:
            print(out, end="")
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.local_processes:
        return run_local(args)
    run_worker(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

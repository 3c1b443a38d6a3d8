"""Analytic + compiler-verified device-memory budget for a named config.

This script makes the memory bound of a configuration computable:

1. **Pytree accounting** (exact, from jax.eval_shape — no device needed):
   params / optimizer-moment / gradient bytes, split tables vs dense.
2. **Compiled-step analysis**: AOT-compiles the REAL train-step chunk for
   the current backend and reads XLA's `memory_analysis()` — argument,
   output, and temp (activation/workspace) bytes the compiler actually
   reserved. On the GPU this is the authoritative peak-memory answer.
3. `memory_stats()` cross-check when the backend exposes it.

    python scripts/mem_budget.py [config] [--set k=v ...]
    python scripts/mem_budget.py multihost_1m --set mesh.model=1 --force-v 1000000
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import numpy as np


def tree_bytes(tree) -> int:
    return sum(
        int(np.prod(x.shape)) * x.dtype.itemsize
        for x in jax.tree.leaves(tree)
        if hasattr(x, "shape")
    )


def gib(n: int) -> str:
    return f"{n / 2**30:6.2f} GiB"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default="multihost_1m")
    p.add_argument("--set", nargs="*", default=[])
    p.add_argument("--force-v", type=int, default=0,
                   help="force the model catalog to V rows (contract-scale "
                        "dims, independent of the synthetic corpus' visited set)")
    p.add_argument("--budget-gib", type=float, default=60.0,
                   help="device memory to report headroom against (one H100 "
                        "process: 3/4 of 80 GB)")
    args = p.parse_args()

    from poi_tpu import backend
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.data.device_sampler import DeviceSampler
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.loop import Trainer
    from poi_tpu.utils.config import parse_set_flags

    cfg = get_config(args.config).with_overrides(parse_set_flags(args.set))
    print(f"config {cfg.name} (backend {backend.platform()})", file=sys.stderr)
    ds = load_dataset(cfg.data)
    dims = DataDims.from_dataset(ds)
    if args.force_v:
        dims = dataclasses.replace(dims, num_pois=args.force_v, num_pois_padded=0)
    sampler = DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed) \
        if cfg.data.sampler == "device" else None
    trainer = Trainer(cfg, dims, sampler=sampler)
    n_model = trainer.mesh.shape["model"]
    n_dev = trainer.mesh.size

    # ---- 1. exact pytree accounting (per device: tables shard over model) --
    abstract = jax.eval_shape(trainer.init_state)
    vp = trainer.dims.num_pois_padded

    def split(tree):
        table = dense = 0
        for x in jax.tree.leaves(tree):
            if not hasattr(x, "shape"):
                continue
            b = int(np.prod(x.shape)) * x.dtype.itemsize
            if len(x.shape) >= 1 and x.shape[0] == vp:
                table += b
            else:
                dense += b
        return table, dense

    from poi_tpu.train.sparse_opt import rows_mode_enabled

    pt, pd = split(abstract.params)
    ot, od = split(abstract.opt_state)
    rows_mode = rows_mode_enabled(cfg, trainer.dims, n_model)
    B, T = cfg.train.batch_size, cfg.data.max_seq_len
    D, S = cfg.model.embed_dim, cfg.loss.num_sampled
    n_ids = 2 * B * T + S
    grad_table = (n_ids * (D + 1) * 4) if rows_mode else pt  # rows vs dense cotangent
    lazy_path = ""
    if cfg.train.table_update == "sparse":
        lazy_path = " (rows-gradient mode)" if rows_mode else " (masked-dense/scatter lazy path)"
    print(f"V={trainer.dims.num_pois:,} (padded {vp:,}) D={D} B={B} T={T} "
          f"S={S} mesh={dict(trainer.mesh.shape)} "
          f"table_update={cfg.train.table_update}{lazy_path}")
    print("-- pytree accounting (per device) --")
    print(f"  params     tables {gib(pt // n_model)}   dense {gib(pd)}")
    print(f"  opt m+v    tables {gib(ot // n_model)}   dense {gib(od)}")
    print(f"  table grad {gib(grad_table // n_model)}"
          f"{'  ([N,D] rows — dense cotangent never built)' if rows_mode else '  (dense cotangent)'}")
    print(f"  dense grad {gib(pd)}")
    static = (pt + ot) // n_model + pd + od
    print(f"  resident state (params + moments): {gib(static)}")

    # ---- 2. compiled-step memory analysis ---------------------------------
    spc = max(1, cfg.train.steps_per_call)
    if sampler is not None:
        fn = trainer._build_sampled_steps(spc)
        lowered = fn.lower(abstract)
    else:
        from poi_tpu.data.pipeline import TrainLoader

        loader = TrainLoader(ds.train, batch_size=cfg.train.batch_size, seed=0)
        batch = next(loader)
        loader.close()
        b_abs = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch
        )
        fn = trainer._build_step(batch)
        lowered = fn.lower(abstract, b_abs)
    compiled = lowered.compile()
    ma = compiled.memory_analysis()
    if ma is not None:
        arg = getattr(ma, "argument_size_in_bytes", 0)
        out = getattr(ma, "output_size_in_bytes", 0)
        tmp = getattr(ma, "temp_size_in_bytes", 0)
        alias = getattr(ma, "alias_size_in_bytes", 0)
        code = getattr(ma, "generated_code_size_in_bytes", 0)
        peak = arg + out + tmp - alias
        print(f"-- XLA memory_analysis of the jit step (steps_per_call={spc}) --")
        print(f"  arguments  {gib(arg)}  (state{' + batch' if sampler is None else ' (+ device-resident corpus)'})")
        print(f"  outputs    {gib(out)}   aliased {gib(alias)} (donation)")
        print(f"  temps      {gib(tmp)}   (activations + workspace)")
        print(f"  code       {gib(code)}")
        print(f"  peak ≈ arg + out + temp - aliased = {gib(peak)}")
        print(f"  headroom vs {args.budget_gib:.0f} GiB: {gib(int(args.budget_gib * 2**30) - peak)}")
    else:
        print("memory_analysis() not available on this backend")

    # ---- 3. live cross-check ----------------------------------------------
    try:
        ms = jax.local_devices()[0].memory_stats() or {}
    except Exception:
        ms = {}
    if ms:
        print("-- device memory_stats --")
        for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
            if k in ms:
                print(f"  {k}: {gib(int(ms[k]))}")
    else:
        print("memory_stats(): not exposed by this backend")
    return 0


if __name__ == "__main__":
    sys.exit(main())

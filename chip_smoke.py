"""End-to-end proof that the system runs on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: config #5 on a model=4 mesh only

One process drives the card(s). Phases, each printing a line, none of them
allowed to fail quietly:

1. device — JAX's devices, and the card's name and power limit from
   ``nvidia-smi`` (a child process that stays off JAX); no GPU, no run;
2. kernels — every hand-written kernel compiled for the card and compared
   with its plain reference at real widths, plus the compiled train step's
   memory analysis;
3. main path — ``poi_tpu.cli.main`` in this process: train config #4 with a
   checkpoint, eval it, serve JSON requests from a substituted stdin, and
   train configs #1 and #3 for a few steps;
4. config #5 on one card (``mesh.model=1``, every visited POI kept): the
   rows-gradient sampled-softmax step at S = 4,096, D = 512 and top-k eval
   over a catalog of the 1M scale.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``. Weights are
random from fixed seeds; data is synthesized from the presets' seeds.
Outputs (checkpoints, metrics) go under ``.smoke_out/`` in the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, ".smoke_out")

# Parity limits against the plain references (same bf16-rounded operands,
# fp32 products at "highest" precision). The kernels round the softmax
# weights to bf16 before the gradient products, which bounds the gradient
# error near 2^-8 relative; the values differ only by fp32 summation order.
NLL_MAX_ABS = 2e-3
GRAD_REL_FROB = 1e-2
TOPK_GAP = 1e-3


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------- kernels


def _bf16_exact(x):
    import jax.numpy as jnp

    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _rel_frob(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def ce_parity(n: int = 32768, v: int = 44170, d: int = 128, seed: int = 0) -> dict:
    """Streamed CE kernel vs ``train.losses.ce_loss`` at the bench shape."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from poi_tpu.train.losses import ce_loss, streamed_ce_loss

    ks = jax.random.split(jax.random.key(seed), 4)
    q = _bf16_exact(0.5 * jax.random.normal(ks[0], (1, n, d)))
    table = _bf16_exact(0.1 * jax.random.normal(ks[1], (v, d)))
    bias = 0.1 * jax.random.normal(ks[2], (v,))
    y = jax.random.randint(ks[3], (1, n), 0, v)
    mask = jnp.ones((1, n), jnp.float32)

    def ref(q, t, b, y, m):
        with jax.default_matmul_precision("highest"):
            return ce_loss(q, t, b, y, m)

    # Per-row NLL is the gradient of sum(nll * m) in the mask; every array
    # is a jit argument (a closed-over constant would be folded at compile).
    def nll(loss):
        return jax.jit(jax.grad(lambda q, t, b, y, m: loss(q, t, b, y, m) * jnp.sum(m), argnums=4))

    def grads(loss):
        return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))

    args = (q, table, bias, y, mask)
    nll_k, nll_r = nll(streamed_ce_loss)(*args)[0], nll(ref)(*args)[0]
    g_k, g_r = grads(streamed_ce_loss)(*args), grads(ref)(*args)
    out = {
        "nll_max_abs": float(np.max(np.abs(np.asarray(nll_k) - np.asarray(nll_r)))),
        "grad_rel_frob": max(_rel_frob(a, b) for a, b in zip(g_k, g_r)),
    }
    check(out["nll_max_abs"] <= NLL_MAX_ABS and out["grad_rel_frob"] <= GRAD_REL_FROB, f"CE parity {out}")
    return out


def sampled_parity(n: int = 8192, v: int = 36969, s: int = 1024, d: int = 256, seed: int = 1) -> dict:
    """Streamed sampled softmax vs the XLA reference, same PRNG draw, at
    config #4's shape (B·T = 64·128 rows, S = 1,024, D = 256)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from poi_tpu.train.losses import sampled_softmax_loss

    ks = jax.random.split(jax.random.key(seed), 5)
    q = _bf16_exact(0.5 * jax.random.normal(ks[0], (1, n, d)))
    table = _bf16_exact(0.05 * jax.random.normal(ks[1], (v, d)))
    bias = 0.1 * jax.random.normal(ks[2], (v,))
    y = jax.random.randint(ks[3], (1, n), 0, v)
    mask = jnp.ones((1, n), jnp.float32)
    args = (q, table, bias, y, mask, ks[4])

    def loss(impl):
        def f(q, t, b, y, m, rng):
            return sampled_softmax_loss(q, t, b, y, m, rng, s, v, impl) * jnp.sum(m)

        return f

    def ref(*a):
        with jax.default_matmul_precision("highest"):
            return loss("xla")(*a)

    def nll(f):
        return jax.jit(jax.grad(f, argnums=4))

    def grads(f):
        return jax.jit(jax.grad(f, argnums=(0, 1, 2)))

    nll_k, nll_r = nll(loss("triton"))(*args)[0], nll(ref)(*args)[0]
    g_k, g_r = grads(loss("triton"))(*args), grads(ref)(*args)
    out = {
        "nll_max_abs": float(np.max(np.abs(np.asarray(nll_k) - np.asarray(nll_r)))),
        "grad_rel_frob": max(_rel_frob(a, b) for a, b in zip(g_k, g_r)),
    }
    check(out["nll_max_abs"] <= NLL_MAX_ABS and out["grad_rel_frob"] <= GRAD_REL_FROB, f"sampled parity {out}")
    return out


def topk_parity(b: int = 512, v: int = 1_000_000, d: int = 512, k: int = 10, chunk: int = 131072,
                seed: int = 2) -> dict:
    """Chunked top-k (``chunk`` rows at a time) vs ``xla_topk``: ids equal on
    every row whose k-th and (k+1)-th reference scores differ by more than
    TOPK_GAP."""
    import jax
    import numpy as np

    from poi_tpu.ops.topk import chunked_topk, xla_topk

    ks = jax.random.split(jax.random.key(seed), 3)
    q = jax.random.normal(ks[0], (b, d))
    table = 0.05 * jax.random.normal(ks[1], (v, d))
    bias = 0.1 * jax.random.normal(ks[2], (v,))
    _, ids = jax.jit(chunked_topk, static_argnums=(3, 4))(q, table, bias, k, chunk)
    rv, rid = jax.jit(xla_topk, static_argnums=3)(q, table, bias, k + 1)
    rv, rid, ids = np.asarray(rv), np.asarray(rid), np.asarray(ids)
    clear = rv[:, k - 1] - rv[:, k] > TOPK_GAP
    same = np.array([set(a) == set(r) for a, r in zip(ids, rid[:, :k])])
    out = {"rows_compared": int(clear.sum()), "rows": b, "mismatched": int((clear & ~same).sum())}
    check(out["mismatched"] == 0 and out["rows_compared"] > 0, f"top-k parity {out}")
    return out


def step_memory(cfg_name: str = "attention_gowalla") -> dict:
    """compiled.memory_analysis() of one train step of a preset."""
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.data.pipeline import TrainLoader
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.loop import Trainer

    cfg = get_config(cfg_name)
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds))
    state = trainer.init_state()
    loader = TrainLoader(ds.train, batch_size=cfg.train.batch_size, seed=0)
    batch = trainer.put_single(next(loader))
    loader.close()
    ma = trainer._build_step(batch).lower(state, batch).compile().memory_analysis()
    gib = 2.0**30
    return {
        "argument_gib": ma.argument_size_in_bytes / gib,
        "output_gib": ma.output_size_in_bytes / gib,
        "temp_gib": ma.temp_size_in_bytes / gib,
        "alias_gib": ma.alias_size_in_bytes / gib,
    }


# ------------------------------------------------------------------- main path


def _cli(argv: list[str], stdin_text: str | None = None) -> str:
    """``poi_tpu.cli.main`` in this process; returns what it printed."""
    from poi_tpu.cli import main

    buf = io.StringIO()
    old_stdin = sys.stdin
    if stdin_text is not None:
        sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        sys.stdin = old_stdin
    check(rc == 0, f"cli {argv[:3]} exited {rc}")
    return buf.getvalue()


def _losses(metrics_dir: str) -> list[float]:
    rows = []
    for name in sorted(os.listdir(metrics_dir)):
        if name.endswith(".jsonl"):
            with open(os.path.join(metrics_dir, name)) as f:
                rows += [json.loads(line) for line in f if line.strip()]
    return [r["loss"] for r in rows if "loss" in r]


def train_run(config: str, steps: int, tag: str, extra: list[str] = (), checkpoint: bool = True) -> dict:
    ckpt, mdir = os.path.join(OUT, tag, "ckpt"), os.path.join(OUT, tag, "metrics")
    shutil.rmtree(os.path.join(OUT, tag), ignore_errors=True)
    # No LR warmup: a few steps must move the loss.
    argv = ["train", "--config", config, "--metrics-dir", mdir,
            "--set", f"train.num_steps={steps}", "train.log_every=1", "train.warmup_steps=0", *extra]
    argv += ["--checkpoint-dir", ckpt] if checkpoint else ["--no-checkpoint"]
    _cli(argv)
    losses = _losses(mdir)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), f"{config} losses {losses}")
    q = max(1, steps // 4)
    first, last = sum(losses[:q]) / q, sum(losses[-q:]) / q
    check(last < first, f"{config} loss did not fall: {losses}")
    return {"config": config, "steps": steps, "first_loss": first, "last_loss": last, "ckpt": ckpt}


def eval_run(config: str, ckpt: str, extra: list[str] = ()) -> dict:
    out = _cli(["eval", "--config", config, "--checkpoint-dir", ckpt, "--set", *extra] if extra
               else ["eval", "--config", config, "--checkpoint-dir", ckpt])
    import ast

    metrics = ast.literal_eval(out.strip().splitlines()[-1])
    check(all(math.isfinite(v) for v in metrics.values()) and metrics["eval_examples"] > 0, f"eval {metrics}")
    return metrics


def serve_run(config: str, ckpt: str) -> dict:
    reqs = [
        [[{"poi": 1, "timestamp": 1000.0}, {"poi": 7, "timestamp": 4600.0}]],
        {"histories": [[{"poi": 3, "timestamp": 2000.0}], [{"poi": 4, "timestamp": 2500.0},
                       {"poi": 9, "timestamp": 9000.0}]], "k": 5},
        {"histories": [[{"poi": i, "timestamp": 100.0 * i} for i in range(1, 40)]], "k": 20},
    ]
    out = _cli(["serve", "--config", config, "--checkpoint-dir", ckpt],
               "\n".join(json.dumps(r) for r in reqs) + "\n")
    replies = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    check(len(replies) == len(reqs) and all("ids" in r for r in replies), f"serve replies {replies}")
    want = [(1, 10), (2, 5), (1, 20)]
    got = [(len(r["ids"]), len(r["ids"][0])) for r in replies]
    check(got == want, f"serve shapes {got} != {want}")
    return {"requests": len(reqs), "answered": len(replies)}


def rows_mode(config: str, extra: list[str]) -> dict:
    """Catalog size of a preset under ``extra`` and whether its train step
    takes the rows-gradient path (checked: config #5 must)."""
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.sparse_opt import rows_mode_enabled
    from poi_tpu.utils.config import parse_set_flags

    cfg = get_config(config).with_overrides(parse_set_flags(extra))
    ds = load_dataset(cfg.data)
    out = {"num_pois": ds.num_pois, "rows_mode": rows_mode_enabled(cfg, DataDims.from_dataset(ds), 1)}
    check(out["rows_mode"], f"{config} does not take the rows-gradient step: {out}")
    return out


# ------------------------------------------------------------------ four cards


def four_cards(cfg=None, steps: int = 3) -> dict:
    """Config #5 (or ``cfg``) on a data=1 x model=4 mesh vs the same params
    and batch on one of those cards at model=1: forward loss and top-k ids,
    the a2a overflow metric, and a few train steps."""
    import jax
    import numpy as np

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.data.pipeline import TrainLoader, eval_batches
    from poi_tpu.eval.evaluate import make_topk_fn, prepare_catalog
    from poi_tpu.ops.embedding import lookup_overflow_fraction
    from poi_tpu.models import base as model_base
    from poi_tpu.ops.topk import xla_topk
    from poi_tpu.parallel.mesh import make_mesh
    from poi_tpu.train.loop import Trainer

    devices = jax.devices()
    check(len(devices) >= 4, f"--four-cards needs 4 cards, found {len(devices)}")
    cfg = (cfg or get_config("multihost_1m")).with_overrides({"mesh.data": "1", "mesh.model": "4"})
    ds = load_dataset(cfg.data)
    dims = model_base.DataDims.from_dataset(ds).padded_to(4)
    mesh4 = make_mesh(1, 4, devices=np.array(devices[:4]))
    mesh1 = make_mesh(1, 1, devices=np.array(devices[:1]))
    t4 = Trainer(cfg, dims, mesh=mesh4)
    t1 = Trainer(cfg.with_overrides({"mesh.model": "1"}), dims, mesh=mesh1)
    s4 = t4.init_state()
    params1 = jax.device_put(s4.params, jax.sharding.SingleDeviceSharding(devices[0]))

    loader = TrainLoader(ds.train, batch_size=cfg.train.batch_size, seed=0)
    host_batch = next(loader)
    rng = jax.random.key(7)

    def forward(trainer):
        @jax.jit
        def f(params, batch, rng):
            q = trainer.model.queries(params, batch)
            table, bias = model_base.output_table(params, trainer.cfg.model)
            return trainer.loss_fn(q, table, bias, batch.poi_tgt, batch.mask, rng)

        return f

    l4 = float(forward(t4)(s4.params, t4.put_single(host_batch), rng))
    l1 = float(forward(t1)(params1, t1.put_single(host_batch), rng))
    check(abs(l4 - l1) <= 1e-3 * max(1.0, abs(l1)), f"forward loss 4 cards {l4} vs 1 card {l1}")

    k = max(cfg.eval.recall_ks)
    eb, _, _ = next(eval_batches(ds.test, cfg.eval.batch_size))
    # The a2a lookup must drop no id of the compared eval batch either.
    eval_overflow = float(lookup_overflow_fraction(
        eb.poi_in, 4, dims.num_pois_padded // 4, cfg.mesh.a2a_capacity_factor))
    check(eval_overflow == 0.0, f"a2a overflow on the eval batch: {eval_overflow}")
    prep4, prep1 = prepare_catalog(s4.params, t4.cfg), prepare_catalog(params1, t1.cfg)
    ids4 = np.asarray(make_topk_fn(t4.model, t4.cfg, k, mesh=mesh4)(
        s4.params, prep4.table, prep4.bias, t4.put_single(eb)))
    ids1 = np.asarray(make_topk_fn(t1.model, t1.cfg, k)(params1, prep1.table, prep1.bias, eb))
    ql = jax.jit(t1.model.queries_last)(params1, eb)
    rv, _ = xla_topk(ql, prep1.table, prep1.bias, k + 1)
    rv = np.asarray(rv)
    clear = rv[:, k - 1] - rv[:, k] > TOPK_GAP
    same = np.array([set(a) == set(b) for a, b in zip(ids4, ids1)])
    check(clear.sum() > 0 and not (clear & ~same).any(), f"sharded top-k differs on {(clear & ~same).sum()} rows")

    state, losses, overflow = s4, [], []
    for _ in range(steps):
        state, m = t4.step(state, next(loader))
        losses.append(float(m["loss"]))
        overflow.append(float(m["a2a_overflow"]))
    loader.close()
    check(all(math.isfinite(x) for x in losses), f"4-card losses {losses}")
    check(max(overflow) == 0.0, f"a2a overflow {overflow}")
    return {"loss_4cards": l4, "loss_1card": l1, "topk_rows_compared": int(clear.sum()),
            "topk_rows": len(ids1), "train_losses": losses, "a2a_overflow_train": max(overflow),
            "a2a_overflow_eval_batch": eval_overflow}


# ------------------------------------------------------------------------ main


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only config #5 on a model=4 mesh and its one-card comparison")
    args = parser.parse_args(argv)

    import jax

    with phase("device"):
        devices = jax.devices()
        if devices[0].platform != "gpu":
            print(f"no GPU: JAX found {devices}", file=sys.stderr)
            return 2
        from poi_tpu import backend

        backend.setup_compile_cache()
        print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
        print(f"card: {backend.card_name_and_power_limit()}")
        print(f"compile cache: {backend.compile_cache_dir()}")
    os.makedirs(OUT, exist_ok=True)

    if args.four_cards:
        with phase("four cards: config #5 model=4 vs model=1"):
            print(json.dumps(four_cards()))
        count = 4
    else:
        with phase("kernels"):
            print("ce (N=32768, V=44170, D=128):", json.dumps(ce_parity()),
                  f"limits nll<={NLL_MAX_ABS} grad<={GRAD_REL_FROB}")
            print("sampled (N=8192, S=1024, D=256, V=36969):", json.dumps(sampled_parity()),
                  f"limits nll<={NLL_MAX_ABS} grad<={GRAD_REL_FROB}")
            print("top-k (B=512, V=1M, D=512, k=10, chunks of 131072):", json.dumps(topk_parity()),
                  f"ids equal where the k/k+1 gap > {TOPK_GAP}")
            print("config #4 train step memory_analysis:", json.dumps(step_memory()))
        with phase("main path: config #4 train / eval / serve"):
            r = train_run("attention_gowalla", 20, "attention_gowalla")
            print("train:", json.dumps(r))
            print("eval:", json.dumps(eval_run("attention_gowalla", r["ckpt"])))
            print("serve:", json.dumps(serve_run("attention_gowalla", r["ckpt"])))
            shutil.rmtree(r["ckpt"])  # the 37k x 256 state is not needed again
        with phase("main path: configs #1 and #3 (CE)"):
            print("train:", json.dumps(train_run("gru_foursquare_nyc", 20, "gru", checkpoint=False)))
            print("train:", json.dumps(train_run("strnn_gowalla", 20, "strnn", checkpoint=False)))
        with phase("config #5 on one card"):
            # The synthesizer's min_poi_checkins=5 filter keeps ~0.2M of the
            # 1M POIs; keeping every visited POI keeps the catalog at the 1M
            # scale, which puts the table above the masked-dense limit and
            # the step on the rows-gradient path.
            extra = ["mesh.model=1", "eval.max_eval_users=2048", "data.min_poi_checkins=1"]
            print("rows-gradient step:", json.dumps(rows_mode("multihost_1m", extra)))
            r = train_run("multihost_1m", 8, "multihost_1m", extra, checkpoint=False)
            print("train:", json.dumps(r))
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

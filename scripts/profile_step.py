"""Dev-only micro-profile: split the bench workload's train-step time into
tower (queries), CE forward, CE backward, and the full step, to locate the
next optimization lever. Not part of the driver contract.

Every measurement below (a) chains the repeated body through the
accumulator inside one jit so XLA cannot hoist it out of the loop, and (b)
ends with a device->host scalar read whose value depends on all the work.
"""

from __future__ import annotations

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp


def chained(fn, params, *args, n=30, trials=3):
    """Mean per-iteration time of fn(params, *args) repeated n times in-graph,
    with params perturbed by the running accumulator so nothing is hoisted."""

    @jax.jit
    def rep(params, *a):
        def body(i, acc):
            p = jax.tree.map(lambda x: x + (acc * 1e-30).astype(x.dtype), params)
            return acc + fn(p, *a)
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    float(rep(params, *args))  # compile + drain
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        float(rep(params, *args))  # to-host fence: arrival proves execution
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def main():
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.data.pipeline import TrainLoader
    from poi_tpu.models import base as model_base
    from poi_tpu.train.loop import Trainer

    batch_size = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    cfg = get_config("smoke").with_overrides(
        {
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
            "train.batch_size": str(batch_size),
            "model.compute_dtype": "bfloat16",
        }
    )
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, model_base.DataDims.from_dataset(ds))
    state = trainer.init_state()
    loader = TrainLoader(ds.train, batch_size=cfg.train.batch_size, seed=0)
    batch = next(loader)
    model, loss_fn = trainer.model, trainer.loss_fn
    params = state.params
    dbatch = trainer._put_batch(batch)
    rng = jax.random.key(0)
    q0 = jax.jit(lambda p, b: model.queries(p, b))(params, dbatch)

    def tower_fwd(p, b):
        return jnp.sum(model.queries(p, b).astype(jnp.float32)) * 1e-30

    def tower_fwdbwd(p, b):
        g = jax.grad(lambda pp: jnp.sum(model.queries(pp, b).astype(jnp.float32)))(p)
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(g)) * 1e-30

    def ce_fwd(p, q, y, m):
        t2, b2 = model_base.output_table(p, cfg.model)
        return loss_fn(q, t2, b2, y, m, rng)

    def ce_fwdbwd(p, q, y, m):
        def f(pp, qq):
            t2, b2 = model_base.output_table(pp, cfg.model)
            return loss_fn(qq, t2, b2, y, m, rng)
        l, (gp, gq) = jax.value_and_grad(f, argnums=(0, 1))(p, q)
        return l + (
            sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(gp)) + jnp.sum(gq)
        ) * 1e-30

    def full_fwdbwd(p, b):
        def f(pp):
            q = model.queries(pp, b)
            t2, b2 = model_base.output_table(pp, cfg.model)
            return loss_fn(q, t2, b2, b.poi_tgt, b.mask, rng)
        l, g = jax.value_and_grad(f)(p)
        return l + sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(g)) * 1e-30

    # Embedding sub-region: input lookup fwd+bwd alone (the bwd is the
    # scatter-add of [B*T, D] rows into the table).
    def embed_fwdbwd(p, b):
        def f(pp):
            x = model_base.input_embeddings(pp["embed"], b, cfg.model, model.lookup)
            return jnp.sum(x.astype(jnp.float32))
        g = jax.grad(f)(p)
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(g)) * 1e-30

    # Optimizer sub-region: adam update + apply, on grads == params shapes.
    opt_state0 = trainer.optimizer.init(params)

    def opt_update(p, _b):
        import optax as _optax

        upd, _ = trainer.optimizer.update(p, opt_state0, p)
        newp = _optax.apply_updates(p, upd)
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(newp)) * 1e-30

    # Metrics sub-region: the two global norms computed every step.
    def norms(p, _b):
        import optax as _optax

        return (_optax.global_norm(p) + _optax.global_norm(p)) * 1e-30

    # Null body: the chained-harness fixed cost per iteration (params
    # perturbation tree-map + fori_loop dispatch). Every region row carries
    # this; subtract it so rows attribute device time, not harness time.
    def null_body(p, _b):
        return jnp.float32(0) * sum(
            jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(p)
        )

    B, T = batch.poi_in.shape
    V, D = trainer.dims.num_pois_padded, cfg.model.embed_dim
    ce_gf = 2 * B * T * D * V / 1e9
    t_null = chained(null_body, params, dbatch)
    raw = [
        ("embed lookup fwd+bwd", chained(embed_fwdbwd, params, dbatch)),
        ("tower fwd", chained(tower_fwd, params, dbatch)),
        ("tower fwd+bwd", chained(tower_fwdbwd, params, dbatch)),
        ("CE fwd (fixed q)", chained(ce_fwd, params, q0, dbatch.poi_tgt, dbatch.mask)),
        ("CE fwd+bwd (fixed q)", chained(ce_fwdbwd, params, q0, dbatch.poi_tgt, dbatch.mask)),
        ("full loss fwd+bwd", chained(full_fwdbwd, params, dbatch)),
        ("optimizer update", chained(opt_update, params, dbatch)),
        ("global norms x2", chained(norms, params, dbatch)),
    ]
    rows = [(tag, max(t - t_null, 0.0)) for tag, t in raw]
    print(f"batch={B} T={T} V={V} D={D}  (CE fwd matmul {ce_gf:.0f} GF)")
    print(f"  harness null body       : {t_null*1e3:7.3f} ms (subtracted from rows)")
    for tag, t in rows:
        print(f"  {tag:24s}: {t*1e3:7.3f} ms")
    t_ce_f = dict(rows)["CE fwd (fixed q)"]
    t_ce_fb = dict(rows)["CE fwd+bwd (fixed q)"]
    print(f"  CE fwd eff : {ce_gf/1e3/t_ce_f:6.1f} TF/s (1 catalog matmul)")
    print(f"  CE bwd eff : {3*ce_gf/1e3/(t_ce_fb-t_ce_f):6.1f} TF/s (2 recompute + 2 grad matmuls ~ 3x fwd work)")

    # End-to-end steady-state step (includes optimizer, metrics, host feed).
    for _ in range(5):
        state, m = trainer.step(state, next(loader))
    float(m["loss"])
    best = 0.0
    for _ in range(3):
        steps = 30
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = trainer.step(state, next(loader))
        float(m["loss"])
        best = max(best, steps * B / (time.perf_counter() - t0))
    loader.close()
    print(f"  full step          : {B/best*1e3:7.3f} ms  ({best:,.0f} seq/s)")

    # The bench path: device-sampled batches, 10 steps per dispatch — the
    # configuration BENCH_r*.json measures. Difference vs 'full loss fwd+bwd'
    # = optimizer + norms + sampler gather + scan/dispatch overhead.
    from poi_tpu.data.device_sampler import DeviceSampler

    tr2 = Trainer(
        cfg, model_base.DataDims.from_dataset(ds),
        sampler=DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed),
    )
    st2 = tr2.init_state()
    st2, m2 = tr2.step_sampled(st2, 10)
    float(m2["loss"][-1])
    best2 = 0.0
    for _ in range(4):
        t0 = time.perf_counter()
        for _ in range(3):
            st2, m2 = tr2.step_sampled(st2, 10)
        float(m2["loss"][-1])
        best2 = max(best2, 30 * B / (time.perf_counter() - t0))
    print(f"  sampled 10-step    : {B/best2*1e3:7.3f} ms/step  ({best2:,.0f} seq/s)")


if __name__ == "__main__":
    sys.exit(main())

"""Dev-only micro-profile of the config-#4 attention workload step
(counterpart of profile_step.py, which covers the CE/GRU bench workload).

Splits the sampled-softmax attention step into tower fwd / tower fwd+bwd /
loss fwd+bwd (fixed q) / optimizer, same chained-in-graph methodology (see
profile_step.py docstring).

    python scripts/profile_attn.py [batch_size]
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from profile_step import chained  # noqa: E402  (same scripts/ dir)


def main():
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.data.pipeline import TrainLoader
    from poi_tpu.models import base as model_base
    from poi_tpu.train.loop import Trainer

    batch_size = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    cfg = get_config("attention_gowalla").with_overrides(
        {
            "data.val_fraction": "0",
            "train.warmup_steps": "0",
            "train.batch_size": str(batch_size),
            "model.dropout": "0",
        }
    )
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, model_base.DataDims.from_dataset(ds))
    state = trainer.init_state()
    loader = TrainLoader(ds.train, batch_size=cfg.train.batch_size, seed=0)
    batch = next(loader)
    loader.close()
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

    def loss_fwdbwd(p, q, y, m):
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

    def embed_fwdbwd(p, b):
        def f(pp):
            x = model_base.input_embeddings(pp["embed"], b, cfg.model, model.lookup)
            return jnp.sum(x.astype(jnp.float32))

        g = jax.grad(f)(p)
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(g)) * 1e-30

    opt_state0 = trainer.optimizer.init(params)

    def opt_update(p, _b):
        import optax as _optax

        upd, _ = trainer.optimizer.update(p, opt_state0, p)
        newp = _optax.apply_updates(p, upd)
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(newp)) * 1e-30

    def null_body(p, _b):
        return jnp.float32(0) * sum(
            jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(p)
        )

    B, T = batch.poi_in.shape
    t_null = chained(null_body, params, dbatch)
    raw = [
        ("embed lookup fwd+bwd", chained(embed_fwdbwd, params, dbatch)),
        ("tower fwd", chained(tower_fwd, params, dbatch)),
        ("tower fwd+bwd", chained(tower_fwdbwd, params, dbatch)),
        ("loss fwd+bwd (fixed q)", chained(loss_fwdbwd, params, q0, dbatch.poi_tgt, dbatch.mask)),
        ("full loss fwd+bwd", chained(full_fwdbwd, params, dbatch)),
        ("optimizer update", chained(opt_update, params, dbatch)),
    ]
    print(
        f"batch={B} T={T} V={trainer.dims.num_pois_padded} D={cfg.model.embed_dim} "
        f"W={cfg.model.attn_window} heads={cfg.model.attn_heads} "
        f"sampled={cfg.loss.num_sampled}"
    )
    print(f"  harness null body       : {t_null*1e3:7.3f} ms (subtracted from rows)")
    for tag, t in raw:
        print(f"  {tag:24s}: {max(t - t_null, 0.0)*1e3:7.3f} ms")


if __name__ == "__main__":
    sys.exit(main())

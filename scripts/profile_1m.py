"""Dev-only per-region attribution of the config-#5 train step (V=1M, D=512,
B=512, sampled softmax S=4096, attention tower) on one chip — the table
VERDICT r4 Next #1 asked for.

Regions: embedding lookup fwd+bwd (whose bwd materializes the dense [1M,512]
scatter-add), tower fwd / fwd+bwd, loss fwd+bwd (fixed q), the full gradient,
the dense-grad scatter in isolation, and the optimizer update — dense Adam
(read-modify-write over every 1M-row table) vs the touched-rows-only sparse
update (train/sparse_opt.py).

Same chained-in-graph methodology as profile_step.py.

    python scripts/profile_1m.py [batch_size]
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from profile_step import chained  # noqa: E402  (same scripts/ dir)


def main():
    import optax

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.data.device_sampler import DeviceSampler
    from poi_tpu.models import base as model_base
    from poi_tpu.train.loop import Trainer
    from poi_tpu.train.sparse_opt import SparseTableOptimizer, touched_ids
    from poi_tpu.train.state import make_optimizer

    batch_size = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    cfg = get_config("multihost_1m").with_overrides(
        {
            "mesh.model": "1",
            "mesh.embedding_mode": "psum",
            "data.num_users": "20000",
            "train.batch_size": str(batch_size),
            "train.warmup_steps": "0",
            "data.sampler": "device",
            "train.table_update": "dense",  # optimizer rows built explicitly below
        }
    )
    print("synthesizing 1M-POI dataset...", file=sys.stderr, flush=True)
    ds = load_dataset(cfg.data)
    dims = dataclasses.replace(
        model_base.DataDims.from_dataset(ds), num_pois=1_000_000, num_pois_padded=0
    )
    sampler = DeviceSampler(ds.train, cfg.train.batch_size, cfg.train.seed)
    trainer = Trainer(cfg, dims, sampler=sampler)
    model, loss_fn = trainer.model, trainer.loss_fn
    # Device-memory budget at V=1M D=512: params ≈ 2.1 GiB and every extra full-tree
    # (grads, m, v, the chained-harness perturbation copy) costs the same, so
    # optimizer states are built/dropped per row instead of held together.
    params = jax.jit(model.init)(jax.random.key(cfg.train.seed))
    dbatch = jax.jit(sampler.sample)(jnp.int32(0))
    rng = jax.random.key(0)
    q0 = jax.jit(lambda p, b: model.queries(p, b))(params, dbatch)
    ids = jax.jit(lambda b, r: touched_ids(cfg, b, r, dims.num_pois))(dbatch, rng)

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

    # Dense-grad materialization in isolation: the zeros[1M,512] + scatter-add
    # that autodiff emits for every table gather, over the full touched set.
    all_ids = ids["poi"]

    def table_scatter(p, _b):
        def f(pp):
            rows = pp["embed"]["poi"].at[all_ids].get(mode="fill", fill_value=0.0)
            return jnp.sum(rows.astype(jnp.float32))

        g = jax.grad(f)(p)
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(g)) * 1e-30

    def null_body(p, _b):
        return jnp.float32(0) * sum(
            jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(p)
        )

    B, T = dbatch.poi_in.shape
    n = 10  # V=1M bodies are 10s of ms; short chains keep windows ~1 s
    print(
        f"batch={B} T={T} V={dims.num_pois_padded} D={cfg.model.embed_dim} "
        f"sampled={cfg.loss.num_sampled} heads={cfg.model.attn_heads} "
        f"touched_ids={int(all_ids.shape[0])}",
        flush=True,
    )
    t_null = chained(null_body, params, dbatch, n=n)
    print(f"  harness null body       : {t_null*1e3:7.3f} ms (subtracted from rows)", flush=True)

    def report(tag, t):
        print(f"  {tag:24s}: {max(t - t_null, 0.0)*1e3:7.3f} ms", flush=True)

    report("embed lookup fwd+bwd", chained(embed_fwdbwd, params, dbatch, n=n))
    report("tower fwd", chained(tower_fwd, params, dbatch, n=n))
    report("tower fwd+bwd", chained(tower_fwdbwd, params, dbatch, n=n))

    # Tower sub-regions on a fixed hidden-state tensor: where does the tower
    # backward time actually go (gru recurrence vs attention+LN vs the
    # input-embedding scatter)?
    from poi_tpu.models.attention import layer_norm
    from poi_tpu.ops.attention import multihead_attention

    h0 = jnp.asarray(q0)  # [B, T, D] stand-in hidden states

    def mha_ln_fwdbwd(p, h):
        def f(hh):
            o = multihead_attention(
                hh, p["tower"]["mha"], num_heads=cfg.model.attn_heads,
                window=cfg.model.attn_window,
            )
            return jnp.sum(layer_norm(p["tower"]["ln"], hh + o))

        return jnp.sum(jax.grad(f)(h).astype(jnp.float32)) * 1e-30

    report("mha+ln fwd+bwd (fixed h)", chained(mha_ln_fwdbwd, params, h0, n=n))

    # Rows-mode gradient region (Stage B): same loss, differentiated w.r.t.
    # the gathered rows — no dense [V, D] cotangent.
    from poi_tpu.train.losses import draw_sampled_negatives

    S = cfg.loss.num_sampled
    V = dims.num_pois
    neg0 = draw_sampled_negatives(rng, S, V)
    B_, T_ = dbatch.poi_in.shape
    BT = B_ * T_
    ids_all = jnp.concatenate(
        [dbatch.poi_in.ravel(), dbatch.poi_tgt.ravel(), neg0]
    ).astype(jnp.int32)
    def rows_grads_body(p, b):
        from poi_tpu import backend
        from poi_tpu.train.losses import sampled_nll

        rows0 = jnp.take(p["embed"]["poi"], ids_all, axis=0)
        brows0 = jnp.take(p["embed"]["out_bias"], ids_all, axis=0)
        rest = {
            k: ({kk: vv for kk, vv in v.items() if kk not in ("poi", "out_bias")}
                if k == "embed" else v)
            for k, v in p.items()
        }

        def f(rest_p, rows, brows):
            x_rows = rows[:BT].reshape(B_, T_, -1)
            q = model.queries(rest_p, b, poi_rows=x_rows)
            e_pos = rows[BT: 2 * BT].reshape(B_, T_, -1)
            b_pos = brows[BT: 2 * BT].reshape(B_, T_)
            s_pos = (
                jnp.einsum("btd,btd->bt", q, e_pos, preferred_element_type=jnp.float32)
                + b_pos
            )
            nll = sampled_nll(
                q, rows[2 * BT:], brows[2 * BT:], s_pos, b.poi_tgt, neg0, S, V,
                backend.sampled_impl(S, cfg.model.embed_dim),
            )
            m = b.mask
            return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)

        l, gs = jax.value_and_grad(f, argnums=(0, 1, 2))(rest, rows0, brows0)
        return l + sum(
            jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(gs)
        ) * 1e-30

    report("ROWS-mode grads fwd+bwd", chained(rows_grads_body, params, dbatch, n=n))

    report("loss fwd+bwd (fixed q)", chained(loss_fwdbwd, params, q0, dbatch.poi_tgt, dbatch.mask, n=n))
    report("full grads fwd+bwd", chained(full_fwdbwd, params, dbatch, n=n))
    report("dense-grad scatter alone", chained(table_scatter, params, dbatch, n=n))
    del q0, h0

    # Real-shaped gradients once, for the optimizer rows.
    grads = jax.jit(
        lambda p, b: jax.grad(
            lambda pp: loss_fn(
                model.queries(pp, b),
                *model_base.output_table(pp, cfg.model),
                b.poi_tgt,
                b.mask,
                rng,
            )
        )(p)
    )(params, dbatch)
    grads = jax.block_until_ready(grads)

    # grads/opt-state ride as jit ARGUMENTS (device buffers): captured in a
    # closure they lower as 6+ GB of embedded constants.
    dense_opt = make_optimizer(cfg.train)
    dense_state = jax.jit(dense_opt.init)(params)

    def opt_dense(p, g, st):
        upd, _ = dense_opt.update(g, st, p)
        newp = optax.apply_updates(p, upd)
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(newp)) * 1e-30

    report("optimizer DENSE adam", chained(opt_dense, params, grads, dense_state, n=n))
    del dense_state  # free m+v (~4.2 GiB) before building the sparse state

    sparse_opt = SparseTableOptimizer(
        cfg.with_overrides({"train.table_update": "sparse"})
    )
    sparse_state = jax.jit(sparse_opt.init)(params)

    def opt_sparse(p, g, st):
        newp, _, _ = sparse_opt.update_apply(g, st, p, ids)
        return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(newp)) * 1e-30

    report("optimizer SPARSE adam", chained(opt_sparse, params, grads, sparse_state, n=n))


if __name__ == "__main__":
    sys.exit(main())

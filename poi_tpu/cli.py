"""Command-line entry point (reference R11 → SURVEY.md §1.2 API/CLI layer).

    python -m poi_tpu train --config gru_foursquare_nyc [--set k=v ...]
    python -m poi_tpu eval  --config gru_foursquare_nyc --checkpoint-dir DIR
    python -m poi_tpu bench --config gru_foursquare_nyc
    python -m poi_tpu configs

Training composes: data pipeline → pjit'd train loop → periodic eval →
sharded checkpointing (auto-resume from the latest checkpoint in the
directory) → JSONL metrics. Runs need a GPU; ``--platform cpu`` (or
``JAX_PLATFORMS=cpu``) runs on the CPU on purpose (poi_tpu/backend.py). ``--set train.fault_inject_step=N`` exercises
the crash/resume path end-to-end (SURVEY.md §5 failure detection).
"""

from __future__ import annotations

import argparse
import logging
import sys

import jax


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="poi_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--config", required=True, help="named config (see `configs`)")
        p.add_argument("--set", nargs="*", default=[], help="dotted overrides key=value")
        p.add_argument(
            "--platform", default=None,
            help="jax platform; 'cpu' runs on the CPU on purpose, otherwise a GPU is required",
        )
        p.add_argument(
            "--debug", action="store_true",
            help="enable jax_debug_nans (fail fast on non-finite values; SURVEY.md §5 sanitizers)",
        )

    p_train = sub.add_parser("train", help="train a model")
    add_common(p_train)
    p_train.add_argument("--checkpoint-dir", default=None, help="override checkpoint directory")
    p_train.add_argument("--no-checkpoint", action="store_true")
    p_train.add_argument("--metrics-dir", default=None)
    p_train.add_argument("--tensorboard", action="store_true", help="also write TB scalars under metrics-dir/tb")
    p_train.add_argument("--profile-dir", default=None, help="trace steps 10..15 to this dir")

    p_eval = sub.add_parser("eval", help="evaluate a checkpoint")
    add_common(p_eval)
    p_eval.add_argument("--checkpoint-dir", default=None)
    p_eval.add_argument("--step", type=int, default=None,
                        help="checkpoint step to evaluate (default: latest)")

    p_rec = sub.add_parser(
        "recommend",
        help="one-shot serving: JSON check-in histories in, top-k POI ids out",
    )
    add_common(p_rec)
    p_rec.add_argument("--checkpoint-dir", default=None)
    p_rec.add_argument("--step", type=int, default=None,
                       help="checkpoint step to serve from (default: latest)")
    p_rec.add_argument("--input", default="-", help="JSON file of histories ('-' = stdin): "
                       '[[{"poi": 1, "timestamp": 1000.0}, ...], ...]')
    p_rec.add_argument("--k", type=int, default=10)
    p_rec.add_argument("--include-visited", action="store_true")

    p_srv = sub.add_parser(
        "serve",
        help="persistent serving loop: line-delimited JSON requests on stdin, "
             "one JSON response line per request (model + jit cache stay warm)",
    )
    add_common(p_srv)
    p_srv.add_argument("--checkpoint-dir", default=None)
    p_srv.add_argument("--step", type=int, default=None,
                       help="checkpoint step to serve from (default: latest)")
    p_srv.add_argument("--k", type=int, default=10, help="default top-k per request")

    p_cfgs = sub.add_parser("configs", help="list named configs")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    if args.cmd == "configs":
        from poi_tpu.configs.presets import list_configs

        for name in list_configs():
            print(name)
        return 0

    from poi_tpu import backend

    backend.init(args.platform)
    if getattr(args, "debug", False):
        jax.config.update("jax_debug_nans", True)

    from poi_tpu.configs.presets import get_config
    from poi_tpu.utils.config import parse_set_flags

    cfg = get_config(args.config).with_overrides(parse_set_flags(args.set))
    if getattr(args, "checkpoint_dir", None):
        cfg = cfg.with_overrides({"checkpoint.directory": args.checkpoint_dir})

    if args.cmd == "train":
        return run_train(
            cfg,
            enable_checkpoint=not args.no_checkpoint,
            metrics_dir=args.metrics_dir,
            profile_dir=args.profile_dir,
            tensorboard=args.tensorboard,
        )
    if args.cmd == "eval":
        return run_eval(cfg, step=args.step)
    if args.cmd == "recommend":
        return run_recommend(cfg, args.input, args.k, not args.include_visited, step=args.step)
    if args.cmd == "serve":
        return run_serve(cfg, default_k=args.k, step=args.step)
    return 1


def run_train(
    cfg,
    enable_checkpoint: bool = True,
    metrics_dir: str | None = None,
    profile_dir: str | None = None,
    tensorboard: bool = False,
) -> int:
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.data.pipeline import TrainLoader
    from poi_tpu.eval.evaluate import evaluate, popularity_baseline
    from poi_tpu.models.base import DataDims
    from poi_tpu.parallel import mesh as mesh_lib
    from poi_tpu.train.loop import Trainer, train
    from poi_tpu.utils.checkpoint import CheckpointManager, abstract_like
    from poi_tpu.utils.obs import MetricsLogger, profile_window

    log = logging.getLogger("poi_tpu.cli")
    mesh_lib.maybe_init_distributed()

    ds = load_dataset(cfg.data)
    log.info(
        "dataset: %d users, %d pois, %d train examples, %d test examples",
        ds.num_users, ds.num_pois, len(ds.train), len(ds.test),
    )
    trainer = Trainer(cfg, DataDims.from_dataset(ds))
    state = trainer.init_state()

    ckpt = None
    loader_state = None
    if enable_checkpoint:
        ckpt = CheckpointManager(
            cfg.checkpoint.directory, cfg.checkpoint.max_to_keep, cfg.checkpoint.async_save
        )
        latest = ckpt.latest_step()
        if latest is not None:
            from poi_tpu.parallel.shardings import state_shardings
            from poi_tpu.utils.checkpoint import warn_config_mismatch

            warn_config_mismatch(ckpt.saved_config(), cfg)
            sh = state_shardings(state, trainer.mesh, trainer.dims.num_pois_padded)
            state, loader_state = ckpt.restore(abstract_like(state, sh))
            log.info("resumed from checkpoint step %d", latest)

    metrics = MetricsLogger(metrics_dir, tensorboard=tensorboard)
    pw = profile_window(profile_dir, 10, 15)

    def _loader_state_at(step):
        ldr = trainer.active_loader
        return ldr.state_at(step) if ldr is not None else None

    # With a validation split (data.val_fraction > 0), periodic eval runs on
    # val and the best-on-val params are selected for the final test eval
    # (train/selection.py); without one, periodic eval runs on test directly
    # (the reference family's protocol).
    tracker = None
    if ds.val is not None:
        from poi_tpu.train.selection import BestOnVal

        tracker = BestOnVal(trainer, ds, cfg)
        if ckpt is not None:
            # Resuming a directory with a persisted selection: seed the
            # tracker so a worse later-segment val peak can never overwrite
            # the better earlier one (the selected manager keeps one step).
            info = ckpt.selected_info()
            if info and info.get("metric") == tracker.metric and info.get("score") is not None:
                from poi_tpu.parallel.shardings import state_shardings
                from poi_tpu.utils.checkpoint import abstract_like

                sh = state_shardings(state, trainer.mesh, trainer.dims.num_pois_padded)
                sel = ckpt.restore_selected(abstract_like(state, sh).params)
                tracker.seed(info["step"], float(info["score"]), jax.device_get(sel))
                log.info(
                    "seeded selection from %s: step %d %s=%.4f",
                    "selected/", info["step"], info["metric"], float(info["score"]),
                )

    def callback(step, st, m):
        pw.step(step)
        if step % cfg.train.eval_every == 0:
            from poi_tpu.utils.obs import device_memory_stats

            mem = device_memory_stats()  # empty on backends without memory_stats
            if mem:
                metrics.write(step, mem)
        if ckpt is not None and step % cfg.train.checkpoint_every == 0:
            ckpt.save(step, st, loader_state=_loader_state_at(step), config_json=cfg.to_json())
        if tracker is not None:
            tracker(step, st, m)
            if tracker.history and tracker.history[-1]["step"] == step:
                metrics.write(step, {f"val/{k}": v for k, v in tracker.history[-1].items() if k != "step"})
        elif step % cfg.train.eval_every == 0:
            em = evaluate(trainer.model, st.params, ds, cfg, mesh=trainer.mesh)
            metrics.write(step, {f"eval/{k}": v for k, v in em.items()})

    start = int(state.step)
    remaining = cfg.train.num_steps - start
    if remaining <= 0:
        log.info("checkpoint already at step %d >= num_steps", start)
        return 0
    try:
        trainer, state, history = train(
            cfg, ds, num_steps=remaining, state=state, trainer=trainer,
            callbacks=[callback], loader_state=loader_state,
        )
    finally:
        pw.close()
    for row in history:
        metrics.write(row["step"], {k: v for k, v in row.items() if k != "step"})

    eval_params = state.params
    if tracker is not None and tracker.best_step >= 0:
        eval_params = tracker.best_params(state.params)
        log.info(
            "selected best-on-val params from step %d (val %s=%.4f)",
            tracker.best_step, tracker.metric, tracker.best_score,
        )
    final = evaluate(trainer.model, eval_params, ds, cfg, mesh=trainer.mesh)
    pop = popularity_baseline(ds, cfg.eval.recall_ks)
    metrics.write(int(state.step), {f"final/{k}": v for k, v in final.items()})
    log.info("final eval: %s", final)
    log.info("popularity baseline: %s", pop)
    if ckpt is not None:
        # The main step sequence always ends with the TRUE end-of-run state
        # (consistent params/opt_state/step — resuming this directory with a
        # larger train.num_steps is sound). The best-on-val-selected params —
        # the ones the final eval was reported on — are persisted separately
        # under <dir>/selected, which `eval`/`recommend` prefer by default,
        # so a later load of this directory matches the reported metrics.
        if ckpt.latest_step() != int(state.step):
            ckpt.save(
                int(state.step), state,
                loader_state=_loader_state_at(int(state.step)), config_json=cfg.to_json(),
            )
        if tracker is not None and tracker.best_step >= 0:
            ckpt.save_selected(
                tracker.best_step, eval_params,
                metric=tracker.metric, score=tracker.best_score,
            )
        ckpt.wait()
        ckpt.close()
    metrics.close()
    return 0


def _restore_for_inference(cfg, step=None):
    """Shared eval/serve bring-up: dataset + trainer + restored state.
    ``step`` selects a specific checkpoint (default: latest — overlaid with
    the best-on-val-selected params when the run saved them, so inference on
    a finished directory reproduces its reported metrics) — checkpointed
    eval by step, SURVEY.md §5 "Checkpoint/resume"."""
    import logging as _logging

    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.models.base import DataDims
    from poi_tpu.parallel import mesh as mesh_lib
    from poi_tpu.parallel.shardings import state_shardings
    from poi_tpu.train.loop import Trainer
    from poi_tpu.utils.checkpoint import CheckpointManager, abstract_like

    from poi_tpu.utils.checkpoint import warn_config_mismatch

    mesh_lib.maybe_init_distributed()
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds))
    state = trainer.init_state()
    ckpt = CheckpointManager(cfg.checkpoint.directory)
    warn_config_mismatch(ckpt.saved_config(step), cfg)
    sh = state_shardings(state, trainer.mesh, trainer.dims.num_pois_padded)
    abstract = abstract_like(state, sh)
    state, _ = ckpt.restore(abstract, step=step)
    if step is None and ckpt.selected_step() is not None:
        state = state._replace(params=ckpt.restore_selected(abstract.params))
        _logging.getLogger("poi_tpu.cli").info(
            "using best-on-val-selected params (trained to step %d)", ckpt.selected_step()
        )
    ckpt.close()
    return ds, trainer, state


def run_recommend(cfg, input_path: str, k: int, exclude_visited: bool, step: int | None = None) -> int:
    import json

    import jax

    from poi_tpu.eval.serve import Checkin, Recommender

    # Restore first (initializes jax.distributed when configured) so
    # process_count() is meaningful; in a multi-process launch only process 0
    # reads the request and prints — the rest are compute shards.
    ds, trainer, state = _restore_for_inference(cfg, step=step)
    histories = None
    if jax.process_index() == 0:
        raw = sys.stdin.read() if input_path == "-" else open(input_path).read()
        histories = [
            [Checkin(poi=int(c["poi"]), timestamp=float(c["timestamp"]),
                     lat=c.get("lat"), lon=c.get("lon")) for c in hist]
            for hist in json.loads(raw)
        ]
    rec = Recommender(trainer.model, state.params, cfg, ds, mesh=trainer.mesh)
    out = rec.recommend(histories, k=k, exclude_visited=exclude_visited)
    if out is not None:
        print(json.dumps(out.tolist()))
    return 0


def run_serve(cfg, default_k: int = 10, step: int | None = None) -> int:
    """Persistent serving loop; works single- AND multi-process.

    Protocol: one JSON request per stdin line —
      ``[[{"poi": 1, "timestamp": 1000.0}, ...], ...]``                (bare)
      ``{"histories": [...], "k": 5, "exclude_visited": false,
         "user_ids": [...]}``                                         (full)
    → one JSON response line: ``{"ids": [[...]]}`` or ``{"error": "..."}``
    (a bad request never kills the server). EOF ends the loop. The model,
    catalog prep, and per-shape jit caches stay warm across requests, so a
    request pays only featurization and one top-k dispatch, not the
    per-invocation restore+compile that ``recommend`` pays.

    Multi-process (``jax.process_count() > 1`` — a vocab-sharded catalog
    served warm, VERDICT r4 Missing #5): process 0 is the frontend (stdin/
    stdout); the others loop as compute shards. Each ACCEPTED request is
    announced with a one-word broadcast before the sharded ``recommend``
    collectives run; malformed lines are answered locally by process 0 and
    the shards never hear of them; EOF broadcasts a shutdown word. Covered
    by the two-process gloo rig (tests/test_multihost.py).
    """
    import json

    import jax

    from poi_tpu.eval.serve import Checkin, Recommender

    log = logging.getLogger("poi_tpu.cli")
    ds, trainer, state = _restore_for_inference(cfg, step=step)
    rec = Recommender(trainer.model, state.params, cfg, ds, mesh=trainer.mesh)
    multiproc = jax.process_count() > 1
    primary = jax.process_index() == 0

    if multiproc and not primary:
        import numpy as np
        from jax.experimental import multihost_utils

        n = 0
        while int(multihost_utils.broadcast_one_to_all(np.zeros(1, np.int32))[0]):
            rec.recommend(None)
            n += 1
        log.info("compute shard %d: served %d requests", jax.process_index(), n)
        return 0

    log.info(
        "serving (step %d, %d process(es)): reading JSON requests from stdin",
        int(state.step), jax.process_count(),
    )
    served = 0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if isinstance(req, list):
                req = {"histories": req}
            histories = [
                [Checkin(poi=int(c["poi"]), timestamp=float(c["timestamp"]),
                         lat=c.get("lat"), lon=c.get("lon")) for c in hist]
                for hist in req["histories"]
            ]
            if not histories:
                raise ValueError("empty request: no histories")
            k = int(req.get("k", default_k))
            user_ids = req.get("user_ids")
            if user_ids is not None:
                import numpy as np

                user_ids = np.asarray(user_ids, np.int32)  # raises on junk
                if len(user_ids) != len(histories):
                    raise ValueError(
                        f"user_ids length {len(user_ids)} != {len(histories)} histories"
                    )
            exclude = bool(req.get("exclude_visited", True))
            if multiproc:
                # Validate the whole request BEFORE announcing to the
                # compute shards: anything that fails after the broadcast
                # leaves them mid-collective (unrecoverable), so the accept
                # word must only follow a request recommend() will take.
                rec._featurize(histories)
        except Exception as e:  # malformed request: report, keep serving
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}), flush=True)
            continue
        if multiproc:
            import numpy as np
            from jax.experimental import multihost_utils

            multihost_utils.broadcast_one_to_all(np.ones(1, np.int32))
            # Past this point an exception cannot be swallowed: the shards
            # have entered the request's collectives, so a failure here is a
            # desync — die loudly rather than serve from a broken state.
            out = rec.recommend(histories, k=k, user_ids=user_ids, exclude_visited=exclude)
        else:
            try:
                out = rec.recommend(
                    histories, k=k, user_ids=user_ids, exclude_visited=exclude
                )
            except Exception as e:  # a bad request never kills the server
                print(json.dumps({"error": f"{type(e).__name__}: {e}"}), flush=True)
                continue
        print(json.dumps({"ids": out.tolist()}), flush=True)
        served += 1
    if multiproc:
        import numpy as np
        from jax.experimental import multihost_utils

        multihost_utils.broadcast_one_to_all(np.zeros(1, np.int32))
    log.info("served %d requests", served)
    return 0


def run_eval(cfg, step: int | None = None) -> int:
    from poi_tpu.eval.evaluate import evaluate

    log = logging.getLogger("poi_tpu.cli")
    ds, trainer, state = _restore_for_inference(cfg, step=step)
    log.info("restored step %d", int(state.step))
    m = evaluate(trainer.model, state.params, ds, cfg, mesh=trainer.mesh)
    print(m)
    return 0


if __name__ == "__main__":
    sys.exit(main())

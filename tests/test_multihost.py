"""True multi-process validation (SURVEY.md §2.2 T7): two JAX processes,
jax.distributed over a local coordinator, gloo CPU collectives, a global
(4 data x 2 model) mesh spanning both processes, per-host loader shards, and
the real Trainer/train() path — the same code that runs on a multi-host GPU
cluster, minus the hardware."""

import json
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    pid = int(sys.argv[1])
    port = sys.argv[2]
    ckpt_dir = sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2 and jax.device_count() == 8

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.eval.evaluate import evaluate
    from poi_tpu.parallel.shardings import state_shardings
    from poi_tpu.train.loop import train
    from poi_tpu.utils.checkpoint import CheckpointManager, abstract_like

    cfg = get_config("smoke").with_overrides(
        {
            "mesh.model": "2",
            "mesh.embedding_mode": "psum",
            "train.num_steps": "5",
            "train.log_every": "1",
            "train.batch_size": "16",
        }
    )
    ds = load_dataset(cfg.data)
    trainer, state, history = train(cfg, ds)

    # Checkpoint sharded state from both processes, restore, then evaluate —
    # the full multi-host "train -> checkpointed eval" path (SURVEY.md T7).
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(int(state.step), state, config_json=cfg.to_json())
    mgr.wait()
    sh = state_shardings(state, trainer.mesh, trainer.dims.num_pois_padded)
    restored, _ = mgr.restore(abstract_like(state, sh))
    m = evaluate(trainer.model, restored.params, ds, cfg, mesh=trainer.mesh)
    mgr.close()
    print("RESULT " + json.dumps(
        {"pid": pid, "losses": [h["loss"] for h in history], "eval": m}
    ))
    """
)


@pytest.mark.slow
def test_two_process_train_checkpoint_eval(tmp_path):
    port = "29741"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(i), port, str(tmp_path / "ckpt")],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd="/root/repo",
        )
        for i in range(2)
    ]
    results = {}
    outputs = {}
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=420)
        outputs[i] = out
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                results[i] = json.loads(line[len("RESULT "):])
    assert set(results) == {0, 1}, outputs
    l0, l1 = results[0]["losses"], results[1]["losses"]
    assert len(l0) == 5
    # Both processes observe the same global loss at every step.
    for a, b in zip(l0, l1):
        assert abs(a - b) < 1e-5, (l0, l1)
    # And the optimization makes progress.
    assert l0[-1] < l0[0]
    # Post-restore eval: identical global metrics on every process, over the
    # full test set (each process scored only its own data-shard rows).
    e0, e1 = results[0]["eval"], results[1]["eval"]
    assert e0.keys() == e1.keys() and "recall@10" in e0
    for k in e0:
        assert abs(e0[k] - e1[k]) < 1e-9, (k, e0, e1)
    assert e0["eval_examples"] == float(len_test_examples())


def len_test_examples():
    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset

    return len(load_dataset(get_config("smoke").data).test)


@pytest.mark.slow
def test_scaling_bench_harness_two_process(tmp_path):
    """The hardware-ready scaling harness (VERDICT r1 item 7) under the local
    two-process gloo rig: both runs complete and the efficiency table renders."""
    import os

    out = tmp_path / "scaling.json"
    env = dict(os.environ, SCALING_BENCH_PORT="29882")
    common = ["--config", "smoke", "--steps", "8", "--warmup", "2", "--repeats", "1",
              "--out", str(out)]
    r1 = subprocess.run(
        [sys.executable, "scripts/scaling_bench.py", "--platform", "cpu", *common],
        capture_output=True, text=True, cwd="/root/repo", timeout=300, env=env,
    )
    assert r1.returncode == 0, r1.stdout + r1.stderr
    r2 = subprocess.run(
        [sys.executable, "scripts/scaling_bench.py", "--local-processes", "2", *common],
        capture_output=True, text=True, cwd="/root/repo", timeout=600, env=env,
    )
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "SCALING" in r2.stdout and "efficiency" in r2.stdout
    rows = json.loads(out.read_text())
    assert [r["processes"] for r in rows] == [1, 2]
    assert all(r["global_seqs_per_sec"] > 0 for r in rows)


_SERVE_WORKER = textwrap.dedent(
    """
    import json, os, sys
    pid = int(sys.argv[1])
    port = sys.argv[2]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.eval.serve import Checkin, Recommender
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.loop import Trainer

    cfg = get_config("smoke").with_overrides(
        {"mesh.model": "2"}
    )
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds))
    state = trainer.init_state()
    rec = Recommender(trainer.model, state.params, cfg, ds, mesh=trainer.mesh)

    # Requests exist on process 0 only (the serving frontend).
    histories = None
    if pid == 0:
        histories = [
            [Checkin(poi=1, timestamp=1000.0), Checkin(poi=2, timestamp=5000.0)],
            [Checkin(poi=3, timestamp=2000.0)],
            [Checkin(poi=i, timestamp=500.0 * i) for i in range(4, 9)],
        ]
    out1 = rec.recommend(histories, k=5, exclude_visited=True)
    out2 = rec.recommend(histories, k=5, exclude_visited=True)
    if pid == 0:
        assert out1.shape == (3, 5), out1.shape
        assert (out1 >= 0).all() and (out1 < ds.num_pois).all()
        assert (out1 == out2).all()
        visited = {1, 2}
        assert not (set(out1[0].tolist()) & visited)
        print("RESULT " + json.dumps({"pid": pid, "ids": out1.tolist()}))
    else:
        assert out1 is None and out2 is None
        print("RESULT " + json.dumps({"pid": pid, "ids": None}))
    """
)


_SERVE_LOOP_WORKER = textwrap.dedent(
    """
    import json, os, sys
    pid = int(sys.argv[1])
    port = sys.argv[2]
    ckpt_dir = sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )

    from poi_tpu.configs.presets import get_config
    from poi_tpu.data.dataset import load_dataset
    from poi_tpu.models.base import DataDims
    from poi_tpu.train.loop import Trainer
    from poi_tpu.utils.checkpoint import CheckpointManager

    cfg = get_config("smoke").with_overrides(
        {
            "mesh.model": "2",
            "checkpoint.directory": ckpt_dir,
        }
    )
    ds = load_dataset(cfg.data)
    trainer = Trainer(cfg, DataDims.from_dataset(ds))
    state = trainer.init_state()
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(0, state, config_json=cfg.to_json())
    mgr.wait()
    mgr.close()

    from poi_tpu.cli import run_serve
    rc = run_serve(cfg, default_k=5)
    print("RC " + str(rc))
    """
)


@pytest.mark.slow
def test_two_process_serve_loop(tmp_path):
    """Warm multi-process serving (VERDICT r4 Missing #5): the persistent
    `serve` loop at process_count=2 — process 0 reads stdin and answers,
    process 1 loops as a compute shard; malformed lines are answered locally
    without desyncing the shards; EOF shuts both down cleanly."""
    port = "29771"
    procs = []
    for i in range(2):
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _SERVE_LOOP_WORKER, str(i), port,
                 str(tmp_path / "ckpt")],
                stdin=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd="/root/repo",
            )
        )
    requests = "\n".join(
        [
            json.dumps([[{"poi": 1, "timestamp": 1000.0}, {"poi": 2, "timestamp": 5000.0}]]),
            "this is not json",
            json.dumps({"histories": [[{"poi": 3, "timestamp": 2000.0}],
                                      [{"poi": 4, "timestamp": 2500.0}]],
                        "k": 3, "exclude_visited": True}),
        ]
    ) + "\n"
    out0, _ = procs[0].communicate(input=requests, timeout=420)
    out1, _ = procs[1].communicate(timeout=420)
    assert procs[0].returncode == 0, out0[-3000:]
    assert procs[1].returncode == 0, out1[-3000:]
    replies = [json.loads(l) for l in out0.splitlines() if l.startswith("{")]
    assert len(replies) == 3
    assert "ids" in replies[0] and len(replies[0]["ids"]) == 1
    assert "error" in replies[1]
    assert "ids" in replies[2] and len(replies[2]["ids"]) == 2
    assert all(len(row) == 3 for row in replies[2]["ids"])
    assert 3 not in replies[2]["ids"][0]  # visited filter active
    assert "RC 0" in out0 and "RC 0" in out1


@pytest.mark.slow
def test_two_process_recommend(tmp_path):
    """Multi-process serving (VERDICT r2 Weak #5): process 0 holds the request,
    both processes shard the compute, process 0 gets the recommendations."""
    port = "29761"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _SERVE_WORKER, str(i), port],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd="/root/repo",
        )
        for i in range(2)
    ]
    results = {}
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=420)
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                results[i] = json.loads(line[len("RESULT "):])
    assert set(results) == {0, 1}
    assert results[0]["ids"] is not None and results[1]["ids"] is None

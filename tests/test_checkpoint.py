"""Checkpoint/resume tests: kill-and-restore continuity (SURVEY.md §4
Fault/resume tier) including the fault-injection path, and the on-disk
format's round trips (sharded, across mesh layouts, selected, retention)."""

import os

import numpy as np
import pytest

import jax

from poi_tpu.configs.presets import get_config
from poi_tpu.data.dataset import load_dataset
from poi_tpu.models.base import DataDims
from poi_tpu.train.loop import FaultInjected, Trainer, train
from poi_tpu.utils.checkpoint import CheckpointManager, abstract_like


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = get_config("smoke").with_overrides({"train.num_steps": "6", "train.log_every": "2"})
    ds = load_dataset(cfg.data)
    return cfg, ds


def test_save_restore_roundtrip(setup, tmp_path):
    cfg, ds = setup
    trainer = Trainer(cfg, DataDims.from_dataset(ds))
    state = trainer.init_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, state, loader_state={"epoch": 1, "pos": 3, "seed": 0}, config_json=cfg.to_json())
    mgr.wait()
    restored, loader_state = mgr.restore(abstract_like(state))
    for a, b in zip(jax.tree.leaves((state.params, state.opt_state)), jax.tree.leaves((restored.params, restored.opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(state.rng)), np.asarray(jax.random.key_data(restored.rng))
    )
    assert int(restored.step) == 0
    assert loader_state == {"epoch": 1, "pos": 3, "seed": 0}
    mgr.close()


@pytest.mark.slow
def test_kill_and_resume_continuity(setup, tmp_path):
    """Train 6 steps straight vs train 3 + checkpoint + crash + resume 3:
    final params must match exactly (same data order, same rng folds)."""
    cfg, ds = setup
    dims = DataDims.from_dataset(ds)

    # Continuous run.
    t_a = Trainer(cfg, dims)
    s_a = t_a.init_state()
    _, s_a, _ = train(cfg, ds, num_steps=6, state=s_a, trainer=t_a)

    # Interrupted run: 3 steps, save, "crash", restore, 3 more.
    t_b = Trainer(cfg, dims)
    s_b = t_b.init_state()
    _, s_b, _ = train(cfg, ds, num_steps=3, state=s_b, trainer=t_b)
    mgr = CheckpointManager(str(tmp_path / "resume"))
    mgr.save(3, s_b, config_json=cfg.to_json())
    mgr.wait()
    del s_b, t_b

    t_c = Trainer(cfg, dims)
    template = t_c.init_state()
    s_c, _ = mgr.restore(abstract_like(template))
    assert int(s_c.step) == 3
    _, s_c, _ = train(cfg, ds, num_steps=3, state=s_c, trainer=t_c)
    mgr.close()

    assert int(s_a.step) == int(s_c.step) == 6
    for a, b in zip(jax.tree.leaves(s_a.params), jax.tree.leaves(s_c.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.slow
def test_cli_grain_resume_mid_epoch_matches_continuous(setup, tmp_path):
    """VERDICT r1 item 6: full CLI-level crash/resume with loader_backend=grain
    and steps_per_call=10 — the resumed run must reproduce the continuous
    run's params exactly (loader state restored from the checkpoint, chunk
    boundaries aligned with checkpoint_every)."""
    from poi_tpu.cli import run_train
    from poi_tpu.train.loop import Trainer

    cfg, ds = setup
    over = {
        "data.loader_backend": "grain",
        "train.steps_per_call": "10",
        "train.num_steps": "40",
        "train.log_every": "10",
        "train.checkpoint_every": "20",
        "train.eval_every": "40",
    }
    cfg_a = cfg.with_overrides({**over, "checkpoint.directory": str(tmp_path / "a")})
    cfg_b = cfg.with_overrides({**over, "checkpoint.directory": str(tmp_path / "b")})

    assert run_train(cfg_a) == 0  # continuous 40 steps

    with pytest.raises(FaultInjected):  # crash at step 25, mid-epoch, mid-chunk
        run_train(cfg_b.with_overrides({"train.fault_inject_step": "25"}))
    assert run_train(cfg_b) == 0  # auto-resume from step-20 checkpoint

    def final_params(c):
        trainer = Trainer(c, DataDims.from_dataset(ds))
        template = trainer.init_state()
        mgr = CheckpointManager(c.checkpoint.directory)
        st, loader_state = mgr.restore(abstract_like(template), step=40)
        mgr.close()
        return st.params, loader_state

    p_a, ls_a = final_params(cfg_a)
    p_b, ls_b = final_params(cfg_b)
    assert ls_a == ls_b == {"next_index": 40}
    for a, b in zip(jax.tree.leaves(p_a), jax.tree.leaves(p_b)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_fault_inject_then_resume(setup, tmp_path):
    """The documented crash-drill: fault-inject mid-train, then resume."""
    cfg, ds = setup
    dims = DataDims.from_dataset(ds)
    trainer = Trainer(cfg, dims)
    state = trainer.init_state()
    mgr = CheckpointManager(str(tmp_path / "fault"))

    def cb(step, st, m):
        if step % 2 == 0:
            mgr.save(step, st)

    cfg_fault = cfg.with_overrides({"train.fault_inject_step": "4"})
    with pytest.raises(FaultInjected):
        train(cfg_fault, ds, state=state, trainer=trainer, callbacks=[cb])
    mgr.wait()
    assert mgr.latest_step() == 4

    template = trainer.init_state()
    restored, _ = mgr.restore(abstract_like(template))
    assert int(restored.step) == 4
    _, final, _ = train(cfg, ds, num_steps=2, state=restored, trainer=trainer)
    assert int(final.step) == 6
    mgr.close()


@pytest.mark.slow
def test_eval_and_recommend_by_step(setup, tmp_path, capsys):
    """`--step N` restores a SPECIFIC checkpoint, not the latest (checkpointed
    eval by step — SURVEY.md §5)."""
    import json

    from poi_tpu.cli import main as cli_main

    ckdir = str(tmp_path / "bystep")
    rc = cli_main([
        "train", "--config", "smoke", "--platform", "cpu",
        "--checkpoint-dir", ckdir,
        "--set", "train.num_steps=6", "train.checkpoint_every=2",
        "train.eval_every=100", "train.log_every=2", "checkpoint.max_to_keep=10",
    ])
    assert rc == 0
    capsys.readouterr()
    for step in (2, 6):
        rc = cli_main([
            "eval", "--config", "smoke", "--platform", "cpu",
            "--checkpoint-dir", ckdir, "--step", str(step),
        ])
        assert rc == 0
    out = capsys.readouterr().out
    assert "recall@10" in out
    # recommend from an early step works too
    import io
    import sys as _sys

    req = json.dumps([[{"poi": 3, "timestamp": 1000.0}]])
    old_stdin = _sys.stdin
    _sys.stdin = io.StringIO(req)
    try:
        rc = cli_main([
            "recommend", "--config", "smoke", "--platform", "cpu",
            "--checkpoint-dir", ckdir, "--step", "2", "--k", "3",
        ])
    finally:
        _sys.stdin = old_stdin
    assert rc == 0
    ids = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(ids[0]) == 3


def test_config_mismatch_warning(tmp_path, caplog):
    """Restoring with a semantics-changed config (same param shapes) must
    warn with the differing keys — shape checks cannot catch this."""
    import logging

    from poi_tpu.configs.presets import get_config
    from poi_tpu.utils.checkpoint import warn_config_mismatch

    cfg = get_config("smoke")
    cfg2 = cfg.with_overrides({"model.attn_window": "32", "data.time_buckets": "24"})
    with caplog.at_level(logging.WARNING):
        diffs = warn_config_mismatch(cfg.to_json(), cfg2)
    assert any("model.attn_window" in d for d in diffs)
    assert any("data.time_buckets" in d for d in diffs)
    assert "differs" in caplog.text
    # Identical / absent configs stay silent.
    assert warn_config_mismatch(cfg.to_json(), cfg) == []
    assert warn_config_mismatch(None, cfg) == []


def _assert_trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("save_mesh,restore_mesh", [((4, 2), (4, 2)), ((4, 2), (2, 4)), ((4, 2), (8, 1))])
def test_sharded_roundtrip_across_layouts(setup, tmp_path, eight_devices, save_mesh, restore_mesh):
    """Sharded state saved from one 8-device layout restores bit-exactly into
    the shardings of another (each device's slice assembled from the saved
    shards that overlap it)."""
    from poi_tpu.parallel.mesh import make_mesh
    from poi_tpu.parallel.shardings import state_shardings

    cfg, ds = setup
    dims = DataDims.from_dataset(ds).padded_to(4)
    t_save = Trainer(cfg, dims, mesh=make_mesh(*save_mesh))
    state = t_save.init_state()
    mgr = CheckpointManager(str(tmp_path / "sh"))
    mgr.save(7, state, loader_state={"next_index": 3}, config_json=cfg.to_json())
    t_load = Trainer(cfg, dims, mesh=make_mesh(*restore_mesh))
    template = t_load.init_state()
    sh = state_shardings(template, t_load.mesh, t_load.dims.num_pois_padded)
    restored, loader_state = mgr.restore(abstract_like(template, sh))
    _assert_trees_equal(state.params, restored.params)
    _assert_trees_equal(state.opt_state, restored.opt_state)
    table = restored.params["embed"]["poi"]
    assert table.sharding.is_equivalent_to(sh.params["embed"]["poi"], table.ndim)
    assert int(restored.step) == int(state.step) and loader_state == {"next_index": 3}
    mgr.close()


@pytest.mark.parametrize("async_save", [False, True])
def test_max_to_keep_and_latest(setup, tmp_path, async_save):
    cfg, ds = setup
    state = Trainer(cfg, DataDims.from_dataset(ds)).init_state()
    mgr = CheckpointManager(str(tmp_path / "keep"), max_to_keep=2, async_save=async_save)
    for step in (1, 2, 3, 4):
        mgr.save(step, state)
    mgr.wait()
    assert mgr.latest_step() == 4
    assert sorted(int(n) for n in os.listdir(mgr.directory) if n.isdigit()) == [3, 4]
    assert not [n for n in os.listdir(mgr.directory) if n.endswith(".tmp")]
    mgr.delete(4)
    assert mgr.latest_step() == 3
    mgr.close()


def test_selected_roundtrip_and_info(setup, tmp_path):
    cfg, ds = setup
    state = Trainer(cfg, DataDims.from_dataset(ds)).init_state()
    mgr = CheckpointManager(str(tmp_path / "sel"))
    assert mgr.selected_step() is None and mgr.selected_info() is None
    mgr.save_selected(5, state.params, metric="recall@10", score=0.25)
    mgr.save_selected(9, state.params, metric="recall@10", score=0.5)
    assert mgr.selected_step() == 9
    assert mgr.selected_info() == {"step": 9, "metric": "recall@10", "score": 0.5}
    _assert_trees_equal(state.params, mgr.restore_selected(abstract_like(state).params))
    assert mgr.latest_step() is None  # the selection is not a resumable step
    mgr.close()


def test_restore_rejects_mismatched_tree(setup, tmp_path):
    """A checkpoint of another model names the leaves that do not match
    instead of restoring garbage."""
    cfg, ds = setup
    state = Trainer(cfg, DataDims.from_dataset(ds)).init_state()
    mgr = CheckpointManager(str(tmp_path / "mm"))
    mgr.save(1, state, config_json=cfg.to_json())
    other = Trainer(cfg.with_overrides({"model.kind": "lstm"}), DataDims.from_dataset(ds)).init_state()
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(abstract_like(other))
    assert mgr.saved_config() == cfg.to_json()
    mgr.close()


def test_missing_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None and mgr.saved_config() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(None)
    with pytest.raises(FileNotFoundError):
        mgr.restore_selected(None)

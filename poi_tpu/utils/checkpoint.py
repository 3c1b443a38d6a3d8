"""Sharded save/restore of the full train state (SURVEY.md §5
"Checkpoint/resume"), in a plain on-disk format of this repository.

Every checkpoint carries params + optimizer state + step + PRNG key plus the
loader position and the serialized config, so a preempted run resumes
exactly: same data order, same sampling keys, same optimizer moments.

Layout of one checkpoint, ``<directory>/<step>/``:

- ``leaf<i>.p<process>.s<j>.npy`` — one file per shard of leaf i that the
  process owns (replicated shards are written once, by the process holding
  replica 0), so every process writes only its own shards;
- ``index.p<process>.json`` — for each leaf: its tree path, global shape and
  dtype, and the slice of the global array each of that process's files
  holds;
- ``extra.json`` — JSON extras (loader state, config), written by process 0.

A step is written under ``<step>.tmp`` and renamed once every process has
finished, so a directory named by a bare step number is always complete.
Restore reads the index files and builds each leaf with
``jax.make_array_from_callback`` into the shardings the caller asks for:
each device's slice is assembled from whichever saved shards overlap it, so
a checkpoint restores under another mesh layout too.

Best-on-val-selected params live in their own sequence under
``<directory>/selected``, keyed by the step they were trained to, keeping
one step.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Any

import jax
import numpy as np

from poi_tpu.train.state import TrainState

log = logging.getLogger(__name__)


def _sync(tag: str) -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)


def _slices_json(index, shape) -> list[list[int]]:
    return [list(sl.indices(n)[:2]) for sl, n in zip(index, shape)]


def _leaf_shards(x) -> list[tuple[list[list[int]], np.ndarray]]:
    """(global slice, host data) for each shard of ``x`` this process writes."""
    if isinstance(x, jax.Array):
        return [
            (_slices_json(s.index, x.shape), np.asarray(s.data))
            for s in x.addressable_shards
            if s.replica_id == 0
        ]
    a = np.asarray(x)
    if jax.process_index() != 0:
        return []
    return [([[0, n] for n in a.shape], a)]


class _Sequence:
    """Numbered checkpoints under one directory, newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int | None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def write(self, step: int, tree: Any, extra: dict) -> None:
        """Writes ``tree``'s shards and ``extra``; host copies are taken by
        the caller (see ``CheckpointManager._save``)."""
        tmp = self.path(step) + ".tmp"
        pid = jax.process_index()
        if pid == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _sync(f"ckpt_mkdir_{tmp}")
        index = []
        for i, (path, shape, dtype, shards) in enumerate(tree):
            files = []
            for j, (sl, data) in enumerate(shards):
                name = f"leaf{i}.p{pid}.s{j}.npy"
                np.save(os.path.join(tmp, name), data)
                files.append({"file": name, "slice": sl})
            index.append({"path": path, "shape": shape, "dtype": dtype, "files": files})
        with open(os.path.join(tmp, f"index.p{pid}.json"), "w") as f:
            json.dump(index, f)
        if pid == 0:
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump(extra, f)
        _sync(f"ckpt_written_{tmp}")
        if pid == 0:
            final = self.path(step)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            if self.max_to_keep:
                for old in self.steps()[: -self.max_to_keep]:
                    shutil.rmtree(self.path(old), ignore_errors=True)
        _sync(f"ckpt_committed_{tmp}")

    def read_extra(self, step: int) -> dict:
        try:
            with open(os.path.join(self.path(step), "extra.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def read(self, step: int, abstract: Any) -> Any:
        """Restore into the shapes, dtypes and shardings of ``abstract``."""
        root = self.path(step)
        saved: dict[str, dict] = {}
        for name in sorted(os.listdir(root)):
            if name.startswith("index.p") and name.endswith(".json"):
                with open(os.path.join(root, name)) as f:
                    for entry in json.load(f):
                        leaf = saved.setdefault(entry["path"], {**entry, "files": []})
                        leaf["files"] += entry["files"]
        leaves, treedef = jax.tree_util.tree_flatten_with_path(abstract)
        paths = [jax.tree_util.keystr(p) for p, _ in leaves]
        missing = [p for p in paths if p not in saved]
        extra = sorted(set(saved) - set(paths))
        changed = [
            f"{p}: saved {saved[p]['shape']} {saved[p]['dtype']}, wanted {list(x.shape)} {np.dtype(x.dtype)}"
            for p, (_, x) in zip(paths, leaves)
            if p in saved
            and (saved[p]["shape"] != list(x.shape) or saved[p]["dtype"] != str(np.dtype(x.dtype)))
        ]
        if missing or extra or changed:
            raise ValueError(
                f"checkpoint {root} does not match the state being restored "
                f"(was it written with another config?): missing {missing[:5]}, "
                f"unexpected {extra[:5]}, changed {changed[:5]}"
            )
        out = [
            _restore_leaf(root, saved[p]["files"], leaf, p) for p, (_, leaf) in zip(paths, leaves)
        ]
        return jax.tree_util.tree_unflatten(treedef, out)


def _restore_leaf(root: str, files: list[dict], leaf, path: str):
    shape = tuple(leaf.shape)
    dtype = np.dtype(leaf.dtype)
    opened = [(f["slice"], np.load(os.path.join(root, f["file"]), mmap_mode="r")) for f in files]

    def read(index) -> np.ndarray:
        want = [sl.indices(n)[:2] for sl, n in zip(index, shape)]
        out = np.empty([hi - lo for lo, hi in want], dtype)
        filled = 0
        for sl, data in opened:
            src, dst = [], []
            for (lo, hi), (slo, shi) in zip(want, sl):
                a, b = max(lo, slo), min(hi, shi)
                if a >= b:
                    break
                src.append(slice(a - slo, b - slo))
                dst.append(slice(a - lo, b - lo))
            else:
                out[tuple(dst)] = data[tuple(src)]
                filled += int(np.prod([s.stop - s.start for s in dst]))
        if filled < out.size:
            raise ValueError(f"{path}: saved shards do not cover slice {want}")
        return out

    sharding = getattr(leaf, "sharding", None)
    if sharding is None:
        return jax.device_put(read(tuple(slice(0, n) for n in shape)))
    return jax.make_array_from_callback(shape, sharding, read)


def _flatten(tree: Any) -> list[tuple[str, list, str, list]]:
    """(path, global shape, dtype, this process's shards) per leaf."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [
        (jax.tree_util.keystr(p), list(np.shape(x)), str(np.dtype(x.dtype)), _leaf_shards(x))
        for p, x in leaves
    ]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self._main = _Sequence(self.directory, max_to_keep)
        self._async_save = async_save
        self._selected: _Sequence | None = None
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------ save
    def _save(self, seq: _Sequence, step: int, tree: Any, extra: dict) -> None:
        """Device→host copies happen here, in the caller's thread; with
        ``async_save`` the file writes then run on one background thread
        (``wait`` joins it and re-raises its error)."""
        self.wait()
        host = _flatten(tree)
        if not self._async_save:
            seq.write(step, host, extra)
            return

        def run():
            try:
                seq.write(step, host, extra)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._pending = threading.Thread(target=run, name="checkpoint-save", daemon=True)
        self._pending.start()

    def save(self, step: int, state: TrainState, loader_state: dict | None = None, config_json: str | None = None) -> None:
        self._save(self._main, step, _serializable(state), {"loader": loader_state, "config": config_json})

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def delete(self, step: int) -> None:
        """Remove one step."""
        shutil.rmtree(self._main.path(step), ignore_errors=True)

    # ------------------------------------------------- selected (best-on-val)
    # The main step sequence always carries the true end-of-run state
    # (consistent params/opt_state/step), so resuming with a larger
    # train.num_steps is sound; eval/recommend prefer the selected params
    # when present (ADVICE r4: overwriting the final step with best-step
    # params left the real end-of-run params unrecoverable).
    def _selected_seq(self) -> _Sequence:
        if self._selected is None:
            self._selected = _Sequence(os.path.join(self.directory, "selected"), 1)
        return self._selected

    def save_selected(
        self, step: int, params: Any, metric: str | None = None, score: float | None = None
    ) -> None:
        """Persist the best-on-val params under their own step number, with
        the selection metric/score so a resumed run can seed its tracker and
        never overwrite a better previous selection."""
        self._save(self._selected_seq(), step, params, {"metric": metric, "score": score})

    def selected_step(self) -> int | None:
        if not os.path.isdir(os.path.join(self.directory, "selected")):
            return None
        return self._selected_seq().latest()

    def selected_info(self) -> dict | None:
        """{'step', 'metric', 'score'} of the persisted selection, or None."""
        step = self.selected_step()
        if step is None:
            return None
        return {"step": step, **self._selected_seq().read_extra(step)}

    def restore_selected(self, abstract_params: Any) -> Any:
        step = self.selected_step()
        if step is None:
            raise FileNotFoundError(f"no selected checkpoint under {self.directory}")
        return self._selected_seq().read(step, abstract_params)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        return self._main.latest()

    def restore(self, abstract_state: TrainState, step: int | None = None) -> tuple[TrainState, dict]:
        """Restore into the sharding/layout of ``abstract_state`` (use
        jax.eval_shape + shardings so large tables restore born-sharded)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        d = dict(self._main.read(step, _serializable(abstract_state)))
        d["rng"] = jax.random.wrap_key_data(d["rng"])
        extra = self._main.read_extra(step)
        return TrainState(**d), (extra.get("loader") or {})

    def saved_config(self, step: int | None = None) -> str | None:
        """The config JSON persisted with a checkpoint (None if absent)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return self._main.read_extra(step).get("config")

    def close(self) -> None:
        self.wait()


def warn_config_mismatch(saved_json: str | None, cfg, sections=("model", "data", "loss")) -> list[str]:
    """Compare semantics-bearing config sections against a checkpoint's saved
    config and log what differs. Same-shaped params under a different config
    (e.g. another attn_window or feature-bucketing) restore WITHOUT error and
    silently evaluate wrong — the one failure mode shape checking can't catch.
    Returns the list of differing dotted keys (for tests)."""
    if not saved_json:
        return []
    try:
        saved = json.loads(saved_json)
    except ValueError:
        return []
    live = json.loads(cfg.to_json())
    diffs = []
    for sec in sections:
        a, b = saved.get(sec, {}), live.get(sec, {})
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                diffs.append(f"{sec}.{k}: checkpoint={a.get(k)!r} vs run={b.get(k)!r}")
    if diffs:
        log.warning(
            "config differs from the one this checkpoint was trained with "
            "(same-shaped params restore silently; results may be wrong):\n  %s",
            "\n  ".join(diffs),
        )
    return diffs


def _serializable(state: TrainState) -> dict:
    """TrainState → plain dict with the typed PRNG key flattened to uint32
    key data (typed key dtypes aren't serializable)."""
    d = state._asdict()
    rng = d["rng"]
    if jax.dtypes.issubdtype(getattr(rng, "dtype", None), jax.dtypes.prng_key):
        if isinstance(rng, jax.ShapeDtypeStruct):
            d["rng"] = jax.ShapeDtypeStruct(rng.shape + (2,), np.uint32, sharding=rng.sharding)
        else:
            d["rng"] = jax.random.key_data(rng)
    return d


def abstract_like(state: TrainState, shardings=None) -> TrainState:
    """ShapeDtypeStruct pytree (optionally with shardings) for restore."""
    def absify(x, s=None):
        if hasattr(x, "shape"):
            return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=s)
        return x

    if shardings is None:
        return jax.tree.map(absify, state)
    return jax.tree.map(absify, state, shardings)

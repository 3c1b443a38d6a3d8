"""Observability: structured metrics, throughput, profiling hooks
(SURVEY.md §5 "Tracing/profiling", "Metrics/logging").

- ``MetricsLogger`` — per-step scalars to JSONL (one file per host) +
  host-0 console summaries; TensorBoard-compatible via the JSONL converter.
- ``profile_window`` — wraps steps [start, stop) in ``jax.profiler`` tracing
  for TensorBoard's profile plugin.
- ``StepTimer`` — wall-time + examples/s accounting.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

import jax

log = logging.getLogger(__name__)


class MetricsLogger:
    """Append-only JSONL metric stream + console summary on host 0, with an
    optional TensorBoard scalar stream (``tensorboard=True``; host 0 only)."""

    def __init__(self, directory: str | None, run_name: str = "train", tensorboard: bool = False):
        self.directory = directory
        self._fh = None
        self._tb = None
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, f"{run_name}_host{jax.process_index()}.jsonl")
            self._fh = open(path, "a", buffering=1)
            if tensorboard and jax.process_index() == 0:
                try:
                    from flax.metrics import tensorboard as tb

                    self._tb = tb.SummaryWriter(os.path.join(directory, "tb"))
                except ImportError:  # pragma: no cover - flax always present here
                    log.warning("flax tensorboard writer unavailable; JSONL only")

    def write(self, step: int, scalars: dict[str, Any]) -> None:
        row = {"step": step, "time": time.time(), **{k: _to_py(v) for k, v in scalars.items()}}
        if self._fh is not None:
            self._fh.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.scalar(k, v, step)
        if jax.process_index() == 0:
            pretty = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items() if k != "time")
            log.info(pretty)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def device_memory_stats() -> dict[str, float]:
    """Device-memory usage of the first local device, in GiB — empty when
    the backend doesn't expose ``memory_stats()``."""
    try:
        ms = jax.local_devices()[0].memory_stats() or {}
    except Exception:
        return {}
    return {
        f"device_{k}_gib": v / 2**30
        for k, v in ms.items()
        if k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    }


class StepTimer:
    """Tracks steps/s and examples/s over a rolling window."""

    def __init__(self, examples_per_step: int):
        self.examples_per_step = examples_per_step
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self) -> None:
        self._steps += 1

    def rates(self) -> dict[str, float]:
        dt = time.perf_counter() - self._t0
        out = {
            "steps_per_sec": self._steps / max(dt, 1e-9),
            "seqs_per_sec": self._steps * self.examples_per_step / max(dt, 1e-9),
        }
        self._t0 = time.perf_counter()
        self._steps = 0
        return out


class profile_window:
    """Trace steps [start, stop) to ``logdir`` for the TB profile plugin.

    Usage: ``pw = profile_window(logdir, 10, 15)`` then ``pw.step(i)`` once
    per train step (host 0 only traces).
    """

    def __init__(self, logdir: str | None, start: int, stop: int):
        self.logdir = logdir
        self.start, self.stop = start, stop
        self._active = False

    def step(self, i: int) -> None:
        if self.logdir is None or jax.process_index() != 0:
            return
        if i == self.start and not self._active:
            jax.profiler.start_trace(self.logdir)
            self._active = True
        elif i >= self.stop and self._active:
            jax.profiler.stop_trace()
            self._active = False

    def close(self) -> None:
        if self._active:
            jax.profiler.stop_trace()
            self._active = False

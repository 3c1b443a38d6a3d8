"""Which device the program runs on, and which implementation of each
operation runs there.

Every platform test in the package goes through this module:

- ``init`` resolves the platform of the process. A GPU is required unless
  the caller asked for the CPU explicitly (``--platform cpu`` or
  ``JAX_PLATFORMS=cpu``, as the tests do); a run that finds no GPU stops
  with ``NoAcceleratorError`` and never carries on on the CPU.
- ``init`` also sets up JAX's persistent compile cache on the GPU: the
  directory named by ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX
  reads it itself; nothing else is set in code), otherwise the fixed
  ``.jax_cache/`` at the root of the checkout.
- ``ce_impl``, ``sampled_impl`` and ``prefetch_to_device`` choose an
  implementation from the platform and the shape. No kernel runs in
  interpret mode unless a test asks for it through the kernel's
  ``interpret`` argument.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

REPO_ROOT = Path(__file__).resolve().parents[1]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

# Catalogs below this size score every column in one dense matrix: the
# [rows, V] logits are small enough that streaming them buys nothing.
STREAMED_CE_MIN_VOCAB = 8192
# Sampled pools at least this large may go through the streamed kernel on
# the GPU; smaller pools keep XLA's dense [rows, S] logits.
STREAMED_SAMPLED_MIN_POOL = 1024
# The streamed kernel runs only at feature widths where it beat XLA end to
# end on the H100 (PERF.md): D = 128 (CE, bench shape) and D = 256 (config
# #4's sampled softmax). At D = 512 (config #5) XLA's plain version was
# faster, so wider queries stay on XLA.
STREAMED_MAX_WIDTH = 256


class NoAcceleratorError(RuntimeError):
    """Raised when a run that needs the GPU finds none."""


def platform() -> str:
    """The default backend of this process: "gpu" or "cpu"."""
    return jax.default_backend()


def cpu_requested(requested: str | None) -> bool:
    return (requested or "").strip().lower() == "cpu"


def init(requested: str | None = None) -> str:
    """Resolve this process's platform; returns "gpu" or "cpu".

    ``requested`` is the ``--platform`` flag. With none, ``JAX_PLATFORMS``
    (as JAX read it) decides whether the CPU was asked for.
    """
    if requested:
        jax.config.update("jax_platforms", requested)
    requested = requested or jax.config.jax_platforms
    # A multi-process launch joins its peers before any backend starts.
    from poi_tpu.parallel.mesh import maybe_init_distributed

    maybe_init_distributed()
    try:
        found = platform()
    except RuntimeError as e:  # e.g. JAX_PLATFORMS=cuda on a host without one
        raise NoAcceleratorError(f"no GPU found: {e}") from e
    if found == "gpu":
        setup_compile_cache()
    elif not cpu_requested(requested):
        raise NoAcceleratorError(
            f"no GPU found (JAX backend {found!r}); pass --platform cpu or set "
            "JAX_PLATFORMS=cpu to run on the CPU on purpose"
        )
    return found


def compile_cache_dir() -> str:
    """Where compiled programs are kept between runs."""
    return os.environ.get(CACHE_ENV) or str(DEFAULT_CACHE_DIR)


def setup_compile_cache() -> str:
    """Point JAX's persistent cache at ``compile_cache_dir()``. The path is
    fixed (never built from a pid, a time or a temporary name), so a later
    run in the same checkout finds what this one compiled."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def ce_impl(num_pois: int, width: int, label_smoothing: float = 0.0) -> str:
    """Full-catalog CE over ``width``-wide queries: "dense" logits, XLA's
    "chunked" scan, or the streamed "triton" kernel (ops/online_lse.py)."""
    if label_smoothing > 0.0 or num_pois < STREAMED_CE_MIN_VOCAB:
        return "dense"
    if platform() != "gpu":
        return "chunked"
    return "triton" if width <= STREAMED_MAX_WIDTH else "chunked"


def sampled_impl(num_sampled: int, width: int) -> str:
    """Sampled softmax over a shared pool of ``num_sampled`` rows and
    ``width``-wide queries: XLA's dense [rows, S] logits ("xla") or the
    streamed kernel ("triton")."""
    if (
        platform() == "gpu"
        and num_sampled >= STREAMED_SAMPLED_MIN_POOL
        and width <= STREAMED_MAX_WIDTH
    ):
        return "triton"
    return "xla"


def prefetch_to_device() -> bool:
    """Whether the train loop ships batches from a worker thread. On the CPU
    there is no transfer to hide, and a concurrent ``device_put`` from a
    second thread can deadlock the CPU client against the running step."""
    return platform() != "cpu"


def visible_gpu_count() -> int:
    """GPUs this host exposes to the process, counted without starting a
    JAX backend (``jax.distributed.initialize`` must come first)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip() not in ("", "-1")])
    try:
        return len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        return 0


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s "name, power.limit" line for each card, read by a
    child process that stays off JAX. A card set below its maximum power
    runs slower under load, so every timing is reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()

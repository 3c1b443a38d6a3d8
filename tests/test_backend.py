"""The backend module: platform resolution, the compile-cache directory
rule, and each implementation choice by platform and shape."""

import jax
import pytest

from poi_tpu import backend
from poi_tpu.parallel import mesh as mesh_lib


def test_init_honors_explicit_cpu():
    assert backend.init("cpu") == "cpu"
    assert backend.init() == "cpu"  # JAX_PLATFORMS=cpu, as the tests set it


@pytest.fixture
def platforms_config():
    """Sets jax_platforms for one test and puts it back after. The CPU
    backend is already running, so only what backend.init reads changes."""
    old = jax.config.jax_platforms
    yield lambda value: jax.config.update("jax_platforms", value)
    jax.config.update("jax_platforms", old)


@pytest.mark.parametrize("requested", ["", "cpu,cuda"])
def test_init_refuses_to_run_without_a_gpu(platforms_config, requested):
    """A run that asked for no CPU and finds no GPU stops; it never carries
    on on the CPU."""
    platforms_config(requested)
    with pytest.raises(backend.NoAcceleratorError, match="no GPU"):
        backend.init(requested or None)


def test_cli_refuses_to_run_without_a_gpu(tmp_path):
    """End to end: ``python -m poi_tpu train`` with neither --platform cpu
    nor JAX_PLATFORMS=cpu exits with the error on a host without a GPU."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, "-m", "poi_tpu", "train", "--config", "smoke", "--no-checkpoint"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(backend.REPO_ROOT),
    )
    assert r.returncode != 0
    assert "NoAcceleratorError" in r.stderr and "no GPU" in r.stderr


@pytest.mark.parametrize("requested,want", [("cpu", True), (" CPU ", True), ("", False), (None, False), ("cuda", False), ("cpu,cuda", False)])
def test_cpu_requested(requested, want):
    assert backend.cpu_requested(requested) is want


def test_cache_dir_defaults_to_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv(backend.CACHE_ENV, raising=False)
    seen = {}
    monkeypatch.setattr(backend.jax.config, "update", lambda k, v: seen.__setitem__(k, v))
    path = backend.setup_compile_cache()
    assert path == str(backend.REPO_ROOT / ".jax_cache")
    assert seen == {"jax_compilation_cache_dir": path}
    assert backend.compile_cache_dir() == path  # the same path every time


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
    seen = {}
    monkeypatch.setattr(backend.jax.config, "update", lambda k, v: seen.__setitem__(k, v))
    assert backend.setup_compile_cache() == str(tmp_path)
    assert seen == {}  # JAX reads the variable itself; nothing else is set


@pytest.mark.parametrize(
    "platform,vocab,width,smoothing,want",
    [
        ("gpu", 44170, 128, 0.0, "triton"),
        ("gpu", 8192, 256, 0.0, "triton"),
        ("gpu", 44170, 512, 0.0, "chunked"),
        ("gpu", 8191, 128, 0.0, "dense"),
        ("gpu", 44170, 128, 0.1, "dense"),
        ("cpu", 44170, 128, 0.0, "chunked"),
        ("cpu", 512, 128, 0.0, "dense"),
    ],
)
def test_ce_impl(monkeypatch, platform, vocab, width, smoothing, want):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert backend.ce_impl(vocab, width, smoothing) == want


@pytest.mark.parametrize(
    "platform,pool,width,want",
    [
        ("gpu", 1024, 256, "triton"),
        ("gpu", 4096, 128, "triton"),
        ("gpu", 4096, 512, "xla"),
        ("gpu", 512, 256, "xla"),
        ("cpu", 4096, 256, "xla"),
    ],
)
def test_sampled_impl(monkeypatch, platform, pool, width, want):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert backend.sampled_impl(pool, width) == want


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_prefetch_to_device(monkeypatch, platform, want):
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert backend.prefetch_to_device() is want


def test_build_loss_fn_takes_the_kernel_on_gpu(monkeypatch):
    """On the GPU the large-catalog CE and the sampled loss route through the
    streamed kernel: tracing them reaches ops.online_lse."""
    import jax.numpy as jnp

    from poi_tpu.ops import online_lse
    from poi_tpu.train.losses import build_loss_fn
    from poi_tpu.utils.config import LossConfig

    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    calls = []

    def fake(q, t, b, rid=None, cid=None, interpret=False):
        calls.append(t.shape)
        return jnp.zeros(q.shape[:1])

    monkeypatch.setattr(online_lse, "online_lse", fake)
    q, y, m = jnp.zeros((2, 3, 8)), jnp.zeros((2, 3), jnp.int32), jnp.ones((2, 3))
    table, bias = jnp.zeros((9000, 8)), jnp.zeros((9000,))
    jax.eval_shape(lambda: build_loss_fn(LossConfig(kind="ce"), 9000)(q, table, bias, y, m, None))
    jax.eval_shape(lambda: build_loss_fn(LossConfig(kind="sampled_softmax", num_sampled=1024), 9000)(
        q, table, bias, y, m, jax.random.key(0)))
    assert calls == [(9000, 8), (1024, 8)]


@pytest.mark.parametrize(
    "visible,want", [("0,1,2,3", 4), ("2", 1), ("", 0), ("-1", 0), ("0, 1", 2)]
)
def test_visible_gpu_count_from_environment(monkeypatch, visible, want):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert backend.visible_gpu_count() == want


@pytest.mark.parametrize("pid,gpus,want", [(0, 4, [0]), (3, 4, [3]), (5, 4, [1]), (1, 1, [0]), (2, 0, None)])
def test_one_card_per_process(pid, gpus, want):
    assert mesh_lib.local_device_ids_for(pid, gpus) == want

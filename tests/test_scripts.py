"""Dev-script smoke coverage: the measurement tooling under scripts/ must
keep running as the APIs underneath evolve."""

import subprocess
import sys

import pytest


@pytest.mark.slow
def test_mem_budget_runs_on_smoke():
    """scripts/mem_budget.py: pytree accounting + XLA memory_analysis of the
    real jit step, on the CPU backend (smoke config)."""
    r = subprocess.run(
        [sys.executable, "scripts/mem_budget.py", "smoke", "--set",
         "train.table_update=sparse", "loss.kind=sampled_softmax",
         "loss.num_sampled=64"],
        capture_output=True, text=True, cwd="/root/repo", timeout=420,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": "/root", "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "pytree accounting" in r.stdout
    assert "lazy path" in r.stdout  # smoke tables are small → masked-dense, not rows mode
    assert "memory_analysis" in r.stdout or "peak" in r.stdout


@pytest.mark.slow
def test_compare_attention_modes_runs_small():
    """scripts/compare_attention_modes.py on tiny dims: compiles all three
    impls across meshes and prints the wire table."""
    r = subprocess.run(
        [sys.executable, "scripts/compare_attention_modes.py",
         "--dim", "32", "--heads", "8", "--batch", "16", "--seqlen", "16",
         "--window", "4"],
        capture_output=True, text=True, cwd="/root/repo", timeout=420,
        env={"PATH": "/usr/bin:/bin", "HOME": "/root", "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0, r.stdout + r.stderr
    for impl in ("blockwise", "ring", "ulysses"):
        assert impl in r.stdout

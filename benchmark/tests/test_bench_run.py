"""``run.py`` refuses to run without a card, and its check for JAX
compares each module's top-level name whole."""

import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.run import forbidden_modules


def test_forbidden_modules_compare_top_level_names_whole():
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax",
                              "stylemesh_tpu.models.vgg", "numpy"]) == [
        "flax", "jax", "jaxlib", "stylemesh_tpu"]
    assert forbidden_modules(["stylemesh_tpu_torch", "stylemesh_tpu_torch.ops",
                              "jaxtyping", "benchmark.run"]) == []


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.run, benchmark.harness, benchmark.check, "
            "benchmark.calibrate, benchmark.faults; "
            "from benchmark.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "scannet_dip.b1r1", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

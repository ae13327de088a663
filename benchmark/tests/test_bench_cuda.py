"""On the card: each cell of ``BENCHMARK.json`` runs a short window with
``correct`` true, and the control, the reference in float8 at the cell's
own size, comes out not correct. Skips without a card; run on one with
``python -m pytest --noconftest -m cuda benchmark/tests/test_bench_cuda.py``
from the checkout's root."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("scannet_full.b4r20", "scannet_full.b1r20")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_and_control_does_not(card, name):
    from benchmark import check, harness
    from benchmark.run import run_cell

    cell = harness.load_cell(name)
    result = run_cell(cell, 77, 2.0, 0, card, time.perf_counter())
    assert result["correct"] is True
    with harness.workdir() as wd:
        s = harness.Session(cell, 78, card, wd)
        s.free()
        cfg = harness.resolved(s.pipe_cfg)
        ref = check.reference_numbers(s, cfg)
        control = check.reference_numbers(s, cfg, "fp8")
    assert not check.verdict(check.gaps(control, ref), cell.limits)

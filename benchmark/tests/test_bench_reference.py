"""The plain reference against the port's plain CPU path: at a tiny size
in float32 the two agree to rounding; the control (the reference in
float8) and the program with a fault planted come out not correct."""

import time

import pytest

from benchmark import check, faults, harness
from benchmark.run import run_cell
from conftest import CELLS


def readings(root, bench_dir, name, seed, control=False):
    """(cell, program numbers, reference numbers, control numbers or None)
    of the tiny cell ``name`` on the CPU."""
    cell = harness.load_cell(name, root, bench_dir)
    with harness.workdir() as wd:
        s = harness.Session(cell, seed, "cpu", wd)
        cfg = harness.resolved(s.pipe_cfg)
        ref = check.reference_numbers(s, cfg)
        ctl = check.reference_numbers(s, cfg, "fp8") if control else None
    return cell, s.numbers, ref, ctl


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port_in_float32(tiny_f32, name):
    _, program, ref, _ = readings(*tiny_f32, name, 3)
    gaps = check.gaps(program, ref)
    # the first step renders the zero texture: no Adam step yet, so the
    # losses and the gradient agree to float32 rounding
    for k in check.LOSS_TERMS:
        assert program["losses"][0][k] == pytest.approx(
            ref["losses"][0][k], rel=1e-5)
    assert gaps["grad_gap"] < 1e-5
    # three steps of Adam move each texel by about its gradient's sign,
    # so elements nought to rounding can land either way
    assert gaps["loss_gap"] < 1e-3 and gaps["change_gap"] < 5e-3
    # the content targets are one forward of the photos, compared element
    # by element
    assert program["content"] and gaps["content_gap"] < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_f32, name):
    cell, _, ref, control = readings(*tiny_f32, name, 4, control=True)
    assert not check.verdict(check.gaps(control, ref), cell.limits)


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS for f in faults.FAULTS
    if f != "half_batch" or c.endswith(".b4r20")])
def test_run_with_a_fault_is_not_correct(tiny_f32, name, fault):
    cell = harness.load_cell(name, *tiny_f32)
    assert fault in faults.applicable(cell)
    with faults.FAULTS[fault]():
        result = run_cell(cell, 5, 0.5, 0, "cpu", time.perf_counter(),
                          bench_dir=tiny_f32[1], log=lambda *a: None)
    assert result["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_f32, name):
    cell = harness.load_cell(name, *tiny_f32)
    result = run_cell(cell, 6, 0.5, 0, "cpu", time.perf_counter(),
                      bench_dir=tiny_f32[1], log=lambda *a: None)
    assert result["correct"] is True
    assert list(result["checks"]) == list(check.NUMBERS)
    assert result["attempted"] > 0 and result["failed"] == 0

"""The recorded stretches of a traced run (``progtrace.py``), on the CPU:
the unprofiled one carries the program's ``train_step`` spans, the
profiled one its spans, counters and the two breakdown lists; their
readers read nothing off CUDA, nor on a program without the recorder."""

import time

import pytest

from benchmark import harness, progtrace
from benchmark.run import run_cell
from stylemesh_tpu_torch.utils import profiling

NEW = ("enqueue_ms", "forward_ms", "backward_ms", "update_ms", "h2d_gbps")
SPANS = ("get_batch", "to_device", "prepare_batch", "train_step", "forward",
         "backward", "update")


def test_traced_run_carries_the_program_record(tiny):
    root, bench_dir = tiny
    cell = harness.load_cell("scannet_full.b4r20", root, bench_dir)
    assert set(NEW) <= {m["name"] for m in cell.metrics_of("per_layer")}
    with harness.workdir() as wd:
        session = harness.Session(cell, 2 ** 31 + 5, "cpu", wd)
        record = harness.Record(session, 0.0)
        record.stretches = harness.measure_traced(session, 1.0)
        assert progtrace.read(record) is None  # off CUDA
        assert progtrace.enqueue_s(record) is None
        logs = []
        host, stretch = progtrace.recorded_stretches(record, 2,
                                                     log=logs.append)
        # once a run
        assert progtrace.recorded_stretches(record) == (host, stretch)
        assert record.stretches["recorded"] is stretch
        assert record.stretches["recorded_host"] is host
        chunk_steps = session.run.index_repeat
        session.free()
    # two whole chunks each
    assert host.steps == stretch.steps == 2 * chunk_steps
    assert [p for _, _, p in host.segments] == [True, True]
    assert [p for _, _, p in stretch.segments] == [True, True]
    enqueue = progtrace.host_s(host.program.spans, "train_step")
    assert len(enqueue) == host.steps and min(enqueue) > 0
    assert "get_batch" in {s.name for s in host.program.spans}
    spans = stretch.program.spans
    names = [s.name for s in spans]
    assert set(SPANS) <= set(names)
    assert names.count("train_step") == stretch.steps > 0
    assert names.count("get_batch") == sum(p for _, _, p in stretch.segments)
    # the CPU is the host: nothing was copied to a device
    assert stretch.program.counters == {}
    for s in spans:
        if s.name in ("forward", "backward", "update"):
            assert spans[s.parent].name == "train_step"
    rows = {r[0]: r for r in stretch.join.rows()}
    assert set(SPANS) | {progtrace.OUTSIDE} == set(rows)
    assert all(len(r) == 5 for r in rows.values())
    assert rows["train_step"][1] >= rows["forward"][1] > 0
    gaps = stretch.join.idle_gaps()  # no device operations on the CPU
    assert sum(v for _, v in gaps) * stretch.steps == pytest.approx(
        stretch.join.timeline.window_s)
    assert any(line.startswith("[progtrace] program_spans ")
               for line in logs)
    assert any(line.startswith("[progtrace] unprofiled: ")
               and "0 steps failed" in line for line in logs)
    assert any(line.startswith("[progtrace] idle_gaps_program ")
               for line in logs)


def test_readers_read_nothing_without_a_card_or_recorder(tiny, monkeypatch):
    root, bench_dir = tiny
    cell = harness.load_cell("scannet_full.b4r20", root, bench_dir)
    result = run_cell(cell, 11, 1.0, 1, "cpu", time.perf_counter(),
                      bench_dir=bench_dir, log=lambda *a: None)
    assert result["correct"] is True
    assert not set(NEW) & set(result["metrics"])
    # the parent's program has no recorder: the stretch is not run
    monkeypatch.delattr(profiling, "recording")
    with harness.workdir() as wd:
        session = harness.Session(cell, 12, "cpu", wd)
        record = harness.Record(session, 0.0, stretches={})
        assert progtrace.recorded_stretches(record) is None
        assert record.stretches == {}
        session.free()

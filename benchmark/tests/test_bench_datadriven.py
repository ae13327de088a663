"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries only: the harness picks them up by name, with no edit
to a file that is there."""

import json
import shutil
import time

from benchmark import harness
from benchmark.run import run_cell
from conftest import ROOT, tiny_bench

DIP_CELL = "scannet_dip.b4r1"  # a second DIP cell beside scannet_dip.b1r1

METRIC = '''"""A made-up per-layer metric: the steps of the synced stretch."""


def read(record):
    return float(record.stretches["synced"].steps)
'''


def test_new_files_and_entries_make_a_new_cell(tiny):
    root, bench_dir = tiny
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench_dir / "configs" / "scannet_dip.json").read_text())
    cfg["pipeline"]["hierarchical_layers"] = 2
    (bench_dir / "configs" / "made_up.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "b4r20.json").read_text())
    traffic.update(views_per_step=2, index_repeat=2)
    (bench_dir / "traffic" / "b2r2.json").write_text(json.dumps(traffic))
    shutil.copy(bench_dir / "limits" / "scannet_dip.b1r1.json",
                bench_dir / "limits" / "made_up.b2r2.json")
    (bench_dir / "metrics" / "made_up_steps.py").write_text(METRIC)
    b["configs"].append({"name": "made_up", "source": "a test",
                         "file": "bench/configs/made_up.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "made_up.b2r2", "config": "made_up",
                           "traffic": "b2r2", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "made_up_steps", "unit": "steps",
                           "better": "higher", "source": "program_span",
                           "layer": "train step", "moves": "views_per_s",
                           "workloads": ["made_up.b2r2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = harness.load_cell("made_up.b2r2", root, bench_dir)
    assert cell.traffic["views_per_step"] == 2
    assert [m["name"] for m in cell.metrics_of("per_layer")][-1] == \
        "made_up_steps"
    # the per-layer metrics that list their cells report in those alone
    for trace, want in ((0, {"views_per_s", "setup_s"}),
                        (1, {"made_up_steps"})):
        result = run_cell(cell, 9, 1.0, trace, "cpu", time.perf_counter(),
                          bench_dir=bench_dir, log=lambda *a: None)
        assert set(result["metrics"]) == want
        assert result["correct"] is True
    # the benchmark's own cells do not report the made-up metric
    other = harness.load_cell("scannet_dip.b1r1", root, bench_dir)
    assert "made_up_steps" not in [m["name"] for m in other.metrics]


def test_a_dip_cell_added_by_entries_alone(tmp_path):
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    config, traffic = DIP_CELL.split(".")
    if config not in [c["name"] for c in b["configs"]]:
        b["configs"].append({"name": config, "source": "a test",
                             "file": f"benchmark/configs/{config}.json",
                             "reduced": [], "why": "a test"})
    if DIP_CELL not in [w["name"] for w in b["workloads"]]:
        b["workloads"].append({"name": DIP_CELL, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    root, bench_dir = tiny_bench(tmp_path / "tiny", f32=True,
                                 source=tmp_path / "BENCHMARK.json")
    limits = bench_dir / "limits" / f"{DIP_CELL}.json"
    if not limits.exists():  # the file that the cell's PR would bring
        shutil.copy(bench_dir / "limits" / "scannet_dip.b1r1.json", limits)

    for name in ("scannet_dip.b1r1", DIP_CELL):
        cell = harness.load_cell(name, root, bench_dir)
        assert cell.config["pipeline"]["gram_mode"] == "average"
        result = run_cell(cell, 8, 0.5, 0, "cpu", time.perf_counter(),
                          bench_dir=bench_dir, log=lambda *a: None)
        assert result["correct"] is True, result["checks"]
        assert result["attempted"] > 0 and result["failed"] == 0

"""Puts the checkout's root on ``sys.path``, so ``benchmark`` and the port
import as packages, and builds tiny copies of the benchmark's cells for
the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
BENCH = ROOT / "benchmark"
CELLS = ("scannet_full.b4r20", "scannet_full.b1r20", "scannet_dip.b1r1")


def tiny_bench(dest, f32=False, source=ROOT / "BENCHMARK.json"):
    """A checkout root under ``dest`` whose ``BENCHMARK.json`` holds the
    cells of ``source`` (a ``BENCHMARK.json``; its files are the
    benchmark's) cut to a CPU's size: a 64x64 atlas, 32-pixel views of a
    6-view 48x64 scene with UV levels 32..56, 3 repeats. ``f32`` runs the
    pipeline in float32 with float32 K1/K2. Returns (root, bench_dir)."""
    root = Path(dest)
    bench_dir = root / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bench_dir / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", bench_dir / "metrics",
                    dirs_exist_ok=True)
    shutil.copy(BENCH / "peaks.json", bench_dir / "peaks.json")
    bench = json.loads(Path(source).read_text())
    # scannet_dip.b1r1's files are in the benchmark, its entries may not be
    # (PERF.md): each entry is added where no entry of its name is there
    if "scannet_dip" not in [c["name"] for c in bench["configs"]]:
        bench["configs"].append({"name": "scannet_dip", "reduced": [],
                                 "file": "benchmark/configs/scannet_dip.json"})
    if "scannet_dip.b1r1" not in [w["name"] for w in bench["workloads"]]:
        bench["workloads"].append({"name": "scannet_dip.b1r1", "chips": 1,
                                   "config": "scannet_dip",
                                   "traffic": "b1r1"})
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["pipeline"].update(texture_width=64, texture_height=64)
        cfg["run"].update(resize_size=32, min_pyramid_height=32)
        if f32:
            cfg["pipeline"].update(compute_dtype=None, precision="highest",
                                   kernel_compute="f32")
        c["file"] = f"bench/configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        t["scene"].update(views=6, photo_hw=[48, 64],
                          uv_heights=[32, 40, 48, 56], style_hw=[40, 52])
        t["index_repeat"] = min(t["index_repeat"], 3)
        (bench_dir / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(t))
        limits = BENCH / "limits" / f"{w['name']}.json"
        if limits.exists():  # else the caller writes the cell's limits
            shutil.copy(limits, bench_dir / "limits" / limits.name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench_dir


@pytest.fixture
def tiny(tmp_path):
    return tiny_bench(tmp_path)


@pytest.fixture
def tiny_f32(tmp_path):
    return tiny_bench(tmp_path, f32=True)

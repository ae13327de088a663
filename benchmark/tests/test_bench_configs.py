"""Each configuration file holds today's preset exactly, and
``BENCHMARK.json`` keeps to the names, units and keys of the benchmark's
contract."""

import dataclasses
import json
import re

import pytest

from benchmark import harness
from stylemesh_tpu_torch.cli import build_parser, configs_from_args
from stylemesh_tpu_torch.presets import apply_preset

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# RunConfig fields the run sets from the written scene
RUN_TIME = {"root_path", "scene", "style_image_path"}


def bench():
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def plain(v):
    return list(v) if isinstance(v, tuple) else v


@pytest.mark.parametrize("name", ["scannet_full", "scannet_dip"])
def test_config_file_is_todays_preset(name):
    args = build_parser().parse_args(["--preset", name, "--bfloat16"])
    run, pipe = configs_from_args(apply_preset(args, name, {"bfloat16"}))
    cfg = json.loads((harness.BENCH_DIR / "configs" / f"{name}.json")
                     .read_text())
    want = dataclasses.asdict(pipe)
    want["compute_dtype"] = "bfloat16"
    assert {k: plain(v) for k, v in want.items()} == cfg["pipeline"]
    want = {k: plain(v) for k, v in dataclasses.asdict(run).items()
            if k not in RUN_TIME}
    assert want == {k: v for k, v in cfg["run"].items() if k not in RUN_TIME}
    cell = harness.Cell(name, 1, cfg, {"views_per_step": 1,
                                       "index_repeat": run.index_repeat},
                        {}, [])
    assert harness.pipeline_config(cell) == pipe


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/")
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["chips"] == 1
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        harness.load_cell(w["name"])  # its traffic and limits files exist
        names += [w["name"], w["traffic"]]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(b)) < 64 * 1024

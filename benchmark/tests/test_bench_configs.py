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


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_limits_give_every_compared_number_a_limit(name):
    from benchmark import check

    limits = harness.load_cell(name).limits
    assert set(limits) == set(check.NUMBERS)
    assert all(v > 0 for v in limits.values())


def level_tables(cell, wd, seed):
    """The scene of ``cell`` written for ``seed`` under ``wd`` at its own
    size, and what ``harness.Session`` checks its chunks with: (cache,
    train indices, run config, pipeline config with the static level skip,
    loss_live, grad_live)."""
    from benchmark.scene import write_scene
    from stylemesh_tpu_torch.data.loading import SceneCache
    from stylemesh_tpu_torch.data.sampling import make_split
    from stylemesh_tpu_torch.optimize import (
        discover_scene,
        scene_grad_dead_levels,
        scene_skip_levels,
        view_level_tables,
    )

    data_root, scene, style = write_scene(wd, cell.traffic["scene"], seed)
    run = harness.run_config(cell, data_root, scene, style)
    pipe_cfg = harness.pipeline_config(cell)
    cache = SceneCache(discover_scene(run), resize_size=run.resize_size)
    tables = loss_live, grad_live = view_level_tables(cache, pipe_cfg)
    skip = tuple(sorted(set(scene_skip_levels(cache, pipe_cfg, tables))
                        | set(pipe_cfg.skip_levels)))
    dead = tuple(sorted((set(scene_grad_dead_levels(cache, pipe_cfg, tables))
                         | set(pipe_cfg.stop_grad_levels)) - set(skip)))
    pipe_cfg = dataclasses.replace(pipe_cfg, skip_levels=skip,
                                   stop_grad_levels=dead)
    train_idx, _ = make_split(cache.num_views,
                              split=(run.train_split, run.val_split),
                              split_mode=run.split_mode, shuffle=run.shuffle,
                              seed=run.seed)
    return cache, train_idx, run, pipe_cfg, loss_live, grad_live


def test_one_view_cell_as_the_harness_sees_it():
    from benchmark import faults

    name = "scannet_full.b1r20"
    cell = harness.load_cell(name)
    assert cell.traffic["views_per_step"] == 1
    assert cell.traffic["index_repeat"] == 20
    b4 = json.loads((harness.BENCH_DIR / "traffic" / "b4r20.json")
                    .read_text())
    assert cell.traffic["scene"] == b4["scene"]
    b = bench()
    assert [m["name"] for m in cell.metrics_of("per_layer")] == [
        m["name"] for m in b["per_layer"] if name in m.get("workloads", [])]
    assert {m["name"] for m in cell.metrics_of("end_to_end")} == {
        "views_per_s", "setup_s"}
    assert faults.applicable(cell) == ["unchanged_state"]

    with harness.workdir() as wd:
        cache, train_idx, run, pipe_cfg, loss_live, grad_live = level_tables(
            cell, wd, 2 ** 31 + 22)
    assert run.views_per_batch == 1 and len(train_idx) > 1
    assert loss_live.shape == (cell.traffic["scene"]["views"], 4)
    # every one-view chunk keeps every level of the run
    harness._same_signature(cache, train_idx, run, pipe_cfg, loss_live,
                            grad_live)
    # and a view that loses a level is refused
    view = train_idx[5]
    live = loss_live.copy()
    live[cache._pos_of[view], 3] = False
    with pytest.raises(ValueError, match=rf"chunk \[{view}\] drops level 3"):
        harness._same_signature(cache, train_idx, run, pipe_cfg, live,
                                grad_live)

"""Port parity, the slice as a whole: ``optimize.run_training`` of both
packages on one ScanNet-layout scene written to ``tmp_path`` (float32, a
64² x 2 Laplacian atlas, so that the JAX package attaches no splat plans,
two UV levels, two epochs, batches of two views each repeated twice), and
the CLI: its configuration, its refusals of mode combinations, and its runs
on the CPU with the post chain (styled frames, video, reprojection eval)
and TensorBoard event files.

The scene is made so that the run loop's level decisions all occur: views
0-1 see only level 0 (their batch skips level 1), views 2-3 see level 1
and view 3 a few isolated level-0 pixels that erosion removes (their batch
keeps level 0's loss value and detaches it); the validation view sees both.

Tolerances: the split, the chunk order, the level decisions and the keys
of ``run_config.json`` and ``wallclock.json`` are equal (the port has no
``splat_planning`` phase: it plans nothing); every logged loss 1e-4
relative (float32 against JAX ``Precision.HIGHEST``); the final texture
within 2e-2 normwise of JAX's, relative to its size (the texture starts at
zero): eight Adam steps at lr 1.0 move a texel by about ``lr * sign(g)``,
so texels whose gradient is at float32 noise move differently.
"""

import dataclasses
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from stylemesh_tpu import cli as jcli
from stylemesh_tpu import optimize as joptimize
from stylemesh_tpu.data.loading import SceneCache as JSceneCache
from stylemesh_tpu.models.pipeline import PipelineConfig as JPipelineConfig
from stylemesh_tpu.models import pipeline as jpipeline
from stylemesh_tpu.models.texture import Texture as JTexture
from stylemesh_tpu_torch import cli as tcli
from stylemesh_tpu_torch import optimize as toptimize
from stylemesh_tpu_torch.convert import train_state_from_numpy
from stylemesh_tpu_torch.models import pipeline as tpipeline
from stylemesh_tpu_torch.data.loading import SceneCache as TSceneCache
from stylemesh_tpu_torch.models.pipeline import PipelineConfig as TPipelineConfig
from stylemesh_tpu_torch.presets import PRESETS

SCENE = "scene0007_00"
HW = (24, 32)
UV_HEIGHTS = (16, 24)
PIPE = dict(texture_width=64, texture_height=64, hierarchical_layers=2,
            use_angle_weight=True, use_depth_scaling=True,
            content_weight=7e1, style_weight=1e-4, tex_reg_weight=5e3,
            style_pyramid_mode="multi", angle_threshold=30.0,
            learning_rate=1.0, decay_step_size=3, style_min_size=16,
            remat_vgg=False, kernel_compute="f32")


def _make_scene(root, n=5):
    """The ScanNet layout of tests/test_data.py with chosen depths (mm)."""
    sp = root / "train" / "images" / SCENE
    for sub in ["color", "depth", "pose", "uv"] + [f"uv_{h}" for h in UV_HEIGHTS]:
        (sp / sub).mkdir(parents=True)
    h, w = HW
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            sp / "color" / f"{i}.jpg")
        depth = np.full((h, w), 2000, np.uint16)  # level 1
        if i in (0, 1):
            depth[:] = 100  # level 0
        elif i == 3:
            depth[10:12, 10:12] = 100  # isolated level-0 pixels
        elif i == 4:
            depth[:, :w // 2] = 100
        Image.fromarray(depth).save(sp / "depth" / f"{i}.png")
        np.savetxt(sp / "pose" / f"{i}.txt", np.eye(4) + rng.normal(0, 0.01, (4, 4)))
        np.save(sp / "uv" / f"{i}.angle.npy", rng.random((h, w, 3), dtype=np.float32))
        for lh in UV_HEIGHTS:
            uv = rng.random((lh, lh * w // h, 3), dtype=np.float32)
            uv[:2, :2] = 0.0
            np.save(sp / f"uv_{lh}" / f"{i}.npy", uv)
    with open(sp / f"{SCENE}.txt", "w") as f:
        f.write("fx_color = 30.0\nfy_color = 31.0\nmx_color = 16.0\n"
                f"my_color = 12.0\ncolorWidth = {w}\ncolorHeight = {h}\n")
    style = root / "style.jpg"
    Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)).save(style)
    return str(style)


def _metrics(log_dir):
    with open(f"{log_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _json(path):
    with open(path) as f:
        return json.load(f)


def _record_chunks(monkeypatch, cls, calls):
    real = cls.get_batch
    monkeypatch.setattr(cls, "get_batch",
                        lambda self, idx: calls.append(list(idx)) or real(self, idx))


def _start_from(monkeypatch, layers):
    """Both packages' ``TexturePipeline.init`` return the same state: the
    given texture, zero Adam moments, step 0 (the port's through
    ``convert.train_state_from_numpy``)."""
    jinit = jpipeline.TexturePipeline.init

    def jax_init(self, rng=None):
        texture = JTexture.from_arrays(layers)
        return jinit(self)._replace(texture=texture,
                                    opt_state=self.optimizer.init(texture))

    def port_init(self, generator=None):
        zeros = [np.zeros_like(l) for l in layers]
        return train_state_from_numpy(layers, zeros, zeros, 0, self.device)

    monkeypatch.setattr(jpipeline.TexturePipeline, "init", jax_init)
    monkeypatch.setattr(tpipeline.TexturePipeline, "init", port_init)


def test_run_training_matches_jax(tmp_path, monkeypatch):
    style = _make_scene(tmp_path)
    rng = np.random.default_rng(5)
    start = [rng.normal(0, 20, (64 >> i, 64 >> i, 3)).astype(np.float32)
             for i in range(2)]
    _start_from(monkeypatch, start)
    run = dict(root_path=str(tmp_path), dataset="scannet", scene=SCENE,
               resize_size=16, pyramid_levels=4, min_pyramid_height=16,
               index_repeat=2, max_epochs=2, views_per_batch=2,
               style_image_path=style, run_post_steps=False)
    jcalls, tcalls = [], []
    _record_chunks(monkeypatch, JSceneCache, jcalls)
    _record_chunks(monkeypatch, TSceneCache, tcalls)
    _, jdir, _ = joptimize.run_training(
        joptimize.RunConfig(log_dir=str(tmp_path / "jax"), **run),
        JPipelineConfig(**PIPE))
    _, tdir, _, _ = toptimize.run_training(
        toptimize.RunConfig(log_dir=str(tmp_path / "port"), **run),
        TPipelineConfig(precision="highest", **PIPE), device="cpu")

    # split, chunk order (one host slice per new chunk, then validation)
    # (the validation batch is padded to two views by cycling)
    assert tcalls == jcalls == [[0, 1], [2, 3], [4, 4], [0, 1], [2, 3], [4, 4]]
    jcfg, tcfg = _json(f"{jdir}/run_config.json"), _json(f"{tdir}/run_config.json")
    assert list(tcfg) == list(jcfg)
    assert list(tcfg["run"]) == list(jcfg["run"])
    assert tcfg["indices"] == jcfg["indices"] == {"train": [0, 1, 2, 3],
                                                  "val": [4]}
    assert tcfg["selected_scene"] == jcfg["selected_scene"] == SCENE
    assert tcfg["levels"] == jcfg["levels"] == [16.0, 24.0]
    assert set(tcfg["pipeline"]) == set(jcfg["pipeline"]) - {"use_splat_kernel"}
    for k in ("skip_levels", "stop_grad_levels", "steps_per_epoch",
              "kernel_compute", "remat_vgg", "texture_width"):
        assert tcfg["pipeline"][k] == jcfg["pipeline"][k], k
    # the level decisions: no static skip, two batch signatures
    jwall, twall = _json(f"{jdir}/wallclock.json"), _json(f"{tdir}/wallclock.json")
    assert set(twall) == set(jwall) - {"splat_planning"}
    assert twall["level_signatures"] == jwall["level_signatures"] == {
        "specialized": 2, "signatures": [{"skip": [1], "stop_grad": []},
                                         {"skip": [], "stop_grad": [0]}]}
    assert twall["train_steps"]["steps"] == jwall["train_steps"]["steps"] == 8

    # every logged loss, train and validation
    jm, tm = _metrics(jdir), _metrics(tdir)
    assert [(r["tag"], r["step"]) for r in tm] == [(r["tag"], r["step"]) for r in jm]
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(t["value"], j["value"], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{j['tag']} {j['step']}")
    assert any(r["tag"] == "Batch/Loss/val/total" for r in tm)

    # exports: the same files, the final texture within the bound
    for name in ("texture.npz", "epoch_1_texture.jpg", "epoch_1_layer0_texture.jpg"):
        assert (tmp_path / "port" / "version_0" / name).exists(), name
    jtex, ttex = np.load(f"{jdir}/texture.npz"), np.load(f"{tdir}/texture.npz")
    assert sorted(ttex.files) == sorted(jtex.files) == ["layer_0", "layer_1"]
    for k, s in zip(jtex.files, start):
        moved = np.linalg.norm(jtex[k] - s)
        assert moved > 0
        assert np.linalg.norm(ttex[k] - jtex[k]) / moved < 2e-2


def _port_value(name, value):
    """A port PipelineConfig field as the JAX package spells it."""
    if name == "compute_dtype":
        return None if value is None else jnp.dtype(str(value).split(".")[-1])
    return value


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_configs_from_args_match_jax(preset, bf16):
    """Every field of both configs, for every preset. The port's
    ``precision`` is 'default' under --bfloat16 (its trunk then runs the
    conv kernels), 'highest' otherwise; the JAX CLI keeps HIGHEST."""
    argv = ["--preset", preset, "--root_path", "/data", "--batch_size", "4",
            "--loss_weight", "content=3", "--no_post_steps"]
    argv += ["--bfloat16"] if bf16 else []
    jargs = jcli.build_parser().parse_args(argv)
    jargs = jcli.apply_preset(jargs, preset, explicit=jcli.explicit_cli_keys(
        jcli.build_parser, argv))
    targs = tcli.build_parser().parse_args(argv)
    targs = tcli.apply_preset(targs, preset, explicit=tcli.explicit_cli_keys(
        tcli.build_parser, argv))
    jrun, jpipe = jcli.configs_from_args(jargs)
    trun, tpipe = tcli.configs_from_args(targs)
    assert dataclasses.asdict(trun) == dataclasses.asdict(jrun)
    jfields = dataclasses.asdict(jpipe)
    for f in dataclasses.fields(tpipe):
        value = getattr(tpipe, f.name)
        if f.name == "precision":
            assert value == ("default" if bf16 else "highest")
            continue
        assert _port_value(f.name, value) == jfields[f.name], f.name
    assert set(jfields) - {f.name for f in dataclasses.fields(tpipe)} == {
        "use_splat_kernel"}
    assert tpipe.remat_vgg == jpipe.remat_vgg == (not bf16)
    assert tpipe.kernel_compute == "bf16"


def _cli(tmp_path, *extra):
    style = _make_scene(tmp_path)
    return tcli.main([
        "--preset", "scannet_full", "--root_path", str(tmp_path),
        "--scene", SCENE, "--style_image_path", style, "--texture_size", "64,64",
        "--resize_size", "16", "--min_pyramid_height", "16",
        "--batch_size", "2", "--max_epochs", "1", "--index_repeat", "1",
        "--platform", "cpu", "--log_dir", str(tmp_path / "runs"), *extra])


def _post_outputs(log_dir, tag="", views=5):
    """Check the post chain's files for one texture; its eval's JSON."""
    styled = sorted(os.listdir(f"{log_dir}/styled{tag}"))
    assert styled == sorted(f"{i}.png" for i in range(views))
    assert Image.open(f"{log_dir}/styled{tag}/0.png").size == (32, 24)
    cap = cv2.VideoCapture(f"{log_dir}/styled{tag}.mp4")
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == views
    cap.release()
    (out,) = [f for f in os.listdir(log_dir) if f.endswith(f"_output{tag}.json")]
    results = _json(f"{log_dir}/{out}")
    assert sorted(results["accuracies"]) == sorted(
        f"reprojection{p}{l}" for p in ("", "_short", "_long")
        for l in ("", "_lpips"))
    assert all(np.isfinite(v) for v in results["accuracies"].values())
    assert results["lpips_calibrated"] is False
    assert results["number_files"] == views
    return results


def test_cli_runs_the_post_chain_on_cpu(tmp_path, capsys):
    """The JAX CLI's default run (no ``--no_post_steps``): after training,
    the styled frame of every view, ``styled.mp4`` with one frame per
    view, ``<stamp>_output.json`` with the six accuracies, the ``post_*``
    phases merged into ``wallclock.json``, and the JAX CLI's printed
    lines."""
    _, log_dir = _cli(tmp_path)
    _post_outputs(log_dir)
    wall = _json(f"{log_dir}/wallclock.json")
    assert {"train_steps", "post_render", "post_video", "post_eval"} <= set(wall)
    out = capsys.readouterr().out
    assert "reprojection eval: {" in out and "post-chain wall-clock:" in out
    launches = json.loads(out.split("post-chain launches: ")[1].splitlines()[0])
    assert launches == {"post_render": {}, "post_eval": {}}  # plain on the CPU
    assert not any(f.startswith("events.out") for f in os.listdir(log_dir))


def test_cli_tb_logs_write_events(tmp_path):
    """The same run with ``--tb_logs``: one event file beside
    ``metrics.jsonl`` holding every logged scalar."""
    from tests.test_torch_tb_events import _load

    _, log_dir = _cli(tmp_path, "--tb_logs")
    (events,) = [f for f in os.listdir(log_dir) if f.startswith("events.out")]
    _post_outputs(log_dir)
    tags = set(_load(f"{log_dir}/{events}").Tags()["scalars"])
    assert tags == {r["tag"] for r in _metrics(log_dir)}
    assert "Batch/Loss/train/total" in tags


def test_cli_post_chain_per_style(tmp_path):
    """A 2-style sweep runs one post chain per style, its files tagged
    ``_style<s>``."""
    other = tmp_path / "style2.jpg"
    Image.fromarray(np.random.default_rng(3).integers(
        0, 255, (36, 44, 3), dtype=np.uint8)).save(other)
    _, log_dir = _cli(tmp_path, "--style_image_path", str(other))
    for s in (0, 1):
        _post_outputs(log_dir, f"_style{s}")
    assert not os.path.exists(f"{log_dir}/styled")


@pytest.mark.parametrize("argv,match", [
    (["--shard_atlas", "--data_parallel"], "exclusive"),
    (["--shard_atlas", "--style_image_path", "a.jpg",
      "--style_image_path", "b.jpg"], "style axis"),
    (["--data_parallel", "--style_dir", "."], "style axis"),
])
def test_mode_combinations_raise_before_training(tmp_path, monkeypatch, argv,
                                                 match):
    """The JAX package's exclusive multi-device combinations raise before
    any scene is read."""
    for name in ("s.jpg", "t.jpg"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(toptimize, "discover_scene", lambda run: pytest.fail(
        "training started"))
    with pytest.raises(ValueError, match=match):
        tcli.main(argv + ["--no_post_steps", "--root_path", str(tmp_path),
                          "--platform", "cpu", "--log_dir",
                          str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()


def test_cli_runs_on_cpu(tmp_path):
    """The CLI end to end with --platform cpu: a preset, a scene from disk,
    the exports and the logs."""
    style = _make_scene(tmp_path)
    state, log_dir = tcli.main([
        "--preset", "scannet_full", "--root_path", str(tmp_path),
        "--scene", SCENE, "--style_image_path", style, "--texture_size", "64,64",
        "--resize_size", "16", "--min_pyramid_height", "16",
        "--batch_size", "2", "--max_epochs", "1", "--index_repeat", "1",
        "--kernel_compute", "bf16", "--no_post_steps", "--platform", "cpu",
        "--log_dir", str(tmp_path / "runs")])
    assert state.step == 2
    assert state.texture.layers[0].device.type == "cpu"
    losses = [r for r in _metrics(log_dir) if r["tag"] == "Batch/Loss/train/total"]
    assert len(losses) == 2 and all(np.isfinite(r["value"]) for r in losses)
    assert np.load(f"{log_dir}/texture.npz")["layer_3"].shape == (8, 8, 3)
    wall = _json(f"{log_dir}/wallclock.json")
    assert {"scene_cache", "pipeline_build", "compile_first_step",
            "train_steps"} <= set(wall)


def test_checkpoint_and_exports(tmp_path):
    """``save_train_state`` / ``restore_train_state`` round-trip the port's
    state; the texture exports have the JAX package's names and formats
    (its ``load_texture_npz`` reads the port's file)."""
    from stylemesh_tpu.utils.checkpoint import load_texture_npz as jload
    from stylemesh_tpu_torch.utils import checkpoint as tck

    rng = np.random.default_rng(2)
    arrays = [rng.normal(0, 20, (16 >> i, 16 >> i, 3)).astype(np.float32)
              for i in range(2)]
    mu = [rng.normal(size=a.shape).astype(np.float32) for a in arrays]
    nu = [rng.random(a.shape, dtype=np.float32) for a in arrays]
    state = train_state_from_numpy(arrays, mu, nu, 7, "cpu")
    tck.save_train_state(state, str(tmp_path / "ckpt"))
    zeros = [np.zeros_like(a) for a in arrays]
    restored = tck.restore_train_state(
        train_state_from_numpy(zeros, zeros, zeros, 0, "cpu"),
        str(tmp_path / "ckpt"))
    assert restored.step == 7
    for got, want in zip((restored.texture.layers, restored.mu, restored.nu),
                         (arrays, mu, nu)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.detach().numpy(), w)
    with pytest.raises(ValueError, match="shapes"):
        tck.restore_train_state(train_state_from_numpy(
            zeros[:1], zeros[:1], zeros[:1], 0, "cpu"), str(tmp_path / "ckpt"))

    tck.save_texture_npz(state.texture, str(tmp_path / "texture.npz"))
    for a, b in zip(jload(str(tmp_path / "texture.npz")).layers, arrays):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = tck.load_texture_npz(str(tmp_path / "texture.npz"), device="cpu")
    np.testing.assert_array_equal(back.layers[1].detach().numpy(), arrays[1])
    paths = tck.save_texture_layers(state.texture, str(tmp_path), "epoch_0")
    paths.append(tck.save_texture_image(state.texture, str(tmp_path), "epoch_0_"))
    assert [p.split("/")[-1] for p in paths] == [
        "epoch_0_layer0_texture.jpg", "epoch_0_layer1_texture.jpg",
        "epoch_0_texture.jpg"]
    assert Image.open(paths[-1]).size == (16, 16)

"""Port parity: the evaluations (``eval/lpips.py``, ``eval/reprojection.py``,
the folder CLI ``eval/__main__.py`` and ``eval/circles.py``) against the
JAX package, on the same seeded inputs read from the same files.

Tolerances: LPIPS 1e-4 relative (float32 VGG at ``HIGHEST`` in both,
summed in another order); the reprojection eval's pairs equal, its MSEs
1e-5 relative (float64 sums of the same float32 residuals; a warp
coordinate may differ by one float32 ulp, ROADMAP §3) and its LPIPS sums
1e-4 relative; the circle statistics 1e-5 relative (the 2-D detection is
the same OpenCV code; the 3-D lengths come from ``unproject``).
"""

import json
import os
import random
from datetime import datetime

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from stylemesh_tpu.data.loading import SceneCache as JSceneCache
from stylemesh_tpu.eval import circles as jcircles
from stylemesh_tpu.eval import reprojection as jrep
from stylemesh_tpu.eval.__main__ import main as jeval_main
from stylemesh_tpu.eval.lpips import LPIPSDistance as JLPIPS
from stylemesh_tpu.models.vgg import init_vgg_params as jinit_vgg
from stylemesh_tpu.optimize import RunConfig as JRunConfig
from stylemesh_tpu.optimize import discover_scene as jdiscover
from stylemesh_tpu_torch.data.loading import SceneCache as TSceneCache
from stylemesh_tpu_torch.eval import circles as tcircles
from stylemesh_tpu_torch.eval import reprojection as trep
from stylemesh_tpu_torch.eval.__main__ import main as teval_main
from stylemesh_tpu_torch.eval.lpips import LPIPS_LAYERS
from stylemesh_tpu_torch.eval.lpips import LPIPSDistance as TLPIPS
from stylemesh_tpu_torch.models.vgg import VGG_LAYER_CHANNELS
from stylemesh_tpu_torch.models.vgg import init_vgg_params as tinit_vgg
from stylemesh_tpu_torch.optimize import RunConfig as TRunConfig
from stylemesh_tpu_torch.optimize import discover_scene as tdiscover

SCENE = "scene0011_00"


def write_scene(root, n=6, hw=(24, 32), uv_heights=(16, 24), seed=0):
    """A ScanNet-layout scene under ``root/train/images``: a wall with a
    nearer box (uint16 depth in mm, holes of zero depth), a camera that
    pans and turns, random photos and UV maps (zeros: no surface)."""
    h, w = hw
    sp = root / "train" / "images" / SCENE
    for sub in ["color", "depth", "pose", "uv"] + [f"uv_{u}" for u in uv_heights]:
        (sp / sub).mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        a = 0.05 * i - 0.1
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        pose[:3, 3] = [0.12 * i, 0.01 * i, -0.05 * i]
        np.savetxt(sp / "pose" / f"{i}.txt", pose)
        depth = 3000 + rng.integers(-40, 40, (h, w))
        depth[h // 4:h // 2 + 2, w // 3:w // 2 + 3] = 1400
        depth[-4:-2, 2:6] = 0
        Image.fromarray(depth.astype(np.uint16)).save(sp / "depth" / f"{i}.png")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            sp / "color" / f"{i}.jpg")
        np.save(sp / "uv" / f"{i}.angle.npy",
                rng.random((h, w, 3), dtype=np.float32))
        for u in uv_heights:
            uv = rng.uniform(0.05, 0.95, (u, u * w // h, 3)).astype(np.float32)
            uv[:2, :3] = 0.0
            np.save(sp / f"uv_{u}" / f"{i}.npy", uv)
    with open(sp / f"{SCENE}.txt", "w") as f:
        f.write(f"fx_color = {0.9 * w}\nfy_color = {0.9 * w}\n"
                f"mx_color = {w / 2}\nmy_color = {h / 2}\n"
                f"colorWidth = {w}\ncolorHeight = {h}\n")
    return sp


def caches(root, resize_size=24, min_pyramid_height=16):
    """Both packages' scene caches of the scene under ``root``."""
    kw = dict(root_path=str(root), scene=SCENE, resize_size=resize_size,
              min_pyramid_height=min_pyramid_height, pyramid_levels=4)
    return (JSceneCache(jdiscover(JRunConfig(**kw)), resize_size=resize_size),
            TSceneCache(tdiscover(TRunConfig(**kw)), resize_size=resize_size))


class _Clock(datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


def pin_clock(monkeypatch):
    for mod in (jrep, trep):
        monkeypatch.setattr(mod, "datetime", _Clock)


def _lin_weights(path, seed=7):
    rng = np.random.default_rng(seed)
    np.savez(path, **{k: rng.random(VGG_LAYER_CHANNELS[k]).astype(np.float32)
                      for k in LPIPS_LAYERS})


@pytest.mark.parametrize("calibrated", [False, True])
def test_lpips_matches_jax(tmp_path, calibrated):
    rng = np.random.default_rng(11)
    a = rng.random((2, 32, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    jlin = tlin = None
    if calibrated:
        _lin_weights(tmp_path / "lin.npz")
        jlin = JLPIPS.load_lin_weights(tmp_path / "lin.npz")
        tlin = TLPIPS.load_lin_weights(tmp_path / "lin.npz", "cpu")
    jd = JLPIPS(jinit_vgg(rng=3, he=True), lin_weights=jlin)
    td = TLPIPS(tinit_vgg(rng=3, he=True, device="cpu"), lin_weights=tlin)
    assert td.calibrated == jd.calibrated == calibrated
    got = td(a, b)
    want = np.asarray(jd(a, b))
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert float(td(a, a).abs().max()) < 1e-6


def _styled_folder(path, cache, hw, seed=1):
    path.mkdir()
    rng = np.random.default_rng(seed)
    for idx in cache.indices:
        Image.fromarray(rng.integers(0, 255, hw + (3,), dtype=np.uint8)).save(
            path / f"{idx}.png")


def _same_results(got, want):
    for k in ("number_files", "date_time", "pairs", "short_pairs",
              "long_pairs", "lpips_calibrated"):
        assert got[k] == want[k], k
    assert sorted(got["accuracies"]) == sorted(want["accuracies"])
    for k, v in want["accuracies"].items():
        assert np.isfinite(got["accuracies"][k]) and v > 0, k
        rtol = 1e-4 if k.endswith("_lpips") else 1e-5
        np.testing.assert_allclose(got["accuracies"][k], v, rtol=rtol,
                                   err_msg=k)


def test_reprojection_eval_matches_jax(tmp_path, monkeypatch):
    """One styled folder read by both packages' evals; the same output
    files (the diagnostic image set and ``<stamp>_output<suffix>.json``)."""
    write_scene(tmp_path)
    jcache, tcache = caches(tmp_path)
    styled = tmp_path / "styled"
    _styled_folder(styled, tcache, (24, 32))
    pin_clock(monkeypatch)
    params = dict(seed=5, pair_threshold=3, pair_threshold_long=2,
                  suffix="_style1")
    want = jrep.eval_reprojection_consistency(
        jcache, str(styled), out_dir=str(tmp_path / "jax"),
        lpips_fn=JLPIPS(jinit_vgg(rng=2, he=True)), **params)
    got = trep.eval_reprojection_consistency(
        tcache, str(styled), out_dir=str(tmp_path / "port"),
        lpips_fn=TLPIPS(tinit_vgg(rng=2, he=True, device="cpu")),
        device="cpu", **params)
    _same_results(got, want)
    assert got["pairs"] == trep.sample_pairs(6, 3, random.Random(5))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == [
            "02.01.2026-03:04:05_output_style1.json",
            "eval_image_data_02.01.2026-03:04:05_style1"]
    dump = "eval_image_data_02.01.2026-03:04:05_style1"
    names = sorted(os.listdir(tmp_path / "port" / dump))
    assert names == sorted(os.listdir(tmp_path / "jax" / dump))
    assert len(names) == 9 * 6
    with open(tmp_path / "port" / "02.01.2026-03:04:05_output_style1.json") as f:
        assert json.load(f) == got
    for name in ("rgb_0.jpg", "styled_3.jpg"):  # same pixels, same encoder
        assert np.array_equal(
            np.asarray(Image.open(tmp_path / "port" / dump / name)),
            np.asarray(Image.open(tmp_path / "jax" / dump / name)))


def _eval_folders(root, n=4, h=24, w=32):
    """Loose rgb / styled / pose / depth folders and a ScanNet intrinsics
    file, as tests/test_eval_post.py writes them."""
    for sub in ("rgb", "styled", "pose", "depth"):
        (root / sub).mkdir()
    rng = np.random.default_rng(5)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(root / "rgb" / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(root / "styled" / f"{i}.png")
        depth = rng.integers(800, 3000, (h, w), dtype=np.uint16)
        Image.fromarray(depth.astype(np.int32), mode="I").save(
            root / "depth" / f"{i}.png")
        pose = np.eye(4)
        pose[0, 3] = 0.02 * i
        np.savetxt(root / "pose" / f"{i}.txt", pose)
    with open(root / "intr.txt", "w") as f:
        f.write(f"fx_color = 30.0\nfy_color = 30.0\nmx_color = {w/2}\n"
                f"my_color = {h/2}\ncolorWidth = {w}\ncolorHeight = {h}\n")
    return ["--rgb", str(root / "rgb"), "--styled", str(root / "styled"),
            "--pose", str(root / "pose"), "--depth", str(root / "depth"),
            "--intrinsics", str(root / "intr.txt"), "--image_size", "16",
            "--pair_threshold", "2"]


def test_eval_cli_matches_jax(tmp_path, monkeypatch):
    """``python -m stylemesh_tpu_torch.eval`` against ``python -m
    stylemesh_tpu.eval`` on the same folders, with a lin-weights file."""
    argv = _eval_folders(tmp_path)
    _lin_weights(tmp_path / "lin.npz")
    argv += ["--lpips_weights", str(tmp_path / "lin.npz")]
    pin_clock(monkeypatch)
    want = jeval_main(argv + ["--out_dir", str(tmp_path / "jax")])
    got = teval_main(argv + ["--out_dir", str(tmp_path / "port"),
                             "--platform", "cpu"])
    assert got["lpips_calibrated"] is True
    _same_results(got, want)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    rgb0 = np.asarray(Image.open(
        tmp_path / "port" / "eval_image_data_02.01.2026-03:04:05" / "rgb_0.jpg"),
        np.float32)
    assert rgb0.std() > 10.0  # the scene's photos, not a placeholder


def test_eval_cli_needs_the_card_unless_told(tmp_path, monkeypatch):
    argv = _eval_folders(tmp_path) + ["--out_dir", str(tmp_path / "out")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval_main(argv)
    assert not (tmp_path / "out").exists()
    os.remove(tmp_path / "styled" / "0.png")
    with pytest.raises(ValueError, match="styled frame count"):
        teval_main(argv + ["--platform", "cpu", "--no_lpips"])


def _circles(img, circles):
    for cx, cy, r in circles:
        cv2.circle(img, (cx, cy), r, (0, 0, 230), -1)  # BGR red
    return img


def test_measure_frame_matches_jax():
    img = _circles(np.zeros((120, 160, 3), np.uint8),
                   ((40, 40, 8), (100, 80, 16), (130, 30, 12)))
    h, w = img.shape[:2]
    rng = np.random.default_rng(2)
    depth = rng.uniform(1.5, 3.0, (h, w, 1)).astype(np.float32)
    angle = rng.uniform(0, 60, (h, w, 1)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([xs * 0.01, ys * 0.012, depth[..., 0], np.ones_like(
        depth[..., 0])], -1).astype(np.float32)
    for debug in (False, True):
        got = tcircles.measure_frame(img, depth, angle, coords, debug=debug)
        want = jcircles.measure_frame(img, depth, angle, coords, debug=debug)
        assert got[1] == want[1] == 3
        assert got[0].keys() == want[0].keys()
        for k in want[0]:
            np.testing.assert_array_equal(np.float64(got[0][k]),
                                          np.float64(want[0][k]), err_msg=k)
        if debug:
            assert np.array_equal(got[2]["image"], want[2]["image"])
            assert got[2]["scatter"] == want[2]["scatter"]


def _circle_frames(path, cache, hw):
    path.mkdir()
    rng = np.random.default_rng(9)
    for idx in cache.indices:
        spots = [(int(rng.integers(12, hw[1] - 12)),
                  int(rng.integers(12, hw[0] - 12)), int(rng.integers(4, 9)))
                 for _ in range(3)]
        cv2.imwrite(str(path / f"{idx}.png"),
                    _circles(np.zeros(hw + (3,), np.uint8), spots))


def test_measure_circles_for_scene_matches_jax(tmp_path):
    """The scene aggregate (3-D lengths from ``unproject``) and its debug
    artifacts, and the circles CLI of both packages on the same scene."""
    write_scene(tmp_path, n=4, hw=(72, 96))
    jcache, tcache = caches(tmp_path, resize_size=72)
    styled = tmp_path / "styled"
    _circle_frames(styled, tcache, (72, 96))
    want = jcircles.measure_circles_for_scene(
        jcache, str(styled), debug_dir=str(tmp_path / "jdbg"))
    got = tcircles.measure_circles_for_scene(
        tcache, str(styled), debug_dir=str(tmp_path / "tdbg"), device="cpu")
    assert got["n_circles"] == want["n_circles"] > 4
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    assert sorted(os.listdir(tmp_path / "tdbg")) == sorted(
        os.listdir(tmp_path / "jdbg"))

    argv = ["--root_path", str(tmp_path), "--scene", SCENE, "--styled",
            str(styled), "--resize_size", "72", "--min_pyramid_height", "16"]
    jcircles.main(argv + ["--out", str(tmp_path / "j.json")])
    tcircles.main(argv + ["--out", str(tmp_path / "t.json"), "--platform",
                          "cpu"])
    with open(tmp_path / "j.json") as f, open(tmp_path / "t.json") as g:
        jres, tres = json.load(f), json.load(g)
    assert tres.keys() == jres.keys()
    for k, v in jres.items():
        np.testing.assert_allclose(tres[k], v, rtol=1e-5, err_msg=k)

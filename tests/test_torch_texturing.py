"""Port parity: the post-train render (``optimize.py::render_styled_frames``)
and the texturing tools (``texturing/{video,mask_texture,mask_image}.py``
and their CLIs) against the JAX package, on the same seeded inputs.

Tolerances: rendered PNGs within 1/255 (float32 sampling, one ulp of a
coordinate apart at most, then the same rounding to 8 bits); texture masks
and RGBA masked images equal; videos the same frame count and order.
"""

import importlib
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stylemesh_tpu import optimize as joptimize
from stylemesh_tpu.models.texture import Texture as JTexture
from stylemesh_tpu.texturing import video as jvideo
from stylemesh_tpu_torch import optimize as toptimize
from stylemesh_tpu_torch.convert import texture_from_jax
from stylemesh_tpu_torch.texturing import video as tvideo
from tests.test_torch_eval import SCENE, caches, write_scene

# the packages export functions of these modules' names
jmask_image = importlib.import_module("stylemesh_tpu.texturing.mask_image")
jmask_texture = importlib.import_module("stylemesh_tpu.texturing.mask_texture")
tmask_image = importlib.import_module("stylemesh_tpu_torch.texturing.mask_image")
tmask_texture = importlib.import_module(
    "stylemesh_tpu_torch.texturing.mask_texture")


def _layers(seed=0, size=64, n=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 40, (size >> i, size >> i, 3)).astype(np.float32)
            for i in range(n)]


def test_render_styled_frames_matches_jax(tmp_path, monkeypatch):
    """Ten views: two chunks, one ``sample_texture`` call each (one K1
    launch each on the card), at the finest UV level, masked."""
    write_scene(tmp_path, n=10)
    jcache, tcache = caches(tmp_path)
    layers = _layers()
    calls = []
    real = toptimize.sample_texture
    monkeypatch.setattr(toptimize, "sample_texture", lambda tex, grids: (
        calls.append([tuple(g.shape) for g in grids]) or real(tex, grids)))
    jpaths = joptimize.render_styled_frames(
        JTexture.from_arrays([jnp.asarray(l) for l in layers]), jcache,
        str(tmp_path / "jax"))
    tpaths = toptimize.render_styled_frames(
        texture_from_jax(layers, device="cpu"), tcache, str(tmp_path / "port"))
    assert calls == [[(8, 24, 32, 2)], [(2, 24, 32, 2)]]
    assert [os.path.basename(p) for p in tpaths] == [
        os.path.basename(p) for p in jpaths] == [f"{i}.png" for i in range(10)]
    masked = 0
    for t, j in zip(tpaths, jpaths):
        got = np.asarray(Image.open(t), np.int16)
        want = np.asarray(Image.open(j), np.int16)
        assert got.shape == want.shape == (24, 32, 3)
        assert np.abs(got - want).max() <= 1
        masked += int((want == 0).all(-1).sum())
    assert masked >= 10 * 6  # the UV maps' empty corner stays black


def test_render_styled_frames_level_matches_jax(tmp_path):
    """``level=0`` renders at the coarsest UV level, as the JAX package's
    ``level`` argument does."""
    write_scene(tmp_path, n=3)
    jcache, tcache = caches(tmp_path)
    layers = _layers(seed=1)
    jpaths = joptimize.render_styled_frames(
        JTexture.from_arrays([jnp.asarray(l) for l in layers]), jcache,
        str(tmp_path / "jax"), level=0)
    tpaths = toptimize.render_styled_frames(
        texture_from_jax(layers, device="cpu"), tcache, str(tmp_path / "port"),
        level=0)
    assert len(tpaths) == len(jpaths) == 3
    for t, j in zip(tpaths, jpaths):
        got = np.asarray(Image.open(t), np.int16)
        want = np.asarray(Image.open(j), np.int16)
        assert got.shape == want.shape == (16, 21, 3)
        assert np.abs(got - want).max() <= 1


def _frames(path, names, hw=(32, 48)):
    """Solid frames, frame ``i`` of gray level ``20 * (i + 1)``."""
    path.mkdir()
    paths = []
    for name in names:
        level = 20 * (int(name.split(".")[0].split("_")[-1]) + 1)
        p = path / name
        cv2.imwrite(str(p), np.full(hw + (3,), level, np.uint8))
        paths.append(str(p))
    return paths


def _decoded_levels(video):
    cap = cv2.VideoCapture(video)
    levels = []
    ok, frame = cap.read()
    while ok:
        levels.append(int(round(float(frame.mean()) / 20.0)) - 1)
        ok, frame = cap.read()
    cap.release()
    return levels


def test_video_from_files_matches_jax(tmp_path):
    """Integer frame names sort numerically, Matterport pano names by
    camera and yaw; the video holds every frame in that order, as the JAX
    package's does, and frames of another size are resized."""
    names = ["10.png", "2.png", "0.png", "1.png"]
    paths = _frames(tmp_path / "f", names)
    cv2.imwrite(str(tmp_path / "f" / "3.png"), np.full((20, 30, 3), 80,
                                                       np.uint8))
    paths.append(str(tmp_path / "f" / "3.png"))
    for mod, name in ((tvideo, "port.mp4"), (jvideo, "jax.mp4")):
        mod.video_from_files(paths, str(tmp_path / name), fps=5)
    assert _decoded_levels(str(tmp_path / "port.mp4")) == _decoded_levels(
        str(tmp_path / "jax.mp4")) == [0, 1, 2, 3, 10]
    pano = ["ab_i1_2.jpg", "ab_i0_5.jpg", "ab_i1_0.jpg", "zz.jpg", "7.jpg"]
    assert sorted(pano, key=tvideo._sort_key) == sorted(
        pano, key=jvideo._sort_key) == ["7.jpg", "ab_i0_5.jpg", "ab_i1_0.jpg",
                                        "ab_i1_2.jpg", "zz.jpg"]
    with pytest.raises(ValueError, match="no frames"):
        tvideo.video_from_files([], str(tmp_path / "none.mp4"))


def _uv_views(seed=3):
    rng = np.random.default_rng(seed)
    grids, masks = [], []
    for hw in ((12, 16), (20, 27), (12, 16), (9, 12)):
        grids.append(rng.uniform(-1.1, 0.6, hw + (2,)).astype(np.float32))
        masks.append((rng.random(hw + (1,)) > 0.3).astype(np.float32))
    return grids, masks


@pytest.mark.parametrize("min_fraction", [0.02, 0.5])
def test_texture_mask_matches_jax(min_fraction):
    grids, masks = _uv_views()
    want = jmask_texture.compute_texture_mask(grids, masks, (24, 40),
                                              min_fraction)
    got = tmask_texture.compute_texture_mask(grids, masks, (24, 40),
                                             min_fraction, device="cpu")
    assert got.dtype == bool and got.shape == (24, 40)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    tex = np.random.default_rng(4).random((24, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmask_texture.mask_texture(tex, got),
                                  jmask_texture.mask_texture(tex, want))


def test_mask_image_matches_jax():
    rng = np.random.default_rng(6)
    mask = rng.random((10, 14)) > 0.5
    for img in (rng.random((10, 14, 3)).astype(np.float32),
                rng.integers(0, 255, (10, 14, 3), dtype=np.uint8)):
        got = tmask_image.mask_image(img, mask)
        assert got.mode == "RGBA"
        assert np.array_equal(np.asarray(got),
                              np.asarray(jmask_image.mask_image(img, mask)))


def _same_image(a, b):
    assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


def test_texturing_clis_match_jax(tmp_path, monkeypatch):
    """The video, mask_image (one image, and a scene's frames) and
    mask_texture CLIs of both packages on the same inputs give the same
    files; mask_texture needs the card unless told ``--platform cpu``."""
    # UV levels from 32 px: the scene-mode CLIs keep RunConfig's
    # min_pyramid_height
    write_scene(tmp_path, n=4, hw=(24, 32), uv_heights=(32, 48))
    _, tcache = caches(tmp_path, min_pyramid_height=32)
    styled = tmp_path / "styled"
    styled.mkdir()
    rng = np.random.default_rng(8)
    for idx in tcache.indices:
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)).save(
            styled / f"{idx}.png")
    for mod, name in ((jvideo, "j.mp4"), (tvideo, "t.mp4")):
        mod.main(["--imgs_dir", str(styled), "--out", str(tmp_path / name)])
    assert len(_decoded_levels(str(tmp_path / "t.mp4"))) == 4

    uv = np.zeros((24, 32, 4), np.float32)
    uv[4:20, 4:28, :2] = 0.5
    np.save(tmp_path / "uv0.npy", uv)
    argv = ["--image", str(styled / "0.png"), "--uv", str(tmp_path / "uv0.npy")]
    jmask_image.main(argv)
    os.rename(styled / "0_masked.png", tmp_path / "j_masked.png")
    tmask_image.main(argv)
    _same_image(styled / "0_masked.png", tmp_path / "j_masked.png")
    os.remove(styled / "0_masked.png")

    scene = ["--root_path", str(tmp_path), "--scene", SCENE,
             "--resize_size", "24"]
    for mod, out in ((jmask_image, "jm"), (tmask_image, "tm")):
        mod.main(scene + ["--styled", str(styled), "--out",
                          str(tmp_path / out)])
    assert sorted(os.listdir(tmp_path / "tm")) == sorted(
        os.listdir(tmp_path / "jm")) == [f"{i}_masked.png" for i in range(4)]
    for i in range(4):
        _same_image(tmp_path / "tm" / f"{i}_masked.png",
                    tmp_path / "jm" / f"{i}_masked.png")

    tex = tmp_path / "tex.png"
    Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(tex)
    jmask_texture.main(scene + ["--tex", str(tex), "--out",
                                str(tmp_path / "jt.png"), "--min_fraction",
                                "0.5"])
    tmask_texture.main(scene + ["--tex", str(tex), "--out",
                                str(tmp_path / "tt.png"), "--min_fraction",
                                "0.5", "--platform", "cpu"])
    _same_image(tmp_path / "tt.png", tmp_path / "jt.png")
    kept = (np.asarray(Image.open(tmp_path / "tt.png")) > 0).any(-1).mean()
    assert 0 < kept < 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmask_texture.main(scene + ["--tex", str(tex), "--out",
                                    str(tmp_path / "no.png")])
    assert not (tmp_path / "no.png").exists()

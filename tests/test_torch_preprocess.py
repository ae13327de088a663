"""Port parity of preprocessing and capture: ``preprocess.py`` (the bakes,
the frame renders, the CLI), ``data/demo_scene.py`` and ``capture.py``
against the JAX package, on the same meshes, poses and textures.

Tolerances:
- native backend (both packages run ``native/rasterizer.cpp``): every file
  written is equal byte for byte (``.npy``, PNG, JPEG, pose text);
- the port's torch backend (on the CPU here) against the JAX package's
  JAX backend: ``tests/test_native.py``'s rasterizer bounds per baked map —
  hit agreement above 0.99, and where both hit depth within rtol 1e-4, UV
  within 1e-4, angle and LOD within 1e-3;
- a mipmap render of a ``texture.npz``: within one 8-bit level (the texture
  is composed by each package's float32 sampler first).
"""

import io
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from stylemesh_tpu import capture as jcapture
from stylemesh_tpu import preprocess as jpre
from stylemesh_tpu.data import demo_scene as jdemo
from stylemesh_tpu.data.matterport_house import (MPHouse, MPImage, MPPanorama,
                                                 MPRegion)
from stylemesh_tpu.geometry import mesh_io as jmesh_io
from stylemesh_tpu.geometry.trajectories import orbit_poses, write_pose_dir
from stylemesh_tpu_torch import capture as tcapture
from stylemesh_tpu_torch import preprocess as tpre
from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.data import demo_scene as tdemo
from stylemesh_tpu_torch.data.loading import SceneCache
from stylemesh_tpu_torch.data.scenes import (discover_scannet_scenes,
                                             select_scene)
from stylemesh_tpu_torch.geometry import native as tnative
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.models.vgg import init_vgg_params
from stylemesh_tpu_torch.models.texture import Texture
from stylemesh_tpu_torch.utils.checkpoint import save_texture_npz
from tests.test_capture import _room_mesh
from tests.test_torch_meshes import assert_same, assert_same_tree, tree

SCENE = "scene0100_00"
HW = (24, 32)


def _scene(root, n=4, hw=HW):
    """A ScanNet-layout scene in the demo room: poses on an orbit (one of
    them untracked), the room mesh, intrinsics; returns (scene dir, mesh
    path, K)."""
    scene = root / "train" / "images" / SCENE
    (scene / "color").mkdir(parents=True)
    h, w = hw
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = k[1, 1] = 0.8 * w
    k[0, 2], k[1, 2] = w / 2.0, h / 2.0
    with open(scene / f"{SCENE}.txt", "w") as f:
        f.write(f"fx_color = {k[0, 0]}\nfy_color = {k[1, 1]}\n"
                f"mx_color = {k[0, 2]}\nmy_color = {k[1, 2]}\n"
                f"colorWidth = {w}\ncolorHeight = {h}\n")
    poses = orbit_poses((2.0, 2.0, 1.4), 1.2, 0.0, n=n)
    poses[1] = np.full((4, 4), -np.inf, np.float32)
    write_pose_dir(poses, str(scene / "pose"))
    mesh_path = root / "room_uvs_blender.ply"
    jmesh_io.save_ply(jdemo.room_mesh(), str(mesh_path))
    return scene, mesh_path, k


WALL_PLY = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
element face 2
property list uchar int vertex_indices
property list uchar float texcoord
end_header
-1 -1 3
1 -1 3.5
1 1 4
-1 1 3.5
3 0 1 2 6 0 0 1 0 1 1
3 0 2 3 6 0 0 1 1 0 1
"""


def _wall_scene(root, n=3):
    """A slanted wall quad before translated cameras: no face crosses the
    camera plane, so the JAX rasterizer (which drops such faces) bakes the
    same surface as the port's and native."""
    scene, _, k = _scene(root, n=n)
    for i in range(n):
        pose = np.eye(4)
        pose[0, 3] = 0.1 * i
        np.savetxt(scene / "pose" / f"{i}.txt", pose)
    mesh_path = root / "wall_uvs_blender.ply"
    mesh_path.write_text(WALL_PLY)
    return scene, mesh_path, k


def _bake_args(scene, mesh_path, k):
    return (str(mesh_path), str(scene / "pose"), k, (HW[1], HW[0]), str(scene))


BAKE_KW = dict(base_hw=(2 * HW[0], 2 * HW[1]), pyramid_heights=(16, 24),
               verbose=False)


def test_bake_scene_native_matches_jax(tmp_path):
    """Every ``.npy`` the native bake writes is equal byte for byte; a
    second run with ``skip_existing`` and a ``frame_ids`` subset rewrites
    nothing."""
    trees = []
    for mod, side in ((jpre, "j"), (tpre, "t")):
        scene, mesh_path, k = _scene(tmp_path / side)
        assert mod.bake_scene(*_bake_args(scene, mesh_path, k), **BAKE_KW) == 3
        assert mod.bake_scene(*_bake_args(scene, mesh_path, k),
                              frame_ids=[0, 2], **BAKE_KW) == 2
        trees.append(scene)
    assert_same_tree(*trees)
    files = tree(trees[1])
    assert "uv_24/3.npy" in files and "uv_24/1.npy" not in files
    uv = np.load(trees[1] / "uv" / "0.npy")
    assert uv.shape == (48, 64, 3) and (uv[..., :2] > 0).mean() > 0.9


def _assert_bakes_close(got_dir, want_dir):
    """The baked maps of two scene trees within the rasterizer bounds."""
    names = sorted(tree(want_dir))
    assert sorted(tree(got_dir)) == names
    for name in names:
        if not name.endswith(".npy") or name.endswith(("angle.npy",
                                                       "depth.npy")):
            continue
        stem = name[:-len(".npy")]
        uv_g, uv_w = np.load(got_dir / name), np.load(want_dir / name)
        hit_g, hit_w = uv_g[..., :2].any(-1), uv_w[..., :2].any(-1)
        assert (hit_g == hit_w).mean() > 0.99, name
        both = hit_g & hit_w
        assert both.mean() > 0.2, name  # the surface fills a good part
        np.testing.assert_allclose(uv_g[both][:, :2], uv_w[both][:, :2],
                                   atol=1e-4)
        np.testing.assert_allclose(uv_g[both][:, 2], uv_w[both][:, 2],
                                   atol=1e-3)
        if name.startswith("uv/"):
            for suffix, tol in ((".angle.npy", dict(atol=1e-3)),
                                (".rendered_depth.npy", dict(rtol=1e-4))):
                np.testing.assert_allclose(
                    np.load(got_dir / (stem + suffix))[both],
                    np.load(want_dir / (stem + suffix))[both], **tol)


def test_bake_scene_torch_backend_matches_jax_backend(tmp_path):
    """``backend="torch"`` on the CPU against the JAX package's JAX
    rasterizer and against the native bake, map by map, on the wall scene
    (the demo room's near-clipped walls: ``tests/test_torch_native.py``)."""
    dirs = {}
    for mod, side, backend, kw in ((jpre, "j", "jax", {}),
                                   (tpre, "t", "torch", dict(device="cpu")),
                                   (tpre, "n", "native", {})):
        scene, mesh_path, k = _wall_scene(tmp_path / side)
        assert mod.bake_scene(*_bake_args(scene, mesh_path, k),
                              backend=backend, **kw, **BAKE_KW) == 3
        dirs[side] = scene
    _assert_bakes_close(dirs["t"], dirs["j"])
    _assert_bakes_close(dirs["t"], dirs["n"])


def test_unknown_backend_and_native_failure_raise(tmp_path, monkeypatch):
    """An unknown backend is a ``ValueError`` before anything is written; a
    native build failure raises out of ``main`` (no fallback to another
    rasterizer), as does the torch backend on a machine without a card."""
    scene, mesh_path, k = _scene(tmp_path)
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        tpre.bake_scene(*_bake_args(scene, mesh_path, k), backend="jax",
                        **BAKE_KW)
    assert not (scene / "uv").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpre.bake_scene(*_bake_args(scene, mesh_path, k), backend="torch",
                        **BAKE_KW)
    assert not (scene / "uv").exists()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the compiler"):
        tpre.main(["bake", "--mesh", str(mesh_path), "--scene_dir", str(scene),
                   "--base_hw", "8", "12", "--pyramid_heights", "8"])
    assert not any((scene / "uv").iterdir())


def test_preprocess_main_matches_jax(tmp_path, capsys):
    """The CLI's ``bake``, ``mipmap`` (an image and a ``texture.npz``) and
    ``vertex-color`` in both packages; the port's ``bake --backend torch
    --platform cpu`` writes what ``bake_scene(backend="torch",
    device="cpu")`` writes."""
    rng = np.random.default_rng(4)
    tex_img = tmp_path / "final_texture.png"
    Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)).save(
        tex_img)
    layers = [rng.normal(0.5, 0.3, (32 >> i, 32 >> i, 3)).astype(np.float32)
              for i in range(2)]
    npz = tmp_path / "texture.npz"
    save_texture_npz(Texture.from_arrays(layers, device="cpu"), str(npz))
    colors = tmp_path / "colors.npy"
    np.save(colors, rng.random((24, 3)).astype(np.float32))
    outs = {}
    for mod, side, extra in ((jpre, "j", []), (tpre, "t", ["--platform", "cpu"])):
        scene, mesh_path, _ = _scene(tmp_path / side)
        common = ["--mesh", str(mesh_path), "--scene_dir", str(scene)]
        mod.main(["bake"] + common + ["--base_hw", "16", "24",
                                      "--pyramid_heights", "8", "12"])
        for name, tex in (("mip_img", tex_img), ("mip_npz", npz)):
            mod.main(["mipmap"] + common + [
                "--texture", str(tex), "--out", str(tmp_path / side / name),
                "--hw", "12", "16"] + (extra if name == "mip_npz" else []))
        mod.main(["vertex-color"] + common + [
            "--colors", str(colors), "--out", str(tmp_path / side / "vc"),
            "--hw", "12", "16"])
        outs[side] = capsys.readouterr().out.replace(str(tmp_path / side), "")
    assert outs["j"] == outs["t"]
    for sub in (f"train/images/{SCENE}", "mip_img", "vc"):
        assert_same_tree(tmp_path / "j" / sub, tmp_path / "t" / sub)
    got, want = tree(tmp_path / "t" / "mip_npz"), tree(tmp_path / "j" / "mip_npz")
    assert sorted(got) == sorted(want) == ["0.png", "2.png", "3.png"]
    for name in got:
        a = np.asarray(Image.open(io.BytesIO(got[name])), np.int16)
        b = np.asarray(Image.open(io.BytesIO(want[name])), np.int16)
        assert np.abs(a - b).max() <= 1 and a.std() > 0

    for side in ("cli", "call"):
        scene, mesh_path, k = _scene(tmp_path / side)
        if side == "cli":
            tpre.main(["bake", "--mesh", str(mesh_path), "--scene_dir",
                       str(scene), "--base_hw", "16", "24",
                       "--pyramid_heights", "8", "12", "--backend", "torch",
                       "--platform", "cpu"])
        else:
            tpre.bake_scene(str(mesh_path), str(scene / "pose"), k, HW[::-1],
                            str(scene), base_hw=(16, 24), pyramid_heights=(8, 12),
                            backend="torch", device="cpu")
    assert_same_tree(tmp_path / "cli", tmp_path / "call")


def _house(root, h=24, w=32):
    k = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]], np.float64)
    rng = np.random.default_rng(3)
    images, panos = [], []
    color_src = root / "matterport_color_images"
    color_src.mkdir()
    for p in range(2):
        pano = MPPanorama(name=f"cam{p:02d}", region_index=0, images=[])
        for yaw in range(2 if p == 0 else 1):
            pose = np.asarray(orbit_poses((2.0, 2.0, 1.4), 1.0, 0.0, n=3)[
                p + yaw], np.float64)
            img = MPImage(name=f"cam{p:02d}", camera_index=0, yaw_index=yaw,
                          extrinsics=pose, intrinsics=k, width=w, height=h,
                          position=pose[:3, 3], panorama_index=p)
            pano.images.append(img)
            images.append(img)
            Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                            ).save(color_src / img.color_filename)
        panos.append(pano)
    region = MPRegion(label="office", level_index=0, panoramas=panos)
    return MPHouse(name="17TEST", label=None, regions=[region],
                   panoramas=panos, images=images), color_src


def test_bake_matterport_region_matches_jax(tmp_path):
    """The region trees (poses, intrinsics, copied colour, angle, depth, UV
    pyramid) are equal byte for byte, and an idempotent re-run agrees."""
    house, color_src = _house(tmp_path)
    mesh_path = tmp_path / "region0_uvs_blender.ply"
    jmesh_io.save_ply(jdemo.room_mesh(), str(mesh_path))
    for mod, side in ((jpre, "j"), (tpre, "t")):
        for _ in range(2):
            assert mod.bake_matterport_region(
                house, str(mesh_path), str(tmp_path / side / "17TEST"), 0,
                color_src=str(color_src), pyramid_heights=(16, 24),
                verbose=False) == 3
    assert_same_tree(tmp_path / "j", tmp_path / "t")
    assert len(tree(tmp_path / "t")) == 3 * 7


def test_build_demo_scene_matches_jax_and_trains(tmp_path):
    """The demo room at 3 views of 60x80 with UV heights (32, 48): the two
    packages write equal scene trees, JPEG frames included, with and
    without a frame hook; the port trains a step on its scene."""
    tex = jdemo.circle_texture(size=128, radius_px=6, spacing_px=24)

    def hook(i, img, depth):
        return jdemo.paint_screen_circles(img, radius_px=4, spacing_px=16)

    for frame_hook in (None, hook):
        roots = {}
        for mod, side in ((jdemo, "j"), (tdemo, "t")):
            root = tmp_path / f"{side}{frame_hook is None}"
            scene = mod.build_demo_scene(
                str(root), n_views=3, view_hw=(60, 80), pyramid_heights=(32, 48),
                texture=tex if frame_hook else None, shading=frame_hook is None,
                frame_hook=frame_hook, verbose=False)
            assert scene == str(root / "train" / "images" / "scene0900_00")
            roots[side] = root
        assert_same_tree(roots["j"], roots["t"])
    assert_same(tdemo.room_mesh(), jdemo.room_mesh())
    np.testing.assert_array_equal(tdemo.demo_texture(size=64, seed=3),
                                  jdemo.demo_texture(size=64, seed=3))
    np.testing.assert_array_equal(tdemo.circle_texture(size=64),
                                  jdemo.circle_texture(size=64))

    scenes = discover_scannet_scenes(str(roots["t"] / "train" / "images"),
                                     pyramid_levels=2, min_pyramid_height=32)
    cache = SceneCache(select_scene(scenes, min_images=1), resize_size=32)
    batch = batch_from_numpy(cache.get_batch(cache.indices[:2]), device="cpu")
    cfg = PipelineConfig(steps_per_epoch=1, texture_width=64, texture_height=64,
                         hierarchical_layers=2, use_angle_weight=True,
                         use_depth_scaling=True, content_weight=7e1,
                         style_weight=1e-4, style_min_size=16,
                         learning_rate=0.5)
    style = torch.from_numpy((np.random.default_rng(1).random(
        (1, 32, 40, 3), dtype=np.float32) - 0.45) * 255)
    pipe = TexturePipeline(cfg, init_vgg_params(rng=1, device="cpu"), style,
                           device="cpu")
    state = pipe.init()
    losses = pipe.train_step(state, batch)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert float(batch.mask.sum()) > 0


def test_capture_matches_jax(tmp_path, monkeypatch):
    """The scripted fly (same keys, same preview frames and captured
    poses), ``main --orbit`` with its bake (equal trees), and the port's
    ``--backend torch --platform cpu``, which bakes what ``bake_scene``
    bakes on the CPU from the captured poses."""
    mesh = _room_mesh()
    k = np.array([[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]], np.float32)
    texture = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    for tex in (None, texture):
        results = []
        for mod in (jcapture, tcapture):
            monkeypatch.setattr(sys, "stdin", io.StringIO("c w w c l l s c q i x"))
            out = io.StringIO()
            poses = mod.fly(mesh, k, (12, 16), texture=tex,
                            start=(0.0, 0.0, 0.0), speed=0.5, turn_deg=45.0,
                            out=out, interactive=False)
            results.append((poses, out.getvalue()))
        (jp, jout), (tp, tout) = results
        assert tout == jout and "▀" in tout
        assert len(tp) == len(jp) == 3
        for a, b in zip(tp, jp):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for y in (0.0, 0.3, -1.2):
        assert np.array_equal(tcapture.pose_from(np.zeros(3), y, 0.2),
                              jcapture.pose_from(np.zeros(3), y, 0.2))
    img = np.random.default_rng(1).integers(0, 255, (5, 4, 3), dtype=np.uint8)
    assert tcapture.ansi_frame(img) == jcapture.ansi_frame(img)

    mesh_path = str(tmp_path / "room.ply")
    jmesh_io.save_ply(mesh, mesh_path)
    argv = ["--mesh", mesh_path, "--base_hw", "24", "32", "--pyramid_heights",
            "16", "--fov", "70", "--orbit", "0", "0", "0", "1.0", "3"]
    for mod, side in ((jcapture, "j"), (tcapture, "t")):
        assert mod.main(argv + ["--out", str(tmp_path / side)]) == 0
        monkeypatch.setattr(sys, "stdin", io.StringIO("w c j j c x"))
        assert mod.main(argv[:-6] + ["--out", str(tmp_path / f"{side}_fly"),
                                     "--preview_hw", "16", "22",
                                     "--no_bake"]) == 0
    for side in ("", "_fly"):
        assert_same_tree(tmp_path / f"j{side}", tmp_path / f"t{side}")
    assert sorted(tree(tmp_path / "t_fly")) == ["pose_novel/0.txt",
                                                "pose_novel/1.txt"]
    assert tcapture.main(argv + ["--out", str(tmp_path / "torch"), "--backend",
                                 "torch", "--platform", "cpu"]) == 0
    pose_dir = tmp_path / "call" / "pose_novel"
    write_pose_dir(orbit_poses((0, 0, 0), 1.0, 0.0, n=3), str(pose_dir))
    f = 16 / np.tan(np.deg2rad(70) / 2)
    k = np.array([[f, 0, 16], [0, f, 12], [0, 0, 1]], np.float32)
    tpre.bake_scene(mesh_path, str(pose_dir), k, (32, 24), str(tmp_path / "call"),
                    base_hw=(24, 32), pyramid_heights=(16,), backend="torch",
                    device="cpu")
    assert_same_tree(tmp_path / "torch", tmp_path / "call")

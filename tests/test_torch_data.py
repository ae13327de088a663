"""Port parity: the data layer (``data/scenes.py``, ``data/loading.py``,
``data/sampling.py``, ``data/grad_masks.py``) against the JAX package on the
ScanNet and Matterport layouts of ``tests/test_data.py``, written to
``tmp_path``.

Tolerance: exact. Both packages run the same numpy, Pillow and OpenCV calls
on the same files, so every path, array and index list must be equal.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stylemesh_tpu.data import grad_masks as jgrad_masks
from stylemesh_tpu.data import loading as jloading
from stylemesh_tpu.data import sampling as jsampling
from stylemesh_tpu.data import scenes as jscenes
from stylemesh_tpu_torch.data import grad_masks as tgrad_masks
from stylemesh_tpu_torch.data import loading as tloading
from stylemesh_tpu_torch.data import sampling as tsampling
from stylemesh_tpu_torch.data import scenes as tscenes
from test_data import N_FRAMES, _make_matterport_region, _make_scannet_scene

ROOT = Path(__file__).resolve().parents[1]


def _assert_same(a, b, where=""):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
    else:
        assert a == b, where


def _discover(pkg, dataset, root, **kw):
    if dataset == "scannet":
        return pkg.discover_scannet_scenes(str(root), **kw)
    return pkg.discover_matterport_regions(str(root), region_index=0, **kw)


def _make(dataset, root):
    (_make_scannet_scene if dataset == "scannet" else _make_matterport_region)(root)


@pytest.mark.parametrize("dataset", ["scannet", "matterport"])
@pytest.mark.parametrize("levels,min_height", [(5, 16), (1, 20)])
def test_discovery_matches_jax(tmp_path, dataset, levels, min_height):
    _make(dataset, tmp_path)
    kw = dict(pyramid_levels=levels, min_pyramid_height=min_height)
    jspecs = _discover(jscenes, dataset, tmp_path, **kw)
    tspecs = _discover(tscenes, dataset, tmp_path, **kw)
    assert list(tspecs) == list(jspecs) and len(tspecs) == 1
    for name in jspecs:
        j, t = dataclasses.asdict(jspecs[name]), dataclasses.asdict(tspecs[name])
        assert list(t) == list(j)
        for k in j:
            _assert_same(t[k], j[k], k)
    for seed in (0, 3):
        assert (tscenes.select_scene(tspecs, min_images=1, seed=seed).name
                == jscenes.select_scene(jspecs, min_images=1, seed=seed).name)
    with pytest.raises(ValueError, match="No scene"):
        tscenes.select_scene(tspecs, min_images=100)


@pytest.mark.parametrize("dataset", ["scannet", "matterport"])
def test_load_view_and_scene_cache_match_jax(tmp_path, dataset):
    _make(dataset, tmp_path)
    jspec = next(iter(_discover(jscenes, dataset, tmp_path,
                                min_pyramid_height=16).values()))
    tspec = next(iter(_discover(tscenes, dataset, tmp_path,
                                min_pyramid_height=16).values()))
    for idx in range(N_FRAMES):
        j = dataclasses.asdict(jloading.load_view(jspec, idx, resize_size=16))
        t = dataclasses.asdict(tloading.load_view(tspec, idx, resize_size=16))
        assert list(t) == list(j)
        for k in j:
            _assert_same(t[k], j[k], f"view {idx} {k}")
    jcache = jloading.SceneCache(jspec, resize_size=16)
    tcache = tloading.SceneCache(tspec, resize_size=16, indices=[2, 0, 1])
    assert tcache.num_views == N_FRAMES
    _assert_same(tcache.levels, jcache.levels)
    for chunk in ([2, 0], [1, 1, 2]):
        jb = jcache.get_batch(chunk)
        tb = tcache.get_batch(chunk)
        assert jb.splat_plans is None
        for k in tb._fields:
            _assert_same(getattr(tb, k), getattr(jb, k), f"{chunk} {k}")
    np.testing.assert_array_equal(
        tloading.gatys_pre_np(np.full((2, 2, 3), 0.5, np.float32)),
        jloading.gatys_pre_np(np.full((2, 2, 3), 0.5, np.float32)))


@pytest.mark.parametrize("angle,depth", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_grad_weight_masks_match_jax(tmp_path, angle, depth):
    _make_scannet_scene(tmp_path)
    spec = next(iter(tscenes.discover_scannet_scenes(
        str(tmp_path), min_pyramid_height=16).values()))
    batch = tloading.SceneCache(spec, resize_size=16).get_batch([0, 1, 2])
    shapes = [tuple(u.shape[1:3]) for u in batch.uv] + [(7, 9)]
    got = tgrad_masks.grad_weight_masks(batch, shapes, angle, depth)
    want = jgrad_masks.grad_weight_masks(batch, shapes, angle, depth)
    if not (angle or depth):
        assert got is None and want is None
        return
    _assert_same(got, want)


def test_sampling_matches_jax():
    for n, split, mode, shuffle in [(10, (0.8, 0.2), "sequential", False),
                                    (7, (0.99, 0.01), "sequential", True),
                                    (5, (0.5, 0.5), "folder", True)]:
        assert (tsampling.make_split(n, split, mode, shuffle, seed=4)
                == jsampling.make_split(n, split, mode, shuffle, seed=4))
    idx = [3, 1, 4, 0, 5]
    for mode, rep in [("sequential", 1), ("random", 1), ("repeat", 3),
                      ("repeat", [1, 2, 3, 1, 2, 2])]:
        assert (tsampling.epoch_indices(idx, mode, rep, seed=9)
                == jsampling.epoch_indices(idx, mode, rep, seed=9))
    for bs in (1, 2, 4):
        assert tsampling.batched(idx, bs) == jsampling.batched(idx, bs)
        assert (tsampling.batched(idx, bs, drop_remainder=True)
                == jsampling.batched(idx, bs, drop_remainder=True))
        assert (tsampling.batched_repeat(idx, bs, 3)
                == jsampling.batched_repeat(idx, bs, 3))
    with pytest.raises(ValueError):
        tsampling.epoch_indices(idx, "shuffle")


def test_port_imports_without_pillow_or_opencv():
    """Pillow and OpenCV are imported where images are decoded or written,
    never when a module of the port is imported."""
    code = ("import sys\n"
            "sys.modules['PIL'] = sys.modules['cv2'] = None\n"
            "import importlib, pkgutil, stylemesh_tpu_torch\n"
            "for m in pkgutil.walk_packages(stylemesh_tpu_torch.__path__,\n"
            "                                'stylemesh_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

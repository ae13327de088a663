"""Scene discovery for the ScanNet and Matterport3D on-disk layouts
(counterpart of ``stylemesh_tpu/data/scenes.py``, a copy: the port imports
nothing of the JAX package).

Replicates the file-system contract of the reference datasets:

- ScanNet (the reference's data/scannet_dataset.py:99-256):
  ``<root>/<scene>/{color,depth,pose,uv,uv_<h>}`` with ``<scene>.txt``
  intrinsics (fx_color/fy_color/mx_color/my_color/colorWidth/colorHeight);
  frames named ``<int>.<ext>``; uv pyramid folders ``uv_<height>``.
- Matterport (the reference's data/matterport_dataset.py:98-243):
  ``<root>/<scan>/rendered/region_<r>/{color,depth,pose,uv_<w>_<h>,angle,
  rendered_depth}``; frames named ``<pano>_i<cam>_<yaw>.<ext>``; a single
  ``*.intrinsics.txt`` in pose/ used for the whole region.

Discovery is pure metadata (paths + intrinsics); pixel loading lives in
:mod:`stylemesh_tpu_torch.data.loading`.
"""

import dataclasses
import os
import random
from os.path import isdir, join
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SceneSpec:
    """All file paths + static metadata of one (scene, region)."""

    name: str
    dataset: str  # 'scannet' | 'matterport'
    rgb: List[str]
    depth: List[str]
    extrinsics: List[str]
    uv: List[List[str]]  # [pyramid_level][frame]
    angle: List[str]
    intrinsics: np.ndarray  # [4, 4]
    intrinsics_size: Tuple[int, int]  # (w, h) the intrinsics refer to
    intrinsics_file: Optional[str]
    levels: np.ndarray  # filtered uv heights (sorted ascending)
    all_levels: np.ndarray
    rendered_depth: bool  # depth comes from baked .npy instead of sensor png
    depth_divisor: float  # sensor png scale: 1000 (ScanNet) / 4000 (Matterport)
    mask_uses_depth: bool  # ScanNet gates the UV mask by depth > 0
    min_pyramid_depth: float = 0.25

    @property
    def num_frames(self):
        return len(self.rgb)


def _int_name_key(fname):
    return int(fname.split(".")[0])


def _matterport_key(fname):
    stem = fname.split(".")[0]
    parts = stem.split("_")
    return [parts[0], int(parts[1][1]) * 100 + int(parts[2])]


def _is_float(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def _listdir_sorted(path, key, keep=None):
    if not isdir(path):
        return []
    names = os.listdir(path)
    if keep is not None:
        names = [n for n in names if keep(n)]
    return [join(path, n) for n in sorted(names, key=key)]


# --------------------------------------------------------------- ScanNet


def _scannet_intrinsics(scene_path):
    intr = np.identity(4, dtype=np.float32)
    w = h = 0
    files = [join(scene_path, f) for f in os.listdir(scene_path) if f.endswith(".txt")]
    intr_file = None
    if len(files) == 1:
        intr_file = files[0]
        with open(intr_file) as f:
            for line in f:
                line = line.strip()
                if " = " not in line:
                    continue
                key, val = line.split(" = ", 1)
                key = key.strip()
                if key == "fx_color":
                    intr[0, 0] = float(val)
                elif key == "fy_color":
                    intr[1, 1] = float(val)
                elif key == "mx_color":
                    intr[0, 2] = float(val)
                elif key == "my_color":
                    intr[1, 2] = float(val)
                elif key == "colorWidth":
                    w = int(val)
                elif key == "colorHeight":
                    h = int(val)
    return intr, (w, h), intr_file


def discover_scannet_scene(scene_path, pyramid_levels=5, min_pyramid_height=256,
                           min_pyramid_depth=0.25):
    """Parse one ``<root>/<scene>`` directory; returns SceneSpec or None if
    the scene is incomplete (mirrors the consistency checks at
    abstract_dataset.py:133-165)."""
    name = os.path.basename(scene_path.rstrip("/"))
    rgb = _listdir_sorted(join(scene_path, "color"), _int_name_key,
                          keep=lambda n: n.endswith(("jpg", "png")))
    # depth: sensor pngs, falling back to baked rendered-depth npys
    depth = _listdir_sorted(join(scene_path, "depth"), _int_name_key)
    rendered = False
    if not depth:
        depth = _listdir_sorted(join(scene_path, "uv"), _int_name_key,
                                keep=lambda n: "npy" in n and "depth" in n)
        rendered = True
    pose = _listdir_sorted(join(scene_path, "pose"), _int_name_key)
    angle = _listdir_sorted(join(scene_path, "uv"), _int_name_key,
                            keep=lambda n: "npy" in n and "angle" in n)

    # uv pyramid folders: 'uv_<height>', deduped (256 vs 256.0), sorted,
    # floored at min height, truncated to pyramid_levels (scannet_dataset.py:198-239)
    folders = [f for f in os.listdir(scene_path)
               if "uv_" in f and len(f.split("_")) > 1 and _is_float(f.split("_")[1])]
    folders = sorted(folders, key=lambda x: float(x.split("_")[1]))
    seen, dedup = set(), []
    for f in folders:
        size = float(f.split("_")[1])
        if size not in seen:
            seen.add(size)
            dedup.append(f)
    all_levels = np.array([float(f.split("_")[1]) for f in dedup])
    dedup = [f for f in dedup if float(f.split("_")[1]) >= min_pyramid_height]
    dedup = dedup[:pyramid_levels]
    levels = np.array([float(f.split("_")[1]) for f in dedup])
    uv = [
        _listdir_sorted(join(scene_path, f), _int_name_key,
                        keep=lambda n: "npy" in n and "angle" not in n and "depth" not in n)
        for f in dedup
    ]

    intr, size, intr_file = _scannet_intrinsics(scene_path)

    n = len(rgb)
    complete = (n > 0 and len(depth) == n and len(angle) == n and len(pose) == n
                and len(uv) > 0 and all(len(u) == n for u in uv))
    if not complete:
        return None
    return SceneSpec(
        name=name, dataset="scannet", rgb=rgb, depth=depth, extrinsics=pose,
        uv=uv, angle=angle, intrinsics=intr, intrinsics_size=size,
        intrinsics_file=intr_file, levels=levels, all_levels=all_levels,
        rendered_depth=rendered, depth_divisor=1000.0, mask_uses_depth=True,
        min_pyramid_depth=min_pyramid_depth)


def discover_scannet_scenes(root, **kw) -> Dict[str, SceneSpec]:
    scenes = {}
    if not isdir(root):
        return scenes
    for name in sorted(os.listdir(root)):
        path = join(root, name)
        if isdir(path):
            spec = discover_scannet_scene(path, **kw)
            if spec is not None:
                scenes[name] = spec
    return scenes


# --------------------------------------------------------------- Matterport


def _matterport_intrinsics(region_path):
    intr = np.identity(4, dtype=np.float32)
    w = h = 0
    pose_dir = join(region_path, "pose")
    intr_file = None
    if isdir(pose_dir):
        files = [join(pose_dir, f) for f in sorted(os.listdir(pose_dir))
                 if f.endswith(".intrinsics.txt")]
        if files:
            intr_file = files[0]
            with open(intr_file) as f:
                for i, line in enumerate(f):
                    elems = line.strip().split(" ")
                    if i < 3:
                        intr[i, 0] = float(elems[0])
                        intr[i, 1] = float(elems[1])
                        intr[i, 2] = float(elems[2])
                    elif i == 3:
                        w, h = int(elems[0]), int(elems[1])
    return intr, (w, h), intr_file


def discover_matterport_region(scan_path, region_index=0, pyramid_levels=5,
                               min_pyramid_height=256, min_pyramid_depth=0.25):
    name = os.path.basename(scan_path.rstrip("/"))
    region = join(scan_path, "rendered", f"region_{region_index}")
    if not isdir(region):
        return None
    rgb = _listdir_sorted(join(region, "color"), _matterport_key,
                          keep=lambda n: n.endswith(("jpg", "png")))
    depth = _listdir_sorted(join(region, "depth"), _matterport_key)
    rendered = False
    if not depth:
        depth = _listdir_sorted(join(region, "rendered_depth"), _matterport_key,
                                keep=lambda n: "npy" in n and "depth" in n)
        rendered = True
    pose = _listdir_sorted(join(region, "pose"), _matterport_key,
                           keep=lambda n: "intrinsic" not in n)
    angle = _listdir_sorted(join(region, "angle"), _matterport_key,
                            keep=lambda n: "npy" in n and "angle" in n)

    folders = [f for f in os.listdir(region) if "uv_" in f]
    folders = sorted(folders, key=lambda x: int(x.split("_")[-1]))
    all_levels = np.array([int(f.split("_")[-1]) for f in folders])
    folders = [f for f in folders if int(f.split("_")[-1]) >= min_pyramid_height]
    folders = folders[:pyramid_levels]
    levels = np.array([float(f.split("_")[-1]) for f in folders])
    uv = [
        _listdir_sorted(join(region, f), _matterport_key,
                        keep=lambda n: "npy" in n and "uvs" in n)
        for f in folders
    ]

    intr, size, intr_file = _matterport_intrinsics(region)

    n = len(rgb)
    complete = (n > 0 and len(depth) == n and len(angle) == n and len(pose) == n
                and len(uv) > 0 and all(len(u) == n for u in uv))
    if not complete:
        return None
    return SceneSpec(
        name=name, dataset="matterport", rgb=rgb, depth=depth, extrinsics=pose,
        uv=uv, angle=angle, intrinsics=intr, intrinsics_size=size,
        intrinsics_file=intr_file, levels=levels, all_levels=all_levels,
        rendered_depth=rendered, depth_divisor=4000.0, mask_uses_depth=False,
        min_pyramid_depth=min_pyramid_depth)


def discover_matterport_regions(root, region_index=0, **kw) -> Dict[str, SceneSpec]:
    scenes = {}
    if not isdir(root):
        return scenes
    for name in sorted(os.listdir(root)):
        path = join(root, name)
        if isdir(path):
            spec = discover_matterport_region(path, region_index=region_index, **kw)
            if spec is not None:
                scenes[name] = spec
    return scenes


# --------------------------------------------------------------- selection


def select_scene(scenes: Dict[str, SceneSpec], name=None, min_images=1000,
                 max_images=-1, seed=None) -> SceneSpec:
    """Pick the named scene, or a random one whose frame count is in range
    (reference single-scene logic, scannet_single_scene_dataset.py:110-150)."""

    def in_range(v):
        return ((min_images == -1 or v >= min_images)
                and (max_images == -1 or v <= max_images))

    if name and name in scenes and in_range(scenes[name].num_frames):
        return scenes[name]
    names = list(scenes.keys())
    rng = random.Random(seed)
    rng.shuffle(names)
    lo = hi = -1
    for n in names:
        v = scenes[n].num_frames
        hi = max(hi, v) if hi != -1 else v
        lo = min(lo, v) if lo != -1 else v
        if in_range(v):
            return scenes[n]
    raise ValueError(
        f"No scene with {min_images} <= frames <= {max_images}; "
        f"available range: {lo}..{hi}")

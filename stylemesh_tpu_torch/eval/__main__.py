"""Standalone reprojection-consistency eval over image folders
(counterpart of ``stylemesh_tpu/eval/__main__.py``): score a styled frame
set, made by any tool, against the scene's rgb, depth and poses without
training.

    python -m stylemesh_tpu_torch.eval --rgb <dir> --styled <dir> \
        --pose <dir> --intrinsics <file> --depth <dir> \
        [--vgg_model_path vgg.npz] [--lpips_weights lpips_lin.npz] \
        [--image_size 256] [--platform cpu] [...]

Frames are paired by sorted filename across the folders (the reference's
convention). Depth is divided by ``--depth_divisor`` (1000 ScanNet, 4000
Matterport). The warps and LPIPS run on the card unless ``--platform cpu``.
"""

import argparse
import json
import os
import types
from os.path import isdir, join

import numpy as np

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.data.loading import (
    gatys_pre_np,
    load_extrinsics,
    rescale_intrinsics,
)
from stylemesh_tpu_torch.data.scenes import _matterport_key
from stylemesh_tpu_torch.eval.reprojection import eval_reprojection_consistency


def _sort_key(fname):
    """Tolerant frame ordering: numeric stems (ScanNet '123.jpg'), matterport
    '<hash>_i<c>_<y>' names, else lexicographic."""
    stem = fname.split(".")[0]
    if stem.isdigit():
        return ("", int(stem))
    try:
        return tuple(_matterport_key(fname))
    except (IndexError, ValueError):
        return (stem, 0)


def _listdir(path, exts=None):
    names = sorted(os.listdir(path), key=_sort_key)
    if exts:
        names = [n for n in names if n.lower().endswith(exts)]
    return [join(path, n) for n in names]


def _load_intrinsics(path):
    """ScanNet ``<scene>.txt`` (fx_color = ...) or a numeric-row matrix file
    (Matterport ``.intrinsics.txt``: 3 rows + optional 'w h')."""
    with open(path) as f:
        text = f.read()
    k = np.identity(4, dtype=np.float32)
    size = None
    if "fx_color" in text:
        vals = {}
        for line in text.splitlines():
            if "=" in line:
                key, v = line.split("=", 1)
                vals[key.strip()] = float(v.strip())
        k[0, 0] = vals["fx_color"]
        k[1, 1] = vals["fy_color"]
        k[0, 2] = vals["mx_color"]
        k[1, 2] = vals["my_color"]
        size = (int(vals.get("colorWidth", 0)), int(vals.get("colorHeight", 0)))
    else:
        rows = [l.split() for l in text.splitlines() if l.strip()]
        for i in range(3):
            k[i, :3] = [float(v) for v in rows[i][:3]]
        if len(rows) > 3 and len(rows[3]) >= 2:
            size = (int(float(rows[3][0])), int(float(rows[3][1])))
    return k, size


def _load_depth(path, hw, divisor):
    from PIL import Image

    if path.endswith(".npy"):
        d = np.load(path)
        if d.ndim == 3:
            d = d[..., 0]
    else:
        d = np.asarray(Image.open(path), dtype=np.float32) / divisor
    img = Image.fromarray(np.asarray(d, np.float32), mode="F")
    if (img.size[1], img.size[0]) != hw:
        img = img.resize((hw[1], hw[0]), Image.Resampling.NEAREST)
    return np.asarray(img, dtype=np.float32)[..., None]


def folder_scene(rgb_dir, depth_dir, pose_dir, intrinsics_path,
                 image_size=256, depth_divisor=1000.0):
    """Build the minimal scene-cache shim the reprojection eval consumes
    from loose folders (sorted-filename pairing across folders)."""
    from PIL import Image

    rgb_files = _listdir(rgb_dir, (".jpg", ".png", ".jpeg"))
    if not rgb_files:
        raise ValueError(f"no rgb frames in {rgb_dir}")
    w0, h0 = Image.open(rgb_files[0]).size
    hw = (image_size, round(w0 * image_size / h0))

    depth_files = _listdir(depth_dir)
    pose_files = [p for p in _listdir(pose_dir) if "intrinsic" not in p]
    n = len(rgb_files)
    if not len(depth_files) == len(pose_files) == n:
        raise ValueError(f"frame count mismatch: rgb={n} "
                         f"depth={len(depth_files)} pose={len(pose_files)}")

    k, size = _load_intrinsics(intrinsics_path)
    k = rescale_intrinsics(k, size or (w0, h0), (hw[1], hw[0]))

    # real frames, Gatys-preprocessed as SceneCache stores them: the
    # diagnostic image dump writes them back out as the scene's photos
    def _load_rgb(p):
        img = Image.open(p).convert("RGB").resize((hw[1], hw[0]),
                                                  Image.Resampling.BICUBIC)
        return gatys_pre_np(np.asarray(img, np.float32) / 255.0)

    rgb = np.stack([_load_rgb(p) for p in rgb_files])
    depth = np.stack([_load_depth(p, hw, depth_divisor) for p in depth_files])
    poses = np.stack([load_extrinsics(p) for p in pose_files])
    intr = np.broadcast_to(np.asarray(k, np.float32), (n, 4, 4)).copy()

    batch = types.SimpleNamespace(rgb=rgb, depth=depth, extrinsics=poses,
                                  intrinsics=intr)
    return types.SimpleNamespace(_batch_all=batch, num_views=n,
                                 indices=list(range(n)))


def main(argv=None):
    p = argparse.ArgumentParser("stylemesh_tpu_torch.eval")
    p.add_argument("--rgb", required=True, help="path to rgb image folder")
    p.add_argument("--styled", required=True, help="path to styled image folder")
    p.add_argument("--pose", required=True,
                   help="path to pose folder (4x4 cam2world per frame)")
    p.add_argument("--intrinsics", required=True, help="path to intrinsics file")
    p.add_argument("--depth", required=True, help="path to depth image folder")
    p.add_argument("--vgg_model_path", default="",
                   help="VGG weights (.npz/.pth) for the LPIPS metric")
    p.add_argument("--lpips_weights", default="",
                   help="calibrated LPIPS lin weights .npz (tools/convert_lpips.py)")
    p.add_argument("--style_image", default="", help="accepted for "
                   "reference-compat (unused by the reprojection metric)")
    p.add_argument("--random_seed", default=42, type=int)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--image_size", default=256, type=int)
    p.add_argument("--pair_threshold", default=20, type=int)
    p.add_argument("--pair_threshold_short", default=1, type=int)
    p.add_argument("--pair_threshold_long", default=10, type=int)
    p.add_argument("--depth_divisor", default=1000.0, type=float)
    p.add_argument("--no_lpips", default=False, action="store_true")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="'cpu' runs on the CPU; the default is the card")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)

    scene = folder_scene(args.rgb, args.depth, args.pose, args.intrinsics,
                         image_size=args.image_size,
                         depth_divisor=args.depth_divisor)

    lpips_fn = None
    if not args.no_lpips:
        from stylemesh_tpu_torch.optimize import build_lpips

        lpips_fn = build_lpips(args.vgg_model_path, args.lpips_weights,
                               device=device)

    styled_paths = _listdir(args.styled, (".jpg", ".png", ".jpeg"))
    if len(styled_paths) != scene.num_views:
        raise ValueError(f"styled frame count {len(styled_paths)} != "
                         f"{scene.num_views}")
    results = eval_reprojection_consistency(
        scene, args.styled, out_dir=args.out_dir or args.styled,
        seed=args.random_seed, pair_threshold=args.pair_threshold,
        pair_threshold_short=args.pair_threshold_short,
        pair_threshold_long=args.pair_threshold_long,
        lpips_fn=lpips_fn, styled_paths=styled_paths, device=device)
    print(json.dumps(results["accuracies"], indent=2))
    return results


if __name__ == "__main__":
    main()

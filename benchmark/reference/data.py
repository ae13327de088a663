"""The scene's views read from its files as the upstream dataset reads
them: a frozen copy of the port's ``data/loading.py::load_view`` pixel path
(PIL bicubic for the photo, cv2 linear for depth, cv2 nearest for the
angle, PIL nearest for the mask), ``data/depth_level.py`` and the style
image loader, on numpy."""

import os

import numpy as np

IMAGENET_MEAN_BGR = np.asarray((0.40760392, 0.45795686, 0.48501961),
                               np.float32)


def gatys_pre(rgb01):
    """``[H, W, 3]`` RGB in [0, 1] -> BGR, mean removed, times 255."""
    return (rgb01[..., ::-1].astype(np.float32) - IMAGENET_MEAN_BGR) * 255.0


def depth_levels(depth, levels, min_depth, min_uv_height=32):
    """(rounded, other, weight) per pixel: the nearest and second-nearest
    pyramid level of each pixel's ideal UV height and the nearest's
    weight (the upstream's ``calculate_depth_level``)."""
    levels = np.asarray(levels, np.float64)
    n = len(levels)
    uv_height = min_uv_height * (np.asarray(depth, np.float64) / min_depth)
    rounded = np.argmin(np.abs(uv_height[..., None] - levels), axis=-1)
    residues = levels[rounded] - uv_height
    step = np.where(residues > 0, -1, 1)
    step[residues == 0] = 0
    other = np.clip(rounded + step, 0, n - 1)
    height_diff = np.abs(levels[rounded] - levels[other])
    interp = np.abs(residues / (height_diff + 1e-6))
    interp[height_diff == 0] = 0
    return (rounded.astype(np.float32), other.astype(np.float32),
            (1 - interp).astype(np.float32))


def scene_levels(scene_dir, pyramid_levels, min_height):
    """The UV heights the run uses: the scene's ``uv_<h>`` folders of at
    least ``min_height``, the first ``pyramid_levels`` of them."""
    heights = sorted({float(f.split("_")[1]) for f in os.listdir(scene_dir)
                      if f.startswith("uv_")})
    return [h for h in heights if h >= min_height][:pyramid_levels]


def load_views(scene_dir, indices, levels, resize_size, min_depth):
    """The views ``indices`` as a dict of stacked numpy arrays: ``rgb``
    ``[V, H, W, 3]``, ``uv`` (per level ``[V, h, w, 2]`` in [-1, 1]),
    ``mask``, ``angle_guidance``, ``angle_degrees``, ``rounded``,
    ``other``, ``weight`` (each ``[V, H, W, 1]``)."""
    import cv2
    from PIL import Image

    out = {k: [] for k in ("rgb", "mask", "angle_guidance", "angle_degrees",
                           "rounded", "other", "weight")}
    out["uv"] = [[] for _ in levels]
    for i in indices:
        photo = Image.open(os.path.join(scene_dir, "color", f"{i}.jpg"))
        w0, h0 = photo.size
        target = (round(w0 * resize_size / h0), resize_size)
        depth = (np.asarray(Image.open(os.path.join(
            scene_dir, "depth", f"{i}.png"))) / 1000.0).astype(np.float32)
        uv_raw = [np.load(os.path.join(scene_dir, f"uv_{int(h)}", f"{i}.npy"))
                  for h in levels]
        top = uv_raw[-1]
        mask = (top[..., 0] != 0) | (top[..., 1] != 0)
        d = cv2.resize(depth, (mask.shape[1], mask.shape[0]),
                       interpolation=cv2.INTER_LINEAR)
        mask = Image.fromarray(mask & (d > 0)).resize(
            target, Image.Resampling.NEAREST)
        angle = np.load(os.path.join(scene_dir, "uv", f"{i}.angle.npy"))
        angle = cv2.resize(angle[..., :1].astype(np.float32), target,
                           interpolation=cv2.INTER_NEAREST)
        depth = cv2.resize(depth, target, interpolation=cv2.INTER_LINEAR)
        rounded, other, weight = depth_levels(depth, levels, min_depth)
        rgb = np.asarray(photo.resize(target, Image.Resampling.BICUBIC),
                         np.float32) / 255.0
        cos = np.clip(angle, -1.0, 1.0)
        out["rgb"].append(gatys_pre(rgb[..., :3]))
        out["mask"].append((np.asarray(mask) > 0).astype(np.float32)[..., None])
        out["angle_guidance"].append(cos[..., None])
        out["angle_degrees"].append(np.degrees(np.arccos(cos))
                                    .astype(np.float32)[..., None])
        out["rounded"].append(rounded[..., None])
        out["other"].append(other[..., None])
        out["weight"].append(weight[..., None])
        for lv, u in zip(out["uv"], uv_raw):
            lv.append(u[..., :2].astype(np.float32) * 2.0 - 1.0)
    batch = {k: np.stack(v) for k, v in out.items() if k != "uv"}
    batch["uv"] = [np.stack(u) for u in out["uv"]]
    return batch


def load_style(path, max_size=2048):
    """The style image as ``[1, H, W, 3]`` Gatys values; an image larger
    than ``max_size`` on either side has its shorter side brought to it."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w > max_size or h > max_size:
        size = ((max_size, round(h * max_size / w)) if w < h
                else (round(w * max_size / h), max_size))
        img = img.resize(size, Image.Resampling.BILINEAR)
    return gatys_pre(np.asarray(img, np.float32) / 255.0)[None]

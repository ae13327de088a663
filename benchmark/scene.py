"""The benchmark's scene generator: a ScanNet-layout scene written from a
seed, which the port's data layer and the reference both read.

A frozen copy of the port's ``data/synthetic.py::synthetic_view_batch`` and
of ``chip_smoke.py::write_scene``, with one change: each view's UV map
covers a square window of ``uv_window`` of the atlas's side at a place drawn
from the seed, so that consecutive chunks touch different texels. Every
seed gives the same sizes, masks, depths and angles (so the same work); the
seed moves the windows and draws the photos and the style image.

Layout under ``<root>/train/images/<name>``: ``color/<i>.jpg``,
``depth/<i>.png`` (uint16 millimetres), ``pose/<i>.txt``,
``uv/<i>.angle.npy``, ``uv_<h>/<i>.npy`` ((u, v) in [0, 1], zeros where no
surface is seen) and ``<name>.txt`` intrinsics; ``<root>/style.jpg``.
"""

import os

import numpy as np


def scene_arrays(spec, seed):
    """The per-view arrays of the scene (numpy): photos ``[V, H, W, 3]``
    uint8, depth ``[H, W]``, cos angle ``[H, W]``, mask ``[H, W]`` bool and
    per level ``[V, h, w, 2]`` UVs in [0, 1]."""
    rng = np.random.default_rng(seed)
    n = spec["views"]
    h, w = spec["photo_hw"]
    aspect = w / h
    win = spec["uv_window"]
    corners = rng.random((n, 2)) * (1.0 - win)
    uv = []
    for lh in spec["uv_heights"]:
        lw = int(lh * aspect)
        ys, xs = np.meshgrid(np.linspace(0, 1, lh), np.linspace(0, 1, lw),
                             indexing="ij")
        uv.append(np.stack([np.stack([c[0] + win * xs, c[1] + win * ys],
                                     axis=-1) for c in corners])
                  .astype(np.float32))
    d0, d1 = spec["depth_range"]
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    depth = (d0 + (d1 - d0) * (0.3 * xs + 0.7 * ys)).astype(np.float32)
    r = np.sqrt((xs - 0.5) ** 2 + (ys - 0.5) ** 2) / np.sqrt(0.5)
    cos_angle = np.clip(1.0 - 0.9 * r, 0.01, 1.0).astype(np.float32)
    mask = np.ones((h, w), bool)
    strip = max(1, int(h * (1 - spec["valid_fraction"])))
    mask[:strip] = False
    mask[:, :strip] = False
    photos = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    style = rng.integers(0, 256, tuple(spec["style_hw"]) + (3,),
                         dtype=np.uint8)
    return photos, depth, cos_angle, mask, uv, style


def write_scene(root, spec, seed):
    """Write the scene of ``spec`` (a traffic file's ``scene``) for
    ``seed`` under ``root``; returns ``(data_root, scene_name, style_path)``
    where ``data_root`` is what ``RunConfig.root_path`` takes."""
    from PIL import Image

    photos, depth, cos_angle, mask, uv, style = scene_arrays(
        spec, seed)
    name = spec["name"]
    h, w = spec["photo_hw"]
    sp = os.path.join(root, "train", "images", name)
    for sub in ["color", "depth", "pose", "uv"] + [
            f"uv_{lh}" for lh in spec["uv_heights"]]:
        os.makedirs(os.path.join(sp, sub), exist_ok=True)
    depth_mm = np.where(mask, np.round(depth * 1000.0), 0).astype(np.uint16)
    angle = np.repeat(cos_angle[..., None], 3, axis=-1)
    pose = np.eye(4, dtype=np.float32)
    for i in range(spec["views"]):
        Image.fromarray(photos[i]).save(
            os.path.join(sp, "color", f"{i}.jpg"), quality=95)
        Image.fromarray(depth_mm).save(os.path.join(sp, "depth", f"{i}.png"))
        np.savetxt(os.path.join(sp, "pose", f"{i}.txt"), pose)
        np.save(os.path.join(sp, "uv", f"{i}.angle.npy"), angle)
        for lh, grid in zip(spec["uv_heights"], uv):
            lw = grid.shape[2]
            m = mask[(np.arange(lh) * h) // lh][:, (np.arange(lw) * w) // lw]
            np.save(os.path.join(sp, f"uv_{lh}", f"{i}.npy"),
                    np.where(m[..., None], grid[i], 0.0).astype(np.float32))
    with open(os.path.join(sp, f"{name}.txt"), "w") as f:
        f.write(f"fx_color = {w}.0\nfy_color = {w}.0\nmx_color = {w / 2}\n"
                f"my_color = {h / 2}\ncolorWidth = {w}\ncolorHeight = {h}\n")
    style_path = os.path.join(root, "style.jpg")
    Image.fromarray(style).save(style_path, quality=95)
    return root, name, style_path

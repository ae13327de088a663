"""Synthetic scenes: procedurally generated view batches with analytically
consistent UV / angle / depth maps (counterpart of
``stylemesh_tpu/data/synthetic.py::synthetic_view_batch``).

A virtual camera pans across a textured plane, so every pixel has a
well-defined UV coordinate, viewing angle and depth. The numpy draws are the
JAX package's, so the same arguments give the same batch in both packages.
"""

import numpy as np

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.data.depth_level import calculate_depth_level
from stylemesh_tpu_torch.data.schema import ViewBatch, to_device


def synthetic_view_batch(num_views=2, content_hw=(64, 85),
                         level_heights=(64, 96, 128), aspect=4.0 / 3.0,
                         min_depth=0.25, seed=0, valid_fraction=0.85,
                         depth_range=(0.5, 3.0), numpy_arrays=False,
                         device=None):
    """Build a ViewBatch for a camera panning across a textured plane.

    Returns numpy arrays with ``numpy_arrays=True``, else tensors on
    ``device`` (CUDA unless the caller asks for another device).
    """
    rng = np.random.default_rng(seed)
    h, w = content_hw

    rgb = rng.random((num_views, h, w, 3), dtype=np.float32)
    rgb = (rgb[..., ::-1] - np.float32(0.45)) * np.float32(255.0)  # Gatys range

    uv_pyramid = []
    for lh in level_heights:
        lw = int(lh * aspect)
        ys, xs = np.meshgrid(np.linspace(0, 1, lh), np.linspace(0, 1, lw),
                             indexing="ij")
        grids = []
        for v in range(num_views):
            shift = 0.1 * v / max(num_views, 1)
            u = 0.1 + 0.6 * xs + shift
            vv = 0.15 + 0.6 * ys
            grids.append(np.stack([u * 2 - 1, vv * 2 - 1],
                                  axis=-1).astype(np.float32))
        uv_pyramid.append(np.stack(grids, axis=0))

    # depth ramp per view (front-left near, back-right far)
    d0, d1 = depth_range
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    depth = (d0 + (d1 - d0) * (0.3 * xs + 0.7 * ys))[None].repeat(num_views, 0)
    depth = depth.astype(np.float32)[..., None]

    # viewing angle: near-frontal at center, grazing at borders
    r = np.sqrt((xs - 0.5) ** 2 + (ys - 0.5) ** 2) / np.sqrt(0.5)
    cos_angle = np.clip(1.0 - 0.9 * r, 0.01, 1.0)
    angle_guidance = cos_angle[None, ..., None].repeat(num_views, 0)
    angle_guidance = angle_guidance.astype(np.float32)
    angle_degrees = np.degrees(np.arccos(angle_guidance)).astype(np.float32)

    # mask: a valid blob + invalid border strip
    mask = np.ones((num_views, h, w, 1), dtype=np.float32)
    strip = max(1, int(h * (1 - valid_fraction)))
    mask[:, :strip] = 0.0
    mask[:, :, :strip] = 0.0

    cont, rounded, other, weight = calculate_depth_level(
        depth[..., 0], np.asarray(level_heights, dtype=np.float64),
        min_depth=min_depth)

    extr = np.tile(np.eye(4, dtype=np.float32), (num_views, 1, 1))
    intr = np.tile(np.eye(4, dtype=np.float32), (num_views, 1, 1))
    intr[:, 0, 0] = intr[:, 1, 1] = w
    intr[:, 0, 2] = w / 2.0
    intr[:, 1, 2] = h / 2.0

    batch = ViewBatch(
        rgb=rgb,
        uv=tuple(uv_pyramid),
        mask=mask,
        depth=depth,
        rounded_depth_level=rounded[..., None].astype(np.float32),
        other_depth_level=other[..., None].astype(np.float32),
        depth_level_weight=weight[..., None],
        angle_guidance=angle_guidance,
        angle_degrees=angle_degrees,
        extrinsics=extr,
        intrinsics=intr,
        idx=np.arange(num_views, dtype=np.int32),
        depth_level=cont[..., None],
    )
    if numpy_arrays:
        return batch
    return to_device(batch, resolve_device(device))

"""Pinhole un/re-projection (counterpart of
``stylemesh_tpu/geometry/project.py``).

Used by the reprojection-consistency eval (warp the styled image of one
view into another through depth and poses, and mask occlusions by
4-corner depth agreement) and by the circle metric's 2-D to 3-D lifting.

Channel-last: images ``[B, H, W, C]``, depths ``[B, H, W, 1]``. The depth
lookups are one nearest-neighbour gather over all the views, where the JAX
package loops over them. The colour and mask warps go through
:func:`~stylemesh_tpu_torch.ops.grid_sample.grid_sample`, K1 on the card,
one launch per view and image: a K1 launch samples one set of layers at
all its grids, and each view warps its own image. K1 takes ``[H, W, 3]``
layers, so the one-channel mask is warped as three equal channels and one
is kept; bilinear sampling is per channel, so that is the same function.
"""

import torch

from stylemesh_tpu_torch.ops.grid_sample import grid_sample, nearest_indices


def _pixel_grid(h, w, dtype, device):
    xx = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    yy = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return xx, yy


def _camera_points(intrinsic, depth):
    """Homogeneous camera-space points ``[B, H, W, 4]`` of a depth map."""
    _, h, w, _ = depth.shape
    xx, yy = _pixel_grid(h, w, depth.dtype, depth.device)
    fx, fy, cx, cy = _focal(intrinsic)
    d = depth[..., 0]
    x = (xx[None] - cx) / fx * d
    y = (yy[None] - cy) / fy * d
    return torch.stack([x, y, d, torch.ones_like(d)], dim=-1)


def _focal(intrinsic):
    """(fx, fy, cx, cy), each ``[B, 1, 1]``."""
    return tuple(intrinsic[:, i, j][:, None, None]
                 for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))


def unproject(cam2world, intrinsic, depth):
    """Depth map -> homogeneous world-space points ``[B, H, W, 4]``, with
    the reference's row-vector convention ``[x, y, z, 1] @ cam2world``."""
    return torch.einsum("bhwi,bij->bhwj", _camera_points(intrinsic, depth),
                        cam2world)


def _aligned(t):
    """``t``, or a copy of it where its start is not 16-byte aligned (K1
    takes aligned tensors; one view of a batch is aligned only when its
    size is a multiple of 16 bytes)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _warp(images, grids):
    """Each view's image bilinearly sampled at its own grid: ``images[i]``
    ``[H, W, 3]`` at ``grids[i]``."""
    return torch.stack([grid_sample(_aligned(img), _aligned(g))
                        for img, g in zip(images, grids)])


def reproject(cam2world_src, cam2world_tar, intrinsic, depth_src, depth_tar,
              color_tar, mask_tar, depth_agreement=0.1):
    """Warp ``color_tar`` into the src views; returns (warped, valid_mask).

    Unprojects the src depth, moves the points to the target camera,
    projects them with K, and rejects out-of-bounds and zero-depth pixels
    and pixels whose reprojected depth disagrees with the target depth at
    all four surrounding integer pixels by more than ``depth_agreement``.
    A projection that is NaN counts as out of bounds (the JAX package's
    comparisons let it through, and its colour then stays NaN).

    Args:
        color_tar: ``[B, H, W, 3]``; depths ``[B, H, W, 1]``;
        mask_tar: ``[B, H, W, 1]`` (0/1).
    Returns:
        warped ``[B, H, W, 3]`` (zeros where invalid), mask ``[B, H, W, 1]``
        bool.
    """
    _, h, w, _ = color_tar.shape
    dtype = color_tar.dtype
    world2cam_tar = torch.linalg.inv(cam2world_tar)
    # the reference applies (world2cam_tar @ cam2world_src)^T to row vectors
    src2tar = torch.einsum("bij,bjk->bik", world2cam_tar,
                           cam2world_src).transpose(1, 2)
    coords = torch.einsum("bhwi,bij->bhwj",
                          _camera_points(intrinsic, depth_src), src2tar)
    fx, fy, cx, cy = _focal(intrinsic)
    z_tar = coords[..., 2]
    px = coords[..., 0] / (1e-8 + z_tar) * fx + cx
    py = coords[..., 1] / (1e-8 + z_tar) * fy + cy

    inside = (px >= 0) & (py >= 0) & (px < w - 1) & (py < h - 1)
    lx, ly = torch.floor(px), torch.floor(py)
    rx, ry = lx + 1, ly + 1

    def to_grid(gx, gy):
        # the reference's make_grid: 2 x / W - 1 (not align_corners scaling)
        return torch.stack([2.0 * gx / w - 1.0, 2.0 * gy / h - 1.0], dim=-1)

    b, dh, dw, _ = depth_tar.shape
    depth_flat = depth_tar.reshape(b, dh * dw)
    nearest = [torch.gather(depth_flat, 1, nearest_indices(
        to_grid(gx, gy), dh, dw).reshape(b, -1)).reshape(z_tar.shape)
        for gx, gy in ((lx, ly), (lx, ry), (rx, ly), (rx, ry))]
    closest = torch.stack([torch.abs(z_tar - s) for s in nearest]).amin(0)
    geometric = inside & (depth_src[..., 0] != 0) & ~(closest > depth_agreement)

    warp_grid = to_grid(px, py)
    color_warp = _warp(color_tar, warp_grid)
    mask3 = mask_tar.to(dtype).expand(-1, -1, -1, 3).contiguous()
    mask_warp = _warp(mask3, warp_grid)[..., :1]
    valid = (mask_warp > 0.99) & geometric[..., None]
    return color_warp * valid.to(dtype), valid

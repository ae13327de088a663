"""Texture masking (counterpart of ``stylemesh_tpu/texturing/mask_texture.py``):
zero out the texels that too few views observe.

Every view's UV map marks the 4 texels around each of its valid pixels;
texels marked by at least ``min_fraction`` of the views are kept, the rest
zeroed (the reference's default: 2% of the views). The marks are one
``index_add_`` of unweighted ones per corner, on the CPU or the card: not
K2's function, which weights the corners, so it is plain PyTorch here as
it is plain XLA in the JAX package.

    python -m stylemesh_tpu_torch.texturing.mask_texture --tex tex.png \\
        --root_path R --scene scene0000_00 [--min_fraction 0.02] \\
        [--platform cpu]
"""

import numpy as np
import torch

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.ops import grid_sample


def _splat_counts(uv_grid, mask, tex_h, tex_w):
    """One view: ``[tex_h, tex_w]`` float, 1 where a corner of a valid pixel
    lies. ``uv_grid [H, W, 2]`` in [-1, 1] (x, y); ``mask [H, W, 1]``. The
    corners are those of the bilinear gather (align_corners=True, border
    clamp); their weights are not used."""
    y0, y1, x0, x1, _, _ = grid_sample.corner_indices_weights(
        uv_grid, tex_h, tex_w)
    m = mask[..., 0].reshape(-1)
    flat = torch.zeros((tex_h * tex_w,), dtype=torch.float32,
                       device=uv_grid.device)
    for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
        flat.index_add_(0, (yy * tex_w + xx).reshape(-1), m)
    return (flat > 0).float().reshape(tex_h, tex_w)


def compute_texture_mask(uv_grids, masks, tex_hw, min_fraction=0.02,
                         device=None):
    """Fraction-of-views visibility mask over the atlas.

    Args:
        uv_grids: iterable of [H, W, 2] grids in [-1, 1] (per view; may vary
            in resolution).
        masks: matching [H, W, 1] validity masks.
        tex_hw: (H_tex, W_tex).
        device: where the counts are taken (the card unless the CPU is
            asked for).
    Returns:
        [H_tex, W_tex] numpy bool: texels seen by >= min_fraction of views.
    """
    device = resolve_device(device)
    th, tw = tex_hw
    counts = torch.zeros((th, tw), dtype=torch.float32, device=device)
    n = 0
    for uv, m in zip(uv_grids, masks):
        counts += _splat_counts(
            torch.as_tensor(np.asarray(uv, np.float32)).to(device),
            torch.as_tensor(np.asarray(m, np.float32)).to(device), th, tw)
        n += 1
    return counts.cpu().numpy() >= max(1.0, min_fraction * n)


def mask_texture(texture_img, tex_mask):
    """Apply the visibility mask: unseen texels -> 0 ([H, W, C] * [H, W])."""
    return np.asarray(texture_img) * np.asarray(tex_mask)[..., None]


def main(argv=None):
    """Zero the atlas texels that fewer than ``--min_fraction`` of the
    scene's views observe."""
    import argparse

    from PIL import Image

    from stylemesh_tpu_torch.data.loading import SceneCache
    from stylemesh_tpu_torch.optimize import RunConfig, discover_scene

    p = argparse.ArgumentParser(description="mask unobserved atlas texels")
    p.add_argument("--tex", required=True, help="texture image to mask")
    p.add_argument("--root_path", required=True)
    p.add_argument("--dataset", default="scannet",
                   choices=["scannet", "matterport"])
    p.add_argument("--scene", default="")
    p.add_argument("--out", default=None,
                   help="output path (default <tex>_masked.png)")
    p.add_argument("--min_fraction", type=float, default=0.02)
    p.add_argument("--resize_size", type=int, default=256)
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="'cpu' counts on the CPU; the default is the card")
    a = p.parse_args(argv)
    device = resolve_device("cpu" if a.platform == "cpu" else None)

    run = RunConfig(root_path=a.root_path, dataset=a.dataset, scene=a.scene,
                    min_images=1, resize_size=a.resize_size)
    cache = SceneCache(discover_scene(run), resize_size=a.resize_size)
    b = cache._batch_all
    tex_img = np.asarray(Image.open(a.tex).convert("RGB"))
    uv_top = np.asarray(b.uv[-1])  # highest-res uv level
    # validity straight from the uv grids (background bakes to exactly
    # (-1, -1)); the reference's script also reads only uv maps
    valid = ~((uv_top[..., 0] == -1.0) & (uv_top[..., 1] == -1.0))
    tex_mask = compute_texture_mask(
        [uv_top[v] for v in range(uv_top.shape[0])],
        [valid[v][..., None].astype(np.float32)
         for v in range(uv_top.shape[0])],
        tex_img.shape[:2], min_fraction=a.min_fraction, device=device)
    out = a.out or a.tex.rsplit(".", 1)[0] + "_masked.png"
    masked = mask_texture(tex_img, tex_mask).astype(np.uint8)
    Image.fromarray(masked).save(out)
    print(f"wrote {out} ({int(tex_mask.sum())} visible texels)")


if __name__ == "__main__":
    main()

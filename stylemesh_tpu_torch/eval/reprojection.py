"""Reprojection-consistency evaluation, the paper's Table 1 metric
(counterpart of ``stylemesh_tpu/eval/reprojection.py``).

On top of the packed scene cache: for every frame, warp the styled image of
a paired frame into the current view through depth and poses (4-corner
depth-agreement occlusion masking, ``geometry/project.py``), then
accumulate

- MSE over the masked pixels (global sum of squares over the count, as
  torchmetrics' ``MeanSquaredError`` accumulates), and
- an LPIPS distance over the masked images (summed over the frames),

for three pairings: random (within ±pair_threshold), short (deterministic
±1) and long (deterministic ±10). Pairs are drawn with Python's ``random``
from the seed, so they equal the JAX package's.

The warps and LPIPS run on ``device`` (the card unless the caller asks for
the CPU): per pairing and chunk of ``EVAL_CHUNK`` views one
:func:`reproject` (one K1 launch per view for the colours and one for the
mask) and one LPIPS call per side.
"""

import json
import os
import random
from datetime import datetime
from os.path import join

import numpy as np
import torch

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.data.loading import gatys_pre_np
from stylemesh_tpu_torch.geometry.project import reproject
from stylemesh_tpu_torch.ops.color import gatys_post

EVAL_CHUNK = 8  # views per reproject call and per LPIPS call


def sample_pairs(n, threshold=10, rng=None):
    """Random partner within ±threshold."""
    rng = rng or random
    pairs = []
    for i in range(n):
        start = max(0, i - threshold)
        end = min(n, i + threshold)
        pairs.append(rng.choice([j for j in range(start, end) if j != i]))
    return pairs


def sample_pairs_det(n, threshold=10):
    """Deterministic partner at -threshold (or +threshold at the left
    edge, else the frame itself)."""
    pairs = []
    for i in range(n):
        left, right = i - threshold, i + threshold
        pairs.append(left if left >= 0 else right if right < n else i)
    return pairs


def _load_styled(path, hw):
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if (img.size[1], img.size[0]) != hw:
        img = img.resize((hw[1], hw[0]), Image.Resampling.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


class _MSEAccum:
    """torchmetrics.MeanSquaredError semantics: global Σ(a-b)²/N."""

    def __init__(self):
        self.sq = 0.0
        self.n = 0

    def compute(self):
        return self.sq / max(self.n, 1)


def _tensor(x, device):
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


def eval_reprojection_consistency(scene_cache, styled_dir, out_dir=None,
                                  seed=42, pair_threshold=20,
                                  pair_threshold_short=1,
                                  pair_threshold_long=10, lpips_fn=None,
                                  save_images=True, styled_paths=None,
                                  suffix="", device=None):
    """Returns the metric dict and writes ``<timestamp>_output<suffix>.json``.

    Styled frames are read from ``styled_dir`` as ``<dataset idx>.png`` (the
    output of ``render_styled_frames``) unless explicit ``styled_paths`` are
    given (the standalone folder CLI); rgb, depth and poses come from the
    cache. The metric works in Gatys space like the reference (styled
    images are pre-transformed before the MSE).

    ``save_images`` writes the reference's per-frame diagnostic set: rgb,
    styled, residual, and styled_other / styled_reprojected for all three
    pairings. ``suffix`` tags the output files (multi-style sweeps run one
    eval per style). ``lpips_fn`` runs on its own device.
    """
    device = resolve_device(device)
    b = scene_cache._batch_all
    n = scene_cache.num_views
    hw = b.rgb.shape[1:3]
    out_dir = out_dir or styled_dir
    stamp = datetime.now().strftime("%d.%m.%Y-%H:%M:%S")
    image_dir = join(out_dir, f"eval_image_data_{stamp}{suffix}")
    if save_images:
        os.makedirs(image_dir, exist_ok=True)

    rng = random.Random(seed)
    pairs = sample_pairs(n, pair_threshold, rng)
    short_pairs = sample_pairs_det(n, pair_threshold_short)
    long_pairs = sample_pairs_det(n, pair_threshold_long)

    if styled_paths is None:
        styled_paths = [join(styled_dir, f"{idx}.png")
                        for idx in scene_cache.indices]
    styled_np = np.stack([gatys_pre_np(_load_styled(p, hw))
                          for p in styled_paths])
    styled = _tensor(styled_np, device)
    depth = _tensor(b.depth, device)
    poses = _tensor(b.extrinsics, device)
    intr = _tensor(b.intrinsics, device)

    accums = {"reprojection": _MSEAccum(), "reprojection_short": _MSEAccum(),
              "reprojection_long": _MSEAccum()}
    lpips_sums = {"reprojection_lpips": 0.0, "reprojection_short_lpips": 0.0,
                  "reprojection_long_lpips": 0.0}

    @torch.no_grad()
    def eval_pairing(pair_idx, key):
        j = torch.as_tensor(pair_idx, device=device)
        warped_all, mask_all = [], []
        for c0 in range(0, n, EVAL_CHUNK):
            ii = torch.arange(c0, min(c0 + EVAL_CHUNK, n), device=device)
            jj = j[ii]
            mask_other = (depth[jj] > 0).float()
            warped, mask = reproject(poses[ii], poses[jj], intr[ii],
                                     depth[ii], depth[jj], styled[jj],
                                     mask_other)
            warped_all.append(warped)
            mask_all.append(mask)
        warped = torch.cat(warped_all)
        m3 = torch.cat(mask_all)
        d = (styled - warped) * m3
        accums[key].sq += float(torch.sum(d.double() ** 2))
        accums[key].n += int(m3.sum()) * styled.shape[-1]
        if lpips_fn is not None:
            for c0 in range(0, n, EVAL_CHUNK):
                sl = slice(c0, min(c0 + EVAL_CHUNK, n))
                a01 = gatys_post(styled[sl] * m3[sl])
                b01 = gatys_post(warped[sl] * m3[sl])
                lpips_sums[key + "_lpips"] += float(torch.sum(lpips_fn(a01, b01)))
        return warped.cpu().numpy(), m3[..., 0].cpu().numpy()

    warped_r, mask_r = eval_pairing(pairs, "reprojection")
    warped_s, _ = eval_pairing(short_pairs, "reprojection_short")
    warped_l, _ = eval_pairing(long_pairs, "reprojection_long")

    def save_img(arr_gatys, name):
        from PIL import Image

        img = gatys_post(torch.from_numpy(np.asarray(arr_gatys, np.float32)))
        Image.fromarray((img.numpy() * 255 + 0.5).astype(np.uint8)).save(
            join(image_dir, name))

    if save_images:
        for i in range(n):
            m3 = mask_r[i][..., None]
            save_img(np.abs(styled_np[i] * m3 - warped_r[i] * m3),
                     f"residual_image_{i}.jpg")
            save_img(np.asarray(b.rgb[i]), f"rgb_{i}.jpg")
            save_img(styled_np[i], f"styled_{i}.jpg")
            save_img(styled_np[pairs[i]], f"styled_other_{i}_{pairs[i]}.jpg")
            save_img(warped_r[i], f"styled_reprojected_{i}.jpg")
            save_img(styled_np[short_pairs[i]],
                     f"styled_other_short_{i}_{short_pairs[i]}.jpg")
            save_img(warped_s[i], f"styled_reprojected_short_{i}.jpg")
            save_img(styled_np[long_pairs[i]],
                     f"styled_other_long_{i}_{long_pairs[i]}.jpg")
            save_img(warped_l[i], f"styled_reprojected_long_{i}.jpg")

    results = {
        "number_files": n,
        "date_time": stamp,
        "pairs": pairs,
        "short_pairs": short_pairs,
        "long_pairs": long_pairs,
        "lpips_calibrated": getattr(lpips_fn, "calibrated", None),
        "accuracies": {k: a.compute() for k, a in accums.items()},
    }
    if lpips_fn is not None:
        results["accuracies"].update(lpips_sums)
    with open(join(out_dir, f"{stamp}_output{suffix}.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results

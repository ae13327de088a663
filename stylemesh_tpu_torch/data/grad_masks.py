"""Host-side (numpy) twins of the pipeline's gradient reweighting
(counterpart of ``stylemesh_tpu/data/grad_masks.py``, a copy). The run loop
uses them to find pyramid levels whose gradient is an exact zero
(``optimize.py::view_level_tables``).

The training step multiplies each pyramid level's pixel gradient by
``angle_weight * depth_interp_weight`` (forward-mode equivalents of the
reference's backward hooks, models/pipeline.py:40-76 /
reference model/model.py:195-251). Both weights are functions of the
per-view constants (angle guidance, depth levels, UV mask), so pixels whose
combined weight is exactly zero are known at scene-cache build time.

Everything here is *conservative*: a pixel is marked dead only when the
device computation provably yields an exact 0. The nearest resize and the
erosion replicate ops/resize.resize_nearest and ops/erosion.erode exactly;
the bilinear angle resize is over-approximated by a neighbor union (a
bilinear output is nonzero only if one of its 4 source taps is nonzero).
"""

import numpy as np


def _erode3_np(mask):
    """Exact twin of ops.erosion.erode for 0/1 masks: 3x3 box sum == 9."""
    m = np.asarray(mask, np.float32)
    p = np.pad(m, [(0, 0)] * (m.ndim - 2) + [(1, 1), (1, 1)])
    s = np.zeros_like(m)
    for dy in range(3):
        for dx in range(3):
            s = s + p[..., dy:dy + m.shape[-2], dx:dx + m.shape[-1]]
    return (m > 0) & (s >= 9.0)


def _resize_nearest_np(img, size):
    """Exact twin of ops.resize.resize_nearest (floor index map) for
    ``[..., H, W]`` arrays."""
    h_out, w_out = size
    h_in, w_in = img.shape[-2], img.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        return img
    ys = (np.arange(h_out) * h_in) // h_out
    xs = (np.arange(w_out) * w_in) // w_out
    return img[..., ys, :][..., xs]


def _bilinear_nonzero_np(img, size):
    """Superset of ``resize_bilinear(img, size) != 0`` for img >= 0: an
    output is nonzero only if one of its 4 source taps is nonzero (weights
    are >= 0), so the union of the 4 taps' nonzero-ness over-approximates."""
    h_out, w_out = size
    h_in, w_in = img.shape[-2], img.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        return np.asarray(img) != 0

    def taps(out_size, in_size):
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        src = np.maximum(src, 0.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        return i0, i1

    y0, y1 = taps(h_out, h_in)
    x0, x1 = taps(w_out, w_in)
    nz = np.asarray(img) != 0
    rows = nz[..., y0, :] | nz[..., y1, :]
    return rows[..., x0] | rows[..., x1]


def grad_weight_masks(batch, level_shapes, use_angle_weight,
                      use_depth_scaling):
    """Per-level ``[V, H_i, W_i]`` bool arrays: True where the pixel's
    gradient scale may be nonzero.

    Args:
        batch: a ViewBatch of numpy arrays.
        level_shapes: [(H_i, W_i)] per pyramid level.
    Returns:
        list of masks, or None when no reweighting is active (every pixel's
        gradient may be nonzero).
    """
    if not (use_angle_weight or use_depth_scaling):
        return None
    masks = []
    guidance = np.asarray(batch.angle_guidance)[..., 0]
    mask = np.asarray(batch.mask)[..., 0]
    rounded = np.asarray(batch.rounded_depth_level)[..., 0]
    other = np.asarray(batch.other_depth_level)[..., 0]
    w = np.asarray(batch.depth_level_weight)[..., 0]
    for i, hw in enumerate(level_shapes):
        nz = np.ones((guidance.shape[0],) + tuple(hw), bool)
        if use_angle_weight:
            nz &= _bilinear_nonzero_np(guidance, hw)
        if use_depth_scaling:
            m1 = _erode3_np((rounded == i) & (mask > 0)) & (w > 0)
            m2 = _erode3_np((other == i) & (mask > 0)) & (w < 1)
            nz &= _resize_nearest_np(m1 | m2, hw)
        masks.append(nz)
    return masks

"""Per-pixel depth-level assignment.

Replicates the reference dataset's ``calculate_depth_level``
(``data/scannet_dataset.py:330-366``): each pixel's ideal UV-map height is
``32 * depth / min_depth``; the nearest and second-nearest available pyramid
levels plus an interpolation weight make style features constant world-size.

Vectorized numpy (host-side, run once per scene); a copy of
``stylemesh_tpu/data/depth_level.py`` so the port needs nothing of the JAX
package.
"""

import numpy as np


def calculate_depth_level(depth, levels, min_depth=0.25, min_uv_height=32):
    """Args:
        depth: ``[H, W]`` (or any shape) metric depth.
        levels: sorted 1D array of available UV-map heights (e.g. 256..960).
        min_depth: depth mapped to ``min_uv_height``.
    Returns:
        (continuous_level, rounded_level, other_level, interp_weight), each
        shaped like ``depth``; ``rounded``/``other`` are the nearest and
        2nd-nearest level indices (int), ``interp_weight`` in (0, 1) is the
        weight of the *nearest* level.
    """
    levels = np.asarray(levels, dtype=np.float64)
    n_levels = len(levels)
    depth = np.asarray(depth, dtype=np.float64)

    uv_height = min_uv_height * (depth / min_depth)
    x = uv_height[..., None] - levels  # distance to all levels
    rounded = np.argmin(np.abs(x), axis=-1)
    residues = levels[rounded] - uv_height
    discrete = np.where(residues > 0, -1, 1)
    discrete[residues == 0] = 0
    other = rounded + discrete
    other[other < 0] = 0
    other[other >= n_levels] = n_levels - 1
    height_diff = np.abs(levels[rounded] - levels[other])
    interp = np.abs(residues / (height_diff + 1e-6))
    interp[height_diff == 0] = 0
    interp = 1 - interp
    continuous = np.where(residues > 0, other + interp, other - interp)
    continuous[interp == 1] = rounded[interp == 1]
    return (continuous.astype(np.float32), rounded.astype(np.int32),
            other.astype(np.int32), interp.astype(np.float32))

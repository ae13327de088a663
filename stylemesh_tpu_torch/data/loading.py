"""View loading: files -> ViewBatch arrays, plus a packed per-scene cache
(counterpart of ``stylemesh_tpu/data/loading.py``).

Replicates the reference ``__getitem__`` pixel path, including its exact
resize semantics (PIL bicubic for RGB, cv2 INTER_LINEAR for depth arrays,
cv2 INTER_NEAREST for angle, PIL NEAREST for masks). Everything here is
host-side numpy; Pillow and OpenCV are imported inside :func:`load_view`,
so importing the port needs neither.

:class:`SceneCache` decodes every view of a scene once into packed numpy
arrays; a batch is then a slice, which reaches the card through
``convert.batch_from_numpy``. The JAX package's splat plans
(``attach_splat_plans``) are not carried: the Hopper gather/splat kernels
take no plans.
"""

import dataclasses
from typing import List, Sequence

import numpy as np

from stylemesh_tpu_torch.data.depth_level import calculate_depth_level
from stylemesh_tpu_torch.data.scenes import SceneSpec
from stylemesh_tpu_torch.data.schema import ViewBatch
from stylemesh_tpu_torch.ops.color import _IMAGENET_MEAN_BGR
from stylemesh_tpu_torch.utils.profiling import span


def gatys_pre_np(rgb01):
    """Host-side Gatys preprocessing on a [H, W, 3] RGB [0,1] array."""
    bgr = rgb01[..., ::-1].astype(np.float32)
    mean = np.asarray(_IMAGENET_MEAN_BGR, dtype=np.float32)
    return (bgr - mean) * 255.0


def _resize_size_for(rgb_size, resize_size):
    """int -> height-matched (w, h); tuple passes through (PIL (w,h) order)."""
    if isinstance(resize_size, int):
        w, h = rgb_size
        h_new = resize_size
        w_new = round(w * h_new / h)
        return (w_new, h_new)
    return resize_size


def load_extrinsics(path):
    with open(path) as f:
        rows = [[float(v) for v in line.split(" ")] for line in f if line.strip()]
    return np.asarray(rows, dtype=np.float32)


def rescale_intrinsics(intrinsics, from_size, to_size):
    """Scale the focal lengths and principal point (sizes are (w, h))."""
    if tuple(from_size) == tuple(to_size) or from_size[0] == 0:
        return np.asarray(intrinsics, dtype=np.float32)
    k = np.array(intrinsics, dtype=np.float32)
    k[0, 0] = k[0, 0] / from_size[0] * to_size[0]
    k[1, 1] = k[1, 1] / from_size[1] * to_size[1]
    k[0, 2] = k[0, 2] / from_size[0] * to_size[0]
    k[1, 2] = k[1, 2] / from_size[1] * to_size[1]
    return k


@dataclasses.dataclass
class View:
    """One loaded view, channel-last numpy (pre-batched ViewBatch fields)."""

    rgb: np.ndarray
    uv: List[np.ndarray]
    mask: np.ndarray
    depth: np.ndarray
    rounded_depth_level: np.ndarray
    other_depth_level: np.ndarray
    depth_level_weight: np.ndarray
    depth_level: np.ndarray
    angle_guidance: np.ndarray
    angle_degrees: np.ndarray
    extrinsics: np.ndarray
    intrinsics: np.ndarray
    idx: int


def load_view(spec: SceneSpec, idx: int, resize_size=256) -> View:
    """Load and preprocess one view exactly as the reference __getitem__."""
    import cv2
    from PIL import Image

    rgb_img = Image.open(spec.rgb[idx])
    target = _resize_size_for(rgb_img.size, resize_size)

    # depth (always ends up an ndarray; sensor png / divisor or baked npy)
    if not spec.rendered_depth:
        depth = np.asarray(Image.open(spec.depth[idx])) / spec.depth_divisor
    else:
        depth = np.load(spec.depth[idx])[:, :, 0]
    depth = np.asarray(depth, dtype=np.float32)

    # uv pyramid at native resolutions
    uv_raw = [np.load(spec.uv[level][idx]) for level in range(len(spec.uv))]

    # mask from the highest-res uv map (+ depth gate for ScanNet)
    top = uv_raw[-1]
    mask = (top[:, :, 0] != 0) | (top[:, :, 1] != 0)
    if spec.mask_uses_depth:
        d = cv2.resize(depth, (mask.shape[1], mask.shape[0]),
                       interpolation=cv2.INTER_LINEAR)
        mask = mask & (d > 0)
    mask_img = Image.fromarray(mask)

    angle = np.load(spec.angle[idx])[:, :, :1].astype(np.float32)

    # resizes (reference semantics: PIL bicubic rgb, cv2 linear depth,
    # cv2 nearest angle, PIL nearest mask)
    rgb_img = rgb_img.resize(target, Image.Resampling.BICUBIC)
    depth = cv2.resize(depth, target, interpolation=cv2.INTER_LINEAR)
    angle = cv2.resize(angle, target, interpolation=cv2.INTER_NEAREST)
    mask_img = mask_img.resize(target, Image.Resampling.NEAREST)

    intr = rescale_intrinsics(spec.intrinsics, spec.intrinsics_size, rgb_img.size)
    extr = load_extrinsics(spec.extrinsics[idx])

    cont, rounded, other, weight = calculate_depth_level(
        depth, spec.levels, min_depth=spec.min_pyramid_depth)

    rgb01 = np.asarray(rgb_img, dtype=np.float32) / 255.0
    rgb = gatys_pre_np(rgb01[..., :3])

    uv_grids = [u[..., :2].astype(np.float32) * 2.0 - 1.0 for u in uv_raw]
    mask_np = (np.asarray(mask_img) > 0).astype(np.float32)[..., None]
    cos = np.clip(angle, -1.0, 1.0)
    degrees = np.degrees(np.arccos(cos)).astype(np.float32)

    return View(
        rgb=rgb,
        uv=uv_grids,
        mask=mask_np,
        depth=depth[..., None],
        rounded_depth_level=rounded[..., None].astype(np.float32),
        other_depth_level=other[..., None].astype(np.float32),
        depth_level_weight=weight[..., None],
        depth_level=cont[..., None],
        angle_guidance=cos[..., None],
        angle_degrees=degrees[..., None],
        extrinsics=extr,
        intrinsics=intr,
        idx=idx,
    )


def views_to_batch(views: Sequence[View]) -> ViewBatch:
    num_levels = len(views[0].uv)
    return ViewBatch(
        rgb=np.stack([v.rgb for v in views]),
        uv=tuple(np.stack([v.uv[l] for v in views]) for l in range(num_levels)),
        mask=np.stack([v.mask for v in views]),
        depth=np.stack([v.depth for v in views]),
        rounded_depth_level=np.stack([v.rounded_depth_level for v in views]),
        other_depth_level=np.stack([v.other_depth_level for v in views]),
        depth_level_weight=np.stack([v.depth_level_weight for v in views]),
        angle_guidance=np.stack([v.angle_guidance for v in views]),
        angle_degrees=np.stack([v.angle_degrees for v in views]),
        extrinsics=np.stack([v.extrinsics for v in views]),
        intrinsics=np.stack([v.intrinsics for v in views]),
        idx=np.asarray([v.idx for v in views], dtype=np.int32),
        depth_level=np.stack([v.depth_level for v in views]),
    )


class SceneCache:
    """Pack every view of a scene once; serve batches as array slices."""

    def __init__(self, spec: SceneSpec, resize_size=256, indices=None,
                 verbose=False):
        self.spec = spec
        self.indices = list(range(spec.num_frames)) if indices is None else list(indices)
        views = []
        for i in self.indices:
            views.append(load_view(spec, i, resize_size))
            if verbose and len(views) % 50 == 0:
                print(f"cached {len(views)}/{len(self.indices)} views")
        self._batch_all = views_to_batch(views)
        self._pos_of = {idx: p for p, idx in enumerate(self.indices)}

    @property
    def num_views(self):
        return len(self.indices)

    @property
    def levels(self):
        return self.spec.levels

    def get_batch(self, indices) -> ViewBatch:
        """Batch of dataset indices (positions resolved via the cache), as
        numpy arrays."""
        with span("get_batch"):
            pos = np.asarray([self._pos_of[i] for i in indices],
                             dtype=np.int64)
            b = self._batch_all
            return ViewBatch(*[
                None if f is None else
                tuple(x[pos] for x in f) if isinstance(f, tuple) else f[pos]
                for f in b])

"""Circle-uniformity metric, the paper's Table 2 / Fig. 8 (counterpart of
``stylemesh_tpu/eval/circles.py``).

The scene is styled with a uniform red-circles texture; rendered circles
are detected per frame (HSV red filter -> contours -> convexity filter ->
ellipse fit), and the method's 3-D uniformity is quantified by

- the distribution of circle radii against the per-frame median (4 buckets
  at factor ``t``), in 2-D pixels and in 3-D world units (ellipse
  endpoints unprojected through depth, ``geometry/project.py::unproject``
  on the card unless the CPU is asked for),
- the correlation of radius and depth (a perfectly 3-D-uniform stylization
  has ~0 in 3-D, strongly negative in 2-D pixels), and
- the correlation of ellipse stretch and viewing angle.

The detection is host code (OpenCV, imported where it is used, numpy and
scipy).

    python -m stylemesh_tpu_torch.eval.circles --root_path <scannet_root> \
        --scene scene0000_00 --styled <dir with <idx>.png> [--t 1.5] \
        [--out circles.json] [--debug_dir <dir>] [--platform cpu]
"""

import json
import os
from os.path import join

import numpy as np
import torch
from scipy.spatial import distance as dist

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.geometry.project import unproject


def filter_hsv_red(src_bgr):
    """Keep the two red hue bands (measure_circles.py:25-43)."""
    import cv2

    hsv = cv2.cvtColor(src_bgr, cv2.COLOR_BGR2HSV)
    lower = np.array([0, int(0.6 * 255), int(0.6 * 255)])
    upper = np.array([15, 255, 255])
    mask = cv2.inRange(hsv, lower, upper)
    lower = np.array([160, int(0.4 * 255), int(0.4 * 255)])
    upper = np.array([179, 255, 255])
    mask += cv2.inRange(hsv, lower, upper)
    return cv2.bitwise_and(src_bgr, src_bgr, mask=mask)


def _order_points(pts):
    x_sorted = pts[np.argsort(pts[:, 0]), :]
    left = x_sorted[:2, :][np.argsort(x_sorted[:2, 1]), :]
    right = x_sorted[2:, :]
    tl, bl = left
    d = dist.cdist(tl[np.newaxis], right, "euclidean")[0]
    br, tr = right[np.argsort(d)[::-1], :]
    return tl, tr, br, bl


def _ellipse_stats(a, b):
    radius = (a / 2.0 + b / 2.0) / 2.0
    stretch = abs(a / b) if a > b else abs(b / a)
    return radius, stretch, a * b


def _clamp(p, w, h):
    x, y = int(round(p[0])), int(round(p[1]))
    return max(0, min(x, w - 1)), max(0, min(y, h - 1))


def _in_range(p, w, h):
    x, y = round(p[0]), round(p[1])
    return 0 <= x < w and 0 <= y < h


def _corr_from_lookup(centers, ys, lut, filter_zero=True):
    xs = [float(lut[p[1], p[0], 0]) for p in centers]
    xy = sorted(zip(xs, ys), key=lambda pair: pair[0])
    if filter_zero:
        xy = [i for i in xy if i[0] != 0]
    if len(xy) < 2:
        return float("nan"), [], []
    xs = [i[0] for i in xy]
    ys = [i[1] for i in xy]
    return float(np.corrcoef(np.array([xs, ys]))[0, 1]), xs, ys


def _radius_buckets(radii, t):
    """Per-radius bucket names vs the median (measure_circles.py:130-157) —
    the single source for both the statistics and the debug colors."""
    med = float(np.median(np.asarray(radii))) if len(radii) else 0.0
    out = []
    for r in radii:
        if r < med / t:
            out.append("smallest")
        elif r < med:
            out.append("small")
        elif med < r < med * t:
            out.append("large")
        else:
            out.append("largest")
    return out


def _median_buckets(radii, t, suffix):
    stats = {f"{k}{suffix}": 0 for k in ("smallest", "small", "large", "largest")}
    n = len(radii)
    if n == 0:
        return {k: float("nan") for k in stats}, 0
    for k in _radius_buckets(radii, t):
        stats[f"{k}{suffix}"] += 1
    return {k: v / n for k, v in stats.items()}, n


def detect_ellipses(image_bgr, max_hull_deviation=2.0, max_stretch=10.0,
                    min_size=10.0, max_size=10000.0):
    """HSV red filter -> denoised binary -> contours -> convexity-filtered
    ellipse fits (measure_circles.py:185-290). Returns list of
    (ellipse, radius, stretch)."""
    import cv2

    hsv_filtered = filter_hsv_red(image_bgr)
    gray = cv2.cvtColor(hsv_filtered, cv2.COLOR_BGR2GRAY)
    _, bw = cv2.threshold(gray, 40, 255, cv2.THRESH_BINARY | cv2.THRESH_OTSU)
    bw = cv2.fastNlMeansDenoising(bw, h=100)
    _, bw = cv2.threshold(bw, 40, 255, cv2.THRESH_BINARY | cv2.THRESH_OTSU)
    contours, _ = cv2.findContours(bw, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)

    out = []
    for cnt in contours:
        try:
            hull = cv2.convexHull(cnt, returnPoints=False)
            defects = cv2.convexityDefects(cnt, hull)
            max_dev = 0.0
            if defects is not None and len(defects):
                max_dev = float(np.max(np.asarray(defects).reshape(-1, 4)[:, 3])) / 256.0
            if max_dev > max_hull_deviation:
                continue
            ellipse = cv2.fitEllipse(cnt)
            w, h = ellipse[1]
            if w == 0 or h == 0:
                continue
            radius, stretch, size = _ellipse_stats(w, h)
            if stretch < max_stretch and min_size < size < max_size:
                out.append((ellipse, radius, stretch))
        except cv2.error as e:
            msg = str(e)
            ok = ("-201:Incorrect size of input array" in msg
                  or "The convex hull indices are not monotonous" in msg)
            if not ok:
                raise
    return out


# the reference's BGR bucket coding: blue/green/yellow/purple
_BUCKET_BGR = {"smallest": (255, 0, 0), "small": (0, 255, 0),
               "large": (0, 255, 255), "largest": (255, 0, 255)}


def _bucket_colors(radii, t):
    """Debug colors derived from the SAME bucket assignment the statistics
    report (so the annotated images always visualize the reported
    smallest/small/large/largest fractions)."""
    return [_BUCKET_BGR[k] for k in _radius_buckets(radii, t)]


def measure_frame(image_bgr, depth, angle_degrees, world_coords, t=1.5,
                  debug=False):
    """Per-frame circle statistics (measure_circles.py:185-400).

    Args:
        image_bgr: ``[H, W, 3]`` uint8 styled frame (BGR, cv2 layout).
        depth: ``[H, W, 1]`` metric depth.
        angle_degrees: ``[H, W, 1]`` viewing angle.
        world_coords: ``[H, W, >=3]`` unprojected world points per pixel.
        debug: also return the annotated ellipse image and scatter data —
            the file-saving twin of the reference's interactive verbose mode
            (measure_circles.py:349-400, cv.imshow + plt.scatter), which has
            no display in this headless environment.
    Returns:
        (stats dict, n detected circles), plus a debug dict when ``debug``.
    """
    import cv2

    img_h, img_w = image_bgr.shape[:2]
    depth2 = depth.squeeze()

    detections = detect_ellipses(image_bgr)

    centers, h_edges, v_edges, radii, stretches = [], [], [], [], []
    ellipses = []
    for ellipse, radius, stretch in detections:
        box = cv2.boxPoints(ellipse)
        tl, tr, br, bl = _order_points(box)
        half_tr_br = tr + (br - tr) / 2.0
        half_tl_bl = tl + (bl - tl) / 2.0
        half_tl_tr = tl + (tr - tl) / 2.0
        half_bl_br = bl + (br - bl) / 2.0
        he = _clamp(half_tr_br if _in_range(half_tr_br, img_w, img_h)
                    else half_tl_bl, img_w, img_h)
        ve = _clamp(half_tl_tr if _in_range(half_tl_tr, img_w, img_h)
                    else half_bl_br, img_w, img_h)
        c = _clamp(ellipse[0], img_w, img_h)
        if not all(depth2[p[1], p[0]] > 0 for p in (c, he, ve)):
            continue
        centers.append(c)
        h_edges.append(he)
        v_edges.append(ve)
        radii.append(radius)
        stretches.append(stretch)
        ellipses.append(ellipse)

    # 3D: unproject center + edge midpoints, measure world-space axes
    radii_3d, stretches_3d, centers_3d = [], [], []
    for c, he, ve in zip(centers, h_edges, v_edges):
        cc = world_coords[c[1], c[0], :3]
        a = np.linalg.norm(world_coords[he[1], he[0], :3] - cc)
        b = np.linalg.norm(world_coords[ve[1], ve[0], :3] - cc)
        if a == 0 or b == 0:
            continue
        radius, stretch, _ = _ellipse_stats(a, b)
        radii_3d.append(radius)
        stretches_3d.append(stretch)
        centers_3d.append(c)

    stats, n = _median_buckets(radii, t, "_2D")
    stats3, _ = _median_buckets(radii_3d, t, "_3D")
    stats.update(stats3)

    scatter = {}
    corr, xs, ys = _corr_from_lookup(centers, radii, depth)
    stats["corr_depth_2D"] = corr
    scatter["depth_vs_radius_2D"] = (xs, ys)
    corr, xs, ys = _corr_from_lookup(centers_3d, radii_3d, depth)
    stats["corr_depth_3D"] = corr
    scatter["depth_vs_radius_3D"] = (xs, ys)
    corr, xs, ys = _corr_from_lookup(centers, stretches, angle_degrees)
    stats["corr_angle_2D"] = corr
    scatter["angle_vs_stretch_2D"] = (xs, ys)
    stats["mean_stretch_2D"] = float(np.mean(ys)) if ys else float("nan")
    stats["median_stretch_2D"] = float(np.median(ys)) if ys else float("nan")
    stats["std_stretch_2D"] = float(np.std(ys)) if ys else float("nan")
    corr, xs, ys = _corr_from_lookup(centers_3d, stretches_3d, angle_degrees)
    stats["corr_angle_3D"] = corr
    scatter["angle_vs_stretch_3D"] = (xs, ys)
    stats["mean_stretch_3D"] = float(np.mean(ys)) if ys else float("nan")
    stats["median_stretch_3D"] = float(np.median(ys)) if ys else float("nan")
    stats["std_stretch_3D"] = float(np.std(ys)) if ys else float("nan")
    if not debug:
        return stats, n
    # annotated frame: every kept ellipse drawn in its radius-bucket color,
    # measurement edge points in red (measure_circles.py:364-372)
    canvas = np.ascontiguousarray(image_bgr.copy())
    for ellipse, color, he, ve in zip(ellipses, _bucket_colors(radii, t),
                                      h_edges, v_edges):
        cv2.ellipse(canvas, ellipse, color, thickness=2)
        cv2.circle(canvas, (int(ellipse[0][0]), int(ellipse[0][1])), 1,
                   color, thickness=1)
        cv2.circle(canvas, (int(he[0]), int(he[1])), 1, (0, 0, 255),
                   thickness=2)
        cv2.circle(canvas, (int(ve[0]), int(ve[1])), 1, (0, 0, 255),
                   thickness=2)
    scatter = {k: {"x": [float(x) for x in xs], "y": [float(y) for y in ys]}
               for k, (xs, ys) in scatter.items()}
    return stats, n, {"image": canvas, "scatter": scatter}


def measure_circles_for_scene(scene_cache, styled_dir, t=1.5, out_path=None,
                              debug_dir=None, device=None):
    """Aggregate the per-frame statistics over a scene, weighted by circle
    count. With ``debug_dir``, also saves the per-frame annotated ellipse
    image (``circles_<idx>.png``) and the scatter data behind every
    correlation (``circles_scatter.json``). The world points of each frame
    are unprojected on ``device``."""
    import cv2

    device = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(device)

    b = scene_cache._batch_all
    totals = {}
    n_total = 0
    all_scatter = {}
    if debug_dir:
        os.makedirs(debug_dir, exist_ok=True)
    for p, idx in enumerate(scene_cache.indices):
        img = cv2.imread(join(styled_dir, f"{idx}.png"))
        if img is None:
            continue
        depth = np.asarray(b.depth[p])
        if img.shape[:2] != depth.shape[:2]:
            img = cv2.resize(img, (depth.shape[1], depth.shape[0]))
        coords = unproject(tensor(b.extrinsics[p:p + 1]),
                           tensor(b.intrinsics[p:p + 1]),
                           tensor(depth[None]))[0].cpu().numpy()
        res = measure_frame(img, depth, np.asarray(b.angle_degrees[p]),
                            coords, t=t, debug=bool(debug_dir))
        if debug_dir:
            stats, n, dbg = res
            cv2.imwrite(join(debug_dir, f"circles_{idx}.png"), dbg["image"])
            for k, v in dbg["scatter"].items():
                agg = all_scatter.setdefault(k, {"x": [], "y": []})
                agg["x"] += v["x"]
                agg["y"] += v["y"]
        else:
            stats, n = res
        if n == 0:
            continue
        n_total += n
        for k, v in stats.items():
            if not np.isnan(v):
                totals[k] = totals.get(k, 0.0) + v * n
    result = {k: v / n_total for k, v in totals.items()} if n_total else {}
    result["n_circles"] = n_total
    if debug_dir:
        with open(join(debug_dir, "circles_scatter.json"), "w") as f:
            json.dump(all_scatter, f)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None):
    """The circle-metric CLI: a baked scene and a styled-frame folder."""
    import argparse

    from stylemesh_tpu_torch.data.loading import SceneCache
    from stylemesh_tpu_torch.optimize import RunConfig, discover_scene

    p = argparse.ArgumentParser(description="circle pattern metric")
    p.add_argument("--root_path", required=True)
    p.add_argument("--dataset", default="scannet",
                   choices=["scannet", "matterport"])
    p.add_argument("--scene", default="")
    p.add_argument("--styled", required=True,
                   help="folder of styled frames named <view_idx>.png")
    p.add_argument("--t", type=float, default=1.5,
                   help="median bucket factor (reference opt.t)")
    p.add_argument("--resize_size", type=int, default=256)
    p.add_argument("--min_pyramid_height", type=int, default=32)
    p.add_argument("--out", default=None, help="write result JSON here")
    p.add_argument("--debug_dir", default=None,
                   help="save annotated ellipse images + scatter data here")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="'cpu' unprojects on the CPU; the default is the card")
    a = p.parse_args(argv)
    device = resolve_device("cpu" if a.platform == "cpu" else None)
    run = RunConfig(root_path=a.root_path, dataset=a.dataset, scene=a.scene,
                    min_images=1, resize_size=a.resize_size,
                    min_pyramid_height=a.min_pyramid_height)
    cache = SceneCache(discover_scene(run), resize_size=a.resize_size)
    result = measure_circles_for_scene(cache, a.styled, t=a.t,
                                       out_path=a.out, debug_dir=a.debug_dir,
                                       device=device)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

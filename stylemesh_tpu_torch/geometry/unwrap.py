"""UV unwrapping: a smart-projection atlas generator.

A copy of ``stylemesh_tpu/geometry/unwrap.py`` (the port imports nothing of
the JAX package).

The reference delegates unwrapping to headless Blender
(scripts/scannet/create_uvs.py:98-107 —
``uv.smart_project(angle_limit=1.2217)`` after decimation). This module
provides a built-in equivalent so the framework is self-contained on machines
without Blender, following the same algorithm family as Blender's
``smart_project``:

1. projection groups are grown greedily by face normal with the same
   70-degree ``angle_limit``: the largest-area unassigned face seeds a
   group, every unassigned face within the angle limit joins, and the group
   direction is refined once to the area-weighted mean normal;
2. faces of a group are orthographically projected onto the plane
   perpendicular to the group direction (arbitrary basis, not just the 6
   axis planes);
3. edge-connected islands within a group are PCA-aligned (dominant 2D axis
   horizontal — approximating Blender's pack-with-rotation) and
   shelf-packed into the unit square with margins.

Output is a vertex-split mesh with per-vertex UVs — the same contract as the
Blender export. For byte-identical atlases Blender remains a drop-in
alternative (the baked ``*_uvs_blender.ply`` files load through
:mod:`stylemesh_tpu_torch.geometry.mesh_io`).
"""

import dataclasses
from collections import defaultdict

import numpy as np

from stylemesh_tpu_torch.geometry.mesh_io import Mesh, compute_vertex_normals

# Blender's create_uvs.py angle_limit (radians, ~70 degrees)
ANGLE_LIMIT = 1.2217


def _face_normals_areas(vertices, faces):
    c = np.cross(vertices[faces[:, 1]] - vertices[faces[:, 0]],
                 vertices[faces[:, 2]] - vertices[faces[:, 0]])
    nrm = np.linalg.norm(c, axis=1)
    areas = 0.5 * nrm
    normals = c / np.maximum(nrm, 1e-12)[:, None]
    normals[nrm < 1e-12] = (0.0, 0.0, 1.0)  # degenerate faces -> +Z group
    return normals, areas


def _projection_groups(vertices, faces, angle_limit=ANGLE_LIMIT):
    """Greedy angle-limit clustering of faces by normal (Blender
    smart_project's grouping): seed with the largest unassigned face,
    absorb everything within the limit, refine the direction once to the
    area-weighted mean. Returns (group id per face, group directions)."""
    normals, areas = _face_normals_areas(vertices, faces)
    cos_lim = float(np.cos(angle_limit))
    n_faces = len(faces)
    group_of = np.full(n_faces, -1, np.int64)
    directions = []
    unassigned = np.ones(n_faces, bool)
    while unassigned.any():
        seed = int(np.argmax(np.where(unassigned, areas, -1.0)))
        d = normals[seed]
        sel = unassigned & (normals @ d >= cos_lim)
        # one refinement pass: area-weighted mean normal, re-threshold
        m = (normals[sel] * areas[sel, None]).sum(0)
        mn = np.linalg.norm(m)
        if mn > 1e-12:
            m = m / mn
            sel2 = unassigned & (normals @ m >= cos_lim)
            if sel2.any():
                sel, d = sel2, m
        sel[seed] = True
        group_of[sel] = len(directions)
        directions.append(d)
        unassigned &= ~sel
    return group_of, directions


def _plane_basis(n):
    """Orthonormal (u, v) spanning the plane perpendicular to ``n``."""
    a = np.asarray((0.0, 0.0, 1.0) if abs(n[2]) < 0.9 else (1.0, 0.0, 0.0))
    u = np.cross(a, n)
    u = u / np.linalg.norm(u)
    v = np.cross(n, u)
    return u, v


def _convex_hull(pts):
    """Andrew's monotone chain; pts [n, 2] -> hull vertices CCW."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and np.cross(out[-1] - out[-2],
                                             p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _min_rect_align(pts2):
    """Rotate 2D points into their minimum-area bounding rectangle, wide
    side horizontal (rotating calipers over the convex hull — the exact
    version of Blender's pack-with-rotation bbox shrink). PCA alignment is
    NOT this: on symmetric islands (squares, regular patches) its
    eigenvectors are arbitrary and inflate the bbox by up to sqrt(2)
    (measured: an 8x8 floor packed as an 11.31x11.31 diamond)."""
    flat = pts2.reshape(-1, 2)
    hull = _convex_hull(flat)
    if len(hull) <= 2:
        return pts2
    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    lens = np.linalg.norm(edges, axis=1)
    keep = lens > 1e-12
    if not keep.any():
        return pts2
    dirs = edges[keep] / lens[keep, None]
    # candidate rotations: each hull edge horizontal
    best, best_area = None, np.inf
    for d in dirs:
        rot = np.asarray([[d[0], d[1]], [-d[1], d[0]]])
        h2 = hull @ rot.T
        w, h = h2.max(0) - h2.min(0)
        if w * h < best_area:
            best_area = w * h
            best = rot if w >= h else np.asarray(
                [[-d[1], d[0]], [-d[0], -d[1]]])
    return pts2 @ best.T


def _islands(faces, bins):
    """Edge-connected components of faces within the same bin."""
    edge_to_faces = defaultdict(list)
    for fi, (a, b, c) in enumerate(faces):
        for e in ((a, b), (b, c), (c, a)):
            edge_to_faces[frozenset(e)].append(fi)

    parent = list(range(len(faces)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(x, y):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry

    for fs in edge_to_faces.values():
        for i in range(1, len(fs)):
            if bins[fs[i]] == bins[fs[0]]:
                union(fs[i], fs[0])
    groups = defaultdict(list)
    for fi in range(len(faces)):
        groups[find(fi)].append(fi)
    return list(groups.values())


def smart_project(mesh: Mesh, margin=0.002, angle_limit=ANGLE_LIMIT) -> Mesh:
    """Unwrap ``mesh`` into a packed atlas; returns a mesh with UVs (vertices
    are split so each island owns its corners, like any unwrap seam)."""
    vertices = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int64)
    bins, directions = _projection_groups(vertices, faces, angle_limit)
    islands = _islands(faces, bins)

    # project each island onto its group plane, PCA-align, collect 2D bbox
    proj = []  # (face_ids, uv2 [n_faces, 3, 2])
    for island in islands:
        u, v = _plane_basis(directions[bins[island[0]]])
        tri = vertices[faces[island]]  # [n, 3, 3]
        pts = np.stack([tri @ u, tri @ v], axis=-1)  # [n, 3, 2]
        pts = _min_rect_align(pts)
        mn = pts.reshape(-1, 2).min(0)
        pts = pts - mn
        proj.append((island, pts))

    # shelf packing by descending height at the largest uniform scale that
    # fits the unit square (bisected) — a fixed pre-scale + shrink-to-fit
    # left the atlas' right/top bands empty (measured 23-59% texel
    # utilization on the tools/unwrap_metrics.py fixtures; the search lifts
    # the same fixtures to ~70%+, directly more texels per island at any
    # texture size).
    order = sorted(range(len(proj)),
                   key=lambda i: -proj[i][1].reshape(-1, 2)[:, 1].max())
    sizes = [proj[i][1].reshape(-1, 2).max(0) for i in range(len(proj))]

    def shelf_pack(scale):
        """First-fit-decreasing-height shelf pack at ``scale``; returns
        (offsets, height_used). The margin is kept in absolute UV units (it
        guards texel bleed, so it must not shrink with the islands) and is
        only paid BETWEEN islands — no trailing margin against the atlas
        border, which matters exactly when two halves share a shelf."""
        shelves = []  # [y, height, x_cursor]
        offsets = [None] * len(proj)
        for i in order:
            w, h = sizes[i] * scale
            placed = False
            for s in shelves:
                x0 = s[2] + (margin if s[2] > 0 else 0.0)
                if x0 + w <= 1.0 and h <= s[1] + 1e-12:
                    offsets[i] = (x0, s[0])
                    s[2] = x0 + w
                    placed = True
                    break
            if not placed:
                y = (shelves[-1][0] + shelves[-1][1] + margin) if shelves else 0.0
                shelves.append([y, h, w])
                offsets[i] = (0.0, y)
        if not shelves:
            return offsets, margin
        return offsets, shelves[-1][0] + shelves[-1][1]

    total_area = sum((s[0] + 1e-6) * (s[1] + 1e-6) for s in sizes)
    hi = 1.0 / np.sqrt(total_area)  # >= perfect packing's scale
    widest = max(s[0] for s in sizes) + 1e-12
    hi = min(hi, (1.0 - margin) / widest)  # every island must fit one shelf
    lo = hi * 0.25
    offsets, height_used = shelf_pack(lo)
    if height_used > 1.0:
        hi = lo  # extremely fragmented: fall back to shrink-to-fit below
    else:
        for _ in range(24):
            mid = 0.5 * (lo + hi)
            o, hu = shelf_pack(mid)
            if hu <= 1.0:
                lo, offsets, height_used = mid, o, hu
            else:
                hi = mid
    scale = lo

    # safety normalization (no-op when the bisection fit, which it does for
    # any non-degenerate mesh)
    norm = 1.0 / max(1.0, height_used)

    # emit per-corner uvs -> vertex-split mesh
    n_faces = len(faces)
    new_vertices = np.empty((n_faces * 3, 3), np.float32)
    new_faces = np.arange(n_faces * 3, dtype=np.int32).reshape(n_faces, 3)
    new_uvs = np.empty((n_faces * 3, 2), np.float32)
    src_normals = (mesh.normals if mesh.normals is not None
                   else compute_vertex_normals(vertices, faces))
    new_normals = np.empty((n_faces * 3, 3), np.float32)
    new_colors = (np.empty((n_faces * 3, 3), np.float32)
                  if mesh.colors is not None else None)

    for i, (island, pts) in enumerate(proj):
        ox, oy = offsets[i]
        uv = (pts * scale + np.asarray([ox, oy])) * norm
        for k, fi in enumerate(island):
            for c in range(3):
                vi = faces[fi][c]
                new_vertices[fi * 3 + c] = vertices[vi]
                new_uvs[fi * 3 + c] = uv[k, c]
                new_normals[fi * 3 + c] = src_normals[vi]
                if new_colors is not None:
                    new_colors[fi * 3 + c] = mesh.colors[vi]

    return Mesh(vertices=new_vertices, faces=new_faces, uvs=new_uvs,
                normals=new_normals, colors=new_colors)


def decimate(mesh: Mesh, max_faces: int) -> Mesh:
    """Face-count reduction via vertex clustering (the reference decimates to
    <= 500k faces in Blender before unwrapping, create_uvs.py:81-95). Vertex
    clustering is cruder than Blender's collapse decimation but dependency-
    free; for quality, decimate externally."""
    if len(mesh.faces) <= max_faces:
        return mesh
    v = mesh.vertices
    # binary-search the grid resolution that hits the budget
    lo, hi = 1, 1024
    best = None
    bbox_min, bbox_size = v.min(0), np.maximum(v.max(0) - v.min(0), 1e-6)
    while lo <= hi:
        mid = (lo + hi) // 2
        cell = np.floor((v - bbox_min) / bbox_size * (mid - 1e-4)).astype(np.int64)
        key = (cell[:, 0] * mid + cell[:, 1]) * mid + cell[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        f = inv[mesh.faces]
        keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        n = int(keep.sum())
        if n <= max_faces:
            best = (mid, inv, f[keep])
            lo = mid + 1
        else:
            hi = mid - 1
    if best is None:
        return mesh
    mid, inv, new_faces = best
    # cluster centroid positions
    counts = np.bincount(inv)
    pos = np.zeros((len(counts), 3), np.float64)
    for d in range(3):
        pos[:, d] = np.bincount(inv, weights=v[:, d]) / counts
    out = Mesh(vertices=pos.astype(np.float32),
               faces=new_faces.astype(np.int32), uvs=None, normals=None,
               colors=None)
    return out.with_generated_normals()

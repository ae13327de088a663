"""Software UV/angle/depth rasterizer in PyTorch (counterpart of
``stylemesh_tpu/geometry/rasterize.py``), on the card unless the caller asks
for the CPU.

Given a UV-unwrapped triangle mesh and a posed pinhole camera it bakes, per
pixel, the perspective-correct UV coordinate (background 0), the cosine of
the viewing angle ``max(dot(n̂_view, dir_to_camera), 0)``, the linear
eye-space depth and the mip LOD of the reference's ``uvmap.frag`` — the
output contract of the native C++ rasterizer (``geometry/native.py``).

Design: a brute-force z-buffer over chunks of ``face_chunk`` faces, each a
``[face_chunk, P]`` field of edge functions over all P pixel centres, as the
JAX package scans it. The scan keeps per pixel only the nearest depth and
the face that gave it; the attributes (UV, angle, LOD) are interpolated once
at the end, for the winning face of each pixel, with the arithmetic the
scan would have used for it. ``argmin`` takes the first minimum within a
chunk and a later chunk wins only when strictly closer, so an exact depth
tie goes to the globally first face whatever ``face_chunk`` is. There is no
hand-written kernel behind it: the JAX rasterizer has no ``pallas_call``.

One deviation from the JAX rasterizer: faces are clipped first
(Sutherland-Hodgman, the polygon fan-triangulated) against the near plane
``z = NEAR``, as the native rasterizer and GL do, where the JAX rasterizer
drops every face with a vertex behind the camera, and against a guard band
around the image, as GPU rasterizers do. Indoor meshes have wall, floor and
ceiling triangles that span the camera plane: without the near clip the
demo room's bake loses most of its floor and walls, and without the guard
band the slivers the near clip leaves reach screen coordinates of 10^4 to
10^5 pixels, where float32 edge functions lose the bake's 1e-4 bounds.
Faces inside the band and in front of the plane are rasterized unchanged;
faces wholly outside cover no pixel and are dropped.
"""

import numpy as np
import torch

from stylemesh_tpu_torch import resolve_device

EPS = 1e-9
NEAR = 0.01  # the native rasterizer's near plane (clip_and_raster's znear)
GUARD_BAND = 1.0  # image sizes around the image that faces are clipped to
LOD_TEXTURE_SIZE = 1024.0  # the GL bake's texture: textureQueryLod's scale


def _screen(v, fx, fy, cx, cy):
    """Camera space [..., 3] -> pixel x, y and depth z; +z in front."""
    z = v[..., 2]
    zs = torch.where(z.abs() < EPS, EPS, z)
    return v[..., 0] / zs * fx + cx, v[..., 1] / zs * fy + cy, z


def _edge(px, py, qx, qy, rx, ry):
    """Signed area of (p, q, r), broadcast over faces and pixels."""
    return (qx - px) * (ry - py) - (qy - py) * (rx - px)


def _pixel_centres(hw, like):
    """Pixel centres (x + 0.5, y + 0.5), flattened row-major, on the device
    and in the dtype of ``like``."""
    h, w = hw
    px = torch.arange(w, dtype=like.dtype, device=like.device) + 0.5
    py = torch.arange(h, dtype=like.dtype, device=like.device) + 0.5
    return (px[None, :].expand(h, w).reshape(-1),
            py[:, None].expand(h, w).reshape(-1))


def _depth_scan(face_verts, fx, fy, cx, cy, hw, face_chunk):
    """The z-buffer: per pixel the nearest depth (inf where no face covers
    it) and the index of the face that gave it."""
    pxs, pys = _pixel_centres(hw, face_verts)
    p = pxs.numel()
    zbuf = torch.full_like(pxs, float("inf"))
    face = torch.zeros((p,), dtype=torch.int64, device=pxs.device)
    rx, ry = pxs[None, :], pys[None, :]
    for s in range(0, face_verts.shape[0], face_chunk):
        fv = face_verts[s:s + face_chunk]  # [F, 3, 3]
        sx, sy, z = _screen(fv, fx, fy, cx, cy)  # [F, 3] each
        in_front = (z > EPS).all(dim=1)  # cull faces behind the camera
        ax, bx, cx_ = (sx[:, i:i + 1] for i in range(3))
        ay, by, cy_ = (sy[:, i:i + 1] for i in range(3))
        area = (bx - ax) * (cy_ - ay) - (by - ay) * (cx_ - ax)  # [F, 1]
        w0 = _edge(bx, by, cx_, cy_, rx, ry)  # [F, P]
        w1 = _edge(cx_, cy_, ax, ay, rx, ry)
        w2 = _edge(ax, ay, bx, by, rx, ry)
        # inside for both windings: all edge functions >= 0 (area >= 0) or
        # all <= 0 (area < 0); a NaN fails both, as its comparisons do
        lo = torch.minimum(torch.minimum(w0, w1), w2)
        hi = torch.maximum(torch.maximum(w0, w1), w2)
        inside = torch.where(area >= 0, lo >= 0, hi <= 0)
        del lo, hi
        inside &= (area.abs() > EPS) & in_front[:, None]

        area_safe = torch.where(area.abs() < EPS, 1.0, area)
        # perspective-correct depth: 1 / sum_i (l_i / z_i)
        inv_z = w0.div_(area_safe).div_(z[:, 0:1])
        inv_z += w1.div_(area_safe).div_(z[:, 1:2])
        inv_z += w2.div_(area_safe).div_(z[:, 2:3])
        del w1, w2
        z_pix = torch.where(inv_z.abs() < EPS, EPS, inv_z).reciprocal_()
        del inv_z, w0
        inside &= z_pix > EPS
        z_cand = z_pix.masked_fill_(~inside, float("inf"))
        del inside
        best_f = z_cand.argmin(dim=0)  # the first minimum on ties
        best_z = z_cand.gather(0, best_f[None])[0]
        closer = best_z < zbuf
        zbuf = torch.where(closer, best_z, zbuf)
        face = torch.where(closer, best_f + s, face)
        del z_cand
    return zbuf, face


def _interpolate(fv, fuv, fn, pxs, pys, fx, fy, cx, cy):
    """Attributes of one face per pixel (``fv``/``fuv``/``fn`` ``[P, 3, k]``,
    the pixel's winning face) at the pixel centres: (attributes [P, k], cos
    angle [P], LOD [P]), with the arithmetic of the JAX scan's body."""
    sx, sy, z = _screen(fv, fx, fy, cx, cy)  # [P, 3]
    ax, bx, cx_ = sx.unbind(1)
    ay, by, cy_ = sy.unbind(1)
    w0 = _edge(bx, by, cx_, cy_, pxs, pys)
    w1 = _edge(cx_, cy_, ax, ay, pxs, pys)
    w2 = _edge(ax, ay, bx, by, pxs, pys)
    area = (bx - ax) * (cy_ - ay) - (by - ay) * (cx_ - ax)
    area_safe = torch.where(area.abs() < EPS, 1.0, area)
    l0, l1, l2 = w0 / area_safe, w1 / area_safe, w2 / area_safe
    inv_z = l0 / z[:, 0] + l1 / z[:, 1] + l2 / z[:, 2]
    z_pix = 1.0 / torch.where(inv_z.abs() < EPS, EPS, inv_z)

    def pinterp(attr):  # [P, 3, k] -> [P, k]
        acc = (l0[:, None] * attr[:, 0] / z[:, 0:1]
               + l1[:, None] * attr[:, 1] / z[:, 1:2]
               + l2[:, None] * attr[:, 2] / z[:, 2:3])
        return acc * z_pix[:, None]

    uv_pix = pinterp(fuv)
    n_pix = pinterp(fn)
    pos_pix = pinterp(fv)  # view-space position

    # angle.frag: cos = max(dot(normalize(n), normalize(-pos)), 0)
    def norm(x):
        return torch.sqrt((x * x).sum(-1, keepdim=True))

    n_hat = n_pix / (norm(n_pix) + EPS)
    v_hat = -pos_pix / (norm(pos_pix) + EPS)
    cosang = torch.clamp_min((n_hat * v_hat).sum(-1), 0.0)

    # per-pixel mip LOD (textureQueryLod, uvmap.frag): u = num/den with
    # num = sum_i l_i * u_i/z_i, den = sum_i l_i/z_i; the barycentric l_i
    # are affine in screen space, so the num/den gradients are per-face
    # constants and du/dx = (gnum_x - u * gden_x) * z per pixel, against a
    # 1024^2 texture clamped to its [0, 10] mips
    gl_x = torch.stack([-(cy_ - by), -(ay - cy_)], -1)
    gl_y = torch.stack([cx_ - bx, ax - cx_], -1)
    gl_x = torch.cat([gl_x, -gl_x.sum(-1, keepdim=True)], -1) / area_safe[:, None]
    gl_y = torch.cat([gl_y, -gl_y.sum(-1, keepdim=True)], -1) / area_safe[:, None]
    uv_over_z = fuv[..., :2] / z[..., None]  # [P, 3, 2]
    gnum_x = (gl_x[..., None] * uv_over_z).sum(1)  # [P, 2]
    gnum_y = (gl_y[..., None] * uv_over_z).sum(1)
    gden_x = (gl_x / z).sum(1)  # [P]
    gden_y = (gl_y / z).sum(1)
    duv_dx = ((gnum_x - uv_pix[:, :2] * gden_x[:, None])
              * z_pix[:, None] * LOD_TEXTURE_SIZE)
    duv_dy = ((gnum_y - uv_pix[:, :2] * gden_y[:, None])
              * z_pix[:, None] * LOD_TEXTURE_SIZE)
    rho2 = torch.maximum((duv_dx * duv_dx).sum(-1), (duv_dy * duv_dy).sum(-1))
    lod = torch.clamp(0.5 * torch.log2(torch.clamp_min(rho2, 1e-20)), 0.0, 10.0)
    return uv_pix, cosang, lod


def _clip_polygons(poly, count, dist):
    """One Sutherland-Hodgman pass over polygons ``poly [F, N, D]`` of
    ``count [F]`` vertices (position first) against a plane, ``dist [F, N]``
    the vertices' signed distances (>= 0 kept): walk the edges in order,
    keep each vertex inside and add each edge's crossing, every channel
    interpolated linearly in camera space. Returns ([F, N + 1, D], count)."""
    f, n, d = poly.shape
    i = torch.arange(n, device=poly.device)
    nxt = (i[None, :] + 1) % count.clamp_min(1)[:, None]
    b = poly.gather(1, nxt[..., None].expand(-1, -1, d))
    db = dist.gather(1, nxt)
    valid = i[None, :] < count[:, None]
    a_in, b_in = dist >= 0, db >= 0
    cross = poly + (b - poly) * (dist / (dist - db))[..., None]
    cand = torch.stack([poly, cross], dim=2).reshape(f, 2 * n, d)
    keep = torch.stack([valid & a_in, valid & (a_in != b_in)],
                       dim=2).reshape(f, 2 * n)
    out = poly.new_zeros((f, n + 1, d))
    rows = torch.arange(f, device=poly.device)[:, None].expand(-1, 2 * n)
    out[rows[keep], keep.cumsum(dim=1)[keep] - 1] = cand[keep]
    return out, keep.sum(dim=1)


def _clip_faces(face_verts, attrs_f, normals_f, fx, fy, cx, cy, hw):
    """Clip every face against the near plane ``z = NEAR`` (as the native
    rasterizer's ``clip_and_raster`` and GL do) and the four planes of a
    guard band GUARD_BAND image sizes around the image, and fan-triangulate
    what is left. Faces wholly inside come out as they went in, faces wholly
    outside one plane are dropped (they cover no pixel), and the order is
    kept: a clipped face's triangles stand in the place of the face. The
    guard band bounds the screen coordinates the scan sees, which keeps
    float32 edge functions well conditioned for the slivers a near clip
    leaves (vertices at z = NEAR project 1 / NEAR times farther out)."""
    h, w = hw
    gx, gy = GUARD_BAND * w, GUARD_BAND * h
    k = attrs_f.shape[-1]
    x = torch.cat([face_verts, attrs_f, normals_f], dim=-1)  # [F, 3, D]
    # signed distances, linear in camera space: near, then screen x >= -gx,
    # x <= w + gx, y >= -gy, y <= h + gy (times z, valid for z > 0)
    planes = (lambda q: q[..., 2] - NEAR,
              lambda q: q[..., 0] * fx + (cx + gx) * q[..., 2],
              lambda q: (w + gx - cx) * q[..., 2] - q[..., 0] * fx,
              lambda q: q[..., 1] * fy + (cy + gy) * q[..., 2],
              lambda q: (h + gy - cy) * q[..., 2] - q[..., 1] * fy)
    dist = torch.stack([plane(x) for plane in planes], dim=-1)  # [F, 3, 5]
    inside = (dist >= 0).all(dim=-1).all(dim=-1)
    outside = (dist < 0).all(dim=1).any(dim=-1)
    if bool(inside.all()):
        return face_verts, attrs_f, normals_f
    kept = inside.nonzero()[:, 0]
    todo = (~inside & ~outside).nonzero()[:, 0]
    poly = x[todo]
    count = torch.full((len(todo),), 3, dtype=torch.int64, device=x.device)
    for plane in planes:
        poly, count = _clip_polygons(poly, count, plane(poly))
    # fan (0, j, j + 1) of each polygon
    j = torch.arange(1, poly.shape[1] - 1, device=x.device)
    tris = torch.stack([poly[:, [0] * len(j)], poly[:, j], poly[:, j + 1]],
                       dim=2)  # [G, J, 3, D]
    live = j[None, :] + 1 < count[:, None]
    stride = poly.shape[1]
    keys = torch.cat([kept * stride,
                      (todo[:, None] * stride + j[None, :])[live]])
    tris = torch.cat([x[kept], tris[live]])[keys.argsort()]
    return tris[..., :3], tris[..., 3:3 + k], tris[..., 3 + k:]


@torch.no_grad()
def _rasterize_impl(face_verts, attrs_f, normals_f, fx, fy, cx, cy, hw,
                    face_chunk):
    """(attributes [H, W, k], cos angle [H, W], depth [H, W], hit [H, W],
    LOD [H, W]) of faces given in camera space, on their device and in
    their dtype (float32 from the entry points)."""
    h, w = hw
    face_verts, attrs_f, normals_f = _clip_faces(face_verts, attrs_f,
                                                 normals_f, fx, fy, cx, cy, hw)
    zbuf, face = _depth_scan(face_verts, fx, fy, cx, cy, hw, face_chunk)
    hit = torch.isfinite(zbuf)
    pxs, pys = _pixel_centres(hw, face_verts)
    idx = face[hit]
    attr, ang, lod = _interpolate(face_verts[idx], attrs_f[idx], normals_f[idx],
                                  pxs[hit], pys[hit], fx, fy, cx, cy)
    n_attr = attrs_f.shape[-1]
    attr_out = zbuf.new_zeros((h * w, n_attr))
    ang_out = zbuf.new_zeros((h * w,))
    lod_out = zbuf.new_zeros((h * w,))
    attr_out[hit] = attr
    ang_out[hit] = ang
    lod_out[hit] = lod
    depth = torch.where(hit, zbuf, 0.0)
    return (attr_out.reshape(h, w, n_attr), ang_out.reshape(h, w),
            depth.reshape(h, w), hit.reshape(h, w), lod_out.reshape(h, w))


def _camera_faces(vertices, faces, attrs, normals, cam2world, device):
    """Per-face corners in camera space, per-face attributes and normals on
    ``device`` (float32); the transform on the host, as the JAX package
    does it."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    normals = np.asarray(normals, np.float32)
    world2cam = np.linalg.inv(np.asarray(cam2world, np.float32))
    r, t = world2cam[:3, :3], world2cam[:3, 3]
    verts_cam = vertices @ r.T + t
    normals_cam = normals @ r.T  # rotation only (rigid transform)

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    return put(verts_cam[faces]), put(attrs[faces]), put(normals_cam[faces])


def _check_chunk(face_chunk):
    if int(face_chunk) < 1:
        raise ValueError(f"face_chunk must be positive, got {face_chunk}")
    return int(face_chunk)


def rasterize_mesh(vertices, faces, uvs, normals, cam2world, intrinsics, hw,
                   face_chunk=256, device=None):
    """Rasterize one view; returns (uv [H,W,2], cos_angle [H,W],
    depth [H,W], hit_mask [H,W], lod [H,W]) as float32 (hit: bool) tensors
    on ``device`` (default CUDA, see :func:`resolve_device`).

    Args:
        vertices: ``[Nv, 3]`` world-space positions.
        faces: ``[Nf, 3]`` int vertex indices.
        uvs: ``[Nv, 2]`` texture coordinates in [0, 1].
        normals: ``[Nv, 3]`` vertex normals (world space).
        cam2world: ``[4, 4]`` camera-to-world pose (ScanNet convention).
        intrinsics: ``[3+, 3+]`` pinhole K (fx, fy, cx, cy used).
        hw: output (height, width).
        face_chunk: faces per step of the scan; the result does not depend
            on it, the peak memory grows with it.
    """
    device = resolve_device(device)
    k = np.asarray(intrinsics, np.float32)
    fv, fuv, fn = _camera_faces(vertices, faces,
                                np.asarray(uvs, np.float32), normals,
                                cam2world, device)
    return _rasterize_impl(fv, fuv, fn, float(k[0, 0]), float(k[1, 1]),
                           float(k[0, 2]), float(k[1, 2]), tuple(hw),
                           _check_chunk(face_chunk))


def render_vertex_colors(vertices, faces, colors, normals, cam2world,
                         intrinsics, hw, face_chunk=256, return_depth=False,
                         device=None):
    """Twin of the reference's vertex_color shader mode
    (scripts/scannet/render_uv/shader/vertex_color.frag, ``mesh_colors``
    flag src/main.cpp:77-78; Matterport color3D.frag): perspective-correct
    interpolated per-vertex colours, fully opaque, no shading.

    ``colors``: ``[Nv, 3]`` in [0, 1]. Returns an ``[H, W, 3]`` float32
    tensor on ``device`` (background 0), plus the linear eye-depth map when
    ``return_depth``. The colours ride attribute channels 2:5 beside two
    unused UV channels, as in the JAX package."""
    device = resolve_device(device)
    colors = np.asarray(colors, np.float32)
    attrs = np.concatenate(
        [np.zeros((len(colors), 2), np.float32), colors], axis=-1)
    k = np.asarray(intrinsics, np.float32)
    fv, fattr, fn = _camera_faces(vertices, faces, attrs, normals, cam2world,
                                  device)
    out, _, depth, hit, _ = _rasterize_impl(
        fv, fattr, fn, float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
        float(k[1, 2]), tuple(hw), _check_chunk(face_chunk))
    rgb = torch.clamp(out[..., 2:5], 0.0, 1.0) * hit[..., None]
    return (rgb, depth) if return_depth else rgb

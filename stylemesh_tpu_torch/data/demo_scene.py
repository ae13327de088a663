"""Synthetic "room" scene builder in ScanNet layout (counterpart of
``stylemesh_tpu/data/demo_scene.py``).

An inward-facing box room (6 UV islands in one atlas), an interior camera
orbit, procedurally textured color frames rendered with the native mip
renderer, and the full baked uv/angle/depth pyramid (``preprocess.py::
bake_scene``, native backend) — everything a ``--preset scannet_full`` run
needs, with no real data. ``chip_smoke.py`` trains the bench step and the
no-pretrained-weights quality gates (``tests/test_torch_quality_gates.py``)
on it; with ``shading=False`` the ground-truth texture is the exact global
optimum of a content-only reconstruction.

The reference ships no synthetic scene; this stands in for a ScanNet scan
(directory layout of data/scannet/scannet_single.py) so the whole stack
runs hermetically. It is host code: numpy, the native library and PIL.
"""

import os
from os.path import join

import numpy as np

from stylemesh_tpu_torch.geometry.mesh_io import (
    Mesh,
    compute_vertex_normals,
    save_ply,
)
from stylemesh_tpu_torch.geometry.native import render_textured_native
from stylemesh_tpu_torch.geometry.trajectories import orbit_poses, write_pose_dir
from stylemesh_tpu_torch.preprocess import bake_scene


def room_mesh(w=8.0, d=8.0, h=3.0):
    """Inward-facing box; each wall is its own UV island in a 3x2 atlas."""
    quads = [
        # (corner0..corner3 CCW seen from inside, island (col,row))
        ([(0, 0, 0), (w, 0, 0), (w, 0, h), (0, 0, h)], (0, 0)),   # front y=0
        ([(w, d, 0), (0, d, 0), (0, d, h), (w, d, h)], (1, 0)),   # back  y=d
        ([(0, d, 0), (0, 0, 0), (0, 0, h), (0, d, h)], (2, 0)),   # left  x=0
        ([(w, 0, 0), (w, d, 0), (w, d, h), (w, 0, h)], (0, 1)),   # right x=w
        ([(0, 0, 0), (0, d, 0), (w, d, 0), (w, 0, 0)], (1, 1)),   # floor
        ([(0, 0, h), (w, 0, h), (w, d, h), (0, d, h)], (2, 1)),   # ceiling
    ]
    verts, uvs, faces = [], [], []
    iw, ih = 1.0 / 3, 1.0 / 2
    inset = 0.01
    for corners, (cx, cy) in quads:
        b = len(verts)
        u0, v0 = cx * iw + inset, cy * ih + inset
        u1, v1 = (cx + 1) * iw - inset, (cy + 1) * ih - inset
        verts += corners
        uvs += [(u0, v0), (u1, v0), (u1, v1), (u0, v1)]
        faces += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    uvs = np.asarray(uvs, np.float32)
    normals = compute_vertex_normals(verts, faces)
    # normals must face inward (toward the room center) for shading/angles
    center = np.array([w / 2, d / 2, h / 2], np.float32)
    flip = np.sum(normals * (center - verts), axis=1) < 0
    normals[flip] *= -1
    return Mesh(vertices=verts, faces=faces, uvs=uvs, normals=normals)


def demo_texture(size=1024, seed=0):
    """Structured content: colored gradient + checker + blobs (something for
    the content loss to hold on to)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    tex = np.stack([0.55 + 0.35 * np.sin(6.28 * (x + 0.1)),
                    0.5 + 0.3 * np.cos(6.28 * (y * 2)),
                    0.45 + 0.4 * np.sin(6.28 * (x + y))], axis=-1)
    checker = ((x * 24).astype(int) + (y * 24).astype(int)) % 2
    tex *= (0.75 + 0.25 * checker[..., None])
    for _ in range(40):  # blobs
        cx, cy, r = rng.random(), rng.random(), 0.02 + 0.05 * rng.random()
        m = ((x - cx) ** 2 + (y - cy) ** 2) < r * r
        tex[m] = rng.random(3) * 0.9 + 0.05
    return np.clip(tex, 0, 1).astype(np.float32)


def circle_texture(size=1024, radius_px=None, spacing_px=None,
                   bg=(0.82, 0.82, 0.82), fg=(0.85, 0.05, 0.05)):
    """A grid of red circles on light gray — the texture-space analogue of
    the reference's uniformity probe style
    (styles/simple_shapes/circles_uniform_small.png, used by
    scripts/eval/measure_circles.py:114-162). Painted in TEXTURE space, the
    circles are uniform in 3D/world space by construction: rendered frames
    must show 3D radii independent of depth (the paper's Tab. 2 "full
    method" signature)."""
    radius_px = radius_px or max(3, size // 40)
    spacing_px = spacing_px or radius_px * 4
    tex = np.empty((size, size, 3), np.float32)
    tex[:] = bg
    y, x = np.mgrid[0:size, 0:size]
    cy = (y + spacing_px // 2) % spacing_px - spacing_px // 2
    cx = (x + spacing_px // 2) % spacing_px - spacing_px // 2
    m = cy * cy + cx * cx <= radius_px * radius_px
    tex[m] = fg
    return tex


def paint_screen_circles(img, radius_px, spacing_px,
                         fg=(0.85, 0.05, 0.05)):
    """Composite a grid of constant-PIXEL-radius red circles onto a rendered
    view — what a per-view 2D stylization would produce (the paper's
    "only 2D" baseline): uniform in screen space, so their world size grows
    with depth and the 3D radii correlate positively with depth."""
    h, w = img.shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    cy = (y + spacing_px // 2) % spacing_px - spacing_px // 2
    cx = (x + spacing_px // 2) % spacing_px - spacing_px // 2
    m = cy * cy + cx * cx <= radius_px * radius_px
    out = img.copy()
    out[m] = fg
    return out


def build_demo_scene(out_root, n_views=24, pyramid_heights=None,
                     view_hw=(480, 640), texture=None, shading=True,
                     scene_name="scene0900_00", orbit_radius=1.2,
                     orbit_center=(2.0, 2.0, 1.4), frame_hook=None,
                     verbose=True):
    """Build + bake a complete ScanNet-layout scene; returns the scene dir.

    Args:
        texture: [S, S, 3] float texture to render content frames from
            (default :func:`demo_texture`).
        shading: lambertian shading on content frames. ``False`` makes the
            content view-independent, so ``texture`` is the exact optimum of
            a pixel-reproduction objective (the quality-gate setting).
        frame_hook: optional ``f(i, img, depth) -> img`` applied to each
            rendered content frame before saving (e.g.
            :func:`paint_screen_circles` for the only-2D baseline arm).
    """
    scene = join(out_root, "train", "images", scene_name)
    os.makedirs(join(scene, "color"), exist_ok=True)

    mesh = room_mesh()
    mesh_path = join(out_root, "room_uvs_blender.ply")
    save_ply(mesh, mesh_path)

    h, w = view_hw
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = k[1, 1] = 580.0 * w / 1296  # ScanNet-ish intrinsics at 640
    k[0, 2], k[1, 2] = w / 2.0, h / 2.0
    with open(join(scene, f"{scene_name}.txt"), "w") as f:
        f.write(f"fx_color = {k[0,0]}\nfy_color = {k[1,1]}\n"
                f"mx_color = {k[0,2]}\nmy_color = {k[1,2]}\n"
                f"colorWidth = {w}\ncolorHeight = {h}\n")

    # off-center orbit in an 8 x 8 m room: wall distances span ~0.9..7.5 m,
    # so the depth-scaling levels 256..784 (uv_height = 128 * depth) all get
    # live pixels — like a real room scan
    poses = orbit_poses(center=orbit_center, radius=orbit_radius, height=0.0,
                        n=n_views)
    write_pose_dir(poses, join(scene, "pose"))

    if texture is None:
        texture = demo_texture()
    from PIL import Image

    for i, pose in enumerate(poses):
        img = render_textured_native(mesh.vertices, mesh.faces, mesh.uvs,
                                     mesh.normals, pose, k, (h, w), texture,
                                     shading=shading)
        if frame_hook is not None:
            from stylemesh_tpu_torch.geometry.native import rasterize_mesh_native

            _, _, depth, _, _ = rasterize_mesh_native(
                mesh.vertices, mesh.faces, mesh.uvs, mesh.normals, pose, k,
                (h, w))
            img = frame_hook(i, img, depth)
        Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
                        ).save(join(scene, "color", f"{i}.jpg"))

    bake_kw = {} if pyramid_heights is None else {
        "pyramid_heights": tuple(pyramid_heights)}
    n = bake_scene(mesh_path, join(scene, "pose"), k, (w, h), scene,
                   base_hw=(h, w), verbose=verbose, **bake_kw)
    if verbose:
        print(f"demo scene: {scene} ({n} views baked)")
    return scene

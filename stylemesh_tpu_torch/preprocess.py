"""Offline preprocessing: bake per-view UV / angle / depth maps for a scene
(counterpart of ``stylemesh_tpu/preprocess.py``).

The replacement of the reference's render pipeline
(scripts/scannet/render_uvs.py + the render_uv C++/OpenGL executables):
given a UV-unwrapped mesh and per-frame poses, it writes the on-disk
contract the data layer (and the reference) consumes:

    <scene>/uv/<id>.npy                 [H, W, 3]  (u, v, mip LOD)
    <scene>/uv/<id>.angle.npy           [H, W, 3]  cos angle replicated
    <scene>/uv/<id>.rendered_depth.npy  [H, W, 3]  linear depth replicated
    <scene>/uv_<height>/<id>.npy        pyramid levels (5 heights 256..960)

Rasterization backends (``backend``):

- ``"native"`` (the default): the C++ rasterizer of ``native/``, host code,
  built by the port's own loader (``geometry/native.py``);
- ``"torch"``: the PyTorch rasterizer (``geometry/rasterize.py``) on
  ``device``, the card unless the caller asks for the CPU.

Neither falls back to the other: a native build or load failure raises, and
any other backend name is a ``ValueError``.

Blender's smart-UV unwrap stays an external step, as in the reference
(``create_uvs.py`` has a built-in stand-in); this module consumes its
``*_uvs_blender.ply`` output.

    python -m stylemesh_tpu_torch.preprocess bake --mesh m.ply --scene_dir S \\
        [--backend torch [--platform cpu]]
"""

import os
from os.path import exists, join

import numpy as np

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.data.loading import load_extrinsics, rescale_intrinsics
from stylemesh_tpu_torch.geometry.mesh_io import load_mesh

# the reference's pyramid heights: linspace(256, 960, 5)
DEFAULT_PYRAMID_HEIGHTS = (256, 432, 608, 784, 960)
BACKENDS = ("native", "torch")


def _check_backend(backend, device):
    """Raise on an unknown backend; the torch backend's device, resolved
    (raises without CUDA unless the CPU is asked for)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown rasterizer backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    return resolve_device(device) if backend == "torch" else None


def _rasterize(mesh, cam2world, intrinsics, hw, backend="native", device=None):
    device = _check_backend(backend, device)
    if backend == "native":
        from stylemesh_tpu_torch.geometry.native import rasterize_mesh_native

        return rasterize_mesh_native(mesh.vertices, mesh.faces, mesh.uvs,
                                     mesh.normals, cam2world, intrinsics, hw)
    from stylemesh_tpu_torch.geometry.rasterize import rasterize_mesh

    out = rasterize_mesh(mesh.vertices, mesh.faces, mesh.uvs, mesh.normals,
                         cam2world, intrinsics, hw, device=device)
    return tuple(x.cpu().numpy() for x in out)


def bake_view(mesh, cam2world, intrinsics, hw, backend="native", device=None):
    """One view -> (uv3 [H,W,3], angle3 [H,W,3], depth3 [H,W,3]).

    uv3's third channel is the real baked mip LOD (uvmap.frag writes
    textureQueryLod there; training discards it, the mip renderer uses it).
    ``device`` serves the torch backend only."""
    uv, ang, depth, _, lod = _rasterize(mesh, cam2world, intrinsics, hw,
                                        backend, device)
    uv3 = np.concatenate([uv, lod[..., None]], axis=-1)
    ang3 = np.repeat(ang[..., None], 3, axis=-1)
    depth3 = np.repeat(depth[..., None], 3, axis=-1)
    return uv3.astype(np.float32), ang3.astype(np.float32), depth3.astype(np.float32)


def _pose_files(pose_dir, frame_ids):
    pose_files = sorted(
        (f for f in os.listdir(pose_dir) if f.endswith(".txt")),
        key=lambda x: int(x.split(".")[0]))
    if frame_ids is not None:
        wanted = {str(i) for i in frame_ids}
        pose_files = [f for f in pose_files if f.split(".")[0] in wanted]
    return pose_files


def _require_uvs(mesh, mesh_path):
    if mesh.uvs is None:
        raise ValueError(f"mesh {mesh_path} has no UVs (run unwrap first)")


def bake_scene(mesh_path, pose_dir, intrinsics, intrinsics_size, out_dir,
               base_hw=(960, 1280), pyramid_heights=DEFAULT_PYRAMID_HEIGHTS,
               aspect=None, backend="native", skip_existing=True,
               frame_ids=None, verbose=True, device=None):
    """Bake a whole scene (render_uvs.py semantics: idempotent per folder).

    Args:
        mesh_path: UV-unwrapped mesh (.ply / .obj).
        pose_dir: directory of ``<id>.txt`` 4x4 cam2world poses.
        intrinsics: [3+,3+] K at ``intrinsics_size`` (w, h).
        out_dir: scene directory to fill with uv/ and uv_<h>/ folders.
        base_hw: resolution of the base uv/angle/depth folder.
        pyramid_heights: heights of the uv_<h> pyramid; widths follow
            ``aspect`` (default base_hw ratio — reference: 1280/960).
        backend: ``"native"`` or ``"torch"`` (on ``device``).
    Returns:
        the number of views with a finite pose.
    """
    device = _check_backend(backend, device)
    mesh = load_mesh(mesh_path)
    _require_uvs(mesh, mesh_path)
    if aspect is None:
        aspect = base_hw[1] / base_hw[0]
    pose_files = _pose_files(pose_dir, frame_ids)

    base_dir = join(out_dir, "uv")
    os.makedirs(base_dir, exist_ok=True)
    level_dirs = []
    for height in pyramid_heights:
        d = join(out_dir, f"uv_{height}")
        os.makedirs(d, exist_ok=True)
        level_dirs.append((height, d))

    n_baked = 0
    for pf in pose_files:
        frame = pf.split(".")[0]
        cam2world = load_extrinsics(join(pose_dir, pf))
        if not np.all(np.isfinite(cam2world)):
            continue  # ScanNet has -inf poses for untracked frames

        targets = [(base_hw, join(base_dir, f"{frame}.npy"), True)]
        for height, d in level_dirs:
            hw = (height, int(height * aspect))
            targets.append((hw, join(d, f"{frame}.npy"), False))

        for hw, uv_path, is_base in targets:
            if skip_existing and exists(uv_path):
                continue
            k = rescale_intrinsics(intrinsics, intrinsics_size, (hw[1], hw[0]))
            uv3, ang3, depth3 = bake_view(mesh, cam2world, k, hw, backend,
                                          device)
            np.save(uv_path, uv3)
            if is_base:
                np.save(uv_path.replace(".npy", ".angle.npy"), ang3)
                np.save(uv_path.replace(".npy", ".rendered_depth.npy"), depth3)
        n_baked += 1
        if verbose and n_baked % 25 == 0:
            print(f"baked {n_baked}/{len(pose_files)} views")
    return n_baked


def bake_matterport_region(house, mesh_path, scan_out_dir, region_index,
                           color_src=None, depth_src=None,
                           pyramid_heights=DEFAULT_PYRAMID_HEIGHTS,
                           backend="native", skip_existing=True,
                           verbose=True, device=None):
    """Bake one Matterport region into the tree the data layer (and the
    reference's MatterportDataset) consumes, the replacement of
    ``scripts/matterport/render_uv`` (main.cpp:100-157 + mp_renderer.cpp:
    87-180): walk the ``.house`` region's panoramas/images, export per-image
    pose + ``.intrinsics.txt``, copy color/depth, and render uv / angle /
    rendered_depth::

        <scan>/rendered/region_<r>/pose/<img>.jpg.pose.txt            4x4
        <scan>/rendered/region_<r>/pose/<img>.jpg.pose.txt.intrinsics.txt
        <scan>/rendered/region_<r>/color/<img>.jpg                    copied
        <scan>/rendered/region_<r>/depth/<img d>.png                  copied
        <scan>/rendered/region_<r>/angle/<img>.jpg.angle.npy          [H,W,3]
        <scan>/rendered/region_<r>/rendered_depth/<img>.jpg.rendered_depth.npy
        <scan>/rendered/region_<r>/uv_-1_<h>/<img>.jpg.uvs.npy        per level

    Args:
        house: an ``MPHouse`` (data/matterport_house.py) or a ``.house``
            path. Image extrinsics are taken as CAMERA-TO-WORLD with a
            +z-forward pinhole (the convention of this repo's rasterizers
            and of the pose files the eval chain unprojects with).
        mesh_path: the region's UV-unwrapped mesh (``region_<r>.ply`` after
            unwrap).
        color_src/depth_src: directories holding the original
            ``matterport_color_images`` / ``matterport_depth_images`` to
            copy per region (reference copyImages, mp_renderer.cpp:150-180);
            missing sources are skipped (the loader falls back to
            rendered_depth).
        pyramid_heights: UV pyramid heights; widths follow each image's
            aspect (reference renders with w=-1, hence the ``uv_-1_<h>``
            folder names).
        backend: ``"native"`` or ``"torch"`` (on ``device``).
    Returns:
        number of baked images.
    """
    import shutil

    from stylemesh_tpu_torch.data.matterport_house import parse_house

    device = _check_backend(backend, device)
    if isinstance(house, (str, os.PathLike)):
        house = parse_house(house)
    mesh = load_mesh(mesh_path)
    _require_uvs(mesh, mesh_path)

    region_dir = join(scan_out_dir, "rendered", f"region_{region_index}")
    dirs = {k: join(region_dir, k)
            for k in ("pose", "color", "depth", "angle", "rendered_depth")}
    for h in pyramid_heights:
        dirs[f"uv_{h}"] = join(region_dir, f"uv_-1_{h}")
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    images = house.region_images(region_index)
    n_baked = 0
    for img in images:
        cname = img.color_filename
        # pose (+ original intrinsics, reference saves them per image)
        pose_path = join(dirs["pose"], f"{cname}.pose.txt")
        if not (skip_existing and exists(pose_path)):
            with open(pose_path, "w") as f:
                for row in np.asarray(img.extrinsics, np.float64):
                    f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
            with open(pose_path + ".intrinsics.txt", "w") as f:
                for row in np.asarray(img.intrinsics, np.float64):
                    f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
                f.write(f"{img.width} {img.height}\n")

        # copy originals when available
        for src_root, fname, key in ((color_src, cname, "color"),
                                     (depth_src, img.depth_filename, "depth")):
            if src_root:
                src = join(src_root, fname)
                dst = join(dirs[key], fname)
                if exists(src) and not exists(dst):
                    shutil.copyfile(src, dst)

        cam2world = np.asarray(img.extrinsics, np.float64)
        if not np.all(np.isfinite(cam2world)):
            continue
        aspect = img.width / img.height

        # base resolution: angle + rendered_depth (the loss/mask inputs)
        ang_path = join(dirs["angle"], f"{cname}.angle.npy")
        dep_path = join(dirs["rendered_depth"], f"{cname}.rendered_depth.npy")
        if not (skip_existing and exists(ang_path) and exists(dep_path)):
            _, ang3, depth3 = bake_view(mesh, cam2world, img.intrinsics,
                                        (img.height, img.width), backend,
                                        device)
            np.save(ang_path, ang3)
            np.save(dep_path, depth3)

        # uv pyramid (per-image K rescaled per level, mp_renderer.cpp:99-110)
        for h in pyramid_heights:
            uv_path = join(dirs[f"uv_{h}"], f"{cname}.uvs.npy")
            if skip_existing and exists(uv_path):
                continue
            hw = (h, int(h * aspect))
            k = rescale_intrinsics(img.intrinsics, (img.width, img.height),
                                   (hw[1], hw[0]))
            uv3, _, _ = bake_view(mesh, cam2world, k, hw, backend, device)
            np.save(uv_path, uv3)
        n_baked += 1
        if verbose and n_baked % 10 == 0:
            print(f"baked {n_baked}/{len(images)} region images")
    return n_baked


def _save_frame(img, path):
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)).save(path)


def render_mipmap_frames(mesh_path, pose_dir, intrinsics, intrinsics_size,
                         texture_rgb01, out_dir, hw=(480, 640), shading=True,
                         frame_ids=None):
    """Post-train textured render of every pose with the trained texture —
    the ``render_mipmap_{scannet,matterport}`` equivalent (native trilinear
    mipmap render + ambient/diffuse shading like the reference's rgb.frag)."""
    from stylemesh_tpu_torch.geometry.native import render_textured_native

    mesh = load_mesh(mesh_path)
    _require_uvs(mesh, mesh_path)
    os.makedirs(out_dir, exist_ok=True)
    k = rescale_intrinsics(intrinsics, intrinsics_size, (hw[1], hw[0]))
    paths = []
    for pf in _pose_files(pose_dir, frame_ids):
        frame = pf.split(".")[0]
        cam2world = load_extrinsics(join(pose_dir, pf))
        if not np.all(np.isfinite(cam2world)):
            continue
        img = render_textured_native(mesh.vertices, mesh.faces, mesh.uvs,
                                     mesh.normals, cam2world, k, hw,
                                     texture_rgb01, shading=shading)
        path = join(out_dir, f"{frame}.png")
        _save_frame(img, path)
        paths.append(path)
    return paths


def render_vertex_color_frames(mesh_path, pose_dir, intrinsics,
                               intrinsics_size, colors, out_dir,
                               hw=(480, 640), frame_ids=None):
    """Render every pose with interpolated per-vertex colours — the
    reference's ``mesh_colors`` render mode
    (scripts/scannet/render_uv/src/main.cpp:77-78, shader
    vertex_color.frag; Matterport color3D.frag). The output path for
    segmentation-recolour and mesh-edit demos: pass a [Nv, 3] colour array,
    e.g. a palette indexed by SegmentationProvider object ids."""
    from stylemesh_tpu_torch.geometry.native import render_vertex_colors_native

    mesh = load_mesh(mesh_path)
    colors = np.asarray(colors, np.float32)
    if len(colors) != len(mesh.vertices):
        raise ValueError(f"colors {len(colors)} != vertices "
                         f"{len(mesh.vertices)}")
    os.makedirs(out_dir, exist_ok=True)
    k = rescale_intrinsics(intrinsics, intrinsics_size, (hw[1], hw[0]))
    paths = []
    for pf in _pose_files(pose_dir, frame_ids):
        frame = pf.split(".")[0]
        cam2world = load_extrinsics(join(pose_dir, pf))
        if not np.all(np.isfinite(cam2world)):
            continue
        img = render_vertex_colors_native(
            mesh.vertices, mesh.faces, colors, mesh.normals, cam2world, k, hw)
        path = join(out_dir, f"{frame}.png")
        _save_frame(img, path)
        paths.append(path)
    return paths


def main(argv=None):
    """Preprocessing CLI, the runnable twin of the reference's per-stage
    scripts (``scripts/scannet/render_uvs.py``, ``scripts/matterport``
    renderer, ``render_mipmap_scannet.py``, vertex-color render mode)::

        python -m stylemesh_tpu_torch.preprocess bake --mesh m.ply \\
            --scene_dir S [--backend torch] [--platform cpu]
        python -m stylemesh_tpu_torch.preprocess bake-matterport \\
            --house h.house --mesh region0.ply --scan_dir SCAN --region 0
        python -m stylemesh_tpu_torch.preprocess mipmap --mesh m.ply \\
            --scene_dir S --texture final_texture.jpg --out frames/
        python -m stylemesh_tpu_torch.preprocess vertex-color --mesh m.ply \\
            --scene_dir S --colors colors.npy --out frames/

    ``--scene_dir`` is a baked ScanNet-layout scene folder holding ``pose/``
    and the ``<scene>.txt`` intrinsics file. ``--backend torch`` bakes with
    the PyTorch rasterizer on the card (``--platform cpu``: on the CPU);
    ``--platform`` also places a ``texture.npz`` that ``mipmap`` composes.
    """
    import argparse

    from PIL import Image

    from stylemesh_tpu_torch.data.scenes import _scannet_intrinsics

    p = argparse.ArgumentParser(description="stylemesh_tpu_torch preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common_args(sp, backend=False):
        sp.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                        help="device of the torch backend and of a "
                             "texture.npz (default: the card)")
        if backend:
            sp.add_argument("--backend", default="native", choices=BACKENDS,
                            help="rasterizer: native C++ on the host, or "
                                 "the PyTorch one on --platform")

    def scene_args(sp):
        sp.add_argument("--mesh", required=True)
        sp.add_argument("--scene_dir", required=True,
                        help="scene folder with pose/ + <scene>.txt")

    b = sub.add_parser("bake", help="bake uv/angle/depth pyramid")
    scene_args(b)
    common_args(b, backend=True)
    b.add_argument("--base_hw", nargs=2, type=int, default=(960, 1280))
    b.add_argument("--pyramid_heights", nargs="+", type=int,
                   default=list(DEFAULT_PYRAMID_HEIGHTS))
    b.add_argument("--no_skip_existing", action="store_true")

    m = sub.add_parser("bake-matterport", help="bake one Matterport region")
    m.add_argument("--house", required=True, help=".house file")
    m.add_argument("--mesh", required=True, help="region mesh with UVs")
    m.add_argument("--scan_dir", required=True)
    m.add_argument("--region", type=int, default=0)
    m.add_argument("--color_src", default=None)
    m.add_argument("--depth_src", default=None)
    m.add_argument("--pyramid_heights", nargs="+", type=int,
                   default=list(DEFAULT_PYRAMID_HEIGHTS))
    common_args(m, backend=True)

    r = sub.add_parser("mipmap", help="render poses with a trained texture")
    scene_args(r)
    r.add_argument("--texture", required=True,
                   help="texture image (final_texture.jpg) or texture.npz")
    r.add_argument("--out", required=True)
    r.add_argument("--hw", nargs=2, type=int, default=(480, 640))
    r.add_argument("--no_shading", action="store_true")
    common_args(r)

    v = sub.add_parser("vertex-color", help="render per-vertex colors")
    scene_args(v)
    v.add_argument("--colors", required=True,
                   help=".npy [num_vertices, 3] colors in [0, 1]")
    v.add_argument("--out", required=True)
    v.add_argument("--hw", nargs=2, type=int, default=(480, 640))

    a = p.parse_args(argv)
    device = "cpu" if getattr(a, "platform", None) == "cpu" else None

    if a.cmd == "bake-matterport":
        from stylemesh_tpu_torch.data.matterport_house import parse_house

        n = bake_matterport_region(
            parse_house(a.house), a.mesh, a.scan_dir, a.region,
            color_src=a.color_src, depth_src=a.depth_src,
            pyramid_heights=tuple(a.pyramid_heights), backend=a.backend,
            device=device)
        print(f"baked {n} images for region {a.region}")
        return

    intr, intr_size, intr_file = _scannet_intrinsics(a.scene_dir)
    if intr_file is None:
        raise SystemExit(f"no <scene>.txt intrinsics in {a.scene_dir}")
    pose_dir = join(a.scene_dir, "pose")

    if a.cmd == "bake":
        bake_scene(a.mesh, pose_dir, intr, intr_size, a.scene_dir,
                   base_hw=tuple(a.base_hw),
                   pyramid_heights=tuple(a.pyramid_heights),
                   backend=a.backend, skip_existing=not a.no_skip_existing,
                   device=device)
        print(f"baked scene at {a.scene_dir}")
    elif a.cmd == "mipmap":
        if a.texture.endswith(".npz"):
            import torch

            from stylemesh_tpu_torch.models.texture import texture_image
            from stylemesh_tpu_torch.utils.checkpoint import load_texture_npz

            with torch.no_grad():
                img = texture_image(load_texture_npz(
                    a.texture, device=resolve_device(device)))
            tex = np.clip(img.cpu().numpy(), 0.0, 1.0)
        else:
            tex = np.asarray(Image.open(a.texture), np.float32)[..., :3] / 255.0
        paths = render_mipmap_frames(a.mesh, pose_dir, intr, intr_size, tex,
                                     a.out, hw=tuple(a.hw),
                                     shading=not a.no_shading)
        print(f"rendered {len(paths)} frames to {a.out}")
    elif a.cmd == "vertex-color":
        colors = np.load(a.colors)
        paths = render_vertex_color_frames(a.mesh, pose_dir, intr, intr_size,
                                           colors, a.out, hw=tuple(a.hw))
        print(f"rendered {len(paths)} frames to {a.out}")


if __name__ == "__main__":
    main()

"""UV-unwrap tool — the ``create_uvs.py`` equivalent without Blender.

A copy of ``stylemesh_tpu/create_uvs.py`` (the port imports nothing of
the JAX package).

The reference runs headless Blender per scene (decimate to <=500k faces, then
``uv.smart_project``, export ``*_uvs_blender.ply``;
scripts/scannet/create_uvs.py:81-117). This tool does the same with the
built-in decimator + smart projection:

    python -m stylemesh_tpu_torch.create_uvs <mesh.ply> [--max_faces 500000]
    python -m stylemesh_tpu_torch.create_uvs --scans_root <root>   # all scenes

Output: ``<stem>_uvs_blender.ply`` next to the input (the exact filename the
data layer's mesh discovery expects, reference model/optimize.py:179),
skipped if it already exists (idempotent like the reference).
"""

import argparse
import os
from os.path import dirname, exists, join, splitext

from stylemesh_tpu_torch.geometry.mesh_io import load_mesh, save_ply
from stylemesh_tpu_torch.geometry.unwrap import decimate, smart_project


def unwrap_mesh_file(path, max_faces=500000, overwrite=False):
    stem = splitext(path)[0]
    out_path = f"{stem}_uvs_blender.ply"
    if exists(out_path) and not overwrite:
        print(f"skip (exists): {out_path}")
        return out_path
    mesh = load_mesh(path)
    print(f"{path}: {len(mesh.faces)} faces")
    mesh = decimate(mesh, max_faces)
    mesh = smart_project(mesh)
    save_ply(mesh, out_path)
    print(f"wrote {out_path} ({len(mesh.faces)} faces)")
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser("stylemesh_tpu_torch.create_uvs")
    p.add_argument("mesh", nargs="?", default=None)
    p.add_argument("--scans_root", default=None,
                   help="unwrap every scene mesh under <root>/<scene>/")
    p.add_argument("--max_faces", default=500000, type=int)
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)

    if args.mesh:
        unwrap_mesh_file(args.mesh, args.max_faces, args.overwrite)
        return
    if not args.scans_root:
        p.error("need a mesh path or --scans_root")
    for scene in sorted(os.listdir(args.scans_root)):
        sdir = join(args.scans_root, scene)
        if not os.path.isdir(sdir):
            continue
        for f in sorted(os.listdir(sdir)):
            if f.endswith((".ply", ".obj")) and "_uvs_blender" not in f:
                unwrap_mesh_file(join(sdir, f), args.max_faces, args.overwrite)


if __name__ == "__main__":
    main()

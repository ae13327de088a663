"""Triangle-mesh loading (PLY / OBJ) — the Assimp-import equivalent.

A copy of ``stylemesh_tpu/geometry/mesh_io.py`` (the port imports nothing of
the JAX package).

The reference loads UV-unwrapped scan meshes through Assimp (triangulate +
GenNormals, reference include/model.h:53-70): ScanNet ``*_uvs_blender.ply``
(Blender smart-UV-project output, scripts/scannet/create_uvs.py:98-117) and
Matterport region plys. This loader supports:

- PLY ascii / binary_little_endian; vertex properties x y z [nx ny nz]
  [s t | u v | texture_u texture_v] [red green blue]; triangle or quad faces
  (quads are triangulated); per-face ``texcoord`` property lists (6 floats —
  Blender's export style) are converted to per-corner UVs by vertex
  duplication where corners disagree.
- OBJ with v/vt/vn/f (polygon faces fan-triangulated).

Vertex normals are generated (area-weighted face normals, normalized) when
absent — matching Assimp's GenNormals behavior used by the reference.
"""

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # [Nv, 3] float32
    faces: np.ndarray  # [Nf, 3] int32
    uvs: Optional[np.ndarray] = None  # [Nv, 2] float32
    normals: Optional[np.ndarray] = None  # [Nv, 3] float32
    colors: Optional[np.ndarray] = None  # [Nv, 3] float32 in [0,1]

    def with_generated_normals(self):
        if self.normals is not None:
            return self
        return dataclasses.replace(self, normals=compute_vertex_normals(
            self.vertices, self.faces))


def compute_vertex_normals(vertices, faces):
    """Area-weighted vertex normals (Assimp GenNormals equivalent)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    return n.astype(np.float32)


_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n")
    if head_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    body = data[head_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop_kind, ...)])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", _PLY_TYPES[tok[2]],
                                        _PLY_TYPES[tok[3]], tok[4]))
            else:
                elements[-1][2].append(("scalar", _PLY_TYPES[tok[1]], tok[2]))

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format {fmt}")

    parsed = {}
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                row = {}
                for p in props:
                    if p[0] == "list":
                        n = int(float(tokens[pos])); pos += 1
                        row[p[3]] = [float(tokens[pos + i]) for i in range(n)]
                        pos += n
                    else:
                        row[p[2]] = float(tokens[pos]); pos += 1
                rows.append(row)
            parsed[name] = rows
    else:
        off = 0
        for name, count, props in elements:
            if all(p[0] == "scalar" for p in props):
                dtype = np.dtype([(p[2], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dtype=dtype, count=count, offset=off)
                off += dtype.itemsize * count
                parsed[name] = arr
            else:
                rows = []
                for _ in range(count):
                    row = {}
                    for p in props:
                        if p[0] == "scalar":
                            dt = np.dtype("<" + p[1])
                            row[p[2]] = np.frombuffer(body, dt, 1, off)[0]
                            off += dt.itemsize
                        else:
                            cnt_dt = np.dtype("<" + p[1])
                            n = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                            off += cnt_dt.itemsize
                            val_dt = np.dtype("<" + p[2])
                            row[p[3]] = np.frombuffer(body, val_dt, n, off)
                            off += val_dt.itemsize * n
                    rows.append(row)
                parsed[name] = rows

    # --- vertices
    vtx = parsed["vertex"]
    if isinstance(vtx, np.ndarray):
        def col(*names):
            for n in names:
                if n in vtx.dtype.names:
                    return np.asarray(vtx[n], np.float32)
            return None
        vertices = np.stack([col("x"), col("y"), col("z")], -1)
        nx = col("nx")
        normals = (np.stack([col("nx"), col("ny"), col("nz")], -1)
                   if nx is not None else None)
        u = col("s", "u", "texture_u")
        v = col("t", "v", "texture_v")
        uvs = np.stack([u, v], -1) if u is not None and v is not None else None
        r = col("red")
        colors = None
        if r is not None:
            colors = np.stack([col("red"), col("green"), col("blue")], -1)
            if colors.max() > 1.0:
                colors = colors / 255.0
    else:
        def colr(row, *names):
            for n in names:
                if n in row:
                    return float(row[n])
            return None
        vertices = np.asarray([[r["x"], r["y"], r["z"]] for r in vtx], np.float32)
        normals = (np.asarray([[r["nx"], r["ny"], r["nz"]] for r in vtx], np.float32)
                   if "nx" in vtx[0] else None)
        uvs = None
        for ukey, vkey in [("s", "t"), ("u", "v"), ("texture_u", "texture_v")]:
            if ukey in vtx[0]:
                uvs = np.asarray([[r[ukey], r[vkey]] for r in vtx], np.float32)
                break
        colors = None
        if "red" in vtx[0]:
            colors = np.asarray([[r["red"], r["green"], r["blue"]] for r in vtx],
                                np.float32)
            if colors.max() > 1.0:
                colors = colors / 255.0

    # --- faces (+ optional per-face texcoords)
    face_rows = parsed.get("face", [])
    tris = []
    tri_uv = []
    has_face_uv = bool(face_rows) and not isinstance(face_rows, np.ndarray) \
        and "texcoord" in face_rows[0]
    for row in face_rows:
        idx = [int(i) for i in row["vertex_indices" if "vertex_indices" in row
                                  else "vertex_index"]]
        tc = np.asarray(row["texcoord"], np.float32).reshape(-1, 2) \
            if has_face_uv else None
        for k in range(1, len(idx) - 1):
            tris.append((idx[0], idx[k], idx[k + 1]))
            if tc is not None:
                tri_uv.append((tc[0], tc[k], tc[k + 1]))

    faces = np.asarray(tris, np.int32).reshape(-1, 3)

    if has_face_uv:
        # convert per-corner UVs to per-vertex by duplicating vertices whose
        # corners disagree (standard unwrap-seam split)
        vertices, faces, uvs, normals, colors = _split_seams(
            vertices, faces, tri_uv, normals, colors)

    mesh = Mesh(vertices=vertices, faces=faces, uvs=uvs, normals=normals,
                colors=colors)
    return mesh.with_generated_normals()


def _split_seams(vertices, faces, tri_uv, normals, colors):
    """Assign per-corner UVs, duplicating vertices at UV seams."""
    n = len(vertices)
    uv_of = [None] * n
    new_v, new_n, new_c = [], [], []
    out_faces = np.array(faces, np.int32)
    extra_uv = []
    for fi in range(len(faces)):
        for k in range(3):
            vi = faces[fi][k]
            uv = tuple(np.round(tri_uv[fi][k], 7))
            if uv_of[vi] is None:
                uv_of[vi] = uv
            elif uv_of[vi] != uv:
                # seam: duplicate
                new_idx = n + len(new_v)
                new_v.append(vertices[vi])
                if normals is not None:
                    new_n.append(normals[vi])
                if colors is not None:
                    new_c.append(colors[vi])
                extra_uv.append(uv)
                out_faces[fi][k] = new_idx
    uvs = np.zeros((n + len(new_v), 2), np.float32)
    for i, uv in enumerate(uv_of):
        if uv is not None:
            uvs[i] = uv
    for i, uv in enumerate(extra_uv):
        uvs[n + i] = uv
    if new_v:
        vertices = np.concatenate([vertices, np.asarray(new_v, np.float32)])
        if normals is not None:
            normals = np.concatenate([normals, np.asarray(new_n, np.float32)])
        if colors is not None:
            colors = np.concatenate([colors, np.asarray(new_c, np.float32)])
    return vertices, out_faces, uvs, normals, colors


def load_obj(path) -> Mesh:
    vs, vts, vns, faces, face_uv_idx = [], [], [], [], []
    with open(path) as f:
        for line in f:
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == "v":
                vs.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                vts.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "vn":
                vns.append([float(x) for x in tok[1:4]])
            elif tok[0] == "f":
                corners = []
                for c in tok[1:]:
                    parts = c.split("/")
                    vi = int(parts[0]) - 1
                    ti = int(parts[1]) - 1 if len(parts) > 1 and parts[1] else -1
                    corners.append((vi, ti))
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0][0], corners[k][0], corners[k + 1][0]))
                    face_uv_idx.append((corners[0][1], corners[k][1],
                                        corners[k + 1][1]))
    vertices = np.asarray(vs, np.float32)
    faces_np = np.asarray(faces, np.int32).reshape(-1, 3)
    uvs = None
    if vts and all(t >= 0 for tri in face_uv_idx for t in tri):
        vts_np = np.asarray(vts, np.float32)
        tri_uv = [(vts_np[a], vts_np[b], vts_np[c]) for a, b, c in face_uv_idx]
        vertices, faces_np, uvs, _, _ = _split_seams(
            vertices, faces_np, tri_uv, None, None)
    mesh = Mesh(vertices=vertices, faces=faces_np, uvs=uvs,
                normals=np.asarray(vns, np.float32) if (
                    vns and len(vns) == len(vertices)) else None)
    return mesh.with_generated_normals()


def load_mesh(path) -> Mesh:
    if str(path).endswith(".obj"):
        return load_obj(path)
    return load_ply(path)


def save_ply(mesh: Mesh, path, binary=True):
    """Write a PLY with per-vertex uv (``s``/``t`` properties) + normals +
    colors — the ``*_uvs_blender.ply`` contract the pipeline consumes."""
    v = np.asarray(mesh.vertices, np.float32)
    parts = [v]
    props = ["property float x", "property float y", "property float z"]
    if mesh.normals is not None:
        parts.append(np.asarray(mesh.normals, np.float32))
        props += ["property float nx", "property float ny", "property float nz"]
    if mesh.uvs is not None:
        parts.append(np.asarray(mesh.uvs, np.float32))
        props += ["property float s", "property float t"]
    if mesh.colors is not None:
        parts.append(np.asarray(mesh.colors, np.float32))
        props += ["property float red", "property float green",
                  "property float blue"]
    vdata = np.concatenate(parts, axis=1).astype("<f4")
    faces = np.asarray(mesh.faces, np.int32)

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {len(v)}", *props,
              f"element face {len(faces)}",
              "property list uchar int vertex_indices",
              "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(vdata.tobytes())
            rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())
        else:
            for row in vdata:
                f.write((" ".join(f"{x:g}" for x in row) + "\n").encode())
            for face in faces:
                f.write((f"3 {face[0]} {face[1]} {face[2]}\n").encode())
    return path

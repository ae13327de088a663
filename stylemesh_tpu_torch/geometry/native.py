"""ctypes bindings to the native (C++) rasterizer ``native/rasterizer.cpp``
(counterpart of ``stylemesh_tpu/geometry/native.py``, with a loader of its
own).

The library is host code: the UV/angle/depth bake, the textured mipmap
render and the vertex-colour render, each with the output contract of the
JAX package's wrappers. It is compiled at first use from the checkout's
``native/rasterizer.cpp`` with ``native/Makefile``'s flags into
``build/native/`` at the root of the checkout, under a name keyed on the
source's content, so a changed source builds a new library and an unchanged
one is reused. Processes that build at once (test workers) serialise on a
file lock, and each writes to a temporary file that is renamed into place.
Nothing is written into ``native/``. A failed compile or load raises, with the
compiler's output: there is no rebuild-and-retry and no other rasterizer
behind it.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "rasterizer.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX = "g++"
# native/Makefile's CXXFLAGS, and -shared
CXXFLAGS = ["-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared"]

_lib = None


def library_path():
    """Where the library built from the current source (and flags) lives."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join([CXX] + CXXFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libstylemesh_native-{key[:16]}.so"


def build():
    """Compile ``native/rasterizer.cpp`` unless the library of its current
    content exists; return the library's path. Raises ``RuntimeError`` with
    the compiler's output when the compile fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():  # another process built it while we waited
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                proc = subprocess.run([CXX] + CXXFLAGS + ["-o", tmp,
                                                          str(SOURCE)],
                                      capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"native rasterizer: cannot run the "
                                   f"compiler {CXX!r}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native rasterizer: {CXX} failed with exit code "
                    f"{proc.returncode}:\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def load_library():
    """The loaded library, built at first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.sm_rasterize.restype = ctypes.c_int64
    lib.sm_rasterize.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, f32p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, f32p, f32p, f32p, f32p,
    ]
    lib.sm_render_textured.restype = ctypes.c_int64
    lib.sm_render_textured.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, f32p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, f32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, f32p,
    ]
    lib.sm_render_vertex_colors.restype = ctypes.c_int64
    lib.sm_render_vertex_colors.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, f32p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, f32p, f32p,
    ]
    _lib = lib
    return lib


def _prep(vertices, faces, uvs, normals, cam2world):
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    u = np.ascontiguousarray(uvs, np.float32)
    n = np.ascontiguousarray(normals, np.float32)
    c = np.ascontiguousarray(np.asarray(cam2world, np.float32).reshape(16))
    if not (len(u) == len(n) == len(v) and f.ndim == 2 and f.shape[1] == 3):
        raise ValueError(f"mesh arrays disagree: {len(v)} vertices, "
                         f"{len(u)} attributes, {len(n)} normals, faces "
                         f"{f.shape}")
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("a face indexes a vertex that does not exist")
    return v, f, u, n, c


def rasterize_mesh_native(vertices, faces, uvs, normals, cam2world,
                          intrinsics, hw):
    """Native twin of ``rasterize_mesh``: returns (uv [H,W,2],
    cos_angle [H,W], depth [H,W], hit [H,W], lod [H,W]).

    ``lod`` is the baked mip level (uvmap.frag's textureQueryLod channel,
    computed against the GL bake-time 1024^2 texture, clamped to [0, 10])."""
    lib = load_library()
    v, f, u, n, c = _prep(vertices, faces, uvs, normals, cam2world)
    k = np.asarray(intrinsics, np.float32)
    h, w = hw
    out_uv = np.zeros((h, w, 2), np.float32)
    out_angle = np.zeros((h, w), np.float32)
    out_depth = np.zeros((h, w), np.float32)
    out_lod = np.zeros((h, w), np.float32)
    lib.sm_rasterize(v, len(v), f, len(f), u, n, c,
                     float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
                     float(k[1, 2]), h, w, out_uv, out_angle, out_depth,
                     out_lod)
    return out_uv, out_angle, out_depth, out_depth > 0, out_lod


def render_vertex_colors_native(vertices, faces, colors, normals, cam2world,
                                intrinsics, hw, return_depth=False):
    """Per-vertex-colour render, the reference's vertex_color shader mode
    (scripts/scannet/render_uv/shader/vertex_color.frag, the ``mesh_colors``
    flag src/main.cpp:77-78; Matterport color3D.frag): the output path for
    segmentation recolouring and mesh editing (geometry/segmentation.py).

    ``colors``: [n_verts, 3] in [0, 1]. Returns [H, W, 3] float (background
    0), plus the linear-depth map when ``return_depth``."""
    lib = load_library()
    v, f, col, n, c = _prep(vertices, faces, colors, normals, cam2world)
    k = np.asarray(intrinsics, np.float32)
    h, w = hw
    out = np.zeros((h, w, 3), np.float32)
    out_depth = np.zeros((h, w), np.float32)
    lib.sm_render_vertex_colors(v, len(v), f, len(f), col, n, c,
                                float(k[0, 0]), float(k[1, 1]),
                                float(k[0, 2]), float(k[1, 2]), h, w,
                                out, out_depth)
    return (out, out_depth) if return_depth else out


def render_textured_native(vertices, faces, uvs, normals, cam2world,
                           intrinsics, hw, texture, shading=True,
                           max_aniso=8):
    """Textured mipmap render (the reference's post-train renderer,
    renderer.cpp:110-140 + rgb.frag shading). ``texture``: [Ht, Wt, 3] in
    [0, 1]. Returns [H, W, 3] float.

    ``max_aniso`` matches the reference's GL_TEXTURE_MAX_ANISOTROPY_EXT = 8
    (renderer.cpp:110-140): up to N trilinear taps along the major
    screen-space uv-derivative axis; 1 = plain trilinear."""
    lib = load_library()
    v, f, u, n, c = _prep(vertices, faces, uvs, normals, cam2world)
    k = np.asarray(intrinsics, np.float32)
    h, w = hw
    tex = np.ascontiguousarray(texture, np.float32)
    if tex.ndim != 3 or tex.shape[2] != 3:
        raise ValueError(f"texture must be [H, W, 3], got {tex.shape}")
    out = np.zeros((h, w, 3), np.float32)
    lib.sm_render_textured(v, len(v), f, len(f), u, n, c,
                           float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
                           float(k[1, 2]), h, w,
                           tex, tex.shape[0], tex.shape[1],
                           1 if shading else 0, int(max_aniso), out)
    return out

"""Port parity of the rasterizers: the port's own loader of the native C++
rasterizer (``geometry/native.py``) against the JAX package's loader, and
the PyTorch rasterizer (``geometry/rasterize.py``, on the CPU here) against
the JAX one.

Tolerances:
- native, port against JAX: bit-equal. Both load a library built from the
  same ``native/rasterizer.cpp`` with the same flags.
- PyTorch rasterizer against JAX (faces in front of the camera) and
  against native (faces in front of it and faces crossing its plane, which
  the port and native clip and JAX drops): the bounds of
  ``tests/test_native.py``. Hit masks agree on more than 99% of the pixels
  (edge pixels may round the other way); where both hit, depth within rtol
  1e-4, UV within 1e-4, angle and LOD within 1e-3, vertex colours within
  2e-4.
- the PyTorch rasterizer at two face chunk sizes: equal, exact depth ties
  included (the globally first face wins).
- the PyTorch rasterizer on the demo room (8 m walls that cross the camera
  plane) against its own scan in float64: the same bounds, where the same
  triangle won (and on more than 99% of the pixels it did).
"""

import numpy as np
import pytest
import torch

from stylemesh_tpu.geometry import native as jnative
from stylemesh_tpu.geometry.rasterize import rasterize_mesh as jrasterize
from stylemesh_tpu.geometry.rasterize import render_vertex_colors as jvertex
from stylemesh_tpu_torch.data.demo_scene import room_mesh
from stylemesh_tpu_torch.geometry import native as tnative
from stylemesh_tpu_torch.geometry import rasterize as trast
from stylemesh_tpu_torch.geometry.trajectories import orbit_poses
from stylemesh_tpu_torch.geometry.rasterize import rasterize_mesh as trasterize
from stylemesh_tpu_torch.geometry.rasterize import render_vertex_colors as tvertex
from tests.test_native import _scene

K = np.array([[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]], np.float32)
HW = (48, 64)


def _tilted_scene(seed=5, n_tris=40, crossing=True):
    """Random triangles before a tilted camera, both windings, random
    normals; with ``crossing``, some of them cross the camera plane."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform((-2, -1.5, 1.0), (2, 1.5, 6.0), (n_tris, 3))
    verts = (centres[:, None] + rng.normal(0, 0.8, (n_tris, 3, 3))).reshape(-1, 3)
    faces = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    uvs = rng.random((3 * n_tris, 2))
    normals = rng.normal(size=(3 * n_tris, 3))
    a = 0.2
    cam = np.eye(4)
    cam[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    cam[:3, 3] = (0.3, -0.1, -0.5)
    if not crossing:
        z = ((verts - cam[:3, 3]) @ cam[:3, :3])[:, 2].reshape(-1, 3)
        faces = faces[(z > 0.05).all(1)]
    return (verts.astype(np.float32), faces, uvs.astype(np.float32),
            normals.astype(np.float32), cam.astype(np.float32), K)


def _colors(n, seed=7):
    return np.random.default_rng(seed).random((n, 3)).astype(np.float32)


def test_native_loader_matches_jax():
    """The port's library lies under build/native, keyed on the source; its
    three entry points give the JAX loader's outputs bit for bit."""
    path = tnative.build()
    assert path.parent == tnative.ROOT / "build" / "native"
    assert path == tnative.library_path() and path.exists()
    verts, faces, uvs, normals, cam, k = _scene()
    for got, want in zip(
            tnative.rasterize_mesh_native(verts, faces, uvs, normals, cam, k, HW),
            jnative.rasterize_mesh_native(verts, faces, uvs, normals, cam, k, HW)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    colors = _colors(len(verts))
    for got, want in zip(
            tnative.render_vertex_colors_native(verts, faces, colors, normals,
                                                cam, k, HW, return_depth=True),
            jnative.render_vertex_colors_native(verts, faces, colors, normals,
                                                cam, k, HW, return_depth=True)):
        assert np.array_equal(got, want)
    tex = np.random.default_rng(2).random((64, 48, 3)).astype(np.float32)
    for shading, aniso in ((True, 8), (False, 1)):
        got = tnative.render_textured_native(verts, faces, uvs, normals, cam, k,
                                             HW, tex, shading, aniso)
        want = jnative.render_textured_native(verts, faces, uvs, normals, cam,
                                              k, HW, tex, shading, aniso)
        assert np.array_equal(got, want) and (got > 0).any()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A missing compiler or a source that does not compile raises with the
    compiler's message; nothing is loaded, nothing falls back, nothing is
    left in the build directory."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-compiler"))
    verts, faces, uvs, normals, cam, k = _scene()
    with pytest.raises(RuntimeError, match="cannot run the compiler"):
        tnative.rasterize_mesh_native(verts, faces, uvs, normals, cam, k, HW)
    monkeypatch.setattr(tnative, "CXX", "g++")
    bad = tmp_path / "rasterizer.cpp"
    bad.write_text("int sm_rasterize( {\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed with exit code"):
        tnative.load_library()
    assert tnative._lib is None
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["lock"]


def test_native_rejects_bad_meshes():
    verts, faces, uvs, normals, cam, k = _scene()
    with pytest.raises(ValueError, match="does not exist"):
        tnative.rasterize_mesh_native(verts, faces + len(verts), uvs, normals,
                                      cam, k, HW)
    with pytest.raises(ValueError, match="disagree"):
        tnative.rasterize_mesh_native(verts, faces, uvs[:-1], normals, cam, k,
                                      HW)


def _assert_maps_close(got, want, min_hits=500):
    uv_g, ang_g, d_g, hit_g, lod_g = got
    uv_w, ang_w, d_w, hit_w, lod_w = want
    assert (hit_g == hit_w).mean() > 0.99
    both = hit_g & hit_w
    assert both.sum() > min_hits
    np.testing.assert_allclose(d_g[both], d_w[both], rtol=1e-4)
    np.testing.assert_allclose(uv_g[both], uv_w[both], atol=1e-4)
    np.testing.assert_allclose(ang_g[both], ang_w[both], atol=1e-3)
    np.testing.assert_allclose(lod_g[both], lod_w[both], atol=1e-3)


def _torch_maps(*args, **kw):
    out = trasterize(*args, device="cpu", **kw)
    assert [x.dtype for x in out] == [torch.float32] * 3 + [torch.bool,
                                                            torch.float32]
    assert all(x.device.type == "cpu" for x in out)
    return [x.numpy() for x in out]


def _floor_scene():
    """tests/test_native.py's near-plane case: a floor quad that passes
    under and behind the camera."""
    verts = np.asarray([(-5, 1, -5), (5, 1, -5), (5, 1, 5), (-5, 1, 5)],
                       np.float32)
    faces = np.asarray([(0, 1, 2), (0, 2, 3)], np.int32)
    uvs = np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    normals = np.tile(np.asarray([0, -1, 0], np.float32), (4, 1))
    return verts, faces, uvs, normals, np.eye(4, dtype=np.float32), K


def _crossing_scene():
    """The tilted scene with its crossing triangles and the floor quad."""
    verts, faces, uvs, normals, cam, k = _tilted_scene()
    fv, ff, fu, fn, _, _ = _floor_scene()
    return (np.concatenate([verts, fv]), np.concatenate([faces, ff + len(verts)]),
            np.concatenate([uvs, fu]), np.concatenate([normals, fn]), cam, k)


@pytest.mark.parametrize("scene", [_scene, lambda: _tilted_scene(
    crossing=False)], ids=["two_quads", "tilted"])
def test_torch_rasterizer_matches_jax_and_native(scene):
    verts, faces, uvs, normals, cam, k = scene()
    got = _torch_maps(verts, faces, uvs, normals, cam, k, HW)
    _assert_maps_close(got, [np.asarray(x) for x in jrasterize(
        verts, faces, uvs, normals, cam, k, HW)], min_hits=300)
    _assert_maps_close(got, tnative.rasterize_mesh_native(
        verts, faces, uvs, normals, cam, k, HW), min_hits=300)
    colors = _colors(len(verts))
    rgb_t, d_t = tvertex(verts, faces, colors, normals, cam, k, HW,
                         return_depth=True, device="cpu")
    rgb_j, d_j = jvertex(verts, faces, colors, normals, cam, k, HW,
                         return_depth=True)
    rgb_t, rgb_j = rgb_t.numpy(), np.asarray(rgb_j)
    hit_t, hit_j = rgb_t.sum(-1) > 0, rgb_j.sum(-1) > 0
    assert (hit_t == hit_j).mean() > 0.99
    both = hit_t & hit_j
    np.testing.assert_allclose(rgb_t[both], rgb_j[both], atol=2e-4)
    np.testing.assert_allclose(d_t.numpy()[both], np.asarray(d_j)[both],
                               rtol=1e-4)


@pytest.mark.parametrize("scene", [_crossing_scene, _floor_scene])
def test_torch_rasterizer_clips_the_near_plane(scene):
    """Faces that cross the camera plane are clipped as the native
    rasterizer clips them (the JAX rasterizer drops them): the maps agree
    with native within the bounds, the floor covers the lower frame, and
    the vertex colours ride the clip too."""
    verts, faces, uvs, normals, cam, k = scene()
    got = _torch_maps(verts, faces, uvs, normals, cam, k, HW)
    _assert_maps_close(got, tnative.rasterize_mesh_native(
        verts, faces, uvs, normals, cam, k, HW), min_hits=300)
    hit_j = np.asarray(jrasterize(verts, faces, uvs, normals, cam, k, HW)[3])
    assert got[3].sum() > hit_j.sum() + 100
    colors = _colors(len(verts))
    rgb_t = tvertex(verts, faces, colors, normals, cam, k, HW,
                    device="cpu").numpy()
    rgb_n = tnative.render_vertex_colors_native(verts, faces, colors, normals,
                                                cam, k, HW)
    both = (rgb_t.sum(-1) > 0) & (rgb_n.sum(-1) > 0)
    assert both.mean() > 0.3
    np.testing.assert_allclose(rgb_t[both], rgb_n[both], atol=2e-4)


def test_torch_rasterizer_chunk_size_and_ties():
    """Duplicated faces with other UVs tie exactly in depth: the first face
    of the list wins at every pixel, whatever the chunk size, so the maps
    at chunk sizes 1, 3, 7 and 256 are equal, and equal to the untied
    mesh's."""
    verts, faces, uvs, normals, cam, k = _tilted_scene(n_tris=12)
    n = len(verts)
    dup_verts = np.concatenate([verts, verts])
    dup_uvs = np.concatenate([uvs, 1.0 - uvs])
    dup_normals = np.concatenate([normals, -normals])
    # the copies come first in the list and hold the other UVs; the
    # originals come after them
    dup_faces = np.concatenate([faces + n, faces])
    maps = [_torch_maps(dup_verts, dup_faces, dup_uvs, dup_normals, cam, k,
                        HW, face_chunk=c) for c in (1, 3, 7, 256)]
    for m in maps[1:]:
        for a, b in zip(maps[0], m):
            assert np.array_equal(a, b)
    copies = _torch_maps(verts, faces, 1.0 - uvs, -normals, cam, k, HW)
    for a, b in zip(maps[0], copies):
        assert np.array_equal(a, b)
    assert maps[0][3].sum() > 200
    with pytest.raises(ValueError, match="face_chunk"):
        trasterize(verts, faces, uvs, normals, cam, k, HW, face_chunk=0,
                   device="cpu")


def test_demo_room_against_float64():
    """The near clip leaves slivers whose vertices project 100 times
    farther out; the guard band keeps float32 within the bounds of the same
    scan in float64 on the demo room's first views."""
    mesh = room_mesh()
    hw = (60, 80)
    k = np.eye(3, dtype=np.float32)
    k[0, 0] = k[1, 1] = 580.0 * 80 / 1296
    k[0, 2], k[1, 2] = 40.0, 30.0
    cam = (float(k[0, 0]), float(k[1, 1]), 40.0, 30.0)
    for pose in orbit_poses((2.0, 2.0, 1.4), 1.2, 0.0, n=24)[:4]:
        out = {}
        for dtype in (torch.float32, torch.float64):
            fv, fuv, fn = (x.to(dtype) for x in trast._camera_faces(
                mesh.vertices, mesh.faces, mesh.uvs, mesh.normals, pose,
                "cpu"))
            maps = [x.numpy() for x in trast._rasterize_impl(
                fv, fuv, fn, *cam, hw, 256)]
            clipped = trast._clip_faces(fv, fuv, fn, *cam, hw)[0]
            face = trast._depth_scan(clipped, *cam, hw, 256)[1].numpy()
            out[dtype] = maps, face.reshape(hw)
        (got, f32), (want, f64) = out[torch.float32], out[torch.float64]
        same = (got[3] == want[3]) & (~got[3] | (f32 == f64))
        assert same.mean() > 0.99 and got[3].all()
        m = same & got[3]
        np.testing.assert_allclose(got[2][m], want[2][m], rtol=1e-4)
        np.testing.assert_allclose(got[0][m], want[0][m], atol=1e-4)
        np.testing.assert_allclose(got[1][m], want[1][m], atol=1e-3)
        np.testing.assert_allclose(got[4][m], want[4][m], atol=1e-3)


def test_torch_rasterizer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces, uvs, normals, cam, k = _scene()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trasterize(verts, faces, uvs, normals, cam, k, HW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvertex(verts, faces, _colors(len(verts)), normals, cam, k, HW)

"""Port parity of the host-side preprocessing modules that are numpy copies:
``geometry/{mesh_io,trajectories,unwrap,segmentation}.py``, ``create_uvs.py``
and ``data/{matterport_house,sens,filters}.py``, against the JAX package on
the same seeded inputs.

Tolerance: none. Both packages run the same numpy code, so every array is
equal in dtype and value, every file they write is equal byte for byte, and
every return value is equal.
"""

import dataclasses
import json
import os
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from stylemesh_tpu import create_uvs as jcreate_uvs
from stylemesh_tpu.data import filters as jfilters
from stylemesh_tpu.data import matterport_house as jhouse
from stylemesh_tpu.data import sens as jsens
from stylemesh_tpu.data.demo_scene import room_mesh as jroom_mesh
from stylemesh_tpu.geometry import mesh_io as jmesh_io
from stylemesh_tpu.geometry import segmentation as jseg
from stylemesh_tpu.geometry import trajectories as jtraj
from stylemesh_tpu.geometry import unwrap as junwrap
from stylemesh_tpu_torch import create_uvs as tcreate_uvs
from stylemesh_tpu_torch.data import filters as tfilters
from stylemesh_tpu_torch.data import matterport_house as thouse
from stylemesh_tpu_torch.data import sens as tsens
from stylemesh_tpu_torch.geometry import mesh_io as tmesh_io
from stylemesh_tpu_torch.geometry import segmentation as tseg
from stylemesh_tpu_torch.geometry import trajectories as ttraj
from stylemesh_tpu_torch.geometry import unwrap as tunwrap

MESH_FIELDS = ("vertices", "faces", "uvs", "normals", "colors")


def assert_same(a, b, where=""):
    """Equal values of equal types: arrays in dtype and bits, containers
    element by element, dataclasses field by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    root = Path(root)
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_tree(a, b):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k


def _seam_ply_ascii(path):
    """Two quads sharing an edge, per-face texcoords that disagree at the
    shared corners (a UV seam) and at one corner inside a quad."""
    path.write_text("""ply
format ascii 1.0
element vertex 6
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element face 3
property list uchar int vertex_indices
property list uchar float texcoord
end_header
-1 -1 3 255 0 0
0 -1 3 0 255 0
0 1 3 0 0 255
-1 1 3 10 20 30
1 -1 2.5 40 50 60
1 1 2.5 70 80 90
4 0 1 2 3 8 0 0 0.5 0 0.5 1 0 1
3 1 4 5 6 0.6 0 1 0 1 1
3 1 5 2 6 0.6 0 1 1 0.61 1
""")


def _binary_ply_with_face_uvs(path, rng):
    """Binary PLY: float xyz + normals, a quad and triangles with per-face
    texcoords, random seams."""
    v = rng.normal(size=(7, 3)).astype("<f4")
    n = rng.normal(size=(7, 3)).astype("<f4")
    faces = [[0, 1, 2, 3], [1, 4, 2], [4, 5, 6], [2, 4, 6]]
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 7\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float nx\nproperty float ny\nproperty float nz\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\n"
              "property list uchar float texcoord\nend_header\n")
    body = np.concatenate([v, n], 1).tobytes()
    for f in faces:
        body += struct.pack("<B", len(f)) + np.asarray(f, "<i4").tobytes()
        tc = rng.random(2 * len(f)).astype("<f4")
        body += struct.pack("<B", len(tc)) + tc.tobytes()
    path.write_bytes(header.encode() + body)


def _obj(path):
    path.write_text("""v -1 -1 3
v 1 -1 3
v 1 1 3
v -1 1 3
v 2 0 3
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vt 0.5 0.5
vn 0 0 -1
f 1/1 2/2 3/3 4/4
f 2/5 5/2 3/3
""")


def _box_mesh(mesh_io):
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    return mesh_io.Mesh(vertices=v, faces=f).with_generated_normals()


def _grid_mesh(mesh_io, n=30):
    ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z = 0.2 * np.sin(xs / 5.0) * np.cos(ys / 5.0)
    v = np.stack([xs.ravel(), ys.ravel(), z.ravel()], -1).astype(np.float32)
    faces = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    return mesh_io.Mesh(vertices=v, faces=np.asarray(faces, np.int32)
                        ).with_generated_normals()


def _port_mesh(mesh):
    return tmesh_io.Mesh(**{f: getattr(mesh, f) for f in MESH_FIELDS})


def test_mesh_loaders_match_jax(tmp_path):
    """PLY (ASCII with colours, a quad and seams; binary with normals and
    per-face texcoords), OBJ with a UV seam, through ``load_mesh``: equal
    meshes, seam splits included."""
    rng = np.random.default_rng(0)
    _seam_ply_ascii(tmp_path / "seam.ply")
    _binary_ply_with_face_uvs(tmp_path / "bin.ply", rng)
    _obj(tmp_path / "quad.obj")
    for name in ("seam.ply", "bin.ply", "quad.obj"):
        want = jmesh_io.load_mesh(str(tmp_path / name))
        got = tmesh_io.load_mesh(str(tmp_path / name))
        assert_same(got, want, name)
        assert got.uvs is not None
    seam = tmesh_io.load_ply(str(tmp_path / "seam.ply"))
    assert len(seam.vertices) > 6  # the seam duplicated vertices
    with pytest.raises(ValueError, match="not a PLY"):
        tmesh_io.load_ply(str(tmp_path / "quad.obj"))


@pytest.mark.parametrize("binary", [True, False])
def test_save_ply_matches_jax(tmp_path, binary):
    """``save_ply`` writes the same bytes; both loaders read them back
    equal, normals generated the same way."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(9, 3)).astype(np.float32)
    f = rng.integers(0, 9, (11, 3)).astype(np.int32)
    normals = jmesh_io.compute_vertex_normals(v, f)
    assert_same(tmesh_io.compute_vertex_normals(v, f), normals)
    fields = dict(vertices=v, faces=f, normals=normals,
                  uvs=rng.random((9, 2)).astype(np.float32),
                  colors=rng.random((9, 3)).astype(np.float32))
    jmesh_io.save_ply(jmesh_io.Mesh(**fields), str(tmp_path / "j.ply"),
                      binary=binary)
    tmesh_io.save_ply(tmesh_io.Mesh(**fields), str(tmp_path / "t.ply"),
                      binary=binary)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    assert_same(tmesh_io.load_ply(str(tmp_path / "t.ply")),
                jmesh_io.load_ply(str(tmp_path / "t.ply")))


def test_trajectories_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    keys = []
    for _ in range(3):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        m = np.eye(4)
        m[:3, :3] = jtraj._mat_from_quat(q)
        m[:3, 3] = rng.normal(size=3)
        keys.append(m)
    assert_same(ttraj.interpolate_poses(keys, steps_per_segment=7),
                jtraj.interpolate_poses(keys, steps_per_segment=7))
    for kw in (dict(), dict(look_at=(0.5, 0.0, 1.0)), dict(height=0.0)):
        args = dict(center=(1.0, 2.0, 1.4), radius=1.2, height=0.3, n=9)
        args.update(kw)
        assert_same(ttraj.orbit_poses(**args), jtraj.orbit_poses(**args))
    poses = jtraj.orbit_poses((0, 0, 0), 1.0, 0.0, n=5)
    jtraj.write_pose_dir(poses, str(tmp_path / "j"))
    ttraj.write_pose_dir(poses, str(tmp_path / "t"))
    assert_same_tree(tmp_path / "j", tmp_path / "t")


def test_unwrap_and_decimate_match_jax():
    """``smart_project`` (groups, islands, min-area rectangles, the bisected
    shelf pack) on the box, the demo room and a height field, and
    ``decimate``'s binary search on the height field."""
    grid = _grid_mesh(jmesh_io)
    for mesh in (_box_mesh(jmesh_io), jroom_mesh(), grid):
        for kw in (dict(), dict(margin=0.01, angle_limit=0.5)):
            assert_same(tunwrap.smart_project(_port_mesh(mesh), **kw),
                        junwrap.smart_project(mesh, **kw))
    for max_faces in (300, 1000, 5000):
        want = junwrap.decimate(grid, max_faces)
        assert_same(tunwrap.decimate(_port_mesh(grid), max_faces), want)
    assert len(want.faces) == len(grid.faces)  # under the cap: unchanged


def test_segmentation_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    semseg = {"segGroups": [
        {"id": 0, "label": "wall", "segments": [0, 2]},
        {"id": 1, "label": "chair", "segments": [1]},
        {"id": 2, "label": "wall", "segments": [3]},
    ]}
    vseg = {"segIndices": [int(x) for x in rng.integers(0, 4, 8)]}
    fseg = {"segIndices": [int(x) for x in rng.integers(0, 4, 12)]}
    for name, blob in (("semseg", semseg), ("vseg", vseg), ("fseg", fseg)):
        (tmp_path / f"a.{name}.json").write_text(json.dumps(blob))
    paths = [tmp_path / f"a.{n}.json" for n in ("semseg", "vseg", "fseg")]
    jsp = jseg.SegmentationProvider.load(*paths, seed=5)
    tsp = tseg.SegmentationProvider.load(*paths, seed=5)
    assert_same(tsp, jsp)
    ids = jsp.vertex_object_ids()
    assert_same(tsp.vertex_object_ids(), ids)
    assert_same(tsp.object_id_of_vertex(4), jsp.object_id_of_vertex(4))
    box = _box_mesh(jmesh_io)
    for by in ("object", "class"):
        assert_same(tsp.recolor_mesh(_port_mesh(box), by=by),
                    jsp.recolor_mesh(box, by=by))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (2.0, -1.0, 0.5)
    for obj in (0, 1):
        assert_same(tseg.split_mesh_at_object(_port_mesh(box), ids, obj),
                    jseg.split_mesh_at_object(box, ids, obj))
        assert_same(tseg.move_object_vertices(_port_mesh(box), ids, obj, t),
                    jseg.move_object_vertices(box, ids, obj, t))


def test_create_uvs_matches_jax(tmp_path):
    """``unwrap_mesh_file`` and the CLI over a scans root write the same
    ``*_uvs_blender.ply`` bytes."""
    for side in ("j", "t"):
        for scene, mesh in (("scene0000_00", _grid_mesh(jmesh_io, 12)),
                            ("scene0001_00", _box_mesh(jmesh_io))):
            d = tmp_path / side / scene
            d.mkdir(parents=True)
            jmesh_io.save_ply(mesh, str(d / f"{scene}_vh_clean.ply"))
    raw = "scene0000_00/scene0000_00_vh_clean.ply"
    out_j = jcreate_uvs.unwrap_mesh_file(str(tmp_path / "j" / raw), max_faces=150)
    out_t = tcreate_uvs.unwrap_mesh_file(str(tmp_path / "t" / raw), max_faces=150)
    assert Path(out_j).read_bytes() == Path(out_t).read_bytes()
    jcreate_uvs.main(["--scans_root", str(tmp_path / "j"), "--max_faces", "150"])
    tcreate_uvs.main(["--scans_root", str(tmp_path / "t"), "--max_faces", "150"])
    assert_same_tree(tmp_path / "j", tmp_path / "t")
    assert len(tree(tmp_path / "t")) == 4


HOUSE = """ASCII 1.0
H house1 - 3 2 0 0 2 1 0 0 0 0 0 0 0 0 0 0 0 0 0 0
L 0 0 lab 0 0 0 0 0 0 0 0 0 0 0 0 0 0
R 0 0 0 0 bedroom 1 2 3 0 0 0 1 1 1 2.5 0 0 0 0
R 1 0 0 0 kitchen 1 2 3 0 0 0 1 1 1 2.5 0 0 0 0
P pano_a 0 0 0 1 1 1 0 0 0 0 0
P pano_b 1 1 0 2 2 1 0 0 0 0 0
I 0 0 img0 0 0 1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1 50 0 32 0 50 24 0 0 1 64 48 1 1 1 0 0 0 0 0
I 1 0 img0 0 1 0.5 0 0.8 0.1 0 1 0 0.2 -0.8 0 0.5 0 0 0 0 1 50 0 32 0 50 24 0 0 1 64 48 1 1 1 0 0 0 0 0
I 2 1 img1 1 2 1 0 0 2 0 1 0 0 0 0 1 0 0 0 0 1 40 0 30 0 41 20 0 0 1 60 40 2 2 1 0 0 0 0 0
"""


def test_parse_house_matches_jax(tmp_path):
    p = tmp_path / "house1.house"
    p.write_text(HOUSE)
    want = jhouse.parse_house(str(p))
    got = thouse.parse_house(str(p))
    assert_same(got, want)
    assert len(got.images) == 3 and len(got.regions[1].panoramas) == 1
    for r in (0, 1):
        assert_same(got.region_images(r), want.region_images(r))
    assert [i.color_filename for i in got.images] == [
        i.color_filename for i in want.images]
    assert [i.depth_filename for i in got.images] == [
        i.depth_filename for i in want.images]


def _write_sens(path, h=24, w=32, frames=5):
    """A synthetic v4 ``.sens`` stream (jpeg colour, zlib depth), one frame
    with a non-finite pose."""
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        f.write(struct.pack("I", 4))
        name = b"sensor"
        f.write(struct.pack("Q", len(name)))
        f.write(name)
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 30.0, 31.0, 16.0, 12.0
        for _ in range(4):
            f.write(k.tobytes())
        f.write(struct.pack("iiIIIIf", 2, 1, w, h, w, h, 1000.0))
        f.write(struct.pack("Q", frames))
        for i in range(frames):
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = i if i != 2 else -np.inf
            f.write(pose.tobytes())
            f.write(struct.pack("QQ", i, i))
            ok, jpg = cv2.imencode(
                ".jpg", rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            dz = zlib.compress(
                rng.integers(500, 5000, (h, w)).astype(np.uint16).tobytes())
            f.write(struct.pack("QQ", len(jpg.tobytes()), len(dz)))
            f.write(jpg.tobytes())
            f.write(dz)


def test_sens_matches_jax(tmp_path):
    """``extract_sens`` and the CLI write the same scene trees; the reader
    and the label helpers agree."""
    path = tmp_path / "scene.sens"
    _write_sens(path)
    for mod, side in ((jsens, "j"), (tsens, "t")):
        out = tmp_path / side / "scene0001_00"
        assert mod.extract_sens(str(path), str(out), frame_skip=1,
                                image_size=(12, 16)) == 4
        mod.main(["--filename", str(path), "--output_path",
                  str(tmp_path / side / "native_size"), "--frame_skip", "2",
                  "--image_size", "0", "0"])
    assert_same_tree(tmp_path / "j", tmp_path / "t")
    assert "pose/2.txt" not in tree(tmp_path / "t" / "scene0001_00")

    jr, tr = jsens.SensReader(str(path)), tsens.SensReader(str(path))
    for (jp, jc, jd), (tp, tc, td) in zip(jr, tr):
        assert_same(tp, jp)
        assert_same(tr.decode_color(tc), jr.decode_color(jc))
        assert_same(tr.decode_depth(td), jr.decode_depth(jd))
    jr.close()
    tr.close()
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\tnyu40id\n1\t5\n2\t\n3\t7\n")
    mapping = jsens.load_label_mapping(str(tsv))
    assert_same(tsens.load_label_mapping(str(tsv)), mapping)
    labels = np.random.default_rng(1).integers(0, 4, (6, 5))
    assert_same(tsens.remap_labels(labels, mapping),
                jsens.remap_labels(labels, mapping))


def _blur_scene(scene):
    (scene / "color").mkdir(parents=True)
    (scene / "depth").mkdir()
    (scene / "pose").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
        if i % 2:
            img = cv2.GaussianBlur(img, (31, 31), 4 * i)
        Image.fromarray(img).save(scene / "color" / f"{i}.jpg")
        Image.fromarray(np.zeros((64, 64), np.uint8)).save(
            scene / "depth" / f"{i}.png")
        (scene / "pose" / f"{i}.txt").write_text("pose")


def test_filters_match_jax(tmp_path, capsys):
    """Sharpness, ``filter_blurry`` (dry run and real), ``undo_filter`` and
    the CLI: the same frames move, the same trees remain."""
    for side in ("j", "t"):
        _blur_scene(tmp_path / side / "scene")
    js, ts = tmp_path / "j" / "scene", tmp_path / "t" / "scene"
    for i in range(4):
        assert (tfilters.sharpness(str(ts / "color" / f"{i}.jpg"))
                == jfilters.sharpness(str(js / "color" / f"{i}.jpg")))
    assert (tfilters.filter_blurry(str(ts), dry_run=True)
            == jfilters.filter_blurry(str(js), dry_run=True))
    assert_same_tree(js, ts)
    filtered = jfilters.filter_blurry(str(js), threshold=150.0)
    assert tfilters.filter_blurry(str(ts), threshold=150.0) == filtered
    assert filtered
    assert_same_tree(js, ts)
    assert tfilters.undo_filter(str(ts)) == jfilters.undo_filter(str(js))
    assert_same_tree(js, ts)
    outs = {jfilters: [], tfilters: []}
    for argv in (["--threshold", "100"], ["--undo"]):
        for mod, s in ((jfilters, js), (tfilters, ts)):
            mod.main(["--dir", str(s)] + argv)
            outs[mod].append(capsys.readouterr().out)
        assert_same_tree(js, ts)
    assert outs[jfilters] == outs[tfilters]
    assert sorted(os.listdir(ts / "color")) == [f"{i}.jpg" for i in range(4)]

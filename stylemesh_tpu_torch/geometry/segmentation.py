"""Matterport segmentation + mesh editing utilities.

A copy of ``stylemesh_tpu/geometry/segmentation.py`` (the port imports nothing of
the JAX package).

Python equivalents of the reference's Segmentation_Provider
(scripts/matterport/render_uv/src/mp_parser/
segmentation_provider.cpp:4-127) and Mesh_Transformer
(mesh_transformer.cpp:8-60):

- load ``.semseg.json`` (segment groups -> objects/classes), ``.vseg.json``
  (per-vertex segment ids) and ``.fseg.json`` (per-face segment ids);
- map vertices -> objects / classes; assign stable per-object / per-class
  colors and recolor the mesh;
- split a mesh at an object boundary and rigidly transform one object's
  vertices (the demo scene-editing capability).
"""

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from stylemesh_tpu_torch.geometry.mesh_io import Mesh, compute_vertex_normals


@dataclasses.dataclass
class SegmentationProvider:
    vertex_to_segment: np.ndarray  # [Nv] int
    face_to_segment: Optional[np.ndarray]  # [Nf] int or None
    segment_to_object: Dict[int, int]
    object_to_class: Dict[int, str]
    object_colors: Dict[int, np.ndarray]
    class_colors: Dict[str, np.ndarray]

    @staticmethod
    def load(semseg_path, vseg_path, fseg_path=None, seed=0):
        with open(semseg_path) as f:
            semseg = json.load(f)
        with open(vseg_path) as f:
            vseg = json.load(f)
        fseg = None
        if fseg_path:
            with open(fseg_path) as f:
                fseg = json.load(f)

        vertex_to_segment = np.asarray(vseg["segIndices"], np.int64)
        face_to_segment = (np.asarray(fseg["segIndices"], np.int64)
                           if fseg else None)

        segment_to_object = {}
        object_to_class = {}
        for group in semseg["segGroups"]:
            oid = int(group["id"])
            object_to_class[oid] = group.get("label", "")
            for seg in group["segments"]:
                segment_to_object[int(seg)] = oid

        rng = np.random.default_rng(seed)
        object_colors = {oid: rng.random(3).astype(np.float32)
                         for oid in sorted(object_to_class)}
        class_colors = {}
        for label in sorted(set(object_to_class.values())):
            class_colors[label] = rng.random(3).astype(np.float32)
        return SegmentationProvider(
            vertex_to_segment=vertex_to_segment,
            face_to_segment=face_to_segment,
            segment_to_object=segment_to_object,
            object_to_class=object_to_class,
            object_colors=object_colors,
            class_colors=class_colors)

    def object_id_of_vertex(self, vi):
        return self.segment_to_object.get(int(self.vertex_to_segment[vi]), -1)

    def vertex_object_ids(self):
        """[Nv] object id per vertex (-1 for unassigned segments)."""
        return np.asarray([
            self.segment_to_object.get(int(s), -1)
            for s in self.vertex_to_segment], np.int64)

    def recolor_mesh(self, mesh: Mesh, by="object") -> Mesh:
        """Per-object or per-class vertex colors (reference recolor path)."""
        ids = self.vertex_object_ids()
        colors = np.zeros((len(mesh.vertices), 3), np.float32)
        for i, oid in enumerate(ids):
            if oid < 0:
                continue
            if by == "object":
                colors[i] = self.object_colors[oid]
            else:
                colors[i] = self.class_colors[self.object_to_class[oid]]
        return dataclasses.replace(mesh, colors=colors)


def split_mesh_at_object(mesh: Mesh, object_ids, target_object) -> Mesh:
    """Remove faces straddling the target object's boundary
    (mesh_transformer.cpp:8-32): keep a face iff all three corners share one
    object id OR none of them is the target object."""
    ids = np.asarray(object_ids)
    f = mesh.faces
    a, b, c = ids[f[:, 0]], ids[f[:, 1]], ids[f[:, 2]]
    same = (a == b) & (b == c)
    none_target = (a != target_object) & (b != target_object) & (c != target_object)
    keep = same | none_target
    return dataclasses.replace(mesh, faces=f[keep])


def move_object_vertices(mesh: Mesh, object_ids, target_object,
                         transform) -> Mesh:
    """Rigidly transform the target object's vertices (+normals by the
    inverse-transpose), mesh_transformer.cpp:34-60."""
    ids = np.asarray(object_ids)
    t = np.asarray(transform, np.float32)
    sel = ids == target_object
    v = mesh.vertices.copy()
    hom = np.concatenate([v[sel], np.ones((sel.sum(), 1), np.float32)], axis=1)
    v[sel] = (hom @ t.T)[:, :3]
    normals = mesh.normals
    if normals is not None:
        it = np.linalg.inv(t[:3, :3]).T
        normals = normals.copy()
        normals[sel] = normals[sel] @ it.T
    return dataclasses.replace(mesh, vertices=v, normals=normals)

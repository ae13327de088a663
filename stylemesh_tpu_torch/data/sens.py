"""ScanNet ``.sens`` stream extraction.

A copy of ``stylemesh_tpu/data/sens.py`` (the port imports nothing of
the JAX package).

Equivalent of scripts/scannet/prepare_data/ (the vendored
ScanNet SensorData decoder + prepare_2d_data.py): decode the binary RGB-D
stream (v4: zlib'd uint16 depth, jpeg color, per-frame cam2world pose) and
export every ``frame_skip``-th frame as ``color/<i>.jpg`` (resized, default
320x240 like the reference), ``depth/<i>.png`` (uint16 mm, native depth
resolution), ``pose/<i>.txt`` and the ``_info`` intrinsics fields the data
layer's ``<scene>.txt`` parser expects.

Streaming (no whole-file slurp) — scans are multi-GB.
"""

import os
import struct
import zlib
from os.path import join

import numpy as np

_COLOR_COMPRESSION = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
_DEPTH_COMPRESSION = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}


class SensReader:
    """Iterates frames of a .sens file without loading it into memory."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "rb")
        f = self._f
        version = struct.unpack("I", f.read(4))[0]
        assert version == 4, f"unsupported .sens version {version}"
        strlen = struct.unpack("Q", f.read(8))[0]
        self.sensor_name = f.read(strlen).decode("ascii", "replace")
        self.intrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.extrinsic_color = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.intrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.extrinsic_depth = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
        self.color_compression = _COLOR_COMPRESSION[struct.unpack("i", f.read(4))[0]]
        self.depth_compression = _DEPTH_COMPRESSION[struct.unpack("i", f.read(4))[0]]
        self.color_width = struct.unpack("I", f.read(4))[0]
        self.color_height = struct.unpack("I", f.read(4))[0]
        self.depth_width = struct.unpack("I", f.read(4))[0]
        self.depth_height = struct.unpack("I", f.read(4))[0]
        self.depth_shift = struct.unpack("f", f.read(4))[0]
        self.num_frames = struct.unpack("Q", f.read(8))[0]

    def __iter__(self):
        f = self._f
        for _ in range(self.num_frames):
            pose = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
            f.read(16)  # color + depth timestamps
            color_bytes = struct.unpack("Q", f.read(8))[0]
            depth_bytes = struct.unpack("Q", f.read(8))[0]
            color_data = f.read(color_bytes)
            depth_data = f.read(depth_bytes)
            yield pose, color_data, depth_data

    def decode_color(self, color_data):
        if self.color_compression == "jpeg":
            import cv2

            arr = np.frombuffer(color_data, np.uint8)
            return cv2.cvtColor(cv2.imdecode(arr, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        if self.color_compression == "raw":
            return np.frombuffer(color_data, np.uint8).reshape(
                self.color_height, self.color_width, 3)
        raise ValueError(f"unsupported color compression {self.color_compression}")

    def decode_depth(self, depth_data):
        if self.depth_compression == "zlib_ushort":
            raw = zlib.decompress(depth_data)
        elif self.depth_compression == "raw_ushort":
            raw = depth_data
        else:
            raise ValueError(f"unsupported depth compression {self.depth_compression}")
        return np.frombuffer(raw, np.uint16).reshape(
            self.depth_height, self.depth_width)

    def close(self):
        self._f.close()


def remap_labels(label_image, mapping):
    """Remap a label image through a {raw_id: target_id} mapping — the
    reference's label-export remap (prepare_2d_data.py label path + util.py).
    ``mapping`` can come from :func:`load_label_mapping`."""
    label = np.asarray(label_image)
    out = np.zeros_like(label)
    for src, dst in mapping.items():
        out[label == src] = dst
    return out


def load_label_mapping(tsv_path, label_from="id", label_to="nyu40id"):
    """Parse the ScanNet labels .tsv into a remap dict (util.py semantics)."""
    import csv

    mapping = {}
    with open(tsv_path) as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            if row[label_from] and row[label_to]:
                mapping[int(row[label_from])] = int(row[label_to])
    return mapping


def extract_sens(path, out_dir, frame_skip=20, image_size=(240, 320)):
    """Export a .sens to the scene layout (prepare_2d_data.py semantics:
    every ``frame_skip``-th frame, color resized to ``image_size`` (h, w),
    depth at native resolution). Returns the number of exported frames."""
    import cv2

    r = SensReader(path)
    for sub in ("color", "depth", "pose"):
        os.makedirs(join(out_dir, sub), exist_ok=True)

    # intrinsics file in the <scene>.txt format the dataset parses
    scene_name = os.path.basename(out_dir.rstrip("/")) or "scene"
    k = r.intrinsic_color
    sy = image_size[0] / r.color_height if image_size else 1.0
    sx = image_size[1] / r.color_width if image_size else 1.0
    with open(join(out_dir, f"{scene_name}.txt"), "w") as f:
        f.write(f"fx_color = {k[0, 0] * sx}\nfy_color = {k[1, 1] * sy}\n")
        f.write(f"mx_color = {k[0, 2] * sx}\nmy_color = {k[1, 2] * sy}\n")
        f.write(f"colorWidth = {image_size[1] if image_size else r.color_width}\n")
        f.write(f"colorHeight = {image_size[0] if image_size else r.color_height}\n")
        f.write(f"depthWidth = {r.depth_width}\ndepthHeight = {r.depth_height}\n")
        f.write(f"depthShift = {r.depth_shift}\n")

    n = 0
    for i, (pose, color_data, depth_data) in enumerate(r):
        if i % frame_skip != 0:
            continue
        if not np.all(np.isfinite(pose)):
            continue  # untracked frames have -inf poses
        color = r.decode_color(color_data)
        if image_size is not None:
            color = cv2.resize(color, (image_size[1], image_size[0]),
                               interpolation=cv2.INTER_AREA)
        depth = r.decode_depth(depth_data)
        cv2.imwrite(join(out_dir, "color", f"{i}.jpg"),
                    cv2.cvtColor(color, cv2.COLOR_RGB2BGR))
        cv2.imwrite(join(out_dir, "depth", f"{i}.png"), depth)
        with open(join(out_dir, "pose", f"{i}.txt"), "w") as f:
            for row in pose:
                f.write(" ".join(str(v) for v in row) + "\n")
        n += 1
    r.close()
    return n


def main(argv=None):
    """.sens extraction CLI — the runnable twin of the reference's
    ``scripts/scannet/prepare_data/reader.py`` / ``prepare_2d_data.py``."""
    import argparse

    p = argparse.ArgumentParser(description="extract a ScanNet .sens file")
    p.add_argument("--filename", required=True, help="path to .sens file")
    p.add_argument("--output_path", required=True, help="scene output folder")
    p.add_argument("--frame_skip", type=int, default=20,
                   help="export every Nth frame (prepare_2d_data default)")
    p.add_argument("--image_size", nargs=2, type=int, default=(240, 320),
                   help="color resize (h, w); pass 0 0 for native size")
    a = p.parse_args(argv)
    size = None if tuple(a.image_size) == (0, 0) else tuple(a.image_size)
    n = extract_sens(a.filename, a.output_path, frame_skip=a.frame_skip,
                     image_size=size)
    print(f"exported {n} frames to {a.output_path}")


if __name__ == "__main__":
    main()

"""Frame quality filtering.

A copy of ``stylemesh_tpu/data/filters.py`` (the port imports nothing of
the JAX package).

Equivalent of scripts/scannet/filter/filter_blurry.py:41-92:
frames whose variance-of-Laplacian sharpness is below a threshold (reference
default 150) are moved — together with their depth/pose/label/instance
siblings — into a ``filtered/`` subtree; ``undo`` restores them.
"""

import os
import shutil
from os.path import exists, join


SIBLING_DIRS = ("depth", "pose", "label", "instance")
SIBLING_EXT = {"depth": ".png", "pose": ".txt", "label": ".png", "instance": ".png"}


def sharpness(image_path):
    """Variance of the Laplacian (higher = sharper)."""
    import cv2

    img = cv2.imread(image_path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        return 0.0
    return float(cv2.Laplacian(img, cv2.CV_64F).var())


def filter_blurry(scene_dir, threshold=150.0, dry_run=False):
    """Move blurry frames (+ siblings) to ``<scene>/filtered/...``.

    Returns the list of filtered frame ids.
    """
    color_dir = join(scene_dir, "color")
    filtered = []
    for fname in sorted(os.listdir(color_dir),
                        key=lambda x: int(x.split(".")[0])):
        frame = fname.split(".")[0]
        if sharpness(join(color_dir, fname)) < threshold:
            filtered.append(frame)
            if dry_run:
                continue
            dst_color = join(scene_dir, "filtered", "color")
            os.makedirs(dst_color, exist_ok=True)
            shutil.move(join(color_dir, fname), join(dst_color, fname))
            for sub in SIBLING_DIRS:
                src = join(scene_dir, sub, frame + SIBLING_EXT[sub])
                if exists(src):
                    dst = join(scene_dir, "filtered", sub)
                    os.makedirs(dst, exist_ok=True)
                    shutil.move(src, join(dst, frame + SIBLING_EXT[sub]))
    return filtered


def undo_filter(scene_dir):
    """Restore everything under ``filtered/`` (the reference's --undo)."""
    froot = join(scene_dir, "filtered")
    if not exists(froot):
        return 0
    n = 0
    for sub in ("color",) + SIBLING_DIRS:
        src_dir = join(froot, sub)
        if not exists(src_dir):
            continue
        dst_dir = join(scene_dir, sub)
        os.makedirs(dst_dir, exist_ok=True)
        for fname in os.listdir(src_dir):
            shutil.move(join(src_dir, fname), join(dst_dir, fname))
            n += 1
    shutil.rmtree(froot)
    return n


def main(argv=None):
    """Blur-filter CLI — the runnable twin of the reference's
    ``scripts/scannet/filter/filter_blurry.py`` (threshold, --undo)."""
    import argparse

    p = argparse.ArgumentParser(description="move blurry frames aside")
    p.add_argument("--dir", required=True, help="scene folder with color/")
    p.add_argument("--threshold", type=float, default=150.0,
                   help="Laplacian-variance sharpness floor")
    p.add_argument("--dry_run", action="store_true",
                   help="report without moving (reference --debug)")
    p.add_argument("--undo", action="store_true",
                   help="restore everything under filtered/")
    a = p.parse_args(argv)
    if a.undo:
        n = undo_filter(a.dir)
        print(f"restored {n} files")
    else:
        ids = filter_blurry(a.dir, threshold=a.threshold, dry_run=a.dry_run)
        verb = "would filter" if a.dry_run else "filtered"
        print(f"{verb} {len(ids)} frames: {ids}")


if __name__ == "__main__":
    main()

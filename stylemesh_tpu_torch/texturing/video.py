"""Video assembly from rendered frames (counterpart of
``stylemesh_tpu/texturing/video.py``): frames sorted (integer names for
ScanNet, pano names for Matterport) and written as mp4 (``mp4v``) at 20
fps by OpenCV (imported where frames are read). Host code only.

    python -m stylemesh_tpu_torch.texturing.video --imgs_dir <frames> \\
        [--out video.mp4] [--fps 20]
"""

import os


def _sort_key(path):
    stem = os.path.basename(path).split(".")[0]
    try:
        return (0, int(stem), "")
    except ValueError:
        parts = stem.split("_")
        try:  # matterport pano naming <pano>_i<cam>_<yaw>
            return (1, int(parts[1][1]) * 100 + int(parts[2]), parts[0])
        except (IndexError, ValueError):
            return (2, 0, stem)


def video_from_files(frame_paths, out_path, fps=20):
    """Write ``frame_paths``, sorted, to ``out_path`` (mp4, 20 fps default);
    frames of another size than the first are resized to it."""
    import cv2

    paths = sorted(frame_paths, key=_sort_key)
    if not paths:
        raise ValueError("no frames to assemble")
    first = cv2.imread(paths[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    try:
        for p in paths:
            frame = cv2.imread(p)
            if frame.shape[:2] != (h, w):
                frame = cv2.resize(frame, (w, h))
            writer.write(frame)
    finally:
        writer.release()
    return out_path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="assemble frames into a video")
    p.add_argument("--imgs_dir", required=True)
    p.add_argument("--out", default=None,
                   help="output file (default <imgs_dir>/video.mp4)")
    p.add_argument("--fps", type=int, default=20)
    a = p.parse_args(argv)
    frames = [os.path.join(a.imgs_dir, f) for f in os.listdir(a.imgs_dir)
              if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    out = a.out or os.path.join(a.imgs_dir, "video.mp4")
    video_from_files(frames, out, fps=a.fps)
    print(f"wrote {out} ({len(frames)} frames)")


if __name__ == "__main__":
    main()

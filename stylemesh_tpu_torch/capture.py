"""Interactive fly-camera capture + novel-pose uv-pyramid bake (counterpart
of ``stylemesh_tpu/capture.py``).

Headless twin of the reference's GLFW WASD capture loop
(scripts/scannet/render_uv/src/renderer/renderer.cpp:268-375) and its
capture -> multi-size uv render loop (src/main.cpp:80-140): navigate the
mesh from the terminal (ANSI half-block preview rendered by the native
rasterizer, host code — no GL anywhere), capture poses, and on exit bake
the captured poses' multi-size uv pyramid with
:func:`stylemesh_tpu_torch.preprocess.bake_scene` (``--backend torch``: the
PyTorch rasterizer on the card, or on the CPU with ``--platform cpu``) —
the exact output contract training and the mipmap renderer consume
(``pose_novel/<i>.txt`` + ``uv/`` + ``uv_<h>/`` folders).

Controls: ``w``/``s`` forward/back, ``a``/``d`` strafe, ``q``/``e``
down/up, ``j``/``l`` yaw, ``i``/``k`` pitch (arrow keys work too),
``c`` or SPACE capture the current pose, ``r`` reset, ``x`` / ESC / EOF
quit and bake.

Non-interactive use (CI, scripted paths): pipe the key string on stdin
(``echo "w w c l l c x" | python -m stylemesh_tpu_torch.capture ...``) —
when stdin is not a TTY the same key language is read as whitespace-separated
tokens. ``--orbit`` / ``--keyframes`` skip navigation entirely and capture
a synthesized trajectory (geometry/trajectories.py).
"""

import os
import re
import sys
from os.path import join

import numpy as np

from stylemesh_tpu_torch.geometry.mesh_io import load_mesh
from stylemesh_tpu_torch.geometry.trajectories import (interpolate_poses,
                                                       orbit_poses,
                                                       write_pose_dir)
from stylemesh_tpu_torch.preprocess import (BACKENDS, DEFAULT_PYRAMID_HEIGHTS,
                                            bake_scene, bake_view)

ESC = "\x1b"


def pose_from(eye, yaw, pitch):
    """cam2world from eye + yaw/pitch (x right, y down, +z forward; world
    up is -z — the baked ScanNet pose convention, geometry/trajectories.py)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    fwd = np.array([cy * cp, sy * cp, sp])
    right = np.cross(fwd, [0.0, 0.0, -1.0])
    n = np.linalg.norm(right)
    right = np.array([1.0, 0.0, 0.0]) if n < 1e-6 else right / n
    down = np.cross(fwd, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, down, fwd, eye
    return m


def _preview(mesh, pose, k, hw, texture):
    """[H,W,3] uint8 preview frame via the native rasterizer."""
    if texture is not None:
        from stylemesh_tpu_torch.geometry.native import render_textured_native

        img = render_textured_native(mesh.vertices, mesh.faces, mesh.uvs,
                                     mesh.normals, pose, k, hw, texture)
    elif mesh.colors is not None:
        from stylemesh_tpu_torch.geometry.native import render_vertex_colors_native

        img = render_vertex_colors_native(mesh.vertices, mesh.faces,
                                          mesh.colors, mesh.normals, pose,
                                          k, hw)
    else:  # Lambert-ish shading from the baked angle map
        _, ang3, depth3 = bake_view(mesh, pose, k, hw)
        shade = np.cos(np.deg2rad(np.clip(ang3, 0.0, 90.0)))
        img = np.where(depth3 > 0, 0.15 + 0.85 * shade, 0.0)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def ansi_frame(img):
    """Render [H,W,3] uint8 as 24-bit half-block rows (2 pixels / char)."""
    h = img.shape[0] - (img.shape[0] % 2)
    rows = []
    for y in range(0, h, 2):
        row = []
        for t, b in zip(img[y], img[y + 1]):
            row.append(f"{ESC}[38;2;{t[0]};{t[1]};{t[2]}m"
                       f"{ESC}[48;2;{b[0]};{b[1]};{b[2]}m▀")
        rows.append("".join(row) + f"{ESC}[0m")
    return "\n".join(rows)


def _read_keys_tty():
    """Yield key tokens from a raw TTY (arrows mapped to ijkl)."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    arrows = {"A": "i", "B": "k", "C": "l", "D": "j"}
    try:
        tty.setcbreak(fd)
        while True:
            ch = sys.stdin.read(1)
            if ch == ESC:
                # a lone ESC quits; an arrow key arrives as ESC [ A..D.
                # In cbreak mode read(1) would block forever on a bare ESC,
                # so poll briefly to distinguish the two.
                import select

                ready, _, _ = select.select([fd], [], [], 0.05)
                if not ready:
                    yield "x"
                    continue
                nxt = sys.stdin.read(1)
                if nxt != "[":
                    yield "x"
                    continue
                yield arrows.get(sys.stdin.read(1), "")
            elif ch == "":
                yield "x"
            else:
                yield ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def _read_keys_scripted():
    """Whitespace-separated key tokens from piped stdin (CI / scripting)."""
    for tok in sys.stdin.read().split():
        yield tok
    yield "x"


def fly(mesh, k, hw, texture=None, start=None, speed=0.25,
        turn_deg=10.0, out=sys.stdout, interactive=None):
    """Run the capture loop; returns the list of captured cam2world poses.

    The reference's loop polls GLFW keys and moves `cameraSpeed * deltaTime`
    along the look/right axes (renderer.cpp:336-375); here each keypress is
    one fixed-size move and the preview redraws after every key.
    """
    lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
    center, extent = (lo + hi) / 2.0, float(np.linalg.norm(hi - lo) / 2.0)
    if start is None:
        start = center - np.array([1.5 * extent, 0.0, 0.0])
    eye, yaw, pitch = np.array(start, np.float64), 0.0, 0.0
    captured = []
    if interactive is None:
        interactive = sys.stdin.isatty()
    keys = _read_keys_tty() if interactive else _read_keys_scripted()
    turn = np.deg2rad(turn_deg)

    def draw():
        pose = pose_from(eye, yaw, pitch)
        frame = ansi_frame(_preview(mesh, pose, k, hw, texture))
        status = (f"eye [{eye[0]:.2f} {eye[1]:.2f} {eye[2]:.2f}] "
                  f"yaw {np.rad2deg(yaw):.0f} pitch {np.rad2deg(pitch):.0f} "
                  f"| captured {len(captured)} | wasdqe move, ijkl look, "
                  f"c/SPACE capture, r reset, x quit")
        if interactive:
            out.write(f"{ESC}[H{ESC}[2J")
        out.write(frame + "\n" + status + "\n")
        out.flush()
        return pose

    pose = draw()
    for key in keys:
        m = pose_from(eye, yaw, pitch)
        fwd, right = m[:3, 2].astype(np.float64), m[:3, 0].astype(np.float64)
        if key == "w":
            eye += speed * fwd
        elif key == "s":
            eye -= speed * fwd
        elif key == "a":
            eye -= speed * right
        elif key == "d":
            eye += speed * right
        elif key == "q":
            eye[2] += speed  # world down is +z
        elif key == "e":
            eye[2] -= speed
        elif key == "j":
            yaw -= turn
        elif key == "l":
            yaw += turn
        elif key == "i":
            pitch = max(pitch - turn, -np.pi / 2 + 1e-3)
        elif key == "k":
            pitch = min(pitch + turn, np.pi / 2 - 1e-3)
        elif key in ("c", " "):
            captured.append(pose_from(eye, yaw, pitch))
        elif key == "r":
            eye, yaw, pitch = np.array(start, np.float64), 0.0, 0.0
        elif key in ("x", "\x03", "\x04"):
            break
        pose = draw()
    return captured


def _intrinsics(args):
    """(K, (w, h)) — from the scene dir or synthesized from --fov."""
    if args.scene_dir:
        from stylemesh_tpu_torch.data.scenes import _scannet_intrinsics

        k, size, _ = _scannet_intrinsics(args.scene_dir)
        return np.asarray(k, np.float32), size
    h, w = args.base_hw
    f = (w / 2.0) / np.tan(np.deg2rad(args.fov) / 2.0)
    k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
    return k, (w, h)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="fly-camera novel-pose capture + uv pyramid bake")
    p.add_argument("--mesh", required=True, help="UV-unwrapped mesh")
    p.add_argument("--out", required=True,
                   help="scene dir to write pose_novel/ + uv pyramids into")
    p.add_argument("--scene_dir", default=None,
                   help="baked scene dir to take intrinsics from")
    p.add_argument("--fov", type=float, default=60.0,
                   help="horizontal fov when no --scene_dir intrinsics")
    p.add_argument("--base_hw", nargs=2, type=int, default=(960, 1280))
    p.add_argument("--pyramid_heights", nargs="+", type=int,
                   default=list(DEFAULT_PYRAMID_HEIGHTS))
    p.add_argument("--texture", default=None,
                   help="texture image for the preview render")
    p.add_argument("--preview_hw", nargs=2, type=int, default=None,
                   help="preview resolution (default: fit the terminal)")
    p.add_argument("--speed", type=float, default=0.25, help="meters/keypress")
    p.add_argument("--orbit", nargs=5, type=float, default=None,
                   metavar=("CX", "CY", "CZ", "RADIUS", "N"),
                   help="skip navigation: capture an orbit trajectory")
    p.add_argument("--keyframes", default=None,
                   help="pose dir: capture a slerp path through its poses")
    p.add_argument("--steps_per_segment", type=int, default=30)
    p.add_argument("--no_bake", action="store_true",
                   help="only write pose_novel/, skip the uv pyramid bake")
    p.add_argument("--backend", default="native", choices=BACKENDS,
                   help="rasterizer of the bake: native C++ on the host, or "
                        "the PyTorch one on --platform")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="device of the torch backend (default: the card)")
    args = p.parse_args(argv)

    mesh = load_mesh(args.mesh).with_generated_normals()
    k, size = _intrinsics(args)

    if args.orbit is not None:
        cx, cy, cz, radius, n = args.orbit
        captured = orbit_poses((cx, cy, cz), radius, 0.0, n=int(n))
    elif args.keyframes is not None:
        from stylemesh_tpu_torch.data.loading import load_extrinsics

        # only numeric pose files (write_pose_dir's contract); skip stray
        # intrinsics/notes .txt files instead of crashing
        keys = sorted((f for f in os.listdir(args.keyframes)
                       if re.fullmatch(r"\d+\.txt", f)),
                      key=lambda x: int(x.split(".")[0]))
        captured = interpolate_poses(
            [load_extrinsics(join(args.keyframes, f)) for f in keys],
            steps_per_segment=args.steps_per_segment)
    else:
        texture = None
        if args.texture:
            from PIL import Image

            texture = np.asarray(Image.open(args.texture).convert("RGB"),
                                 np.float32) / 255.0
        if args.preview_hw is None:
            import shutil

            cols, rows = shutil.get_terminal_size((100, 30))
            ph = max(2 * (rows - 3), 16)
            args.preview_hw = (ph, min(cols - 1, int(ph * size[0] / size[1])))
        from stylemesh_tpu_torch.data.loading import rescale_intrinsics

        pk = rescale_intrinsics(k, size, (args.preview_hw[1],
                                          args.preview_hw[0]))
        captured = fly(mesh, pk, tuple(args.preview_hw), texture=texture,
                       speed=args.speed)

    if not captured:
        print("no poses captured; nothing to bake")
        return 0
    pose_dir = write_pose_dir(captured, join(args.out, "pose_novel"))
    print(f"wrote {len(captured)} poses -> {pose_dir}")
    if not args.no_bake:
        n = bake_scene(args.mesh, pose_dir, k, size, args.out,
                       base_hw=tuple(args.base_hw),
                       pyramid_heights=tuple(args.pyramid_heights),
                       backend=args.backend,
                       device="cpu" if args.platform == "cpu" else None)
        print(f"baked uv pyramid for {n} novel poses -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

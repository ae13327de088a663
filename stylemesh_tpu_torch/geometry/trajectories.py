"""Novel-pose trajectory synthesis.

A copy of ``stylemesh_tpu/geometry/trajectories.py`` (the port imports nothing of
the JAX package).

The reference's interactive WASD fly-camera (renderer.cpp:268-375) captures
custom pose sets that are then baked into UV pyramids ("closeup" /
"orthogonal" scene variants). Headless equivalent: generate smooth pose
trajectories programmatically — keyframe interpolation (slerp on rotations)
and orbits — and write them as ``pose/<i>.txt`` files for
:func:`stylemesh_tpu_torch.preprocess.bake_scene`.
"""

import os
from os.path import join

import numpy as np


def _quat_from_mat(m):
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = np.argmax(np.diag(m))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def _mat_from_quat(q):
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0, q1, t):
    d = np.dot(q0, q1)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(theta)


def interpolate_poses(keyframes, steps_per_segment=30):
    """Smooth cam2world path through 4x4 keyframe poses (slerp + lerp)."""
    keyframes = [np.asarray(k, np.float64) for k in keyframes]
    out = []
    for a, b in zip(keyframes[:-1], keyframes[1:]):
        qa, qb = _quat_from_mat(a[:3, :3]), _quat_from_mat(b[:3, :3])
        for s in range(steps_per_segment):
            t = s / steps_per_segment
            m = np.eye(4)
            m[:3, :3] = _mat_from_quat(_slerp(qa, qb, t))
            m[:3, 3] = (1 - t) * a[:3, 3] + t * b[:3, 3]
            out.append(m.astype(np.float32))
    out.append(keyframes[-1].astype(np.float32))
    return out


def orbit_poses(center, radius, height, n=60, look_at=None):
    """Circular orbit around ``center`` looking inward (+z forward,
    y-down pinhole convention like the baked ScanNet poses)."""
    center = np.asarray(center, np.float64)
    look_at = center if look_at is None else np.asarray(look_at, np.float64)
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = center + np.array([radius * np.cos(a), radius * np.sin(a), height])
        fwd = look_at - eye
        fwd = fwd / np.linalg.norm(fwd)
        up_hint = np.array([0.0, 0.0, -1.0])
        right = np.cross(fwd, up_hint)
        if np.linalg.norm(right) < 1e-6:
            right = np.array([1.0, 0.0, 0.0])
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        m = np.eye(4)
        m[:3, 0] = right
        m[:3, 1] = down
        m[:3, 2] = fwd
        m[:3, 3] = eye
        poses.append(m.astype(np.float32))
    return poses


def write_pose_dir(poses, out_dir):
    """Write ``<i>.txt`` cam2world files (the baked-pose contract)."""
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(poses):
        with open(join(out_dir, f"{i}.txt"), "w") as f:
            for row in p:
                f.write(" ".join(str(v) for v in row) + "\n")
    return out_dir

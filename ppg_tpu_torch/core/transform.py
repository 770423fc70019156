"""Host-side 4x4 transform helpers (numpy), matching Mitsuba conventions.

Reference: mitsuba/src/libcore/transform.cpp (lookAt, perspective, rotate,
scale, translate). Used during scene ingestion only; device code consumes
flattened arrays.

The port's own copy of ppg_tpu/core/transform.py.
"""

from __future__ import annotations

import numpy as np


def translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def scale(v):
    v = np.broadcast_to(np.asarray(v, np.float64), (3,))
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg):
    """Rotation about an arbitrary axis, angle in degrees (right-handed)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))
    x, y, z = a
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) * c + (1 - c) * np.outer(a, a) + s * K
    m = np.eye(4)
    m[:3, :3] = R
    return m


def look_at(origin, target, up):
    """Mitsuba camera-to-world: x = 'left' = normalize(up x dir), y = dir x left,
    z = dir (reference transform.cpp:480-505)."""
    origin = np.asarray(origin, np.float64)
    d = np.asarray(target, np.float64) - origin
    d = d / np.linalg.norm(d)
    left = np.cross(np.asarray(up, np.float64), d)
    n = np.linalg.norm(left)
    if n == 0:
        raise ValueError("lookAt: up parallel to viewing direction")
    left /= n
    new_up = np.cross(d, left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, new_up, d, origin
    return m


def perspective(fov_deg, near, far):
    """Projects camera space onto the z=1 plane with the x field of view
    mapped to [-1, 1] (reference transform.cpp:540-565)."""
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.deg2rad(fov_deg / 2.0))
    return np.array(
        [
            [cot, 0, 0, 0],
            [0, cot, 0, 0],
            [0, 0, far * recip, -near * far * recip],
            [0, 0, 1, 0],
        ]
    )


def apply_point(m, p):
    """Apply 4x4 to points [..., 3] with perspective divide."""
    p = np.asarray(p, np.float64)
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return r / w[..., None] if m[3, :3].any() or m[3, 3] != 1.0 else r


def apply_vector(m, v):
    return np.asarray(v, np.float64) @ m[:3, :3].T


def apply_normal(m, n):
    inv = np.linalg.inv(m[:3, :3])
    return np.asarray(n, np.float64) @ inv

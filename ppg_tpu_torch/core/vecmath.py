"""Batched 3D vector math over float32 tensors shaped [..., 3]
(counterpart of ppg_tpu/core/vecmath.py)."""

from __future__ import annotations

import torch


def dot(a, b):
    return (a * b).sum(-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a):
    return a * (1.0 / torch.clamp(length(a), min=1e-20))[..., None]


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def build_frame(n):
    """Orthonormal basis (s, t) around the unit normal n (branchless
    Duff et al. construction, as in ppg_tpu)."""
    nx, ny, z = n.unbind(-1)
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx ** 2 * a, sign * b, -sign * nx], -1)
    t = torch.stack([b, sign + ny ** 2 * a, -ny], -1)
    return s, t


def to_local(s, t, n, v):
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], -1)


def to_world(s, t, n, v):
    return v[..., 0:1] * s + v[..., 1:2] * t + v[..., 2:3] * n

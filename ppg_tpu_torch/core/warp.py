"""Square-to-distribution warps and the SD-tree's cylindrical map
(counterpart of ppg_tpu/core/warp.py)."""

from __future__ import annotations

import math

import torch

from .vecmath import safe_sqrt

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 1]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def square_to_uniform_disk_concentric(u):
    """Concentric disk map (warp.cpp:81-103, low-branch Cline variant)."""
    r1 = 2.0 * u[..., 0] - 1.0
    r2 = 2.0 * u[..., 1] - 1.0
    use1 = r1 * r1 > r2 * r2
    r = torch.where(use1, r1, r2)
    phi = torch.where(
        use1,
        (math.pi / 4.0) * (r2 / torch.where(r1 == 0.0, 1.0, r1)),
        (math.pi / 2.0) - (r1 / torch.where(r2 == 0.0, 1.0, r2))
        * (math.pi / 4.0),
    )
    zero = (r1 == 0.0) & (r2 == 0.0)
    r = torch.where(zero, 0.0, r)
    phi = torch.where(zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def square_to_cosine_hemisphere(u):
    p = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    z = torch.clamp(z, min=1e-10)
    return torch.stack([p[..., 0], p[..., 1], z], -1)


def square_to_cosine_hemisphere_pdf(w):
    return INV_PI * w[..., 2]


def square_to_uniform_triangle(u):
    """Barycentrics (b1, b2) uniform over the triangle."""
    a = safe_sqrt(1.0 - u[..., 0])
    return torch.stack([1.0 - a, a * u[..., 1]], -1)


def canonical_to_dir(p):
    """Cylindrical equal-area map of the unit square onto the sphere, used
    by the directional quadtrees (guided_path.cpp:586-608)."""
    cos_theta = 2.0 * p[..., 0] - 1.0
    phi = 2.0 * math.pi * p[..., 1]
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], -1)


def dir_to_canonical(d):
    cos_theta = torch.clamp(d[..., 2], -1.0, 1.0)
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    x = (cos_theta + 1.0) / 2.0
    y = phi * INV_TWOPI
    finite = torch.isfinite(d).all(-1)
    return torch.where(finite[..., None], torch.stack([x, y], -1), 0.0)

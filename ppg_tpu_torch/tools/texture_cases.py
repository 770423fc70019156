"""Atlases and lookups for the texture tests and chip_smoke (numpy only):
a texture set with every filter code and procedural kind, and lanes
that reach every branch of sample_atlas, edge cases included."""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np


def atlas_specs(tex_dir, res=64, seed=0):
    """Texture specs over one res x (res - 8) EXR bitmap written into
    tex_dir (noise and stripes from the seed): ewa (the default; tiled and
    offset), trilinear, bilinear, nearest (maxAnisotropy 4), a
    checkerboard, a gridtexture and a `scale` over a checkerboard. Returns
    the specs (ppg_tpu's TextureAtlas.build takes them too)."""
    from ..io import exr

    rng = np.random.default_rng(seed)
    h, w = res, res - 8
    x = np.arange(w) / w
    img = (0.5 + 0.4 * np.sin(2 * np.pi * 5 * x))[None, :, None] \
        * np.ones((h, 1, 3)) + 0.2 * rng.random((h, w, 3))
    exr.write(os.path.join(tex_dir, "tex.exr"), img.astype(np.float32))
    checker = SimpleNamespace(cls="texture", otype="checkerboard",
                              props={"uscale": 2.0}, children=[])
    return [
        dict(_otype="bitmap", filename="tex.exr", uscale=3.0, voffset=0.25),
        dict(_otype="bitmap", filename="tex.exr", filterType="trilinear"),
        dict(_otype="bitmap", filename="tex.exr", filterType="bilinear"),
        dict(_otype="bitmap", filename="tex.exr", filterType="nearest",
             maxAnisotropy=4.0),
        dict(_otype="checkerboard", uscale=4.0, vscale=2.0),
        dict(_otype="gridtexture", lineWidth=0.1),
        dict(_otype="scale", scale=0.5, _children=[checker]),
        dict(_otype="bitmap", filename="tex.exr", uscale=-2.0,
             maxAnisotropy=0.5),
    ]


def lanes(n_slots, L, seed=0, well_conditioned=False):
    """L lookups: slot ids in [-1, n_slots] (plus one past the last: the
    clip), uv in [-2, 2]^2, a footprint and a uv Jacobian. Unless
    `well_conditioned`, the first lanes are the edge cases: a tiled uv
    whose texel coordinate passes 2^31 either way (the saturating floor),
    NaN and infinite uvs, zero differentials, an extreme anisotropy, an
    isotropic Jacobian, and slot ids 0 and -1. With `well_conditioned`
    every Jacobian has an anisotropy at most 16 (the ellipse's F = AC -
    B^2 / 4 is then far above its rounding, which ppg_tpu's XLA and
    PyTorch round differently near 0). Returns a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    tex_id = rng.integers(-1, n_slots + 1, L).astype(np.int32)
    uv = (rng.random((L, 2)) * 4 - 2).astype(np.float32)
    foot = ((rng.random((L, 2)) * 0.3) ** 2).astype(np.float32)
    ang = rng.random(L) * np.pi
    r = 10 ** rng.uniform(-3.5, -0.5, L)
    ratio = 10 ** rng.uniform(0, 1.2, L)
    d0 = np.stack([np.cos(ang) * r, np.sin(ang) * r], -1)
    d1 = np.stack([-np.sin(ang), np.cos(ang)], -1) * (r / ratio)[:, None]
    d0, d1 = d0.astype(np.float32), d1.astype(np.float32)
    if not well_conditioned:
        edge = [
            ((3e9, 0.1), (0.01, 0.01), (0.01, 0), (0, 0.01)),
            ((-3e9, 0.2), (0.01, 0.01), (0.01, 0), (0, 0.01)),
            ((0.3, 5e9), (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
            ((np.nan, 0.3), (np.nan, 0.1), (np.nan, 0), (0, 0.01)),
            ((np.inf, 0.5), (np.inf, 0.1), (np.inf, 0), (0, np.inf)),
            ((0.5, -np.inf), (0.1, 0.1), (0.5, 0), (0, 1e-7)),
            ((0.25, 0.75), (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
            ((0.4, 0.6), (0.5, 0.5), (0.9, 0.0), (0.0, 1e-6)),
            ((0.1, 0.2), (0.05, 0.05), (0.05, 0.0), (0.0, 0.05)),
            ((-0.7, 1.3), (0.0, 0.0), (-0.2, 0.1), (0.1, 0.2)),
        ]
        for k, (u, f, a, b) in enumerate(edge):
            uv[k], foot[k], d0[k], d1[k] = u, f, a, b
            tex_id[k] = 1 + k % min(n_slots - 1, 8)
        tex_id[len(edge)], tex_id[len(edge) + 1] = 0, -1
    return dict(tex_id=tex_id, uv=uv, foot=foot, d0=d0, d1=d1)

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


def edge_atlas_specs(tex_dir, res=16, seed=0):
    """The edges of K9's level skip, apart from atlas_specs: res x res
    float32 EXR bitmaps (noise from the seed) written into tex_dir, whose
    slots differ in tap_safe: clean (ewa; trilinear with uscale 2), a NaN
    texel (ewa; nearest), a negative texel (trilinear), a left half of -0
    (ewa; bilinear), a left half of +0 (trilinear) and flat corners beside
    two bright texels (ewa; these two flagged beside the clean ones), and
    a checkerboard. Returns the specs."""
    from ..io import exr

    rng = np.random.default_rng(seed)
    base = (0.2 + rng.random((res, res, 3))).astype(np.float32)
    imgs = {"clean": base, "nan": base.copy(), "neg": base.copy(),
            "mzero": base.copy(), "pzero": base.copy()}
    imgs["nan"][res // 3, res // 2 + 1, 1] = np.nan
    imgs["neg"][res // 2, res // 4, 0] = -0.5
    imgs["mzero"][:, :res // 2] = -0.0
    imgs["pzero"][:, :res // 2] = 0.0
    # flat at level 0's corners, not at level 1's: a lookup far past 2^31
    # texels, whose floor saturates to a corner, extrapolates level 0 to a
    # finite value and level 1 past the float range
    imgs["corner"] = np.full((res, res, 3), 0.5, np.float32)
    imgs["corner"][[2, res - 2], [2, res - 2]] = 60000.0
    for name, img in imgs.items():
        exr.write(os.path.join(tex_dir, f"edge_{name}.exr"), img,
                  pixel_type="float")

    def bitmap(name, **kw):
        return dict(_otype="bitmap", filename=f"edge_{name}.exr", **kw)

    return [
        bitmap("clean"),
        bitmap("nan"),
        bitmap("neg", filterType="trilinear"),
        bitmap("mzero"),
        bitmap("pzero", filterType="trilinear"),
        bitmap("mzero", filterType="bilinear"),
        bitmap("nan", filterType="nearest"),
        bitmap("clean", filterType="trilinear", uscale=2.0, uoffset=0.5),
        bitmap("corner"),
        dict(_otype="checkerboard", uscale=2.0),
    ]


def edge_lanes(meta, uvx, seed=0, n_random=256):
    """Lookups for edge_atlas_specs' atlas (its meta and uvx arrays): for
    each slot (and the white ids 0 and -1, and one past the last), lanes
    in a shuffled order: n_random uvs with zero footprints and Jacobians
    (a later bounce's lookups: lod 0, fraction 0); footprints and
    isotropic Jacobians at the integer lods 0-5, 8, 11, 12 (the clamp), 13
    and 30 and at half-integer ones; uvs whose texel coordinates pass 2^31
    at level 0 or 1 at fraction 0, or pass it far in u and v; NaN footprints and Jacobians (a NaN
    lod), infinite ones, NaN, infinite and -0 uvs; anisotropic Jacobians
    along u or v (one offset of the taps zero) and in other directions,
    whose four taps run at lod 0 (magnified) or above. Returns a dict of
    numpy arrays as `lanes` does."""
    rng = np.random.default_rng(seed)
    S = meta.shape[0]
    rows = []  # (slot, u, v, fu, fv, d0u, d0v, d1u, d1v)
    for s in list(range(1, S + 1)) + [0, -1]:
        c = min(max(s, 0), S - 1)
        su = abs(float(uvx[c, 0])) * float(meta[c, 1])
        sv = abs(float(uvx[c, 1])) * float(meta[c, 2])
        for u, v in rng.random((n_random, 2)) * 3 - 1:
            rows.append((s, u, v, 0, 0, 0, 0, 0, 0))
        for k in (0, 1, 2, 3, 4, 5, 8, 11, 12, 13, 30, 0.5, 2.5, 12.5):
            r = 2.0 ** k
            for u, v in rng.random((2, 2)):
                rows.append((s, u, v, r / su, 0, r / su, 0, 0, r / sv))
        for u in (2e8, -2e8, 1e9, -1e9, 2.0 ** 28, 2.0 ** 28 * (1 - 2 ** -10),
                  3e9):
            for k in (0, 1, 3):
                r = 2.0 ** k
                rows.append((s, u, 0.3, r / su, 0, r / su, 0, 0, r / sv))
                rows.append((s, 0.6, u, 0, r / sv, 0, r / sv, r / su, 0))
        for u, v in ((1e18, 1e18), (-1e18, 1e18), (1e18, -1e18)):
            rows.append((s, u, v, 0, 0, 0, 0, 0, 0))
            rows.append((s, u, v, 2 / su, 0, 2 / su, 0, 0, 2 / sv))
        for x in (np.nan, np.inf, -np.inf):
            rows.append((s, 0.4, 0.6, x, 0.1, x, 0, 0, 0.01))
            rows.append((s, 0.4, 0.6, 0.1, x, 0, x, 0.01, 0))
            rows.append((s, x, 0.6, 0, 0, 0, 0, 0, 0))
            rows.append((s, 0.2, x, 0.01, 0.01, 0.01, 0, 0, 0.01))
        for d in (0.0, 0.5, 4.0):
            rows.append((s, -0.0, -0.0, d / su, d / sv, d / su, 0, 0, d / sv))
        for k in (-1, 0.5, 2, 5):
            # anisotropic along v, or along u: one tap offset is zero
            r = 2.0 ** k
            u, v = rng.random(2)
            rows.append((s, u, v, r / su, r / sv, 0, 4 * r / sv, r / su, 0))
            rows.append((s, v, u, r / su, r / sv, 4 * r / su, 0, 0, r / sv))
        for _ in range(32):
            ang = rng.random() * np.pi
            r = 10 ** rng.uniform(-1, 2.5) / su
            ratio = 10 ** rng.uniform(0.3, 1.5)
            u, v = rng.random(2)
            rows.append((s, u, v, r, r, np.cos(ang) * r, np.sin(ang) * r,
                         -np.sin(ang) * r / ratio, np.cos(ang) * r / ratio))
    a = np.array(rows, np.float64)[rng.permutation(len(rows))]
    f32 = lambda x: x.astype(np.float32)
    return dict(tex_id=a[:, 0].astype(np.int32), uv=f32(a[:, 1:3]),
                foot=f32(a[:, 3:5]), d0=f32(a[:, 5:7]), d1=f32(a[:, 7:9]))

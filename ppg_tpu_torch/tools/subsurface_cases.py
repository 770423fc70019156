"""Inputs for K12 (csrc/subsurface.cu) and lo_sub_plain, in numpy only:
shared by tests/test_torch_subsurface.py (against ppg_tpu, and K12 under
tools/cuda_shim.py), tests/test_torch_subsurface_gpu.py (on a card) and
chip_smoke.py.

A case is a point cloud and a set of lanes. Each owner's points lie on a
sphere of radius 0.3 around its own centre, with marble-like dipole
constants (subsurface.dipole_params of MARBLE, Jensen's marble at scale 8,
or of its variants), and each lane sits on or near the sphere of its
owner. Lanes are -1 or an owner, with cos_o drawn over [-0.3, 1] and
some at exactly +0 and -0; the lane counts are not multiples of K12's
256-lane tile. Some cases take K12 to its edges: lanes exactly on points
(d2 = 0), points so far that the exponential underflows or d2 leaves the
guard's range, an owner whose constants lie outside it, every lane gated
in, a whole number of 32-lane groups gated in and one lane more, and
single-owner tiles beside a tile that two owners share.
"""

from __future__ import annotations

import numpy as np

from ..subsurface import PT_BLOCK, dipole_params

MARBLE = dict(sigma_s=[17.52, 20.96, 24.0], sigma_a=[0.0168, 0.0328, 0.0568],
              g=0.0, eta=1.3)

# name -> (lanes, seed, owners' tiles, how the cloud is laid out)
CASES = {
    "several owners": (1000, 31, (1, 2, 3), "aligned"),
    "one tile": (300, 32, (1,), "aligned"),
    "many tiles": (777, 33, (10,), "aligned"),
    "padded repeats and a zero area": (700, 34, (2,), "padded"),
    "a non-finite E in one owner": (600, 35, (1, 2), "nonfinite"),
    "interleaved owners": (513, 36, (2, 2), "interleaved"),
    # more lane tiles than the shim's six blocks: a block's queue carries
    # its remainder from one tile to the next
    "many lanes": (4000, 37, (2, 3), "aligned"),
    "more tiles than a window": (600, 38, (40,), "aligned"),
    # spans of K12's warps (24 here, under the shim) longer than the head
    # tiles a warp sums before it waits (HCAP)
    "heads longer than a warp holds": (700, 47, (64,), "aligned"),
    # lanes exactly on points of their owner: d2 = 0
    "lanes on points": (500, 39, (2, 1), "on points"),
    # points 200 away (every exponential underflows) and 2^20 away (d2
    # above the guard's 2^39)
    "far points": (500, 40, (2, 2), "far"),
    # an owner with zr and zv below the guard's 2^-20, its lanes on
    # points (or its exitance would be denormal)
    "an owner outside the guard": (500, 41, (1, 2), "tiny mfp"),
    "every lane gated in": (700, 42, (3,), "all gated"),
    # exactly 4 and 5 whole 32-lane groups, and one lane more
    "128 lanes gated in": (1000, 43, (2, 2), "gated 128"),
    "129 lanes gated in": (1000, 44, (2, 2), "gated 129"),
    # owner 0's tiles 0-1 and owner 1's 3-4 beside tile 2, half of each
    "single-owner tiles beside a shared tile": (800, 45, (3, 2),
                                                "beside shared"),
    # lanes whose d2 + z^2 with a point at the origin makes dr or dd an
    # all-ones significand (the guard's IEEE path)
    "all-ones significands": (400, 46, (1,), "all ones"),
}


def _rows(n, tiny=False):
    """n dipole rows: marble, then its variants (the last of three with
    eta 1, the second with another g and scale, or, where `tiny`, a mean
    free path of 2e-7)."""
    rows = []
    for s in range(n):
        r = dict(MARBLE)
        if s == 1:
            r = dict(r, sigma_s=[x * 0.5 for x in r["sigma_s"]], g=0.3)
            if tiny:
                r = dict(r, sigma_s=[5e6, 5e6, 5e6])
        if s == 2:
            r = dict(r, eta=1.0)
        rows.append(dipole_params(r))
    return np.stack(rows)


def _all_ones_offsets(z2s):
    """Offsets dx (float32) with RN(RN(dx dx) + z2) = x for an x whose
    correctly rounded square root dr, or dr * dr, has an all-ones
    significand, for the z2s (each channel's zr^2 and zv^2) below x: the
    floats just below 2^-8 .. 1 where that happens."""
    f32 = np.float32
    out = []
    for j in range(-8, 1):
        x = (f32(2.0 ** j).view(np.int32)
             + np.arange(-64, 64, dtype=np.int32)).view(f32)
        dr = np.sqrt(x.astype(np.float64)).astype(f32)
        ones = lambda v: (v.view(np.uint32) & 0x7fffff) == 0x7fffff
        for t in x[ones(dr) | ones(dr * dr)]:
            for z2 in z2s:
                if z2 >= t:
                    continue
                d = f32(np.sqrt(float(t) - float(z2)))
                dx = (d.view(np.int32) + np.arange(-4096, 4097,
                                                   dtype=np.int32)).view(f32)
                hit = dx[(dx >= 0) & (dx * dx + z2 == t)]
                if len(hit):
                    out.append(hit[0])
    return np.array(out, f32)


def _centre(s):
    return np.array([0.7 * s, 0.1 * s, -0.2 * s])


def _on_sphere(rng, n, s, jitter=0.0):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return _centre(s) + v * (0.3 + jitter * rng.normal(size=(n, 1)))


def case(name):
    """dict(params [S,12], pts [P,3], E [P,3], area [P] float32, pt_ss
    [P] int32; lanes: ss_id [L] int32, p [L,3], cos_o [L] float32)."""
    L, seed, tiles, layout = CASES[name]
    rng = np.random.default_rng(seed)
    S = len(tiles)
    pts, E, area, pt_ss = [], [], [], []
    for s, n_t in enumerate(tiles):
        n = n_t * PT_BLOCK
        x = _on_sphere(rng, n, s)
        e = rng.uniform(0.0, 2.0, (n, 3))
        if layout == "padded":
            # 400 points, then repeats of them (as build_subsurface pads)
            rep = rng.integers(0, 400, n - 400)
            x[400:], e[400:] = x[rep], e[rep]
        pts.append(x)
        E.append(e)
        area.append(np.full(n, 0.6 / n))
        pt_ss.append(np.full(n, s))
    pts, E = np.concatenate(pts), np.concatenate(E)
    area, pt_ss = np.concatenate(area), np.concatenate(pt_ss)
    if layout == "padded":
        area[17] = 0.0
    if layout == "nonfinite":
        k = np.flatnonzero(pt_ss == 1)
        E[k[5], 0] = np.inf
        E[k[300], 1] = np.nan
    if layout == "interleaved":
        # owners alternate point by point, and every seventh point is no
        # one's: no tile belongs to one owner
        pt_ss = np.where(np.arange(len(pt_ss)) % 7 == 3, -1,
                         np.arange(len(pt_ss)) % S)
    if layout == "far":
        k = np.flatnonzero(pt_ss == 0)
        pts[k[:64]] += np.array([200.0, 0.0, 0.0])
        pts[k[64:70]] += np.array([0.0, 2.0 ** 20, 0.0])
        E[k[:70]] = 1.0
    if layout == "beside shared":
        # owner 0's last tile goes half to owner 1: tile 2 is shared
        pt_ss[2 * PT_BLOCK + PT_BLOCK // 2:3 * PT_BLOCK] = 1
    ss_id = rng.integers(-1, S, L)
    p = np.stack([_on_sphere(rng, 1, max(s, 0), 0.05)[0] for s in ss_id])
    cos_o = rng.uniform(-0.3, 1.0, L)
    cos_o[3], cos_o[4] = 0.0, -0.0
    if layout in ("on points", "tiny mfp"):
        for i in np.flatnonzero(ss_id >= 0):
            p[i] = pts[rng.choice(np.flatnonzero(pt_ss == ss_id[i]))]
    if layout == "all ones":
        # owner 0's first point at its centre, the origin, and lanes on
        # the x axis at the offsets found
        rows = _rows(S)[0]
        z = rows[0:6].astype(np.float32)
        dx = _all_ones_offsets(z * z)
        pts[0] = 0.0
        p[:len(dx)] = 0.0
        p[:len(dx), 0] = dx
        ss_id[:len(dx)] = 0
        cos_o[:len(dx)] = 0.5
    if layout == "all gated":
        ss_id = rng.integers(0, S, L)
        cos_o = rng.uniform(0.0, 1.0, L)
        cos_o[cos_o == 0.0] = 0.5
    if layout.startswith("gated "):
        # exactly n lanes gated in, the rest out by ss_id or cos_o
        n = int(layout.split()[1])
        on = np.zeros(L, bool)
        on[rng.choice(L, n, replace=False)] = True
        ss_id = np.where(on, rng.integers(0, S, L),
                         np.where(rng.random(L) < 0.5, -1, ss_id))
        cos_o = np.where(on, rng.uniform(0.01, 1.0, L),
                         np.where(ss_id >= 0, -np.abs(cos_o), cos_o))
    return dict(params=_rows(S, layout == "tiny mfp"),
                pts=pts.astype(np.float32),
                E=E.astype(np.float32), area=area.astype(np.float32),
                pt_ss=pt_ss.astype(np.int32), ss_id=ss_id.astype(np.int32),
                p=p.astype(np.float32), cos_o=cos_o.astype(np.float32))

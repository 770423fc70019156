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
256-lane tile.
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
    # an owner of more tiles than K12 holds sums of at once (WIN)
    "more tiles than a window": (600, 38, (40,), "aligned"),
}


def _rows(n):
    """n dipole rows: marble, then its variants (the last of three with
    eta 1, the second with another g and scale)."""
    rows = []
    for s in range(n):
        r = dict(MARBLE)
        if s == 1:
            r = dict(r, sigma_s=[x * 0.5 for x in r["sigma_s"]], g=0.3)
        if s == 2:
            r = dict(r, eta=1.0)
        rows.append(dipole_params(r))
    return np.stack(rows)


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
    ss_id = rng.integers(-1, S, L)
    p = np.stack([_on_sphere(rng, 1, max(s, 0), 0.05)[0] for s in ss_id])
    cos_o = rng.uniform(-0.3, 1.0, L)
    cos_o[3], cos_o[4] = 0.0, -0.0
    return dict(params=_rows(S), pts=pts.astype(np.float32),
                E=E.astype(np.float32), area=area.astype(np.float32),
                pt_ss=pt_ss.astype(np.int32), ss_id=ss_id.astype(np.int32),
                p=p.astype(np.float32), cos_o=cos_o.astype(np.float32))

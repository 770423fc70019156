"""Random triangle soups and rays made with numpy, for holding the
intersection kernels against their plain versions: chip_smoke.py and the
kernel tests (tests/test_torch_brute*.py, tests/test_torch_bvh*.py) take
their inputs from here. Every function returns numpy arrays made from a
seed; rays are (o [L,3], d [L,3], t_min [L], t_max [L]) float32, with a
parked lane marked by t_max < t_min, as the tracer parks a dead path.
"""

from __future__ import annotations

import numpy as np


def aim_at_edges(tri, o, d, rng):
    """A copy of the origins o in which the first half is moved so that
    each ray passes through a point on an edge of a random triangle of
    tri [T,12] (p0, e1, e2, pad), where two evaluations that round
    differently disagree about the side. `rng` is a seed or a numpy
    Generator."""
    rng = np.random.default_rng(rng)
    half = len(o) // 2
    k = rng.integers(0, len(tri), half)
    s = rng.random(half)
    edge = rng.integers(0, 3, half)
    alpha = np.where(edge == 0, s, np.where(edge == 1, 0.0, s))
    beta = np.where(edge == 0, 0.0, np.where(edge == 1, s, 1.0 - s))
    target = (tri[k, 0:3] + alpha[:, None] * tri[k, 3:6]
              + beta[:, None] * tri[k, 6:9])
    o = o.copy()
    o[:half] = target - d[:half] * rng.uniform(0.5, 2.0, (half, 1))
    return o.astype(np.float32)


def tri_soup(T, L, seed, shadow=False, edges=False):
    """T random triangles in [-1, 1]^3 as [T,12] rows and L rays from
    [-2, 2]^3 with every 17th lane parked; with `edges`, half of the rays
    aimed at triangle edges; with `shadow`, finite segment ends and a
    third of the lanes parked, as the tracer's shadow rays. Returns
    (tri, o, d, t_min, t_max)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, (T, 3, 3)).astype(np.float32)
    tri = np.zeros((T, 12), np.float32)
    tri[:, 0:3] = v[:, 0]
    tri[:, 3:6] = v[:, 1] - v[:, 0]
    tri[:, 6:9] = v[:, 2] - v[:, 0]
    o = rng.uniform(-2.0, 2.0, (L, 3)).astype(np.float32)
    d = rng.normal(size=(L, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if edges:
        o = aim_at_edges(tri, o, d, rng)
    t_max = np.where(np.arange(L) % 17 == 0, -1.0, 3.4e38).astype(np.float32)
    if shadow:
        t_max = np.where(rng.random(L) < 0.33, -1.0,
                         rng.random(L) * 3.0).astype(np.float32)
    return tri, o, d, np.zeros(L, np.float32), t_max


def deep_soup(T=20000, seed=11):
    """Clustered random triangles (tests/test_scene.py:130), which give a
    deep, uneven wide BVH. Returns (positions, faces)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(T, 1, 3)) * np.array([5.0, 1.0, 5.0])
    tris = centers + rng.normal(size=(T, 3, 3)) * 0.4
    return tris.reshape(-1, 3), np.arange(3 * T, dtype=np.int32).reshape(-1, 3)


# the two triangles that tie_soup stacks, above deep_soup's clusters
_TIE_TRIS = np.array([[[0.3, 3.8, 0.1], [1.4, 4.5, -0.3], [0.2, 5.1, 0.6]],
                      [[-2.0, 4.2, 1.0], [-1.1, 3.9, 2.2], [-2.4, 5.0, 1.7]]])
TIE_COPIES = (40, 17)


def tie_soup(T=600, seed=13):
    """deep_soup's clustered triangles, then TIE_COPIES[k] identical copies
    of each of the two triangles _TIE_TRIS. The BVH builder splits
    identical centroids only by the median, so each stack fills leaves of
    identical triangles whose boxes coincide, siblings under one node: a
    ray through a stack meets ties in tn between those children and in t
    between the copies in a leaf. Returns (positions, faces); the copies
    are the faces from T on."""
    pos, _ = deep_soup(T, seed)
    pos = np.concatenate([pos] + [np.tile(t, (n, 1)) for t, n in
                                  zip(_TIE_TRIS, TIE_COPIES)])
    return pos, np.arange(len(pos), dtype=np.int32).reshape(-1, 3)


def tie_rays(L, seed):
    """soup_rays' rays (every 17th lane parked), the first half turned to
    pass through random points inside the two stacked triangles of
    tie_soup. Returns (o, d, t_min, t_max)."""
    o, d, t_min, t_max = soup_rays(L, seed)
    rng = np.random.default_rng(seed)
    half = L // 2
    tri = _TIE_TRIS[rng.integers(0, 2, half)]
    a, b = rng.random((2, half, 1))
    a, b = np.where(a + b > 1, 1 - a, a), np.where(a + b > 1, 1 - b, b)
    target = tri[:, 0] + a * (tri[:, 1] - tri[:, 0]) + b * (tri[:, 2]
                                                           - tri[:, 0])
    to = target - o[:half]
    d = d.copy()
    d[:half] = to / np.linalg.norm(to, axis=-1, keepdims=True)
    return o, d.astype(np.float32), t_min, t_max


def soup_rays(L, seed, shadow=False):
    """Rays around the deep soup, origins normal with sigma 4, every 17th
    lane parked; with `shadow`, finite segment ends and a third of the
    lanes parked. Returns (o, d, t_min, t_max)."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(L, 3)) * 4.0).astype(np.float32)
    d = rng.normal(size=(L, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.where(np.arange(L) % 17 == 0, -1.0, 1e9)
    if shadow:
        t_max = np.where(rng.random(L) < 0.33, -1.0, rng.random(L) * 3.0)
    return o, d, np.zeros(L, np.float32), t_max.astype(np.float32)

"""Ray casting against the scene's triangles (counterpart of
ppg_tpu/accel/traverse.py, small-scene path).

Scenes of at most BRUTE_MAX triangles are swept triangle by triangle
(accel/brute.py: the CUDA kernel on a card, its plain version on the CPU).
The wide-BVH walk that serves larger scenes is not ported yet (ROADMAP,
Queue 2 K2), so a larger scene raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import bvh_lib
from .brute import brute_any_hit, brute_closest, brute_sweep_plain
from .bvh import build_bvh8

BRUTE_MAX = 1024  # scenes up to this many triangles take the sweep

_BVH_TODO = ("scenes with more than {} triangles need the BVH16 walk "
             "(ROADMAP Queue 2, K2), which is not ported yet")


class GeometryArrays:
    """Packed triangles in BVH leaf order.

    tri  [T,12] f32 : p0(3), e1(3), e2(3), pad(3)
    perm [T]    i32 : packed row -> original face index
    """

    def __init__(self, tri, perm):
        self.tri = tri
        self.perm = perm

    @property
    def num_tris(self):
        return self.tri.shape[0]


def pack_triangles(positions, faces):
    """Host packing: the leaf order of the wide-BVH builder (accel/bvh.py,
    the port's copy of ppg_tpu's, built with the same flags) fixes the
    triangle ids, so ids agree with ppg_tpu's on the same machine.
    Returns (tri [max(T,1),12] f32, perm [T] int32) as numpy."""
    perm = np.asarray(build_bvh8(positions, faces)["prim_ids"])
    if len(perm) == 0:
        perm = np.zeros(0, np.int64)
    v = positions[faces].astype(np.float64)[perm] if len(perm) else \
        np.zeros((0, 3, 3))
    T = len(perm)
    tri = np.zeros((max(T, 1), 12), np.float32)
    if T:
        tri[:T, 0:3] = v[:, 0]
        tri[:T, 3:6] = v[:, 1] - v[:, 0]
        tri[:T, 6:9] = v[:, 2] - v[:, 0]
    return tri, perm.astype(np.int32)


def native_builder_loaded():
    """Whether the C++ BVH builder (csrc/host/bvh_builder.cpp) builds and
    loads; without it pack_triangles takes the slower numpy builder."""
    lib = bvh_lib()
    return lib is not None and hasattr(lib, "ppg_bvhw_build")


def build_geometry(positions, faces, device) -> GeometryArrays:
    tri, perm = pack_triangles(positions, faces)
    if len(perm) > BRUTE_MAX:
        raise NotImplementedError(_BVH_TODO.format(BRUTE_MAX))
    return GeometryArrays(torch.from_numpy(tri).to(device, torch.float32),
                          torch.from_numpy(perm).to(device, torch.int32))


def brute_force_closest(geom: GeometryArrays, o, d, t_min, t_max):
    """The plain sweep (tests and CPU runs). Returns (tri_idx in packed
    order, t, u, v)."""
    return brute_sweep_plain(geom.tri, o, d, t_min, t_max)


def closest_hit(geom: GeometryArrays, o, d, t_min, t_max,
                count="brute_kernel"):
    """Returns (packed tri index or -1, t, u, v)."""
    if geom.num_tris > BRUTE_MAX:
        raise NotImplementedError(_BVH_TODO.format(BRUTE_MAX))
    return brute_closest(geom.tri, o, d, t_min, t_max, count)


def any_hit(geom: GeometryArrays, o, d, t_min, t_max):
    """Occlusion test (shadow rays), as ppg_tpu's brute-force any-hit:
    whether the closest-hit sweep would find a hit. On a card the any-hit
    kernel stops each ray at its first hit; lanes with t_max < t_min are
    parked and never occluded. Kernel launches count under
    COUNTS["any_hit"]. Returns bool [L]."""
    if geom.num_tris > BRUTE_MAX:
        raise NotImplementedError(_BVH_TODO.format(BRUTE_MAX))
    return brute_any_hit(geom.tri, o, d, t_min, t_max)

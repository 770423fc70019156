"""Carry ppg_tpu's state, given as numpy arrays, into the port's classes.

The scene needs no converter: both packages build from the same host
scene object. Every conversion states its dtype, since numpy hands over
float64 by default.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.traverse import GeometryArrays, padded_rows
from .bsdf.bsdf import MaterialArrays
from .guiding.sdtree import SDTreeArrays
from .singlescatter import SSSArrays
from .subsurface import SubsurfArrays

_INT_FIELDS = {"s_child", "s_dtree", "qs_child", "ds_root", "qb_child",
               "db_root", "opt_iter"}


def _tensor(a, dtype, device):
    # torch.tensor copies: the port updates trees in place, and must not
    # write through into the caller's (or JAX's) buffers
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def sdtree_from_numpy(fields, s_depth, q_depth, device) -> SDTreeArrays:
    """fields: {name: np.ndarray} holding at least every field of the
    port's SDTreeArrays.FIELDS (ppg_tpu's packed descent tables are
    ignored). Integer fields become int32, the rest float32."""
    out = {}
    for f in SDTreeArrays.FIELDS:
        dtype = torch.int32 if f in _INT_FIELDS else torch.float32
        out[f] = _tensor(np.asarray(fields[f]), dtype, device)
    return SDTreeArrays(s_depth=int(s_depth), q_depth=int(q_depth), **out)


def geometry_from_numpy(tri, rows, perm, stack_depth, wide,
                        device) -> GeometryArrays:
    """ppg_tpu's whole GeometryArrays: tri [T,12] float32, rows [N,ROW]
    float32 (the wide BVH, laid out on `device` with each row on 16 bytes,
    traverse.padded_rows), perm [T] int32, the walk's stack depth and the
    tree's width."""
    return GeometryArrays(_tensor(tri, torch.float32, device),
                          _tensor(perm, torch.int32, device),
                          rows=padded_rows(np.asarray(rows, np.float32),
                                           device),
                          stack_depth=stack_depth, wide=wide)


def materials_from_numpy(packed, present, device) -> MaterialArrays:
    """ppg_tpu's MaterialArrays: packed [M, MaterialArrays.WIDTH] float32
    (the same SLOTS, integer fields as their bits) and the static set of
    families `present`."""
    packed = np.asarray(packed, np.float32)
    if packed.ndim != 2 or packed.shape[1] != MaterialArrays.WIDTH:
        raise ValueError(f"materials_from_numpy: want [M, "
                         f"{MaterialArrays.WIDTH}] rows; got {packed.shape}")
    return MaterialArrays(_tensor(packed, torch.float32, device),
                          frozenset(int(t) for t in present))


def subsurf_from_numpy(params, pts, E, area, pt_ss, tri_ss, num,
                       device) -> SubsurfArrays:
    """ppg_tpu's SubsurfArrays: params [S, 12], pts [P, 3], E [P, 3] and
    area [P] float32; pt_ss [P] and tri_ss [T] int32."""
    f = lambda a: _tensor(a, torch.float32, device)
    i = lambda a: _tensor(a, torch.int32, device)
    return SubsurfArrays(f(params), f(pts), f(E), f(area), i(pt_ss),
                         i(tri_ss), num=int(num))


def sss_from_numpy(params, tri_ss, num, fss, depth, device) -> SSSArrays:
    """ppg_tpu's SSSArrays: params [S, 12] float32, tri_ss [T] int32 and
    the static fss and depth."""
    return SSSArrays(_tensor(params, torch.float32, device),
                     _tensor(tri_ss, torch.int32, device), num=int(num),
                     fss=int(fss), depth=int(depth))

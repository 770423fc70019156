"""Carry ppg_tpu's state, given as numpy arrays, into the port's classes.

The scene needs no converter: both packages build from the same host
scene object. Every conversion states its dtype, since numpy hands over
float64 by default.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.traverse import GeometryArrays, padded_rows
from .guiding.sdtree import SDTreeArrays

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

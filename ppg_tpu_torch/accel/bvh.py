"""Binned-SAH BVH2 builder with a threaded (stackless) layout.

Plays the role of the reference's SAH kd-tree (mitsuba/include/mitsuba/
render/gkdtree.h, skdtree.h) but as a BVH emitted in DFS order with
hit/miss links, which turns traversal into a branch-free index walk —
the idiomatic shape for SIMD/TPU wavefront traversal (no pointer chasing,
no per-lane stack). Built host-side in numpy; consumed by
accel.traverse as flat arrays.

The port's own copy of ppg_tpu/accel/bvh.py; the native builder is
csrc/host/bvh_builder.cpp, built and loaded by ppg_tpu_torch/native.py.

Layout (node i):
  node_min/max [N,3] : AABB
  is_leaf      [N]   : bool
  leaf_off/cnt [N]   : range into prim_ids for leaves
  miss        [N]    : node index to jump to when the AABB test fails
                       (or after finishing a leaf); N means "done"
  hit (implicit)     : i+1 in DFS order for internal nodes
"""

from __future__ import annotations

import numpy as np

MAX_LEAF = 4
N_BINS = 16
B8_LEAF_BIT = np.int32(1 << 30)
# Wide-BVH arity. Measured on kitchen (1M tris, 64k lanes, v5e): the
# row gather dominates each traversal step at ~(10.6 ns/lane +
# ~12 ps/byte); a 32/32 tree costs +45%/step (290 vs 160 cols) but cuts
# iterations LESS than that (the pend-mask revisit scheme re-gathers a
# parent row once per extra hit child, so arity does not proportionally
# cut gather count): camera rays measured 38.4 ms vs 25.6 ms at 16/16.
# 16/16 is the sweet spot for the one-table walk; the builder stays
# parameterized (wide<=32) for the planned VMEM-resident MXU descent
# over a 32-wide internal-only table. ROW = max(7W, 9K+2).
B8_WIDE = 16
B8_MAX_TRIS = 16
B8_ROW = max(7 * B8_WIDE, 9 * B8_MAX_TRIS + 2)


def build_bvh8(positions, faces, wide=None, max_tris=None):
    """Wide BVH with packed SoA float rows (see csrc/host/bvh_builder.cpp
    for the layout). Returns dict(rows [N,ROW] f32, prim_ids [T],
    wide). Uses the C++ builder when available, else collapses the
    numpy BVH2 to the same layout. Row 0 is ALWAYS a node row —
    traversal state machines start walks in node phase (traverse.py
    bvh_state_init), so a root-leaf tree (everything fits one leaf)
    gets wrapped in a one-child node."""
    wide = wide or B8_WIDE
    max_tris = max_tris or B8_MAX_TRIS
    row_len = max(7 * wide, 9 * max_tris + 2)
    F = len(faces)
    if F == 0:
        rows = np.zeros((1, row_len), np.float32)  # empty leaf row (cnt 0)
        return dict(rows=_wrap_root_leaf(rows, None, wide),
                    prim_ids=np.zeros(0, np.int32), wide=wide)
    out = _build8_native(positions, faces, wide, max_tris, row_len)
    if out is None:
        out = _collapse8(positions, faces, wide, max_tris, row_len)
    out["wide"] = wide
    if len(out["rows"]) == 1:
        v = positions[faces].reshape(-1, 3)
        out["rows"] = _wrap_root_leaf(out["rows"],
                                      (v.min(axis=0), v.max(axis=0)), wide)
    return out


def _wrap_root_leaf(leaf_rows, bbox, wide=None):
    """Prepend a node row whose only child is the (single) leaf row at
    index 1. Unused slots get NaN slabs (never hit) and info 0."""
    W = wide or B8_WIDE
    row_len = leaf_rows.shape[1]
    node = np.full(row_len, np.nan, np.float32)
    node[6 * W:] = 0.0
    if bbox is not None:
        bmin, bmax = bbox
        node[0 * W], node[1 * W], node[2 * W] = bmin
        node[3 * W], node[4 * W], node[5 * W] = bmax
        node[6 * W] = np.int32(1 | B8_LEAF_BIT).view(np.float32)
    return np.concatenate([node[None], leaf_rows], axis=0)


def _build8_native(positions, faces, wide, max_tris, row_len):
    import ctypes
    import os

    from ..native import bvh_lib

    lib = bvh_lib()
    if lib is None or not hasattr(lib, "ppg_bvhw_build"):
        return None
    verts = np.ascontiguousarray(positions, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    n_threads = min(os.cpu_count() or 1, 16)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    n = lib.ppg_bvhw_build(fp(verts), len(verts), ip(f), len(f), n_threads,
                           wide, max_tris)
    if n <= 0:
        return None
    rows = np.empty((n, row_len), np.float32)
    prim_ids = np.empty(len(f), np.int32)
    lib.ppg_bvhw_copy(fp(rows), ip(prim_ids))
    return dict(rows=rows, prim_ids=prim_ids)


def _collapse8(positions, faces, wide=None, max_tris=None, row_len=None):
    """Pure-python fallback: binary build then W-wide collapse into the
    same packed SoA rows as the native builder."""
    W = wide or B8_WIDE
    K = max_tris or B8_MAX_TRIS
    row_len = row_len or max(7 * W, 9 * K + 2)
    bvh = build_bvh(positions, faces, max_leaf=K,
                    allow_native=False)
    is_leaf = np.asarray(bvh["is_leaf"], bool)
    N = len(is_leaf)
    nmin, nmax = bvh["node_min"], bvh["node_max"]
    miss = np.asarray(bvh["miss"], np.int64)
    loff = np.asarray(bvh["leaf_off"], np.int64)
    lcnt = np.asarray(bvh["leaf_cnt"], np.int64)
    pids = np.asarray(bvh["prim_ids"], np.int64)
    v = positions[faces].astype(np.float64)

    def area(i):
        d = np.maximum(nmax[i] - nmin[i], 0)
        return d[0] * d[1] + d[1] * d[2] + d[0] * d[2]

    rows = []
    prim_out = []

    def emit_leaf(i):
        row = np.zeros(row_len, np.float32)
        base = len(prim_out)
        for k in range(int(lcnt[i])):
            fid = pids[loff[i] + k]
            p = v[fid]
            for c in range(3):
                row[K * c + k] = p[0][c]
                row[3 * K + K * c + k] = p[1][c] - p[0][c]
                row[6 * K + K * c + k] = p[2][c] - p[0][c]
            prim_out.append(fid)
        row[9 * K] = np.int32(lcnt[i]).view(np.float32)
        row[9 * K + 1] = np.int32(base).view(np.float32)
        rows.append(row)
        return len(rows) - 1

    def emit(i):
        if is_leaf[i]:
            return emit_leaf(i)
        slots = [i + 1, int(miss[i + 1])]
        while len(slots) < W:
            cands = [s for s in slots if not is_leaf[s]]
            if not cands:
                break
            pick = max(cands, key=area)
            slots[slots.index(pick)] = pick + 1
            slots.append(int(miss[pick + 1]))
        ri = len(rows)
        rows.append(np.zeros(row_len, np.float32))
        child_rows = [emit(s) for s in slots]
        row = rows[ri]
        for k in range(W):
            if k < len(slots):
                s = slots[k]
                row[0 * W + k], row[1 * W + k], row[2 * W + k] = nmin[s]
                row[3 * W + k], row[4 * W + k], row[5 * W + k] = nmax[s]
                info = np.int32(child_rows[k])
                if is_leaf[s]:
                    info = info | B8_LEAF_BIT
                row[6 * W + k] = np.int32(info).view(np.float32)
            else:
                row[0 * W + k] = row[1 * W + k] = row[2 * W + k] = np.nan
                row[3 * W + k] = row[4 * W + k] = row[5 * W + k] = np.nan
        return ri

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        emit(0)
    finally:
        sys.setrecursionlimit(old)
    return dict(rows=np.stack(rows), prim_ids=np.array(prim_out, np.int32))


def _build_native(positions, faces, max_leaf):
    """C++ builder (csrc/host/bvh_builder.cpp); None if unavailable."""
    import ctypes
    import os

    from ..native import bvh_lib

    lib = bvh_lib()
    if lib is None:
        return None
    verts = np.ascontiguousarray(positions, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    F = len(f)
    n_threads = min(os.cpu_count() or 1, 16)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    n = lib.ppg_bvh_build(fp(verts), len(verts), ip(f), F, max_leaf, n_threads)
    if n <= 0:
        return None
    node_min = np.empty((n, 3), np.float32)
    node_max = np.empty((n, 3), np.float32)
    is_leaf = np.empty(n, np.uint8)
    leaf_off = np.empty(n, np.int32)
    leaf_cnt = np.empty(n, np.int32)
    miss = np.empty(n, np.int32)
    prim_ids = np.empty(F, np.int32)
    lib.ppg_bvh_copy(
        fp(node_min), fp(node_max),
        is_leaf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ip(leaf_off), ip(leaf_cnt), ip(miss), ip(prim_ids),
    )
    return dict(
        node_min=node_min, node_max=node_max, is_leaf=is_leaf.astype(bool),
        leaf_off=leaf_off, leaf_cnt=leaf_cnt, miss=miss, prim_ids=prim_ids,
    )


def build_bvh(positions, faces, max_leaf=MAX_LEAF, allow_native=True):
    F = len(faces)
    if F == 0:
        return dict(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.zeros((1, 3), np.float32),
            is_leaf=np.array([True]),
            leaf_off=np.zeros(1, np.int32),
            leaf_cnt=np.zeros(1, np.int32),
            miss=np.array([1], np.int32),
            prim_ids=np.zeros(0, np.int32),
        )
    if allow_native:
        out = _build_native(positions, faces, max_leaf)
        if out is not None:
            return out
    v = positions[faces]  # [F, 3, 3]
    tmin = v.min(axis=1)
    tmax = v.max(axis=1)
    cent = (tmin + tmax) * 0.5

    prim_ids = []
    nodes = []  # dicts: min,max,leaf(off,cnt) or child2

    def make_node(idx):
        lo = tmin[idx].min(axis=0)
        hi = tmax[idx].max(axis=0)
        ni = len(nodes)
        nodes.append({"min": lo, "max": hi, "left": -1, "right": -1, "off": -1, "cnt": 0})
        if len(idx) <= max_leaf:
            nodes[ni]["off"] = len(prim_ids)
            nodes[ni]["cnt"] = len(idx)
            prim_ids.extend(idx.tolist())
            return ni

        # binned SAH over the largest-extent axis set; pick best split
        best = None
        c = cent[idx]
        clo, chi = c.min(axis=0), c.max(axis=0)
        ext = chi - clo
        for axis in range(3):
            if ext[axis] <= 0:
                continue
            scale = N_BINS * (1.0 - 1e-6) / ext[axis]
            b = ((c[:, axis] - clo[axis]) * scale).astype(np.int32)
            # bin bounds and counts
            cnts = np.bincount(b, minlength=N_BINS)
            bin_lo = np.full((N_BINS, 3), np.inf)
            bin_hi = np.full((N_BINS, 3), -np.inf)
            for k in range(N_BINS):
                sel = b == k
                if cnts[k]:
                    bin_lo[k] = tmin[idx][sel].min(axis=0)
                    bin_hi[k] = tmax[idx][sel].max(axis=0)

            def sa(lo, hi):
                d = np.maximum(hi - lo, 0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 0] * d[..., 2]

            # prefix/suffix sweeps
            lcnt = np.cumsum(cnts)[:-1]
            rcnt = len(idx) - lcnt
            llo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
            lhi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
            rlo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
            rhi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]
            cost = sa(llo, lhi) * lcnt + sa(rlo, rhi) * rcnt
            cost[lcnt == 0] = np.inf
            cost[rcnt == 0] = np.inf
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
                best = (cost[k], axis, k, b)

        if best is None:
            # degenerate: all centroids coincide -> median split
            order = np.argsort(cent[idx][:, 0], kind="stable")
            half = len(idx) // 2
            left_idx, right_idx = idx[order[:half]], idx[order[half:]]
        else:
            _, axis, k, b = best
            left_idx = idx[b <= k]
            right_idx = idx[b > k]

        nodes[ni]["left"] = make_node(left_idx)
        nodes[ni]["right"] = make_node(right_idx)
        return ni

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 + 4 * F))
    make_node(np.arange(F))
    sys.setrecursionlimit(old)

    # DFS order is construction order (children created right after parent,
    # left subtree fully before right). Compute miss links.
    N = len(nodes)
    miss = np.full(N, N, np.int32)

    def link(i, m):
        miss[i] = m
        if nodes[i]["left"] >= 0:
            link(nodes[i]["left"], nodes[i]["right"])
            link(nodes[i]["right"], m)

    sys.setrecursionlimit(max(old, 10 + 4 * F))
    link(0, N)
    sys.setrecursionlimit(old)

    return dict(
        node_min=np.array([n["min"] for n in nodes], np.float32),
        node_max=np.array([n["max"] for n in nodes], np.float32),
        is_leaf=np.array([n["left"] < 0 for n in nodes]),
        leaf_off=np.array([max(n["off"], 0) for n in nodes], np.int32),
        leaf_cnt=np.array([n["cnt"] for n in nodes], np.int32),
        miss=miss,
        prim_ids=np.array(prim_ids, np.int32),
    )

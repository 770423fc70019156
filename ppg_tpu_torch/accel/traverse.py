"""Ray casting against the scene's triangles (counterpart of
ppg_tpu/accel/traverse.py).

Scenes of at most BRUTE_MAX triangles are swept triangle by triangle
(accel/brute.py: the CUDA kernel on a card, its plain version on the CPU).
Larger scenes walk the wide BVH (W = 16) that the builder
(accel/bvh.py::build_bvh8) emits as one row table: accel/bvh_walk.py
launches the walk kernel (csrc/bvh.cu) on a card, and `bvh_closest_plain`
below is its plain PyTorch version, run for CPU tensors and used on the
card as the kernel's referee.

The walk is ppg_tpu's ordered BVH16 walk (traverse.py::bvh_step_factory,
driven by bvh_closest): each step reads one row; a node step slab-tests
the row's 16 children (restricted to the lane's pending mask on a parent
revisit), descends into the nearest hit child, pushes the second-nearest
as a direct entry (its node and entry distance) and, with three or more
hit children, the parent below it with the mask of the rest; a leaf step
intersects the row's up to 16 triangles; a lane that did not descend
pops, discarding for free one direct entry that cannot beat its best hit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import bvh_lib
from .brute import COUNTS as BRUTE_COUNTS
from .brute import INF, brute_any_hit, brute_closest, brute_sweep_plain
from .bvh import build_bvh8
from .bvh_walk import STACK_CAP, bvh_any_hit, bvh_closest

BRUTE_MAX = 1024  # scenes up to this many triangles take the sweep
MAX_STEPS = 8192  # steps a lane may take, as ppg_tpu's watchdog guard
LEAF_BIT = 1 << 30  # a child info's leaf flag; the low 30 bits index a row
IDX_MASK = (1 << 30) - 1


class GeometryArrays:
    """Packed triangles and the wide BVH, in BVH leaf order.

    tri  [T,12] f32 : p0(3), e1(3), e2(3), pad(3)
    rows [N,ROW] f32: ROW = max(7W, 9W+2) (146 at W = 16), as ppg_tpu's
                      GeometryArrays.rows: an internal row holds its W
                      child AABBs SoA (min x, y, z, max x, y, z; W columns
                      each) and the children's infos as int32 bits at
                      6W..7W-1 (0 = empty, bit 30 = leaf, low 30 bits the
                      row); a leaf row holds up to W triangles SoA (p0,
                      e1, e2; W columns per component), its count at 9W
                      and its first packed triangle at 9W+1 (int32 bits).
                      A view of a buffer whose rows are padded to a
                      multiple of 4 floats, so that every row starts on
                      16 bytes (the kernel's loads).
    perm [T]    i32 : packed row -> original face index
    stack_depth     : entries of a lane's walk stack (ppg_tpu's rule)
    wide            : W
    """

    def __init__(self, tri, perm, rows, stack_depth, wide=16):
        self.tri = tri
        self.perm = perm
        self.rows = rows
        self.stack_depth = int(stack_depth)
        self.wide = int(wide)

    @property
    def num_tris(self):
        return self.tri.shape[0]


def _bvh8_depth(rows, wide):
    """Internal-node depth of the wide BVH (ppg_tpu's _bvh8_depth): a
    breadth-first walk over the child infos; a one-row tree (a root leaf)
    has depth 1."""
    if rows.shape[0] == 1:
        return 1
    infos = rows[:, 6 * wide:7 * wide].view(np.int32)
    frontier = np.array([0], np.int64)
    depth = 0
    while len(frontier):
        depth += 1
        ch = infos[frontier].reshape(-1)
        ch = ch[(ch != 0) & ((ch & LEAF_BIT) == 0)]
        frontier = (ch & IDX_MASK).astype(np.int64)
        if depth > 4096:
            raise RuntimeError("BVH depth runaway (cyclic links?)")
    return depth


def stack_depth_for(rows, wide):
    """ppg_tpu's stack size: the walk pushes up to two entries per
    internal level (a direct second-nearest child and the parent's
    remaining mask), rounded up to a multiple of 8. An undersized stack
    silently drops entries and loses hits, so the depth is measured."""
    return ((2 * _bvh8_depth(rows, wide) + 2 + 7) // 8) * 8


def _pack(bvh, positions, faces):
    perm = np.asarray(bvh["prim_ids"])
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


def pack_triangles(positions, faces):
    """Host packing: the leaf order of the wide-BVH builder (accel/bvh.py,
    the port's copy of ppg_tpu's, built with the same flags) fixes the
    triangle ids, so ids agree with ppg_tpu's on the same machine.
    Returns (tri [max(T,1),12] f32, perm [T] int32) as numpy."""
    return _pack(build_bvh8(positions, faces), positions, faces)


def native_builder_loaded():
    """Whether the C++ BVH builder (csrc/host/bvh_builder.cpp) builds and
    loads; without it pack_triangles takes the slower numpy builder."""
    lib = bvh_lib()
    return lib is not None and hasattr(lib, "ppg_bvhw_build")


def padded_rows(rows, device):
    """rows [N,R] (numpy f32) on `device` as a [N,R] view of a zeroed
    [N, R rounded up to 4] buffer, so that each row starts on 16 bytes."""
    n, r = rows.shape
    buf = torch.zeros((n, (r + 3) // 4 * 4), dtype=torch.float32,
                      device=device)
    buf[:, :r] = torch.from_numpy(np.require(rows, np.float32, ("C", "W")))
    return buf[:, :r]


def build_geometry(positions, faces, device) -> GeometryArrays:
    """Builds the wide BVH once and keeps its rows beside the packed
    triangles; raises ValueError when the walk's stack would need more
    entries than the kernel holds (accel/bvh_walk.STACK_CAP)."""
    bvh = build_bvh8(positions, faces)
    tri, perm = _pack(bvh, positions, faces)
    rows = np.asarray(bvh["rows"], np.float32)
    wide = int(bvh.get("wide", 16))
    depth = stack_depth_for(rows, wide)
    if depth > STACK_CAP:
        raise ValueError(f"the BVH needs a walk stack of {depth} entries; "
                         f"the kernel holds {STACK_CAP}")
    return GeometryArrays(torch.from_numpy(tri).to(device, torch.float32),
                          torch.from_numpy(perm).to(device, torch.int32),
                          rows=padded_rows(rows, device), stack_depth=depth,
                          wide=wide)


def brute_force_closest(geom: GeometryArrays, o, d, t_min, t_max):
    """The plain sweep (tests and CPU runs). Returns (tri_idx in packed
    order, t, u, v)."""
    return brute_sweep_plain(geom.tri, o, d, t_min, t_max)


def _safe_inv(x):
    return torch.reciprocal(torch.where(
        x.abs() < 1e-20, torch.where(x >= 0, 1e-20, -1e-20), x))


def _read(stack, pos):
    """stack[lane, pos[lane]], or 0 where pos lies outside the stack (the
    one-hot read of ppg_tpu's walk)."""
    sd = stack.shape[1]
    v = stack.gather(1, pos.clamp(0, sd - 1).long()[:, None])[:, 0]
    return torch.where((pos >= 0) & (pos < sd), v, torch.zeros_like(v))


def _write(stack, pos, mask, val):
    """stack[lane, pos[lane]] = val where mask, in place; a write past the
    end of the stack is dropped, as ppg_tpu's one-hot write drops it."""
    sd = stack.shape[1]
    idx = pos.clamp(max=sd - 1).long()[:, None]
    old = stack.gather(1, idx)[:, 0]
    ok = mask & (pos < sd)
    stack.scatter_(1, idx, torch.where(ok, val, old)[:, None])


def bvh_closest_plain(geom: GeometryArrays, o, d, t_min, t_max,
                      stop_on_hit=False, return_stats=False):
    """The BVH16 walk in plain PyTorch: ppg_tpu's bvh_state_init and
    bvh_step_factory's body, one step per loop turn while a lane walks and
    fewer than MAX_STEPS turns were taken. Each turn steps only the lanes
    still walking (a parked or finished lane's step changes nothing), and
    the stacks are read and written with gather/scatter along dim 1.
    Every product and sum is a separately rounded f32 operation, as in
    csrc/bvh.cu. With `stop_on_hit` a lane stops at its first accepted
    hit (any-hit). Lanes start only where t_max > t_min.

    Returns (best_i i32 in packed order or -1, t, u, v), t = INF on a
    miss; with `return_stats` also dict(node_steps, leaf_steps [L] i32
    per lane; node_tests [L] i32, the children each lane's node steps had
    to slab-test (non-empty and in the pending mask); leaf_tests [L] i32,
    the triangles of its leaf steps (each leaf's count); it = turns taken;
    node_rows and leaf_rows = bool [N], the rows the walk read)."""
    if o.is_cuda:
        BRUTE_COUNTS["plain_on_cuda"] += 1
    dev = o.device
    L, W, SD = o.shape[0], geom.wide, geom.stack_depth
    rows = geom.rows
    i32 = torch.int32
    iotaw = torch.arange(W, dtype=i32, device=dev)[None, :]
    full_mask = (1 << W) - 1

    cur = torch.where(t_max > t_min, 0, -1).to(i32)
    leaf = torch.zeros(L, dtype=torch.bool, device=dev)
    pend = torch.zeros(L, dtype=i32, device=dev)
    sp = torch.zeros(L, dtype=i32, device=dev)
    nstack = torch.zeros((L, SD), dtype=i32, device=dev)
    mstack = torch.zeros((L, SD), dtype=i32, device=dev)
    tstack = torch.zeros((L, SD), dtype=torch.float32, device=dev)
    best_t = torch.full((L,), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((L,), -1, dtype=i32, device=dev)
    best_u = torch.zeros(L, dtype=torch.float32, device=dev)
    best_v = torch.zeros(L, dtype=torch.float32, device=dev)
    node_steps = torch.zeros(L, dtype=i32, device=dev)
    leaf_steps = torch.zeros(L, dtype=i32, device=dev)
    node_tests = torch.zeros(L, dtype=i32, device=dev)
    leaf_tests = torch.zeros(L, dtype=i32, device=dev)
    node_rows = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    leaf_rows = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    inv = _safe_inv(d)

    it = 0
    while it < MAX_STEPS:
        lanes = (cur >= 0).nonzero()[:, 0]
        if lanes.numel() == 0:
            break
        it += 1
        c, lf, pd, s = cur[lanes], leaf[lanes], pend[lanes], sp[lanes]
        ns, ms, ts = nstack[lanes], mstack[lanes], tstack[lanes]
        bt, bi = best_t[lanes], best_i[lanes]
        bu, bv = best_u[lanes], best_v[lanes]
        ox, oy, oz = (a[:, None] for a in o[lanes].unbind(-1))
        dx, dy, dz = (a[:, None] for a in d[lanes].unbind(-1))
        ix, iy, iz = (a[:, None] for a in inv[lanes].unbind(-1))
        tmin, tmax = t_min[lanes], t_max[lanes]
        tmin1 = tmin[:, None]
        row = rows[c.long()]
        if return_stats:
            node_steps[lanes] += (~lf).to(i32)
            leaf_steps[lanes] += lf.to(i32)
            node_rows[c[~lf].long()] = True
            leaf_rows[c[lf].long()] = True
        limit = torch.minimum(bt, tmax)[:, None]

        # leaf phase: up to W SoA triangles; a node lane's inputs are
        # zeroed, as in ppg_tpu
        lrow = torch.where(lf[:, None], row, 0.0)
        meta = lrow[:, 9 * W:9 * W + 2].contiguous().view(i32)
        cnt, base = meta[:, 0:1], meta[:, 1]
        p0x, p0y, p0z = (lrow[:, W * k:W * (k + 1)] for k in range(3))
        e1x, e1y, e1z = (lrow[:, W * k:W * (k + 1)] for k in range(3, 6))
        e2x, e2y, e2z = (lrow[:, W * k:W * (k + 1)] for k in range(6, 9))
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        rdet = torch.where(det.abs() < 1e-12, 0.0, torch.reciprocal(det))
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * rdet
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        vv = (dx * qvx + dy * qvy + dz * qvz) * rdet
        tt = (e2x * qvx + e2y * qvy + e2z * qvz) * rdet
        take = (lf[:, None] & (iotaw < cnt) & (rdet != 0.0) & (uu >= 0.0)
                & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > tmin1)
                & (tt < limit))
        ttm = torch.where(take, tt, INF)
        kbest = ttm.argmin(1, keepdim=True)  # the first minimum
        t_leaf = ttm.gather(1, kbest)[:, 0]
        got = t_leaf < bt
        # ppg_tpu picks u and v as a sum of selects, which turns -0.0
        # into +0.0: so does the + 0.0
        bi = torch.where(got, base + kbest[:, 0].to(i32), bi)
        bu = torch.where(got, uu.gather(1, kbest)[:, 0] + 0.0, bu)
        bv = torch.where(got, vv.gather(1, kbest)[:, 0] + 0.0, bv)
        bt = torch.where(got, t_leaf, bt)
        limit = torch.minimum(bt, tmax)[:, None]

        # node phase: slab-test the W children
        nd = ~lf
        nrow = torch.where(nd[:, None], row[:, :7 * W], 0.0)
        pmask = torch.where(pd == 0, full_mask, pd)[:, None]
        info = nrow[:, 6 * W:7 * W].contiguous().view(i32)
        t0x = (nrow[:, 0 * W:1 * W] - ox) * ix
        t1x = (nrow[:, 3 * W:4 * W] - ox) * ix
        t0y = (nrow[:, 1 * W:2 * W] - oy) * iy
        t1y = (nrow[:, 4 * W:5 * W] - oy) * iy
        t0z = (nrow[:, 2 * W:3 * W] - oz) * iz
        t1z = (nrow[:, 5 * W:6 * W] - oz) * iz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z))
        tested = (info != 0) & (((pmask >> iotaw) & 1) == 1)
        if return_stats:  # a leaf lane's info and cnt are zeroed
            node_tests[lanes] += tested.sum(1, dtype=i32)
            leaf_tests[lanes] += cnt[:, 0]
        hitw = (nd[:, None] & (tn <= tf) & (tf >= tmin1) & (tn <= limit)
                & tested)
        tnm = torch.where(hitw, tn, INF)
        kn = tnm.argmin(1, keepdim=True)
        chosen = info.gather(1, kn)[:, 0]
        chosen_bit = (1 << kn[:, 0]).to(i32)
        hit_mask = (hitw.to(i32) << iotaw).sum(1, dtype=i32)
        any_hit = nd & (hit_mask != 0)
        if stop_on_hit:
            any_hit = any_hit & ~(bi >= 0)
        rem = hit_mask & ~chosen_bit
        # the second-nearest hit child, pushed as a direct entry
        tnm2 = torch.where(hitw & (iotaw != kn), tn, INF)
        kn2 = tnm2.argmin(1, keepdim=True)
        info2 = info.gather(1, kn2)[:, 0]
        tn2 = tnm2.gather(1, kn2)[:, 0]
        rem2 = rem & ~(1 << kn2[:, 0]).to(i32)
        push_par = any_hit & (rem2 != 0)  # 3+ children: parent revisit
        push_dir = any_hit & (rem != 0)   # 2+ children: direct second
        _write(ns, s, push_par, c)
        _write(ms, s, push_par, rem2)
        s = s + push_par.to(i32)
        _write(ns, s, push_dir, info2)
        _write(ms, s, push_dir, torch.zeros_like(rem2))
        _write(ts, s, push_dir, tn2)
        s = s + push_dir.to(i32)

        # pop, discarding a direct top that cannot beat the best hit
        need_pop = ~any_hit
        found = None
        if stop_on_hit:
            found = bi >= 0
            need_pop = need_pop & ~found
        limit1 = torch.minimum(bt, tmax)
        prune1 = (need_pop & (s > 0) & (_read(ms, s - 1) == 0)
                  & (_read(ts, s - 1) > limit1))
        s_eff = torch.where(prune1, s - 1, s)
        can_pop = need_pop & (s_eff > 0)
        done = need_pop & (s_eff == 0)
        if found is not None:
            done = done | found
        top_n, top_m = _read(ns, s_eff - 1), _read(ms, s_eff - 1)
        s = torch.where(can_pop, s_eff - 1, s_eff)
        is_dir = top_m == 0
        pop_cur = torch.where(is_dir, top_n & IDX_MASK, top_n)
        pop_leaf = is_dir & ((top_n & LEAF_BIT) != 0)
        pop_pend = torch.where(is_dir, 0, top_m).to(i32)

        cur[lanes] = torch.where(
            any_hit, chosen & IDX_MASK,
            torch.where(can_pop, pop_cur, torch.where(done, -1, c))).to(i32)
        leaf[lanes] = torch.where(
            any_hit, (chosen & LEAF_BIT) != 0,
            torch.where(can_pop, pop_leaf, lf & ~done))
        pend[lanes] = torch.where(
            any_hit, 0, torch.where(can_pop, pop_pend, pd)).to(i32)
        sp[lanes] = s
        nstack[lanes], mstack[lanes], tstack[lanes] = ns, ms, ts
        best_t[lanes], best_i[lanes] = bt, bi
        best_u[lanes], best_v[lanes] = bu, bv

    out = (best_i, best_t, best_u, best_v)
    if return_stats:
        return out + (dict(node_steps=node_steps, leaf_steps=leaf_steps,
                           node_tests=node_tests, leaf_tests=leaf_tests,
                           it=it, node_rows=node_rows, leaf_rows=leaf_rows),)
    return out


def closest_hit(geom: GeometryArrays, o, d, t_min, t_max, force_bvh=False,
                count="brute_kernel"):
    """Dispatch as ppg_tpu's closest_hit: the sweep up to BRUTE_MAX
    triangles (kernel launches counted under brute.COUNTS[count]), the
    BVH walk above it or with `force_bvh`. Returns (packed tri index or
    -1, t, u, v)."""
    if geom.num_tris <= BRUTE_MAX and not force_bvh:
        return brute_closest(geom.tri, o, d, t_min, t_max, count)
    return bvh_closest(geom, o, d, t_min, t_max)


def any_hit(geom: GeometryArrays, o, d, t_min, t_max):
    """Occlusion test (shadow rays), as ppg_tpu's any_hit: whether the
    walk (or, up to BRUTE_MAX triangles, the sweep) finds a hit with
    t_min < t < t_max. On a card the any-hit kernels stop each ray at its
    first hit; lanes with t_max < t_min are parked and never occluded.
    Returns bool [L]."""
    if geom.num_tris <= BRUTE_MAX:
        return brute_any_hit(geom.tri, o, d, t_min, t_max)
    return bvh_any_hit(geom, o, d, t_min, t_max)

"""Host-side SD-tree topology management between iterations (numpy and
native C++ kernels).

The port's own copy of the numpy half of ppg_tpu/guiding/host.py's
HostSDTree. The topology work (STree::refine, guided_path.cpp:957-998;
DTree::reset, :456-514; DTree::build, :520-533) runs in the native
kernels of csrc/host/sdtree_host.cpp (a copy of ppg_tpu's), built and
loaded by ppg_tpu_torch/native.py. `push` returns the port's SDTreeArrays
on a given device and `pull` takes them back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..native import sdtree_lib
from .sdtree import MAX_Q_DEPTH, MAX_S_DEPTH, SDTreeArrays

UINT16_CAP = 65535  # per-dtree node cap (reference :499-503)


def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


_F64, _I64 = ctypes.c_double, ctypes.c_int64


class HostSDTree:
    def __init__(self, aabb_min, aabb_max):
        # cube extension (STree ctor, guided_path.cpp:855-859)
        size = (np.asarray(aabb_max, np.float64)
                - np.asarray(aabb_min, np.float64))
        self.aabb_min = np.asarray(aabb_min, np.float64)
        self.aabb_size = float(size.max())

        self.s_child = np.full((1, 2), -1, np.int64)
        self.s_dtree = np.array([0], np.int64)  # leaf -> dtree row

        # one dtree, one root node, per pool
        self.b_off = np.array([0], np.int64)
        self.b_cnt = np.array([1], np.int64)
        self.qb_sum = np.zeros((1, 4), np.float64)
        self.qb_child = np.full((1, 4), -1, np.int64)

        self.s_off = np.array([0], np.int64)
        self.s_cnt = np.array([1], np.int64)
        self.qs_sum = np.zeros((1, 4), np.float64)
        self.qs_child = np.full((1, 4), -1, np.int64)

        self.statw_b = np.zeros(1)
        self.statw_s = np.zeros(1)
        self.sum_s = np.zeros(1)
        self.maxdepth = np.ones(1, np.int64)

        self.opt_var = np.zeros(1)
        self.opt_m1 = np.zeros(1)
        self.opt_m2 = np.zeros(1)
        self.opt_iter = np.zeros(1, np.int64)
        self.opt_bgrad = np.zeros(1)
        self.opt_bweight = np.zeros(1)

    @property
    def num_dtrees(self):
        return len(self.b_off)

    def approx_memory_mb(self):
        nodes = len(self.qb_sum) + len(self.qs_sum)
        return nodes * (4 * 4 + 4 * 2) / 1e6  # sums f32 + children u16

    # -- device sync ----------------------------------------------------------

    def pull(self, sdt: SDTreeArrays):
        """Copy the pass's accumulation back (building sums, statweights,
        Adam state)."""
        host = lambda x: x.detach().cpu().numpy()
        T = self.num_dtrees
        self.qb_sum = host(sdt.qb_sum).astype(np.float64)[:len(self.qb_sum)]
        self.statw_b = host(sdt.db_statw).astype(np.float64)[:T]
        for f in ("opt_var", "opt_m1", "opt_m2", "opt_bgrad", "opt_bweight"):
            setattr(self, f, host(getattr(sdt, f)).astype(np.float64)[:T])
        self.opt_iter = host(sdt.opt_iter).astype(np.int64)[:T]

    def push(self, device) -> SDTreeArrays:
        """Upload as float32 / int32 tensors on `device`. The walk lengths
        round the trees' depths up to multiples of 4."""
        # torch.tensor copies, so passes never write into host arrays
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32),
                                     device=device)
        i32 = lambda a: torch.tensor(np.asarray(a).astype(np.int32),
                                     device=device)

        def round4(x, cap):
            return int(min(((max(int(x), 1) + 3) // 4) * 4, cap))

        s_depth = round4(self._stree_depth(), MAX_S_DEPTH)
        q_depth = round4(max(int(self.maxdepth.max()) if len(self.maxdepth)
                             else 1, int(self._building_depth())),
                         MAX_Q_DEPTH)
        return SDTreeArrays(
            s_depth=s_depth,
            q_depth=q_depth,
            aabb_min=f32(self.aabb_min),
            aabb_size=f32(self.aabb_size),
            s_child=i32(self.s_child),
            s_dtree=i32(self.s_dtree),
            qs_sum=f32(self.qs_sum),
            qs_child=i32(self.qs_child),
            ds_root=i32(self.s_off),
            ds_sum=f32(self.sum_s),
            ds_statw=f32(self.statw_s),
            qb_sum=f32(self.qb_sum),
            qb_child=i32(self.qb_child),
            db_root=i32(self.b_off),
            db_statw=f32(self.statw_b),
            opt_var=f32(self.opt_var),
            opt_m1=f32(self.opt_m1),
            opt_m2=f32(self.opt_m2),
            opt_iter=i32(self.opt_iter),
            opt_bgrad=f32(self.opt_bgrad),
            opt_bweight=f32(self.opt_bweight),
        )

    # -- build (end of iteration): sums up, copy building -> sampling --------

    def build(self):
        """QuadTreeNode::build + DTree::build + DTreeWrapper::build."""
        lib = sdtree_lib()
        N, T = len(self.qb_sum), self.num_dtrees
        qb_sum = np.ascontiguousarray(self.qb_sum, np.float64)
        qb_child = np.ascontiguousarray(self.qb_child, np.int64)
        b_off = np.ascontiguousarray(self.b_off, np.int64)
        b_cnt = np.ascontiguousarray(self.b_cnt, np.int64)
        sum_s = np.zeros(T)
        maxdepth = np.zeros(T, np.int64)
        lib.ppg_sdt_pushdown(N, _p(qb_sum, _F64), _p(qb_child, _I64))
        lib.ppg_sdt_build(N, T, _p(qb_sum, _F64), _p(qb_child, _I64),
                          _p(b_off, _I64), _p(b_cnt, _I64), _p(sum_s, _F64),
                          _p(maxdepth, _I64))
        self.qb_sum = qb_sum
        self.sum_s = sum_s
        self.qs_sum = qb_sum.copy()
        self.qs_child = qb_child.copy()
        self.s_off = self.b_off.copy()
        self.s_cnt = self.b_cnt.copy()
        self.statw_s = self.statw_b.copy()
        self.maxdepth = maxdepth

    def distribution_stats(self):
        """min/avg/max over the sampling D-trees of depth, mean radiance,
        node count and statistical weight (guided_path.cpp:1121-1186)."""
        statw = self.statw_s
        active = statw > 0
        mean = np.where(active, self.sum_s / (4 * np.pi * np.maximum(
            statw, 1e-300)), 0.0)

        def mam(v, mask=None):
            v = v[mask] if mask is not None and mask.any() else v
            if len(v) == 0:
                return dict(min=0.0, avg=0.0, max=0.0)
            return dict(min=float(v.min()), avg=float(v.mean()),
                        max=float(v.max()))

        return dict(
            n_dtrees=int(self.num_dtrees),
            stree_depth=int(self._stree_depth()),
            depth=mam(self.maxdepth.astype(np.float64)),
            mean_radiance=mam(mean, active),
            nodes=mam(self.s_cnt.astype(np.float64)),
            stat_weight=mam(statw, active),
            approx_memory_mb=float(self.approx_memory_mb()),
        )

    def _stree_depth(self):
        depth = 1
        frontier = np.array([0])
        while True:
            internal = frontier[self.s_dtree[frontier] < 0]
            if len(internal) == 0:
                return depth
            frontier = self.s_child[internal].ravel()
            depth += 1

    def _building_depth(self):
        """Levels of the deepest building quadtree (level BFS; children
        always have larger indices than their parent)."""
        depth = 0
        frontier = self.b_off[self.b_cnt > 0]
        while len(frontier):
            kids = self.qb_child[frontier].ravel()
            frontier = kids[kids >= 0]
            depth += 1
        return max(depth, 1)

    def leaf_boxes(self):
        """(pos, size) world-space box per spatial leaf, by dtree id; a
        level-by-level walk (the split axis cycles x -> y -> z per depth,
        so a whole level shares one axis)."""
        out_pos = np.zeros((self.num_dtrees, 3))
        out_size = np.zeros((self.num_dtrees, 3))
        nodes = np.array([0], np.int64)
        lo = self.aabb_min[None, :].copy()
        size = np.full((1, 3), self.aabb_size)
        axis = 0
        while len(nodes):
            t = self.s_dtree[nodes]
            leaf = t >= 0
            out_pos[t[leaf]] = lo[leaf]
            out_size[t[leaf]] = size[leaf]
            internal = ~leaf
            if not internal.any():
                break
            n = nodes[internal]
            l0 = lo[internal]
            h = size[internal].copy()
            h[:, axis] /= 2
            l1 = l0.copy()
            l1[:, axis] += h[:, axis]
            nodes = np.concatenate([self.s_child[n, 0], self.s_child[n, 1]])
            lo = np.concatenate([l0, l1])
            size = np.concatenate([h, h])
            axis = (axis + 1) % 3
        return out_pos, out_size

    # -- reset (start of iteration) -------------------------------------------

    def refine_and_reset(self, iter_idx, spp_per_pass, s_tree_threshold,
                         d_tree_threshold, sd_tree_max_mb=-1):
        """resetSDTree (guided_path.cpp:1108-1113): STree::refine with the
        iteration-scaled threshold, then DTree::reset for every leaf."""
        threshold = (np.sqrt((2.0 ** iter_idx) * spp_per_pass / 4.0)
                     * s_tree_threshold)
        self._stree_refine(threshold, sd_tree_max_mb)
        self._dtree_reset_all(d_tree_threshold)

    def _stree_refine(self, samples_required, max_mb):
        if max_mb >= 0 and self.approx_memory_mb() >= max_mb:
            return
        # level-synchronous subdivision: splitting every over-threshold
        # leaf per level until none remain gives the reference DFS's
        # topology, since children inherit exactly half the statweight
        s_child = self.s_child
        s_dtree = self.s_dtree.copy()
        statw = self.statw_b.copy()
        dtree_src = np.arange(self.num_dtrees, dtype=np.int64)
        frontier = np.nonzero(s_dtree >= 0)[0]
        while len(frontier):
            t = s_dtree[frontier]
            can = statw[t] > samples_required
            if not can.any() or len(s_child) >= 2 ** 31 - 3:
                break
            split = frontier[can]
            ts = t[can]
            k = len(split)
            kids = len(s_child) + np.arange(2 * k, dtype=np.int64)
            s_child = np.concatenate(
                [s_child, np.full((2 * k, 2), -1, np.int64)])
            s_child[split, 0] = kids[0::2]
            s_child[split, 1] = kids[1::2]
            new_t = len(statw) + np.arange(2 * k, dtype=np.int64)
            s_dtree = np.concatenate([s_dtree, new_t])
            s_dtree[split] = -1
            # children inherit a copy of the dtree with halved statweight
            # (STreeNode::subdivide, :876-895)
            statw = np.concatenate([statw, np.repeat(statw[ts] / 2, 2)])
            dtree_src = np.concatenate(
                [dtree_src, np.repeat(dtree_src[ts], 2)])
            frontier = kids
        self.s_child = s_child

        # compact dtrees: keep only leaves' dtrees, in leaf order
        leaf_nodes = np.nonzero(s_dtree >= 0)[0]
        old_ids = s_dtree[leaf_nodes]
        src = dtree_src[old_ids]
        new_statw = statw[old_ids]
        if len(src) == self.num_dtrees and (src == np.arange(len(src))).all():
            self.statw_b = new_statw  # no splits: layout unchanged
            return
        self._gather_dtrees(src, new_statw)
        self.s_dtree = np.full(len(self.s_child), -1, np.int64)
        self.s_dtree[leaf_nodes] = np.arange(len(leaf_nodes))

    def _gather_dtrees(self, src, new_statw_b):
        """Recreate per-dtree slabs for the new dtree list `src` (source
        dtree row per new dtree), remapping global child indices."""
        lib = sdtree_lib()

        def regather(off, cnt, q_sum, q_child):
            n_cnt = cnt[src]
            n_off = np.concatenate([[0], np.cumsum(n_cnt)[:-1]]).astype(
                np.int64)
            total = int(n_cnt.sum())
            q_sum = np.ascontiguousarray(q_sum, np.float64)
            q_child = np.ascontiguousarray(q_child, np.int64)
            srcc = np.ascontiguousarray(src, np.int64)
            offc = np.ascontiguousarray(off, np.int64)
            cntc = np.ascontiguousarray(cnt, np.int64)
            ns = np.empty((total, 4), np.float64)
            nc = np.empty((total, 4), np.int64)
            lib.ppg_sdt_regather(len(src), _p(srcc, _I64), _p(offc, _I64),
                                 _p(cntc, _I64), _p(q_sum, _F64),
                                 _p(q_child, _I64), _p(n_off, _I64),
                                 _p(ns, _F64), _p(nc, _I64))
            return n_off, n_cnt, ns, nc

        self.b_off, self.b_cnt, self.qb_sum, self.qb_child = regather(
            self.b_off, self.b_cnt, self.qb_sum, self.qb_child)
        self.s_off, self.s_cnt, self.qs_sum, self.qs_child = regather(
            self.s_off, self.s_cnt, self.qs_sum, self.qs_child)
        self.statw_b = new_statw_b
        self.statw_s = self.statw_s[src]
        self.sum_s = self.sum_s[src]
        self.maxdepth = self.maxdepth[src]
        for f in ("opt_var", "opt_m1", "opt_m2", "opt_iter", "opt_bgrad",
                  "opt_bweight"):
            setattr(self, f, getattr(self, f)[src])

    def _dtree_reset_all(self, threshold):
        """DTree::reset across all dtrees: the new building topology
        refines the sampling tree wherever a quadrant carries more than
        `threshold` of its tree's energy (max depth 20, 65535 nodes per
        tree); all sums start at zero."""
        lib = sdtree_lib()
        T = self.num_dtrees
        tot = np.ascontiguousarray(self.sum_s, np.float64)
        s_off = np.ascontiguousarray(self.s_off, np.int64)
        qs_sum = np.ascontiguousarray(self.qs_sum, np.float64)
        qs_child = np.ascontiguousarray(self.qs_child, np.int64)
        N = lib.ppg_sdt_reset(T, _p(tot, _F64), _p(s_off, _I64),
                              _p(qs_sum, _F64), _p(qs_child, _I64),
                              float(threshold), MAX_Q_DEPTH, UINT16_CAP)
        qb_child = np.empty((N, 4), np.int64)
        cnt = np.empty(T, np.int64)
        lib.ppg_sdt_reset_copy(_p(qb_child, _I64), _p(cnt, _I64))
        self.b_cnt = cnt
        self.b_off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(
            np.int64)
        self.qb_sum = np.zeros((N, 4), np.float64)
        self.qb_child = qb_child
        self.statw_b = np.zeros(T)

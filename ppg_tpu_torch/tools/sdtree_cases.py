"""SD-trees and lanes made with numpy, for holding the descent kernels
(csrc/sdtree.cu) against their plain versions: tests/test_torch_descent*.py
take their edge cases from here, chip_smoke.py its trained tree. The
trees are the
port's SDTreeArrays on the CPU (`to_device` moves one);
`capture_sampling_trees` records the trees a GuidedPathTracer's passes
sample from, so that a check can take a trained tree.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..convert import sdtree_from_numpy
from ..core.warp import dir_to_canonical
from ..guiding.sdtree import MAX_Q_DEPTH, SDTreeArrays

CHAIN_Q = 25  # quadtree chain length, past the walk's 20 levels


def unit(rng, n):
    """n unit vectors [n,3] float32."""
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def to_device(sdt, device):
    return SDTreeArrays(sdt.s_depth, sdt.q_depth, **{
        f: getattr(sdt, f).to(device) for f in SDTreeArrays.FIELDS})


def tree(s_child, s_dtree, s_depth, qs_sum, qs_child, ds_root, ds_sum,
         ds_statw, opt_var, q_depth):
    """An SD-tree on the CPU from its spatial and sampling tables (the
    building pool a copy of the sampling pool, the Adam state zero), over
    the box [-1, 0.5, 2] + [0, 4]^3."""
    T = len(ds_root)
    f = dict(aabb_min=np.array([-1.0, 0.5, 2.0], np.float32),
             aabb_size=np.float32(4.0), s_child=s_child, s_dtree=s_dtree,
             qs_sum=qs_sum, qs_child=qs_child, ds_root=ds_root,
             ds_sum=ds_sum, ds_statw=ds_statw, qb_sum=qs_sum,
             qb_child=qs_child, db_root=ds_root, db_statw=ds_statw,
             opt_var=opt_var, opt_m1=np.zeros(T), opt_m2=np.zeros(T),
             opt_iter=np.zeros(T), opt_bgrad=np.zeros(T),
             opt_bweight=np.zeros(T))
    return sdtree_from_numpy(f, s_depth, q_depth, "cpu")


def deep_tree(cap_spatial):
    """A spatial chain of 30 internal nodes toward the (1, 1, 1) corner
    (child 0 a leaf, child 1 the next node), walked for 31 levels or, with
    cap_spatial, 24 (the walk then ends on an internal node: id -1). The
    quadtree: a chain of CHAIN_Q nodes through quadrant 3, which holds most
    of the mass; then an all-zero node, and a node with zero quadrants.
    Dtrees: 0 the chain's root, 1 mid-chain, 2 the all-zero node, 3 the
    node with zero quadrants, 4 uniform (sum 0), 5 uniform (statw 0)."""
    rng = np.random.default_rng(3)
    n_int, T = 30, 6
    s_child = np.zeros((2 * n_int + 1, 2), np.int32)
    s_dtree = np.full(2 * n_int + 1, -1, np.int32)
    for k in range(n_int):
        leaf = n_int + k
        s_child[k] = [leaf, k + 1 if k + 1 < n_int else 2 * n_int]
        s_dtree[leaf] = k % T
    s_child[n_int:] = -1
    s_dtree[2 * n_int] = 1
    Q = CHAIN_Q + 2
    qs_sum = rng.random((Q, 4)).astype(np.float32)
    qs_sum[:CHAIN_Q, 3] = 1000.0 * (1 + rng.random(CHAIN_Q))
    qs_child = np.full((Q, 4), -1, np.int32)
    qs_child[:CHAIN_Q - 1, 3] = np.arange(1, CHAIN_Q)
    qs_sum[CHAIN_Q] = 0.0  # degenerate
    qs_sum[CHAIN_Q + 1, [0, 2]] = 0.0  # zero quadrants: factor 0
    ds_root = np.array([0, 9, CHAIN_Q, CHAIN_Q + 1, 0, 0], np.int32)
    ds_sum = np.array([5.0, 2.0, 1.0, 3.0, 0.0, 4.0], np.float32)
    ds_statw = np.array([2.0, 1.0, 1.0, 1.0, 1.0, 0.0], np.float32)
    opt_var = rng.normal(size=T).astype(np.float32) * 3
    return tree(s_child, s_dtree, 24 if cap_spatial else n_int + 1,
                 qs_sum, qs_child, ds_root, ds_sum, ds_statw, opt_var,
                 MAX_Q_DEPTH)


def flat_tree():
    """One spatial leaf (dtree 2); dtrees 0 uniform (sum 0), 1 with a root
    whose four sums are 0, 2 with a leaf-only root holding two zero
    quadrants."""
    qs_sum = np.array([[0.0, 0.0, 0.0, 0.0], [0.0, 3.0, 0.0, 1.0]],
                      np.float32)
    return tree(np.full((1, 2), -1, np.int32), np.full(1, 2, np.int32), 4,
                 qs_sum, np.full((2, 4), -1, np.int32),
                 np.array([0, 0, 1], np.int32),
                 np.array([0.0, 1.0, 1.0], np.float32),
                 np.array([1.0, 1.0, 1.0], np.float32),
                 np.array([0.0, 25.0, -25.0], np.float32), 4)


def positions(sdt, rng, L):
    """Positions [L,3] (L >= 89) uniform over the tree's box grown by a
    tenth on each side, and edge lanes: normalised 0, 0.5, 1.0 and
    1 - 2^-k per axis, NaN, +-inf."""
    lo = sdt.aabb_min.cpu().numpy().astype(np.float64)
    side = float(sdt.aabb_size)
    x = rng.random((L, 3)) * 1.2 - 0.1
    edges = [0.0, 0.5, 1.0, 0.25, 0.75] + [1 - 2.0 ** -k
                                           for k in range(1, 24)]
    n = len(edges)
    x[:n] = np.array(edges)[:, None]
    x[n:2 * n, 0] = edges
    x[2 * n:3 * n] = rng.choice(edges, (n, 3))
    p = (lo + x * side).astype(np.float32)
    k = 3 * n
    p[k:k + 3] = [[np.nan, 0, 0], [0, np.inf, 0], [0, 0, -np.inf]]
    p[k + 3:k + 5] = [[np.inf] * 3, [-np.inf, np.nan, np.inf]]
    return torch.from_numpy(p)


def walk_inputs(sdt, rng, L):
    """(u [L,22] with 0, 0.5 and 1 - 2^-24 among them, is_point [L],
    canonical points [L,2] of unit directions and of NaN / +-inf
    directions, some NaN and +-inf points themselves, dtree ids [L] with
    -1 among them), for L >= 12."""
    T = sdt.ds_root.shape[0]
    u = rng.random((L, MAX_Q_DEPTH + 2)).astype(np.float32)
    u[:L // 8] = 1 - 2.0 ** -24
    u[L // 8:L // 6] = rng.choice([0.0, 0.5], (L // 6 - L // 8, u.shape[1]))
    d = unit(rng, L)
    d[:5] = [[np.nan, 0, 1], [np.inf, 0, 0], [0, -np.inf, 0],
             [np.nan] * 3, [0, 0, 1]]
    pc = dir_to_canonical(torch.from_numpy(d))
    pc[5:12] = torch.tensor([[np.nan, 0.3], [0.3, np.nan], [np.inf, 0.2],
                             [-np.inf, 0.9], [1.0, 1.0], [0.5, 0.5],
                             [1.0, 0.0]])
    ids = torch.from_numpy(rng.integers(-1, T, L).astype(np.int32))
    is_point = torch.from_numpy(rng.random(L) < 0.5)
    return torch.from_numpy(u), is_point, pc.contiguous(), ids


@contextlib.contextmanager
def capture_sampling_trees(tracer):
    """Within the block, each call of tracer._render_passes appends the
    SD-tree its passes sample from to the yielded list (the last one is
    the tree of the render's final iteration, trained by all before it;
    the tree left in tracer.sdtree after render() is none that a pass
    sampled from)."""
    trees, render_passes = [], tracer._render_passes

    def record(n_passes, sdtree, *args):
        trees.append(sdtree)
        return render_passes(n_passes, sdtree, *args)

    tracer._render_passes = record
    try:
        yield trees
    finally:
        del tracer._render_passes

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
    """(u [L,22] with 0, 0.5 and 1 - 2^-24 among them, level-major as the
    tracer draws it on a card (the transpose of a contiguous [22, L]), is_point [L],
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
    return (torch.from_numpy(u).t().contiguous().t(), is_point,
            pc.contiguous(), ids)


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


def grid_tree(levels, T=7):
    """A complete spatial tree of `levels` levels (2^levels leaves, the
    leaf k holding dtree k % T) over tree()'s box, the quadtree of
    deep_tree(False) under every dtree: a box over many leaves overflows
    the walk's S_TARGETS."""
    n_int = (1 << levels) - 1
    S = 2 * n_int + 1
    s_child = np.full((S, 2), -1, np.int32)
    s_child[:n_int] = np.stack([2 * np.arange(n_int) + 1,
                                2 * np.arange(n_int) + 2], -1)
    s_dtree = np.full(S, -1, np.int32)
    s_dtree[n_int:] = np.arange(S - n_int) % T
    q = deep_tree(False)
    return tree(s_child, s_dtree, levels + 1, q.qs_sum.numpy(),
                q.qs_child.numpy(), np.zeros(T, np.int32),
                np.ones(T, np.float32), np.ones(T, np.float32),
                np.zeros(T, np.float32), MAX_Q_DEPTH)


def box_records(sdt, rng, L):
    """Records for the spatial box walk, (p [L,3], voxel [L,3], mask [L]),
    L >= 120: positions as `positions` gives them (split planes, far
    faces, NaN, +-inf), voxels from 0 to 1.2 of the box's side on each
    axis, a zero voxel (the volume's clamp), boxes over the whole tree
    (past S_TARGETS leaves and, on a deep chain, past the stack), a
    negative and a NaN voxel; 80% of the records in the mask."""
    side = float(sdt.aabb_size)
    p = positions(sdt, rng, L)
    v = rng.choice([0.0, 1e-3, 0.01, 0.1, 0.3], (L, 3)) * rng.random((L, 3))
    v[:8] = 0.0
    v[8:40] = rng.uniform(0.5, 1.2, (32, 3))
    v[40:44] = [[1e-30, 1e-30, 1e-30], [-0.1, 0.2, 0.2], [np.nan, 0.1, 0.1],
                [np.inf, 0.1, 0.1]]
    # boxes centred in the tree over its whole extent
    p[100:110] = sdt.aabb_min.cpu() + torch.tensor(
        rng.uniform(0.3, 0.7, (10, 3)), dtype=torch.float32) * side
    v[100:110] = 2.5
    mask = torch.from_numpy(rng.random(L) < 0.8)
    mask[100:110] = True
    return p, torch.from_numpy((v * side).astype(np.float32)), mask


def path_chain_tree(bits, T=7):
    """A spatial chain down the halves `bits` (0 or 1, one a level): the
    internal node k at depth k takes half bits[k] to node k + 1 (after
    the last, the leaf 2n, dtree T - 1), its other child the leaf n + k
    (dtree k % T); len(bits) + 1 levels, over tree()'s box, the quadtree
    of deep_tree(False) under every dtree. Deep enough, its corners need
    every bit a float32 holds, or more (the plain walk then rounds)."""
    n = len(bits)
    s_child = np.full((2 * n + 1, 2), -1, np.int32)
    s_dtree = np.full(2 * n + 1, -1, np.int32)
    for k, b in enumerate(bits):
        s_child[k, b] = k + 1 if k + 1 < n else 2 * n
        s_child[k, 1 - b] = n + k
        s_dtree[n + k] = k % T
    s_dtree[2 * n] = T - 1
    q = deep_tree(False)
    return tree(s_child, s_dtree, min(n + 1, 64), q.qs_sum.numpy(),
                q.qs_child.numpy(), np.zeros(T, np.int32),
                np.ones(T, np.float32), np.ones(T, np.float32),
                np.zeros(T, np.float32), MAX_Q_DEPTH)


def chain_records(sdt, bits, rng, L):
    """Records for the spatial box walk on path_chain_tree(bits): boxes
    about the chain's deepest cell (its centre in float64, rounded once to
    a position), of sides from the whole box down to 2^-30 of it with
    jitter, a tenth of them moved by up to their side. Returns (p [L,3],
    voxel [L,3])."""
    lo = np.zeros(3)
    n_ax = np.zeros(3, np.int64)
    for k, b in enumerate(bits):
        a = k % 3
        n_ax[a] += 1
        lo[a] += b * 2.0 ** -n_ax[a]
    centre = lo + 0.5 * 2.0 ** -n_ax
    side = float(sdt.aabb_size)
    v = 2.0 ** -rng.uniform(0, 30, (L, 1)) * rng.uniform(0.5, 1.5, (L, 3))
    x = np.broadcast_to(centre, (L, 3)).copy()
    moved = rng.random(L) < 0.1
    x[moved] += v[moved] * rng.uniform(-1, 1, (int(moved.sum()), 3))
    p = sdt.aabb_min.cpu().numpy().astype(np.float64) + x * side
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return f32(p), f32(v * side)


def fork_chain_tree(bits, T=7):
    """A root whose child 0 (the lower half of x) is an internal node over
    two leaves (dtrees 0 and 1) and whose child 1 is path_chain_tree(bits)
    one level down: a walk pushes that inner child 0 first and pops it
    only after the whole chain below child 1, so the pop climbs from the
    chain's deepest node back to the root."""
    n = len(bits)
    chain = path_chain_tree(bits, T)
    s_child = np.full((2 * n + 5, 2), -1, np.int32)
    s_dtree = np.full(2 * n + 5, -1, np.int32)
    s_child[0] = [1, 4]
    s_child[1] = [2, 3]
    s_dtree[2:4] = [0, 1]
    c = chain.s_child.numpy()
    s_child[4:] = np.where(c >= 0, c + 4, -1)
    s_dtree[4:] = chain.s_dtree.numpy()
    return tree(s_child, s_dtree, min(n + 2, 64), chain.qs_sum.numpy(),
                chain.qs_child.numpy(), np.zeros(T, np.int32),
                np.ones(T, np.float32), np.ones(T, np.float32),
                np.zeros(T, np.float32), MAX_Q_DEPTH)


def fork_records(sdt, rng, L):
    """Records for fork_chain_tree([0] * n): boxes from 2^-2 to 2^-8 of the
    side below x = 0.5 (over the root's child 0) to 2^-18 to 2^-25 above
    it, and from 2^-2 to 2^-8 below 0 to 2^-20 to 2^-30 above it on y and
    z, so that most walk the chain toward (0.5, 0, 0) until its cells'
    float widths run out (about 72 levels) with fewer than S_TARGETS
    leaves met, then pop the root's child 0. Returns (p [L,3], voxel
    [L,3])."""
    lo = -(2.0 ** -rng.uniform(2, 8, (L, 3)))
    hi = np.stack([2.0 ** -rng.uniform(18, 25, L),
                   2.0 ** -rng.uniform(20, 30, L),
                   2.0 ** -rng.uniform(20, 30, L)], -1)
    lo[:, 0] += 0.5
    hi[:, 0] += 0.5
    side = float(sdt.aabb_size)
    p = sdt.aabb_min.cpu().numpy().astype(np.float64) + (lo + hi) / 2 * side
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return f32(p), f32((hi - lo) * side)


def dir_inputs(sdt, rng, L):
    """(dtree ids [L] i32 in [0, T), canonical points [L,2]) for the
    directional splat targets, L >= 60: walk_inputs' points (NaN and
    +-inf among them), points at and just beside the split planes 0.5 and
    0.25, at 0, 1 - 1e-6 and 1, and clustered about (0.5, 0.5), where the
    cells are small."""
    T = sdt.db_root.shape[0]
    pc = walk_inputs(sdt, rng, L)[2].clone()
    edges = torch.tensor([0.0, 0.25, 0.5, 1 - 1e-6, 1.0,
                          np.nextafter(np.float32(0.5), np.float32(0)),
                          np.nextafter(np.float32(0.5), np.float32(1))],
                         dtype=torch.float32)
    n = len(edges)
    pc[12:12 + n * n] = torch.stack(torch.meshgrid(edges, edges,
                                                   indexing="ij"),
                                    -1).reshape(-1, 2)
    k = 12 + n * n
    pc[k:k + L // 4] = torch.from_numpy(
        (0.5 + rng.normal(0, 1e-3, (L // 4, 2))).clip(0, 1)
        .astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, T, L).astype(np.int32))
    return ids, pc.contiguous()


def adam_leaves(rng, T):
    """Bucket sums and Adam state for T >= 40 dtrees, as _adam_rounds
    takes them: (S0, S1 [T,62], G0, W [T]) and (opt_var, opt_m1, opt_m2
    [T] f32, opt_iter [T] i32). Among the dtrees: W = 0, W < 2 (no step),
    W giving k < 64 steps (rounds without a step), k not a multiple of 64,
    var at +-20 and at +-15 (fractions near 0 and 1), empty buckets."""
    S0 = (rng.random((T, 62)) * 10 * (rng.random((T, 62)) < 0.7))
    S1 = rng.normal(0, 0.5, (T, 62)) * (S0 > 0)
    G0 = rng.normal(0, 5, T)
    W = rng.uniform(0, 3000, T)
    W[:4] = [0.0, 1.5, 1.999, 0.25]
    W[4:12] = rng.uniform(2, 128, 8)
    W[12:16] = [128.0, 129.0, 2 * 64 * 3 + 7, 2 * 64 * 5]
    var = rng.normal(0, 2, T)
    var[16:20] = [20.0, -20.0, 15.0, -15.0]
    m1 = rng.normal(0, 0.1, T)
    m2 = rng.random(T) * 0.1
    it = rng.integers(0, 5000, T)
    var[20:30], m1[20:30], m2[20:30], it[20:30] = 0.0, 0.0, 0.0, 0
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return ((f32(S0), f32(S1), f32(G0), f32(W)),
            (f32(var), f32(m1), f32(m2),
             torch.from_numpy(it.astype(np.int32))))


def adam_edge_leaves(rng, T):
    """adam_leaves(rng, T), T >= 48, with the step counts' edges: k = 63
    (q = 0, r = 63), k = 64 (q = 1, r = 0), a negative W (no step, the
    count moves back), NaN and +inf W, a count near 2^30 and one that
    wraps past 2^31 - 1, and bucket sums of magnitudes 1e-6 to 1e6 whose
    sum depends on its order."""
    (S0, S1, G0, W), (var, m1, m2, it) = adam_leaves(rng, T)
    W[30:34] = torch.tensor([127.5, 128.5, -5.0, float("nan")])
    W[34], W[35:37] = float("inf"), 2500.0
    it[35:37] = torch.tensor([2 ** 30 + 12345, 2 ** 31 - 10],
                             dtype=torch.int32)
    mag = torch.from_numpy(10.0 ** rng.integers(-6, 7, (8, 62)))
    S0[40:48] = (S0[40:48] + 0.5) * mag.float()
    S1[40:48] = S1[40:48] * mag.float()
    return (S0, S1, G0, W), (var, m1, m2, it)


def dir_edge_ids(sdt, rng, L):
    """Dtree ids [L] i32 for the directional splat targets, L >= 16: ids in
    [0, T), ids in [-T, 0) (torch counts them from the end) and, in the
    first 8 lanes, ids outside [-T, T), whose root K5a reads as -1, a
    root outside the pool (the plain version's indexing raises on
    them)."""
    T = sdt.db_root.shape[0]
    ids = rng.integers(-T, T, L).astype(np.int64)
    ids[:8] = [T, T + 5, -T - 1, -T - 7, 2 ** 30, -2 ** 31, 2 ** 31 - 1,
               3 * T]
    return torch.from_numpy(ids.astype(np.int32))


def outside_pool_targets(root, pc, depth=None):
    """What K5a gives lanes whose root lies outside the pool (a walk that
    reads no row): nearest, (node, quad, depth, cell) = (root, 0, 0,
    root * 4); box, with the box's depth [L] i32 (0 without one: the leaf
    descent took no level), cell4 = root * 4 in each slot and the first
    corner's overlap with the unit cell at the origin as its weight, the
    others 0 (the same cell), in the float32 operations of
    dtree_box_targets4_plain. Returns ((node, quad, depth, cell), (cell4,
    w4))."""
    L = root.shape[0]
    zero = torch.zeros(L, dtype=torch.int32)
    depth = zero if depth is None else depth
    s = 0.5 ** depth.to(torch.float32)
    lo = pc - s[:, None] * 0.5
    hi = pc + s[:, None] * 0.5
    o = torch.floor(torch.clamp(lo, 0.0, 1.0 - 1e-6))
    w2 = torch.clamp(torch.minimum(hi, o + 1.0) - torch.maximum(lo, o),
                     min=0.0)
    w4 = torch.zeros((L, 4))
    w4[:, 0] = (w2[:, 0] * w2[:, 1]) / torch.clamp(s * s, min=1e-38)
    cell = root * 4
    return (root, zero, zero, cell), (cell[:, None].repeat(1, 4), w4)

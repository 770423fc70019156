"""Device-side SD-tree: a spatial binary tree over directional quadtrees
(counterpart of ppg_tpu/guiding/sdtree.py).

Both trees are flat pools of tensors; the host (guiding/host.py) changes
their topology between iterations and the passes only read the sampling
pool and accumulate into the building pool:

  spatial  : s_child [S,2] (-1 for leaves), s_dtree [S] (leaf -> dtree)
  quadtrees: per pool q_sum [Q,4] f32 + q_child [Q,4] i32 (-1 = leaf
             quadrant), one root per dtree (ds_root / db_root); the
             sampling pool also as qs_row [Q,8] i32, both in one 32-byte
             row a node (K4's layout, built with the tree)
  K3's rows, built with the tree: s_row [S,4] i32 (the children and
             their dtree ids), s_oct [S,16] i32 (three levels a load)
             and ds_row [T,4] i32 (a dtree's root, sum and statweight)

The walks take one level per step over these plain tables, with the
semantics of ppg_tpu's one-level reference walks (lookup_ref,
sample_pdf_dir_ref). ppg_tpu's multi-level packed tables exist only to
cut TPU gather counts and are not carried over. Splats add into the
building pool in place.

The descents of a guided bounce (lookup, lookup_meta, dtree_meta,
sampling_fraction, sample_pdf_dir, pdf_dir2) run their *_plain versions
on CPU tensors and the hand-written kernels K3 and K4 on CUDA tensors
(guiding/descent.py, csrc/sdtree.cu), which equal the plain versions bit
for bit. So do the training pass's hot loops (descend_cell,
dtree_box_targets4 and dir_targets, the directional splat targets;
stree_box_targets, the spatial box walk; _adam_rounds, the Adam chain's
rounds), with the kernels K5a, K5b and K6 (guiding/train.py,
csrc/train.cu).
"""

from __future__ import annotations

import torch

from ..core.warp import INV_FOURPI, canonical_to_dir, dir_to_canonical
from ..ops.reduce import bincount_add, bincount_add2
from . import descent as D
from . import train as TR

MAX_S_DEPTH = 64  # spatial descent bound
MAX_Q_DEPTH = 20  # quadtree depth cap (DTree::reset maxDepth)


class SDTreeArrays:
    FIELDS = (
        "aabb_min", "aabb_size",
        "s_child", "s_dtree",
        # sampling pool (frozen during a pass)
        "qs_sum", "qs_child", "ds_root", "ds_sum", "ds_statw",
        # building pool (accumulated into during a pass)
        "qb_sum", "qb_child", "db_root", "db_statw",
        # per-dtree Adam state of the learned bsdf sampling fraction
        "opt_var", "opt_m1", "opt_m2", "opt_iter", "opt_bgrad", "opt_bweight",
    )

    def __init__(self, s_depth=MAX_S_DEPTH, q_depth=MAX_Q_DEPTH, **kw):
        # walk lengths: spatial / quadtree levels that the trees can have
        self.s_depth = s_depth
        self.q_depth = q_depth
        for f in self.FIELDS:
            setattr(self, f, kw[f])
        # the kernels' rows (guiding/descent.py), built where the tree
        # reaches the card: K4's one-sector rows of the sampling pool,
        # K3's octant entries (three levels a load) and spatial rows (a
        # level a load, for the levels left before s_depth), and the
        # dtrees' meta rows
        self.qs_row, self.qs_row_stamp = D.quad_rows(self.qs_sum,
                                                     self.qs_child)
        self.s_row, self.s_oct, self.s_row_stamp = D.spatial_rows(
            self.s_child, self.s_dtree, self.aabb_min, self.aabb_size)
        self.ds_row, self.ds_row_stamp = D.meta_rows(
            self.ds_root, self.ds_sum, self.ds_statw)


def _take(table, idx):
    return table[idx.long()]


def _sel4(arr, bx, by):
    """arr[lane, bx | by<<1]."""
    q = bx.long() | (by.long() << 1)
    return arr.gather(1, q[:, None])[:, 0]


def _quad_index(p):
    """(quadrant index, point rescaled into that quadrant)."""
    bx = p[..., 0] >= 0.5
    by = p[..., 1] >= 0.5
    px = torch.where(bx, (p[..., 0] - 0.5) * 2, p[..., 0] * 2)
    py = torch.where(by, (p[..., 1] - 0.5) * 2, p[..., 1] * 2)
    idx = bx.to(torch.int32) | (by.to(torch.int32) << 1)
    return idx, torch.stack([px, py], -1)


def _plain_on(t):
    """Counts a plain walk run on CUDA tensors (descent.COUNTS)."""
    if t.is_cuda:
        D.COUNTS["sd_plain_on_cuda"] += 1


def lookup(sdt: SDTreeArrays, p_world):
    """Spatial descent: (dtree id [L] i32, voxel size [L,3]). CPU tensors
    run lookup_plain; CUDA tensors launch K3 (guiding/descent.py)."""
    if p_world.is_cuda:
        return D.lookup(sdt, p_world)
    return lookup_plain(sdt, p_world)


def lookup_plain(sdt: SDTreeArrays, p_world, return_stats=False):
    """Spatial descent (STree::dTreeWrapper, guided_path.cpp:897-905):
    the split axis cycles x, y, z with depth. Returns (dtree id [L] i32,
    voxel size [L,3] in world units). With return_stats, also a dict of
    what the walk needs: "levels" [L] i32, the internal nodes each lane
    descends through, and "nodes", the distinct nodes read."""
    _plain_on(p_world)
    x = list(torch.clamp((p_world - sdt.aabb_min) / sdt.aabb_size,
                         0.0, 1.0).unbind(-1))
    L = x[0].shape[0]
    size = [torch.full((L,), 1.0, dtype=torch.float32, device=x[0].device)
            * sdt.aabb_size for _ in range(3)]
    node = torch.zeros(L, dtype=torch.int64, device=x[0].device)
    levels = torch.zeros(L, dtype=torch.int32, device=x[0].device)
    seen = []
    for level in range(sdt.s_depth):
        a = level % 3
        internal = sdt.s_dtree[node] < 0
        hi = x[a] >= 0.5
        child = torch.where(hi, sdt.s_child[node, 1], sdt.s_child[node, 0])
        x[a] = torch.where(internal, torch.where(hi, (x[a] - 0.5) * 2.0,
                                                 x[a] * 2.0), x[a])
        size[a] = torch.where(internal, size[a] * 0.5, size[a])
        if return_stats:
            levels += internal
            seen.append(node[internal])
        node = torch.where(internal, child.long(), node)
    out = sdt.s_dtree[node], torch.stack(size, -1)
    if return_stats:
        return (*out, dict(levels=levels,
                           nodes=torch.cat(seen + [node]).unique()))
    return out


def lookup_meta(sdt: SDTreeArrays, p_world, mask=None):
    """A guided bounce's lookups in one call: the spatial descent at
    p_world [L,3], the dtree id set to -1 where mask [L] (optional) is
    False, then dtree_meta and sampling_fraction of that id. Returns
    (dtree id [L] i32, voxel [L,3], root [L] i32, uniform [L] bool, frac
    [L]). CPU tensors run lookup_meta_plain; CUDA tensors launch K3 once."""
    if p_world.is_cuda:
        return D.lookup(sdt, p_world, mask, meta=True)
    return lookup_meta_plain(sdt, p_world, mask)


def lookup_meta_plain(sdt: SDTreeArrays, p_world, mask=None):
    dtree_id, voxel = lookup_plain(sdt, p_world)
    if mask is not None:
        dtree_id = torch.where(mask, dtree_id, -1)
    return (dtree_id, voxel, *dtree_meta_plain(sdt, dtree_id))


def dtree_meta(sdt: SDTreeArrays, dtree_id):
    """(root, uniform, frac) of dtree_meta_plain; CUDA tensors launch K3
    on the ids, without a descent."""
    if dtree_id.is_cuda:
        return D.meta(sdt, dtree_id)
    return dtree_meta_plain(sdt, dtree_id)


def dtree_meta_plain(sdt: SDTreeArrays, dtree_id):
    """Per-dtree scalars of a guided bounce: (root node [L] i32, uniform
    [L] bool -- the DTree's mean <= 0 or statWeight <= 0 falls back to the
    uniform sphere, guided_path.cpp:415-421/431-442 --, and the learned
    bsdf sampling fraction [L], logistic(opt_var))."""
    _plain_on(dtree_id)
    i = dtree_id.clamp(min=0)
    root = _take(sdt.ds_root, i)
    statw = _take(sdt.ds_statw, i)
    mean = _take(sdt.ds_sum, i) * INV_FOURPI / torch.clamp(statw, min=1e-38)
    uniform = ~(mean > 0) | (statw <= 0) | (dtree_id < 0)
    return root, uniform, _fraction(sdt, dtree_id)


def sample_pdf_dir(sdt: SDTreeArrays, u, is_point, p_point, root, uniform):
    """(direction [L,3], pdf [L]) of sample_pdf_dir_plain. CUDA tensors
    launch K4 for the canonical point and the pdf; canonical_to_dir
    stays in PyTorch."""
    if u.is_cuda:
        pfin, pdf = D.sample_pdf(sdt, u, is_point, p_point, root, uniform)
        return canonical_to_dir(pfin), pdf
    return sample_pdf_dir_plain(sdt, u, is_point, p_point, root, uniform)


def sample_pdf_dir_plain(sdt: SDTreeArrays, u, is_point, p_point, root,
                         uniform):
    """One walk over the sampling quadtree serving both halves of the
    one-sample MIS mixture (guided_path.cpp:1647-1692): lanes with
    ~is_point draw a direction by the conditional-CDF walk of DTree::sample
    (:257-301), one uniform of u [L, MAX_Q_DEPTH+2] per level plus two for
    the leaf cell; is_point lanes descend at p_point (canonical) as
    DTree::pdf does (:232-245). Returns (direction [L,3] -- meaningful for
    the sampling lanes --, pdf [L] of each lane's chosen direction).
    root / uniform come from dtree_meta."""
    pfin, pdf = sample_pdf_canonical_plain(sdt, u, is_point, p_point, root,
                                           uniform)
    return canonical_to_dir(pfin), pdf


def sample_pdf_canonical_plain(sdt: SDTreeArrays, u, is_point, p_point,
                               root, uniform, return_stats=False):
    """The walk of sample_pdf_dir_plain, returning the canonical point
    [L,2] in place of the direction (K4's specification). With
    return_stats, also a dict of what the walk needs: "levels" [L] i32,
    the nodes each lane reads before it stops (0 on uniform lanes, whose
    results do not depend on the walk), and "nodes", the distinct nodes
    read."""
    _plain_on(u)
    L = u.shape[0]
    dev = u.device
    node = root.long()
    p = p_point
    origin = torch.zeros((L, 2), dtype=torch.float32, device=dev)
    scale = torch.ones(L, dtype=torch.float32, device=dev)
    acc = torch.ones(L, dtype=torch.float32, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    dead = torch.zeros(L, dtype=torch.bool, device=dev)
    levels = torch.zeros(L, dtype=torch.int32, device=dev)
    seen = []
    for level in range(sdt.q_depth):
        sm = u[:, level]
        sums = sdt.qs_sum[node]
        kids = sdt.qs_child[node]
        if return_stats:
            walks = ~done & ~uniform
            levels += walks
            seen.append(node[walks])
        # the children in a fixed order, as K4 adds them
        total = ((sums[:, 0] + sums[:, 1]) + sums[:, 2]) + sums[:, 3]
        degenerate = ~(total > 0)
        # conditional-CDF choice (sampling lanes)
        top_left, top_right = sums[:, 0], sums[:, 1]
        partial = top_left + sums[:, 2]
        boundary = partial / torch.clamp(total, min=1e-38)
        go_right = sm >= boundary
        sm1 = torch.where(
            go_right,
            (sm - boundary) / torch.clamp(1 - boundary, min=1e-38),
            sm / torch.clamp(boundary, min=1e-38))
        part2 = torch.where(go_right, total - partial, partial)
        bnd2 = torch.where(go_right, top_right, top_left) / torch.clamp(
            part2, min=1e-38)
        go_down = sm1 >= bnd2
        # point choice (pdf lanes)
        bx = torch.where(is_point, p[:, 0] >= 0.5, go_right)
        by = torch.where(is_point, p[:, 1] >= 0.5, go_down)
        s_q = _sel4(sums, bx, by)
        child = _sel4(kids, bx, by)
        factor = torch.where(
            s_q > 0, 4.0 * s_q / torch.clamp(total, min=1e-38), 0.0)
        _, p2 = _quad_index(p)
        leaf = child < 0
        step = ~done & ~degenerate
        acc = torch.where(step, acc * factor, acc)
        dead = dead | (~done & degenerate)
        off = torch.stack([torch.where(bx, 0.5, 0.0),
                           torch.where(by, 0.5, 0.0)], -1)
        origin = origin + torch.where(step[:, None], scale[:, None] * off,
                                      0.0)
        scale = torch.where(step, scale * 0.5, scale)
        node = torch.where(step & ~leaf, child.long(), node)
        p = torch.where(step[:, None], p2, p)
        done = done | leaf | degenerate
    pdf = torch.where(dead, 0.0, acc * INV_FOURPI)
    pdf = torch.where(uniform, INV_FOURPI, pdf)
    u2 = u[:, MAX_Q_DEPTH:MAX_Q_DEPTH + 2]
    pfin = torch.clamp(origin + scale[:, None] * u2, 0.0, 1.0)
    pfin = torch.where(uniform[:, None], u2, pfin)
    if return_stats:
        nodes = torch.cat(seen).unique() if seen else node[:0]
        return pfin, pdf, dict(levels=levels, nodes=nodes)
    return pfin, pdf


def pdf_dir2(sdt: SDTreeArrays, d_world, root, uniform):
    """Sampling-tree pdf at world directions d_world (the NEE lanes): the
    point descent of sample_pdf_dir on every lane (DTree::pdf). CUDA
    tensors launch K4 in its point mode, which reads no uniforms."""
    if d_world.is_cuda:
        return D.pdf_point(sdt, dir_to_canonical(d_world), root, uniform)
    L = d_world.shape[0]
    u = torch.zeros((L, MAX_Q_DEPTH + 2), dtype=torch.float32,
                    device=d_world.device)
    is_point = torch.ones(L, dtype=torch.bool, device=d_world.device)
    return sample_pdf_canonical_plain(sdt, u, is_point,
                                      dir_to_canonical(d_world), root,
                                      uniform)[1]


def sampling_fraction(sdt: SDTreeArrays, dtree_id):
    """The learned bsdf sampling fraction of sampling_fraction_plain; CUDA
    tensors launch K3 on the ids."""
    if dtree_id.is_cuda:
        return D.meta(sdt, dtree_id)[2]
    return sampling_fraction_plain(sdt, dtree_id)


def sampling_fraction_plain(sdt: SDTreeArrays, dtree_id):
    """The learned bsdf sampling fraction logistic(opt_var)
    (guided_path.cpp:659-670); 0.5 where dtree_id < 0."""
    _plain_on(dtree_id)
    return _fraction(sdt, dtree_id)


def _fraction(sdt, dtree_id):
    var = _take(sdt.opt_var, dtree_id.clamp(min=0))
    return torch.where(dtree_id >= 0, torch.sigmoid(var), 0.5)


def _plain_train(t):
    """Counts a plain target walk or Adam chain run on CUDA tensors
    (train.COUNTS)."""
    if t.is_cuda:
        TR.COUNTS["train_plain_on_cuda"] += 1


def descend_cell(q_child, root, p, depth_limit=None, n_steps=MAX_Q_DEPTH):
    """(node, quadrant, depth) of descend_cell_plain. CUDA tensors launch
    K5a (guiding/train.py) once."""
    if p.is_cuda:
        return TR.descend(q_child, root, p, depth_limit, n_steps)
    return descend_cell_plain(q_child, root, p, depth_limit, n_steps)


def descend_cell_plain(q_child, root, p, depth_limit=None,
                       n_steps=MAX_Q_DEPTH, return_stats=False):
    """Walk canonical points p [L,2] down a quadtree pool from root [L]
    for at most n_steps levels. Returns (node, quadrant, depth) as i32;
    depth counts the levels walked (a root leaf gives 1, so the cell has
    side 0.5**depth). With depth_limit [L] the walk stops at that cell
    depth even where the node is internal (ppg_tpu's
    descend_cell_clamped); the cell is then an internal quadrant, whose
    residual the host pushes down by area at build. With return_stats,
    also a dict whose "nodes" are the distinct nodes read (a lane reads
    `depth` rows)."""
    _plain_train(p)
    L = p.shape[0]
    flat = q_child.reshape(-1)
    node = root.long()
    quad = torch.zeros(L, dtype=torch.int32, device=p.device)
    depth = torch.zeros(L, dtype=torch.int32, device=p.device)
    done = torch.zeros(L, dtype=torch.bool, device=p.device)
    seen = []
    for _ in range(n_steps):
        q, p2 = _quad_index(p)
        if return_stats:
            seen.append(node[~done])
        child = flat[node * 4 + q]
        stop = done | (child < 0)
        if depth_limit is not None:
            stop = stop | (depth + 1 >= depth_limit)
        node = torch.where(stop, node, child.long())
        quad = torch.where(done, quad, q)
        p = torch.where(done[:, None], p, p2)
        depth = torch.where(done, depth, depth + 1)
        done = stop
    out = node.to(torch.int32), quad, depth
    if return_stats:
        nodes = torch.cat(seen).unique() if seen else node[:0]
        return (*out, dict(nodes=nodes))
    return out


def dtree_box_targets4(q_child, root, pc, depth, n_steps=MAX_Q_DEPTH):
    """(cell [L,4], w [L,4]) of dtree_box_targets4_plain. CUDA tensors
    launch K5a once."""
    if pc.is_cuda:
        return TR.box_targets(q_child, root, pc, depth, n_steps)
    return dtree_box_targets4_plain(q_child, root, pc, depth, n_steps)


def dtree_box_targets4_plain(q_child, root, pc, depth, n_steps=MAX_Q_DEPTH,
                             return_stats=False):
    """Box directional splat targets (QuadTreeNode::record,
    guided_path.cpp:322-338, in ppg_tpu's bounded form): the 4 corners of
    the box of side 0.5**depth centred at pc descend the building tree,
    clamped at the box's own depth, so they reach every cell the box
    overlaps. Returns (cell [L,4] i32 flat quadrant indices, w [L,4] f32
    overlap fractions; a corner landing in an earlier corner's cell gets
    weight 0). With return_stats, also a dict: "levels" [L] i32, the rows
    the four corners read, and "nodes", the distinct nodes read."""
    L = pc.shape[0]
    s = 0.5 ** depth.to(torch.float32)
    b_lo = pc - s[:, None] * 0.5
    b_hi = pc + s[:, None] * 0.5
    corners = torch.stack(
        [b_lo, torch.stack([b_hi[:, 0], b_lo[:, 1]], -1),
         torch.stack([b_lo[:, 0], b_hi[:, 1]], -1), b_hi], 1)  # [L,4,2]
    cc = torch.clamp(corners, 0.0, 1.0 - 1e-6).reshape(L * 4, 2)
    node, quad, d, *st = descend_cell_plain(
        q_child, root.repeat_interleave(4), cc, depth.repeat_interleave(4),
        n_steps, return_stats)
    scale = torch.exp2(d.to(torch.float32))
    csz = 1.0 / scale
    o = torch.floor(cc * scale[:, None]) * csz[:, None]
    w2 = torch.clamp(torch.minimum(b_hi.repeat_interleave(4, 0),
                                   o + csz[:, None])
                     - torch.maximum(b_lo.repeat_interleave(4, 0), o),
                     min=0.0)
    s4 = s.repeat_interleave(4)
    w = ((w2[:, 0] * w2[:, 1]) / torch.clamp(s4 * s4, min=1e-38))
    cell = (node * 4 + quad).reshape(L, 4)
    w = w.reshape(L, 4)
    for j in range(1, 4):
        dup = (cell[:, :j] == cell[:, j:j + 1]).any(-1)
        w[:, j] = torch.where(dup, 0.0, w[:, j])
    if return_stats:
        return cell, w, dict(levels=d.reshape(L, 4).sum(1, dtype=torch.int32),
                             nodes=st[0]["nodes"])
    return cell, w


def dir_targets(sdt: SDTreeArrays, sp_id, pc, box):
    """A record's directional splat target in the building pool, at its
    canonical direction pc [L,2] in the dtree sp_id [L] i32: the leaf
    cell [L] i32 (node * 4 + quadrant), or with `box` the box filter's
    (cell4 [L,4] i32, w4 [L,4]). CPU tensors run dir_targets_plain; CUDA
    tensors launch K5a once (guiding/train.py)."""
    if pc.is_cuda:
        return TR.dir_targets(sdt, sp_id, pc, box)
    return dir_targets_plain(sdt, sp_id, pc, box)


def dir_targets_plain(sdt: SDTreeArrays, sp_id, pc, box, return_stats=False):
    """K5a's specification: the building tree's root of sp_id, the leaf
    descent at pc (descend_cell_plain) and with `box` the four clamped
    corner descents (dtree_box_targets4_plain). With return_stats, also a
    dict: "levels" [L] i32, the rows a lane's descents read, and "nodes",
    the distinct nodes read."""
    root = _take(sdt.db_root, sp_id)
    node, quad, depth, *st = descend_cell_plain(
        sdt.qb_child, root, pc, None, sdt.q_depth, return_stats)
    if box:
        out = dtree_box_targets4_plain(sdt.qb_child, root, pc, depth,
                                       sdt.q_depth, return_stats)
        if not return_stats:
            return out
        stats = dict(levels=depth + out[2]["levels"],
                     nodes=torch.cat([st[0]["nodes"],
                                      out[2]["nodes"]]).unique())
        return out[:2], stats
    cell = node * 4 + quad
    if return_stats:
        return cell, dict(levels=depth, nodes=st[0]["nodes"])
    return cell


S_STACK = 24  # spatial box-filter stack capacity per record
S_TARGETS = 16  # max spatial leaves one record splats into


def stree_box_targets(sdt: SDTreeArrays, p_world, voxel, mask=None):
    """(dtree id [L,S_TARGETS] i32, weight) of stree_box_targets_plain.
    CUDA tensors launch K5b once (guiding/train.py), with no host sync."""
    if p_world.is_cuda:
        return TR.stree_box(sdt, p_world, voxel, mask)
    return stree_box_targets_plain(sdt, p_world, voxel, mask)


def stree_box_targets_plain(sdt: SDTreeArrays, p_world, voxel, mask=None,
                            return_stats=False):
    """Spatial box filter targets (STreeNode::record, guided_path.cpp:
    823-839, 935-943): the box p +- voxel/2 is intersected with the
    spatial leaves by a depth-first walk (child 0 pushed before child 1,
    the top popped first) on a stack of S_STACK entries. Returns the
    first S_TARGETS leaves in that order as (dtree id [L,S_TARGETS] i32,
    -1 for unused slots; weight = overlap / box volume). Records outside
    the optional mask [L] bool walk nothing (all slots -1 and 0). With
    return_stats, also a dict: "pops" [L] i32, the nodes a record pops,
    and "nodes", the distinct nodes popped."""
    _plain_train(p_world)
    L = p_world.shape[0]
    dev = p_world.device
    x = (p_world - sdt.aabb_min) / sdt.aabb_size
    v = voxel / sdt.aabb_size
    b_lo = x - v / 2
    b_hi = x + v / 2
    vol = torch.clamp(v[:, 0] * v[:, 1] * v[:, 2], min=1e-38)

    def overlap(lo, sz):
        e = torch.clamp(torch.minimum(b_hi, lo + sz)
                        - torch.maximum(b_lo, lo), min=0.0)
        return e[:, 0] * e[:, 1] * e[:, 2]

    tgt_id = torch.full((L, S_TARGETS), -1, dtype=torch.int32, device=dev)
    tgt_w = torch.zeros((L, S_TARGETS), dtype=torch.float32, device=dev)
    n_tgt = torch.zeros(L, dtype=torch.long, device=dev)
    st_node = torch.zeros((L, S_STACK), dtype=torch.long, device=dev)
    st_lo = torch.zeros((L, S_STACK, 3), dtype=torch.float32, device=dev)
    st_sz = torch.ones((L, S_STACK, 3), dtype=torch.float32, device=dev)
    st_depth = torch.zeros((L, S_STACK), dtype=torch.long, device=dev)
    sp = torch.ones(L, dtype=torch.long, device=dev)
    if mask is not None:
        sp = torch.where(mask, sp, 0)
    pops = torch.zeros(L, dtype=torch.int32, device=dev)
    seen = []
    lanes = torch.arange(L, device=dev)
    axes = torch.arange(3, device=dev)
    while bool((sp > 0).any()):
        act = sp > 0
        top = torch.clamp(sp - 1, min=0)
        node = st_node[lanes, top]
        lo = st_lo[lanes, top]
        sz = st_sz[lanes, top]
        depth = st_depth[lanes, top]
        sp = torch.where(act, sp - 1, sp)
        if return_stats:
            pops += act
            seen.append(node[act])

        ov = overlap(lo, sz)
        dtree = sdt.s_dtree[node]
        leaf = dtree >= 0
        emit = act & leaf & (ov > 0) & (n_tgt < S_TARGETS)
        slot = torch.clamp(n_tgt, max=S_TARGETS - 1)
        tgt_id[lanes, slot] = torch.where(emit, dtree, tgt_id[lanes, slot])
        tgt_w[lanes, slot] = torch.where(emit, ov / vol, tgt_w[lanes, slot])
        n_tgt = n_tgt + emit

        on_axis = axes[None, :] == (depth % 3)[:, None]
        half = torch.where(on_axis, sz / 2, sz)
        for c in range(2):
            clo = lo + half if c else lo
            clo = torch.where(on_axis, clo, lo)
            push = act & ~leaf & (overlap(clo, half) > 0) & (sp < S_STACK)
            slot = torch.clamp(sp, max=S_STACK - 1)
            st_node[lanes, slot] = torch.where(
                push, sdt.s_child[node, c].long(), st_node[lanes, slot])
            st_lo[lanes, slot] = torch.where(push[:, None], clo,
                                             st_lo[lanes, slot])
            st_sz[lanes, slot] = torch.where(push[:, None], half,
                                             st_sz[lanes, slot])
            st_depth[lanes, slot] = torch.where(push, depth + 1,
                                                st_depth[lanes, slot])
            sp = sp + push
    if return_stats:
        nodes = torch.cat(seen).unique() if seen else sp[:0]
        return tgt_id, tgt_w, dict(pops=pops, nodes=nodes)
    return tgt_id, tgt_w


# Learned bsdfSamplingFraction (AdamOptimizer, guided_path.cpp:69-133,
# 655-697), as ppg_tpu computes it: the reference steps Adam once per two
# units of statistical weight with the gradient re-evaluated at the current
# variable. Per (leaf, c-bucket) sums of the records' gradient coefficients
# (c = dTreePdf / (bsdfPdf - dTreePdf), 31 log-spaced buckets per sign)
# re-evaluate the batch-mean gradient at any fraction, and ADAM_ROUNDS
# rounds advance each leaf by its share of floor(weight / 2) steps with
# the constant-gradient closed form. The weight remainder and its
# gradient carry to the next batch in opt_bgrad / opt_bweight.

ADAM_B = 62  # c-buckets: 31 log-spaced per sign of x
ADAM_ROUNDS = 64  # gradient re-evaluation rounds per splat batch
_ADAM_LO, _ADAM_SPAN = -3.0, 7.0  # log10(c + 1e-3) bucket range


def _adam_bucket_centers():
    i = torch.arange(31, dtype=torch.float64)
    pos = 10.0 ** (_ADAM_LO + (i + 0.5) * (_ADAM_SPAN / 31)) - 1e-3
    return torch.cat([pos, -(pos + 1.0)]).to(torch.float32)


_ADAM_CHAT = _adam_bucket_centers()  # [ADAM_B] bucket-centre c values


def _adam_bucket_index(c):
    """Bucket of c: 0..30 for c >= 0, 31..61 for c <= -1 (u = -c - 1
    shares the log mapping)."""
    neg = c < 0
    u = torch.where(neg, -c - 1.0, c)
    z = torch.log10(torch.clamp(u, min=0.0) + 1e-3)
    idx = torch.clamp(((z - _ADAM_LO) * (31 / _ADAM_SPAN)).to(torch.int32),
                      0, 30)
    return torch.where(neg, idx + 31, idx)


def _adam_chain(sdt, dtree_id, product, wo_pdf, bsdf_pdf, dtree_pdf,
                stat_w, valid_e, learn_fraction):
    """Consume one record batch (learn_fraction "kl" or "var"); returns
    the new (opt_var, opt_m1, opt_m2, opt_iter, opt_bgrad, opt_bweight)
    leaf arrays. All arithmetic is float32, as in ppg_tpu. The records'
    part (_adam_stats) is PyTorch; the rounds run _adam_rounds."""
    S0, S1, G0, W = _adam_stats(sdt, dtree_id, product, wo_pdf, bsdf_pdf,
                                dtree_pdf, stat_w, valid_e, learn_fraction)
    return _adam_rounds(sdt, S0, S1, G0, W, learn_fraction)


def _adam_stats(sdt, dtree_id, product, wo_pdf, bsdf_pdf, dtree_pdf,
                stat_w, valid_e, learn_fraction):
    """The records' part of _adam_chain: the per-(leaf, bucket) sums S0,
    S1 [T,ADAM_B] of the gradient coefficients, and per leaf the exact
    gradient sum G0 [T] at the batch-start variable and the weight W [T],
    both with the carried remainder added."""
    dev = product.device
    chat = _ADAM_CHAT.to(dev)
    is_kl = learn_fraction == "kl"
    rp = 1.0 if is_kl else 2.0
    T = sdt.opt_var.shape[0]
    dtree_id = dtree_id.long()

    var0 = sdt.opt_var[dtree_id]
    frac0 = torch.sigmoid(var0)
    x = bsdf_pdf - dtree_pdf
    mix0 = frac0 * bsdf_pdf + (1 - frac0) * dtree_pdf
    # exact per-record gradient at the batch-start variable
    ratio0 = (product / torch.clamp(mix0, min=1e-38)) ** rp
    dl_dv0 = (-ratio0 / torch.clamp(wo_pdf, min=1e-38) * x * frac0
              * (1 - frac0) + 0.01 * var0)
    opt_ok = valid_e & (product > 0) & torch.isfinite(dl_dv0)
    g0 = torch.where(opt_ok, dl_dv0 * stat_w, 0.0)
    w = torch.where(opt_ok, stat_w, 0.0)

    # bucket statistics for the gradient at a moved variable
    xs = torch.where(x.abs() > 1e-30, x, 1e-30)
    c = dtree_pdf / xs
    wo = torch.clamp(wo_pdf, min=1e-38)
    coeff = product / wo if is_kl else product * product / (wo * xs)
    stat_ok = opt_ok & (x.abs() > 1e-5 * (bsdf_pdf + dtree_pdf + 1e-30))
    b_idx = _adam_bucket_index(c)
    cell = dtree_id * ADAM_B + torch.where(stat_ok, b_idx, 0)
    cw = torch.where(stat_ok, coeff * stat_w, 0.0)
    zeros = lambda: torch.zeros(T * ADAM_B, dtype=torch.float32, device=dev)
    S0, S1 = bincount_add2((zeros(), zeros()), cell, cw,
                           cw * (c - chat[b_idx.clamp(0, ADAM_B - 1).long()]))
    G0, W = bincount_add2((sdt.opt_bgrad.clone(), sdt.opt_bweight.clone()),
                          dtree_id, g0, w)
    return S0.reshape(T, ADAM_B), S1.reshape(T, ADAM_B), G0, W


def _adam_rounds(sdt, S0, S1, G0, W, learn_fraction):
    """The ADAM_ROUNDS rounds of _adam_rounds_plain from the leaves' sums
    S0, S1 [T,ADAM_B], G0 and W [T]. CUDA tensors launch K6 once
    (guiding/train.py)."""
    if S0.is_cuda:
        return TR.adam_rounds(sdt, S0, S1, G0, W, learn_fraction == "kl")
    return _adam_rounds_plain(sdt, S0, S1, G0, W, learn_fraction)


def _bucket_sum(v):
    """v [T,ADAM_B] summed over the buckets in K6's order: zero-padded to
    64, then the upper half added to the lower six times (ATen's .sum
    picks its order per device)."""
    v = torch.cat([v, v.new_zeros((v.shape[0], 64 - ADAM_B))], 1)
    while v.shape[1] > 1:
        v = v[:, :v.shape[1] // 2] + v[:, v.shape[1] // 2:]
    return v[:, 0]


def _adam_rounds_plain(sdt, S0, S1, G0, W, learn_fraction):
    """K6's specification. Each of ADAM_ROUNDS rounds re-evaluates the
    leaf's mean gradient at its current variable from the bucket sums and
    advances Adam by the round's share of floor(W / 2) steps; the weight
    remainder (< 2) carries over with its gradient at the final variable.
    Returns the new (opt_var, opt_m1, opt_m2, opt_iter, opt_bgrad,
    opt_bweight)."""
    _plain_train(S0)
    chat = _ADAM_CHAT.to(S0.device)
    is_kl = learn_fraction == "kl"
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8
    W_safe = torch.clamp(W, min=1e-38)

    def data_grad(f):
        """Bucket-approximated mean dl/dvariable data term at fraction f
        [T] (first-order Taylor in c around each bucket centre)."""
        d = chat[None, :] + f[:, None]
        d = torch.where(d.abs() > 1e-4, d, torch.where(d < 0, -1e-4, 1e-4))
        if is_kl:
            p0 = 1.0 / d
            p1 = -p0 * p0
        else:
            p0 = 1.0 / (d * d)
            p1 = -2.0 * p0 / d
        s = -_bucket_sum(S0 * p0 + S1 * p1)
        return s * f * (1 - f) / W_safe

    d0 = data_grad(torch.sigmoid(sdt.opt_var))
    k = torch.floor(W * 0.5).to(torch.int32)  # reference steps to take
    q, r = k // ADAM_ROUNDS, k % ADAM_ROUNDS
    var, m1, m2, it = sdt.opt_var, sdt.opt_m1, sdt.opt_m2, sdt.opt_iter

    def grad_at(var):
        return (G0 / W_safe + (data_grad(torch.sigmoid(var)) - d0)
                + 0.01 * (var - sdt.opt_var))

    for t in range(ADAM_ROUNDS):
        s = (q + (t < r).to(torch.int32)).to(torch.float32)
        g = grad_at(var)
        a1 = b1 ** s
        a2 = b2 ** s
        m1n = a1 * m1 + (1 - a1) * g
        m2n = a2 * m2 + (1 - a2) * g * g
        # sum of m1 over the s steps (exact for a constant gradient); a
        # product by 1 / (1 - b1), which a card's ATen makes of a quotient
        # by a Python float and the CPU's does not
        geo = b1 * (1 - a1) * (1 / (1 - b1))
        summ1 = m1 * geo + g * (s - geo)
        it_mid = it.to(torch.float32) + (s + 1) * 0.5
        alr = lr * torch.sqrt(1 - b2 ** it_mid) / (1 - b1 ** it_mid)
        varn = torch.clamp(
            var - alr * summ1 / (torch.sqrt(torch.clamp(m2n, min=0.0)) + eps),
            -20.0, 20.0)
        do = s > 0
        var = torch.where(do, varn, var)
        m1 = torch.where(do, m1n, m1)
        m2 = torch.where(do, m2n, m2)
        it = it + s.to(torch.int32)

    rem_w = W - 2.0 * k.to(torch.float32)
    any_w = W > 0
    rem_g = torch.where(any_w, grad_at(var) * rem_w, 0.0)
    return var, m1, m2, it, rem_g, torch.where(any_w, rem_w, 0.0)


def splat_targets(sdt: SDTreeArrays, dtree_id, d_rec, valid,
                  spatial_filter="nearest", directional_filter="nearest",
                  p_rec=None, voxel=None, u_jitter=None):
    """A record's splat targets, resolved when the tracer shades
    (splat_records' fast path). The spatial leaf is the dtree at the
    record (nearest) or at p_rec jittered by (u_jitter - 0.5) * voxel and
    clipped to the tree's cube (stochastic, Vertex::commit
    guided_path.cpp:1746-1762). The directional target is the building
    tree's leaf quadrant at d_rec (nearest) or the box's cells and
    weights (box). Returns dict(sp_id [L] i32, and cell [L] i32 or
    cell4 / w4 [L,4])."""
    if spatial_filter == "stochastic":
        pj = torch.clamp(p_rec + (u_jitter - 0.5) * voxel, min=sdt.aabb_min,
                         max=sdt.aabb_min + sdt.aabb_size)
        dtree_id = lookup(sdt, pj)[0]
    sp_id = torch.where(valid, dtree_id, 0).clamp(min=0)
    pc = dir_to_canonical(d_rec)
    if directional_filter == "box":
        cell4, w4 = dir_targets(sdt, sp_id, pc, True)
        return dict(sp_id=sp_id, cell4=cell4, w4=w4)
    return dict(sp_id=sp_id, cell=dir_targets(sdt, sp_id, pc, False))


_OPT_FIELDS = ("opt_var", "opt_m1", "opt_m2", "opt_iter", "opt_bgrad",
               "opt_bweight")


def splat_records(sdt: SDTreeArrays, rec, spatial_filter="nearest",
                  directional_filter="nearest", learn_fraction=None,
                  u_jitter=None):
    """Accumulate a flat batch of DTreeRecords into the building pool, in
    place (DTreeWrapper::record, guided_path.cpp:587-600), and with
    learn_fraction ("kl" / "var") step the leaves' Adam state.

    rec: dict of flat tensors radiance, product, wo_pdf, bsdf_pdf,
    dtree_pdf, stat_weight, is_delta, valid [N], and either the
    shade-time targets sp_id with cell or cell4 / w4 (fast path, for the
    nearest and stochastic spatial filters) or p, d, voxel [N,3] (lookup
    path: the walks run here; the stochastic filter then jitters the
    position by u_jitter [N,3]). The box spatial filter splats each
    record into every spatial leaf its voxel-sized box overlaps, weighted
    by the overlap (stree_box_targets)."""
    valid = rec["valid"]
    stat_w = torch.where(valid, rec["stat_weight"], 0.0)
    irradiance = rec["radiance"] / torch.clamp(rec["wo_pdf"], min=1e-38)
    fields = {k: rec[k] for k in ("bsdf_pdf", "dtree_pdf", "wo_pdf",
                                  "product", "is_delta")}
    fast = "sp_id" in rec and spatial_filter != "box"
    d = rec.get("d")
    if spatial_filter == "box":
        ids, factor = stree_box_targets(sdt, rec["p"], rec["voxel"], valid)
        ids, factor = ids.reshape(-1), factor.reshape(-1)
        # only the (record, leaf) pairs that carry weight; the others add
        # zeros in ppg_tpu, so dropping them changes only summation order
        keep = (valid.repeat_interleave(S_TARGETS) & (ids >= 0)
                & (factor > 0)).nonzero()[:, 0]
        src = keep // S_TARGETS
        dtree_id = ids[keep]
        valid_e = torch.ones_like(keep, dtype=torch.bool)
        stat_w = stat_w[src] * factor[keep]
        irradiance = irradiance[src]
        d = d[src]
        fields = {k: v[src] for k, v in fields.items()}
    elif fast:
        dtree_id = torch.where(valid, rec["sp_id"], 0)
        valid_e = valid
    else:
        p = rec["p"]
        if spatial_filter == "stochastic":
            p = torch.clamp(p + (u_jitter - 0.5) * rec["voxel"],
                            min=sdt.aabb_min, max=sdt.aabb_min + sdt.aabb_size)
        dtree_id = torch.where(valid, lookup(sdt, p)[0], 0)
        valid_e = valid

    rec_ok = (valid_e & ~fields["is_delta"] & torch.isfinite(stat_w)
              & (stat_w > 0))
    irr_ok = rec_ok & torch.isfinite(irradiance) & (irradiance > 0)
    # statistical weight accumulates for every non-delta record (:395-397)
    bincount_add(sdt.db_statw, dtree_id, torch.where(rec_ok, stat_w, 0.0))
    amount = torch.where(irr_ok, irradiance * stat_w, 0.0)
    qb = sdt.qb_sum.view(-1)
    if fast and directional_filter == "box":
        bincount_add(qb, rec["cell4"].reshape(-1),
                     (amount[:, None] * rec["w4"]).reshape(-1))
    elif fast:
        bincount_add(qb, rec["cell"], amount)
    else:
        pc = dir_to_canonical(d)
        if directional_filter == "box":
            cell4, w4 = dir_targets(sdt, dtree_id, pc, True)
            bincount_add(qb, cell4.reshape(-1),
                         (amount[:, None] * w4).reshape(-1))
        else:
            bincount_add(qb, dir_targets(sdt, dtree_id, pc, False), amount)

    if learn_fraction is not None:
        new = _adam_chain(sdt, dtree_id, fields["product"], fields["wo_pdf"],
                          fields["bsdf_pdf"], fields["dtree_pdf"], stat_w,
                          valid_e, learn_fraction)
        for f, v in zip(_OPT_FIELDS, new):
            setattr(sdt, f, v)
    return sdt

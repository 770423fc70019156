"""Device-side SD-tree: a spatial binary tree over directional quadtrees
(counterpart of ppg_tpu/guiding/sdtree.py).

Both trees are flat pools of tensors; the host (guiding/host.py) changes
their topology between iterations and the passes only read the sampling
pool and accumulate into the building pool:

  spatial  : s_child [S,2] (-1 for leaves), s_dtree [S] (leaf -> dtree)
  quadtrees: per pool q_sum [Q,4] f32 + q_child [Q,4] i32 (-1 = leaf
             quadrant), one root per dtree (ds_root / db_root)

The walks take one level per step over these plain tables, with the
semantics of ppg_tpu's one-level reference walks (lookup_ref,
sample_pdf_dir_ref). ppg_tpu's multi-level packed tables exist only to
cut TPU gather counts and are not carried over. Splats add into the
building pool in place.
"""

from __future__ import annotations

import torch

from ..core.warp import INV_FOURPI, canonical_to_dir, dir_to_canonical
from ..ops.reduce import bincount_add

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


def lookup(sdt: SDTreeArrays, p_world):
    """Spatial descent (STree::dTreeWrapper, guided_path.cpp:897-905):
    the split axis cycles x, y, z with depth. Returns (dtree id [L] i32,
    voxel size [L,3] in world units)."""
    x = list(torch.clamp((p_world - sdt.aabb_min) / sdt.aabb_size,
                         0.0, 1.0).unbind(-1))
    L = x[0].shape[0]
    size = [torch.full((L,), 1.0, dtype=torch.float32, device=x[0].device)
            * sdt.aabb_size for _ in range(3)]
    node = torch.zeros(L, dtype=torch.int64, device=x[0].device)
    for level in range(sdt.s_depth):
        a = level % 3
        internal = sdt.s_dtree[node] < 0
        hi = x[a] >= 0.5
        child = torch.where(hi, sdt.s_child[node, 1], sdt.s_child[node, 0])
        x[a] = torch.where(internal, torch.where(hi, (x[a] - 0.5) * 2.0,
                                                 x[a] * 2.0), x[a])
        size[a] = torch.where(internal, size[a] * 0.5, size[a])
        node = torch.where(internal, child.long(), node)
    return sdt.s_dtree[node], torch.stack(size, -1)


def dtree_meta(sdt: SDTreeArrays, dtree_id):
    """Per-dtree scalars of a guided bounce: (root node [L] i32, uniform
    [L] bool -- the DTree's mean <= 0 or statWeight <= 0 falls back to the
    uniform sphere, guided_path.cpp:415-421/431-442 --, and the learned
    bsdf sampling fraction [L], logistic(opt_var))."""
    i = dtree_id.clamp(min=0)
    root = _take(sdt.ds_root, i)
    statw = _take(sdt.ds_statw, i)
    mean = _take(sdt.ds_sum, i) * INV_FOURPI / torch.clamp(statw, min=1e-38)
    uniform = ~(mean > 0) | (statw <= 0) | (dtree_id < 0)
    frac = torch.where(dtree_id >= 0, torch.sigmoid(_take(sdt.opt_var, i)),
                       0.5)
    return root, uniform, frac


def sample_pdf_dir(sdt: SDTreeArrays, u, is_point, p_point, root, uniform):
    """One walk over the sampling quadtree serving both halves of the
    one-sample MIS mixture (guided_path.cpp:1647-1692): lanes with
    ~is_point draw a direction by the conditional-CDF walk of DTree::sample
    (:257-301), one uniform of u [L, MAX_Q_DEPTH+2] per level plus two for
    the leaf cell; is_point lanes descend at p_point (canonical) as
    DTree::pdf does (:232-245). Returns (direction [L,3] -- meaningful for
    the sampling lanes --, pdf [L] of each lane's chosen direction).
    root / uniform come from dtree_meta."""
    L = u.shape[0]
    dev = u.device
    node = root.long()
    p = p_point
    origin = torch.zeros((L, 2), dtype=torch.float32, device=dev)
    scale = torch.ones(L, dtype=torch.float32, device=dev)
    acc = torch.ones(L, dtype=torch.float32, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    dead = torch.zeros(L, dtype=torch.bool, device=dev)
    for level in range(sdt.q_depth):
        sm = u[:, level]
        sums = sdt.qs_sum[node]
        kids = sdt.qs_child[node]
        total = sums.sum(-1)
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
    return canonical_to_dir(pfin), pdf


def descend_to_leaf(q_child, root, p, n_steps):
    """Walk canonical points p [L,2] down a quadtree pool from root [L]
    for at most n_steps levels. Returns (leaf node, quadrant) as i32."""
    L = p.shape[0]
    node = root.long()
    quad = torch.zeros(L, dtype=torch.int32, device=p.device)
    done = torch.zeros(L, dtype=torch.bool, device=p.device)
    for _ in range(n_steps):
        q, p2 = _quad_index(p)
        child = _sel4(q_child[node], p[:, 0] >= 0.5, p[:, 1] >= 0.5)
        leaf = child < 0
        node = torch.where(done | leaf, node, child.long())
        quad = torch.where(done, quad, q)
        p = torch.where(done[:, None], p, p2)
        done = done | leaf
    return node.to(torch.int32), quad


def splat_targets(sdt: SDTreeArrays, dtree_id, d_rec, valid):
    """Splat targets for the nearest/nearest filters: the record's spatial
    leaf is the dtree at its position, and its directional cell is the
    building-tree leaf quadrant at d_rec. The tracer calls this at shade
    time (splat_records' fast path). Returns (sp_id [L] i32, cell [L] i32
    flat quadrant index)."""
    sp_id = torch.where(valid, dtree_id, 0).clamp(min=0)
    node, quad = descend_to_leaf(sdt.qb_child, _take(sdt.db_root, sp_id),
                                 dir_to_canonical(d_rec), sdt.q_depth)
    return sp_id, node * 4 + quad


def splat_records(sdt: SDTreeArrays, rec, spatial_filter="nearest",
                  directional_filter="nearest"):
    """Accumulate a flat batch of DTreeRecords into the building pool, in
    place (DTreeWrapper::record, guided_path.cpp:587-600).

    rec: dict of flat tensors: radiance, product, wo_pdf, bsdf_pdf,
    dtree_pdf, stat_weight, is_delta, valid [N]; and either the shade-time
    targets sp_id / cell [N] (fast path) or p / d [N,3] (lookup path:
    the spatial leaf and the directional cell are walked here)."""
    if spatial_filter != "nearest" or directional_filter != "nearest":
        raise NotImplementedError(
            f"spatialFilter={spatial_filter!r} / directionalFilter="
            f"{directional_filter!r}: only nearest/nearest is ported "
            "(ROADMAP Queue 1, the box and stochastic filters)")
    valid = rec["valid"]
    stat_w = torch.where(valid, rec["stat_weight"], 0.0)
    irradiance = rec["radiance"] / torch.clamp(rec["wo_pdf"], min=1e-38)
    if "sp_id" in rec:
        dtree_id = torch.where(valid, rec["sp_id"], 0)
        cell = rec["cell"]
    else:
        dtree_id, cell = splat_targets(sdt, lookup(sdt, rec["p"])[0],
                                       rec["d"], valid)
    rec_ok = valid & ~rec["is_delta"] & torch.isfinite(stat_w) & (stat_w > 0)
    irr_ok = rec_ok & torch.isfinite(irradiance) & (irradiance > 0)
    # statistical weight accumulates for every non-delta record (:395-397)
    bincount_add(sdt.db_statw, dtree_id, torch.where(rec_ok, stat_w, 0.0))
    amount = torch.where(irr_ok, irradiance * stat_w, 0.0)
    bincount_add(sdt.qb_sum.view(-1), cell, amount)
    return sdt

"""The SD-tree descents on a card: the hand-written CUDA kernels
(csrc/sdtree.cu: K3, the spatial lookup with the dtree's root, uniform
flag and learned fraction; K4, the quadtree sample-and-pdf walk) and
their wrappers.

The kernels replace ppg_tpu's XLA walks, ppg_tpu/guiding/sdtree.py::
lookup, dtree_meta and sampling_fraction (K3) and sample_pdf_dir and
pdf_dir2 (K4). guiding/sdtree.py's public functions of the same names
dispatch here for CUDA tensors; for CPU tensors they run the plain
versions (lookup_plain, lookup_meta_plain, dtree_meta_plain,
sampling_fraction_plain, sample_pdf_canonical_plain), which are the
kernels' specification: the kernels equal them bit for bit (see the note
in csrc/sdtree.cu). The library is built from csrc/sdtree.cu with nvcc at
first use, into build/ppg_tpu_torch/ at the root of the checkout
(native.load_cuda). A failed build or launch raises.

The kernels read the trees as rows that SDTreeArrays builds on the
tables' device when the tree is made, each with a stamp of the tables it
was built from (the tables themselves and their in-place version
counters): a wrapper refuses a tree whose row is missing, or stale
because a table was replaced or changed in place since (rebuild it with
the same function). The stamps stand for the tables' checks: a tree's
tables are validated once, where its rows are built, and a call checks
only its own tensors, the stamps and the rows' card.
- K3: s_oct [S,16] int32, eight 8-byte entries a node, one per octant
  of the next three levels' halves: the node three levels down (or the
  leaf where the walk stopped) times 4 plus the levels taken, and its
  dtree id (one load per three levels); s_row [S,4] int32, a spatial
  node's two children and their dtree ids (one 16-byte load a level,
  for the levels left when fewer than three remain before s_depth);
  spatial_rows builds both from s_child and s_dtree and validates
  aabb_min and aabb_size beside them. ds_row [T,4] int32, a dtree's
  ds_root and the bits of ds_sum and ds_statw (meta_rows). opt_var stays
  out of the rows: the Adam batches replace it while the tree is
  sampled, so the wrapper checks it on every call.
- K4: qs_row [Q,8] int32, a quadtree node's four sums' bits, then its
  four children (quad_rows). K4 takes the uniforms u [L,22] as the
  transpose of a contiguous [22, L] (the tracer draws them so on a
  card), so that a warp's uniforms of one level are one 128-byte line.

COUNTS holds plain integers: "sd_lookup" counts K3 launches,
"sd_sample_pdf" K4 launches, and "sd_plain_on_cuda" plain walks run on
CUDA tensors (`reset_counts` zeroes them).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..native import CSRC, load_cuda, raw_stream

COUNTS = {"sd_lookup": 0, "sd_sample_pdf": 0, "sd_plain_on_cuda": 0}

U_COLS = 22  # uniforms per lane: sdtree.MAX_Q_DEPTH levels + 2 leaf
MAX_Q_DEPTH = U_COLS - 2
INDEX_MAX = (2 ** 31 - 1) // 4  # pool rows the kernels' int32 index takes

_SRC = os.path.join(CSRC, "sdtree.cu")
# --fmad=false: the plain version rounds every product and sum on its
# own, and a contracted rescale or quotient would pick another quadrant.
# No --use_fast_math, no -ftz=true: the 1e-38 clamps are subnormal.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# p, aabb_min, aabb_size, s_row, s_oct, s_dtree, s_depth, mask, ids,
# ds_row, opt_var, L, out id, voxel, root, uniform, frac, card, stream
LOOKUP_ARGTYPES = [_vp, _vp, _vp, _vp, _vp, _vp, _ci, _vp, _vp, _vp, _vp,
                   _ci, _vp, _vp, _vp, _vp, _vp, _ci, _vp]
_cll = ctypes.c_longlong
# qs_row, Q, q_depth, u, u's level and lane strides, is_point, p, root,
# uniform, L, out p, out pdf, card, stream
WALK_ARGTYPES = [_vp, _ci, _ci, _vp, _cll, _cll, _vp, _vp, _vp, _vp, _ci,
                 _vp, _vp, _ci, _vp]
OCTANTS = 8  # s_oct's entries a node: the halves of three levels
_lib = None


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def build():
    """Compile csrc/sdtree.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(_SRC, "libppgsdtree", NVCC_FLAGS,
                     {"ppg_sd_lookup": LOOKUP_ARGTYPES,
                      "ppg_sd_sample_pdf": WALK_ARGTYPES})
    return _lib


def _check(what, idx, *specs):
    """Raises unless each (name, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on card idx."""
    bad = [f"{name} {t.dtype} {tuple(t.shape)} on {t.device}"
           + ("" if t.is_contiguous() else " not contiguous")
           for name, t, dtype, shape in specs
           if not (t.dtype == dtype and tuple(t.shape) == tuple(shape)
                   and t.is_contiguous() and t.is_cuda
                   and t.get_device() == idx)]
    if bad:
        raise ValueError(f"{what}: want " + ", ".join(
            f"{name} {dtype} {tuple(shape)}" for name, _, dtype, shape in
            specs) + f", contiguous on cuda:{idx}; got " + "; ".join(bad))


def _stamp(*tables):
    """What a row was built from: the tables themselves and their in-place
    version counters."""
    return tuple((t, t._version) for t in tables)


def _current(stamp, *tables):
    """Whether `stamp` is that of these tables as they are now."""
    return stamp is not None and len(stamp) == len(tables) and all(
        t is s and t._version == v for t, (s, v) in zip(tables, stamp))


def quad_rows(qs_sum, qs_child):
    """(qs_row, stamp): qs_row [Q,8] int32, each node's four sums
    (qs_sum [Q,4] float32, as their bits) then its four children
    (qs_child [Q,4] int32), one contiguous 32-byte row a node (one
    torch.cat on the tables' device); stamp records what it was built
    from. (None, None) for tables of other types or shapes, which K4
    does not take."""
    if not (qs_sum.dtype == torch.float32 and qs_child.dtype == torch.int32
            and qs_sum.dim() == qs_child.dim() == 2
            and qs_sum.shape == qs_child.shape and qs_sum.shape[1] == 4
            and qs_sum.device == qs_child.device):
        return None, None
    row = torch.cat([qs_sum.view(torch.int32), qs_child], 1).contiguous()
    return row, _stamp(qs_sum, qs_child)


def spatial_rows(s_child, s_dtree, aabb_min, aabb_size):
    """(s_row, s_oct, stamp) of K3's descent, on the tables' device:
    s_row [S,4] int32, each node's children (s_child [S,2] int32) and
    their dtree ids (s_dtree [S] int32; -1 for a leaf's missing
    children, whose row no walk reads); s_oct [S,16] int32, each node's
    eight entries (node * 4 + levels taken, dtree id), the walk of up to
    three levels from it whose halves are the octant's bits (bit k the
    k-th level's), stopping at a leaf as lookup_plain does (entries of a
    leaf, which no walk reads, take 0 levels); stamp records the tables
    and aabb_min [3] and aabb_size (one value), both float32 on that
    device, which the kernel also reads. (None, None, None) for tables of
    other types or shapes, which K3 does not take."""
    f32, i32 = torch.float32, torch.int32
    dev = s_child.device
    if not (s_child.dtype == i32 and s_dtree.dtype == i32
            and s_child.dim() == 2 and s_child.shape[1] == 2
            and s_dtree.shape == s_child.shape[:1]
            and aabb_min.dtype == aabb_size.dtype == f32
            and aabb_min.shape == (3,) and aabb_size.numel() == 1
            and aabb_min.is_contiguous()
            and s_dtree.device == aabb_min.device == aabb_size.device
            == dev):
        return None, None, None
    child = s_child.long()
    dt = s_dtree.long()
    # a child's dtree id (the leaves' -1 children read nothing)
    child_dt = torch.where(child >= 0, dt[child.clamp(min=0)], -1)
    s_row = torch.cat([child, child_dt], 1).to(i32)
    S = s_child.shape[0]
    node = torch.arange(S, device=dev)[:, None].expand(S, OCTANTS)
    at = dt[node]
    taken = torch.zeros_like(node)
    octant = torch.arange(OCTANTS, device=dev)
    for k in range(3):
        half = (octant >> k) & 1
        walks = at < 0  # an internal node: the walk takes this level
        at = torch.where(walks, child_dt[node, half], at)
        node = torch.where(walks, child[node, half], node)
        taken = taken + walks
    s_oct = torch.stack([node * 4 + taken, at], -1).to(i32).reshape(S, -1)
    return s_row, s_oct, _stamp(s_child, s_dtree, aabb_min, aabb_size)


def meta_rows(ds_root, ds_sum, ds_statw):
    """(ds_row, stamp): ds_row [T,4] int32, each dtree's ds_root [T]
    int32 and the bits of ds_sum and ds_statw [T] float32, then 0, one
    16-byte row a dtree; stamp records the tables. (None, None) for
    tables of other types or shapes."""
    i32 = torch.int32
    if not (ds_root.dtype == i32 and ds_sum.dtype == ds_statw.dtype
            == torch.float32 and ds_root.dim() == 1
            and ds_sum.shape == ds_statw.shape == ds_root.shape
            and ds_sum.device == ds_statw.device == ds_root.device):
        return None, None
    row = torch.stack([ds_root, ds_sum.view(i32), ds_statw.view(i32),
                       torch.zeros_like(ds_root)], 1)
    return row, _stamp(ds_root, ds_sum, ds_statw)


def _check_row(sdt, what, row, tables, builder):
    """Raises unless sdt's `row` is current (its stamp, sdt.<row>_stamp,
    that of the tables as they are) and starts on its own row size."""
    r = getattr(sdt, row, None)
    if r is None:
        raise ValueError(f"{what}: the tree has no {row} ({builder} builds "
                         f"it from {', '.join(tables)})")
    if not _current(getattr(sdt, row + "_stamp", None),
                    *(getattr(sdt, n) for n in tables)):
        raise ValueError(f"{what}: {row} is stale: {' or '.join(tables)} "
                         f"changed since it was built ({builder})")
    if r.data_ptr() % (r.element_size() * r.shape[1]):
        raise ValueError(f"{what}: {row} must start on "
                         f"{r.element_size() * r.shape[1]} bytes")


def _on_card(what, idx, *rows):
    """Raises unless each (name, row) lies on card idx."""
    for name, r in rows:
        if not (r.is_cuda and r.get_device() == idx):
            raise ValueError(f"{what}: want {name} on cuda:{idx}; got "
                             f"{r.device}")


def _check_u(u, idx, L):
    """Raises unless u is the [L,22] float32 transpose of a contiguous
    [22, L] (strides (1, L)) on card idx."""
    if not (u.dtype == torch.float32 and tuple(u.shape) == (L, U_COLS)
            and u.stride(1) == L and (L == 1 or u.stride(0) == 1)):
        raise ValueError(
            f"ppg_sd_sample_pdf: want u float32 ({L}, {U_COLS}) with "
            f"strides (1, {L}), the transpose of a contiguous ({U_COLS}, "
            f"{L}) (level-major: a warp's uniforms of one level on one "
            f"line); got {u.dtype} {tuple(u.shape)} strides {u.stride()}")
    if not (u.is_cuda and u.get_device() == idx):
        raise ValueError(f"ppg_sd_sample_pdf: want u on cuda:{idx}; got "
                         f"{u.device}")


def _check_pool(what, n):
    if not 1 <= n <= INDEX_MAX:
        raise ValueError(f"{what}: {n} rows; the kernels index 1.."
                         f"{INDEX_MAX}")


def _ptr(t):
    return None if t is None else t.data_ptr()


SPATIAL = ("s_child", "s_dtree", "aabb_min", "aabb_size")
META = ("ds_root", "ds_sum", "ds_statw")


def _lookup_launch(sdt, idx, L, p=None, mask=None, ids=None, meta=True):
    """K3 on card idx; returns (id, voxel, root, uniform, frac), None for
    what the mode does not write."""
    f32, i32, b = torch.float32, torch.int32, torch.bool
    what = "ppg_sd_lookup"
    specs, rows, T = [], [], sdt.ds_root.shape[0]
    if p is not None:
        _check_pool("the spatial tree", sdt.s_dtree.shape[0])
        _check_row(sdt, what, "s_row", SPATIAL, "spatial_rows")
        specs.append(("p", p, f32, (L, 3)))
        rows += [("s_row", sdt.s_row), ("s_oct", sdt.s_oct)]
    if mask is not None:
        specs.append(("mask", mask, b, (L,)))
    if ids is not None:
        specs.append(("ids", ids, i32, (L,)))
    if meta:
        _check_pool("the dtrees", T)
        _check_row(sdt, what, "ds_row", META, "meta_rows")
        specs.append(("opt_var", sdt.opt_var, f32, (T,)))
        rows.append(("ds_row", sdt.ds_row))
    _check(what, idx, *specs)
    _on_card(what, idx, *rows)
    dev = (p if p is not None else ids).device
    out_id = out_voxel = root = uniform = frac = None
    if p is not None:
        out_id = torch.empty(L, dtype=i32, device=dev)
        out_voxel = torch.empty((L, 3), dtype=f32, device=dev)
    if meta:
        root = torch.empty(L, dtype=i32, device=dev)
        uniform = torch.empty(L, dtype=b, device=dev)
        frac = torch.empty(L, dtype=f32, device=dev)
    lib = _lib or build()
    spatial = p is not None
    err = lib.ppg_sd_lookup(
        _ptr(p), sdt.aabb_min.data_ptr(), sdt.aabb_size.data_ptr(),
        _ptr(sdt.s_row if spatial else None),
        _ptr(sdt.s_oct if spatial else None),
        sdt.s_dtree.data_ptr(), sdt.s_depth, _ptr(mask), _ptr(ids),
        _ptr(sdt.ds_row if meta else None), sdt.opt_var.data_ptr(), L,
        _ptr(out_id), _ptr(out_voxel), _ptr(root), _ptr(uniform),
        _ptr(frac), idx, raw_stream(idx))
    if err != 0:
        raise RuntimeError(f"ppg_sd_lookup launch failed: cudaError {err}")
    COUNTS["sd_lookup"] += 1
    return out_id, out_voxel, root, uniform, frac


def lookup(sdt, p_world, mask=None, meta=False):
    """K3 on the positions p_world [L,3] (float32, contiguous, on a card):
    (dtree id [L] i32, voxel [L,3]) of sdtree.lookup_plain, or with `meta`
    the five results of sdtree.lookup_meta_plain (the id -1 where mask
    [L] bool is False). Adds one to COUNTS["sd_lookup"]."""
    out = _lookup_launch(sdt, p_world.get_device(), p_world.shape[0],
                         p=p_world, mask=mask, meta=meta)
    return out if meta else out[:2]


def meta(sdt, dtree_id):
    """K3 on given ids [L] i32 (no descent): (root, uniform, frac) of
    sdtree.dtree_meta_plain. Adds one to COUNTS["sd_lookup"]."""
    return _lookup_launch(sdt, dtree_id.get_device(), dtree_id.shape[0],
                          ids=dtree_id)[2:]


def _walk(sdt, p_point, root, uniform, u=None, is_point=None):
    f32, i32, b = torch.float32, torch.int32, torch.bool
    L, idx = p_point.shape[0], p_point.get_device()
    Q = sdt.qs_sum.shape[0]
    _check_pool("the sampling quadtrees", Q)
    if not 0 <= sdt.q_depth <= MAX_Q_DEPTH:
        raise ValueError(f"q_depth {sdt.q_depth}: the kernel walks at most "
                         f"{MAX_Q_DEPTH} levels")
    _check_row(sdt, "ppg_sd_sample_pdf", "qs_row", ("qs_sum", "qs_child"),
               "quad_rows")
    if u is not None:
        _check_u(u, idx, L)
    specs = [("qs_row", sdt.qs_row, i32, (Q, 8)),
             ("p_point", p_point, f32, (L, 2)), ("root", root, i32, (L,)),
             ("uniform", uniform, b, (L,))]
    if u is not None:
        specs.append(("is_point", is_point, b, (L,)))
    _check("ppg_sd_sample_pdf", idx, *specs)
    pdf = torch.empty(L, dtype=f32, device=p_point.device)
    pfin = (torch.empty((L, 2), dtype=f32, device=p_point.device)
            if u is not None else None)
    lib = _lib or build()
    err = lib.ppg_sd_sample_pdf(
        sdt.qs_row.data_ptr(), Q, sdt.q_depth, _ptr(u), L, 1,
        _ptr(is_point), p_point.data_ptr(), root.data_ptr(),
        uniform.data_ptr(), L, _ptr(pfin), pdf.data_ptr(), idx,
        raw_stream(idx))
    if err != 0:
        raise RuntimeError(
            f"ppg_sd_sample_pdf launch failed: cudaError {err}")
    COUNTS["sd_sample_pdf"] += 1
    return pfin, pdf


def sample_pdf(sdt, u, is_point, p_point, root, uniform):
    """K4: (canonical point [L,2], pdf [L]) of
    sdtree.sample_pdf_canonical_plain; u [L,22] the transpose of a
    contiguous [22, L], is_point [L] bool, p_point [L,2], root [L] i32,
    uniform [L] bool, contiguous on one card; sdt.qs_row current.
    Adds one to COUNTS["sd_sample_pdf"]."""
    return _walk(sdt, p_point, root, uniform, u=u, is_point=is_point)


def pdf_point(sdt, p_point, root, uniform):
    """K4 in point mode: the pdf [L] at the canonical points p_point
    [L,2] (sdtree.pdf_dir2's walk), reading no uniforms. Adds one to
    COUNTS["sd_sample_pdf"]."""
    return _walk(sdt, p_point, root, uniform)[1]

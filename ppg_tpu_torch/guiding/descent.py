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
# p, aabb_min, aabb_size, s_child, s_dtree, s_depth, mask, ids, ds_root,
# ds_sum, ds_statw, opt_var, L, out id, voxel, root, uniform, frac, card,
# stream
LOOKUP_ARGTYPES = [_vp, _vp, _vp, _vp, _vp, _ci, _vp, _vp, _vp, _vp, _vp,
                   _vp, _ci, _vp, _vp, _vp, _vp, _vp, _ci, _vp]
# qs_sum, qs_child, Q, q_depth, u, is_point, p, root, uniform, L, out p,
# out pdf, card, stream
WALK_ARGTYPES = [_vp, _vp, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _ci, _vp, _vp,
                 _ci, _vp]
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


def _check_pool(what, n):
    if not 1 <= n <= INDEX_MAX:
        raise ValueError(f"{what}: {n} rows; the kernels index 1.."
                         f"{INDEX_MAX}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _lookup_launch(sdt, idx, L, p=None, mask=None, ids=None, meta=True):
    f32, i32, b = torch.float32, torch.int32, torch.bool
    S, T = sdt.s_dtree.shape[0], sdt.ds_root.shape[0]
    _check_pool("the spatial tree", S)
    _check_pool("the dtrees", T)
    specs = [("s_child", sdt.s_child, i32, (S, 2)),
             ("s_dtree", sdt.s_dtree, i32, (S,))]
    if meta:
        specs += [(n, getattr(sdt, n), dt, (T,)) for n, dt in
                  (("ds_root", i32), ("ds_sum", f32), ("ds_statw", f32),
                   ("opt_var", f32))]
    if p is not None:
        specs += [("p", p, f32, (L, 3)),
                  ("aabb_min", sdt.aabb_min, f32, (3,)),
                  ("aabb_size", sdt.aabb_size.reshape(-1), f32, (1,))]
    if mask is not None:
        specs.append(("mask", mask, b, (L,)))
    if ids is not None:
        specs.append(("ids", ids, i32, (L,)))
    _check("ppg_sd_lookup", idx, *specs)
    dev = (p if p is not None else ids).device
    out_id = out_voxel = None
    if p is not None:
        out_id = torch.empty(L, dtype=i32, device=dev)
        out_voxel = torch.empty((L, 3), dtype=f32, device=dev)
    root = uniform = frac = None
    if meta:
        root = torch.empty(L, dtype=i32, device=dev)
        uniform = torch.empty(L, dtype=b, device=dev)
        frac = torch.empty(L, dtype=f32, device=dev)
    lib = _lib or build()
    err = lib.ppg_sd_lookup(
        _ptr(p), sdt.aabb_min.data_ptr(), sdt.aabb_size.data_ptr(),
        sdt.s_child.data_ptr(), sdt.s_dtree.data_ptr(), sdt.s_depth,
        _ptr(mask), _ptr(ids), sdt.ds_root.data_ptr(), sdt.ds_sum.data_ptr(),
        sdt.ds_statw.data_ptr(), sdt.opt_var.data_ptr(), L, _ptr(out_id),
        _ptr(out_voxel), _ptr(root), _ptr(uniform), _ptr(frac), idx,
        raw_stream(idx))
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
    specs = [("qs_sum", sdt.qs_sum, f32, (Q, 4)),
             ("qs_child", sdt.qs_child, i32, (Q, 4)),
             ("p_point", p_point, f32, (L, 2)), ("root", root, i32, (L,)),
             ("uniform", uniform, b, (L,))]
    if u is not None:
        specs += [("u", u, f32, (L, U_COLS)), ("is_point", is_point, b, (L,))]
    _check("ppg_sd_sample_pdf", idx, *specs)
    if sdt.qs_sum.data_ptr() % 16 or sdt.qs_child.data_ptr() % 16:
        raise ValueError("ppg_sd_sample_pdf: qs_sum and qs_child must start "
                         "on 16 bytes (one 16-byte load per node)")
    pdf = torch.empty(L, dtype=f32, device=p_point.device)
    pfin = (torch.empty((L, 2), dtype=f32, device=p_point.device)
            if u is not None else None)
    lib = _lib or build()
    err = lib.ppg_sd_sample_pdf(
        sdt.qs_sum.data_ptr(), sdt.qs_child.data_ptr(), Q, sdt.q_depth,
        _ptr(u), _ptr(is_point), p_point.data_ptr(), root.data_ptr(),
        uniform.data_ptr(), L, _ptr(pfin), pdf.data_ptr(), idx,
        raw_stream(idx))
    if err != 0:
        raise RuntimeError(
            f"ppg_sd_sample_pdf launch failed: cudaError {err}")
    COUNTS["sd_sample_pdf"] += 1
    return pfin, pdf


def sample_pdf(sdt, u, is_point, p_point, root, uniform):
    """K4: (canonical point [L,2], pdf [L]) of
    sdtree.sample_pdf_canonical_plain; u [L,22], is_point [L] bool,
    p_point [L,2], root [L] i32, uniform [L] bool, contiguous on one card.
    Adds one to COUNTS["sd_sample_pdf"]."""
    return _walk(sdt, p_point, root, uniform, u=u, is_point=is_point)


def pdf_point(sdt, p_point, root, uniform):
    """K4 in point mode: the pdf [L] at the canonical points p_point
    [L,2] (sdtree.pdf_dir2's walk), reading no uniforms. Adds one to
    COUNTS["sd_sample_pdf"]."""
    return _walk(sdt, p_point, root, uniform)[1]

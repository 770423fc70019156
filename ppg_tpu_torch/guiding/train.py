"""The training pass's hot loops on a card: the hand-written CUDA kernels
of csrc/train.cu (K5a, the directional splat targets: the leaf descent of
the building quadtree and the box filter's four clamped corner descents;
K5b, the spatial box walk; K6, the 64 rounds of the learned fraction's
Adam chain) and their wrappers.

The kernels replace ppg_tpu's XLA loops, ppg_tpu/guiding/sdtree.py::
descend_cell, descend_cell_clamped and dtree_box_targets4 (K5a),
stree_box_targets (K5b) and the rounds of _adam_chain (K6).
guiding/sdtree.py's descend_cell, dtree_box_targets4, dir_targets,
stree_box_targets and _adam_rounds dispatch here for CUDA tensors; for
CPU tensors they run the plain versions (descend_cell_plain,
dtree_box_targets4_plain, dir_targets_plain, stree_box_targets_plain,
_adam_rounds_plain), which are the kernels' specification: the kernels
equal them bit for bit (see the note in csrc/train.cu). The library is
built from csrc/train.cu with nvcc at first use, into build/ppg_tpu_torch/
at the root of the checkout (native.load_cuda). A failed build or launch
raises.

COUNTS holds plain integers: "sd_dir_targets" counts K5a launches,
"sd_stree_box" K5b launches, "sd_adam" K6 launches, and
"train_plain_on_cuda" plain target walks and Adam rounds run on CUDA
tensors (`reset_counts` zeroes them).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..native import CSRC, load_cuda, raw_stream
from .descent import (INDEX_MAX, SPATIAL, _check, _check_pool, _check_row,
                      _ptr)

COUNTS = {"sd_dir_targets": 0, "sd_stree_box": 0, "sd_adam": 0,
          "train_plain_on_cuda": 0}

S_TARGETS = 16  # = sdtree.S_TARGETS
ADAM_B = 62  # = sdtree.ADAM_B

_SRC = os.path.join(CSRC, "train.cu")
# as csrc/sdtree.cu's: --fmad=false, since the plain versions round every
# product and sum on their own; no fast-math flag (subnormal clamps)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# q_child, Q, table, T, ids, pc, depth, L, n_steps, out node, quad, depth,
# cell, cell4, w4, card, stream
DIR_ARGTYPES = [_vp, _ci, _vp, _ci, _vp, _vp, _vp, _ci, _ci, _vp, _vp, _vp,
                _vp, _vp, _vp, _ci, _vp]
# p, voxel, aabb_min, aabb_size, s_row, s_dtree, mask, L, out id, out w,
# card, stream
BOX_ARGTYPES = [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _vp, _vp, _ci, _vp]
# S0, S1, G0, W, var, m1, m2, iter, chat, T, kl, out var, m1, m2, iter,
# bgrad, bweight, card, stream
ADAM_ARGTYPES = [_vp] * 9 + [_ci, _ci] + [_vp] * 6 + [_ci, _vp]
_lib = None
_chat = {}  # card index -> the Adam buckets' centres on it


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def build():
    """Compile csrc/train.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(_SRC, "libppgtrain", NVCC_FLAGS,
                     {"ppg_sd_dir_targets": DIR_ARGTYPES,
                      "ppg_sd_stree_box": BOX_ARGTYPES,
                      "ppg_sd_adam_rounds": ADAM_ARGTYPES})
    return _lib


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _dir_launch(q_child, ids, pc, n_steps, table=None, depth=None,
                box=False, outs=("cell",)):
    """K5a on a card; returns the outputs named in `outs` (nearest mode:
    any of node, quad, depth, cell) or, with `box`, (cell4, w4)."""
    i32, f32 = torch.int32, torch.float32
    L, idx = pc.shape[0], pc.get_device()
    Q = q_child.shape[0]
    _check_pool("the building quadtrees", Q)
    specs = [("q_child", q_child, i32, (Q, 4)), ("ids", ids, i32, (L,)),
             ("pc", pc, f32, (L, 2))]
    T = 0
    if table is not None:
        T = table.shape[0]
        _check_pool("the dtrees", T)
        specs.append(("db_root", table, i32, (T,)))
    if depth is not None:
        specs.append(("depth", depth, i32, (L,)))
    _check("ppg_sd_dir_targets", idx, *specs)
    new = lambda *shape, dt=i32: torch.empty(shape, dtype=dt,
                                             device=pc.device)
    got = dict(node=None, quad=None, depth=None, cell=None)
    cell4 = w4 = None
    if box:
        cell4, w4 = new(L, 4), new(L, 4, dt=f32)
    else:
        got.update({k: new(L) for k in outs})
    lib = _lib or build()
    _raise_on(lib.ppg_sd_dir_targets(
        q_child.data_ptr(), Q, _ptr(table), T, ids.data_ptr(),
        pc.data_ptr(), _ptr(depth), L, n_steps, _ptr(got["node"]),
        _ptr(got["quad"]), _ptr(got["depth"]), _ptr(got["cell"]),
        _ptr(cell4), _ptr(w4), idx, raw_stream(idx)), "ppg_sd_dir_targets")
    COUNTS["sd_dir_targets"] += 1
    return (cell4, w4) if box else tuple(got[k] for k in outs)


def descend(q_child, root, p, depth_limit, n_steps):
    """K5a's leaf descent from root [L] i32 at the canonical points p
    [L,2], clamped at depth_limit [L] i32 if given: (node, quad, depth) of
    sdtree.descend_cell_plain. Adds one to COUNTS["sd_dir_targets"]."""
    return _dir_launch(q_child, root, p, n_steps, depth=depth_limit,
                       outs=("node", "quad", "depth"))


def box_targets(q_child, root, pc, depth, n_steps):
    """K5a's box corners for the box of depth [L] i32 at pc: (cell4 [L,4]
    i32, w4 [L,4]) of sdtree.dtree_box_targets4_plain. Adds one to
    COUNTS["sd_dir_targets"]."""
    return _dir_launch(q_child, root, pc, n_steps, depth=depth, box=True)


def dir_targets(sdt, sp_id, pc, box):
    """K5a from the dtrees sp_id [L] i32 (their building roots read in the
    kernel) at pc [L,2]: the leaf cell [L] i32, or with `box` (cell4, w4),
    of sdtree.dir_targets_plain. Adds one to COUNTS["sd_dir_targets"]."""
    out = _dir_launch(sdt.qb_child, sp_id, pc.contiguous(), sdt.q_depth,
                      table=sdt.db_root, box=box)
    return out if box else out[0]


def stree_box(sdt, p_world, voxel, mask=None):
    """K5b: (dtree id [L,16] i32, weight [L,16]) of
    sdtree.stree_box_targets_plain for positions and voxels [L,3]; records
    outside mask [L] bool get -1 and 0. The kernel reads a node as its
    16-byte row of sdt.s_row (descent.spatial_rows), which must be
    current. Adds one to COUNTS["sd_stree_box"]."""
    f32, i32 = torch.float32, torch.int32
    what = "ppg_sd_stree_box"
    L, idx = p_world.shape[0], p_world.get_device()
    S = sdt.s_dtree.shape[0]
    _check_pool("the spatial tree", S)
    _check_row(sdt, what, "s_row", SPATIAL, "spatial_rows")
    specs = [("p", p_world, f32, (L, 3)), ("voxel", voxel, f32, (L, 3)),
             ("aabb_min", sdt.aabb_min, f32, (3,)),
             ("aabb_size", sdt.aabb_size.reshape(-1), f32, (1,)),
             ("s_row", sdt.s_row, i32, (S, 4)),
             ("s_dtree", sdt.s_dtree, i32, (S,))]
    if mask is not None:
        specs.append(("mask", mask, torch.bool, (L,)))
    _check(what, idx, *specs)
    ids = torch.empty((L, S_TARGETS), dtype=i32, device=p_world.device)
    w = torch.empty((L, S_TARGETS), dtype=f32, device=p_world.device)
    lib = _lib or build()
    _raise_on(lib.ppg_sd_stree_box(
        p_world.data_ptr(), voxel.data_ptr(), sdt.aabb_min.data_ptr(),
        sdt.aabb_size.data_ptr(), sdt.s_row.data_ptr(),
        sdt.s_dtree.data_ptr(), _ptr(mask), L, ids.data_ptr(), w.data_ptr(),
        idx, raw_stream(idx)), what)
    COUNTS["sd_stree_box"] += 1
    return ids, w


def adam_rounds(sdt, S0, S1, G0, W, kl):
    """K6: the new (opt_var, opt_m1, opt_m2, opt_iter, opt_bgrad,
    opt_bweight) of sdtree._adam_rounds_plain from the bucket sums S0, S1
    [T,62], G0 and W [T] and sdt's Adam state; kl selects the loss (else
    var). Adds one to COUNTS["sd_adam"]."""
    from .sdtree import _ADAM_CHAT

    f32, i32 = torch.float32, torch.int32
    T, idx = sdt.opt_var.shape[0], S0.get_device()
    if not 1 <= T <= INDEX_MAX:
        raise ValueError(f"ppg_sd_adam_rounds: {T} dtrees")
    _check("ppg_sd_adam_rounds", idx,
           ("S0", S0, f32, (T, ADAM_B)), ("S1", S1, f32, (T, ADAM_B)),
           ("G0", G0, f32, (T,)), ("W", W, f32, (T,)),
           ("opt_var", sdt.opt_var, f32, (T,)),
           ("opt_m1", sdt.opt_m1, f32, (T,)),
           ("opt_m2", sdt.opt_m2, f32, (T,)),
           ("opt_iter", sdt.opt_iter, i32, (T,)))
    chat = _chat.get(idx)
    if chat is None:
        chat = _chat[idx] = _ADAM_CHAT.to(S0.device)
    out = [torch.empty(T, dtype=i32 if k == 3 else f32, device=S0.device)
           for k in range(6)]
    lib = _lib or build()
    _raise_on(lib.ppg_sd_adam_rounds(
        S0.data_ptr(), S1.data_ptr(), G0.data_ptr(), W.data_ptr(),
        sdt.opt_var.data_ptr(), sdt.opt_m1.data_ptr(), sdt.opt_m2.data_ptr(),
        sdt.opt_iter.data_ptr(), chat.data_ptr(), T, 1 if kl else 0,
        *(t.data_ptr() for t in out), idx, raw_stream(idx)),
        "ppg_sd_adam_rounds")
    COUNTS["sd_adam"] += 1
    return tuple(out)

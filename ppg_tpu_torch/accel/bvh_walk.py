"""The BVH16 walk on a card: the hand-written CUDA kernels (csrc/bvh.cu,
closest hit and any hit) and their wrappers.

The kernels replace ppg_tpu's XLA walk, ppg_tpu/accel/traverse.py::
bvh_step_factory driven by bvh_closest. `bvh_closest` and `bvh_any_hit`
are the wrappers that accel/traverse.py dispatches to above BRUTE_MAX
triangles: for tensors on the CPU they run the plain version,
traverse.bvh_closest_plain; for CUDA tensors they launch a kernel or
raise. The library is built from csrc/bvh.cu with nvcc at first use, into
build/ppg_tpu_torch/ at the root of the checkout (native.build_shared).
The kernels take the plain version's steps and equal it bit for bit (see
the design note in csrc/bvh.cu).

COUNTS holds plain integers: "bvh_kernel" counts closest-hit launches,
"bvh_any_hit" any-hit launches; a plain walk run on CUDA tensors counts
under brute.COUNTS["plain_on_cuda"], and brute.reset_counts zeroes both.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..native import CSRC, load_cuda, raw_stream

COUNTS = {"bvh_kernel": 0, "bvh_any_hit": 0}

WIDE = 16       # children per node and triangles per leaf the kernel takes
ROW = 9 * WIDE + 2  # floats per row: max(7W, 9W + 2)
STACK_CAP = 64  # entries of a lane's walk stack in the kernel

_SRC = os.path.join(CSRC, "bvh.cu")
# --fmad=false: the plain version rounds every product and sum on its
# own, and a contracted slab or triangle test would cull or pick
# differently. No --use_fast_math: its reciprocal and denormal flushing
# would differ from PyTorch's.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# rows and their row stride, the stack depth, o and its strides, d and its
# strides, t_min, t_max (each with its stride), L, out, the counter of rays
# taken (one int32, zeroed), card, stream
ARGTYPES = [_vp, _ll, _ci, _vp, _ll, _ll, _vp, _ll, _ll, _vp, _ll, _vp, _ll,
            _ci, _vp, _vp, _ci, _vp]
_lib = None


def build():
    """Compile csrc/bvh.cu (once per source content) and load it. Returns
    the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(_SRC, "libppgbvh", NVCC_FLAGS,
                     {"ppg_bvh_closest": ARGTYPES,
                      "ppg_bvh_any_hit": ARGTYPES})
    return _lib


def _launch(fn, geom, o, d, t_min, t_max, out):
    """Checks the inputs (attribute reads only) and launches `fn` on the
    current stream of the rays' card; the rays are read where they lie,
    with their strides, and the kernel's groups take them from a zeroed
    counter. Raises on any mismatch or a failed launch."""
    rows, L, idx = geom.rows, o.shape[0], o.get_device()
    f32 = torch.float32
    if not (rows is not None and rows.dtype == o.dtype == d.dtype
            == t_min.dtype == t_max.dtype == f32
            and rows.get_device() == d.get_device() == t_min.get_device()
            == t_max.get_device() == idx
            and geom.wide == WIDE and rows.dim() == 2
            and rows.shape[1] == ROW and rows.stride(1) == 1
            and rows.stride(0) % 4 == 0 and rows.data_ptr() % 16 == 0
            and 1 <= geom.stack_depth <= STACK_CAP
            and o.shape == d.shape and o.dim() == 2 and o.shape[1] == 3
            and t_min.shape == t_max.shape == (L,)):
        raise ValueError(
            f"want rows [N,{ROW}] float32 of a W = {WIDE} tree, each row on "
            f"16 bytes (traverse.padded_rows), a stack of 1..{STACK_CAP} "
            f"entries, o and d [L,3], t_min and t_max [L], all float32 on "
            f"one card; got wide {geom.wide}, stack {geom.stack_depth}, "
            + ", ".join(f"{x.dtype} {tuple(x.shape)} stride {x.stride()} "
                        f"on {x.device}" for x in
                        (rows, o, d, t_min, t_max) if x is not None))
    if L == 0:
        return
    so, sd = o.stride(), d.stride()
    taken = torch.zeros(1, dtype=torch.int32, device=o.device)
    err = fn(rows.data_ptr(), rows.stride(0), geom.stack_depth,
             o.data_ptr(), so[0], so[1], d.data_ptr(), sd[0], sd[1],
             t_min.data_ptr(), t_min.stride(0), t_max.data_ptr(),
             t_max.stride(0), L, out.data_ptr(), taken.data_ptr(), idx,
             raw_stream(idx))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def bvh_closest(geom, o, d, t_min, t_max):
    """Closest hit of rays (o, d [L,3], t_min/t_max [L]) in the wide BVH
    of geom (traverse.GeometryArrays). CPU tensors run the plain walk;
    CUDA tensors launch the kernel, adding one to COUNTS["bvh_kernel"].
    Returns (best_i i32 in packed order, t, u, v), views of one [4, L]
    buffer on a card."""
    if not o.is_cuda:
        from .traverse import bvh_closest_plain
        return bvh_closest_plain(geom, o, d, t_min, t_max)
    lib = _lib or build()
    out = torch.empty((4, o.shape[0]), dtype=torch.float32, device=o.device)
    _launch(lib.ppg_bvh_closest, geom, o, d, t_min, t_max, out)
    COUNTS["bvh_kernel"] += 1
    i, t, u, v = out.unbind(0)  # row 0 holds best_i's int32 bits
    return i.view(torch.int32), t, u, v


def bvh_any_hit(geom, o, d, t_min, t_max):
    """Whether each ray hits a triangle with t_min < t < t_max: the walk
    with stop_on_hit, which ends a ray at its first accepted hit. CPU
    tensors run the plain walk; CUDA tensors launch the any-hit kernel,
    adding one to COUNTS["bvh_any_hit"]. Returns bool [L]."""
    if not o.is_cuda:
        from .traverse import bvh_closest_plain
        return bvh_closest_plain(geom, o, d, t_min, t_max,
                                 stop_on_hit=True)[0] >= 0
    lib = _lib or build()
    out = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    _launch(lib.ppg_bvh_any_hit, geom, o, d, t_min, t_max, out)
    COUNTS["bvh_any_hit"] += 1
    return out

"""Small-scene triangle sweep: the hand-written CUDA kernels
(csrc/brute.cu, closest hit and any hit) and their plain PyTorch version.

The kernels replace the Pallas TPU kernel ppg_tpu/accel/pallas_brute.py.
`brute_closest` and `brute_any_hit` are the wrappers the tracer calls: for
tensors on the CPU they run `brute_sweep_plain`; for CUDA tensors they
launch a kernel or raise. The kernel library is built from csrc/brute.cu
with nvcc at first use, into build/ppg_tpu_torch/ at the root of the
checkout (native.build_shared). The kernels equal the plain version bit
for bit (see the design note in csrc/brute.cu).

COUNTS holds plain integers: "brute_kernel" counts closest-hit kernel
launches, "any_hit" any-hit kernel launches, and "plain_on_cuda" plain
sweeps run on CUDA tensors, so a run can show which of the two carried
its rays (`reset_counts` zeroes them all, and the BVH walk's
accel/bvh_walk.COUNTS).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..native import CSRC, load_cuda, raw_stream

INF = 3.4e38  # miss sentinel (float32(3.4e38)), as in ppg_tpu

COUNTS = {"brute_kernel": 0, "any_hit": 0, "plain_on_cuda": 0}

_SRC = os.path.join(CSRC, "brute.cu")
# FMA contraction is allowed: the exact stage of the kernel uses
# non-contractible intrinsics. No --use_fast_math: its reciprocal and
# denormal flushing would differ from PyTorch's.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# tri, T, o and its strides, d and its strides, t_min, t_max (each with
# its stride), L, out, card, stream
ARGTYPES = [_vp, _ci, _vp, _ll, _ll, _vp, _ll, _ll, _vp, _ll, _vp, _ll, _ci,
            _vp, _ci, _vp]
_lib = None


def reset_counts():
    from .bvh_walk import COUNTS as WALK

    for counts in (COUNTS, WALK):
        for k in counts:
            counts[k] = 0


def build():
    """Compile csrc/brute.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(_SRC, "libppgbrute", NVCC_FLAGS,
                     {"ppg_brute_closest": ARGTYPES,
                      "ppg_brute_any_hit": ARGTYPES})
    return _lib


def brute_sweep_plain(tri, o, d, t_min, t_max):
    """Plain PyTorch sweep (the semantics of ppg_tpu's
    traverse.brute_force_closest): one pass over the triangles in packed
    order, every product and sum a separate rounded f32 op. Returns
    (best_i i32, t, u, v) with t = INF and best_i = -1 on a miss."""
    if o.is_cuda:
        COUNTS["plain_on_cuda"] += 1
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    L = o.shape[0]
    best_t = torch.full((L,), INF, dtype=torch.float32, device=o.device)
    best_i = torch.full((L,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros(L, dtype=torch.float32, device=o.device)
    best_v = torch.zeros(L, dtype=torch.float32, device=o.device)
    for k, row in enumerate(tri[:, :9]):
        p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = row.unbind(0)
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv = torch.where(det.abs() < 1e-12, 0.0, torch.reciprocal(det))
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        hit = ((inv != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_min) & (t < torch.minimum(best_t, t_max)))
        best_i = torch.where(hit, k, best_i)
        best_u = torch.where(hit, u, best_u)
        best_v = torch.where(hit, v, best_v)
        best_t = torch.where(hit, t, best_t)
    return best_i, torch.where(best_i >= 0, best_t, INF), best_u, best_v


def _launch(fn, tri, o, d, t_min, t_max, out):
    """Checks the inputs (attribute reads only) and launches `fn` on the
    current stream of the rays' card; the rays are read where they lie,
    with their strides. Raises on any mismatch or a failed launch."""
    L, T, idx = o.shape[0], tri.shape[0], o.get_device()
    f32 = torch.float32
    if not (tri.dtype == o.dtype == d.dtype == t_min.dtype == t_max.dtype
            == f32 and tri.get_device() == d.get_device()
            == t_min.get_device() == t_max.get_device() == idx
            and tri.shape[1] == 12 and tri.is_contiguous()
            and o.shape == d.shape and o.shape[1] == 3
            and t_min.shape == t_max.shape == (L,)):
        raise ValueError(
            "want tri [T,12] contiguous, o and d [L,3], t_min and t_max "
            "[L], all float32 on one card; got " + ", ".join(
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
                for x in (tri, o, d, t_min, t_max)))
    if L == 0:
        return
    so, sd = o.stride(), d.stride()
    err = fn(tri.data_ptr(), T, o.data_ptr(), so[0], so[1], d.data_ptr(),
             sd[0], sd[1], t_min.data_ptr(), t_min.stride(0),
             t_max.data_ptr(), t_max.stride(0), L, out.data_ptr(), idx,
             raw_stream(idx))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def brute_closest(tri, o, d, t_min, t_max, count="brute_kernel"):
    """Closest hit of rays (o, d [L,3], t_min/t_max [L]) against every
    triangle of tri [T,12] (p0, e1, e2, pad). CPU tensors run the plain
    version; CUDA tensors launch the kernel, adding one to COUNTS[count].
    Returns (best_i i32, t, u, v), views of one [4, L] buffer on a card."""
    if not o.is_cuda:
        return brute_sweep_plain(tri, o, d, t_min, t_max)
    lib = _lib or build()
    out = torch.empty((4, o.shape[0]), dtype=torch.float32, device=o.device)
    _launch(lib.ppg_brute_closest, tri, o, d, t_min, t_max, out)
    COUNTS[count] += 1
    i, t, u, v = out.unbind(0)  # row 0 holds best_i's int32 bits
    return i.view(torch.int32), t, u, v


def brute_any_hit(tri, o, d, t_min, t_max):
    """Whether each ray hits any triangle with t_min < t < t_max (the
    closest-hit sweep's best_i >= 0). CPU tensors run the plain version;
    CUDA tensors launch the any-hit kernel, which stops each ray at its
    first hit, adding one to COUNTS["any_hit"]. Returns bool [L]."""
    if not o.is_cuda:
        return brute_sweep_plain(tri, o, d, t_min, t_max)[0] >= 0
    lib = _lib or build()
    out = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    _launch(lib.ppg_brute_any_hit, tri, o, d, t_min, t_max, out)
    COUNTS["any_hit"] += 1
    return out

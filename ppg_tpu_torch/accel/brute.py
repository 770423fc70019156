"""Small-scene closest-hit sweep: the hand-written CUDA kernel
(csrc/brute.cu) and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ppg_tpu/accel/pallas_brute.py.
`brute_closest` is the wrapper the tracer calls: for a tensor on the CPU it
runs `brute_sweep_plain`; for a CUDA tensor it launches the kernel or
raises. The kernel library is built from csrc/brute.cu with nvcc at first
use, into build/ppg_tpu_torch/ at the root of the checkout.

COUNTS holds plain integers: "brute_kernel" counts kernel launches for
closest-hit rays, "any_hit" kernel launches for shadow rays, and
"plain_on_cuda" plain sweeps run on CUDA tensors, so a run can show which
of the two carried its rays (`reset_counts` zeroes them all).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

INF = 3.4e38  # miss sentinel (float32(3.4e38)), as in ppg_tpu

COUNTS = {"brute_kernel": 0, "any_hit": 0, "plain_on_cuda": 0}

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "brute.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "ppg_tpu_torch")
# --fmad=false keeps every product and sum rounded on its own, as PyTorch's
# elementwise kernels round them; with nvcc's default contraction into FMAs
# the kernel's t/u/v would differ from the plain version in the last bits
# and near-ties would pick other triangles. No --use_fast_math: it would
# replace the IEEE division 1/det with an approximate reciprocal.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/brute.cu")
    return path


def build():
    """Compile csrc/brute.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                               ).hexdigest()[:12]
        so = os.path.join(BUILD_DIR, f"libppgbrute-{tag}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC}:\n{r.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ppg_brute_closest.argtypes = [vp, ci, vp, ci, vp, vp, vp, vp, vp]
        lib.ppg_brute_closest.restype = ci
        _lib = lib
        return lib


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


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous() \
            or tuple(x.shape) != shape:
        raise ValueError(f"{name}: want contiguous {dtype} {shape} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device} (contiguous={x.is_contiguous()})")


def brute_closest(tri, o, d, t_min, t_max, count="brute_kernel"):
    """Closest hit of rays (o, d [L,3], t_min/t_max [L]) against every
    triangle of tri [T,12] (p0, e1, e2, pad). CPU tensors run the plain
    version; CUDA tensors launch the kernel, adding one to COUNTS[count]."""
    if not o.is_cuda:
        return brute_sweep_plain(tri, o, d, t_min, t_max)
    L, T = o.shape[0], tri.shape[0]
    dev = o.device
    _check("tri", tri, (T, 12), torch.float32, dev)
    for name, x in (("o", o), ("d", d)):
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != (L, 3):
            raise ValueError(f"{name}: want float32 ({L}, 3) on {dev}")
    for name, x in (("t_min", t_min), ("t_max", t_max)):
        _check(name, x, (L,), torch.float32, dev)
    lib = build()
    # SoA [8, L]: one coalesced load per component in the kernel
    rays = torch.cat([o.t(), d.t(), t_min[None], t_max[None]]).contiguous()
    best_i = torch.empty(L, dtype=torch.int32, device=dev)
    t = torch.empty(L, dtype=torch.float32, device=dev)
    u = torch.empty(L, dtype=torch.float32, device=dev)
    v = torch.empty(L, dtype=torch.float32, device=dev)
    if L == 0:
        return best_i, t, u, v
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ppg_brute_closest(tri.data_ptr(), T, rays.data_ptr(), L,
                                    best_i.data_ptr(), t.data_ptr(),
                                    u.data_ptr(), v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"brute_closest kernel launch failed: "
                           f"cudaError {err}")
    COUNTS[count] += 1
    return best_i, t, u, v

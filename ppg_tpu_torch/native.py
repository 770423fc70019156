"""Builds and loads the port's native libraries: the host C++ helpers
(csrc/host/bvh_builder.cpp, the wide-BVH builder; csrc/host/sdtree_host.cpp,
the SD-tree topology kernels) and the CUDA kernels (accel/brute.py,
accel/bvh_walk.py).

Each library is compiled at first use into build/ppg_tpu_torch/ at the
root of the checkout, never beside its source. The file name carries a
hash of the source, the compiler and its flags, and, for -march=native,
the target features the compiler resolves on this machine, so a checkout
shared between machines never loads a library built for another CPU.
The host libraries use ppg_tpu's compiler flags, so the BVH leaf order,
and with it the packed triangle ids, is the same as ppg_tpu's on the same
machine. Without a C++ compiler `bvh_lib` returns None (accel/bvh.py then
takes its numpy builder) and `sdtree_lib` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ppg_tpu_torch")

# as ppg_tpu/accel/native and ppg_tpu/guiding/native compile them
_HOST_FLAGS = {
    "bvh_builder": ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                    "-pthread"],
    "sdtree_host": ["-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17"],
}

_lock = threading.Lock()
_host = {}  # source stem -> loaded library, or False after a failed build
_cuda = {}  # source stem -> loaded CUDA kernel library
_cuda_locks = {}


def build_shared(compiler, flags, src, stem, tag=b""):
    """Compile `src` into a shared library under BUILD_DIR (once per
    source, compiler, flags and `tag`) and return its path; raises
    RuntimeError with the compiler's messages if it fails."""
    with open(src, "rb") as f:
        key = f.read() + "\0".join([compiler, *flags]).encode() + tag
    so = os.path.join(BUILD_DIR,
                      f"{stem}-{hashlib.sha1(key).hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run([compiler, *flags, "-o", tmp, src],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {src}:\n{r.stderr}")
        os.replace(tmp, so)
    return so


def nvcc():
    """The CUDA compiler's path; raises if the toolkit is missing."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in csrc/")
    return path


def load_cuda(src, stem, flags, symbols):
    """Compile the CUDA source `src` with nvcc (once per source content
    and flags) and load it, once per process. `symbols` maps each C entry
    point to its ctypes argtypes; each returns an int error code. Each
    stem has its own lock, so that two sources build at the same time.
    Returns the ctypes library; raises if nvcc fails."""
    with _lock:
        lock = _cuda_locks.setdefault(stem, threading.Lock())
    with lock:
        lib = _cuda.get(stem)
        if lib is None:
            lib = ctypes.CDLL(build_shared(nvcc(), flags, src, stem))
            for name, argtypes in symbols.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _cuda[stem] = lib
        return lib


def raw_stream(index):
    """The handle of the current CUDA stream of card `index`, as a kernel
    library's C entry point takes it."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return get(index) if get else torch.cuda.current_stream(index).cuda_stream


def _native_target(cxx):
    """What -march=native means here: gcc lists the target options it
    enables; other compilers fall back to the host's name."""
    try:
        r = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                           capture_output=True, text=True, timeout=60)
        if r.returncode == 0 and r.stdout:
            return r.stdout.encode()
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{platform.node()} {platform.machine()}".encode()


def _host_lib(stem, declare):
    with _lock:
        lib = _host.get(stem)
        if lib is None:
            cxx = os.environ.get("CXX", "c++")
            try:
                so = build_shared(cxx, _HOST_FLAGS[stem],
                                  os.path.join(CSRC, "host", f"{stem}.cpp"),
                                  f"lib{stem}", _native_target(cxx))
                lib = ctypes.CDLL(so)
                declare(lib)
            except (OSError, RuntimeError):
                lib = False
            _host[stem] = lib
        return lib or None


def _declare_bvh(lib):
    i32 = ctypes.c_int32
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(i32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ppg_bvh_build.restype = i32
    lib.ppg_bvh_build.argtypes = [f32p, i32, i32p, i32, i32, i32]
    lib.ppg_bvh_copy.restype = None
    lib.ppg_bvh_copy.argtypes = [f32p, f32p, u8p, i32p, i32p, i32p, i32p]
    lib.ppg_bvhw_build.restype = i32
    lib.ppg_bvhw_build.argtypes = [f32p, i32, i32p, i32, i32, i32, i32]
    lib.ppg_bvhw_copy.restype = None
    lib.ppg_bvhw_copy.argtypes = [f32p, i32p]


def _declare_sdtree(lib):
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    f64p = ctypes.POINTER(f64)
    i64p = ctypes.POINTER(i64)
    lib.ppg_sdt_reset.restype = i64
    lib.ppg_sdt_reset.argtypes = [i64, f64p, i64p, f64p, i64p, f64, i64, i64]
    lib.ppg_sdt_reset_copy.restype = None
    lib.ppg_sdt_reset_copy.argtypes = [i64p, i64p]
    lib.ppg_sdt_build.restype = None
    lib.ppg_sdt_build.argtypes = [i64, i64, f64p, i64p, i64p, i64p, f64p,
                                  i64p]
    lib.ppg_sdt_pushdown.restype = None
    lib.ppg_sdt_pushdown.argtypes = [i64, f64p, i64p]
    lib.ppg_sdt_regather.restype = None
    lib.ppg_sdt_regather.argtypes = [
        i64, i64p, i64p, i64p, f64p, i64p, i64p, f64p, i64p]


def bvh_lib():
    """The native wide-BVH builder, or None without a working compiler."""
    return _host_lib("bvh_builder", _declare_bvh)


def sdtree_lib():
    """The native SD-tree topology kernels; raises if they do not build."""
    lib = _host_lib("sdtree_host", _declare_sdtree)
    if lib is None:
        raise RuntimeError("the native SD-tree kernels "
                           "(ppg_tpu_torch/csrc/host/sdtree_host.cpp) failed "
                           "to build or load")
    return lib

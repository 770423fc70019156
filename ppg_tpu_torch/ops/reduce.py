"""Indexed accumulation, K5's sums (counterpart of ppg_tpu/ops/reduce.py):
target[m] += the sum of the values whose index is m.

ppg_tpu sorts the records and takes a compensated prefix sum, so that its
sums are the same on every run. Here each cell's sum is a fixed-point
integer sum at a scale of the cell's own (see csrc/reduce.cu's note, which
states the rounding and the error bound), so the bits do not depend on the
order of the records on any device, and no float atomic is taken. A
record whose value is zero touches nothing; a non-finite value makes its
cell target + the IEEE sum of the cell's non-finite values and touches no
other cell.

bincount_add and bincount_add2 launch the kernels of csrc/reduce.cu (K5:
three launches a call, both streams of bincount_add2 in one sequence; a
call whose cells fit in a block's shared memory sums there, block by
block, any other one in global scratch) for
CUDA tensors and run bincount_add_plain, the kernels' specification, for
CPU tensors; they equal each other bit for bit. The library is built with
nvcc at first use into build/ppg_tpu_torch/ (native.load_cuda); a failed
build or launch raises, and an index outside [0, M) traps the kernel, as
index_add_'s device assertion does. The kernels keep their scratch (20 B a
cell and stream) zeroed between calls, one scratch per card and CUDA
stream, so that calls on two streams at once do not share one.

COUNTS holds plain integers: "reduce_add" counts K5's launches (three a
call), "reduce_shared" and "reduce_global" its calls by the path they
took (`path`), "reduce_plain_on_cuda" plain sums run on CUDA tensors
(`reset_counts` zeroes them).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..guiding.descent import _check
from ..native import CSRC, load_cuda, raw_stream

COUNTS = {"reduce_add": 0, "reduce_plain_on_cuda": 0, "reduce_shared": 0,
          "reduce_global": 0}

ACC_BITS = 62  # each cell's sum of quantised values stays below 2^62

_SRC = os.path.join(CSRC, "reduce.cu")
# --fmad=false and no fast-math flag: the quantisation and the final
# product and sum are each rounded on their own, subnormals exactly
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# idx, idx64, N, M, n_streams, target0, val0, target1, val1, acc, cnt, ex,
# nf, cap, card, stream
ARGTYPES = [_vp, _ci, _cll, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
            _vp, _cll, _ci, _vp]
PATH_ARGTYPES = [_ci, _ci]  # M, n_streams
PATHS = ("shared", "global")  # ppg_reduce_path's values
_lib = None
_scratch = {}  # (card, stream) -> (cap, acc int64 [2 cap], int32 [3, 2 cap])
LAUNCHES_PER_CALL = 3


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def build():
    """Compile csrc/reduce.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(_SRC, "libppgreduce", NVCC_FLAGS,
                     {"ppg_reduce_add": ARGTYPES,
                      "ppg_reduce_path": PATH_ARGTYPES})
    return _lib


def path(M, n_streams, lib=None):
    """The path K5 takes into M cells a stream (PATHS): "shared" (cells x
    streams fit in a block's shared memory: the sums there, block by
    block) or "global" (in global scratch)."""
    return PATHS[(lib or _lib or build()).ppg_reduce_path(M, n_streams)]


def bincount_add(target_flat, idx, val):
    """target_flat[m] += sum(val[idx == m]), in place; returns target_flat.
    Masked records carry val == 0 at any in-range idx. CUDA tensors launch
    K5; CPU tensors run bincount_add_plain."""
    if target_flat.is_cuda:
        return _launch((target_flat,), idx, (val,))[0]
    return bincount_add_plain(target_flat, idx, val)


def bincount_add2(targets, idx, val_a, val_b):
    """Two accumulations over one index (e.g. sum and statweight), in
    place, each as bincount_add; returns the pair of targets."""
    if targets[0].is_cuda:
        return _launch(tuple(targets), idx, (val_a, val_b))
    return (bincount_add_plain(targets[0], idx, val_a),
            bincount_add_plain(targets[1], idx, val_b))


def _pow2(k):
    """2^k as float64, exact, for integer k [..] in [-1022, 1023]."""
    return ((k.long() + 1023) << 52).view(torch.float64)


def _bitlen(c):
    """ceil(log2(c + 1)) of int64 counts c >= 0: frexp's exponent, exact
    below 2^53."""
    return torch.frexp(c.double())[1]


def bincount_add_plain(target_flat, idx, val):
    """bincount_add in PyTorch operations (the kernels' specification): the
    per-cell fixed-point sum of csrc/reduce.cu, in place; returns
    target_flat. Only integer sums and exact powers of two take part, so
    no step depends on the order of the records. An index outside [0, M),
    whatever its value, raises IndexError (the kernel traps)."""
    if target_flat.is_cuda:
        COUNTS["reduce_plain_on_cuda"] += 1
    M, dev = target_flat.shape[0], target_flat.device
    idx = idx.long()
    if idx.numel() and bool((idx.min() < 0) | (idx.max() >= M)):
        raise IndexError(f"bincount_add: an index outside [0, {M})")
    fin = torch.isfinite(val)
    use = (val != 0) & fin
    i, v = idx[use], val[use]
    cnt = torch.zeros(M, dtype=torch.int64, device=dev).index_add_(
        0, i, torch.ones_like(i))
    ex = torch.zeros(M, dtype=torch.int32, device=dev).scatter_reduce_(
        0, i, torch.frexp(v)[1], "amax", include_self=False)
    has = cnt > 0
    # the scale 2^(S - e) of each cell, S = ACC_BITS - bitlen(count)
    sh = torch.where(has, ACC_BITS - _bitlen(cnt) - ex, 0)
    q = torch.round(v.double() * _pow2(sh[i])).long()
    acc = torch.zeros(M, dtype=torch.int64, device=dev).index_add_(0, i, q)
    new = (target_flat.double() + acc.double() * _pow2(-sh)).float()
    bad = ~fin
    if bool(bad.any()):
        ib, vb = idx[bad], val[bad]
        seen = lambda m: torch.zeros(M, dtype=torch.int64, device=dev) \
            .index_add_(0, ib[m], torch.ones_like(ib[m])) > 0
        nan, pos, neg = seen(vb.isnan()), seen(vb > 0), seen(vb < 0)
        flagged = nan | pos | neg
        inf = torch.tensor(float("inf"), device=dev)
        nfv = torch.where(nan | (pos & neg), float("nan"),
                          torch.where(pos, inf, -inf))
        new = torch.where(flagged, target_flat + nfv, new)
        has = has | flagged
    return target_flat.copy_(torch.where(has, new, target_flat))


def _scratch_for(card, stream, M):
    """The zeroed scratch of the card's CUDA stream `stream`, grown to at
    least M cells a stream of values."""
    got = _scratch.get((card, stream))
    if got is None or got[0] < M:
        cap = max(M, 2 * got[0] if got else 1 << 12)
        dev = torch.device("cuda", card)
        got = (cap, torch.zeros(2 * cap, dtype=torch.int64, device=dev),
               torch.zeros((3, 2 * cap), dtype=torch.int32, device=dev))
        _scratch[(card, stream)] = got
    return got


def _launch(targets, idx, vals):
    """K5 on targets' card: each target [M] += its values [N] by idx [N]
    (int32 or int64). Adds its three launches to COUNTS["reduce_add"]."""
    card = targets[0].get_device()
    M, N = targets[0].shape[0], idx.shape[0]
    _check("ppg_reduce_add", card,
           *((f"target{s}", t, torch.float32, (M,))
             for s, t in enumerate(targets)),
           *((f"val{s}", v, torch.float32, (N,)) for s, v in enumerate(vals)))
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1 \
            or not idx.is_contiguous() or idx.device != targets[0].device:
        raise ValueError(f"ppg_reduce_add: want idx int32 or int64 ({N},), "
                         f"contiguous on cuda:{card}; got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    if not 1 <= M < 2 ** 31:
        raise ValueError(f"ppg_reduce_add: {M} cells; the kernels index "
                         f"1..{2 ** 31 - 1}")
    if N == 0:
        return targets
    stream = raw_stream(card)
    cap, acc, meta = _scratch_for(card, stream, M)
    t1, v1 = (targets[1], vals[1]) if len(targets) == 2 else (None, None)
    lib = _lib or build()
    err = lib.ppg_reduce_add(
        idx.data_ptr(), int(idx.dtype == torch.int64), N, M, len(targets),
        targets[0].data_ptr(), vals[0].data_ptr(),
        None if t1 is None else t1.data_ptr(),
        None if v1 is None else v1.data_ptr(), acc.data_ptr(),
        meta[0].data_ptr(), meta[1].data_ptr(), meta[2].data_ptr(), cap,
        card, stream)
    if err != 0:
        raise RuntimeError(f"ppg_reduce_add launch failed: cudaError {err}")
    COUNTS["reduce_add"] += LAUNCHES_PER_CALL
    COUNTS["reduce_" + path(M, len(targets), lib)] += 1
    return targets

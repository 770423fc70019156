"""Film accumulation (counterpart of ppg_tpu/render/film.py, box
reconstruction filter only). The box filter with samples jittered inside
their own pixel lands every sample in that pixel, so a contiguous pixel
chunk splats with one slice add. Unlike the functional JAX version the
flat buffers are updated in place.

Film.splat_box_linear launches K7 (csrc/film.cu, one launch a chunk for
the film and, if given, the squared film) for CUDA tensors and runs
splat_box_linear_plain, the kernel's specification, for CPU tensors; they
equal each other bit for bit. The library is built with nvcc at first use
into build/ppg_tpu_torch/ (native.load_cuda); a failed build or launch
raises. COUNTS holds plain integers: "film_splat" counts K7 launches,
"film_plain_on_cuda" plain splats run on CUDA tensors (`reset_counts`
zeroes them).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..guiding.descent import _check
from ..native import CSRC, load_cuda, raw_stream

COUNTS = {"film_splat": 0, "film_plain_on_cuda": 0}

_SRC = os.path.join(CSRC, "film.cu")
# --fmad=false: the squares are rounded before they are added, as the
# plain version rounds them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# rgb, w, rgb2, w2, start, values, valid, C, card, stream
ARGTYPES = [_vp, _vp, _vp, _vp, _cll, _vp, _vp, _cll, _ci, _vp]
_lib = None


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def build():
    """Compile csrc/film.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(_SRC, "libppgfilm", NVCC_FLAGS,
                     {"ppg_film_splat": ARGTYPES})
    return _lib


def splat_box_linear_plain(buffers, start, values, valid, sq_buffers=None):
    """Adds values [C,3] (where valid [C]) and weight 1 to the C pixels
    from linear offset `start`, and with sq_buffers values * values and
    weight 1 to those, in place; returns the buffers."""
    if values.is_cuda:
        COUNTS["film_plain_on_cuda"] += 1
    C = values.shape[0]
    for bufs, v in ((buffers, values),
                    (sq_buffers, None if sq_buffers is None
                     else values * values)):
        if bufs is not None:
            bufs[0][start:start + C] += torch.where(valid[:, None], v, 0.0)
            bufs[1][start:start + C] += valid.to(torch.float32)
    return buffers


def _launch(buffers, start, values, valid, sq_buffers):
    """K7 on the buffers' card. Adds one to COUNTS["film_splat"]."""
    rgb, w = buffers
    card, P, C = rgb.get_device(), rgb.shape[0], values.shape[0]
    specs = [("rgb", rgb, torch.float32, (P, 3)), ("w", w, torch.float32, (P,)),
             ("values", values, torch.float32, (C, 3)),
             ("valid", valid, torch.bool, (C,))]
    if sq_buffers is not None:
        specs += [("rgb2", sq_buffers[0], torch.float32, (P, 3)),
                  ("w2", sq_buffers[1], torch.float32, (P,))]
    _check("ppg_film_splat", card, *specs)
    if not 0 <= start <= P - C:
        raise ValueError(f"ppg_film_splat: pixels {start}..{start + C} of "
                         f"{P}")
    rgb2, w2 = sq_buffers if sq_buffers is not None else (None, None)
    lib = _lib or build()
    err = lib.ppg_film_splat(
        rgb.data_ptr(), w.data_ptr(), None if rgb2 is None else rgb2.data_ptr(),
        None if w2 is None else w2.data_ptr(), int(start), values.data_ptr(),
        valid.data_ptr(), C, card, raw_stream(card))
    if err != 0:
        raise RuntimeError(f"ppg_film_splat launch failed: cudaError {err}")
    COUNTS["film_splat"] += 1
    return buffers


class Film:
    """Accumulation buffers: rgb sum and weight sum per pixel."""

    def __init__(self, W, H, rfilter="box", device="cuda"):
        if rfilter != "box":
            raise NotImplementedError(
                f"rfilter {rfilter!r}: only the box filter is ported "
                "(ROADMAP Queue 1, the general rfilter Film.splat)")
        self.W, self.H, self.rfilter = W, H, rfilter
        self.device = device

    def zeros_flat(self, chunk):
        """Flat buffers padded to a whole number of chunks."""
        P = ((self.W * self.H + chunk - 1) // chunk) * chunk
        return (torch.zeros((P, 3), dtype=torch.float32, device=self.device),
                torch.zeros(P, dtype=torch.float32, device=self.device))

    @staticmethod
    def splat_box_linear(buffers, start, values, valid, sq_buffers=None):
        """Adds values [C,3] (where valid [C]) and weight 1 to the C pixels
        from linear offset `start`, and with sq_buffers the squares too, in
        place; returns the buffers. CUDA tensors launch K7 once; CPU
        tensors run splat_box_linear_plain."""
        if values.is_cuda:
            return _launch(buffers, start, values, valid, sq_buffers)
        return splat_box_linear_plain(buffers, start, values, valid,
                                      sq_buffers)

    def unflatten(self, buffers):
        rgb_flat, w_flat = buffers
        n = self.W * self.H
        return (rgb_flat[:n].reshape(self.H, self.W, 3),
                w_flat[:n].reshape(self.H, self.W))

    @staticmethod
    def develop(buffers):
        rgb, wsum = buffers
        return rgb / torch.clamp(wsum, min=1e-20)[..., None]

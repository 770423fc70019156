"""Film accumulation with reconstruction filters (counterpart of
ppg_tpu/render/film.py): each sample adds (value * weight, weight) into
the pixels its filter reaches; develop() divides by the weight sum.
Filters as in ppg_tpu: box, tent, gaussian, mitchell, catmullrom and
lanczos, evaluated analytically (`filter_eval`). Unlike the functional
JAX version the buffers are updated in place.

Two splats, each with a hand-written kernel for CUDA tensors and its plain
version, the kernel's specification, for CPU tensors (the kernels equal
them bit for bit):
- the box filter, whose samples jittered inside their own pixel land in
  that pixel: a contiguous pixel chunk splats into flat buffers with one
  slice add. Film.splat_box_linear launches K7 (csrc/film.cu,
  ppg_film_splat) and runs splat_box_linear_plain on the CPU;
- every other filter: Film.splat gathers a chunk's samples into the
  [H,W] buffers' pixels that the chunk reaches. It launches K7s
  (csrc/film.cu, ppg_film_splat_filter) and runs splat_filter_plain on
  the CPU.
Each launch covers the film and, if given, the squared film. The library
is built with nvcc at first use into build/ppg_tpu_torch/
(native.load_cuda); a failed build or launch raises. COUNTS holds plain
integers: "film_splat" counts K7 launches, "film_splat_filter" K7s
launches, "film_plain_on_cuda" plain splats of either kind run on CUDA
tensors (`reset_counts` zeroes them).
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from ..guiding.descent import _check
from ..native import CSRC, load_cuda, raw_stream

COUNTS = {"film_splat": 0, "film_splat_filter": 0, "film_plain_on_cuda": 0}

FILTER_RADIUS = {
    "box": 0.5,
    "tent": 1.0,
    "gaussian": 2.0,
    "mitchell": 2.0,
    "catmullrom": 2.0,
    "lanczos": 3.0,
}
# K7s's filter kinds (csrc/film.cu)
_KIND = {"tent": 1, "gaussian": 2, "mitchell": 3, "catmullrom": 3,
         "lanczos": 4}
N_CONSTS = 10

_SRC = os.path.join(CSRC, "film.cu")
# --fmad=false: every product (a square, a filter term) is rounded before
# it is added, as the plain versions round them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# rgb, w, rgb2, w2, start, values, valid, C, card, stream
ARGTYPES = [_vp, _vp, _vp, _vp, _cll, _vp, _vp, _cll, _ci, _vp]
# rgb, w, rgb2, w2, pos, values, start, C, W, H, kind, radius, consts,
# card, stream
FILTER_ARGTYPES = [_vp] * 6 + [_cll, _cll, _ci, _ci, _ci, ctypes.c_float,
                               _vp, _ci, _vp]
_lib = None


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def build():
    """Compile csrc/film.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(_SRC, "libppgfilm", NVCC_FLAGS,
                     {"ppg_film_splat": ARGTYPES,
                      "ppg_film_splat_filter": FILTER_ARGTYPES})
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


def filter_constants(name):
    """The float32 constants of filter `name` as K7s takes them (N_CONSTS
    floats): ppg_tpu's Python-float constants rounded to float32, as its
    float32 arithmetic rounds them. gaussian: alpha, exp(4 alpha);
    mitchell and catmullrom: the outer cubic's four coefficients from x^3
    down, the inner cubic's x^3, x^2 and 1 coefficients, 1/6; lanczos:
    pi, 1/3 (the quotient by 3 as a product by its reciprocal, as ATen on
    a card computes it), 1e-6, 3."""
    c = np.zeros(N_CONSTS, np.float32)
    if name == "gaussian":
        # sigma = 0.5, radius 2, offset to zero at the boundary
        alpha = -1.0 / (2.0 * 0.5 ** 2)
        c[:2] = alpha, np.exp(alpha * 4.0)
    elif name in ("mitchell", "catmullrom"):
        B, C = (1 / 3, 1 / 3) if name == "mitchell" else (0.0, 0.5)
        c[:8] = (-B - 6 * C, 6 * B + 30 * C, -12 * B - 48 * C, 8 * B + 24 * C,
                 12 - 9 * B - 6 * C, -18 + 12 * B + 6 * C, 6 - 2 * B,
                 1.0 / 6.0)
    elif name == "lanczos":
        c[:4] = math.pi, 1.0 / 3.0, 1e-6, 3.0
    elif name not in FILTER_RADIUS:
        raise ValueError(f"unknown rfilter {name!r}")
    return c


def _mitchell_1d(x, c):
    """The Mitchell-Netravali cubic at |2x| with constants c
    (filter_constants)."""
    x = torch.abs(2.0 * x)
    x2, x3 = x * x, x * x * x
    outer = (c[0] * x3 + c[1] * x2 + c[2] * x + c[3]) * c[7]
    inner = (c[4] * x3 + c[5] * x2 + c[6]) * c[7]
    return torch.where(x > 1, outer, inner)


def _sinc(x, pi):
    """sin(pi x) / (pi x) from elementary operations (not torch.sinc)."""
    px = pi * x
    return torch.sin(px) / px


def filter_eval(name, x):
    """1D filter weight at offset x (pixels), float32; filters are
    separable. The operations of K7s's filter_eval, in its order."""
    ax = torch.abs(x)
    if name == "box":
        return torch.where(ax <= 0.5, 1.0, 0.0)
    c = [float(v) for v in filter_constants(name)]
    if name == "tent":
        return torch.clamp(1.0 - ax, min=0.0)
    if name == "gaussian":
        return torch.clamp(torch.exp(c[0] * ax * ax) - c[1], min=0.0)
    if name in ("mitchell", "catmullrom"):
        # ppg_tpu's |2 (ax / 2)|: halving and doubling are exact
        return torch.where(ax <= 2.0, _mitchell_1d(ax * 0.5, c), 0.0)
    # lanczos
    s = torch.where(ax < c[2], 1.0,
                    _sinc(ax, c[0]) * _sinc(ax * c[1], c[0]))
    return torch.where(ax <= c[3], s, 0.0)


def _filter_geometry(radius):
    """(K, n): the neighbourhood a sample inside its pixel reaches,
    ceil(r), and the pixels its window spans per axis, ceil(2r)."""
    return math.ceil(radius), math.ceil(2 * radius)


def _reached_rows(W, H, pix_start, C, K):
    """(last pixel of the chunk on the film, first row, number of rows)
    that the chunk's samples can reach; None for a chunk off the film."""
    last = min(pix_start + C, W * H) - 1
    if C <= 0 or pix_start < 0 or last < pix_start:
        return None
    y0 = max(pix_start // W - K, 0)
    return last, y0, min(last // W + K, H - 1) - y0 + 1


def splat_filter_plain(name, buffers, pix_start, pos, values,
                       sq_buffers=None):
    """The filter splat of one pixel chunk, K7s's specification: lane i
    of pos [C,2] and values [C,3] is pixel pix_start + i (lanes from W * H
    on are off the film and ignored), jittered inside it. Adds, in place,
    into every pixel of the [H,W] buffers (rgb [H,W,3], w [H,W]) that the
    chunk can reach, the terms of its neighbours (dy, dx) in [-K, K]^2 in
    that order, each neighbour's sample weighted as ppg_tpu's Film.splat
    weights it where the pixel lies in its window; with sq_buffers, also
    (value * value) * weight and the weights. A pixel sums its terms from
    +0 and adds the sum to its buffers once. Raises ValueError if a
    sample lies outside its own pixel. Returns the buffers."""
    if values.is_cuda:
        COUNTS["film_plain_on_cuda"] += 1
    rgb, w = buffers
    H, W = w.shape
    K, n = _filter_geometry(FILTER_RADIUS[name])
    reach = _reached_rows(W, H, pix_start, values.shape[0], K)
    if reach is None:
        return buffers
    last, y0, rows = reach
    dev, f32 = values.device, torch.float32
    ids = torch.arange(pix_start, last + 1, device=dev)
    own = pos[:last + 1 - pix_start]
    fx, fy = (ids % W).to(f32), torch.div(ids, W, rounding_mode="floor") \
        .to(f32)
    inside = ((own[:, 0] >= fx) & (own[:, 0] <= fx + 1.0)
              & (own[:, 1] >= fy) & (own[:, 1] <= fy + 1.0))
    if not bool(inside.all()):
        raise ValueError("splat_filter_plain: a sample lies outside its "
                         "own pixel")
    py = torch.arange(y0, y0 + rows, device=dev)[:, None].expand(rows, W)
    px = torch.arange(W, device=dev)[None, :].expand(rows, W)
    r = FILTER_RADIUS[name]
    acc = torch.zeros((rows, W, 3), dtype=f32, device=dev)
    acc_w = torch.zeros((rows, W), dtype=f32, device=dev)
    acc_sq = torch.zeros_like(acc) if sq_buffers is not None else None
    for dy in range(-K, K + 1):
        for dx in range(-K, K + 1):
            qx, qy = px + dx, py + dy
            qid = qy * W + qx
            ok = ((qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
                  & (qid >= pix_start) & (qid <= last))
            s = torch.where(ok, qid - pix_start, 0)
            x, y = pos[s, 0], pos[s, 1]
            bx = torch.ceil(x - 0.5 - r).to(torch.int64)
            by = torch.ceil(y - 0.5 - r).to(torch.int64)
            ok = ok & (px >= bx) & (px < bx + n) & (py >= by) & (py < by + n)
            wt = (filter_eval(name, px.to(f32) + 0.5 - x)
                  * filter_eval(name, py.to(f32) + 0.5 - y))
            v = values[s]
            acc += torch.where(ok[..., None], v * wt[..., None], 0.0)
            acc_w += torch.where(ok, wt, 0.0)
            if acc_sq is not None:
                acc_sq += torch.where(ok[..., None], (v * v) * wt[..., None],
                                      0.0)
    for bufs, a in ((buffers, acc), (sq_buffers, acc_sq)):
        if bufs is not None:
            bufs[0][y0:y0 + rows] += a
            bufs[1][y0:y0 + rows] += acc_w
    return buffers


def _launch_filter(name, buffers, pix_start, pos, values, sq_buffers):
    """K7s on the buffers' card. Adds one to COUNTS["film_splat_filter"]."""
    rgb, w = buffers
    card, (H, W), C = rgb.get_device(), w.shape, values.shape[0]
    f32 = torch.float32
    specs = [("rgb", rgb, f32, (H, W, 3)), ("w", w, f32, (H, W)),
             ("pos", pos, f32, (C, 2)), ("values", values, f32, (C, 3))]
    if sq_buffers is not None:
        specs += [("rgb2", sq_buffers[0], f32, (H, W, 3)),
                  ("w2", sq_buffers[1], f32, (H, W))]
    _check("ppg_film_splat_filter", card, *specs)
    if pix_start < 0:
        raise ValueError(f"ppg_film_splat_filter: pixel {pix_start}")
    if pix_start >= W * H or C == 0:
        return buffers  # no lane on the film: nothing to launch
    consts = filter_constants(name)
    rgb2, w2 = sq_buffers if sq_buffers is not None else (None, None)
    lib = _lib or build()
    err = lib.ppg_film_splat_filter(
        rgb.data_ptr(), w.data_ptr(), None if rgb2 is None else rgb2.data_ptr(),
        None if w2 is None else w2.data_ptr(), pos.data_ptr(),
        values.data_ptr(), int(pix_start), C, W, H, _KIND[name],
        FILTER_RADIUS[name], consts.ctypes.data, card, raw_stream(card))
    if err != 0:
        raise RuntimeError(f"ppg_film_splat_filter launch failed: cudaError "
                           f"{err}")
    COUNTS["film_splat_filter"] += 1
    return buffers


class Film:
    """Accumulation buffers: rgb sum and weight sum per pixel."""

    def __init__(self, W, H, rfilter="box", device="cuda"):
        if rfilter not in FILTER_RADIUS:
            raise ValueError(f"unknown rfilter {rfilter!r}")
        self.W, self.H, self.rfilter = W, H, rfilter
        self.device = device

    def zeros(self):
        """[H,W] buffers, for splat."""
        return (torch.zeros((self.H, self.W, 3), dtype=torch.float32,
                            device=self.device),
                torch.zeros((self.H, self.W), dtype=torch.float32,
                            device=self.device))

    def splat(self, buffers, pix_start, sample_pos, values, sq_buffers=None):
        """Adds a chunk of samples into the [H,W] buffers (from zeros)
        with the film's filter, in place: lane i of sample_pos [C,2] and
        values [C,3] is pixel pix_start + i, jittered inside it; lanes from
        W * H on are ignored. With sq_buffers, also the squares. CUDA
        tensors launch K7s once; CPU tensors run splat_filter_plain. Not
        for the box filter (splat_box_linear). Returns the buffers."""
        if self.rfilter == "box":
            raise ValueError("Film.splat: the box filter splats through "
                             "splat_box_linear")
        if values.is_cuda:
            return _launch_filter(self.rfilter, buffers, pix_start,
                                  sample_pos, values, sq_buffers)
        return splat_filter_plain(self.rfilter, buffers, pix_start,
                                  sample_pos, values, sq_buffers)

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

"""Environment emitter (counterpart of ppg_tpu/emitters/envmap.py): a
lat-long radiance map with luminance-CDF direct sampling.

Semantics as in ppg_tpu (Mitsuba's envmap.cpp): the emitter-local
direction d = (sin phi sin theta, cos theta, -cos phi sin theta), uv =
(atan2(x, -z) / 2pi, acos(y) / pi); sampling picks a row and a column
from sin(theta)-weighted luminance CDFs with sample reuse, jitters by a
tent filter and takes the bilinear value and pdf (envmap.cpp:567-601);
the pdf of a direction is the bilinear luminance * rowWeight *
normalisation / sin(theta) (:604-631); the NEE distance is the far hit on
the scene's bounding sphere (radius 1.5 x the half-diagonal, :333-337).

`lookup` (eval_env and pdf_direct for the same directions) and
`sample_direct` launch K10 (csrc/envmap.cu, a persistent grid that
queues the gated-in lanes, --fmad=false) on CUDA tensors and run
`lookup_plain` and `sample_direct_plain`,
the kernel's specification, on CPU tensors. Each takes a lane gate
(`Gate`: the lanes whose int32 key equals a value and whose masks are
set) and gives zeros outside it, and the emitter-slot count n: pdf * (1 /
n) (the reciprocal in float32, as ATen divides by a Python number on a
card) and value * n. The plain version spells each operation out so
that the kernel can repeat it: the rotations as products and sums in a
fixed order, clamps as compare and select, the texel wrap as a floor
modulo, floats to int32 as XLA converts them (saturating, NaN to 0), the
constants as ATen rounds a Python float, and the CUDA math library's
atan2f, acosf, sinf, cosf and sqrtf, which ATen calls on a card. A
failed build or launch raises; a CUDA tensor never runs the plain
version through `lookup` or `sample_direct`. COUNTS: "env_sample" and
"env_lookup" count K10 launches by mode, "env_plain_on_cuda" plain calls
on CUDA tensors (`reset_counts` zeroes them).
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..native import CSRC, load_cuda, raw_stream
from ..scene.textures import _floor_i32

INV_PI = 1.0 / np.pi
INV_TWOPI = 0.5 / np.pi
EPS = 1e-4  # Mitsuba's Epsilon

COUNTS = {"env_sample": 0, "env_lookup": 0, "env_plain_on_cuda": 0}

SAMPLE, LOOKUP = 0, 1
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]
_vp, _ci, _cll, _cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
# mode, img, row_cdf, col_cdf, row_w, consts, H, W, phi and theta scale,
# n, 1 / n; the lanes' directions (lookup) or points (sample) and their
# two strides; ux, its stride, uy, its stride; the gate's key, its
# stride, its value, two masks and their strides; d, dist, pdf, value;
# L, card, stream
ARGTYPES = [_ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _cf, _cf, _cf, _cf,
            _vp, _cll, _cll, _vp, _cll, _vp, _cll, _vp, _cll, _ci, _vp,
            _cll, _vp, _cll, _vp, _vp, _vp, _vp, _cll, _ci, _vp]
_lib = None


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def build():
    """Compile csrc/envmap.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(os.path.join(CSRC, "envmap.cu"), "libppgenvmap",
                     NVCC_FLAGS, {"ppg_env": ARGTYPES})
    return _lib


def _luminance(rgb):
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + \
        rgb[..., 2] * 0.072169


class EnvmapArrays:
    """An environment map's tables on one device:

    img_flat [H*W, 3]  radiance (scale baked in)
    row_cdf  [H+1]     normalised marginal CDF over rows
    col_cdf  [H*(W+1)] each row's conditional CDF, flattened
    row_w    [H]       sin((y + .5) pi / H)
    norm     []        1 / (rowSum * pixelSolidAngle)
    rot, rot_inv [3,3] emitter-local to world and back
    bs_center [3], bs_radius []  the scene's bounding sphere

    as ppg_tpu builds them (numpy float64, then float32), and `consts`
    [23] float32 (norm, rot, rot_inv, bs_center, bs_radius^2 in float32),
    which the kernel reads; `host` holds the same as Python floats for
    the plain version."""

    FIELDS = ("img_flat", "row_cdf", "col_cdf", "row_w", "norm", "rot",
              "rot_inv", "bs_center", "bs_radius")

    def __init__(self, arrays, device):
        for f in self.FIELDS:
            setattr(self, f, torch.from_numpy(arrays[f]).to(device))
        self.H = int(arrays["row_w"].shape[0])
        self.W = int(arrays["img_flat"].shape[0]) // self.H
        r = arrays["bs_radius"]
        c = np.concatenate([arrays["norm"].reshape(1),
                            arrays["rot"].reshape(-1),
                            arrays["rot_inv"].reshape(-1),
                            arrays["bs_center"], (r * r).reshape(1)])
        self.host = [float(x) for x in c]
        self.consts = torch.from_numpy(c).to(device)
        # the scales of a pixel's centre to its angles, float32 as ATen
        # rounds the Python floats 2 pi / W and pi / H
        self.phi_scale = float(np.float32(2 * np.pi / self.W))
        self.theta_scale = float(np.float32(np.pi / self.H))

    @staticmethod
    def arrays(img, to_world_rot, aabb_min, aabb_max):
        """The tables of ppg_tpu's EnvmapArrays.from_image (numpy
        float32); raises ValueError on a black map."""
        img = np.asarray(img, np.float32)
        H, W = img.shape[:2]
        lum = np.asarray(_luminance(img), np.float64)
        row_w = np.sin((np.arange(H) + 0.5) * np.pi / H)
        col_sum = lum.sum(axis=1)
        col_cdf = np.zeros((H, W + 1), np.float64)
        col_cdf[:, 1:] = np.cumsum(lum, axis=1)
        col_cdf /= np.maximum(col_sum, 1e-300)[:, None]
        col_cdf[:, -1] = 1.0
        row_sum = float((col_sum * row_w).sum())
        if row_sum <= 0:
            raise ValueError("environment map is completely black")
        row_cdf = np.zeros(H + 1, np.float64)
        row_cdf[1:] = np.cumsum(col_sum * row_w)
        row_cdf /= row_sum
        row_cdf[-1] = 1.0
        norm = 1.0 / (row_sum * (2 * np.pi / W) * (np.pi / H))
        center = (np.asarray(aabb_min) + np.asarray(aabb_max)) * 0.5
        radius = max(EPS, float(np.linalg.norm(np.asarray(aabb_max) - center))
                     * 1.5)
        rot = np.asarray(to_world_rot, np.float64)[:3, :3]
        f32 = lambda x: np.array(x, np.float32, order="C")
        return dict(img_flat=f32(img.reshape(H * W, 3)), row_cdf=f32(row_cdf),
                    col_cdf=f32(col_cdf.reshape(-1)), row_w=f32(row_w),
                    norm=f32(norm), rot=f32(rot),
                    rot_inv=f32(np.linalg.inv(rot)), bs_center=f32(center),
                    bs_radius=f32(radius))

    @classmethod
    def from_image(cls, img, to_world_rot, aabb_min, aabb_max, device):
        return cls(cls.arrays(img, to_world_rot, aabb_min, aabb_max), device)


def env_image(spec, scene_dir):
    """The lat-long radiance map [H, W, 3] of an <emitter> PluginSpec of
    type envmap, constant, sky, sun or sunsky (ppg_tpu's
    build_env_from_spec)."""
    t, p = spec.otype, spec.props
    if t in ("sky", "sun", "sunsky"):
        from .sunsky import rasterize_sun_sky

        return rasterize_sun_sky(p, t)
    if t == "envmap":
        from ..scene.textures import load_texture

        fn = p["filename"]
        path = fn if os.path.isabs(fn) else os.path.join(scene_dir, fn)
        img = load_texture(path, float(p.get("gamma", 0.0)))
        return img * float(p.get("scale", 1.0))
    if t == "constant":
        rad = p.get("radiance", 1.0)
        rad = [float(rad)] * 3 if np.isscalar(rad) else np.asarray(rad)
        return np.broadcast_to(np.asarray(rad, np.float32), (32, 64, 3)).copy()
    raise NotImplementedError(f"environment emitter type {t!r}")


# the host tables of the last few sun and sky emitters built (a 4096
# sunsky's raster and tables take seconds): key -> EnvmapArrays.arrays
_SKY_TABLES = {}
_SKY_TABLES_KEPT = 2


def build_env_from_spec(spec, scene_dir, aabb_min, aabb_max, device):
    """EnvmapArrays of an <emitter> PluginSpec of type envmap, constant,
    sky, sun or sunsky. A sun or sky emitter's tables are kept for the
    next scene with the same emitter and bounds."""
    rot = np.asarray(spec.props.get("toWorld", np.eye(4)))[:3, :3]
    key = None
    if spec.otype in ("sky", "sun", "sunsky"):
        key = (spec.otype, repr(sorted(spec.props.items())),
               tuple(np.asarray(aabb_min, np.float64)),
               tuple(np.asarray(aabb_max, np.float64)))
    arrays = _SKY_TABLES.get(key)
    if arrays is None:
        arrays = EnvmapArrays.arrays(env_image(spec, scene_dir), rot,
                                     aabb_min, aabb_max)
        if key is not None:
            while len(_SKY_TABLES) >= _SKY_TABLES_KEPT:
                del _SKY_TABLES[next(iter(_SKY_TABLES))]
            _SKY_TABLES[key] = arrays
    return EnvmapArrays(arrays, device)


class Gate(NamedTuple):
    """The lanes a K10 call computes: key[i] == key_val where key (int32
    [L]) is given, and m1[i] and m2[i] where those bool [L] masks are
    given. The others get zeros."""
    key: Optional[torch.Tensor] = None
    key_val: int = 0
    m1: Optional[torch.Tensor] = None
    m2: Optional[torch.Tensor] = None


def gate_mask(gate, L, device):
    """The lanes a Gate lets in, bool [L] (None: every lane)."""
    if gate is None:
        return None
    m = None
    for x in ((gate.key == gate.key_val) if gate.key is not None else None,
              gate.m1, gate.m2):
        if x is not None:
            m = x if m is None else m & x
    return m if m is not None else torch.ones(L, dtype=torch.bool,
                                              device=device)


def _recip(n):
    """1 / n in float32, as ATen divides by a Python number on a card."""
    return float(np.float32(1.0) / np.float32(n))


# ---------------------------------------------------------------------------
# the plain versions (the kernel's specification)
# ---------------------------------------------------------------------------

def _lt(x, c):
    """max(x, c) as compare and select: a NaN x passes."""
    return torch.where(x < c, c, x)


def _clip(x, lo, hi):
    x = torch.where(x < lo, lo, x)
    return torch.where(x > hi, hi, x)


def _rotate(m, v):
    """m [9] (row-major, Python floats) times each v [L, 3]: each row's
    products summed left to right."""
    return [v[:, 0] * m[3 * i] + v[:, 1] * m[3 * i + 1]
            + v[:, 2] * m[3 * i + 2] for i in range(3)]


def _texel(env, x, y):
    """Texels (x wrapped by a floor modulo, y clamped to [0, H-1])."""
    xi = torch.remainder(x, env.W)
    yi = torch.clamp(y, 0, env.H - 1)
    return env.img_flat[(yi.long() * env.W + xi.long())]


def _bilerp_rows(env, x0, y, dx1):
    """One bilinear row: texel(x0, y) (1 - dx1) + texel(x0 + 1, y) dx1."""
    a = _texel(env, x0, y)
    b = _texel(env, x0 + 1, y)
    return a * (1.0 - dx1)[:, None] + b * dx1[:, None]


def _bilinear_parts(env, x, y):
    """(v1, v2, y0) of the bilinear lookup at texel coordinates (x, y):
    v1 the row y0's value times 1 - dy, v2 the row y0 + 1's times dy."""
    x0, y0 = _floor_i32(x), _floor_i32(y)
    dx1 = x - x0.to(torch.float32)
    dy1 = y - y0.to(torch.float32)
    v1 = _bilerp_rows(env, x0, y0, dx1) * (1.0 - dy1)[:, None]
    v2 = _bilerp_rows(env, x0, y0 + 1, dx1) * dy1[:, None]
    return v1, v2, y0


def _row_pdf(env, v1, v2, y0):
    """lum(v1) rowWeight(y0) + lum(v2) rowWeight(y0 + 1)."""
    rw0 = env.row_w[torch.clamp(y0, 0, env.H - 1).long()]
    rw1 = env.row_w[torch.clamp(y0 + 1, 0, env.H - 1).long()]
    return _luminance(v1) * rw0 + _luminance(v2) * rw1


def _gated(gate, x, L, device):
    m = gate_mask(gate, L, device)
    if m is None:
        return x
    return torch.where(m.reshape((L,) + (1,) * (x.dim() - 1)), x, 0.0)


def lookup_plain(env, d, gate=None, n_slots=1):
    """(value [L,3], pdf [L]) of directions d [L,3] escaping the scene:
    ppg_tpu's eval_env (the bilinear radiance) and pdf_direct (the
    solid-angle pdf of sample_direct giving d) times 1 / n_slots; zeros
    outside the gate."""
    if d.is_cuda:
        COUNTS["env_plain_on_cuda"] += 1
    c = env.host
    dl0, dl1, dl2 = _rotate(c[10:19], d)
    u = torch.atan2(dl0, -dl2) * INV_TWOPI
    u = torch.where(u < 0, u + 1.0, u)
    v = torch.acos(_clip(dl1, -1.0, 1.0)) * INV_PI
    v1, v2, y0 = _bilinear_parts(env, u * env.W - 0.5, v * env.H - 0.5)
    value = v1 + v2
    st = torch.sqrt(_clip(1.0 - dl1 * dl1, 0.0, 1.0))
    pdf = _row_pdf(env, v1, v2, y0) * c[0] / _lt(st, EPS) * _recip(n_slots)
    L = d.shape[0]
    return _gated(gate, value, L, d.device), _gated(gate, pdf, L, d.device)


def _sample_cdf(cdf, base, size, u):
    """Inversion of cdf[base : base + size + 1] (ascending, 0..1) at u:
    (index, rescaled remainder), DiscretePDF::sampleReuse
    (envmap.cpp:681-687), by ppg_tpu's binary search: ceil(log2 size) + 1
    rounds, after which hi - lo <= 1 and lo no longer moves."""
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, size)
    for _ in range(max(1, math.ceil(math.log2(max(size, 2)))) + 1):
        mid = (lo + hi) >> 1
        go_hi = u >= cdf[(base + mid).long()]
        lo = torch.where(go_hi & (mid > lo), mid, lo)
        hi = torch.where(~go_hi & (mid < hi), mid, hi)
    idx = torch.clamp(lo, 0, size - 1)
    c0 = cdf[(base + idx).long()]
    c1 = cdf[(base + idx + 1).long()]
    rem = _clip((u - c0) / _lt(c1 - c0, 1e-20), 0.0, 1.0)
    return idx, rem


def _interval_to_tent(x):
    """warp::intervalToTent: the inverse CDF of the tent on [-1, 1]."""
    neg = x < 0.5
    x2 = torch.where(neg, 1.0 - 2.0 * x, 2.0 * x - 1.0)
    t = 1.0 - torch.sqrt(_clip(1.0 - x2, 0.0, 1.0))
    return torch.where(neg, -t, t)


def sample_direct_plain(env, ref_p, ux, uy, gate=None, n_slots=1):
    """NEE sample toward the environment from ref_p [L,3] with the
    uniforms ux (the column's) and uy (the row's), each [L] (envmap.cpp
    sampleDirect): dict(d, dist -- the far hit on the bounding sphere --,
    pdf -- solid angle, times 1 / n_slots --, value = radiance / pdf,
    times n_slots); pdf and value 0 where the sample fails (pdf 0, or
    ref_p outside the bounding sphere); every output 0 outside the
    gate."""
    if ref_p.is_cuda:
        COUNTS["env_plain_on_cuda"] += 1
    H, W, c = env.H, env.W, env.host
    zero = torch.zeros(ref_p.shape[0], dtype=torch.int32, device=ref_p.device)
    row, ry = _sample_cdf(env.row_cdf, zero, H, uy)
    col, rx = _sample_cdf(env.col_cdf, row * (W + 1), W, ux)
    px = col.to(torch.float32) + _interval_to_tent(rx)
    py = row.to(torch.float32) + _interval_to_tent(ry)
    v1, v2, y0 = _bilinear_parts(env, px, py)
    value = v1 + v2
    pdf = _row_pdf(env, v1, v2, y0) * c[0]
    phi = (px + 0.5) * env.phi_scale
    theta = (py + 0.5) * env.theta_scale
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    pdf = pdf / _lt(st.abs(), EPS)
    dl = torch.stack([sp * st, ct, -cp * st], -1)
    d = torch.stack(_rotate(c[1:10], dl), -1)
    # the far hit on the scene's bounding sphere: the shadow ray's length
    oc = [ref_p[:, i] - c[19 + i] for i in range(3)]
    b = oc[0] * d[:, 0] + oc[1] * d[:, 1] + oc[2] * d[:, 2]
    cc = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]) - c[22]
    disc = b * b - cc
    sq = torch.sqrt(torch.where(disc < 0.0, 0.0, disc))
    near, far = -b - sq, -b + sq
    ok = (disc > 0) & (near < 0) & (far > 0) & (pdf > 0)
    pdf = torch.where(ok, pdf, 0.0)
    value = torch.where(ok[:, None], value / _lt(pdf, 1e-30)[:, None], 0.0)
    L, dev = ref_p.shape[0], ref_p.device
    return dict(d=_gated(gate, d, L, dev), dist=_gated(gate, far, L, dev),
                pdf=_gated(gate, pdf * _recip(n_slots), L, dev),
                value=_gated(gate, value * float(n_slots), L, dev))


# ---------------------------------------------------------------------------
# the entry points: K10 on a card
# ---------------------------------------------------------------------------

def lookup(env, d, gate=None, n_slots=1):
    """lookup_plain's (value, pdf); CUDA tensors launch K10 once."""
    if d.is_cuda:
        return _launch(LOOKUP, env, d, None, None, gate, n_slots)
    return lookup_plain(env, d, gate, n_slots)


def eval_env(env, d):
    """Radiance [L,3] for rays escaping in d [L,3] (bilinear lookup)."""
    return lookup(env, d)[0]


def pdf_direct(env, d):
    """Solid-angle pdf [L] of sample_direct having produced d [L,3]."""
    return lookup(env, d)[1]


def sample_direct(env, ref_p, ux, uy, gate=None, n_slots=1):
    """sample_direct_plain's dict; CUDA tensors launch K10 once."""
    if ref_p.is_cuda:
        return _launch(SAMPLE, env, ref_p, ux, uy, gate, n_slots)
    return sample_direct_plain(env, ref_p, ux, uy, gate, n_slots)


def kernel_args(mode, env, x, ux, uy, gate, n_slots):
    """The C entry point's arguments but the outputs, L, card and stream;
    raises ValueError on a tensor it does not take."""
    L = x.shape[0]
    g = gate if gate is not None else Gate()
    want = [("x", x, torch.float32, (L, 3)), ("img", env.img_flat,
                                              torch.float32, None)]
    if mode == SAMPLE:
        want += [("ux", ux, torch.float32, (L,)), ("uy", uy, torch.float32,
                                                   (L,))]
    want += [(n, t, dt, (L,)) for n, t, dt in (
        ("key", g.key, torch.int32), ("m1", g.m1, torch.bool),
        ("m2", g.m2, torch.bool)) if t is not None]
    bad = [f"{n} {t.dtype} {tuple(t.shape)} on {t.device}"
           for n, t, dt, shape in want
           if t.dtype != dt or (shape is not None and tuple(t.shape) != shape)
           or t.device != env.img_flat.device]
    if bad or not 0 < n_slots < 1 << 24:
        raise ValueError(
            f"ppg_env: want x float32 ({L}, 3), ux and uy float32 ({L},) in "
            f"sample mode, a gate's key int32 and masks bool ({L},), all on "
            f"{env.img_flat.device}, and 0 < n_slots < 2^24; got "
            + "; ".join(bad + [f"n_slots {n_slots}"]))
    ptr = lambda t: None if t is None else t.data_ptr()
    st = lambda t: 0 if t is None else t.stride(0)
    return [mode, env.img_flat.data_ptr(), env.row_cdf.data_ptr(),
            env.col_cdf.data_ptr(), env.row_w.data_ptr(),
            env.consts.data_ptr(), env.H, env.W, env.phi_scale,
            env.theta_scale, float(n_slots), _recip(n_slots),
            x.data_ptr(), x.stride(0), x.stride(1), ptr(ux), st(ux), ptr(uy),
            st(uy), ptr(g.key), st(g.key), int(g.key_val), ptr(g.m1),
            st(g.m1), ptr(g.m2), st(g.m2)]


def _launch(mode, env, x, ux, uy, gate, n_slots):
    """K10 on x's card in `mode`: SAMPLE gives sample_direct_plain's dict,
    LOOKUP lookup_plain's (value, pdf). Adds one to COUNTS["env_sample"]
    or COUNTS["env_lookup"]."""
    args = kernel_args(mode, env, x, ux, uy, gate, n_slots)
    L, card = x.shape[0], x.get_device()
    new = lambda *s: torch.empty((L,) + s, dtype=torch.float32,
                                 device=x.device)
    value, pdf = new(3), new()
    d, dist = (new(3), new()) if mode == SAMPLE else (None, None)
    lib = _lib or build()
    err = lib.ppg_env(*args, None if d is None else d.data_ptr(),
                      None if dist is None else dist.data_ptr(),
                      pdf.data_ptr(), value.data_ptr(), L, card,
                      raw_stream(card))
    if err != 0:
        raise RuntimeError(f"ppg_env launch failed: cudaError {err}")
    if mode == SAMPLE:
        COUNTS["env_sample"] += 1
        return dict(d=d, dist=dist, pdf=pdf, value=value)
    COUNTS["env_lookup"] += 1
    return value, pdf

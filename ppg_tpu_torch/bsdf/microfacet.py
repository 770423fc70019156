"""Microfacet normal distributions, Beckmann and GGX (counterpart of
ppg_tpu/bsdf/microfacet.py): D (microfacet.h:191-233), Smith's G1 with
the Beckmann rational approximation (:477-514), the projected roughness
(:541-551), the full distribution's sampling (:287-397) and the visible
normals' sampling with its pdf, pdfVisible = G1(wi,m) |wi.m| D(m) /
|cos(wi)| (:465-470).

sample_visible launches K8 (csrc/microfacet.cu: a persistent grid whose
blocks queue each tile's gated-in lanes by distribution, so that a warp
runs one branch) on CUDA tensors and runs sample_visible_plain, the
kernel's specification, on CPU tensors: the stretch, the alpha = 1 slope
sample (GGX in Heitz's closed form; Beckmann by 12 erf-domain
bisection-Newton rounds, with the normal-incidence case), the rotation,
the unstretch and the normalisation. With a gate (mtype, fams), only the
lanes whose family mtype has its bit set in the mask fams are sampled;
the others get m = (0, 0, 1). The plain version spells each operation
out so that the kernel, built with --fmad=false, can repeat it: sums of
squares in a fixed order, clamps as compare and select (which pass a NaN
on), a reciprocal as 1 / x. On a card ATen's erf, erfinv, exp, pow, tan,
acos, atan2, sin, cos, log and sqrt are the CUDA math library's erff,
erfinvf (PyTorch compiles its CUDA erfinv from `erfinv(a)`, not from the
CPU's calc_erfinv), expf, powf, tanf, acosf, atan2f, sinf, cosf, logf
and sqrtf, which the kernel calls, so the two agree bit for bit. The
library is built with nvcc at first use into build/ppg_tpu_torch/
(native.load_cuda); a failed build or launch raises, and a CUDA tensor
never runs the plain version through sample_visible. COUNTS:
"vndf_kernel" counts K8 launches, "vndf_plain_on_cuda" plain samples run
on CUDA tensors (`reset_counts` zeroes them).
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from ..native import CSRC, load_cuda, raw_stream

INV_PI = 1.0 / math.pi
SQRT_PI_INV = 1.0 / math.sqrt(math.pi)
TWO_PI = 2.0 * math.pi

BECKMANN, GGX = 0, 1
# the Beckmann sampler's bisection-Newton rounds (microfacet.h:573-650)
ROUNDS = 12
# erfinv's argument stays strictly inside (-1, 1)
ERF_EDGE = 0.9999999

COUNTS = {"vndf_kernel": 0, "vndf_plain_on_cuda": 0}

_SRC = os.path.join(CSRC, "microfacet.cu")
# --fmad=false: each product and sum rounded on its own, as the plain
# version's separate operations round them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# wi, wi strides (2), u, u strides (2), alpha_u, its stride, alpha_v, its
# stride, dist, its stride, mtype (or null), its stride, fams, m, L, card,
# stream
ARGTYPES = [_vp, _cll, _cll, _vp, _cll, _cll, _vp, _cll, _vp, _cll, _vp,
            _cll, _vp, _cll, ctypes.c_uint, _vp, _cll, _ci, _vp]
_lib = None


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def build():
    """Compile csrc/microfacet.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(_SRC, "libppgmicrofacet", NVCC_FLAGS,
                     {"ppg_vndf_sample": ARGTYPES})
    return _lib


def _cos2(m):
    return m[..., 2] * m[..., 2]


def eval_d(dist, alpha_u, alpha_v, m):
    """Microfacet density D(m)."""
    c2 = _cos2(m)
    safe_c2 = torch.clamp(c2, min=1e-20)
    bexp = ((m[..., 0] ** 2) / (alpha_u * alpha_u)
            + (m[..., 1] ** 2) / (alpha_v * alpha_v)) / safe_c2
    beck = torch.exp(-bexp) / (math.pi * alpha_u * alpha_v * safe_c2
                               * safe_c2)
    root = (1.0 + bexp) * safe_c2
    ggx = 1.0 / (math.pi * alpha_u * alpha_v * root * root)
    d = torch.where(dist == GGX, ggx, beck)
    d = torch.where(m[..., 2] <= 0, 0.0, d)
    return torch.where(d * m[..., 2] < 1e-20, 0.0, d)


def _project_roughness(alpha_u, alpha_v, v):
    sin2 = torch.clamp(1.0 - v[..., 2] ** 2, min=1e-20)
    inv = 1.0 / sin2
    cos_phi2 = v[..., 0] ** 2 * inv
    sin_phi2 = v[..., 1] ** 2 * inv
    aniso = torch.sqrt(cos_phi2 * alpha_u ** 2 + sin_phi2 * alpha_v ** 2)
    return torch.where(torch.abs(alpha_u - alpha_v) < 1e-7, alpha_u, aniso)


def smith_g1(dist, alpha_u, alpha_v, v, m):
    """Smith's masking term for one direction."""
    back = (v * m).sum(-1) * v[..., 2] <= 0
    cos_v = torch.clamp(torch.abs(v[..., 2]), 1e-8, 1.0)
    tan_theta = torch.sqrt(torch.clamp(1.0 - cos_v * cos_v, min=0.0)) / cos_v
    alpha = _project_roughness(alpha_u, alpha_v, v)
    a = 1.0 / torch.clamp(alpha * tan_theta, min=1e-12)
    a2 = a * a
    beck = torch.where(a >= 1.6, 1.0, (3.535 * a + 2.181 * a2)
                       / (1.0 + 2.276 * a + 2.577 * a2))
    root = alpha * tan_theta
    ggx = 2.0 / (1.0 + torch.sqrt(1.0 + root * root))
    g = torch.where(dist == GGX, ggx, beck)
    g = torch.where(tan_theta == 0.0, 1.0, g)
    return torch.where(back, 0.0, g)


def g_smith(dist, alpha_u, alpha_v, wi, wo, m):
    return smith_g1(dist, alpha_u, alpha_v, wi, m) * smith_g1(
        dist, alpha_u, alpha_v, wo, m)


def pdf_visible(dist, alpha_u, alpha_v, wi, m):
    cos_i = wi[..., 2]
    g1 = smith_g1(dist, alpha_u, alpha_v, wi, m)
    d = eval_d(dist, alpha_u, alpha_v, m)
    p = g1 * torch.abs((wi * m).sum(-1)) * d / torch.clamp(
        torch.abs(cos_i), min=1e-12)
    return torch.where(cos_i == 0.0, 0.0, p)


def _lt(x, c):
    """max(x, c) as compare and select: a NaN x stays NaN."""
    return torch.where(x < c, c, x)


def _gt(x, c):
    """min(x, c) as compare and select: a NaN x stays NaN."""
    return torch.where(x > c, c, x)


def _clip(x, lo, hi):
    return _gt(_lt(x, lo), hi)


def _slope_11(dist, theta, u1, u2):
    """The alpha = 1 slope sample (ppg_tpu's _sample_visible_11, :90):
    both branches over every lane, then the lane's distribution's."""
    # GGX: Heitz's closed form (JCGT 2018, "Sampling the GGX Distribution
    # of Visible Normals") for the stretched wi = (sin theta, 0, cos
    # theta): the disk's basis T1 = (0, 1, 0), perpendicular to wi and
    # horizontal, and T2 = wi x T1 = (-cos theta, 0, sin theta), along
    # which the disk is squeezed to the visible part of the hemisphere.
    # (ppg_tpu's basis puts T1 in the plane of incidence and squeezes
    # along y, which lands about 1% of oblique samples beyond the
    # horizon.)
    wix, wiz = torch.sin(theta), torch.cos(theta)
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + wiz)
    p2 = (1.0 - s) * torch.sqrt(_lt(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(_lt(1.0 - p1 * p1 - p2 * p2, 0.0))
    nx = p3 * wix - p2 * wiz
    nz = _lt(p2 * wix + p3 * wiz, 1e-8)
    ggx_x, ggx_y = -nx / nz, -p1 / nz

    # Beckmann: the erf-domain bisection-Newton rounds
    tan_ti = torch.tan(theta)
    cot = 1.0 / _lt(tan_ti, 1e-12)
    c = torch.erf(cot)
    ux = _lt(u1, 1e-6)
    fit = 1.0 + theta * (-0.876 + theta * (0.4265 - 0.0594 * theta))
    b = c - (1.0 + c) * torch.pow(1.0 - ux, fit)
    k = SQRT_PI_INV * tan_ti
    norm = 1.0 / (1.0 + c + k * torch.exp(-cot * cot))
    a, cc = torch.full_like(b, -1.0), c
    for _ in range(ROUNDS):
        b = torch.where((b >= a) & (b <= cc), b, 0.5 * (a + cc))
        ie = torch.erfinv(_clip(b, -ERF_EDGE, ERF_EDGE))
        value = (1.0 + b + k * torch.exp(-ie * ie)) * norm - ux
        below = value <= 0
        a = torch.where(below, b, a)
        cc = torch.where(below, cc, b)
        deriv = (1.0 - ie * tan_ti) * norm
        b = b - value / torch.where(torch.abs(deriv) < 1e-12, 1.0, deriv)
    b = _gt(_lt(b, -ERF_EDGE), _gt(c, ERF_EDGE))
    beck_x = torch.erfinv(b)
    beck_y = torch.erfinv(_clip(2.0 * _lt(u2, 1e-6) - 1.0, -ERF_EDGE,
                                ERF_EDGE))
    # normal incidence
    near0 = theta < 1e-4
    r0 = torch.sqrt(_lt(-torch.log(1.0 - u1), 0.0))
    phi0 = TWO_PI * u2
    beck_x = torch.where(near0, r0 * torch.cos(phi0), beck_x)
    beck_y = torch.where(near0, r0 * torch.sin(phi0), beck_y)
    ggx = dist == GGX
    return torch.where(ggx, ggx_x, beck_x), torch.where(ggx, ggx_y, beck_y)


def gate_mask(mtype, fams):
    """The lanes a gate (mtype, fams) samples: bool [L], True where bit
    mtype of the mask fams is set."""
    return torch.isin(mtype, torch.tensor(
        [t for t in range(32) if fams >> t & 1], dtype=torch.int32,
        device=mtype.device))


def sample_visible_plain(dist, alpha_u, alpha_v, wi, u, gate=None):
    """Visible normal m [L,3] (microfacet.h:428-463) for dist [L] int32
    (BECKMANN or GGX), alpha_u, alpha_v [L], wi [L,3] and the uniforms
    u [L,2] (columns 0 and 1 of any strided view). With gate = (mtype [L]
    int32, fams), the lanes outside gate_mask get (0, 0, 1)."""
    if wi.is_cuda:
        COUNTS["vndf_plain_on_cuda"] += 1
    sx, sy, sz = alpha_u * wi[:, 0], alpha_v * wi[:, 1], wi[:, 2]
    n = torch.sqrt(sx * sx + sy * sy + sz * sz)
    sx, sy, sz = sx / n, sy / n, sz / n
    z = _clip(sz, -1.0, 1.0)
    tilt = z < 0.99999
    theta = torch.where(tilt, torch.acos(z), 0.0)
    phi = torch.where(tilt, torch.atan2(sy, sx), 0.0)
    sp, cp = torch.sin(phi), torch.cos(phi)
    slope_x, slope_y = _slope_11(dist, theta, u[:, 0], u[:, 1])
    mx = (cp * slope_x - sp * slope_y) * alpha_u
    my = (sp * slope_x + cp * slope_y) * alpha_v
    inv = 1.0 / torch.sqrt(mx * mx + my * my + 1.0)
    m = torch.stack([-mx * inv, -my * inv, inv], -1)
    if gate is None:
        return m
    return torch.where(gate_mask(*gate)[:, None], m,
                       m.new_tensor([0.0, 0.0, 1.0]))


def sample_visible(dist, alpha_u, alpha_v, wi, u, gate=None):
    """sample_visible_plain's m; CUDA tensors launch K8 once."""
    if wi.is_cuda:
        return _launch(dist, alpha_u, alpha_v, wi, u, gate)
    return sample_visible_plain(dist, alpha_u, alpha_v, wi, u, gate)


def _launch(dist, alpha_u, alpha_v, wi, u, gate=None):
    """K8 on wi's card: every input read through the strides it is given,
    the gate's mtype too (which the kernel reads itself). Adds one to
    COUNTS["vndf_kernel"]."""
    L = wi.shape[0]
    card = wi.get_device()
    mtype, fams = gate if gate is not None else (None, 0)
    bad = [f"{name} {t.dtype} {tuple(t.shape)} on {t.device}"
           for name, t, dtype, shape in (
               ("wi", wi, torch.float32, (L, 3)),
               ("u", u, torch.float32, (L, 2)),
               ("alpha_u", alpha_u, torch.float32, (L,)),
               ("alpha_v", alpha_v, torch.float32, (L,)),
               ("dist", dist, torch.int32, (L,)),
               ("mtype", mtype, torch.int32, (L,)))
           if t is not None and not (
               t.dtype == dtype and tuple(t.shape) == shape and t.is_cuda
               and t.get_device() == card)]
    if not (isinstance(fams, int) and 0 <= fams < 1 << 32):
        bad.append(f"fams {fams!r}")
    if bad:
        raise ValueError(
            f"ppg_vndf_sample: want wi float32 ({L}, 3), u float32 ({L}, "
            f"2), alpha_u, alpha_v float32 ({L},), dist int32 ({L},) on "
            f"cuda:{card}, and a gate of mtype int32 ({L},) there and a "
            f"32-bit mask; got " + "; ".join(bad))
    m = torch.empty((L, 3), dtype=torch.float32, device=wi.device)
    lib = _lib or build()
    err = lib.ppg_vndf_sample(
        wi.data_ptr(), wi.stride(0), wi.stride(1), u.data_ptr(),
        u.stride(0), u.stride(1), alpha_u.data_ptr(), alpha_u.stride(0),
        alpha_v.data_ptr(), alpha_v.stride(0), dist.data_ptr(),
        dist.stride(0), None if mtype is None else mtype.data_ptr(),
        0 if mtype is None else mtype.stride(0), fams, m.data_ptr(), L,
        card, raw_stream(card))
    if err != 0:
        raise RuntimeError(f"ppg_vndf_sample launch failed: cudaError {err}")
    COUNTS["vndf_kernel"] += 1
    return m


def sample_all(dist, alpha_u, alpha_v, u):
    """Sample the full (cosine-weighted) distribution D(m) cos; the
    isotropic-alpha path (microfacet.h:287-345). Returns (m, pdf)."""
    u1, u2 = u[..., 0], u[..., 1]
    phi = TWO_PI * u2
    a2 = alpha_u * alpha_u
    tan2_b = a2 * -torch.log(torch.clamp(1.0 - u1, min=1e-20))
    cos_b = 1.0 / torch.sqrt(1.0 + tan2_b)
    pdf_b = (1.0 - u1) / torch.clamp(
        math.pi * alpha_u * alpha_v * cos_b ** 3, min=1e-30)
    tan2_g = a2 * u1 / torch.clamp(1.0 - u1, min=1e-12)
    cos_g = 1.0 / torch.sqrt(1.0 + tan2_g)
    temp = 1.0 + tan2_g / a2
    pdf_g = INV_PI / torch.clamp(
        alpha_u * alpha_v * cos_g ** 3 * temp * temp, min=1e-30)
    cos_t = torch.where(dist == GGX, cos_g, cos_b)
    pdf = torch.where(dist == GGX, pdf_g, pdf_b)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    m = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                    -1)
    return m, torch.where(pdf < 1e-20, 0.0, pdf)


def pdf_all(dist, alpha_u, alpha_v, m):
    return eval_d(dist, alpha_u, alpha_v, m) * m[..., 2]


def pdf_m(dist, alpha_u, alpha_v, wi, m, visible):
    return torch.where(visible, pdf_visible(dist, alpha_u, alpha_v, wi, m),
                       pdf_all(dist, alpha_u, alpha_v, m))


def sample_m(dist, alpha_u, alpha_v, wi, u, visible):
    m_vis = sample_visible(dist, alpha_u, alpha_v, wi, u)
    m_all, _ = sample_all(dist, alpha_u, alpha_v, u)
    return torch.where(visible[..., None], m_vis, m_all)

"""The BSDF table (counterpart of ppg_tpu/bsdf/bsdf.py): every lane carries
a material row index, and each family present in the scene is evaluated
over the wavefront and selected per lane. Conventions follow Mitsuba as
in ppg_tpu:

  sample(u) -> (wo, weight = f*cos/pdf, pdf, sampled_delta, eta)
               (pdf is the discrete lobe probability for delta lobes)
  eval()    -> f * cos(theta_o) of the smooth components (solid angle)
  pdf()     -> solid-angle pdf of the smooth components of sample()

The leaf families (reference sources in src/bsdfs/): diffuse,
roughdiffuse, ward, difftrans, phong, conductor, dielectric,
thindielectric, roughconductor, plastic, roughplastic, roughdielectric
and hk, with twosided as a per-row frame flip; null passes the ray
through. The wrapper families (mask, blend, coating, roughcoating) are
composed at the shading site over these leaf rows (wrappers.py,
layered.py); MaterialArrays resolves their rows once. Textures are not
ported: MaterialArrays.from_table refuses a scene that has them.

sample_bsdf draws one visible normal per call: each roughconductor,
roughplastic and roughdielectric lane picks its family's (alpha_u,
alpha_v, wi, u), and microfacet.sample_visible runs once (K8 on a card),
gated to those families' lanes: the others get (0, 0, 1), which their
families never read. The function is elementwise, so each lane gets the
bits that three per-family calls give it.

Unlike ppg_tpu, roughdielectric samples wi below the surface as
Mitsuba's roughdielectric.cpp does: the visible normal of -wi, kept on
the upper side, with the Fresnel term and refraction of wi's own side;
its pdf is the density of those samples (ROADMAP Queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import warp
from ..scene.scene import (
    MAT_BLEND,
    MAT_COATING,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DIFFTRANS,
    MAT_DIFFUSE,
    MAT_HK,
    MAT_MASK,
    MAT_NAMES,
    MAT_NULL,
    MAT_PHONG,
    MAT_PLASTIC,
    MAT_ROUGHCOATING,
    MAT_ROUGHCONDUCTOR,
    MAT_ROUGHDIELECTRIC,
    MAT_ROUGHDIFFUSE,
    MAT_ROUGHPLASTIC,
    MAT_THINDIELECTRIC,
    MAT_WARD,
)
from . import microfacet as MF
from .fresnel import fresnel_conductor_exact, fresnel_dielectric_ext

INV_PI = 1.0 / math.pi
RT_BINS = 64

# families with a smooth lobe (BSDF::ESmooth): guiding applies
SMOOTH_TYPES = (MAT_DIFFUSE, MAT_ROUGHDIFFUSE, MAT_ROUGHCONDUCTOR,
                MAT_ROUGHDIELECTRIC, MAT_PLASTIC, MAT_ROUGHPLASTIC, MAT_PHONG,
                MAT_WARD, MAT_DIFFTRANS, MAT_BLEND, MAT_HK, MAT_ROUGHCOATING)
# delta-only families: guiding bypassed (guided_path.cpp:1654)
DELTA_TYPES = (MAT_CONDUCTOR, MAT_DIELECTRIC, MAT_THINDIELECTRIC)
# families with transmission or backside lobes: NEE refN = 0
# (records.inl:160-164; twosided adds EBackSide)
TRANSMISSIVE_TYPES = (MAT_DIELECTRIC, MAT_THINDIELECTRIC,
                      MAT_ROUGHDIELECTRIC, MAT_MASK, MAT_NULL, MAT_DIFFTRANS,
                      MAT_HK)
# the material wrappers (wrappers.py)
WRAPPER_TYPES = (MAT_MASK, MAT_NULL, MAT_BLEND, MAT_COATING,
                 MAT_ROUGHCOATING)
# microfacet families, each with its visible-normal sample
_MF_TYPES = (MAT_ROUGHCONDUCTOR, MAT_ROUGHPLASTIC, MAT_ROUGHDIELECTRIC)


class MaterialArrays:
    """Per-material parameters packed into one [M, WIDTH] float32 matrix,
    ppg_tpu's layout: a lane's parameters are one row gather, and its
    fields are views of the row (integer fields stored as their bits,
    bools as 0.0 / 1.0). `present` is the static set of families in the
    scene: absent families cost no launch. `flags` [5, M] bool holds each
    row's lane flags (smooth, delta-only, null, transmissive, twosided),
    gathered with the row; a wrapper row's are its resolution's
    (wrappers.py). `wrappers` is the table's wrappers.Resolution, None
    without a mask, blend or coating; `walk` [M, 4] the rows' family
    (its bits) and opacity, which the shadow walk reads."""

    # field -> (offset, width, kind); kind in {f, f3, i, b, tab}
    SLOTS = {
        "mtype": (0, 1, "i"),
        "twosided": (1, 1, "b"),
        "reflectance": (2, 3, "f3"),
        "specular": (5, 3, "f3"),
        "transmittance": (8, 3, "f3"),
        "eta": (11, 3, "f3"),
        "k": (14, 3, "f3"),
        "int_ior": (17, 1, "f"),
        "ext_ior": (18, 1, "f"),
        "alpha_u": (19, 1, "f"),
        "alpha_v": (20, 1, "f"),
        "dist": (21, 1, "i"),
        "nonlinear": (22, 1, "b"),
        "opacity": (23, 3, "f3"),
        "nested": (26, 1, "i"),
        "exponent": (27, 1, "f"),
        "eta_rel": (28, 1, "f"),
        "inv_eta2": (29, 1, "f"),
        "fdr_int": (30, 1, "f"),
        "spec_weight": (31, 1, "f"),
        "rt_fdr_int": (32, 1, "f"),
        "tex_reflectance": (33, 1, "i"),
        "tex_opacity": (34, 1, "i"),
        "tex_bump": (35, 1, "i"),
        "bump_is_normal": (36, 1, "b"),
        "nested2": (37, 1, "i"),
        "blend_w": (38, 1, "f"),
        "rt_ext": (39, RT_BINS, "tab"),
        "sigma_s": (39 + RT_BINS, 3, "f3"),
        "sigma_a": (42 + RT_BINS, 3, "f3"),
        "thickness": (45 + RT_BINS, 1, "f"),
        "phase_g": (46 + RT_BINS, 1, "f"),
    }
    WIDTH = 47 + RT_BINS

    def __init__(self, packed, present=None):
        self.packed = packed
        self.present = (frozenset(present) if present is not None
                        else frozenset(MAT_NAMES.values()))
        mt = packed.view(torch.int32)[:, 0]
        two = packed[:, 1] > 0.5
        kinds = lambda ts: torch.isin(
            mt, torch.tensor(ts, dtype=torch.int32, device=packed.device))
        self.flags = torch.stack([kinds(SMOOTH_TYPES), kinds(DELTA_TYPES),
                                  mt == MAT_NULL,
                                  kinds(TRANSMISSIVE_TYPES) | two, two])
        from . import wrappers
        self.wrappers = wrappers.resolve(packed, self.flags)
        if self.wrappers is not None:
            self.flags = self.wrappers.flags
        op = self.SLOTS["opacity"][0]
        self.walk = packed[:, [0, op, op + 1, op + 2]].contiguous()

    @classmethod
    def from_table(cls, table, device):
        """The scene's table, packed as ppg_tpu packs it; raises
        NotImplementedError for textures and for the wrapper nests the
        port refuses (wrappers.resolve)."""
        mtype = np.asarray(table.mtype)
        M = len(mtype)
        for f in ("tex_reflectance", "tex_opacity", "tex_bump"):
            if (np.asarray(getattr(table, f))[:M] >= 0).any():
                raise NotImplementedError(
                    f"textured materials ({f}) are not ported (ROADMAP "
                    "Queue 1 item 2b-ii)")
        packed = np.zeros((max(M, 1), cls.WIDTH), np.float32)
        for f, (off, w, kind) in cls.SLOTS.items():
            arr = np.asarray(getattr(table, f))[:M]
            if kind == "i":
                packed[:M, off] = arr.astype(np.int32).view(np.float32)
            elif kind in ("b", "f"):
                packed[:M, off] = arr.astype(np.float32)
            else:
                packed[:M, off:off + w] = arr.astype(np.float32).reshape(M, w)
        present = frozenset(int(t) for t in np.unique(mtype))
        return cls(torch.from_numpy(packed).to(device), present)


class Params(dict):
    """A lane's parameters: the gathered rows [L, WIDTH] and flags [5, L];
    each field of MaterialArrays.SLOTS is made at its first use as a view
    of the rows (a bool field as one compare)."""

    def __init__(self, row, flags):
        super().__init__(twosided=flags[4])
        self.row, self.flags = row, flags

    def __missing__(self, f):
        off, w, kind = MaterialArrays.SLOTS[f]
        if kind == "i":
            v = self.row.view(torch.int32)[:, off]
        elif kind == "b":
            v = self.row[:, off] > 0.5
        elif kind == "f":
            v = self.row[:, off]
        else:
            v = self.row[:, off:off + w]
        self[f] = v
        return v


def gather_params(mats: MaterialArrays, mid):
    """One row gather and one flag gather for the lanes' material ids."""
    i = mid.long()
    return Params(mats.packed[i], mats.flags[:, i])


def lane_flags(p):
    """(smooth, delta_only, is_null, transmissive) per lane, each a
    contiguous [L] bool; transmissive includes the two-sided rows."""
    return p.flags[0], p.flags[1], p.flags[2], p.flags[3]


def _flip_sign(p, wi):
    return torch.where(p["twosided"] & (wi[..., 2] < 0.0), -1.0, 1.0)


def _z(v, sign):
    return torch.cat([v[..., :2], (v[..., 2] * sign)[..., None]], -1)


def _reflect(wi):
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)


def _up(v, cos):
    """v turned to the upper side: signum(cos) * v (roughdielectric.cpp)."""
    return v * torch.sign(cos)[..., None]


def _reflect_m(wi, m):
    return 2.0 * (wi * m).sum(-1, keepdim=True) * m - wi


def _norm(v):
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _half(wi, wo):
    h = wi + wo
    return h / torch.clamp(_norm(h), min=1e-20)


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def _frame_up(axis):
    """ppg_tpu's helper vector for a frame around `axis`: +z, or +x where
    the axis is within 0.999 of +-z."""
    away = torch.abs(axis[..., 2]) < 0.999
    zero = torch.zeros_like(axis[..., 2])
    return torch.stack([torch.where(away, 0.0, 1.0), zero,
                        torch.where(away, 1.0, 0.0)], -1)


def _rt_lookup(p, cos_theta):
    """Rough-transmittance table lookup (linear in cos)."""
    x = torch.clamp(cos_theta, 0.0, 1.0) * RT_BINS - 0.5
    # floor, clipped to the table (a NaN cos reads bin 0, as ppg_tpu's
    # int32 cast and clip do)
    f = torch.floor(x)
    f = torch.where(f > 0, f, 0.0)
    i0 = torch.where(f < RT_BINS - 1, f, float(RT_BINS - 1)).long()
    i1 = torch.clamp(i0 + 1, max=RT_BINS - 1)
    t = torch.clamp(x - i0, 0.0, 1.0)
    tab = p["rt_ext"]
    return ((1 - t) * torch.gather(tab, 1, i0[:, None])[:, 0]
            + t * torch.gather(tab, 1, i1[:, None])[:, 0])


# ---------------------------------------------------------------------------
# family evaluators: each returns (f_cos [L,3], pdf [L]) of the smooth part
# ---------------------------------------------------------------------------

def _diffuse_ep(p, wi, wo):
    both = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    f = p["reflectance"] * (INV_PI * torch.clamp(wo[..., 2], min=0.0))[
        ..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(both[..., None], f, 0.0), torch.where(both, pdf, 0.0)


def _roughdiffuse_ep(p, wi, wo):
    """Oren-Nayar (qualitative model), src/bsdfs/roughdiffuse.cpp with
    useFastApprox semantics; sampled with the cosine hemisphere."""
    both = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    ci = torch.clamp(wi[..., 2], 1e-6, 1.0)
    co = torch.clamp(wo[..., 2], 1e-6, 1.0)
    # sigma = alpha / sqrt(2) (roughdiffuse.cpp)
    sigma = p["alpha_u"] * 0.70710678
    s2 = sigma * sigma
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    si = torch.sqrt(torch.clamp(1 - ci * ci, 0.0, 1.0))
    so = torch.sqrt(torch.clamp(1 - co * co, 0.0, 1.0))
    denom = torch.clamp(si * so, min=1e-9)
    cos_dphi = torch.clamp(
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / denom, -1, 1)
    max_cos = torch.clamp(cos_dphi, min=0.0)
    sin_alpha = torch.maximum(si, so)
    tan_beta = torch.minimum(si / ci, so / co)
    f = p["reflectance"] * (
        INV_PI * co * (a + b * max_cos * sin_alpha * tan_beta))[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(both[..., None], f, 0.0), torch.where(both, pdf, 0.0)


def _ward_ep(p, wi, wo):
    """Anisotropic Ward (src/bsdfs/ward.cpp, the classic variant): diffuse
    plus a gaussian-exponential lobe on the half vector, sampled as a
    diffuse/specular mixture with Ward's half-vector warp."""
    both = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    ci = torch.clamp(wi[..., 2], 1e-6, 1.0)
    co = torch.clamp(wo[..., 2], 1e-6, 1.0)
    h = wi + wo
    hz2 = torch.clamp(h[..., 2] * h[..., 2], min=1e-12)
    au = torch.clamp(p["alpha_u"], min=1e-4)
    av = torch.clamp(p["alpha_v"], min=1e-4)
    expo = torch.exp(-((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2) / hz2)
    spec = expo / (4.0 * math.pi * au * av * torch.sqrt(ci * co))
    f = (p["reflectance"] * (INV_PI * co)[..., None]
         + p["specular"] * (spec * co)[..., None])
    hn = h / torch.clamp(_norm(h), min=1e-12)
    chz2 = torch.clamp(hn[..., 2] * hn[..., 2], min=1e-12)
    exph = torch.exp(-((hn[..., 0] / au) ** 2 + (hn[..., 1] / av) ** 2)
                     / chz2)
    pdf_h = exph / (4.0 * math.pi * au * av
                    * torch.clamp(hn[..., 2] ** 3, min=1e-12))
    dwh_dwo = 1.0 / torch.clamp(4.0 * torch.abs((wo * hn).sum(-1)),
                                min=1e-12)
    w_s = p["spec_weight"]
    pdf = (w_s * pdf_h * dwh_dwo
           + (1 - w_s) * warp.square_to_cosine_hemisphere_pdf(wo))
    return torch.where(both[..., None], f, 0.0), torch.where(both, pdf, 0.0)


def _difftrans_ep(p, wi, wo):
    """Diffuse transmitter (src/bsdfs/difftrans.cpp): a Lambertian lobe on
    the opposite hemisphere."""
    through = (((wi[..., 2] > 0) & (wo[..., 2] < 0))
               | ((wi[..., 2] < 0) & (wo[..., 2] > 0)))
    aco = torch.abs(wo[..., 2])
    f = p["transmittance"] * (INV_PI * aco)[..., None]
    pdf = aco * INV_PI
    return (torch.where(through[..., None], f, 0.0),
            torch.where(through, pdf, 0.0))


def _phong_ep(p, wi, wo):
    """Modified Phong (src/bsdfs/phong.cpp): diffuse plus a normalised
    cosine lobe around the mirror direction, sampled as a mixture."""
    both = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    e = p["exponent"]
    alpha = torch.clamp((_reflect(wi) * wo).sum(-1), 0.0, 1.0)
    spec = (alpha ** e) * (e + 2) * (0.5 * INV_PI)
    co = torch.clamp(wo[..., 2], min=0.0)
    f = (p["reflectance"] * (INV_PI * co)[..., None]
         + p["specular"] * (spec * co)[..., None])
    w_s = p["spec_weight"]
    pdf_spec = (alpha ** e) * (e + 1) * (0.5 * INV_PI)
    pdf = (w_s * pdf_spec
           + (1 - w_s) * warp.square_to_cosine_hemisphere_pdf(wo))
    return torch.where(both[..., None], f, 0.0), torch.where(both, pdf, 0.0)


def _roughconductor_ep(p, wi, wo):
    both = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    h = _half(wi, wo)
    dist, au, av = p["dist"], p["alpha_u"], p["alpha_v"]
    d = MF.eval_d(dist, au, av, h)
    F = fresnel_conductor_exact((wi * h).sum(-1), p["eta"], p["k"])
    g = MF.g_smith(dist, au, av, wi, wo, h)
    val = (d * g / (4.0 * torch.clamp(wi[..., 2], min=1e-8)))[..., None] * F
    f = p["specular"] * val
    pdf_h = MF.pdf_visible(dist, au, av, wi, h)
    pdf = pdf_h / torch.clamp(4.0 * torch.abs((wo * h).sum(-1)), min=1e-12)
    return (torch.where(both[..., None], f, 0.0),
            torch.where(both & (d > 0), pdf, 0.0))


def _diffuse_albedo(p, fdr):
    """The plastic families' diffuse reflectance: nonlinear rows
    R / (1 - R Fdr), the others R / (1 - Fdr)."""
    diff = p["reflectance"]
    fdr = fdr[..., None]
    return torch.where(p["nonlinear"][..., None], diff / (1.0 - diff * fdr),
                       diff / (1.0 - fdr))


def _plastic_ep(p, wi, wo):
    """Smooth plastic: the diffuse lobe only, in solid angle (plastic.cpp
    eval/pdf); the delta lobe is handled in sampling."""
    both = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    Fi, _ = fresnel_dielectric_ext(wi[..., 2], p["eta_rel"])
    Fo, _ = fresnel_dielectric_ext(wo[..., 2], p["eta_rel"])
    diff = _diffuse_albedo(p, p["fdr_int"])
    f = diff * (warp.square_to_cosine_hemisphere_pdf(wo)
                * p["inv_eta2"] * (1 - Fi) * (1 - Fo))[..., None]
    sw = p["spec_weight"]
    prob_spec = (Fi * sw) / torch.clamp(Fi * sw + (1 - Fi) * (1 - sw),
                                        min=1e-12)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo) * (1 - prob_spec)
    return torch.where(both[..., None], f, 0.0), torch.where(both, pdf, 0.0)


def _roughplastic_ep(p, wi, wo):
    both = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    h = _half(wi, wo)
    dist, alpha = p["dist"], p["alpha_u"]
    d = MF.eval_d(dist, alpha, alpha, h)
    F, _ = fresnel_dielectric_ext((wi * h).sum(-1), p["eta_rel"])
    g = MF.g_smith(dist, alpha, alpha, wi, wo, h)
    spec = p["specular"] * (
        F * d * g / (4.0 * torch.clamp(wi[..., 2], min=1e-8)))[..., None]
    t12 = _rt_lookup(p, wi[..., 2])
    t21 = _rt_lookup(p, wo[..., 2])
    diff = _diffuse_albedo(p, p["rt_fdr_int"])
    diffuse = diff * (INV_PI * torch.clamp(wo[..., 2], min=0.0) * t12 * t21
                      * p["inv_eta2"])[..., None]
    f = spec + diffuse
    sw = p["spec_weight"]
    prob_spec0 = 1.0 - t12
    prob_spec = (prob_spec0 * sw) / torch.clamp(
        prob_spec0 * sw + (1 - prob_spec0) * (1 - sw), min=1e-12)
    pdf_h = MF.pdf_visible(dist, alpha, alpha, wi, h)
    pdf_spec = pdf_h / torch.clamp(4.0 * torch.abs((wo * h).sum(-1)),
                                   min=1e-12)
    pdf = (pdf_spec * prob_spec
           + (1 - prob_spec) * warp.square_to_cosine_hemisphere_pdf(wo))
    return torch.where(both[..., None], f, 0.0), torch.where(both, pdf, 0.0)


def _roughdielectric_ep(p, wi, wo):
    """Walter-style rough dielectric: reflection and transmission lobes
    (roughdielectric.cpp eval/pdf), signed-cosine convention."""
    ci, co = wi[..., 2], wo[..., 2]
    reflect = ci * co > 0
    eta = torch.where(ci > 0, p["eta_rel"], 1.0 / p["eta_rel"])
    h_r = _half(wi, wo)
    h_t = wi + wo * eta[..., None]
    h_t = h_t / torch.clamp(_norm(h_t), min=1e-20)
    h = torch.where(reflect[..., None], h_r, h_t)
    h = h * torch.sign(h[..., 2:3])
    dist, au, av = p["dist"], p["alpha_u"], p["alpha_v"]
    d = MF.eval_d(dist, au, av, h)
    F, _ = fresnel_dielectric_ext((wi * h).sum(-1), p["eta_rel"])
    g = MF.g_smith(dist, au, av, wi, wo, h)
    val_r = F * d * g / (4.0 * torch.clamp(torch.abs(ci), min=1e-8))
    ih = (wi * h).sum(-1)
    oh = (wo * h).sum(-1)
    denom = ih + eta * oh
    q = ci * denom * denom
    val_t = ((1 - F) * d * g * eta * eta * ih * oh
             / torch.where(torch.abs(q) < 1e-12, 1.0, q))
    factor = torch.where(ci > 0, 1.0 / p["eta_rel"], p["eta_rel"])
    val_t = torch.abs(val_t * factor * factor)
    f = torch.where(reflect[..., None], p["specular"] * val_r[..., None],
                    p["transmittance"] * val_t[..., None])
    f = torch.where(((d > 0) & (ci != 0))[..., None], f, 0.0)
    # the visible normals of wi turned to the upper side (Mitsuba's
    # signum(cos) * wi): the density sample_bsdf draws them from
    pdf_h = MF.pdf_visible(dist, au, av, _up(wi, ci), h)
    dwh_dwo = torch.where(
        reflect, 1.0 / torch.clamp(4.0 * torch.abs(oh), min=1e-12),
        (eta * eta * torch.abs(oh)) / torch.clamp(denom * denom, min=1e-12))
    pdf = torch.abs(pdf_h * dwh_dwo) * torch.where(reflect, F, 1 - F)
    # only a microfacet that wi and wo each see from their own side takes
    # wi to wo: elsewhere no sample lands (and f is 0 through G)
    seen = (ih * ci > 0) & (oh * co > 0)
    return f, torch.where((ci != 0) & seen, pdf, 0.0)


def _hk_phase_eval(g, wi, wo):
    """HG phase value in the reference's convention (src/phase/hg.cpp: eval
    uses 1 + g^2 + 2g dot(wi, wo) with both directions pointing away from
    the event); g = 0 is the isotropic 1/4pi."""
    dp = (wi * wo).sum(-1)
    temp = 1.0 + g * g + 2.0 * g * dp
    hg = (0.25 * INV_PI) * (1.0 - g * g) / torch.clamp(
        temp * torch.sqrt(torch.clamp(temp, min=1e-12)), min=1e-12)
    return torch.where(torch.abs(g) < 1e-6, 0.25 * INV_PI, hg)


def _hk_parts(p, wi):
    sigma_t = p["sigma_s"] + p["sigma_a"]
    tau_d = sigma_t * p["thickness"][..., None]
    albedo = torch.where(sigma_t > 0, p["sigma_s"] / torch.clamp(
        sigma_t, min=1e-30), 0.0)
    aci = torch.clamp(torch.abs(wi[..., 2]), min=1e-8)
    # per-wavelength probability of crossing the slab unscattered,
    # averaged over channels (hk.cpp:318-320)
    atten = torch.exp(-tau_d / aci[..., None])
    return tau_d, albedo, atten, atten.mean(-1)


def _hk_ep(p, wi, wo):
    """Hanrahan-Krueger single-scattering slab, smooth lobes only
    (src/bsdfs/hk.cpp:191-261; the delta transmission lobe is handled in
    sampling)."""
    tau_d, albedo, _, prob_t = _hk_parts(p, wi)
    ci, co = wi[..., 2], wo[..., 2]
    aci = torch.clamp(torch.abs(ci), min=1e-8)
    aco = torch.clamp(torch.abs(co), min=1e-8)
    phase = _hk_phase_eval(p["phase_g"], wi, wo)
    dp = ci * co
    # reflection (Hanrahan et al. '93 single scattering)
    f_r = albedo * (phase * ci / (ci + co))[..., None] * (
        1.0 - torch.exp((-1.0 / aci - 1.0 / aco)[..., None] * tau_d))
    # transmission; the |ci| == |co| limit in l'Hopital's form
    near = torch.abs(aci - aco) < 1e-5
    safe_diff = torch.where(near, 1.0, aci - aco)[..., None]
    f_t_gen = albedo * (phase * aci)[..., None] / safe_diff * (
        torch.exp(-tau_d / aci[..., None]) - torch.exp(-tau_d / aco[..., None]))
    f_t_lim = (albedo * phase[..., None] * tau_d / aco[..., None]
               * torch.exp(-tau_d / aco[..., None]))
    f_t = torch.where(near[..., None], f_t_lim, f_t_gen)
    f = torch.where((dp > 0)[..., None], f_r,
                    torch.where((dp < 0)[..., None], f_t, 0.0)) * aco[
        ..., None]
    pdf = phase * (1.0 - prob_t)
    ok = dp != 0
    return (torch.where(ok[..., None], torch.clamp(f, min=0.0), 0.0),
            torch.where(ok, pdf, 0.0))


_SMOOTH_EP = {
    MAT_DIFFUSE: _diffuse_ep,
    MAT_ROUGHDIFFUSE: _roughdiffuse_ep,
    MAT_PHONG: _phong_ep,
    MAT_WARD: _ward_ep,
    MAT_DIFFTRANS: _difftrans_ep,
    MAT_ROUGHCONDUCTOR: _roughconductor_ep,
    MAT_PLASTIC: _plastic_ep,
    MAT_ROUGHPLASTIC: _roughplastic_ep,
    MAT_ROUGHDIELECTRIC: _roughdielectric_ep,
    MAT_HK: _hk_ep,
}


def _on(present):
    return (lambda t: True) if present is None else (lambda t: t in present)


def eval_pdf_bsdf(p, wi, wo, present=None):
    """(eval_bsdf, pdf_bsdf) in one pass: (f * cos [L,3], pdf [L]) of the
    smooth components. `present` (the scene's families, default all)
    skips the absent ones; a scene of one family selects nothing."""
    sign = _flip_sign(p, wi)
    wi_l, wo_l = _z(wi, sign), _z(wo, sign)
    fams = [(t, fn) for t, fn in _SMOOTH_EP.items() if _on(present)(t)]
    if present is not None and len(present) == 1 and fams:
        return fams[0][1](p, wi_l, wo_l)
    f = torch.zeros_like(wi)
    pdf = torch.zeros_like(wi[..., 0])
    mt = p["mtype"]
    for t, fn in fams:
        sel = mt == t
        ft, pt = fn(p, wi_l, wo_l)
        f = torch.where(sel[..., None], ft, f)
        pdf = torch.where(sel, pt, pdf)
    return f, pdf


def eval_bsdf(p, wi, wo, present=None):
    return eval_pdf_bsdf(p, wi, wo, present)[0]


def pdf_bsdf(p, wi, wo, present=None):
    return eval_pdf_bsdf(p, wi, wo, present)[1]


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _visible_normals(p, mt, on, wi_l, ci, u2, u_g, single=False):
    """The one visible-normal sample of the present microfacet families:
    each lane's (alpha_u, alpha_v, wi, u) by its family, then
    microfacet.sample_visible, gated to the lanes of those families (in a
    scene of one family, every lane)."""
    fams = [t for t in _MF_TYPES if on(t)]
    au, av = p["alpha_u"], p["alpha_v"]
    w, u = wi_l, u2
    if MAT_ROUGHPLASTIC in fams:
        if len(fams) == 1:
            av, u = au, u_g
        else:
            rp = mt == MAT_ROUGHPLASTIC
            av = torch.where(rp, au, av)
            u = torch.where(rp[..., None], u_g, u2)
    if MAT_ROUGHDIELECTRIC in fams:
        wi_f = _up(wi_l, ci)
        w = wi_f if len(fams) == 1 else torch.where(
            (mt == MAT_ROUGHDIELECTRIC)[..., None], wi_f, wi_l)
    gate = None if single else (mt, sum(1 << t for t in fams))
    return MF.sample_visible(p["dist"], au, av, w, u, gate)


def sample_bsdf(p, wi, u2, present=None):
    """Returns (wo, weight = f*cos/pdf, pdf, sampled_delta, eta).

    u2 is [L, 3]: components 0-1 drive the lobe and warp sampling like the
    reference's Point2; component 2 is the extra 1D draw roughdielectric
    needs for its reflect/refract decision. For delta lobes pdf is the
    discrete lobe probability and weight carries f/pdf as in the
    reference's bsdf->sample convention."""
    sign = _flip_sign(p, wi)
    on = _on(present)
    ci = wi[..., 2] * sign
    # the diffuse lobes need only the flipped cos
    wi_l = (None if present is not None
            and present <= {MAT_DIFFUSE, MAT_DIFFTRANS} else _z(wi, sign))
    mt = p["mtype"]
    L = wi.shape[0]
    dev = wi.device
    u1, u2b = u2[..., 0], u2[..., 1]
    u3 = u2[..., 2] if u2.shape[-1] > 2 else u2[..., 0]
    u2 = u2[..., :2]
    # one family in the scene: every lane is its own, nothing to select
    single = present is not None and len(present) == 1
    any_cosine = any(map(on, (MAT_DIFFUSE, MAT_ROUGHDIFFUSE, MAT_PHONG,
                              MAT_WARD, MAT_DIFFTRANS)))

    out = dict(wo=None, weight=None, pdf=None,
               delta=torch.zeros(L, dtype=torch.bool, device=dev),
               eta=torch.ones(L, dtype=torch.float32, device=dev))
    if not single:
        out.update(wo=torch.zeros_like(wi), weight=torch.zeros_like(wi),
                   pdf=torch.zeros_like(wi[..., 0]))

    def put(t, wo_t, w_t, pdf_t, delta_t=None, eta_t=None):
        new = dict(wo=wo_t, weight=w_t, pdf=pdf_t, delta=delta_t, eta=eta_t)
        sel = None if single else mt == t
        for k, v in new.items():
            if v is None:
                continue
            if sel is None:
                out[k] = v
            else:
                out[k] = torch.where(sel[..., None] if v.dim() > 1 else sel,
                                     v, out[k])

    if any_cosine:
        wo_d = warp.square_to_cosine_hemisphere(u2)
        pdf_d = warp.square_to_cosine_hemisphere_pdf(wo_d)
        ok_d = ci > 0
    if on(MAT_DIFFUSE):
        put(MAT_DIFFUSE, wo_d,
            torch.where(ok_d[..., None], p["reflectance"], 0.0),
            torch.where(ok_d, pdf_d, 0.0))

    if on(MAT_ROUGHDIFFUSE):
        # Oren-Nayar: cosine sample, weight = f/pdf
        f_on, pdf_on = _roughdiffuse_ep(p, wi_l, wo_d)
        put(MAT_ROUGHDIFFUSE, wo_d,
            torch.where((ok_d & (pdf_on > 0))[..., None],
                        f_on / torch.clamp(pdf_on, min=1e-30)[..., None],
                        0.0),
            torch.where(ok_d, pdf_on, 0.0))

    if on(MAT_PHONG) or on(MAT_WARD):
        # phong: diffuse/specular mixture (phong.cpp:sample)
        pick_spec = u3 < p["spec_weight"]
    if on(MAT_PHONG):
        e = p["exponent"]
        refl_m = _reflect(wi_l)
        cos_a = torch.clamp(u1, 1e-9, 1.0) ** (1.0 / (e + 1.0))
        sin_a = torch.sqrt(torch.clamp(1 - cos_a * cos_a, 0.0, 1.0))
        phi_s = 2 * math.pi * u2b
        # orthonormal frame around the mirror direction
        sx = _cross(_frame_up(refl_m), refl_m)
        sx = sx / torch.clamp(_norm(sx), min=1e-12)
        sy = _cross(refl_m, sx)
        wo_sp = (sx * (sin_a * torch.cos(phi_s))[..., None]
                 + sy * (sin_a * torch.sin(phi_s))[..., None]
                 + refl_m * cos_a[..., None])
        wo_ph = torch.where(pick_spec[..., None], wo_sp, wo_d)
        f_ph, pdf_ph = _phong_ep(p, wi_l, wo_ph)
        ok_ph = ok_d & (pdf_ph > 0) & (wo_ph[..., 2] > 0)
        put(MAT_PHONG, wo_ph,
            torch.where(ok_ph[..., None],
                        f_ph / torch.clamp(pdf_ph, min=1e-30)[..., None], 0.0),
            torch.where(ok_ph, pdf_ph, 0.0))

    if on(MAT_WARD):
        # ward: diffuse/specular mixture with Ward's half-vector warp
        au = torch.clamp(p["alpha_u"], min=1e-4)
        av = torch.clamp(p["alpha_v"], min=1e-4)
        phi_w = 2 * math.pi * u2b
        hx = au * torch.cos(phi_w)
        hy = av * torch.sin(phi_w)
        inv_n = 1.0 / torch.sqrt(torch.clamp(hx * hx + hy * hy, min=1e-20))
        cph, sph = hx * inv_n, hy * inv_n
        tan2_th = -torch.log(torch.clamp(u1, 1e-9, 1.0)) / torch.clamp(
            (cph / au) ** 2 + (sph / av) ** 2, min=1e-12)
        cos_th = 1.0 / torch.sqrt(1.0 + tan2_th)
        sin_th = torch.sqrt(torch.clamp(1.0 - cos_th ** 2, 0.0, 1.0))
        h_w = torch.stack([sin_th * cph, sin_th * sph, cos_th], -1)
        wo_w = torch.where(pick_spec[..., None], _reflect_m(wi_l, h_w), wo_d)
        f_w, pdf_w = _ward_ep(p, wi_l, wo_w)
        ok_w = ok_d & (pdf_w > 0) & (wo_w[..., 2] > 0)
        put(MAT_WARD, wo_w,
            torch.where(ok_w[..., None],
                        f_w / torch.clamp(pdf_w, min=1e-30)[..., None], 0.0),
            torch.where(ok_w, pdf_w, 0.0))

    if on(MAT_DIFFTRANS):
        # a cosine lobe on the opposite hemisphere
        wo_dt = torch.stack([wo_d[..., 0], wo_d[..., 1], -wo_d[..., 2]], -1)
        put(MAT_DIFFTRANS, wo_dt,
            torch.where(ok_d[..., None], p["transmittance"], 0.0),
            torch.where(ok_d, pdf_d, 0.0))

    if on(MAT_CONDUCTOR):
        F_c = fresnel_conductor_exact(ci, p["eta"], p["k"])
        put(MAT_CONDUCTOR, _reflect(wi_l),
            torch.where((ci > 0)[..., None], p["specular"] * F_c, 0.0),
            torch.where(ci > 0, 1.0, 0.0),
            torch.ones(L, dtype=torch.bool, device=dev))

    if on(MAT_DIELECTRIC):
        # two delta lobes
        eta_rel = p["eta_rel"]
        F_d, cos_t = fresnel_dielectric_ext(ci, eta_rel)
        pick_refl = u1 <= F_d
        scale = torch.where(ci > 0, 1.0 / eta_rel, eta_rel)
        wo_refr = torch.stack([-scale * wi_l[..., 0], -scale * wi_l[..., 1],
                               cos_t], -1)
        w_diel = torch.where(pick_refl[..., None], p["specular"],
                             p["transmittance"] * (scale * scale)[..., None])
        put(MAT_DIELECTRIC,
            torch.where(pick_refl[..., None], _reflect(wi_l), wo_refr),
            w_diel, torch.where(pick_refl, F_d, 1.0 - F_d),
            torch.ones(L, dtype=torch.bool, device=dev),
            torch.where(pick_refl, 1.0,
                        torch.where(ci > 0, eta_rel, 1.0 / eta_rel)))

    if on(MAT_THINDIELECTRIC):
        # delta reflection and transmission (thindielectric.cpp)
        R_t, _ = fresnel_dielectric_ext(torch.abs(ci), p["eta_rel"])
        R_t = torch.where(R_t < 1.0, 2.0 * R_t / (1.0 + R_t), R_t)
        pick_r = u1 <= R_t
        put(MAT_THINDIELECTRIC,
            torch.where(pick_r[..., None], _reflect(wi_l), -wi_l),
            torch.where(pick_r[..., None], p["specular"], p["transmittance"]),
            torch.where(pick_r, R_t, 1.0 - R_t),
            torch.ones(L, dtype=torch.bool, device=dev))

    if on(MAT_ROUGHPLASTIC):
        # the glossy lobe's pick and its rescaled uniforms (used by the
        # visible-normal sample below)
        t12 = _rt_lookup(p, ci)
        sw = p["spec_weight"]
        psp0 = 1.0 - t12
        psp = (psp0 * sw) / torch.clamp(psp0 * sw + (1 - psp0) * (1 - sw),
                                        min=1e-12)
        pick_g = u2b < psp
        u_g = torch.stack([u1, torch.clamp(
            u2b / torch.clamp(psp, min=1e-9), 0.0, 1.0 - 1e-7)], -1)
    else:
        u_g = None
    if any(map(on, _MF_TYPES)):
        m = _visible_normals(p, mt, on, wi_l, ci, u2, u_g, single)

    if on(MAT_ROUGHCONDUCTOR):
        wo_rc = _reflect_m(wi_l, m)
        f_rc, pdf_rc = _roughconductor_ep(p, wi_l, wo_rc)
        ok_rc = (ci > 0) & (wo_rc[..., 2] > 0) & (pdf_rc > 0)
        put(MAT_ROUGHCONDUCTOR, wo_rc,
            torch.where(ok_rc[..., None],
                        f_rc / torch.clamp(pdf_rc, min=1e-30)[..., None], 0.0),
            torch.where(ok_rc, pdf_rc, 0.0))

    if on(MAT_PLASTIC):
        # a delta lobe and a diffuse one
        eta_rel, sw = p["eta_rel"], p["spec_weight"]
        Fi, _ = fresnel_dielectric_ext(ci, eta_rel)
        prob_sp = (Fi * sw) / torch.clamp(Fi * sw + (1 - Fi) * (1 - sw),
                                          min=1e-12)
        pick_sp = u1 < prob_sp
        u_re = torch.stack([torch.clamp(
            (u1 - prob_sp) / torch.clamp(1 - prob_sp, min=1e-9), 0.0,
            1.0 - 1e-7), u2b], -1)
        wo_pd = warp.square_to_cosine_hemisphere(u_re)
        Fo, _ = fresnel_dielectric_ext(wo_pd[..., 2], eta_rel)
        diff = _diffuse_albedo(p, p["fdr_int"])
        w_pd = diff * (p["inv_eta2"] * (1 - Fi) * (1 - Fo) / torch.clamp(
            1 - prob_sp, min=1e-12))[..., None]
        w_ps = p["specular"] * (Fi / torch.clamp(prob_sp, min=1e-12))[
            ..., None]
        ok_p = ci > 0
        put(MAT_PLASTIC,
            torch.where(pick_sp[..., None], _reflect(wi_l), wo_pd),
            torch.where(ok_p[..., None],
                        torch.where(pick_sp[..., None], w_ps, w_pd), 0.0),
            torch.where(ok_p, torch.where(
                pick_sp, prob_sp,
                (1 - prob_sp) * warp.square_to_cosine_hemisphere_pdf(wo_pd)),
                0.0),
            pick_sp)

    if on(MAT_ROUGHPLASTIC):
        # a glossy lobe and a diffuse one
        u_dd = torch.stack([u1, torch.clamp(
            (u2b - psp) / torch.clamp(1 - psp, min=1e-9), 0.0, 1.0 - 1e-7)],
            -1)
        wo_rp = torch.where(pick_g[..., None], _reflect_m(wi_l, m),
                            warp.square_to_cosine_hemisphere(u_dd))
        f_rp, pdf_rp = _roughplastic_ep(p, wi_l, wo_rp)
        ok_rp = (ci > 0) & (wo_rp[..., 2] > 0) & (pdf_rp > 0)
        put(MAT_ROUGHPLASTIC, wo_rp,
            torch.where(ok_rp[..., None],
                        f_rp / torch.clamp(pdf_rp, min=1e-30)[..., None], 0.0),
            torch.where(ok_rp, pdf_rp, 0.0))

    if on(MAT_ROUGHDIELECTRIC):
        # m, on the upper side, drawn for wi turned up; the Fresnel term
        # and the refraction take wi's own side from the sign of wi.m
        # (roughdielectric.cpp:sample)
        eta_rel = p["eta_rel"]
        dm = (wi_l * m).sum(-1)
        F_rd, cos_t_rd = fresnel_dielectric_ext(dm, eta_rel)
        pick_r_rd = u3 <= F_rd  # independent lobe pick (roughdielectric.cpp)
        wo_rd_r = _reflect_m(wi_l, m)
        eta_ratio = torch.where(cos_t_rd < 0, 1.0 / eta_rel, eta_rel)
        wo_rd_t = (m * (dm * eta_ratio + cos_t_rd)[..., None]
                   - wi_l * eta_ratio[..., None])
        wo_rd = torch.where(pick_r_rd[..., None], wo_rd_r, wo_rd_t)
        side_ok = torch.where(pick_r_rd, wo_rd[..., 2] * ci > 0,
                              wo_rd[..., 2] * ci < 0)
        f_rd, pdf_rd = _roughdielectric_ep(p, wi_l, wo_rd)
        ok_rd = side_ok & (pdf_rd > 0) & (ci != 0)
        put(MAT_ROUGHDIELECTRIC, wo_rd,
            torch.where(ok_rd[..., None],
                        f_rd / torch.clamp(pdf_rd, min=1e-30)[..., None], 0.0),
            torch.where(ok_rd, pdf_rd, 0.0), None,
            torch.where(pick_r_rd, 1.0,
                        torch.where(ci > 0, eta_rel, 1.0 / eta_rel)))

    if on(MAT_HK):
        # delta transmission w.p. prob_t, else the phase function's lobe
        # around -wi (hk.cpp:305-374; hg.cpp:74-97 sampling)
        tau_d, albedo, atten, prob_t = _hk_parts(p, wi_l)
        pick_t = u1 <= prob_t
        g = p["phase_g"]
        iso = torch.abs(g) < 1e-6
        sqr = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * u2b, min=1e-12)
        cos_hk = torch.where(
            iso, 1.0 - 2.0 * u2b,
            (1.0 + g * g - sqr * sqr) / torch.where(iso, 1.0, 2.0 * g))
        cos_hk = torch.clamp(cos_hk, -1.0, 1.0)
        sin_hk = torch.sqrt(torch.clamp(1.0 - cos_hk * cos_hk, 0.0, 1.0))
        phi_hk = 2.0 * math.pi * u3
        # a frame around -wi (HG samples relative to the propagation)
        ax = -wi_l
        hx = _cross(_frame_up(ax), ax)
        hx = hx / torch.clamp(_norm(hx), min=1e-12)
        hy = _cross(ax, hx)
        wo_ph = (hx * (sin_hk * torch.cos(phi_hk))[..., None]
                 + hy * (sin_hk * torch.sin(phi_hk))[..., None]
                 + ax * cos_hk[..., None])
        f_hk, pdf_hk = _hk_ep(p, wi_l, wo_ph)
        ok_hk = pdf_hk > 0
        put(MAT_HK, torch.where(pick_t[..., None], -wi_l, wo_ph),
            torch.where(pick_t[..., None],
                        atten / torch.clamp(prob_t, min=1e-12)[..., None],
                        torch.where(ok_hk[..., None], f_hk / torch.clamp(
                            pdf_hk, min=1e-30)[..., None], 0.0)),
            torch.where(pick_t, prob_t, pdf_hk), pick_t)

    if on(MAT_NULL):
        put(MAT_NULL, -wi_l, torch.ones_like(wi),
            torch.ones(L, dtype=torch.float32, device=dev),
            torch.ones(L, dtype=torch.bool, device=dev))

    if out["wo"] is None:  # a scene of one family without a sampler here
        out.update(wo=torch.zeros_like(wi), weight=torch.zeros_like(wi),
                   pdf=torch.zeros_like(wi[..., 0]))
    # un-flip the two-sided lanes
    return (_z(out["wo"], sign), out["weight"], out["pdf"], out["delta"],
            out["eta"])

"""Dielectric coating wrappers, `coating` and `roughcoating` (counterpart
of ppg_tpu/bsdf/layered.py).

Weidlich-Wilkie layered models as the reference implements them
(src/bsdfs/coating.cpp:106-400, roughcoating.cpp:106-456): the incident
and exitant directions are refracted through the dielectric interface,
the nested leaf BSDF is queried with the refracted pair, and the result
is attenuated by the two interface transmittances, the layer's
absorption and the solid-angle compression eta^-2 cos(wo) / cos(wo').

Conventions as in bsdf.py: eval and pdf cover the smooth lobes in solid
angle (eval premultiplied by |cos theta_o|); sampling returns (wo,
weight = f / pdf, pdf, sampled_delta, eta) with the discrete lobe
probability for a delta pick.

The work is split so that a shading site can run the nested leaf inside
its one stacked table call (bsdf/wrappers.py): `prepare` refracts wi
once a bounce, `compose_eval` turns the nested (f, pdf) at the refracted
pair into the coating's, and `sample_parts` and `finish` turn the nested
sample into the coating's, the smooth picks weighted by the coating's
eval at the sampled direction. `eval_pdf` and `sample` put them together
for one coating row and its nested row, as ppg_tpu's functions do.

Roughcoating's interface lobe samples its visible normals through
microfacet.sample_visible (K8 on a card), gated to the roughcoating
lanes; unlike ppg_tpu, a GGX interface takes Heitz's disk basis (ROADMAP
Queue 3, PR 15), so its samples differ from ppg_tpu's by design.
"""

from __future__ import annotations

import torch

from ..scene.scene import MAT_ROUGHCOATING
from . import bsdf as B
from . import microfacet as MF
from .fresnel import fresnel_dielectric_ext


def _refract(v, scale):
    """Refract across the interface with relative IOR 1 / scale, keeping
    the hemisphere's sign (coating.cpp refractIn / refractOut). Returns
    (v', R), R the Fresnel reflectance; under total internal reflection
    v'.z = 0 and R = 1."""
    vz = v[..., 2]
    R, ct = fresnel_dielectric_ext(torch.abs(vz), 1.0 / scale)
    # fresnel returns cos_t signed opposite to its (positive) input
    zp = torch.sign(vz) * (-ct)
    return torch.stack([scale * v[..., 0], scale * v[..., 1], zp], -1), R


def _absorption(p, wi_p, wo_p):
    """exp(-sigmaA * thickness * (1 / |cos wi'| + 1 / |cos wo'|))."""
    inv = (1.0 / torch.clamp(torch.abs(wi_p[..., 2]), min=1e-8)
           + 1.0 / torch.clamp(torch.abs(wo_p[..., 2]), min=1e-8))
    return torch.exp(-p["sigma_a"] * p["thickness"][..., None]
                     * inv[..., None])


def _prob_specular(p, wi, rt_i):
    """The probability of picking the interface lobe (coating.cpp:268-273;
    roughcoating takes 1 - roughTransmittance for the Fresnel term,
    roughcoating.cpp:340-353). Returns (ps, R12)."""
    rough = p["mtype"] == MAT_ROUGHCOATING
    R12, _ = fresnel_dielectric_ext(torch.abs(wi[..., 2]), p["eta_rel"])
    ps0 = torch.where(rough, 1.0 - rt_i, R12)
    w = p["spec_weight"]
    ps = (ps0 * w) / torch.clamp(ps0 * w + (1.0 - ps0) * (1.0 - w),
                                 min=1e-12)
    return ps, R12


def prepare(p, wi, rough_present=True):
    """The coat rows `p` at wi, as a dict: the rows' frame flip (sign), wi
    in it (wi) and refracted (wi_p, with that refraction's R12), the
    interface pick's probability ps (with the R12_ps it was computed
    from), the rough-transmittance lookup at wi (rt_i) and the
    roughcoating lanes (rough). `rough_present` False (no roughcoating
    row reaches these lanes) skips roughcoating's interface lobe."""
    sign = B._flip_sign(p, wi)
    wi_f = B._z(wi, sign)
    inv_eta = 1.0 / p["eta_rel"]
    wi_p, R12 = _refract(wi_f, inv_eta)
    rt_i = B._rt_lookup(p, torch.abs(wi_f[..., 2]))
    ps, R12_ps = _prob_specular(p, wi_f, rt_i)
    return dict(sign=sign, wi=wi_f, inv_eta=inv_eta, wi_p=wi_p, R12=R12,
                rt_i=rt_i, ps=ps, R12_ps=R12_ps,
                rough=p["mtype"] == MAT_ROUGHCOATING,
                rough_present=rough_present)


def refract_wo(st, wo):
    """wo in the coat's frame and refracted: (wo_f, wo_p, R21), the
    nested leaf's exitant direction being wo_p."""
    wo_f = B._z(wo, st["sign"])
    wo_p, R21 = _refract(wo_f, st["inv_eta"])
    return wo_f, wo_p, R21


def compose_eval(p, st, wo_f, wo_p, R21, f_n, pdf_n):
    """The coating's (f * cos, pdf) at wo from its nested leaf's (f_n,
    pdf_n) at (wi_p, wo_p), with roughcoating's glossy interface lobe."""
    wi, inv_eta = st["wi"], st["inv_eta"]
    tir = (st["R12"] >= 1.0) | (R21 >= 1.0)
    rough = st["rough"]
    rt_o = B._rt_lookup(p, torch.abs(wo_f[..., 2]))
    interface_t = torch.where(rough, st["rt_i"] * rt_o,
                              (1.0 - st["R12"]) * (1.0 - R21))
    compress = (inv_eta * inv_eta * wo_f[..., 2]
                / torch.where(torch.abs(wo_p[..., 2]) < 1e-8, 1.0,
                              wo_p[..., 2]))
    f = (f_n * interface_t[..., None] * _absorption(p, st["wi_p"], wo_p)
         * compress[..., None])
    f = torch.where(tir[..., None], 0.0, f)
    pdf = torch.where(tir, 0.0, pdf_n * compress * (1.0 - st["ps"]))
    if not st["rough_present"]:
        return f, pdf
    # roughcoating's own glossy reflection lobe (solid-angle measure)
    ci, co = wi[..., 2], wo_f[..., 2]
    refl = ci * co > 0
    sg = torch.sign(ci)
    wi_s, wo_s = B._z(wi, sg), B._z(wo_f, sg)
    h = B._half(wi_s, wo_s)
    alpha = p["alpha_u"]
    d = MF.eval_d(p["dist"], alpha, alpha, h)
    Fh, _ = fresnel_dielectric_ext(torch.abs((wi_s * h).sum(-1)),
                                   p["eta_rel"])
    g = MF.g_smith(p["dist"], alpha, alpha, wi_s, wo_s, h)
    gl = Fh * d * g / (4.0 * torch.clamp(torch.abs(ci), min=1e-8))
    pdf_h = MF.pdf_visible(p["dist"], alpha, alpha, wi_s, h)
    pdf_gl = pdf_h / torch.clamp(4.0 * torch.abs((wo_s * h).sum(-1)),
                                 min=1e-12)
    gl_on = rough & refl & (d > 0)
    f = f + torch.where(gl_on[..., None], p["specular"] * gl[..., None], 0.0)
    pdf = pdf + torch.where(gl_on, pdf_gl * st["ps"], 0.0)
    return f, pdf


def sample_parts(p, st, u4, nested):
    """The coating's sample from its nested leaf's sample `nested` = (wo',
    weight, pdf, delta, eta) drawn at st["wi_p"] with u4[:, :3]; u4[:, 3]
    picks the interface lobe. Returns (wo, weight, pdf, delta, eta,
    smooth, ok): on the `smooth` lanes (a glossy interface pick or a
    smooth nested one) weight and pdf are left to `finish`, which takes
    the coating's eval at wo; `ok` is the validity of the pick."""
    wi, inv_eta, ps, R12 = st["wi"], st["inv_eta"], st["ps"], st["R12_ps"]
    rough = st["rough"]
    pick_spec = u4[..., 3] < ps
    ci = wi[..., 2]

    # interface: coating's delta reflection (coating.cpp:330-337) ...
    wo_s = B._reflect(wi)
    w_sd = p["specular"] * (R12 / torch.clamp(ps, min=1e-12))[..., None]
    side_ok = None
    if st["rough_present"]:
        # ... or roughcoating's visible-normal reflection
        # (roughcoating.cpp:420-430), K8 gated to the roughcoating lanes
        sg = torch.sign(ci)
        alpha = p["alpha_u"]
        m = MF.sample_visible(p["dist"], alpha, alpha, B._z(wi, sg),
                              u4[..., :2], (p["mtype"], 1 << MAT_ROUGHCOATING))
        wo_sg = B._reflect_m(wi, B._z(m, sg))
        side_ok = wo_sg[..., 2] * ci > 0
        wo_s = torch.where(rough[..., None], wo_sg, wo_s)
    delta_s = ~rough

    # nested: its sample refracted back out
    wo_n_p, w_n, pdf_n, delta_n, eta_n = nested
    wo_n, R21 = _refract(wo_n_p, p["eta_rel"])
    tir = (R12 >= 1.0) | (R21 >= 1.0)
    absorb = _absorption(p, st["wi_p"], wo_n_p)
    rt_o = B._rt_lookup(p, torch.abs(wo_n[..., 2]))
    interface_t = torch.where(rough, st["rt_i"] * rt_o,
                              (1.0 - R12) * (1.0 - R21))
    inv_pn = 1.0 / torch.clamp(1.0 - ps, min=1e-12)
    # delta nested lobes: the branch weight, discrete measure
    # (coating.cpp:342-370)
    w_nb = w_n * (interface_t * inv_pn)[..., None] * absorb
    compress = (inv_eta * inv_eta * wo_n[..., 2]
                / torch.where(torch.abs(wo_n_p[..., 2]) < 1e-8, 1.0,
                              wo_n_p[..., 2]))
    pdf_nb = pdf_n * (1.0 - ps) * torch.where(delta_n, 1.0, compress)
    bad_n = tir | (pdf_n <= 0)
    w_nb = torch.where(bad_n[..., None], 0.0, w_nb)
    pdf_nb = torch.where(bad_n, 0.0, pdf_nb)

    wo = torch.where(pick_spec[..., None], wo_s, wo_n)
    delta = torch.where(pick_spec, delta_s, delta_n)
    eta = torch.where(pick_spec, 1.0, eta_n)
    weight = torch.where(pick_spec[..., None], w_sd, w_nb)
    pdf = torch.where(pick_spec, ps, pdf_nb)
    spec_ok = ~rough if side_ok is None else (rough & side_ok) | ~rough
    ok = torch.where(pick_spec, spec_ok, pdf_nb > 0)
    return B._z(wo, st["sign"]), weight, pdf, delta, eta, ~delta, ok


def finish(weight, pdf, smooth, ok, f_mix, pdf_mix):
    """The sample's weight and pdf, the `smooth` lanes' from the eval
    (f_mix, pdf_mix) at the sampled direction (roughcoating.cpp:443-450:
    one-sample MIS over the whole mixture), zero where not `ok`."""
    w_mix = torch.where(pdf_mix[..., None] > 0,
                        f_mix / torch.clamp(pdf_mix, min=1e-30)[..., None],
                        0.0)
    weight = torch.where(smooth[..., None], w_mix, weight)
    pdf = torch.where(smooth, pdf_mix, pdf)
    ok = ok & (pdf > 0)
    return (torch.where(ok[..., None], weight, 0.0),
            torch.where(ok, pdf, 0.0))


def eval_pdf(p, pn, wi, wo, present=None):
    """(f * cos, pdf) of the coating rows p over their nested leaf rows
    pn (present: the nested families)."""
    st = prepare(p, wi)
    wo_f, wo_p, R21 = refract_wo(st, wo)
    f_n, pdf_n = B.eval_pdf_bsdf(pn, st["wi_p"], wo_p, present)
    return compose_eval(p, st, wo_f, wo_p, R21, f_n, pdf_n)


def sample(p, pn, wi, u4, present=None):
    """Sample the coating rows p over their nested leaf rows pn; u4 is
    [L, 4]: 0-2 drive the nested and microfacet sampling, 3 picks the
    interface or the nested lobe."""
    st = prepare(p, wi)
    nested = B.sample_bsdf(pn, st["wi_p"], u4[..., :3], present)
    wo, weight, pdf, delta, eta, smooth, ok = sample_parts(p, st, u4,
                                                           nested)
    f_mix, pdf_mix = eval_pdf(p, pn, wi, wo, present)
    weight, pdf = finish(weight, pdf, smooth, ok, f_mix, pdf_mix)
    return wo, weight, pdf, delta, eta

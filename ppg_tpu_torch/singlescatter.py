"""Single scattering in media with refractive boundaries (counterpart of
ppg_tpu/singlescatter.py; the reference's src/subsurface/singlescatter.cpp,
Holzschuch 2014, its fast path fastSingleScatter=true, the plugin
default).

At a hit on a singlescatter shape the reference's Lo()
(singlescatter.cpp:1581-1640) splits into a delta reflection (F times the
radiance along the mirrored ray) and a refraction feeding LoSingle
(:1322-1579): each interior segment finds its exit thickness, connects
`fssSamples` exponentially placed points on the interior ray to one
sampled emitter through the refractive boundary (Fresnel, HG phase,
per-channel attenuation and Holzschuch's D geometry term, :1416-1488),
recurses on the internal reflection with weight F_exit exp(-sigma_t
thickness) up to singleScatterDepth (:1376-1403), and adds the boundary's
exit transmittance (:1344-1374).

As in ppg_tpu, the interior recursion is a masked loop over segments
(the internal reflection is specular, so it is a product of weights), and
the two nested radiance calls become the path's own continuation: a lane
picks the entry reflection (probability F_in, weight 1) or the first
exit's transmission (probability 1 - F_in, weight (1 - F_exit)
exp(-sigma_t t0)), and the tracer takes it as the next segment. As in
ppg_tpu, the exit transmittance at interior depth >= 1 is left out of the
continuation, and the interior walk stays on the owning shape's
boundary.

The loop is plain PyTorch: each segment casts a closest hit for its exit,
samples one emitter through the tracer's _sample_emitters, and computes
its fss points together ([fss, L] tensors), with one closest hit toward
the emitter sample and one any-hit from the crossing for all of them (K1
up to 1,024 triangles, K2 above). Its uniforms come in as one
[L, depth * (2 + fss) + 1] array (`n_uniforms`), taken in ppg_tpu's
column order.
"""

from __future__ import annotations

import numpy as np
import torch

from .bsdf.fresnel import fresnel_dielectric_ext
from .core.vecmath import dot

INV_FOURPI = 1.0 / (4.0 * np.pi)


class SSSArrays:
    """Per-subsurface single-scattering constants, on one device.

    params [S, 12]: sigma_s(3) sigma_t(3) g(3) eta r_min pad
    tri_ss [T] int32 owning singlescatter id per packed triangle (-1 for
    triangles without one, dipole-owned ones included). fss and depth
    (shared by every row) are the loops' trip counts.
    """

    FIELDS = ("params", "tri_ss")

    def __init__(self, params, tri_ss, num=0, fss=2, depth=4):
        self.params = params
        self.tri_ss = tri_ss
        self.num = num
        self.fss = fss
        self.depth = depth

    @classmethod
    def empty(cls, device):
        return cls(torch.zeros((1, 12), dtype=torch.float32, device=device),
                   torch.full((1,), -1, dtype=torch.int32, device=device),
                   num=0)


def n_uniforms(sss):
    """Uniforms single_scatter takes a lane: 2 (the emitter) + fss (the
    distances) a segment, and 1 for the entry's branch."""
    return sss.depth * (2 + sss.fss) + 1


def sss_params(row):
    """Host: one singlescatter spec dict -> the 12-float param row."""
    ss = np.asarray(row["sigma_s"], np.float64)
    sa = np.asarray(row["sigma_a"], np.float64)
    st = ss + sa
    g = np.asarray(row.get("g3", [row["g"]] * 3), np.float64)
    out = np.zeros(12, np.float32)
    out[0:3] = ss
    out[3:6] = st
    out[6:9] = g
    out[9] = float(row["eta"])
    # m_radius = min mean-free path (singlescatter.cpp configure())
    out[10] = float(np.min(1.0 / np.maximum(st, 1e-12)))
    return out


def build_sss(sc, dev):
    """Host: SSSArrays of the scene's singlescatter rows on dev's device;
    tri_ss is in the packed triangle order of dev's geometry, gated to
    the single-scattering rows."""
    device = dev.shade.device
    rows = [r for r in sc.subsurfaces
            if r.get("kind", "dipole") == "singlescatter"]
    if not rows:
        return SSSArrays.empty(device)
    # tri -> singlescatter id in the global subsurface id space, gated to
    # single-kind rows (dipole triangles map to -1)
    single_ids = np.full(len(sc.subsurfaces), -1, np.int32)
    params = []
    for i, r in enumerate(sc.subsurfaces):
        if r.get("kind", "dipole") == "singlescatter":
            single_ids[i] = len(params)
            params.append(sss_params(r))
    perm = dev.geom.perm.cpu().numpy()
    tri_global = (sc.tri_subsurf[perm] if len(perm)
                  else np.zeros(1, np.int32))
    tri_ss = np.where(tri_global >= 0, single_ids[tri_global], -1)
    fss = max(int(r.get("fss_samples", 2)) for r in rows)
    depth = max(int(r.get("ss_depth", 4)) for r in rows)
    return SSSArrays(
        torch.from_numpy(np.stack(params)).to(device),
        torch.from_numpy(tri_ss.astype(np.int32)).to(device),
        num=len(params), fss=max(fss, 1), depth=max(min(depth, 8), 1))


def _hg(cos_theta, g):
    """Henyey-Greenstein phase per channel (singlescatter.cpp:39-42)."""
    temp = 1.0 + g * g + 2.0 * g * cos_theta[..., None]
    return INV_FOURPI * (1.0 - g * g) / (temp * torch.sqrt(
        torch.clamp(temp, min=1e-12)))


def _atten(sigma_t, dist):
    """Per-channel Beer attenuation; channels with sigma_t == 0 pass
    through (singlescatter.cpp attenuation(), :200-207)."""
    a = torch.exp(-sigma_t * dist[..., None])
    return torch.where(sigma_t > 0, a, 1.0)


def _refract(wi, n, cos_i, cos_t, eta):
    """Specular refraction given the signed cosines from
    fresnel_dielectric_ext (bsdf.h refract): wi points away from the
    surface, n is the outward normal, eta = int/ext."""
    scale = torch.where(cos_i > 0, 1.0 / eta, eta)
    return (-scale[..., None] * wi
            + (scale * cos_i + cos_t)[..., None] * n)


def _norm(x):
    return torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=1e-12)


def _unit(x):
    return x / _norm(x)[..., None]


def single_scatter(scene, cfg, ss_id, p, d, sh_n, geo_n, u):
    """Interior single-scattering sum and boundary continuation for lanes
    hitting a singlescatter shape (ppg_tpu's single_scatter, given its
    uniforms).

    ss_id [L] int32 (-1: not a singlescatter lane), p the hit points, d
    the incoming ray direction (toward the surface), sh_n and geo_n the
    shading and geometric normals, u [L, n_uniforms(scene.sss)] uniforms.
    `cfg` is the tracer's PTConfig (unused: the emitter sample follows
    the scene). Returns (L_ss [L,3] radiance to add at throughput weight,
    cont dict(o, d, w, valid) overriding the path's next segment)."""
    from .accel.traverse import any_hit, closest_hit
    from .integrators.wavefront import _sample_emitters, decode_row, fetch_row

    sss, geom = scene.sss, scene.geom
    L = p.shape[0]
    if tuple(u.shape) != (L, n_uniforms(sss)):
        raise ValueError(f"single_scatter: want u of shape "
                         f"({L}, {n_uniforms(sss)}); got {tuple(u.shape)}")
    active = ss_id >= 0
    prm = sss.params[torch.clamp(ss_id, 0, sss.params.shape[0] - 1).long()]
    sigma_s, sigma_t, g = prm[:, 0:3], prm[:, 3:6], prm[:, 6:9]
    eta = prm[:, 9]
    r_mfp = torch.clamp(prm[:, 10], min=1e-12)
    eps = scene.eps
    zero = torch.zeros(L, dtype=torch.float32, device=p.device)
    zero_f = torch.zeros(sss.fss * L, dtype=torch.float32, device=p.device)
    zeros3 = torch.zeros((L, 3), dtype=torch.float32, device=p.device)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])

    # face-forward normals (the entry side)
    n_out = sh_n * torch.sign(dot(sh_n, -d))[:, None]
    gn_out = geo_n * torch.sign(dot(geo_n, -d))[:, None]

    wi = -d
    cos_i = dot(n_out, wi)
    F_in, cos_t_in = fresnel_dielectric_ext(cos_i, eta)
    d_int = _unit(_refract(wi, n_out, cos_i, cos_t_in, eta))

    col = 0
    L_acc = zeros3
    # segment state
    p_cur = p - gn_out * eps
    d_cur = d_int
    w_seg = torch.ones((L, 3), dtype=torch.float32,
                       device=p.device) * (1.0 - F_in)[:, None]
    seg_on = active & (F_in < 1.0)
    cont_o = cont_d = cont_w = zeros3

    for dep in range(sss.depth):
        # the exit thickness (LoSingle's forwardRay, :1332-1339)
        tri_x, t_x, bu_x, bv_x = closest_hit(
            geom, p_cur, d_cur, zero, torch.where(seg_on, 3.4e38, -1.0))
        seg_ok = seg_on & (tri_x >= 0)
        thick = torch.where(seg_ok, t_x, 1.0)
        p_x = p_cur + thick[:, None] * d_cur
        # the exit's normals from its shade row, turned to face the
        # interior ray's origin side (inward)
        n_x, gn_x = decode_row(fetch_row(scene, tri_x.clamp(min=0)), bu_x,
                               bv_x)[0:2]
        n_x = n_x * torch.sign(dot(n_x, -d_cur))[:, None]
        gn_x_out = gn_x * torch.sign(dot(gn_x, -d_cur))[:, None]

        # one emitter sample for this segment (:1405-1412), the
        # environment's only on the segment's live lanes
        ds = _sample_emitters(scene, p_cur, zeros3, u[:, col:col + 2],
                              act=seg_ok)
        col += 2
        em_ok = seg_ok & (ds["pdf"] > 0)
        # eta^2 light compression entering the medium (:1408-1410), the
        # camera side's 1/eta^2 folded in here too
        value = ds["value"] * (eta * eta)[:, None]
        L_pos = p_cur + ds["dist"][:, None] * ds["d"]

        s_max = 1.0 - torch.exp(-thick / r_mfp)
        d_samples = s_max / sss.fss
        w0 = (d_samples * r_mfp * ds["dist"] * ds["dist"])[:, None] * sigma_s

        # the segment's fss points at once, [fss, L] (point s takes column
        # col + s, as ppg_tpu takes them one after another), their casts
        # as one call of fss * L rays
        u_s = u[:, col:col + sss.fss].t()
        col += sss.fss
        dist = -torch.log(torch.clamp(1.0 - u_s * s_max, min=1e-30)) * r_mfp
        ok = em_ok & (dist <= thick)
        V = p_cur + dist[..., None] * d_cur
        # the boundary crossing toward the light (:1440-1447)
        VL = L_pos - V
        dVL = _norm(VL)
        vl = VL / dVL[..., None]
        tri_b, t_b, bu_b, bv_b = (x.view(sss.fss, L) for x in closest_hit(
            geom, flat(V), flat(vl), zero_f,
            flat(torch.where(ok, dVL * (1.0 - 1e-4), -1.0))))
        ok = ok & (tri_b >= 0)
        P = V + t_b[..., None] * vl
        n_b = decode_row(fetch_row(scene, flat(tri_b).clamp(min=0)),
                         flat(bu_b), flat(bv_b))[0].view(sss.fss, L, 3)

        # the shadow ray from the crossing to the light (:1454-1459)
        omega_l = L_pos - P
        d_l = _norm(omega_l)
        omega_l = omega_l / d_l[..., None]
        so = P + torch.sign(dot(n_b, omega_l))[..., None] * n_b * eps
        blocked = any_hit(geom, flat(so), flat(omega_l), zero_f, flat(
            torch.where(ok, d_l * (1.0 - 1e-4) - eps, -1.0))).view(sss.fss,
                                                                  L)
        ok = ok & ~blocked

        omega_v = V - P
        d_v = _norm(omega_v)
        omega_v = omega_v / d_v[..., None]
        cos_l = dot(omega_l, n_b)
        cos_v = dot(omega_v, n_b)
        ok = ok & (torch.abs(cos_l) > 1e-7) & (torch.abs(cos_v) > 1e-7)
        F_b, _ = fresnel_dielectric_ext(cos_l, eta)
        phase = _hg(dot(omega_v, d_cur), g) * _atten(sigma_t, dist + d_v)
        D = (d_v + eta * d_l) * (
            torch.abs(cos_l / torch.where(torch.abs(cos_v) > 1e-7, cos_v,
                                          1.0)) * d_v
            + torch.abs(cos_v / torch.where(torch.abs(cos_l) > 1e-7,
                                            cos_l, 1.0)) * eta * d_l)
        w = ((1.0 - F_b)[..., None] / torch.clamp(D, min=1e-12)[..., None]
             * phase * value * w0 * torch.exp(dist / r_mfp)[..., None])
        terms = torch.where(ok[..., None], w_seg * w, 0.0)
        for k in range(sss.fss):
            L_acc = L_acc + terms[k]

        # the exit event: the Fresnel split at the far boundary; n_x faces
        # the inside, so the signed inside cosine is -cos_x
        cos_x = dot(n_x, -d_cur)
        F_x, cos_t_x = fresnel_dielectric_ext(-cos_x, eta)
        att_seg = _atten(sigma_t, thick)
        if dep == 0:
            # the first exit's transmission (Lo()'s refraction branch
            # feeding the transmittance term); stepping against gn_x_out,
            # which faces inside, leaves the surface
            cont_o = p_x - gn_x_out * eps
            cont_d = _unit(_refract(-d_cur, -n_x, -cos_x, cos_t_x, eta))
            cont_w = torch.where(seg_ok[:, None],
                                 (1.0 - F_x)[:, None] * att_seg, 0.0)
        # the internal mirror reflection (:1376-1403)
        d_cur = _unit(d_cur + 2.0 * cos_x[:, None] * n_x)
        p_cur = p_x + gn_x_out * eps
        w_seg = w_seg * F_x[:, None] * att_seg
        seg_on = seg_ok & (w_seg > 1e-7).any(-1)

    # the entry's branch for the path's continuation
    pick_refl = u[:, col] < F_in
    d_refl = d - 2.0 * dot(d, n_out)[:, None] * n_out
    o_refl = p + gn_out * eps
    cont = dict(
        o=torch.where(pick_refl[:, None], o_refl, cont_o),
        d=torch.where(pick_refl[:, None], d_refl, cont_d),
        # one-sample weights: reflection F/F = 1, transmission
        # (1-F_in)(1-F_x) atten / (1-F_in) = (1-F_x) atten
        w=torch.where(pick_refl[:, None], 1.0, cont_w),
        valid=active & torch.where(pick_refl, F_in > 0,
                                   (cont_w > 0).any(-1)),
    )
    return torch.where(active[:, None], L_acc, 0.0), cont

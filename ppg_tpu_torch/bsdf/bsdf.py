"""BSDFs (counterpart of ppg_tpu/bsdf/bsdf.py, the diffuse family only).

Conventions follow Mitsuba as in ppg_tpu:
  sample(u) -> (wo, weight = f*cos/pdf, pdf, sampled_delta, eta)
  eval()    -> f * cos(theta_o) of the smooth components
  pdf()     -> solid-angle pdf of sample()
with twosided materials flipping the frame for lanes below the surface.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import warp
from ..scene.scene import MAT_DIFFUSE


class MaterialArrays:
    """Per-material parameters of a diffuse-only scene:
    reflectance [M,3] f32 and twosided [M] bool."""

    def __init__(self, reflectance, twosided):
        self.reflectance = reflectance
        self.twosided = twosided

    @classmethod
    def from_table(cls, table, device):
        mtype = np.asarray(table.mtype)
        M = len(mtype)
        if (mtype != MAT_DIFFUSE).any():
            raise NotImplementedError(
                "only diffuse materials are ported (ROADMAP Queue 1, rest "
                "of shading); the scene uses material types "
                f"{sorted(set(int(t) for t in mtype))}")
        for f in ("tex_reflectance", "tex_opacity", "tex_bump"):
            if (np.asarray(getattr(table, f))[:M] >= 0).any():
                raise NotImplementedError(
                    f"textured materials ({f}) are not ported (ROADMAP "
                    "Queue 1, rest of shading)")
        refl = np.zeros((max(M, 1), 3), np.float32)
        refl[:M] = np.asarray(table.reflectance, np.float32).reshape(M, 3)
        two = np.zeros(max(M, 1), bool)
        two[:M] = np.asarray(table.twosided, bool)[:M]
        return cls(torch.from_numpy(refl).to(device, torch.float32),
                   torch.from_numpy(two).to(device))


def gather_params(mats: MaterialArrays, mid):
    m = mid.long()
    return dict(reflectance=mats.reflectance[m], twosided=mats.twosided[m])


def lane_flags(p):
    """(smooth, delta_only, transmissive) per lane: a diffuse lane is
    smooth, never delta-only, and transmissive only when two-sided."""
    ts = p["twosided"]
    return torch.ones_like(ts), torch.zeros_like(ts), ts


def _flip_sign(p, wi):
    return torch.where(p["twosided"] & (wi[..., 2] < 0.0), -1.0, 1.0)


def _z(v, sign):
    return torch.cat([v[..., :2], (v[..., 2] * sign)[..., None]], -1)


def _eval_pdf(p, wi, wo):
    sign = _flip_sign(p, wi)
    wi_l, wo_l = _z(wi, sign), _z(wo, sign)
    both = (wi_l[..., 2] > 0) & (wo_l[..., 2] > 0)
    f = p["reflectance"] * (warp.INV_PI
                            * torch.clamp(wo_l[..., 2], min=0.0))[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo_l)
    return torch.where(both[..., None], f, 0.0), torch.where(both, pdf, 0.0)


def eval_bsdf(p, wi, wo):
    return _eval_pdf(p, wi, wo)[0]


def pdf_bsdf(p, wi, wo):
    return _eval_pdf(p, wi, wo)[1]


def sample_bsdf(p, wi, u):
    """u [L,3] (the third column is unused by the diffuse lobe).
    Returns (wo, weight, pdf, sampled_delta, eta)."""
    sign = _flip_sign(p, wi)
    ci = wi[..., 2] * sign
    wo = warp.square_to_cosine_hemisphere(u[..., :2])
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    ok = ci > 0
    weight = torch.where(ok[..., None], p["reflectance"], 0.0)
    pdf = torch.where(ok, pdf, 0.0)
    L = wi.shape[0]
    delta = torch.zeros(L, dtype=torch.bool, device=wi.device)
    eta = torch.ones(L, dtype=torch.float32, device=wi.device)
    return _z(wo, sign), weight, pdf, delta, eta

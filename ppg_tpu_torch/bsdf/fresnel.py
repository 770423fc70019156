"""Fresnel terms (counterpart of ppg_tpu/bsdf/fresnel.py), matching the
reference's exact forms (mitsuba/src/libcore/util.cpp:
fresnelDielectricExt, fresnelConductorExact, fresnelDiffuseReflectance):
the device terms as tensor functions, and the numpy
fresnel_diffuse_reflectance the scene loader needs."""

from __future__ import annotations

import numpy as np
import torch


def fresnel_dielectric_ext(cos_theta_i, eta):
    """Unpolarised Fresnel reflectance of a dielectric boundary.

    cos_theta_i is SIGNED (positive = outside). Returns (F, cos_theta_t)
    with cos_theta_t signed opposite to cos_theta_i."""
    scale = torch.where(cos_theta_i > 0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * scale * scale
    tir = cos_t2 <= 0.0
    ci = torch.abs(cos_theta_i)
    ct = torch.sqrt(torch.clamp(cos_t2, min=0.0))
    rs = (ci - eta * ct) / (ci + eta * ct)
    rp = (eta * ci - ct) / (eta * ci + ct)
    F = 0.5 * (rs * rs + rp * rp)
    F = torch.where(tir, 1.0, F)
    F = torch.where(eta == 1.0, 0.0, F)
    cos_theta_t = torch.where(cos_theta_i > 0, -ct, ct)
    cos_theta_t = torch.where(tir, 0.0, cos_theta_t)
    cos_theta_t = torch.where(eta == 1.0, -cos_theta_i, cos_theta_t)
    return F, cos_theta_t


def fresnel_conductor_exact(cos_theta_i, eta, k):
    """Exact unpolarised conductor reflectance; eta and k are [..., 3]."""
    c2 = (cos_theta_i * cos_theta_i)[..., None]
    s2 = 1.0 - c2
    s4 = s2 * s2
    t1 = eta * eta - k * k - s2
    a2pb2 = torch.sqrt(torch.clamp(t1 * t1 + 4.0 * k * k * eta * eta,
                                   min=0.0))
    a = torch.sqrt(torch.clamp((a2pb2 + t1) * 0.5, min=0.0))
    term1 = a2pb2 + c2
    term2 = 2.0 * a * torch.sqrt(c2)
    rs2 = (term1 - term2) / (term1 + term2)
    term3 = a2pb2 * c2 + s4
    term4 = term2 * s2
    rp2 = rs2 * (term3 - term4) / (term3 + term4)
    return 0.5 * (rp2 + rs2)


def fresnel_diffuse_reflectance(eta):
    """Hemispherical average of the unpolarised dielectric Fresnel
    reflectance, 2 * integral of F(mu) mu dmu (trapezoid, 2049 nodes)."""
    if eta == 1.0:
        return 0.0
    mu = np.linspace(0.0, 1.0, 2049)
    s = 1.0 / eta
    cos_t2 = 1.0 - (1.0 - mu * mu) * s * s
    ct = np.sqrt(np.maximum(cos_t2, 0.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        rs = (mu - eta * ct) / (mu + eta * ct)
        rp = (eta * mu - ct) / (eta * mu + ct)
    F = np.where(cos_t2 <= 0, 1.0, 0.5 * (rs * rs + rp * rp))
    integrand = 2.0 * mu * F
    return float(np.trapezoid(integrand, mu))

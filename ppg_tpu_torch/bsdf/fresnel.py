"""Fresnel helpers the scene loader needs (copy of the numpy
fresnel_diffuse_reflectance of ppg_tpu/bsdf/fresnel.py; the rest of that
module, the device Fresnel terms, is not ported yet: ROADMAP Queue 1
item 2a)."""

from __future__ import annotations

import numpy as np


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

"""Host-side derived material quantities.

The reference ships precomputed rough-transmittance spline tables
(data/microfacet/*.dat, loaded by rtrans.h) used by roughplastic and
roughcoating for energy bookkeeping. We compute the same quantities
numerically at scene-build time instead: the directional albedo of the
microfacet Fresnel reflection lobe (single scattering, matching the
reference's definition) via stratified Monte Carlo over the half-vector
distribution, plus its cosine-weighted average. Accuracy ~0.3% which is
below the MC noise floor of any render.

The port's own copy of ppg_tpu/bsdf/derived.py.
"""

from __future__ import annotations

import numpy as np

RT_BINS = 64


def _fresnel_dielectric(cos_i, eta):
    scale = np.where(cos_i > 0, 1.0 / eta, eta)
    c2 = 1.0 - (1.0 - cos_i * cos_i) * scale * scale
    ci = np.abs(cos_i)
    ct = np.sqrt(np.maximum(c2, 0.0))
    rs = (ci - eta * ct) / (ci + eta * ct)
    rp = (eta * ci - ct) / (eta * ci + ct)
    F = 0.5 * (rs * rs + rp * rp)
    return np.where(c2 <= 0, 1.0, F)


def _smith_g1(dist, alpha, cos_v, vm_dot):
    cos_v = np.clip(np.abs(cos_v), 1e-8, 1.0)
    tan = np.sqrt(np.maximum(1 - cos_v**2, 0)) / cos_v
    ok = vm_dot > 0
    if dist == 1:  # ggx
        g = 2.0 / (1.0 + np.sqrt(1.0 + (alpha * tan) ** 2))
    else:
        a = 1.0 / np.maximum(alpha * tan, 1e-12)
        a2 = a * a
        g = np.where(
            a >= 1.6, 1.0, (3.535 * a + 2.181 * a2) / (1 + 2.276 * a + 2.577 * a2)
        )
    return np.where(ok, np.where(tan == 0, 1.0, g), 0.0)


def rough_transmittance_table(dist, alpha, eta, bins=RT_BINS, samples=16384):
    """T(cos_theta) = 1 - directional single-scattering albedo of the rough
    Fresnel reflection lobe, on a uniform cos-theta grid in (0, 1]."""
    if alpha <= 1e-4:  # effectively smooth
        mu = (np.arange(bins) + 0.5) / bins
        return 1.0 - _fresnel_dielectric(mu, eta)

    rng = np.random.default_rng(12345)
    # stratified samples of the full distribution m ~ D(m) cos(m)
    u1 = (np.arange(samples) + rng.random(samples)) / samples
    u2 = rng.random(samples)
    phi = 2 * np.pi * u2
    a2 = alpha * alpha
    if dist == 1:  # ggx
        tan2 = a2 * u1 / np.maximum(1.0 - u1, 1e-12)
    else:
        tan2 = -a2 * np.log(np.maximum(1.0 - u1, 1e-12))
    cos_m = 1.0 / np.sqrt(1.0 + tan2)
    sin_m = np.sqrt(np.maximum(1 - cos_m**2, 0))
    m = np.stack([sin_m * np.cos(phi), sin_m * np.sin(phi), cos_m], -1)

    mu = (np.arange(bins) + 0.5) / bins
    T = np.zeros(bins)
    for i, c in enumerate(mu):
        wi = np.array([np.sqrt(max(1 - c * c, 0.0)), 0.0, c])
        im = m @ wi
        wo = 2 * im[:, None] * m - wi
        valid = (im > 0) & (wo[:, 2] > 0)
        F = _fresnel_dielectric(im, eta)
        G = _smith_g1(dist, alpha, c, im) * _smith_g1(
            dist, alpha, wo[:, 2], (wo * m).sum(-1)
        )
        est = np.where(valid, F * G * im / np.maximum(c * cos_m, 1e-12), 0.0)
        T[i] = 1.0 - est.mean()
    return np.clip(T, 0.0, 1.0)


def diffuse_transmittance(table):
    """Cosine-weighted average of a T(cos) table: integral T(mu) 2 mu dmu."""
    bins = len(table)
    mu = (np.arange(bins) + 0.5) / bins
    return float(np.sum(table * 2 * mu) / bins)

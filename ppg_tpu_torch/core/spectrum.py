"""Spectral power distribution -> linear RGB conversion (Mitsuba RGB mode).

Replicates the behavior of the reference's 3-sample RGB pipeline
(reference: mitsuba/src/libcore/spectrum.cpp:172-229): scene XML spectra
given as wavelength:value pairs are zero-extended, convolved against the
CIE 1931 standard observer, normalized by the CIE Y integral, and mapped
XYZ -> ITU-R Rec. BT.709 linear RGB. The CIE 1931 2-degree tables are the
public standard dataset (360..830nm at 1nm), stored in data/cie1931.npz.

The port's own copy of ppg_tpu/core/spectrum.py.
"""

from __future__ import annotations

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "..", "data", "cie1931.npz")
_cie = None


def _cie_tables():
    global _cie
    if _cie is None:
        _cie = np.load(_DATA)
    return _cie


# XYZ <-> ITU-R Rec. BT.709 linear RGB (reference spectrum.cpp:221-236)
XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)


def xyz_to_rgb(xyz):
    return np.asarray(xyz) @ XYZ_TO_RGB.T


def rgb_to_xyz(rgb):
    return np.asarray(rgb) @ RGB_TO_XYZ.T


def luminance(rgb):
    rgb = np.asarray(rgb)
    return rgb @ RGB_TO_XYZ[1]


class InterpolatedSpectrum:
    """Piecewise-linear spectrum over increasing wavelengths (nm)."""

    def __init__(self, wavelengths, values):
        self.wl = np.asarray(wavelengths, np.float64)
        self.v = np.asarray(values, np.float64)
        if np.any(np.diff(self.wl) <= 0):
            raise ValueError("wavelengths must be strictly increasing")

    def zero_extend(self):
        """Append zero-valued endpoints one average-spacing beyond the range
        (reference spectrum.cpp:630-648)."""
        if len(self.wl) < 2:
            raise ValueError("need at least 2 entries")
        spacing = np.mean(np.diff(self.wl))
        wl, v = list(self.wl), list(self.v)
        if v[0] != 0:
            wl.insert(0, wl[0] - spacing)
            v.insert(0, 0.0)
        if v[-1] != 0:
            wl.append(wl[-1] + spacing)
            v.append(0.0)
        self.wl, self.v = np.array(wl), np.array(v)
        return self

    def eval(self, lam):
        """Pointwise evaluation replicating the reference's
        InterpolatedSpectrum::eval (spectrum.cpp:689-711) — which passes its
        interpolants to math::lerp in REVERSED order, so every segment is
        linearly interpolated backwards: eval(a..b) runs from f(b) to f(a).
        This quirk measurably changes the RGB conversion of coarse spectra
        (e.g. the cbox emitter, knots every 100nm) and must be replicated
        for golden-image parity. Exact knot hits return the knot value."""
        lam = np.asarray(lam, np.float64)
        out = np.zeros_like(lam)
        inside = (lam >= self.wl[0]) & (lam <= self.wl[-1])
        seg = np.clip(np.searchsorted(self.wl, lam, "right") - 1, 0, len(self.wl) - 2)
        a, b = self.wl[seg], self.wl[seg + 1]
        fa, fb = self.v[seg], self.v[seg + 1]
        t = (lam - a) / (b - a)
        out = np.where(inside, (1.0 - t) * fb + t * fa, 0.0)  # reversed lerp
        exact = inside & np.isin(lam, self.wl)
        if np.any(exact):
            idx = np.searchsorted(self.wl, lam)
            out = np.where(exact, self.v[np.clip(idx, 0, len(self.v) - 1)], out)
        return out


def _product_average(spec: InterpolatedSpectrum, cie_vals, cie_wl):
    """Average of spec(lambda)*cie(lambda) over the CIE range, matching the
    reference's ProductSpectrum + Gauss-Lobatto integration
    (spectrum.cpp:176-181,546-569) including the reversed-lerp eval quirk.
    Integrates on the union of both sample grids; within each sub-interval
    both factors are linear (reversed or not), the product is quadratic,
    handled exactly with Simpson. Knot discontinuities are measure-zero, so
    endpoints are evaluated via the containing segment's formula."""
    lo, hi = cie_wl[0], cie_wl[-1]
    grid = np.union1d(np.clip(spec.wl, lo, hi), cie_wl)
    cie = InterpolatedSpectrum(cie_wl, cie_vals)
    g0, g1 = grid[:-1], grid[1:]
    mid = 0.5 * (g0 + g1)
    # evaluate endpoint limits from within each sub-interval (nudge inward)
    h = (g1 - g0) * 1e-7
    fa = spec.eval(g0 + h) * cie.eval(g0 + h)
    fm = spec.eval(mid) * cie.eval(mid)
    fb = spec.eval(g1 - h) * cie.eval(g1 - h)
    integral = np.sum((g1 - g0) / 6.0 * (fa + 4 * fm + fb))
    return integral / (hi - lo)


def spectrum_to_rgb(wavelengths, values, zero_extend=True):
    """Convert a wavelength:value spectrum to linear RGB exactly as the
    reference's RGB-mode `fromContinuousSpectrum` does, including negative
    clamping (scenehandler.cpp:609-613)."""
    spec = InterpolatedSpectrum(wavelengths, values)
    if zero_extend:
        spec.zero_extend()
    t = _cie_tables()
    X = _product_average(spec, t["x"], t["wavelengths"])
    Y = _product_average(spec, t["y"], t["wavelengths"])
    Z = _product_average(spec, t["z"], t["wavelengths"])
    ynorm = np.trapezoid(t["y"], t["wavelengths"]) / (
        t["wavelengths"][-1] - t["wavelengths"][0]
    )
    xyz = np.array([X, Y, Z]) / ynorm
    return np.maximum(xyz_to_rgb(xyz), 0.0)


def d65_rgb():
    """CIE D65 illuminant, normalized to unit luminance, as linear RGB
    (reference spectrum.cpp:127-128)."""
    t = _cie_tables()
    rgb = spectrum_to_rgb(t["wavelengths"], t["d65"], zero_extend=False)
    return rgb / luminance(rgb)


def blackbody_rgb(temperature, scale=1.0):
    """Blackbody emission spectrum -> RGB (radiance units of the reference:
    W / (m^2 * sr * nm), spectrum.h BlackBodySpectrum)."""
    t = _cie_tables()
    wl = t["wavelengths"]
    lam = wl * 1e-9
    h, c, kb = 6.62607004e-34, 299792458.0, 1.38064852e-23
    I = (2 * h * c * c) / (lam**5 * (np.exp(h * c / (lam * kb * temperature)) - 1))
    I *= 1e-9  # per nm
    return np.maximum(spectrum_to_rgb(wl, I, zero_extend=False) * scale, 0.0)

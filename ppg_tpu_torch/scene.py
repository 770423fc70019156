"""Scene loading without JAX.

Both packages build from the same host scene object returned by
ppg_tpu.scene.scene.load_scene. That loader is numpy code, but while it
derives per-material constants it imports ppg_tpu.bsdf.fresnel, whose
module top imports jax.numpy, only to call fresnel_diffuse_reflectance,
a numpy function. `load_scene` and `mini_cbox` here run the shared loader
with that one module supplied by a numpy-only stand-in holding a copy of
the function, and restore the module table afterwards, so the port never
imports JAX and ppg_tpu's own imports are untouched. The stand-in goes
once the fresnel module imports JAX lazily (ROADMAP).
"""

from __future__ import annotations

import contextlib
import sys
import types

import numpy as np

_FRESNEL = "ppg_tpu.bsdf.fresnel"


def fresnel_diffuse_reflectance(eta):
    """Copy of ppg_tpu.bsdf.fresnel.fresnel_diffuse_reflectance (numpy)."""
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


@contextlib.contextmanager
def _numpy_fresnel():
    if _FRESNEL in sys.modules:  # already imported by ppg_tpu itself
        yield
        return
    import ppg_tpu.bsdf as pkg

    stub = types.ModuleType(_FRESNEL)
    stub.fresnel_diffuse_reflectance = fresnel_diffuse_reflectance
    sys.modules[_FRESNEL] = stub
    try:
        yield
    finally:
        sys.modules.pop(_FRESNEL, None)
        if getattr(pkg, "fresnel", None) is stub:
            del pkg.fresnel


def load_scene(path, defaults=None):
    from ppg_tpu.scene.scene import load_scene as _load

    with _numpy_fresnel():
        return _load(path, defaults)


def mini_cbox(res=64, budget=16, max_depth=6, nee="never"):
    """The built-in Cornell box of ppg_tpu.scene.testscenes."""
    from ppg_tpu.scene.testscenes import MINI_CBOX, scene_from_xml

    with _numpy_fresnel():
        return scene_from_xml(MINI_CBOX.format(
            res=res, budget=budget, max_depth=max_depth, nee=nee))

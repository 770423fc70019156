"""The learned bsdf sampling fraction's inputs in the port: the BSDF pdf
that guide-mix vertices record, and the per-iteration NEE schedule and
tracer configuration against ppg_tpu's.

Guide-mix vertices record bsdfPdf at the direction actually taken, as
Mitsuba's pdfMat does. ppg_tpu (integrators/wavefront.py:844) records the
pdf of the BSDF sample drawn for the mixture even where the tree's
direction was taken; the port deliberately does not copy that, so the
first test holds the port to the reference's definition, not to
ppg_tpu."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from ppg_tpu.integrators.guided import GuidedPathTracer as JTracer
from ppg_tpu_torch.accel.brute import INF
from ppg_tpu_torch.accel.traverse import closest_hit
from ppg_tpu_torch.bsdf import bsdf as B
from ppg_tpu_torch.core.vecmath import build_frame, to_local
from ppg_tpu_torch.device import generator
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators import wavefront as W
from ppg_tpu_torch.integrators.guided import GuidedPathTracer as TTracer
from ppg_tpu_torch.scene import mini_cbox


def test_guide_mix_vertices_record_bsdf_pdf_at_taken_direction():
    """On a built tree, every valid guide-mix vertex's bsdf_pdf equals
    pdf_bsdf(params, wi, wo) at its recorded direction, within 1e-6: the
    direction goes to world space and back (one rounding per step), and
    the diffuse pdf is wo.z / pi."""
    sc = mini_cbox(res=16, budget=7, max_depth=5)
    tracer = TTracer(sc, chunk=256, overrides=dict(sppPerPass=1),
                     device="cpu")
    tracer.render(seed=0)
    sdtree = tracer.sdtree  # built after the last iteration
    cfg = dataclasses.replace(tracer._cfg(True, False, False),
                              splat_spatial="", splat_dir="")
    scene = tracer.scene_dev
    gen = generator(5, "cpu")
    _, _, (o, d, t_min, t_max) = TD.chunk_pixels(tracer.sensor, 256, 0, gen)
    out = W.trace_paths(scene, cfg, gen, o, d, t_min, t_max, sdtree=sdtree)
    vert = out["vertices"]["bsdf"]
    checked = 0
    for j in range(vert["d"].shape[0]):
        # the shading point of vertex j is where the previous ray hit
        tri, _, bu, bv = closest_hit(scene.geom, o, d, t_min, t_max)
        sh_n, _, mid, _, _ = W.decode_row(W.fetch_row(scene, tri.clamp(min=0)),
                                          bu, bv)
        s_ax, t_ax = build_frame(sh_n)
        params = B.gather_params(scene.mats, mid)
        wi = to_local(s_ax, t_ax, sh_n, -d)
        wo = to_local(s_ax, t_ax, sh_n, vert["d"][j])
        want = B.pdf_bsdf(params, wi, wo)
        mix = vert["valid"][j] & (vert["dtree_pdf"][j] > 0)
        np.testing.assert_allclose(vert["bsdf_pdf"][j][mix].numpy(),
                                   want[mix].numpy(), rtol=1e-6, atol=1e-6)
        checked += int(mix.sum())
        o, d = vert["p"][j], vert["d"][j]
        t_min, t_max = torch.zeros_like(t_min), torch.full_like(t_max, INF)
    assert checked > 200


def test_delta_only_lanes_reflect_with_probability_f(monkeypatch):
    """Lanes without the guide mix sample the BSDF with the first uniform
    as drawn, as Mitsuba's sampleMat does (guided_path.cpp:1654). So on a
    built tree with a BSDF fraction of 0.5 a smooth dielectric (a
    delta-only family: never in the mix) reflects with probability F.
    ppg_tpu rescales that uniform by the fraction on every lane
    (wavefront.py:793-795): there it reflects with probability 0.5 F
    while its weight still divides by F. Over every dielectric lane of
    one wavefront on a built tree (the box's white surfaces as glass of
    IOR 3), the count of reflections is held to the sum of F: |z| < 4 in
    units of its standard deviation (the rescaling puts z below -20)."""
    from ppg_tpu_torch.bsdf.fresnel import fresnel_dielectric_ext
    from ppg_tpu_torch.scene.scene import MAT_DIELECTRIC
    from ppg_tpu_torch.scene.testscenes import MINI_CBOX, scene_from_xml

    white = ('<bsdf type="diffuse" id="white"><rgb name="reflectance" '
             'value="0.8, 0.8, 0.8"/></bsdf>')
    xml = MINI_CBOX.format(res=32, budget=4, max_depth=6, nee="never")
    assert white in xml
    sc = scene_from_xml(xml.replace(
        white, '<bsdf type="dielectric" id="white"><float name="intIOR" '
               'value="3.0"/></bsdf>'))
    tracer = TTracer(sc, chunk=1024, device="cpu")
    tracer.render(seed=0)
    cfg = tracer._cfg(True, False, False)
    assert cfg.guiding and cfg.is_built and tracer.sdtree is not None
    assert cfg.bsdf_fraction == 0.5
    sample, n, f_sum, var, refl = B.sample_bsdf, [0], [0.0], [0.0], [0]

    def record(p, wi, u, present=None):
        out = sample(p, wi, u, present)
        glass = p["mtype"] == MAT_DIELECTRIC
        ci = wi[..., 2] * B._flip_sign(p, wi)
        F = fresnel_dielectric_ext(ci, p["eta_rel"])[0].double()[glass]
        n[0] += int(glass.sum())
        f_sum[0] += float(F.sum())
        var[0] += float((F * (1.0 - F)).sum())
        refl[0] += int((out[3] & (out[4] == 1.0))[glass].sum())
        return out

    monkeypatch.setattr(B, "sample_bsdf", record)
    gen = generator(6, "cpu")
    _, _, rays = TD.chunk_pixels(tracer.sensor, 1024, 0, gen)
    W.trace_paths(tracer.scene_dev, cfg, gen, *rays, sdtree=tracer.sdtree)
    z = (refl[0] - f_sum[0]) / var[0] ** 0.5
    assert n[0] > 2000 and abs(z) < 4, (n[0], refl[0], f_sum[0], z)


@pytest.fixture(scope="module")
def tracers():
    sc = mini_cbox(res=8, budget=16, max_depth=4)
    return TTracer(sc, chunk=64, device="cpu"), JTracer(sc, chunk=64)


_PORTED = ("do_nee", "nee_always", "guiding", "is_built", "record_vertices",
           "learn_fraction", "bsdf_fraction", "splat_spatial", "splat_dir",
           "max_depth", "rr_depth")


@pytest.mark.parametrize("nee", ["never", "kickstart", "always"])
def test_do_nee_and_cfg_match(tracers, nee):
    """doNeeWithSpp and the per-pass configuration equal ppg_tpu's for
    every (spatial filter, directional filter, loss) and every
    (is_built, do_nee, is_final)."""
    port, ref = tracers
    n = 0
    for sf, df, loss in itertools.product(("nearest", "stochastic", "box"),
                                          ("nearest", "box"),
                                          ("none", "kl", "var")):
        for tr in (port, ref):
            tr.nee, tr.spatial_filter, tr.directional_filter, tr.loss = \
                nee, sf, df, loss
        for spp in (0, 1, 127, 128, 1000):
            assert port._do_nee(spp) == ref._do_nee(spp), (nee, spp)
        for flags in itertools.product((False, True), repeat=3):
            a, b = port._cfg(*flags), ref._cfg(*flags)
            for f in _PORTED:
                assert getattr(a, f) == getattr(b, f), (sf, df, loss, flags, f)
            n += 1
    assert n == 3 * 2 * 3 * 8

"""The material wrappers at the shading site (ppg_tpu_torch/bsdf/
wrappers.py) and in the tracer.

- Refusals: MaterialArrays.from_table raises NotImplementedError, naming
  the nest, for each nest ppg_tpu does not compute consistently: a blend
  child that is a wrapper or has a delta lobe, a coating over anything
  but a leaf, a mask over a mask or a null.
- The nests the port composes as Mitsuba does where ppg_tpu does not: a
  mask over a blend or over a coating keeps its pass-through lobe (wo =
  -wi, weight (1 - opacity) / (1 - prob), pdf 1 - prob, delta, eta 1)
  and scales the nested lobe (weight by opacity / prob, pdf by prob);
  held lane by lane against the unmasked nest's site on the same
  uniforms, within 1e-6 relative (one float32 product and quotient
  apart), and the lanes' resolved flags.
- Call counts: one guided bounce on a built tree of mini_cbox_wrappers
  makes one sample_bsdf call and two eval_pdf_bsdf calls.
- One bounce with QMC: a sobol render (maxDepth 2, nee always, unguided,
  32 x 32, 1 spp) of mini_cbox_wrappers with every distribution Beckmann
  (GGX's visible normals differ from ppg_tpu's by design), through both
  packages with the mask, blend and coating picks at the same sobol
  dimensions: every pixel within 1e-5 relative (above 1e-3 of the
  value), the largest seen 3.7e-7 (105 of the 1,024 pixels are lit at
  one bounce: the luminaire faces the ceiling); the Beckmann normals'
  erfinv and the libms' exp and pow are the only differences. ppg_tpu
  runs eagerly (jax.disable_jit), which costs less here than compiling
  its tracer.
- Guided against unguided: mini_cbox_wrappers at 64 x 64 with nee
  always, the gates of tests/test_regen.py:29-45 (means within 5%,
  median 8x8 block difference below 0.25): seed 1, 16 spp unguided, seed
  0 and a 15-spp budget guided. Margins on the CPU: 0.3% and 0.137.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ppg_tpu.integrators import driver as JD
from ppg_tpu.scene.testscenes import scene_from_xml as j_scene_from_xml
from ppg_tpu_torch.bsdf import bsdf as B
from ppg_tpu_torch.bsdf import wrappers as WR
from ppg_tpu_torch.device import generator
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators import wavefront as W
from ppg_tpu_torch.integrators.guided import GuidedPathTracer as TTracer
from ppg_tpu_torch.scene.scene import MaterialBuilder, TextureBuilder
from ppg_tpu_torch.scene.testscenes import (mini_cbox_wrappers,
                                            mini_cbox_wrappers_xml,
                                            scene_from_xml)
from ppg_tpu_torch.scene.xml_parser import PluginSpec as P
from ppg_tpu_torch.scene.xml_parser import Spectrum
from test_torch_render import assert_images_agree


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(otype, **props):
    return P("bsdf", otype, dict(props))


def _mask(child, op=0.6):
    return P("bsdf", "mask", {"opacity": Spectrum(rgb=np.full(3, op))},
             [child])


def _blend(a, b, w=0.3):
    return P("bsdf", "blendbsdf", {"weight": w}, [a, b])


def _coat(child, otype="coating", **props):
    return P("bsdf", otype, dict(props), [child])


def _table(*specs):
    mb = MaterialBuilder(TextureBuilder(None))
    rows = [mb.add(s) for s in specs]
    return rows, mb.finalize()


REFUSED = {
    "blend-of-mask": _blend(_mask(_leaf("diffuse")), _leaf("diffuse")),
    "blend-of-null": _blend(_leaf("diffuse"), _leaf("null")),
    "blend-of-blend": _blend(_leaf("diffuse"),
                             _blend(_leaf("diffuse"), _leaf("diffuse"))),
    "blend-of-coating": _blend(_leaf("diffuse"), _coat(_leaf("diffuse"))),
    "blend-of-roughcoating": _blend(
        _coat(_leaf("diffuse"), "roughcoating"), _leaf("diffuse")),
    "blend-of-conductor": _blend(_leaf("diffuse"), _leaf("conductor")),
    "blend-of-dielectric": _blend(_leaf("dielectric"), _leaf("diffuse")),
    "blend-of-thindielectric": _blend(_leaf("diffuse"),
                                      _leaf("thindielectric")),
    "blend-of-plastic": _blend(_leaf("diffuse"), _leaf("plastic")),
    "blend-of-hk": _blend(_leaf("diffuse"), _leaf("hk")),
    "coating-of-mask": _coat(_mask(_leaf("diffuse"))),
    "coating-of-null": _coat(_leaf("null")),
    "coating-of-blend": _coat(_blend(_leaf("diffuse"), _leaf("diffuse"))),
    "roughcoating-of-coating": _coat(_coat(_leaf("diffuse")),
                                     "roughcoating"),
    "mask-of-mask": _mask(_mask(_leaf("diffuse"))),
    "mask-of-null": _mask(_leaf("null")),
}


@pytest.mark.parametrize("nest", sorted(REFUSED))
def test_from_table_refuses_the_nest(nest):
    outer, inner = nest.split("-of-")
    _, table = _table(REFUSED[nest])
    with pytest.raises(NotImplementedError) as err:
        B.MaterialArrays.from_table(table, "cpu")
    msg = str(err.value)
    assert (inner in msg and ("blendbsdf" in msg if outer == "blend"
                              else outer in msg)), msg


L = 4000


def _sites(spec_plain, spec_masked, seed):
    """The site of a nest and of the same nest under a mask (opacity
    0.6), both on L lanes of the same wi and uniforms."""
    rows, table = _table(spec_plain, spec_masked)
    mats = B.MaterialArrays.from_table(table, "cpu")
    rng = np.random.default_rng(seed)
    wi = rng.normal(size=(L, 3)).astype(np.float32)
    wi[:, 2] = np.abs(wi[:, 2])
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wi = torch.from_numpy(wi)
    u_m, u_b = (torch.from_numpy(rng.random(L).astype(np.float32))
                for _ in range(2))
    u_c = torch.from_numpy(rng.random((L, 1)).astype(np.float32))
    u = torch.from_numpy(rng.random((L, 3)).astype(np.float32))
    out = []
    for r in rows:
        mid = torch.full((L,), r, dtype=torch.int32)
        site = WR.Site(mats, mid, wi, u_m, u_b, u_c)
        wo, w, pdf, delta, eta = site.sample(u)
        w, pdf = site.finish(w, pdf, *site.eval_pdf(wo))
        out.append((site, wo, w, pdf, delta, eta))
    return wi, out


NESTS = {
    "blend": _blend(_leaf("diffuse"), _leaf("roughplastic", alpha=0.2)),
    "coating": _coat(_leaf("diffuse")),
    "roughcoating": _coat(_leaf("roughconductor", alpha=0.3),
                          "roughcoating", alpha=0.2),
}


@pytest.mark.parametrize("nest", sorted(NESTS))
def test_mask_over_a_nest_keeps_its_lobes(nest):
    spec = NESTS[nest]
    wi, ((s0, wo0, w0, p0, d0, e0), (s1, wo1, w1, p1, d1, e1)) = _sites(
        spec, _mask(spec), len(nest))
    o = 0.6
    q = float(np.float32(0.6 * 0.212671 + 0.6 * 0.715160 + 0.6 * 0.072169))
    pt, g = s1.pass_thru, s1.go_nested
    assert 0.3 * L < int(pt.sum()) < 0.5 * L and bool((pt ^ g).all())
    # the pass-through lobe
    assert torch.equal(wo1[pt], -wi[pt]) and bool(d1[pt].all())
    assert bool((e1[pt] == 1.0).all())
    np.testing.assert_allclose(p1[pt].numpy(), 1.0 - q, rtol=1e-6)
    np.testing.assert_allclose(w1[pt].numpy(), (1.0 - o) / (1.0 - q),
                               rtol=1e-6)
    # the nested lobe, scaled
    assert torch.equal(wo1[g], wo0[g]) and torch.equal(d1[g], d0[g])
    assert torch.equal(e1[g], e0[g])
    np.testing.assert_allclose(p1[g].numpy(), (p0[g] * q).numpy(),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(w1[g].numpy(), (w0[g] * o / q).numpy(),
                               rtol=1e-6, atol=1e-12)
    assert int((w0[g] > 0).any(-1).sum()) > 0.3 * L
    # the resolved flags: the nest's, transmissive under the mask
    for k in (0, 1):
        assert torch.equal(s1.flags[k], s0.flags[k])
    assert bool(s1.flags[3].all())


def test_a_guided_bounce_makes_one_sample_and_two_evals(monkeypatch):
    sc = mini_cbox_wrappers(res=16, budget=4, nee="always", spheres=False)
    tracer = TTracer(sc, chunk=256, device="cpu")
    tracer.render(seed=0)
    cfg = dataclasses.replace(tracer._cfg(True, True, False), max_depth=2)
    assert cfg.guiding and cfg.is_built and cfg.do_nee and cfg.n_bounces == 1
    calls = {"sample_bsdf": 0, "eval_pdf_bsdf": 0}
    for name in calls:
        fn = getattr(B, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(B, name, counted)
    gen = generator(3, "cpu")
    _, _, rays = TD.chunk_pixels(tracer.sensor, 256, 0, gen)
    out = W.trace_paths(tracer.scene_dev, cfg, gen, *rays,
                        sdtree=tracer.sdtree)
    assert calls == {"sample_bsdf": 1, "eval_pdf_bsdf": 2}
    assert bool(torch.isfinite(out["li"]).all())


def test_one_bounce_sobol_render_matches_ppg_tpu():
    xml = mini_cbox_wrappers_xml(res=32, max_depth=2, nee="always",
                                 spheres=False, ggx=False)
    xml = xml.replace('<sampler type="independent">',
                      '<sampler type="sobol">')
    img_t = TD.render(scene_from_xml(xml), spp=1, seed=1, chunk=1024,
                      device="cpu")
    with jax.disable_jit():
        img_j = np.asarray(JD.render(j_scene_from_xml(xml), spp=1, seed=1,
                                     chunk=1024))
    lit = (img_j > 0).any(-1)
    assert lit.sum() > 100 and img_t.mean() > 0
    rel = np.abs(img_t - img_j) / np.maximum(np.abs(img_j), 1e-3)
    assert rel.max() <= 1e-5, rel.max()


def test_guided_wrappers_render_agrees_with_unguided():
    xml = mini_cbox_wrappers_xml(res=64, budget=15, nee="always",
                                 spheres=False)
    sc = scene_from_xml(xml)
    ref = TD.render(sc, spp=16, seed=1, chunk=4096, device="cpu")
    tracer = TTracer(sc, chunk=4096, device="cpu")
    img = tracer.render(seed=0)
    assert [(s["passes"], s["is_final"]) for s in tracer.stats] == [
        (1, False), (3, True)]
    assert np.isfinite(img).all() and img.mean() > 0
    assert tracer.tree_stats[-1]["n_dtrees"] > 1
    assert_images_agree(ref, img)

"""The port's coating and roughcoating (ppg_tpu_torch/bsdf/layered.py)
against ppg_tpu's (ppg_tpu/bsdf/layered.py), and the reference's own
layered tests (tests/test_layered.py, marked slow there) ported to the
port.

Against ppg_tpu, on tests/test_layered.py's five CASES, each on both of
its WI_LIST entries and on a wi below the surface, plus a two-sided
roughcoating: the rows are ppg_tpu's (its MaterialBuilder and
MaterialArrays, carried over by convert.materials_from_numpy), wo and the
uniforms come from a numpy seed, N_LANES lanes a case and wi.
- eval and pdf: within EVAL_RTOL 2e-5 of each value and EVAL_ATOL 1e-6 of
  the case's largest value. The closed forms are the same; XLA's and
  ATen's float32 exp, sqrt and pow differ by a few ulp each, and the
  coating chains the Fresnel terms, the rough-transmittance lookup and
  the absorption's exp (largest seen 1.5e-6 relative).
- sample, on the Beckmann cases (every case but the GGX roughcoating,
  whose interface normals take Heitz's basis in the port and another in
  ppg_tpu, ROADMAP Queue 3): wo within SAMPLE_WO_ATOL 1e-4, weight and
  pdf within SAMPLE_RTOL 2e-3 (relative, above 1e-6 of the largest),
  delta and eta exactly. These are tests/test_torch_bsdf.py's sample
  tolerances and for its reasons: the Beckmann visible normals run 12
  rounds over XLA's and ATen's different erfinv, and a normal 1e-6 apart
  moves a narrow lobe's weight and pdf by up to some 6e-4 (largest seen
  here: wo 2.1e-5, weight 6.2e-4, pdf 6.6e-4).

Ported from tests/test_layered.py: the consistency of sample with
eval_pdf (95% quantiles of the relative errors below 5e-3 and 1e-2), the
energy bound of a clear coat over a white diffuse, and a chi-square test
of each case on both wi (tests/chi2util.py, significance 0.01, Sidak over
every run here), with the sample counts of the reference. Beyond the
reference's cases: wi below the surface (a two-sided Beckmann
roughcoating over a diffuse, and a one-sided GGX roughcoating over a
roughconductor, whose interface lobe mirrors below), and the GGX
roughcoating near grazing incidence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.bsdf import bsdf as JB
from ppg_tpu.bsdf import layered as JLY
from ppg_tpu.scene.scene import MaterialBuilder as JBuilder
from ppg_tpu.scene.scene import TextureBuilder as JTextures
from ppg_tpu.scene.xml_parser import PluginSpec as JSpec
from ppg_tpu.scene.xml_parser import Spectrum as JSpectrum
from ppg_tpu_torch.bsdf import bsdf as B
from ppg_tpu_torch.bsdf import layered as LY
from ppg_tpu_torch.convert import materials_from_numpy
from ppg_tpu_torch.scene.scene import MaterialBuilder, TextureBuilder
from ppg_tpu_torch.scene.xml_parser import PluginSpec, Spectrum

EVAL_RTOL, EVAL_ATOL = 2e-5, 1e-6
SAMPLE_WO_ATOL, SAMPLE_RTOL = 1e-4, 2e-3
N_LANES = 1000

# tests/test_layered.py's CASES: (type, props, nested type, nested props)
CASES = [
    ("coating", {"intIOR": 1.5}, "roughconductor", {"alpha": 0.3}),
    ("coating", {"intIOR": 1.7, "sigmaA": np.array([0.1, 0.2, 0.5]),
                 "thickness": 1.0}, "diffuse", {}),
    ("coating", {}, "conductor", {}),
    ("roughcoating", {"alpha": 0.2}, "diffuse", {}),
    ("roughcoating", {"alpha": 0.1, "distribution": "ggx"},
     "roughconductor", {"alpha": 0.3}),
]
GGX_CASES = {4}
# a two-sided Beckmann roughcoating over a diffuse (the loader marks the
# coat row and its nested row two-sided)
TWOSIDED = ("roughcoating", {"alpha": 0.2}, "diffuse", {}, True)
WI_LIST = [np.array([0.0, 0.0, 1.0]), np.array([0.6, 0.0, 0.8])]
WI_BELOW = np.array([0.3, -0.2, -0.932738])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """With several test workers on one host, intra-op threads contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(case, P, S):
    otype, props, n_otype, n_props = case[:4]
    conv = lambda v: S(rgb=np.asarray(v)) if isinstance(v, np.ndarray) else v
    spec = P("bsdf", otype, {k: conv(v) for k, v in props.items()},
             [P("bsdf", n_otype, {k: conv(v) for k, v in n_props.items()})])
    if len(case) > 4 and case[4]:
        spec = P("bsdf", "twosided", {}, [spec])
    return spec


def port_rows(case, L):
    """The coat rows and their nested rows on L lanes, from the port's own
    loader, and the nested families."""
    mb = MaterialBuilder(TextureBuilder(None))
    spec = _spec(case, PluginSpec, Spectrum)
    row = mb.add(spec)
    mats = B.MaterialArrays.from_table(mb.finalize(), "cpu")
    p = B.gather_params(mats, torch.full((L,), row, dtype=torch.int32))
    pn = B.gather_params(mats, torch.clamp(p["nested"], min=0))
    return p, pn, mats.wrappers.leaf_present


def both_rows(case, L):
    """ppg_tpu's rows of the case on L lanes and the port's, fed them."""
    mb = JBuilder(JTextures(None))
    spec = _spec(case, JSpec, JSpectrum)
    row = mb.add(spec)
    jm = JB.MaterialArrays.from_table(mb.finalize())
    tm = materials_from_numpy(np.asarray(jm.packed), jm.present, "cpu")
    ids = np.full(L, row, np.int32)
    jp = JB.gather_params(jm, jnp.asarray(ids))
    jpn = JB.gather_params(jm, jnp.maximum(jp["nested"], 0))
    tp = B.gather_params(tm, torch.from_numpy(ids))
    tpn = B.gather_params(tm, torch.clamp(tp["nested"], min=0))
    return (jp, jpn), (tp, tpn)


def _close(a, b, rtol, atol_frac):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = atol_frac * max(np.abs(a).max(), 1e-30)
    return np.abs(a - b) <= rtol * np.abs(a) + atol


# each case and the two-sided row on both WI_LIST entries and on
# WI_BELOW, N_LANES lanes each, in one call (one shape for every call:
# ppg_tpu's eager operations compile once a shape)
ALL = list(range(len(CASES) + 1))


def _case(i):
    return TWOSIDED if i == len(CASES) else CASES[i]


def _wi(i):
    """The lanes' wi [len(wis) * N_LANES, 3] and which wi each lane has."""
    wis = WI_LIST + [WI_BELOW]
    k = np.repeat(np.arange(len(wis)), N_LANES)
    return np.stack(wis).astype(np.float32)[k], k


@pytest.mark.parametrize("ci", ALL)
def test_eval_pdf_match_ppg_tpu(ci):
    case = _case(ci)
    wi_l, k = _wi(ci)
    (jp, jpn), (tp, tpn) = both_rows(case, len(k))
    rng = np.random.default_rng(100 + ci)
    wo = rng.normal(size=wi_l.shape).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    fj, pj = JLY.eval_pdf(jp, jpn, jnp.asarray(wi_l), jnp.asarray(wo))
    ft, pt = LY.eval_pdf(tp, tpn, torch.from_numpy(wi_l),
                         torch.from_numpy(wo))
    fj, pj = np.asarray(fj), np.asarray(pj)
    # a smooth coating over a smooth conductor has no smooth lobe; below
    # the surface a one-sided coating has little
    for w in range(k.max()):
        assert ((pj[k == w] > 0).sum() > N_LANES // 20
                or case[2] == "conductor"), w
    assert _close(fj, ft.numpy(), EVAL_RTOL, EVAL_ATOL).all()
    assert _close(pj, pt.numpy(), EVAL_RTOL, EVAL_ATOL).all()


SAMPLED = [i for i in ALL if i not in GGX_CASES]


@pytest.mark.parametrize("ci", SAMPLED)
def test_sample_matches_ppg_tpu(ci):
    case = _case(ci)
    wi_l, k = _wi(ci)
    (jp, jpn), (tp, tpn) = both_rows(case, len(k))
    u = np.random.default_rng(200 + ci).random(
        (len(k), 4)).astype(np.float32)
    j = [np.asarray(x) for x in JLY.sample(jp, jpn, jnp.asarray(wi_l),
                                           jnp.asarray(u))]
    t = [x.numpy() for x in LY.sample(tp, tpn, torch.from_numpy(wi_l),
                                      torch.from_numpy(u))]
    np.testing.assert_array_equal(j[3], t[3])  # sampled delta
    np.testing.assert_array_equal(j[4], t[4])  # eta
    live = j[2] > 0
    np.testing.assert_array_equal(live, t[2] > 0)
    assert np.abs(j[0][live] - t[0][live]).max(initial=0) <= SAMPLE_WO_ATOL
    assert _close(j[1], t[1], SAMPLE_RTOL, 1e-6).all()
    assert _close(j[2], t[2], SAMPLE_RTOL, 1e-6).all()


def _sample(case, wi, n, seed=0):
    p, pn, present = port_rows(case, n)
    wi_l = torch.tensor(wi, dtype=torch.float32).expand(n, 3).contiguous()
    u = torch.from_numpy(
        np.random.default_rng(seed).random((n, 4)).astype(np.float32))
    out = LY.sample(p, pn, wi_l, u, present)
    return (p, pn, present), wi_l, *(x.numpy() for x in out)


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_consistency(ci):
    n = 60_000
    for wi in WI_LIST:
        (p, pn, present), wi_l, wo, w, pdf, delta, eta = _sample(
            CASES[ci], wi, n)
        ok = (pdf > 1e-4) & ~delta & np.any(w > 0, -1)
        if ok.sum() < n // 20:
            continue
        f2, pdf2 = (x.numpy() for x in LY.eval_pdf(
            p, pn, wi_l, torch.from_numpy(wo), present))
        sel = ok & (pdf > 1e-3)
        rel = np.abs(pdf2[sel] - pdf[sel]) / pdf[sel]
        assert np.quantile(rel, 0.95) < 5e-3, (ci, wi, np.quantile(rel, 0.95))
        w2 = f2[sel] / pdf[sel][:, None]
        relw = np.abs(w2 - w[sel]) / np.maximum(np.abs(w[sel]), 1e-3)
        assert np.quantile(relw, 0.95) < 1e-2, (ci, wi)


# (case, wi) beyond the reference's: wi below the surface, two-sided and
# one-sided, and the GGX roughcoating near grazing incidence
BEYOND = [
    (TWOSIDED, WI_BELOW),
    (CASES[4], WI_BELOW),
    (CASES[4], np.array([0.9, 0.0, 0.43589])),
]
CHI2 = [(CASES[i], wi) for i in range(len(CASES)) for wi in WI_LIST] + BEYOND


@pytest.mark.parametrize("k", range(len(CHI2)),
                         ids=[f"{c[0]}-{c[2]}-{i}" for i, (c, _) in
                              enumerate(CHI2)])
def test_chi2(k):
    from chi2util import run_sphere_chi2

    case, wi = CHI2[k]
    n = 200_000
    _, _, wo, w, pdf, delta, eta = _sample(case, wi, n, seed=5)
    sel = (pdf > 0) & ~delta
    if sel.sum() < n // 40:  # delta only (a smooth coat on a conductor)
        assert k < len(CHI2) - len(BEYOND), (k, sel.sum())
        return
    rows = None

    def pdf_fn(dirs):
        nonlocal rows
        m = len(dirs)
        if rows is None:
            rows = port_rows(case, m)
        wi_m = torch.tensor(wi, dtype=torch.float32).expand(m, 3)
        p, pn, present = rows
        return LY.eval_pdf(p, pn, wi_m.contiguous(),
                           torch.from_numpy(np.asarray(dirs, np.float32)),
                           present)[1].numpy()

    ok, stats = run_sphere_chi2(wo[sel], pdf_fn, np.random.default_rng(11),
                                significance=0.01, n_tests=len(CHI2))
    assert stats["total_mass"] < 1.0 + 5e-2, (k, stats)
    assert ok, (k, wi, stats)


def test_coating_energy_bounds():
    """A clear coat over a white diffuse reflects at most what it gets:
    the mean sample weight (the directional albedo) stays below 1."""
    case = ("coating", {}, "diffuse", {"reflectance": np.ones(3)})
    _, _, wo, w, pdf, delta, eta = _sample(
        case, np.array([0.3, 0.2, 0.933]), 100_000)
    assert w.mean(0).max() <= 1.0 + 1e-3

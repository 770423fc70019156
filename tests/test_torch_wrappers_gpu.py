"""The material wrappers' site and the shadow walk on a card.

- The site's visible normals: a site (bsdf/wrappers.py::Site) of
  mini_cbox_wrappers' rows on L = 262,144 lanes of random rows, wi and
  uniforms makes two K8 calls a sample, the table's (gated to the
  microfacet families of slot a) and roughcoating's interface (gated to
  the roughcoating lanes, its uniforms a strided view); each is held bit
  for bit (two NaNs equal) with sample_visible_plain and the same gate
  on the card.
- One site's outputs (the sample's wo, weight, pdf, delta and eta after
  `finish`, and the eval at the sampled direction) on the card, with K8,
  against the same site with sample_visible_plain in K8's place on the
  card: bit for bit, since everything else is the same ATen operations.
- shadow_transmittance through K1 (mini_cbox_panel, mask and null, 18
  triangles) and K2 (mini_cbox_wrappers with its spheres, 32,272
  triangles) against the plain sweep and walk on the CPU, on 65,536
  segments of each scene, with no cap and a cap of 1: at most 1e-3 of
  the lanes may differ (a hit decided the other way at a triangle's edge
  by ATen's CPU and the kernel's roundings), and every lane's T is one of
  the products the walk can make (1, 1 - opacity, its square, 0).

The kernels have no CPU mode, so the `gpu` tests run only on a card and
skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_wrappers_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.bsdf import bsdf as B
from ppg_tpu_torch.bsdf import microfacet as MF
from ppg_tpu_torch.bsdf import wrappers as WR
from ppg_tpu_torch.integrators import wavefront as W
from ppg_tpu_torch.scene.testscenes import mini_cbox_panel, mini_cbox_wrappers

L = 1 << 18


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool:
        assert torch.equal(a, b)
        return
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).sum())


def _site_inputs(card, seed=5):
    sc = mini_cbox_wrappers(res=16, nee="always", spheres=True)
    mats = B.MaterialArrays.from_table(sc.materials, card)
    rng = np.random.default_rng(seed)
    M = mats.packed.shape[0]
    mid = torch.from_numpy(rng.integers(0, M, L).astype(np.int32)).to(card)
    wi = rng.normal(size=(L, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    draw = lambda *s: torch.from_numpy(
        rng.random(s).astype(np.float32)).to(card)
    return (mats, mid, torch.from_numpy(wi).to(card), draw(L), draw(L),
            draw(L, 1), draw(L, 3))


def _run_site(inputs, vndf):
    """The site's sample (finished) and eval at the sampled direction, with
    `vndf` in sample_visible's place; and sample_visible's calls."""
    mats, mid, wi, u_m, u_b, u_c, u = inputs
    calls, saved = [], MF.sample_visible

    def record(*args):
        m = vndf(*args)
        calls.append((args, m))
        return m
    MF.sample_visible = record
    try:
        site = WR.Site(mats, mid, wi, u_m, u_b, u_c)
        wo, w, pdf, delta, eta = site.sample(u)
        f, p = site.eval_pdf(wo)
        w, pdf = site.finish(w, pdf, f, p)
    finally:
        MF.sample_visible = saved
    return (wo, w, pdf, delta, eta, f, p), calls


@pytest.mark.gpu
def test_site_visible_normals_equal_the_gated_plain_version(card):
    inputs = _site_inputs(card)
    MF.reset_counts()
    _, calls = _run_site(inputs, MF.sample_visible)
    assert MF.COUNTS["vndf_kernel"] == 2 and len(calls) == 2
    assert MF.COUNTS["vndf_plain_on_cuda"] == 0
    fams = {args[5][1] for args, _ in calls}
    assert 1 << B.MAT_ROUGHCOATING in fams
    for args, m in calls:
        _same(m, MF.sample_visible_plain(*args))


@pytest.mark.gpu
def test_site_on_the_card_equals_the_plain_path(card):
    inputs = _site_inputs(card, seed=6)
    got, _ = _run_site(inputs, MF.sample_visible)
    want, _ = _run_site(inputs, MF.sample_visible_plain)
    for g, w in zip(got, want):
        _same(g, w)
    assert int((got[1] > 0).any(-1).sum()) > L // 4


def _segments(seed, n=1 << 16):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.95, 0.95, n), rng.uniform(0.05, 1.6, n),
                  rng.uniform(-0.95, 0.95, n)], -1)
    tgt = np.stack([rng.uniform(-0.6, 0.6, n), np.full(n, 1.99),
                    rng.uniform(-0.6, 0.6, n)], -1)
    v = tgt - o
    dist = np.linalg.norm(v, axis=1)
    return [torch.from_numpy(x.astype(np.float32)) for x in
            (o, v / dist[:, None], dist)] + [
        torch.from_numpy(rng.random(n) < 0.9)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mask", "null", "wrappers"])
def test_shadow_walk_on_the_card_matches_the_cpu(card, name):
    sc = (mini_cbox_wrappers(res=16, nee="always") if name == "wrappers"
          else mini_cbox_panel(res=16, nee="always", panel=name))
    cpu = W.DeviceScene.from_scene(sc, "cpu")
    gpu = W.DeviceScene.from_scene(sc, card)
    segs = _segments(len(name))
    for cap in (None, 1):
        t_c = W.shadow_transmittance(cpu, *segs, cap)
        t_g = W.shadow_transmittance(gpu, *(s.to(card) for s in segs),
                                     cap).cpu()
        differ = (t_c != t_g).any(-1)
        assert int(differ.sum()) <= 1e-3 * len(t_c), int(differ.sum())
        ok = torch.tensor([0.0, 1.0, 0.4, 0.16])
        assert bool(torch.isclose(t_g[..., None], ok, rtol=1e-6,
                                  atol=0).any(-1).all())

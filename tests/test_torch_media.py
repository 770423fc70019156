"""The port's participating media (ppg_tpu_torch/media.py) against
ppg_tpu's, and K11 (csrc/media.cu) compiled for the CPU under
tools/cuda_shim.py against its plain version.

- MediaArrays.from_table's rows and grid equal ppg_tpu's bit for bit
  (with num, has_orient and any_hetero) for homogeneous media, a grid
  medium under a to_world, a Kajiya-Kay medium, a microflake grid medium
  with an orientation volume and a Rayleigh medium.
- fetch (its fiber axis from the orientation volume), density and
  _orientation_lookup on the same points, within 1e-6 relative (the
  affine's sums are XLA's on one side and left to right on the other):
  random points inside and outside the grid and, under an affine whose
  products are exact, points on its max faces and in its last cells.
- sample_distance and transmittance given the same uniforms, within
  1e-6 relative (1e-9 absolute: weights near 0 carry XLA's and ATen's
  exp roundings).
- Each phase kind's eval, pdf and sample (phase_eval, phase_pdf,
  phase_sample_full; HG at several g, isotropic, Rayleigh, Kajiya-Kay,
  SGGX, and the kinds mixed across lanes) given the same uniforms:
  directions, pdfs and weights within 2e-4 relative (XLA's and ATen's
  sin, cos, pow and sqrt round differently; an SGGX lobe's value at a
  sampled direction divides by small differences).
- HG sampling keeps a backward lobe (mean cosine g), which ppg_tpu's
  standalone hg_sample does not (a fault the port repairs; the tracers
  sample through phase_sample, which both packages get right).
- ppg_tpu's physics checks on the port (tests/test_media.py TestPhase,
  TestRayleighPhase, TestKajiyaKayPhase and TestPhaseChi2;
  tests/test_hetero_media.py's trilinear density, Woodcock against the
  analytic transmittance of a constant grid and unbiased ratio
  tracking; tests/test_microflake.py's SGGX normalisation, chi-square
  and orientation volume), with their tolerances.
- The plain Woodcock and ratio tracking against ppg_tpu's over 2^16
  lanes of a random grid: the random streams differ (threefry against
  the counter hash), so the scatter fraction, the mean weight and the
  mean transmittance agree within 4 standard errors.
- K11 under the shim bit for bit with the plain version in both modes
  (log patched to the C library's logf in the plain version, as the
  shim's kernel calls it) on an edge set: vacuum lanes, homogeneous
  lanes, a grid of zeros (majorant 0), t_surf = inf, zero and negative
  distances, points on the grid's max face and in its last cell (lanes
  with d = 0 take every event there), a lane of more than one 64-event
  block, and lanes at the cap (n_steps = 1: 1,024 events; the 65,536
  events of the default cap in the kernel alone, against the plain
  version's values at the cap). Strided inputs, and the wrapper's
  refusals.
"""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chi2util import chi2_test, run_sphere_chi2
from ppg_tpu import media as JM
from ppg_tpu_torch import media as TM
from ppg_tpu_torch.tools import cuda_shim
from ppg_tpu_torch.tools import media_cases as MC

PHASE_RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _tables():
    rng = np.random.default_rng(3)
    og = rng.normal(size=(4, 5, 6, 3)).astype(np.float32)
    og[0, 0, 0] = 0.0  # a zero axis: the row's orientation is kept
    return {
        "homogeneous": [dict(sigma_t=[0.5, 1.0, 2.0], albedo=[0.8, 0.6, 0.4],
                             g=0.3),
                        dict(sigma_t=[1.5] * 3, albedo=[0.9] * 3, g=-0.5)],
        "grid under to_world": [dict(
            hetero=True, density=rng.random((5, 6, 7)).astype(np.float32),
            bbox_min=np.array([-1.0, -0.5, -1.5]),
            bbox_max=np.array([1.0, 1.5, 0.5]), to_world=MC.turned(),
            scale=2.5, albedo=np.array([0.8, 0.7, 0.6]), g=0.2)],
        "kajiya-kay": [dict(sigma_t=[1.0] * 3, albedo=[0.7] * 3,
                            g=JM.KKAY_G, orientation=[1.0, 2.0, 3.0],
                            ks=0.5, kd=0.3, exponent=6.0)],
        "microflake, orientation volume": [dict(
            hetero=True, density=rng.random((4, 5, 6)).astype(np.float32),
            bbox_min=np.array([0.0, 0.0, 0.0]),
            bbox_max=np.array([1.0, 1.2, 1.4]), scale=1.5,
            albedo=np.array([0.9] * 3), g=JM.MICROFLAKE_G, stddev=0.3,
            orientation=[0.0, 1.0, 0.0], orientation_grid=og)],
        "rayleigh": [dict(sigma_t=[0.3, 0.6, 1.2], albedo=[0.95] * 3,
                          g=JM.RAYLEIGH_G),
                     dict(sigma_t=[1.0] * 3, albedo=[0.5] * 3, g=0.0)],
    }


@pytest.mark.parametrize("name", list(_tables()))
def test_from_table_equals_ppg_tpu(name):
    table = _tables()[name]
    j = JM.MediaArrays.from_table(table)
    t = TM.MediaArrays.from_table(table, "cpu")
    np.testing.assert_array_equal(t.rows.numpy().view(np.int32),
                                  np.asarray(j.rows).view(np.int32))
    np.testing.assert_array_equal(t.grid.numpy().view(np.int32),
                                  np.asarray(j.grid).view(np.int32))
    assert (t.num, t.has_orient, t.any_hetero) == (
        j.num, j.has_orient, j.any_hetero)
    e = TM.MediaArrays.empty("cpu")
    je = JM.MediaArrays.empty()
    np.testing.assert_array_equal(e.rows.numpy(), np.asarray(je.rows))
    assert (e.num, e.any_hetero, e.kinds) == (0, False, {"hg"})


def _grid_points(rows, n, rng, margin=0.3):
    """World points whose grid coordinates spread over [-margin, res - 1 +
    margin] on each axis of the row's grid (float64 inverse affine)."""
    row = rows[0].astype(np.float64)
    res = row[11:14]
    w2g = np.vstack([row[14:26].reshape(3, 4), [0, 0, 0, 1]])
    g = rng.uniform(-margin, 1 + margin, (n, 3)) * (res - 1)
    p = (np.linalg.inv(w2g) @ np.c_[g, np.ones(n)].T).T[:, :3]
    return p.astype(np.float32)


@pytest.mark.parametrize("name", ["grid under to_world",
                                  "microflake, orientation volume", "faces"])
def test_fetch_density_orientation_match(name):
    table = MC.face_table() if name == "faces" else _tables()[name]
    j = JM.MediaArrays.from_table(table)
    t = TM.MediaArrays.from_table(table, "cpu")
    rng = np.random.default_rng(4)
    p = (MC.face_points() if name == "faces"
         else _grid_points(np.asarray(j.rows), 4096, rng))
    n = len(p)
    mid = np.zeros(n, np.int32)
    mid[::5] = -1  # vacuum lanes
    row_j = JM.fetch_row(j, jnp.asarray(mid))
    row_t = TM.fetch_row(t, _t(mid, torch.int32))
    dj = np.asarray(JM.density(j, row_j, jnp.asarray(p)))
    dt = TM.density(t, row_t, _t(p)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-7)
    if name == "faces":
        # grid coordinates exact: equal, and only the points outside are 0
        np.testing.assert_array_equal(dt, dj)
        assert (dt[:8] > 0).all() and (dt[8:11] == 0).all()
    else:
        assert (dt == 0).mean() > 0.2 and (dt > 0).mean() > 0.2
    sj, aj, ppj = JM.fetch(j, jnp.asarray(mid), x=jnp.asarray(p))
    st, at, ppt = TM.fetch(t, _t(mid, torch.int32), x=_t(p))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(ppt.g.numpy(), np.asarray(ppj.g))
    np.testing.assert_allclose(ppt.axis.numpy(), np.asarray(ppj.axis),
                               rtol=1e-6, atol=1e-7)
    if t.has_orient:
        oj = np.asarray(JM._orientation_lookup(j, row_j, jnp.asarray(p)))
        ot = TM._orientation_lookup(t, row_t, _t(p)).numpy()
        np.testing.assert_array_equal(ot, oj)


def test_sample_distance_and_transmittance_match():
    rng = np.random.default_rng(5)
    n = 8192
    sigma_t = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    sigma_t[::7] = 0.0  # vacuum lanes
    sigma_t[1::7, 1] = 0.0  # a channel without extinction
    albedo = rng.random((n, 3)).astype(np.float32)
    t_surf = rng.uniform(0, 4, n).astype(np.float32)
    t_surf[::11] = np.inf
    u1, u2 = rng.random((2, n)).astype(np.float32)
    j = JM.sample_distance(*(jnp.asarray(x) for x in (sigma_t, albedo, t_surf,
                                                       u1, u2)))
    t = TM.sample_distance(*(_t(x) for x in (sigma_t, albedo, t_surf, u1,
                                             u2)))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    for a, b in zip(t[1:], j[1:]):
        # XLA's and ATen's exp differ in the last bits (weights near 0)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
    dist = rng.uniform(-1, 5, n).astype(np.float32)
    np.testing.assert_allclose(
        TM.transmittance(_t(sigma_t), _t(dist)).numpy(),
        np.asarray(JM.transmittance(jnp.asarray(sigma_t), jnp.asarray(dist))),
        rtol=1e-6)


def _phase_lanes(kind, n, rng):
    """(g [n], rows [n, ROW_W]) of one kind, or "mixed": every kind."""
    rows = np.zeros((n, JM.ROW_W), np.float32)
    axis = rng.normal(size=(n, 3))
    rows[:, 28:31] = axis / np.linalg.norm(axis, axis=1, keepdims=True)
    rows[:, 31] = rng.uniform(0.05, 1.0, n)  # ks, or SGGX's beta
    rows[:, 32] = rng.uniform(0.0, 0.5, n)
    rows[:, 33] = rng.uniform(1.0, 12.0, n)
    rows[:, 34] = [JM.kkay_normalization(e) for e in rows[:, 33]]
    g = {"hg": rng.uniform(-0.9, 0.9, n), "isotropic": np.zeros(n),
         "rayleigh": np.full(n, JM.RAYLEIGH_G), "kkay": np.full(n, JM.KKAY_G),
         "microflake": np.full(n, JM.MICROFLAKE_G),
         "mixed": rng.choice([0.0, 0.7, -0.4, JM.RAYLEIGH_G, JM.KKAY_G,
                              JM.MICROFLAKE_G], n)}[kind]
    rows[:, 6] = g
    return g.astype(np.float32), rows


@pytest.mark.parametrize("kind", ["hg", "isotropic", "rayleigh", "kkay",
                                  "microflake", "mixed"])
def test_phase_eval_pdf_sample_match(kind):
    rng = np.random.default_rng(6)
    n = 4096
    g, rows = _phase_lanes(kind, n, rng)
    d_in = rng.normal(size=(n, 3))
    d_in = (d_in / np.linalg.norm(d_in, axis=1, keepdims=True)).astype(
        np.float32)
    d_out = rng.normal(size=(n, 3))
    d_out = (d_out / np.linalg.norm(d_out, axis=1, keepdims=True)).astype(
        np.float32)
    u = rng.random((n, 2)).astype(np.float32)
    ppj = JM.PhaseParams(jnp.asarray(g), jnp.asarray(rows))
    ppt = TM.PhaseParams(_t(g), _t(rows))
    kinds = {"isotropic": {"hg"}, "mixed": TM.PHASE_KINDS}.get(kind, {kind})
    ppk = TM.PhaseParams(_t(g), _t(rows), kinds=frozenset(kinds | {"hg"}))
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=PHASE_RTOL, atol=1e-6)
    for pp in (ppt, ppk):
        close(TM.phase_eval(pp, _t(d_in), _t(d_out)),
              JM.phase_eval(ppj, jnp.asarray(d_in), jnp.asarray(d_out)))
        close(TM.phase_pdf(pp, _t(d_in), _t(d_out)),
              JM.phase_pdf(ppj, jnp.asarray(d_in), jnp.asarray(d_out)))
        dt, pt, wt = TM.phase_sample_full(pp, _t(d_in), _t(u))
        dj, pj, wj = JM.phase_sample_full(ppj, jnp.asarray(d_in),
                                          jnp.asarray(u))
        close(dt, dj)
        close(pt, pj)
        close(wt, wj)


# ppg_tpu's physics checks on the port (tests/test_media.py,
# test_hetero_media.py, test_microflake.py)

def _unit_rows(n, rng):
    v = rng.normal(size=(n, 3))
    return torch.from_numpy(
        (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32))


def test_hg_pdf_normalized():
    v = _unit_rows(200_000, np.random.default_rng(0))
    for g in (0.0, 0.4, -0.6, 0.9):
        pdf = TM.hg_eval_pdf(torch.tensor(g), v[:, 2])
        assert abs(float(pdf.mean()) * 4 * np.pi - 1.0) < 0.02, g


def test_hg_sample_matches_pdf():
    rng = np.random.default_rng(1)
    d_in = torch.tensor([[0.0, 0, 1]]).repeat(100_000, 1)
    for g in (0.0, 0.5, -0.3):
        u = _t(rng.random((100_000, 2)))
        d_out, pdf = TM.hg_sample(torch.tensor(g), d_in, u)
        pdf2 = TM.hg_eval_pdf(torch.tensor(g), d_out[:, 2])
        rel = ((pdf - pdf2).abs() / torch.clamp(pdf2, min=1e-6)).numpy()
        assert np.quantile(rel, 0.95) < 1e-3, g
        if g > 0:
            assert float(d_out[:, 2].mean()) > 0.3


@pytest.mark.parametrize("g", [-0.7, -0.3, 0.5])
def test_hg_sample_keeps_backward_lobes(g):
    """HG's mean cosine is g. The port's hg_sample holds it; ppg_tpu's
    hg_sample clamps 2g from below and sends a backward lobe forward (its
    tracer samples through phase_sample, which keeps the sign)."""
    rng = np.random.default_rng(7)
    n = 200_000
    u = rng.random((n, 2)).astype(np.float32)
    d_in = np.tile(np.float32([0.0, 0, 1]), (n, 1))
    d, _ = TM.hg_sample(torch.tensor(g), _t(d_in), _t(u))
    assert abs(float(d[:, 2].mean()) - g) < 0.01
    dj, _ = JM.hg_sample(jnp.float32(g), jnp.asarray(d_in), jnp.asarray(u))
    mean_j = float(np.asarray(dj)[:, 2].mean())
    assert (mean_j > 0.4) if g < 0 else abs(mean_j - g) < 0.01, mean_j


def test_distance_sampling_unbiased():
    rng = np.random.default_rng(2)
    n = 400_000
    sigma_t = torch.tensor([[0.5, 1.0, 2.0]]).repeat(n, 1)
    albedo = torch.full((n, 3), 0.8)
    is_med, _, w = TM.sample_distance(sigma_t, albedo, torch.full((n,), 1.7),
                                      _t(rng.random(n)), _t(rng.random(n)))
    surf = torch.where(~is_med[:, None], w, 0.0).mean(0).numpy()
    expect = np.exp(-np.array([0.5, 1.0, 2.0]) * 1.7)
    assert np.allclose(surf, expect, rtol=0.02), (surf, expect)
    medium = torch.where(is_med[:, None], w, 0.0).mean(0).numpy()
    assert np.allclose(medium, 0.8 * (1 - expect), rtol=0.02)


def test_rayleigh_pdf_sample_and_dispatch():
    rng = np.random.default_rng(3)
    v = _unit_rows(200_000, rng)
    assert abs(float(TM.rayleigh_eval_pdf(v[:, 2]).mean()) * 4 * np.pi
               - 1.0) < 0.02
    N = 400_000
    d_in = torch.tensor([[0.0, 0, 1]]).repeat(N, 1)
    d_out, pdf = TM.phase_sample(torch.full((N,), TM.RAYLEIGH_G), d_in,
                                 _t(rng.random((N, 2))))
    ct = d_out[:, 2].numpy()
    pdf2 = TM.rayleigh_eval_pdf(d_out[:, 2]).numpy()
    assert np.quantile(np.abs(pdf.numpy() - pdf2) / np.maximum(pdf2, 1e-6),
                       0.95) < 1e-3
    hist, edges = np.histogram(ct, bins=32, range=(-1, 1), density=True)
    mid = 0.5 * (edges[:-1] + edges[1:])
    assert np.abs(hist - 3.0 / 8.0 * (1.0 + mid * mid)).max() < 0.02
    g = torch.where(torch.arange(1000) % 2 == 0, TM.RAYLEIGH_G, 0.9)
    d_out, _ = TM.phase_sample(g, d_in[:1000], _t(rng.random((1000, 2))))
    ct = d_out[:, 2].numpy()
    assert ct[1::2].mean() > 0.7 and abs(ct[0::2].mean()) < 0.05


def _kkay(n, axis, ks=1.0, kd=0.0, exponent=4.0):
    row = np.zeros((1, TM.ROW_W), np.float32)
    row[0, 6] = TM.KKAY_G
    row[0, 28:31] = axis
    row[0, 31:35] = ks, kd, exponent, TM.kkay_normalization(exponent)
    return TM.PhaseParams(torch.full((n,), TM.KKAY_G), _t(row).repeat(n, 1))


def test_kajiya_kay_normalization_sample_and_fallback():
    rng = np.random.default_rng(5)
    N = 200_000
    vals = TM.phase_eval(_kkay(N, [0, 0, 1.0]),
                         torch.tensor([[1.0, 0, 0]]).repeat(N, 1),
                         _unit_rows(N, rng))
    assert abs(float(vals.mean()) * 4 * np.pi - 1.0) < 0.03
    pp = _kkay(4096, [0, 1.0, 0], ks=0.5, kd=0.3)
    d_in = torch.tensor([[0.0, 0, 1.0]]).repeat(4096, 1)
    d_out, pdf, w = TM.phase_sample_full(pp, d_in, _t(rng.random((4096, 2))))
    np.testing.assert_allclose(pdf.numpy(), 1 / (4 * np.pi), rtol=1e-5)
    np.testing.assert_allclose(
        w.numpy(), TM.phase_eval(pp, d_in, d_out).numpy() * 4 * np.pi,
        rtol=1e-4, atol=1e-6)
    d = torch.tensor([[0.0, 0, 1.0]])
    v = TM.phase_eval(_kkay(1, [0.0, 0, 0], ks=0.7, kd=0.2), d, d)
    np.testing.assert_allclose(v.numpy(), 0.2 / (4 * np.pi), rtol=1e-5)


@pytest.mark.parametrize("gval,seed", [(0.7, 21), (-0.4, 22), (0.0, 23),
                                       (TM.RAYLEIGH_G, 24)])
def test_phase_chi2(gval, seed):
    n = 200_000
    rng = np.random.default_rng(seed)
    din1 = np.asarray([0.36, -0.48, 0.8])
    d_out, _ = TM.phase_sample(torch.full((n,), gval),
                               _t(din1).repeat(n, 1), _t(rng.random((n, 2))))

    def pdf_fn(dirs):
        return TM.phase_eval_pdf(torch.full((len(dirs),), gval),
                                 _t(dirs @ din1)).numpy()

    ok, stats = run_sphere_chi2(d_out.numpy(), pdf_fn, rng,
                                significance=0.01, n_tests=4)
    assert ok, (gval, stats)


def _const_media(value, albedo=(0.8, 0.6, 0.4)):
    return TM.MediaArrays.from_table([dict(
        hetero=True, density=np.full((2, 2, 2), value, np.float32),
        bbox_min=np.array([-10.0, -10, -10]),
        bbox_max=np.array([10.0, 10, 10]), scale=1.0,
        albedo=np.array(albedo), g=0.0)], "cpu")


def test_density_trilinear():
    grid = np.broadcast_to(np.linspace(0.0, 1.0, 5, dtype=np.float32),
                           (3, 3, 5)).copy()
    media = TM.MediaArrays.from_table([dict(
        hetero=True, density=grid, bbox_min=np.zeros(3),
        bbox_max=np.ones(3), scale=1.0, albedo=np.full(3, 0.5), g=0.0)],
        "cpu")
    row = TM.fetch_row(media, torch.zeros(4, dtype=torch.int32))
    p = torch.tensor([[0.25, 0.5, 0.5], [0.6, 0.5, 0.5], [0.5, 0.5, 0.5],
                      [2.0, 0.5, 0.5]])
    d = TM.density(media, row, p).numpy()
    assert np.allclose(d[:3], [0.25, 0.6, 0.5], atol=1e-5) and d[3] == 0.0


def _seed(s):
    return torch.tensor([s], dtype=torch.int64)


def test_woodcock_matches_analytic():
    n = 200_000
    media = _const_media(1.5)
    o = torch.zeros((n, 3))
    d = torch.tensor([[1.0, 0, 0]]).repeat(n, 1)
    is_med, t, w = TM.woodcock_sample(media, torch.zeros(n, dtype=torch.int32),
                                      o, d, torch.full((n,), 1.2), _seed(0))
    is_med = is_med.numpy()
    T = np.exp(-1.5 * 1.2)
    assert abs((~is_med).mean() - T) < 0.01
    est = np.where(is_med[:, None], w.numpy(), 0).mean(0)
    assert np.allclose(est, np.array([0.8, 0.6, 0.4]) * (1 - T), rtol=0.03)
    tm = t.numpy()[is_med]
    assert abs(tm.mean() - ((1 / 1.5) - 1.2 * T / (1 - T))) < 0.01


def test_ratio_transmittance_unbiased():
    n = 200_000
    T = TM.ratio_transmittance(
        _const_media(2.0), torch.zeros(n, dtype=torch.int32),
        torch.zeros((n, 3)), torch.tensor([[0.0, 0, 1.0]]).repeat(n, 1),
        torch.full((n,), 0.9), _seed(1)).numpy()
    assert abs(T.mean() - np.exp(-2.0 * 0.9)) < 0.01


def _sggx(n, axis, stddev):
    media = TM.MediaArrays.from_table(
        [dict(sigma_t=[1, 1, 1], albedo=[0.9] * 3, g=TM.MICROFLAKE_G,
              stddev=stddev, orientation=axis)], "cpu")
    return TM.fetch(media, torch.zeros(n, dtype=torch.int32))[2]


@pytest.mark.parametrize("stddev,axis", [(0.25, (0.0, 0.0, 1.0)),
                                         (0.1, (1.0, 0.0, 0.0)),
                                         (0.6, (0.577, 0.577, 0.577))])
def test_sggx_phase_normalized(stddev, axis):
    N = 400_000
    v = _unit_rows(N, np.random.default_rng(1))
    d_in = _t([0.3, -0.4, np.sqrt(0.75)]).repeat(N, 1)
    p = TM.sggx_eval(_sggx(N, axis, stddev), d_in, v)
    assert abs(float(p.mean()) * 4 * np.pi - 1.0) < 0.02


def test_sggx_sample_matches_pdf_chi2():
    rng = np.random.default_rng(2)
    N = 500_000
    pp = _sggx(N, (0.0, 0.0, 1.0), 0.3)
    d_in = _t([0.6, 0.0, -0.8]).repeat(N, 1)
    d_out, pdf = TM.sggx_sample(pp, d_in, _t(rng.random((N, 2))))
    pdf2 = TM.sggx_eval(pp, d_in, d_out)
    rel = ((pdf - pdf2).abs() / torch.clamp(pdf2, min=1e-6)).numpy()
    assert np.quantile(rel, 0.95) < 1e-3
    nb_t, nb_p = 16, 16

    def bins(v):
        theta = np.arccos(np.clip(v[:, 2], -1, 1))
        phi = np.arctan2(v[:, 1], v[:, 0]) + np.pi
        ti = np.minimum((theta / np.pi * nb_t).astype(int), nb_t - 1)
        pi_ = np.minimum((phi / (2 * np.pi) * nb_p).astype(int), nb_p - 1)
        return ti * nb_p + pi_

    counts = np.bincount(bins(d_out.numpy()), minlength=nb_t * nb_p)
    M = 400_000
    v = np.random.default_rng(3).normal(size=(M, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pv = TM.sggx_eval(_sggx(M, (0.0, 0.0, 1.0), 0.3),
                      _t([0.6, 0.0, -0.8]).repeat(M, 1), _t(v)).numpy()
    b = bins(v)
    w = pv * 4 * np.pi / M
    expected = np.bincount(b, weights=w, minlength=nb_t * nb_p) * N
    evar = (np.bincount(b, weights=w * w, minlength=nb_t * nb_p) * M
            - (expected / N) ** 2) / M * N * N
    ok, stats = chi2_test(counts, expected, expected_var=evar,
                          significance=0.0025)
    assert ok, stats


def test_orientation_volume_lookup():
    og = np.zeros((1, 1, 2, 3), np.float32)
    og[0, 0, 0] = [1, 0, 0]
    og[0, 0, 1] = [0, 1, 0]
    media = TM.MediaArrays.from_table([dict(
        sigma_t=[1, 1, 1], albedo=[0.9] * 3, g=TM.MICROFLAKE_G, stddev=0.2,
        orientation=[0, 0, 1], hetero=True,
        density=np.ones((2, 2, 2), np.float32), bbox_min=[0, 0, 0],
        bbox_max=[1, 1, 1],
        orientation_grid=np.broadcast_to(og, (2, 2, 2, 3)).copy())], "cpu")
    x = torch.tensor([[0.1, 0.1, 0.1], [0.9, 0.1, 0.1]])
    ax = TM.fetch(media, torch.zeros(2, dtype=torch.int32), x=x)[2].axis
    np.testing.assert_allclose(ax.numpy(), [[1, 0, 0], [0, 1, 0]], atol=1e-6)


# the plain tracking against ppg_tpu's, in distribution

def _puffs(res, seed):
    """A density grid [res, res, res] of a few Gaussian puffs, max 1."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.linspace(0, 1, res),) * 3, indexing="ij")
    dens = np.zeros((res,) * 3)
    for c, s in zip(rng.uniform(0.2, 0.8, (5, 3)), rng.uniform(0.08, 0.2, 5)):
        dens += np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2
                         + (z - c[2]) ** 2) / (2 * s * s))
    return (dens / dens.max()).astype(np.float32)


def _puff_table():
    return [dict(hetero=True, density=_puffs(12, 1),
                 bbox_min=np.array([-1.0, -1, -1]),
                 bbox_max=np.array([1.0, 1, 1]), scale=12.0,
                 albedo=np.array([0.8, 0.6, 0.4]), g=0.3)]


def test_plain_tracking_matches_ppg_tpu_in_distribution():
    n = 1 << 16
    rng = np.random.default_rng(9)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_surf = rng.uniform(0.5, 2.5, n).astype(np.float32)
    mid = np.zeros(n, np.int32)
    j = JM.MediaArrays.from_table(_puff_table())
    t = TM.MediaArrays.from_table(_puff_table(), "cpu")
    ij, tj, wj = JM.woodcock_sample(j, jnp.asarray(mid), jnp.asarray(o),
                                    jnp.asarray(d), jnp.asarray(t_surf),
                                    jax.random.key(3))
    it, tt, wt = TM.woodcock_sample_plain(t, _t(mid, torch.int32), _t(o),
                                          _t(d), _t(t_surf), _seed(77))

    def agree(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        se = np.sqrt(a.var() / len(a) + b.var() / len(b))
        assert abs(a.mean() - b.mean()) < 4 * se, (a.mean(), b.mean(), se)

    scat_j, scat_t = np.asarray(ij), it.numpy()
    assert 0.2 < scat_t.mean() < 0.8
    agree(scat_j, scat_t)
    for c in range(3):
        agree(np.asarray(wj)[:, c] * scat_j, wt.numpy()[:, c] * scat_t)
    agree(np.where(scat_j, np.asarray(tj), 0), np.where(scat_t, tt.numpy(), 0))
    Tj = JM.ratio_transmittance(j, jnp.asarray(mid), jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(t_surf),
                                jax.random.key(4))
    Tt = TM.ratio_transmittance_plain(t, _t(mid, torch.int32), _t(o), _t(d),
                                      _t(t_surf), _seed(78))
    agree(Tj, Tt.numpy())
    # the scatter fraction is one minus the transmittance on average
    agree(1.0 - scat_t, Tt.numpy())


# K11 under the shim

_VLOGF = r"""
#include <math.h>
extern "C" void vlogf(const float* x, float* y, long n) {
    for (long i = 0; i < n; ++i) y[i] = logf(x[i]);
}
"""


@pytest.fixture(scope="module")
def host_k11(tmp_path_factory):
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    from ppg_tpu_torch.native import CSRC

    out = tmp_path_factory.mktemp("k11_host")
    lib = cuda_shim.build_host(os.path.join(CSRC, "media.cu"), str(out),
                               "k11_host", launches=2)
    lib.ppg_media_track.argtypes = TM.ARGTYPES
    lib.ppg_media_track.restype = ctypes.c_int
    # the C library's logf over a tensor, as the shim's kernel calls it
    src = out / "vlogf.cpp"
    src.write_text(_VLOGF)
    so = str(out / "libvlogf.so")
    subprocess.run([cuda_shim.host_compiler(), "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", so, str(src)], check=True)
    vlog = ctypes.CDLL(so).vlogf
    vlog.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]

    def logf(x):
        x = x.contiguous()
        y = torch.empty_like(x)
        vlog(x.data_ptr(), y.data_ptr(), x.numel())
        return y

    def k11(mode, media, mid, o, d, t_end, seed, n_steps=TM.WOODCOCK_STEPS):
        args = TM.kernel_args(mode, media, mid, o, d, t_end, seed, n_steps)
        L = o.shape[0]
        if mode == TM.TRACK:
            out = (torch.ones(L, dtype=torch.bool), torch.full((L,), 7.0),
                   torch.full((L, 3), 7.0))
            ptrs = [out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                    None]
        else:
            out = torch.full((L,), 7.0)
            ptrs = [None, None, None, out.data_ptr()]
        assert lib.ppg_media_track(*args, *ptrs, L, 0, None) == 0
        return out

    return k11, logf


def _lanes(arrays):
    return tuple(_t(x, torch.int32) if x.dtype == np.int32 else _t(x)
                 for x in arrays)


def _bits_equal(a, b):
    if a.dtype == torch.bool:
        assert torch.equal(a, b), int((a != b).sum())
        return
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                           & b.isnan())
    assert bool(same.all()), int((~same).sum())


def _positions(stats, hit, cap):
    """Where in a batch of 8 events each gated-in lane's walk ended: the
    accepted event's place (track) and the place of the flight that
    reached t_end (lanes short of the cap, no event accepted)."""
    n = stats["lane_events"]
    lanes = stats["lanes_in"]
    acc = lanes & hit
    end = lanes & ~hit & (n < cap)
    return (set(((n[acc] - 1) % 8).tolist()), set((n[end] % 8).tolist()))


K11_CASES = (["edges"] + list(MC.TILE_CASES)
             + ["clamped corners", "many media"])


def _case_lanes(case):
    if case == "edges":
        return MC.edge_lanes(1500, 13)
    if case in ("clamped corners", "many media"):
        return MC.tiled_lanes(1500, 26, 4)
    return MC.tiled_lanes(*MC.TILE_CASES[case])


def _nan_tail(rows, media):
    """MediaArrays of `rows` over media's grids, the grids a view of a
    longer buffer whose tail is NaN: a corner read past the grids' end,
    whatever its weight, makes the density NaN, where the clamped read of
    the plain version does not."""
    G = media.grid.shape[0]
    buf = torch.full((G + 64,), float("nan"), device=media.grid.device)
    buf[:G] = media.grid
    return TM.MediaArrays(rows, buf[:G], media.num)


def _case_media(case):
    media = TM.MediaArrays.from_table(
        MC.many_media() if case == "many media" else MC.edge_table(), "cpu")
    if case != "clamped corners":
        return _nan_tail(media.rows, media)
    rows = MC.shifted_rows(media.rows.numpy(), media.grid.shape[0])
    return _nan_tail(torch.from_numpy(rows), media)


@pytest.mark.parametrize("case", K11_CASES)
def test_k11_edges_on_the_cpu_equal_plain(host_k11, monkeypatch, case):
    """Each case bit for bit in both modes with two seeds. The tile cases
    (media_cases.TILE_CASES) put a tile of gated-out lanes, tiles of
    gated-in lanes (the one-deep grid's among them, whose corners past
    the grid are clamped), a ragged last tile and fewer lanes than a tile
    through the kernel's loop on the shim's grid of six blocks, so that a
    block takes several tiles, refills its threads from a queue longer
    than a block (queue_plan), works a queue before its last chunk and
    fills the queue to its capacity; the walks end (accepted, or at
    t_end) at every place of a batch of up to eight events. "clamped
    corners" shifts two grids' offsets (media_cases.shifted_rows) so that
    corner indices below 0 and past the grid are clamped where their
    weight is not zero; "many media" has 66 (media_cases.many_media). In
    every case the grids end where a NaN tail begins (_nan_tail), so a
    corner read past them that the plain version clamps shows."""
    k11, logf = host_k11
    media = _case_media(case)
    mid, o, d, t = _lanes(_case_lanes(case))
    monkeypatch.setattr(torch, "log", logf)
    cap = TM.WOODCOCK_STEPS * TM.WOODCOCK_MAX_BLOCKS
    places = []
    for seed in (_seed(5), _seed((1 << 32) - 3)):
        got = k11(TM.TRACK, media, mid, o, d, t, seed)
        stats = {}
        want = TM.woodcock_sample_plain(media, mid, o, d, t, seed,
                                        stats=stats)
        for a, b in zip(got, want):
            _bits_equal(a, b)
        places.append(_positions(stats, want[0], cap))
        dist = torch.clamp(t, max=2.5)
        rstats = {}
        _bits_equal(k11(TM.RATIO, media, mid, o, d, dist, seed),
                    TM.ratio_transmittance_plain(media, mid, o, d, dist,
                                                 seed, stats=rstats))
        places.append(_positions(rstats, torch.zeros_like(want[0]), cap))
    every = set(range(8))
    if case == "below one tile":
        assert len(mid) < MC.k11_constants()["BLOCK"]
        return
    if case == "clamped corners":
        # walks in both shifted grids: indices clamped below 0 and past
        # the grid's end
        n = stats["lane_events"]
        assert int(n[mid == 3].sum()) > 0 and int(n[mid == 4].sum()) > 0
        return
    if case == "many media":
        assert int(stats["lane_events"][mid == 5].sum()) > 0
        return
    # every place of a batch of 8 (so of 2 and 4) ends a walk
    assert places[0][0] | places[2][0] == every
    assert places[0][1] | places[2][1] == every
    assert places[1][1] | places[3][1] == every
    if case != "edges":
        k = MC.k11_constants()
        plan = MC.queue_plan(stats["lanes_in"].numpy(), 6, k["BLOCK"],
                             k["CHUNK"], k["QCAP"])
        worked = [q for p in plan for q in p]
        assert len(mid) % k["BLOCK"] and len(plan) == 6
        assert not bool(stats["lanes_in"][:k["BLOCK"]].any())
        assert bool(stats["lanes_in"][k["BLOCK"]:2 * k["BLOCK"]].all())
        # lanes of the one-deep grid: corners past the grid, clamped
        assert int(stats["lane_events"][mid == 5].sum()) > 0
        if case == "two tiles a block":
            assert max(worked) > k["BLOCK"]
        if case == "three chunks a block":
            assert max(len(p) for p in plan) > 1
            assert max(worked) == k["QCAP"]
        return
    # the edges were reached: scatters and escapes, the dense grid's inf
    # lanes all scatter, and the one-voxel grid's walks take more than one
    # block of events
    hit = want[0]
    assert 0 < int(hit.sum()) < len(hit)
    assert bool(hit[(mid == 0) & t.isinf()].all())
    assert stats["steps"] > 2 * TM.WOODCOCK_STEPS
    # strided inputs: o and d as views of a wider row, t and mid columns
    wide = torch.zeros((len(mid), 9))
    wide[:, 1:4], wide[:, 5:8] = o, d
    tw = torch.stack([t, t], -1)
    mw = torch.stack([mid, mid], -1)
    got = k11(TM.TRACK, media, mw[:, 1], wide[:, 1:4], wide[:, 5:8],
              tw[:, 0], _seed(5))
    want = TM.woodcock_sample_plain(media, mid, o, d, t, _seed(5))
    for a, b in zip(got, want):
        _bits_equal(a, b)


# the cap: None, n_steps = 1 (1,024 events) and the default 65,536; a
# number, that cap in events (WOODCOCK_MAX_BLOCKS patched to 1), so that
# the cap falls at every place of a batch of up to eight events
CAPS = [None, 1, 2, 3, 5, 6, 7, 9]


@pytest.mark.parametrize("cap", CAPS)
def test_k11_at_the_cap_on_the_cpu(host_k11, monkeypatch, cap):
    """media_cases.cap_lanes: n_steps = 1 makes the cap 1,024 events for
    the plain version; the default cap's 65,536 events run in the kernel
    alone, against the values the plain version gives the escaping lanes
    at any cap. A numbered cap ends lanes 0, 2 and 5 (never accepted)
    and lane 1's ratio product there, in both modes."""
    k11, logf = host_k11
    media = TM.MediaArrays.from_table(MC.edge_table(), "cpu")
    mid, o, d, t = _lanes(MC.cap_lanes())
    monkeypatch.setattr(torch, "log", logf)
    seed = _seed(99)
    if cap is not None:
        monkeypatch.setattr(TM, "WOODCOCK_MAX_BLOCKS", 1)
        stats = {}
        got = k11(TM.TRACK, media, mid, o, d, t, seed, n_steps=cap)
        want = TM.woodcock_sample_plain(media, mid, o, d, t, seed,
                                        n_steps=cap, stats=stats)
        for a, b in zip(got, want):
            _bits_equal(a, b)
        assert stats["lane_events"][[0, 2, 5]].tolist() == [cap] * 3
        assert not bool(want[0][[0, 2, 5]].any())
        rstats = {}
        _bits_equal(k11(TM.RATIO, media, mid, o, d, t, seed, n_steps=cap),
                    TM.ratio_transmittance_plain(media, mid, o, d, t, seed,
                                                 n_steps=cap, stats=rstats))
        assert int(rstats["lane_events"][1]) == cap
        return
    got = k11(TM.TRACK, media, mid, o, d, t, seed, n_steps=1)
    want = TM.woodcock_sample_plain(media, mid, o, d, t, seed, n_steps=1)
    for a, b in zip(got, want):
        _bits_equal(a, b)
    assert not bool(want[0][[0, 2, 5]].any())
    assert bool(want[1][[0, 2, 5]].isinf().all())
    assert bool((want[2][[0, 2, 5]] == 1.0).all())
    T = k11(TM.RATIO, media, mid, o, d, t, seed, n_steps=1)
    _bits_equal(T, TM.ratio_transmittance_plain(media, mid, o, d, t, seed,
                                                n_steps=1))
    assert 0.0 <= float(T[1]) < 1.0 and float(T[0]) == 1.0
    full = k11(TM.TRACK, media, mid[[0, 2, 5]], o[[0, 2, 5]], d[[0, 2, 5]],
               t[[0, 2, 5]], seed)
    for a, b in zip(full, want):
        _bits_equal(a, b[[0, 2, 5]])


def test_kernel_args_refuse_bad_tensors():
    media = TM.MediaArrays.from_table(MC.edge_table(), "cpu")
    z = torch.zeros((10, 3))
    mid = torch.zeros(10, dtype=torch.int32)
    t = torch.zeros(10)
    TM.kernel_args(TM.TRACK, media, mid, z, z, t, _seed(1), 64)
    for bad in ((mid.long(), z, z, t, _seed(1), 64),
                (mid, z.double(), z, t, _seed(1), 64),
                (mid, z, z[:9], t, _seed(1), 64),
                (mid, z, z, t, torch.tensor([1], dtype=torch.int32), 64),
                (mid, z, z, t, _seed(1), 0)):
        with pytest.raises(ValueError):
            TM.kernel_args(TM.RATIO, media, *bad)

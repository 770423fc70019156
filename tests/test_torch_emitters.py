"""The port's emitters (ppg_tpu_torch/emitters/{envmap,delta,sunsky,
area}.py) against ppg_tpu's, and K10 (csrc/envmap.cu) compiled for the
CPU under tools/cuda_shim.py against its plain version.

- The sun and sky rasters (sky, sun, sunsky; the sun's coordinates from a
  date or a direction; the directional sun) equal ppg_tpu's bit for bit.
- EnvmapArrays' tables equal ppg_tpu's bit for bit for a random 16 x 32
  map, a map with black rows and a 4096 x 2048 sunsky.
- lookup_plain (eval_env and pdf_direct) and sample_direct_plain against
  ppg_tpu's eval_env, pdf_direct and sample_direct on the same numpy
  inputs, a turned map: values, pdfs, distances and directions within a
  relative 2e-5 (atan2, acos, sin, cos and sqrt are XLA's on one side and
  PyTorch's on the other); the CDF picks, which depend only on the
  uniforms and the tables, exactly.
- The delta emitters' sample_direct against ppg_tpu's: point and
  directional equal within 1e-6; the spot equal inside its beam and
  beyond its cutoff and, in the transition band, linear in the angle
  (Mitsuba's spot.cpp) where ppg_tpu's is linear in the cosine.
- The tracer's NEE pick over area, environment and delta slots
  (_sample_emitters) against ppg_tpu's on the sky box for the same
  uniforms, within a relative 2e-5, and the area emitters' pdf with the
  slot count.
- K10 under the shim (atan2, acos, sin and cos patched to the C
  library's in the plain version, sqrt to a correctly rounded one) bit
  for bit with the plain version, in both modes, with and without a gate
  and a slot count, on tools/env_cases.py's edge maps and lanes.
- ppg_tpu's tests/test_envmap.py on the port: the pdf integrates to one,
  sample and pdf agree, the Monte Carlo estimate of the map's integral,
  the rotation, the sun's position, the sky's raster, the sun's power
  under sunRadiusScale, and the chi-square test of sample_direct's
  directions against pdf_direct (tests/chi2util.py).
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.emitters import delta as JDE
from ppg_tpu.emitters import envmap as JEV
from ppg_tpu.emitters import sunsky as JSS
from ppg_tpu_torch.emitters import area as E
from ppg_tpu_torch.emitters import delta as DE
from ppg_tpu_torch.emitters import envmap as EV
from ppg_tpu_torch.emitters import sunsky as SS
from ppg_tpu_torch.tools import cuda_shim, env_cases

RTOL = 2e-5


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# the sun and sky rasters

@pytest.mark.parametrize("kind,props", [
    ("sky", dict(hour=9.0, turbidity=5.0, resolution=64)),
    ("sun", dict(hour=9.0, turbidity=5.0, resolution=64, sunRadiusScale=4.0)),
    ("sunsky", dict(sunDirection=[0.0, 0.5, -1.0], resolution=128,
                    stretch=1.1, extend=True, albedo=[0.1, 0.2, 0.3])),
])
def test_sun_sky_rasters_equal_ppg_tpu(kind, props):
    a = SS.rasterize_sun_sky(props, kind)
    b = JSS.rasterize_sun_sky(props, kind)
    assert a.dtype == np.float32 and np.array_equal(_bits(a), _bits(b))
    assert SS.compute_sun_coordinates(props) == \
        JSS.compute_sun_coordinates(props)
    da, ia = SS.directional_sun(props)
    db, ib = JSS.directional_sun(props)
    assert np.array_equal(da, db) and np.array_equal(ia, ib)


# the tables

def _tables_equal(img, rot):
    got = EV.EnvmapArrays.from_image(img, rot, np.zeros(3), np.ones(3), "cpu")
    want = JEV.EnvmapArrays.from_image(img, rot, np.zeros(3), np.ones(3))
    for f in EV.EnvmapArrays.FIELDS:
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(want, f))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        assert np.array_equal(_bits(a), _bits(b)), f
    assert (got.H, got.W) == (want.H, want.W)
    return got


def test_tables_equal_ppg_tpu():
    rng = np.random.default_rng(1)
    _tables_equal(rng.random((16, 32, 3)).astype(np.float32), np.eye(3))
    img, rot = env_cases.edge_maps()["black rows, turned"]
    env = _tables_equal(img, rot)
    cdf = env.col_cdf.reshape(16, 33)
    assert float(cdf[0, :-1].abs().max()) == 0.0 and float(cdf[0, -1]) == 1.0


def test_4096_sunsky_tables_equal_ppg_tpu():
    img = SS.rasterize_sun_sky(dict(sunDirection=[0.0, 0.5, -1.0],
                                    resolution=4096), "sunsky")
    assert img.shape == (2048, 4096, 3)
    env = _tables_equal(img, np.eye(3))
    assert float(env.img_flat.max()) > 1e4


@pytest.fixture(scope="module")
def turned():
    img, rot = env_cases.edge_maps()["black rows, turned"]
    lanes = env_cases.edge_lanes(EV.EnvmapArrays.arrays(
        img, rot, np.zeros(3), np.ones(3)), 4000, seed=3)
    # points strictly inside the bounding sphere: on it, the far hit's
    # sign is the rounding of either package
    lanes["p"] = np.random.default_rng(4).random((4000, 3)).astype(
        np.float32)
    return (EV.EnvmapArrays.from_image(img, rot, np.zeros(3), np.ones(3),
                                       "cpu"),
            JEV.EnvmapArrays.from_image(img, rot, np.zeros(3), np.ones(3)),
            lanes)


def _close(a, b, rtol=RTOL, atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(b), 1e-30)
    bad = np.abs(a - b) > rtol * scale + atol
    assert not bad.any(), (int(bad.sum()), a[bad][:5], b[bad][:5])


def test_lookup_matches_ppg_tpu(turned):
    env, jenv, lanes = turned
    d = lanes["d"]
    value, pdf = EV.lookup_plain(env, torch.from_numpy(d))
    # the pdf grows as 1/sin(theta) near the poles: an ulp of the
    # direction moves it further there
    _close(value, JEV.eval_env(jenv, jnp.asarray(d)), 1e-4, 1e-6)
    _close(pdf, JEV.pdf_direct(jenv, jnp.asarray(d)), 1e-4, 1e-6)
    assert torch.equal(EV.eval_env(env, torch.from_numpy(d)), value)
    assert torch.equal(EV.pdf_direct(env, torch.from_numpy(d)), pdf)


def test_sample_matches_ppg_tpu(turned):
    env, jenv, lanes = turned
    ux, uy, p = lanes["ux"], lanes["uy"], lanes["p"]
    got = EV.sample_direct_plain(env, torch.from_numpy(p),
                                 torch.from_numpy(ux), torch.from_numpy(uy))
    want = JEV.sample_direct(jenv, jnp.asarray(p),
                             jnp.asarray(np.stack([ux, uy], -1)))
    for k in ("pdf", "value", "dist"):
        _close(got[k], want[k], RTOL, 1e-6)
    _close(got["d"], want["d"], RTOL, 1e-6)
    # the tent jitter reaches the black rows on some samples: pdf 0
    assert float((got["pdf"] > 0).float().mean()) > 0.8
    # the picks: the same rows and columns from the same uniforms
    H, W = env.H, env.W
    zero = torch.zeros(4000, dtype=torch.int32)
    row, _ = EV._sample_cdf(env.row_cdf, zero, H, torch.from_numpy(uy))
    jrow, _ = JEV._sample_cdf(jenv.row_cdf, jnp.zeros(4000, jnp.int32), H,
                              jnp.asarray(uy), 6)
    assert np.array_equal(row.numpy(), np.asarray(jrow))
    col, _ = EV._sample_cdf(env.col_cdf, row * (W + 1), W,
                            torch.from_numpy(ux))
    jcol, _ = JEV._sample_cdf(jenv.col_cdf, jrow * (W + 1), W,
                              jnp.asarray(ux), 7)
    assert np.array_equal(col.numpy(), np.asarray(jcol))


def test_gate_and_slot_count(turned):
    env, _, lanes = turned
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    gate = EV.Gate(t["key"], 1, t["m1"], t["m2"])
    full = EV.sample_direct_plain(env, t["p"], t["ux"], t["uy"])
    got = EV.sample_direct_plain(env, t["p"], t["ux"], t["uy"], gate, 3)
    m = EV.gate_mask(gate, 4000, "cpu")
    assert 0 < int(m.sum()) < 4000
    for k in ("d", "dist", "pdf", "value"):
        assert float(got[k][~m].abs().max()) == 0.0
    assert torch.equal(got["d"][m], full["d"][m])
    assert torch.equal(got["pdf"][m], full["pdf"][m] * np.float32(1 / 3))
    assert torch.equal(got["value"][m], full["value"][m] * 3.0)
    v, p = EV.lookup_plain(env, t["d"], gate, 3)
    v0, p0 = EV.lookup_plain(env, t["d"])
    assert torch.equal(v[m], v0[m]) and float(v[~m].abs().max()) == 0.0
    assert torch.equal(p[m], p0[m] * np.float32(1 / 3))


# the delta emitters

def _delta_pair(table):
    lo, hi = np.zeros(3), np.array([2.0, 2.0, 2.0])
    return (DE.DeltaEmitterArrays.from_table(table, lo, hi, "cpu"),
            JDE.DeltaEmitterArrays.from_table(table, lo, hi))


SPOT = dict(type=1, position=(0.0, 2.0, 0.0), direction=(0.0, -1.0, 0.0),
            intensity=(10.0, 10.0, 10.0), cutoff_deg=40.0, beamwidth_deg=20.0)


def test_point_and_directional_match_ppg_tpu():
    em, jem = _delta_pair([
        dict(type=0, position=(0.5, 1.5, 0.2), intensity=(3.0, 2.0, 1.0)),
        dict(type=2, direction=(0.2, -1.0, 0.3), intensity=(1.0, 2.0, 3.0))])
    rng = np.random.default_rng(5)
    p = rng.random((1000, 3)).astype(np.float32)
    slot = (np.arange(1000) % 2).astype(np.int32)
    got = DE.sample_direct(em, torch.from_numpy(slot), torch.from_numpy(p))
    want = JDE.sample_direct(jem, jnp.asarray(slot), jnp.asarray(p))
    for k in ("d", "dist", "pdf", "value"):
        _close(got[k], want[k], 1e-6)
    assert bool(got["discrete"].all())


def test_spot_falloff_is_linear_in_the_angle():
    """Inside the beam (angle <= 20 deg) and beyond the cutoff (>= 40 deg)
    the port equals ppg_tpu; in the band it is Mitsuba's (cutoff - angle)
    / (cutoff - beam), which ppg_tpu's cosine ramp is not."""
    em, jem = _delta_pair([SPOT])
    ang = np.deg2rad(np.array([0.0, 10.0, 19.0, 25.0, 30.0, 35.0, 41.0,
                               60.0]))
    # points on the plane y = 0 at those angles from the spot's axis
    p = np.stack([2.0 * np.tan(ang), np.zeros_like(ang), np.zeros_like(ang)],
                 -1).astype(np.float32)
    slot = np.zeros(len(ang), np.int32)
    got = DE.sample_direct(em, torch.from_numpy(slot), torch.from_numpy(p))
    want = JDE.sample_direct(jem, jnp.asarray(slot), jnp.asarray(p))
    d2 = (p * p).sum(-1) + 4.0
    fall = got["value"][:, 0].numpy() * d2 / 10.0
    jfall = np.asarray(want["value"])[:, 0] * d2 / 10.0
    outside = (ang <= np.deg2rad(19.0)) | (ang >= np.deg2rad(41.0))
    _close(fall[outside], jfall[outside], 1e-5, 1e-7)
    band = ~outside
    mitsuba = (np.deg2rad(40.0) - ang[band]) / np.deg2rad(20.0)
    _close(fall[band], mitsuba, 1e-4)
    cosine = (np.cos(ang[band]) - np.cos(np.deg2rad(40.0))) / (
        np.cos(np.deg2rad(20.0)) - np.cos(np.deg2rad(40.0)))
    _close(jfall[band], cosine, 1e-4)
    assert np.all(np.abs(fall[band] - jfall[band]) > 0.02)


# the tracer's pick over every emitter kind

def test_sample_emitters_match_ppg_tpu():
    import jax

    from ppg_tpu.integrators import driver as JD
    from ppg_tpu.integrators import wavefront as JW
    from ppg_tpu.scene.testscenes import scene_from_xml as j_scene
    from ppg_tpu_torch.integrators import wavefront as W
    from ppg_tpu_torch.scene.testscenes import (mini_cbox_sky_xml,
                                                scene_from_xml)

    xml = mini_cbox_sky_xml(resolution=64)
    sc, jsc = scene_from_xml(xml), j_scene(xml)
    scene = W.DeviceScene.from_scene(sc, "cpu")
    jscene = JW.DeviceScene.from_scene(jsc)
    assert W.n_emitter_slots(scene) == (1, 1, 2)
    rng = np.random.default_rng(6)
    L = 4000
    p = (rng.random((L, 3)) * [1.8, 1.8, 1.8] + [-0.9, 0.1, -0.9]).astype(
        np.float32)
    ref_n = np.tile(np.float32([0.0, 1.0, 0.0]), (L, 1))
    ref_n[::3] = 0.0  # transmissive lanes
    u = rng.random((L, 2)).astype(np.float32)
    ones = torch.ones(L, dtype=torch.bool)
    got = W._sample_emitters(scene, torch.from_numpy(p),
                             torch.from_numpy(ref_n), torch.from_numpy(u),
                             ones, ones)
    cfg = JD.make_config(jsc, guiding=False)
    assert cfg.has_env
    want, n_slots = jax.jit(lambda *a: JW._sample_emitters(
        jscene, cfg, *a))(jnp.asarray(p), jnp.asarray(ref_n), jnp.asarray(u))
    assert n_slots == 4
    for k in ("d", "dist", "pdf"):
        _close(got[k], want[k], 1e-4, 1e-6)
    # the spot (slot 2, axis -y) in its transition band, 20-30 degrees
    # off its axis: the port's falloff is Mitsuba's, not ppg_tpu's
    slot = np.clip((u[:, 0] * 4).astype(np.int32), 0, 3)
    cos_ang = got["d"][:, 1].numpy()
    band = (slot == 2) & (cos_ang > np.cos(np.deg2rad(30.0))) & (
        cos_ang < np.cos(np.deg2rad(20.0)))
    assert band.sum() > 10
    _close(got["value"][~band], np.asarray(want["value"])[~band], 1e-4, 1e-6)
    assert np.all(got["value"][band].numpy() < np.asarray(want["value"])[band])
    assert np.array_equal(got["discrete"].numpy(),
                          np.asarray(want["discrete"]))
    for s in range(4):  # every slot drew samples that reach their emitter
        assert float((got["pdf"][torch.from_numpy(slot == s)] > 0)
                     .float().mean()) > 0.02, s
    # the area pdf with the slot count: the whole set's 1/4, not 1/1
    hit = torch.from_numpy(p[:8])
    n = torch.tensor([[0.0, -1.0, 0.0]]).repeat(8, 1)
    eid = torch.zeros(8, dtype=torch.int32)
    one = E.pdf_direct(scene.emitters, eid, hit + 0.5, n, hit)
    assert torch.equal(E.pdf_direct(scene.emitters, eid, hit + 0.5, n, hit,
                                    n_slots=4), one / 4)


# K10 under the shim

@pytest.fixture(scope="module")
def host_k10(tmp_path_factory):
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    from ppg_tpu_torch.native import CSRC

    lib = cuda_shim.build_host(os.path.join(CSRC, "envmap.cu"),
                               str(tmp_path_factory.mktemp("k10_host")),
                               "k10_host", launches=2)
    lib.ppg_env.argtypes = EV.ARGTYPES
    lib.ppg_env.restype = ctypes.c_int

    def k10(mode, env, x, ux=None, uy=None, gate=None, n_slots=1):
        args = EV.kernel_args(mode, env, x, ux, uy, gate, n_slots)
        L = x.shape[0]
        out = [torch.full(s, 7.0) for s in ((L, 3), (L,), (L,), (L, 3))]
        assert lib.ppg_env(*args, *(t.data_ptr() for t in out), L, 0,
                           None) == 0
        if mode == EV.SAMPLE:
            return dict(zip(("d", "dist", "pdf", "value"), out))
        return out[3], out[2]

    return k10


def _as_the_kernel(monkeypatch):
    """atan2, acos, sin and cos as the kernel computes them under the
    shim (the C library's), sqrt correctly rounded (PyTorch's CPU sqrt is
    not, always)."""
    libm = ctypes.CDLL("libm.so.6")
    fns = {}
    for name, k in (("atan2f", 2), ("acosf", 1), ("sinf", 1), ("cosf", 1)):
        f = getattr(libm, name)
        f.argtypes = [ctypes.c_float] * k
        f.restype = ctypes.c_float
        fns[name] = f

    def each(f):
        return lambda *xs: torch.tensor(
            [f(*v) for v in zip(*(x.reshape(-1).tolist() for x in xs))],
            dtype=torch.float32).reshape(xs[0].shape)

    for name in ("atan2", "acos", "sin", "cos"):
        monkeypatch.setattr(torch, name, each(fns[name + "f"]))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))


def _same(a, b):
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).reshape(len(a), -1).any(-1).sum())


L_SHIM = 3000


@pytest.mark.parametrize("name", list(env_cases.edge_maps()))
def test_k10_edges_on_the_cpu_equal_plain(host_k10, name, monkeypatch):
    img, rot = env_cases.edge_maps()[name]
    env = EV.EnvmapArrays.from_image(img, rot, np.zeros(3), np.ones(3), "cpu")
    t = {k: torch.from_numpy(v) for k, v in env_cases.edge_lanes(
        EV.EnvmapArrays.arrays(img, rot, np.zeros(3), np.ones(3)), L_SHIM,
        seed=7).items()}
    _as_the_kernel(monkeypatch)
    # the shim's grid is 6 blocks, so each takes two of the 12 tiles: no
    # gate fills the queue on every tile, the key gate never, and the mask
    # gate (about 230 lanes a tile) fills it on the second tile and leaves
    # a remainder
    for gate, n in ((None, 1), (EV.Gate(t["key"], 1, t["m1"], t["m2"]), 4),
                    (EV.Gate(m1=t["m1"]), 2)):
        got = host_k10(EV.SAMPLE, env, t["p"], t["ux"], t["uy"], gate, n)
        want = EV.sample_direct_plain(env, t["p"], t["ux"], t["uy"], gate, n)
        for k in ("d", "dist", "pdf", "value"):
            _same(got[k], want[k])
        got = host_k10(EV.LOOKUP, env, t["d"], gate=gate, n_slots=n)
        want = EV.lookup_plain(env, t["d"], gate, n)
        _same(got[0], want[0])
        _same(got[1], want[1])
    # strided inputs: the points and directions as views of a wider row,
    # the row uniform a column of a [L, 2] draw
    wide = torch.zeros((L_SHIM, 7))
    wide[:, 2:5] = t["d"]
    u2 = torch.stack([t["ux"], t["uy"]], -1)
    got = host_k10(EV.LOOKUP, env, wide[:, 2:5])
    _same(got[0], EV.lookup_plain(env, t["d"])[0])
    wide[:, 2:5] = t["p"]
    got = host_k10(EV.SAMPLE, env, wide[:, 2:5], t["ux"], u2[:, 1])
    want = EV.sample_direct_plain(env, t["p"], t["ux"], t["uy"])
    _same(got["value"], want["value"])
    _same(got["d"], want["d"])


@pytest.mark.parametrize("name", ["black rows, turned",
                                  "4100 x 2, tall, turned"])
def test_k10_scrambled_tables_on_the_cpu_equal_plain(host_k10, name,
                                                     monkeypatch):
    img, rot = env_cases.edge_maps()[name]
    arrays = env_cases.scrambled(EV.EnvmapArrays.arrays(
        img, rot, np.zeros(3), np.ones(3)))
    env = EV.EnvmapArrays(arrays, "cpu")
    t = {k: torch.from_numpy(v) for k, v in env_cases.edge_lanes(
        arrays, L_SHIM, seed=5).items()}
    _as_the_kernel(monkeypatch)
    got = host_k10(EV.SAMPLE, env, t["p"], t["ux"], t["uy"])
    want = EV.sample_direct_plain(env, t["p"], t["ux"], t["uy"])
    for k in ("d", "dist", "pdf", "value"):
        _same(got[k], want[k])
    # searches that compared a NaN entry and still gave a finite sample
    assert int(want["d"].isfinite().all(-1).sum()) > L_SHIM // 5


def test_kernel_args_refuse_bad_tensors(turned):
    env = turned[0]
    d = torch.zeros((10, 3))
    with pytest.raises(ValueError):
        EV.kernel_args(EV.LOOKUP, env, d.double(), None, None, None, 1)
    with pytest.raises(ValueError):
        EV.kernel_args(EV.SAMPLE, env, d, torch.zeros(9), torch.zeros(10),
                       None, 1)
    with pytest.raises(ValueError):
        EV.kernel_args(EV.LOOKUP, env, d, None, None,
                       EV.Gate(torch.zeros(10, dtype=torch.int64), 0), 1)
    with pytest.raises(ValueError):
        EV.kernel_args(EV.LOOKUP, env, d, None, None, None, 0)


# ppg_tpu's tests/test_envmap.py on the port

def _env(img, rot=np.eye(3)):
    return EV.EnvmapArrays.from_image(img, rot, np.zeros(3), np.ones(3),
                                      "cpu")


def _sphere_dirs(n, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return torch.from_numpy(
        (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32))


def _sample(env, u):
    L = u.shape[0]
    return EV.sample_direct(env, torch.full((L, 3), 0.5), u[:, 0], u[:, 1])


def test_pdf_integrates_to_one():
    rng = np.random.default_rng(1)
    env = _env(rng.random((16, 32, 3)).astype(np.float32) + 0.05)
    pdf = EV.pdf_direct(env, _sphere_dirs(200_000)).numpy()
    assert abs(pdf.mean() * 4 * np.pi - 1.0) < 0.02


def test_sample_pdf_consistency():
    rng = np.random.default_rng(2)
    env = _env((rng.random((16, 32, 3)) ** 2).astype(np.float32) + 0.01)
    ds = _sample(env, torch.from_numpy(rng.random((50_000, 2)).astype(
        np.float32)))
    p1, p2 = ds["pdf"].numpy(), EV.pdf_direct(env, ds["d"]).numpy()
    ok = p1 > 0
    rel = np.abs(p1[ok] - p2[ok]) / np.maximum(p1[ok], 1e-6)
    assert np.quantile(rel, 0.95) < 1e-3


def test_mc_estimate_matches_integral():
    rng = np.random.default_rng(3)
    env = _env((rng.random((8, 16, 3)) * 2).astype(np.float32) + 0.1)
    ds = _sample(env, torch.from_numpy(rng.random((400_000, 2)).astype(
        np.float32)))
    est = ds["value"].numpy().mean(axis=0)
    ref = EV.eval_env(env, _sphere_dirs(400_000, seed=4)).numpy().mean(
        axis=0) * 4 * np.pi
    assert np.allclose(est, ref, rtol=0.03), (est, ref)


def test_rotation():
    img = np.zeros((8, 16, 3), np.float32)
    img[0] = 10.0  # a bright pole at local +Y
    img += 0.01
    env = _env(img, np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0.0]]))
    up = EV.eval_env(env, torch.tensor([[0.0, 0, 1]]))[0]
    side = EV.eval_env(env, torch.tensor([[0.0, 1, 0]]))[0]
    assert up[0] > 5.0 and side[0] < 0.1


def test_sun_position_and_sky_raster():
    elev, _ = SS.compute_sun_coordinates(dict(hour=9.0))
    assert 0 < elev < np.pi / 2 and abs(np.rad2deg(elev) - 38.66) < 0.5
    img = SS.rasterize_sun_sky(dict(hour=9.0, turbidity=5.0), "sky")
    assert img.shape == (256, 512, 3) and img.min() >= 0
    assert img[:128].mean() > 0.01 and img[129:].max() == 0.0


def test_sun_power_independent_of_radius_scale():
    base = dict(hour=9.0, turbidity=5.0)
    p1 = SS.rasterize_sun_sky(dict(base, sunRadiusScale=1.0), "sun")
    p4 = SS.rasterize_sun_sky(dict(base, sunRadiusScale=4.0), "sun")
    H, W = p1.shape[:2]
    w = np.sin((np.arange(H) + 0.5) * np.pi / H)[:, None, None]
    pow1 = (p1 * w).sum() * (2 * np.pi / W) * (np.pi / H)
    pow4 = (p4 * w).sum() * (2 * np.pi / W) * (np.pi / H)
    assert abs(pow1 / pow4 - 1) < 0.02


def test_envmap_sample_chi2():
    from chi2util import run_sphere_chi2

    rng = np.random.default_rng(31)
    env = _env((rng.random((16, 32, 3)) ** 2).astype(np.float32) + 0.01)
    ds = _sample(env, torch.from_numpy(rng.random((200_000, 2)).astype(
        np.float32)))
    ok, stats = run_sphere_chi2(
        ds["d"].numpy(),
        lambda d: EV.pdf_direct(env, torch.from_numpy(
            np.asarray(d, np.float32))).numpy(),
        rng, nb_ct=10, nb_ph=10, significance=0.01, n_tests=1)
    assert ok, stats

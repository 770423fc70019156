"""The port's core math, camera, film, diffuse BSDF, area emitter, scene
tables and configuration against ppg_tpu on identical numpy inputs.
Elementwise math is compared within 1e-6 (XLA and PyTorch may evaluate
transcendental functions and 3-term sums in another order); packed host
tables are compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.bsdf import bsdf as JB
from ppg_tpu.core import vecmath as JV
from ppg_tpu.core import warp as JW
from ppg_tpu.emitters import area as JE
from ppg_tpu.integrators import driver as JD
from ppg_tpu.integrators import wavefront as JWF
from ppg_tpu.render import film as JF
from ppg_tpu.render import sensor as JS
from ppg_tpu_torch.bsdf import bsdf as TB
from ppg_tpu_torch.core import vecmath as TV
from ppg_tpu_torch.core import warp as TW
from ppg_tpu_torch.emitters import area as TE
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators import wavefront as TWF
from ppg_tpu_torch.render import film as TF
from ppg_tpu_torch.render import sensor as TS
from ppg_tpu_torch.scene import mini_cbox

TOL = dict(rtol=1e-6, atol=1e-6)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def cbox():
    return mini_cbox(res=16, max_depth=6)


def test_vecmath_matches():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(500, 3)).astype(np.float32)
    b = rng.normal(size=(500, 3)).astype(np.float32)
    n = _unit(rng, 500)
    n[:5] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0, 0, 0.999]]
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ta, tb, tn = (torch.from_numpy(x) for x in (a, b, n))
    _close(TV.dot(ta, tb), JV.dot(a, b))
    _close(TV.normalize(ta), JV.normalize(a))
    _close(TV.safe_sqrt(ta[:, 0]), JV.safe_sqrt(a[:, 0]))
    s, t = TV.build_frame(tn)
    js, jt = JV.build_frame(jnp.asarray(n))
    _close(s, js)
    _close(t, jt)
    loc = TV.to_local(s, t, tn, ta)
    _close(loc, JV.to_local(js, jt, jnp.asarray(n), a))
    _close(TV.to_world(s, t, tn, loc), JV.to_world(js, jt, jnp.asarray(n),
                                                   np.asarray(loc)))


def test_warps_and_canonical_map_match():
    rng = np.random.default_rng(1)
    u = rng.random((2000, 2)).astype(np.float32)
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [1 - 1e-7, 0.25]]
    tu = torch.from_numpy(u)
    w = TW.square_to_cosine_hemisphere(tu)
    _close(w, JW.square_to_cosine_hemisphere(u))
    _close(TW.square_to_cosine_hemisphere_pdf(w),
           JW.square_to_cosine_hemisphere_pdf(np.asarray(w)))
    _close(TW.square_to_uniform_sphere(tu), JW.square_to_uniform_sphere(u))
    _close(TW.canonical_to_dir(tu), JW.canonical_to_dir(u))
    d = _unit(rng, 2000)
    d[0] = [np.nan, 0, 0]
    d[1] = [0, 0, 1]
    _close(TW.dir_to_canonical(torch.from_numpy(d)), JW.dir_to_canonical(d))
    assert TW.INV_FOURPI == JW.INV_FOURPI


def test_diffuse_bsdf_matches(cbox):
    rng = np.random.default_rng(2)
    L = 3000
    mid = rng.integers(0, 3, L).astype(np.int32)
    wi = _unit(rng, L)
    wo = _unit(rng, L)
    u = rng.random((L, 3)).astype(np.float32)
    jm = JB.MaterialArrays.from_table(cbox.materials)
    jp = JB.gather_params(jm, jnp.asarray(mid))
    tm = TB.MaterialArrays.from_table(cbox.materials, "cpu")
    tp = TB.gather_params(tm, torch.from_numpy(mid))
    twi, two, tu = (torch.from_numpy(x) for x in (wi, wo, u))
    _close(TB.eval_bsdf(tp, twi, two), JB.eval_bsdf(jp, wi, wo, jm.present))
    _close(TB.pdf_bsdf(tp, twi, two), JB.pdf_bsdf(jp, wi, wo, jm.present))
    got = TB.sample_bsdf(tp, twi, tu)
    want = JB.sample_bsdf(jp, wi, u, jm.present)
    # the cosine warp's z = sqrt(1 - r^2) turns a 1-ulp difference between
    # XLA's and PyTorch's sin/cos into ~6e-8/z near the horizon
    wo, w, pdf, delta, eta = (x.numpy() for x in got)
    jwo, jw, jpdf, jdelta, jeta = (np.asarray(x) for x in want)
    tol = 1e-6 + 6e-8 / np.maximum(np.abs(jwo[:, 2]), 1e-3)
    assert (np.abs(wo - jwo) <= tol[:, None]).all()
    assert (np.abs(pdf - jpdf) <= tol).all()
    np.testing.assert_allclose(w, jw, **TOL)
    np.testing.assert_array_equal(delta, jdelta)
    np.testing.assert_array_equal(eta, jeta)
    js, jd, _, _ = JB.lane_flags(jp)
    ts, td, _, _ = TB.lane_flags(tp)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_eval_radiance_matches(cbox):
    rng = np.random.default_rng(3)
    L = 1000
    eid = rng.integers(-1, 1, L).astype(np.int32)
    n, w = _unit(rng, L), _unit(rng, L)
    got = TE.eval_radiance(TE.EmitterArrays.from_scene(cbox, "cpu"),
                           *(torch.from_numpy(x) for x in (eid, n, w)))
    want = JE.eval_radiance(JE.EmitterArrays.from_scene(cbox), eid, n, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() > 0).any()


def test_sample_rays_match(cbox):
    rng = np.random.default_rng(4)
    W, H = cbox.film["width"], cbox.film["height"]
    pos = (rng.random((4096, 2)) * [W, H]).astype(np.float32)
    got = TS.make_sensor(cbox.sensor, cbox.film, "cpu").sample_rays(
        torch.from_numpy(pos))
    want = JS.make_sensor(cbox.sensor, cbox.film).sample_rays(
        jnp.asarray(pos))
    for a, b in zip(got, want):
        _close(a, b)
    assert got[1].dtype == torch.float32


def test_splat_box_linear_matches():
    rng = np.random.default_rng(5)
    W, H, C = 12, 10, 64
    vals = rng.random((C, 3)).astype(np.float32)
    valid = rng.random(C) < 0.8
    tf = TF.Film(W, H, "box", "cpu")
    jf = JF.Film(W, H, "box")
    tb, jb = tf.zeros_flat(C), jf.zeros_flat(C)
    for start in (0, C):
        tb = tf.splat_box_linear(tb, start, torch.from_numpy(vals),
                                 torch.from_numpy(valid))
        jb = jf.splat_box_linear(jb, start, jnp.asarray(vals),
                                 jnp.asarray(valid))
    _close(TF.Film.develop(tf.unflatten(tb)),
           JF.Film.develop(jf.unflatten(jb)))
    with pytest.raises(ValueError, match="rfilter"):
        TF.Film(W, H, "sinc")


def test_scene_tables_and_config_match(cbox):
    dev = TWF.DeviceScene.from_scene(cbox, "cpu")
    jdev = JWF.DeviceScene.from_scene(cbox)
    # bitwise: the id columns are int32 bit patterns
    np.testing.assert_array_equal(dev.shade.numpy().view(np.int32),
                                  np.asarray(jdev.shade).view(np.int32))
    assert dev.eps == float(jdev.eps)
    jcfg = JD.make_config(cbox, guiding=True, record_vertices=True)
    tcfg = TD.make_config(cbox, guiding=True, record_vertices=True)
    for f in ("max_depth", "rr_depth", "strict_normals", "hide_emitters",
              "do_nee", "bsdf_fraction", "guiding", "record_vertices",
              "sampler"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.n_bounces == jcfg.n_bounces
    for nee in ("kickstart", "always"):  # NEE is ported
        sc = mini_cbox(res=8, nee=nee)
        tn, jn = TD.make_config(sc), JD.make_config(sc)
        assert (tn.do_nee, tn.nee_always) == (jn.do_nee, jn.nee_always)
    # environment maps, media and subsurfaces are ported; the regenerative
    # tracer is not yet
    assert TD.make_config(cbox, has_env=True).has_env
    assert TD.make_config(cbox, has_media=True).has_media
    cfg = TD.make_config(cbox, has_subsurf=True, has_sss=True)
    assert cfg.has_subsurf and cfg.has_sss
    with pytest.raises(NotImplementedError, match="regen"):
        TD.make_config(cbox, force_machine=True)


def test_numpy_fresnel_copy_matches_original():
    from ppg_tpu.bsdf.fresnel import fresnel_diffuse_reflectance
    from ppg_tpu_torch.scene import fresnel_diffuse_reflectance as port

    for eta in (1.0, 1.33, 1.5, 1 / 1.5, 2.4):
        assert port(eta) == fresnel_diffuse_reflectance(eta)

"""The port's single scattering (ppg_tpu_torch/singlescatter.py) against
ppg_tpu's.

- sss_params and build_sss equal ppg_tpu's: on tests/test_singlescatter.py's
  cube (CUBE_SS_XML, with its row's clamps), and on the translucent box
  (scene/testscenes.py::mini_cbox_translucent_xml with its dipole sphere
  at scale 1), where the sphere's triangles are -1 in the
  single-scattering table and the cube's -1 in the dipole's.
- _hg, _atten and _refract against ppg_tpu's on random inputs within
  1e-6 relative.
- single_scatter lane by lane against ppg_tpu.singlescatter.single_scatter
  on CUBE_SS_XML, both fed the uniforms jax.random.uniform(key, (L, n_u))
  (ppg_tpu draws them inside from the key; the port takes them as an
  argument), once under its point light and once with a constant
  environment added (K10's gate in _sample_emitters): 2,048 lanes on
  the cube's faces, entering at random angles (some lanes -1). L_ss and
  the continuation's weight within 2e-4 relative of the lane's largest
  channel (XLA's and ATen's roundings of the casts, sqrt, exp, log and
  the Fresnel terms, compounded over the segments), the continuation's
  origin and direction within 2e-5. A lane may fall outside by a branch
  taken at its threshold (a sample at the segment's end, dist <= thick;
  a crossing at a cube edge; the entry's pick u < F_in): at most 8 of
  the 2,048 lanes, each one branch apart (measured: 0 under the point
  light, 0 with the environment).
- tests/test_singlescatter.py's quadrature oracle and continuation checks
  on the port (single_scatter at normal incidence on the cube's top face,
  4,096 lanes, uniforms from a seeded torch.Generator), with that test's
  tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu import singlescatter as JSS
from ppg_tpu.integrators import driver as JD
from ppg_tpu.integrators.wavefront import DeviceScene as JDeviceScene
from ppg_tpu.scene.testscenes import scene_from_xml as j_scene_from_xml
from ppg_tpu_torch import singlescatter as TSS
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.wavefront import DeviceScene
from ppg_tpu_torch.scene.testscenes import (mini_cbox_translucent_xml,
                                            scene_from_xml)
from test_singlescatter import CUBE_SS_XML, _fresnel_ext_np, _oracle_cube

_ENV = ('<emitter type="constant"><rgb name="radiance" value="0.3, 0.4, '
        '0.5"/></emitter>\n</scene>')


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(xml):
    """(port scene, its cfg, ppg_tpu's scene, its cfg) with the
    subsurface tables built."""
    sc_t = scene_from_xml(xml)
    scene = TD.ensure_subsurface(sc_t, DeviceScene.from_scene(sc_t, "cpu"))
    sc_j = j_scene_from_xml(xml)
    dev_j = JD.ensure_subsurface(sc_j, JDeviceScene.from_scene(sc_j))
    return (scene, TD.make_config(sc_t, guiding=False), dev_j,
            JD.make_config(sc_j, guiding=False))


@pytest.mark.parametrize("xml", [
    CUBE_SS_XML, CUBE_SS_XML.replace('"singleScatterDepth" value="3"',
                                     '"singleScatterDepth" value="11"'),
    mini_cbox_translucent_xml(res=16, scale=1.0)],
    ids=["cube", "depth clamped", "translucent box"])
def test_tables_equal_ppg_tpu(xml):
    scene, cfg, dev_j, cfg_j = _both(xml)
    for ours, theirs in ((scene.sss, dev_j.sss), (scene.subsurf,
                                                  dev_j.subsurf)):
        assert ours.num == theirs.num
        for f in ("params", "tri_ss"):
            a, b = getattr(ours, f).numpy(), np.asarray(getattr(theirs, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (scene.sss.fss, scene.sss.depth) == (dev_j.sss.fss,
                                                dev_j.sss.depth)
    assert (cfg.has_sss, cfg.has_subsurf) == (cfg_j.has_sss,
                                              cfg_j.has_subsurf)
    rows = scene_from_xml(xml).subsurfaces
    for r in rows:
        if r["kind"] == "singlescatter":
            np.testing.assert_array_equal(TSS.sss_params(r),
                                          JSS.sss_params(r))
    if len(rows) == 2:
        # each table gates the other kind's triangles out
        both = (scene.sss.tri_ss >= 0) & (scene.subsurf.tri_ss >= 0)
        assert not bool(both.any())
        assert int((scene.sss.tri_ss >= 0).sum()) == 12
        assert int((scene.subsurf.tri_ss >= 0).sum()) == 16128


def test_helpers_equal_ppg_tpu():
    rng = np.random.default_rng(4)
    c = rng.uniform(-1, 1, 1000).astype(np.float32)
    g = rng.uniform(-0.9, 0.9, (1000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TSS._hg(torch.from_numpy(c), torch.from_numpy(g)).numpy(),
        np.asarray(JSS._hg(jnp.asarray(c), jnp.asarray(g))), rtol=1e-6)
    st = rng.uniform(0, 2, (1000, 3)).astype(np.float32)
    st[::7] = 0.0
    dist = rng.uniform(0, 3, 1000).astype(np.float32)
    np.testing.assert_allclose(
        TSS._atten(torch.from_numpy(st), torch.from_numpy(dist)).numpy(),
        np.asarray(JSS._atten(jnp.asarray(st), jnp.asarray(dist))),
        rtol=1e-6)
    n = rng.normal(size=(1000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wi = rng.normal(size=(1000, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    ci = (wi * n).sum(-1)
    eta = np.float32(1.5)
    ct = np.array([_fresnel_ext_np(float(x), float(eta))[1] for x in ci],
                  np.float32)
    args = (wi, n, ci, ct, np.full(1000, eta, np.float32))
    np.testing.assert_allclose(
        TSS._refract(*map(torch.from_numpy, args)).numpy(),
        np.asarray(JSS._refract(*map(jnp.asarray, args))), rtol=1e-5,
        atol=1e-6)


def _cube_lanes(L, seed):
    """Points on the cube's faces (inside [-0.95, 0.95] of the face),
    directions entering it at random angles, the face's outward normal;
    one lane in 16 not a singlescatter lane."""
    rng = np.random.default_rng(seed)
    ax = rng.integers(0, 3, L)
    sgn = rng.choice([-1.0, 1.0], L)
    p = rng.uniform(-0.95, 0.95, (L, 3))
    p[np.arange(L), ax] = sgn
    n = np.zeros((L, 3))
    n[np.arange(L), ax] = sgn
    d = rng.normal(size=(L, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cos = (d * n).sum(-1)
    d = np.where((cos > -0.1)[:, None], d - (cos + 0.1 + rng.uniform(
        0, 1, L))[:, None] * n, d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ss_id = np.where(np.arange(L) % 16 == 5, -1, 0)
    f = lambda a: a.astype(np.float32)
    return ss_id.astype(np.int32), f(p), f(d), f(n)


@pytest.mark.parametrize("env", [False, True], ids=["point", "point+env"])
def test_single_scatter_lanes_match_ppg_tpu(env):
    xml = CUBE_SS_XML.replace("</scene>", _ENV) if env else CUBE_SS_XML
    scene, cfg, dev_j, cfg_j = _both(xml)
    L = 2048
    ss_id, p, d, n = _cube_lanes(L, 9 if env else 8)
    key = jax.random.key(21)
    n_u = TSS.n_uniforms(scene.sss)
    assert n_u == dev_j.sss.depth * (2 + dev_j.sss.fss) + 1
    u = np.array(jax.random.uniform(key, (L, n_u)))
    Lj, cj = JSS.single_scatter(dev_j, cfg_j, *map(jnp.asarray, (
        ss_id, p, d, n, n)), key)
    Lt, ct = TSS.single_scatter(scene, cfg, *map(torch.from_numpy, (
        ss_id, p, d, n, n, u)))
    Lj, Lt = np.asarray(Lj, np.float64), Lt.numpy().astype(np.float64)
    assert (Lj[ss_id < 0] == 0).all() and (Lt[ss_id < 0] == 0).all()
    assert (Lj > 0).any(-1).mean() > 0.5
    wj, wt = np.asarray(cj["w"], np.float64), ct["w"].numpy()
    off = (np.abs(Lt - Lj) > 2e-4 * np.abs(Lj).max(-1, keepdims=True)
           + 1e-12).any(-1)
    off |= (np.abs(wt - wj) > 2e-4 * np.abs(wj).max(-1, keepdims=True)
            + 1e-12).any(-1)
    for k in ("o", "d"):
        off |= (np.abs(ct[k].numpy() - np.asarray(cj[k])) > 2e-5).any(-1)
    off |= ct["valid"].numpy() != np.asarray(cj["valid"])
    assert off.sum() <= 8, np.flatnonzero(off)[:20]


def test_single_scatter_matches_the_quadrature_oracle():
    """tests/test_singlescatter.py's oracle and continuation checks."""
    sc = scene_from_xml(CUBE_SS_XML)
    scene = TD.ensure_subsurface(sc, DeviceScene.from_scene(sc, "cpu"))
    cfg = TD.make_config(sc, guiding=False)
    assert scene.sss.num == 1 and scene.sss.fss == 2 \
        and scene.sss.depth == 3
    L = 4096
    p = torch.tensor([[0.0, 0.0, 1.0]]).repeat(L, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(L, 1)
    n = torch.tensor([[0.0, 0.0, 1.0]]).repeat(L, 1)
    gen = torch.Generator().manual_seed(7)
    u = torch.rand((L, TSS.n_uniforms(scene.sss)), generator=gen)
    L_ss, cont = TSS.single_scatter(
        scene, cfg, torch.zeros(L, dtype=torch.int32), p, d, n, n, u)
    got = L_ss.numpy().astype(np.float64)
    row = sc.subsurfaces[0]
    want = _oracle_cube(row["sigma_s"], row["sigma_a"], row["g3"],
                        row["eta"], fss=2, depth=3,
                        L_pos=np.array([0.0, 3.0, 0.0]),
                        I=[10.0, 10.0, 10.0], eps=float(scene.eps))
    assert want.min() > 0
    se = got.std(0) / np.sqrt(L)
    np.testing.assert_allclose(got.mean(0), want, rtol=0.05,
                               err_msg=f"se={se}, want={want}")
    # reflection lanes carry weight 1 and mirror straight back;
    # transmission lanes exit the far face straight through with
    # (1 - F_exit) exp(-sigma_t 2)
    co, cd = cont["o"].numpy(), cont["d"].numpy()
    cw = cont["w"].numpy().astype(np.float64)
    refl = cd[:, 2] > 0
    F_in, _ = _fresnel_ext_np(1.0, row["eta"])
    assert abs(refl.mean() - F_in) < 0.02
    np.testing.assert_allclose(
        cd[refl], np.broadcast_to([0, 0, 1.0], cd[refl].shape), atol=1e-5)
    np.testing.assert_allclose(cw[refl], 1.0, atol=1e-5)
    np.testing.assert_allclose(
        cd[~refl], np.broadcast_to([0, 0, -1.0], cd[~refl].shape),
        atol=1e-5)
    assert np.all(co[~refl, 2] < -1.0)  # exits below the bottom face
    sigma_t = np.asarray(row["sigma_s"]) + np.asarray(row["sigma_a"])
    want_w = (1 - F_in) * np.exp(-sigma_t * 2.0)
    np.testing.assert_allclose(cw[~refl].mean(0), want_w, rtol=0.02)

"""The port's textures (ppg_tpu_torch/scene/textures.py) against ppg_tpu's
on the CPU, on numpy inputs from a seed, and K9 (csrc/textures.cu) built
for the CPU under tools/cuda_shim.py against the plain version.

- TextureAtlas.build: every array bit for bit equal to ppg_tpu's for
  bitmap (EXR), checkerboard, gridtexture, scale, vertexcolors and
  wireframe specs; the scene's atlas with the wireframe's lineWidth = 0
  rule equal to ppg_tpu's DeviceScene.tex.
- sample_atlas, each mode and filter code: the base level and the
  footprint within 1e-6 (the XLA and ATen roundings of the same
  operations), the uv Jacobian within 1e-4 (each within 1e-5 relative
  too: a negative uscale clamps su to 1e-20 and sends the taps' texel
  coordinates past 2^31, where both packages' bilinear weights
  extrapolate to values near 1e11) on well-conditioned
  Jacobians (anisotropy at most 16) and the edge lanes (slot ids <= 0
  and past the last, negative and tiled uvs, the saturating floor, NaN
  and infinite uvs, zero and extreme differentials): NaN where ppg_tpu
  gives NaN. On near-degenerate ellipses F = AC - B^2 / 4 is rounding
  noise and the two packages' roundings pick different branches, so
  those are not compared.
- uv_differentials, perturb_normal (bump and normal map) and
  wireframe_color within 1e-4 (relative for the differentials).
- K9 under the shim, each mode and a stacked strided call: bit for bit
  with the plain version once the plain version's log2 and hypot are the
  C library's log2f and hypotf, which the kernel calls there, and its
  sqrt is correctly rounded (PyTorch's CPU log2 and sqrt are its own
  vectorised ones; on a card all are CUDA's).
- The assertions of ppg_tpu's test_textures.py (the MIP chain, a
  minified lookup), test_ewa.py (filter codes, an isotropic Jacobian is
  trilinear, EWA keeps the detail across the major axis, the anisotropy
  clamp, nearest, the perspective camera's direction differentials) and
  test_wireframe_curvature.py (edge and interior colours, the curvature
  colours of a sphere) on the port's functions.
"""

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.scene import textures as JT
from ppg_tpu_torch.io import exr
from ppg_tpu_torch.scene import textures as TX
from ppg_tpu_torch.tools import cuda_shim, texture_cases


@pytest.fixture(scope="module")
def tex_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("textures"))


@pytest.fixture(scope="module")
def specs(tex_dir):
    return texture_cases.atlas_specs(tex_dir)


@pytest.fixture(scope="module")
def atlases(specs, tex_dir):
    return (JT.TextureAtlas.build(specs, tex_dir),
            TX.TextureAtlas.build(specs, tex_dir, "cpu"))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                        a.shape, b.shape)
    assert (a.view(np.uint8) == b.view(np.uint8)).all()


def _wire(**kw):
    return dict(_otype="wireframe", **kw)


SPEC_KINDS = {
    "bitmap": lambda s: s[:4] + s[7:],
    "checkerboard": lambda s: [s[4]],
    "gridtexture": lambda s: [s[5]],
    "scale": lambda s: [s[6]],
    "vertexcolors": lambda s: [dict(_otype="vertexcolors"), s[4]],
    "wireframe": lambda s: [_wire(lineWidth=0.02, stepWidth=2.0),
                            _wire(edgeColor=0.3), s[5]],
}


@pytest.mark.parametrize("kind", sorted(SPEC_KINDS))
def test_atlas_build_equals_ppg_tpu(specs, tex_dir, kind):
    sp = SPEC_KINDS[kind](specs)
    ja = JT.TextureAtlas.build(sp, tex_dir)
    arr = TX.TextureAtlas.build_arrays(sp, tex_dir)
    for f in TX.TextureAtlas.FIELDS:
        _bits_equal(arr[f], getattr(ja, f))
    ta = TX.TextureAtlas(arr, "cpu")
    for f in TX.TextureAtlas.FIELDS:
        _bits_equal(getattr(ta, f).numpy(), getattr(ja, f))


def test_scene_atlas_with_the_wireframe_rule(tex_dir):
    from ppg_tpu.integrators.wavefront import DeviceScene as JDS
    from ppg_tpu.scene.testscenes import scene_from_xml as j_scene
    from ppg_tpu_torch.scene.testscenes import (
        mini_cbox_texture_variant_xml, scene_from_xml)

    xml = mini_cbox_texture_variant_xml("wireframe", tex_dir, res=8)
    ja = JDS.from_scene(j_scene(xml)).tex
    ta = TX.TextureAtlas.from_scene(scene_from_xml(xml), "cpu")
    assert float(ta.wfp[1, 0]) > 0  # lineWidth 0 -> 10% of the mean edge
    for f in TX.TextureAtlas.FIELDS:
        _bits_equal(getattr(ta, f).numpy(), getattr(ja, f))
    e = TX.TextureAtlas.empty("cpu")
    assert e.pixels.dtype == torch.float16 and bool((e.pixels == 1).all())
    assert e.meta.tolist() == [[0, 1, 1]] and e.n_slots == 1


def _lookup_pair(atlases, lanes, mode):
    ja, ta = atlases
    j = {k: jnp.asarray(v) for k, v in lanes.items()}
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    kw_j, kw_t = {
        "base": ({}, {}),
        "foot": (dict(foot_uv=j["foot"]), dict(foot_uv=t["foot"])),
        "duv": (dict(duv=(j["d0"], j["d1"])), dict(duv=(t["d0"], t["d1"]))),
    }[mode]
    want = np.asarray(JT.sample_atlas(ja, j["tex_id"], j["uv"], **kw_j))
    got = TX.sample_atlas(ta, t["tex_id"], t["uv"], **kw_t).numpy()
    return want, got


@pytest.mark.parametrize("mode,tol", [("base", 1e-6), ("foot", 1e-6),
                                      ("duv", 1e-4)])
def test_sample_atlas_matches_ppg_tpu(atlases, mode, tol):
    n_slots = atlases[1].n_slots
    edge = texture_cases.lanes(n_slots, 12, seed=1)
    good = texture_cases.lanes(n_slots, 20000, seed=2, well_conditioned=True)
    lanes = {k: np.concatenate([edge[k], good[k]]) for k in edge}
    want, got = _lookup_pair(atlases, lanes, mode)
    assert got.shape == want.shape == (20012, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=tol)
    # tex_id <= 0 is white; the saturating lanes are finite
    white = lanes["tex_id"] <= 0
    assert white.any() and (got[white] == 1.0).all()
    assert np.isfinite(got[:3]).all()


def test_floor_saturates_as_xla():
    x = np.array([3e9, -3e9, np.nan, np.inf, -np.inf, 2.5, -2.5],
                 np.float32)
    want = np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32))
    got = TX._floor_i32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist()[:4] == [2147483647, -2147483648, 0, 2147483647]


def _perspective(pkg, W=128, H=96):
    return pkg.PerspectiveSensor(dict(xfov=45.0, to_world=np.eye(4)),
                                 dict(width=W, height=H),
                                 *(("cpu",) if pkg.__name__.startswith(
                                     "ppg_tpu_torch") else ()))


def test_uv_differentials_match_ppg_tpu():
    from ppg_tpu.render import sensor as JS
    from ppg_tpu_torch.render import sensor as TS

    rng = np.random.default_rng(4)
    L = 4096
    pos = (rng.random((L, 2)) * [128, 96]).astype(np.float32)
    _, d, *_ = TS.PerspectiveSensor(
        dict(xfov=45.0, to_world=np.eye(4)), dict(width=128, height=96),
        "cpu").sample_rays(torch.from_numpy(pos))
    d = d.numpy()
    t = (1 + 3 * rng.random(L)).astype(np.float32)
    n = rng.normal(size=(L, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    dpdu = rng.normal(size=(L, 3)).astype(np.float32)
    dpdv = rng.normal(size=(L, 3)).astype(np.float32)
    jw = JT.uv_differentials(_perspective(JS), *(jnp.asarray(x) for x in
                                                 (d, t, n, dpdu, dpdv)),
                             jnp.ones(L, bool))
    tw = TX.uv_differentials(_perspective(TS), *(torch.from_numpy(x) for x
                                                 in (d, t, n, dpdu, dpdv)))
    for a, b in zip(jw, tw):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max())


@pytest.fixture(scope="module")
def height_atlases(tex_dir):
    from ppg_tpu_torch.scene.testscenes import write_texture_files

    paths = write_texture_files(tex_dir, floor_res=16, bump_res=32, seed=3)
    sp = [dict(_otype="bitmap", filename=paths["height"], gamma=1.0),
          dict(_otype="bitmap", filename=paths["normal"], gamma=1.0)]
    return (JT.TextureAtlas.build(sp, tex_dir),
            TX.TextureAtlas.build(sp, tex_dir, "cpu"))


def test_perturb_normal_matches_ppg_tpu(height_atlases):
    ja, ta = height_atlases
    rng = np.random.default_rng(6)
    L = 4096
    tid = rng.integers(-1, 3, L).astype(np.int32)
    is_nm = tid == 2
    uv = (rng.random((L, 2)) * 3 - 1).astype(np.float32)
    n = rng.normal(size=(L, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    dpdu = rng.normal(size=(L, 3)).astype(np.float32)
    dpdv = rng.normal(size=(L, 3)).astype(np.float32)
    args = (tid, is_nm, uv, n, dpdu, dpdv)
    want = np.asarray(JT.perturb_normal(ja, *(jnp.asarray(x)
                                              for x in args)))
    got = TX.perturb_normal(ta, *(torch.from_numpy(x) for x in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got[tid <= 0] == n[tid <= 0]).all()
    changed = np.abs(got - n).max(-1) > 1e-3
    assert changed[is_nm].mean() > 0.9 and changed[tid == 1].mean() > 0.5


def test_wireframe_color_matches_ppg_tpu_and_its_assertions():
    wfp = np.full((2, 8), -1.0, np.float32)
    wfp[1] = [0.1, 0.5, 1, 0, 0, 0, 1, 0]  # red edges, green interior
    ja = JT.TextureAtlas.empty()
    ja.wfp = jnp.asarray(wfp)
    ta = TX.TextureAtlas.empty("cpu")
    ta.wfp = torch.from_numpy(wfp)
    rng = np.random.default_rng(7)
    L = 1000
    tri = rng.normal(size=(L, 12)).astype(np.float32)
    bu = rng.random(L).astype(np.float32)
    bv = ((1 - bu) * rng.random(L)).astype(np.float32)
    tri[:3] = [0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0]
    bu[:3], bv[:3] = [0.5, 1 / 3, 0.45], [0.0, 1 / 3, 0.45]
    tid = np.ones(L, np.int32)
    want = np.asarray(JT.wireframe_color(ja, jnp.asarray(tid),
                                         jnp.asarray(tri), jnp.asarray(bu),
                                         jnp.asarray(bv)))
    got = TX.wireframe_color(ta, torch.from_numpy(tid),
                             torch.from_numpy(tri), torch.from_numpy(bu),
                             torch.from_numpy(bv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[0, 0] > 0.9 and got[0, 1] < 0.1  # on an edge: red
    assert got[1, 1] > 0.9 and got[1, 0] < 0.1  # the centroid: interior
    assert got[2, 0] > 0.5  # near the hypotenuse


@pytest.mark.parametrize("show_k,scale", [(True, 0.1), (False, 0.2)])
def test_curvature_colours_on_a_sphere(show_k, scale):
    from ppg_tpu_torch.scene.scene import curvature_colors
    from ppg_tpu_torch.scene.shapes import make_sphere

    r = 0.5
    mesh = make_sphere(np.zeros(3), r)
    col = curvature_colors(np.asarray(mesh.positions),
                           np.asarray(mesh.faces), show_k=show_k,
                           scale=scale)
    # K = 1 / r^2 = 4 (x 0.1) and H = 1 / r = 2 (x 0.2): red 0.4; the
    # poles' angle defect degenerates
    interior = col[np.abs(np.asarray(mesh.positions)[:, 1]) < 0.9 * r]
    assert abs(np.median(interior[:, 0]) - 0.4) < 0.08
    assert np.median(interior[:, 2]) < 0.02


# ppg_tpu's test_textures.py and test_ewa.py on the port's lookups

@pytest.fixture(scope="module")
def mip_atlas(tex_dir):
    img = np.zeros((64, 64, 3), np.float32)
    img[::2, ::2] = 1.0
    img[1::2, 1::2] = 1.0
    exr.write(os.path.join(tex_dir, "checker64.exr"), img)
    return TX.TextureAtlas.build(
        [dict(_otype="bitmap", filename="checker64.exr")], tex_dir, "cpu")


def test_mip_chain_halves(mip_atlas):
    mm = mip_atlas.mip_meta.numpy().reshape(-1, 13, 3)
    assert tuple(mm[1, 0, 1:]) == (64, 64)
    assert tuple(mm[1, 1, 1:]) == (32, 32)
    assert tuple(mm[1, 6, 1:]) == (1, 1)
    assert tuple(mm[1, 12, 1:]) == (1, 1)  # repeats the top


def test_minified_lookup_averages(mip_atlas):
    tid = torch.ones(4, dtype=torch.int32)
    uv = torch.tensor([[0.1, 0.1], [0.4, 0.7], [0.9, 0.2], [0.5, 0.5]])
    v = TX.sample_atlas(mip_atlas, tid, uv, torch.full((4, 2), 1.0))
    np.testing.assert_allclose(v.numpy(), 0.5, atol=0.05)
    v0 = TX.sample_atlas(mip_atlas, tid, uv, torch.full((4, 2), 1e-8))
    np.testing.assert_allclose(v0.numpy(), TX.sample_atlas(
        mip_atlas, tid, uv).numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def stripes(tex_dir):
    img = np.zeros((64, 64, 3), np.float32)
    img[(np.arange(64) // 4) % 2 == 0, :, :] = 1.0
    exr.write(os.path.join(tex_dir, "stripes.exr"), img)
    atlas = TX.TextureAtlas.build(
        [dict(_otype="bitmap", filename="stripes.exr"),
         dict(_otype="bitmap", filename="stripes.exr",
              filterType="trilinear"),
         dict(_otype="bitmap", filename="stripes.exr",
              filterType="nearest")], tex_dir, "cpu")
    return atlas, img


def _one(atlas, slot, uv, **kw):
    return TX.sample_atlas(atlas, torch.tensor([slot] * len(uv),
                                               dtype=torch.int32),
                           torch.tensor(uv, dtype=torch.float32),
                           **kw).numpy()


def test_ewa_filter_codes_and_modes(stripes):
    atlas, img = stripes
    f = atlas.filt.numpy()
    assert f[1, 0] == TX.F_EWA and f[2, 0] == TX.F_TRILINEAR
    assert f[3, 0] == TX.F_NEAREST and f[1, 1] == 20.0
    # an isotropic Jacobian is the trilinear footprint lookup
    r = 4.0 / 64.0
    uv = [[0.3, 0.4], [0.77, 0.21]]
    a = _one(atlas, 2, uv, duv=(torch.tensor([[r, 0.0]] * 2),
                                torch.tensor([[0.0, r]] * 2)))
    b = _one(atlas, 2, uv, foot_uv=torch.tensor([[r, r]] * 2))
    np.testing.assert_allclose(a, b, atol=1e-3)
    # a footprint long along u over stripes along v: EWA keeps the point
    # value, trilinear (at the major axis's level) blurs to the mean
    uv = [[0.5, 4.0 / 64.0 + 0.002]]
    duv = (torch.tensor([[16.0 / 64.0, 0.0]]),
           torch.tensor([[0.0, 0.5 / 64.0]]))
    point = _one(atlas, 1, uv)[0, 0]
    e = _one(atlas, 1, uv, duv=duv)[0, 0]
    t = _one(atlas, 2, uv, duv=duv)[0, 0]
    assert abs(e - point) < 0.25 and abs(t - 0.5) < 0.2
    assert abs(e - point) < abs(t - point) - 0.1
    # the anisotropy clamp keeps an extreme footprint finite and bounded
    v = _one(atlas, 1, [[0.5, 0.5]], duv=(torch.tensor([[0.9, 0.0]]),
                                          torch.tensor([[0.0, 1e-6]])))
    assert np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all()
    # nearest returns the texel whatever the sub-texel position
    z = torch.zeros((1, 2))
    v = _one(atlas, 3, [[10.3 / 64.0, 6.7 / 64.0]], duv=(z, z))
    np.testing.assert_allclose(v[0], img[6, 10], atol=2e-3)


def test_perspective_dir_differentials_numeric():
    from ppg_tpu_torch.render.sensor import PerspectiveSensor

    sensor = PerspectiveSensor(dict(xfov=45.0, to_world=np.eye(4)),
                               dict(width=128, height=96), "cpu")
    pos = torch.tensor([[40.0, 30.0], [90.0, 70.0], [5.0, 88.0]])
    _, d, *_ = sensor.sample_rays(pos)
    ddx, ddy = sensor.dir_differentials(d)
    for axis, dd in ((0, ddx), (1, ddy)):
        step = torch.zeros((1, 2))
        step[0, axis] = 1.0
        _, d2, *_ = sensor.sample_rays(pos + step)
        np.testing.assert_allclose(dd.numpy(), (d2 - d).numpy(), atol=2e-3)


# K9 under the shim

@pytest.fixture(scope="module")
def host_k9(tmp_path_factory):
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    from ppg_tpu_torch.native import CSRC

    lib = cuda_shim.build_host(os.path.join(CSRC, "textures.cu"),
                               str(tmp_path_factory.mktemp("k9_host")),
                               "k9_host", launches=1)
    lib.ppg_atlas_sample.argtypes = TX.ARGTYPES
    lib.ppg_atlas_sample.restype = ctypes.c_int

    def k9(atlas, tex_id, uv, foot_uv=None, duv=None, bump=False):
        args, n, _ = TX.kernel_args(atlas, tex_id, uv, foot_uv, duv, bump)
        out = torch.full((n, 3), 7.0)
        assert lib.ppg_atlas_sample(*args, out.data_ptr(), n, 0, None) == 0
        return out

    return k9


def _as_the_kernel(monkeypatch):
    """log2, hypot and sqrt as the kernel computes them under the shim:
    the C library's log2f and hypotf, sqrt correctly rounded (PyTorch's
    CPU sqrt is not, always)."""
    libm = ctypes.CDLL("libm.so.6")
    for name, k in (("log2f", 1), ("hypotf", 2)):
        f = getattr(libm, name)
        f.argtypes = [ctypes.c_float] * k
        f.restype = ctypes.c_float

    def each(f):
        return lambda *xs: torch.tensor(
            [f(*v) for v in zip(*(x.reshape(-1).tolist() for x in xs))],
            dtype=torch.float32).reshape(xs[0].shape)

    monkeypatch.setattr(torch, "log2", each(libm.log2f))
    monkeypatch.setattr(torch, "hypot", each(libm.hypotf))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))


def _same(a, b):
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).any(-1).sum())


@pytest.mark.parametrize("mode", ["base", "foot", "duv", "bump"])
def test_k9_source_on_the_cpu_equals_plain(host_k9, atlases, mode,
                                           monkeypatch):
    ta = atlases[1]
    lanes = {k: torch.from_numpy(v) for k, v in
             texture_cases.lanes(ta.n_slots, 3000, seed=11).items()}
    _as_the_kernel(monkeypatch)
    kw = dict(foot=dict(foot_uv=lanes["foot"]),
              duv=dict(duv=(lanes["d0"], lanes["d1"]))).get(mode, {})
    bump = mode == "bump"
    got = host_k9(ta, lanes["tex_id"], lanes["uv"], bump=bump, **kw)
    want = TX.sample_atlas_plain(ta, lanes["tex_id"], lanes["uv"],
                                 bump=bump, **kw)
    assert got.shape == want.shape
    _same(got, want)


def test_k9_stacked_strided_call_on_the_cpu(host_k9, atlases, monkeypatch):
    ta = atlases[1]
    M = 1000
    lanes = {k: torch.from_numpy(v) for k, v in
             texture_cases.lanes(ta.n_slots, M, seed=12).items()}
    rng = np.random.default_rng(13)
    table = torch.from_numpy(rng.integers(-1, ta.n_slots, (3 * M, 5)).astype(
        np.int32))
    uv4 = torch.zeros((M, 4))
    uv4[:, 1:3] = lanes["uv"]
    _as_the_kernel(monkeypatch)
    duv = (lanes["d0"], lanes["d1"])
    got = host_k9(ta, table[:, 3], uv4[:, 1:3], duv=duv)
    want = TX.sample_atlas_plain(ta, table[:, 3].contiguous(), lanes["uv"],
                                 duv=duv)
    _same(got, want)
    with pytest.raises(ValueError):
        TX.kernel_args(ta, table[:1001, 3], lanes["uv"])  # N % M != 0
    assert jax.config.jax_enable_x64 is False

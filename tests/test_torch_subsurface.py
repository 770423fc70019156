"""The port's dipole (ppg_tpu_torch/subsurface.py) against ppg_tpu's, and
K12 (csrc/subsurface.cu) compiled for the CPU under tools/cuda_shim.py
against its plain version.

- dipole_params, the white-noise sampler (_white_noise_on_tris,
  sample_surface_points) and blue_noise_points equal ppg_tpu's bit for
  bit from the same np.random.default_rng seed.
- lo_sub_plain against ppg_tpu.subsurface.lo_sub on every
  tools/subsurface_cases.py case within 1e-4 relative (a float32 sum of a
  few hundred to 2,560 positive terms, XLA's tree order on one side and
  point order on the other, with XLA's and ATen's exp and sqrt; measured
  below 1e-6), with the non-finite values in the same places.
- ppg_tpu's closed-form one-point test (tests/test_subsurface.py) on the
  port, through lo_sub on CPU tensors.
- build_subsurface on tests/test_subsurface.py's sphere: the points,
  areas, pt_ss and tri_ss equal ppg_tpu's exactly, and E equals ppg_tpu's
  pi to float rounding (under the constant environment of radiance 1
  every cosine ray from the convex sphere escapes, so E = pi exactly in
  expectation and in every sample); on the sphere above a diffuse floor,
  where E varies, the mean E of each quarter of the points by height
  within 4 standard errors of ppg_tpu's (the random streams differ:
  threefry against the CPU generator).
- K12 under the shim bit for bit with lo_sub_plain on every case, the
  plain version's exp patched to the C library's expf and its sqrt to a
  correctly rounded one (numpy's), as the shim's kernel calls them
  (without the patch some values differ in their last bits: PyTorch's
  CPU exp and sqrt are not the C library's); strided lane inputs; the
  wrapper's refusals; owner_tiles' refusals.
- The tables SubsurfArrays builds for K12 against the values the plain
  version reads: the point rows (positions and owners), the rows of
  E * area (the plain version's product, bit for bit) and each tile's
  one owner.
- K12's derived square root and reciprocals against the IEEE operations
  under the shim's rsqrt.approx (the correctly rounded 1 / sqrt(x)): on
  every float of [1, 4) (x and 4x give the same significands, so that is
  every float of the guarded range) and at both ends of every binade of
  the guarded range, and its Markstein quotient on 2^20 drawn pairs.
"""

import ctypes
import os
import subprocess
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu import subsurface as JS
from ppg_tpu.bsdf.fresnel import fresnel_dielectric_ext as j_fresnel
from ppg_tpu.integrators import driver as JD
from ppg_tpu.integrators.wavefront import DeviceScene as JDeviceScene
from ppg_tpu.scene.testscenes import scene_from_xml as j_scene_from_xml
from ppg_tpu_torch import subsurface as TS
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.wavefront import DeviceScene
from ppg_tpu_torch.scene.testscenes import scene_from_xml
from ppg_tpu_torch.tools import cuda_shim
from ppg_tpu_torch.tools import subsurface_cases as SC

CASES = list(SC.CASES)
LANES = ("ss_id", "p", "cos_o")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(c, cls, asarray):
    return cls(*(asarray(c[k]) for k in ("params", "pts", "E", "area",
                                         "pt_ss")),
               asarray(np.full(1, -1, np.int32)), num=len(c["params"]))


def _port(c):
    return _cloud(c, TS.SubsurfArrays, torch.from_numpy)


def _lanes(c):
    return tuple(torch.from_numpy(c[k]) for k in LANES)


def _same_bits(a, b):
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                           & b.isnan())
    assert bool(same.all()), int((~same).sum())


# ---------------------------------------------------------------------------
# the host part
# ---------------------------------------------------------------------------

_DIPOLE_XML = """<scene version="0.5.0">
<integrator type="path"><integer name="maxDepth" value="3"/></integrator>
<sensor type="perspective"><float name="fov" value="45"/>
 <transform name="toWorld"><lookAt origin="0,0,-4" target="0,0,0" up="0,1,0"/></transform>
 <sampler type="independent"/><film type="hdrfilm">
 <integer name="width" value="16"/><integer name="height" value="16"/>
 <rfilter type="box"/></film></sensor>
<shape type="sphere"><float name="radius" value="1"/>
 <subsurface type="dipole">
   <rgb name="sigmaS" value="2, 2.5, 3"/>
   <rgb name="sigmaA" value="0.01, 0.02, 0.04"/>
   <integer name="irrSamples" value="8"/>
 </subsurface>
 <bsdf type="plastic"><rgb name="diffuseReflectance" value="0,0,0"/></bsdf>
</shape>
{extra}<emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
</scene>"""
_FLOOR = """<shape type="rectangle"><transform name="toWorld">
  <scale value="3"/><rotate x="1" angle="-90"/><translate y="-1.2"/>
 </transform><bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf></shape>
"""


@pytest.mark.parametrize("row", [
    dict(sigma_s=[2.0, 2.5, 3.0], sigma_a=[0.01, 0.02, 0.04], g=0.0,
         eta=1.3),
    dict(SC.MARBLE),
    dict(SC.MARBLE, g=0.4, eta=1.0),
    dict(sigma_s=[0.0, 1.0, 2.0], sigma_a=[0.5, 0.0, 0.1], g=-0.2,
         eta=1.5)], ids=["test row", "marble", "eta 1", "zeros"])
def test_dipole_params_equal_ppg_tpu(row):
    np.testing.assert_array_equal(TS.dipole_params(row),
                                  JS.dipole_params(row))


def test_point_samplers_equal_ppg_tpu():
    """The white-noise sampler and the blue-noise set, bit for bit from
    one seed, on the sphere's 16,128 triangles and on a unit quad."""
    sc = scene_from_xml(_DIPOLE_XML.format(extra=""))
    quad = (np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                     np.float64), np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    for pos, faces in ((sc.positions, sc.faces), quad):
        tris = np.arange(len(faces))
        for seed in (3, 4):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            a = TS._white_noise_on_tris(pos, faces, tris, 500, r1)
            b = JS._white_noise_on_tris(pos, faces, tris, 500, r2)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]
            a = TS.sample_surface_points(pos, faces, tris, 300, r1)
            b = JS.sample_surface_points(pos, faces, tris, 300, r2)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            for radius in (0.05, 0.12):
                a = TS.blue_noise_points(pos, faces, tris, radius, r1)
                b = JS.blue_noise_points(pos, faces, tris, radius, r2)
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
                assert a[2] == b[2] and len(a[0]) > 10


def _build_both(xml):
    sc_t = scene_from_xml(xml)
    scene = TD.ensure_subsurface(sc_t, DeviceScene.from_scene(sc_t, "cpu"))
    sc_j = j_scene_from_xml(xml)
    dev_j = JD.ensure_subsurface(sc_j, JDeviceScene.from_scene(sc_j))
    return scene.subsurf, dev_j.subsurf


def test_build_subsurface_equals_ppg_tpu_under_the_sky():
    ss, js = _build_both(_DIPOLE_XML.format(extra=""))
    assert ss.num == js.num == 1
    for f in ("params", "pts", "area", "pt_ss", "tri_ss"):
        a, b = getattr(ss, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ss.pts.shape[0] % TS.PT_BLOCK == 0
    assert TS.tile_aligned(ss.pt_ss.numpy())
    assert ss.tiles.tolist() == [[0, ss.pts.shape[0] // TS.PT_BLOCK]]
    # every cosine ray escapes to the sky of radiance 1: E = pi
    np.testing.assert_allclose(ss.E.numpy(), np.pi, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(js.E), np.pi, rtol=1e-6)


def test_build_subsurface_irradiance_agrees_above_a_floor():
    ss, js = _build_both(_DIPOLE_XML.format(extra=_FLOOR))
    np.testing.assert_array_equal(ss.pts.numpy(), np.asarray(js.pts))
    np.testing.assert_array_equal(ss.tri_ss.numpy(), np.asarray(js.tri_ss))
    y = ss.pts.numpy()[:, 1]
    Et, Ej = ss.E.numpy().mean(-1), np.asarray(js.E).mean(-1)
    assert Et.min() < 0.8 * np.pi  # the floor shades the lower half
    edges = np.quantile(y, [0.0, 0.25, 0.5, 0.75, 1.0])
    for lo, hi in zip(edges[:-1], edges[1:]):
        k = (y >= lo) & (y <= hi)
        se = np.sqrt(Et[k].var() / k.sum() + Ej[k].var() / k.sum())
        assert abs(Et[k].mean() - Ej[k].mean()) < 4 * se + 1e-6, (
            lo, Et[k].mean(), Ej[k].mean(), se)


# ---------------------------------------------------------------------------
# the exitance sum against ppg_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_plain_exitance_matches_ppg_tpu(case):
    c = SC.case(case)
    got = TS.lo_sub_plain(_port(c), *_lanes(c)).numpy()
    js = _cloud(c, JS.SubsurfArrays, jnp.asarray)
    want = np.asarray(JS.lo_sub(js, *(jnp.asarray(c[k]) for k in LANES)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=0)
    gated = (c["ss_id"] >= 0) & (c["cos_o"] > 0)
    assert (got[~gated] == 0).all() and (got[gated] != 0).any(-1).all()


def test_closed_form_one_point():
    """tests/test_subsurface.py's dipole formula on one sample point, and
    0 facing away, on the port."""
    row = dict(sigma_s=[2.0, 2.5, 3.0], sigma_a=[0.01, 0.02, 0.04], g=0.0,
               eta=1.3)
    prm = TS.dipole_params(row)
    P = TS.PT_BLOCK
    pts = np.zeros((P, 3), np.float32)
    E = np.zeros((P, 3), np.float32)
    E[0] = 1.0
    area = np.zeros(P, np.float32)
    area[0] = 1.0
    pt_ss = np.full(P, -1, np.int32)
    pt_ss[0] = 0
    ss = TS.SubsurfArrays(*(torch.from_numpy(a) for a in (
        prm[None], pts, E, area, pt_ss, np.zeros(1, np.int32))), num=1)
    r = 0.3
    p = torch.tensor([[r, 0.0, 0.0]])
    sid = torch.zeros(1, dtype=torch.int32)
    out = TS.lo_sub(ss, sid, p, torch.ones(1)).numpy()[0]
    zr, zv, st = prm[0:3], prm[3:6], prm[6:9]
    dr = np.sqrt(r * r + zr ** 2)
    dv = np.sqrt(r * r + zv ** 2)
    dmo = (1 / (4 * np.pi)) * (
        zr * (st + 1 / dr) * np.exp(-st * dr) / dr ** 2
        + zv * (st + 1 / dv) * np.exp(-st * dv) / dv ** 2)
    want = dmo / np.pi * (1 - float(np.asarray(
        j_fresnel(jnp.asarray([1.0]), jnp.asarray([1.3]))[0])[0]))
    np.testing.assert_allclose(out, want, rtol=1e-4)
    back = TS.lo_sub(ss, sid, p, -torch.ones(1)).numpy()[0]
    np.testing.assert_array_equal(back, 0.0)


# ---------------------------------------------------------------------------
# K12 under the shim
# ---------------------------------------------------------------------------

_VEXPF = r"""
#include <math.h>
extern "C" void vexpf(const float* x, float* y, long n) {
    for (long i = 0; i < n; ++i) y[i] = expf(x[i]);
}
"""


@pytest.fixture(scope="module")
def host_k12(tmp_path_factory):
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    from ppg_tpu_torch.native import CSRC

    out = tmp_path_factory.mktemp("k12_host")
    lib = cuda_shim.build_host(os.path.join(CSRC, "subsurface.cu"),
                               str(out), "k12_host", launches=2)
    for name, argtypes in (("ppg_dipole_lo", TS.ARGTYPES),
                           ("ppg_dipole_grid", TS.GRID_ARGTYPES),
                           ("ppg_dipole_check", TS.CHECK_ARGTYPES)):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    # the C library's expf over a tensor, as the shim's kernel calls it
    src = out / "vexpf.cpp"
    src.write_text(_VEXPF)
    so = str(out / "libvexpf.so")
    subprocess.run([cuda_shim.host_compiler(), "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", so, str(src)], check=True)
    vexp = ctypes.CDLL(so).vexpf
    vexp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]

    def expf(x):
        x = x.contiguous()
        y = torch.empty_like(x)
        vexp(x.data_ptr(), y.data_ptr(), x.numel())
        return y

    def k12(ss, ss_id, p, cos_o):
        args = TS.kernel_args(ss, ss_id, p, cos_o)
        L = p.shape[0]
        out = torch.full((L, 3), 7.0)
        ws = TS.workspace_args(lib, p.device, L)
        assert lib.ppg_dipole_lo(*args, *ws, out.data_ptr(), L, 0,
                                 None) == 0
        return out

    k12.lib = lib
    return k12, expf


def _as_the_kernel(monkeypatch, expf):
    """The plain version's exp and sqrt as the shim's kernel calls them:
    the C library's expf, a correctly rounded sqrt."""
    monkeypatch.setattr(torch, "exp", expf)
    monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(
        np.sqrt(x.contiguous().numpy())))


@pytest.mark.parametrize("case", CASES)
def test_k12_on_the_cpu_equals_plain(host_k12, monkeypatch, case):
    k12, expf = host_k12
    c = SC.case(case)
    ss = _port(c)
    got = k12(ss, *_lanes(c))
    _as_the_kernel(monkeypatch, expf)
    _same_bits(got, TS.lo_sub_plain(ss, *_lanes(c)))


def test_k12_reads_strided_lanes(host_k12, monkeypatch):
    """ss_id, p and cos_o as views with strides other than their
    contiguous ones; the out-of-range owner clamps its params row."""
    k12, expf = host_k12
    c = SC.case("several owners")
    ss = _port(c)
    sid, p, co = _lanes(c)
    sid2 = torch.stack([sid, torch.full_like(sid, 9)], 1)[:, 0]
    p2 = p.t().contiguous().t()
    co2 = torch.stack([torch.full_like(co, -1.0), co], 1)[:, 1]
    assert sid2.stride(0) == 2 and p2.stride() == (1, p.shape[0]) \
        and co2.stride(0) == 2
    got = k12(ss, sid2, p2, co2)
    _as_the_kernel(monkeypatch, expf)
    _same_bits(got, TS.lo_sub_plain(ss, sid, p, co))
    # an owner past the params' rows takes the last row and no point
    big = torch.full_like(sid, 7)
    _same_bits(k12(ss, big, p, co), TS.lo_sub_plain(ss, big, p, co))
    assert bool((TS.lo_sub_plain(ss, big, p, co) == 0).all())


def test_wrapper_and_cloud_refusals():
    c = SC.case("one tile")
    ss = _port(c)
    sid, p, co = _lanes(c)
    for bad in ((ss, sid.long(), p, co), (ss, sid, p.double(), co),
                (ss, sid, p[:, :2], co), (ss, sid, p, co[:-1])):
        with pytest.raises(ValueError, match="ppg_dipole_lo"):
            TS.kernel_args(*bad)
    ss.pts = torch.zeros((TS.PT_BLOCK + 1, 3))
    with pytest.raises(ValueError, match="ppg_dipole_lo"):
        TS.kernel_args(ss, sid, p, co)
    with pytest.raises(ValueError, match="multiple"):
        TS.owner_tiles(np.zeros(100, np.int32), 1)
    with pytest.raises(ValueError, match="owned by"):
        TS.owner_tiles(np.full(256, 2, np.int32), 2)
    tiles = TS.owner_tiles(np.r_[np.full(256, -1), np.zeros(300),
                                 np.full(212, 1)].astype(np.int32), 3)
    assert tiles.tolist() == [[1, 3], [2, 3], [0, 0]]
    assert not TS.tile_aligned(np.r_[np.zeros(300), np.ones(212)])
    assert TS.tile_aligned(np.r_[np.full(256, -1), np.zeros(512)])


@pytest.mark.parametrize("case", CASES)
def test_k12_tables_hold_the_plain_values(case):
    c = SC.case(case)
    ss = _port(c)
    P = c["pts"].shape[0]
    assert ss.pt_row.shape == (P, 4) and ss.ea_row.shape == (P, 4)
    _same_bits(ss.pt_row[:, :3], torch.from_numpy(c["pts"]))
    assert torch.equal(ss.pt_row[:, 3].view(torch.int32),
                       torch.from_numpy(c["pt_ss"]))
    eb = ss.E * ss.area[:, None]  # the plain version's E * A
    _same_bits(ss.ea_row[:, :3], eb)
    assert bool((ss.ea_row[:, 3] == 0).all())
    owners = c["pt_ss"].reshape(-1, TS.PT_BLOCK)
    for b, o in enumerate(ss.tile_owner.tolist()):
        if o == TS.MIXED:
            assert len(np.unique(owners[b])) > 1
        else:
            assert (owners[b] == o).all()


def test_tile_owners():
    pt_ss = np.r_[np.full(256, -1), np.zeros(300), np.full(212, 1)]
    assert TS.tile_owners(pt_ss).tolist() == [-1, 0, TS.MIXED]
    assert TS.tile_owners(np.full(512, 2)).tolist() == [2, 2]


def _bits(x):
    return int(np.float32(x).view(np.int32))


@pytest.mark.parametrize("chunks", ["every float of [1, 4)",
                                    "both ends of every binade"])
def test_k12_derived_operations_equal_ieee(host_k12, chunks):
    """csrc/subsurface.cu's ppg_dipole_check under the shim: the derived
    square root and both reciprocals equal sqrtf, 1.0f / dr and
    1.0f / dd wherever the guard lets them through, and the guard takes
    out only the floats near a power of two; the Markstein quotient
    equals the IEEE division on 2^20 drawn pairs."""
    lib, cpu = host_k12[0].lib, torch.device("cpu")
    lo, hi = TS.X_RANGE_BITS
    assert (lo, hi) == (_bits(2.0 ** -40), _bits(2.0 ** 40))
    if chunks == "every float of [1, 4)":
        r = TS.check_derived(lib, cpu, _bits(1.0), _bits(4.0), 1 << 20,
                             seed=5)
        assert r["values"] == 1 << 24
        assert r["quotients"] == 1 << 20 and r["quotients_differ"] == 0
        assert r["quotients_guarded_out"] < 16
    else:
        # the first and the last 2^15 floats of every binade
        r = sum((Counter(TS.check_derived(lib, cpu, k, k + (1 << 15), 0))
                 for b in range(lo, hi, 1 << 23)
                 for k in (b, b + (1 << 23) - (1 << 15))), Counter())
        assert r["values"] == 160 << 15
    assert r["sqrt_differ"] == 0, r
    assert r["rcp_dr_differ"] == 0 and r["rcp_dd_differ"] == 0, r
    # x within 4 ulps below or 3 above a power of two: 8 floats a binade
    binades = 2 if chunks == "every float of [1, 4)" else 80
    assert r["guarded_out"] == 8 * binades, r

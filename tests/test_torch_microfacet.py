"""The port's microfacet distributions (ppg_tpu_torch/bsdf/microfacet.py)
against ppg_tpu's on the same numpy inputs, and K8's source
(ppg_tpu_torch/csrc/microfacet.cu) compiled for the CPU against
tools/cuda_shim.py and held against sample_visible_plain.

Against ppg_tpu: the closed forms (D, G1, Smith's G, the visible pdf, the
full distribution's pdf) differ only by XLA's and ATen's float32 exp,
sqrt, sin, cos and log, each within a few ulp: rtol 2e-5 (largest seen
4e-6) and atol 1e-6 of the largest value of the function over the
lanes. The full distribution's sample adds sin_t = sqrt(1 - cos_t^2),
which turns a 1-ulp cos_t into up to 6e-8 / sin_t: m within
SAMPLE_ALL_ATOL = 2e-5 (largest seen 4.3e-6). The visible normals: GGX's
closed form goes through sin, cos, tan, acos and atan2; Beckmann's
rounds through erf, exp, pow and erfinv, and XLA's erfinv is another
approximation than ATen's calc_erfinv, which the Newton rounds carry on.
On the Beckmann lanes a BSDF keeps (wi above the surface: roughconductor
and roughplastic need cos > 0, roughdielectric turns wi up; and u1 < 1,
as the tracer's uniforms in [0, 1) are) m is within SAMPLE_ATOL = 2e-5
(largest seen 3.4e-6). On the others (wi on or below the surface, u1 =
1, where the rounds run into erfinv's edge at +-0.9999999 and the two
erfinvs part by up to 5e-3) only which lanes are finite must agree.
GGX's visible normals are not ppg_tpu's: ppg_tpu builds Heitz's disk
basis with T1 in the plane of incidence and squeezes the disk along y,
so at oblique incidence about 1% of its normals land beyond the horizon
(m_z = 1e-8, the clamp) and the others do not follow the visible-normal
density; the port takes Heitz's basis (T1 horizontal, the squeeze along
T2 in the plane of incidence). So GGX sampling is held to its density
instead: the visible normals of each case in VNDF_CASES (GGX and
Beckmann, isotropic and anisotropic, wi at the normal, oblique and near
grazing) against pdf_visible (equal to ppg_tpu's, above) by
tests/chi2util.py's chi-square test at significance 0.01, Sidak over
the cases, 200,000 samples each; and ppg_tpu's beyond-the-horizon
normals are counted.

K8 under the shim: the kernel calls the C library's sinf, cosf, tanf,
acosf, atan2f, erff, expf, powf, logf and sqrtf and the shim's erfinvf
(ATen's calc_erfinv); PyTorch's CPU functions are its own vectorised
ones, which differ from those in the last bit on some values. So K8 is
held bit for bit against the plain version with those functions computed
as the kernel computes them (each element through the C library by
ctypes, sqrt correctly rounded, erfinv the shim's), which holds every
other operation and its order, on every lane; and within LIBM_ATOL = 2e-5
of the unchanged plain version on the kept lanes. On a card ATen's functions
are the CUDA math library's, which K8 calls, and
test_torch_microfacet_gpu.py holds the two bit for bit. The lanes are
tools/vndf_cases.py's: GGX and Beckmann, isotropic and anisotropic
roughness from 1e-3 to 1, wi over both hemispheres, at the normal,
within 1e-4 of it and grazing, and uniforms at 0 and 1; ungated, and
gated by the lanes' families (the edge lanes all gated in), also on
tiles of the kernel's BLOCK lanes all gated out, all GGX or all
Beckmann, in orders that carry a block's queues across tiles.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.bsdf import microfacet as JM
from ppg_tpu_torch.bsdf import microfacet as MF
from ppg_tpu_torch.tools import cuda_shim, vndf_cases

RTOL, ATOL = 2e-5, 1e-6
SAMPLE_ALL_ATOL = 2e-5
SAMPLE_ATOL = 2e-5
LIBM_ATOL = 2e-5
L = 4000


@pytest.fixture(scope="module")
def lanes():
    c = vndf_cases.inputs(np.random.default_rng(11), L)
    rng = np.random.default_rng(12)
    m = rng.normal(size=(L, 3))
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    m[:, 2] = np.abs(m[:, 2]) * np.where(rng.random(L) < 0.9, 1.0, -1.0)
    c["m"] = m.astype(np.float32)
    wo = rng.normal(size=(L, 3))
    c["wo"] = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(
        np.float32)
    c["visible"] = rng.random(L) < 0.5
    return c


def _kept(c):
    """The lanes a BSDF keeps: wi above the surface, u1 < 1."""
    return (c["wi"][:, 2] > 0) & (c["u"][:, 0] < 1.0)


def _both(c, names):
    j = [jnp.asarray(c[n]) for n in names]
    t = [torch.from_numpy(np.asarray(c[n])) for n in names]
    return j, t


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=atol * scale)


CLOSED = {
    "eval_d": ("dist", "alpha_u", "alpha_v", "m"),
    "smith_g1": ("dist", "alpha_u", "alpha_v", "wi", "m"),
    "g_smith": ("dist", "alpha_u", "alpha_v", "wi", "wo", "m"),
    "pdf_visible": ("dist", "alpha_u", "alpha_v", "wi", "m"),
    "pdf_all": ("dist", "alpha_u", "alpha_v", "m"),
    "pdf_m": ("dist", "alpha_u", "alpha_v", "wi", "m", "visible"),
    "_project_roughness": ("alpha_u", "alpha_v", "wi"),
}


@pytest.mark.parametrize("name", sorted(CLOSED))
def test_closed_forms_match_ppg_tpu(lanes, name):
    j, t = _both(lanes, CLOSED[name])
    _close(getattr(MF, name)(*t), getattr(JM, name)(*j))


def test_sample_all_matches_ppg_tpu(lanes):
    c = dict(lanes, u2=lanes["u"][:, :2])
    j, t = _both(c, ("dist", "alpha_u", "alpha_v", "u2"))
    got, want = MF.sample_all(*t), JM.sample_all(*j)
    _close(got[0], want[0], atol=SAMPLE_ALL_ATOL)
    _close(got[1], want[1])


@pytest.mark.parametrize("what", ["sample_visible", "sample_m"])
def test_visible_normals_match_ppg_tpu(lanes, what):
    """Beckmann's visible normals (and sample_m's full-distribution
    lanes) against ppg_tpu's; GGX's follow their density instead
    (test_visible_normals_follow_their_pdf)."""
    c = dict(lanes, u2=lanes["u"][:, :2])
    names = ["dist", "alpha_u", "alpha_v", "wi", "u2"]
    if what == "sample_m":
        names.append("visible")
    j, t = _both(c, names)
    got = getattr(MF, what)(*t).numpy()
    want = np.asarray(getattr(JM, what)(*j))
    held = lanes["dist"] == vndf_cases.BECKMANN
    if what == "sample_m":
        held = held | ~lanes["visible"]
    np.testing.assert_array_equal(np.isfinite(got[held]),
                                  np.isfinite(want[held]))
    keep = _kept(lanes) & held
    assert np.isfinite(want[keep]).all() and keep.sum() > L // 5
    assert np.abs(got[keep] - want[keep]).max() <= SAMPLE_ATOL


# (dist, alpha_u, alpha_v, wi) of the visible-normal density tests
VNDF_CASES = [
    (vndf_cases.GGX, 0.3, 0.3, (0.0, 0.0, 1.0)),
    (vndf_cases.GGX, 0.3, 0.3, (0.6, 0.0, 0.8)),
    (vndf_cases.GGX, 0.5, 0.5, (0.9, 0.0, 0.43589)),
    (vndf_cases.GGX, 0.2, 0.6, (0.3, -0.6, 0.7416)),
    (vndf_cases.BECKMANN, 0.3, 0.3, (0.6, 0.0, 0.8)),
    (vndf_cases.BECKMANN, 0.2, 0.6, (0.3, -0.6, 0.7416)),
]


@pytest.mark.parametrize("case", range(len(VNDF_CASES)))
def test_visible_normals_follow_their_pdf(case):
    from chi2util import run_sphere_chi2

    dist, au, av, wi = VNDF_CASES[case]
    n = 200_000
    full = lambda v, dt=torch.float32: torch.full((n,), v, dtype=dt)
    w = torch.tensor(wi, dtype=torch.float32)
    w = (w / torch.linalg.vector_norm(w)).expand(n, 3).contiguous()
    u = torch.from_numpy(
        np.random.default_rng(case).random((n, 2)).astype(np.float32))
    m = MF.sample_visible(full(dist, torch.int32), full(au), full(av), w, u)

    def pdf_fn(dirs):
        k = len(dirs)
        return MF.pdf_visible(
            torch.full((k,), dist, dtype=torch.int32),
            torch.full((k,), au), torch.full((k,), av),
            w[:1].expand(k, 3), torch.from_numpy(
                np.asarray(dirs, np.float32))).numpy()

    ok, stats = run_sphere_chi2(m.numpy(), pdf_fn,
                                np.random.default_rng(100 + case),
                                significance=0.01,
                                n_tests=len(VNDF_CASES))
    assert ok, stats
    assert float(m[:, 2].min()) > 1e-6  # none beyond the horizon


def test_ppg_tpu_ggx_normals_cross_the_horizon():
    """The fault the port's GGX basis repairs: at wi = (0.6, 0, 0.8) and
    alpha 0.3 about 1% of ppg_tpu's visible normals sit at the clamp,
    m_z ~ 1e-8 (horizontal), none of the port's."""
    n = 100_000
    u = np.random.default_rng(5).random((n, 2)).astype(np.float32)
    args = [np.full(n, vndf_cases.GGX, np.int32),
            np.full(n, 0.3, np.float32), np.full(n, 0.3, np.float32),
            np.tile(np.float32([0.6, 0.0, 0.8]), (n, 1)), u]
    want = np.asarray(JM.sample_visible(*(jnp.asarray(a) for a in args)))
    got = MF.sample_visible(*(torch.from_numpy(a) for a in args)).numpy()
    assert (want[:, 2] < 1e-6).mean() > 0.005
    assert (got[:, 2] < 1e-6).sum() == 0


@pytest.fixture(scope="module")
def host_k8(tmp_path_factory):
    """csrc/microfacet.cu built for the CPU (tools/cuda_shim.build_host).
    Returns (k8(dist, alpha_u, alpha_v, wi, u, gate=None) -> m, the
    library)."""
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    from ppg_tpu_torch.native import CSRC

    lib = cuda_shim.build_host(os.path.join(CSRC, "microfacet.cu"),
                               str(tmp_path_factory.mktemp("vndf_host")),
                               "vndf_host", launches=1)
    lib.ppg_vndf_sample.argtypes = MF.ARGTYPES
    lib.ppg_vndf_sample.restype = ctypes.c_int
    lib.shim_erfinvf.argtypes = [ctypes.c_float]
    lib.shim_erfinvf.restype = ctypes.c_float

    def k8(dist, alpha_u, alpha_v, wi, u, gate=None):
        n = wi.shape[0]
        mt, fams = gate if gate is not None else (None, 0)
        m = torch.full((n, 3), 7.0)
        assert lib.ppg_vndf_sample(
            wi.data_ptr(), wi.stride(0), wi.stride(1), u.data_ptr(),
            u.stride(0), u.stride(1), alpha_u.data_ptr(), alpha_u.stride(0),
            alpha_v.data_ptr(), alpha_v.stride(0), dist.data_ptr(),
            dist.stride(0), None if mt is None else mt.data_ptr(),
            0 if mt is None else mt.stride(0), fams, m.data_ptr(), n, 0,
            None) == 0
        return m

    return k8, lib


def _as_the_kernel(monkeypatch, lib):
    """The plain version's math functions as K8 computes them under the
    shim: the C library's, sqrt correctly rounded, erfinv the shim's."""
    libm = ctypes.CDLL("libm.so.6")
    one = ("sinf", "cosf", "tanf", "acosf", "erff", "expf", "logf")
    for n in one + ("atan2f", "powf"):
        f = getattr(libm, n)
        f.argtypes = [ctypes.c_float] * (1 if n in one else 2)
        f.restype = ctypes.c_float

    def each(f):
        return lambda *xs: torch.tensor(
            [f(*v) for v in zip(*(x.reshape(-1).tolist() for x in xs))],
            dtype=torch.float32).reshape(xs[0].shape)

    for n in one + ("atan2f", "powf"):
        monkeypatch.setattr(torch, n[:-1], each(getattr(libm, n)))
    monkeypatch.setattr(torch, "erfinv", each(lib.shim_erfinvf))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))


def _k8_args(lanes, strided, gated=False):
    """K8's inputs from vndf_cases lanes: with `strided`, alpha, dist and
    the family as columns of a material row and u as u3[:, :2]; with
    `gated`, the gate (mtype, vndf_cases.FAMS) after them."""
    t = {k: torch.from_numpy(v) for k, v in lanes.items()
         if k in ("dist", "alpha_u", "alpha_v", "wi", "u", "mtype")}
    n = t["wi"].shape[0]
    if strided:
        row = torch.zeros((n, 8))
        row[:, 1], row[:, 5] = t["alpha_u"], t["alpha_v"]
        row.view(torch.int32)[:, 3] = t["dist"]
        row.view(torch.int32)[:, 0] = t["mtype"]
        args = (row.view(torch.int32)[:, 3], row[:, 1], row[:, 5], t["wi"],
                t["u"][:, :2])
        mt = row.view(torch.int32)[:, 0]
    else:
        args = (t["dist"], t["alpha_u"], t["alpha_v"], t["wi"],
                t["u"][:, :2].contiguous())
        mt = t["mtype"]
    return args + ((mt, vndf_cases.FAMS),) if gated else args


def _same(a, b):
    """Equal bit for bit; two NaNs count as equal."""
    nan = torch.isnan(a) & torch.isnan(b)
    bad = (a.view(torch.int32) != b.view(torch.int32)) & ~nan
    assert not bool(bad.any()), int(bad.any(-1).sum())


@pytest.mark.parametrize("strided", [True, False])
def test_vndf_kernel_equals_plain_with_its_libm(host_k8, lanes, strided,
                                                monkeypatch):
    """gate=None: every lane sampled, as before the gate."""
    k8, lib = host_k8
    args = _k8_args(lanes, strided)
    got = k8(*args)
    _as_the_kernel(monkeypatch, lib)
    _same(got, MF.sample_visible_plain(*args))


@pytest.mark.parametrize("strided", [True, False])
def test_gated_vndf_kernel_equals_gated_plain(host_k8, lanes, strided,
                                              monkeypatch):
    k8, lib = host_k8
    args = _k8_args(lanes, strided, gated=True)
    got = k8(*args)
    inside = MF.gate_mask(*args[5])
    assert 0 < int(inside.sum()) < L
    _as_the_kernel(monkeypatch, lib)
    _same(got, MF.sample_visible_plain(*args))


def _tile():
    """K8's tile: a block's lanes (csrc/microfacet.cu's BLOCK)."""
    from ppg_tpu_torch.native import CSRC

    with open(os.path.join(CSRC, "microfacet.cu")) as f:
        return int(re.search(r"constexpr int BLOCK = (\d+);",
                             f.read()).group(1))


# K8's tiles in order, one kind each: every lane gated out ("out"), all
# GGX, all Beckmann, all Beckmann at normal incidence ("normal"), and
# vndf_cases' mix
@pytest.mark.parametrize("order", [
    "out ggx beckmann mixed normal ggx ggx beckmann beckmann beckmann out "
    "mixed ggx mixed beckmann ggx out out mixed ggx",
    "ggx ggx ggx ggx beckmann beckmann beckmann beckmann out mixed"])
@pytest.mark.parametrize("ragged", [0, 37])
def test_gated_kernel_on_tiles_of_one_kind(host_k8, lanes, order, ragged,
                                           monkeypatch):
    """Bit for bit with the gated plain version on tiles that are all
    gated out, all GGX, all Beckmann (rounds or normal incidence) or
    mixed, in orders that fill the block's queues across tiles (the
    shim's 6 blocks take tiles in turn), and on an L that ends inside a
    tile (`ragged` lanes of a last mixed tile)."""
    k8, lib = host_k8
    tile = _tile()
    kinds = order.split() + (["mixed"] if ragged else [])
    n = tile * (len(kinds) - (1 if ragged else 0)) + ragged
    c = {k: np.array(v[:n]) for k, v in vndf_cases.inputs(
        np.random.default_rng(31), max(n, L)).items()}
    rng = np.random.default_rng(32)
    for j, kind in enumerate(kinds):
        sl = slice(j * tile, min((j + 1) * tile, n))
        k = sl.stop - sl.start
        if kind == "out":
            c["mtype"][sl] = rng.choice(vndf_cases.OTHER_FAMILIES, k)
        elif kind != "mixed":
            c["mtype"][sl] = rng.choice(vndf_cases.MF_FAMILIES, k)
            c["dist"][sl] = (vndf_cases.GGX if kind == "ggx"
                             else vndf_cases.BECKMANN)
            if kind == "normal":
                c["wi"][sl] = (0.0, 0.0, 1.0)
        c["u"][sl, 0] = np.minimum(c["u"][sl, 0], 0.999)
    args = _k8_args(c, True, gated=True)
    got = k8(*args)
    _as_the_kernel(monkeypatch, lib)
    _same(got, MF.sample_visible_plain(*args))


def test_gated_plain_samples_only_the_gated_lanes(lanes):
    """The gated plain version: the ungated one's bits on the gated-in
    lanes, (0, 0, 1) exactly on the others."""
    args = _k8_args(lanes, True, gated=True)
    got, full = MF.sample_visible_plain(*args), MF.sample_visible_plain(
        *args[:5])
    inside = MF.gate_mask(*args[5])
    assert inside.tolist() == [
        t in vndf_cases.MF_FAMILIES for t in lanes["mtype"].tolist()]
    _same(got[inside], full[inside])
    assert torch.equal(got[~inside], torch.tensor(
        [0.0, 0.0, 1.0]).expand(int((~inside).sum()), 3))


def test_vndf_kernel_within_libm_tolerance(host_k8, lanes):
    k8, _ = host_k8
    args = _k8_args(lanes, True)
    got, want = k8(*args).numpy(), MF.sample_visible_plain(*args).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = _kept(lanes)
    assert np.abs(got[keep] - want[keep]).max() <= LIBM_ATOL


def test_plain_rounds_are_the_beckmann_samplers(host_k8, lanes,
                                                monkeypatch):
    """The kernel's ROUNDS and the plain version's agree: with one round
    fewer in the plain version some Beckmann lanes differ (most have
    converged by then), the GGX lanes not."""
    k8, lib = host_k8
    args = _k8_args(lanes, False)
    got = k8(*args)
    _as_the_kernel(monkeypatch, lib)
    monkeypatch.setattr(MF, "ROUNDS", MF.ROUNDS - 1)
    want = MF.sample_visible_plain(*args)
    differ = (got.view(torch.int32) != want.view(torch.int32)).any(-1)
    beck = args[0] == vndf_cases.BECKMANN
    assert not bool((differ & ~beck).any())
    assert int((differ & beck).sum()) > L // 40


def test_sample_visible_on_the_cpu_runs_the_plain_version(lanes):
    """CPU tensors take the plain version and count no launch; K8's
    wrapper refuses them rather than fall back."""
    args = _k8_args(lanes, True)
    MF.reset_counts()
    _same(MF.sample_visible(*args), MF.sample_visible_plain(*args))
    assert MF.COUNTS == {"vndf_kernel": 0, "vndf_plain_on_cuda": 0}
    with pytest.raises(ValueError, match="ppg_vndf_sample"):
        MF._launch(*args)


def test_gated_sample_visible_on_the_cpu_runs_the_plain_version(lanes):
    """The same with a gate; the wrapper also refuses a gate whose mtype is
    not int32 [L] or whose mask is not a 32-bit int."""
    args = _k8_args(lanes, True, gated=True)
    MF.reset_counts()
    _same(MF.sample_visible(*args), MF.sample_visible_plain(*args))
    assert MF.COUNTS == {"vndf_kernel": 0, "vndf_plain_on_cuda": 0}
    with pytest.raises(ValueError, match="ppg_vndf_sample"):
        MF._launch(*args)
    mt, fams = args[5]
    for bad in ((mt.float(), fams), (mt[:-1], fams), (mt, 1 << 32),
                (mt, -1)):
        with pytest.raises(ValueError, match="mtype|fams"):
            MF._launch(*args[:5], bad)


def test_sample_bsdf_is_the_same_with_and_without_the_gate(monkeypatch):
    """sample_bsdf on a table of every leaf family (test_torch_bsdf.py's
    ROWS, the port's own loader): wo, weight, pdf, delta and eta bit for
    bit whether the one visible-normal sample is gated to the microfacet
    families' lanes or runs on every lane: the other families never read
    it."""
    from ppg_tpu_torch.bsdf import bsdf as TB
    from ppg_tpu_torch.scene import scene as TS
    from ppg_tpu_torch.scene import xml_parser as TX
    from test_torch_bsdf import ROWS, _table

    tm = TB.MaterialArrays.from_table(
        _table(TS.MaterialBuilder, TS.TextureBuilder,
               (TX.PluginSpec, TX.Spectrum)), "cpu")
    rng = np.random.default_rng(33)
    n = 6000
    tp = TB.gather_params(tm, torch.from_numpy(
        rng.integers(0, len(ROWS), n).astype(np.int32)))
    wi = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    wi = wi / torch.linalg.vector_norm(wi, dim=-1, keepdim=True)
    u = torch.from_numpy(rng.random((n, 3)).astype(np.float32))
    sample, gates = MF.sample_visible, []

    def ungated(*args):
        gates.append(args[5:])
        return sample(*args[:5])

    gated = TB.sample_bsdf(tp, wi, u, tm.present)
    monkeypatch.setattr(MF, "sample_visible", ungated)
    full = TB.sample_bsdf(tp, wi, u, tm.present)
    (gate,), = gates
    inside = MF.gate_mask(*gate)
    assert 1000 < int(inside.sum()) < n - 1000
    for a, b in zip(gated, full):
        assert a.dtype == b.dtype
        if a.is_floating_point():
            _same(a, b)
        else:
            assert torch.equal(a, b)

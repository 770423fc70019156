"""The CUDA triangle-sweep kernels (ppg_tpu_torch/csrc/brute.cu: closest
hit and any hit) against their plain PyTorch version on random triangle
soups made with numpy. By design (an exact second stage decides) the
kernels equal the plain version bit for bit, so that is what is held;
it is stricter than the stated tolerance (near-ties on at most 1e-4 of
the lanes). The kernels have no CPU mode, so the `gpu` tests run only on
a card and skip elsewhere. The file imports no JAX, so that it also runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_brute_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.accel import brute as TB
from ppg_tpu_torch.tools.soups import aim_at_edges, tri_soup


@pytest.fixture
def card():
    """Skips without a CUDA card, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _card(*arrays, device="cuda"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _assert_same_bits(got, want):
    """Every lane picks the same triangle, with the same bits of t, u, v."""
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _assert_same_occlusion(occ, want, t_min, t_max):
    """Any-hit equals the closest-hit sweep's best_i >= 0, and a parked
    lane (t_max < t_min) is never occluded."""
    assert torch.equal(occ, want[0] >= 0)
    assert not occ[t_max < t_min].any()


def _shadow_tmax(L, seed):
    """Finite segment ends with a third of the lanes parked, as the
    tracer's shadow rays."""
    rng = np.random.default_rng(seed)
    t_max = (rng.random(L) * 3.0).astype(np.float32)
    return np.where(rng.random(L) < 0.33, -1.0, t_max).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("T,L", [(12, 1 << 16), (130, 1 << 16),
                                 (1024, 1 << 16), (12, (1 << 20) - 37),
                                 (1024, 1000)])
def test_kernel_matches_plain_bitwise_on_card(card, T, L):
    """L = 2^20 - 37 and 1000 end in a partial block of the launch
    grid."""
    args = _card(*tri_soup(T, L, seed=100 + T + L))
    TB.reset_counts()
    got = TB.brute_closest(*args)
    torch.cuda.synchronize()
    assert TB.COUNTS["brute_kernel"] == 1
    _assert_same_bits(got, TB.brute_sweep_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [12, 1024])
def test_kernels_match_plain_on_rays_aimed_at_edges(card, T):
    L = 1 << 16
    tri, o, d, t_min, t_max = tri_soup(T, L, seed=T + 5)
    o = aim_at_edges(tri, o, d, T)
    args = _card(tri, o, d, t_min, t_max)
    _assert_same_bits(TB.brute_closest(*args), TB.brute_sweep_plain(*args))
    sh = args[:4] + _card(_shadow_tmax(L, seed=T))
    _assert_same_occlusion(TB.brute_any_hit(*sh), TB.brute_sweep_plain(*sh),
                           sh[3], sh[4])


@pytest.mark.gpu
@pytest.mark.parametrize("T", [12, 130])
def test_kernels_match_plain_on_a_ragged_wavefront(card, T):
    """Every launch shape the wrappers use (one ray per thread in blocks
    of 128 for T <= 64; above it 2 x 256 for closest hit, 4 x 256 for any
    hit) on an L that is a multiple of none of them."""
    L = 3 * 4 * 256 + 37
    tri, o, d, t_min, _ = tri_soup(T, L, seed=T)
    args = _card(tri, o, d, t_min, _shadow_tmax(L, seed=T))
    want = TB.brute_sweep_plain(*args)
    _assert_same_bits(TB.brute_closest(*args), want)
    _assert_same_occlusion(TB.brute_any_hit(*args), want, args[3], args[4])


@pytest.mark.gpu
@pytest.mark.parametrize("T", [12, 1024])
def test_any_hit_matches_plain_with_parked_lanes(card, T):
    L = 1 << 18
    tri, o, d, t_min, _ = tri_soup(T, L, seed=T)
    t_max = _shadow_tmax(L, seed=T)
    args = _card(tri, o, d, t_min, t_max)
    TB.reset_counts()
    occ = TB.brute_any_hit(*args)
    assert TB.COUNTS == {"brute_kernel": 0, "any_hit": 1, "plain_on_cuda": 0}
    want = TB.brute_sweep_plain(*args)
    _assert_same_occlusion(occ, want, args[3], args[4])
    assert (want[0][args[4] < args[3]] == -1).all()
    assert occ.sum() > 1000  # the segments are actually occluded


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.gpu)])
def test_any_hit_early_exit_does_not_change_the_answer(device):
    """Ray 0 along +z meets triangle 0 (packed first) at t = 5 and
    triangle 1 at t = 2: the first accepted triangle is not the nearest.
    Any-hit must stop at the first triangle the plain predicate accepts
    under t_max, never at one beyond t_max. On the CPU the wrappers run
    the plain version."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tri = np.zeros((2, 12), np.float32)
    for k, z in enumerate((5.0, 2.0)):
        tri[k, 0:3] = (-1.0, -1.0, z)
        tri[k, 3:6] = (3.0, 0.0, 0.0)
        tri[k, 6:9] = (0.0, 3.0, 0.0)
    t_max = np.array([10.0, 3.0, 1.5, 6.0, -1.0], np.float32)
    L = len(t_max)
    o = np.zeros((L, 3), np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (L, 1))
    args = _card(tri, o, d, np.zeros(L, np.float32), t_max, device=device)
    occ = TB.brute_any_hit(*args).cpu().numpy()
    np.testing.assert_array_equal(occ, [True, True, False, True, False])
    best_i, t, _, _ = TB.brute_closest(*args)
    np.testing.assert_array_equal(best_i.cpu().numpy(), [1, 1, -1, 1, -1])
    np.testing.assert_array_equal(
        occ, (TB.brute_sweep_plain(*args)[0] >= 0).cpu().numpy())


@pytest.mark.gpu
def test_rays_are_read_where_they_lie(card):
    """A camera wavefront's origin is one point expanded (stride 0), and
    column views of a wider table have row strides of their own."""
    tri, o, d, t_min, t_max = tri_soup(130, 5000, seed=9)
    tri_c, d_c, tmin_c, tmax_c = _card(tri, d, t_min, t_max)
    o_c = torch.tensor([0.1, -0.2, 0.3], device="cuda").expand(5000, 3)
    wide = torch.cat([d_c, d_c], 1)[:, 3:]
    want = TB.brute_sweep_plain(tri_c, o_c, wide.contiguous(), tmin_c,
                                tmax_c)
    _assert_same_bits(TB.brute_closest(tri_c, o_c, wide, tmin_c, tmax_c),
                      want)
    assert (want[0] >= 0).sum() > 100


@pytest.mark.gpu
def test_card_tensors_raise_rather_than_fall_back(card):
    tri, o, d, t_min, t_max = _card(*tri_soup(12, 64, seed=1))
    TB.reset_counts()
    with pytest.raises(ValueError):
        TB.brute_closest(tri, o.double(), d, t_min, t_max)
    with pytest.raises(ValueError):
        TB.brute_any_hit(tri.cpu(), o, d, t_min, t_max)
    with pytest.raises(ValueError):
        TB.brute_any_hit(tri, o, d[:, :2], t_min, t_max)
    assert TB.COUNTS == {"brute_kernel": 0, "any_hit": 0, "plain_on_cuda": 0}


def _fma(a, b, c):
    """float32 fma: the product is exact in float64, one rounding."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def test_cheap_test_bound_covers_every_plain_accept():
    """csrc/brute.cu's first stage, emulated in numpy with the kernel's
    formulas (n = e1 x e2 per triangle, FMA chains, sign flips) and its
    bound E = 2^-16 M, passes every ray-triangle pair the plain version
    accepts, so the exact second stage sees them all; the measured
    difference between the two evaluations of det, u', v', t' stays far
    below E (a few units of roundoff x M here; E is 256). Half of the
    rays aim at a point on an edge of a random triangle, where the two
    evaluations disagree about the side: with E = 0 the test would refuse
    pairs the plain version accepts."""
    T, L = 130, 8192
    tri, o, d, t_min, t_max = tri_soup(T, L, seed=11)
    o = aim_at_edges(tri, o, d, 12)
    f32 = np.float32
    ox, oy, oz = o.T
    dx, dy, dz = d.T
    P = np.abs(tri[:, 0:3]).max()
    S = np.abs(tri[:, 3:9]).max()
    A = np.abs(o).max(1) + P
    Dm = np.abs(d).max(1)
    M = S * np.maximum(A, Dm) * np.maximum(S, Dm)
    E = (M / 65536).astype(f32)
    eps = 2.0 ** -24
    best_t = np.full(L, f32(3.4e38))
    worst, accepted, missed = 0.0, 0, 0
    for k in range(T):
        p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[k, :9]
        # the plain version, op for op
        pvx, pvy, pvz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, \
            dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        with np.errstate(divide="ignore"):
            inv = np.where(np.abs(det) < 1e-12, f32(0), f32(1) / det)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        up = tvx * pvx + tvy * pvy + tvz * pvz
        qvx, qvy, qvz = tvy * e1z - tvz * e1y, tvz * e1x - tvx * e1z, \
            tvx * e1y - tvy * e1x
        vp = dx * qvx + dy * qvy + dz * qvz
        tp = e2x * qvx + e2y * qvy + e2z * qvz
        u, v, t = up * inv, vp * inv, tp * inv
        m = np.minimum(best_t, t_max)
        hit = ((inv != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
               & (t > t_min) & (t < m))
        # the kernel's cheap test
        one = np.ones(L, f32)
        nx = _fma(e1y, e2z, -(e1z * e2y))
        ny = _fma(e1z, e2x, -(e1x * e2z))
        nz = _fma(e1x, e2y, -(e1y * e2x))
        dn = _fma(dz, nz * one, _fma(dy, ny * one, dx * nx))
        wx = _fma(dy, tvz, -(dz * tvy))
        wy = _fma(dz, tvx, -(dx * tvz))
        wz = _fma(dx, tvy, -(dy * tvx))
        a = _fma(e2z * one, wz, _fma(e2y * one, wy, e2x * wx))
        b = _fma(e1z * one, wz, _fma(e1y * one, wy, e1x * wx))
        c = _fma(tvz, nz * one, _fma(tvy, ny * one, tvx * nx))
        for xk, xp in ((-dn, det), (-a, up), (b, vp), (c, tp)):
            worst = max(worst, float((np.abs(np.float64(xk) - xp)
                                      / (eps * M)).max()))
        sgn = np.where(np.signbit(dn), f32(-1), f32(1))
        su, nsv, nst, ad = a * sgn, b * sgn, c * sgn, np.abs(dn)
        elo = E * (1 + np.abs(t_min))
        ehi = E * (1 + np.abs(m))
        with np.errstate(over="ignore", invalid="ignore"):
            passed = ((su >= -E) & (nsv <= E) & (su - nsv <= ad + 2 * E)
                      & (nst < _fma(-t_min, ad, elo))
                      & (nst > -_fma(m, ad, ehi)))
        cand = passed | (ad <= E)
        accepted += int(hit.sum())
        missed += int((hit & ~cand).sum())
        best_t = np.where(hit, t, best_t)
    assert accepted > 1000 and missed == 0
    assert worst < 16, worst

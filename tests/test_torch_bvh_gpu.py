"""The CUDA BVH16 walk kernels (ppg_tpu_torch/csrc/bvh.cu: closest hit and
any hit) against their plain PyTorch version, traverse.bvh_closest_plain,
on trees built from numpy-made scenes. The kernels take the plain walk's
steps with the same rounding, so every lane must pick the same triangle
with the same bits of t, u and v, and any-hit must give the same
occlusion. The kernels have no CPU mode, so the `gpu` tests run only on a
card and skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_bvh_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.accel import brute as TB
from ppg_tpu_torch.accel import bvh_walk as BW
from ppg_tpu_torch.accel import traverse as TT
from ppg_tpu_torch.scene.shapes import make_sphere
from ppg_tpu_torch.tools.soups import (TIE_COPIES, aim_at_edges, deep_soup,
                                      soup_rays, tie_rays, tie_soup)


@pytest.fixture
def card():
    """Skips without a CUDA card, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _card(*arrays):
    return [torch.from_numpy(a).cuda() for a in arrays]


def _assert_same_bits(got, want):
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _check(geom, o, d, t_min, t_max):
    """Both kernels against the plain walk on these rays, each launched
    once; returns the plain closest hits."""
    TB.reset_counts()
    got = BW.bvh_closest(geom, o, d, t_min, t_max)
    occ = BW.bvh_any_hit(geom, o, d, t_min, t_max)
    torch.cuda.synchronize()
    assert BW.COUNTS == {"bvh_kernel": 1, "bvh_any_hit": 1}
    want = TT.bvh_closest_plain(geom, o, d, t_min, t_max)
    _assert_same_bits(got, want)
    want_occ = TT.bvh_closest_plain(geom, o, d, t_min, t_max,
                                    stop_on_hit=True)[0] >= 0
    assert torch.equal(occ, want_occ)
    assert torch.equal(occ, want[0] >= 0)
    assert not occ[t_max < t_min].any()
    return want


@pytest.fixture(scope="module")
def soup_geom():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return TT.build_geometry(*deep_soup(), "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1 << 16, (1 << 16) - 37, 1000])
def test_kernels_match_plain_bitwise_on_card(card, soup_geom, L):
    """The ragged lengths end in a partial block of 128."""
    want = _check(soup_geom, *_card(*soup_rays(L, seed=L)))
    assert int((want[0] >= 0).sum()) > L // 4


@pytest.mark.gpu
def test_kernels_match_plain_on_rays_aimed_at_edges(card, soup_geom):
    L = 1 << 15
    o, d, t_min, t_max = soup_rays(L, seed=5)
    o = aim_at_edges(soup_geom.tri.cpu().numpy(), o, d, 6)
    _check(soup_geom, *_card(o, d, t_min, t_max))


@pytest.mark.gpu
def test_any_hit_matches_plain_with_parked_lanes(card, soup_geom):
    L = 1 << 16
    args = _card(*soup_rays(L, seed=9, shadow=True))
    want = _check(soup_geom, *args)
    assert (want[0][args[3] < args[2]] == -1).all()
    assert int((want[0] >= 0).sum()) > 1000


@pytest.mark.gpu
def test_rays_are_read_where_they_lie(card, soup_geom):
    """A camera wavefront's origin is one point expanded (stride 0), and
    column views of a wider table have row strides of their own."""
    _, d, t_min, t_max = _card(*soup_rays(5000, seed=2))
    o = torch.tensor([0.1, -0.2, 6.0], device="cuda").expand(5000, 3)
    wide = torch.cat([d, d], 1)[:, 3:]
    want = TT.bvh_closest_plain(soup_geom, o, wide.contiguous(), t_min,
                                t_max)
    _assert_same_bits(BW.bvh_closest(soup_geom, o, wide, t_min, t_max),
                      want)
    assert torch.equal(BW.bvh_any_hit(soup_geom, o, wide, t_min, t_max),
                       want[0] >= 0)
    assert (want[0] >= 0).sum() > 100


@pytest.mark.gpu
def test_walk_ties_break_to_the_first_index(card):
    """tools/soups.tie_soup: coincident sibling boxes (ties in tn) over
    leaves of identical triangles (ties in t). The group's first-minimum
    picks the lowest index on every tie, as the plain walk's scan does, so
    every lane matches it bit for bit; rays of a ragged length."""
    pos, faces = tie_soup()
    geom = TT.build_geometry(pos, faces, "cuda")
    want = _check(geom, *_card(*tie_rays((1 << 14) - 5, seed=14)))
    copies = geom.perm >= len(faces) - sum(TIE_COPIES)
    on_stack = (want[0] >= 0) & copies[want[0].clamp(min=0).long()]
    assert int(on_stack.sum()) > 1 << 12
    assert len(set(want[0][on_stack].tolist())) == 2


@pytest.mark.gpu
def test_sphere_from_inside_and_a_root_leaf(card):
    """Every ray from the centre of a tessellated sphere hits it; the
    12-triangle Cornell box is a one-leaf tree under its wrapping root
    (force_bvh), and its walk picks what the sweep picks."""
    mesh = make_sphere(np.zeros(3), 100.0)
    geom = TT.build_geometry(mesh.positions, mesh.faces, "cuda")
    L = 4096
    _, d, t_min, _ = soup_rays(L, seed=3)
    want = _check(geom, *_card(np.zeros((L, 3), np.float32), d, t_min,
                               np.full(L, 1e9, np.float32)))
    assert (want[0] >= 0).all()

    from ppg_tpu_torch.scene import mini_cbox
    sc = mini_cbox(res=8)
    box = TT.build_geometry(sc.positions, sc.faces, "cuda")
    rng = np.random.default_rng(4)
    o = rng.uniform(-0.9, 0.9, (L, 3)).astype(np.float32) + [0, 1, 0]
    args = _card(o.astype(np.float32), d, t_min,
                 np.full(L, 3.4e38, np.float32))
    _check(box, *args)
    # the sweep keeps a -0.0 u or v where the walk stores +0.0: t by its
    # bits, u and v by value
    got = TT.closest_hit(box, *args, force_bvh=True)
    want = TB.brute_sweep_plain(box.tri, *args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.gpu)])
def test_any_hit_early_exit_does_not_change_the_answer(device):
    """Two triangles in one leaf: ray 0 along +z meets triangle A at t = 5
    and B at t = 2. The walk's any-hit stops at the leaf's first accepted
    hit under t_max, never at one beyond t_max; on the CPU the wrappers
    run the plain walk."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    pos, faces = [], []
    for z in (5.0, 2.0):
        faces.append([len(pos), len(pos) + 1, len(pos) + 2])
        pos += [(-1.0, -1.0, z), (2.0, -1.0, z), (-1.0, 2.0, z)]
    geom = TT.build_geometry(np.array(pos), np.array(faces), device)
    t_max = np.array([10.0, 3.0, 1.5, 6.0, -1.0], np.float32)
    L = len(t_max)
    o = np.zeros((L, 3), np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (L, 1))
    args = [torch.from_numpy(a).to(device)
            for a in (o, d, np.zeros(L, np.float32), t_max)]
    occ = BW.bvh_any_hit(geom, *args).cpu().numpy()
    np.testing.assert_array_equal(occ, [True, True, False, True, False])
    best_i, t, _, _ = BW.bvh_closest(geom, *args)
    np.testing.assert_array_equal(t.cpu().numpy()[[0, 1, 3]], [2.0] * 3)
    np.testing.assert_array_equal(best_i.cpu().numpy() >= 0, occ)


@pytest.mark.gpu
def test_card_tensors_raise_rather_than_fall_back(card, soup_geom):
    o, d, t_min, t_max = _card(*soup_rays(64, seed=1))
    TB.reset_counts()
    with pytest.raises(ValueError):
        BW.bvh_closest(soup_geom, o.double(), d, t_min, t_max)
    with pytest.raises(ValueError):
        BW.bvh_any_hit(soup_geom, o, d[:, :2], t_min, t_max)
    cpu_rows = TT.GeometryArrays(soup_geom.tri, soup_geom.perm,
                                 soup_geom.rows.cpu(), soup_geom.stack_depth)
    with pytest.raises(ValueError):
        BW.bvh_closest(cpu_rows, o, d, t_min, t_max)
    unpadded = TT.GeometryArrays(soup_geom.tri, soup_geom.perm,
                                 soup_geom.rows.contiguous(),
                                 soup_geom.stack_depth)
    with pytest.raises(ValueError):
        BW.bvh_any_hit(unpadded, o, d, t_min, t_max)
    too_deep = TT.GeometryArrays(soup_geom.tri, soup_geom.perm,
                                 soup_geom.rows, BW.STACK_CAP + 8)
    with pytest.raises(ValueError):
        BW.bvh_closest(too_deep, o, d, t_min, t_max)
    assert BW.COUNTS == {"bvh_kernel": 0, "bvh_any_hit": 0}
    assert TB.COUNTS["plain_on_cuda"] == 0

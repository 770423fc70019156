"""The port's small-scene sweep (ppg_tpu_torch/accel) against ppg_tpu's:
the plain PyTorch version must agree with ppg_tpu's XLA referee
(traverse.brute_force_closest) and with the Pallas kernel run in
interpret mode (pallas_brute.brute_pallas), on random triangle soups made
with numpy. The CUDA kernel itself is held bit for bit against the plain
version by the `gpu` tests of test_torch_brute_gpu.py, which run only on a
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.accel.pallas_brute import brute_pallas
from ppg_tpu.accel.traverse import GeometryArrays as JGeom
from ppg_tpu.accel.traverse import any_hit as j_any_hit
from ppg_tpu.accel.traverse import brute_force_closest as j_brute
from ppg_tpu.accel.traverse import build_geometry as j_build
from ppg_tpu_torch.accel import brute as TB
from ppg_tpu_torch.accel import traverse as TT
from ppg_tpu_torch.convert import geometry_from_numpy
from ppg_tpu_torch.tools.soups import tri_soup

INF32 = np.float32(3.4e38)


def _port(tri, o, d, t_min, t_max):
    out = TB.brute_sweep_plain(
        *(torch.from_numpy(a) for a in (tri, o, d, t_min, t_max)))
    return [x.numpy() for x in out]


def geometries(tri):
    """The soup's triangles tri [T,12] as a mesh, built by the port's and
    by ppg_tpu's build_geometry (the same packed order and tree)."""
    p0 = tri[:, 0:3]
    pos = np.stack([p0, p0 + tri[:, 3:6], p0 + tri[:, 6:9]], 1).reshape(-1, 3)
    faces = np.arange(len(pos)).reshape(-1, 3)
    return TT.build_geometry(pos, faces, "cpu"), j_build(pos, faces)


def _f32_bound(tri, o, d, idx):
    """Per-lane forward error bound of a float32 Moeller-Trumbore
    evaluation of (t, u, v) against triangle idx: 8 units of f32 roundoff
    times the condition of each quotient (sum of |terms| over |det|). Two
    correct f32 evaluations that round in different places, e.g. where
    XLA:CPU contracts a multiply-add into an FMA inside its fused scan
    body, differ by at most about this much; cancellation in det or in
    the numerators is what makes it exceed 1e-5 relative on some lanes."""
    r = tri[idx].astype(np.float64)
    p0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
    o, d = o.astype(np.float64), d.astype(np.float64)

    def acr(a, b):  # |a| x |b| with all terms positive
        a, b = np.abs(a), np.abs(b)
        return np.stack([a[:, 1] * b[:, 2] + a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] + a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0]], -1)

    pv = np.cross(d, e2)
    tv = o - p0
    qv = np.cross(tv, e1)
    det = (e1 * pv).sum(-1)
    tva = np.abs(o) + np.abs(p0)
    det_a = (np.abs(e1) * acr(d, e2)).sum(-1)
    nums = ((tv * pv).sum(-1), (d * qv).sum(-1), (e2 * qv).sum(-1))
    nums_a = ((tva * acr(d, e2)).sum(-1), (np.abs(d) * acr(tva, e1)).sum(-1),
              (np.abs(e2) * acr(tva, e1)).sum(-1))
    k = 8 * 2.0 ** -24
    ad = np.abs(det)
    u, v, t = (n / det for n in nums)
    bu, bv, bt = (k * (na + np.abs(x) * det_a) / ad
                  for na, x in zip(nums_a, (u, v, t)))
    return bt, bu, bv


def _assert_agree(port, ref, rays, what):
    """best_i identical, miss sentinels identical, t/u/v within 1e-5
    relative on hits plus the lane's f32 error bound (_f32_bound).
    Where XLA evaluates op by op (the unrolled sweep, T <= 64) the port
    is in fact bit-identical. XLA:CPU may also contract a multiply-add
    where PyTorch rounds twice, which can flip which of two triangles at
    the same distance is nearer: such a lane is accepted only if the two
    hits' t agree within 1e-5 relative, and such lanes stay under 1e-4 of
    all lanes. On the card the kernel matches the plain version exactly
    (the gpu test)."""
    pi, pt, pu, pv = port
    ri, rt, ru, rv = (np.asarray(x) for x in ref)
    L = len(pi)
    differ = pi != ri
    if differ.any():
        tie = np.isclose(pt, rt, rtol=1e-5, atol=0) & (pi >= 0) & (ri >= 0)
        assert tie[differ].all(), f"{what}: non-tie best_i mismatch"
        assert differ.sum() <= 1e-4 * L, f"{what}: {differ.sum()} near ties"
    same = ~differ
    miss = same & (pi < 0)
    assert (pt[miss] == INF32).all() and (rt[miss] == INF32).all(), what
    hit = same & (pi >= 0)
    tri, o, d = rays
    bounds = _f32_bound(tri, o[hit], d[hit], pi[hit])
    for a, b, bound, name in zip((pt, pu, pv), (rt, ru, rv), bounds, "tuv"):
        err = np.abs(a[hit].astype(np.float64) - b[hit])
        tol = 1e-5 * np.abs(b[hit]) + bound
        assert (err <= tol).all(), (what, name, float(err.max()),
                                    int((err > tol).sum()))


@pytest.mark.parametrize("T,L", [(7, 512), (36, 2048), (130, 4096),
                                 (1024, 4096)])
def test_plain_sweep_matches_xla_and_pallas(T, L):
    tri, o, d, t_min, t_max = tri_soup(T, L, seed=T)
    port = _port(tri, o, d, t_min, t_max)
    jgeom = JGeom(jnp.asarray(tri), jnp.zeros((1, 64)),
                  jnp.arange(T, dtype=jnp.int32), stack_depth=8)
    ja = [jnp.asarray(a) for a in (o, d, t_min, t_max)]
    rays = (tri, o, d)
    _assert_agree(port, j_brute(jgeom, *ja), rays, "xla referee")
    _assert_agree(port, brute_pallas(jgeom.tri, *ja, interpret=True), rays,
                  "pallas interpret")
    if T <= 64:  # XLA's unrolled sweep rounds every op as PyTorch does
        for a, b in zip(port, j_brute(jgeom, *ja)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert (port[0] >= 0).sum() >= 20  # the soups are actually hit
    parked = t_max < t_min
    assert (port[0][parked] == -1).all()


def test_wrapper_on_cpu_is_the_plain_version_and_any_hit_agrees():
    tri, o, d, t_min, t_max = tri_soup(40, 1000, seed=3)
    TB.reset_counts()
    args = [torch.from_numpy(a) for a in (o, d, t_min, t_max)]
    got = TB.brute_closest(torch.from_numpy(tri), *args)
    want = TB.brute_sweep_plain(torch.from_numpy(tri), *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert TB.COUNTS == {"brute_kernel": 0, "any_hit": 0, "plain_on_cuda": 0}
    geom, jgeom = geometries(tri)
    occ = TT.any_hit(geom, *args).numpy()
    assert TB.COUNTS == {"brute_kernel": 0, "any_hit": 0, "plain_on_cuda": 0}
    j_occ = np.asarray(j_any_hit(jgeom, *(jnp.asarray(a) for a in
                                          (o, d, t_min, t_max))))
    np.testing.assert_array_equal(occ, j_occ)


def test_build_geometry_matches_ppg_tpu_and_large_scenes_raise():
    """The port's build_geometry keeps the tree's rows beside the packed
    triangles, equal to ppg_tpu's; a scene above BRUTE_MAX triangles no
    longer raises (it takes the BVH walk, tests/test_torch_bvh.py)."""
    from ppg_tpu_torch.scene import mini_cbox

    sc = mini_cbox(res=8)
    rng = np.random.default_rng(0)
    pos = rng.random((3 * (TT.BRUTE_MAX + 1), 3))
    faces = np.arange(len(pos)).reshape(-1, 3)
    for p, f in ((sc.positions, sc.faces), (pos, faces)):
        g = TT.build_geometry(p, f, "cpu")
        jg = j_build(p, f)
        np.testing.assert_array_equal(g.tri.numpy(), np.asarray(jg.tri))
        np.testing.assert_array_equal(g.perm.numpy(), np.asarray(jg.perm))
        # the rows' empty child slots are NaN: compare the bits
        np.testing.assert_array_equal(
            g.rows.numpy().view(np.int32),
            np.asarray(jg.rows).view(np.int32))
        assert (g.stack_depth, g.wide) == (jg.stack_depth, jg.wide)
        assert g.tri.dtype == torch.float32 and g.perm.dtype == torch.int32
        # ppg_tpu's arrays carried across give the same geometry
        c = geometry_from_numpy(np.asarray(jg.tri), np.asarray(jg.rows),
                                np.asarray(jg.perm), jg.stack_depth,
                                jg.wide, "cpu")
        assert torch.equal(c.tri, g.tri) and torch.equal(c.perm, g.perm)
        assert torch.equal(c.rows.view(torch.int32),
                           g.rows.view(torch.int32))
    assert g.num_tris == TT.BRUTE_MAX + 1 and g.rows.shape[0] > 2

"""The port's next-event estimation against ppg_tpu's on identical numpy
inputs: the triangle warp, the emitter sampling tables, sample_direct /
pdf_direct, the tracer's emitter-set sample, the NEE training records and
the shadow-ray any-hit through the triangle sweep."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.accel.traverse import any_hit as j_any_hit
from ppg_tpu.core import warp as JW
from ppg_tpu.emitters import area as JE
from ppg_tpu.guiding import records as JR
from ppg_tpu.integrators import driver as JD
from ppg_tpu.integrators import wavefront as JWF
from ppg_tpu_torch.accel import brute as TB
from ppg_tpu_torch.accel import traverse as TT
from ppg_tpu_torch.core import warp as TW
from ppg_tpu_torch.emitters import area as TE
from ppg_tpu_torch.guiding import records as TR
from ppg_tpu_torch.integrators import wavefront as TWF
from ppg_tpu_torch.scene import mini_cbox
from ppg_tpu_torch.tools.soups import tri_soup
from test_torch_brute import geometries


@pytest.fixture(scope="module")
def cbox():
    return mini_cbox(res=8, nee="always")


def _queries(rng, n):
    """Shading points inside the box, unit normals (every 7th zeroed, as
    for transmissive surfaces) and NEE uniforms."""
    p = np.stack([rng.uniform(-0.99, 0.99, n), rng.uniform(0.01, 1.99, n),
                  rng.uniform(-0.99, 0.99, n)], -1).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[::7] = 0.0
    u2 = rng.random((n, 2)).astype(np.float32)
    return p, nrm, u2


def test_square_to_uniform_triangle_exact():
    """Equal but for one unit in the last place of the square root: the
    same f32 operations, but PyTorch's CPU float32 sqrt is not correctly
    rounded (one ulp off on about 0.5% of these inputs, where XLA's sqrt
    matches numpy's correctly rounded one). sqrt(1 - u) < 1, so one ulp
    of it is at most 2**-24 absolute in both barycentrics."""
    u = np.random.default_rng(1).random((5000, 2)).astype(np.float32)
    got = TW.square_to_uniform_triangle(torch.from_numpy(u)).numpy()
    want = np.asarray(JW.square_to_uniform_triangle(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -24)
    assert (got == want).mean() > 0.99


def test_emitter_tables_equal(cbox):
    t = TE.EmitterArrays.from_scene(cbox, "cpu")
    j = JE.EmitterArrays.from_scene(cbox)
    assert t.num == j.num == 1
    for f in TE.EmitterArrays.FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.tri_offset.dtype == torch.int32 and t.etri.shape[1] == 19


def test_sample_and_pdf_direct_match(cbox):
    """d, dist, pdf and value within 1e-6 relative: both sides take the
    same f32 steps; only the order of 3-term sums and sqrt rounding may
    differ. pdf_direct at the sampled point gives back the sample's pdf."""
    t = TE.EmitterArrays.from_scene(cbox, "cpu")
    j = JE.EmitterArrays.from_scene(cbox)
    p, nrm, u2 = _queries(np.random.default_rng(3), 6000)
    got = TE.sample_direct(t, *(torch.from_numpy(a) for a in (p, nrm, u2)))
    want = JE.sample_direct(j, *(jnp.asarray(a) for a in (p, nrm, u2)))
    for k in ("d", "dist", "pdf", "value", "p", "n"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    ok = got["pdf"].numpy() > 0
    assert 0.03 < ok.mean() < 0.9  # both accepted and rejected samples
    eid = torch.where(torch.from_numpy(ok), 0, -1).to(torch.int32)
    tp = TE.pdf_direct(t, eid, got["p"], got["n"], torch.from_numpy(p))
    jp = JE.pdf_direct(j, jnp.asarray(eid.numpy()), want["p"], want["n"],
                       jnp.asarray(p))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_allclose(tp.numpy()[ok], got["pdf"].numpy()[ok],
                               rtol=1e-5)
    assert (tp.numpy()[~ok] == 0).all()


def test_sample_emitters_matches(cbox):
    scene = TWF.DeviceScene.from_scene(cbox, "cpu")
    jscene = JWF.DeviceScene.from_scene(cbox)
    jcfg = JD.make_config(cbox, guiding=False)
    p, nrm, u2 = _queries(np.random.default_rng(5), 3000)
    got = TWF._sample_emitters(scene, *(torch.from_numpy(a)
                                        for a in (p, nrm, u2)))
    want, n_slots = JWF._sample_emitters(
        jscene, jcfg, *(jnp.asarray(a) for a in (p, nrm, u2)))
    assert n_slots == 1 and not np.asarray(want["discrete"]).any()
    for k in ("d", "dist", "pdf", "value"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_nee_records_match():
    rng = np.random.default_rng(7)
    J, L = 4, 600
    nee = dict(
        p=rng.random((J, L, 3)).astype(np.float32),
        d=rng.normal(size=(J, L, 3)).astype(np.float32),
        radiance=rng.random((J, L, 3)).astype(np.float32),
        throughput=rng.random((J, L, 3)).astype(np.float32) * 3,
        bsdf_val=rng.random((J, L, 3)).astype(np.float32),
        wo_pdf=(rng.random((J, L)) * (rng.random((J, L)) < 0.9)).astype(
            np.float32),
        bsdf_pdf=rng.random((J, L)).astype(np.float32),
        dtree_pdf=rng.random((J, L)).astype(np.float32),
        dtree_id=rng.integers(-1, 20, (J, L)).astype(np.int32),
        voxel=rng.random((J, L, 3)).astype(np.float32),
        valid=rng.random((J, L)) < 0.8,
    )
    nee["throughput"][0, :10] = 1e-9  # the Epsilon guard
    nee["radiance"][1, :5, 2] = np.nan  # non-finite records drop
    got = TR.nee_records({k: torch.from_numpy(v) for k, v in nee.items()})
    want = JR.nee_records({k: jnp.asarray(v) for k, v in nee.items()})
    # the port also passes dtree_id through (ppg_tpu's splat never reads it)
    assert set(got) - {"dtree_id"} == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    assert (got["stat_weight"] == 0.5).all() and not got["is_delta"].any()


@pytest.mark.parametrize("T", [12, 300])
def test_any_hit_matches_with_parked_lanes(T):
    """Shadow segments of random length, a third of the lanes parked
    with t_max = -1 as the tracer parks lanes without a NEE sample:
    identical occlusion, and parked lanes are never occluded."""
    tri, o, d, t_min, _ = tri_soup(T, 4000, seed=T)
    rng = np.random.default_rng(T)
    t_max = rng.uniform(0.0, 3.0, 4000).astype(np.float32)
    t_max[rng.random(4000) < 0.33] = -1.0
    geom, jgeom = geometries(tri)
    TB.reset_counts()
    occ = TT.any_hit(geom, *(torch.from_numpy(a)
                             for a in (o, d, t_min, t_max))).numpy()
    assert TB.COUNTS["any_hit"] == 0  # CPU tensors take the plain sweep
    want = np.asarray(j_any_hit(jgeom, *(jnp.asarray(a)
                                         for a in (o, d, t_min, t_max))))
    np.testing.assert_array_equal(occ, want)
    assert not occ[t_max < 0].any()
    assert 0.02 < occ.mean() < 0.95

"""NEE through null and mask surfaces in the port
(ppg_tpu_torch/integrators/wavefront.py::shadow_transmittance) against
ppg_tpu's, and ppg_tpu's tests/test_shadow_null.py (tests 1-3, marked slow
there) on the port.

The walk: the same shadow segments, from points spread over the box to
points above the panel of mini_cbox_panel (a mask of opacity 0.6, and a
null panel) and of mini_cbox_wrappers without its spheres (a mask panel
and a null rectangle), through the port's plain sweep and ppg_tpu's,
with no cap and with a cap of 1 (a crossing at the cap blocks).
Without media the walk is deterministic, so T is compared lane by lane:
exactly, since both sides multiply the same float32 factors (1 or 1 -
opacity) in the same order after the same closest hits (the
intersection is bit for bit, tests/test_torch_brute.py).

The renders (the port's CPU generator): a masked panel's nee always and
nee never means within 6% (both estimators are unbiased for one scene);
a null panel leaves nee always within 5% of the box without it (maxDepth
24, a crossing takes a depth level); direct light through a nearly
transparent mask is over twice that through a nearly opaque one. These
are the reference's gates, scenes and seeds, and its samples per image:
the reference renders 32 x 32 pixels at 384, 96 and 64 spp, the port
128 x 128 at a sixteenth of those (24, 6 and 4), since a CPU wavefront
costs about as much at 16,384 lanes as at 1,024 and the image mean's
variance follows the samples per image. Margins seen on the CPU: 1.4%
(mask, nee always against never), 1.5% (null) and 10.5x (attenuation).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ppg_tpu.integrators import driver as JD
from ppg_tpu.integrators import wavefront as JW
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators import wavefront as W
from ppg_tpu_torch.scene.testscenes import (mini_cbox, mini_cbox_panel,
                                            mini_cbox_wrappers)

N_SEG = 4096
RES = 128  # the renders' side


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segments(seed):
    """Shadow segments from points inside the box to points just below
    the ceiling, most of them across the panel (y = 1.85, |x|, |z| <
    0.5) and some across the luminaire (y = 1.7) or the null rectangle
    (z = -0.5)."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.95, 0.95, N_SEG), rng.uniform(0.05, 1.6,
                                                               N_SEG),
                  rng.uniform(-0.95, 0.95, N_SEG)], -1)
    tgt = np.stack([rng.uniform(-0.6, 0.6, N_SEG), np.full(N_SEG, 1.99),
                    rng.uniform(-0.6, 0.6, N_SEG)], -1)
    v = tgt - o
    dist = np.linalg.norm(v, axis=1)
    d = v / dist[:, None]
    active = rng.random(N_SEG) < 0.9
    return (o.astype(np.float32), d.astype(np.float32),
            dist.astype(np.float32), active)


SCENES = {
    "mask": lambda: mini_cbox_panel(res=16, nee="always", panel="mask"),
    "null": lambda: mini_cbox_panel(res=16, nee="always", panel="null"),
    "wrappers": lambda: mini_cbox_wrappers(res=16, nee="always",
                                           spheres=False),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shadow_walk_matches_ppg_tpu(name):
    sc = SCENES[name]()
    jcfg = JD.make_config(sc)
    assert jcfg.has_mask or jcfg.has_null
    jscene = JW.DeviceScene.from_scene(sc)
    tscene = W.DeviceScene.from_scene(sc, "cpu")
    o, d, dist, active = _segments(len(name))
    for cap in (None, 1):
        W.reset_counts()
        t_t = W.shadow_transmittance(
            tscene, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(dist), torch.from_numpy(active), cap)
        t_j = JW.shadow_transmittance(
            jscene, jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist),
            None, jax.random.key(0), jnp.asarray(active),
            max_inter=None if cap is None else jnp.full(N_SEG, cap,
                                                        jnp.int32))
        np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
        assert W.WALK_COUNTS["walks"] == 1
        assert (W.WALK_COUNTS["host_reads"]
                == W.WALK_COUNTS["crossings"] + 1)
        if cap is None:
            T = t_t.numpy()
            crossed = (T > 0).all(1) & (T < 1).any(1)
            # lanes through the panel, lanes blocked, lanes through
            # nothing (T = 1) and lanes off
            assert (T == 0).all(1).sum() > 100
            assert (T == 1).all(1).sum() > 100
            if name != "null":
                assert crossed.sum() > 100
        else:
            # the second crossing blocks: what passes crossed at most one
            # surface, and a lane through one is unchanged
            T1 = t_t.numpy()
            assert ((T1 > 0).all(1) <= (T > 0).all(1)).all()
            assert W.WALK_COUNTS["crossings"] <= 2


def _mean(img):
    return float(np.asarray(img).mean())


def test_nee_through_mask_matches_no_nee():
    # same masked scene: nee always must agree with nee never in the mean
    sc_n = mini_cbox_panel(res=RES, nee="never", panel="mask", opacity=0.6)
    sc_a = mini_cbox_panel(res=RES, nee="always", panel="mask", opacity=0.6)
    img_n = TD.render(sc_n, spp=24, seed=1, chunk=RES * RES, device="cpu")
    img_a = TD.render(sc_a, spp=6, seed=2, chunk=RES * RES, device="cpu")
    m_n, m_a = _mean(img_n), _mean(img_a)
    assert abs(m_n - m_a) / m_n < 0.06, (m_n, m_a)


def test_nee_through_null_is_fully_transparent():
    # a null panel must not change the nee always estimate; maxDepth is
    # deep because a null crossing takes a depth level, as the
    # reference's ENull branch does (rRec.depth++)
    sc_p = mini_cbox_panel(res=RES, nee="always", panel="null",
                           max_depth=24)
    sc_0 = mini_cbox(res=RES, nee="always", max_depth=24)
    img_p = TD.render(sc_p, spp=4, seed=3, chunk=RES * RES, device="cpu")
    img_0 = TD.render(sc_0, spp=4, seed=3, chunk=RES * RES, device="cpu")
    m_p, m_0 = _mean(img_p), _mean(img_0)
    assert abs(m_p - m_0) / m_0 < 0.05, (m_p, m_0)


def test_mask_shadow_attenuation_scales_with_opacity():
    # direct light through the panel scales like 1 - opacity: a nearly
    # opaque mask against a nearly transparent one
    lo = mini_cbox_panel(res=RES, nee="always", panel="mask", opacity=0.95)
    hi = mini_cbox_panel(res=RES, nee="always", panel="mask", opacity=0.05)
    img_lo = TD.render(lo, spp=4, seed=4, chunk=RES * RES, device="cpu")
    img_hi = TD.render(hi, spp=4, seed=4, chunk=RES * RES, device="cpu")
    assert _mean(img_hi) > 2.0 * _mean(img_lo), (_mean(img_hi),
                                                 _mean(img_lo))

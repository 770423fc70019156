"""Whole renders of a scene above the sweep's 1024 triangles, so that every
ray walks the BVH: the built-in Cornell box with a tessellated sphere on
its floor (scene/testscenes.py::mini_cbox_sphere, 16,140 triangles). The
port's unguided render against ppg_tpu's driver.render (classic
trace_paths through bvh_closest); the port's guided render with NEE
(shadow rays through the walk's any-hit) against its unguided render and
against ppg_tpu's guided render. The random streams differ, so the images
are held to the gates of tests/test_regen.py (test_torch_render.py's
assert_images_agree)."""

import numpy as np
import pytest

from ppg_tpu.integrators import driver as JD
from ppg_tpu_torch.accel import traverse as TT
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.guided import GuidedPathTracer as TTracer
from ppg_tpu_torch.scene.testscenes import mini_cbox_sphere
from test_torch_render import (  # noqa: F401 (one_torch_thread: autouse)
    assert_images_agree, one_torch_thread)
from test_torch_render_improved import _guided_pair

NEE_BOX = dict(spatialFilter="box", directionalFilter="box",
               bsdfSamplingFractionLoss="var")


@pytest.fixture
def walks(monkeypatch):
    """Counts the calls that reach the walk and the sweep."""
    calls = {}
    for name in ("bvh_closest", "bvh_any_hit", "brute_closest",
                 "brute_any_hit"):
        def spy(*a, _n=name, _f=getattr(TT, name), **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(TT, name, spy)
    return calls


def test_unguided_render_through_the_walk_agrees_with_ppg_tpu(walks):
    sc = mini_cbox_sphere(res=32, budget=16, max_depth=6)
    assert sc.num_tris == 16140
    img_t = TD.render(sc, spp=48, seed=3, chunk=32 * 32, device="cpu")
    assert walks["bvh_closest"] > 0 and "brute_closest" not in walks
    img_j = np.asarray(JD.render(sc, spp=48, seed=3, chunk=32 * 32))
    assert np.isfinite(img_t).all()
    assert_images_agree(img_j, img_t)


def test_guided_nee_render_through_the_walk_agrees_with_unguided(walks):
    """nee="always" with the box filters and the variance loss: every
    shadow ray goes through the walk's any-hit."""
    sc = mini_cbox_sphere(res=32, budget=16, max_depth=6, nee="always")
    port = TTracer(sc, chunk=32 * 32, overrides=NEE_BOX, device="cpu")
    img = port.render(seed=1)
    assert walks["bvh_any_hit"] > 0 and walks["bvh_closest"] > 0
    assert not set(walks) & {"brute_closest", "brute_any_hit"}
    ref = TD.render(sc, spp=24, seed=4, chunk=32 * 32, device="cpu")
    assert np.isfinite(img).all() and img.mean() > 0
    assert_images_agree(ref, img)


def test_guided_nee_render_through_the_walk_agrees_with_ppg_tpu():
    sc = mini_cbox_sphere(res=32, budget=16, max_depth=6, nee="always")
    port, img_t, img_j = _guided_pair(sc, NEE_BOX, 32)
    assert_images_agree(img_j, img_t)
    assert port.tree_stats[-1]["n_dtrees"] >= 1

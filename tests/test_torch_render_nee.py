"""Next-event estimation in whole renders: the port's guided tracer with
nee="always", the box spatial and directional filters and the variance
loss, and its unguided tracer with NEE, each against ppg_tpu's under the
gates of tests/test_regen.py (see test_torch_render.py)."""

import numpy as np

from ppg_tpu.integrators import driver as JD
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.scene import mini_cbox
from test_torch_render import (  # noqa: F401 (one_torch_thread: autouse)
    assert_images_agree, one_torch_thread)
from test_torch_render_improved import _guided_pair


def test_nee_always_box_var_render_agrees_with_ppg_tpu():
    """nee="always" with the box spatial and directional filters and the
    variance loss: shadow rays counted, the same schedule, the gates."""
    sc = mini_cbox(res=32, budget=32, max_depth=6, nee="always")
    over = dict(spatialFilter="box", directionalFilter="box",
                bsdfSamplingFractionLoss="var")
    port, img_t, img_j = _guided_pair(sc, over, 32)
    assert_images_agree(img_j, img_t)
    assert float(port.sdtree.opt_var.abs().max()) > 0
    # every diffuse shade casts a shadow ray beside its continuation ray:
    # beyond the camera rays, close to 2 rays per shade (at most 1 without
    # NEE)
    for s in port.stats:
        n_samples = s["spp"] * 32 * 32
        shades = s["avg_path_length"] * n_samples
        assert s["n_rays"] - n_samples > 1.8 * shades


def test_unguided_nee_render_agrees_with_ppg_tpu():
    sc = mini_cbox(res=32, budget=16, max_depth=6, nee="always")
    img_t = TD.render(sc, spp=24, seed=3, chunk=32 * 32, device="cpu")
    img_j = np.asarray(JD.render(sc, spp=24, seed=3, chunk=32 * 32))
    assert np.isfinite(img_t).all()
    assert_images_agree(img_j, img_t)

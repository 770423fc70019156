"""cbox-improved's settings (stochastic spatial and box directional
filters, the kl-trained bsdf sampling fraction, inverse-variance
combination, sTreeThreshold 4000, sppPerPass 1) rendered by the port's
GuidedPathTracer and by ppg_tpu's, held to the gates of
tests/test_regen.py (see test_torch_render.py)."""

import numpy as np

from ppg_tpu.integrators.guided import GuidedPathTracer as JTracer
from ppg_tpu_torch.integrators.guided import GuidedPathTracer as TTracer
from ppg_tpu_torch.scene import mini_cbox
from test_torch_render import (  # noqa: F401 (one_torch_thread: autouse)
    assert_images_agree, one_torch_thread)


IMPROVED = dict(sampleCombination="inversevar", bsdfSamplingFractionLoss="kl",
                spatialFilter="stochastic", directionalFilter="box",
                sTreeThreshold=4000, sppPerPass=1)


def _guided_pair(sc, overrides, res):
    """The same guided render in the port and in ppg_tpu (classic mode,
    the per-chunk mode the port implements)."""
    port = TTracer(sc, chunk=res * res, overrides=overrides, device="cpu")
    img_t = port.render(seed=0)
    ref = JTracer(sc, chunk=res * res, overrides=overrides)
    ref.train_mode = "classic"
    img_j = np.asarray(ref.render(seed=0))
    assert [(s["passes"], s["is_final"]) for s in port.stats] == \
        [(s["passes"], s["is_final"]) for s in ref.stats]
    assert img_t.shape == img_j.shape == (res, res, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    return port, img_t, img_j


def test_improved_render_agrees_with_ppg_tpu():
    """cbox-improved's settings at 32x32, 127 spp: the port trains the
    fraction (opt_var moves), and its inverse-variance image passes the
    gates against ppg_tpu's."""
    sc = mini_cbox(res=32, budget=127, max_depth=6)
    port, img_t, img_j = _guided_pair(sc, IMPROVED, 32)
    assert len(port.stats) == 7
    assert_images_agree(img_j, img_t)
    assert float(port.sdtree.opt_var.abs().max()) > 0
    assert port.tree_stats[-1]["n_dtrees"] > 1

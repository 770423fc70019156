"""The BSDF table's slice as a whole: whole renders of mini_cbox_materials
(scene/testscenes.py; without its spheres: 12 triangles through the
sweep, a GGX roughplastic floor, a Beckmann roughconductor back wall, a
smooth plastic left wall, nee never), the port against ppg_tpu on the
CPU. The random streams differ (threefry against the CPU generator), so
the images are compared by the gates of tests/test_regen.py:29-45, the
whole-image mean within 5% and the median relative difference of 8x8
block means below 0.25, unchanged. The size is 64 x 64 in one chunk:
nee never on a small light is heavy-tailed, and at 32 x 32 with a few
spp one realisation of the port and one of ppg_tpu fall 5.5% apart in
the mean (64 spp); a 64 x 64 chunk costs a CPU little more than a
32 x 32 one, as the wavefront's launches dominate. Seeds: 1 on both
sides for the unguided renders (48 spp), 0 for the guided one (a
63-spp budget: 36 spp in the final image). Margins on the CPU: port
against ppg_tpu, means 1.6% apart with a block median of 0.123; guided
against unguided, 0.8% and 0.166. (The port's GGX floor takes Heitz's
disk basis where ppg_tpu's does not, ROADMAP Queue 3; at alpha 0.1 the
images stay within these margins.)"""

import numpy as np
import pytest
import torch

from ppg_tpu.integrators import driver as JD
from ppg_tpu.scene.testscenes import scene_from_xml as j_scene_from_xml
from ppg_tpu_torch.bsdf import microfacet as MF
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.guided import GuidedPathTracer as TTracer
from ppg_tpu_torch.scene.testscenes import (mini_cbox_materials_xml,
                                            scene_from_xml)
from test_torch_render import assert_images_agree

RES, SPP = 64, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unguided():
    """The port's unguided render of the scene (seed 1)."""
    xml = mini_cbox_materials_xml(res=RES, budget=63, spheres=False)
    sc = scene_from_xml(xml)
    img = TD.render(sc, spp=SPP, seed=1, chunk=RES * RES, device="cpu")
    assert img.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    return xml, sc, img


def test_unguided_materials_render_agrees_with_ppg_tpu(unguided):
    xml, sc, img_t = unguided
    assert sc.materials is not None and len(set(sc.materials.mtype)) == 4
    img_j = np.asarray(JD.render(j_scene_from_xml(xml), spp=SPP, seed=1,
                                 chunk=RES * RES))
    assert_images_agree(img_j, img_t)


def test_guided_materials_render_agrees_with_unguided(unguided):
    _, sc, ref = unguided
    MF.reset_counts()
    tracer = TTracer(sc, chunk=RES * RES, device="cpu")
    img = tracer.render(seed=0)
    assert [(s["passes"], s["is_final"]) for s in tracer.stats] == [
        (1, False), (2, False), (4, False), (9, True)]
    assert np.isfinite(img).all() and img.mean() > 0
    assert_images_agree(ref, img)
    # the tree was trained and used
    assert tracer.tree_stats[-1]["n_dtrees"] > 1
    assert MF.COUNTS == {"vndf_kernel": 0, "vndf_plain_on_cuda": 0}

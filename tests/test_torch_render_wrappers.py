"""The material wrappers' slice as a whole, the port against ppg_tpu: an
unguided render of mini_cbox_wrappers (scene/testscenes.py; without its
spheres: 16 triangles through the sweep, a blendbsdf floor, a GGX
roughcoating over a Beckmann roughconductor on the back wall, a coating
over the red diffuse on the left wall, a mixturebsdf on the right one,
the mask panel above the luminaire and a null rectangle facing the
camera; nee always, so every shadow ray walks through the panel and the
rectangle) through both packages on the CPU, as
tests/test_torch_render_materials.py does for the leaf table. The random
streams differ (threefry against the CPU generator), so the images are
compared by the gates of tests/test_regen.py:29-45, the whole-image
mean within 5% and the median relative difference of 8x8 block means
below 0.25, unchanged, at 64 x 64 in one chunk, 16 spp, seed 1 on both
sides. Margins on the CPU: means 1.1% apart, block median 0.115. (The
GGX surfaces take Heitz's disk basis in the port, ROADMAP Queue 3; the
nests the port composes otherwise than ppg_tpu are not in this scene.)
The guided render against the unguided one is in
tests/test_torch_wrappers.py."""

import numpy as np
import pytest
import torch

from ppg_tpu.integrators import driver as JD
from ppg_tpu.scene.testscenes import scene_from_xml as j_scene_from_xml
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators import wavefront as W
from ppg_tpu_torch.scene.testscenes import (mini_cbox_wrappers_xml,
                                            scene_from_xml)
from test_torch_render import assert_images_agree

RES, SPP = 64, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_unguided_wrappers_render_agrees_with_ppg_tpu():
    xml = mini_cbox_wrappers_xml(res=RES, nee="always", spheres=False)
    sc = scene_from_xml(xml)
    # every wrapper: mask, null, blend, coating, roughcoating
    assert {8, 9, 14, 15, 16} <= set(sc.materials.mtype)
    W.reset_counts()
    img_t = TD.render(sc, spp=SPP, seed=1, chunk=RES * RES, device="cpu")
    assert img_t.shape == (RES, RES, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    # one shadow walk a bounce (maxDepth 6: 5 bounces), each crossing
    # the panel or the rectangle on some lanes
    assert W.WALK_COUNTS["walks"] == 5 * SPP
    assert W.WALK_COUNTS["crossings"] > W.WALK_COUNTS["walks"]
    img_j = np.asarray(JD.render(j_scene_from_xml(xml), spp=SPP, seed=1,
                                 chunk=RES * RES))
    assert_images_agree(img_j, img_t)

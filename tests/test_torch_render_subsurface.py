"""The subsurface slice as a whole on the CPU: renders through the port
and through ppg_tpu under the gates of tests/test_regen.py:29-45
(test_torch_render.assert_images_agree: whole-image means within 5%, the
median relative difference of 8x8 block means below 0.25). The random
streams differ (threefry against the CPU generator), hence the gates.

- tests/test_subsurface.py's dipole sphere under a constant sky and
  tests/test_singlescatter.py's cube under a point light (16 x 16, 32
  spp): the port's driver.render against ppg_tpu's, and those tests' own
  checks on the port (the sphere's centre glows above 0.05, the cube's
  face above 1e-3 with the light at 30).
- A guided render of mini_cbox holding a dipole cube of marble at scale
  1 (a 256-point cloud), stopped after its first iteration's checkpoint
  and resumed, repeats the whole render bit for bit: the point cloud and
  its irradiance are built again from their own seed.

The guided renders of the translucent box are in
tests/test_torch_render_translucent.py.
"""

import os

import numpy as np
import pytest
import torch

from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.testscenes import (MINI_CBOX, light_down,
                                            mini_cbox_translucent_xml,
                                            scene_from_xml)
from test_singlescatter import CUBE_SS_XML
from test_torch_render import assert_images_agree
from test_torch_render_media import _both
from test_torch_subsurface import _DIPOLE_XML

# a dipole cube of Jensen's marble at scale 1 (about 90 blue-noise
# points, padded to one tile)
DIPOLE_CUBE = """  <shape type="cube">
    <transform name="toWorld"><scale value="0.25"/>
      <translate x="-0.4" y="0.25" z="0.2"/></transform>
    <subsurface type="dipole">
      <string name="material" value="marble"/>
      <float name="scale" value="1"/>
    </subsurface>
    <bsdf type="plastic"><rgb name="diffuseReflectance" value="0, 0, 0"/></bsdf>
  </shape>
</scene>"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hidden(xml):
    """The scene with hideEmitters: the luminaire, which light_down turns
    to the camera, is not seen directly (its jittered edges would
    dominate a small image's noise)."""
    old = '<integer name="rrDepth"'
    assert xml.count(old) == 1
    return xml.replace(old, '<boolean name="hideEmitters" value="true"/>'
                       + old)


def box(res, budget, max_depth=4, dipole=False):
    """The small translucent box (mini_cbox_translucent_xml without its
    sphere), or with `dipole` mini_cbox, its luminaire facing the floor,
    holding DIPOLE_CUBE alone; both with hidden emitters."""
    if not dipole:
        return hidden(mini_cbox_translucent_xml(
            res=res, budget=budget, max_depth=max_depth, nee="always",
            sphere=False))
    return hidden(light_down(MINI_CBOX.format(
        res=res, budget=budget, max_depth=max_depth,
        nee="always"))).replace("</scene>", DIPOLE_CUBE)


@pytest.mark.parametrize("kind", ["dipole", "singlescatter"])
def test_renders_agree_with_ppg_tpu(kind):
    xml = (_DIPOLE_XML.format(extra="") if kind == "dipole"
           else CUBE_SS_XML.replace('value="10"', 'value="30"'))
    cfg = TD.make_config(scene_from_xml(xml), guiding=False)
    assert (cfg.has_subsurf, cfg.has_sss) == (kind == "dipole",
                                              kind != "dipole")
    img_t, img_j = _both(xml, 32)
    assert_images_agree(img_j, img_t)
    if kind == "dipole":
        # the translucent sphere glows: its pixels carry subsurface energy
        assert img_t[6:10, 6:10].mean() > 0.05
    else:
        # the cube's face glows with interior single scattering
        assert img_t[4:12, 4:12].mean() > 1e-3


class Abort(Exception):
    pass


def test_resumed_render_repeats(tmp_path):
    xml = box(8, 12, dipole=True)
    whole = GuidedPathTracer(scene_from_xml(xml), chunk=64, device="cpu")
    ref = whole.render(seed=3)
    ck = str(tmp_path / "r.ckpt")
    tr = GuidedPathTracer(scene_from_xml(xml), chunk=64, device="cpu")
    save = tr._save_checkpoint
    calls = []

    def save_and_abort(path, state):
        save(path, state)
        calls.append(state["it"])
        raise Abort()

    tr._save_checkpoint = save_and_abort
    with pytest.raises(Abort):
        tr.render(seed=3, checkpoint=ck)
    assert calls == [1] and os.path.exists(ck)
    tr2 = GuidedPathTracer(scene_from_xml(xml), chunk=64, device="cpu")
    out = tr2.render(seed=3, checkpoint=ck)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert len(tr2.tree_stats) == len(whole.tree_stats) - 1 >= 1

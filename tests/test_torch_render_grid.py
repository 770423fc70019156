"""Grid media on the CPU, beside tests/test_torch_render_media.py (its
slab and gates, test_torch_render.assert_images_agree):

- A grid medium of Gaussian puffs (scene/testscenes.py::puff_grid, 8^3,
  scale 3, HG g 0.5) in the slab with nee always: Woodcock tracking on
  the bounces and ratio tracking on the shadow rays, against ppg_tpu
  (32 spp).
- tests/test_hetero_media.py's constant grid (a 4^3 grid of 0.35, scale
  2, HG g 0.3) against its homogeneous twin (sigma_t 0.7), both through
  the port at 64 spp: that test's gate on the centre block (within 6%
  plus 0.02), and the whole-image gates.
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.io.vol import write_vol
from ppg_tpu_torch.scene.testscenes import scene_from_xml
from test_torch_render import assert_images_agree
from test_torch_render_media import _SLAB, _both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_grid_slab_nee_always_agrees_with_ppg_tpu(tmp_path):
    """A grid medium (an 8^3 grid of Gaussian puffs, scale 3, HG g 0.5)
    in the slab with nee always: Woodcock tracking on the bounces and
    ratio tracking on the shadow rays, against ppg_tpu (32 spp; margins
    on the CPU: means 1.0% apart, block median 0.064)."""
    from ppg_tpu_torch.scene.testscenes import puff_grid

    vol = str(tmp_path / "puffs.vol")
    write_vol(vol, puff_grid(8, 3), [-1.0] * 3, [1.0] * 3)
    het = f"""<medium name="interior" type="heterogeneous">
  <volume name="density" type="gridvolume">
   <string name="filename" value="{vol}"/></volume>
  <volume name="albedo" type="constvolume">
   <rgb name="value" value="0.8, 0.7, 0.6"/></volume>
  <float name="scale" value="3.0"/>
  <phase type="hg"><float name="g" value="0.5"/></phase>
 </medium>"""
    img_t, img_j = _both(_SLAB.format(nee="always", medium=het), 32)
    assert_images_agree(img_j, img_t)


def test_constant_grid_matches_homogeneous_twin(tmp_path):
    vol = str(tmp_path / "const.vol")
    write_vol(vol, np.full((4, 4, 4), 0.35, np.float32), [-1.5] * 3,
              [1.5] * 3)
    het = f"""<medium name="interior" type="heterogeneous">
  <volume name="density" type="gridvolume">
   <string name="filename" value="{vol}"/></volume>
  <volume name="albedo" type="constvolume">
   <rgb name="value" value="0.7, 0.7, 0.7"/></volume>
  <float name="scale" value="2.0"/>
  <phase type="hg"><float name="g" value="0.3"/></phase>
 </medium>"""
    hom = """<medium name="interior" type="homogeneous">
  <rgb name="sigmaT" value="0.7, 0.7, 0.7"/>
  <rgb name="albedo" value="0.7, 0.7, 0.7"/>
  <phase type="hg"><float name="g" value="0.3"/></phase>
 </medium>"""
    scenes = [scene_from_xml(_SLAB.format(nee="never", medium=m))
              for m in (het, hom)]
    assert TD.make_config(scenes[0]).has_hetero
    assert not TD.make_config(scenes[1]).has_hetero
    ih, io_ = (TD.render(sc, spp=64, seed=s, chunk=576, device="cpu")
               for s, sc in enumerate(scenes))
    a, b = ih[8:16, 8:16].mean(), io_[8:16, 8:16].mean()
    assert abs(a - b) < 0.06 * b + 0.02, (a, b)
    assert np.isfinite(ih).all()
    assert_images_agree(io_, ih)

"""The media slice as a whole on the CPU: renders through the port and
through ppg_tpu, under the gates of tests/test_regen.py:29-45 (whole-image
means within 5%, the median relative difference of 8x8 block means below
0.25; test_torch_render.assert_images_agree). The random streams differ
(threefry against the CPU generator and K11's counter hash), hence the
gates.

- tests/test_media.py's slab (_SLAB: a null cube of homogeneous medium
  in front of an area light, 24 x 24, maxDepth 6, nee never), absorbing
  (sigma_a 0.7) and scattering (sigma_s 0.8), 32 spp, against ppg_tpu;
  and that test's Beer-Lambert and dimming checks on the port.
- The scattering slab with nee always, whose shadow rays cross the
  cube's null faces through the walk's medium transmittance, against
  ppg_tpu (48 spp).

Grid media are in tests/test_torch_render_grid.py, the phase kinds and
the guided smoke box in tests/test_torch_render_phases.py (each file
about 35-50 s alone); subsurface scenes in
tests/test_torch_render_subsurface.py.
"""

import numpy as np
import pytest
import torch

from ppg_tpu.integrators import driver as JD
from ppg_tpu.scene.testscenes import scene_from_xml as j_scene_from_xml
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.io.vol import write_vol
from ppg_tpu_torch.scene.testscenes import scene_from_xml
from test_torch_render import assert_images_agree

_SLAB = """<scene version="0.5.0">
<integrator type="path"><integer name="maxDepth" value="6"/>
 <string name="nee" value="{nee}"/></integrator>
<sensor type="perspective"><float name="fov" value="40"/>
 <transform name="toWorld">
  <lookat origin="0, 0, 4" target="0, 0, 0" up="0, 1, 0"/></transform>
 <sampler type="independent"><integer name="sampleCount" value="16"/></sampler>
 <film type="hdrfilm"><integer name="width" value="24"/>
  <integer name="height" value="24"/><rfilter type="box"/></film></sensor>
<shape type="cube">
 <bsdf type="null"/>
 {medium}
</shape>
<shape type="rectangle"><transform name="toWorld">
  <translate z="-2"/></transform>
 <emitter type="area"><rgb name="radiance" value="5, 5, 5"/></emitter>
 <bsdf type="diffuse"/></shape>
</scene>"""


def _homogeneous(sa, ss):
    return f"""<medium name="interior" type="homogeneous">
  <rgb name="sigmaA" value="{sa}, {sa}, {sa}"/>
  <rgb name="sigmaS" value="{ss}, {ss}, {ss}"/>
 </medium>"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(xml, spp, seed=1):
    """The port's and ppg_tpu's unguided renders of one scene, one chunk."""
    sc = scene_from_xml(xml)
    n = sc.film["width"] * sc.film["height"]
    img_t = TD.render(sc, spp=spp, seed=seed, chunk=n, device="cpu")
    img_j = np.asarray(JD.render(j_scene_from_xml(xml), spp=spp, seed=seed,
                                 chunk=n))
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    return img_t, img_j


@pytest.mark.parametrize("sa,ss", [(0.7, 0.0), (0.0, 0.8)],
                         ids=["absorbing", "scattering"])
def test_slab_renders_agree_with_ppg_tpu(sa, ss):
    xml = _SLAB.format(nee="never", medium=_homogeneous(sa, ss))
    assert TD.make_config(scene_from_xml(xml)).has_media
    img_t, img_j = _both(xml, 32)
    assert_images_agree(img_j, img_t)


def test_slab_attenuates_and_scattering_dims():
    """tests/test_media.py's TestMediumRender on the port: the emitter
    seen through an absorber of sigma_a 0.7 over the cube's side of 2
    within 12% of exp(-1.4); scattering dims the emitter seen through the
    cube and adds no energy."""
    render = lambda sa, ss, spp: TD.render(
        scene_from_xml(_SLAB.format(nee="never",
                                    medium=_homogeneous(sa, ss))),
        spp=spp, seed=0, chunk=576, device="cpu")
    clear, foggy = render(0.0, 0.0, 64), render(0.7, 0.0, 64)
    c, f = clear[10:14, 10:14, 0].mean(), foggy[10:14, 10:14, 0].mean()
    assert abs(c - 5.0) / 5.0 < 0.05
    assert abs(f / c - np.exp(-1.4)) / np.exp(-1.4) < 0.12
    scat = render(0.0, 0.8, 32)
    assert scat[12, 12, 0] < clear[12, 12, 0]
    assert scat.mean() <= clear.mean() * 1.05


def test_slab_nee_always_agrees_with_ppg_tpu():
    xml = _SLAB.format(nee="always", medium=_homogeneous(0.2, 0.8))
    img_t, img_j = _both(xml, 48)
    assert_images_agree(img_j, img_t)

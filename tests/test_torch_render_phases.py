"""The media slice on the CPU, continued from
tests/test_torch_render_media.py (the same gates,
test_torch_render.assert_images_agree):

- The phase kinds in one scene under a constant environment and an area
  light, nee always: tests/test_microflake.py's homogeneous microflake
  sphere beside a Rayleigh cube and a Kajiya-Kay cube, 24 x 24, 32 spp,
  against ppg_tpu.
- A guided render of the smoke box (scene/testscenes.py::
  mini_cbox_smoke_xml at 32 x 32 with a 16^3 grid, nee always, a 15-spp
  budget; the tracer records vertices) against the port's unguided
  render at 16 spp (margins on the CPU, two seeds: means 0.9% and 2.2%
  apart, block medians 0.019 and 0.038); and no
  training record (bsdf vertex or NEE record) made inside the smoke,
  where only medium events can be, is valid, though such records exist.
"""

import tempfile

import numpy as np
import pytest
import torch

from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.testscenes import scene_from_xml
from test_torch_render import assert_images_agree
from test_torch_render_media import _both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PHASES = """<scene version="0.5.0">
  <integrator type="volpath"><integer name="maxDepth" value="6"/>
    <string name="nee" value="always"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="60"/>
    <transform name="toWorld">
      <lookat origin="0,0,-4" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="24"/><integer name="height" value="24"/>
      <rfilter type="box"/>
    </film>
    <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
  </sensor>
  <shape type="sphere">
    <float name="radius" value="1.2"/>
    <medium name="interior" type="homogeneous">
      <rgb name="sigmaT" value="1.5,1.5,1.5"/>
      <rgb name="albedo" value="0.9,0.9,0.9"/>
      <phase type="microflake"><float name="stddev" value="0.2"/></phase>
    </medium>
    <bsdf type="null"/>
  </shape>
  <shape type="cube">
    <transform name="toWorld"><scale value="0.5"/>
      <translate x="-1.6" y="1.2"/></transform>
    <medium name="interior" type="homogeneous">
      <rgb name="sigmaT" value="0.8,1.6,3.2"/>
      <rgb name="albedo" value="0.95,0.95,0.95"/>
      <phase type="rayleigh"/>
    </medium>
    <bsdf type="null"/>
  </shape>
  <shape type="cube">
    <transform name="toWorld"><scale value="0.5"/>
      <translate x="1.6" y="-1.2"/></transform>
    <medium name="interior" type="homogeneous">
      <rgb name="sigmaT" value="2,2,2"/>
      <rgb name="albedo" value="0.9,0.9,0.9"/>
      <vector name="orientation" x="1" y="1" z="0"/>
      <phase type="kkay"><float name="ks" value="0.6"/>
        <float name="kd" value="0.2"/><float name="exponent" value="8"/>
      </phase>
    </medium>
    <bsdf type="null"/>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.8,0.9,1.0"/></emitter>
  <shape type="rectangle"><transform name="toWorld"><scale value="0.5"/>
      <rotate x="1" angle="90"/><translate y="2.5"/></transform>
    <emitter type="area"><rgb name="radiance" value="6, 6, 6"/></emitter>
    <bsdf type="diffuse"/></shape>
</scene>
"""


def test_phase_kinds_render_agrees_with_ppg_tpu():
    sc = scene_from_xml(_PHASES)
    assert sorted(m["g"] for m in sc.media) == [2.0, 3.0, 5.0]
    img_t, img_j = _both(_PHASES, 32)
    assert_images_agree(img_j, img_t)


@pytest.fixture(scope="module")
def guided_smoke():
    """The smoke box's guided render, with the points and valid flags of
    every training record the tracer resolves splat targets for."""
    from ppg_tpu_torch.guiding import sdtree as G
    from ppg_tpu_torch.scene.testscenes import mini_cbox_smoke_xml

    with tempfile.TemporaryDirectory() as tmp:
        sc = scene_from_xml(mini_cbox_smoke_xml(
            tmp, res=32, budget=15, max_depth=6, nee="always", grid_res=16))
    seen, targets = [], G.splat_targets

    def kept(sdtree, dtree_id, d, valid, *args, p_rec=None, **kw):
        seen.append((p_rec.numpy().copy(), valid.numpy().copy()))
        return targets(sdtree, dtree_id, d, valid, *args, p_rec=p_rec, **kw)
    G.splat_targets = kept
    try:
        tracer = GuidedPathTracer(sc, chunk=32 * 32, device="cpu")
        img = tracer.render(seed=0)
    finally:
        G.splat_targets = targets
    return sc, tracer, img, seen


def test_guided_smoke_render_agrees_with_unguided(guided_smoke):
    sc, tracer, img, _ = guided_smoke
    assert tracer.base_cfg.has_hetero and tracer.base_cfg.record_vertices
    assert tracer.stats[-1]["is_final"]
    ref = TD.render(sc, spp=16, seed=2, chunk=32 * 32, device="cpu")
    assert_images_agree(ref, img)


def test_no_medium_vertex_is_valid(guided_smoke):
    from ppg_tpu_torch.scene.testscenes import SMOKE_CENTER, SMOKE_HALF

    p = np.concatenate([s[0] for s in guided_smoke[3]])
    valid = np.concatenate([s[1] for s in guided_smoke[3]])
    # strictly inside the smoke's cube: a medium event (no surface there)
    inside = (np.abs(p - np.asarray(SMOKE_CENTER))
              < SMOKE_HALF - 1e-3).all(-1)
    assert inside.sum() > 100
    assert not valid[inside].any() and valid[~inside].any()

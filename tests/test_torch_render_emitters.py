"""The emitters' slice as a whole on the CPU.

- The sky box (scene/testscenes.py::mini_cbox_sky_xml: mini_cbox open to
  a sunsky through its front, a spot and a point light beside its area
  luminaire; four NEE slots; a 512 x 256 map here) and its directional
  companion (sunRadiusScale 0: the sky dome and a directional sun, five
  slots), rendered unguided through both packages at 32 x 32, 16 spp,
  seed 1, one chunk, nee always: the gates of tests/test_regen.py:29-45
  (means within 5%, the median relative difference of 8x8 block means
  below 0.25), unchanged. The random streams differ (threefry against
  the CPU generator), hence the gates. (The spot's transition band is
  Mitsuba's falloff in the port, ppg_tpu's otherwise: a few percent of
  the spot's light in a band of the floor.)
- The port's guided renders of both against its unguided ones at 32 x
  32, the same gates: the sky box with a 31-spp budget (its final image
  16 spp), the companion with 15 (8 spp), each against 32 unguided spp.
- A camera that sees the sky: the environment's radiance reaches the
  misses of the camera segment unless hideEmitters is set.
- Every environment type (an envmap from an EXR file, constant, sky,
  sun, sunsky) through DeviceScene.from_scene and trace_paths at 8 x 8:
  finite and lit.
- ppg_tpu's tests/test_delta_emitters.py, test_sun_directional.py and
  test_blend.py, and test_coating_e2e.py's analytic renders, on the port:
  a point light's inverse square, a directional light's irradiance, a
  spot's beam and cutoff on a diffuse plane; a zero-radius sun against
  the disk sun on a ground plane; blendbsdf and mixturebsdf under a
  head-on directional light against their albedo mixtures; a coated
  diffuse against Weidlich-Wilkie's normal-incidence albedo, a tinted
  coat's absorption, a near-smooth roughcoating against the smooth
  coating, an hk slab against its single-scattering albedo, and a guided
  roughcoating render against the unguided one. Their tolerances are the
  reference tests'.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from ppg_tpu.integrators import driver as JD
from ppg_tpu.scene.testscenes import scene_from_xml as j_scene_from_xml
from ppg_tpu_torch.emitters import envmap as EV
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.scene import load_scene
from ppg_tpu_torch.scene.testscenes import mini_cbox_sky_xml, scene_from_xml
from test_torch_render import assert_images_agree

RES, SPP = 32, 16
SKY_RES = 512


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[False, True],
                ids=["sky box", "directional companion"])
def sky(request):
    xml = mini_cbox_sky_xml(res=RES, budget=31 if not request.param else 15,
                            nee="always", resolution=SKY_RES,
                            directional_sun=request.param)
    return request.param, xml, scene_from_xml(xml)


def test_unguided_sky_render_agrees_with_ppg_tpu(sky):
    directional, xml, sc = sky
    cfg = TD.make_config(sc, guiding=False)
    assert cfg.has_env and cfg.do_nee
    assert len(sc.delta_emitters) == 2 + directional
    img_t = TD.render(sc, spp=SPP, seed=1, chunk=RES * RES, device="cpu")
    assert img_t.shape == (RES, RES, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    img_j = np.asarray(JD.render(j_scene_from_xml(xml), spp=SPP, seed=1,
                                 chunk=RES * RES))
    assert_images_agree(img_j, img_t)


def test_guided_sky_render_agrees_with_unguided(sky):
    directional, _, sc = sky
    tracer = GuidedPathTracer(sc, chunk=RES * RES, device="cpu")
    img = tracer.render(seed=0)
    assert tracer.stats[-1]["is_final"]
    ref = TD.render(sc, spp=32, seed=2, chunk=RES * RES, device="cpu")
    assert_images_agree(ref, img)


def test_camera_sees_the_sky():
    xml = mini_cbox_sky_xml(res=16, nee="always", resolution=64).replace(
        '<lookAt origin="0, 1, -3.5"', '<lookAt origin="0, 1, -6.5"')
    sc = scene_from_xml(xml)
    img = TD.render(sc, spp=1, seed=0, chunk=256, device="cpu")
    hidden = TD.render(sc, spp=1, seed=0, chunk=256, device="cpu",
                       cfg=TD.make_config(sc, guiding=False,
                                          hide_emitters=True))
    # the corner pixels miss the box: the sky's radiance, or nothing
    env = EV.EnvmapArrays.from_image(
        EV.env_image(sc.env_emitter, "."), np.eye(3), sc.aabb_min,
        sc.aabb_max, "cpu")
    assert img[0, 0].min() > 0 and hidden[0, 0].max() == 0
    assert img[0, 0].max() < float(env.img_flat.max())


@pytest.mark.parametrize("kind", ["envmap", "constant", "sky", "sun",
                                  "sunsky"])
def test_every_environment_kind_renders(kind, tmp_path):
    """Each environment emitter type through DeviceScene.from_scene and
    trace_paths (the envmap an EXR written with the port's io/exr.py),
    rendered at 8 x 8 through the open box: finite, and lit."""
    from ppg_tpu_torch.io import exr

    exr.write(str(tmp_path / "sky.exr"), np.random.default_rng(0).random(
        (8, 16, 3)).astype(np.float32) + 0.1)
    emitter = {
        "envmap": '<string name="filename" value="sky.exr"/>',
        "constant": '<rgb name="radiance" value="0.5, 0.6, 0.7"/>',
        "sky": '<integer name="resolution" value="64"/>',
        "sun": '<vector name="sunDirection" x="0" y="0.5" z="-1"/>'
               '<integer name="resolution" value="64"/>',
        "sunsky": '<vector name="sunDirection" x="0" y="0.5" z="-1"/>'
                  '<integer name="resolution" value="64"/>'}[kind]
    # the box open to the sky alone: its luminaire and this emitter
    head = mini_cbox_sky_xml(res=8, nee="always").split(
        '<emitter type="sunsky"')[0]
    xml = head + f'<emitter type="{kind}">{emitter}</emitter>\n</scene>'
    path = tmp_path / "scene.xml"
    path.write_text(xml)
    sc = load_scene(str(path))
    assert sc.env_emitter.otype == kind and not sc.delta_emitters
    img = TD.render(sc, spp=2, seed=0, chunk=64, device="cpu")
    assert np.isfinite(img).all() and img.mean() > 0


# ppg_tpu's tests of the delta emitters and the sun, on the port

_PLANE = """<scene version="0.5.0">
<integrator type="path"><integer name="maxDepth" value="2"/></integrator>
<sensor type="perspective"><float name="fov" value="{fov}"/>
 <transform name="toWorld">
  <lookat origin="{origin}" target="0, 0, 0" up="0, 1, 0"/></transform>
 <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
 <film type="hdrfilm"><integer name="width" value="{res}"/>
  <integer name="height" value="{res}"/><rfilter type="box"/></film></sensor>
<shape type="rectangle"><transform name="toWorld">
  <rotate x="1" angle="-90"/><scale value="{scale}"/></transform>
 {bsdf}</shape>
{emitter}
</scene>"""


def _render(emitter, spp, bsdf='<bsdf type="diffuse"><rgb name="reflectance" '
            'value="0.8, 0.8, 0.8"/></bsdf>', fov=60, origin="0, 1.5, 3",
            res=32, scale=5, check=None, **cfg_over):
    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(_PLANE.format(emitter=emitter, bsdf=bsdf, fov=fov,
                              origin=origin, res=res, scale=scale))
        path = f.name
    try:
        sc = load_scene(path)
        cfg = TD.make_config(sc, guiding=False, do_nee=True, **cfg_over)
        if check is not None:
            check(sc, cfg)
        return TD.render(sc, spp=spp, chunk=res * res, cfg=cfg, device="cpu")
    finally:
        os.unlink(path)


def _center_hit():
    o = np.array([0, 1.5, 3.0])
    d = -o / np.linalg.norm(o)
    return o + (-o[1] / d[1]) * d


def test_point_inverse_square():
    img = _render('<emitter type="point">'
                  '<point name="position" x="0" y="2" z="0"/>'
                  '<rgb name="intensity" value="10, 10, 10"/></emitter>', 48)
    dl = np.array([0, 2, 0.0]) - _center_hit()
    d2 = (dl * dl).sum()
    analytic = 0.8 / np.pi * 10.0 * (dl / np.sqrt(d2))[1] / d2
    assert abs(img[16, 16, 0] - analytic) / analytic < 0.05


def test_directional_irradiance():
    img = _render('<emitter type="directional">'
                  '<vector name="direction" x="0" y="-1" z="0"/>'
                  '<rgb name="irradiance" value="3, 3, 3"/></emitter>', 48)
    analytic = 0.8 / np.pi * 3.0
    assert abs(img[16, 16, 0] - analytic) / analytic < 0.05


def test_spot_beam_and_falloff():
    img = _render(
        '<emitter type="spot"><transform name="toWorld">'
        '<lookat origin="0, 2, 0" target="0, 0, 0" up="1, 0, 0"/></transform>'
        '<float name="cutoffAngle" value="60"/>'
        '<float name="beamWidth" value="50"/>'
        '<rgb name="intensity" value="10, 10, 10"/></emitter>', 48)
    dl = np.array([0, 2, 0.0]) - _center_hit()
    d2 = (dl * dl).sum()
    # the centre hit is about 18 degrees off the axis: inside the beam
    analytic = 0.8 / np.pi * 10.0 * (dl / np.sqrt(d2))[1] / d2
    assert abs(img[16, 16, 0] - analytic) / analytic < 0.06
    assert img[0, 0].max() < analytic * 0.5  # beyond the cutoff


_SUN = ('<emitter type="sun"><float name="sunRadiusScale" value="{srs}"/>'
        '<float name="turbidity" value="3"/>'
        '<float name="elevation" value="60"/></emitter>')


def test_directional_sun_matches_disk_sun():
    def flattened(sc, cfg):
        assert not cfg.has_env and sc.delta_emitters

    kw = dict(bsdf='<bsdf type="diffuse"><rgb name="reflectance" '
              'value="0.6, 0.6, 0.6"/></bsdf>', fov=45,
              origin="0, 3, 0.001", res=16, scale=50)
    disk = _render(_SUN.format(srs=1.0), 96, **kw)
    direc = _render(_SUN.format(srs=0.0), 16, check=flattened, **kw)
    a, b = disk[8, 8], direc[8, 8]
    assert np.isfinite(b).all() and b.mean() > 0
    assert (np.abs(a - b) / np.maximum(b, 1e-9)).max() < 0.08, (a, b)


# ppg_tpu's test_blend.py and test_coating_e2e.py on the port: a head-on
# directional light of irradiance pi on a 2 x 2 plane

_HEAD_ON = ('<emitter type="directional"><vector name="direction" x="0" '
            'y="-1" z="0"/><rgb name="irradiance" '
            'value="3.14159265, 3.14159265, 3.14159265"/></emitter>')


def _head_on(bsdf, spp=128, origin="0, 3, 0.001", **cfg_over):
    return _render(_HEAD_ON, spp, bsdf=bsdf, fov=45, origin=origin, res=24,
                   scale=2, **cfg_over)


def _diffuse(rgb):
    return (f'<bsdf type="diffuse"><rgb name="reflectance" value="{rgb}"/>'
            '</bsdf>')


def test_blendbsdf_analytic():
    c = _head_on('<bsdf type="blendbsdf"><float name="weight" value="0.25"/>'
                 + _diffuse("0.8, 0, 0") + _diffuse("0, 0, 0.8") + '</bsdf>',
                 origin="0, 2, 2.5")[12, 12]
    assert abs(c[0] - 0.6) < 0.04 and abs(c[2] - 0.2) < 0.03 and c[1] < 0.01


def test_mixturebsdf_analytic():
    c = _head_on('<bsdf type="mixturebsdf"><string name="weights" '
                 'value="0.5, 0.5"/>' + _diffuse("0.8, 0, 0")
                 + _diffuse("0, 0.8, 0") + '</bsdf>',
                 origin="0, 2, 2.5")[12, 12]
    assert abs(c[0] - 0.4) < 0.04 and abs(c[1] - 0.4) < 0.04


def _fresnel(c, eta):
    ct = np.sqrt(max(1.0 - (1.0 - c * c) / (eta * eta), 0.0))
    rs = (c - eta * ct) / (c + eta * ct)
    rp = (eta * c - ct) / (eta * c + ct)
    return 0.5 * (rs * rs + rp * rp)


def _coating(nested, extra=""):
    return f'<bsdf type="coating">{extra}{nested}</bsdf>'


def test_coating_diffuse_analytic():
    c = _head_on(_coating(_diffuse("0.8, 0.6, 0.4")))[12, 12]
    eta = 1.5046 / 1.000277
    expect = (np.array([0.8, 0.6, 0.4]) * (1 - _fresnel(1.0, eta)) ** 2
              / eta ** 2)
    assert np.all(np.abs(c - expect) < 0.05 * expect + 0.01), (c, expect)


def test_coating_absorption():
    base = _head_on(_coating(_diffuse("0.8, 0.8, 0.8")))
    tinted = _head_on(_coating(
        _diffuse("0.8, 0.8, 0.8"), '<rgb name="sigmaA" value="0.2, 0.5, 1.0"/>'
        '<float name="thickness" value="1.0"/>'))
    ratio = tinted[12, 12] / np.maximum(base[12, 12], 1e-9)
    expect = np.exp(-2.0 * np.array([0.2, 0.5, 1.0]))
    assert np.all(np.abs(ratio - expect) < 0.06), (ratio, expect)


def test_roughcoating_runs_close_to_smooth():
    smooth = _head_on(_coating(_diffuse("0.7, 0.7, 0.7")), origin="0, 2, 2")
    rough = _head_on('<bsdf type="roughcoating"><float name="alpha" '
                     'value="0.02"/>' + _diffuse("0.7, 0.7, 0.7") + '</bsdf>',
                     origin="0, 2, 2")
    a, b = smooth[12, 12].mean(), rough[12, 12].mean()
    assert abs(a - b) < 0.05 * a + 0.02, (a, b)


def test_hk_reflection_analytic():
    c = _head_on('<bsdf type="hk"><rgb name="sigmaS" value="2, 3, 4"/>'
                 '<rgb name="sigmaA" value="0.1, 0.3, 0.5"/>'
                 '<float name="thickness" value="0.4"/></bsdf>',
                 spp=256)[12, 12]
    st = np.array([2.1, 3.3, 4.5])
    expect = np.array([2, 3, 4]) / st * (1 - np.exp(-2 * st * 0.4)) / 8.0
    assert np.all(np.abs(c - expect) < 0.08 * expect + 0.005), (c, expect)


def test_coating_guided_smoke():
    bsdf = ('<bsdf type="roughcoating"><float name="alpha" value="0.15"/>'
            + _diffuse("0.6, 0.6, 0.6") + '</bsdf>')
    plain = _head_on(bsdf, spp=64, origin="0, 2, 2")
    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(_PLANE.format(emitter=_HEAD_ON, bsdf=bsdf, fov=45,
                              origin="0, 2, 2", res=24, scale=2))
        path = f.name
    try:
        sc = load_scene(path)
        sc.integrator.update(dict(type="guided_path", budgetType="spp",
                                  budget=15, sppPerPass=1, nee="always"))
        img = GuidedPathTracer(sc, chunk=576, device="cpu").render()
    finally:
        os.unlink(path)
    assert np.isfinite(img).all()
    a, b = plain[12, 12].mean(), img[12, 12].mean()
    assert abs(a - b) < 0.15 * a + 0.03, (a, b)

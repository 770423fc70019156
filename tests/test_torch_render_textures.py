"""The textures' slice as a whole on the CPU.

- The textured box (scene/testscenes.py::mini_cbox_textures_xml without
  its sphere: an EWA bitmap floor, a checkerboard back wall, a bump map
  over a GGX roughplastic, a normal map over the red diffuse, the mask
  panel with a gridtexture opacity; nee always, so every shadow ray from
  the ceiling walks the panel's textured opacity) rendered unguided
  through both packages at 64 x 64, 16 spp, seed 1, one chunk: the gates
  of tests/test_regen.py:29-45 (means within 5%, the median relative
  difference of 8x8 block means below 0.25), unchanged.
- The port's guided render of that box against its unguided one, the
  same gates, at 64 x 64 (seed 0 and a 15-spp budget against seed 1 and
  16 spp), as tests/test_torch_wrappers.py holds the wrapper box.
- The assertions of ppg_tpu's test_textures.py, test_texture_plugins.py,
  test_bump.py, test_ewa.py and test_wireframe_curvature.py on the port's
  renders of mini_cbox with the floor or a sphere textured (lit by its
  area light where those tests light with directional and constant
  emitters): a checkerboard shows both colours, a gridtexture bright
  fields and dark lines, a `scale` texture multiplies its nested colours
  (the channel ratios of a render with the scaled constant), a red PLY
  with vertex colours reflects no green or blue, a bump map on the
  ceiling changes its shading against the flat ceiling's from the same
  seed, the wireframe shows edge and
  interior colours, the curvature texture the sphere's colour; the EWA
  path runs with a perspective camera and the footprint path with an
  orthographic one.
- The same assertions under each reference test's own lighting, on the
  reference tests' own scenes, seeds, sample counts and gates:
  test_textures.py's checkerboard and gridtexture plane and
  test_texture_plugins.py's scale and vertex-colour quads under a
  directional light from above, test_bump.py's stripes under an oblique
  directional light, test_ewa.py's EWA plane and
  test_wireframe_curvature.py's wireframe sphere under a constant
  environment (K10's module on the CPU, its plain version).
- In the slow tier: the vertex-colour box lit through its ceiling, where
  a 16-spp guided render strays from the reference two to four times as
  far as an unguided one; the port's guided renders stray no further
  than ppg_tpu's.
"""

import numpy as np
import pytest
import torch

from ppg_tpu.integrators import driver as JD
from ppg_tpu.integrators.guided import GuidedPathTracer as JTracer
from ppg_tpu.scene.testscenes import scene_from_xml as j_scene_from_xml
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators import wavefront as W
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.io import exr
from ppg_tpu_torch.scene import textures as TX
from ppg_tpu_torch.scene.scene import load_scene
from ppg_tpu_torch.scene.testscenes import (MINI_CBOX,
                                            mini_cbox_texture_variant_xml,
                                            mini_cbox_textures_xml,
                                            orthographic, scene_from_xml)
from test_bump import _BUMP as BUMP_MAP
from test_bump import _FLAT as BUMP_FLAT
from test_bump import _SCENE as BUMP_SCENE
from test_ewa import _stripe_image
from test_texture_plugins import _SCENE as PLUGINS_SCENE
from test_textures import _SCENE as TEXTURES_SCENE
from test_torch_render import _blocks, assert_images_agree
from test_torch_render_improved import IMPROVED


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_unguided_textured_render_agrees_with_ppg_tpu(tmp_path):
    RES, SPP = 64, 16
    xml = mini_cbox_textures_xml(str(tmp_path), res=RES, nee="always",
                                 sphere=False)
    sc = scene_from_xml(xml)
    cfg = TD.make_config(sc, guiding=False)
    assert (cfg.has_tex, cfg.has_tex_ewa, cfg.has_tex_opacity, cfg.has_bump,
            cfg.has_mask) == (True,) * 5
    assert not cfg.has_vertexcolors and not cfg.has_wireframe
    W.reset_counts()
    img_t = TD.render(sc, spp=SPP, seed=1, chunk=RES * RES, device="cpu")
    assert img_t.shape == (RES, RES, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert W.WALK_COUNTS["crossings"] > W.WALK_COUNTS["walks"]
    img_j = np.asarray(JD.render(j_scene_from_xml(xml), spp=SPP, seed=1,
                                 chunk=RES * RES))
    assert_images_agree(img_j, img_t)


def test_guided_textured_render_agrees_with_unguided(tmp_path):
    xml = mini_cbox_textures_xml(str(tmp_path), res=64, budget=15,
                                 nee="always", sphere=False)
    sc = scene_from_xml(xml)
    tracer = GuidedPathTracer(sc, chunk=4096, device="cpu")
    img = tracer.render(seed=0)
    assert [(s["passes"], s["is_final"]) for s in tracer.stats] == [
        (1, False), (3, True)]
    ref = TD.render(sc, spp=16, seed=1, chunk=4096, device="cpu")
    assert_images_agree(ref, img)


def _floor_scene(bsdf, res=32, wall="<!-- floor -->"):
    """mini_cbox with its floor (or another wall) in `bsdf` (an XML
    element)."""
    xml = MINI_CBOX.format(res=res, budget=16, max_depth=4, nee="always")
    head, tail = xml.split(wall)
    return head + wall + tail.replace('<ref id="white"/>', bsdf, 1)


def _render(xml, spp=8, seed=0):
    sc = scene_from_xml(xml)
    return TD.render(sc, spp=spp, seed=seed, chunk=1 << 12, device="cpu")


# the floor's pixels at 32 x 32: mini_cbox's camera sees the floor below
# row 26 (the back wall's foot)
FLOOR = (slice(27, 32), slice(6, 26))


def _diffuse(texture):
    return f'<bsdf type="diffuse">{texture}</bsdf>'


def test_checkerboard_and_gridtexture():
    img = _render(_floor_scene(_diffuse(
        '<texture name="reflectance" type="checkerboard">'
        '<rgb name="color0" value="0.9, 0.1, 0.1"/>'
        '<rgb name="color1" value="0.1, 0.1, 0.9"/>'
        '<float name="uscale" value="4"/><float name="vscale" value="4"/>'
        '</texture>')))[FLOOR]
    r, b = img[..., 0], img[..., 2]
    # the light is (30, 18, 5): blue texels reflect far less of it
    assert (r > 4 * b).mean() > 0.1 and (b > 0.5 * r).mean() > 0.1
    img = _render(_floor_scene(_diffuse(
        '<texture name="reflectance" type="gridtexture">'
        '<rgb name="color0" value="0.8, 0.8, 0.8"/>'
        '<rgb name="color1" value="0.02, 0.02, 0.02"/>'
        '<float name="lineWidth" value="0.1"/>'
        '<float name="uscale" value="2"/><float name="vscale" value="2"/>'
        '</texture>'), res=64), spp=4)
    lum = img[48:64, 12:52].mean(-1)
    lit = lum[lum > 0]
    assert (lit > 0.5 * np.median(lit)).mean() > 0.4
    assert (lit < 0.2 * np.median(lit)).mean() > 0.05


def test_scale_texture_multiplies_its_nested_colours():
    scaled = _render(_floor_scene(_diffuse(
        '<texture type="scale" name="reflectance">'
        '<rgb name="scale" value="0.5, 1.0, 0.25"/>'
        '<texture type="checkerboard">'
        '<rgb name="color0" value="0.8, 0.8, 0.8"/>'
        '<rgb name="color1" value="0.8, 0.8, 0.8"/></texture>'
        '</texture>')), spp=16)[FLOOR]
    const = _render(_floor_scene(
        '<bsdf type="diffuse"><rgb name="reflectance" '
        'value="0.4, 0.8, 0.2"/></bsdf>'), spp=16)[FLOOR]
    ratio = scaled.mean((0, 1)) / const.mean((0, 1))
    np.testing.assert_allclose(ratio, 1.0, atol=0.05)


_RED_PLY = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element face 2
property list uchar int vertex_indices
end_header
-1 0.001 -1 255 0 0
1 0.001 -1 255 0 0
1 0.001 1 255 0 0
-1 0.001 1 255 0 0
3 0 2 1
3 0 3 2
"""


def test_vertexcolors_ply(tmp_path):
    xml = mini_cbox_texture_variant_xml("vertexcolors", str(tmp_path))
    (tmp_path / "quad.ply").write_text(_RED_PLY)
    sc = scene_from_xml(xml)
    assert sc.colors is not None
    cfg = TD.make_config(sc, guiding=False)
    assert cfg.has_vertexcolors and cfg.has_tex
    img = TD.render(sc, spp=8, seed=0, chunk=1 << 12, device="cpu")
    floor = img[FLOOR]
    # a reflectance of (1, 0, 0): the quad's pixels carry no green or blue
    assert floor[..., 0].mean() > 0
    assert (floor[..., 1:] == 0).all()


def test_bumpmap_modulates_shading(tmp_path):
    # ppg_tpu's sine stripes, at an amplitude that tilts the normal by up
    # to some 30 degrees (the overhead luminaire's light, unlike that
    # test's oblique directional one, falls off fast with the tilt)
    x = np.arange(64)
    h = (0.5 + 0.05 * np.sin(x * np.pi / 4.0))[None, :].repeat(64, 0)
    height = str(tmp_path / "stripes.exr")
    exr.write(height, np.repeat(h[..., None], 3, -1).astype(np.float32))
    # on the ceiling, which the luminaire lights directly (the camera sees
    # it in the top 12 rows at 64 x 64)
    ceiling = (slice(0, 11), slice(12, 52))
    flat = _render(_floor_scene(
        '<bsdf type="diffuse"><rgb name="reflectance" '
        'value="0.7, 0.7, 0.7"/></bsdf>', 64, "<!-- ceiling at y=2 -->"),
        spp=8)[ceiling]
    bumped = _render(_floor_scene(
        '<bsdf type="bumpmap"><texture name="map" type="bitmap">'
        f'<string name="filename" value="{height}"/>'
        '<float name="gamma" value="1"/></texture>'
        '<bsdf type="diffuse"><rgb name="reflectance" '
        'value="0.7, 0.7, 0.7"/></bsdf></bsdf>', 64,
        "<!-- ceiling at y=2 -->"), spp=8)[ceiling]
    # one seed: both renders draw the same numbers, so their ratio is 1
    # where the bump map does not change the shading
    lit = flat[..., 0] > 0
    ratio = bumped[..., 0][lit] / flat[..., 0][lit]
    assert lit.mean() > 0.9 and ratio.std() > 0.1, ratio.std()
    assert abs(bumped.mean() / flat.mean() - 1.0) < 0.35


def test_wireframe_and_curvature_render(tmp_path):
    sc = scene_from_xml(mini_cbox_texture_variant_xml(
        "wireframe", str(tmp_path), res=32, nee="always"))
    cfg = TD.make_config(sc, guiding=False)
    assert cfg.has_wireframe
    img = TD.render(sc, spp=8, seed=0, chunk=1 << 12, device="cpu")
    assert np.isfinite(img).all()
    ball = img[17:28, 11:21]
    # red edges and green interiors on the sphere (lineWidth 0: 10% of
    # the scene's mean edge, most of a small triangle's area)
    assert (ball[..., 0] > 2 * ball[..., 1]).sum() >= 2
    assert (ball[..., 1] > 2 * ball[..., 0]).sum() >= 2
    sc = scene_from_xml(mini_cbox_texture_variant_xml(
        "curvature", str(tmp_path), res=32, nee="always"))
    assert TD.make_config(sc, guiding=False).has_vertexcolors
    img = TD.render(sc, spp=4, seed=0, chunk=1 << 12, device="cpu")
    ball = img[14:28, 10:22]
    # K = 4 x 0.15: red 0.6, blue 0 on the sphere
    assert ball[..., 0].mean() > 4 * ball[..., 2].mean()


def test_ewa_and_footprint_paths(tmp_path, monkeypatch):
    """The perspective camera takes the uv Jacobian on the first bounce
    (the EWA floor), the orthographic one the footprint."""
    calls = {"duv": 0, "foot": 0}
    sample = TX.sample_atlas

    def count(atlas, tid, uv, foot_uv=None, duv=None):
        calls["duv"] += duv is not None and bool(duv[0].abs().sum() > 0)
        calls["foot"] += foot_uv is not None and bool(foot_uv.sum() > 0)
        return sample(atlas, tid, uv, foot_uv, duv)

    monkeypatch.setattr(TX, "sample_atlas", count)
    xml = mini_cbox_textures_xml(str(tmp_path), res=16, sphere=False)
    img = _render(xml, spp=2)
    assert np.isfinite(img).all() and calls == {"duv": 2, "foot": 0}
    calls.update(duv=0, foot=0)
    sc = scene_from_xml(orthographic(xml))
    assert sc.sensor["type"] == "orthographic"
    img = TD.render(sc, spp=2, seed=0, chunk=1 << 12, device="cpu")
    assert np.isfinite(img).all() and img.mean() > 0
    assert calls == {"duv": 0, "foot": 2}


# ppg_tpu's texture tests under their own lights: each scene, seed (0),
# sample count, chunk and assertion as in the test named

def _render_lit(xml, tmp_path, spp, chunk, **cfg):
    """The port's unguided render of the scene `xml` (written into
    tmp_path, so that relative files resolve there) on the CPU, with
    make_config's overrides `cfg`; returns (image, scene)."""
    path = tmp_path / "scene.xml"
    path.write_text(xml)
    sc = load_scene(str(path))
    cfg = TD.make_config(sc, guiding=False, **cfg)
    return TD.render(sc, spp=spp, seed=0, chunk=chunk, cfg=cfg,
                     device="cpu"), sc


def test_checkerboard_and_gridtexture_under_their_directional_light(
        tmp_path):
    """test_textures.py:40-64: a plane under a directional light from
    above, NEE on, 32 x 32, 32 spp."""
    img, sc = _render_lit(TEXTURES_SCENE.format(texture=(
        '<texture name="reflectance" type="checkerboard">'
        '<rgb name="color0" value="0.9, 0.1, 0.1"/>'
        '<rgb name="color1" value="0.1, 0.1, 0.9"/>'
        '<float name="uscale" value="4"/><float name="vscale" value="4"/>'
        '</texture>')), tmp_path, 32, 1024, do_nee=True)
    r, b = img[..., 0], img[..., 2]
    assert (r > 2 * b).mean() > 0.1
    assert (b > 2 * r).mean() > 0.1
    img, _ = _render_lit(TEXTURES_SCENE.format(texture=(
        '<texture name="reflectance" type="gridtexture">'
        '<rgb name="color0" value="0.8, 0.8, 0.8"/>'
        '<rgb name="color1" value="0.05, 0.05, 0.05"/>'
        '<float name="lineWidth" value="0.1"/>'
        '<float name="uscale" value="4"/><float name="vscale" value="4"/>'
        '</texture>')), tmp_path, 32, 1024, do_nee=True)
    lum = img.mean(-1)
    lit = lum[lum > 0]
    assert (lit > 0.4).mean() > 0.4
    assert (lit < 0.2).mean() > 0.05


# test_texture_plugins.py:58-113's quad: red at every corner
_QUAD_PLY = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element face 2
property list uchar int vertex_indices
end_header
-2 0 -2 255 0 0
2 0 -2 255 0 0
2 0 2 255 0 0
-2 0 2 255 0 0
3 0 2 1
3 0 3 2
"""
_VERTEXCOLORS_QUAD = """<shape type="ply">
 <string name="filename" value="quad.ply"/>
 <boolean name="srgb" value="false"/>
 <bsdf type="diffuse">
  <texture type="vertexcolors" name="reflectance"/>
 </bsdf></shape>"""


def test_scale_and_vertexcolors_under_their_directional_light(tmp_path):
    """test_texture_plugins.py:39-113: a scaled checkerboard plane and a
    red vertex-coloured PLY quad seen from above under a directional
    light of irradiance pi, NEE on, 16 x 16, 64 spp: the centre pixel is
    the reflectance."""
    img, _ = _render_lit(PLUGINS_SCENE.format(shape="""<shape type="rectangle">
     <transform name="toWorld">
      <rotate x="1" angle="-90"/><scale value="2"/></transform>
     <bsdf type="diffuse">
      <texture type="scale" name="reflectance">
       <rgb name="scale" value="0.5, 1.0, 0.25"/>
       <texture type="checkerboard">
        <rgb name="color0" value="0.8, 0.8, 0.8"/>
        <rgb name="color1" value="0.8, 0.8, 0.8"/>
       </texture>
      </texture>
     </bsdf></shape>"""), tmp_path, 64, 256, do_nee=True)
    c = img[8, 8]
    expect = np.array([0.8 * 0.5, 0.8, 0.8 * 0.25])
    assert np.all(np.abs(c - expect) < 0.03), (c, expect)
    (tmp_path / "quad.ply").write_text(_QUAD_PLY)
    img, sc = _render_lit(PLUGINS_SCENE.format(shape=_VERTEXCOLORS_QUAD),
                          tmp_path, 64, 256, do_nee=True)
    assert sc.colors is not None
    c = img[8, 8]
    assert abs(c[0] - 1.0) < 0.05 and c[1] < 0.02 and c[2] < 0.02, c


def test_bumpmap_under_its_oblique_directional_light(tmp_path):
    """test_bump.py:49-70: sine stripes (an 8-bit PNG) on a plane lit
    obliquely, 32 x 32, 32 spp: far more variation than the flat plane,
    the mean within 35%."""
    from PIL import Image

    x = np.arange(64)
    h = (0.5 + 0.5 * np.sin(x * np.pi / 4.0))[None, :].repeat(64, 0)
    Image.fromarray((h * 255).astype(np.uint8)).save(tmp_path / "h.png")
    flat, _ = _render_lit(BUMP_SCENE.format(bsdf=BUMP_FLAT), tmp_path, 32,
                          1024, do_nee=True)
    bump, sc = _render_lit(BUMP_SCENE.format(bsdf=BUMP_MAP.format(
        tex=tmp_path / "h.png")), tmp_path, 32, 1024, do_nee=True)
    assert (np.asarray(sc.materials.tex_bump) >= 0).any()
    f_var = flat[8:24, 8:24, 0].std()
    b_var = bump[8:24, 8:24, 0].std()
    assert b_var > 3 * max(f_var, 1e-4), (f_var, b_var)
    assert abs(bump.mean() / flat.mean() - 1.0) < 0.35


def test_ewa_plane_under_its_constant_emitter(tmp_path):
    """test_ewa.py:129-170: a 100 x 100 EWA-filtered stripe plane seen at
    a grazing angle under a constant environment, 32 x 24, 4 spp."""
    exr.write(str(tmp_path / "stripes.exr"), _stripe_image())
    img, sc = _render_lit("""<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="60"/>
    <transform name="toWorld">
      <lookat origin="0, 0.4, -2" target="0, 0, 1"/>
    </transform>
    <sampler type="independent"/>
    <film type="hdrfilm">
      <integer name="width" value="32"/><integer name="height" value="24"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="1"/></emitter>
  <shape type="rectangle">
    <transform name="toWorld">
      <rotate x="1" angle="-90"/><scale value="50"/>
    </transform>
    <bsdf type="diffuse">
      <texture name="reflectance" type="bitmap">
        <string name="filename" value="stripes.exr"/>
        <float name="gamma" value="1"/>
      </texture>
    </bsdf>
  </shape>
</scene>""", tmp_path, 4, 1 << 16)
    assert TD.make_config(sc, guiding=False).has_tex_ewa
    assert np.isfinite(img).all()
    assert img.mean() > 0.05


def test_wireframe_under_its_constant_emitter(tmp_path):
    """test_wireframe_curvature.py:33-65: a wireframe sphere under a
    constant environment, 32 x 32, 16 spp: red edges and green interiors
    at its centre."""
    img, sc = _render_lit("""<scene version="0.5.0">
<integrator type="path"><integer name="maxDepth" value="2"/></integrator>
<sensor type="perspective"><float name="fov" value="40"/>
 <transform name="toWorld"><lookAt origin="0,0,-3" target="0,0,0" up="0,1,0"/></transform>
 <sampler type="independent"/><film type="hdrfilm">
 <integer name="width" value="32"/><integer name="height" value="32"/>
 <rfilter type="box"/></film></sensor>
<shape type="sphere"><float name="radius" value="1"/>
 <bsdf type="diffuse"><texture name="reflectance" type="wireframe">
   <rgb name="edgeColor" value="1,0,0"/>
   <rgb name="interiorColor" value="0,1,0"/>
 </texture></bsdf></shape>
<emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
</scene>""", tmp_path, 16, 1024)
    assert TD.make_config(sc, guiding=False).has_wireframe
    assert np.isfinite(img).all()
    center = img[8:24, 8:24]
    assert center[..., 0].max() > 0.05
    assert center[..., 1].max() > 0.1


def _spread(img, ref):
    """The gates' two measures of img against ref (relative difference of
    the means, median relative difference of 8x8 block means), as
    assert_images_agree computes them."""
    mi, mr = float(img.mean()), float(ref.mean())
    bi, br = _blocks(img), _blocks(ref)
    mask = br > 0.1 * br.mean()
    return (abs(mi - mr) / mr,
            float(np.median(np.abs(bi - br)[mask] / br[mask])))


@pytest.mark.slow
def test_guided_vertexcolors_noise_matches_ppg_tpu(tmp_path):
    """The vertex-colour box with mini_cbox's luminaire facing the ceiling
    (the box lit only through its bounces; phase 16 of chip_smoke turns it
    to the floor) at 64 x 64, a 16-spp budget, maxDepth 10, nee always and
    cbox-improved's settings: the port's guided renders from seeds 0, 4
    and 5 stray from a 256-spp unguided reference no further than
    ppg_tpu's guided renders from the same seeds (classic mode), by the
    median of the block measure over the seeds, and the port's means and
    those of unguided 16-spp renders from seeds 1-3 stay within 5% of the
    reference's. Prints the measures."""
    RES, light = 64, '<scale value="0.25"/><rotate x="1" angle="90"/>'
    xml = mini_cbox_texture_variant_xml("vertexcolors", str(tmp_path),
                                        res=RES, budget=16, max_depth=10,
                                        nee="always")
    assert xml.count(light) == 1
    xml = xml.replace(light, light.replace('"90"', '"-90"'))
    sc = scene_from_xml(xml)
    ref = TD.render(sc, spp=256, seed=9, chunk=RES * RES, device="cpu")
    unguided = [_spread(TD.render(sc, spp=16, seed=k, chunk=RES * RES,
                                  device="cpu"), ref) for k in (1, 2, 3)]
    port, theirs = [], []
    jsc = j_scene_from_xml(xml)
    for k in (0, 4, 5):
        port.append(_spread(GuidedPathTracer(
            sc, chunk=RES * RES, overrides=IMPROVED,
            device="cpu").render(seed=k), ref))
        tracer = JTracer(jsc, chunk=RES * RES, overrides=IMPROVED)
        tracer.train_mode = "classic"
        theirs.append(_spread(np.asarray(tracer.render(seed=k)), ref))
    print({"unguided": unguided, "port_guided": port,
           "ppg_tpu_guided": theirs})
    assert all(m < 0.05 for m, _ in unguided + port)
    med_port = float(np.median([b for _, b in port]))
    med_theirs = float(np.median([b for _, b in theirs]))
    assert med_port < 1.25 * med_theirs, (med_port, med_theirs)

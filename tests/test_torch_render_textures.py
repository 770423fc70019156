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
from ppg_tpu_torch.scene.testscenes import (MINI_CBOX,
                                            mini_cbox_texture_variant_xml,
                                            mini_cbox_textures_xml,
                                            orthographic, scene_from_xml)
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

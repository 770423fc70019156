"""Built-in miniature test scenes (no external assets).

A rectangle-only cornell box used by tests, bench warmup, and the driver
entry points; geometry mirrors the classic cbox layout (including the
reference's upside-down luminaire) but is self-contained.

The port's own copy of ppg_tpu/scene/testscenes.py.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

MINI_CBOX = """<scene version="0.5.0">
  <integrator type="guided_path">
    <boolean name="strictNormals" value="true"/>
    <integer name="maxDepth" value="{max_depth}"/>
    <integer name="rrDepth" value="10"/>
    <string name="budgetType" value="spp"/>
    <float name="budget" value="{budget}"/>
    <string name="nee" value="{nee}"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="39.3077"/>
    <float name="nearClip" value="0.01"/>
    <float name="farClip" value="100"/>
    <transform name="toWorld">
      <lookAt origin="0, 1, -3.5" target="0, 1, -2.5" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="16"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="{res}"/>
      <integer name="height" value="{res}"/>
      <boolean name="banner" value="false"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.8, 0.8, 0.8"/></bsdf>
  <bsdf type="diffuse" id="red"><rgb name="reflectance" value="0.7, 0.05, 0.05"/></bsdf>
  <bsdf type="diffuse" id="green"><rgb name="reflectance" value="0.05, 0.7, 0.05"/></bsdf>
  <!-- floor -->
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="-90"/></transform>
    <ref id="white"/>
  </shape>
  <!-- ceiling at y=2 -->
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="90"/><translate y="2"/></transform>
    <ref id="white"/>
  </shape>
  <!-- back wall at z=1 -->
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="180"/><translate z="1" y="1"/></transform>
    <ref id="white"/>
  </shape>
  <!-- left (red) x=-1, right (green) x=1 -->
  <shape type="rectangle">
    <transform name="toWorld"><rotate y="1" angle="90"/><translate x="-1" y="1"/></transform>
    <ref id="red"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><rotate y="1" angle="-90"/><translate x="1" y="1"/></transform>
    <ref id="green"/>
  </shape>
  <!-- upward-facing luminaire inside the box (like the reference cbox) -->
  <shape type="rectangle">
    <transform name="toWorld"><scale value="0.25"/><rotate x="1" angle="-90"/><translate y="1.7"/></transform>
    <ref id="white"/>
    <emitter type="area"><rgb name="radiance" value="30, 18, 5"/></emitter>
  </shape>
</scene>
"""


def scene_from_xml(xml):
    from .scene import load_scene

    with tempfile.NamedTemporaryFile(
        "w", suffix=".xml", delete=False, dir=tempfile.gettempdir()
    ) as f:
        f.write(xml)
        path = f.name
    try:
        return load_scene(path)
    finally:
        os.unlink(path)


def mini_cbox(res=64, budget=16, max_depth=6, nee="never"):
    return scene_from_xml(MINI_CBOX.format(
        res=res, budget=budget, max_depth=max_depth, nee=nee))


# translucent panel hovering between the luminaire (y=1.7, facing up) and
# the ceiling (y=2): every NEE shadow ray from the ceiling toward the
# light crosses it, exercising the evalTransmittance null/mask walk
_PANEL = {
    "mask": """  <shape type="rectangle">
    <transform name="toWorld"><scale value="0.5"/>
      <rotate x="1" angle="-90"/><translate y="1.85"/></transform>
    <bsdf type="mask">
      <rgb name="opacity" value="{op}, {op}, {op}"/>
      <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
    </bsdf>
  </shape>
""",
    "null": """  <shape type="rectangle">
    <transform name="toWorld"><scale value="0.5"/>
      <rotate x="1" angle="-90"/><translate y="1.85"/></transform>
    <bsdf type="null"/>
  </shape>
""",
}


# a white sphere on the floor, tessellated by the loader (scene/shapes.py::
# make_sphere, 16,128 triangles): with the box, a scene above the sweep's
# 1024 triangles
_SPHERE = """  <shape type="sphere">
    <point name="center" x="0" y="0.5" z="0"/>
    <float name="radius" value="0.5"/>
    <ref id="white"/>
  </shape>
"""


def mini_cbox_sphere(res=32, budget=16, max_depth=6, nee="never"):
    """mini_cbox plus a tessellated sphere: 16,140 triangles, so every ray
    walks the BVH."""
    xml = MINI_CBOX.format(res=res, budget=budget, max_depth=max_depth,
                           nee=nee)
    return scene_from_xml(xml.replace("</scene>", _SPHERE + "</scene>"))


def mini_cbox_panel(res=48, budget=16, max_depth=6, nee="never",
                    panel="mask", opacity=0.6):
    """mini_cbox plus a mask/null panel occluding the luminaire."""
    xml = MINI_CBOX.format(res=res, budget=budget, max_depth=max_depth,
                           nee=nee)
    xml = xml.replace("</scene>",
                      _PANEL[panel].format(op=opacity) + "</scene>")
    return scene_from_xml(xml)


# mini_cbox's box and light in glossy, plastic and glass materials: the
# floor a GGX roughplastic (alpha 0.1), the back wall a Beckmann
# roughconductor (alpha 0.3, copper), the left wall a smooth plastic and,
# with the spheres, a Beckmann roughdielectric sphere (alpha 0.2) and a
# smooth dielectric one (delta lobes: the guiding bypass and eta), each
# tessellated by the loader (scene/shapes.py::make_sphere, 16,128
# triangles)
MATERIALS_BSDFS = """  <bsdf type="roughplastic" id="glossy">
    <string name="distribution" value="ggx"/>
    <float name="alpha" value="0.1"/>
    <rgb name="diffuseReflectance" value="0.8, 0.8, 0.8"/>
  </bsdf>
  <bsdf type="roughconductor" id="metal">
    <string name="distribution" value="beckmann"/>
    <float name="alpha" value="0.3"/>
  </bsdf>
  <bsdf type="plastic" id="red_plastic">
    <rgb name="diffuseReflectance" value="0.7, 0.05, 0.05"/>
  </bsdf>
"""
MATERIALS_SPHERES = """  <shape type="sphere">
    <point name="center" x="-0.45" y="0.35" z="0.25"/>
    <float name="radius" value="0.35"/>
    <bsdf type="roughdielectric">
      <string name="distribution" value="beckmann"/>
      <float name="alpha" value="0.2"/>
    </bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="0.45" y="0.35" z="-0.25"/>
    <float name="radius" value="0.35"/>
    <bsdf type="dielectric"/>
  </shape>
"""


def mini_cbox_materials_xml(res=32, budget=16, max_depth=6, nee="never",
                            spheres=True):
    """The XML of mini_cbox_materials."""
    xml = MINI_CBOX.format(res=res, budget=budget, max_depth=max_depth,
                           nee=nee)
    xml = xml.replace("  <!-- floor -->", MATERIALS_BSDFS + "  <!-- floor -->")
    for wall, ref in (("<!-- floor -->", "glossy"),
                      ("<!-- back wall at z=1 -->", "metal")):
        head, tail = xml.split(wall)
        xml = head + wall + tail.replace('<ref id="white"/>',
                                         f'<ref id="{ref}"/>', 1)
    xml = xml.replace('<translate x="-1" y="1"/></transform>\n'
                      '    <ref id="red"/>',
                      '<translate x="-1" y="1"/></transform>\n'
                      '    <ref id="red_plastic"/>')
    if spheres:
        xml = xml.replace("</scene>", MATERIALS_SPHERES + "</scene>")
    return xml


def mini_cbox_materials(res=32, budget=16, max_depth=6, nee="never",
                        spheres=True):
    """mini_cbox in glossy, plastic and glass materials: 12 triangles
    without the spheres (the sweep), 32,268 with them (the BVH walk)."""
    return scene_from_xml(mini_cbox_materials_xml(res, budget, max_depth,
                                                  nee, spheres))


# mini_cbox's box in the material wrappers: the floor a blendbsdf (weight
# 0.3) of the white diffuse and a GGX roughplastic (alpha 0.1), the back
# wall a GGX roughcoating (alpha 0.1) over a Beckmann roughconductor
# (alpha 0.3), the left wall a coating (intIOR 1.7, sigmaA (0.1, 0.2,
# 0.5), thickness 1) over the red diffuse, the right wall a mixturebsdf
# (0.5, 0.5) of the green diffuse and a GGX roughconductor (alpha 0.2),
# the mask panel (opacity 0.6) above the luminaire and a null rectangle
# facing the camera; with the spheres (make_sphere, 16,128 triangles
# each) a coating over a smooth conductor and a Beckmann roughcoating
# (alpha 0.2) over a diffuse of 0.6. `ggx=False` makes every GGX
# distribution Beckmann.
WRAPPERS_BSDFS = """  <bsdf type="blendbsdf" id="blend_floor">
    <float name="weight" value="0.3"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.8, 0.8, 0.8"/></bsdf>
    <bsdf type="roughplastic">
      <string name="distribution" value="ggx"/>
      <float name="alpha" value="0.1"/>
      <rgb name="diffuseReflectance" value="0.8, 0.8, 0.8"/>
    </bsdf>
  </bsdf>
  <bsdf type="roughcoating" id="coated_metal">
    <string name="distribution" value="ggx"/>
    <float name="alpha" value="0.1"/>
    <bsdf type="roughconductor">
      <string name="distribution" value="beckmann"/>
      <float name="alpha" value="0.3"/>
    </bsdf>
  </bsdf>
  <bsdf type="coating" id="coated_red">
    <float name="intIOR" value="1.7"/>
    <rgb name="sigmaA" value="0.1, 0.2, 0.5"/>
    <float name="thickness" value="1"/>
    <ref id="red"/>
  </bsdf>
  <bsdf type="mixturebsdf" id="mix_green">
    <string name="weights" value="0.5, 0.5"/>
    <ref id="green"/>
    <bsdf type="roughconductor">
      <string name="distribution" value="ggx"/>
      <float name="alpha" value="0.2"/>
    </bsdf>
  </bsdf>
"""
_NULL_RECT = """  <shape type="rectangle">
    <transform name="toWorld"><scale value="0.4"/><rotate y="1" angle="180"/>
      <translate x="0" y="1" z="-0.5"/></transform>
    <bsdf type="null"/>
  </shape>
"""
WRAPPERS_SPHERES = """  <shape type="sphere">
    <point name="center" x="0.45" y="0.35" z="-0.25"/>
    <float name="radius" value="0.35"/>
    <bsdf type="coating"><bsdf type="conductor"/></bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="-0.45" y="0.35" z="0.25"/>
    <float name="radius" value="0.35"/>
    <bsdf type="roughcoating">
      <string name="distribution" value="beckmann"/>
      <float name="alpha" value="0.2"/>
      <bsdf type="diffuse"><rgb name="reflectance" value="0.6, 0.6, 0.6"/></bsdf>
    </bsdf>
  </shape>
"""


def mini_cbox_wrappers_xml(res=32, budget=16, max_depth=6, nee="never",
                           spheres=True, ggx=True):
    """The XML of mini_cbox_wrappers."""
    xml = MINI_CBOX.format(res=res, budget=budget, max_depth=max_depth,
                           nee=nee)
    bsdfs = WRAPPERS_BSDFS
    if not ggx:
        bsdfs = bsdfs.replace('value="ggx"', 'value="beckmann"')
    xml = xml.replace("  <!-- floor -->", bsdfs + "  <!-- floor -->")
    for wall, ref in (("<!-- floor -->", "blend_floor"),
                      ("<!-- back wall at z=1 -->", "coated_metal")):
        head, tail = xml.split(wall)
        xml = head + wall + tail.replace('<ref id="white"/>',
                                         f'<ref id="{ref}"/>', 1)
    for side, ref, new in (('x="-1"', "red", "coated_red"),
                           ('x="1"', "green", "mix_green")):
        xml = xml.replace(f'<translate {side} y="1"/></transform>\n'
                          f'    <ref id="{ref}"/>',
                          f'<translate {side} y="1"/></transform>\n'
                          f'    <ref id="{new}"/>')
    extra = _PANEL["mask"].format(op=0.6) + _NULL_RECT
    if spheres:
        extra += WRAPPERS_SPHERES
    return xml.replace("</scene>", extra + "</scene>")


def mini_cbox_wrappers(res=32, budget=16, max_depth=6, nee="never",
                       spheres=True, ggx=True):
    """mini_cbox in the material wrappers (mask, null, blend, mixture,
    coating, roughcoating): 16 triangles without the spheres (the sweep),
    32,272 with them (the BVH walk)."""
    return scene_from_xml(mini_cbox_wrappers_xml(res, budget, max_depth,
                                                 nee, spheres, ggx))


# mini_cbox's box with textures: the floor a diffuse whose reflectance is
# a bitmap (filterType left at its default, ewa; uscale 4), the back wall a
# diffuse checkerboard (trilinear by default), the left wall a bump map
# over a GGX roughplastic (alpha 0.2), the right wall a normal map over
# the red diffuse, the mask panel above the luminaire with a gridtexture
# opacity and, with the sphere, a tessellated sphere (its own uvs; 16,128
# triangles, so every ray walks the BVH) in a diffuse whose reflectance is
# a `scale` texture over a checkerboard. The bitmaps are EXR files written
# by `write_texture_files` (no PIL needed).
TEXTURES_BSDFS = """  <bsdf type="diffuse" id="tex_floor">
    <texture name="reflectance" type="bitmap">
      <string name="filename" value="{floor}"/>
      <float name="uscale" value="4"/>
    </texture>
  </bsdf>
  <bsdf type="diffuse" id="tex_back">
    <texture name="reflectance" type="checkerboard">
      <rgb name="color0" value="0.8, 0.8, 0.8"/>
      <rgb name="color1" value="0.2, 0.3, 0.6"/>
      <float name="uscale" value="3"/>
      <float name="vscale" value="3"/>
    </texture>
  </bsdf>
  <bsdf type="bumpmap" id="tex_left">
    <texture name="map" type="bitmap">
      <string name="filename" value="{height}"/>
      <float name="gamma" value="1"/>
    </texture>
    <bsdf type="roughplastic">
      <string name="distribution" value="ggx"/>
      <float name="alpha" value="0.2"/>
      <rgb name="diffuseReflectance" value="0.7, 0.05, 0.05"/>
    </bsdf>
  </bsdf>
  <bsdf type="normalmap" id="tex_right">
    <texture name="normalmap" type="bitmap">
      <string name="filename" value="{normal}"/>
      <float name="gamma" value="1"/>
    </texture>
    <ref id="red"/>
  </bsdf>
"""
TEXTURES_PANEL = """  <shape type="rectangle">
    <transform name="toWorld"><scale value="0.5"/>
      <rotate x="1" angle="-90"/><translate y="1.85"/></transform>
    <bsdf type="mask">
      <texture name="opacity" type="gridtexture">
        <rgb name="color0" value="0.3, 0.3, 0.3"/>
        <rgb name="color1" value="0.9, 0.9, 0.9"/>
        <float name="lineWidth" value="0.08"/>
        <float name="uscale" value="4"/>
        <float name="vscale" value="4"/>
      </texture>
      <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
    </bsdf>
  </shape>
"""
TEXTURES_SPHERE = """  <shape type="sphere">
    <point name="center" x="0.35" y="0.4" z="0.2"/>
    <float name="radius" value="0.4"/>
    <bsdf type="diffuse">
      <texture name="reflectance" type="scale">
        <rgb name="scale" value="0.9, 0.7, 0.5"/>
        <texture type="checkerboard">
          <rgb name="color0" value="0.9, 0.9, 0.9"/>
          <rgb name="color1" value="0.3, 0.3, 0.3"/>
          <float name="uscale" value="8"/>
          <float name="vscale" value="4"/>
        </texture>
      </texture>
    </bsdf>
  </shape>
"""


def write_texture_files(tex_dir, floor_res=32, bump_res=32, seed=0):
    """The textured box's bitmaps as EXR files in tex_dir (made from the
    seed with numpy): floor.exr (floor_res^2: stripes and noise),
    height.exr (bump_res^2: a heightfield of waves) and normal.exr
    (bump_res^2: that heightfield's tangent-space normals encoded as
    (n + 1) / 2). Returns {name: path}."""
    import numpy as np

    from ..io import exr

    rng = np.random.default_rng(seed)
    n = floor_res
    x = (np.arange(n) + 0.5) / n
    stripes = 0.5 + 0.35 * np.sin(2 * np.pi * 6 * x)[None, :] \
        * np.cos(2 * np.pi * 2 * x)[:, None]
    floor = np.stack([stripes, 0.8 * stripes, 0.6 + 0.0 * stripes], -1)
    floor = floor + 0.15 * rng.random((n, n, 3))
    n = bump_res
    x = (np.arange(n) + 0.5) / n
    h = 0.5 + 0.25 * (np.sin(2 * np.pi * 5 * x)[None, :]
                      + np.sin(2 * np.pi * 3 * x + 1.0)[:, None])
    h = h + 0.05 * rng.random((n, n))
    gy, gx = np.gradient(h * 8.0)
    nrm = np.stack([-gx, -gy, np.ones_like(h)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    paths = {k: os.path.join(tex_dir, f"{k}.exr")
             for k in ("floor", "height", "normal")}
    exr.write(paths["floor"], floor.astype(np.float32))
    exr.write(paths["height"], np.repeat(h[..., None], 3, -1).astype(
        np.float32))
    exr.write(paths["normal"], ((nrm + 1) / 2).astype(np.float32))
    return paths


def mini_cbox_textures_xml(tex_dir, res=32, budget=16, max_depth=6,
                           nee="never", floor_res=32, bump_res=32, seed=0,
                           sphere=True):
    """The XML of the textured box (see TEXTURES_BSDFS), its bitmaps
    written into tex_dir; 14 triangles without the sphere (the sweep),
    16,142 with it (the BVH walk)."""
    paths = write_texture_files(tex_dir, floor_res, bump_res, seed)
    xml = MINI_CBOX.format(res=res, budget=budget, max_depth=max_depth,
                           nee=nee)
    xml = xml.replace("  <!-- floor -->",
                      TEXTURES_BSDFS.format(**paths) + "  <!-- floor -->")
    for wall, ref in (("<!-- floor -->", "tex_floor"),
                      ("<!-- back wall at z=1 -->", "tex_back")):
        head, tail = xml.split(wall)
        xml = head + wall + tail.replace('<ref id="white"/>',
                                         f'<ref id="{ref}"/>', 1)
    for side, ref, new in (('x="-1"', "red", "tex_left"),
                           ('x="1"', "green", "tex_right")):
        xml = xml.replace(f'<translate {side} y="1"/></transform>\n'
                          f'    <ref id="{ref}"/>',
                          f'<translate {side} y="1"/></transform>\n'
                          f'    <ref id="{new}"/>')
    extra = TEXTURES_PANEL + (TEXTURES_SPHERE if sphere else "")
    return xml.replace("</scene>", extra + "</scene>")


# the smaller textured scenes: mini_cbox with, as its floor, a quad of a
# PLY whose corners are red, green, blue and white (vertexcolors); or a
# sphere (make_sphere) in the wireframe or the gaussian curvature texture
_VC_PLY = """ply
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
1 0.001 -1 0 255 0
1 0.001 1 0 0 255
-1 0.001 1 255 255 255
3 0 2 1
3 0 3 2
"""
_VARIANT_SHAPES = {
    "vertexcolors": """  <shape type="ply">
    <string name="filename" value="{ply}"/>
    <boolean name="srgb" value="false"/>
    <bsdf type="diffuse"><texture type="vertexcolors" name="reflectance"/></bsdf>
  </shape>
""",
    "wireframe": """  <shape type="sphere">
    <point name="center" x="0" y="0.5" z="0"/>
    <float name="radius" value="0.5"/>
    <bsdf type="diffuse"><texture name="reflectance" type="wireframe">
      <rgb name="edgeColor" value="0.9, 0.1, 0.1"/>
      <rgb name="interiorColor" value="0.1, 0.8, 0.1"/>
    </texture></bsdf>
  </shape>
""",
    "curvature": """  <shape type="sphere">
    <point name="center" x="0" y="0.5" z="0"/>
    <float name="radius" value="0.5"/>
    <bsdf type="diffuse"><texture name="reflectance" type="curvature">
      <string name="curvature" value="gaussian"/>
      <float name="scale" value="0.15"/>
    </texture></bsdf>
  </shape>
""",
}


def light_down(xml):
    """mini_cbox's luminaire turned to face the floor, which it then
    lights directly."""
    old = '<scale value="0.25"/><rotate x="1" angle="-90"/>'
    assert xml.count(old) == 1
    return xml.replace(old, '<scale value="0.25"/><rotate x="1" angle="90"/>')


def mini_cbox_texture_variant_xml(variant, tex_dir, res=32, budget=16,
                                  max_depth=6, nee="never"):
    """mini_cbox, its luminaire facing the floor (light_down), with one
    of the lane-side textures: "vertexcolors" (a quad of a PLY written
    into tex_dir in the floor's place, 12 triangles), "wireframe" or
    "curvature" (a sphere of 16,128 triangles in the box)."""
    xml = light_down(MINI_CBOX.format(res=res, budget=budget,
                                      max_depth=max_depth, nee=nee))
    ply = os.path.join(tex_dir, "quad.ply")
    if variant == "vertexcolors":
        with open(ply, "w") as f:
            f.write(_VC_PLY)
        # the quad takes the floor's place
        head, tail = xml.split("  <!-- floor -->\n")
        xml = head + tail.split("  </shape>\n", 1)[1]
    return xml.replace("</scene>",
                       _VARIANT_SHAPES[variant].format(ply=ply) + "</scene>")


def orthographic(xml):
    """The scene's camera made orthographic, looking down at the floor
    through the box's open front (a view 2 wide, the floor in about half
    of it): the footprint path of the textures."""
    import re

    xml = re.sub(r'<sensor type="perspective">\s*<float name="fov" '
                 r'value="[^"]*"/>', '<sensor type="orthographic">', xml)
    old = '<lookAt origin="0, 1, -3.5" target="0, 1, -2.5" up="0, 1, 0"/>'
    assert xml.count(old) == 1
    return xml.replace(old, '<lookAt origin="0, 1.6, -2.2" '
                            'target="0, 0, 0.4" up="0, 1, 0"/>')


# the sky box's lights besides its luminaire: a sun and sky through the
# open front (z = -1), a spot inside the box aimed at the floor and a
# point light
SKY_EMITTERS = """  <emitter type="sunsky">
    <vector name="sunDirection" x="0" y="0.5" z="-1"/>
    <integer name="resolution" value="{resolution}"/>
    {sun_radius}
  </emitter>
  <emitter type="spot">
    <transform name="toWorld">
      <lookat origin="-0.5, 1.8, 0.3" target="-0.5, 0, 0.3" up="0, 0, 1"/>
    </transform>
    <float name="cutoffAngle" value="30"/>
    <float name="beamWidth" value="20"/>
    <rgb name="intensity" value="4, 4, 4"/>
  </emitter>
  <emitter type="point">
    <point name="position" x="0.5" y="1.2" z="0"/>
    <rgb name="intensity" value="2, 2, 2"/>
  </emitter>
"""


def mini_cbox_sky_xml(res=32, budget=16, max_depth=6, nee="always",
                      resolution=4096, directional_sun=False):
    """mini_cbox open to the sky through its front (z = -1): its area
    luminaire, a `sunsky` emitter of `resolution` (a resolution x
    resolution / 2 map, default turbidity 3, the sun's own radiance) whose
    sun shines in through the opening onto the floor and the back wall, a
    spot inside the box aimed at the floor and a point light: four NEE
    slots (area, environment, spot, point). With directional_sun the
    sunsky has sunRadiusScale 0: its sky dome and a directional sun (five
    slots)."""
    return MINI_CBOX.format(
        res=res, budget=budget, max_depth=max_depth, nee=nee).replace(
        "</scene>", SKY_EMITTERS.format(
            resolution=resolution,
            sun_radius='<float name="sunRadiusScale" value="0"/>'
            if directional_sun else "") + "</scene>")


def puff_grid(res, seed, n_puffs=8):
    """A smoke density grid [res, res, res] float32 (z, y, x): a sum of
    Gaussian puffs at random centres and widths from `seed`, normalised
    to a maximum of 1 (each puff separable, so a 256^3 grid takes a
    second)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, res, dtype=np.float32)
    dens = np.zeros((res, res, res), np.float32)
    for c, s, a in zip(rng.uniform(0.25, 0.75, (n_puffs, 3)),
                       rng.uniform(0.06, 0.16, n_puffs),
                       rng.uniform(0.4, 1.0, n_puffs)):
        gx, gy, gz = (np.exp(-(x - c[k]) ** 2 / (2 * s * s)).astype(
            np.float32) for k in range(3))
        dens += np.float32(a) * gz[:, None, None] * gy[None, :, None] \
            * gx[None, None, :]
    return dens / dens.max()


def fiber_grid(res):
    """An orientation volume [res, res, res, 3] float32: fibers swirling
    around the y axis, tilted up with height."""
    x = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    z, y, xx = np.meshgrid(x, x, x, indexing="ij")
    v = np.stack([-z, 0.5 * y, xx], -1)
    return (v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                           1e-3)).astype(np.float32)


# the smoke box's media: a null cube of grid smoke (HG g 0.3, albedo 0.8)
# and a null cube of homogeneous Rayleigh medium
SMOKE_CENTER, SMOKE_HALF = (-0.3, 0.75, 0.15), 0.45
RAYLEIGH_CENTER, RAYLEIGH_HALF = (0.5, 0.35, -0.35), 0.3
_NULL_CUBE = """  <shape type="cube">
    <transform name="toWorld"><scale value="{half}"/>
      <translate x="{c[0]}" y="{c[1]}" z="{c[2]}"/></transform>
    <bsdf type="null"/>
    <medium name="interior" type="{kind}">
{body}
    </medium>
  </shape>
"""


def _grid_medium(vol, scale, phase, extra=""):
    return (f'      <volume name="density" type="gridvolume">\n'
            f'        <string name="filename" value="{vol}"/></volume>\n'
            f'{extra}'
            f'      <volume name="albedo" type="constvolume">\n'
            f'        <rgb name="value" value="0.8, 0.8, 0.8"/></volume>\n'
            f'      <float name="scale" value="{scale!r}"/>\n'
            f'      {phase}')


def mini_cbox_smoke_xml(vol_dir, res=32, budget=16, max_depth=6,
                        nee="always", grid_res=256, seed=0):
    """mini_cbox, its luminaire facing the floor (light_down: NEE from
    the media crosses them), holding two null cubes of media (36
    triangles): a heterogeneous smoke of a grid_res^3 float32 density grid of Gaussian
    puffs (puff_grid(grid_res, seed), written to vol_dir/smoke.vol with
    io/vol.py) scaled so that its majorant times the cube's side is 8, HG
    g 0.3 and albedo 0.8; and a homogeneous Rayleigh medium (sigma_t 0.6,
    1.2, 2.4, albedo 0.95)."""
    from ..io.vol import write_vol

    c, h = np.asarray(SMOKE_CENTER), SMOKE_HALF
    vol = os.path.join(vol_dir, "smoke.vol")
    write_vol(vol, puff_grid(grid_res, seed), c - h, c + h)
    smoke = _NULL_CUBE.format(half=h, c=SMOKE_CENTER, kind="heterogeneous",
                              body=_grid_medium(vol, 8.0 / (2 * h),
                                                '<phase type="hg"><float '
                                                'name="g" value="0.3"/>'
                                                '</phase>'))
    rayleigh = _NULL_CUBE.format(
        half=RAYLEIGH_HALF, c=RAYLEIGH_CENTER, kind="homogeneous",
        body='      <rgb name="sigmaT" value="0.6, 1.2, 2.4"/>\n'
             '      <rgb name="albedo" value="0.95, 0.95, 0.95"/>\n'
             '      <phase type="rayleigh"/>')
    return light_down(MINI_CBOX.format(
        res=res, budget=budget, max_depth=max_depth, nee=nee)).replace(
        "</scene>", smoke + rayleigh + "</scene>")


def mini_cbox_fibers_xml(vol_dir, res=32, budget=16, max_depth=6,
                         nee="always", grid_res=32, seed=1):
    """mini_cbox, its luminaire facing the floor, holding two null cubes
    of fiber media: a microflake grid medium (puff_grid(grid_res, seed) densities, scale 6, stddev 0.3)
    whose fibers follow a grid_res^3 orientation volume (fiber_grid,
    written to vol_dir/fibers.vol), and a homogeneous Kajiya-Kay medium
    (sigma_t 1.5, fibers along (1, 1, 0), ks 0.6, kd 0.2, exponent 8)."""
    from ..io.vol import write_vol

    c, h = np.asarray(SMOKE_CENTER), SMOKE_HALF
    dens = os.path.join(vol_dir, "fiber_density.vol")
    ori = os.path.join(vol_dir, "fibers.vol")
    write_vol(dens, puff_grid(grid_res, seed), c - h, c + h)
    write_vol(ori, fiber_grid(grid_res), c - h, c + h)
    flakes = _NULL_CUBE.format(
        half=h, c=SMOKE_CENTER, kind="heterogeneous", body=_grid_medium(
            dens, 6.0, '<phase type="microflake"><float name="stddev" '
                       'value="0.3"/></phase>',
            f'      <volume name="orientation" type="gridvolume">\n'
            f'        <string name="filename" value="{ori}"/></volume>\n'))
    kkay = _NULL_CUBE.format(
        half=RAYLEIGH_HALF, c=RAYLEIGH_CENTER, kind="homogeneous",
        body='      <rgb name="sigmaT" value="1.5, 1.5, 1.5"/>\n'
             '      <rgb name="albedo" value="0.9, 0.9, 0.9"/>\n'
             '      <vector name="orientation" x="1" y="1" z="0"/>\n'
             '      <phase type="kkay"><float name="ks" value="0.6"/>'
             '<float name="kd" value="0.2"/>'
             '<float name="exponent" value="8"/></phase>')
    return light_down(MINI_CBOX.format(
        res=res, budget=budget, max_depth=max_depth, nee=nee)).replace(
        "</scene>", flakes + kkay + "</scene>")


# the translucent box's shapes: a dipole sphere of Jensen's marble at
# scale 8 on the floor under ppg_tpu's test boundary (a plastic of
# diffuse reflectance 0), and a single-scattering cube of side 0.5 with
# tests/test_singlescatter.py's coefficients inside a dielectric of
# intIOR 1.5 (the shape's own BSDF, as there, the loader's all-absorbing
# default)
TRANSLUCENT_SPHERE = """  <shape type="sphere">
    <point name="center" x="-0.45" y="{r}" z="0.25"/>
    <float name="radius" value="{r}"/>
    <subsurface type="dipole">
      <string name="material" value="marble"/>
      <float name="scale" value="{scale!r}"/>
    </subsurface>
    <bsdf type="plastic"><rgb name="diffuseReflectance" value="0, 0, 0"/></bsdf>
  </shape>
"""
SSS_CUBE = """  <shape type="cube">
    <transform name="toWorld"><scale value="0.25"/><rotate y="1" angle="30"/>
      <translate x="0.45" y="0.25" z="-0.2"/></transform>
    <subsurface type="singlescatter">
      <rgb name="sigmaS" value="0.6, 0.8, 1.0"/>
      <rgb name="sigmaA" value="0.05, 0.1, 0.2"/>
      <rgb name="g" value="0.1, 0.1, 0.1"/>
      <integer name="fssSamples" value="2"/>
      <integer name="singleScatterDepth" value="4"/>
      <bsdf type="dielectric"><float name="intIOR" value="1.5"/></bsdf>
    </subsurface>
  </shape>
"""


def mini_cbox_translucent_xml(res=32, budget=16, max_depth=6, nee="always",
                              sphere=True, scale=8.0):
    """mini_cbox, its luminaire facing the floor (light_down: the dipole's
    irradiance and the cube's emitter samples see it directly), holding a
    single-scattering cube (12 triangles) and, with `sphere`, a dipole
    sphere of radius 0.4 on the floor (the loader tessellates it to
    16,128 triangles, so the scene runs through the BVH walk; without it
    the scene has 24 triangles and runs through the sweep). `scale`
    scales the marble's coefficients: at 8 the point cloud holds about
    13,000 points, at 1 about 130."""
    shapes = SSS_CUBE
    if sphere:
        shapes = TRANSLUCENT_SPHERE.format(r=0.4, scale=scale) + shapes
    return light_down(MINI_CBOX.format(
        res=res, budget=budget, max_depth=max_depth, nee=nee)).replace(
        "</scene>", shapes + "</scene>")

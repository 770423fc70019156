"""Built-in miniature test scenes (no external assets).

A rectangle-only cornell box used by tests, bench warmup, and the driver
entry points; geometry mirrors the classic cbox layout (including the
reference's upside-down luminaire) but is self-contained.

The port's own copy of ppg_tpu/scene/testscenes.py.
"""

from __future__ import annotations

import os
import tempfile

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

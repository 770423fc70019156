"""The port's own scene loader (ppg_tpu_torch/scene, with its copies of the
modules the loader pulls in) against ppg_tpu's: the same scene file gives
equal host arrays in every field of the scene (positions, faces, normals,
uvs, the material table, the emitter tables, sensor, film, integrator and
the parsed plugin tree), and the port's BVH packing gives ppg_tpu's
triangle order."""

import os
import struct

import numpy as np
import pytest

from ppg_tpu.accel import bvh as JB
from ppg_tpu.io.serialized import save_serialized
from ppg_tpu.scene.scene import load_scene as j_load
from ppg_tpu.scene.testscenes import MINI_CBOX as J_MINI_CBOX
from ppg_tpu.scene.testscenes import mini_cbox as j_mini_cbox
from ppg_tpu_torch.accel import bvh as TB
from ppg_tpu_torch.accel.traverse import native_builder_loaded, pack_triangles
from ppg_tpu_torch.scene import MINI_CBOX, load_scene, mini_cbox


def _same(a, b, path="scene", seen=None):
    """Field-by-field equality of two loaded scenes (classes compared by
    name: each package has its own)."""
    seen = set() if seen is None else seen
    if (id(a), id(b)) in seen:
        return
    seen.add((id(a), id(b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert type(a).__name__ == type(b).__name__, path
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]", seen)
        if hasattr(a, "__dict__"):  # a dict subclass's own attributes
            _same(vars(a), vars(b), path + ".vars", seen)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", seen)
    elif isinstance(a, float) and isinstance(b, float):
        assert a == b or (a != a and b != b), path
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        _same(vars(a), vars(b), path, seen)
    else:
        assert a == b, (path, a, b)


def _both(path, **kw):
    port, ref = load_scene(str(path), **kw), j_load(str(path), **kw)
    assert port.num_tris == ref.num_tris
    _same(port, ref)
    return port


# the three built-in Cornell boxes chip_smoke.py renders (phase 1, phases
# 3-5, phase 6)
@pytest.mark.parametrize("res,budget,depth,nee", [(16, 4, 2, "never"),
                                                  (512, 127, 10, "never"),
                                                  (256, 32, 10, "always")])
def test_mini_cbox_matches(tmp_path, res, budget, depth, nee):
    assert MINI_CBOX == J_MINI_CBOX
    p = tmp_path / "cbox.xml"
    p.write_text(MINI_CBOX.format(res=res, budget=budget, max_depth=depth,
                                  nee=nee))
    sc = _both(p)
    assert sc.num_tris == 12 and sc.emitters.num == 1
    # the port's built-in loader, through its own temporary file
    port = mini_cbox(res=res, budget=budget, max_depth=depth, nee=nee)
    ref = j_mini_cbox(res=res, budget=budget, max_depth=depth, nee=nee)
    port.xml_path = ref.xml_path = ""
    port.textures.scene_xml = ref.textures.scene_xml = None
    _same(port, ref)


_CAMERA = """<integrator type="path"><integer name="maxDepth" value="2"/></integrator>
<sensor type="perspective"><float name="fov" value="45"/>
 <transform name="toWorld">
  <lookat origin="0, 3, 0.001" target="0, 0, 0" up="0, 1, 0"/></transform>
 <sampler type="independent"><integer name="sampleCount" value="16"/></sampler>
 <film type="hdrfilm"><integer name="width" value="16"/>
  <integer name="height" value="16"/><rfilter type="box"/></film></sensor>"""

_PLY = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
property float nx
property float ny
property float nz
property float u
property float v
element face 2
property list uchar int vertex_indices
end_header
-2 0 -2 0 1 0 0 0
2 0 -2 0 1 0 1 0
2 0 2 0 1 0 1 1
-2 0 2 0 1 0 0 1
3 0 2 1
3 0 3 2
"""

_OBJ = """v -1 0 -1
v 1 0 -1
v 1 0.5 1
v -1 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
f 1/1/1 2/2/1 3/3/1 4/4/1
"""


def _write_mesh_files(d):
    (d / "quad.ply").write_text(_PLY)
    (d / "quad.obj").write_text(_OBJ)
    quad = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    save_serialized(str(d / "mesh.serialized"), [
        dict(positions=quad, faces=np.array([[0, 1, 2], [2, 3, 0]]),
             normals=np.tile([0.0, 0, 1], (4, 1)), texcoords=quad[:, :2],
             name="quad"),
        dict(positions=quad * 2.0, faces=np.array([[0, 1, 2], [2, 3, 0]]),
             face_normals=True, name="quad2")])
    from PIL import Image

    h = (np.arange(16)[None, :] * np.ones((16, 1)) * 16).astype(np.uint8)
    Image.fromarray(h, mode="L").save(d / "h.png")
    (d / "f.hair").write_text("0 0 0\n0 0 1\n0 0 2\n\n1 0 0\n1 0 1\n")
    data = b"BINARY_HAIR" + struct.pack("<I", 4)
    inf = struct.pack("<f", float("inf"))
    data += inf + struct.pack("<6f", 0, 0, 0, 0, 0, 1)
    data += inf + struct.pack("<6f", 5, 0, 0, 5, 0, 1)
    (d / "b.hair").write_bytes(data)


_SHAPES = {
    # tests/test_shapes_io.py::test_ply_scene_end_to_end
    "ply": """<shape type="ply"><string name="filename" value="quad.ply"/>
 <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
</shape>
<emitter type="directional"><vector name="direction" x="0" y="-1" z="0"/>
 <rgb name="irradiance" value="3.14159265, 3.14159265, 3.14159265"/>
</emitter>""",
    "obj": """<shape type="obj"><string name="filename" value="quad.obj"/>
 <transform name="toWorld"><rotate y="1" angle="30"/><translate z="1"/></transform>
 <bsdf type="roughplastic"><float name="alpha" value="0.2"/>
  <rgb name="diffuseReflectance" value="0.2, 0.4, 0.6"/></bsdf>
</shape>
<shape type="sphere"><point name="center" x="0" y="1" z="0"/>
 <float name="radius" value="0.3"/>
 <emitter type="area"><rgb name="radiance" value="4, 4, 4"/></emitter></shape>""",
    "serialized": """<shape type="serialized">
 <string name="filename" value="mesh.serialized"/>
 <integer name="shapeIndex" value="1"/>
 <bsdf type="conductor"><string name="material" value="Au"/></bsdf></shape>
<shape type="serialized">
 <string name="filename" value="mesh.serialized"/>
 <bsdf type="dielectric"><float name="intIOR" value="1.5"/></bsdf></shape>
<shape type="rectangle"><transform name="toWorld"><translate y="2"/></transform>
 <emitter type="area"><spectrum name="radiance" value="400:1, 500:2, 600:3, 700:4"/></emitter></shape>""",
    # tests/test_shapes_io.py::test_instance_flattening
    "instance": """<shape type="shapegroup" id="grp">
 <shape type="rectangle">
  <bsdf type="diffuse"><rgb name="reflectance" value="0.8, 0.1, 0.1"/></bsdf>
 </shape>
</shape>
<shape type="instance"><ref id="grp"/>
 <transform name="toWorld"><translate x="-3"/></transform></shape>
<shape type="instance"><ref id="grp"/>
 <transform name="toWorld"><translate x="3"/></transform></shape>""",
    # tests/test_shapes_io.py::test_heightfield_shape
    "heightfield": """<shape type="heightfield">
 <string name="filename" value="h.png"/>
 <float name="scale" value="4"/>
 <bsdf type="diffuse"/></shape>""",
    # tests/test_shapes_io.py::test_hair_shape and the binary format
    "hair": """<shape type="hair">
 <string name="filename" value="f.hair"/>
 <float name="radius" value="0.05"/>
 <bsdf type="diffuse"/></shape>
<shape type="hair"><string name="filename" value="b.hair"/>
 <float name="radius" value="0.02"/></shape>""",
}


@pytest.mark.parametrize("kind", list(_SHAPES))
def test_xml_scene_matches(tmp_path, kind):
    _write_mesh_files(tmp_path)
    p = tmp_path / "s.xml"
    p.write_text(f'<scene version="0.5.0">\n{_CAMERA}\n{_SHAPES[kind]}\n'
                 "</scene>")
    sc = _both(p)
    assert sc.num_tris >= 2


def test_defaults_substitution_matches(tmp_path):
    """tests/test_scene.py::test_defaults_substitution."""
    p = tmp_path / "s.xml"
    p.write_text(
        """<scene version="0.5.0">
        <default name="res" value="64"/>
        <integrator type="path"><integer name="maxDepth" value="$depth"/></integrator>
        <sensor type="perspective"><float name="fov" value="45"/>
          <film type="hdrfilm"><integer name="width" value="$res"/>
          <integer name="height" value="$res"/></film>
        </sensor></scene>""")
    sc = _both(p, defaults={"depth": 7})
    assert sc.integrator["maxDepth"] == 7 and sc.film["width"] == 64


def test_zero_radius_sun_is_not_ported(tmp_path):
    """A sun of zero apparent radius (once refused by the port) flattens
    into a directional delta emitter, and a sunsky into that and its sky
    dome, as in ppg_tpu (sun.cpp:153-166)."""
    for kind, env in (("sun", False), ("sunsky", True)):
        p = tmp_path / f"{kind}.xml"
        p.write_text(f'<scene version="0.5.0">\n{_CAMERA}\n'
                     f'<shape type="rectangle"/>\n<emitter type="{kind}">'
                     '<float name="sunRadiusScale" value="0"/></emitter>'
                     "</scene>")
        sc, jsc = load_scene(str(p)), j_load(str(p))
        assert (sc.env_emitter is not None) == env
        assert (jsc.env_emitter is not None) == env
        assert len(sc.delta_emitters) == len(jsc.delta_emitters) == 1
        a, b = sc.delta_emitters[0], jsc.delta_emitters[0]
        assert a["type"] == b["type"] == 2
        assert np.array_equal(a["direction"], b["direction"])
        assert np.array_equal(a["intensity"], b["intensity"])


def _soup(T, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (3 * T, 3))
    return pos, rng.permutation(3 * T).reshape(T, 3).astype(np.int32)


@pytest.mark.parametrize("scene", ["mini_cbox", "soup"])
def test_pack_triangles_matches_ppg_tpu_bvh_order(scene):
    if scene == "mini_cbox":
        sc = mini_cbox(res=8)
        pos, faces = sc.positions, sc.faces
    else:
        pos, faces = _soup(700, seed=5)
    assert native_builder_loaded()
    ref = JB.build_bvh8(pos, faces)
    port = TB.build_bvh8(pos, faces)
    np.testing.assert_array_equal(port["prim_ids"], ref["prim_ids"])
    np.testing.assert_array_equal(port["rows"], ref["rows"])
    tri, perm = pack_triangles(pos, faces)
    np.testing.assert_array_equal(perm, np.asarray(ref["prim_ids"]))
    v = pos[faces[perm]]
    np.testing.assert_array_equal(tri[:, 0:3], v[:, 0].astype(np.float32))


def test_numpy_bvh_builder_matches_ppg_tpu():
    """The builder a machine without a C++ compiler takes."""
    pos, faces = _soup(300, seed=6)
    port = TB._collapse8(pos, faces)
    ref = JB._collapse8(pos, faces)
    np.testing.assert_array_equal(port["prim_ids"], ref["prim_ids"])
    np.testing.assert_array_equal(port["rows"], ref["rows"])


def test_host_libraries_are_built_outside_the_reference():
    """The port's native libraries come from its own sources and live in
    build/ppg_tpu_torch/, never beside ppg_tpu's."""
    from ppg_tpu_torch import native

    for lib in (native.bvh_lib(), native.sdtree_lib()):
        assert os.path.dirname(lib._name) == native.BUILD_DIR
        assert os.path.basename(lib._name).startswith(
            ("libbvh_builder-", "libsdtree_host-"))

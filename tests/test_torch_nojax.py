"""ppg_tpu_torch never imports JAX, and nothing of ppg_tpu: in a fresh
interpreter, importing the package, loading a scene, packing its
triangles, building a host SD-tree and dumping it as .sdt, walking the
BVH of a scene above 1024 triangles, drawing QMC samples (and importing
the kdbench tool, the descent kernels' wrappers, the CUDA shim and the
SD-tree and texture cases), rendering a textured box and rendering a
16x16 Cornell box on the CPU through GuidedPathTracer (with a thin lens
and the gaussian filter) and through the command line (at the default
settings, at cbox-improved's, with NEE, and unguided with the sobol
sampler) leaves no jax and no ppg_tpu module loaded; no source file of
the port, nor chip_smoke.py, k1_compare.py, launch_profile.py and
gate_noise.py, names ppg_tpu in an import; and the kernel sources
include only the CUDA runtime's and C headers."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RENDER = """
import sys
import numpy as np
import ppg_tpu_torch
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.testscenes import MINI_CBOX, scene_from_xml
xml = MINI_CBOX.format(res=16, budget=16, max_depth=6, nee="never")
xml = xml.replace('<sensor type="perspective">', '<sensor type="thinlens">')
xml = xml.replace('<rfilter type="box"/>', '<rfilter type="gaussian"/>')
tracer = GuidedPathTracer(scene_from_xml(xml), chunk=256, device="cpu")
img = tracer.render(seed=0)
assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0
assert tracer.sensor.needs_lens_sample and tracer.film.rfilter == "gaussian"
jax = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not jax, jax
print("ok")
"""

_CLI = """
import runpy, sys
sys.argv = ["ppg_tpu_torch.cli", sys.argv[1], "-o", sys.argv[2], "--spp",
            "8", "--chunk", "64", "--device", "cpu"]
runpy.run_module("ppg_tpu_torch.cli", run_name="__main__")
assert "jax" not in sys.modules
print("ok")
"""


# `import ppg_tpu...` / `from ppg_tpu... import`, also after other names
# on one import line, and the dynamic forms; ppg_tpu_torch does not match
_STATIC = re.compile(
    r"^\s*(?:from\s+ppg_tpu(?![\w])|import\s+(?:[\w.]+(?:\s+as\s+\w+)?"
    r"\s*,\s*)*ppg_tpu(?![\w]))", re.M)
_DYNAMIC = re.compile(
    r"(?:__import__|import_module)\(\s*[\"']ppg_tpu(?![\w])")


def _port_sources():
    files = glob.glob(os.path.join(ROOT, "ppg_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, f) for f in (
        "chip_smoke.py", "k1_compare.py", "launch_profile.py",
        "gate_noise.py")]


def test_no_source_of_the_port_imports_ppg_tpu():
    files = _port_sources()
    assert len(files) > 30
    for new in (("guiding", "descent.py"), ("render", "samplers.py"),
                ("io", "sdt.py"), ("scene", "textures.py"),
                ("tools", "texture_cases.py")):
        assert os.path.join(ROOT, "ppg_tpu_torch", *new) in files
    for path in files:
        with open(path) as f:
            src = f.read()
        bad = _STATIC.findall(src) + _DYNAMIC.findall(src)
        assert not bad, (path, bad)
    # the patterns do catch what they are meant to
    for line in ("import ppg_tpu", "from ppg_tpu.io import exr",
                 "    from ppg_tpu import media", "import os, ppg_tpu.scene",
                 "importlib.import_module('ppg_tpu.io')"):
        assert _STATIC.search(line) or _DYNAMIC.search(line), line
    for line in ("import ppg_tpu_torch", "from ppg_tpu_torch.io import exr",
                 "# see ppg_tpu/accel/bvh.py"):
        assert not (_STATIC.search(line) or _DYNAMIC.search(line)), line


_HOST = """
import sys
import numpy as np
import torch
from ppg_tpu_torch.accel.traverse import (any_hit, build_geometry,
                                          closest_hit, pack_triangles)
from ppg_tpu_torch.guiding import descent
from ppg_tpu_torch.guiding.host import HostSDTree
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene import mini_cbox
from ppg_tpu_torch.scene.testscenes import mini_cbox_sphere
from ppg_tpu_torch.io.sdt import dump_sdtree, read_sdt
from ppg_tpu_torch.render import samplers
from ppg_tpu_torch.tools import cuda_shim, kdbench, sdtree_cases
sc = mini_cbox(res=16, budget=8, max_depth=3, nee="always")
tri, perm = pack_triangles(sc.positions, sc.faces)
assert sorted(perm) == list(range(len(sc.faces)))
host = HostSDTree(sc.aabb_min, sc.aabb_max)
host.build()
dump_sdtree(sys.argv[1], host, np.eye(4))
assert read_sdt(sys.argv[1])[0].shape == (4, 4)
for kind in samplers.KINDS[1:]:
    u = samplers.draw(kind, torch.arange(64), 3, 5, None, (64, 4))
    assert u.shape == (64, 4) and 0 <= float(u.min()) <= float(u.max()) < 1
img = GuidedPathTracer(sc, chunk=256, device="cpu").render(seed=0)
assert np.isfinite(img).all() and img.mean() > 0
# the BVH walk: a scene above the sweep's 1024 triangles
big = mini_cbox_sphere(res=8)
geom = build_geometry(big.positions, big.faces, "cpu")
o = torch.tensor([[0.0, 1.0, -2.0]]).expand(8, 3)
d = torch.nn.functional.normalize(torch.randn(8, 3) * 0.1
                                  + torch.tensor([0.0, 0.0, 1.0]), dim=1)
t0, t1 = torch.zeros(8), torch.full((8,), 1e9)
assert (closest_hit(geom, o, d, t0, t1)[0] >= 0).all()
assert any_hit(geom, o, d, t0, t1).all()
# a textured box (every texture kind of the slice) on the CPU
import tempfile
from ppg_tpu_torch.integrators import driver
from ppg_tpu_torch.scene.testscenes import (mini_cbox_textures_xml,
                                            scene_from_xml)
from ppg_tpu_torch.tools import texture_cases
with tempfile.TemporaryDirectory() as tex_dir:
    tsc = scene_from_xml(mini_cbox_textures_xml(tex_dir, res=8,
                                                sphere=False))
    img = driver.render(tsc, spp=1, chunk=64, device="cpu")
assert np.isfinite(img).all()
bad = sorted(m for m in sys.modules if m in ("jax", "ppg_tpu")
             or m.startswith(("jax.", "ppg_tpu.")))
assert not bad, bad
print("ok")
"""


def test_kernel_sources_include_no_framework_header():
    """Each csrc/*.cu (film.cu's K7 and K7s, textures.cu's K9 among them)
    includes only the CUDA runtime's headers (cuda_fp16.h for K9's
    float16 atlas) and C headers: no PyTorch, so nvcc builds it in seconds
    and tools/cuda_shim builds it for the CPU."""
    sources = glob.glob(os.path.join(ROOT, "ppg_tpu_torch", "csrc", "*.cu"))
    for name in ("film.cu", "textures.cu"):
        assert os.path.join(ROOT, "ppg_tpu_torch", "csrc", name) in sources
    for path in sources:
        with open(path) as f:
            heads = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)", f.read(),
                               re.M)
        assert set(heads) <= {"cuda_runtime.h", "cuda_fp16.h", "math.h",
                              "stdint.h"}, (path, heads)


def test_host_path_imports_nothing_of_ppg_tpu(tmp_path):
    _run(_HOST, str(tmp_path / "t.sdt"))


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
    return r


def test_render_imports_no_jax():
    _run(_RENDER)


# integrator settings the scene XML adds (the CLI has no flags for them)
_IMPROVED = """
    <string name="sampleCombination" value="inversevar"/>
    <string name="bsdfSamplingFractionLoss" value="kl"/>
    <string name="spatialFilter" value="stochastic"/>
    <string name="directionalFilter" value="box"/>
    <integer name="sTreeThreshold" value="4000"/>
    <integer name="sppPerPass" value="1"/>"""
_NEE_BOX = """
    <string name="spatialFilter" value="box"/>
    <string name="directionalFilter" value="box"/>
    <string name="bsdfSamplingFractionLoss" value="var"/>"""


@pytest.mark.parametrize("nee,settings", [("never", ""),
                                          ("never", _IMPROVED),
                                          ("always", _NEE_BOX)],
                         ids=["default", "improved", "nee"])
def test_cli_renders_exr_without_jax(tmp_path, nee, settings):
    from ppg_tpu.io import exr
    from ppg_tpu.scene.testscenes import MINI_CBOX

    scene = tmp_path / "cbox.xml"
    xml = MINI_CBOX.format(res=8, budget=16, max_depth=5, nee=nee)
    tag = '<integrator type="guided_path">'
    scene.write_text(xml.replace(tag, tag + settings))
    out = tmp_path / "cbox.exr"
    _run(_CLI, str(scene), str(out))
    img, _ = exr.read(str(out))
    assert img.shape[:2] == (8, 8) and np.isfinite(img).all()
    assert img.mean() > 0


_CLI_ARGS = """
import runpy, sys
sys.argv = ["ppg_tpu_torch.cli", *sys.argv[1:], "--device", "cpu"]
runpy.run_module("ppg_tpu_torch.cli", run_name="__main__")
assert "jax" not in sys.modules
print("ok")
"""


@pytest.mark.parametrize("integrator", ["path", "guided_path"])
def test_cli_renders_the_front_end_without_jax(tmp_path, integrator):
    """The unguided path tracer with the sobol sampler (the scene names
    integrator path), and the guided tracer with --dump-sdtree, both with
    a thin lens and the gaussian filter."""
    from ppg_tpu.io import exr
    from ppg_tpu.scene.testscenes import MINI_CBOX

    xml = MINI_CBOX.format(res=8, budget=8, max_depth=5, nee="never")
    xml = xml.replace('<sensor type="perspective">', '<sensor type="thinlens">')
    xml = xml.replace('<rfilter type="box"/>', '<rfilter type="gaussian"/>')
    xml = xml.replace('<sampler type="independent">', '<sampler type="sobol">')
    xml = xml.replace('<integrator type="guided_path">',
                      f'<integrator type="{integrator}">')
    scene = tmp_path / "cbox.xml"
    scene.write_text(xml)
    out = tmp_path / "cbox.exr"
    # 16 spp at sppPerPass 4: a training iteration of one pass (dumped),
    # then the final one of three
    _run(_CLI_ARGS, str(scene), "-o", str(out), "--spp", "16", "--chunk",
         "64", "--dump-sdtree")
    img, _ = exr.read(str(out))
    assert img.shape[:2] == (8, 8) and np.isfinite(img).all()
    assert img.mean() > 0
    dumps = sorted(p.name for p in tmp_path.glob("cbox-*.sdt"))
    assert dumps == ([] if integrator == "path" else ["cbox-00.sdt"])

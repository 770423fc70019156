"""ppg_tpu_torch never imports JAX: in a fresh interpreter, importing the
package, rendering a 16x16 Cornell box on the CPU through
GuidedPathTracer and through the command line (at the default settings,
at cbox-improved's and with NEE) leaves no jax module loaded."""

import os
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
from ppg_tpu_torch.scene import mini_cbox
img = GuidedPathTracer(mini_cbox(res=16, budget=16), chunk=256,
                       device="cpu").render(seed=0)
assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0
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

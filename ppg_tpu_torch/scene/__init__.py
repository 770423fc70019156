"""Scene loading (the port's own copy of ppg_tpu/scene; numpy, but for
textures.py's lookups in PyTorch).

The modules of this package are copies of their namesakes in ppg_tpu's
scene package, with imports pointed at the port's own copies of what the
loader pulls in (core/spectrum.py, core/transform.py, io/, bsdf/derived.py,
bsdf/fresnel.py, utils/logging.py, media.py). The port never imports
ppg_tpu. textures.py adds the MIP atlas and its lookups (K9) to the host
decoding the loader calls, and a sun of zero apparent radius flattens to
a directional emitter (scene.py), as in ppg_tpu.
"""

from ..bsdf.fresnel import fresnel_diffuse_reflectance
from .scene import load_scene
from .testscenes import MINI_CBOX, mini_cbox

__all__ = ["MINI_CBOX", "fresnel_diffuse_reflectance", "load_scene",
           "mini_cbox"]

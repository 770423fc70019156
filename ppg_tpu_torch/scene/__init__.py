"""Scene loading (the port's own copy of ppg_tpu/scene, numpy only).

The modules of this package are copies of their namesakes in ppg_tpu's
scene package, with imports pointed at the port's own copies of what the
loader pulls in (core/spectrum.py, core/transform.py, io/, bsdf/derived.py,
bsdf/fresnel.py, utils/logging.py, media.py). The port never imports
ppg_tpu. Left out: texture sampling (textures.py keeps only the host
decoding the loader calls; sampling is ROADMAP Queue 1 item 2b) and the
zero-radius sun emitter, which raises NotImplementedError.
"""

from ..bsdf.fresnel import fresnel_diffuse_reflectance
from .scene import load_scene
from .testscenes import MINI_CBOX, mini_cbox

__all__ = ["MINI_CBOX", "fresnel_diffuse_reflectance", "load_scene",
           "mini_cbox"]

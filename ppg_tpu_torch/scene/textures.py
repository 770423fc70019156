"""Host-side texture decoding (copy of the numpy part of
ppg_tpu/scene/textures.py: _srgb_to_linear, rasterize_procedural,
load_texture).

8-bit PNG/JPG sources are converted sRGB -> linear exactly as
Bitmap::setGamma/fromLinearRGB does for gamma=-1 (srgb). The device-side
atlas and its bilinear/EWA sampling are not ported yet (ROADMAP Queue 1
item 2b).
"""

from __future__ import annotations

import os

import numpy as np


def _srgb_to_linear(x):
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def rasterize_procedural(otype, p, res=128):
    """checkerboard.cpp: 2x2 tiles of color0/color1 per uv unit;
    gridtexture.cpp: color1 lines of lineWidth on a color0 field."""
    def rgb(v, default):
        if v is None:
            return np.full(3, default, np.float32)
        a = np.asarray(getattr(v, "rgb", v), np.float64).reshape(-1)
        return (np.full(3, float(a[0])) if a.size == 1 else a[:3]).astype(
            np.float32)

    c0 = rgb(p.get("color0"), 0.4)
    c1 = rgb(p.get("color1"), 0.2)
    u = (np.arange(res) + 0.5) / res
    uu, vv = np.meshgrid(u, u)
    if otype == "checkerboard":
        mask = ((uu * 2).astype(int) + (vv * 2).astype(int)) % 2 == 0
    else:
        lw = float(p.get("lineWidth", 0.01))
        fu = uu - np.floor(uu)
        fv = vv - np.floor(vv)
        mask = ~((np.minimum(fu, 1 - fu) < lw) | (np.minimum(fv, 1 - fv) < lw))
    img = np.where(mask[..., None], c0[None, None], c1[None, None])
    return img.astype(np.float32)


def load_texture(path, gamma=0.0):
    """Decode an image file to linear float32 RGB [H, W, 3]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        from ..io import exr

        img = exr.read(path)[0]
        return np.asarray(img, np.float32)[..., :3]
    from PIL import Image

    im = Image.open(path)
    arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    arr = arr[..., :3]
    if arr.dtype == np.uint8:
        x = arr.astype(np.float64) / 255.0
        if gamma == 0.0 or gamma == -1.0:  # srgb (bitmap.cpp default)
            x = _srgb_to_linear(x)
        elif gamma != 1.0:
            x = x ** gamma
        return x.astype(np.float32)
    return arr.astype(np.float32)

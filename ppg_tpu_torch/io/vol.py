"""Mitsuba .vol grid-volume codec.

Layout (reference src/volume/gridvolume.cpp:56-102): b'VOL', version
byte 3, int32 encoding (1 = float32, 2 = float16, 3 = uint8), int32
xres/yres/zres, int32 channels (1 or 3), 6 float32 bbox
(xmin ymin zmin xmax ymax zmax), then data indexed
data[((z*yres + y)*xres + x)*channels + c].

The port's own copy of ppg_tpu/io/vol.py.
"""

from __future__ import annotations

import struct

import numpy as np


def read_vol(path):
    """Returns (data [Z,Y,X,C] float32, bbox_min [3], bbox_max [3])."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"VOL":
        raise ValueError(f"{path}: bad magic")
    if buf[3] != 3:
        raise ValueError(f"{path}: unsupported version {buf[3]}")
    enc, xr, yr, zr, ch = struct.unpack_from("<5i", buf, 4)
    bbox = struct.unpack_from("<6f", buf, 24)
    n = xr * yr * zr * ch
    if enc == 1:
        data = np.frombuffer(buf, "<f4", n, 48)
    elif enc == 2:
        data = np.frombuffer(buf, "<f2", n, 48).astype(np.float32)
    elif enc == 3:
        data = np.frombuffer(buf, "<u1", n, 48).astype(np.float32) / 255.0
    else:
        raise ValueError(f"{path}: unsupported encoding {enc}")
    data = data.reshape(zr, yr, xr, ch).astype(np.float32)
    return data, np.array(bbox[:3]), np.array(bbox[3:])


def write_vol(path, data, bbox_min, bbox_max):
    """data: [Z,Y,X] or [Z,Y,X,C] float32."""
    d = np.asarray(data, np.float32)
    if d.ndim == 3:
        d = d[..., None]
    zr, yr, xr, ch = d.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<5i", 1, xr, yr, zr, ch))
        f.write(struct.pack("<6f", *np.asarray(bbox_min, np.float64),
                            *np.asarray(bbox_max, np.float64)))
        f.write(d.tobytes())

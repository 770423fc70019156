"""Minimal OpenEXR 2.0 scanline codec (read/write) in pure Python + numpy.

Replaces the role of Mitsuba's Bitmap EXR path (reference:
mitsuba/src/libcore/bitmap.cpp) for golden-image comparison and output.
Supports: single-part scanline images, HALF/FLOAT/UINT channels,
NONE / ZIPS (1 line) / ZIP (16 lines) compression, increasing-y line order.
That covers every EXR bundled with the reference scenes (ZIP + half RGB).

The port's own copy of ppg_tpu/io/exr.py.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76

# EXR pixel types
_UINT, _HALF, _FLOAT = 0, 1, 2
_PT_DTYPE = {_UINT: np.uint32, _HALF: np.float16, _FLOAT: np.float32}
_PT_SIZE = {_UINT: 4, _HALF: 2, _FLOAT: 4}

# compression ids
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16}


def _predictor_decode(buf: bytearray) -> bytes:
    """EXR zip post-processing: undo delta encoding then de-interleave."""
    arr = np.frombuffer(bytes(buf), np.uint8).astype(np.int64)
    if arr.size > 1:
        arr[1:] = (np.cumsum(arr[1:] - 128 + 256) + arr[0]) % 256
    arr = arr.astype(np.uint8)
    # de-interleave: first half holds even bytes, second half odd bytes
    n = arr.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _predictor_encode(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    x = inter.astype(np.int64)
    if n > 1:
        d = np.empty(n, np.int64)
        d[0] = x[0]
        d[1:] = (x[1:] - x[:-1]) + 128
        x = d % 256
    return x.astype(np.uint8).tobytes()


def _read_attrs(data: bytes, off: int):
    attrs = {}
    while data[off] != 0:
        e = data.index(b"\0", off)
        name = data[off:e].decode()
        off = e + 1
        e = data.index(b"\0", off)
        typ = data[off:e].decode()
        off = e + 1
        size = struct.unpack_from("<I", data, off)[0]
        off += 4
        attrs[name] = (typ, data[off : off + size])
        off += size
    return attrs, off + 1


def read(path):
    """Read an EXR file. Returns (image, channel_names).

    image is float32 [H, W, C] with channels ordered R,G,B[,A] when those
    names exist, otherwise alphabetical (EXR storage order).
    """
    data = open(path, "rb").read()
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    if version & 0x1000 or version & 0x800:
        raise NotImplementedError("multi-part/deep EXR not supported")

    attrs, off = _read_attrs(data, 8)

    # channels
    chl = attrs["channels"][1]
    chans = []  # (name, pixel_type) in storage (alphabetical) order
    o = 0
    while chl[o] != 0:
        e = chl.index(b"\0", o)
        nm = chl[o:e].decode()
        o = e + 1
        pt = struct.unpack_from("<i", chl, o)[0]
        o += 16
        chans.append((nm, pt))

    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {comp} not supported")
    lpb = _LINES_PER_BLOCK[comp]
    nblocks = (H + lpb - 1) // lpb

    # line offset table
    offsets = struct.unpack_from(f"<{nblocks}Q", data, off)

    line_bytes = sum(_PT_SIZE[pt] for _, pt in chans) * W
    out = {nm: np.empty((H, W), _PT_DTYPE[pt]) for nm, pt in chans}

    for bi in range(nblocks):
        boff = offsets[bi]
        y, nbytes = struct.unpack_from("<iI", data, boff)
        raw = data[boff + 8 : boff + 8 + nbytes]
        ny = min(lpb, ymax + 1 - y)
        expect = line_bytes * ny
        if comp in (_ZIPS, _ZIP):
            if nbytes < expect:
                raw = _predictor_decode(bytearray(zlib.decompress(raw)))
        pos = 0
        for ly in range(ny):
            for nm, pt in chans:  # channels stored alphabetically per line
                sz = _PT_SIZE[pt] * W
                row = np.frombuffer(raw[pos : pos + sz], _PT_DTYPE[pt])
                out[nm][y - ymin + ly] = row
                pos += sz

    names = [nm for nm, _ in chans]
    order = [n for n in ("R", "G", "B", "A") if n in names]
    order += [n for n in names if n not in order]
    img = np.stack([out[n].astype(np.float32) for n in order], axis=-1)
    return img, order


def write(path, img, channel_names=None, compression="zip", pixel_type="half"):
    """Write a float32 [H, W, C] (or [H, W]) image as scanline EXR."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if channel_names is None:
        channel_names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[C]
    pt = {"half": _HALF, "float": _FLOAT}[pixel_type]
    comp = {"none": _NO_COMPRESSION, "zips": _ZIPS, "zip": _ZIP}[compression]
    lpb = _LINES_PER_BLOCK[comp]

    # EXR requires alphabetical channel storage order
    order = sorted(range(C), key=lambda i: channel_names[i])

    def attr(name, typ, payload):
        return (
            name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<I", len(payload)) + payload
        )

    chl = b""
    for i in order:
        chl += channel_names[i].encode() + b"\0"
        chl += struct.pack("<iiii", pt, 0, 1, 1)
    chl += b"\0"

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    hdr = struct.pack("<II", _MAGIC, 2)
    hdr += attr("channels", "chlist", chl)
    hdr += attr("compression", "compression", bytes([comp]))
    hdr += attr("dataWindow", "box2i", box)
    hdr += attr("displayWindow", "box2i", box)
    hdr += attr("lineOrder", "lineOrder", b"\0")
    hdr += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    hdr += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    hdr += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    hdr += b"\0"

    dt = _PT_DTYPE[pt]
    planes = [np.ascontiguousarray(img[:, :, i].astype(dt)) for i in order]

    nblocks = (H + lpb - 1) // lpb
    blocks = []
    for bi in range(nblocks):
        y0 = bi * lpb
        ny = min(lpb, H - y0)
        raw = b"".join(
            planes[ci][y0 + ly].tobytes()
            for ly in range(ny)
            for ci in range(C)
        )
        if comp in (_ZIPS, _ZIP):
            cz = zlib.compress(_predictor_encode(raw))
            payload = cz if len(cz) < len(raw) else raw
        else:
            payload = raw
        blocks.append(struct.pack("<iI", y0, len(payload)) + payload)

    table_off = len(hdr) + 8 * nblocks
    table = b""
    pos = table_off
    for b in blocks:
        table += struct.pack("<Q", pos)
        pos += len(b)

    with open(path, "wb") as f:
        f.write(hdr)
        f.write(table)
        for b in blocks:
            f.write(b)

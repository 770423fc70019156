"""Mitsuba .serialized mesh loader.

File layout (reference src/librender/trimesh.cpp:175-300, loadCompressed/
readHeader/readOffset): per mesh a {uint16 0x041C, uint16 version(3|4)}
header followed by one zlib stream containing
  uint32 flags, [v4: null-terminated name], uint64 vertexCount,
  uint64 triangleCount, positions, [normals], [texcoords], [colors],
  uint32 indices[3T]
with flags EHasNormals=1, EHasTexcoords=2, EHasColors=8, EFaceNormals=16,
ESinglePrecision=0x1000, EDoublePrecision=0x2000. A trailer stores the
mesh count (uint32) preceded by per-mesh byte offsets (u64 for v4,
u32 for v3).

The port's own copy of ppg_tpu/io/serialized.py.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

HEADER = 0x041C
E_HAS_NORMALS = 0x0001
E_HAS_TEXCOORDS = 0x0002
E_HAS_COLORS = 0x0008
E_FACE_NORMALS = 0x0010
E_SINGLE = 0x1000
E_DOUBLE = 0x2000


class _ZReader:
    """Incremental zlib reader over a byte buffer."""

    def __init__(self, buf, off):
        self._d = zlib.decompressobj()
        self._buf = buf
        self._off = off
        self._out = b""

    def read(self, n):
        while len(self._out) < n:
            chunk = self._buf[self._off:self._off + 65536]
            if not chunk:
                raise EOFError("serialized mesh: truncated zlib stream")
            self._off += len(chunk)
            self._out += self._d.decompress(chunk)
        r, self._out = self._out[:n], self._out[n:]
        return r

    def read_cstring(self):
        out = b""
        while True:
            c = self.read(1)
            if c == b"\0":
                return out.decode("utf-8", "replace")
            out += c


def _offsets(buf):
    (count,) = struct.unpack_from("<I", buf, len(buf) - 4)
    # probe v4 (u64 offsets) vs v3 (u32): the header at offset 0 pins
    # the version of mesh 0
    version = struct.unpack_from("<H", buf, 2)[0]
    if version == 4:
        base = len(buf) - 4 - 8 * count
        offs = struct.unpack_from(f"<{count}Q", buf, base)
    else:
        base = len(buf) - 4 - 4 * count
        offs = struct.unpack_from(f"<{count}I", buf, base)
    return list(offs)


def load_serialized(path, shape_index=0):
    """Returns dict(positions, faces, normals, texcoords, colors,
    face_normals) for one mesh in the file."""
    with open(path, "rb") as f:
        buf = f.read()
    fmt, version = struct.unpack_from("<HH", buf, 0)
    if fmt != HEADER:
        raise ValueError(f"{path}: bad magic 0x{fmt:04x}")
    off = 0
    if shape_index != 0:
        off = _offsets(buf)[shape_index]
        fmt, version = struct.unpack_from("<HH", buf, off)
        if fmt != HEADER:
            raise ValueError(f"{path}: bad sub-mesh magic at {off}")
    z = _ZReader(buf, off + 4)

    (flags,) = struct.unpack("<I", z.read(4))
    name = z.read_cstring() if version == 4 else ""
    vcount, tcount = struct.unpack("<QQ", z.read(16))
    ft = np.dtype("<f8") if flags & E_DOUBLE else np.dtype("<f4")

    def arr(n_elem, width):
        return np.frombuffer(
            z.read(ft.itemsize * n_elem * width), ft
        ).reshape(n_elem, width).astype(np.float64)

    positions = arr(vcount, 3)
    normals = arr(vcount, 3) if flags & E_HAS_NORMALS else None
    texcoords = arr(vcount, 2) if flags & E_HAS_TEXCOORDS else None
    colors = arr(vcount, 3) if flags & E_HAS_COLORS else None
    faces = np.frombuffer(z.read(4 * 3 * tcount), "<u4").reshape(
        tcount, 3).astype(np.int32)
    return dict(positions=positions, faces=faces, normals=normals,
                texcoords=texcoords, colors=colors, name=name,
                face_normals=bool(flags & E_FACE_NORMALS))


def save_serialized(path, meshes):
    """Write a v4 .serialized file (tooling + test fixture support).

    meshes: list of dicts with positions/faces and optional
    normals/texcoords/colors/name/face_normals."""
    blobs = []
    offsets = []
    pos = 0
    for m in meshes:
        flags = E_SINGLE
        if m.get("normals") is not None:
            flags |= E_HAS_NORMALS
        if m.get("texcoords") is not None:
            flags |= E_HAS_TEXCOORDS
        if m.get("colors") is not None:
            flags |= E_HAS_COLORS
        if m.get("face_normals"):
            flags |= E_FACE_NORMALS
        V = len(m["positions"])
        T = len(m["faces"])
        payload = struct.pack("<I", flags)
        payload += m.get("name", "").encode() + b"\0"
        payload += struct.pack("<QQ", V, T)
        payload += np.asarray(m["positions"], "<f4").tobytes()
        for k in ("normals", "texcoords", "colors"):
            if m.get(k) is not None:
                payload += np.asarray(m[k], "<f4").tobytes()
        payload += np.asarray(m["faces"], "<u4").tobytes()
        blob = struct.pack("<HH", HEADER, 4) + zlib.compress(payload)
        offsets.append(pos)
        blobs.append(blob)
        pos += len(blob)
    trailer = struct.pack(f"<{len(meshes)}Q", *offsets)
    trailer += struct.pack("<I", len(meshes))
    with open(path, "wb") as f:
        for b in blobs:
            f.write(b)
        f.write(trailer)

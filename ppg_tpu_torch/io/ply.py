"""Stanford PLY mesh loader (ascii + binary little/big endian).

Covers the property surface Mitsuba's ply shape consumes
(reference src/shapes/ply.cpp + vendored libply): vertex x/y/z,
optional nx/ny/nz normals, u/v (or s/t / texture_u/texture_v)
texture coordinates, red/green/blue vertex colors, and face
vertex_indices lists (triangulated as fans).

The port's own copy of ppg_tpu/io/ply.py.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_UV_NAMES = {"u": 0, "v": 1, "s": 0, "t": 1, "texture_u": 0, "texture_v": 1}


def load_ply(path):
    """Returns dict(positions [V,3] f64, faces [F,3] i32, normals
    [V,3]|None, texcoords [V,2]|None, colors [V,3]|None)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype, is_list, idx_t)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            toks = line.decode("ascii", "replace").strip().split()
            if not toks or toks[0] == "comment" or toks[0] == "obj_info":
                continue
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                elements.append((toks[1], int(toks[2]), []))
            elif toks[0] == "property":
                if toks[1] == "list":
                    elements[-1][2].append(
                        (toks[4], _TYPES[toks[3]], True, _TYPES[toks[2]]))
                else:
                    elements[-1][2].append(
                        (toks[2], _TYPES[toks[1]], False, None))
            elif toks[0] == "end_header":
                break
        if fmt == "ascii":
            data = _read_ascii(f, elements)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            data = _read_binary(f, elements, endian)

    out = dict(positions=None, faces=None, normals=None,
               texcoords=None, colors=None)
    for name, _count, props, cols in data:
        if name == "vertex":
            byname = {p[0]: cols[i] for i, p in enumerate(props)}
            V = len(byname["x"])
            out["positions"] = np.stack(
                [byname["x"], byname["y"], byname["z"]], -1).astype(np.float64)
            if "nx" in byname:
                out["normals"] = np.stack(
                    [byname["nx"], byname["ny"], byname["nz"]], -1
                ).astype(np.float64)
            uv = np.zeros((V, 2))
            got_uv = False
            for k, i in _UV_NAMES.items():
                if k in byname:
                    uv[:, i] = byname[k]
                    got_uv = True
            if got_uv:
                out["texcoords"] = uv
            if "red" in byname:
                c = np.stack(
                    [byname["red"], byname["green"], byname["blue"]], -1
                ).astype(np.float64)
                # integer color encodings are 0-255
                if byname["red"].dtype.kind in "ui":
                    c = c / 255.0
                out["colors"] = c
        elif name == "face":
            for i, p in enumerate(props):
                if p[0] in ("vertex_indices", "vertex_index"):
                    out["faces"] = _triangulate(cols[i])
    if out["positions"] is None or out["faces"] is None:
        raise ValueError(f"{path}: missing vertex or face element")
    return out


def _triangulate(lists):
    tris = []
    for idx in lists:
        for k in range(1, len(idx) - 1):
            tris.append((idx[0], idx[k], idx[k + 1]))
    return np.asarray(tris, np.int32)


def _read_ascii(f, elements):
    out = []
    text = f.read().decode("ascii", "replace").split()
    pos = 0
    for name, count, props in elements:
        cols = [[] for _ in props]
        for _ in range(count):
            for i, (_pn, dt, is_list, _it) in enumerate(props):
                if is_list:
                    n = int(text[pos]); pos += 1
                    cols[i].append(
                        [int(float(x)) for x in text[pos:pos + n]])
                    pos += n
                else:
                    cols[i].append(float(text[pos])); pos += 1
        cols = [c if props[i][2] else np.asarray(c, props[i][1])
                for i, c in enumerate(cols)]
        out.append((name, count, props, cols))
    return out


def _read_binary(f, elements, endian):
    buf = f.read()
    out = []
    off = 0
    for name, count, props, in elements:
        if not any(p[2] for p in props):
            # fixed stride: one structured read
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            arr = np.frombuffer(buf, dt, count, off)
            off += dt.itemsize * count
            cols = [arr[p[0]] for p in props]
            out.append((name, count, props, cols))
            continue
        # list properties: try the common uniform-arity fast path first
        if len(props) == 1 and props[0][2]:
            pn, dt, _is_list, it = props[0]
            nt = np.dtype(endian + it)
            vt = np.dtype(endian + dt)
            n0 = int(np.frombuffer(buf, nt, 1, off)[0])
            stride = nt.itemsize + n0 * vt.itemsize
            if off + stride * count <= len(buf):
                raw = np.frombuffer(buf, np.uint8, stride * count, off)
                raw = raw.reshape(count, stride)
                ns = raw[:, :nt.itemsize].copy().view(nt)[:, 0]
                if np.all(ns == n0):
                    vals = raw[:, nt.itemsize:].copy().view(vt)
                    off += stride * count
                    out.append((name, count, props, [list(vals)]))
                    continue
        # general slow path
        cols = [[] for _ in props]
        for _ in range(count):
            for i, (_pn, dt, is_list, it) in enumerate(props):
                if is_list:
                    nt = np.dtype(endian + it)
                    n = int(np.frombuffer(buf, nt, 1, off)[0])
                    off += nt.itemsize
                    vt = np.dtype(endian + dt)
                    cols[i].append(np.frombuffer(buf, vt, n, off))
                    off += vt.itemsize * n
                else:
                    vt = np.dtype(endian + dt)
                    cols[i].append(np.frombuffer(buf, vt, 1, off)[0])
                    off += vt.itemsize
        cols = [c if props[i][2] else np.asarray(c, props[i][1])
                for i, c in enumerate(cols)]
        out.append((name, count, props, cols))
    return out

"""Wavefront OBJ loader -> indexed triangle arrays.

Mirrors the behavior of the reference loader (mitsuba/src/shapes/obj.cpp):
polygon fan triangulation, negative indices, per-corner v/vt/vn index
triples deduplicated into unified vertices. Materials/groups are flattened
into one mesh per file — the scene XML assigns one BSDF per <shape> in all
bundled scenes, so group splitting is unnecessary.

The port's own copy of ppg_tpu/io/obj.py.
"""

from __future__ import annotations

import numpy as np


def load_obj(path):
    positions, normals, texcoords = [], [], []
    corners = []  # (vi, ti, ni) per triangle corner

    with open(path, "rb") as f:
        data = f.read().decode("utf-8", "replace")

    for line in data.splitlines():
        if not line or line[0] not in "vf":  # skip comments/groups/usemtl fast
            continue
        parts = line.split()
        if not parts:
            continue
        key = parts[0]
        if key == "v":
            positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "vn":
            normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "vt":
            texcoords.append((float(parts[1]), float(parts[2])))
        elif key == "f":
            face = []
            for tok in parts[1:]:
                sub = tok.split("/")
                vi = int(sub[0])
                ti = int(sub[1]) if len(sub) > 1 and sub[1] else 0
                ni = int(sub[2]) if len(sub) > 2 and sub[2] else 0
                face.append((vi, ti, ni))
            for k in range(1, len(face) - 1):  # fan triangulation
                corners.extend((face[0], face[k], face[k + 1]))

    nv, nt, nn = len(positions), len(texcoords), len(normals)

    def fix(idx, count):
        return idx - 1 if idx > 0 else (count + idx if idx < 0 else -1)

    corner_arr = np.array(
        [(fix(v, nv), fix(t, nt), fix(n, nn)) for v, t, n in corners], np.int64
    ).reshape(-1, 3)

    # unify distinct (v, t, n) triples
    uniq, inverse = np.unique(corner_arr, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)

    pos = np.asarray(positions, np.float64)[uniq[:, 0]]
    uv = (
        np.asarray(texcoords, np.float64)[uniq[:, 1]]
        if nt and (uniq[:, 1] >= 0).all()
        else None
    )
    nrm = (
        np.asarray(normals, np.float64)[uniq[:, 2]]
        if nn and (uniq[:, 2] >= 0).all()
        else None
    )
    return {"positions": pos, "normals": nrm, "texcoords": uv, "faces": faces}

"""Mitsuba .hair file loader (src/shapes/hair.cpp:637-780): binary
("BINARY_HAIR" header, uint32 vertex count, float triples, +inf x marks
a new fiber) and whitespace text (one "x y z" per line, blank line
separates fibers).

The port's own copy of ppg_tpu/io/hair.py.
"""

from __future__ import annotations

import struct

import numpy as np


def load_hair(path):
    """-> (vertices [N,3] f64, starts_fiber [N] bool)."""
    with open(path, "rb") as f:
        head = f.read(11)
        if head == b"BINARY_HAIR":
            (count,) = struct.unpack("<I", f.read(4))
            raw = np.frombuffer(f.read(), "<f4")
            verts = []
            starts = []
            i = 0
            new_fiber = True
            while len(verts) < count and i < len(raw):
                if np.isinf(raw[i]):
                    i += 1
                    new_fiber = True
                verts.append(raw[i:i + 3])
                starts.append(new_fiber)
                new_fiber = False
                i += 3
            return (np.asarray(verts, np.float64),
                    np.asarray(starts, bool))
    verts = []
    starts = []
    new_fiber = True
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                new_fiber = True
                continue
            verts.append([float(parts[0]), float(parts[1]),
                          float(parts[2])])
            starts.append(new_fiber)
            new_fiber = False
    return np.asarray(verts, np.float64), np.asarray(starts, bool)

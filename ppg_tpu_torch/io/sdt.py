""".sdt SD-tree snapshots (counterpart of ppg_tpu/io/sdt.py), the
reference visualizer's format (BlobWriter + STree::dump +
DTreeWrapper::dump, guided_path.cpp:35-57, 699-711, 945-951, 1191-1208):

  16 x f32 camera matrix, then per spatial leaf with statWeight > 0:
    pos(3 f32), size(3 f32), mean(f32), statWeight(u64), numNodes(u64),
    numNodes x 4 x { sum(f32), child(u16) }   (local child indices, 0=leaf)

numpy only; `dump_sdtree` reads the port's HostSDTree (guiding/host.py).
"""

from __future__ import annotations

import struct

import numpy as np

_NODE = np.dtype([("sum", "<f4"), ("child", "<u2")])


def dump_sdtree(path, host_tree, camera_matrix):
    """Writes host_tree's sampling trees and camera_matrix [4,4] to
    `path`."""
    pos, size = host_tree.leaf_boxes()
    with open(path, "wb") as f:
        f.write(np.asarray(camera_matrix, np.float32).tobytes())
        for t in range(host_tree.num_dtrees):
            statw = host_tree.statw_s[t]
            if not statw > 0:
                continue
            off = int(host_tree.s_off[t])
            cnt = int(host_tree.s_cnt[t])
            mean = host_tree.sum_s[t] / (4 * np.pi * statw)
            f.write(struct.pack("<6f f QQ", *pos[t], *size[t], mean,
                                int(statw), cnt))
            kids = host_tree.qs_child[off:off + cnt]
            rec = np.zeros((cnt, 4), dtype=_NODE)
            rec["sum"] = host_tree.qs_sum[off:off + cnt].astype(np.float32)
            rec["child"] = np.where(kids >= 0, kids - off, 0).astype(
                np.uint16)
            f.write(rec.tobytes())


def read_sdt(path):
    """(camera [4,4], [dict(pos, size, mean, stat_weight, sums [n,4],
    children [n,4]) per leaf]) of an .sdt file."""
    with open(path, "rb") as f:
        data = f.read()
    cam = np.frombuffer(data[:64], "<f4").reshape(4, 4)
    off = 64
    trees = []
    while off < len(data):
        px, py, pz, sx, sy, sz, mean = struct.unpack_from("<7f", data, off)
        off += 28
        statw, nnodes = struct.unpack_from("<QQ", data, off)
        off += 16
        rec = np.frombuffer(data[off:off + nnodes * 24], dtype=_NODE) \
            .reshape(nnodes, 4)
        off += nnodes * 24
        trees.append(dict(pos=(px, py, pz), size=(sx, sy, sz), mean=mean,
                          stat_weight=statw, sums=rec["sum"].copy(),
                          children=rec["child"].copy()))
    return cam, trees

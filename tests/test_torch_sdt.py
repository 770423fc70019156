""".sdt dumps (ppg_tpu_torch/io/sdt.py) against ppg_tpu's: a host SD-tree
trained by a short CPU render of the port (several spatial leaves, refined
quadtrees) is copied into ppg_tpu's HostSDTree, and both packages' dumps
of it are the same bytes; read_sdt gives back the leaves of positive
statistical weight, their boxes (HostSDTree.leaf_boxes, equal to
ppg_tpu's), means, sums and local child indices."""

import copy

import numpy as np
import pytest
import torch

from ppg_tpu.guiding.host import HostSDTree as JHost
from ppg_tpu.io import sdt as JSdt
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.io import sdt as TSdt
from ppg_tpu_torch.scene import mini_cbox


@pytest.fixture(scope="module")
def trees():
    """(the port's host tree as its last training iteration left it, the
    tree a dump writes; ppg_tpu's copy of it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = GuidedPathTracer(mini_cbox(res=16, budget=28, max_depth=4),
                              chunk=256, overrides=dict(sTreeThreshold=20),
                              device="cpu")
        dumped = []
        tr.dump_sdtree = True
        tr._dump = lambda it: dumped.append(copy.deepcopy(tr.host_tree))
        tr.render(seed=0)
    finally:
        torch.set_num_threads(n)
    port = dumped[-1]
    ref = JHost(port.aabb_min, port.aabb_min + port.aabb_size)
    ref.__dict__.update({k: np.copy(v) if isinstance(v, np.ndarray) else v
                         for k, v in vars(port).items()})
    return port, ref


def test_dump_bytes_equal_ppg_tpu(trees, tmp_path):
    port, ref = trees
    assert port.num_dtrees > 4 and int((port.statw_s > 0).sum()) > 4
    for got, want in zip(port.leaf_boxes(), ref.leaf_boxes()):
        np.testing.assert_array_equal(got, want)
    cam = np.arange(16, dtype=np.float64).reshape(4, 4) * 0.25
    TSdt.dump_sdtree(str(tmp_path / "port.sdt"), port, cam)
    JSdt.dump_sdtree(str(tmp_path / "ref.sdt"), ref, cam)
    got = (tmp_path / "port.sdt").read_bytes()
    assert got == (tmp_path / "ref.sdt").read_bytes()
    assert len(got) > 64 + 5 * 44


def test_read_sdt_round_trips(trees, tmp_path):
    port, _ = trees
    path = str(tmp_path / "t.sdt")
    cam = np.eye(4) * 2.0
    TSdt.dump_sdtree(path, port, cam)
    got_cam, recs = TSdt.read_sdt(path)
    np.testing.assert_array_equal(got_cam, cam.astype(np.float32))
    pos, size = port.leaf_boxes()
    kept = [t for t in range(port.num_dtrees) if port.statw_s[t] > 0]
    assert len(recs) == len(kept)
    for rec, t in zip(recs, kept):
        off, cnt = int(port.s_off[t]), int(port.s_cnt[t])
        np.testing.assert_array_equal(rec["pos"], pos[t].astype(np.float32))
        np.testing.assert_array_equal(rec["size"],
                                      size[t].astype(np.float32))
        assert rec["stat_weight"] == int(port.statw_s[t])
        assert rec["mean"] == np.float32(
            port.sum_s[t] / (4 * np.pi * port.statw_s[t]))
        np.testing.assert_array_equal(
            rec["sums"], port.qs_sum[off:off + cnt].astype(np.float32))
        kids = port.qs_child[off:off + cnt]
        np.testing.assert_array_equal(rec["children"],
                                      np.where(kids >= 0, kids - off, 0))
    assert TSdt.read_sdt(path)[1][0].keys() == JSdt.read_sdt(path)[1][0] \
        .keys()

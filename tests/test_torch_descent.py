"""The SD-tree descent kernels' source (ppg_tpu_torch/csrc/sdtree.cu: K3,
the spatial lookup with the dtree meta, and K4, the quadtree
sample-and-pdf walk with its point mode), compiled for the CPU against
tools/cuda_shim.py, held bit for bit against the plain versions in
guiding/sdtree.py: lookup_plain, lookup_meta_plain, dtree_meta_plain,
sample_pdf_canonical_plain and pdf_dir2.

Every result is compared bit for bit except the learned fraction: K3
computes 1 / (1 + expf(-v)) with the C library's expf (on a card, the
CUDA math library's, as torch.sigmoid there), and PyTorch's CPU sigmoid
takes its own vectorised exp. Over Adam's range of v, [-20, 20], the two
differ on about 4% of the values, by at most 4 units in the last place
(ulp; 2 ulp above v = -10), so frac is held within FRAC_ULP = 4 ulp here
(test_fraction_within_ulps_over_the_adam_range); on a card it is held
bit for bit.

The inputs: the refined tree of tests/test_packed_descent.py brought
across with convert.sdtree_from_numpy; a tree whose quadtree chain runs
past the 20-level cap and whose spatial chain runs past s_depth; a tree
with uniform dtrees, all-zero nodes and zero quadrants; lanes with dtree
id -1, masked lanes, positions on the split planes (0.5) and on the box's
far faces (1.0), outside the box, NaN and +-inf, and NaN and +-inf
directions and canonical points. The kernels themselves run on a card in
test_torch_descent_gpu.py."""

import ctypes
import os

import numpy as np
import pytest
import torch

from ppg_tpu_torch.guiding import descent as D
from ppg_tpu_torch.guiding import sdtree as TG
from ppg_tpu_torch.tools import cuda_shim
from ppg_tpu_torch.tools import sdtree_cases as C
from test_torch_sdtree import _port_tree

FRAC_ULP = 4


@pytest.fixture(scope="module")
def trees():
    from test_packed_descent import _refined_tree

    return {"refined": _port_tree(_refined_tree().push()),
            "deep": C.deep_tree(False), "capped": C.deep_tree(True),
            "flat": C.flat_tree()}


TREES = ["refined", "deep", "capped", "flat"]


@pytest.fixture(scope="module")
def host_sd(tmp_path_factory):
    """csrc/sdtree.cu built for the CPU (tools/cuda_shim.build_host).
    Returns (k3, k4): k3(sdt, p=None, mask=None, ids=None, meta=True) ->
    (id, voxel, root, uniform, frac), k4(sdt, pp, root, uniform, u=None,
    is_point=None) -> (pfin, pdf), with None for what a mode does not
    write."""
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    from ppg_tpu_torch.native import CSRC

    lib = cuda_shim.build_host(os.path.join(CSRC, "sdtree.cu"),
                               str(tmp_path_factory.mktemp("sd_host")),
                               "sd_host", launches=2)
    lib.ppg_sd_lookup.argtypes = D.LOOKUP_ARGTYPES
    lib.ppg_sd_sample_pdf.argtypes = D.WALK_ARGTYPES
    lib.ppg_sd_lookup.restype = lib.ppg_sd_sample_pdf.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()

    def k3(sdt, p=None, mask=None, ids=None, meta=True):
        L = (p if p is not None else ids).shape[0]
        out = [None] * 5
        if p is not None:
            out[0] = torch.full((L,), 77, dtype=torch.int32)
            out[1] = torch.full((L, 3), np.nan)
        if meta:
            out[2] = torch.full((L,), 77, dtype=torch.int32)
            out[3] = torch.full((L,), 7, dtype=torch.uint8)
            out[4] = torch.full((L,), np.nan)
        assert lib.ppg_sd_lookup(
            ptr(p), sdt.aabb_min.data_ptr(), sdt.aabb_size.data_ptr(),
            sdt.s_child.data_ptr(), sdt.s_dtree.data_ptr(), sdt.s_depth,
            ptr(mask), ptr(ids), sdt.ds_root.data_ptr(),
            sdt.ds_sum.data_ptr(), sdt.ds_statw.data_ptr(),
            sdt.opt_var.data_ptr(), L, *map(ptr, out), 0, None) == 0
        if meta:
            assert int(out[3].max()) <= 1
            out[3] = out[3].bool()
        return out

    def k4(sdt, pp, root, uniform, u=None, is_point=None):
        L = pp.shape[0]
        pfin = torch.full((L, 2), np.nan) if u is not None else None
        pdf = torch.full((L,), np.nan)
        assert lib.ppg_sd_sample_pdf(
            sdt.qs_sum.data_ptr(), sdt.qs_child.data_ptr(),
            sdt.qs_sum.shape[0], sdt.q_depth, ptr(u), ptr(is_point),
            pp.data_ptr(), root.data_ptr(), uniform.data_ptr(), L,
            ptr(pfin), pdf.data_ptr(), 0, None) == 0
        return pfin, pdf

    return k3, k4


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), int((a != b).sum())


def _ulps(a, b):
    """Units in the last place between float32 arrays of one sign."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


@pytest.mark.parametrize("name", TREES)
def test_lookup_kernel_equals_plain(host_sd, trees, name):
    """K3 without meta: the dtree id and the voxel bit for bit."""
    k3, _ = host_sd
    sdt = trees[name]
    p = C.positions(sdt, np.random.default_rng(1), 3000)
    got = k3(sdt, p=p, meta=False)
    want_id, want_vox, stats = TG.lookup_plain(sdt, p, return_stats=True)
    _same_bits(got[0], want_id)
    _same_bits(got[1], want_vox)
    if name == "deep":  # the far corner walks the whole spatial chain
        assert int(stats["levels"].max()) == 30
    if name == "capped":  # and stops at s_depth on an internal node
        assert int(stats["levels"].max()) == 24
        assert bool((want_id < 0).any())


@pytest.mark.parametrize("name", TREES)
def test_lookup_meta_kernel_equals_plain(host_sd, trees, name):
    """K3 with the mask and the meta against lookup_meta_plain, and in
    its ids mode against dtree_meta_plain (ids -1 among them): all bit
    for bit but frac, which is within FRAC_ULP."""
    k3, _ = host_sd
    sdt = trees[name]
    rng = np.random.default_rng(2)
    p = C.positions(sdt, rng, 3000)
    mask = torch.from_numpy(rng.random(3000) < 0.8)
    got = k3(sdt, p=p, mask=mask)
    want = TG.lookup_meta_plain(sdt, p, mask)
    for a, b in zip(got[:4], want[:4]):
        _same_bits(a, b)
    assert bool((got[0] == -1).any()) and not bool(got[3].all())
    assert int(_ulps(got[4], want[4]).max()) <= FRAC_ULP
    ids = C.walk_inputs(sdt, rng, 3000)[3]
    got = k3(sdt, ids=ids)
    want = TG.dtree_meta_plain(sdt, ids)
    _same_bits(got[2], want[0])
    _same_bits(got[3], want[1])
    assert int(_ulps(got[4], want[2]).max()) <= FRAC_ULP
    assert got[0] is None and got[1] is None


@pytest.mark.parametrize("name", TREES)
def test_walk_kernel_equals_plain(host_sd, trees, name):
    """K4 on sampling and point lanes against sample_pdf_canonical_plain:
    the canonical point and the pdf bit for bit, on every lane."""
    _, k4 = host_sd
    sdt = trees[name]
    u, is_point, pc, ids = C.walk_inputs(sdt, np.random.default_rng(3), 4096)
    root, uniform, _ = TG.dtree_meta_plain(sdt, ids)
    pfin, pdf = k4(sdt, pc, root, uniform, u=u, is_point=is_point)
    want_p, want_pdf, stats = TG.sample_pdf_canonical_plain(
        sdt, u, is_point, pc, root, uniform, return_stats=True)
    _same_bits(pfin, want_p)
    _same_bits(pdf, want_pdf)
    if name != "flat":
        assert len(pdf.unique()) > 20
    if name in ("deep", "capped"):  # lanes walk the 20 levels to the cap
        assert int(stats["levels"].max()) == TG.MAX_Q_DEPTH
        assert bool((pdf == 0).any())  # the all-zero root kills its lanes


@pytest.mark.parametrize("name", TREES)
def test_walk_point_mode_equals_pdf_dir2(host_sd, trees, name):
    """K4's point mode (no uniforms read) against pdf_dir2's plain walk at
    world directions, NaN and +-inf directions among them."""
    _, k4 = host_sd
    sdt = trees[name]
    rng = np.random.default_rng(4)
    L = 4096
    d = C.unit(rng, L)
    d[:4] = [[np.nan, 0, 1], [np.inf, 0, 0], [0, -np.inf, 0], [0, 0, -1]]
    d = torch.from_numpy(d)
    ids = torch.from_numpy(rng.integers(-1, sdt.ds_root.shape[0], L)
                           .astype(np.int32))
    root, uniform, _ = TG.dtree_meta_plain(sdt, ids)
    got = k4(sdt, TG.dir_to_canonical(d).contiguous(), root, uniform)
    assert got[0] is None
    _same_bits(got[1], TG.pdf_dir2(sdt, d, root, uniform))


def test_the_wrappers_take_only_card_tensors(trees):
    """The public functions take the plain versions on the CPU; the
    kernels' wrappers refuse CPU tensors rather than fall back."""
    sdt = trees["refined"]
    p = C.positions(sdt, np.random.default_rng(5), 128)
    D.reset_counts()
    assert all(torch.equal(a, b) for a, b in zip(
        TG.lookup(sdt, p), TG.lookup_plain(sdt, p)))
    assert D.COUNTS == {"sd_lookup": 0, "sd_sample_pdf": 0,
                        "sd_plain_on_cuda": 0}
    with pytest.raises(ValueError, match="contiguous on cuda"):
        D.lookup(sdt, p)
    ids = torch.zeros(128, dtype=torch.int32)
    root, uniform, _ = TG.dtree_meta(sdt, ids)
    with pytest.raises(ValueError, match="contiguous on cuda"):
        D.pdf_point(sdt, torch.zeros(128, 2), root, uniform)
    assert D.COUNTS["sd_lookup"] == D.COUNTS["sd_sample_pdf"] == 0


def test_walk_stats_count_the_levels_read(trees):
    """The plain walks' stats (chip_smoke.py's bound counts them): a lane
    that stops at a root leaf reads one node, a uniform lane none."""
    sdt = trees["flat"]
    ids = torch.tensor([0, 1, 2, -1], dtype=torch.int32)
    root, uniform, _ = TG.dtree_meta_plain(sdt, ids)
    assert uniform.tolist() == [True, False, False, True]
    u = torch.full((4, TG.MAX_Q_DEPTH + 2), 0.5)
    _, pdf, st = TG.sample_pdf_canonical_plain(
        sdt, u, torch.zeros(4, dtype=torch.bool), torch.zeros(4, 2), root,
        uniform, return_stats=True)
    assert st["levels"].tolist() == [0, 1, 1, 0]
    assert st["nodes"].tolist() == [0, 1]
    # the all-zero root is degenerate (pdf 0); the other lane picks a
    # quadrant holding 3 of 4: 4 * 3/4 / (4 pi)
    assert pdf[1] == 0.0 and float(pdf[2]) == pytest.approx(
        3.0 / (4 * np.pi))


def test_fraction_within_ulps_over_the_adam_range(host_sd):
    """K3's ids mode on 200,001 dtrees whose opt_var sweeps Adam's clamp
    range [-20, 20]: root and uniform bit for bit, frac within FRAC_ULP of
    torch.sigmoid (the host C library's expf against PyTorch's CPU exp),
    and equal on most of them."""
    k3, _ = host_sd
    v = torch.linspace(-20.0, 20.0, 200_001)
    T = v.numel()
    sdt = C.tree(np.full((1, 2), -1, np.int32), np.zeros(1, np.int32), 4,
                np.ones((1, 4), np.float32), np.full((1, 4), -1, np.int32),
                np.zeros(T, np.int32), np.ones(T, np.float32),
                np.ones(T, np.float32), v.numpy(), 4)
    ids = torch.arange(-1, T, dtype=torch.int32)
    got = k3(sdt, ids=ids)
    want = TG.dtree_meta_plain(sdt, ids)
    _same_bits(got[2], want[0])
    _same_bits(got[3], want[1])
    ulps = _ulps(got[4], want[2])
    assert int(ulps.max()) <= FRAC_ULP
    assert float((ulps > 0).float().mean()) < 0.1
    assert float(got[4][0]) == 0.5  # id -1

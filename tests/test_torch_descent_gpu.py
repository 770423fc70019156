"""The CUDA SD-tree descent kernels (ppg_tpu_torch/csrc/sdtree.cu: K3,
the spatial lookup with the dtree meta, and K4, the sample-and-pdf walk
with its point mode) against their plain PyTorch versions in
guiding/sdtree.py, on a card: the edge-case trees and lanes of
tools/sdtree_cases.py and the tree a short guided render of the Cornell
box trained. Every result must be equal bit for bit, the learned
fraction included (K3 and torch.sigmoid both take the CUDA math
library's expf). The kernels have no CPU mode, so the `gpu` tests run
only on a card and skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_descent_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.guiding import descent as D
from ppg_tpu_torch.guiding import sdtree as TG
from ppg_tpu_torch.tools import sdtree_cases as C


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), int((a != b).sum())


@pytest.fixture(scope="module")
def trees():
    """The edge-case trees and a trained one, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.scene import mini_cbox

    tracer = GuidedPathTracer(mini_cbox(res=64, budget=28, max_depth=6,
                                        nee="never"), chunk=4096,
                              device="cuda")
    with C.capture_sampling_trees(tracer) as seen:
        tracer.render(seed=0)
    trained = seen[-1]
    assert trained.qs_sum.shape[0] > 100 and trained.s_dtree.shape[0] > 1
    capped = C.deep_tree(True)
    recap = lambda s_depth: TG.SDTreeArrays(s_depth, capped.q_depth, **{
        f: getattr(capped, f) for f in TG.SDTreeArrays.FIELDS})
    return {"trained": trained,
            **{k: C.to_device(t, "cuda") for k, t in (
                ("deep", C.deep_tree(False)), ("capped", capped),
                ("flat", C.flat_tree()), ("grid", C.grid_tree(8)),
                ("capped 23", recap(23)), ("capped 25", recap(25)))}}


def _cuda(*ts):
    return [t.cuda() for t in ts]


TREES = ["trained", "deep", "capped", "flat"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", TREES + ["grid", "capped 23",
                                          "capped 25"])
def test_lookup_kernels_match_plain_bitwise_on_card(trees, name):
    """K3 alone, with the mask and the meta, and in its ids mode; the
    ragged L = 3000 ends in a partial block. The deep tree walks 31
    levels, the capped ones 24, 23 and 25 (single levels after the
    octant steps), the grid 9."""
    sdt = trees[name]
    rng = np.random.default_rng(1)
    p, = _cuda(C.positions(sdt, rng, 3000))
    mask = torch.from_numpy(rng.random(3000) < 0.8).cuda()
    ids = C.walk_inputs(sdt, rng, 3000)[3].cuda()
    D.reset_counts()
    got = TG.lookup(sdt, p)
    got_meta = TG.lookup_meta(sdt, p, mask)
    got_ids = TG.dtree_meta(sdt, ids)
    torch.cuda.synchronize()
    assert D.COUNTS == {"sd_lookup": 3, "sd_sample_pdf": 0,
                        "sd_plain_on_cuda": 0}
    for a, b in zip(got, TG.lookup_plain(sdt, p)):
        _same_bits(a, b)
    for a, b in zip(got_meta, TG.lookup_meta_plain(sdt, p, mask)):
        _same_bits(a, b)
    for a, b in zip(got_ids, TG.dtree_meta_plain(sdt, ids)):
        _same_bits(a, b)
    assert bool((got_meta[0] == -1).any())


@pytest.mark.gpu
@pytest.mark.parametrize("name", TREES)
def test_walk_kernels_match_plain_bitwise_on_card(trees, name):
    """K4 on sampling and point lanes, and in point mode (pdf_dir2)."""
    sdt = trees[name]
    rng = np.random.default_rng(2)
    L = 4097
    u, is_point, pc, ids = _cuda(*C.walk_inputs(sdt, rng, L))
    assert u.stride() == (1, L)  # level-major, as the tracer draws it
    root, uniform, _ = TG.dtree_meta_plain(sdt, ids)
    d = torch.from_numpy(C.unit(rng, L)).cuda()
    d[:3] = torch.tensor([[np.nan, 0, 1], [np.inf, 0, 0], [0, 0, -1]])
    D.reset_counts()
    got_d, got_pdf = TG.sample_pdf_dir(sdt, u, is_point, pc, root, uniform)
    got_nee = TG.pdf_dir2(sdt, d, root, uniform)
    pfin, _ = D.sample_pdf(sdt, u, is_point, pc, root, uniform)
    torch.cuda.synchronize()
    assert D.COUNTS["sd_sample_pdf"] == 3
    want_p, want_pdf = TG.sample_pdf_canonical_plain(sdt, u, is_point, pc,
                                                     root, uniform)
    _same_bits(pfin, want_p)
    _same_bits(got_pdf, want_pdf)
    _same_bits(got_d, TG.canonical_to_dir(want_p))
    want_nee = TG.sample_pdf_canonical_plain(
        sdt, torch.zeros_like(u), torch.ones_like(is_point),
        TG.dir_to_canonical(d), root, uniform)[1]
    _same_bits(got_nee, want_nee)
    if name != "flat":
        assert len(got_pdf.unique()) > 20


@pytest.mark.gpu
@pytest.mark.parametrize("name", TREES)
def test_walk_kernel_reads_any_u_layout_through_its_strides_on_card(
        trees, name):
    """The kernel takes u through its strides: on the lane-major copy of
    the same values (which the wrapper refuses) it gives the same bits
    as on the level-major u; and each qs_row holds its tree's sums and
    children."""
    sdt = trees[name]
    rng = np.random.default_rng(3)
    L = 4097
    u, is_point, pc, ids = _cuda(*C.walk_inputs(sdt, rng, L))
    root, uniform, _ = TG.dtree_meta_plain(sdt, ids)
    assert torch.equal(sdt.qs_row[:, :4].contiguous().view(torch.float32),
                       sdt.qs_sum)
    assert torch.equal(sdt.qs_row[:, 4:], sdt.qs_child)
    want = D.sample_pdf(sdt, u, is_point, pc, root, uniform)
    rows = u.contiguous()
    got = (torch.full((L, 2), np.nan, device="cuda"),
           torch.full((L,), np.nan, device="cuda"))
    assert D.build().ppg_sd_sample_pdf(
        sdt.qs_row.data_ptr(), sdt.qs_sum.shape[0], sdt.q_depth,
        rows.data_ptr(), 1, rows.shape[1], is_point.data_ptr(),
        pc.data_ptr(), root.data_ptr(), uniform.data_ptr(), L,
        got[0].data_ptr(), got[1].data_ptr(), 0,
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _same_bits(a, b)
    with pytest.raises(ValueError, match="strides"):
        D.sample_pdf(sdt, rows, is_point, pc, root, uniform)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(trees):
    sdt = trees["trained"]
    p = torch.rand(64, 3, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        TG.lookup(sdt, p.T.contiguous().T)
    with pytest.raises(ValueError, match="want"):
        TG.lookup(sdt, p.double())
    ids = torch.zeros(64, dtype=torch.int32, device="cuda")
    root, uniform, _ = TG.dtree_meta(sdt, ids)
    with pytest.raises(ValueError, match="want"):
        TG.sample_pdf_dir(sdt, torch.rand(64, 21, device="cuda"),
                          uniform, torch.rand(64, 2, device="cuda"), root,
                          uniform)
    stale = C.to_device(sdt, "cpu")  # a copy: the trained tree stays
    stale = C.to_device(stale, "cuda")
    stale.qs_sum.mul_(2.0)
    u = torch.rand(TG.MAX_Q_DEPTH + 2, 64, device="cuda").t()
    with pytest.raises(ValueError, match="stale"):
        TG.sample_pdf_dir(stale, u, uniform,
                          torch.rand(64, 2, device="cuda"), root, uniform)


@pytest.mark.gpu
def test_rows_hold_their_tables_and_stale_rows_are_refused_on_card(trees):
    """s_row, s_oct and ds_row, built on the card with the tree, equal the
    rows built from the same tables on the CPU; a row whose tables changed
    since is refused, and a rebuilt one is taken."""
    sdt = trees["trained"]
    cpu = C.to_device(sdt, "cpu")
    for row in ("s_row", "s_oct", "ds_row"):
        assert torch.equal(getattr(sdt, row).cpu(), getattr(cpu, row))
    copy = C.to_device(cpu, "cuda")  # rows of its own
    p = C.positions(copy, np.random.default_rng(4), 256).cuda()
    copy.ds_statw.mul_(2.0)
    with pytest.raises(ValueError, match="ds_row is stale"):
        TG.lookup_meta(copy, p)
    TG.lookup(copy, p)  # the lookup alone reads no ds_row
    copy.s_child = copy.s_child.clone()
    with pytest.raises(ValueError, match="s_row is stale"):
        TG.lookup(copy, p)
    copy.s_row, copy.s_oct, copy.s_row_stamp = D.spatial_rows(
        copy.s_child, copy.s_dtree, copy.aabb_min, copy.aabb_size)
    copy.ds_row, copy.ds_row_stamp = D.meta_rows(
        copy.ds_root, copy.ds_sum, copy.ds_statw)
    for a, b in zip(TG.lookup_meta(copy, p), TG.lookup_meta_plain(copy, p)):
        _same_bits(a, b)

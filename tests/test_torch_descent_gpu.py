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
    return {"trained": trained,
            **{k: C.to_device(t, "cuda") for k, t in (
                ("deep", C.deep_tree(False)), ("capped", C.deep_tree(True)),
                ("flat", C.flat_tree()))}}


def _cuda(*ts):
    return [t.cuda() for t in ts]


TREES = ["trained", "deep", "capped", "flat"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", TREES)
def test_lookup_kernels_match_plain_bitwise_on_card(trees, name):
    """K3 alone, with the mask and the meta, and in its ids mode; the
    ragged L = 3000 ends in a partial block."""
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

"""The CUDA training kernels (ppg_tpu_torch/csrc/train.cu: K5a, the
directional splat targets; K5b, the spatial box walk; K6, the Adam
chain's rounds) against their plain PyTorch versions in
guiding/sdtree.py, on a card: the edge-case trees, records and leaves of
tools/sdtree_cases.py, and the tree and Adam batch a short guided render
of the Cornell box at the NEE path's settings (box filters, the var loss)
trained. Every result must be equal bit for bit, K6's included: on a card
the plain rounds' sigmoid, pow and sqrt are the CUDA math library's expf,
powf and sqrtf, which K6 calls. The kernels have no CPU mode, so the
`gpu` tests run only on a card and skip elsewhere. The file imports no
JAX:

    python -m pytest --noconftest tests/test_torch_train_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.guiding import sdtree as TG
from ppg_tpu_torch.guiding import train as TR
from ppg_tpu_torch.tools import sdtree_cases as C

TREES = ["trained", "deep", "capped", "flat", "grid"]


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), int((a != b).sum())


@pytest.fixture(scope="module")
def trained():
    """A tree trained by a short guided render with box filters, the var
    loss and a low spatial threshold (some 130 spatial nodes), and the
    last Adam batch's arguments of _adam_rounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.scene import mini_cbox

    tracer = GuidedPathTracer(
        mini_cbox(res=64, budget=28, max_depth=6, nee="always"), chunk=4096,
        overrides=dict(spatialFilter="box", directionalFilter="box",
                       bsdfSamplingFractionLoss="var", sTreeThreshold=400),
        device="cuda")
    seen, rounds = {}, TG._adam_rounds

    def record(*args):
        seen["adam"] = args
        return rounds(*args)

    TG._adam_rounds = record
    try:
        with C.capture_sampling_trees(tracer) as trees:
            tracer.render(seed=0)
    finally:
        TG._adam_rounds = rounds
    sdt = trees[-1]
    assert sdt.qb_child.shape[0] > 100 and sdt.s_dtree.shape[0] > 8
    return sdt, seen["adam"]


@pytest.fixture(scope="module")
def trees(trained):
    return {"trained": trained[0],
            **{k: C.to_device(t, "cuda") for k, t in (
                ("deep", C.deep_tree(False)), ("capped", C.deep_tree(True)),
                ("flat", C.flat_tree()), ("grid", C.grid_tree(8)))}}


@pytest.mark.gpu
@pytest.mark.parametrize("name", TREES)
def test_dir_targets_match_plain_bitwise_on_card(trees, name):
    """K5a from dtree ids, nearest and box, through dir_targets; from given
    roots through descend_cell (clamped too) and dtree_box_targets4. The
    ragged L = 3001 ends in a partial block."""
    sdt = trees[name]
    rng = np.random.default_rng(1)
    ids, pc = (t.cuda() for t in C.dir_inputs(sdt, rng, 3001))
    root = TG._take(sdt.db_root, ids)
    lim = torch.from_numpy(rng.integers(-1, 8, 3001).astype(np.int32)).cuda()
    TR.reset_counts()
    cell = TG.dir_targets(sdt, ids, pc, False)
    cell4, w4 = TG.dir_targets(sdt, ids, pc, True)
    desc = TG.descend_cell(sdt.qb_child, root, pc, None, sdt.q_depth)
    clamped = TG.descend_cell(sdt.qb_child, root, pc, lim, sdt.q_depth)
    box = TG.dtree_box_targets4(sdt.qb_child, root, pc, lim.clamp(min=0),
                                sdt.q_depth)
    torch.cuda.synchronize()
    assert TR.COUNTS == {"sd_dir_targets": 5, "sd_stree_box": 0,
                         "sd_adam": 0, "train_plain_on_cuda": 0}
    _same_bits(cell, TG.dir_targets_plain(sdt, ids, pc, False))
    for a, b in zip((cell4, w4), TG.dir_targets_plain(sdt, ids, pc, True)):
        _same_bits(a, b)
    for a, b in zip(desc, TG.descend_cell_plain(sdt.qb_child, root, pc,
                                                None, sdt.q_depth)):
        _same_bits(a, b)
    for a, b in zip(clamped, TG.descend_cell_plain(sdt.qb_child, root, pc,
                                                   lim, sdt.q_depth)):
        _same_bits(a, b)
    for a, b in zip(box, TG.dtree_box_targets4_plain(
            sdt.qb_child, root, pc, lim.clamp(min=0), sdt.q_depth)):
        _same_bits(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", TREES)
def test_dir_targets_outside_the_pool_on_card(trees, name):
    """K5a on ids in [-T, T) (negative ones counted from the end) against
    the plain version, and on ids outside [-T, T) and given roots outside
    the pool, which read no row (sdtree_cases.outside_pool_targets), in
    each mode."""
    sdt = trees[name]
    rng = np.random.default_rng(5)
    L, Q = 1001, sdt.qb_child.shape[0]
    ids = C.dir_edge_ids(sdt, rng, L)
    pc = torch.from_numpy(rng.random((L, 2)).astype(np.float32))
    root = TG._take(sdt.db_root.cpu(), ids.clamp(0, sdt.db_root.shape[0] - 1))
    root[:4] = torch.tensor([-1, Q, Q + 3, 2 ** 29], dtype=torch.int32)
    depth = torch.from_numpy(rng.integers(0, 9, L).astype(np.int32))
    ids, pc, root, depth = (t.cuda() for t in (ids, pc, root, depth))
    cell = TG.dir_targets(sdt, ids, pc, False)
    box = TG.dir_targets(sdt, ids, pc, True)
    given = TG.dtree_box_targets4(sdt.qb_child, root, pc, depth,
                                  sdt.q_depth)
    torch.cuda.synchronize()
    _same_bits(cell[8:], TG.dir_targets_plain(sdt, ids[8:], pc[8:], False))
    for a, b in zip(box, TG.dir_targets_plain(sdt, ids[8:], pc[8:], True)):
        _same_bits(a[8:], b)
    for a, b in zip(given, TG.dtree_box_targets4_plain(
            sdt.qb_child, root[4:], pc[4:], depth[4:], sdt.q_depth)):
        _same_bits(a[4:], b)
    cpu = lambda t: t.cpu()
    minus = torch.full((8,), -1, dtype=torch.int32)
    near, far = C.outside_pool_targets(minus, cpu(pc[:8]))
    _same_bits(cell[:8].cpu(), near[3])
    for a, b in zip(box, far):
        _same_bits(a[:8].cpu(), b)
    for a, b in zip(given, C.outside_pool_targets(
            cpu(root[:4]), cpu(pc[:4]), cpu(depth[:4]))[1]):
        _same_bits(a[:4].cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", TREES)
def test_stree_box_matches_plain_bitwise_on_card(trees, name):
    """K5b with and without the mask, boxes over more than 16 leaves and
    past the 24-entry stack among them."""
    sdt = trees[name]
    p, voxel, mask = (t.cuda() for t in C.box_records(
        sdt, np.random.default_rng(2), 1201))
    TR.reset_counts()
    got = TG.stree_box_targets(sdt, p, voxel)
    got_m = TG.stree_box_targets(sdt, p, voxel, mask)
    torch.cuda.synchronize()
    assert TR.COUNTS["sd_stree_box"] == 2
    assert TR.COUNTS["train_plain_on_cuda"] == 0
    for a, b in zip(got, TG.stree_box_targets_plain(sdt, p, voxel)):
        _same_bits(a, b)
    for a, b in zip(got_m, TG.stree_box_targets_plain(sdt, p, voxel, mask)):
        _same_bits(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("share", [0.0, 0.13, 1.0])
@pytest.mark.parametrize("name", TREES)
def test_stree_box_mask_shares_on_card(trees, name, share):
    """K5b with none, about an eighth and all of the records in the
    mask: the blocks queue the masked-in records and walk them in full
    groups, the others' rows written as -1 and 0."""
    sdt = trees[name]
    p, voxel, _ = (t.cuda() for t in C.box_records(
        sdt, np.random.default_rng(6), 3001))
    mask = torch.from_numpy(
        np.random.default_rng(7).random(3001) < share).cuda()
    got = TG.stree_box_targets(sdt, p, voxel, mask)
    torch.cuda.synchronize()
    for a, b in zip(got, TG.stree_box_targets_plain(sdt, p, voxel, mask)):
        _same_bits(a, b)


CHAINS = {"63 levels, 22 bits a corner": [1, 1, 1] + [0, 1] * 29 + [1],
          "200 levels toward the origin": [0] * 200,
          "90 levels, random halves": list(
              np.random.default_rng(13).integers(0, 2, 90))}


@pytest.mark.gpu
@pytest.mark.parametrize("chain", list(CHAINS))
def test_stree_box_deep_chains_on_card(trained, chain):
    """K5b down chains whose corners need every bit of a float32 or more,
    and toward the origin until the overlaps underflow."""
    bits = CHAINS[chain]
    sdt = C.to_device(C.path_chain_tree(bits), "cuda")
    p, voxel = (t.cuda() for t in C.chain_records(
        sdt, bits, np.random.default_rng(14), 2000))
    got = TG.stree_box_targets(sdt, p, voxel)
    torch.cuda.synchronize()
    for a, b in zip(got, TG.stree_box_targets_plain(sdt, p, voxel)):
        _same_bits(a, b)


@pytest.mark.gpu
def test_stree_box_pops_a_root_child_after_a_deep_chain_on_card(trained):
    """K5b's pop from a chain's end back to the root's inner child 0 (24
    halvings an axis at once), with and without a mask."""
    sdt = C.to_device(C.fork_chain_tree([0] * 100), "cuda")
    p, voxel = (t.cuda() for t in C.fork_records(
        sdt, np.random.default_rng(21), 2000))
    mask = torch.from_numpy(np.random.default_rng(22).random(2000) < 0.5)
    for m in (None, mask.cuda()):
        got = TG.stree_box_targets(sdt, p, voxel, m)
        torch.cuda.synchronize()
        for a, b in zip(got, TG.stree_box_targets_plain(sdt, p, voxel, m)):
            _same_bits(a, b)


@pytest.mark.gpu
def test_stree_box_refuses_a_stale_row_on_card(trees):
    """The wrapper refuses a tree whose spatial tables changed after its
    s_row was built."""
    t = trees["grid"]  # a copy, whose tables the test may change
    sdt = TG.SDTreeArrays(t.s_depth, t.q_depth, **{
        k: getattr(t, k).clone() for k in TG.SDTreeArrays.FIELDS})
    p, voxel, mask = (t.cuda() for t in C.box_records(
        sdt, np.random.default_rng(8), 256))
    sdt.s_dtree[0] = sdt.s_dtree[0]
    with pytest.raises(ValueError, match="s_row is stale"):
        TG.stree_box_targets(sdt, p, voxel, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["kl", "var"])
def test_adam_edge_leaves_on_card(trained, loss):
    """K6 bit for bit on the step counts' edges (k = 63 and 64, a
    negative, NaN and infinite W, counts near 2^30 and past 2^31 - 1)
    and on bucket sums of magnitudes 1e-6 to 1e6."""
    (S0, S1, G0, W), (var, m1, m2, it) = (
        [t.cuda() for t in x] for x in C.adam_edge_leaves(
            np.random.default_rng(9), 1000))
    sdt = C.to_device(C.tree(
        np.full((1, 2), -1, np.int32), np.zeros(1, np.int32), 4,
        np.ones((1, 4), np.float32), np.full((1, 4), -1, np.int32),
        np.zeros(1000, np.int32), np.ones(1000, np.float32),
        np.ones(1000, np.float32), var.cpu().numpy(), 4), "cuda")
    sdt.opt_m1, sdt.opt_m2, sdt.opt_iter = m1, m2, it
    got = TG._adam_rounds(sdt, S0, S1, G0, W, loss)
    torch.cuda.synchronize()
    for a, b in zip(got, TG._adam_rounds_plain(sdt, S0, S1, G0, W, loss)):
        _same_bits(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["kl", "var"])
def test_adam_rounds_match_plain_bitwise_on_card(trained, loss):
    """K6 on tools/sdtree_cases.adam_leaves' edge leaves (W = 0, W < 2,
    fewer than 64 steps, var at +-20) and on the trained render's last
    batch, for both losses: every output bit for bit."""
    (S0, S1, G0, W), (var, m1, m2, it) = (
        [t.cuda() for t in x] for x in C.adam_leaves(
            np.random.default_rng(3), 1000))
    sdt = C.to_device(C.tree(
        np.full((1, 2), -1, np.int32), np.zeros(1, np.int32), 4,
        np.ones((1, 4), np.float32), np.full((1, 4), -1, np.int32),
        np.zeros(1000, np.int32), np.ones(1000, np.float32),
        np.ones(1000, np.float32), var.cpu().numpy(), 4), "cuda")
    sdt.opt_m1, sdt.opt_m2, sdt.opt_iter = m1, m2, it
    t_sdt, *t_stats, _ = trained[1]
    for tree, stats in ((sdt, (S0, S1, G0, W)), (t_sdt, t_stats)):
        TR.reset_counts()
        got = TG._adam_rounds(tree, *stats, loss)
        torch.cuda.synchronize()
        assert TR.COUNTS["sd_adam"] == 1
        want = TG._adam_rounds_plain(tree, *stats, loss)
        for a, b in zip(got, want):
            _same_bits(a, b)
    assert int((want[3] != t_sdt.opt_iter).sum()) > 0


@pytest.mark.gpu
def test_splats_run_the_kernels_alone(trained):
    """splat_targets (both directional filters) and splat_records on its
    box-filter path with a learned fraction: K5a, K5b and K6 launch and no
    plain walk runs on the card."""
    sdt = C.to_device(C.to_device(trained[0], "cpu"), "cuda")  # a copy
    rng = np.random.default_rng(4)
    N = 5000
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    lo, side = sdt.aabb_min.cpu().numpy(), float(sdt.aabb_size)
    rec = dict(radiance=f(rng.random(N)), product=f(rng.random(N)),
               wo_pdf=f(rng.random(N) + 0.05), bsdf_pdf=f(rng.random(N)),
               dtree_pdf=f(rng.random(N)), stat_weight=f(np.ones(N)),
               is_delta=torch.from_numpy(rng.random(N) < 0.05).cuda(),
               valid=torch.from_numpy(rng.random(N) < 0.8).cuda(),
               p=f(lo + rng.random((N, 3)) * side),
               d=f(C.unit(rng, N)), voxel=f(np.full((N, 3), 0.05 * side)))
    ids = TG.lookup(sdt, rec["p"])[0]
    TR.reset_counts()
    for filt in ("nearest", "box"):
        out = TG.splat_targets(sdt, ids, rec["d"], rec["valid"], "nearest",
                               filt)
        assert set(out) == ({"sp_id", "cell"} if filt == "nearest"
                            else {"sp_id", "cell4", "w4"})
    TG.splat_records(sdt, rec, "box", "box", "var")
    torch.cuda.synchronize()
    assert TR.COUNTS == {"sd_dir_targets": 3, "sd_stree_box": 1,
                         "sd_adam": 1, "train_plain_on_cuda": 0}


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(trees):
    sdt = trees["trained"]
    pc = torch.rand(64, 2, device="cuda")
    ids = torch.zeros(64, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="want"):
        TG.dir_targets(sdt, ids.long(), pc, True)
    with pytest.raises(ValueError, match="want"):
        TG.stree_box_targets(sdt, torch.rand(64, 3, device="cuda"),
                             torch.rand(64, 3, device="cuda").double())
    T = sdt.opt_var.shape[0]
    with pytest.raises(ValueError, match="want"):
        TG._adam_rounds(sdt, *(torch.zeros((T, 61), device="cuda"),) * 2,
                        sdt.opt_bgrad, sdt.opt_bweight, "kl")

"""The training kernels' source (ppg_tpu_torch/csrc/train.cu: K5a, the
directional splat targets; K5b, the spatial box walk; K6, the Adam
chain's 64 rounds), compiled for the CPU against tools/cuda_shim.py and
held against their plain versions in guiding/sdtree.py:
descend_cell_plain, dtree_box_targets4_plain, dir_targets_plain,
stree_box_targets_plain and _adam_rounds_plain.

K5a and K5b are held bit for bit, except that two NaNs count as equal
whatever their payloads: PyTorch's CPU torch.minimum and torch.maximum
make an all-ones NaN where the kernels' compare and select pass the
input's on (on a card both give the card's one NaN, and
test_torch_train_gpu.py compares every bit).

K6 calls the C library's expf and powf (through the sigmoid and Adam's
powers) and sqrtf; PyTorch's CPU sigmoid, pow and sqrt are its own
vectorised functions, which differ from those in the last bit on some
values (its sqrt is not even correctly rounded), and 64 rounds of Adam
carry such a bit on. So K6 is held two ways: bit for bit against the
plain rounds with the sigmoid, pow and sqrt computed as the kernel
computes them (the C library's expf and powf through ctypes, a correctly
rounded sqrt), which holds the bucket sums' order and every other
operation exactly; and against the unchanged plain rounds within
LIBM_RTOL = 1e-4 of each field's largest magnitude (test_torch_adam.py's
tolerance against ppg_tpu), where the differences seen are at most
3e-5. On a card ATen's sigmoid, pow and sqrt are the CUDA math library's
expf, powf and sqrtf, which K6 calls, and the card tests hold K6 bit for
bit.

The inputs: the refined trees of tests/test_packed_descent.py and
tests/test_estimator_oracle.py brought across with
convert.sdtree_from_numpy, and tools/sdtree_cases.py's trees (a quadtree
chain past the 20-level cap, a spatial chain past the walk's 24-entry
stack, a flat tree, a complete spatial tree of 256 leaves), canonical
points on the split planes and at 1 - 1e-6, NaN and +-inf points, boxes
over more than 16 leaves, zero, negative and NaN voxels, and Adam leaves
with W = 0, W < 2, fewer than 64 steps, a step count that is no multiple
of 64, and var at +-20 and +-15. The kernels themselves run on a card in
test_torch_train_gpu.py."""

import ctypes
import os

import numpy as np
import pytest
import torch

from ppg_tpu_torch.guiding import sdtree as TG
from ppg_tpu_torch.guiding import train as TR
from ppg_tpu_torch.tools import cuda_shim
from ppg_tpu_torch.tools import sdtree_cases as C
from test_torch_sdtree import _port_tree

LIBM_RTOL = 1e-4
TREES = ["refined", "deep", "capped", "flat", "grid"]
BOX_TREES = ["refined", "spatial", "deep", "capped", "grid"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain walks' many small tensor ops gain nothing from intra-op
    threads, and with several test workers on one host those threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    from test_estimator_oracle import _spatial_tree
    from test_packed_descent import _refined_tree

    return {"refined": _port_tree(_refined_tree().push()),
            "spatial": _port_tree(_spatial_tree()[1]),
            "deep": C.deep_tree(False), "capped": C.deep_tree(True),
            "flat": C.flat_tree(), "grid": C.grid_tree(8)}


@pytest.fixture(scope="module")
def host_train(tmp_path_factory):
    """csrc/train.cu built for the CPU (tools/cuda_shim.build_host).
    Returns (k5a, k5b, k6) with the wrappers' arguments: k5a(q_child,
    ids, pc, n_steps, table=None, depth=None, box=False) -> (node, quad,
    depth, cell) or (cell4, w4); k5b(sdt, p, voxel, mask=None) -> (ids,
    w); k6(S0, S1, G0, W, var, m1, m2, it, kl) -> the six new arrays."""
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    from ppg_tpu_torch.native import CSRC

    lib = cuda_shim.build_host(os.path.join(CSRC, "train.cu"),
                               str(tmp_path_factory.mktemp("train_host")),
                               "train_host", launches=3)
    for name, argtypes in (("ppg_sd_dir_targets", TR.DIR_ARGTYPES),
                           ("ppg_sd_stree_box", TR.BOX_ARGTYPES),
                           ("ppg_sd_adam_rounds", TR.ADAM_ARGTYPES)):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()

    def k5a(q_child, ids, pc, n_steps, table=None, depth=None, box=False):
        L = pc.shape[0]
        outs = [None] * 4 if box else [
            torch.full((L,), 77, dtype=torch.int32) for _ in range(4)]
        cell4 = torch.full((L, 4), 77, dtype=torch.int32) if box else None
        w4 = torch.full((L, 4), 7.0) if box else None
        assert lib.ppg_sd_dir_targets(
            q_child.data_ptr(), q_child.shape[0], ptr(table),
            0 if table is None else table.shape[0], ids.data_ptr(),
            pc.data_ptr(), ptr(depth), L, n_steps, *map(ptr, outs),
            ptr(cell4), ptr(w4), 0, None) == 0
        return (cell4, w4) if box else outs

    def k5b(sdt, p, voxel, mask=None):
        L = p.shape[0]
        ids = torch.full((L, TG.S_TARGETS), 77, dtype=torch.int32)
        w = torch.full((L, TG.S_TARGETS), 7.0)
        assert lib.ppg_sd_stree_box(
            p.data_ptr(), voxel.data_ptr(), sdt.aabb_min.data_ptr(),
            sdt.aabb_size.data_ptr(), sdt.s_row.data_ptr(),
            sdt.s_dtree.data_ptr(), ptr(mask), L, ids.data_ptr(),
            w.data_ptr(), 0, None) == 0
        return ids, w

    def k6(S0, S1, G0, W, var, m1, m2, it, kl):
        T = var.shape[0]
        out = [torch.full((T,), 77, dtype=torch.int32) if k == 3 else
               torch.full((T,), 7.0) for k in range(6)]
        assert lib.ppg_sd_adam_rounds(
            *(t.data_ptr() for t in (S0, S1, G0, W, var, m1, m2, it,
                                     TG._ADAM_CHAT)), T, int(kl),
            *(t.data_ptr() for t in out), 0, None) == 0
        return out

    return k5a, k5b, k6


def _same(a, b):
    """Equal bit for bit; two NaNs count as equal (see the docstring)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        nan = torch.isnan(a) & torch.isnan(b)
        a, b = a.view(torch.int32), b.view(torch.int32)
        bad = (a != b) & ~nan
    else:
        bad = a != b
    assert not bool(bad.any()), int(bad.sum())


@pytest.mark.parametrize("name", TREES)
def test_dir_targets_kernel_equals_plain(host_train, trees, name):
    """K5a from dtree ids (the building roots read in the kernel): the
    leaf cell and the box filter's four cells and weights. Points on and
    beside the coarse split lines (0.5 +- 1 ulp, 0.25) send corners off
    the point's path at the first level; points at 0 and 1 clamp corners
    at 0 and 1 - 1e-6."""
    k5a, _, _ = host_train
    sdt = trees[name]
    ids, pc = C.dir_inputs(sdt, np.random.default_rng(1), 3000)
    cell = k5a(sdt.qb_child, ids, pc, sdt.q_depth, table=sdt.db_root)[3]
    want, st = TG.dir_targets_plain(sdt, ids, pc, False, return_stats=True)
    _same(cell, want)
    cell4, w4 = k5a(sdt.qb_child, ids, pc, sdt.q_depth, table=sdt.db_root,
                    box=True)
    (want4, want_w), st4 = TG.dir_targets_plain(sdt, ids, pc, True,
                                                return_stats=True)
    _same(cell4, want4)
    _same(w4, want_w)
    assert bool((want_w == 0).any()) and bool(torch.isnan(want_w).any())
    # duplicate cells, and at (1, 1) all four corners in the point's cell
    assert bool((want4 == want4[:, :1]).all(1).any())
    if name in ("deep", "capped", "grid"):  # the chain to the 20-level cap
        assert int(st["levels"].max()) == TG.MAX_Q_DEPTH
    assert bool((st4["levels"] >= st["levels"]).all())


@pytest.mark.parametrize("name", TREES)
def test_descend_kernel_equals_plain(host_train, trees, name):
    """K5a's leaf descent from given roots, unclamped and clamped at
    per-lane depths (-1, 0 and past the tree among them), against
    descend_cell_plain; and the box corners at given depths (0 and 30
    among them) against dtree_box_targets4_plain."""
    k5a, _, _ = host_train
    sdt = trees[name]
    rng = np.random.default_rng(2)
    ids, pc = C.dir_inputs(sdt, rng, 2000)
    root = TG._take(sdt.db_root, ids)
    got = k5a(sdt.qb_child, root, pc, sdt.q_depth)
    want = TG.descend_cell_plain(sdt.qb_child, root, pc, None, sdt.q_depth)
    for a, b in zip(got[:3], want):
        _same(a, b)
    _same(got[3], want[0] * 4 + want[1])
    lim = torch.from_numpy(rng.integers(-1, 8, 2000).astype(np.int32))
    lim[:3] = torch.tensor([-1, 0, 30])
    got = k5a(sdt.qb_child, root, pc, sdt.q_depth, depth=lim)
    want = TG.descend_cell_plain(sdt.qb_child, root, pc, lim, sdt.q_depth)
    for a, b in zip(got[:3], want):
        _same(a, b)
    depth = torch.from_numpy(rng.integers(0, 12, 2000).astype(np.int32))
    depth[:2] = torch.tensor([0, 30])
    got = k5a(sdt.qb_child, root, pc, sdt.q_depth, depth=depth, box=True)
    want = TG.dtree_box_targets4_plain(sdt.qb_child, root, pc, depth,
                                       sdt.q_depth)
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.parametrize("mode", ["nearest", "box", "given depth"])
def test_dir_targets_outside_the_pool_read_no_row(host_train, trees, mode):
    """K5a on ids in [-T, T) (negative ones counted from the end, as
    torch indexes) against the plain version, and on ids outside [-T, T)
    and given roots outside the pool, which read no row: the cells and
    weights of sdtree_cases.outside_pool_targets."""
    k5a, _, _ = host_train
    sdt = trees["refined"]
    rng = np.random.default_rng(9)
    L, Q = 600, sdt.qb_child.shape[0]
    ids = C.dir_edge_ids(sdt, rng, L)
    pc = torch.from_numpy(rng.random((L, 2)).astype(np.float32))
    pc[8:12] = torch.tensor([[0.5, 0.5], [0.25, 0.75], [0.0, 0.0],
                             [1 - 1e-6, 1.0]])
    box = mode != "nearest"
    if mode == "given depth":  # from given roots, outside the pool first
        root = TG._take(sdt.db_root, ids.clamp(0, sdt.db_root.shape[0] - 1))
        root[:4] = torch.tensor([-1, Q, Q + 3, 2 ** 29], dtype=torch.int32)
        depth = torch.from_numpy(rng.integers(0, 9, L).astype(np.int32))
        got = k5a(sdt.qb_child, root, pc, sdt.q_depth, depth=depth,
                  box=True)
        out, inside = 4, slice(4, None)
        want = TG.dtree_box_targets4_plain(sdt.qb_child, root[inside],
                                           pc[inside], depth[inside],
                                           sdt.q_depth)
        edge = C.outside_pool_targets(root[:out], pc[:out], depth[:out])[1]
    else:
        got = k5a(sdt.qb_child, ids, pc, sdt.q_depth, table=sdt.db_root,
                  box=box)
        out, inside = 8, slice(8, None)
        want = TG.dir_targets_plain(sdt, ids[inside], pc[inside], box)
        edge = C.outside_pool_targets(torch.full((out,), -1,
                                                 dtype=torch.int32),
                                      pc[:out])
        edge = edge[1] if box else edge[0][3]
        if not box:
            got, want, edge = got[3:], (want,), (edge,)
    for a, b, e in zip(got, want, edge):
        _same(a[inside], b)
        _same(a[:out], e)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", BOX_TREES)
def test_stree_box_kernel_equals_plain(host_train, trees, name, masked):
    """K5b: the first 16 leaves in the walk's order and their weights,
    with and without the mask (masked records: all -1 and 0)."""
    _, k5b, _ = host_train
    sdt = trees[name]
    p, voxel, mask = C.box_records(sdt, np.random.default_rng(3), 1200)
    mask = mask if masked else None
    ids, w = k5b(sdt, p, voxel, mask)
    want_ids, want_w, st = TG.stree_box_targets_plain(sdt, p, voxel, mask,
                                                      return_stats=True)
    _same(ids, want_ids)
    _same(w, want_w)
    if masked:
        assert bool((want_ids[~mask] == -1).all())
        assert bool((want_w[~mask] == 0).all())
    n = (want_ids >= 0).sum(1)
    if name != "flat":
        assert int(n.max()) == TG.S_TARGETS and int(st["pops"].max()) > 20
    assert bool((want_w[want_ids < 0] == 0).all())


def test_stree_box_walk_overflows_its_stack(host_train, trees, monkeypatch):
    """On the deep spatial chain a box over the whole tree fills the
    24-entry stack: with a deeper stack the plain walk keeps other leaves,
    and the kernel keeps the 24-entry walk's."""
    _, k5b, _ = host_train
    sdt = trees["deep"]
    p, voxel, _ = C.box_records(sdt, np.random.default_rng(4), 300)
    ids, w = k5b(sdt, p, voxel)
    want = TG.stree_box_targets_plain(sdt, p, voxel)
    _same(ids, want[0])
    _same(w, want[1])
    monkeypatch.setattr(TG, "S_STACK", 64)
    deeper = TG.stree_box_targets_plain(sdt, p, voxel)
    assert bool((deeper[0] != want[0]).any(1)[100:110].all())


@pytest.mark.parametrize("share", [0.0, 0.13, 1.0])
@pytest.mark.parametrize("name", BOX_TREES)
def test_stree_box_kernel_with_mask_shares(host_train, trees, name, share):
    """K5b with none, about an eighth (phase 6's share) and all of the
    records in the mask: the blocks queue the masked-in records of their
    tiles and walk them in full groups, the others' rows written as -1
    and 0, so every row must come out as the plain walk's whatever the
    share. L = 1201 ends in a partial tile."""
    _, k5b, _ = host_train
    sdt = trees[name]
    p, voxel, _ = C.box_records(sdt, np.random.default_rng(11), 1201)
    mask = torch.from_numpy(np.random.default_rng(12).random(1201) < share)
    ids, w = k5b(sdt, p, voxel, mask)
    want_ids, want_w = TG.stree_box_targets_plain(sdt, p, voxel, mask)
    _same(ids, want_ids)
    _same(w, want_w)
    assert int(mask.sum()) == round(share * 1201) or 0 < share < 1


@pytest.mark.parametrize("name,share", [("refined", 0.13), ("grid", 0.8)])
def test_stree_box_kernel_over_many_tiles_a_block(host_train, trees, name,
                                                   share):
    """K5b on 8,000 records: each block of the persistent grid takes ten
    tiles or so, so records stay queued from one tile to the next, and
    the queue's rest moves to its front after each walk."""
    _, k5b, _ = host_train
    sdt = trees[name]
    p, voxel, _ = C.box_records(sdt, np.random.default_rng(19), 8000)
    mask = torch.from_numpy(np.random.default_rng(20).random(8000) < share)
    ids, w = k5b(sdt, p, voxel, mask)
    want_ids, want_w = TG.stree_box_targets_plain(sdt, p, voxel, mask)
    _same(ids, want_ids)
    _same(w, want_w)


CHAINS = {"63 levels, 22 bits a corner": [1, 1, 1] + [0, 1] * 29 + [1],
          "200 levels toward the origin": [0] * 200,
          "90 levels, random halves": list(
              np.random.default_rng(13).integers(0, 2, 90))}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_stree_box_kernel_on_deep_chains(host_train, chain):
    """K5b down spatial chains whose corners need every bit of a float32
    (22 halvings an axis at depth 64) or more (the plain walk's sums then
    round, and the kernel's integer corners must round alike), and one
    toward the origin whose walks go on until the overlaps underflow
    (depth 150 or so), with and without a mask. The boxes reach deep."""
    _, k5b, _ = host_train
    bits = CHAINS[chain]
    sdt = C.path_chain_tree(bits)
    p, voxel = C.chain_records(sdt, bits, np.random.default_rng(14), 400)
    mask = torch.from_numpy(np.random.default_rng(15).random(400) < 0.5)
    for m in (None, mask):
        ids, w = k5b(sdt, p, voxel, m)
        want_ids, want_w, st = TG.stree_box_targets_plain(
            sdt, p, voxel, m, return_stats=True)
        _same(ids, want_ids)
        _same(w, want_w)
        assert int(st["pops"].max()) > min(len(bits), 140)


def test_stree_box_kernel_pops_a_root_child_after_a_deep_chain(host_train):
    """K5b on sdtree_cases.fork_chain_tree: the root's inner child 0 waits
    on the stack while the walk goes down the chain under child 1 until
    its cells' float widths run out near x = 0.5 (about 72 levels), and
    its pop then climbs to the root, 24 halvings an axis at once, about the
    largest climb a walk can make. Bit for bit with and without a mask;
    most records climb."""
    _, k5b, _ = host_train
    sdt = C.fork_chain_tree([0] * 100)
    p, voxel = C.fork_records(sdt, np.random.default_rng(21), 300)
    mask = torch.from_numpy(np.random.default_rng(22).random(300) < 0.5)
    for m in (None, mask):
        ids, w = k5b(sdt, p, voxel, m)
        want_ids, want_w, st = TG.stree_box_targets_plain(
            sdt, p, voxel, m, return_stats=True)
        _same(ids, want_ids)
        _same(w, want_w)
        climbed = (st["pops"] > 60) & ((want_ids >= 0).sum(1) < TG.S_TARGETS)
        assert int(climbed.sum()) > (100 if m is None else 50)
        assert bool(((want_ids[climbed] == 0) | (want_ids[climbed] == 1))
                    .any(1).all())


def test_stree_box_refuses_a_stale_row(trees):
    """K5b reads s_row: the wrapper refuses a tree whose tables changed
    after the row was built, and one without the row, before it looks at
    the tensors' device."""
    t = trees["refined"]  # a copy, whose tables the test may change
    sdt = TG.SDTreeArrays(t.s_depth, t.q_depth, **{
        k: getattr(t, k).clone() for k in TG.SDTreeArrays.FIELDS})
    p, voxel, mask = C.box_records(sdt, np.random.default_rng(16), 128)
    sdt.s_child[0, 0] = sdt.s_child[0, 0]  # a write: the version moves
    with pytest.raises(ValueError, match="s_row is stale"):
        TR.stree_box(sdt, p, voxel, mask)
    sdt.s_row = None
    with pytest.raises(ValueError, match="has no s_row"):
        TR.stree_box(sdt, p, voxel, mask)
    assert TR.COUNTS["sd_stree_box"] == 0


def _adam_case(kl, seed):
    (S0, S1, G0, W), (var, m1, m2, it) = C.adam_leaves(
        np.random.default_rng(seed), 300)
    T = var.shape[0]
    sdt = C.tree(np.full((1, 2), -1, np.int32), np.zeros(1, np.int32), 4,
                 np.ones((1, 4), np.float32), np.full((1, 4), -1, np.int32),
                 np.zeros(T, np.int32), np.ones(T, np.float32),
                 np.ones(T, np.float32), var.numpy(), 4)
    sdt.opt_m1, sdt.opt_m2, sdt.opt_iter = m1, m2, it
    return sdt, (S0, S1, G0, W), "kl" if kl else "var"


def _as_the_kernel(monkeypatch):
    """The plain rounds' sigmoid, pow and sqrt as K6 computes them: the C
    library's expf and powf, a correctly rounded sqrt."""
    libm = ctypes.CDLL("libm.so.6")
    libm.expf.argtypes = [ctypes.c_float]
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    libm.expf.restype = libm.powf.restype = ctypes.c_float
    each = lambda f, x: torch.tensor([f(v) for v in x.reshape(-1).tolist()],
                                     dtype=torch.float32).reshape(x.shape)
    monkeypatch.setattr(torch, "sigmoid",
                        lambda x: 1.0 / (1.0 + each(libm.expf, -x)))
    monkeypatch.setattr(torch.Tensor, "__rpow__", lambda x, b: each(
        lambda v: libm.powf(float(np.float32(b)), v), x))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))


@pytest.mark.parametrize("kl", [True, False])
def test_adam_kernel_equals_plain_with_its_libm(host_train, kl,
                                                monkeypatch):
    """K6 bit for bit against _adam_rounds_plain computing its sigmoid,
    pow and sqrt as the kernel does: the bucket sums' order, the
    constants, the skipped rounds and the remainder all exact."""
    _, _, k6 = host_train
    sdt, stats, loss = _adam_case(kl, 5)
    got = k6(*stats, sdt.opt_var, sdt.opt_m1, sdt.opt_m2, sdt.opt_iter, kl)
    _as_the_kernel(monkeypatch)
    want = TG._adam_rounds_plain(sdt, *stats, loss)
    for a, b in zip(got, want):
        _same(a, b)
    it0 = sdt.opt_iter
    k = torch.floor(stats[3] * 0.5).to(torch.int32)
    assert torch.equal(want[3] - it0, k) and int((k == 0).sum()) >= 4
    assert bool((want[5] < 2).all()) and float(want[5][0]) == 0.0


@pytest.mark.parametrize("kl", [True, False])
def test_adam_kernel_within_libm_tolerance(host_train, kl):
    """K6 against the unchanged plain rounds (PyTorch's CPU sigmoid, pow
    and sqrt): within LIBM_RTOL of each field's largest magnitude, the
    step counts equal."""
    _, _, k6 = host_train
    sdt, stats, loss = _adam_case(kl, 6)
    got = k6(*stats, sdt.opt_var, sdt.opt_m1, sdt.opt_m2, sdt.opt_iter, kl)
    want = TG._adam_rounds_plain(sdt, *stats, loss)
    _same(got[3], want[3])
    for a, b in zip(got, want):
        b = b.double().numpy()
        np.testing.assert_allclose(a.double().numpy(), b, rtol=LIBM_RTOL,
                                   atol=LIBM_RTOL * np.abs(b).max())


def _adam_edge_case(kl, seed):
    sdt, _, loss = _adam_case(kl, seed)
    stats, (var, m1, m2, it) = C.adam_edge_leaves(
        np.random.default_rng(seed), sdt.opt_var.shape[0])
    sdt.opt_var, sdt.opt_m1, sdt.opt_m2, sdt.opt_iter = var, m1, m2, it
    return sdt, stats, loss


@pytest.mark.parametrize("kl", [True, False])
def test_adam_kernel_edge_leaves_equal_plain_with_its_libm(host_train, kl,
                                                           monkeypatch):
    """K6 bit for bit against _adam_rounds_plain (with the kernel's libm)
    on the step counts' edges: k = 63 and 64, q > 0 with r > 0 and r = 0,
    a negative, NaN and infinite W, a count near 2^30 and one that wraps
    past 2^31 - 1 (the kernel's counts before each round in closed form
    must wrap as the plain rounds' int32 adds do)."""
    _, _, k6 = host_train
    sdt, stats, loss = _adam_edge_case(kl, 17)
    got = k6(*stats, sdt.opt_var, sdt.opt_m1, sdt.opt_m2, sdt.opt_iter, kl)
    _as_the_kernel(monkeypatch)
    want = TG._adam_rounds_plain(sdt, *stats, loss)
    for a, b in zip(got, want):
        _same(a, b)
    assert int(want[3][36]) < 0 < int(sdt.opt_iter[36])  # wrapped
    assert int(want[3][32]) == int(sdt.opt_iter[32]) - 3  # k = -3


@pytest.mark.parametrize("kl", [True, False])
def test_adam_kernel_sums_buckets_in_order(host_train, kl, monkeypatch):
    """K6's lanes sum their buckets in _bucket_sum's order: on bucket sums
    of magnitudes 1e-6 to 1e6 the kernel equals the plain rounds bit for
    bit, and the plain rounds with the buckets summed left to right give
    other bits."""
    _, _, k6 = host_train
    sdt, stats, loss = _adam_edge_case(kl, 18)
    rows = slice(40, 48)
    stats = tuple(t[rows].contiguous() for t in stats)
    for f in ("opt_var", "opt_m1", "opt_m2", "opt_iter"):
        setattr(sdt, f, getattr(sdt, f)[rows].contiguous())
    got = k6(*stats, sdt.opt_var, sdt.opt_m1, sdt.opt_m2, sdt.opt_iter, kl)
    _as_the_kernel(monkeypatch)
    want = TG._adam_rounds_plain(sdt, *stats, loss)
    for a, b in zip(got, want):
        _same(a, b)
    monkeypatch.setattr(TG, "_bucket_sum", lambda v: torch.from_numpy(
        np.cumsum(v.numpy(), 1, dtype=np.float32)[:, -1]))
    serial = TG._adam_rounds_plain(sdt, *stats, loss)
    assert not torch.equal(serial[0].view(torch.int32),
                           want[0].view(torch.int32))


def test_adam_fast_divisions_hold_the_bucket_operands():
    """K6 divides its bucket terms without the IEEE division's slow path
    (csrc/train.cu's div_fast and recip_fast), which its note holds exact
    for |d| = |c + f| in [1e-4, 7712], f in [0, 1] and the clamp's D_MIN
    the least: every bucket centre c and c + 1 must stay within 7712 of 0
    and D_MIN at 1e-4, or the kernel must take the compiler's divisions
    again."""
    src = open(os.path.join(os.path.dirname(TR.__file__), "..", "csrc",
                            "train.cu")).read()
    assert "constexpr float D_MIN = static_cast<float>(1e-4);" in src
    assert "[1e-4, 7712]" in src
    c = TG._ADAM_CHAT
    assert float(torch.maximum(c.abs(), (c + 1).abs()).max()) <= 7712.0


def test_bucket_sum_halves_in_order():
    """_bucket_sum adds the zero-padded 64 buckets' halves six times: on
    sums whose order shows, it equals that order in numpy and differs
    from a left-to-right sum."""
    rng = np.random.default_rng(7)
    v = (rng.normal(size=(500, TG.ADAM_B))
         * 10.0 ** rng.integers(-4, 5, (500, TG.ADAM_B))).astype(np.float32)
    x = np.concatenate([v, np.zeros((500, 2), np.float32)], 1)
    while x.shape[1] > 1:
        x = x[:, :x.shape[1] // 2] + x[:, x.shape[1] // 2:]
    got = TG._bucket_sum(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, x[:, 0])
    serial = np.zeros(500, np.float32)
    for j in range(TG.ADAM_B):
        serial = serial + v[:, j]
    assert (got != serial).any()


def test_the_wrappers_take_only_card_tensors(trees):
    """The public functions take the plain versions on the CPU; the
    kernels' wrappers refuse CPU tensors rather than fall back."""
    sdt = trees["refined"]
    rng = np.random.default_rng(8)
    ids, pc = C.dir_inputs(sdt, rng, 128)
    p, voxel, mask = C.box_records(sdt, rng, 128)
    TR.reset_counts()
    _same(TG.dir_targets(sdt, ids, pc, False),
          TG.dir_targets_plain(sdt, ids, pc, False))
    for a, b in zip(TG.stree_box_targets(sdt, p, voxel, mask),
                    TG.stree_box_targets_plain(sdt, p, voxel, mask)):
        _same(a, b)
    assert TR.COUNTS == {"sd_dir_targets": 0, "sd_stree_box": 0,
                         "sd_adam": 0, "train_plain_on_cuda": 0}
    with pytest.raises(ValueError, match="contiguous on cuda"):
        TR.dir_targets(sdt, ids, pc, True)
    with pytest.raises(ValueError, match="contiguous on cuda"):
        TR.stree_box(sdt, p, voxel, mask)
    (S0, S1, G0, W), _ = C.adam_leaves(rng, 64)
    with pytest.raises(ValueError, match="contiguous on cuda"):
        TR.adam_rounds(sdt, S0, S1, G0, W, True)
    assert all(v == 0 for v in TR.COUNTS.values())

"""K5's accumulation (ppg_tpu_torch/csrc/reduce.cu) and K7, the box film
splat (csrc/film.cu), on a card: each kernel against its plain PyTorch
version on the card and on the CPU, bit for bit (two NaNs equal whatever
their payloads), on tools/reduce_cases' cases (zeros, prior targets,
cancellation, subnormals and values near FLT_MAX, one crowded cell,
non-finite values, an int64 index), at the main path's sizes, and under
a permutation of the records. The kernels have no CPU mode, so the `gpu`
tests run only on a card and skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_reduce_gpu.py -q
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ppg_tpu_torch.ops import reduce as R
from ppg_tpu_torch.render import film as F
from ppg_tpu_torch.tools import reduce_cases as C


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    assert a.shape == b.shape and a.dtype == b.dtype
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).sum())


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _three_ways(target, idx, vals):
    """The kernel, the plain version on the card and on the CPU, each into
    fresh copies of the targets; returns the three lists of targets."""
    out = []
    for dev, fn in (("cuda", None), ("cuda", "plain"), ("cpu", "plain")):
        ts = [torch.from_numpy(t.copy()).to(dev) for t in target]
        i = torch.from_numpy(idx).to(dev)
        vs = [torch.from_numpy(v).to(dev) for v in vals]
        if fn is None:
            if len(ts) == 1:
                R.bincount_add(ts[0], i, vs[0])
            else:
                R.bincount_add2(tuple(ts), i, *vs)
        else:
            for t, v in zip(ts, vs):
                R.bincount_add_plain(t, i, v)
        out.append(ts)
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", C.CASES)
def test_kernel_equals_plain_on_card_and_cpu(card, name):
    target, idx, val = C.case(name)
    before = R.COUNTS["reduce_add"]
    for targets, vals in (([target], [val]),
                          ([target, target[::-1].copy()],
                           [val, (-0.5 * val).astype(np.float32)])):
        kern, plain, cpu = _three_ways(targets, idx, vals)
        for a, b, c in zip(kern, plain, cpu):
            _same(a, b)
            _same(a, c)
    assert R.COUNTS["reduce_add"] == before + 2 * R.LAUNCHES_PER_CALL


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,crowded", [(1_390_000, 9_437_184, False),
                                         (4_500, 1 << 20, True),
                                         (4_500 * 62, 1 << 20, True),
                                         (1_093, 2_359_296, True),
                                         (16_384, 1 << 20, True),
                                         (1_390_000, 65_536, False),
                                         (1_390_000, 65_536, True)])
def test_kernel_is_order_free_at_main_path_sizes(card, M, N, crowded):
    """The box splat's 9.4 M records into 1.39 M cells; the Adam
    statistics' few thousand (and few thousand times 62) crowded cells,
    most records masked to zero at cell 0; the statistical weights'
    1,093 cells; the most cells the shared path takes; a batch of 65,536
    records into the box splat's cells. A permutation of the records
    gives the same bits, and both equal the plain version; each call
    takes the path of its size."""
    g = torch.Generator(device="cuda").manual_seed(M + N)
    idx = torch.randint(0, M, (N,), generator=g, device="cuda",
                        dtype=torch.int32)
    val = torch.rand(N, generator=g, device="cuda") ** 4 * 1e3
    if crowded:
        masked = torch.rand(N, generator=g, device="cuda") < 0.6
        idx = torch.where(masked, 0, idx // 16)
        val = torch.where(masked, 0.0, val - 0.3e3)
    target = torch.rand(M, generator=g, device="cuda")
    perm = torch.randperm(N, generator=g, device="cuda")
    path = "shared" if M <= 16_384 else "global"
    before = R.COUNTS["reduce_" + path]
    a = R.bincount_add(target.clone(), idx, val)
    b = R.bincount_add(target.clone(), idx[perm].contiguous(),
                       val[perm].contiguous())
    c = R.bincount_add_plain(target.clone(), idx, val)
    _same(a, b)
    _same(a, c)
    assert R.path(M, 1) == path
    assert R.COUNTS["reduce_" + path] == before + 2


@pytest.mark.gpu
def test_two_streams_at_once_keep_their_own_scratch(card):
    """Calls on two CUDA streams, issued together and overlapping on the
    card, each equal the plain sum: each stream has its scratch."""
    g = torch.Generator(device="cuda").manual_seed(5)
    M, N = 4_500, 1 << 20
    sets = [(torch.rand(M, generator=g, device="cuda"),
             torch.randint(0, M, (N,), generator=g, device="cuda"),
             torch.rand(N, generator=g, device="cuda") - 0.5)
            for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in sets]
    got = [t.clone() for t, _, _ in sets]
    torch.cuda.synchronize()
    for _ in range(4):
        for s, t, (_, i, v) in zip(streams, got, sets):
            with torch.cuda.stream(s):
                R.bincount_add(t, i, v)
    torch.cuda.synchronize()
    for t, (t0, i, v) in zip(got, sets):
        want = t0.clone()
        for _ in range(4):
            R.bincount_add_plain(want, i, v)
        _same(t, want)
    keys = {(0, s.cuda_stream) for s in streams}
    assert keys <= set(R._scratch)


@pytest.mark.gpu
def test_index_outside_the_cells_fails_the_launch(card):
    """An index outside [0, M) traps the kernel, as index_add_'s device
    assertion does; the card's context is then lost, so a process of its
    own makes the call."""
    code = textwrap.dedent("""
        import torch
        from ppg_tpu_torch.ops import reduce as R
        t = torch.zeros(40, device="cuda")
        i = torch.arange(600, device="cuda", dtype=torch.int32) % 40
        i[517] = 40
        try:
            R.bincount_add(t, i, torch.ones(600, device="cuda"))
            torch.cuda.synchronize()
        except RuntimeError as e:
            print("failed:", type(e).__name__)
        else:
            print("no error")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert "failed: " in r.stdout, (r.stdout, r.stderr[-2000:])


@pytest.mark.gpu
@pytest.mark.parametrize("squares", [False, True])
def test_film_kernel_equals_plain_on_card(card, squares):
    rng = np.random.default_rng(9 + squares)
    C_ = 1 << 18
    film = F.Film(512, 513, "box", "cuda")  # the last chunk is padding
    got, want = film.zeros_flat(C_), film.zeros_flat(C_)
    got_sq, want_sq = film.zeros_flat(C_), film.zeros_flat(C_)
    before = F.COUNTS["film_splat"]
    for _ in range(2):
        for start in range(0, got[1].shape[0], C_):
            vals = (rng.normal(size=(C_, 3)) * 10.0 ** rng.uniform(
                -20, 15, (C_, 1))).astype(np.float32)
            valid = rng.random(C_) < 0.95
            vals[~valid] = np.nan
            v, ok = torch.from_numpy(vals).cuda(), torch.from_numpy(
                valid).cuda()
            F.Film.splat_box_linear(got, start, v, ok,
                                    got_sq if squares else None)
            F.splat_box_linear_plain(want, start, v, ok,
                                     want_sq if squares else None)
    for a, b in zip(got + got_sq, want + want_sq):
        _same(a, b)
    assert F.COUNTS["film_splat"] == before + 4

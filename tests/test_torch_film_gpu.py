"""K7s, the reconstruction filter's film splat (ppg_tpu_torch/csrc/film.cu,
ppg_film_splat_filter), on a card: the kernel against its plain PyTorch
version, splat_filter_plain, on the card, bit for bit (two NaNs equal
whatever their payloads), for the five filters, into one film and into
the film and the squared film, on SHAPES: the tests' 23 x 11 film in
chunks of 64 (narrower than the kernel's 32 x 16 tile), the main path's
512 x 512 chunk, films whose width and reached rows are not multiples
of the tile (500 x 300, 37 x 5, 75 x 21), a one-row film (K exceeds the
rows), a chunk smaller than a tile in a film's middle and chunks that
cover whole tiles; chunks that start and end mid-tile and mid-row,
reached rows clipped at the film's top and bottom, the last chunk's
lanes off the film; positions on their pixel's far edges and values with
NaN and inf among them. A sample outside its own pixel traps the kernel.
The kernel has no CPU mode, so the `gpu` tests run only on a card and
skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_film_gpu.py -q
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ppg_tpu_torch.render import film as F

FILTERS = ("tent", "gaussian", "mitchell", "catmullrom", "lanczos")
# (W, H, C, chunk starts, NaN and inf values)
SHAPES = ((23, 11, 64, (0, 5, 64, 100, 192, 230), True),
          (512, 512, 1 << 18, (0,), False),
          (500, 300, 1 << 16, (0, 1 << 16, 2 << 16), False),
          (37, 5, 50, (0, 20, 75, 160), True),
          (70, 1, 30, (0, 25, 60), True),
          (75, 21, 300, (40, 340, 700, 1400), True),
          (100, 40, 100, (1234,), True),
          (70, 40, 1500, (0, 1500), True))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).sum())


def _chunk(rng, W, H, start, C, nonfinite=False):
    """Positions jittered inside their pixels (some on the far edges,
    x = px + 1 or y = py + 1) and values over many magnitudes."""
    ids = start + np.arange(C)
    pos = np.stack([ids % W, ids // W], -1).astype(np.float32)
    jit = rng.random((C, 2)).astype(np.float32)
    jit[rng.random((C, 2)) < 0.05] = 1.0
    pos = pos + jit
    vals = (rng.normal(size=(C, 3))
            * 10.0 ** rng.uniform(-6, 6, (C, 1))).astype(np.float32)
    if nonfinite:  # at least one NaN lane and one inf in a small chunk
        vals[rng.random(C) < 0.01] = np.nan
        vals[rng.random(C) < 0.01, 2] = np.inf
        vals[C // 2] = np.nan
        vals[C // 3, 1] = -np.inf
    return torch.from_numpy(pos).cuda(), torch.from_numpy(vals).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("squares", [False, True])
@pytest.mark.parametrize("name", FILTERS)
def test_filter_kernel_equals_plain_on_card(card, name, squares):
    rng = np.random.default_rng(FILTERS.index(name) * 2 + squares)
    for W, H, C, starts, nonfinite in SHAPES:
        film = F.Film(W, H, name, "cuda")
        got, want = film.zeros(), film.zeros()
        got_sq, want_sq = film.zeros(), film.zeros()
        before = F.COUNTS["film_splat_filter"]
        for start in starts:
            pos, vals = _chunk(rng, W, H, start, C, nonfinite=nonfinite)
            film.splat(got, start, pos, vals, got_sq if squares else None)
            F.splat_filter_plain(name, want, start, pos, vals,
                                 want_sq if squares else None)
        torch.cuda.synchronize()
        for a, b in zip(got + got_sq, want + want_sq):
            _same(a, b)
        assert F.COUNTS["film_splat_filter"] == before + len(starts)
        assert bool(got_sq[1].any()) == squares


@pytest.mark.gpu
def test_sample_outside_its_pixel_fails_the_launch(card):
    """A sample outside its own pixel traps the kernel (its window would
    reach pixels the gather does not visit); the card's context is then
    lost, so a process of its own makes the call."""
    code = textwrap.dedent("""
        import torch
        from ppg_tpu_torch.render import film as F
        film = F.Film(23, 11, "gaussian", "cuda")
        ids = torch.arange(64, device="cuda")
        pos = torch.stack([ids % 23, ids // 23], -1).float() + 0.5
        pos[37, 0] += 1.0
        try:
            film.splat(film.zeros(), 0, pos, torch.ones(64, 3,
                                                        device="cuda"))
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

"""K11, Woodcock and ratio tracking through grid media, on a card.

- tools/media_cases.py's edge set (vacuum and homogeneous lanes, a grid
  of zeros, t_surf = inf, zero and negative distances, the grid's max
  faces and last cells, walks of many rejected events), two seeds, both
  modes, and strided inputs: K11 bit for bit with its plain version on
  the card.
- The cap: media_cases.cap_lanes with n_steps = 1 (1,024 events) bit for
  bit, and the default 65,536 events in the kernel alone against the
  plain version's values for the lanes that escape.
- The smoke box's 256^3 puff grid (scene/testscenes.py::puff_grid) at
  262,144 lanes through its cube, both modes: bit for bit.
- A render of the smoke box (mini_cbox_smoke_xml at 64 x 64, a 64^3
  grid, nee always) through K11 only: no plain loop on the card, finite,
  one track launch a bounce, one ratio launch a shadow-walk crossing.

The kernels have no CPU mode, so the `gpu` tests run only on a card and
skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_media_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch import media as M
from ppg_tpu_torch.tools import media_cases as MC


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool:
        assert torch.equal(a, b), int((a != b).sum())
        return
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).sum())


def _on(card, arrays):
    return tuple(torch.from_numpy(x).to(card) for x in arrays)


def _seed(card, s):
    return torch.tensor([s], dtype=torch.int64, device=card)


def _both_modes(media, mid, o, d, t, seed, n_steps=M.WOODCOCK_STEPS):
    M.reset_counts()
    got = M.woodcock_sample(media, mid, o, d, t, seed, n_steps)
    want = M.woodcock_sample_plain(media, mid, o, d, t, seed, n_steps)
    for a, b in zip(got, want):
        _same(a, b)
    dist = torch.clamp(t, max=2.5)
    _same(M.ratio_transmittance(media, mid, o, d, dist, seed, n_steps),
          M.ratio_transmittance_plain(media, mid, o, d, dist, seed, n_steps))
    assert (M.COUNTS["media_track"], M.COUNTS["media_ratio"]) == (1, 1)
    return want


@pytest.mark.gpu
def test_k11_edges_equal_plain(card):
    media = M.MediaArrays.from_table(MC.edge_table(), card)
    mid, o, d, t = _on(card, MC.edge_lanes(6000, 13))
    for s in (5, (1 << 32) - 3):
        want = _both_modes(media, mid, o, d, t, _seed(card, s))
    assert 0 < int(want[0].sum()) < len(mid)
    wide = torch.zeros((len(mid), 9), device=card)
    wide[:, 1:4], wide[:, 5:8] = o, d
    tw = torch.stack([t, t], -1)
    mw = torch.stack([mid, mid], -1)
    got = M.woodcock_sample(media, mw[:, 1], wide[:, 1:4], wide[:, 5:8],
                            tw[:, 0], _seed(card, 5))
    for a, b in zip(got, M.woodcock_sample_plain(media, mid, o, d, t,
                                                 _seed(card, 5))):
        _same(a, b)


@pytest.mark.gpu
def test_k11_at_the_cap(card):
    media = M.MediaArrays.from_table(MC.edge_table(), card)
    mid, o, d, t = _on(card, MC.cap_lanes())
    seed = _seed(card, 99)
    want = _both_modes(media, mid, o, d, t, seed, n_steps=1)
    _same(M.ratio_transmittance(media, mid, o, d, t, seed, 1),
          M.ratio_transmittance_plain(media, mid, o, d, t, seed, 1))
    esc = torch.tensor([0, 2, 5], device=card)
    got = M.woodcock_sample(media, mid[esc], o[esc], d[esc], t[esc], seed)
    for a, b in zip(got, want):
        _same(a, b[esc])
    assert not bool(got[0].any()) and bool(got[1].isinf().all())


@pytest.mark.gpu
def test_k11_smoke_grid(card):
    from ppg_tpu_torch.scene.testscenes import (SMOKE_CENTER, SMOKE_HALF,
                                                puff_grid)

    c, h = np.asarray(SMOKE_CENTER), SMOKE_HALF
    media = M.MediaArrays.from_table([dict(
        hetero=True, density=puff_grid(256, 0), bbox_min=c - h,
        bbox_max=c + h, scale=8.0 / (2 * h), albedo=np.full(3, 0.8),
        g=0.3)], card)
    L = 1 << 18
    rng = np.random.default_rng(2)
    o = (c + rng.uniform(-h, h, (L, 3))).astype(np.float32)
    d = rng.normal(size=(L, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = rng.uniform(0.0, 2 * h, L).astype(np.float32)
    mid = np.zeros(L, np.int32)
    mid[::9] = -1
    want = _both_modes(media, *_on(card, (mid, o, d, t)), _seed(card, 7))
    assert 0.05 < float(want[0].float().mean()) < 0.95


@pytest.mark.gpu
def test_smoke_render_runs_k11_only(card, tmp_path):
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators import wavefront as WF
    from ppg_tpu_torch.scene.testscenes import (mini_cbox_smoke_xml,
                                                scene_from_xml)

    sc = scene_from_xml(mini_cbox_smoke_xml(str(tmp_path), res=64,
                                            nee="always", grid_res=64,
                                            max_depth=6))
    M.reset_counts()
    WF.reset_counts()
    img = driver.render(sc, spp=2, seed=0, chunk=64 * 64, device="cuda")
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    assert M.COUNTS["media_plain_on_cuda"] == 0
    # one track launch a bounce (5 bounces at maxDepth 6), one ratio
    # launch a shadow-walk crossing
    assert M.COUNTS["media_track"] == 2 * 5
    assert M.COUNTS["media_ratio"] == WF.WALK_COUNTS["crossings"] > 0

"""K11, Woodcock and ratio tracking through grid media, on a card.

- tools/media_cases.py's edge set (vacuum and homogeneous lanes, a grid
  of zeros, t_surf = inf, zero and negative distances, the grid's max
  faces and last cells, walks of many rejected events), two seeds, both
  modes, and strided inputs: K11 bit for bit with its plain version on
  the card. So are its tile cases (a tile of gated-out lanes, tiles of
  gated-in lanes, a ragged last tile, fewer lanes than a tile, blocks of
  several tiles and chunks), 300,000 lanes, more tiles than the card's
  persistent grid has blocks, two grids whose offsets put corners below
  index 0 and past the grid (clamped), and 66 media; in every case the
  grids end where a NaN tail begins, so that a corner read past them
  shows.
- The cap: media_cases.cap_lanes with n_steps = 1 (1,024 events) bit for
  bit, and the default 65,536 events in the kernel alone against the
  plain version's values for the lanes that escape; caps of 1-3, 5-7
  and 9 events, at every place of a batch.
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


# tools/media_cases.py's edge set and its tile cases, and a case of more
# tiles than the card's persistent grid has blocks (each block takes
# several and refills its threads from its queue)
K11_CASES = (["edges"] + list(MC.TILE_CASES)
             + ["tiles beyond the grid", "clamped corners", "many media"])


def _case_lanes(case):
    if case == "edges":
        return MC.edge_lanes(6000, 13)
    if case in ("clamped corners", "many media"):
        return MC.tiled_lanes(1500, 26, 4)
    if case == "tiles beyond the grid":
        return MC.tiled_lanes(300_000, 25, 300)
    return MC.tiled_lanes(*MC.TILE_CASES[case])


def _nan_tail(rows, media):
    """MediaArrays of `rows` over media's grids, the grids a view of a
    longer buffer whose tail is NaN (a corner read past their end shows)."""
    G = media.grid.shape[0]
    buf = torch.full((G + 64,), float("nan"), device=media.grid.device)
    buf[:G] = media.grid
    return M.MediaArrays(rows, buf[:G], media.num)


@pytest.mark.gpu
@pytest.mark.parametrize("case", K11_CASES)
def test_k11_edges_equal_plain(card, case):
    media = M.MediaArrays.from_table(
        MC.many_media() if case == "many media" else MC.edge_table(), card)
    rows = media.rows
    if case == "clamped corners":
        rows = torch.from_numpy(MC.shifted_rows(
            rows.cpu().numpy(), media.grid.shape[0])).to(card)
    media = _nan_tail(rows, media)
    mid, o, d, t = _on(card, _case_lanes(case))
    for s in (5, (1 << 32) - 3):
        want = _both_modes(media, mid, o, d, t, _seed(card, s))
    if case != "edges":
        return
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


# None: n_steps = 1 (1,024 events) and the default cap; a number, that
# cap in events (WOODCOCK_MAX_BLOCKS patched to 1), at every place of a
# batch of up to eight events
CAPS = [None, 1, 2, 3, 5, 6, 7, 9]


@pytest.mark.gpu
@pytest.mark.parametrize("cap", CAPS)
def test_k11_at_the_cap(card, cap, monkeypatch):
    media = M.MediaArrays.from_table(MC.edge_table(), card)
    mid, o, d, t = _on(card, MC.cap_lanes())
    seed = _seed(card, 99)
    if cap is not None:
        monkeypatch.setattr(M, "WOODCOCK_MAX_BLOCKS", 1)
        want = _both_modes(media, mid, o, d, t, seed, n_steps=cap)
        _same(M.ratio_transmittance(media, mid, o, d, t, seed, cap),
              M.ratio_transmittance_plain(media, mid, o, d, t, seed, cap))
        assert not bool(want[0][[0, 2, 5]].any())
        return
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

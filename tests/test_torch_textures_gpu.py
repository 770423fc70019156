"""K9, the atlas lookup, on a card.

- Every mode (base level, footprint, uv Jacobian with each filter code,
  bump) on 262,144 lookups of tools/texture_cases.py's atlas and lanes
  (edge cases included: the saturating floors, NaN and infinite uvs, zero
  and extreme differentials, slot ids 0, -1 and past the last): K9 bit
  for bit (two NaNs equal) with sample_atlas_plain on the card.
- One stacked call (three rows a lane, the slot ids a strided column of
  a row table, uv and the Jacobian strided views): bit for bit.
- A render of the textured box (scene/testscenes.py::
  mini_cbox_textures_xml at 64 x 64, its sphere walking K2) through K9
  only: no plain lookup on the card, finite and the right shape.

The kernels have no CPU mode, so the `gpu` tests run only on a card and
skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_textures_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.scene import textures as TX
from ppg_tpu_torch.tools import texture_cases

L = 1 << 18


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def atlas(card, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("k9"))
    return TX.TextureAtlas.build(texture_cases.atlas_specs(d), d, card)


@pytest.fixture(scope="module")
def lanes(card, atlas):
    return {k: torch.from_numpy(v).to(card) for k, v in
            texture_cases.lanes(atlas.n_slots, L, seed=9).items()}


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).any(-1).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["base", "foot", "duv", "bump"])
def test_k9_equals_plain(card, atlas, lanes, mode):
    t, uv = lanes["tex_id"], lanes["uv"]
    kw = dict(foot=dict(foot_uv=lanes["foot"]),
              duv=dict(duv=(lanes["d0"], lanes["d1"]))).get(mode, {})
    TX.reset_counts()
    if mode == "bump":
        got = TX.bump_lookups(atlas, t, uv)
        want = TX.sample_atlas_plain(atlas, t, uv, bump=True)
    else:
        got = TX.sample_atlas(atlas, t, uv, **kw)
        want = TX.sample_atlas_plain(atlas, t, uv, **kw)
    assert TX.COUNTS == {"atlas_kernel": 1, "atlas_plain_on_cuda": 1}
    assert got.shape == want.shape == ((3 if mode == "bump" else 1) * L, 3)
    _same(got, want)


@pytest.mark.gpu
def test_k9_stacked_strided(card, atlas, lanes):
    M = L // 4
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.integers(
        -1, atlas.n_slots, (3 * M, 5)).astype(np.int32)).to(card)
    tids = table[:, 3]  # a strided column
    uv2 = torch.zeros((M, 4), device=card)
    uv2[:, 1:3] = lanes["uv"][:M]
    uv = uv2[:, 1:3]
    duv = (lanes["d0"][:M], lanes["d1"][:M])
    got = TX.sample_atlas(atlas, tids, uv, duv=duv)
    want = TX.sample_atlas_plain(atlas, tids.contiguous(), uv.contiguous(),
                                 duv=duv)
    _same(got, want)


@pytest.mark.gpu
def test_textured_render_runs_k9_only(card, tmp_path):
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.scene.testscenes import (mini_cbox_textures_xml,
                                                scene_from_xml)

    sc = scene_from_xml(mini_cbox_textures_xml(str(tmp_path), res=64,
                                               nee="always"))
    TX.reset_counts()
    img = driver.render(sc, spp=4, seed=0, chunk=64 * 64, device="cuda")
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    assert TX.COUNTS["atlas_plain_on_cuda"] == 0
    # a site call and a bump call a bounce, and the walk's crossings of
    # the panel
    assert TX.COUNTS["atlas_kernel"] > 2 * 5 * 4

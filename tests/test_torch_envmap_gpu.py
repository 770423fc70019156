"""K10, the environment map's sampling and lookup, on a card.

- tools/env_cases.py's edge maps and lanes (black rows and poles, a sun's
  few hot texels, a constant map; 17 x 33, 5 x 1000, one row, one column,
  4,100 x 2 (taller than the row CDF K10 stages whole) and an inf texel,
  whose CDFs hold NaN; uniforms at 0, 1, on, just below and halfway
  between CDF values and slot-pick remainders; points inside, on and
  beyond the bounding sphere; the axes, the poles, the seam and the zero
  vector), both modes, with and without a gate and a slot count, strided
  inputs: K10 bit for bit (two NaNs equal) with its plain version on the
  card. The same on env_cases.scrambled's tables (CDFs that do not
  ascend, NaN at their searches' first midpoints).
- A 4096 x 2048 sunsky (the sky box's map) at 262,144 lanes in both
  modes: bit for bit; and at 2^20 lanes behind one mask, so that the
  persistent grid's blocks take several tiles and fill their queues.
- A render of the sky box (scene/testscenes.py::mini_cbox_sky_xml at
  64 x 64, a 512 x 256 map) through K10 only: no plain call on the card,
  finite and the right shape, one sample launch a bounce and a lookup
  launch a bounce and a camera segment.

The kernels have no CPU mode, so the `gpu` tests run only on a card and
skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_envmap_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.emitters import envmap as EV
from ppg_tpu_torch.emitters import sunsky as SS
from ppg_tpu_torch.tools import env_cases

L = 1 << 18


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).reshape(len(a), -1).any(-1).sum())


def _both_modes(env, t, gate, n):
    EV.reset_counts()
    got = EV.sample_direct(env, t["p"], t["ux"], t["uy"], gate, n)
    want = EV.sample_direct_plain(env, t["p"], t["ux"], t["uy"], gate, n)
    for k in ("d", "dist", "pdf", "value"):
        _same(got[k], want[k])
    got = EV.lookup(env, t["d"], gate, n)
    want = EV.lookup_plain(env, t["d"], gate, n)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert EV.COUNTS == {"env_sample": 1, "env_lookup": 1,
                         "env_plain_on_cuda": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(env_cases.edge_maps()))
def test_k10_edges_equal_plain(card, name):
    img, rot = env_cases.edge_maps()[name]
    arrays = EV.EnvmapArrays.arrays(img, rot, np.zeros(3), np.ones(3))
    env = EV.EnvmapArrays(arrays, card)
    t = {k: torch.from_numpy(v).to(card) for k, v in
         env_cases.edge_lanes(arrays, 20000, seed=8).items()}
    _both_modes(env, t, None, 1)
    _both_modes(env, t, EV.Gate(t["key"], 1, t["m1"], t["m2"]), 4)
    # strided: the points and directions as views of wider rows, the row
    # uniform a column of a [L, 2] draw
    wide = torch.zeros((20000, 7), device=card)
    wide[:, 2:5] = t["d"]
    _same(EV.lookup(env, wide[:, 2:5])[0], EV.lookup_plain(env, t["d"])[0])
    wide[:, 2:5] = t["p"]
    u2 = torch.stack([t["ux"], t["uy"]], -1)
    got = EV.sample_direct(env, wide[:, 2:5], t["ux"], u2[:, 1])
    want = EV.sample_direct_plain(env, t["p"], t["ux"], t["uy"])
    _same(got["d"], want["d"])
    _same(got["value"], want["value"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["black rows, turned",
                                  "4100 x 2, tall, turned"])
def test_k10_scrambled_tables_equal_plain(card, name):
    img, rot = env_cases.edge_maps()[name]
    arrays = env_cases.scrambled(EV.EnvmapArrays.arrays(
        img, rot, np.zeros(3), np.ones(3)))
    env = EV.EnvmapArrays(arrays, card)
    t = {k: torch.from_numpy(v).to(card) for k, v in
         env_cases.edge_lanes(arrays, 20000, seed=5).items()}
    _both_modes(env, t, None, 1)
    _both_modes(env, t, EV.Gate(t["key"], 1, t["m1"], t["m2"]), 4)


@pytest.mark.gpu
def test_k10_sunsky_4096(card):
    img = SS.rasterize_sun_sky(dict(sunDirection=[0.0, 0.5, -1.0],
                                    resolution=4096), "sunsky")
    arrays = EV.EnvmapArrays.arrays(img, np.eye(3), np.array([-1, 0, -1.0]),
                                    np.array([1, 2, 1.0]))
    env = EV.EnvmapArrays(arrays, card)
    rng = np.random.default_rng(9)
    v = rng.normal(size=(L, 3))
    t = dict(ux=rng.random(L), uy=rng.random(L),
             p=rng.random((L, 3)) * 2 - [1, 0, 1],
             d=v / np.linalg.norm(v, axis=-1, keepdims=True),
             key=rng.integers(0, 4, L), m1=rng.random(L) < 0.9)
    t = {k: torch.from_numpy(np.asarray(x, np.int32 if k == "key" else
                                        bool if k == "m1" else np.float32))
         .to(card) for k, x in t.items()}
    _both_modes(env, t, None, 1)
    _both_modes(env, t, EV.Gate(t["key"], 1, t["m1"]), 4)
    # four times the lanes behind one mask (about 90% in): a block takes
    # about four tiles, so its queue fills and leaves a remainder
    t = {k: torch.cat([v] * 4) for k, v in t.items()}
    _both_modes(env, t, EV.Gate(m1=t["m1"]), 2)


@pytest.mark.gpu
def test_sky_render_runs_k10_only(card):
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.scene.testscenes import (mini_cbox_sky_xml,
                                                scene_from_xml)

    sc = scene_from_xml(mini_cbox_sky_xml(res=64, max_depth=6,
                                          nee="always", resolution=512))
    EV.reset_counts()
    img = driver.render(sc, spp=4, seed=0, chunk=64 * 64, device="cuda")
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    # five bounces a wavefront (maxDepth 6), four wavefronts
    assert EV.COUNTS == {"env_sample": 4 * 5, "env_lookup": 4 * 6,
                         "env_plain_on_cuda": 0}

"""K12, the dipole's exitance sum, on a card.

- tools/subsurface_cases.py's cases (several owners, one tile and many,
  padded repeats and a zero area, a non-finite E in one owner, owners
  interleaved point by point, lanes with ss_id -1 and cos_o <= 0, eta 1,
  lane counts not multiples of the block, lanes on points, far points,
  an owner outside the guard, every lane gated in, 128 and 129 lanes
  gated in, single-owner tiles beside a shared tile): K12 bit for bit
  with lo_sub_plain on the card, and with strided lanes.
- K12's derived square root and reciprocals (from one rsqrt.approx)
  against sqrtf, 1.0f / dr and 1.0f / dd on every float x of the guard's
  range [2^-40, 2^40), and its Markstein quotient against the IEEE
  division on 2^32 drawn pairs, through csrc/subsurface.cu's
  ppg_dipole_check: no value differs, and the guard takes out only the
  floats within a few ulps of a power of two (8 a binade).
- A marble sphere's cloud at the main path's size (51 tiles of one owner,
  13,056 points) over 262,144 lanes of which about a tenth are gated in,
  and all of them: bit for bit.
- A render of mini_cbox holding a dipole cube (64 x 64, nee always)
  through K12 only: no plain call on the card, one launch a bounce,
  finite.

The kernels have no CPU mode, so the `gpu` tests run only on a card and
skip elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_subsurface_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch import subsurface as TS
from ppg_tpu_torch.tools import subsurface_cases as SC


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).sum())


def _case(card, c):
    ss = TS.SubsurfArrays(*(torch.from_numpy(c[k]).to(card) for k in (
        "params", "pts", "E", "area", "pt_ss")),
        torch.full((1,), -1, dtype=torch.int32, device=card),
        num=len(c["params"]))
    return ss, tuple(torch.from_numpy(c[k]).to(card)
                     for k in ("ss_id", "p", "cos_o"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SC.CASES))
def test_k12_equals_plain_on_the_card(card, case):
    ss, lanes = _case(card, SC.case(case))
    TS.reset_counts()
    got = TS.lo_sub(ss, *lanes)
    assert TS.COUNTS["dipole_lo"] == 1
    _same(got, TS.lo_sub_plain(ss, *lanes))
    sid, p, co = lanes
    sid2 = torch.stack([sid, torch.full_like(sid, 5)], 1)[:, 0]
    p2 = p.t().contiguous().t()
    co2 = torch.stack([-co, co], 1)[:, 1]
    _same(TS.lo_sub(ss, sid2, p2, co2), got)


@pytest.mark.gpu
def test_k12_derived_operations_exhaustive_on_the_card(card):
    lib = TS._lib or TS.build()
    lo, hi = TS.X_RANGE_BITS
    r = TS.check_derived(lib, card, lo, hi, 1 << 32, seed=11)
    assert r["values"] == hi - lo and r["quotients"] == 1 << 32, r
    assert r["sqrt_differ"] == 0, r
    assert r["rcp_dr_differ"] == 0 and r["rcp_dd_differ"] == 0, r
    assert r["quotients_differ"] == 0, r
    assert r["guarded_out"] == 8 * ((hi - lo) >> 23), r


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [0.1, 1.0])
def test_k12_at_the_main_path_size(card, gated):
    rng = np.random.default_rng(3)
    P, L = 51 * TS.PT_BLOCK, 1 << 18
    v = rng.normal(size=(P, 3))
    pts = 0.4 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    c = dict(params=TS.dipole_params(dict(SC.MARBLE))[None],
             pts=pts.astype(np.float32),
             E=rng.uniform(0, 3, (P, 3)).astype(np.float32),
             area=np.full(P, 2.0 / P, np.float32),
             pt_ss=np.zeros(P, np.int32),
             ss_id=np.where(rng.random(L) < gated, 0, -1).astype(np.int32),
             p=pts[rng.integers(0, P, L)].astype(np.float32),
             cos_o=rng.uniform(-0.2, 1, L).astype(np.float32))
    if gated == 1.0:
        c["cos_o"] = rng.uniform(0.01, 1, L).astype(np.float32)
    ss, lanes = _case(card, c)
    _same(TS.lo_sub(ss, *lanes), TS.lo_sub_plain(ss, *lanes))


@pytest.mark.gpu
def test_render_runs_through_k12(card):
    from ppg_tpu_torch.integrators import driver as TD
    from ppg_tpu_torch.scene.testscenes import (MINI_CBOX, light_down,
                                                scene_from_xml)

    cube = """  <shape type="cube">
    <transform name="toWorld"><scale value="0.25"/>
      <translate x="-0.4" y="0.25" z="0.2"/></transform>
    <subsurface type="dipole">
      <string name="material" value="marble"/>
      <float name="scale" value="1"/>
    </subsurface>
  </shape>
</scene>"""
    sc = scene_from_xml(light_down(MINI_CBOX.format(
        res=64, budget=4, max_depth=6, nee="always")).replace("</scene>",
                                                              cube))
    TS.reset_counts()
    img = TD.render(sc, spp=4, seed=0, chunk=64 * 64, device="cuda")
    assert np.isfinite(img).all() and img.mean() > 0
    cfg = TD.make_config(sc, guiding=False)
    assert TS.COUNTS["dipole_plain_on_cuda"] == 0
    assert TS.COUNTS["dipole_lo"] == 4 * cfg.n_bounces

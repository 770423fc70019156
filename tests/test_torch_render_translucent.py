"""Guided renders of subsurface scenes on the CPU, continued from
tests/test_torch_render_subsurface.py (the same gates,
test_torch_render.assert_images_agree):

- Guided renders (the tracer records vertices) against the port's
  unguided renders, 16 x 16, maxDepth 4, nee always, hidden emitters, a
  31-spp budget against 32 spp unguided: the small translucent box
  (scene/testscenes.py::mini_cbox_translucent_xml without its sphere: the
  single-scattering cube, 24 triangles, through the sweep) and mini_cbox
  holding a dipole cube of marble at scale 1 (a 256-point cloud). Margins
  on the CPU over three seeds: means 0.7-1.0% and 0.9-1.7% apart, block
  medians 0.014-0.027 and 0.021-0.022 (with the luminaire seen directly,
  its jittered edges put the means up to 12% apart at this size).
- No training record (bsdf vertex or NEE record) made at a
  single-scattering hit is valid: the cube's boundary is a delta
  interface (its dtree id is -1), though such records exist.
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.testscenes import scene_from_xml
from test_torch_render import assert_images_agree
from test_torch_render_subsurface import box

RES = 16
# the translucent box's cube (scene/testscenes.py::SSS_CUBE)
CUBE_HALF, CUBE_CENTER, CUBE_TURN = 0.25, (0.45, 0.25, -0.2), 30.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def guided_boxes():
    """Each box's guided render, with the points and valid flags of every
    training record the tracer resolves splat targets for."""
    from ppg_tpu_torch.guiding import sdtree as G

    out = {}
    for dipole in (False, True):
        sc = scene_from_xml(box(RES, 31, dipole=dipole))
        seen, targets = [], G.splat_targets

        def kept(sdtree, dtree_id, d, valid, *args, p_rec=None, **kw):
            seen.append((p_rec.numpy().copy(), valid.numpy().copy()))
            return targets(sdtree, dtree_id, d, valid, *args, p_rec=p_rec,
                           **kw)
        G.splat_targets = kept
        try:
            tracer = GuidedPathTracer(sc, chunk=RES * RES, device="cpu")
            img = tracer.render(seed=0)
        finally:
            G.splat_targets = targets
        out[dipole] = (sc, tracer, img, seen)
    return out


@pytest.mark.parametrize("dipole", [False, True],
                         ids=["single scattering", "dipole"])
def test_guided_box_agrees_with_unguided(guided_boxes, dipole):
    sc, tracer, img, _ = guided_boxes[dipole]
    cfg = tracer.base_cfg
    assert (cfg.has_sss, cfg.has_subsurf) == (not dipole, dipole)
    assert cfg.record_vertices and tracer.stats[-1]["is_final"]
    if dipole:
        ss = tracer.scene_dev.subsurf
        assert ss.pts.shape[0] == 256 and ss.tiles.tolist() == [[0, 1]]
        # the points of the face on the floor see none of the room
        assert bool((ss.E >= 0).all()) and float((ss.E > 0).any(-1).float(
        ).mean()) > 0.7
    ref = TD.render(sc, spp=32, seed=2, chunk=RES * RES, device="cpu")
    assert np.isfinite(img).all() and img.mean() > 0
    assert_images_agree(ref, img)


def test_no_record_at_a_single_scattering_hit_is_valid(guided_boxes):
    seen = guided_boxes[False][3]
    p = np.concatenate([s[0] for s in seen]) - np.asarray(CUBE_CENTER)
    valid = np.concatenate([s[1] for s in seen])
    # the cube's frame: turned CUBE_TURN degrees about y
    # (records of parked lanes hold points at infinity)
    a = np.radians(CUBE_TURN)
    with np.errstate(invalid="ignore", over="ignore"):
        x = p[:, 0] * np.cos(a) - p[:, 2] * np.sin(a)
        z = p[:, 0] * np.sin(a) + p[:, 2] * np.cos(a)
        q = np.abs(np.stack([x, p[:, 1], z], -1))
        on = (q < CUBE_HALF + 1e-3).all(-1) \
            & (q > CUBE_HALF - 1e-3).any(-1) \
            & (p[:, 1] > -CUBE_HALF + 1e-2)  # not the floor beneath it
    assert on.sum() > 50
    assert not valid[on].any() and valid[~on].any()

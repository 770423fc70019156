"""The port's five cameras (ppg_tpu_torch/render/sensor.py) against
ppg_tpu's on the same numpy inputs: sample_rays (with the thin lens's
aperture samples), footprint and dir_differentials, at W, H = 23, 11
with the transforms the scene loader gives (a lookAt; a scaled and
rotated frame for the orthographic view). The two packages' sin, cos,
norm and division differ in the last bits, so rays agree within RAY_TOL;
the concentric disk map the thin lens uses agrees within DISK_TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.core import warp as JW
from ppg_tpu.render import sensor as JS
from ppg_tpu_torch.core import warp as TW
from ppg_tpu_torch.render import sensor as TS

W, H, L = 23, 11, 512
RAY_TOL = 2e-6  # relative, and absolute on unit vectors: float32 ulps
DISK_TOL = 2e-7


def _look_at(origin, target, up):
    """Mitsuba's lookAt as the scene loader builds it (x = left)."""
    o, t, u = (np.asarray(v, np.float64) for v in (origin, target, up))
    d = (t - o) / np.linalg.norm(t - o)
    left = np.cross(u, d)
    left /= np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(d, left), d, o
    return m


def _configs():
    cam = _look_at([0, 1, -3.5], [0, 1, -2.5], [0, 1, 0])
    tilted = _look_at([0.3, 1.2, -3.0], [0, 0.8, 0.5], [0.1, 1, 0])
    scaled = tilted @ np.diag([1.7, 1.7, 1.0, 1.0])
    base = dict(near_clip=0.01, far_clip=100.0, xfov=39.3077)
    return {
        "perspective": dict(base, type="perspective", to_world=cam),
        "thinlens": dict(base, type="thinlens", to_world=tilted,
                         apertureRadius=0.05, focusDistance=4.5),
        "thinlens_defaults": dict(base, type="thinlens", to_world=cam),
        "orthographic": dict(base, type="orthographic", to_world=scaled),
        "spherical": dict(type="spherical", to_world=tilted),
        "radiancemeter": dict(type="radiancemeter", to_world=tilted),
    }


CONFIGS = _configs()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sensor_equals_ppg_tpu(name):
    cfg, film = CONFIGS[name], dict(width=W, height=H)
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    pos = (rng.random((L, 2)) * [W, H]).astype(np.float32)
    u_lens = rng.random((L, 2)).astype(np.float32)
    t = rng.uniform(0.01, 10.0, L).astype(np.float32)
    js, ts = JS.make_sensor(cfg, film), TS.make_sensor(cfg, film, "cpu")
    assert type(ts).__name__ == type(js).__name__
    assert ts.needs_lens_sample == js.needs_lens_sample
    lens = (jnp.asarray(u_lens), torch.from_numpy(u_lens)) \
        if js.needs_lens_sample else (None, None)
    want = js.sample_rays(jnp.asarray(pos), lens[0])
    got = ts.sample_rays(torch.from_numpy(pos), lens[1])
    for g, w in zip(got, want):
        g, w = g.numpy(), np.broadcast_to(np.asarray(w), g.shape)
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=RAY_TOL, atol=RAY_TOL)
    np.testing.assert_allclose(ts.footprint(torch.from_numpy(t)).numpy(),
                               np.asarray(js.footprint(jnp.asarray(t))),
                               rtol=RAY_TOL, atol=0)
    if hasattr(js, "dir_differentials"):
        d = want[1]
        for g, w in zip(ts.dir_differentials(torch.from_numpy(np.array(d))),
                        js.dir_differentials(d)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=RAY_TOL, atol=RAY_TOL)


def test_thin_lens_reads_its_properties():
    """apertureRadius and focusDistance from the sensor's properties,
    0.1 and 1.0 by default; without lens samples the rays leave the lens
    centre, as the pinhole camera's do."""
    film = dict(width=W, height=H)
    lens = TS.make_sensor(CONFIGS["thinlens"], film, "cpu")
    plain = TS.make_sensor(CONFIGS["thinlens_defaults"], film, "cpu")
    assert (lens.aperture, lens.focus) == (0.05, 4.5)
    assert (plain.aperture, plain.focus) == (0.1, 1.0)
    pos = torch.rand(64, 2) * torch.tensor([W, H])
    pin = TS.make_sensor(dict(CONFIGS["thinlens_defaults"],
                              type="perspective"), film, "cpu")
    for g, w in zip(plain.sample_rays(pos), pin.sample_rays(pos)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RAY_TOL,
                                   atol=RAY_TOL)


def test_radiance_meter_shoots_its_axis_whatever_the_film():
    cfg = CONFIGS["radiancemeter"]
    m = TS.make_sensor(cfg, dict(width=7, height=3), "cpu")
    o, d, _, _ = m.sample_rays(torch.rand(9, 2) * 7)
    z = cfg["to_world"][:3, 2]
    np.testing.assert_allclose(d.numpy(), np.broadcast_to(
        z / np.linalg.norm(z), (9, 3)), atol=1e-7)
    np.testing.assert_allclose(o.numpy(), np.broadcast_to(
        cfg["to_world"][:3, 3], (9, 3)), atol=1e-7)


def test_concentric_disk_equals_ppg_tpu_on_lens_samples():
    rng = np.random.default_rng(5)
    u = np.concatenate([rng.random((4096, 2)), [[0.5, 0.5], [0.0, 0.0],
                                                [1.0, 0.5], [0.5, 0.0]]])
    u = u.astype(np.float32)
    got = TW.square_to_uniform_disk_concentric(torch.from_numpy(u)).numpy()
    want = np.asarray(JW.square_to_uniform_disk_concentric(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=0, atol=DISK_TOL)


def test_unknown_sensor_type_is_refused():
    with pytest.raises(NotImplementedError, match="fisheye"):
        TS.make_sensor(dict(type="fisheye", to_world=np.eye(4)),
                       dict(width=W, height=H), "cpu")

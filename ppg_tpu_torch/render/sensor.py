"""Camera ray generation (counterpart of ppg_tpu/render/sensor.py): the
`perspective` (perspective.cpp:126-292), `thinlens` (thinlens.cpp),
`orthographic` (orthographic.cpp:95-118), `spherical`
(spherical.cpp:67-83) and `radiancemeter` (radiancemeter.cpp) cameras.
Every camera's importance weight is 1. Camera axes follow Mitsuba's
lookAt (x = left, y = up, z = view); the matrix products are written out,
so no matmul precision mode applies."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import warp


def _to_world(v, axes):
    """v @ axes.T for v [L,3] (camera to world)."""
    return (v[:, 0:1] * axes[:, 0] + v[:, 1:2] * axes[:, 1]
            + v[:, 2:3] * axes[:, 2])


def _to_camera(v, axes):
    """v @ axes for v [L,3] (world to camera; the axes are orthonormal)."""
    return v[:, 0:1] * axes[0] + v[:, 1:2] * axes[1] + v[:, 2:3] * axes[2]


def _frame(sensor, sensor_cfg, film_cfg, device):
    """The film size, origin and axes every camera keeps."""
    sensor.W = film_cfg["width"]
    sensor.H = film_cfg["height"]
    m = np.asarray(sensor_cfg["to_world"], np.float64)
    sensor.origin = torch.tensor(m[:3, 3], dtype=torch.float32,
                                 device=device)
    # columns: left / up / view
    sensor.axes = torch.tensor(m[:3, :3], dtype=torch.float32, device=device)
    return m


class PerspectiveSensor:
    """Mitsuba's perspective camera: film sample (u, v) maps to the
    camera-space direction ((1-2u) tan, (1-2v) tan/aspect, 1)."""

    needs_lens_sample = False

    def __init__(self, sensor_cfg, film_cfg, device):
        _frame(self, sensor_cfg, film_cfg, device)
        self.aspect = self.W / self.H
        # the camera-space x and y axes of dir_differentials
        self.e_x = torch.tensor([1.0, 0.0, 0.0], device=device)
        self.e_y = torch.tensor([0.0, 1.0, 0.0], device=device)
        self.xfov = float(sensor_cfg["xfov"])
        self.near = float(sensor_cfg.get("near_clip", 1e-2))
        self.far = float(sensor_cfg.get("far_clip", 1e4))
        self.tan_half = np.tan(np.deg2rad(self.xfov) / 2.0)

    def footprint(self, t):
        """World-space pixel footprint at hit distance t (an isotropic
        stand-in for the camera's ray differentials)."""
        return t * (2.0 * self.tan_half / self.W)

    def dir_differentials(self, d):
        """Per-pixel direction differentials (ddir/dpx, ddir/dpy) from the
        unit direction d [L,3] itself: with s = -2 tan / W,
        d(dir)/dpx = s z (e_x - dir dir_x) in camera space, the same scale
        for y since aspect = W/H."""
        d_cam = _to_camera(d, self.axes)
        s = -2.0 * self.tan_half / self.W
        z = d_cam[:, 2:3]
        ddx = s * z * (self.e_x - d_cam * d_cam[:, 0:1])
        ddy = s * z * (self.e_y - d_cam * d_cam[:, 1:2])
        return _to_world(ddx, self.axes), _to_world(ddy, self.axes)

    def _near_plane(self, sample_pos):
        u = sample_pos[:, 0] / self.W
        v = sample_pos[:, 1] / self.H
        dx = (1.0 - 2.0 * u) * self.tan_half
        dy = (1.0 - 2.0 * v) * self.tan_half / self.aspect
        return dx, dy

    def sample_rays(self, sample_pos, u_lens=None):
        """sample_pos: [L,2] continuous film coords in [0,W]x[0,H].
        Returns (o [L,3], d [L,3], t_min [L], t_max [L])."""
        dx, dy = self._near_plane(sample_pos)
        d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
        d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
        d = _to_world(d_cam, self.axes)
        inv_z = 1.0 / d_cam[:, 2]
        o = self.origin.expand_as(d)
        return o, d, self.near * inv_z, self.far * inv_z


class ThinLensSensor(PerspectiveSensor):
    """Depth-of-field camera: rays start on a disk of apertureRadius
    (default 0.1) and converge on the focusDistance plane (default 1)."""

    needs_lens_sample = True

    def __init__(self, sensor_cfg, film_cfg, device):
        super().__init__(sensor_cfg, film_cfg, device)
        self.aperture = float(sensor_cfg.get("apertureRadius", 0.1))
        self.focus = float(sensor_cfg.get("focusDistance", 1.0))

    def sample_rays(self, sample_pos, u_lens=None):
        """u_lens: [L,2] uniforms for the aperture point (the lens centre
        where None)."""
        L = sample_pos.shape[0]
        dx, dy = self._near_plane(sample_pos)
        near_p = torch.stack([dx, dy, torch.ones_like(dx)], -1) * self.near
        if u_lens is None:
            u_lens = torch.full((L, 2), 0.5, device=sample_pos.device)
        ap = warp.square_to_uniform_disk_concentric(u_lens) * self.aperture
        aperture_p = torch.cat([ap, torch.zeros_like(ap[:, :1])], -1)
        focus_p = near_p * (self.focus / near_p[:, 2:3])
        d_cam = focus_p - aperture_p
        d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
        d = _to_world(d_cam, self.axes)
        o = self.origin + _to_world(aperture_p, self.axes)
        inv_z = 1.0 / d_cam[:, 2]
        return o, d, self.near * inv_z, self.far * inv_z


class OrthographicSensor:
    """Parallel projection; the view's extent comes from the toWorld
    scale, applied through the whole affine transform."""

    needs_lens_sample = False

    def __init__(self, sensor_cfg, film_cfg, device):
        m = _frame(self, sensor_cfg, film_cfg, device)
        self.aspect = self.W / self.H
        self.near = float(sensor_cfg.get("near_clip", 1e-2))
        self.far = float(sensor_cfg.get("far_clip", 1e4))
        self.px_world = float(2.0 * np.linalg.norm(m[:3, 0]) / self.W)

    def footprint(self, t):
        """Parallel rays: one world-space pixel size."""
        return torch.full_like(t, self.px_world)

    def sample_rays(self, sample_pos, u_lens=None):
        u = sample_pos[:, 0] / self.W
        v = sample_pos[:, 1] / self.H
        x = 1.0 - 2.0 * u
        y = (1.0 - 2.0 * v) / self.aspect
        p_cam = torch.stack([x, y, torch.zeros_like(x)], -1)
        o = self.origin + _to_world(p_cam, self.axes)
        d = self.axes[:, 2].expand_as(o)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        L = o.shape[0]
        return (o, d, torch.full((L,), self.near, device=o.device),
                torch.full((L,), self.far, device=o.device))


class SphericalSensor:
    """Latitude-longitude camera: d = (sin(phi) sin(theta), cos(theta),
    -cos(phi) sin(theta)) with phi = 2 pi u, theta = pi v."""

    needs_lens_sample = False

    def __init__(self, sensor_cfg, film_cfg, device):
        _frame(self, sensor_cfg, film_cfg, device)

    def footprint(self, t):
        return t * (2.0 * np.pi / self.W)

    def sample_rays(self, sample_pos, u_lens=None):
        phi = sample_pos[:, 0] / self.W * (2 * math.pi)
        theta = sample_pos[:, 1] / self.H * math.pi
        st, ct = torch.sin(theta), torch.cos(theta)
        d_cam = torch.stack([torch.sin(phi) * st, ct, -torch.cos(phi) * st],
                            -1)
        d = _to_world(d_cam, self.axes)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = self.origin.expand_as(d)
        L = o.shape[0]
        return (o, d, torch.full((L,), 1e-4, device=o.device),
                torch.full((L,), 1e30, device=o.device))


class RadianceMeterSensor:
    """Single-direction probe: every sample shoots the toWorld +Z axis
    from the origin, whatever the film size."""

    needs_lens_sample = False

    def __init__(self, sensor_cfg, film_cfg, device):
        m = _frame(self, sensor_cfg, film_cfg, device)
        self.dir = torch.tensor(m[:3, 2] / np.linalg.norm(m[:3, 2]),
                                dtype=torch.float32, device=device)

    def footprint(self, t):
        """No pixel footprint for a single direction."""
        return torch.zeros_like(t)

    def sample_rays(self, sample_pos, u_lens=None):
        L = sample_pos.shape[0]
        dev = sample_pos.device
        return (self.origin.expand(L, 3), self.dir.expand(L, 3),
                torch.full((L,), 1e-4, device=dev),
                torch.full((L,), 1e30, device=dev))


_SENSORS = {
    "perspective": PerspectiveSensor,
    "thinlens": ThinLensSensor,
    "orthographic": OrthographicSensor,
    "spherical": SphericalSensor,
    "radiancemeter": RadianceMeterSensor,
}


def make_sensor(sensor_cfg, film_cfg, device):
    t = str(sensor_cfg.get("type", "perspective"))
    if t not in _SENSORS:
        raise NotImplementedError(f"sensor type {t!r}")
    return _SENSORS[t](sensor_cfg, film_cfg, device)

"""Camera ray generation (counterpart of ppg_tpu/render/sensor.py,
perspective camera only)."""

from __future__ import annotations

import numpy as np
import torch


class PerspectiveSensor:
    """Mitsuba's perspective camera (perspective.cpp:126-292): film sample
    (u, v) maps to a camera-space direction ((1-2u) tan, (1-2v) tan/aspect,
    1); camera axes follow Mitsuba's lookAt (x = left, y = up, z = view)."""

    def __init__(self, sensor_cfg, film_cfg, device):
        self.W = film_cfg["width"]
        self.H = film_cfg["height"]
        self.aspect = self.W / self.H
        self.xfov = float(sensor_cfg["xfov"])
        self.near = float(sensor_cfg.get("near_clip", 1e-2))
        self.far = float(sensor_cfg.get("far_clip", 1e4))
        m = np.asarray(sensor_cfg["to_world"], np.float64)
        self.origin = torch.tensor(m[:3, 3], dtype=torch.float32,
                                   device=device)
        # columns: left / up / view
        self.axes = torch.tensor(m[:3, :3], dtype=torch.float32,
                                 device=device)
        self.tan_half = np.tan(np.deg2rad(self.xfov) / 2.0)

    def sample_rays(self, sample_pos):
        """sample_pos: [L,2] continuous film coords in [0,W]x[0,H].
        Returns (o [L,3], d [L,3], t_min [L], t_max [L])."""
        u = sample_pos[:, 0] / self.W
        v = sample_pos[:, 1] / self.H
        dx = (1.0 - 2.0 * u) * self.tan_half
        dy = (1.0 - 2.0 * v) * self.tan_half / self.aspect
        d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
        d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
        # d_cam @ axes.T written out, so no matmul precision mode applies
        d = (d_cam[:, 0:1] * self.axes[:, 0] + d_cam[:, 1:2] * self.axes[:, 1]
             + d_cam[:, 2:3] * self.axes[:, 2])
        inv_z = 1.0 / d_cam[:, 2]
        o = self.origin.expand_as(d)
        return o, d, self.near * inv_z, self.far * inv_z


def make_sensor(sensor_cfg, film_cfg, device):
    t = str(sensor_cfg.get("type", "perspective"))
    if t != "perspective":
        raise NotImplementedError(
            f"sensor type {t!r}: only the perspective camera is ported "
            "(ROADMAP Queue 1, rest of shading)")
    return PerspectiveSensor(sensor_cfg, film_cfg, device)

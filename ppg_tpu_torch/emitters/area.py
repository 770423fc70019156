"""Area emitters (counterpart of ppg_tpu/emitters/area.py): radiance
evaluation on hit. The NEE sampling tables (etri, the per-emitter area
CDFs) land with NEE (ROADMAP Queue 1)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.vecmath import dot


class EmitterArrays:
    """radiance [max(E,1),3] f32, one row per area emitter."""

    def __init__(self, radiance):
        self.radiance = radiance

    @classmethod
    def from_scene(cls, sc, device):
        em = sc.emitters
        rad = np.asarray(em.radiance, np.float32).reshape(-1, 3)
        if not len(rad):  # emitterless scenes keep one dummy row
            rad = np.zeros((1, 3), np.float32)
        return cls(torch.from_numpy(rad).to(device, torch.float32))


def eval_radiance(em: EmitterArrays, emitter_id, sh_n, wo_world):
    """Le leaving the surface toward wo_world (= -ray.d): front side only,
    0 for non-emissive hits (emitter_id < 0)."""
    rad = em.radiance[emitter_id.clamp(min=0).long()]
    ok = (emitter_id >= 0) & (dot(sh_n, wo_world) > 0)
    return torch.where(ok[..., None], rad, 0.0)

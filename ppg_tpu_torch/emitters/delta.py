"""Delta emitters: point, spot and directional, and the sunsky's
directional sun (counterpart of ppg_tpu/emitters/delta.py; Mitsuba's
src/emitters/{point,spot,directional}.cpp), in plain PyTorch: a sample is
one row gather and a short elementwise tail.

Delta emitters are sampled only by NEE, in the discrete measure (no MIS
heuristic: weight 1, EMeasure::EDiscrete), and BSDF rays never hit them.

Rows are packed [D, 14]: type (int32 bitcast), position (3), direction
(3), intensity (3), then the spot's cos(cutoffAngle), cutoffAngle,
cos(beamWidth) and 1 / (cutoffAngle - beamWidth) (angles in radians).
The spot's falloff is Mitsuba's spot.cpp falloffCurve: 0 where cos(angle)
<= cos(cutoffAngle), 1 where cos(angle) >= cos(beamWidth), and between
them (cutoffAngle - acos(cos(angle))) / (cutoffAngle - beamWidth), linear
in the angle. (ppg_tpu's is linear in the cosine, (cos(angle) -
cos(cutoffAngle)) / (cos(beamWidth) - cos(cutoffAngle)): the two agree
inside the beam and beyond the cutoff and differ in the transition band;
ROADMAP Queue 3.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.vecmath import dot

TYPE_POINT = 0
TYPE_SPOT = 1
TYPE_DIRECTIONAL = 2
ROW = 14


class DeltaEmitterArrays:
    """rows [D, ROW] float32 (see the module docstring), bs_radius (a
    Python float: 1.5 x the scene's half-diagonal, at least 1e-4, in
    float32) and num = D."""

    def __init__(self, rows, bs_radius):
        self.rows = rows
        self.bs_radius = bs_radius
        self.num = int(rows.shape[0])

    @staticmethod
    def table_rows(table):
        """The packed rows [D, ROW] (numpy float32) of a table of dicts
        (type, position, direction, intensity, cutoff_deg,
        beamwidth_deg), as the scene loader lists them."""
        rows = np.zeros((len(table), ROW), np.float32)
        for i, t in enumerate(table):
            rows[i, 0] = np.int32(t["type"]).view(np.float32)
            rows[i, 1:4] = t.get("position", (0, 0, 0))
            d = np.asarray(t.get("direction", (0, 0, 1)), np.float64)
            n = np.linalg.norm(d)
            rows[i, 4:7] = d / (n if n > 0 else 1.0)
            rows[i, 7:10] = t.get("intensity", (1, 1, 1))
            cut = np.deg2rad(float(t.get("cutoff_deg", 20.0)))
            beam = np.deg2rad(float(t.get("beamwidth_deg",
                                          np.rad2deg(cut) * 3.0 / 4.0)))
            rows[i, 10] = np.cos(cut)
            rows[i, 11] = cut
            rows[i, 12] = np.cos(beam)
            rows[i, 13] = 1.0 / max(cut - beam, 1e-9)
        return rows

    @classmethod
    def from_table(cls, table, aabb_min, aabb_max, device):
        """The scene's delta emitters on `device`, or None for an empty
        table."""
        if not table:
            return None
        center = (np.asarray(aabb_min) + np.asarray(aabb_max)) * 0.5
        radius = float(np.linalg.norm(np.asarray(aabb_max) - center)) * 1.5
        return cls(torch.from_numpy(cls.table_rows(table)).to(device),
                   float(np.float32(max(radius, 1e-4))))


def spot_falloff(cos_ang, cos_cut, cut, cos_beam, inv_tr):
    """spot.cpp falloffCurve's factor for cos(angle) to the axis."""
    ramp = (cut - torch.acos(torch.clamp(cos_ang, -1.0, 1.0))) * inv_tr
    return torch.where(cos_ang <= cos_cut, 0.0,
                       torch.where(cos_ang >= cos_beam, 1.0, ramp))


def sample_direct(em: DeltaEmitterArrays, slot, ref_p):
    """NEE sample of delta emitter `slot` [L] (int32, clamped to the
    table) from ref_p [L,3]: dict(d, dist, pdf -- 1 where the value is
    positive, else 0 --, value -- the radiance-equivalent --, discrete --
    all True). The caller divides pdf by the emitter-slot count and
    multiplies value by it; the MIS weight of a discrete sample is 1."""
    row = em.rows[torch.clamp(slot, 0, em.num - 1).long()]
    etype = row[:, 0].contiguous().view(torch.int32)
    p_e, e_dir, inten = row[:, 1:4], row[:, 4:7], row[:, 7:10]

    to_l = p_e - ref_p
    dist2 = torch.clamp(dot(to_l, to_l), min=1e-30)
    dist_pt = torch.sqrt(dist2)
    d_pt = to_l / dist_pt[:, None]
    val_pt = inten / dist2[:, None]
    # the spot's falloff: the angle of -d to the emitter's axis
    fall = spot_falloff(dot(-d_pt, e_dir), row[:, 10], row[:, 11],
                        row[:, 12], row[:, 13])
    val_spot = val_pt * fall[:, None]

    is_spot = etype == TYPE_SPOT
    is_dir = (etype == TYPE_DIRECTIONAL)[:, None]
    d = torch.where(is_dir, -e_dir, d_pt)
    dist = torch.where(is_dir[:, 0], 2.0 * em.bs_radius, dist_pt)
    # a directional light's irradiance per unit area facing it
    value = torch.where(is_dir, inten,
                        torch.where(is_spot[:, None], val_spot, val_pt))
    ok = (value > 0).any(-1)
    return dict(d=d, dist=dist, pdf=ok.to(torch.float32), value=value,
                discrete=torch.ones_like(ok))

"""Vertex records -> DTreeRecords (Vertex::commit, guided_path.cpp:
1730-1768; counterpart of ppg_tpu/guiding/records.py).

localRadiance = radiance / throughput with the Epsilon guard per channel
(:1736-1738), product = localRadiance * bsdfVal, and the scalar records
are channel means (:1741).
"""

from __future__ import annotations

import torch

EPSILON = 1e-4  # Mitsuba's Epsilon in the throughput guard

# splat targets the tracer resolved at shade time (sp_id with cell or
# cell4 / w4), or what the lookup path and the spatial box filter walk
# from (p, d, voxel, dtree_id)
_PASSTHRU = ("sp_id", "cell", "cell4", "w4", "p", "d", "voxel", "dtree_id")


def _records(v, stat_weight, is_delta, finite):
    thr = v["throughput"]
    wo_pdf = v["wo_pdf"]
    rad = v["radiance"]
    valid = v["valid"] & (wo_pdf > 0) & finite
    guard = thr * wo_pdf[..., None] > EPSILON
    local = torch.where(guard, rad / torch.clamp(thr, min=1e-38), 0.0)
    rec = dict(
        radiance=local.mean(-1),
        product=(local * v["bsdf_val"]).mean(-1),
        wo_pdf=wo_pdf,
        bsdf_pdf=v["bsdf_pdf"],
        dtree_pdf=v["dtree_pdf"],
        stat_weight=torch.full_like(wo_pdf, stat_weight),
        is_delta=is_delta,
        valid=valid,
    )
    for k in _PASSTHRU:
        if k in v:
            rec[k] = v[k]
    return rec


def _flatten(vert):
    return {k: x.reshape((-1,) + tuple(x.shape[2:])) for k, x in vert.items()}


def vertex_records(vert, stat_weight):
    """vert: dict of stacked [J, L, ...] tensors from trace_paths; returns
    the flat record dict for guiding.sdtree.splat_records."""
    v = _flatten(vert)
    rad, bsdf_val = v["radiance"], v["bsdf_val"]
    finite = (torch.isfinite(rad).all(-1) & (rad >= 0).all(-1)
              & torch.isfinite(bsdf_val).all(-1) & (bsdf_val >= 0).all(-1))
    return _records(v, stat_weight, v["is_delta"], finite)


def nee_records(nee):
    """NEE pseudo-vertices (stacked [J, L, ...]), committed with
    statistical weight 0.5 and never delta (guided_path.cpp:2001-2015)."""
    v = _flatten(nee)
    rad = v["radiance"]
    finite = torch.isfinite(rad).all(-1) & (rad >= 0).all(-1)
    return _records(v, 0.5, torch.zeros_like(v["valid"]), finite)

"""Area emitters (counterpart of ppg_tpu/emitters/area.py): radiance
evaluation on hit, next-event sampling and its pdf.

Semantics as in ppg_tpu: front side only on hit; NEE picks an emitter
uniformly (sample reuse), a triangle by the emitter's area CDF and a
uniform point on it, converts to solid angle with dist^2/|cos|, and keeps
samples with dot(d, ref_n) >= 0 and dot(d, n) < 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import warp
from ..core.vecmath import dot, normalize


class EmitterArrays:
    """radiance [E,3], tri_offset / tri_count [E] i32, inv_area [E] f32
    (one dummy row when E = 0), and etri [max(TE,1), 19] f32: per emitter
    triangle p0, e1, e2, n0, n1, n2 and, in column 18, the emitter's
    normalized area CDF. `num` is the number of area emitters."""

    FIELDS = ("radiance", "tri_offset", "tri_count", "inv_area", "etri")

    def __init__(self, num, **kw):
        self.num = int(num)
        for f in self.FIELDS:
            setattr(self, f, kw[f])

    @classmethod
    def from_scene(cls, sc, device):
        em = sc.emitters
        ids = np.asarray(em.tri_ids)
        TE = len(ids)
        etri = np.zeros((max(TE, 1), 19), np.float32)
        if TE:
            v = sc.positions[sc.faces][ids]
            n = sc.normals[sc.faces][ids]
            etri[:TE, 0:3] = v[:, 0]
            etri[:TE, 3:6] = v[:, 1] - v[:, 0]
            etri[:TE, 6:9] = v[:, 2] - v[:, 0]
            etri[:TE, 9:12] = n[:, 0]
            etri[:TE, 12:15] = n[:, 1]
            etri[:TE, 15:18] = n[:, 2]
            etri[:TE, 18] = np.asarray(em.tri_cdf, np.float32)

        def pad1(a, dtype):
            """Emitterless scenes keep one dummy row so gathers stay legal."""
            a = np.asarray(a, dtype)
            if not len(a):
                a = np.zeros((1,) + a.shape[1:], dtype)
            return torch.from_numpy(a).to(device)

        return cls(
            num=em.num,
            radiance=pad1(np.asarray(em.radiance).reshape(-1, 3),
                          np.float32),
            tri_offset=pad1(em.tri_offset, np.int32),
            tri_count=pad1(em.tri_count, np.int32),
            inv_area=pad1(em.inv_area, np.float32),
            etri=torch.from_numpy(etri).to(device))


def eval_radiance(em: EmitterArrays, emitter_id, sh_n, wo_world):
    """Le leaving the surface toward wo_world (= -ray.d): front side only,
    0 for non-emissive hits (emitter_id < 0)."""
    rad = em.radiance[emitter_id.clamp(min=0).long()]
    ok = (emitter_id >= 0) & (dot(sh_n, wo_world) > 0)
    return torch.where(ok[..., None], rad, 0.0)


def sample_direct(em: EmitterArrays, ref_p, ref_n, u2, slot=None, x1=None,
                  n_slots=None):
    """NEE sample toward the area emitters (area.cpp sampleDirect).

    ref_n: shading normal at ref_p, or 0 for transmissive surfaces.
    Returns dict(d, dist, pdf -- solid angle, including the 1/E pick --,
    value = Le / pdf, p, n), with pdf and value 0 on rejected samples.

    slot, x1, n_slots: where the scene has other emitters too, the caller
    picks a slot among n_slots uniform choices (Scene::sampleEmitterDirect)
    and passes the lanes' slots (clamped to the area emitters) and the
    pick's rescaled uniform; the pdf then includes 1 / n_slots."""
    E = em.num
    if slot is None:
        # uniform emitter pick with sample reuse (DiscretePDF::sampleReuse)
        xe = u2[:, 0] * E
        eid = torch.clamp(xe.to(torch.int32), 0, E - 1)
        x1 = xe - eid
    else:
        eid = torch.clamp(slot, 0, E - 1)
    n_slots = E if n_slots is None else n_slots
    eidl = eid.long()
    off = em.tri_offset[eidl].long()
    cnt = em.tri_count[eidl].long()
    TE = em.etri.shape[0]
    cdf = em.etri[:, 18]
    # triangle pick: binary search over the emitter's CDF run
    u = u2[:, 1]
    lo_i = torch.zeros_like(off)
    hi_i = torch.clamp(cnt - 1, min=0)
    for _ in range(max(1, math.ceil(math.log2(max(TE, 2))))):
        active = lo_i < hi_i
        mid = (lo_i + hi_i) >> 1
        go_hi = u > cdf[torch.clamp(off + mid, max=TE - 1)]
        lo_i = torch.where(active & go_hi, mid + 1, lo_i)
        hi_i = torch.where(active & ~go_hi, mid, hi_i)
    idx = torch.minimum(lo_i, torch.clamp(cnt - 1, min=0))

    row = em.etri[torch.clamp(off + idx, max=TE - 1)]
    prev = cdf[torch.clamp(off + torch.clamp(idx - 1, min=0), max=TE - 1)]
    lo = torch.where(idx > 0, prev, 0.0)
    hi = row[:, 18]
    x2 = torch.clamp((u - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0)

    bary = warp.square_to_uniform_triangle(torch.stack([x1, x2], -1))
    b1, b2 = bary[:, 0:1], bary[:, 1:2]
    p = row[:, 0:3] + b1 * row[:, 3:6] + b2 * row[:, 6:9]
    n = normalize(row[:, 9:12] * (1 - b1 - b2) + row[:, 12:15] * b1
                  + row[:, 15:18] * b2)

    d = p - ref_p
    dist2 = dot(d, d)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
    d = d / dist[:, None]
    dp = dot(d, n).abs()
    pdf = torch.where(dp != 0.0, em.inv_area[eidl] * dist2 / dp,
                      0.0) / n_slots
    ok = (dot(d, ref_n) >= 0) & (dot(d, n) < 0) & (pdf > 0)
    value = torch.where(ok[:, None], em.radiance[eidl]
                        / torch.clamp(pdf, min=1e-30)[:, None], 0.0)
    return dict(d=d, dist=dist, pdf=torch.where(ok, pdf, 0.0), value=value,
                p=p, n=n)


def pdf_direct(em: EmitterArrays, emitter_id, hit_p, hit_n, ref_p,
               n_slots=None):
    """Solid-angle pdf of NEE having sampled the point a BSDF ray hit
    (pdfEmitterDirect, scene.cpp:949-961), including the 1 / n_slots pick
    (n_slots defaults to the area emitters' count); 0 where emitter_id <
    0."""
    d = hit_p - ref_p
    dist2 = dot(d, d)
    d = d / torch.sqrt(torch.clamp(dist2, min=1e-30))[:, None]
    dp = dot(d, hit_n).abs()
    inv_area = em.inv_area[emitter_id.clamp(min=0).long()]
    pdf = torch.where(dp != 0.0, inv_area * dist2 / dp, 0.0) / (
        em.num if n_slots is None else n_slots)
    return torch.where(emitter_id >= 0, pdf, 0.0)

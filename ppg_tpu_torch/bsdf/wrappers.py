"""The material wrappers at a shading site: mask (src/bsdfs/mask.cpp),
blendbsdf and mixturebsdf (one MAT_BLEND row of two children and a
weight), and coating and roughcoating over a leaf (layered.py), composed
as ppg_tpu's tracer composes them (ppg_tpu/integrators/wavefront.py
:620-766), but with each site's leaf rows evaluated in one stacked call.

Each material row resolves, once per scene (`resolve`), to at most two
leaf rows and its wrapper factors:
- slot a: the row itself for a leaf (null included); for a mask, its
  nested row's resolution; for a blend, child a; for a coating, its
  nested leaf, which sees the refracted pair (wi', wo');
- slot b: a blend's child b (slot a again elsewhere);
- the coating row, the mask's opacity and pick probability (the
  opacity's luminance clipped to [1e-6, 1 - 1e-6]) and the blend weight.

A bounce (`Site`) gathers one composition row a lane, then the resolved
leaf rows as one [L] or [2L] block (slot a first, then slot b; blend
lanes put the picked child in slot a) and, with a coating in the scene,
the coating rows behind them, in the same gather. It makes one
`sample_bsdf` over slot a and one `eval_pdf_bsdf` over the stacked
block for each direction it is asked about, and composes the mixture,
coating and mask factors with selects. A smooth sample of a blend or a
coating takes its weight from the site's eval at the sampled direction
(`finish`): the tracer evaluates that direction anyway, and every lane
that reads the sample's weight went there. So a bounce costs one
`sample_bsdf` and two `eval_pdf_bsdf` calls (at wo and at the NEE
direction), as a scene of leaves does; roughcoating's interface lobe
runs beside the stack (its glossy term once an eval, its visible
normals through a second K8 call a sample, gated to its lanes).

The resolved lane flags (smooth, delta-only, null, transmissive,
twosided) replace the wrapper rows' in MaterialArrays.flags: a mask
takes its nested resolution's and is transmissive; a blend is smooth
if either child is, delta-only if both are, transmissive if either is;
a coating takes its nested leaf's, smooth and not delta-only when
rough.

Where ppg_tpu composes a nest inconsistently, the port follows Mitsuba
(ROADMAP Queue 3): a mask over a blend or a coating keeps its
pass-through lobe and its opacity (ppg_tpu's blend_fix and coat_fix
overwrite them); a blend whose picked child's sample fails is zero
(blendbsdf.cpp); a mask lane is transmissive whatever its nested row.
`resolve` refuses the nests the reference does not compute: a blend
child that is a wrapper or has a delta lobe, a coating over anything but
a leaf, a mask over a mask or a null.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.scene import (
    MAT_BLEND,
    MAT_COATING,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_HK,
    MAT_MASK,
    MAT_NAMES,
    MAT_NULL,
    MAT_PLASTIC,
    MAT_ROUGHCOATING,
    MAT_THINDIELECTRIC,
)
from . import bsdf as B
from . import layered as LY

# kind bits of a composition row
MASK, BLEND, COAT = 1, 2, 4
# composition row: slot a, slot b, coating row, kind (int32 bits),
# opacity (3), blend weight, mask pick probability
COMP_WIDTH = 9
_COATS = (MAT_COATING, MAT_ROUGHCOATING)
# leaf families with a delta lobe: a blend's exact mixture cannot weigh
# their samples (hk's delta transmission included)
_DELTA_LOBED = (MAT_CONDUCTOR, MAT_DIELECTRIC, MAT_THINDIELECTRIC,
                MAT_PLASTIC, MAT_HK)
_NAME = {v: k for k, v in MAT_NAMES.items()}
_NAME[MAT_BLEND] = "blendbsdf/mixturebsdf"


class Resolution:
    """A table's wrapper resolution (see the module docstring): `comp`
    [M, COMP_WIDTH] float32 on the table's device, `flags` [5, M] the
    resolved lane flags, `leaf_present` the leaf families a site's slots
    reach, and which wrappers the table has."""

    def __init__(self, comp, flags, leaf_present, kinds, rough):
        self.comp, self.flags = comp, flags
        self.leaf_present = frozenset(leaf_present)
        self.has_mask = MASK in kinds
        self.has_blend = BLEND in kinds
        self.has_coat = COAT in kinds
        self.rough_present = rough


def _refuse(what, m, i):
    raise NotImplementedError(
        f"{what} (material row {m} over row {i}): ppg_tpu does not compute "
        "this nest consistently, and the port refuses it (ROADMAP Queue 3)")


def resolve(packed, flags):
    """The Resolution of the packed rows and their own flags [5, M], or
    None for a table without a mask, blend or coating; raises
    NotImplementedError for the nests the port refuses."""
    S = B.MaterialArrays.SLOTS
    pk = packed.detach().cpu().numpy()
    ints = pk.view(np.int32)
    M = pk.shape[0]
    mt = ints[:, S["mtype"][0]]
    if not np.isin(mt, (MAT_MASK, MAT_BLEND) + _COATS).any():
        return None
    # ppg_tpu gathers max(nested, 0)
    child = lambda m, f: int(min(max(ints[m, S[f][0]], 0), M - 1))
    for m in range(M):
        t = mt[m]
        if t == MAT_BLEND:
            for f in ("nested", "nested2"):
                i = child(m, f)
                if mt[i] in B.WRAPPER_TYPES or mt[i] in _DELTA_LOBED:
                    _refuse(f"a blendbsdf/mixturebsdf child that is "
                            f"{_NAME[mt[i]]} (smooth leaf children only)",
                            m, i)
        elif t in _COATS:
            i = child(m, "nested")
            if mt[i] in B.WRAPPER_TYPES:
                _refuse(f"a {_NAME[t]} over {_NAME[mt[i]]} (a coating "
                        "takes a leaf)", m, i)
        elif t == MAT_MASK:
            i = child(m, "nested")
            if mt[i] in (MAT_MASK, MAT_NULL):
                _refuse(f"a mask over {_NAME[mt[i]]}", m, i)

    own = flags.detach().cpu().numpy()
    res = own.copy()
    comp = np.zeros((M, COMP_WIDTH), np.float32)
    ci = comp.view(np.int32)
    kinds, leaves, rough = set(), set(), False
    op = S["opacity"][0]
    for m in range(M):
        kind, inner = 0, m
        if mt[m] == MAT_MASK:
            kind |= MASK
            inner = child(m, "nested")
            comp[m, 4:7] = pk[m, op:op + 3]
        a = b = c = inner
        if mt[inner] == MAT_BLEND:
            kind |= BLEND
            a, b = child(inner, "nested"), child(inner, "nested2")
            comp[m, 7] = pk[inner, S["blend_w"][0]]
            sm, do, tr = (own[0, a] | own[0, b], own[1, a] & own[1, b],
                          own[3, a] | own[3, b])
        elif mt[inner] in _COATS:
            kind |= COAT
            a = b = child(inner, "nested")
            r = mt[inner] == MAT_ROUGHCOATING
            rough |= bool(r)
            sm, do, tr = own[0, a] | r, own[1, a] & ~r, own[3, a]
        else:
            sm, do, tr = own[0, inner], own[1, inner], own[3, inner]
        if kind & MASK:
            tr = True
        if kind & COAT == 0:
            c = m
        ci[m, :4] = (a, b, c, kind)
        res[0, m], res[1, m], res[3, m] = sm, do, tr
        kinds |= {k for k in (MASK, BLEND, COAT) if kind & k}
        leaves |= {int(mt[a]), int(mt[b])}
    comp = torch.from_numpy(comp)
    # the mask's pick probability, as ppg_tpu's tracer computes it
    o = comp[:, 4:7]
    comp[:, 8] = torch.clamp(o[:, 0] * 0.212671 + o[:, 1] * 0.715160
                             + o[:, 2] * 0.072169, 1e-6, 1.0 - 1e-6)
    comp[:, 8] = torch.where(comp.view(torch.int32)[:, 3] & MASK != 0,
                             comp[:, 8], 0.0)
    return Resolution(comp.to(packed.device),
                      torch.from_numpy(res).to(flags.device), leaves, kinds,
                      rough)


class Site:
    """One bounce's shading site over L lanes of material ids `mid`, seen
    from wi (local frame); u_mask [L], u_blend [L] and u_coat [L, 1] are
    the mask, blend and coating picks' uniforms (tags 7, 10 and 11), each
    given when the table has that wrapper. `flags` are the lanes'
    resolved flags (B.lane_flags reads them)."""

    def __init__(self, mats, mid, wi, u_mask=None, u_blend=None,
                 u_coat=None):
        res = mats.wrappers
        self.res, self.wi, self.L = res, wi, mid.shape[0]
        i = mid.long()
        self.flags = mats.flags[:, i]
        comp = res.comp[i]
        ci = comp.view(torch.int32)
        kind = ci[:, 3]
        a, b = ci[:, 0], ci[:, 1]
        ids = [a]
        self.is_mask = self.is_blend = self.is_coat = None
        if res.has_mask:
            self.is_mask = kind & MASK != 0
            self.opacity, self.prob = comp[:, 4:7], comp[:, 8]
            self.go_nested = self.is_mask & (u_mask < self.prob)
            self.pass_thru = self.is_mask & (u_mask >= self.prob)
        if res.has_blend:
            self.is_blend = kind & BLEND != 0
            self.w = comp[:, 7]
            self.pick_b = self.is_blend & (u_blend < self.w)
            ids = [torch.where(self.pick_b, b, a),
                   torch.where(self.pick_b, a, b)]
        n = self.L * len(ids)
        if res.has_coat:
            self.is_coat = kind & COAT != 0
            self.u_coat = u_coat
            ids.append(ci[:, 2])
        ids = torch.cat(ids).long() if len(ids) > 1 else ids[0].long()
        rows, fl = mats.packed[ids], mats.flags[:, ids]
        # the stacked leaf rows (the eval's) and slot a (the sample's)
        self.leaf = B.Params(rows[:n], fl[:, :n])
        self.leaf_a = (self.leaf if n == self.L
                       else B.Params(rows[:self.L], fl[:, :self.L]))
        self.wi_a = wi
        if res.has_coat:
            self.coat = B.Params(rows[n:], fl[:, n:])
            self.st = LY.prepare(self.coat, wi, res.rough_present)
            self.wi_a = torch.where(self.is_coat[:, None], self.st["wi_p"],
                                    wi)
        self.pending = None

    def sample(self, u):
        """(wo, weight, pdf, delta, eta) of the lanes' BSDF sample from
        the uniforms u [L, 3]; the smooth blend and coating lanes' weight
        and pdf wait for `finish`."""
        wo, w, pdf, delta, eta = B.sample_bsdf(self.leaf_a, self.wi_a, u,
                                               self.res.leaf_present)
        from_eval = ok = None
        if self.is_coat is not None:
            u4 = torch.cat([u, self.u_coat], -1)
            parts = LY.sample_parts(self.coat, self.st, u4,
                                    (wo, w, pdf, delta, eta))
            c = self.is_coat
            wo, w = (torch.where(c[:, None], x, y)
                     for x, y in zip(parts[:2], (wo, w)))
            pdf, delta, eta = (torch.where(c, x, y)
                               for x, y in zip(parts[2:5], (pdf, delta, eta)))
            from_eval, ok = c & parts[5], parts[6]
        if self.is_blend is not None:
            # the picked child's own sample must hold (blendbsdf.cpp)
            ok_b = (pdf > 0) & (w > 0).any(-1)
            bl = self.is_blend
            from_eval = bl if from_eval is None else from_eval | bl
            ok = ok_b if ok is None else torch.where(bl, ok_b, ok)
        if self.is_mask is not None:
            g, q, o = self.go_nested, self.prob, self.opacity
            w = torch.where(g[:, None],
                            w * o / torch.clamp(q, min=1e-9)[:, None], w)
            pdf = torch.where(g, pdf * q, pdf)
            pt = self.pass_thru
            wo = torch.where(pt[:, None], -self.wi, wo)
            w = torch.where(pt[:, None], (1.0 - o) / torch.clamp(
                1.0 - q, min=1e-9)[:, None], w)
            pdf = torch.where(pt, 1.0 - q, pdf)
            delta = delta | pt
            eta = torch.where(pt, 1.0, eta)
            if from_eval is not None:
                from_eval = from_eval & ~pt
        if from_eval is not None:
            self.pending = (from_eval, ok)
        return wo, w, pdf, delta, eta

    def eval_pdf(self, wo):
        """The site's (f * cos [L, 3], pdf [L]) at wo (local frame): one
        eval_pdf_bsdf over the stacked leaf rows, then the blend's
        mixture, the coating and the mask's factors."""
        wo_a = wo
        if self.is_coat is not None:
            wo_f, wo_p, R21 = LY.refract_wo(self.st, wo)
            wo_a = torch.where(self.is_coat[:, None], wo_p, wo)
        present = self.res.leaf_present
        if self.is_blend is not None:
            L = self.L
            f2, p2 = B.eval_pdf_bsdf(self.leaf, torch.cat([self.wi_a,
                                                           self.wi]),
                                     torch.cat([wo_a, wo]), present)
            f, pdf = f2[:L], p2[:L]
            pk = self.pick_b
            fa = torch.where(pk[:, None], f2[L:], f)
            fb = torch.where(pk[:, None], f, f2[L:])
            pa, pb = torch.where(pk, p2[L:], pdf), torch.where(pk, pdf, p2[L:])
            w, bl = self.w, self.is_blend
            f = torch.where(bl[:, None], (1 - w)[:, None] * fa
                            + w[:, None] * fb, f)
            pdf = torch.where(bl, (1 - w) * pa + w * pb, pdf)
        else:
            f, pdf = B.eval_pdf_bsdf(self.leaf, self.wi_a, wo_a, present)
        if self.is_coat is not None:
            fc, pc = LY.compose_eval(self.coat, self.st, wo_f, wo_p, R21,
                                     f, pdf)
            f = torch.where(self.is_coat[:, None], fc, f)
            pdf = torch.where(self.is_coat, pc, pdf)
        if self.is_mask is not None:
            f = torch.where(self.is_mask[:, None], f * self.opacity, f)
            pdf = torch.where(self.is_mask, pdf * self.prob, pdf)
        return f, pdf

    def finish(self, w, pdf, f, pdf_e):
        """The sample's (weight, pdf), with the smooth blend and coating
        lanes' taken from the site's eval (f, pdf_e) at the sampled
        direction."""
        if self.pending is None:
            return w, pdf
        from_eval, ok = self.pending
        w_e, p_e = LY.finish(w, pdf, from_eval, ok, f, pdf_e)
        return (torch.where(from_eval[:, None], w_e, w),
                torch.where(from_eval, p_e, pdf))

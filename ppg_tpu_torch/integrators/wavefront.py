"""Wavefront path tracer core (counterpart of
ppg_tpu/integrators/wavefront.py): the reference's Li()
(guided_path.cpp:1712-2157) as a loop over bounces with masked per-lane
state, every stage running over the whole wavefront.

The port covers every leaf BSDF family (bsdf/bsdf.py: delta lobes
bypass guiding and carry their eta into Russian roulette), the material
wrappers (mask, null, blend/mixture, coating, roughcoating; a scene with
a mask, blend or coating shades each bounce through one
bsdf/wrappers.py Site), textures (scene/textures.py: textured
reflectance and opacity, one K9 launch a bounce for every textured row
of the site; bump and normal maps, one more; vertex colours and the
wireframe texture), area, environment (emitters/envmap.py: one K10
launch a bounce for the NEE sample, one for the escaped lanes' radiance
and pdf, one for the camera's misses) and delta emitters
(emitters/delta.py: point, spot, directional), participating media
(media.py: homogeneous media, grid media through K11's Woodcock
tracking, one launch a bounce, and the five phase kinds; medium lanes
scatter by the phase function, skip guiding and record no vertex),
subsurface scattering (subsurface.py: the dipole's exitance at each hit
on a dipole shape, one K12 launch a bounce; singlescatter.py: single
scattering inside a dielectric boundary, whose entry reflection or first
exit overrides the path's next segment), next-event estimation over all
of them with shadow rays through the
triangle sweep or the BVH walk and MIS against emitter hits (nee never /
kickstart / always; through masks, null surfaces and media by
`shadow_transmittance`), the one-sample
mixture of BSDF and SD-tree sampling with a fixed or learned BSDF
fraction, Russian roulette and the stacked training vertices.
`make_config` raises NotImplementedError for the regenerative tracer.

A pass-through transition (a null surface, or a mask's pass-through
lobe taken as the lane's direction) carries the last real vertex's MIS
state (its wo pdf, whether it was delta, its position), as ppg_tpu does
(guided_path.cpp:2045-2075): the emitter hit beyond it is weighed
against the NEE sample of that vertex, is never roulette-terminated and
adds nothing to its own record. Unlike ppg_tpu, a guided mask lane that
drew the pass-through lobe but took the tree's direction scatters
(ROADMAP Queue 3).

Radiance bookkeeping as in ppg_tpu: bounce j adds a contribution slot c_j;
the pixel gets sum_j c_j and vertex j trains on own_j + sum_{k>j} c_k.
Randomness comes from one torch.Generator per render, drawn in a fixed
(bounce, tag) order; with a QMC sampler and the lanes' pixel ids, each
decision draws its own dimensions of the pixel's sample instead
(render/samplers.py, DIM_BLOCK), as in ppg_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..accel.brute import INF
from ..accel.traverse import any_hit, build_geometry, closest_hit
from ..bsdf import bsdf as B
from ..bsdf import wrappers as W
from ..core.vecmath import build_frame, dot, normalize, to_local, to_world
from ..core.warp import dir_to_canonical
from ..device import rand
from ..emitters import area as E
from ..emitters import delta as DE
from ..emitters import envmap as EV
from .. import media as M
from ..singlescatter import SSSArrays, n_uniforms, single_scatter
from ..subsurface import SubsurfArrays, lo_sub
from ..render import samplers as S
from ..scene import textures as TX

SHADOW_EPS = 1e-3  # relative end offset of shadow rays (ShadowEpsilon)
MAX_BOUNCES_CAP = 32  # MAX_NUM_VERTICES analog (guided_path.cpp:1771)
MAX_CROSS = 64  # the shadow walk's crossings (ppg_tpu's bound)
# the shadow walk's calls, crossings and host reads (one any() a
# crossing, and the last that finds no lane alive); reset_counts zeroes
WALK_COUNTS = {"walks": 0, "crossings": 0, "host_reads": 0}


def reset_counts():
    for k in WALK_COUNTS:
        WALK_COUNTS[k] = 0

# per-bounce QMC dimension block: 2 camera dims, then 36 dims per bounce
# (bsdf 0-2, guiding-tree 3-24, nee 25-26, rr 27, mask 28,
#  medium-distance 29-30, phase 31-32); tag -> first dim of its block
DIM_BLOCK = 36
_TAG_DIM = {0: 0, 1: 3, 2: 25, 3: 27, 7: 28, 8: 29, 9: 31, 10: 33, 11: 34}


@dataclass(frozen=True)
class PTConfig:
    """ppg_tpu's PTConfig, field for field; only the defaults of the
    feature flags run here (see make_config)."""
    max_depth: int = 10  # -1 = unlimited (capped at MAX_BOUNCES_CAP+1)
    rr_depth: int = 5
    strict_normals: bool = False
    hide_emitters: bool = False
    do_nee: bool = False
    nee_always: bool = False
    bsdf_fraction: float = 0.5
    guiding: bool = False  # mixture-sample from the SD-tree
    is_built: bool = False  # sampling tree valid (m_isBuilt)
    record_vertices: bool = False  # produce training records
    learn_fraction: bool = False
    has_env: bool = False
    has_tex: bool = False
    has_tex_ewa: bool = False
    has_tex_opacity: bool = True
    has_mask: bool = False
    has_null: bool = False
    has_media: bool = False
    has_hetero: bool = False
    has_bump: bool = False
    has_blend: bool = False
    has_coating: bool = False
    has_vertexcolors: bool = False
    has_wireframe: bool = False
    has_subsurf: bool = False
    has_sss: bool = False
    sampler: str = "independent"
    # shade-time splat targets: with record_vertices the tracer resolves
    # each vertex's spatial leaf (jittered for "stochastic") and
    # directional cell or box cells (splat_records' fast path); "" leaves
    # the walks to the splat
    splat_spatial: str = ""  # "" | "nearest" | "stochastic"
    splat_dir: str = ""  # "" | "nearest" | "box"
    force_machine: bool = False
    force_classic: bool = False

    @property
    def n_bounces(self):
        if self.max_depth < 0:
            return MAX_BOUNCES_CAP
        return min(self.max_depth - 1, MAX_BOUNCES_CAP)


# PTConfig flags outside the slice -> the ROADMAP item that ports them
_UNPORTED = {"force_machine": "regen", "force_classic": "regen"}


def check_supported(cfg: PTConfig):
    for f, item in _UNPORTED.items():
        if getattr(cfg, f):
            raise NotImplementedError(
                f"PTConfig.{f}: not ported yet (ROADMAP Queue 1: {item})")
    for f, ok in (("splat_spatial", ("", "nearest", "stochastic")),
                  ("splat_dir", ("", "nearest", "box"))):
        if getattr(cfg, f) not in ok:
            raise ValueError(f"PTConfig.{f}={getattr(cfg, f)!r}: want one "
                             f"of {ok}")


class DeviceScene:
    """Per-scene tensors consumed by the tracer.

    Per-triangle shading data is packed into one [T,30] f32 row in BVH
    leaf order, laid out as in ppg_tpu: n0(3) n1(3) n2(3) geo_n(3)
    bitcast(mat) bitcast(emitter) radiance(3) uv0(2) uv1(2) uv2(2)
    bitcast(medium) dpdu(3) dpdv(3); a scene with vertex colours widens it
    to [T,39] with the three corner colours. `tex` is the scene's
    TextureAtlas, None without textures; `env` its EnvmapArrays and
    `delta` its DeltaEmitterArrays, None without them; `media` its
    media.MediaArrays (the empty table without media); `subsurf` its
    subsurface.SubsurfArrays and `sss` its singlescatter.SSSArrays, the
    empty tables until driver.ensure_subsurface builds them.
    """

    FIELDS = ("geom", "mats", "emitters", "shade", "eps", "tex", "env",
              "delta", "media", "subsurf", "sss")

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f, kw[f])

    @classmethod
    def from_scene(cls, sc, device):
        geom = build_geometry(sc.positions, sc.faces, device)
        shade = shade_rows(sc, geom.perm.cpu().numpy())
        diag = float(np.linalg.norm(sc.aabb_max - sc.aabb_min))
        env = None
        if sc.env_emitter is not None:
            env = EV.build_env_from_spec(
                sc.env_emitter,
                sc.textures.scene_xml.dir if sc.textures else ".",
                sc.aabb_min, sc.aabb_max, device)
        return cls(
            geom=geom,
            mats=B.MaterialArrays.from_table(sc.materials, device),
            emitters=E.EmitterArrays.from_scene(sc, device),
            shade=torch.from_numpy(shade).to(device, torch.float32),
            eps=float(np.float32(max(diag, 1.0) * 1e-5)),
            tex=TX.TextureAtlas.from_scene(sc, device),
            env=env,
            delta=DE.DeltaEmitterArrays.from_table(
                getattr(sc, "delta_emitters", None), sc.aabb_min,
                sc.aabb_max, device),
            media=(M.MediaArrays.from_table(sc.media, device)
                   if getattr(sc, "media", None) else
                   M.MediaArrays.empty(device)),
            subsurf=SubsurfArrays.empty(device),
            sss=SSSArrays.empty(device),
        )


def shade_rows(sc, perm):
    """The [max(T,1), 30] shade table of ppg_tpu's DeviceScene.from_scene
    ([max(T,1), 39] with the corner colours when the scene has vertex
    colours), built the same way (numpy, float32)."""
    n = sc.normals[sc.faces][perm]
    v = sc.positions[sc.faces][perm]
    gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    T = len(perm)
    colors = getattr(sc, "colors", None)
    shade = np.zeros((max(T, 1), 30 if colors is None else 39), np.float32)
    shade[:, 23] = np.float32(np.int32(-1).view(np.float32))  # medium id
    if not T:
        return shade
    # flat-shaded shapes carry zero vertex normals: use the geometric one
    flat = (n * n).sum(-1) < 1e-12
    n = np.where(flat[..., None], gn[:, None, :], n)
    shade[:T, 0:3] = n[:, 0]
    shade[:T, 3:6] = n[:, 1]
    shade[:T, 6:9] = n[:, 2]
    shade[:T, 9:12] = gn
    shade[:T, 12] = sc.tri_mat[perm].astype(np.int32).view(np.float32)
    eid = sc.tri_emitter[perm].astype(np.int32)
    shade[:T, 13] = eid.view(np.float32)
    if sc.emitters.num:
        shade[:T, 14:17] = np.where((eid >= 0)[:, None],
                                    sc.emitters.radiance[np.maximum(eid, 0)],
                                    0.0)
    if sc.texcoords is not None and len(sc.texcoords):
        uvf = sc.texcoords[sc.faces][perm]  # [T, 3, 2]
        shade[:T, 17:23] = uvf.reshape(T, 6)
        # uv tangents (Mitsuba's its.dpdu / dpdv)
        uvf = uvf.astype(np.float64)
        e1 = (v[:, 1] - v[:, 0]).astype(np.float64)
        e2 = (v[:, 2] - v[:, 0]).astype(np.float64)
        du1 = uvf[:, 1, 0] - uvf[:, 0, 0]
        dv1 = uvf[:, 1, 1] - uvf[:, 0, 1]
        du2 = uvf[:, 2, 0] - uvf[:, 0, 0]
        dv2 = uvf[:, 2, 1] - uvf[:, 0, 1]
        det = du1 * dv2 - du2 * dv1
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        dpdu = (e1 * dv2[:, None] - e2 * dv1[:, None]) * inv[:, None]
        dpdv = (e2 * du1[:, None] - e1 * du2[:, None]) * inv[:, None]
        fallback = np.where(np.abs(gn[:, 2:3]) < 0.9,
                            np.cross(gn, np.array([0.0, 0, 1.0])),
                            np.cross(gn, np.array([1.0, 0, 0.0])))
        shade[:T, 24:27] = np.where(ok[:, None], dpdu, fallback)
        shade[:T, 27:30] = np.where(ok[:, None], dpdv,
                                    np.cross(gn, fallback))
    tri_med = getattr(sc, "tri_medium", None)
    if tri_med is not None and len(tri_med):
        shade[:T, 23] = tri_med[perm].astype(np.int32).view(np.float32)
    if colors is not None:
        shade[:T, 30:39] = colors[sc.faces][perm].reshape(T, 9)
    return shade


def fetch_row(scene: DeviceScene, tri):
    return scene.shade[tri.long()]


def decode_row(row, bu, bv, with_uv=False):
    """Shade row -> (interpolated shading normal, geometric normal,
    material id, emitter id, emitted radiance), and with `with_uv` also the
    interpolated uv and the uv tangents dpdu and dpdv, as ppg_tpu's
    decode_row returns them. The ids are bitcast from the float columns,
    never value-cast."""
    w0 = (1.0 - bu - bv)[..., None]
    sh_n = normalize(row[:, 0:3] * w0 + row[:, 3:6] * bu[..., None]
                     + row[:, 6:9] * bv[..., None])
    geo_n = row[:, 9:12]
    mid = row[:, 12].contiguous().view(torch.int32)
    eid = row[:, 13].contiguous().view(torch.int32)
    if not with_uv:
        return sh_n, geo_n, mid, eid, row[:, 14:17]
    return (sh_n, geo_n, mid, eid, row[:, 14:17], interp_uv(row, bu, bv),
            row[:, 24:27], row[:, 27:30])


def interp_uv(row, bu, bv):
    """The hit's interpolated uv [L, 2] from its shade row."""
    return (row[:, 17:19] * (1.0 - bu - bv)[..., None]
            + row[:, 19:21] * bu[..., None] + row[:, 21:23] * bv[..., None])


def mi_weight(pdf_a, pdf_b):
    """Power heuristic (guided_path.cpp:2247-2250)."""
    a2, b2 = pdf_a * pdf_a, pdf_b * pdf_b
    return torch.where(a2 > 0, a2 / torch.clamp(a2 + b2, min=1e-38), 0.0)


def n_emitter_slots(scene: DeviceScene):
    """(area, environment, delta) emitter slots of NEE's uniform pick."""
    return (scene.emitters.num, int(scene.env is not None),
            0 if scene.delta is None else scene.delta.num)


def _sample_emitters(scene: DeviceScene, p, ref_n, u_nee, act=None,
                     smooth=None):
    """NEE sample over the scene's emitter set (Scene::sampleEmitterDirect
    with uniform emitter weights): a uniform slot over the area emitters,
    the environment and the delta emitters (ppg_tpu's _sample_emitters),
    the pick's remainder reused. Returns dict(d, dist, pdf -- including
    the 1 / n_slots pick --, value, discrete), or without an environment
    and delta emitters the area sample as before (no discrete flag). The
    environment's sample (one K10 launch on a card) is computed only on
    the lanes of its slot that are active and smooth (the masks act and
    smooth, where given), the only ones NEE uses; its other lanes are
    zeros."""
    n_area, n_env, n_delta = n_emitter_slots(scene)
    if n_env + n_delta == 0:
        return E.sample_direct(scene.emitters, p, ref_n, u_nee)
    n_slots = n_area + n_env + n_delta
    xe = u_nee[:, 0] * n_slots
    slot = torch.clamp(xe.to(torch.int32), 0, n_slots - 1)
    xr = xe - slot
    L = p.shape[0]
    no = torch.zeros(L, dtype=torch.bool, device=p.device)
    parts = []
    if n_area:
        ds = E.sample_direct(scene.emitters, p, ref_n, u_nee, slot=slot,
                             x1=xr, n_slots=n_slots)
        parts.append((slot < n_area, dict(ds, discrete=no)))
    if n_env:
        ds = EV.sample_direct(scene.env, p, xr, u_nee[:, 1],
                              EV.Gate(slot, n_area, act, smooth), n_slots)
        parts.append((slot == n_area, dict(ds, discrete=no)))
    if n_delta:
        ds = DE.sample_direct(scene.delta, slot - (n_area + n_env), p)
        ds["pdf"] = ds["pdf"] / n_slots
        ds["value"] = ds["value"] * n_slots
        parts.append((slot >= n_area + n_env, ds))
    ds = parts[-1][1]
    for mask, part in reversed(parts[:-1]):
        ds = {k: torch.where(mask.reshape(mask.shape + (1,) * (
            part[k].dim() - 1)), part[k], ds[k]) for k in ds}
    return ds


def shadow_transmittance(scene: DeviceScene, o, d, dist, active,
                         max_inter=None, med=None, gen=None):
    """Transmittance [L,3] of the shadow segments [o, o + dist * d]
    through null and mask surfaces and media (ppg_tpu's
    shadow_transmittance; Scene::evalTransmittance, scene.cpp:619-679):
    each crossing takes the closest hit over the rest of the segment (K1
    or K2 on a card); a null surface multiplies 1, a mask 1 - opacity, any
    other surface blocks (T = 0), and so does a crossing at the cap
    `max_inter` (maxDepth - depth - 1; None or negative: no cap). With
    `med` ([L] int32, the lanes' media at o) each sub-segment multiplies
    its medium's transmittance: a homogeneous medium's closed form, a
    grid medium's ratio-tracking estimate (one K11 launch a crossing, its
    seed drawn from `gen`); a pass-through crossing switches the lane to
    the crossed shape's interior going in, to vacuum going out. Lanes with
    active False return T = 1. The loop ends when no lane is alive, one
    host read a crossing, or after MAX_CROSS crossings. A mask with
    textured opacity reads the atlas at the crossing's uv, base level (one
    K9 launch a crossing, only when some row textures its opacity)."""
    L = o.shape[0]
    dev = o.device
    t_cur = torch.zeros(L, dtype=torch.float32, device=dev)
    T = torch.ones((L, 3), dtype=torch.float32, device=dev)
    alive = active
    has_mask = B.MAT_MASK in scene.mats.present
    tex_op = has_mask and "opacity" in scene.mats.textured
    media = scene.media
    WALK_COUNTS["walks"] += 1
    for it in range(MAX_CROSS):
        WALK_COUNTS["host_reads"] += 1
        if not bool(alive.any()):
            break
        WALK_COUNTS["crossings"] += 1
        o_cur = o + t_cur[:, None] * d
        remain = dist - t_cur
        tri, t_hit, bu, bv = closest_hit(
            scene.geom, o_cur, d, torch.zeros_like(t_cur),
            torch.where(alive, remain, -1.0))
        hit = (tri >= 0) & alive
        if med is not None:
            # the sub-segment to the hit, or to the end; 0 on ended lanes
            seg = torch.where(alive, torch.where(hit, t_hit, remain), 0.0)
            s_t = torch.where((med >= 0)[:, None],
                              M.fetch_row(media, med)[:, 0:3], 0.0)
            T = T * M.transmittance(s_t, seg)
            if media.any_hetero:
                # 1 on the lanes outside a grid medium and where seg is 0
                T = T * M.ratio_transmittance(media, med, o_cur, d, seg,
                                              M.draw_seed(gen))[:, None]
        row = fetch_row(scene, tri.clamp(min=0))
        mid = row[:, 12].contiguous().view(torch.int32)
        mrow = scene.mats.walk[mid.long()]
        mt = mrow[:, 0].contiguous().view(torch.int32)
        is_mask = mt == B.MAT_MASK
        if max_inter is not None and 0 <= max_inter <= it:
            passthru = torch.zeros_like(hit)
        else:
            passthru = (mt == B.MAT_NULL) | is_mask
        if has_mask:
            op = mrow[:, 1:4]
            if tex_op:
                tid = mrow.view(torch.int32)[:, 4]
                op = torch.where((tid >= 0)[:, None], TX.sample_atlas(
                    scene.tex, tid + 1, interp_uv(row, bu, bv)), op)
            T = torch.where((hit & is_mask)[:, None], T * (1.0 - op), T)
        T = torch.where((hit & ~passthru)[:, None], 0.0, T)
        if med is not None:
            surf_med = row[:, 23].contiguous().view(torch.int32)
            going_in = dot(row[:, 9:12], d) < 0
            med = torch.where(hit & passthru,
                              torch.where(going_in, surf_med, -1), med)
        alive = hit & passthru & (T > 0).any(-1)
        t_cur = torch.where(alive, t_cur + t_hit + scene.eps, dist)
    return T


class TextureLookups:
    """One bounce's texture lookups at the lanes' hits, as ppg_tpu's
    tex_override computes them (ppg_tpu/integrators/wavefront.py:557-610):
    the atlas at the hit's uv with the camera's differentials on the first
    bounce (the uv Jacobian where the scene has EWA bitmaps and the sensor
    has dir_differentials, else the footprint where it has one; neither
    without a sensor) and zero differentials after it; a vertexcolors or
    curvature slot takes the interpolated vertex colour, a wireframe slot
    its wireframe colour. `__call__(slots)` takes the stacked atlas slots
    [k * L] of k fields or rows (a spec index plus one; <= 0: none) and
    returns [k * L, 3] in one sample_atlas call (one K9 launch on a
    card)."""

    def __init__(self, scene, cfg, sensor, j, row, bu, bv, tri, d, t, geo_n,
                 uv, dpdu, dpdv, zero2):
        self.scene, self.cfg, self.uv = scene, cfg, uv
        self.row, self.bu, self.bv, self.tri = row, bu, bv, tri
        self.foot = self.duv = None
        if cfg.has_tex_ewa and hasattr(sensor, "dir_differentials"):
            self.duv = (TX.uv_differentials(sensor, d, t, geo_n, dpdu, dpdv)
                        if j == 1 else (zero2, zero2))
        elif hasattr(sensor, "footprint"):
            if j == 1:
                w = sensor.footprint(t)
                self.foot = torch.stack(
                    [w / torch.clamp(torch.sqrt(dot(dpdu, dpdu)), min=1e-12),
                     w / torch.clamp(torch.sqrt(dot(dpdv, dpdv)), min=1e-12)],
                    -1)
            else:
                self.foot = zero2

    def __call__(self, slot):
        scene, cfg = self.scene, self.cfg
        k = slot.shape[0] // self.uv.shape[0]
        val = TX.sample_atlas(scene.tex, slot, self.uv, self.foot, self.duv)
        if cfg.has_vertexcolors or cfg.has_wireframe:
            slot_c = torch.clamp(slot, 0, scene.tex.n_slots - 1).long()
            rep = lambda x: x if k == 1 else x.repeat(
                (k,) + (1,) * (x.dim() - 1))
        if cfg.has_vertexcolors:
            r, bu, bv = self.row, self.bu[:, None], self.bv[:, None]
            vcol = (r[:, 30:33] * (1.0 - self.bu - self.bv)[:, None]
                    + r[:, 33:36] * bu + r[:, 36:39] * bv)
            val = torch.where(scene.tex.vcflag[slot_c][:, None], rep(vcol),
                              val)
        if cfg.has_wireframe:
            wcol = TX.wireframe_color(scene.tex, slot,
                                      rep(scene.geom.tri[self.tri.long()]),
                                      rep(self.bu), rep(self.bv))
            val = torch.where((scene.tex.wfp[slot_c, 0] >= 0)[:, None], wcol,
                              val)
        return val


def override_reflectance(params, tex):
    """params' reflectance with its textured rows' lookups (tex, a
    TextureLookups, one call)."""
    tid = params.row.view(torch.int32)[:, B.MaterialArrays.SLOTS[
        "tex_reflectance"][0]]
    params["reflectance"] = torch.where((tid >= 0)[:, None], tex(tid + 1),
                                        params["reflectance"])


def trace_paths(scene: DeviceScene, cfg: PTConfig, gen, o, d, t_min, t_max,
                sdtree=None, pixel_ids=None, sample_idx=0, sensor=None):
    """Trace a wavefront of L camera rays to completion. pixel_ids [L] and
    sample_idx feed a QMC sampler (cfg.sampler other than "independent");
    without pixel_ids every draw comes from `gen`. `sensor` gives the
    camera's differentials to textured scenes (see TextureLookups).

    Returns dict(li [L,3] pixel radiance estimates; vertices: None, or
    with cfg.record_vertices dict(bsdf=stacked [J, L, ...] training
    vertices, nee=stacked NEE records or None); n_rays -- camera, bounce
    and shadow rays -- and n_vertices as 0-d int64 tensors)."""
    check_supported(cfg)
    res = scene.mats.wrappers
    present = scene.mats.present
    textured = scene.mats.textured
    for f, there in (("has_mask", res is not None and res.has_mask),
                     ("has_blend", res is not None and res.has_blend),
                     ("has_coating", res is not None and res.has_coat),
                     ("has_null", B.MAT_NULL in present),
                     ("has_tex", bool(textured - {"bump"})),
                     ("has_bump", "bump" in textured)):
        if there and not getattr(cfg, f):
            raise ValueError(f"the scene's materials need PTConfig.{f}")
    if (cfg.has_tex or cfg.has_bump) and scene.tex is None:
        raise ValueError("PTConfig.has_tex or has_bump on a scene without "
                         "textures")
    if cfg.has_env != (scene.env is not None):
        raise ValueError(f"PTConfig.has_env={cfg.has_env} on a scene "
                         f"{'with' if scene.env is not None else 'without'} "
                         f"an environment emitter")
    media = scene.media
    if (cfg.has_media, cfg.has_hetero) != (media.num > 0, media.any_hetero):
        raise ValueError(f"PTConfig.has_media={cfg.has_media} and "
                         f"has_hetero={cfg.has_hetero} on a scene with "
                         f"{media.num} media, grid media "
                         f"{media.any_hetero}")
    for f, table in (("has_subsurf", scene.subsurf), ("has_sss", scene.sss)):
        if getattr(cfg, f) and not table.num:
            raise ValueError(f"PTConfig.{f} on a scene whose {f[4:]} table "
                             f"is empty: build it with "
                             f"driver.ensure_subsurface")
    n_pdf_slots = sum(n_emitter_slots(scene))
    # the fields a site's lookup serves (reflectance of its leaf rows, a
    # mask's opacity), and whether a bounce needs the hit's uv
    tex_fields = (textured & {"reflectance", "opacity"} if cfg.has_tex
                  else frozenset())
    if not cfg.has_tex_opacity:
        tex_fields = tex_fields - {"opacity"}
    need_uv = bool(tex_fields) or cfg.has_bump
    # the hit's triangle: uv lookups and the subsurface ids
    keep_tri = need_uv or cfg.has_subsurf or cfg.has_sss
    # pass-through surfaces: the ENull carry and the shadow walk; media
    # walk shadow rays too
    enull = cfg.has_mask or cfg.has_null
    med_on = cfg.has_media
    walk = enull or med_on
    L = o.shape[0]
    dev = o.device
    J = cfg.n_bounces
    zeros3 = lambda: torch.zeros((L, 3), dtype=torch.float32, device=dev)

    # camera segment and the depth-0 emitter hit (guided_path.cpp:1902-1919)
    tri, t, bu, bv = closest_hit(scene.geom, o, d, t_min, t_max)
    hit = tri >= 0
    row = fetch_row(scene, tri.clamp(min=0))
    c0 = zeros3()
    if not cfg.hide_emitters:
        sh_n0, _, _, eid0, _ = decode_row(row, bu, bv)
        c0 = torch.where(hit[:, None],
                         E.eval_radiance(scene.emitters, eid0, sh_n0, -d),
                         0.0)
        if cfg.has_env:
            # the environment seen by the camera's misses (tri -1)
            c0 = c0 + EV.lookup(scene.env, d, EV.Gate(tri, -1))[0]
    n_rays = torch.tensor(L, dtype=torch.int64, device=dev)
    if J == 0:
        return dict(li=c0, vertices=None, n_rays=n_rays,
                    n_vertices=torch.zeros((), dtype=torch.int64,
                                           device=dev))

    guide = cfg.guiding and sdtree is not None
    if guide:
        from ..guiding import sdtree as G
    use_qmc = cfg.sampler != "independent" and pixel_ids is not None

    def draw(j, tag, *shape):
        """The uniforms of decision `tag` at bounce j."""
        if not use_qmc:
            return rand(gen, *shape)
        dim = 2 + (j - 1) * DIM_BLOCK + _TAG_DIM[tag]
        return S.draw(cfg.sampler, pixel_ids, sample_idx, dim, gen, shape)

    precompute = guide and cfg.record_vertices and cfg.splat_spatial != ""

    def targets(vert, p_rec, d_rec, dtree_id, voxel, valid):
        """The record's splat targets at shade time, or what the splat
        needs to walk them itself."""
        if precompute:
            uj = (rand(gen, L, 3) if cfg.splat_spatial == "stochastic"
                  else None)
            vert.update(G.splat_targets(
                sdtree, dtree_id, d_rec, valid, cfg.splat_spatial,
                cfg.splat_dir, p_rec=p_rec, voxel=voxel, u_jitter=uj))
        else:
            vert.update(p=p_rec, d=d_rec, voxel=voxel, dtree_id=dtree_id)
        return vert

    act = hit
    thr = torch.ones((L, 3), dtype=torch.float32, device=dev)
    eta = torch.ones(L, dtype=torch.float32, device=dev)
    if enull:
        # the last real vertex's MIS state; the camera segment counts as
        # delta (an emitter seen through null surfaces scores weight 1)
        wo_pdf_real = torch.zeros(L, dtype=torch.float32, device=dev)
        delta_real = torch.ones(L, dtype=torch.bool, device=dev)
        p_real = o
    slots, own, verts, nees = [], [], [], []
    n_shades = torch.zeros((), dtype=torch.int64, device=dev)
    if keep_tri:
        tri_c = tri.clamp(min=0)
    if need_uv:
        zero2 = torch.zeros((L, 2), dtype=torch.float32, device=dev)
    if med_on:
        # the lanes' media (the sensor in vacuum) and whether a lane sits
        # at a scattering event t along its ray rather than at a surface
        med = torch.full((L,), -1, dtype=torch.int32, device=dev)
        in_med_c = torch.zeros(L, dtype=torch.bool, device=dev)
    for j in range(1, J + 1):
        p = o + t[:, None] * d
        if med_on:
            in_med = in_med_c & act
            # x resolves an orientation volume's fiber axis at the event
            m_pp = M.phase_params(media, med, M.fetch_row(media, med), x=p)
        if need_uv:
            sh_n, geo_n, mid, _, _, uv, dpdu, dpdv = decode_row(
                row, bu, bv, with_uv=True)
        else:
            sh_n, geo_n, mid, _, _ = decode_row(row, bu, bv)
        wi_dot_geo = -dot(geo_n, d)
        if cfg.strict_normals:
            flip_ok = wi_dot_geo * (-dot(sh_n, d)) >= 0
            act = act & ((in_med | flip_ok) if med_on else flip_ok)
        if cfg.has_bump:
            # the hit row's bump or normal map perturbs the shading normal
            # before the frame is built (one K9 launch on a card)
            bump = scene.mats.bump[mid.long()]
            sh_n = TX.perturb_normal(scene.tex, bump[:, 0] + 1,
                                     bump[:, 1] > 0, uv, sh_n, dpdu, dpdv)
        tex = (TextureLookups(scene, cfg, sensor, j, row, bu, bv, tri_c, d, t,
                              geo_n, uv, dpdu, dpdv, zero2)
               if tex_fields else None)
        s_ax, t_ax = build_frame(sh_n)
        wi = to_local(s_ax, t_ax, sh_n, -d)
        if res is None:
            params = B.gather_params(scene.mats, mid)
            if tex is not None:
                override_reflectance(params, tex)
            site = None
            sample = lambda u: B.sample_bsdf(params, wi, u, present)
            eval_pdf = lambda w: B.eval_pdf_bsdf(params, wi, w, present)
        else:
            # the mask, blend and coating picks (drawn only when the
            # scene has that wrapper), then one site a bounce
            site = W.Site(scene.mats, mid, wi,
                          draw(j, 7, L) if cfg.has_mask else None,
                          draw(j, 10, L) if cfg.has_blend else None,
                          draw(j, 11, L, 1) if cfg.has_coating else None,
                          tex, tex_fields)
            params, sample, eval_pdf = site, site.sample, site.eval_pdf
        smooth, delta_only, is_null, transmissive = B.lane_flags(params)

        # SD-tree lookup; the learned fraction on lanes with a tree
        frac = torch.full((L,), cfg.bsdf_fraction, dtype=torch.float32,
                          device=dev)
        if guide:
            # one call (K3 on a card): the descent, the id masked to the
            # smooth surface lanes (guiding ignores media), and that id's
            # root, uniform flag and fraction
            has_tree = smooth & ~in_med if med_on else smooth
            dtree_id, voxel, d_root, d_uni, d_frac = G.lookup_meta(
                sdtree, p, has_tree)
            if cfg.learn_fraction:
                frac = torch.where(has_tree, d_frac, frac)
        else:
            dtree_id = torch.full((L,), -1, dtype=torch.int32, device=dev)
            voxel = torch.ones((L, 3), dtype=torch.float32, device=dev)

        # sampleMat: one-sample MIS of BSDF and guided sampling
        u_bsdf = draw(j, 0, L, 3)
        if guide and cfg.is_built:
            use_guide_mix = (dtree_id >= 0) & ~delta_only
            pick_bsdf = u_bsdf[:, 0] < frac
            # Deliberately unlike ppg_tpu (wavefront.py:793-795, which
            # rescales every lane's first uniform): lanes without the
            # guide mix (delta-only, no tree) sample the BSDF with the
            # uniforms as drawn, as Mitsuba's sampleMat does
            # (guided_path.cpp:1654). Rescaled there, u / frac clipped
            # below 1 picks a dielectric's reflection with probability
            # frac * F, not F, while the weight divides by F: guided
            # renders lose the light of glass.
            ua = torch.stack([
                torch.where(use_guide_mix, torch.clamp(
                    u_bsdf[:, 0] / torch.clamp(frac, min=1e-9), 0.0,
                    1.0 - 1e-7), u_bsdf[:, 0]),
                u_bsdf[:, 1], u_bsdf[:, 2]], -1)
            wo_a, w_a, pdf_a, delta_a, eta_a = sample(ua)
            # one uniform per quadtree level + 2 for the leaf cell. On a
            # card they are drawn level-major, [22, L], and handed over as
            # the [L, 22] view: K4 reads a warp's uniforms of one level as
            # one line. The plain walk reads either layout, so on the CPU
            # they are drawn lane-major as before, and a CPU render keeps
            # its realisation.
            n_u = G.MAX_Q_DEPTH + 2
            if use_qmc:
                u_tree = draw(j, 1, L, n_u)
                if dev.type == "cuda":
                    u_tree = u_tree.t().contiguous().t()
            else:
                u_tree = (rand(gen, n_u, L).t() if dev.type == "cuda"
                          else rand(gen, L, n_u))
            is_point = pick_bsdf | ~use_guide_mix
            wo_world_a = to_world(s_ax, t_ax, sh_n, wo_a)
            d_tree, dtree_pdf = G.sample_pdf_dir(
                sdtree, u_tree, is_point, dir_to_canonical(wo_world_a),
                root=d_root, uniform=d_uni)
            wo_b = to_local(s_ax, t_ax, sh_n, d_tree)

            wo = torch.where(is_point[:, None], wo_a, wo_b)
            sampled_delta = torch.where(use_guide_mix, delta_a & pick_bsdf,
                                        delta_a)
            eta_s = torch.where(use_guide_mix & ~pick_bsdf, 1.0, eta_a)
            f_cos, bsdf_pdf = eval_pdf(wo)
            if site is not None:
                # a smooth blend or coating sample's weight: the eval at
                # wo, which is wo_a on every lane that reads w_a or pdf_a
                # (bsdf-picked, or without the guide mix)
                w_a, pdf_a = site.finish(w_a, pdf_a, f_cos, bsdf_pdf)
            wo_pdf = frac * bsdf_pdf + (1 - frac) * dtree_pdf
            # delta lobe picked via the bsdf: guiding pdf 0 (:1670-1676)
            wo_pdf = torch.where(sampled_delta, pdf_a * frac, wo_pdf)
            dtree_pdf = torch.where(sampled_delta, 0.0, dtree_pdf)
            bsdf_pdf = torch.where(sampled_delta, pdf_a, bsdf_pdf)
            value = torch.where(sampled_delta[:, None], w_a * pdf_a[:, None],
                                f_cos)
            bsdf_weight = torch.where(
                wo_pdf[:, None] > 0,
                value / torch.clamp(wo_pdf, min=1e-38)[:, None], 0.0)
            # lanes without the guide mix: plain bsdf sampling
            bsdf_weight = torch.where(use_guide_mix[:, None], bsdf_weight,
                                      w_a)
            wo_pdf = torch.where(use_guide_mix, wo_pdf, pdf_a)
            # Deliberately unlike ppg_tpu (wavefront.py:844, which records
            # pdf_a here): guide-mix lanes keep the bsdf pdf at the
            # direction taken, as Mitsuba's pdfMat does. It feeds only the
            # learned-fraction (Adam) gradient; the image estimator
            # already weights by the mixture pdf of that direction.
            bsdf_pdf = torch.where(use_guide_mix, bsdf_pdf, pdf_a)
            dtree_pdf = torch.where(use_guide_mix, dtree_pdf, 0.0)
        else:
            is_point = None
            wo, bsdf_weight, bsdf_pdf, sampled_delta, eta_s = sample(u_bsdf)
            if site is not None and site.pending is not None:
                bsdf_weight, bsdf_pdf = site.finish(
                    bsdf_weight, bsdf_pdf, *eval_pdf(wo))
            wo_pdf = bsdf_pdf
            dtree_pdf = torch.zeros(L, dtype=torch.float32, device=dev)
        wo_world = to_world(s_ax, t_ax, sh_n, wo)
        if med_on:
            # medium lanes: the phase function's sample replaces the BSDF's
            d_ph, pdf_ph, w_ph = M.phase_sample_full(m_pp, d, draw(j, 9, L, 2))
            wo_world = torch.where(in_med[:, None], d_ph, wo_world)
            bsdf_weight = torch.where(in_med[:, None], w_ph[:, None],
                                      bsdf_weight)
            wo_pdf = torch.where(in_med, pdf_ph, wo_pdf)
            bsdf_pdf = torch.where(in_med, pdf_ph, bsdf_pdf)
            sampled_delta = sampled_delta & ~in_med
            eta_s = torch.where(in_med, 1.0, eta_s)
            dtree_pdf = torch.where(in_med, 0.0, dtree_pdf)

        # subsurface scattering on the surface lanes (ppg_tpu's lane
        # block, wavefront.py:890-921): the dipole's exitance (one K12
        # launch on a card) and single scattering, whose continuation
        # overrides the sample above (the shape's boundary is a delta
        # interface: no guiding, no record)
        l_sub = None
        if cfg.has_subsurf or cfg.has_sss:
            ss_gate = act & ~in_med if med_on else act
        if cfg.has_subsurf:
            ss_id = torch.where(ss_gate, scene.subsurf.tri_ss[tri_c.long()],
                                -1)
            l_sub = thr * lo_sub(scene.subsurf, ss_id, p, -dot(sh_n, d))
        if cfg.has_sss:
            sss_id = torch.where(ss_gate, scene.sss.tri_ss[tri_c.long()], -1)
            # from the render's generator, whatever the sampler (as
            # ppg_tpu draws them from its key)
            L_ss, ss_cont = single_scatter(
                scene, cfg, sss_id, p, d, sh_n, geo_n,
                rand(gen, L, n_uniforms(scene.sss)))
            l_sub = thr * L_ss if l_sub is None else l_sub + thr * L_ss
            is_ss = sss_id >= 0
            wo_world = torch.where(is_ss[:, None], ss_cont["d"], wo_world)
            wo = torch.where(is_ss[:, None],
                             to_local(s_ax, t_ax, sh_n, ss_cont["d"]), wo)
            bsdf_weight = torch.where(is_ss[:, None], ss_cont["w"],
                                      bsdf_weight)
            wo_pdf = torch.where(is_ss, 1.0, wo_pdf)
            bsdf_pdf = torch.where(is_ss, 1.0, bsdf_pdf)
            sampled_delta = sampled_delta | is_ss
            eta_s = torch.where(is_ss, 1.0, eta_s)
            dtree_pdf = torch.where(is_ss, 0.0, dtree_pdf)
            dtree_id = torch.where(is_ss, -1, dtree_id)
            if guide and cfg.is_built:
                use_guide_mix = use_guide_mix & ~is_ss

        # next-event estimation (guided_path.cpp:1967-2021)
        l_nee = zeros3()
        if cfg.do_nee:
            u_nee = draw(j, 2, L, 2)
            # a medium lane samples like a transmissive smooth surface
            scatters = (smooth | in_med) if med_on else smooth
            ref_n = torch.where(((transmissive | in_med) if med_on
                                 else transmissive)[:, None], 0.0, sh_n)
            ds = _sample_emitters(scene, p, ref_n, u_nee, act, scatters)
            nee_ok = act & scatters & (ds["pdf"] > 0)
            wo_nee = to_local(s_ax, t_ax, sh_n, ds["d"])
            if cfg.strict_normals:
                side_ok = dot(geo_n, ds["d"]) * wo_nee[:, 2] > 0
                nee_ok = nee_ok & ((in_med | side_ok) if med_on else side_ok)
            f_nee, bsdf_pdf_nee = eval_pdf(wo_nee)
            if med_on:
                # the phase function is a medium lane's "BSDF" (sigma_s is
                # in the throughput through the segment's weight)
                ph_val, ph_pdf = M.phase_value_pdf(m_pp, d, ds["d"])
                f_nee = torch.where(in_med[:, None], ph_val[:, None], f_nee)
                bsdf_pdf_nee = torch.where(in_med, ph_pdf, bsdf_pdf_nee)
            if guide and cfg.is_built:
                dtree_pdf_nee = G.pdf_dir2(sdtree, ds["d"], d_root, d_uni)
                wo_pdf_nee = torch.where(
                    use_guide_mix,
                    frac * bsdf_pdf_nee + (1 - frac) * dtree_pdf_nee,
                    bsdf_pdf_nee)
            else:
                dtree_pdf_nee = torch.zeros(L, dtype=torch.float32,
                                            device=dev)
                wo_pdf_nee = bsdf_pdf_nee
            # shadow ray; lanes that are off park (t_max < t_min = 0)
            so = p + torch.sign(wi_dot_geo)[:, None] * geo_n * scene.eps
            if med_on:
                so = torch.where(in_med[:, None], p, so)
            sh_tmax = torch.where(
                nee_ok, ds["dist"] * (1 - SHADOW_EPS) - scene.eps, -1.0)
            if walk:
                # through null and mask surfaces and media
                t_sh = shadow_transmittance(
                    scene, so, ds["d"], torch.clamp(sh_tmax, min=0.0), nee_ok,
                    None if cfg.max_depth < 0 else cfg.max_depth - j - 1,
                    med if med_on else None, gen)
                nee_ok = nee_ok & (t_sh > 0).any(-1)
            else:
                nee_ok = nee_ok & ~any_hit(scene.geom, so, ds["d"],
                                           torch.zeros_like(sh_tmax), sh_tmax)
            w_nee = mi_weight(ds["pdf"], wo_pdf_nee)
            if scene.delta is not None:
                # a discrete-measure (delta) sample takes no heuristic
                w_nee = torch.where(ds["discrete"], 1.0, w_nee)
            l_nee = thr * ds["value"] * f_nee * w_nee[:, None]
            if walk:
                l_nee = l_nee * t_sh
            l_nee = torch.where(nee_ok[:, None], l_nee, 0.0)
            if cfg.record_vertices:
                nee_valid = nee_ok & (dtree_id >= 0)
                nees.append(targets(dict(
                    radiance=l_nee,
                    throughput=thr * f_nee / torch.clamp(
                        ds["pdf"], min=1e-38)[:, None],
                    bsdf_val=f_nee, wo_pdf=ds["pdf"], bsdf_pdf=bsdf_pdf_nee,
                    dtree_pdf=dtree_pdf_nee, valid=nee_valid),
                    p, ds["d"], dtree_id, voxel, nee_valid))

        # continue the path
        act_c = act & (bsdf_weight > 0).any(-1) & (wo_pdf > 0)
        if cfg.strict_normals:
            side_ok = dot(geo_n, wo_world) * wo[:, 2] > 0
            act_c = act_c & ((in_med | side_ok) if med_on else side_ok)
        thr2 = thr * bsdf_weight
        eta2 = eta * eta_s
        o2 = p + torch.sign(dot(geo_n, wo_world))[:, None] * geo_n * scene.eps
        if med_on:
            o2 = torch.where(in_med[:, None], p, o2)
        if cfg.has_sss:
            # a transmission continues from the far boundary's exit
            # (singlescatter.cpp:1344-1374 launches Li from its2.p)
            o2 = torch.where(is_ss[:, None], ss_cont["o"], o2)
        d2 = wo_world
        # inactive lanes park at once (t_max < t_min)
        tri2, t2, bu2, bv2 = closest_hit(
            scene.geom, o2, d2, torch.zeros_like(t),
            torch.where(act_c, INF, -1.0))
        hit2 = (tri2 >= 0) & act_c
        row2 = fetch_row(scene, tri2.clamp(min=0))
        sh_n2, _, _, eid2, _ = decode_row(row2, bu2, bv2)
        le2 = torch.where(hit2[:, None],
                          E.eval_radiance(scene.emitters, eid2, sh_n2, -d2),
                          0.0)
        if cfg.has_env:
            # the escaped lanes (act_c, tri2 -1): the environment's
            # radiance and its NEE pdf, 1 / n_pdf_slots included, zeros
            # on the other lanes (one K10 launch on a card)
            env_le, env_pdf = EV.lookup(scene.env, d2,
                                        EV.Gate(tri2, -1, act_c), n_pdf_slots)
            le2 = le2 + env_le
        if med_on:
            # a surface lane that transmits through a boundary takes the
            # boundary's interior going in, vacuum going out; then the new
            # segment samples a distance in its medium (Woodcock tracking
            # in a grid medium, one K11 launch)
            cos_wo = dot(geo_n, wo_world)
            crossing = ~in_med & (cos_wo * wi_dot_geo < 0) & act
            surf_med = row[:, 23].contiguous().view(torch.int32)
            med2 = torch.where(crossing, torch.where(cos_wo < 0, surf_med, -1),
                               med)
            row_m2 = M.fetch_row(media, med2)
            s_t2, alb2, _ = M.fetch(media, med2, row=row_m2)
            u_dist = draw(j, 8, L, 2)
            t_for = torch.where(hit2, t2, float("inf"))
            is_med2, t_eff, w_seg = M.sample_distance(
                s_t2, alb2, t_for, u_dist[:, 0], u_dist[:, 1])
            if media.any_hetero:
                is_h, t_h, w_h = M.woodcock_sample(media, med2, o2, d2, t_for,
                                                   M.draw_seed(gen))
                het2 = (med2 >= 0) & (row_m2[:, 7] > 0)
                is_med2 = torch.where(het2, is_h, is_med2)
                t_eff = torch.where(het2, t_h, t_eff)
                w_seg = torch.where(het2[:, None], w_h, w_seg)
            is_med2 = is_med2 & act_c
            thr2 = thr2 * w_seg
            # the scatter event takes the rest of the segment: no emitter
            le2 = torch.where(is_med2[:, None], 0.0, le2)
        # a pass-through transition keeps the last real vertex's MIS state
        wo_pdf_mis, delta_mis, p_ref = wo_pdf, sampled_delta, p
        if enull:
            null_trans = is_null
            if site is not None and site.is_mask is not None:
                pt = site.pass_thru
                null_trans = null_trans | (pt if is_point is None
                                           else pt & is_point)
            null_trans = null_trans & (act & ~in_med if med_on else act)
            wo_pdf_mis = torch.where(null_trans, wo_pdf_real, wo_pdf)
            delta_mis = torch.where(null_trans, delta_real, sampled_delta)
            p_ref = torch.where(null_trans[:, None], p_real, p)
            wo_pdf_real, delta_real, p_real = wo_pdf_mis, delta_mis, p_ref
        # MIS of the emitter hit against NEE's pdf of the same point
        if cfg.do_nee:
            em_pdf = E.pdf_direct(scene.emitters, torch.where(hit2, eid2, -1),
                                  o2 + t2[:, None] * d2, sh_n2, p_ref,
                                  n_pdf_slots)
            if cfg.has_env:
                # 0 on the escaped lanes (no emitter id) + their
                # environment pdf (0 elsewhere): ppg_tpu's select
                em_pdf = em_pdf + env_pdf
            em_pdf = torch.where((le2 > 0).any(-1) & ~delta_mis, em_pdf, 0.0)
        else:
            em_pdf = torch.zeros_like(wo_pdf)
        w_mis2 = torch.where(delta_mis, 1.0, mi_weight(wo_pdf_mis, em_pdf))
        l_hit = torch.where(act_c[:, None], thr2 * le2 * w_mis2[:, None],
                            0.0)
        slots.append(l_nee + l_hit if l_sub is None
                     else l_sub + l_nee + l_hit)

        # vertex record (guided_path.cpp:2093-2110)
        if cfg.record_vertices:
            v_valid = act_c & (dtree_id >= 0) & (wo_pdf > 0)
            if not cfg.learn_fraction:
                v_valid = v_valid & ~sampled_delta
            # an ENull vertex's own radiance starts at 0
            own.append(torch.zeros_like(l_hit) if cfg.nee_always else
                       torch.where(null_trans[:, None], 0.0, l_hit) if enull
                       else l_hit)
            verts.append(targets(dict(
                throughput=thr2, bsdf_val=bsdf_weight * wo_pdf[:, None],
                wo_pdf=wo_pdf, bsdf_pdf=bsdf_pdf, dtree_pdf=dtree_pdf,
                is_delta=sampled_delta, valid=v_valid),
                o2, d2, dtree_id, voxel, v_valid))

        # russian roulette (guided_path.cpp:2124-2142); j is rRec.depth
        act_n = act_c & (hit2 | is_med2) if med_on else act_c & hit2
        if cfg.guiding:
            has_tree_rr = (dtree_id >= 0) & ~sampled_delta
            if cfg.is_built:
                sp_tree = torch.full_like(frac, 0.99)
            else:
                sp_tree = torch.clamp(thr2.amax(-1) * eta2 * eta2, 0.1, 0.99)
            sp = torch.where(has_tree_rr, sp_tree, 1.0)
        else:  # unguided baseline (path.cpp): throughput-based RR
            sp = torch.clamp(thr2.amax(-1) * eta2 * eta2, max=0.95)
        u_rr = draw(j, 3, L)
        sp_eff = sp if j >= cfg.rr_depth else torch.ones_like(sp)
        if enull and j >= cfg.rr_depth:
            # pass-through transitions are never roulette-terminated
            sp_eff = torch.where(null_trans, 1.0, sp_eff)
        act_n = act_n & (u_rr < sp_eff)
        thr2 = thr2 / torch.clamp(sp_eff, min=1e-9)[:, None]

        n_rays = n_rays + act_c.sum()
        if cfg.do_nee:  # shadow rays
            n_rays = n_rays + (act & smooth).sum()
        n_shades = n_shades + act.sum()
        act, o, d, row, t, bu, bv = act_n, o2, d2, row2, t2, bu2, bv2
        thr, eta = thr2, eta2
        if med_on:
            # a scattering lane sits at its event; any other at its hit
            # (t_eff equals t2 on every hit lane)
            t = torch.where(is_med2, t_eff, t2)
            med, in_med_c = med2, is_med2
        if keep_tri:
            tri_c = tri2.clamp(min=0)

    slots = torch.stack(slots)  # [J, L, 3]
    li = c0 + slots.sum(0)
    vertices = None
    if cfg.record_vertices:
        stack = lambda recs: {k: torch.stack([r[k] for r in recs])
                              for k in recs[0]}
        vert = stack(verts)
        # vertex radiance = own + all later slots
        later = slots.flip(0).cumsum(0).flip(0)
        later = torch.cat([later[1:], torch.zeros_like(later[:1])])
        vert["radiance"] = torch.stack(own) + later
        vertices = dict(bsdf=vert, nee=stack(nees) if nees else None)
    return dict(li=li, vertices=vertices, n_rays=n_rays,
                n_vertices=n_shades)

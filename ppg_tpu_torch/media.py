"""Participating media (counterpart of ppg_tpu/media.py): homogeneous and
heterogeneous (grid) media with the isotropic, Henyey-Greenstein,
Rayleigh, Kajiya-Kay and SGGX microflake phase functions (the reference's
src/medium/{homogeneous,heterogeneous}.cpp, src/phase/*.cpp,
src/volume/{gridvolume,constvolume}.cpp), as ppg_tpu integrates them into
the wavefront (guided_path.cpp:1803-1893): distance sampling against the
surface hit, phase sampling at a medium event, transmittance-weighted
NEE. Guiding ignores media: medium vertices are never recorded.

Medium rows [M, 36] f32, as ppg_tpu packs them: sigma_t(3) albedo(3) g
hetero majorant scale grid_offset res(3) world_to_grid(3x4) axis(3)
ks-or-beta kd exponent normalisation orientation_offset. A lane's medium
is an index (-1: vacuum); shapes carry an interior medium and a lane
switches on transmission through their boundary. The g slot doubles as
the phase kind: |g| <= 1 HG (isotropic below 1e-4), RAYLEIGH_G, KKAY_G,
MICROFLAKE_G.

Homogeneous media sample a distance by HomogeneousMedium's balance
strategy (`sample_distance`); grid media by Woodcock (delta) tracking
against the scale * max-density majorant (`woodcock_sample`), and shadow
segments through them take a ratio-tracking estimate
(`ratio_transmittance`). Both run K11 (csrc/media.cu, --fmad=false: a
persistent grid that queues the gated-in lanes, each thread taking the
next queued lane when its own ends, a few events a step) on CUDA
tensors and their plain versions, the kernel's specification, on CPU tensors. As in
ppg_tpu a lane takes at most WOODCOCK_MAX_BLOCKS blocks of WOODCOCK_STEPS
events: a Woodcock lane still alive at that cap escapes with weight 1,
and a ratio product is returned as it stands. Event k of lane i draws
its uniforms from render/samplers.py's counter hash keyed by the lane and
a per-call seed (`draw_seed`: one int64 on the call's device, drawn from
the render's generator), so the kernel and the plain version draw the
same numbers and a render repeats from its seed. The plain version
spells each operation out as the kernel repeats it: the world-to-grid
affine as products summed left to right, the trilinear blend in
ppg_tpu's order, clamps as compare and select, the log as ATen's on a
card (the CUDA math library's logf). A failed build or launch raises;
a CUDA tensor never runs the plain version through `woodcock_sample` or
`ratio_transmittance`. COUNTS: "media_track" and "media_ratio" count K11
launches by mode, "media_plain_on_cuda" plain loops on CUDA tensors
(`reset_counts` zeroes them).

The phase functions are plain PyTorch (elementwise, one call a bounce);
a phase kind no medium of the scene has is not computed (`PhaseParams.
kinds`), which changes no lane's value.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .core.vecmath import dot
from .native import CSRC, load_cuda, raw_stream
from .render.samplers import M32, _mul, _to_float

INV_4PI = 1.0 / (4.0 * np.pi)
ROW_W = 36
RAYLEIGH_G = 2.0  # g-slot sentinel: Rayleigh phase (rayleigh.cpp)
KKAY_G = 3.0  # g-slot sentinel: Kajiya-Kay fiber phase (kkay.cpp)
MICROFLAKE_G = 5.0  # g-slot sentinel: SGGX microflake fiber phase
PHASE_KINDS = frozenset({"hg", "rayleigh", "kkay", "microflake"})
WOODCOCK_STEPS = 64  # majorant events a block
WOODCOCK_MAX_BLOCKS = 1024  # ppg_tpu's watchdog bound on blocks

COUNTS = {"media_track": 0, "media_ratio": 0, "media_plain_on_cuda": 0}
TRACK, RATIO = 0, 1


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def kkay_normalization(exponent):
    """Simpson-quadrature normalisation for perpendicular illumination
    (kkay.cpp configure(), 1000 intervals)."""
    n = 1000
    h = np.pi / n
    theta = h * np.arange(1, n)
    vals = np.cos(theta - np.pi / 2) ** exponent * np.sin(theta)
    coef = np.where(np.arange(1, n) % 2 == 1, 4.0, 2.0)
    integral = np.sum(vals * coef) * h / 3.0
    return float(1.0 / (integral * 2.0 * np.pi))


def _phase_kind(g):
    return ("microflake" if g > 4.5 else "kkay" if g > 2.5 else
            "rayleigh" if g > 1.5 else "hg")


class MediaArrays:
    """The medium rows [max(M, 1), ROW_W] and the concatenated grids [G]
    (a zero first, then each density grid and orientation volume, flat)
    on one device; `num` media, `has_orient` (a medium carries an
    orientation volume), `any_hetero` (a grid medium) and `kinds` (the
    phase kinds of the media, "hg" always: vacuum lanes evaluate it)."""

    FIELDS = ("rows", "grid")

    def __init__(self, rows, grid, num, has_orient=False):
        self.rows, self.grid, self.num = rows, grid, num
        self.has_orient = bool(has_orient)
        host = rows[:num].cpu().numpy()
        self.any_hetero = bool(np.any(host[:, 7] > 0))
        self.kinds = frozenset({"hg"} | {_phase_kind(g) for g in host[:, 6]})

    @classmethod
    def from_table(cls, table, device):
        """ppg_tpu's MediaArrays.from_table: rows [max(M,1), ROW_W] f32
        and grid [G] f32 built in numpy, on `device`. table: dicts of
        sigma_t, albedo and g for homogeneous media, plus hetero=True,
        density [Z,Y,X], bbox_min, bbox_max, to_world 4x4 and scale for
        grid media; the fiber phases' orientation, ks, kd, exponent,
        stddev and orientation_grid [Z,Y,X,3]."""
        M = len(table)
        rows = np.zeros((max(M, 1), ROW_W), np.float32)
        grids = [np.zeros(1, np.float32)]
        goff = 1
        for i, m in enumerate(table):
            rows[i, 3:6] = m["albedo"]
            rows[i, 6] = m.get("g", 0.0)
            if m.get("g", 0.0) == KKAY_G:
                o = np.asarray(m.get("orientation", [0.0, 0.0, 1.0]),
                               np.float64)
                ln = np.linalg.norm(o)
                rows[i, 28:31] = o / ln if ln > 0 else 0.0
                rows[i, 31] = m.get("ks", 0.4)
                rows[i, 32] = m.get("kd", 0.2)
                rows[i, 33] = m.get("exponent", 4.0)
                rows[i, 34] = kkay_normalization(m.get("exponent", 4.0))
            # SGGX fiber flakes S = I - (1 - beta^2) m m^T; the gaussian
            # fiber's stddev maps to beta = stddev sqrt(pi / 2)
            if m.get("g", 0.0) == MICROFLAKE_G:
                o = np.asarray(m.get("orientation", [0.0, 0.0, 1.0]),
                               np.float64)
                ln = np.linalg.norm(o)
                rows[i, 28:31] = o / ln if ln > 0 else (0.0, 0.0, 1.0)
                beta = float(m.get("stddev", 0.25)) * np.sqrt(np.pi / 2)
                rows[i, 31] = min(max(beta, 1e-3), 1.0)
                ogrid = m.get("orientation_grid")
                if ogrid is not None:
                    og = np.asarray(ogrid, np.float32)  # [Z,Y,X,3]
                    if og.ndim != 4 or og.shape[-1] != 3:
                        raise ValueError("orientation volume must be "
                                         "3-channel [Z,Y,X,3]")
                    rows[i, 35] = float(goff)
                    grids.append(og.reshape(-1))
                    goff += og.size
            if not m.get("hetero"):
                rows[i, 0:3] = m["sigma_t"]
                continue
            dens = np.asarray(m["density"], np.float32)  # [Z,Y,X]
            zr, yr, xr = dens.shape
            scale = float(m.get("scale", 1.0))
            rows[i, 7] = 1.0
            rows[i, 8] = scale * float(dens.max())
            rows[i, 9] = scale
            rows[i, 10] = float(goff)
            rows[i, 11:14] = (xr, yr, zr)
            # world -> grid-index affine (gridvolume.cpp:188-196):
            # scale((res-1)/extent) . translate(-bbox_min) . worldToVolume
            ext = np.asarray(m["bbox_max"], np.float64) - np.asarray(
                m["bbox_min"], np.float64)
            s = np.diag(np.append((np.array([xr, yr, zr]) - 1)
                                  / np.maximum(ext, 1e-30), 1.0))
            t = np.eye(4)
            t[:3, 3] = -np.asarray(m["bbox_min"], np.float64)
            w2v = np.linalg.inv(np.asarray(m.get("to_world", np.eye(4)),
                                           np.float64))
            w2g = s @ t @ w2v
            rows[i, 14:26] = w2g[:3, :].reshape(-1)
            grids.append(dens.reshape(-1))
            goff += dens.size
        return cls(torch.from_numpy(rows).to(device),
                   torch.from_numpy(np.concatenate(grids)).to(device), M,
                   has_orient=bool(np.any(rows[:, 35] > 0)))

    @classmethod
    def empty(cls, device):
        return cls(torch.zeros((1, ROW_W), dtype=torch.float32,
                               device=device),
                   torch.zeros(1, dtype=torch.float32, device=device), 0)


class PhaseParams:
    """Per-lane phase data: g (the kind sentinel or HG's g), the medium
    rows and the fiber axis (the row's, or the orientation volume's at
    the event), and the phase kinds to compute."""

    def __init__(self, g, row, axis=None, kinds=PHASE_KINDS):
        self.g, self.row = g, row
        self.axis = row[:, 28:31] if axis is None else axis
        self.kinds = kinds


def fetch_row(media, mid):
    return media.rows[torch.clamp(mid, 0, media.rows.shape[0] - 1).long()]


def fetch(media, mid, x=None, row=None):
    """(sigma_t [L,3], albedo [L,3], PhaseParams) of the lanes' media (0
    in vacuum); `row` the lanes' rows if fetch_row gave them already. With
    `x` ([L,3] world points), a fiber phase with an orientation volume
    takes its axis there (phase_params)."""
    row = fetch_row(media, mid) if row is None else row
    in_medium = (mid >= 0)[:, None]
    return (torch.where(in_medium, row[:, 0:3], 0.0),
            torch.where(in_medium, row[:, 3:6], 0.0),
            phase_params(media, mid, row, x))


def phase_params(media, mid, row, x=None):
    """The lanes' PhaseParams from their rows. With `x` ([L,3] world
    points), a fiber phase with an orientation volume takes its axis at x
    through the density grid's world-to-grid affine (heterogeneous.cpp
    lookupVector)."""
    g = torch.where(mid >= 0, row[:, 6], 0.0)
    axis = row[:, 28:31]
    if x is not None and media.has_orient:
        vax = _orientation_lookup(media, row, x)
        ln = torch.sqrt(dot(vax, vax))
        ok = (row[:, 35] > 0) & (ln > 1e-6)
        axis = torch.where(ok[:, None],
                           vax / torch.clamp(ln, min=1e-12)[:, None], axis)
    return PhaseParams(g, row, axis, media.kinds)


def _to_grid(row, p):
    """The world-to-grid affine of the rows at p [L,3]: [L,3], each
    coordinate's products summed left to right."""
    w = row[:, 14:26].reshape(-1, 3, 4)
    return (w[:, :, 0] * p[:, 0:1] + w[:, :, 1] * p[:, 1:2]
            + w[:, :, 2] * p[:, 2:3] + w[:, :, 3])


def _orientation_lookup(media, row, x):
    """Nearest-cell orientation through the density grid's world-to-grid
    affine (nearest, so opposed fibers are not interpolated)."""
    gpos = _to_grid(row, x)
    res = row[:, 11:14]  # (xr, yr, zr)
    gi = torch.minimum(torch.clamp(torch.round(gpos), min=0.0),
                       torch.clamp(res - 1, min=0.0)).to(torch.int32)
    xr = res[:, 0].to(torch.int32)
    yr = res[:, 1].to(torch.int32)
    off = row[:, 35].to(torch.int32)
    lin = ((gi[:, 2] * yr + gi[:, 1]) * xr + gi[:, 0]) * 3
    base = torch.clamp(off + lin, 0, media.grid.shape[0] - 3).long()
    return torch.stack([media.grid[base], media.grid[base + 1],
                        media.grid[base + 2]], -1)


def _cell(media, row, p):
    """The trilinear lookup's parts at p: (inside [L] -- the continuous
    grid coordinate in [0, res - 1] on every axis --, the eight corners'
    flat grid indices [8, L] int64 in the blend's order x, then y, then z
    fastest-first, and the fractions fx, fy, fz from the clamped cell).
    An index is clamped into the grid, as ppg_tpu's gather clamps it."""
    g = _to_grid(row, p)
    res = row[:, 11:14]
    inside = ((g >= 0) & (g <= res - 1)).all(-1)
    n = res.to(torch.int32)
    hi = torch.clamp(n - 2, min=0)
    x1c = torch.minimum(torch.clamp(torch.floor(g).to(torch.int32), min=0),
                        hi)
    f = g - x1c.to(torch.float32)
    n, c = n.to(torch.int64), x1c.to(torch.int64)
    # ((z + dz) ny + (y + dy)) nx + (x + dx) = base + dz ny nx + dy nx + dx
    base = row[:, 10].to(torch.int64) + (c[:, 2] * n[:, 1] + c[:, 1]) * n[
        :, 0] + c[:, 0]
    sy, sz = n[:, 0], n[:, 0] * n[:, 1]
    idx = torch.stack([base, base + 1, base + sy, base + sy + 1, base + sz,
                       base + sz + 1, base + sz + sy, base + sz + sy + 1])
    return inside, torch.clamp(idx, 0, media.grid.shape[0] - 1), f


def density(media, row, p):
    """Trilinear scalar density (gridvolume.cpp lookupFloat); 0 outside
    the grid. row: [L, ROW_W] medium rows, p: [L,3]. A point in the last
    cell or on the max face interpolates through the clamped cell."""
    return _blend(media, *_cell(media, row, p))


def _blend(media, inside, idx, f):
    a = media.grid[idx]  # [8, L]: (x, y, z) = 000 100 010 110 001 ...
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    d = (((a[0] * (1 - fx) + a[1] * fx) * (1 - fy)
          + (a[2] * (1 - fx) + a[3] * fx) * fy) * (1 - fz)
         + ((a[4] * (1 - fx) + a[5] * fx) * (1 - fy)
            + (a[6] * (1 - fx) + a[7] * fx) * fy) * fz)
    return torch.where(inside, d, 0.0)


# ---------------------------------------------------------------------------
# Woodcock and ratio tracking: the plain versions and K11
# ---------------------------------------------------------------------------

def draw_seed(gen):
    """A K11 call's seed: one int64 in [0, 2^32) on the generator's
    device."""
    return torch.randint(0, 1 << 32, (1,), generator=gen, device=gen.device,
                         dtype=torch.int64)


def _finish(x):
    """The second half of render/samplers.py's _hash, from x + seed *
    golden."""
    x = x ^ (x >> 16)
    x = _mul(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul(x, 0x735A2D97)
    return x ^ (x >> 15)


def lane_keys(seed, L, device):
    """Each lane's key times the golden ratio (mod 2^32), int64 [L]:
    _hash(lane, seed) * 0x9E3779B9, so that event counter c of the lane
    hashes to _finish((c + key) mod 2^32), _hash(c, key)."""
    lane = torch.arange(L, dtype=torch.int64, device=device)
    key = _finish((lane + _mul(seed.to(device) & M32, 0x9E3779B9)) & M32)
    return _mul(key, 0x9E3779B9)


def _uniform(kmul, c):
    """Counter c's uniform in [0, 1) (24 bits) for each lane key; c an int
    or a tensor that broadcasts against kmul."""
    return _to_float(_finish((kmul + c) & M32))


def _ratio_step(dens, maj):
    r = 1.0 - dens / torch.clamp(maj, min=1e-38)
    return torch.where(r < 0, 0.0, r)


def _tracking_plain(mode, media, mid, o, d, t_end, seed, n_steps, stats):
    L, dev = o.shape[0], o.device
    if o.is_cuda:
        COUNTS["media_plain_on_cuda"] += 1
    row = fetch_row(media, mid)
    maj, scale = row[:, 8], row[:, 9]
    active0 = (mid >= 0) & (row[:, 7] > 0) & (maj > 0)
    kmul = lane_keys(seed, L, dev)
    if mode == TRACK:
        # both uniforms of an event in one hash: counters 2k and 2k + 1
        kmul = kmul[:, None]
        chans = torch.arange(2, dtype=torch.int64, device=dev)
    t = torch.zeros(L, dtype=torch.float32, device=dev)
    T = torch.ones(L, dtype=torch.float32, device=dev)
    hit = torch.zeros(L, dtype=torch.bool, device=dev)
    alive = active0
    maj_c = torch.clamp(maj, min=1e-38)
    if stats is not None:
        stats.update(gated_in=int(active0.sum()), steps=0, events=0,
                     inside=0, corners=[], lanes_in=active0,
                     lane_events=torch.zeros(L, dtype=torch.int64,
                                             device=dev))
    # ppg_tpu runs blocks of n_steps events while a lane is alive; a lane
    # takes at most n_steps * WOODCOCK_MAX_BLOCKS events either way, and
    # events after the last lane ended change nothing, so this loop ends
    # at the first event with no lane alive
    for k in range(n_steps * WOODCOCK_MAX_BLOCKS):
        if not bool(alive.any()):
            break
        if mode == TRACK:
            u = _uniform(kmul, chans + 2 * k)
            u0, u1 = u[:, 0], u[:, 1]
        else:
            u0 = _uniform(kmul, k)
        t2 = t - torch.log(torch.clamp(1.0 - u0, min=1e-38)) / maj_c
        past = t2 >= t_end
        cell = _cell(media, row, o + t2[:, None] * d)
        dens = _blend(media, *cell) * scale
        live = alive & ~past
        if stats is not None:
            seen = live & cell[0]
            stats["steps"] += 1
            stats["events"] += int(live.sum())
            stats["inside"] += int(seen.sum())
            stats["lane_events"] += live
            stats["corners"].append(cell[1][:, seen].reshape(-1))
        if mode == TRACK:
            accept = u1 * maj < dens
            hit = hit | (live & accept)
            alive = live & ~accept
        else:
            T = torch.where(live, T * _ratio_step(dens, maj), T)
            alive = live
        t = torch.where(live, t2, t)
    if stats is not None:
        corners = stats.pop("corners")
        stats["distinct_grid"] = (int(torch.unique(torch.cat(corners)).numel())
                                  if corners else 0)
    if mode == TRACK:
        w = torch.where(hit[:, None], row[:, 3:6], 1.0)
        return hit, torch.where(hit, t, t_end), w
    return torch.where(active0, T, 1.0)


def woodcock_sample_plain(media, mid, o, d, t_surf, seed,
                          n_steps=WOODCOCK_STEPS, stats=None):
    """Delta tracking along o + t d up to t_surf ([L]; inf: no surface)
    in the lanes' media (mid [L] int32). Returns (is_medium [L] bool, t
    [L], weight [L,3]): the albedo at a scatter event, 1 for the surface
    (the acceptance test makes the transmittance estimate unbiased).
    Lanes in vacuum, in a homogeneous medium or with majorant 0 escape
    at once. Event k of lane i draws u0 (the free flight) and u1 (the
    acceptance) from counters 2k and 2k + 1 (lane_keys); events run in
    blocks of n_steps while any lane is alive, at most
    WOODCOCK_MAX_BLOCKS of them, and a lane alive at that cap escapes.
    With `stats` (a dict) it also gives the gated-in lanes (a count,
    and `lanes_in`, a mask [L]), the live events (a count, and
    `lane_events` [L], each lane's), those inside the grid and the
    distinct grid floats they read, and the steps the longest lane
    took."""
    return _tracking_plain(TRACK, media, mid, o, d, t_surf, seed, n_steps,
                           stats)


def ratio_transmittance_plain(media, mid, o, d, dist, seed,
                              n_steps=WOODCOCK_STEPS, stats=None):
    """Ratio-tracking transmittance [L] of [0, dist] in the lanes' grid
    media (unbiased), 1 on the other lanes; event k of lane i draws its
    flight from counter k. Blocks and cap as woodcock_sample_plain: the
    product at the cap is returned as it stands."""
    return _tracking_plain(RATIO, media, mid, o, d, dist, seed, n_steps,
                           stats)


def woodcock_sample(media, mid, o, d, t_surf, seed, n_steps=WOODCOCK_STEPS):
    """woodcock_sample_plain's (is_medium, t, weight); CUDA tensors
    launch K11 once."""
    if o.is_cuda:
        return _launch(TRACK, media, mid, o, d, t_surf, seed, n_steps)
    return woodcock_sample_plain(media, mid, o, d, t_surf, seed, n_steps)


def ratio_transmittance(media, mid, o, d, dist, seed,
                        n_steps=WOODCOCK_STEPS):
    """ratio_transmittance_plain's T; CUDA tensors launch K11 once."""
    if o.is_cuda:
        return _launch(RATIO, media, mid, o, d, dist, seed, n_steps)
    return ratio_transmittance_plain(media, mid, o, d, dist, seed, n_steps)


# --fmad=false: each product and sum rounded on its own, as the plain
# version's separate operations round them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# mode, rows, M, grid, G, o and its strides (2), d and its strides, t_end
# and its stride, mid and its stride, seed, the cap in events; is_med, t,
# w (track) or T (ratio); L, card, stream
ARGTYPES = [_ci, _vp, _ci, _vp, _cll, _vp, _cll, _cll, _vp, _cll, _cll,
            _vp, _cll, _vp, _cll, _vp, _ci, _vp, _vp, _vp, _vp, _cll, _ci,
            _vp]
_lib = None


def build():
    """Compile csrc/media.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(os.path.join(CSRC, "media.cu"), "libppgmedia",
                     NVCC_FLAGS, {"ppg_media_track": ARGTYPES})
    return _lib


def kernel_args(mode, media, mid, o, d, t_end, seed, n_steps):
    """The C entry point's arguments but the outputs, L, card and stream;
    raises ValueError on a tensor it does not take."""
    L = o.shape[0]
    want = [("o", o, torch.float32, (L, 3)), ("d", d, torch.float32, (L, 3)),
            ("t_end", t_end, torch.float32, (L,)),
            ("mid", mid, torch.int32, (L,)),
            ("seed", seed, torch.int64, (1,)),
            ("rows", media.rows, torch.float32, None),
            ("grid", media.grid, torch.float32, None)]
    bad = [f"{n} {t.dtype} {tuple(t.shape)} on {t.device}"
           for n, t, dt, shape in want
           if t.dtype != dt or (shape is not None and tuple(t.shape) != shape)
           or t.device != o.device]
    if (bad or not media.rows.is_contiguous() or media.rows.dim() != 2
            or media.rows.shape[1] != ROW_W or not media.grid.is_contiguous()
            or mode not in (TRACK, RATIO)
            or not 0 < n_steps * WOODCOCK_MAX_BLOCKS < 1 << 30):
        raise ValueError(
            f"ppg_media_track: want o and d float32 ({L}, 3), t_end float32 "
            f"({L},), mid int32 ({L},), seed int64 (1,), contiguous rows "
            f"float32 [M, {ROW_W}] and grid float32, all on {o.device}, and "
            f"0 < n_steps * {WOODCOCK_MAX_BLOCKS} < 2^30; got "
            + "; ".join(bad + [f"n_steps {n_steps}"]))
    return [mode, media.rows.data_ptr(), media.rows.shape[0],
            media.grid.data_ptr(), media.grid.shape[0], o.data_ptr(),
            o.stride(0), o.stride(1), d.data_ptr(), d.stride(0), d.stride(1),
            t_end.data_ptr(), t_end.stride(0), mid.data_ptr(),
            mid.stride(0), seed.data_ptr(), n_steps * WOODCOCK_MAX_BLOCKS]


def _launch(mode, media, mid, o, d, t_end, seed, n_steps=WOODCOCK_STEPS):
    """K11 on o's card in `mode`: TRACK gives woodcock_sample_plain's
    (is_medium, t, weight), RATIO ratio_transmittance_plain's T. Adds one
    to COUNTS["media_track"] or COUNTS["media_ratio"]."""
    args = kernel_args(mode, media, mid, o, d, t_end, seed, n_steps)
    L, card = o.shape[0], o.get_device()
    new = lambda *s, dt=torch.float32: torch.empty((L,) + s, dtype=dt,
                                                   device=o.device)
    if mode == TRACK:
        out = (new(dt=torch.bool), new(), new(3))
        ptrs = [out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                None]
    else:
        out = new()
        ptrs = [None, None, None, out.data_ptr()]
    lib = _lib or build()
    err = lib.ppg_media_track(*args, *ptrs, L, card, raw_stream(card))
    if err != 0:
        raise RuntimeError(f"ppg_media_track launch failed: cudaError {err}")
    COUNTS["media_track" if mode == TRACK else "media_ratio"] += 1
    return out


# ---------------------------------------------------------------------------
# homogeneous media
# ---------------------------------------------------------------------------

def transmittance(sigma_t, dist):
    """e^{-sigma_t * d} per channel."""
    return torch.exp(-sigma_t * torch.clamp(dist, min=0.0)[..., None])


def sample_distance(sigma_t, albedo, t_surf, u_chan, u_dist):
    """HomogeneousMedium::sampleDistance with the balance channel
    strategy. Returns (is_medium, t, weight [L,3]); the weight folds
    sigma_s / pdf at a medium event, T / pdf_surf at the surface, 1 in
    vacuum."""
    ch = torch.clamp((u_chan * 3).to(torch.int32), 0, 2)
    st_ch = torch.gather(sigma_t, -1, ch[:, None].long())[:, 0]
    active = st_ch > 0
    t = torch.where(active, -torch.log(torch.clamp(1.0 - u_dist, min=1e-38))
                    / torch.clamp(st_ch, min=1e-38), float("inf"))
    is_medium = active & (t < t_surf)
    tr_t = transmittance(sigma_t, t)
    tr_s = transmittance(sigma_t, t_surf)
    # the balance heuristic's pdfs, averaged over the 3 channels
    pdf_medium = (sigma_t * tr_t).mean(-1)
    pdf_surf = tr_s.mean(-1)
    sigma_s = sigma_t * albedo
    w_medium = sigma_s * tr_t / torch.clamp(pdf_medium, min=1e-38)[:, None]
    w_surf = tr_s / torch.clamp(pdf_surf, min=1e-38)[:, None]
    w = torch.where(is_medium[:, None], w_medium, w_surf)
    vac = (sigma_t <= 0).all(-1)
    w = torch.where(vac[:, None], 1.0, w)
    return is_medium & ~vac, torch.where(is_medium, t, t_surf), w


# ---------------------------------------------------------------------------
# phase functions
# ---------------------------------------------------------------------------

_AXES = {}  # (device, dtype) -> [[0, 0, 1], [1, 0, 0]], made once


def _frame_up(v):
    """(0, 0, 1) where |v_z| < 0.999, else (1, 0, 0), per lane."""
    key = (v.device, v.dtype)
    if key not in _AXES:
        _AXES[key] = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]],
                                  dtype=v.dtype, device=v.device)
    axes = _AXES[key]
    return torch.where((v[..., 2].abs() < 0.999)[..., None], axes[0],
                       axes[1])


def _unit(v):
    return v / torch.clamp(torch.sqrt(dot(v, v)), min=1e-12)[..., None]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def hg_eval_pdf(g, cos_theta):
    """HG phase value (= pdf). cos_theta is measured from the propagation
    direction (forward peak for g > 0)."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    iso = torch.abs(g) < 1e-4
    hg = INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)
    return torch.where(iso, INV_4PI, hg)


def _dir_around(d_in, cos_theta, phi):
    """Direction at (cos_theta, phi) in a frame around d_in."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, 0.0, 1.0))
    sx = _unit(_cross(_frame_up(d_in), d_in))
    sy = _cross(d_in, sx)
    return (sx * (sin_theta * torch.cos(phi))[..., None]
            + sy * (sin_theta * torch.sin(phi))[..., None]
            + d_in * cos_theta[..., None])


def hg_sample(g, d_in, u2):
    """(d_out, pdf) around d_in (hg.cpp sample): phase_sample's HG branch.
    Unlike ppg_tpu's hg_sample, whose clamp of 2g from below turns every
    backward lobe (g < 0) forward (its tracer samples through
    phase_sample, which keeps the sign), so the mean cosine is g."""
    return phase_sample(g, d_in, u2, kinds=frozenset({"hg"}))


def rayleigh_eval_pdf(cos_theta):
    """Rayleigh phase value (= pdf): 3 / (16 pi) (1 + cos^2)."""
    return 3.0 / (16.0 * np.pi) * (1.0 + cos_theta * cos_theta)


def rayleigh_sample_ct(u):
    """The Rayleigh CDF inverted over cos_theta: c^3 + 3c + (4 - 8u) = 0
    in closed form (Cardano with p = 3: c = z - 1/z; the cube root's
    argument is positive)."""
    d = 4.0 - 8.0 * u
    s = torch.sqrt(d * d * 0.25 + 1.0)
    z = torch.pow(-0.5 * d + s, 1.0 / 3.0)
    return torch.clamp(z - 1.0 / z, -1.0, 1.0)


def phase_eval_pdf(g, cos_theta, kinds=PHASE_KINDS):
    """Per-lane dispatch over the g slot (HG/isotropic or Rayleigh)."""
    if "rayleigh" not in kinds:
        return hg_eval_pdf(g, cos_theta)
    ray = g > 1.5
    return torch.where(ray, rayleigh_eval_pdf(cos_theta),
                       hg_eval_pdf(torch.where(ray, 0.0, g), cos_theta))


def phase_sample(g, d_in, u2, kinds=PHASE_KINDS):
    """(d_out, pdf) of the HG/isotropic or Rayleigh lanes."""
    ray = g > 1.5
    g_hg = torch.where(ray, 0.0, g)
    iso = torch.abs(g_hg) < 1e-4
    sq = (1.0 - g_hg * g_hg) / (1.0 - g_hg + 2.0 * g_hg * u2[..., 0])
    # a sign-preserving guard: a clamp would flip backward lobes
    den = 2.0 * g_hg
    den = torch.where(torch.abs(den) < 1e-8, 1e-8, den)
    ct_hg = (1.0 + g_hg * g_hg - sq * sq) / den
    ct_iso = 1.0 - 2.0 * u2[..., 0]
    cos_theta = torch.where(iso, ct_iso, torch.clamp(ct_hg, -1.0, 1.0))
    if "rayleigh" in kinds:
        cos_theta = torch.where(ray, rayleigh_sample_ct(u2[..., 0]),
                                cos_theta)
    d_out = _dir_around(d_in, cos_theta, 2.0 * np.pi * u2[..., 1])
    return d_out, phase_eval_pdf(g, cos_theta, kinds)


def kkay_eval(pp, d_in, d_out):
    """Kajiya-Kay phase value (kkay.cpp eval): a specular lobe around the
    fiber-preserving reflected direction and a diffuse floor. d_in points
    along propagation."""
    axis = pp.axis
    ks, kd, expn, norm = (pp.row[:, k] for k in (31, 32, 33, 34))
    has_axis = dot(axis, axis) > 0
    sx = _unit(_cross(_frame_up(axis), axis))
    sy = _cross(axis, sx)
    lx = dot(d_out, sx)
    ly = dot(d_out, sy)
    lz = dot(d_in, axis)  # reflectedLocal.z = -dot(wi, n), d_in = -wi
    denom = torch.clamp(lx * lx + ly * ly, min=1e-12)
    a = torch.sqrt(torch.clamp((1.0 - lz * lz) / denom, 0.0, 1e12))
    R = (sx * (lx * a)[..., None] + sy * (ly * a)[..., None]
         + axis * lz[..., None])
    spec = torch.pow(torch.clamp(dot(R, d_out), min=0.0), expn) * norm * ks
    val = spec + kd * INV_4PI
    return torch.where(has_axis, val, kd * INV_4PI)


# SGGX microflake fiber phase [Heitz et al. 2015], S = I - (1 - beta^2) m
# m^T: sigma(w) = sqrt(1 - (1 - beta^2) <w,m>^2), D(wm) = 1 / (pi beta
# (<wm,m>^2 / beta^2 + 1 - <wm,m>^2)^2), p = D(wh) / (4 sigma(wi));
# visible-normal sampling then mirror reflection, so pdf = value. As in
# ppg_tpu the extinction stays directionally uniform.

def _sggx_sigma(beta, cm):
    return torch.sqrt(torch.clamp(1.0 - (1.0 - beta * beta) * cm * cm,
                                  min=1e-12))


def _sggx_D(beta, cm):
    q = cm * cm / torch.clamp(beta * beta, min=1e-12) + (1.0 - cm * cm)
    return 1.0 / torch.clamp(np.pi * beta * q * q, min=1e-24)


def sggx_eval(pp, d_in, d_out):
    """Phase value = sampling pdf; d_in points along propagation."""
    m = pp.axis
    beta = pp.row[:, 31]
    wi = -d_in
    wh = wi + d_out
    hn = torch.sqrt(dot(wh, wh))
    wh = wh / torch.clamp(hn, min=1e-12)[..., None]
    val = _sggx_D(beta, dot(wh, m)) / (4.0 * _sggx_sigma(beta, dot(wi, m)))
    # wh undefined for wo == -wi: the value goes to 0
    return torch.where(hn > 1e-6, val, 0.0)


def sggx_sample(pp, d_in, u2):
    """Visible-normal sample of the SGGX fiber distribution in the (wk,
    wj, wi) frame (Heitz et al. 2015, supplemental listing), then a
    specular reflection. Returns (d_out, pdf)."""
    m = pp.axis
    beta = pp.row[:, 31]
    wi = -d_in
    wk = _unit(_cross(_frame_up(wi), wi))
    wj = _cross(wi, wk)
    # S in the (k, j, i) frame: S_ab = <a,b> - c <a,m><b,m>
    c = 1.0 - beta * beta
    mk, mj, mi = dot(wk, m), dot(wj, m), dot(wi, m)
    S_kk = 1.0 - c * mk * mk
    S_jj = 1.0 - c * mj * mj
    S_ii = 1.0 - c * mi * mi
    S_kj = -c * mk * mj
    S_ki = -c * mk * mi
    S_ji = -c * mj * mi
    det = (S_kk * S_jj * S_ii - S_kj * S_kj * S_ii - S_ki * S_ki * S_jj
           - S_ji * S_ji * S_kk + 2.0 * S_kj * S_ki * S_ji)
    sqrt_det = torch.sqrt(torch.clamp(det, min=1e-24))
    inv_sqrt_Sii = 1.0 / torch.sqrt(torch.clamp(S_ii, min=1e-12))
    tmp = torch.sqrt(torch.clamp(S_jj * S_ii - S_ji * S_ji, min=1e-24))
    zero = torch.zeros_like(tmp)
    Mk = torch.stack([sqrt_det / tmp, zero, zero], -1)
    Mj = torch.stack([-inv_sqrt_Sii * (S_ki * S_ji - S_kj * S_ii) / tmp,
                      inv_sqrt_Sii * tmp, zero], -1)
    Mi = torch.stack([inv_sqrt_Sii * S_ki, inv_sqrt_Sii * S_ji,
                      inv_sqrt_Sii * S_ii], -1)
    # a uniform point on the visible hemisphere
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * np.pi * u2[..., 1]
    uu = r * torch.cos(phi)
    vv = r * torch.sin(phi)
    ww = torch.sqrt(torch.clamp(1.0 - uu * uu - vv * vv, min=0.0))
    wm_kji = _unit(uu[..., None] * Mk + vv[..., None] * Mj
                   + ww[..., None] * Mi)
    wm = (wm_kji[..., 0:1] * wk + wm_kji[..., 1:2] * wj
          + wm_kji[..., 2:3] * wi)
    d_out = 2.0 * dot(wi, wm)[..., None] * wm - wi
    return d_out, sggx_eval(pp, d_in, d_out)


def phase_value_pdf(pp, d_in, d_out):
    """(phase_eval, phase_pdf) of the same directions, their shared parts
    computed once (HG and Rayleigh sample their own value)."""
    kinds = pp.kinds
    ct = dot(d_in, d_out)
    fiber = kinds & {"kkay", "microflake"}
    val = pdf = phase_eval_pdf(torch.where(pp.g > 2.5, 0.0, pp.g) if fiber
                               else pp.g, ct, kinds)
    if "kkay" in kinds:
        kk = pp.g > 2.5
        val = torch.where(kk, kkay_eval(pp, d_in, d_out), val)
        pdf = torch.where(kk, INV_4PI, pdf)
    if "microflake" in kinds:
        mf = pp.g > 4.5
        s = sggx_eval(pp, d_in, d_out)
        val, pdf = torch.where(mf, s, val), torch.where(mf, s, pdf)
    return val, pdf


def phase_eval(pp, d_in, d_out):
    """Phase value with per-lane kind dispatch."""
    return phase_value_pdf(pp, d_in, d_out)[0]


def phase_pdf(pp, d_in, d_out):
    """Sampling pdf of phase_sample_full (Kajiya-Kay samples the uniform
    sphere, kkay.cpp pdf(); SGGX samples itself)."""
    return phase_value_pdf(pp, d_in, d_out)[1]


def phase_sample_full(pp, d_in, u2):
    """(d_out, pdf, weight): HG and Rayleigh sample their own density
    (weight 1); Kajiya-Kay samples the uniform sphere with weight eval *
    4 pi (kkay.cpp sample); SGGX samples its visible normals (weight
    1)."""
    kinds = pp.kinds
    fiber = kinds & {"kkay", "microflake"}
    kk = pp.g > 2.5
    d_out, pdf = phase_sample(torch.where(kk, 0.0, pp.g) if fiber else pp.g,
                              d_in, u2, kinds)
    w = torch.ones_like(pdf)
    if "kkay" in kinds:
        ct = 1.0 - 2.0 * u2[..., 0]
        d_uni = _dir_around(d_in, ct, 2.0 * np.pi * u2[..., 1])
        uni = kk & ~(pp.g > 4.5)
        d_out = torch.where(uni[..., None], d_uni, d_out)
        pdf = torch.where(uni, INV_4PI, pdf)
        w = torch.where(uni, kkay_eval(pp, d_in, d_out) * (4.0 * np.pi), w)
    if "microflake" in kinds:
        mf = pp.g > 4.5
        d_sggx, pdf_sggx = sggx_sample(pp, d_in, u2)
        d_out = torch.where(mf[..., None], d_sggx, d_out)
        pdf = torch.where(mf, pdf_sggx, pdf)
    return d_out, pdf, w

"""Dipole subsurface scattering (counterpart of ppg_tpu/subsurface.py;
the reference's src/subsurface/dipole.cpp with irrtree/irrproc): Jensen
et al.'s classical dipole diffusion of multiple scattering.

The host part (numpy, bit for bit with ppg_tpu from the same
np.random.default_rng seed) blue-noise samples each dipole shape's
surface (`blue_noise_points`, white noise above a 16 x n_points cap),
pads each shape's points with repeats to a multiple of PT_BLOCK, and
`build_subsurface` precomputes the irradiance at every point with one
cosine-hemisphere render through the port's trace_paths. At render time
`lo_sub` gives each lane's exitance as a dense sum over every sample
point of its shape:

  dr = sqrt(r^2 + zr^2), dv = sqrt(r^2 + zv^2)
  dMo = 1/4pi [ zr (sigma_tr + 1/dr) e^{-sigma_tr dr} / dr^2
              + zv (sigma_tr + 1/dv) e^{-sigma_tr dv} / dv^2 ]
  Lo = (1/pi) (sum dMo E_i A_i) (1 - F_dr,ext(cos_o, eta))

(IsotropicDipoleQuery, dipole.cpp:41-58; Lo(), :336). `lo_sub_plain` is
the specification: ppg_tpu's gate (ss_id >= 0 and cos_o > 0), another
owner's term a selected +0, each PT_BLOCK tile's terms added in point
order from +0 and each tile's sum added to the lane's total in tile
order, every product by a Python constant as ATen computes it (a product
by the float32 constant). On CUDA tensors `lo_sub` launches K12
(csrc/subsurface.cu, --fmad=false, one launch a call, a workspace made
once a device), which gives that order's bits; on CPU tensors it runs
the plain version.
Nothing falls back: a failed build or launch raises. COUNTS:
"dipole_lo" counts K12's launches, "dipole_plain_on_cuda" plain calls on
CUDA tensors (`reset_counts` zeroes them).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .bsdf.fresnel import fresnel_dielectric_ext, fresnel_diffuse_reflectance
from .native import CSRC, load_cuda, raw_stream

PT_BLOCK = 256  # the sample points' tile
MIXED = -(1 << 31)  # tile_owners' mark of a tile with points of two owners
INV_4PI = 1.0 / (4.0 * np.pi)
INV_PI = 1.0 / np.pi
# lanes a plain call computes at once: bounds its [lanes, PT_BLOCK]
# intermediates on a card (no value's order depends on it)
PLAIN_LANES = 1 << 14

COUNTS = {"dipole_lo": 0, "dipole_plain_on_cuda": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def owner_tiles(pt_ss, S):
    """[S, 2] int32: each owner's first tile and one past its last tile
    holding a point of it ((0, 0) for an owner without points). Raises
    ValueError unless the point count is a multiple of PT_BLOCK and every
    owner is -1 or in [0, S)."""
    pt_ss = np.asarray(pt_ss)
    P = pt_ss.shape[0]
    if P == 0 or P % PT_BLOCK or ((pt_ss < -1) | (pt_ss >= S)).any():
        raise ValueError(f"SubsurfArrays: want a positive multiple of "
                         f"{PT_BLOCK} points owned by -1 or [0, {S}); got "
                         f"{P} points, owners {np.unique(pt_ss)[:8]}")
    tiles = np.zeros((S, 2), np.int32)
    for s in range(S):
        idx = np.flatnonzero(pt_ss == s)
        if len(idx):
            tiles[s] = idx[0] // PT_BLOCK, idx[-1] // PT_BLOCK + 1
    return tiles


def tile_owners(pt_ss):
    """[P / PT_BLOCK] int32: the owner of every point of each tile (-1
    where no point of the tile has one), or MIXED where the tile's points
    have more than one owner."""
    t = np.asarray(pt_ss, np.int32).reshape(-1, PT_BLOCK)
    return np.where((t == t[:, :1]).all(1), t[:, 0], MIXED).astype(np.int32)


def tile_aligned(pt_ss):
    """Whether every owner's points are one contiguous run that starts at
    a tile boundary and fills whole tiles (as build_subsurface pads
    them)."""
    pt_ss = np.asarray(pt_ss)
    for s in np.unique(pt_ss[pt_ss >= 0]):
        idx = np.flatnonzero(pt_ss == s)
        if (idx[0] % PT_BLOCK or len(idx) % PT_BLOCK
                or idx[-1] - idx[0] + 1 != len(idx)):
            return False
    return True


class SubsurfArrays:
    """Per-subsurface dipole constants and the shared sample points, as
    ppg_tpu's, on one device.

    params [S, 12]: zr(3) zv(3) sigma_tr(3) eta pad pad
    pts [P, 3] sample positions;  E [P, 3] irradiance;  area [P];
    pt_ss [P] int32 owning subsurface id (-1: none);  tri_ss [T] int32
    per packed triangle. Built from them once, for K12: `tiles` [S, 2]
    int32 (owner_tiles) bounds the tiles that hold each owner's points,
    `tile_owner` [P / PT_BLOCK] int32 (tile_owners) names each tile's one
    owner, `pt_row` [P, 4] float32 holds each point's x, y, z and its
    owner's int32 bits, and `ea_row` [P, 4] float32 its E * area per
    channel (the plain version's product) and 0.
    """

    FIELDS = ("params", "pts", "E", "area", "pt_ss", "tri_ss")

    def __init__(self, params, pts, E, area, pt_ss, tri_ss, num=0):
        self.params = params
        self.pts = pts
        self.E = E
        self.area = area
        self.pt_ss = pt_ss
        self.tri_ss = tri_ss
        self.num = num
        owners = pt_ss.cpu().numpy()
        self.tiles = torch.from_numpy(owner_tiles(
            owners, params.shape[0])).to(params.device)
        self.tile_owner = torch.from_numpy(tile_owners(owners)).to(
            params.device)
        self.pt_row = torch.cat([pts, pt_ss.view(torch.float32)[:, None]],
                                1).contiguous()
        self.ea_row = torch.cat([E * area[:, None], torch.zeros_like(area)[
            :, None]], 1).contiguous()

    @classmethod
    def empty(cls, device):
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        m1 = lambda n: torch.full((n,), -1, dtype=torch.int32, device=device)
        return cls(z(1, 12), z(PT_BLOCK, 3), z(PT_BLOCK, 3), z(PT_BLOCK),
                   m1(PT_BLOCK), m1(1), num=0)


def dipole_params(row):
    """Host: one subsurface spec dict -> the 12-float param row."""
    ss = np.asarray(row["sigma_s"], np.float64)
    sa = np.asarray(row["sigma_a"], np.float64)
    g = float(row["g"])
    eta = float(row["eta"])
    ssp = ss * (1.0 - g)
    stp = ssp + sa
    mfp = 1.0 / np.maximum(stp, 1e-12)
    fdr = float(fresnel_diffuse_reflectance(1.0 / eta))
    A = (1 + fdr) / (1 - fdr)
    sigma_tr = np.sqrt(3.0 * sa * stp)
    zr = mfp
    zv = mfp * (1.0 + 4.0 / 3.0 * A)
    out = np.zeros(12, np.float32)
    out[0:3] = zr
    out[3:6] = zv
    out[6:9] = sigma_tr
    out[9] = eta
    return out


def _white_noise_on_tris(positions, faces, tri_ids, n_points, rng):
    """Area-weighted uniform points on the given triangles. Returns
    (pts [N,3], pick [N] local tri index, total_area)."""
    v = positions[faces[tri_ids]]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = areas.sum()
    pdf = areas / max(total, 1e-30)
    pick = rng.choice(len(tri_ids), size=n_points, p=pdf)
    u = rng.random((n_points, 2))
    su = np.sqrt(u[:, 0])
    b1 = 1.0 - su
    b2 = u[:, 1] * su
    pts = (v[pick, 0] + e1[pick] * b1[:, None] + e2[pick] * b2[:, None])
    return pts, pick, float(total)


def sample_surface_points(positions, faces, tri_ids, n_points, rng):
    """Host: area-weighted random points on the given triangles (the
    white-noise sampler; per-point area = total/N). Returns (pts [N,3],
    area [N])."""
    pts, _, total = _white_noise_on_tris(positions, faces, tri_ids,
                                         n_points, rng)
    return pts, np.full(n_points, total / n_points, np.float32)


def blue_noise_points(positions, faces, tri_ids, radius, rng, kmax=8):
    """Host: Poisson-disk surface point set (bluenoise.cpp
    blueNoisePointSet's cell and phase-group dart throwing, vectorised
    over numpy). Dense white noise (15 SA / (pi r^2) candidates) hashes
    into cells of width r / sqrt(3); cells are processed in 27
    interleaved phase groups (same-group cells are more than r apart), a
    group's non-conflicting candidates committed in one batch, kmax
    candidate trials per cell against a 5x5x5-neighbour conflict test
    (bluenoise.cpp:209-258). Returns (pts [P,3], tri [P] local triangle
    index of each point, total_area)."""
    # candidate count: 15 * SA / (pi r^2)  (bluenoise.cpp:103)
    _, _, total = _white_noise_on_tris(positions, faces, tri_ids, 1, rng)
    n_samples = int(np.ceil(15.0 * total / (np.pi * radius * radius)))
    n_samples = max(n_samples, 16)
    pts, tri, total = _white_noise_on_tris(
        positions, faces, tri_ids, n_samples, rng)

    cell_w = radius / np.sqrt(3.0)
    lo = pts.min(axis=0)
    ext = pts.max(axis=0) - lo
    cnt = np.maximum(1, np.ceil(ext / cell_w).astype(np.int64))
    idx = np.minimum((pts - lo) / cell_w, cnt - 1).astype(np.int64)
    idx = np.maximum(idx, 0)
    cell_id = idx[:, 0] + cnt[0] * (idx[:, 1] + idx[:, 2] * cnt[1])

    order = np.argsort(cell_id, kind="stable")
    pts, tri, cell_id, idx = pts[order], tri[order], cell_id[order], idx[order]
    uniq, first = np.unique(cell_id, return_index=True)
    # phase group of each unique cell (bluenoise.cpp:191-198)
    ux, uy, uz = idx[first, 0], idx[first, 1], idx[first, 2]
    phase = (ux % 3 + (uy % 3) * 3 + (uz % 3) * 9).astype(np.int64)

    # accepted sample per unique cell (-1 = none yet)
    chosen = np.full(len(uniq), -1, np.int64)
    # neighbour cellID offsets, 5x5x5 (bailout loop :230-251)
    dzyx = np.array([(x + cnt[0] * (y + z * cnt[1]))
                     for z in range(-2, 3) for y in range(-2, 3)
                     for x in range(-2, 3)], np.int64)
    r2 = radius * radius
    for trial in range(kmax):
        for ph in range(27):
            cand_cells = np.nonzero((phase == ph) & (chosen < 0))[0]
            if len(cand_cells) == 0:
                continue
            ai = first[cand_cells] + trial  # candidate sample index
            ok = (ai < len(cell_id)) & (cell_id[np.minimum(
                ai, len(cell_id) - 1)] == uniq[cand_cells])
            cand_cells, ai = cand_cells[ok], ai[ok]
            if len(cand_cells) == 0:
                continue
            acc_cells = np.nonzero(chosen >= 0)[0]
            if len(acc_cells):
                acc_ids = uniq[acc_cells]          # sorted (uniq is sorted)
                acc_pts = pts[chosen[acc_cells]]
                nb = uniq[cand_cells][:, None] + dzyx[None, :]  # [M,125]
                pos = np.searchsorted(acc_ids, nb)
                pos = np.minimum(pos, len(acc_ids) - 1)
                hit = acc_ids[pos] == nb
                d2 = np.sum((pts[ai][:, None, :] - acc_pts[pos]) ** 2, -1)
                conflict = np.any(hit & (d2 < r2), axis=1)
            else:
                conflict = np.zeros(len(cand_cells), bool)
            take = ~conflict
            chosen[cand_cells[take]] = ai[take]
    sel = chosen[chosen >= 0]
    return pts[sel], tri[sel], total


# ---------------------------------------------------------------------------
# the exitance sum: the plain version (the specification) and K12
# ---------------------------------------------------------------------------

def _exitance(ss, sid_raw, p, cos_o):
    """lo_sub_plain's values on gated-in lanes (ss_id >= 0, cos_o > 0)."""
    S = ss.params.shape[0]
    prm = ss.params[torch.clamp(sid_raw, 0, S - 1).long()]
    zr, zv, st, eta = prm[:, 0:3], prm[:, 3:6], prm[:, 6:9], prm[:, 9]
    zr2, zv2, nst = zr * zr, zv * zv, -st
    n = p.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=p.device)
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    for b in range(ss.pts.shape[0] // PT_BLOCK):
        sl = slice(b * PT_BLOCK, (b + 1) * PT_BLOCK)
        q = ss.pts[sl]
        eb = ss.E[sl] * ss.area[sl][:, None]  # [B, 3] E * A
        own = ss.pt_ss[sl][None, :] == sid_raw[:, None]  # [n, B]
        dx, dy, dz = px - q[:, 0], py - q[:, 1], pz - q[:, 2]
        d2 = dx * dx + dy * dy + dz * dz
        terms = []
        for c in range(3):
            st_c, nst_c = st[:, c:c + 1], nst[:, c:c + 1]
            dr = torch.sqrt(d2 + zr2[:, c:c + 1])
            dv = torch.sqrt(d2 + zv2[:, c:c + 1])
            a = (zr[:, c:c + 1] * (st_c + 1.0 / dr) * torch.exp(nst_c * dr)
                 / (dr * dr))
            v = (zv[:, c:c + 1] * (st_c + 1.0 / dv) * torch.exp(nst_c * dv)
                 / (dv * dv))
            terms.append(torch.where(own, INV_4PI * (a + v) * eb[:, c], 0.0))
        terms = torch.stack(terms, 0)  # [3, n, B]
        # the tile's terms in point order from +0, then the tile's sum
        tile = torch.zeros((3, n), dtype=torch.float32, device=p.device)
        for k in range(PT_BLOCK):
            tile = tile + terms[:, :, k]
        acc = acc + tile.t()
    F, _ = fresnel_dielectric_ext(torch.clamp(cos_o, min=0.0), eta)
    fr = 1.0 - F
    return acc * INV_PI * torch.where(eta != 1.0, fr, 1.0)[:, None]


def lo_sub_plain(ss: SubsurfArrays, ss_id, p, cos_o):
    """Diffuse subsurface exitance per lane (dipole.cpp Lo()), the
    specification of K12. ss_id [L] int32 (-1: none), p [L,3] hit points,
    cos_o [L] = n.wo. Returns [L,3] float32: zeros outside the gate
    (ss_id >= 0 and cos_o > 0). The gated-in lanes are computed
    PLAIN_LANES at a time; each lane's value depends on its own inputs
    alone."""
    if p.is_cuda:
        COUNTS["dipole_plain_on_cuda"] += 1
    L = p.shape[0]
    out = torch.zeros((L, 3), dtype=torch.float32, device=p.device)
    lanes = ((ss_id >= 0) & (cos_o > 0.0)).nonzero()[:, 0]
    for c0 in range(0, lanes.shape[0], PLAIN_LANES):
        i = lanes[c0:c0 + PLAIN_LANES]
        out[i] = _exitance(ss, ss_id[i], p[i], cos_o[i])
    return out


def lo_sub(ss: SubsurfArrays, ss_id, p, cos_o):
    """lo_sub_plain's values; CUDA tensors launch K12 once."""
    if p.is_cuda:
        return _launch(ss, ss_id, p, cos_o)
    if p.device.type != "cpu":
        raise ValueError(f"lo_sub: tensors on {p.device}: want a CUDA "
                         f"device or the CPU")
    return lo_sub_plain(ss, ss_id, p, cos_o)


# --fmad=false: each product and sum rounded on its own, as the plain
# version's separate operations round them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_cu, _cull = ctypes.c_uint, ctypes.c_ulonglong
# params, S, tiles, pt_row, ea_row, tile_owner, P; ss_id and its stride,
# p and its strides (2), cos_o and its stride; the workspace (ctrl, queue
# and its length, part and its warps); out, L, card, stream
ARGTYPES = [_vp, _ci, _vp, _vp, _vp, _vp, _ci, _vp, _cll, _vp, _cll, _cll,
            _vp, _cll, _vp, _vp, _cll, _vp, _cll, _vp, _cll, _ci, _vp]
# the card, a pointer to the int that takes the grid's blocks
GRID_ARGTYPES = [_ci, _vp]
# lo and hi bits, pairs, seed, counts, card, stream
CHECK_ARGTYPES = [_cu, _cu, _cll, _cull, _vp, _ci, _vp]
# csrc/subsurface.cu's ints a warp's totals take, the block's warps and
# the control ints (the epoch, the arrivals, 4 for each parity)
SLOT, WARPS, CTRL_INTS = 128, 8, 10
# the floats x = d2 + z^2 the kernel's derived square root and
# reciprocals take (csrc/subsurface.cu's guard): [2^-40, 2^40)
X_RANGE_BITS = (0x2b800000, 0x53800000)
CHECK_COUNTS = ("values", "sqrt_differ", "rcp_dr_differ", "rcp_dd_differ",
                "guarded_out", "quotients", "quotients_differ",
                "quotients_guarded_out")
_lib = None
_workspaces = {}


def build():
    """Compile csrc/subsurface.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    _lib = load_cuda(os.path.join(CSRC, "subsurface.cu"), "libppgdipole",
                     NVCC_FLAGS, {"ppg_dipole_lo": ARGTYPES,
                                  "ppg_dipole_grid": GRID_ARGTYPES,
                                  "ppg_dipole_check": CHECK_ARGTYPES})
    return _lib


def kernel_args(ss, ss_id, p, cos_o):
    """The C entry point's arguments up to the workspace; raises
    ValueError on a tensor it does not take."""
    L = p.shape[0]
    want = [("ss_id", ss_id, torch.int32, (L,)),
            ("p", p, torch.float32, (L, 3)),
            ("cos_o", cos_o, torch.float32, (L,)),
            ("params", ss.params, torch.float32, None),
            ("tiles", ss.tiles, torch.int32, None),
            ("pts", ss.pts, torch.float32, None),
            ("E", ss.E, torch.float32, None),
            ("area", ss.area, torch.float32, None),
            ("pt_ss", ss.pt_ss, torch.int32, None),
            ("pt_row", ss.pt_row, torch.float32, None),
            ("ea_row", ss.ea_row, torch.float32, None),
            ("tile_owner", ss.tile_owner, torch.int32, None)]
    bad = [f"{n} {t.dtype} {tuple(t.shape)} on {t.device}"
           for n, t, dt, shape in want
           if t.dtype != dt or (shape is not None and tuple(t.shape) != shape)
           or t.device != p.device]
    S, P = ss.params.shape[0], ss.pts.shape[0]
    table = [ss.params, ss.tiles, ss.pt_row, ss.ea_row, ss.tile_owner]
    if (bad or not all(t.is_contiguous() for t in table)
            or tuple(ss.params.shape) != (S, 12)
            or tuple(ss.tiles.shape) != (S, 2)
            or tuple(ss.pts.shape) != (P, 3) or tuple(ss.E.shape) != (P, 3)
            or tuple(ss.area.shape) != (P,) or tuple(ss.pt_ss.shape) != (P,)
            or tuple(ss.pt_row.shape) != (P, 4)
            or tuple(ss.ea_row.shape) != (P, 4)
            or tuple(ss.tile_owner.shape) != (P // PT_BLOCK,)
            or P % PT_BLOCK or not 0 < P < 1 << 30):
        raise ValueError(
            f"ppg_dipole_lo: want ss_id int32 ({L},), p float32 ({L}, 3), "
            f"cos_o float32 ({L},), contiguous params float32 [S, 12], "
            f"tiles int32 [S, 2], pts and E float32 [P, 3], area float32 "
            f"[P], pt_ss int32 [P], pt_row and ea_row float32 [P, 4] and "
            f"tile_owner int32 [P / {PT_BLOCK}], P a positive multiple of "
            f"{PT_BLOCK}, all on {p.device}; got " + "; ".join(
                bad + [f"params {tuple(ss.params.shape)}, tiles "
                       f"{tuple(ss.tiles.shape)}, pts {tuple(ss.pts.shape)}"]))
    return [ss.params.data_ptr(), S, ss.tiles.data_ptr(),
            ss.pt_row.data_ptr(), ss.ea_row.data_ptr(),
            ss.tile_owner.data_ptr(), P, ss_id.data_ptr(), ss_id.stride(0),
            p.data_ptr(), p.stride(0), p.stride(1), cos_o.data_ptr(),
            cos_o.stride(0)]


def workspace_args(lib, device, L):
    """K12's workspace on `device` for L lanes, as the C entry point takes
    it (ctrl, queue and its length, part and its warps): made once a
    device (the control counters and the warps' flags zeroed then, never
    again: the kernel moves an epoch on the card) and the queue grown to
    the largest L asked for. One call at a time a device: the calls of a
    device go on one stream."""
    key = (id(lib), str(device))
    ws = _workspaces.get(key)
    if ws is None:
        blocks = ctypes.c_int(0)
        err = lib.ppg_dipole_grid(device.index or 0, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"ppg_dipole_grid failed: cudaError {err}")
        warps = blocks.value * WARPS
        ws = _workspaces[key] = dict(
            ctrl=torch.zeros(CTRL_INTS, dtype=torch.int32, device=device),
            part=torch.zeros(warps * SLOT, dtype=torch.int32, device=device),
            queue=torch.empty(0, dtype=torch.int32, device=device),
            warps=warps)
    if ws["queue"].numel() < L:
        ws["queue"] = torch.empty(L, dtype=torch.int32, device=device)
    return [ws["ctrl"].data_ptr(), ws["queue"].data_ptr(),
            ws["queue"].numel(), ws["part"].data_ptr(), ws["warps"]]


def _launch(ss, ss_id, p, cos_o):
    """K12 on p's card: lo_sub_plain's [L, 3]. Adds one to
    COUNTS["dipole_lo"]."""
    args = kernel_args(ss, ss_id, p, cos_o)
    L, card = p.shape[0], p.get_device()
    out = torch.empty((L, 3), dtype=torch.float32, device=p.device)
    lib = _lib or build()
    ws = workspace_args(lib, p.device, L)
    err = lib.ppg_dipole_lo(*args, *ws, out.data_ptr(), L, card,
                            raw_stream(card))
    if err != 0:
        raise RuntimeError(f"ppg_dipole_lo launch failed: cudaError {err}")
    COUNTS["dipole_lo"] += 1
    return out


def check_derived(lib, device, lo_bits, hi_bits, pairs, seed=0):
    """Runs csrc/subsurface.cu's check of the kernel's derived square root
    and reciprocals (every float x with bits in [lo_bits, hi_bits)) and of
    its quotient (`pairs` drawn pairs) against the IEEE operations, on
    `device` through `lib` (the card's build, or a host build). Returns
    dict(CHECK_COUNTS -> count)."""
    counts = torch.zeros(8, dtype=torch.int64, device=device)
    card = device.index or 0
    stream = raw_stream(card) if device.type == "cuda" else None
    err = lib.ppg_dipole_check(lo_bits, hi_bits, pairs, seed,
                               counts.data_ptr(), card, stream)
    if err != 0:
        raise RuntimeError(f"ppg_dipole_check failed: cudaError {err}")
    return dict(zip(CHECK_COUNTS, counts.cpu().tolist()))


# ---------------------------------------------------------------------------
# the point cloud and its irradiance
# ---------------------------------------------------------------------------

IRR_CHUNK = 1 << 16  # lanes of one irradiance wavefront


def build_subsurface(sc, dev, n_points=2048, seed=17):
    """The irradiance point cloud of every dipole of the scene, as
    SubsurfArrays on dev's device (the irrproc/irrtree stage of the
    reference, as ppg_tpu computes it): the points and areas bit for bit
    with ppg_tpu's from np.random.default_rng(seed), each dipole's points
    padded with repeats to whole tiles; the irradiance E = pi * mean(Li)
    over cosine-hemisphere rays around each point's face normal, traced
    by the port's trace_paths in wavefronts of IRR_CHUNK lanes from a
    torch.Generator on the device seeded from `seed` (so a scene's cloud
    is the same whenever it is built). As in ppg_tpu, the last dipole
    row's irr_samples serve every row, and the render of the irradiance
    has no subsurface of either kind. Single-scattering rows keep their
    slot in params (zeros) and their triangles are -1 in tri_ss."""
    from .core.vecmath import build_frame
    from .core import warp
    from .device import generator, rand
    from .integrators.driver import make_config
    from .integrators.wavefront import trace_paths

    device = dev.shade.device
    rng = np.random.default_rng(seed)
    rows, all_pts, all_area, all_ss, all_nrm = [], [], [], [], []
    irr_samples = 16
    single_mask = np.zeros(len(sc.subsurfaces), bool)
    for i, row in enumerate(sc.subsurfaces):
        if row.get("kind", "dipole") != "dipole":
            rows.append(np.zeros(12, np.float32))
            single_mask[i] = True
            continue
        rows.append(dipole_params(row))
        tri_ids = np.arange(row["tri_start"],
                            row["tri_start"] + row["n_tris"])
        v = sc.positions[sc.faces[tri_ids]]
        fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        # the Poisson radius (dipole.cpp:394): the diffusion mfp shrunk by
        # sampleMultiplier; white noise where the set would exceed the cap
        mfp_min = float(np.min(
            1.0 / np.maximum(np.asarray(row["sigma_s"]) * (1 - row["g"])
                             + np.asarray(row["sigma_a"]), 1e-12)))
        radius = mfp_min / np.sqrt(row.get("sample_mult", 1.0) * 20.0)
        sa_est = float(np.sum(0.5 * np.linalg.norm(
            np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)))
        # about 2 points per pi r^2 of area at Poisson saturation
        est_accept = 2.0 * sa_est / (np.pi * radius * radius)
        cap = int(n_points * 16)
        if est_accept > cap:
            n_i = int(n_points * row.get("sample_mult", 1.0))
            n_i = max(PT_BLOCK, (n_i // PT_BLOCK) * PT_BLOCK)
            pts, pick, total = _white_noise_on_tris(
                sc.positions, sc.faces, tri_ids, n_i, rng)
            area = np.full(n_i, total / n_i, np.float32)
            nrm_i = fn[pick]
        else:
            pts, tri_of, total = blue_noise_points(
                sc.positions, sc.faces, tri_ids, radius, rng)
            # whole tiles by repeats (the area rescales, so the padded sum
            # is unchanged)
            P_i = len(pts)
            n_i = max(PT_BLOCK,
                      ((P_i + PT_BLOCK - 1) // PT_BLOCK) * PT_BLOCK)
            rep = rng.integers(0, P_i, n_i - P_i)
            pts = np.concatenate([pts, pts[rep]])
            tri_of = np.concatenate([tri_of, tri_of[rep]])
            area = np.full(n_i, total / n_i, np.float32)
            nrm_i = fn[tri_of]
        all_pts.append(pts)
        all_area.append(area)
        all_nrm.append(nrm_i)
        all_ss.append(np.full(len(pts), i, np.int32))
        irr_samples = row["irr_samples"]

    pts = np.concatenate(all_pts).astype(np.float32)
    area = np.concatenate(all_area)
    pt_ss = np.concatenate(all_ss)
    nrm = np.concatenate(all_nrm).astype(np.float32)
    assert tile_aligned(pt_ss), "each dipole's points fill whole tiles"
    P = len(pts)

    # irradiance: E = pi * mean(Li) over cosine-sampled directions
    cfg = make_config(sc, guiding=False, record_vertices=False,
                      has_subsurf=False, has_sss=False)
    S = irr_samples
    gen = generator(seed, device)
    E = torch.zeros((P, 3), dtype=torch.float32, device=device)
    chunk = max(1, IRR_CHUNK // S)
    pts_t = torch.from_numpy(pts).to(device)
    nrm_t = torch.from_numpy(nrm).to(device)
    for c0 in range(0, P, chunk):
        c1 = min(c0 + chunk, P)
        o_rep = pts_t[c0:c1].repeat_interleave(S, 0)
        n_rep = nrm_t[c0:c1].repeat_interleave(S, 0)
        n = o_rep.shape[0]
        d_loc = warp.square_to_cosine_hemisphere(rand(gen, n, 2))
        s_ax, t_ax = build_frame(n_rep)
        d = (s_ax * d_loc[:, 0:1] + t_ax * d_loc[:, 1:2]
             + n_rep * d_loc[:, 2:3])
        o = o_rep + n_rep * dev.eps
        li = trace_paths(dev, cfg, gen, o, d,
                         torch.zeros(n, dtype=torch.float32, device=device),
                         torch.full((n,), 3.4e38, dtype=torch.float32,
                                    device=device))["li"]
        E[c0:c1] = np.pi * li.reshape(c1 - c0, S, 3).mean(1)

    perm = dev.geom.perm.cpu().numpy()
    tri_ss = (sc.tri_subsurf[perm] if len(perm)
              else np.zeros(1, np.int32))
    if single_mask.any():
        tri_ss = np.where((tri_ss >= 0) & single_mask[
            np.maximum(tri_ss, 0)], -1, tri_ss)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device, dt)
    return SubsurfArrays(
        t(np.stack(rows), torch.float32), pts_t, E,
        t(area.astype(np.float32), torch.float32), t(pt_ss, torch.int32),
        t(tri_ss.astype(np.int32), torch.int32), num=len(rows))

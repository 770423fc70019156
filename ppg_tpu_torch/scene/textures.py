"""Bitmap and procedural textures (counterpart of
ppg_tpu/scene/textures.py): the host decoders, the MIP atlas and its
lookups, the camera's uv differentials, bump and normal maps, and the
wireframe texture.

The atlas (`TextureAtlas.build`, numpy, then tensors on an explicit
device) packs every texture's full MIP pyramid into one [P, 12] float16
table, each row a texel with its right, down and diagonal neighbours
repeat-wrapped, so that a bilinear tap is one row load; meta [N, 3]
(offset, W, H), mip_meta [N * 13, 3] (each level past a texture's 1x1 top
repeats it), uvx [N, 4] (uscale, vscale, uoffset, voffset), filt [N, 2]
(filterType code, maxAnisotropy), vcflag [N] (a vertexcolors or
curvature slot) and wfp [N, 8] (wireframe parameters). Slot 0 is a 1x1
white dummy; material rows store a spec index, and a lookup takes it
plus one (<= 0: white). The arrays are ppg_tpu's, bit for bit.

`sample_atlas` launches K9 (csrc/textures.cu; see its note) on
CUDA tensors and runs `sample_atlas_plain` on CPU tensors: base level
bilinear, or with a footprint the isotropic trilinear lookup, or with
the uv Jacobian each texture's filterType (ewa: 4 trilinear taps along
the ellipse's major axis at the minor axis's level, weights exp(-2 t^2);
trilinear, bilinear, nearest), as ppg_tpu's sample_atlas and
_sample_ewa. One call serves a stacked set of lookups: tex_id [N] with
uv and the differentials [M, 2], N a multiple of M, lookup i at lane
i % M, so one launch serves every textured row of a shading site.
`bump_lookups` makes perturb_normal's h0, hu and hv taps (its normal-map
tap repeats h0's) as one such call.

The plain version is the kernel's specification, written so that a
card's ATen repeats it: each operation as ppg_tpu writes it, sums of two
terms spelled out, the float-to-int conversions saturating with NaN to 0
as XLA's (and the card's cvt.rmi) do, the EWA taps' quotient by their
summed weight as a product by its float32 reciprocal (what ATen does on a
card with a Python-float divisor). K9 leaves unread the rows a value
does not depend on (`_level_one_unread`, with the atlas's `tap_safe`
flags); `lookup_classes` says what each lookup reads. COUNTS:
"atlas_kernel" counts K9 launches, "atlas_plain_on_cuda" plain lookups
run on CUDA tensors (`reset_counts` zeroes them).

8-bit PNG/JPG sources are converted sRGB -> linear exactly as
Bitmap::setGamma/fromLinearRGB does for gamma=-1 (srgb); they need PIL,
EXR and procedural textures do not.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

COUNTS = {"atlas_kernel": 0, "atlas_plain_on_cuda": 0}

LMAX = 13  # MIP levels a slot's mip_meta holds
# filterType codes (src/textures/bitmap.cpp:213-229; default ewa)
F_EWA, F_TRILINEAR, F_BILINEAR, F_NEAREST = 0.0, 1.0, 2.0, 3.0
# lookup modes of K9 (and the plain version)
BASE, FOOT, DUV, BUMP = 0, 1, 2, 3
TAPS = 4
_I32_MAX = 2147483647


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _srgb_to_linear(x):
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def rasterize_procedural(otype, p, res=128):
    """checkerboard.cpp: 2x2 tiles of color0/color1 per uv unit;
    gridtexture.cpp: color1 lines of lineWidth on a color0 field."""
    def rgb(v, default):
        if v is None:
            return np.full(3, default, np.float32)
        a = np.asarray(getattr(v, "rgb", v), np.float64).reshape(-1)
        return (np.full(3, float(a[0])) if a.size == 1 else a[:3]).astype(
            np.float32)

    c0 = rgb(p.get("color0"), 0.4)
    c1 = rgb(p.get("color1"), 0.2)
    u = (np.arange(res) + 0.5) / res
    uu, vv = np.meshgrid(u, u)
    if otype == "checkerboard":
        mask = ((uu * 2).astype(int) + (vv * 2).astype(int)) % 2 == 0
    else:
        lw = float(p.get("lineWidth", 0.01))
        fu = uu - np.floor(uu)
        fv = vv - np.floor(vv)
        mask = ~((np.minimum(fu, 1 - fu) < lw) | (np.minimum(fv, 1 - fv) < lw))
    img = np.where(mask[..., None], c0[None, None], c1[None, None])
    return img.astype(np.float32)


def load_texture(path, gamma=0.0):
    """Decode an image file to linear float32 RGB [H, W, 3]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        from ..io import exr

        img = exr.read(path)[0]
        return np.asarray(img, np.float32)[..., :3]
    from PIL import Image

    im = Image.open(path)
    arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    arr = arr[..., :3]
    if arr.dtype == np.uint8:
        x = arr.astype(np.float64) / 255.0
        if gamma == 0.0 or gamma == -1.0:  # srgb (bitmap.cpp default)
            x = _srgb_to_linear(x)
        elif gamma != 1.0:
            x = x ** gamma
        return x.astype(np.float32)
    return arr.astype(np.float32)


def _downsample2(im):
    """2x box downsample with odd-dimension truncation handling."""
    H, W = im.shape[:2]
    H2, W2 = max(H // 2, 1), max(W // 2, 1)
    im = im[:H2 * 2 if H > 1 else 1, :W2 * 2 if W > 1 else 1]
    if H > 1:
        im = 0.5 * (im[0::2] + im[1::2])
    if W > 1:
        im = 0.5 * (im[:, 0::2] + im[:, 1::2])
    return im


def _rgb3(v, d):
    a = np.asarray(getattr(v, "rgb", v if v is not None else d),
                   np.float32).reshape(-1)
    return np.full(3, a[0]) if a.size == 1 else a[:3]


def tap_safe(pixels, meta):
    """[N] int32: 1 where every texel of the slot's whole pyramid (its
    rows, from its offset in meta to the next slot's) is finite with its
    sign bit clear, else 0. A bilinear tap at such a slot's texel
    coordinates with weights in [0, 1] is then finite and +0 or more, so
    its product by a zero fraction is a zero of that fraction's sign:
    K9 skips the second level of a trilinear lookup whose fraction is 0
    there (see _level_one_unread)."""
    bits = np.ascontiguousarray(pixels).view(np.uint16)
    bad = ((bits & 0x8000) != 0) | ((bits & 0x7C00) == 0x7C00)
    per_slot = np.add.reduceat(bad.any(-1).astype(np.int64),
                               meta[:, 0].astype(np.int64))
    return (per_slot == 0).astype(np.int32)


class TextureAtlas:
    """The packed texture set as tensors on one device (see the module
    docstring); `eps` [N, 2] float32 is each slot's bump step, 1 /
    max(W, 2) and 1 / max(H, 2) of its base level, and `tap_safe` [N]
    int32 the slots whose texels are all finite and sign-clear
    (`tap_safe`; not one of ppg_tpu's arrays)."""

    FIELDS = ("pixels", "meta", "uvx", "vcflag", "wfp", "mip_meta", "filt")

    def __init__(self, arrays, device):
        for f in self.FIELDS:
            setattr(self, f, torch.from_numpy(np.ascontiguousarray(
                arrays[f])).to(device))
        wh = np.maximum(arrays["meta"][:, 1:3].astype(np.float32),
                        np.float32(2.0))
        self.eps = torch.from_numpy(np.float32(1.0) / wh).to(device)
        self.n_slots = int(arrays["meta"].shape[0])
        self.tap_safe = torch.from_numpy(
            tap_safe(arrays["pixels"], arrays["meta"])).to(device)

    @staticmethod
    def build_arrays(specs, scene_dir):
        """ppg_tpu's TextureAtlas.build as numpy: specs is a list of
        texture Properties dicts ({_otype, filename, gamma, uscale, vscale,
        uoffset, voffset, color0/color1/lineWidth, filterType,
        maxAnisotropy, ...}). Returns {field: array}; pixels float16."""
        imgs = [np.ones((1, 1, 3), np.float32)]  # dummy slot 0
        uvx = [np.array([1.0, 1.0, 0.0, 0.0], np.float32)]

        def build_one(p):
            """One spec -> (linear image, uv transform); `scale` wrappers
            (src/textures/scale.cpp) multiply the nested texture's pixels
            at build time."""
            otype = p.get("_otype", "bitmap")
            x4 = np.array([
                float(p.get("uscale", 1.0)), float(p.get("vscale", 1.0)),
                float(p.get("uoffset", 0.0)), float(p.get("voffset", 0.0)),
            ], np.float32)
            if otype == "scale":
                nested = None
                for c in p.get("_children", ()):
                    if getattr(c, "cls", None) == "texture":
                        nested = c
                if nested is None:
                    raise ValueError("scale texture: missing nested texture")
                img, x4 = build_one(dict(nested.props, _otype=nested.otype,
                                         _children=nested.children))
                s = p.get("scale", 1.0)
                s = np.asarray(getattr(s, "rgb", s), np.float32).reshape(-1)
                return img * (np.full(3, s[0]) if s.size == 1 else s[:3]), x4
            if otype in ("checkerboard", "gridtexture"):
                return rasterize_procedural(otype, p), x4
            fn = p.get("filename", "")
            path = fn if os.path.isabs(fn) else os.path.join(scene_dir, fn)
            return load_texture(path, float(p.get("gamma", 0.0))), x4

        for p in specs:
            if p.get("_otype") in ("vertexcolors", "curvature", "wireframe"):
                # read lane-side; a white placeholder keeps the slots aligned
                imgs.append(np.ones((1, 1, 3), np.float32))
                uvx.append(np.array([1, 1, 0, 0], np.float32))
                continue
            img, x4 = build_one(p)
            imgs.append(img)
            uvx.append(x4)
        meta = np.zeros((len(imgs), 3), np.int32)
        mip_meta = np.zeros((len(imgs), LMAX, 3), np.int32)
        off = 0
        flats = []
        for i, im in enumerate(imgs):
            for lvl in range(LMAX):
                H, W = im.shape[:2]
                if lvl == 0:
                    meta[i] = (off, W, H)
                mip_meta[i, lvl] = (off, W, H)
                right = np.roll(im, -1, axis=1)
                flats.append(np.concatenate(
                    [im, right, np.roll(im, -1, axis=0),
                     np.roll(right, -1, axis=0)], -1).reshape(-1, 12))
                off += H * W
                if W == 1 and H == 1:
                    # the remaining levels repeat the 1x1 top
                    mip_meta[i, lvl + 1:] = mip_meta[i, lvl]
                    break
                im = _downsample2(im)
        vcflag = np.zeros(len(imgs), bool)
        wfp = np.full((len(imgs), 8), -1.0, np.float32)
        for i, p in enumerate(specs):
            if p.get("_otype") in ("vertexcolors", "curvature"):
                # curvature colours are baked into the mesh's vertex colours
                # at scene build and read through the vertexcolors path
                vcflag[i + 1] = True
            elif p.get("_otype") == "wireframe":
                wfp[i + 1, 0] = float(p.get("lineWidth", 0.0))
                wfp[i + 1, 1] = min(max(float(p.get("stepWidth", 0.5)),
                                        0.0), 1.0)
                wfp[i + 1, 2:5] = _rgb3(p.get("edgeColor"), [0.1] * 3)
                wfp[i + 1, 5:8] = _rgb3(p.get("interiorColor"), [0.5] * 3)
        # per-slot filter mode and anisotropy clamp (bitmap.cpp:213-232:
        # filterType default ewa for bitmaps, maxAnisotropy default 20;
        # procedural rasterizations default to trilinear)
        fmap = {"ewa": F_EWA, "trilinear": F_TRILINEAR,
                "bilinear": F_BILINEAR, "nearest": F_NEAREST}
        filt = np.tile(np.array([[F_TRILINEAR, 20.0]], np.float32),
                       (len(imgs), 1))
        for i, p in enumerate(specs):
            dflt = "ewa" if p.get("_otype", "bitmap") == "bitmap" \
                else "trilinear"
            filt[i + 1, 0] = fmap.get(
                str(p.get("filterType", dflt)).lower(), F_EWA)
            filt[i + 1, 1] = float(p.get("maxAnisotropy", 20.0))
        # f16's finite range: HDR sources above 65504 would become inf
        packed = np.clip(np.concatenate(flats, 0), -65504.0, 65504.0)
        return dict(pixels=packed.astype(np.float16), meta=meta,
                    uvx=np.stack(uvx), vcflag=vcflag, wfp=wfp,
                    mip_meta=mip_meta.reshape(-1, 3), filt=filt)

    @classmethod
    def build(cls, specs, scene_dir, device):
        return cls(cls.build_arrays(specs, scene_dir), device)

    @classmethod
    def empty(cls, device):
        """The untextured atlas: one white 1x1 slot."""
        return cls(dict(
            pixels=np.ones((1, 12), np.float16),
            meta=np.array([[0, 1, 1]], np.int32),
            uvx=np.array([[1.0, 1.0, 0.0, 0.0]], np.float32),
            vcflag=np.zeros(1, bool),
            wfp=np.full((1, 8), -1.0, np.float32),
            mip_meta=np.tile(np.array([[0, 1, 1]], np.int32), (LMAX, 1)),
            filt=np.array([[F_TRILINEAR, 20.0]], np.float32)), device)

    @classmethod
    def from_scene(cls, sc, device):
        """The scene's atlas (None without texture specs), with the
        wireframe's lineWidth = 0 rule of ppg_tpu's DeviceScene
        (ppg_tpu/integrators/wavefront.py:203-211): 10% of the mean edge
        length, averaged over the whole scene (the reference averages per
        mesh, wireframe.cpp:90-106)."""
        if sc.textures is None or not sc.textures.specs:
            return None
        arrays = cls.build_arrays(
            [dict(s.props, _otype=s.otype, _children=s.children)
             for s in sc.textures.specs], sc.textures.scene_xml.dir)
        wfp = arrays["wfp"]
        if np.any(wfp[:, 0] == 0.0) and len(sc.faces):
            v = sc.positions[sc.faces]
            e = np.linalg.norm(v - np.roll(v, -1, axis=1), axis=-1).mean()
            wfp[:, 0] = np.where(wfp[:, 0] == 0.0, 0.1 * e, wfp[:, 0])
        return cls(arrays, device)


# ---------------------------------------------------------------------------
# the plain lookups (the kernel's specification)
# ---------------------------------------------------------------------------

def _floor_i32(x):
    """floor(x) as int32, saturating, NaN to 0 (XLA's float-to-int
    conversion and the card's cvt.rmi.s32.f32; PyTorch's CPU cast wraps)."""
    f = torch.floor(x)
    i = torch.where(f == f, torch.clamp(f, -2147483648.0, 2147483520.0),
                    0.0).to(torch.int32)
    return torch.where(f >= 2147483648.0, _I32_MAX, i)


def _rows(atlas, idx, stats, need=None):
    """The atlas rows idx as float32; `stats` collects (idx, need), need
    None where K9 reads every row, else where it reads them."""
    if stats is not None:
        stats.append((idx, need))
    return atlas.pixels[idx].to(torch.float32)


def _texel_xy(m, x4, u_in, v_in):
    """A lookup's texel coordinates at level m = (offset, W, H) [K, 3]."""
    u = u_in * x4[:, 0] + x4[:, 2]
    v = v_in * x4[:, 1] + x4[:, 3]
    return (u * m[:, 1].to(torch.float32) - 0.5,
            v * m[:, 2].to(torch.float32) - 0.5)


def _bilinear(atlas, m, x4, u_in, v_in, stats=None, need=None):
    """Repeat-wrapped bilinear lookup at level m = (offset, W, H) [K, 3]."""
    W, H = m[:, 1], m[:, 2]
    x, y = _texel_xy(m, x4, u_in, v_in)
    x0, y0 = _floor_i32(x), _floor_i32(y)
    dx = (x - x0.to(torch.float32))[:, None]
    dy = (y - y0.to(torch.float32))[:, None]
    xi = torch.remainder(x0, W)
    yi = torch.remainder(y0, H)
    row = _rows(atlas, (m[:, 0] + yi * W + xi).long(), stats, need)
    a00, a10, a01, a11 = (row[:, 0:3], row[:, 3:6], row[:, 6:9],
                          row[:, 9:12])
    return ((a00 * (1 - dx) + a10 * dx) * (1 - dy)
            + (a01 * (1 - dx) + a11 * dx) * dy)


def _levels(atlas, tid, lod):
    """A trilinear lookup's levels' (offset, W, H) rows and its fraction."""
    l0 = _floor_i32(lod)
    frac = lod - l0.to(torch.float32)
    base = tid.long() * LMAX
    return (atlas.mip_meta[base + l0.long()],
            atlas.mip_meta[base + torch.clamp(l0 + 1, max=LMAX - 1).long()],
            frac)


def _exact_floor(x):
    """Where floor(x) is an int32 (finite, in [-2^31, 2^31)): the texel
    weight x - floor(x) is then exact and in [0, 1)."""
    f = torch.floor(x)
    return (f >= -2147483648.0) & (f < 2147483648.0)


def _level_one_unread(atlas, tid, x4, u, v, lod):
    """Where K9 does not read a trilinear lookup's second level (l1): its
    fraction is 0 (so lod is not NaN), the slot is tap_safe, and level
    l1's texel coordinates floor exactly. Its weights are then in [0, 1)
    and their complements in (0, 1], so its value vb is a sum of
    products of finite sign-clear texels by sign-clear weights: finite,
    +0 or more (a -0 weight x - floor(x) needs x = -0, which u * W - 0.5
    never gives, and a sum with one sign-clear term is sign-clear). So
    vb * frac is a zero of frac's sign, as (+0) * frac is, and the blend
    va * (1 - frac) + vb * frac keeps its bits with vb = +0."""
    _, mb, frac = _levels(atlas, tid, lod)
    x, y = _texel_xy(mb, x4, u, v)
    return ((frac == 0) & (atlas.tap_safe[tid.long()] != 0)
            & _exact_floor(x) & _exact_floor(y))


def _trilinear(atlas, tid, x4, u, v, lod, stats=None):
    """Two-level MIP blend at a per-lookup lod in [0, 12] (or NaN)."""
    ma, mb, frac = _levels(atlas, tid, lod)
    need = None if stats is None else ~_level_one_unread(
        atlas, tid, x4, u, v, lod)
    frac = frac[:, None]
    va = _bilinear(atlas, ma, x4, u, v, stats)
    vb = _bilinear(atlas, mb, x4, u, v, stats, need)
    return va * (1 - frac) + vb * frac


def tap_weights():
    """The EWA taps' offsets t, their weights exp(-2 t^2) as Python floats
    (ppg_tpu's) and the float32 reciprocal of their sum."""
    ts = [(2 * k + 1 - TAPS) / TAPS for k in range(TAPS)]
    ws = [float(np.exp(-2.0 * t * t)) for t in ts]
    wsum = 0.0
    for w in ws:
        wsum = wsum + w
    return ts, ws, float(np.float32(1.0) / np.float32(wsum))


def _ellipse(atlas, tid, x4, u, v, d0, d1):
    """filterType dispatch from the uv Jacobian (ppg_tpu's _sample_ewa,
    mipmap.h:640-713) up to the taps: (lod, u, v, off_u, off_v), uv
    snapped for nearest, the taps at uv + (off_u, off_v) * t."""
    m0 = atlas.meta[tid.long()]
    W0 = m0[:, 1].to(torch.float32)
    H0 = m0[:, 2].to(torch.float32)
    f = atlas.filt[tid.long()]
    mode = f[:, 0]
    max_aniso = torch.clamp(f[:, 1], min=1.0)
    su = x4[:, 0] * W0
    sv = x4[:, 1] * H0
    du0 = d0[:, 0] * su
    dv0 = d0[:, 1] * sv
    du1 = d1[:, 0] * su
    dv1 = d1[:, 1] * sv
    A = dv0 * dv0 + dv1 * dv1
    B = -2.0 * (du0 * dv0 + du1 * dv1)
    C = du0 * du0 + du1 * du1
    F = A * C - 0.25 * B * B
    root = torch.hypot(A - C, B)
    Ap = 0.5 * (A + C - root)
    Cp = 0.5 * (A + C + root)
    Fp = torch.clamp(F, min=0.0)
    major = torch.sqrt(Fp / torch.clamp(Ap, min=1e-20))
    minor = torch.sqrt(Fp / torch.clamp(Cp, min=1e-20))
    is_ewa = (mode == F_EWA) & (F > 0) & (minor > 0) & (major > 0)
    minor_c = torch.maximum(minor, major / max_aniso)
    lod_tri = torch.log2(torch.clamp(major, min=1e-9))
    lod_ewa = torch.log2(torch.clamp(minor_c, min=1e-9))
    lod = torch.where(is_ewa, lod_ewa, lod_tri)
    lod = torch.where(mode >= F_BILINEAR, 0.0, lod)
    lod = torch.clamp(lod, 0.0, LMAX - 1.0)

    # nearest: snap uv to the base-level texel centre
    ut = u * x4[:, 0] + x4[:, 2]
    vt = v * x4[:, 1] + x4[:, 3]
    un = ((torch.floor(ut * W0) + 0.5) / W0 - x4[:, 2]) \
        / torch.where(x4[:, 0] == 0, 1.0, x4[:, 0])
    vn = ((torch.floor(vt * H0) + 0.5) / H0 - x4[:, 3]) \
        / torch.where(x4[:, 1] == 0, 1.0, x4[:, 1])
    nearest = mode == F_NEAREST
    u = torch.where(nearest, un, u)
    v = torch.where(nearest, vn, v)

    # the major axis: the eigenvector of [[A, B/2], [B/2, C]] for Ap, of
    # two forms the better conditioned
    v1x, v1y = 0.5 * B, Ap - A
    v2x, v2y = Ap - C, 0.5 * B
    pick = (v1x * v1x + v1y * v1y) >= (v2x * v2x + v2y * v2y)
    axx = torch.where(pick, v1x, v2x)
    axy = torch.where(pick, v1y, v2y)
    nrm = torch.sqrt(axx * axx + axy * axy)
    big = nrm > 1e-20
    nrm_c = torch.clamp(nrm, min=1e-20)
    axx = torch.where(big, axx / nrm_c, 1.0)
    axy = torch.where(big, axy / nrm_c, 0.0)
    # the probes cover the major radius beyond one isotropic probe's; all
    # coincide on the other modes' lookups
    ext = torch.where(is_ewa, torch.clamp(major - minor_c, min=0.0), 0.0)
    off_u = axx * ext / torch.clamp(su, min=1e-20)
    off_v = axy * ext / torch.clamp(sv, min=1e-20)
    return lod, u, v, off_u, off_v


def _sample_ewa(atlas, tid, x4, u, v, d0, d1, stats=None):
    """filterType dispatch from the uv Jacobian (ppg_tpu's _sample_ewa):
    _ellipse, then the 4 taps' weighted sum."""
    lod, u, v, off_u, off_v = _ellipse(atlas, tid, x4, u, v, d0, d1)
    ts, ws, inv_wsum = tap_weights()
    acc = 0.0
    for t, w in zip(ts, ws):
        acc = acc + w * _trilinear(atlas, tid, x4, u + off_u * t,
                                   v + off_v * t, lod, stats)
    return acc * inv_wsum


def _lanes(x, n):
    """x [M, ...] read at lane i % M for i < n."""
    m = x.shape[0]
    return x if m == n else x.repeat((n // m,) + (1,) * (x.dim() - 1))


def sample_atlas_plain(atlas, tex_id, uv, foot_uv=None, duv=None,
                       bump=False, stats=None):
    """Filtered lookups [N, 3] with repeat wrap: tex_id [N] int32 (a spec
    index plus one; <= 0 returns white), uv [M, 2], N a multiple of M,
    lookup i at lane i % M; foot_uv [M, 2] (isotropic trilinear, lod =
    log2 of the footprint in texels) or duv ([M, 2], [M, 2]) (each
    texture's filterType) or neither (base level). With bump, tex_id has
    M rows and N = 3M: lookups at uv, uv + (eps_u, 0) and uv + (0, eps_v)
    of each lane, base level. `stats`, a list, collects the row indices
    read, each as (idx, need): need None, or where K9 reads them too."""
    if tex_id.is_cuda:
        COUNTS["atlas_plain_on_cuda"] += 1
    if bump:
        tid = torch.clamp(tex_id, 0, atlas.n_slots - 1)
        eps = atlas.eps[tid.long()]
        u, v = uv[:, 0], uv[:, 1]
        uv = torch.cat([uv, torch.stack([u + eps[:, 0], v + 0.0], -1),
                        torch.stack([u + 0.0, v + eps[:, 1]], -1)])
        tex_id = tex_id.repeat(3)
    n = tex_id.shape[0]
    uv = _lanes(uv, n)
    tid = torch.clamp(tex_id, 0, atlas.n_slots - 1)
    x4 = atlas.uvx[tid.long()]
    u, v = uv[:, 0], uv[:, 1]
    if duv is not None:
        val = _sample_ewa(atlas, tid, x4, u, v, _lanes(duv[0], n),
                          _lanes(duv[1], n), stats)
    elif foot_uv is None:
        val = _bilinear(atlas, atlas.meta[tid.long()], x4, u, v, stats)
    else:
        lod = _foot_lod(atlas, tid, x4, _lanes(foot_uv, n))
        val = _trilinear(atlas, tid, x4, u, v, lod, stats)
    return torch.where((tex_id > 0)[:, None], val, 1.0)


# a lookup's class in K9's queues (lookup_classes)
WHITE, ONE_ROW, TWO_LEVELS, EWA_TAPS = 0, 1, 2, 3


def _foot_lod(atlas, tid, x4, foot):
    m0 = atlas.meta[tid.long()]
    texels = torch.maximum(
        torch.abs(foot[:, 0] * x4[:, 0]) * m0[:, 1].to(torch.float32),
        torch.abs(foot[:, 1] * x4[:, 1]) * m0[:, 2].to(torch.float32))
    return torch.clamp(torch.log2(torch.clamp(texels, min=1e-9)), 0.0,
                       LMAX - 1.0)


def lookup_classes(atlas, tex_id, uv, foot_uv=None, duv=None, bump=False):
    """Each lookup's class [N] (sample_atlas_plain's arguments), as K9
    queues it: WHITE (slot <= 0), ONE_ROW (a base-level or bump tap, or
    one trilinear tap whose second level is not read:
    _level_one_unread), TWO_LEVELS (one trilinear tap at two levels: a
    footprint, or a Jacobian whose taps all coincide) or EWA_TAPS (four
    taps along the ellipse)."""
    if bump:
        tex_id = tex_id.repeat(3)
    n = tex_id.shape[0]
    tid = torch.clamp(tex_id, 0, atlas.n_slots - 1)
    cls = torch.full((n,), ONE_ROW, dtype=torch.int64, device=tex_id.device)
    if foot_uv is not None or duv is not None:
        uv = _lanes(uv, n)
        x4 = atlas.uvx[tid.long()]
        u, v = uv[:, 0], uv[:, 1]
        if duv is not None:
            lod, u, v, off_u, off_v = _ellipse(
                atlas, tid, x4, u, v, _lanes(duv[0], n), _lanes(duv[1], n))
            one = (off_u == 0) & (off_v == 0)
        else:
            lod = _foot_lod(atlas, tid, x4, _lanes(foot_uv, n))
            one = torch.ones_like(lod, dtype=torch.bool)
        cls = torch.where(
            one, torch.where(_level_one_unread(atlas, tid, x4, u, v, lod),
                             ONE_ROW, TWO_LEVELS), EWA_TAPS)
    return torch.where(tex_id > 0, cls, WHITE)


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

# --fmad=false: each product and sum rounded on its own, as the plain
# version's separate operations round them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]
_vp, _ci, _cll, _cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
# pixels, meta, mip_meta, uvx, filt, n_slots, eps, tap_safe, tex_id, its
# rows, its stride, uv, its strides (2), d0, d1, their strides (2 each), M,
# mode, the outer and inner tap weights, 1 / their sum, out, N, card,
# stream
ARGTYPES = [_vp, _vp, _vp, _vp, _vp, _ci, _vp, _vp, _vp, _cll, _cll, _vp,
            _cll, _cll, _vp, _vp, _cll, _cll, _cll, _ci, _cf, _cf, _cf, _vp,
            _cll, _ci, _vp]
_lib = None


def build():
    """Compile csrc/textures.cu (once per source content) and load it.
    Returns the ctypes library; raises if nvcc fails."""
    global _lib
    from ..native import CSRC, load_cuda

    _lib = load_cuda(os.path.join(CSRC, "textures.cu"), "libppgtextures",
                     NVCC_FLAGS, {"ppg_atlas_sample": ARGTYPES})
    return _lib


def kernel_args(atlas, tex_id, uv, foot_uv=None, duv=None, bump=False):
    """The C entry point's arguments but the output, N, card and stream:
    (args, N, mode). Raises ValueError on a shape or type it does not
    take."""
    M = uv.shape[0]
    if bump:
        mode, n = BUMP, 3 * M
    else:
        mode = DUV if duv is not None else FOOT if foot_uv is not None \
            else BASE
        n = tex_id.shape[0]
    d0, d1 = (duv if duv is not None else
              (foot_uv, foot_uv) if foot_uv is not None else (None, None))
    if (M == 0 or n % M or tex_id.dtype != torch.int32 or tex_id.dim() != 1
            or (bump and tex_id.shape[0] != M)
            or uv.dtype != torch.float32 or tuple(uv.shape) != (M, 2)
            or any(d is not None and (d.dtype != torch.float32
                                      or tuple(d.shape) != (M, 2))
                   for d in (d0, d1))
            or (d0 is not None and d0.stride() != d1.stride())):
        raise ValueError(
            f"ppg_atlas_sample: want tex_id int32 [N] (or [M] with bump), "
            f"uv float32 [M, 2], N a multiple of M, and the differentials "
            f"float32 [M, 2] with one layout; got tex_id {tex_id.dtype} "
            f"{tuple(tex_id.shape)}, uv {uv.dtype} {tuple(uv.shape)}" +
            ("" if d0 is None else
             f", d {d0.dtype} {tuple(d0.shape)} {tuple(d1.shape)}"))
    _, ws, inv_wsum = tap_weights()
    args = [atlas.pixels.data_ptr(), atlas.meta.data_ptr(),
            atlas.mip_meta.data_ptr(), atlas.uvx.data_ptr(),
            atlas.filt.data_ptr(), atlas.n_slots, atlas.eps.data_ptr(),
            atlas.tap_safe.data_ptr(), tex_id.data_ptr(), tex_id.shape[0], tex_id.stride(0),
            uv.data_ptr(), uv.stride(0), uv.stride(1),
            None if d0 is None else d0.data_ptr(),
            None if d1 is None else d1.data_ptr(),
            0 if d0 is None else d0.stride(0),
            0 if d0 is None else d0.stride(1), M, mode, ws[0], ws[1],
            inv_wsum]
    return args, n, mode


def _launch(atlas, tex_id, uv, foot_uv=None, duv=None, bump=False):
    """K9 on uv's card; adds one to COUNTS["atlas_kernel"]."""
    from ..native import raw_stream

    card = uv.get_device()
    tensors = [atlas.pixels, atlas.tap_safe, tex_id, uv] + [
        t for t in ((foot_uv,) if foot_uv is not None else ()) +
        (tuple(duv) if duv is not None else ())]
    if any(not t.is_cuda or t.get_device() != card for t in tensors):
        raise ValueError(f"ppg_atlas_sample: every tensor on cuda:{card}")
    args, n, _ = kernel_args(atlas, tex_id, uv, foot_uv, duv, bump)
    out = torch.empty((n, 3), dtype=torch.float32, device=uv.device)
    lib = _lib or build()
    err = lib.ppg_atlas_sample(*args, out.data_ptr(), n, card,
                               raw_stream(card))
    if err != 0:
        raise RuntimeError(f"ppg_atlas_sample launch failed: cudaError {err}")
    COUNTS["atlas_kernel"] += 1
    return out


def sample_atlas(atlas, tex_id, uv, foot_uv=None, duv=None):
    """sample_atlas_plain's lookups [N, 3]; CUDA tensors launch K9 once."""
    if uv.is_cuda:
        return _launch(atlas, tex_id, uv, foot_uv, duv)
    return sample_atlas_plain(atlas, tex_id, uv, foot_uv, duv)


def bump_lookups(atlas, tex_id, uv):
    """perturb_normal's taps [3M, 3] of tex_id [M] (plus one) at uv [M, 2]:
    the base-level lookups at uv, uv + (eps_u, 0) and uv + (0, eps_v),
    one K9 launch on a card."""
    if uv.is_cuda:
        return _launch(atlas, tex_id, uv, bump=True)
    return sample_atlas_plain(atlas, tex_id, uv, bump=True)


# ---------------------------------------------------------------------------
# differentials, bump and normal maps, wireframe (plain PyTorch)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def _normalize(v):
    n = torch.sqrt(_dot(v, v))[:, None]
    return v / torch.clamp(n, min=1e-12)


def uv_differentials(sensor, d, t, geo_n, dpdu, dpdv):
    """The camera's ray differentials transferred to the hit plane and
    solved for the uv Jacobian (duv/dx, duv/dy), each [L, 2] (ppg_tpu's
    uv_differentials on its active lanes; Intersection::
    computeUVPartials)."""
    ddx, ddy = sensor.dir_differentials(d)
    dn = _dot(d, geo_n)
    dn = torch.where(torch.abs(dn) < 1e-8,
                     torch.where(dn >= 0, 1e-8, -1e-8), dn)

    def transfer(dd):
        # p(px) = o + t(px) d(px) on the plane (p - p0).n = 0
        k = _dot(dd, geo_n) / dn
        return t[:, None] * (dd - d * k[:, None])

    a = _dot(dpdu, dpdu)
    b = _dot(dpdu, dpdv)
    c = _dot(dpdv, dpdv)
    det = a * c - b * b
    inv = torch.where(torch.abs(det) < 1e-24, 0.0, 1.0 / det)

    def solve(dp):
        pu = _dot(dp, dpdu)
        pv = _dot(dp, dpdv)
        return torch.stack([(c * pu - b * pv) * inv,
                            (a * pv - b * pu) * inv], -1)

    return solve(transfer(ddx)), solve(transfer(ddy))


def _lum(c):
    return c[:, 0] * 0.212671 + c[:, 1] * 0.715160 + c[:, 2] * 0.072169


def perturb_normal(atlas, tex_id, is_normalmap, uv, sh_n, dpdu, dpdv):
    """The shading normal of bump and normal maps (src/bsdfs/{bumpmap,
    normalmap}.cpp; ppg_tpu's perturb_normal): a bump map's one-texel
    finite-difference height gradient, a normal map's tangent-space
    normal (2c - 1), turned into sh_n's hemisphere. tex_id [L] is the slot
    plus one; lanes with tex_id <= 0 keep sh_n. Its lookups are one
    bump_lookups call (K9 on a card); the normal map's tap is h0's."""
    L = tex_id.shape[0]
    taps = bump_lookups(atlas, tex_id, uv)
    c0 = taps[:L]
    h0, hu, hv = _lum(c0), _lum(taps[L:2 * L]), _lum(taps[2 * L:])
    eps = atlas.eps[torch.clamp(tex_id, 0, atlas.n_slots - 1).long()]
    dhdu = (hu - h0) / eps[:, 0]
    dhdv = (hv - h0) / eps[:, 1]
    n_bump = _cross(dpdu + sh_n * dhdu[:, None], dpdv + sh_n * dhdv[:, None])
    # an orthonormal tangent frame for the normal map
    t = dpdu - sh_n * _dot(sh_n, dpdu)[:, None]
    t = _normalize(t)
    b = _cross(sh_n, t)
    c = c0 * 2.0 - 1.0
    n_nm = t * c[:, 0:1] + b * c[:, 1:2] + sh_n * c[:, 2:3]
    n_new = _normalize(torch.where(is_normalmap[:, None], n_nm, n_bump))
    n_new = torch.where((_dot(n_new, sh_n) < 0)[:, None], -n_new, n_new)
    return torch.where((tex_id > 0)[:, None], n_new, sh_n)


def wireframe_color(atlas, tex_id, tri_rows, bu, bv):
    """The wireframe texture (src/textures/wireframe.cpp:81-123): the
    world-space distance from the shading point to the nearest edge line
    of its triangle, smoothstepped between lineWidth (1 - stepWidth) and
    lineWidth from edgeColor to interiorColor. tri_rows [K, 12] (p0, e1,
    e2, pad), tex_id [K] the slot plus one."""
    wf = atlas.wfp[torch.clamp(tex_id, 0, atlas.wfp.shape[0] - 1).long()]
    lw, sw = wf[:, 0], wf[:, 1]
    p0, e1, e2 = tri_rows[:, 0:3], tri_rows[:, 3:6], tri_rows[:, 6:9]
    p = p0 + bu[:, None] * e1 + bv[:, None] * e2

    def line_d2(c, dvec):
        l2 = _dot(dvec, dvec)
        w = p - c
        t = _dot(w, dvec) / torch.clamp(l2, min=1e-30)
        dd = w - t[:, None] * dvec
        return _dot(dd, dd)

    d2 = torch.minimum(torch.minimum(line_d2(p0, e1), line_d2(p0, e2)),
                       line_d2(p0 + e1, e2 - e1))
    x = torch.sqrt(torch.clamp(d2, min=0.0))
    e0 = lw * (1.0 - sw)
    t = torch.clamp((x - e0) / torch.clamp(lw - e0, min=1e-30), 0.0, 1.0)
    s = t * t * (3.0 - 2.0 * t)  # math::smoothStep
    return wf[:, 2:5] * (1.0 - s)[:, None] + wf[:, 5:8] * s[:, None]

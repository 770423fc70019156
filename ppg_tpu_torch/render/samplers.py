"""Sample generators (counterpart of ppg_tpu/render/samplers.py): the
sampler family of Mitsuba (independent, stratified, ldsampler, halton,
hammersley, sobol) recast for wavefront rendering.

In the wavefront each lane needs the d-th dimension of the s-th sample of
pixel p as a pure function value(p, s, d), so every sampler but the
independent one is a counter-based map, and the integrator gives each
decision a fixed dimension (integrators/wavefront.py's DIM_BLOCK). As in
ppg_tpu, each pixel gets the same low-discrepancy sequence, decorrelated
by an Owen / Cranley-Patterson scramble keyed on (pixel, dimension);
`draw` gives ppg_tpu's values bit for bit for every kind but
`independent`, which draws from the caller's torch.Generator.

ppg_tpu's uint32 arithmetic wraps; here every value lives in an int64
tensor and is cut to 32 bits after each step, and a product of two 32-bit
values is taken by 16-bit halves (`_mul`), so no intermediate passes
2^49. All dimensions of a call are drawn in one vectorised pass ([L, n]
tensors), so a call's launches do not grow with its dimension count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import rand

KINDS = ("independent", "stratified", "ldsampler", "halton", "hammersley",
         "sobol")

M32 = 0xFFFFFFFF
_INV32 = float(np.float32(1.0 / 4294967296.0))
_INV24 = float(np.float32(1.0 / 16777216.0))
_ONE_MINUS = float(np.float32(1.0 - 1e-7))  # draw's upper clip


def _mul(a, b):
    """a * b mod 2^32 for a and b in [0, 2^32) (int64 tensors or Python
    ints): b by 16-bit halves, so each product stays below 2^48."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def _hash(x, seed):
    """pcg-style integer hash (u32 -> u32)."""
    x = (x + _mul(seed, 0x9E3779B9)) & M32
    x = x ^ (x >> 16)
    x = _mul(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul(x, 0x735A2D97)
    return x ^ (x >> 15)


def _to_float(u):
    return (u >> 8).to(torch.float32) * _INV24


def _reverse_bits(v):
    v = ((v << 16) | (v >> 16)) & M32
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    return ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)


def _laine_karras(x, seed):
    """Owen-equivalent hash scramble of a bit-reversed index (Laine and
    Karras 2011, Burley 2020)."""
    x = (x + seed) & M32
    x = x ^ _mul(x, 0x6C50B47C)
    x = x ^ _mul(x, 0xB82F1E52)
    x = x ^ _mul(x, 0xC7AFE638)
    return x ^ _mul(x, 0x8D22F6E6)


def _owen(v, seed):
    """Owen scramble in base 2: reverse, hash-scramble, reverse."""
    return _reverse_bits(_laine_karras(_reverse_bits(v), seed))


# Sobol' direction numbers from small primitive polynomials (Joe-Kuo
# new-joe-kuo-6 initialisation for the first dimensions): (degree,
# coefficient a, initial m_i) for dims 1..; dim 0 is van der Corput
_JK = [
    (1, 0, [1]), (2, 1, [1, 3]), (3, 1, [1, 3, 1]), (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]), (4, 4, [1, 3, 5, 13]), (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]), (5, 7, [1, 1, 7, 11, 19]),
    (5, 11, [1, 1, 5, 1, 1]), (5, 13, [1, 1, 1, 3, 11]),
    (5, 14, [1, 3, 5, 5, 31]), (6, 1, [1, 3, 3, 9, 7, 49]),
    (6, 13, [1, 1, 1, 15, 21, 21]), (6, 16, [1, 3, 1, 13, 27, 49]),
    (6, 19, [1, 1, 1, 15, 7, 5]), (6, 22, [1, 3, 1, 15, 13, 25]),
    (6, 25, [1, 1, 5, 5, 19, 61]), (7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (7, 4, [1, 3, 7, 13, 13, 15, 69]), (7, 7, [1, 1, 3, 13, 7, 35, 63]),
    (7, 8, [1, 3, 5, 9, 1, 25, 53]), (7, 14, [1, 3, 1, 13, 9, 35, 107]),
    (7, 19, [1, 3, 1, 5, 27, 61, 31]), (7, 21, [1, 1, 5, 11, 19, 41, 61]),
    (7, 28, [1, 3, 5, 3, 3, 13, 69]), (7, 31, [1, 1, 7, 13, 1, 19, 1]),
    (7, 32, [1, 3, 7, 5, 13, 19, 59]), (7, 37, [1, 1, 3, 9, 25, 29, 41]),
    (7, 41, [1, 3, 5, 13, 23, 1, 55]), (7, 42, [1, 3, 7, 3, 13, 59, 17]),
    (7, 50, [1, 3, 1, 3, 5, 53, 69]), (7, 55, [1, 1, 5, 5, 23, 33, 13]),
    (7, 56, [1, 1, 7, 7, 1, 61, 123]), (7, 59, [1, 1, 7, 9, 13, 61, 49]),
    (7, 62, [1, 3, 3, 5, 3, 55, 33]), (8, 14, [1, 3, 1, 15, 31, 13, 49, 245]),
    (8, 21, [1, 3, 5, 15, 31, 59, 76, 125]),
    (8, 22, [1, 1, 7, 11, 11, 41, 103, 182]),
    (8, 38, [1, 3, 7, 12, 9, 17, 16, 41]),
    (8, 47, [1, 1, 5, 3, 15, 59, 23, 117]),
    (8, 49, [1, 3, 3, 9, 9, 37, 123, 13]),
    (8, 50, [1, 1, 7, 15, 1, 51, 66, 83]),
    (8, 52, [1, 1, 1, 5, 23, 53, 118, 225]),
    (8, 56, [1, 3, 7, 9, 13, 1, 34, 145]),
    (8, 67, [1, 1, 3, 7, 7, 61, 18, 117]),
    (8, 70, [1, 1, 1, 9, 23, 57, 83, 217]),
    (8, 84, [1, 3, 3, 5, 11, 61, 106, 123]),
    (8, 97, [1, 1, 5, 9, 17, 61, 86, 153]),
    (8, 103, [1, 1, 5, 13, 29, 27, 54, 185]),
    (8, 115, [1, 3, 1, 3, 27, 25, 34, 63]),
    (8, 122, [1, 3, 7, 9, 5, 63, 105, 247]),
    (9, 8, [1, 1, 1, 3, 13, 33, 65, 19, 403]),
    (9, 13, [1, 3, 5, 11, 27, 55, 103, 247, 379]),
    (9, 16, [1, 3, 1, 7, 3, 37, 61, 195, 289]),
    (9, 22, [1, 3, 7, 1, 15, 17, 17, 131, 357]),
    (9, 25, [1, 1, 5, 5, 1, 63, 89, 123, 141]),
    (9, 44, [1, 1, 7, 11, 23, 1, 51, 23, 381]),
    (9, 47, [1, 3, 5, 13, 29, 9, 39, 201, 131]),
    (9, 52, [1, 1, 1, 9, 5, 25, 117, 103, 75]),
    (9, 55, [1, 1, 7, 1, 1, 45, 51, 77, 141]),
    (9, 59, [1, 3, 5, 9, 17, 63, 85, 135, 261]),
    (9, 62, [1, 3, 1, 15, 29, 47, 65, 45, 329]),
]


def _sobol_directions(n_dims=64):
    """[n_dims, 32] uint32 direction numbers."""
    V = np.zeros((n_dims, 32), np.uint32)
    for k in range(32):
        V[0, k] = np.uint32(1) << (31 - k)
    for d in range(1, n_dims):
        deg, a, m_init = _JK[(d - 1) % len(_JK)]
        m = list(m_init)
        for k in range(deg, 32):
            new = m[k - deg] ^ (m[k - deg] << deg)
            for i in range(1, deg):
                if (a >> (deg - 1 - i)) & 1:
                    new ^= m[k - i] << i
            m.append(new)
        for k in range(32):
            V[d, k] = np.uint32(m[k]) << (31 - k)
    return V


def _primes(n):
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps):
            ps.append(c)
        c += 1
    return ps


_SOBOL_V = _sobol_directions().astype(np.int64)
_PRIMES = np.asarray(_primes(256), np.int64)


def _sobol_u32(idx, dims):
    """Sobol' samples (as int64 in [0, 2^32)) of indices idx [A,1] for
    dimensions dims [n]: [A, n]."""
    v = torch.from_numpy(_SOBOL_V).to(idx.device)[dims % _SOBOL_V.shape[0]]
    out = torch.zeros(torch.broadcast_shapes(idx.shape, dims.shape),
                      dtype=torch.int64, device=idx.device)
    for k in range(32):
        out = out ^ torch.where((idx >> k) & 1 == 1, v[:, k], 0)
    return out


def _radical_inverse(idx, base, seed):
    """Scrambled radical inverse of idx [A,1] in base [n] with the
    per-lane seeds [L, n]: a per-digit affine permutation d -> a d + c mod
    base, a in [1, base), keyed on (seed, digit position), the
    counterpart of Mitsuba's Faure-permuted Halton. float32 [L, n]."""
    inv_base = 1.0 / base.to(torch.float32)
    x = torch.zeros(seed.shape, dtype=torch.float32, device=seed.device)
    inv = torch.ones_like(inv_base)
    i = idx
    for k in range(24):  # base >= 2: 24 digits reach well past 2^24
        digit = i % base
        h = _hash(seed, k * 131 + 7)
        a = 1 + h % (base - 1)
        c = (h >> 16) % base
        perm = (a * digit + c) % base
        inv = inv * inv_base
        x = x + perm.to(torch.float32) * inv
        i = torch.div(i, base, rounding_mode="floor")
    return x


def draw(kind, pixel_ids, sample_idx, dim, gen, shape):
    """One [L] or [L, n] batch of float32 samples in [0, 1 - 1e-7].

    kind        sampler name (KINDS)
    pixel_ids   [L] integer pixel index (the decorrelation key)
    sample_idx  [L] tensor or int: the pixel's sample counter
    dim         first dimension (int or 0-d integer tensor); shape[-1]
                consecutive dimensions are drawn
    gen         torch.Generator (the independent sampler's only input)
    """
    if kind == "independent":
        return rand(gen, *shape)
    if kind not in KINDS:
        raise ValueError(f"unknown sampler kind {kind!r}")
    L = shape[0]
    n = shape[1] if len(shape) > 1 else 1
    dev = pixel_ids.device if torch.is_tensor(pixel_ids) else gen.device
    i64 = torch.int64
    pid = torch.as_tensor(pixel_ids, device=dev).to(i64).expand(L) & M32
    sidx = (torch.as_tensor(sample_idx, device=dev).to(i64).reshape(-1, 1)
            & M32)  # [L, 1] or [1, 1]
    d = (torch.as_tensor(dim, device=dev).to(i64)
         + torch.arange(n, device=dev)) & M32  # [n]
    seed = _hash(pid[:, None], (_mul(d, 0x51633E2D) + 0x68BC21EB) & M32)
    if kind == "stratified":
        # hashed-independent stand-in beyond the camera dims, like the
        # reference's stratified sampler past its dimension budget
        u = _to_float(_hash((_mul(sidx, 0x9E3779B9) + seed) & M32, d + 1))
    elif kind == "ldsampler":
        # Owen-scrambled (0,2)-sequence pairs (ldsampler.cpp)
        v0 = _owen(_reverse_bits(sidx), seed)
        v1 = _owen(_sobol_u32(sidx, torch.ones_like(d)), seed)
        u = torch.where(d % 2 == 0, v0, v1).to(torch.float32) * _INV32
    elif kind in ("halton", "hammersley"):
        base = torch.from_numpy(_PRIMES).to(dev)[d % len(_PRIMES)]
        u = _radical_inverse(sidx, base, seed)
        if kind == "hammersley":
            # dim 0 takes i/N-style van der Corput (hammersley.cpp)
            u = torch.where(d == 0, _reverse_bits(sidx).to(torch.float32)
                            * _INV32, u)
    else:  # sobol
        u = _owen(_sobol_u32(sidx, d), seed).to(torch.float32) * _INV32
    return torch.clamp(u.reshape(shape), 0.0, _ONE_MINUS)

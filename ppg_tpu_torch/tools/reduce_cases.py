"""Inputs for the checks of K5's accumulation (ops/reduce.py,
csrc/reduce.cu) and the error bound it keeps; numpy only, shared by the
CPU tests and the card tests.

`case(name)` gives (target [M] f32, idx [N] int32 or int64, val [N] f32)
for each name in CASES; `exact_and_bound(target, idx, val)` gives, per
cell, the exact sum (target plus every finite value, summed with
math.fsum) and the bound csrc/reduce.cu states for the distance of the
kernel's result from it.
"""

from __future__ import annotations

import math

import numpy as np

FLT_MAX = float(np.finfo(np.float32).max)
TINY = float(np.finfo(np.float32).smallest_subnormal)
ACC_BITS = 62  # = ops/reduce.py's

CASES = ("small", "zeros", "prior", "cancel", "extremes", "one_cell",
         "nonfinite", "int64_index", "wide", "sparse", "split")


def case(name):
    """The case's (target, idx, val): see CASES."""
    rng = np.random.default_rng(CASES.index(name) + 101)
    M, N = 17, 1000
    target = np.zeros(M, np.float32)
    idx = rng.integers(0, M, N)
    val = rng.uniform(-1, 1, N)
    if name == "zeros":
        # a third of the values are zero (a sign each), and the cells 0-4
        # get nothing else; their targets hold -0.0, a NaN and numbers
        val[rng.random(N) < 0.33] = 0.0
        val[idx < 5] = 0.0
        val[(idx < 5) & (rng.random(N) < 0.5)] = -0.0
        target[:5] = [-0.0, np.nan, 1.5, -2.25, 0.0]
    elif name == "prior":
        # targets already hold sums of their own, as G0 starts from
        # opt_bgrad
        target = rng.normal(0, 100, M).astype(np.float32)
    elif name == "cancel":
        # mixed signs that cancel: pairs +-x of large magnitude and small
        # values between them, where an f32 running sum loses the small
        big = 10.0 ** rng.uniform(4, 8, N // 2)
        val = np.concatenate([big, -big, rng.uniform(-1e-3, 1e-3, 200)])
        idx = np.concatenate([idx[:N // 2], idx[:N // 2],
                              rng.integers(0, M, 200)])
    elif name == "extremes":
        # cells 0-3 get subnormals only; 4 two values of FLT_MAX (the sum
        # leaves float32); 5 FLT_MAX and -FLT_MAX / 2; 6 values of
        # FLT_MAX / 200 to FLT_MAX / 100 beside values near 1e-30
        sub = rng.integers(1, 1 << 20, N) * TINY
        val = np.where(idx < 4, sub, val)
        val[idx == 4] = 0.0
        val[idx == 5] = 0.0
        val[np.flatnonzero(idx == 4)[:2]] = FLT_MAX
        k5 = np.flatnonzero(idx == 5)[:2]
        val[k5[0]], val[k5[1]] = FLT_MAX, -FLT_MAX / 2
        k6 = idx == 6
        val[k6] = np.where(rng.random(k6.sum()) < 0.5,
                           rng.uniform(0.005, 0.01, k6.sum()) * FLT_MAX,
                           rng.uniform(-1e-30, 1e-30, k6.sum()))
    elif name == "one_cell":
        M, N = 8, 20000
        target = np.zeros(M, np.float32)
        idx = np.full(N, 3)
        val = rng.exponential(1.0, N) * np.where(rng.random(N) < 0.1, -1, 1)
    elif name == "nonfinite":
        # cell 1 a NaN, 2 +inf, 3 -inf, 4 both infinities, 5 +inf and a
        # NaN; each beside finite values
        for cell, bad in ((1, [np.nan]), (2, [np.inf]), (3, [-np.inf]),
                          (4, [np.inf, -np.inf]), (5, [np.inf, np.nan])):
            k = np.flatnonzero(idx == cell)[:len(bad)]
            val[k] = bad
    elif name == "int64_index":
        M, N = 4096, 30000
        target = rng.normal(0, 1, M).astype(np.float32)
        idx = rng.integers(0, M, N) // 7 * 7  # crowded cells
        val = rng.lognormal(0, 3, N)
        return target, idx.astype(np.int64), val.astype(np.float32)
    elif name == "wide":
        # the global path, pass 3 over every cell: 20,000 cells (more than
        # a block's shared memory holds), a third of the values zero,
        # crowded and lone cells
        M, N = 20000, 40000
        target = rng.normal(0, 1, M).astype(np.float32)
        idx = np.where(rng.random(N) < 0.5, rng.integers(0, 64, N),
                       rng.integers(0, M, N))
        val = rng.normal(0, 1, N) * (rng.random(N) < 0.67)
    elif name == "sparse":
        # the global path, few records for many cells: 3,000 records into
        # 50,000 cells, half of them into one cell, NaN, +-inf and zeros
        # among them
        M, N = 50000, 3000
        target = rng.normal(0, 1, M).astype(np.float32)
        idx = np.where(rng.random(N) < 0.5, 31337, rng.integers(0, M, N))
        val = rng.exponential(1.0, N) * (rng.random(N) < 0.8)
        val[:3] = [np.nan, np.inf, -np.inf]
        idx[:3] = [7, 8, 8]
    elif name == "split":
        # 9,000 cells: the shared path with one stream, the global path
        # (pass 3 over every cell) with two
        M, N = 9000, 20000
        target = rng.normal(0, 1, M).astype(np.float32)
        idx = rng.integers(0, M, N) // 3 * 3
        val = rng.normal(0, 10, N)
    elif name != "small":
        raise ValueError(name)
    return target, idx.astype(np.int32), val.astype(np.float32)


def exact_and_bound(target, idx, val):
    """Per cell: (exact, bound). exact is target + the finite values' sum
    (math.fsum, correctly rounded to float64); bound is csrc/reduce.cu's:
    c 2^(e - S - 1) for the quantisation, 2^-52 of the magnitudes for the
    int64-to-double conversion and the double sum, and half a float32
    spacing for the final rounding."""
    M = target.shape[0]
    v64 = val.astype(np.float64)
    use = np.isfinite(v64) & (v64 != 0)
    i, v = idx[use].astype(np.int64), v64[use]
    order = np.argsort(i, kind="stable")
    i, v = i[order], v[order]
    cuts = np.searchsorted(i, np.arange(M + 1))
    t = target.astype(np.float64)
    exact, bound = t.copy(), np.zeros(M)
    for m in range(M):
        vs = v[cuts[m]:cuts[m + 1]]
        if len(vs) == 0:
            continue
        c = len(vs)
        e = int(np.frexp(np.abs(vs))[1].max())
        S = ACC_BITS - int(c).bit_length()
        quant = c * math.ldexp(1.0, e - S - 1)
        total = math.fsum(vs)
        exact[m] = math.fsum([t[m], total])
        bound[m] = quant + 2.0 ** -52 * (abs(t[m]) + abs(total) + quant)
    with np.errstate(over="ignore"):
        f32 = np.abs(exact).astype(np.float32)
    half_ulp = np.where(np.isfinite(f32),
                        np.spacing(f32).astype(np.float64) / 2, np.inf)
    return exact, bound + half_ulp

"""Environment maps and lanes for holding K10 (csrc/envmap.cu) against
emitters/envmap.py's plain versions: numpy only, shared by the CPU tests,
the card tests and chip_smoke.py.

`edge_maps()` gives the maps: random texels with a black row (its column
CDF all 0 with a final 1) and black rows at both poles (their row weight
and their CDF steps 0); a map whose few hot texels, a sun's, hold most
of its power (peak 19,440 against a mean near 0.125, as the 4096 sunsky);
a constant map; each with a rotation (the identity or a turn about the
x and y axes). Beside those 16 x 32 maps, shapes for every path of K10's
searches (csrc/envmap.cu takes three rounds of a search a step, and
stages the row CDF in shared memory whole up to 4,095 rows, else the
first levels of its search): 17 x 33 and 5 x 1000 (searches of 4-6 and
2-10 rounds, most of them not a multiple of three), one row and one
column (searches of no round), 4,100 x 2 (taller than the staged row
CDF: the search goes on from the staged levels) and a map with an inf
texel, which the loader takes (its row sum is inf, not 0) and whose
CDFs hold NaN from the texel on (inf / inf), so that a search compares
with NaN entries.

`edge_lanes(arrays, L, seed)` gives, for one map's tables, L lanes of
both modes:
- the uniforms (ux the column's, uy the row's): uniform ones, exactly 0
  and 1, exactly on the row CDF's values and on a row's column CDF
  values (ties go up), just below them, halfway between two
  neighbouring ones (the first and last intervals among them), and the
  remainders of a slot pick over 4 slots (xe - slot, as the tracer
  reuses them);
- the sampling points: inside the scene's bounding sphere, on it and
  outside it (no far hit: pdf 0);
- the lookup directions: random ones, the six axes, the poles, and
  directions at the seam u = 0 / 1 (x = +-0 with z > 0: atan2 gives +-pi)
  and just beside it, and the zero vector;
- a gate: keys 0-3 against key value 1 and two masks.
"""

from __future__ import annotations

import numpy as np


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


ROTATIONS = {
    "identity": np.eye(3),
    "turned": (np.array([[1, 0, 0], [0, 0.6, -0.8], [0, 0.8, 0.6]])
               @ np.array([[0.28, 0, 0.96], [0, 1, 0], [-0.96, 0, 0.28]])),
}


def _noise(rng, H, W):
    """Random texels with black rows at both poles and a third of the way
    down."""
    img = (rng.random((H, W, 3)) ** 2).astype(np.float32) + 0.01
    img[0] = 0.0
    img[H - 1] = 0.0
    img[H // 3] = 0.0
    return img


def _sun(H, W):
    """A dim map with a sun's three hot texels."""
    img = np.full((H, W, 3), 0.125, np.float32)
    img[H // 4, W // 3] = 19440.0
    img[H // 4, (W // 3 + 1) % W] = 9000.0
    img[(H // 4 + 1) % H, W // 3] = 4000.0
    return img


def edge_maps(H=16, W=32, seed=0):
    """name -> (image [H, W, 3] float32, rotation [3, 3])."""
    rng = np.random.default_rng(seed)
    noise = _noise(rng, H, W)
    const = np.full((H, W, 3), 0.5, np.float32)
    inf = (rng.random((H, W, 3)) + 0.05).astype(np.float32)
    inf[H // 2, W // 4, 1] = np.inf
    tall = (rng.random((4100, 2, 3)) + 0.05).astype(np.float32)
    tall[1000:1100] = 0.0
    tall[3000, 1] = 500.0
    tall[[0, -1]] = 2e4  # bright poles: a search's first and last steps
    ident, turned = ROTATIONS["identity"], ROTATIONS["turned"]
    return {"black rows, identity": (noise, ident),
            "black rows, turned": (noise, turned),
            "sun, turned": (_sun(H, W), turned),
            "constant, identity": (const, ident),
            "17 x 33, black rows, turned": (_noise(rng, 17, 33), turned),
            "5 x 1000, sun, identity": (_sun(5, 1000), ident),
            "1 x 64, sun, turned": (_sun(1, 64), turned),
            "64 x 1, black rows, identity": (_noise(rng, 64, 1), ident),
            "4100 x 2, tall, turned": (tall, turned),
            "inf texel, identity": (inf, ident)}


def scrambled(arrays, seed=0):
    """A copy of one map's tables (EnvmapArrays.arrays') whose CDFs no
    loader builds: each CDF's inner entries shuffled, so that none
    ascends, and NaN at its search's first midpoint and the midpoint right
    of it, so that every search compares a NaN entry first (and goes
    left) yet most end between finite ones (a CDF of under four steps
    keeps its entries finite). It holds K10's searches to
    _sample_cdf's index on any table: a search that assumed an ascending
    CDF, or compared a NaN otherwise, picks another texel."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    H = arrays["row_w"].shape[0]
    cdfs = [arrays["row_cdf"]] + list(arrays["col_cdf"].reshape(H, -1))
    for k, c in enumerate(cdfs):
        c = c.copy()
        rng.shuffle(c[1:-1])
        n = c.shape[0] - 1
        if n >= 4:
            c[[n >> 1, (n + (n >> 1)) >> 1]] = np.nan
        cdfs[k] = c
    out["row_cdf"] = cdfs[0]
    out["col_cdf"] = np.concatenate(cdfs[1:])
    return out


def edge_lanes(arrays, L, seed=0):
    """Lanes for one map (arrays: EnvmapArrays.arrays' tables): dict(ux,
    uy [L] float32, p [L, 3] float32 points, d [L, 3] float32
    directions, key [L] int32, m1, m2 [L] bool)."""
    rng = np.random.default_rng(seed)
    row_cdf, col_cdf = arrays["row_cdf"], arrays["col_cdf"]
    H = row_cdf.shape[0] - 1
    W = col_cdf.shape[0] // H - 1
    ux = rng.random(L).astype(np.float32)
    uy = rng.random(L).astype(np.float32)
    k = np.arange(L) % 10
    ux[k == 1], uy[k == 1] = 1.0, 1.0
    ux[k == 2], uy[k == 2] = 0.0, 0.0
    on_row = rng.choice(row_cdf, L)
    uy[k == 3] = on_row[k == 3]
    uy[k == 4] = np.nextafter(on_row[k == 4], np.float32(-1))
    on_col = rng.choice(col_cdf, L)
    ux[k == 5] = on_col[k == 5]
    ux[k == 6] = np.nextafter(on_col[k == 6], np.float32(-1))
    # the slot pick's remainder over 4 slots, as the tracer reuses it
    xe = rng.random(L).astype(np.float32) * np.float32(4)
    slot = np.clip(xe.astype(np.int32), 0, 3)
    ux[k == 7] = (xe - slot.astype(np.float32))[k == 7]
    ux[k == 8] = 1.0
    uy[k == 8] = rng.random(L).astype(np.float32)[k == 8]
    # halfway between two neighbouring CDF values: every interval's
    # inside, the first and the last one's too (c0 and c1 at a search's
    # two ends)
    n = np.arange(L)
    j = rng.integers(0, H, L)
    j[n % 30 == 9], j[n % 30 == 19] = 0, H - 1
    i = rng.integers(0, W, L)
    i[n % 40 == 9], i[n % 40 == 29] = 0, W - 1
    half = lambda c, at: ((c[at].astype(np.float64)
                           + c[at + 1].astype(np.float64)) / 2)
    uy[k == 9] = half(row_cdf, j)[k == 9]
    ux[k == 9] = half(col_cdf, j * (W + 1) + i)[k == 9]
    np.clip(ux, 0.0, 1.0, out=ux)
    np.clip(uy, 0.0, 1.0, out=uy)

    # points: mostly inside the unit box's bounding sphere (centre 0.5,
    # radius 1.5 x sqrt(3) / 2 = 1.299), some on and beyond it
    p = rng.random((L, 3)).astype(np.float32)
    far = np.arange(L) % 7 == 3
    p[far] = (0.5 + 2.0 * _unit(rng.normal(size=(int(far.sum()), 3))))
    on = np.arange(L) % 7 == 5
    p[on] = (0.5 + 1.299038 * _unit(rng.normal(size=(int(on.sum()), 3))))

    d = _unit(rng.normal(size=(L, 3)))
    special = np.array([
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
        [0.0, 0, 1], [-0.0, 0, 1], [1e-7, 0, 1], [-1e-7, 0, 1],
        [1e-3, 0.5, 1], [-1e-3, -0.5, 1], [0, 0, 0], [0, 1, 1e-7],
        [0, -1, -1e-7]], np.float64)
    nz = np.linalg.norm(special, axis=-1, keepdims=True)
    special = np.where(nz > 0, special / np.where(nz > 0, nz, 1), 0.0)
    at = np.arange(L) % 5 == 0
    d[at] = special[np.arange(int(at.sum())) % len(special)]
    d = d.astype(np.float32)
    # -0 components survive the float32 cast; keep the seam's x = -0
    d[at & (np.arange(L) // 5 % len(special) == 7), 0] = -0.0

    return dict(ux=ux, uy=uy, p=p.astype(np.float32), d=d,
                key=rng.integers(0, 4, L).astype(np.int32),
                m1=rng.random(L) < 0.9, m2=rng.random(L) < 0.9)

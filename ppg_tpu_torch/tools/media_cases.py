"""Edge cases for K11 (csrc/media.cu) and its plain versions, in numpy
only: shared by tests/test_torch_media.py (under tools/cuda_shim.py) and
tests/test_torch_media_gpu.py (on a card)."""

from __future__ import annotations

import os
import re

import numpy as np

from ..media import MICROFLAKE_G
from ..native import CSRC


def k11_constants():
    """csrc/media.cu's integer constants: BLOCK (a tile's lanes), BATCH
    (the events a step takes), CHUNK, QCAP, ..."""
    with open(os.path.join(CSRC, "media.cu")) as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


# Lane sets over K11's tiles (csrc/media.cu: a block gates CHUNK tiles of
# BLOCK lanes at a time and works its queue when it could not take
# another chunk, or at its last): name -> (lanes, seed, tiles all gated in
# after the first tile, which is all gated out)
TILE_CASES = {
    "below one tile": (100, 21, 0),
    "a ragged tile, one tile out and one in": (1500, 22, 1),
    "two tiles a block": (3000, 23, 1),
    "three chunks a block": (13000, 24, 49),
}


def turned(scale=1.3):
    """A to_world 4x4 with a rotation, a non-uniform scale and a shift."""
    c, s = np.cos(0.4), np.sin(0.4)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag(
        [scale, 0.8, 1.1])
    m[:3, 3] = [0.2, -0.1, 0.3]
    return m


def face_table():
    """A microflake grid medium whose affine is the identity (bbox [0,
    res - 1], to_world the identity), so a point's grid coordinates are
    exact; res (5, 4, 3), with an orientation volume."""
    rng = np.random.default_rng(8)
    dens = rng.random((3, 4, 5)).astype(np.float32)
    og = rng.normal(size=(3, 4, 5, 3)).astype(np.float32)
    return [dict(hetero=True, density=dens, bbox_min=np.zeros(3),
                 bbox_max=np.array([4.0, 3.0, 2.0]), scale=1.0,
                 albedo=np.array([0.5] * 3), g=MICROFLAKE_G,
                 orientation_grid=og)]


def face_points():
    """Points of face_table's grid: on its max faces and corner, in its
    last cells, its min corner, and just outside (the 9th to 11th)."""
    pts = [[4.0, 3.0, 2.0], [4.0, 1.5, 0.5], [2.5, 3.0, 1.0],
           [1.0, 2.0, 2.0], [3.5, 2.5, 1.5], [3.999, 2.999, 1.999],
           [4.0, 3.0, 0.0], [0.0, 0.0, 0.0], [4.0001, 1.0, 1.0],
           [-1e-4, 1.0, 1.0], [2.0, 3.0001, 1.0], [3.25, 0.75, 1.75]]
    return np.asarray(pts, np.float32)


def edge_table():
    """Six media: 0 a dense random grid under a to_world (its inf lanes
    scatter before they can leave it), 1 a homogeneous medium, 2 a grid
    of zeros (majorant 0), 3 a grid with one dense voxel (walks of many
    rejected events), 4 face_table's identity-affine grid, 5 a grid one
    voxel deep at the end of the concatenated grids (res z 1: every point
    is inside in z, and its cell's z + 1 corners lie past the grid, their
    indices clamped into it; K11 takes its clamped path there)."""
    rng = np.random.default_rng(11)
    hot = np.full((4, 4, 4), 0.01, np.float32)
    hot[1, 2, 3] = 60.0
    box = dict(bbox_min=np.array([-1.0, -1, -1]),
               bbox_max=np.array([1.0, 1, 1]))
    return [dict(hetero=True, density=0.5 + 0.5 * rng.random(
                (6, 5, 4)).astype(np.float32),
                 bbox_min=np.array([-3.0, -3, -3]),
                 bbox_max=np.array([3.0, 3, 3]), to_world=turned(1.0),
                 scale=6.0, albedo=np.array([0.8, 0.6, 0.4]), g=0.0),
            dict(sigma_t=[1.0, 2.0, 3.0], albedo=[0.5] * 3, g=0.0),
            dict(hetero=True, density=np.zeros((2, 3, 4), np.float32),
                 scale=1.0, albedo=np.array([0.5] * 3), g=0.0, **box),
            dict(hetero=True, density=hot, scale=1.0,
                 albedo=np.array([0.3] * 3), g=0.0, **box),
            dict(face_table()[0], albedo=np.array([0.6] * 3)),
            dict(hetero=True, density=0.2 + rng.random((1, 3, 4)).astype(
                np.float32), scale=2.0, albedo=np.array([0.7] * 3), g=0.0,
                 **box)]


def edge_lanes(n, seed):
    """(mid int32, o, d, t_surf float32) over edge_table: every medium id
    and -1; random origins and directions through the grids; every tenth
    lane with t_surf = inf (finite on the grids a ray could leave without
    an event), some 0 or negative; the last lanes each of face_points
    with d = 0 in the identity-affine grid, so every event lands there."""
    rng = np.random.default_rng(seed)
    mid = rng.integers(-1, 5, n).astype(np.int32)
    o = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = rng.uniform(0.0, 3.0, n).astype(np.float32)
    t[::10] = np.inf
    t[5::37] = 0.0
    t[6::37] = -1.0
    o[(mid == 0) & np.isinf(t)] *= 0.5
    t[(mid >= 2) & np.isinf(t)] = 2.5
    pts = face_points()
    k = len(pts)
    mid[-k:] = 4
    o[-k:] = pts
    d[-k:] = 0.0
    t[-k:] = rng.uniform(0.5, 4.0, k)
    return mid, o, d, t


def cap_lanes():
    """(mid, o, d, t_surf) of six lanes for the cap: three outside their
    grid with t_surf = inf (0, 2 and 5: never accepted, they escape at the
    cap), one at rest (d = 0) in the one-voxel grid where the density is
    below the majorant (1: a ratio product of 1,024 or 65,536 factors),
    a homogeneous lane and a vacuum lane."""
    mid = np.array([3, 3, 0, 1, -1, 3], np.int32)
    o = np.array([[3.0, 0, 0], [0.1, 0.1, 0.1], [5.0, 5, 5], [0.0, 0, 0],
                  [0.0, 0, 0], [-4.0, 0, 0]], np.float32)
    d = np.array([[1.0, 0, 0], [0.0, 0, 0], [0.0, 1, 0], [1.0, 0, 0],
                  [1.0, 0, 0], [-1.0, 0, 0]], np.float32)
    return mid, o, d, np.full(6, np.inf, np.float32)


def tiled_lanes(n, seed, tiles_in):
    """edge_lanes(n, seed) with the first tile's lanes gated out (vacuum,
    the homogeneous medium and the grid of zeros in turn) and the next
    `tiles_in` tiles' lanes gated in (the dense, the one-voxel, the
    identity-affine and the one-deep grids in turn; an infinite t_surf
    made 2.5, so that no lane leaves its grid toward the cap), as far as
    n reaches before the face points at the end."""
    mid, o, d, t = edge_lanes(n, seed)
    tile = k11_constants()["BLOCK"]
    last = n - len(face_points())
    out = min(tile, last)
    mid[:out] = np.array([-1, 1, 2], np.int32)[np.arange(out) % 3]
    hi = min(tile * (1 + tiles_in), last)
    if hi > tile:
        k = np.arange(tile, hi)
        mid[k] = np.array([0, 3, 4, 5], np.int32)[k % 4]
        t[k] = np.where(np.isinf(t[k]), np.float32(2.5), t[k])
    return mid, o, d, t


def queue_plan(lanes_in, blocks, tile, chunk, qcap):
    """The queues K11's loop works for the gate mask `lanes_in` [L] on a
    grid of at most `blocks` blocks (csrc/media.cu: block b gates tiles
    b, b + grid, ... CHUNK at a time, and works its queue when it could
    not take another chunk or its tiles are done): for each block, the
    lengths of the queues it works in turn."""
    L = len(lanes_in)
    tiles = -(-L // tile)
    grid = min(tiles, blocks)
    per_tile = [int(np.sum(lanes_in[k * tile:(k + 1) * tile]))
                for k in range(tiles)]
    plan = []
    for b in range(grid):
        q, worked = 0, []
        for c0 in range(b, tiles, chunk * grid):
            q += sum(per_tile[c] for c in range(c0, tiles, grid)[:chunk])
            if c0 + chunk * grid >= tiles or q > qcap - chunk * tile:
                worked.append(q)
                q = 0
        plan.append(worked)
    return plan


def shifted_rows(rows, G):
    """edge_table's rows ([M, 36] numpy, over grids of G floats) with the
    one-voxel grid's offset at -40 (its first cells' corners below index
    0) and the identity-affine grid's at G - 30 (its last cells' corners
    past the grid), so that the corner indices' clamps bind on corners of
    nonzero weight, as no table from_table builds makes them."""
    r = rows.copy()
    r[3, 10] = -40.0
    r[4, 10] = float(G - 30)
    return r


def many_media():
    """edge_table followed by 60 homogeneous media: a table of 66 rows,
    the grids' rows first."""
    return edge_table() + [dict(sigma_t=[0.5 + 0.01 * k] * 3,
                                albedo=[0.5] * 3, g=0.0) for k in range(60)]

"""Smoke run of ppg_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the triangle-sweep kernels (closest hit and any hit) from
ppg_tpu_torch/csrc/brute.cu, the BVH16 walk kernels from
ppg_tpu_torch/csrc/bvh.cu, the SD-tree descent kernels (K3 lookup, K4
sample-and-pdf walk) from ppg_tpu_torch/csrc/sdtree.cu (one nvcc each,
started together) and the host
libraries from ppg_tpu_torch/csrc/host, holds the kernels against their
plain PyTorch versions (the kernels are bit-identical to them by design,
so any lane that picks another triangle or differs in a bit fails the
run), times them (through the wrapper, alone in a CUDA graph, and the
plain version) beside their bound, and renders with GuidedPathTracer on
the card, each render checked against an unguided one. The built-in
Cornell box (12 triangles, through the sweep):
- phase 3/4: 512x512, 127 spp budget, maxDepth 10, nee never,
  nearest/nearest filters;
- phase 5: the improved configuration (cbox-improved: inversevar,
  kl-trained bsdf sampling fraction, stochastic spatial and box
  directional filters, sTreeThreshold 4000, sppPerPass 1) at the same
  size;
- phase 6: next-event estimation with shadow rays through the kernel's
  any-hit (nee always, box/box filters, variance-trained fraction) at
  256x256, 32 spp.
The box with a bumpy sphere of 1,046,528 triangles on its floor, written
as a binary PLY and loaded by the port's loader (1,046,540 triangles,
through the walk):
- phase 7: the walk kernels against the plain walk on camera and
  incoherent rays of that scene and on a deep random soup, timed beside
  their bound (from the plain walk's step counts);
- phase 8: the renders of phases 3 and 6 on that scene, through the walk
  kernels only.
Every guided render (phases 3, 5, 6, 8a, 8b) must run its SD-tree
descents through K3 and K4 and no plain descent on the card. Then:
- phase 9: K3 and K4 against their plain versions, bit for bit, at
  L = 262,144 on the tree phase 3's last iteration sampled from, timed
  beside their bound (from the plain walks' levels and rows);
- phase 10: the kernels still to port (K5's accumulation, K6, K7) at the
  shapes phase 5's training passes gave them: their plain time, their
  bound and, for K5, index_add_'s time.
Every phase prints its own lines; any failure raises and the script exits
non-zero. The line before the last is a JSON object describing the
kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RES, BUDGET, MAX_DEPTH = 512, 127, 10
CHUNK = 1 << 18  # the whole 512x512 frame in one wavefront
IMPROVED = dict(sampleCombination="inversevar", bsdfSamplingFractionLoss="kl",
                spatialFilter="stochastic", directionalFilter="box",
                sTreeThreshold=4000, sppPerPass=1)
NEE_RES, NEE_BUDGET = 256, 32
NEE_FILTERS = dict(spatialFilter="box", directionalFilter="box",
                   bsdfSamplingFractionLoss="var")
# H100 SXM: HBM3 rate and FP32 peak outside the tensor cores; the sweep
# needs 32 FP32 operations per ray-triangle pair (tv 3, d.n 5, d x tv 9,
# three dot products 15) and 9 per triangle (n = e1 x e2)
HBM_BYTES_PER_S, FP32_PER_S = 3.35e12, 67e12
OPS_PER_PAIR, OPS_PER_TRI = 32, 9
# the walk: 25 FP32 operations per child slab test (6 sub, 6 mul, 10
# min/max, 3 compares) on each child a node step must test (non-empty and
# pending), a triangle test on each triangle of a leaf step; the bytes a
# row must give: 28 per non-empty child (its box and info), 36 per
# triangle (p0, e1, e2) and 8 per leaf (its count and base)
W = 16
OPS_PER_SLAB, CHILD_BYTES, TRI_BYTES, LEAF_META_BYTES = 25, 28, 36, 8
# the descents (csrc/sdtree.cu's note): FP32 operations per spatial level
# (a compare, the rescale's subtract and multiply, the side's halving),
# per lookup lane (normalise 3 subtracts and 3 divides, 6 clamp compares;
# the meta's multiply, divide, 4 compares, negate, exp, add, divide), per
# quadtree level of a sampling lane (the sum 3, the conditional CDF 13,
# the factor 3, acc 1, origin 4, scale 1) and of a point lane (the sum 3,
# 4 compares, the rescale 4, the factor 3, acc 1, origin 4, scale 1), and
# per sampled lane's leaf point (2 multiplies, 2 adds, 4 compares); the
# rows: 12 B per spatial node, 32 B per quadtree node, 16 B per dtree's
# meta
OPS_S_LEVEL, OPS_LOOKUP_LANE = 4, 22
OPS_Q_SAMPLE, OPS_Q_POINT, OPS_LEAF_POINT = 25, 20, 8
S_ROW_BYTES, Q_ROW_BYTES, META_ROW_BYTES = 12, 32, 16
SPHERE_SUBDIV = (512, 1024)  # theta, phi: 1,046,528 triangles
WALK_L = 1 << 18
SOUP_T, SOUP_L = 20000, 1 << 20


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def soup(T, L, seed, shadow=False, edges=False):
    """tools/soups.tri_soup's random triangles and rays on the card."""
    from ppg_tpu_torch.tools.soups import tri_soup

    return [torch.from_numpy(a).cuda()
            for a in tri_soup(T, L, seed, shadow, edges)]


def cuda_ms(fn, reps, batches=1):
    """ms per call of `fn` back to back, host side included (events around
    `reps` calls); the least of `batches` such runs, since the host side
    follows the load of the machine's shared CPU."""
    fn()  # warm-up
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def graph_ms(fn, n=100, reps=5):
    """The kernel alone: n launches captured in one CUDA graph, replayed
    and timed with events; ms per launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def visited_pairs(tri, o, d, t_min, t_max):
    """Ray-triangle pairs the any-hit sweep must test on these rays: up to
    and including its first hit in packed order, all T without one, none
    for a parked lane (the plain predicate, 64 triangles at a time)."""
    T, L = tri.shape[0], o.shape[0]
    first = torch.full((L,), T, dtype=torch.int64, device=o.device)
    o, d = o.T[:, None], d.T[:, None]
    for k0 in range(T - 1, -1, -64):
        r = tri[max(0, k0 - 63):k0 + 1, :9].T[:, :, None]
        p0, e1, e2 = r[0:3], r[3:6], r[6:9]
        pv = torch.linalg.cross(d, e2, dim=0)
        det = (e1 * pv).sum(0)
        inv = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
        tv = o - p0
        u = (tv * pv).sum(0) * inv
        qv = torch.linalg.cross(tv, e1, dim=0)
        v = (d * qv).sum(0) * inv
        t = (e2 * qv).sum(0) * inv
        hit = ((inv != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
               & (t > t_min) & (t < t_max))
        k = torch.arange(max(0, k0 - 63), k0 + 1, device=o.device)
        first = torch.where(hit.any(0), k[hit.int().argmax(0)], first)
    first = torch.where(first < T, first + 1, T)
    return int(torch.where(t_max < t_min, 0, first).sum())


def same_bits(got, want):
    """Holds a kernel's closest hits against the plain version's, both
    (best_i, t, u, v): raises unless every lane picks the same triangle
    with the same bits of t, u and v. Returns the hits' count and the
    largest absolute t/u/v difference on them."""
    gi, pi = got[0], want[0]
    other = int((gi != pi).sum())
    bits = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
               for a, b in zip(got[1:], want[1:]))
    if other or bits:
        raise AssertionError(f"{other} lanes pick another triangle, {bits} "
                             f"t/u/v values differ in a bit")
    hit = pi >= 0
    err = max(float((a[hit] - b[hit]).abs().max()) if bool(hit.any())
              else 0.0 for a, b in zip(got[1:], want[1:]))
    return int(hit.sum()), err


def bound_ms(T, L, out_bytes, pairs):
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the pairs' FP32 operations at
    the FP32 peak, whichever is larger. Returns (ms, which term)."""
    mem = (L * 32 + T * 48 + L * out_bytes) / HBM_BYTES_PER_S * 1e3
    ops = (OPS_PER_PAIR * pairs + OPS_PER_TRI * T) / FP32_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def walk_bound_ms(geom, L, out_bytes, stats):
    """The walk's bound, from what the plain walk's steps needed on these
    rays: the FP32 operations of the slab tests of the children its node
    steps had to test and of the triangle tests of its leaf steps'
    triangles, at the FP32 peak; or the rays (32 B) and results read and
    written once plus, from each distinct row the walk read, its non-empty
    children and its triangles, at the HBM rate; whichever is larger.
    Returns (ms, which term, the counts)."""
    rows = geom.rows
    info = rows[stats["node_rows"], 6 * W:7 * W].contiguous().view(
        torch.int32)
    cnt = rows[stats["leaf_rows"], 9 * W:9 * W + 1].contiguous().view(
        torch.int32)
    n = dict(node_tests=int(stats["node_tests"].sum()),
             leaf_tests=int(stats["leaf_tests"].sum()),
             row_children=int((info != 0).sum()), row_tris=int(cnt.sum()),
             leaf_rows=int(cnt.shape[0]))
    ops = n["node_tests"] * OPS_PER_SLAB + n["leaf_tests"] * OPS_PER_PAIR
    mem = (L * (32 + out_bytes) + n["row_children"] * CHILD_BYTES
           + n["row_tris"] * TRI_BYTES + n["leaf_rows"] * LEAF_META_BYTES)
    mem_ms, ops_ms = mem / HBM_BYTES_PER_S * 1e3, ops / FP32_PER_S * 1e3
    by = "bytes" if mem_ms >= ops_ms else "operations"
    return max(mem_ms, ops_ms), by, n


def once_ms(fn):
    """ms of one call, events around it (for the slow plain walk)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def bumpy_sphere_ply(path, n_theta, n_phi):
    """A sphere of radius 0.5 at (0, 0.5, 0), its radius times
    1 + 0.02 sin(24 theta) cos(24 phi), on scene/shapes.py::make_sphere's
    grid and faces, written as a binary little-endian PLY. Returns the
    triangle count, 2 n_phi (n_theta - 1)."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 0.5 * (1.0 + 0.02 * np.sin(24 * T) * np.cos(24 * P))
    pos = np.stack([r * np.sin(T) * np.cos(P),
                    0.5 + r * np.sin(T) * np.sin(P),
                    r * np.cos(T)], -1).reshape(-1, 3).astype("<f4")
    i, j = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a = i * (n_phi + 1) + j
    b, c, d = a + 1, a + n_phi + 2, a + n_phi + 1
    tris = np.stack([np.stack([a, d, b], -1), np.stack([b, d, c], -1)], 2)
    keep = np.stack([i > 0, i < n_theta - 1], 2)  # the poles' one face
    faces = np.zeros(int(keep.sum()), np.dtype([("n", "u1"),
                                                ("v", "<i4", (3,))]))
    faces["n"], faces["v"] = 3, tris[keep]
    with open(path, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pos)}\nproperty float x\n"
                 "property float y\nproperty float z\n"
                 f"element face {len(faces)}\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 ).encode())
        f.write(pos.tobytes())
        f.write(faces.tobytes())
    return len(faces)


def sphere_scene(ply, res, budget, nee):
    """The built-in Cornell box with the PLY sphere on its floor, loaded by
    the port's loader; returns (scene, load seconds)."""
    from ppg_tpu_torch.scene import MINI_CBOX, load_scene

    shape = f"""  <shape type="ply">
    <string name="filename" value="{ply}"/>
    <ref id="white"/>
  </shape>
"""
    xml = MINI_CBOX.format(res=res, budget=budget, max_depth=MAX_DEPTH,
                           nee=nee).replace("</scene>", shape + "</scene>")
    path = os.path.join(os.path.dirname(ply), f"scene-{res}-{nee}.xml")
    with open(path, "w") as f:
        f.write(xml)
    t0 = time.time()
    sc = load_scene(path)
    return sc, time.time() - t0


def walk_rays(kind, L, seed, sc=None, geom=None, shadow=False):
    """Rays for the walk, [o, d, t_min, t_max] on the card: "camera", the
    scene's camera rays at uniform film positions; "incoherent", origins
    uniform in the scene's AABB and uniform directions (kdbench's random
    rays), half of them aimed at triangle edges; "soup", tools/soups'
    rays around the deep soup. Every 17th lane is parked; with `shadow`,
    finite segment ends and a third of the lanes parked, as the tracer's
    shadow rays."""
    from ppg_tpu_torch.render.sensor import make_sensor
    from ppg_tpu_torch.tools.soups import aim_at_edges, soup_rays

    if kind == "soup":
        return [torch.from_numpy(a).cuda()
                for a in soup_rays(L, seed, shadow)]
    rng = np.random.default_rng(seed)
    if kind == "camera":
        W_, H_ = sc.film["width"], sc.film["height"]
        pos = rng.uniform(0, 1, (L, 2)) * [W_, H_]
        o, d, t_min, t_max = make_sensor(sc.sensor, sc.film, "cuda") \
            .sample_rays(torch.from_numpy(pos.astype(np.float32)).cuda())
        t_max = torch.where(torch.arange(L, device="cuda") % 17 == 0, -1.0,
                            t_max)
        return [o, d, t_min, t_max]
    lo, hi = sc.aabb_min, sc.aabb_max
    o = (lo + rng.random((L, 3)) * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(L, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = aim_at_edges(geom.tri.cpu().numpy(), o, d, rng)
    t_min = np.full(L, 1e-4, np.float32)
    t_max = np.where(np.arange(L) % 17 == 0, -1.0, 3.4e38)
    if shadow:
        t_max = np.where(rng.random(L) < 0.33, -1.0, rng.random(L) * 3.0)
    return [torch.from_numpy(a).cuda() for a in
            (o, d, t_min, t_max.astype(np.float32))]


def check_walk(geom, args, what):
    """The closest-hit kernel bit for bit and the any-hit kernel's
    occlusion against the plain walk; raises on any differing lane.
    Returns (plain closest hits, its stats, plain stop_on_hit stats,
    largest |t/u/v| difference on the hits)."""
    from ppg_tpu_torch.accel import bvh_walk as BW
    from ppg_tpu_torch.accel import traverse as TT

    *want, stats = TT.bvh_closest_plain(geom, *args, return_stats=True)
    hits, err = same_bits(BW.bvh_closest(geom, *args), want)
    occ_w, _, _, _, any_stats = TT.bvh_closest_plain(
        geom, *args, stop_on_hit=True, return_stats=True)
    occ = BW.bvh_any_hit(geom, *args)
    differ = int((occ != (occ_w >= 0)).sum())
    if differ or bool(occ[args[3] < args[2]].any()):
        raise AssertionError(f"{what}: any-hit: {differ} lanes differ in "
                             f"occlusion, or a parked lane is occluded")
    steps = (stats["node_steps"] + stats["leaf_steps"]).float()
    print(f"phase 7: {what} L={len(args[0])}: closest-hit bit-identical on "
          f"all lanes ({hits} hits), any-hit 0 lanes differ "
          f"({int(occ.sum())} occluded, parked lanes never); steps per lane "
          f"mean {float(steps.mean()):.2f} max {int(steps.max())} "
          f"({int(stats['node_steps'].sum())} node, "
          f"{int(stats['leaf_steps'].sum())} leaf), rows read "
          f"{int(stats['node_rows'].sum())} internal "
          f"{int(stats['leaf_rows'].sum())} leaf")
    return want, stats, any_stats, err


def time_walk(name, geom, fn, plain, L, out_bytes, stats, tag, what):
    """Times one walk kernel through its wrapper, alone (100 launches in a
    CUDA graph) and its plain version, beside its bound."""
    bound, by, n = walk_bound_ms(geom, L, out_bytes, stats)
    row = dict(what=what, L=L, ms=cuda_ms(fn, 20, batches=3),
               kernel_only_ms=graph_ms(fn),
               plain_ms=once_ms(plain), bound_ms=bound, bound_by=by,
               bound="memory" if by == "bytes" else "fp32",
               node_steps=int(stats["node_steps"].sum()),
               leaf_steps=int(stats["leaf_steps"].sum()),
               node_rows=int(stats["node_rows"].sum()), **n)
    print(f"phase 7: {name} {what} L={L}: wrapper {row['ms']:.4f} ms, "
          f"kernel alone {row['kernel_only_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.1f} ms, bound {bound:.5f} ms from "
          f"{row['bound']} ({n['node_tests']} slab tests, "
          f"{n['leaf_tests']} triangle tests; rows read hold "
          f"{n['row_children']} children and {n['row_tris']} triangles); "
          f"kernel alone at the bound's "
          f"{bound / row['kernel_only_ms']:.1%} [{tag}]")
    return row


def blocks(im):
    h, w = (im.shape[0] // 8) * 8, (im.shape[1] // 8) * 8
    return im[:h, :w].mean(-1).reshape(h // 8, 8, w // 8, 8).mean((1, 3))


def gate(img, ref, what):
    """tests/test_regen.py's gates: whole-image means within 5%, median
    relative difference of 8x8 block means below 0.25. Returns a summary."""
    mg, mu = float(img.mean()), float(ref.mean())
    bg, bu = blocks(img), blocks(ref)
    mask = bu > 0.1 * bu.mean()
    med = float(np.median(np.abs(bg - bu)[mask] / bu[mask]))
    if not (abs(mg - mu) / mu < 0.05 and med < 0.25):
        raise AssertionError(f"{what}: means {mg} {mu}, block median {med}")
    return (f"means guided {mg:.5f} unguided {mu:.5f} "
            f"({abs(mg - mu) / mu:.4f} < 0.05), block median {med:.4f} < 0.25")


def guided_run(phase, tracer, tag, walk=False, seed=0):
    """Render through the tracer with the launch counts zeroed just before
    and read just after; checks the image, that the scene's kernel ran
    (the sweep, or with `walk` the BVH walk) and the other did not, that
    the descent kernels K3 and K4 ran, that no plain sweep, walk or
    descent ran on the card, and that no JAX module was loaded. Returns
    (image, counts, wall seconds)."""
    from ppg_tpu_torch.accel import brute as B
    from ppg_tpu_torch.accel import bvh_walk as BW
    from ppg_tpu_torch.guiding import descent as D

    B.reset_counts()
    D.reset_counts()
    t0 = time.time()
    img = tracer.render(seed=seed)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {**B.COUNTS, **BW.COUNTS, **D.COUNTS}
    W_, H_ = tracer.film.W, tracer.film.H
    if img.shape != (H_, W_, 3) or not np.isfinite(img).all() \
            or not img.mean() > 0:
        raise AssertionError(f"phase {phase}: bad image {img.shape} mean "
                             f"{img.mean()}")
    ran, idle = (("bvh_kernel", ("brute_kernel", "any_hit")) if walk else
                 ("brute_kernel", ("bvh_kernel", "bvh_any_hit")))
    if counts[ran] <= 0 or counts["plain_on_cuda"] != 0 \
            or any(counts[k] for k in idle):
        raise AssertionError(f"phase {phase}: main path did not run on the "
                             f"scene's kernel alone: {counts}")
    if counts["sd_lookup"] <= 0 or counts["sd_sample_pdf"] <= 0 \
            or counts["sd_plain_on_cuda"] != 0:
        raise AssertionError(f"phase {phase}: the SD-tree descents did not "
                             f"run through K3 and K4 alone: {counts}")
    bad = [m for m in sys.modules if m in ("jax", "ppg_tpu")
           or m.startswith(("jax.", "ppg_tpu."))]
    if bad:
        raise AssertionError(f"jax or ppg_tpu was imported: {bad[:5]}")
    for i, s in enumerate(tracer.stats):
        print(f"phase {phase}: iteration {i}: {s['passes']} passes, "
              f"{s['seconds']:.3f} s, {s['n_rays']} rays, "
              f"{s['n_rays'] / s['seconds'] / 1e6:.1f} Mrays/s, "
              f"avgPathLength {s['avg_path_length']:.3f} [{tag}]")
    return img, counts, wall


def walk_phases(tag, tmp):
    """Phases 7 and 8 (the BVH walk); the scene files go into `tmp`.
    Returns (timing rows, largest t/u/v error, counts of 8a and 8b)."""
    from ppg_tpu_torch.accel import bvh_walk as BW
    from ppg_tpu_torch.accel import traverse as TT
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.tools.soups import deep_soup

    # phase 7: the walk kernels against the plain walk on a scene of
    # 1,046,540 triangles and on the deep soup, and their timings
    ply = os.path.join(tmp, "bumpy_sphere.ply")
    n_sphere = bumpy_sphere_ply(ply, *SPHERE_SUBDIV)
    sc8, load_s = sphere_scene(ply, RES, BUDGET, "never")
    t0 = time.time()
    geom = TT.build_geometry(sc8.positions, sc8.faces, "cuda")
    torch.cuda.synchronize()
    build_bvh_s = time.time() - t0
    print(f"phase 7: box + bumpy sphere ({n_sphere} triangles in a binary "
          f"PLY of {os.path.getsize(ply)} bytes): {geom.num_tris} triangles, "
          f"load_scene {load_s:.2f} s, build_geometry {build_bvh_s:.2f} s "
          f"(native builder, rows to the card), {geom.rows.shape[0]} rows of "
          f"{geom.rows.shape[1]} floats, stack depth {geom.stack_depth}")
    soup = TT.build_geometry(*deep_soup(SOUP_T), "cuda")
    print(f"phase 7: deep soup {soup.num_tris} triangles: "
          f"{soup.rows.shape[0]} rows, stack depth {soup.stack_depth}")
    walk_rows, walk_err = {}, 0.0
    for what, g, args in (
            ("camera", geom, walk_rays("camera", WALK_L, 1, sc=sc8)),
            ("incoherent", geom, walk_rays("incoherent", WALK_L, 2, sc=sc8,
                                           geom=geom)),
            ("soup", soup, walk_rays("soup", SOUP_L, 3)),
            ("soup", soup, walk_rays("soup", SOUP_L - 37, 4))):
        _, stats, _, err = check_walk(g, args, what)
        walk_err = max(walk_err, err)
        if len(args[0]) == SOUP_L - 37:
            continue
        walk_rows[("bvh_closest", what)] = time_walk(
            "bvh_closest", g, lambda: BW.bvh_closest(g, *args),
            lambda: TT.bvh_closest_plain(g, *args), len(args[0]), 16, stats,
            tag, what)
    # any-hit on shadow-style rays: the NEE wavefront's size on the scene,
    # and the soup
    for what, g, args in (
            ("shadow", geom, walk_rays("incoherent", NEE_RES * NEE_RES, 5,
                                       sc=sc8, geom=geom, shadow=True)),
            ("soup shadow", soup, walk_rays("soup", SOUP_L, 6,
                                            shadow=True))):
        _, _, any_stats, err = check_walk(g, args, what)
        walk_err = max(walk_err, err)
        walk_rows[("bvh_any_hit", what)] = time_walk(
            "bvh_any_hit", g, lambda: BW.bvh_any_hit(g, *args),
            lambda: TT.bvh_closest_plain(g, *args, stop_on_hit=True),
            len(args[0]), 1, any_stats, tag, what)
    del soup

    # phase 8a: the guided render of phase 3 on that scene, through the
    # walk kernels only
    tracer8 = GuidedPathTracer(sc8, chunk=CHUNK, device="cuda")
    img8, counts8, wall8 = guided_run("8a", tracer8, tag, walk=True)
    rays8 = sum(s["n_rays"] for s in tracer8.stats)
    pass8 = sum(s["seconds"] for s in tracer8.stats)
    print(f"phase 8a: guided {RES}x{RES} {BUDGET} spp maxDepth {MAX_DEPTH}, "
          f"{geom.num_tris} triangles: {wall8:.2f} s wall, {pass8:.2f} s in "
          f"passes, {rays8} rays, {rays8 / pass8 / 1e6:.1f} Mrays/s, "
          f"{counts8['bvh_kernel']} walk launches, 0 sweeps, 0 plain walks "
          f"on the card [{tag}]")
    spp8 = tracer8.stats[-1]["spp"]
    t0 = time.time()
    ref8 = driver.render(sc8, spp=spp8, seed=1, chunk=CHUNK, device="cuda")
    print(f"phase 8a: unguided {spp8} spp in {time.time() - t0:.2f} s "
          f"[{tag}]; " + gate(img8, ref8, "phase 8a: guided vs unguided"))
    del tracer8, geom

    # phase 8b: the NEE path of phase 6 on that scene: every shadow ray
    # through the walk's any-hit kernel
    sc8b, load8b = sphere_scene(ply, NEE_RES, NEE_BUDGET, "always")
    tracer8b = GuidedPathTracer(sc8b, chunk=NEE_RES * NEE_RES,
                                overrides=NEE_FILTERS, device="cuda")
    img8b, counts8b, wall8b = guided_run("8b", tracer8b, tag, walk=True)
    if counts8b["bvh_any_hit"] <= 0:
        raise AssertionError(f"phase 8b: no any-hit launch: {counts8b}")
    rays8b = sum(s["n_rays"] for s in tracer8b.stats)
    pass8b = sum(s["seconds"] for s in tracer8b.stats)
    print(f"phase 8b: nee always {NEE_RES}x{NEE_RES} {NEE_BUDGET} spp "
          f"box/box/var (scene loaded in {load8b:.2f} s): {wall8b:.2f} s "
          f"wall, {pass8b:.2f} s in passes, {rays8b} rays with shadow rays, "
          f"{rays8b / pass8b / 1e6:.1f} Mrays/s, {counts8b['bvh_kernel']} "
          f"closest-hit and {counts8b['bvh_any_hit']} any-hit walk "
          f"launches, 0 sweeps, 0 plain walks on the card [{tag}]")
    spp8b = tracer8b.stats[-1]["spp"]
    t0 = time.time()
    ref8b = driver.render(sc8b, spp=spp8b, seed=3, chunk=NEE_RES * NEE_RES,
                          device="cuda")
    print(f"phase 8b: unguided nee {spp8b} spp in {time.time() - t0:.2f} s "
          f"[{tag}]; " + gate(img8b, ref8b,
                              "phase 8b: nee guided vs unguided"))
    return walk_rows, walk_err, counts8, counts8b


def descent_bound_ms(lane_bytes, row_bytes, ops):
    """The least time for a descent: its lanes' inputs and outputs and the
    distinct rows read once at the HBM rate, or its FP32 operations at
    the FP32 peak, whichever is larger. Returns (ms, which term)."""
    mem = (lane_bytes + row_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_PER_S * 1e3
    return (mem, "bytes") if mem >= ops_ms else (ops_ms, "operations")


def differ(got, want):
    """Lanes [L] where a result differs from the plain version's in a bit."""
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got != want if got.dim() == 1 else (got != want).any(-1)


def descent_phase(tag, tree, sc):
    """Phase 9: K3 (lookup with the meta) and K4 (the walk, sampling and
    point lanes, and its point mode) against the plain versions at
    L = CHUNK on `tree`, at the first bounce of cbox's camera rays (the
    positions) with uniform directions and uniforms; raises on any lane
    that differs in a bit. Times each through its wrapper, alone (100
    launches in a CUDA graph) and its plain version, beside its bound.
    Returns {(name, what): row}."""
    from ppg_tpu_torch.accel.traverse import closest_hit
    from ppg_tpu_torch.guiding import descent as D
    from ppg_tpu_torch.guiding import sdtree as G
    from ppg_tpu_torch.integrators.wavefront import DeviceScene
    from ppg_tpu_torch.render.sensor import make_sensor
    from ppg_tpu_torch.tools.sdtree_cases import unit

    L = CHUNK
    rng = np.random.default_rng(9)
    pos = rng.uniform(0, 1, (L, 2)) * [sc.film["width"], sc.film["height"]]
    o, d, t_min, t_max = make_sensor(sc.sensor, sc.film, "cuda").sample_rays(
        torch.from_numpy(pos.astype(np.float32)).cuda())
    geom = DeviceScene.from_scene(sc, "cuda").geom
    t = closest_hit(geom, o, d, t_min, t_max)[1]
    p = (o + t[:, None] * d).contiguous()
    mask = torch.from_numpy(rng.random(L) < 0.9).cuda()
    u = torch.from_numpy(rng.random((L, G.MAX_Q_DEPTH + 2)).astype(
        np.float32)).cuda()
    is_point = torch.from_numpy(rng.random(L) < 0.5).cuda()
    pc = G.dir_to_canonical(torch.from_numpy(unit(rng, L)).cuda())
    print(f"phase 9: the tree of phase 3's last iteration: "
          f"{tree.s_dtree.shape[0]} spatial nodes (s_depth {tree.s_depth}), "
          f"{tree.ds_root.shape[0]} dtrees, {tree.qs_sum.shape[0]} quadtree "
          f"nodes (q_depth {tree.q_depth}); {L} lanes at the first bounce "
          f"of cbox's camera rays, 90% in the mask")

    # K3 bit for bit (frac too: both take the CUDA math library's expf)
    got = G.lookup_meta(tree, p, mask)
    want = G.lookup_meta_plain(tree, p, mask)
    torch.cuda.synchronize()
    bad3 = sum(differ(a, b) for a, b in zip(got, want)) > 0
    frac_ulp = int((got[4].view(torch.int32).long()
                    - want[4].view(torch.int32).long()).abs().max())
    _, _, st3 = G.lookup_plain(tree, p, return_stats=True)
    ids, root, uniform = want[0], want[2], want[3]
    # K4 bit for bit: sampling and point lanes, then the point mode
    pfin, pdf = D.sample_pdf(tree, u, is_point, pc, root, uniform)
    want_p, want_pdf, st4 = G.sample_pdf_canonical_plain(
        tree, u, is_point, pc, root, uniform, return_stats=True)
    bad4 = differ(pfin, want_p) | differ(pdf, want_pdf)
    nee = D.pdf_point(tree, pc, root, uniform)
    want_nee, stp = G.sample_pdf_canonical_plain(
        tree, torch.zeros_like(u), torch.ones_like(is_point), pc, root,
        uniform, return_stats=True)[1:]
    badp = differ(nee, want_nee)
    n3, n4, np_ = int(bad3.sum()), int(bad4.sum()), int(badp.sum())
    err = {"sd_lookup": max(float((a - b).abs().max()) for a, b in
                            ((got[1], want[1]), (got[4], want[4]))),
           "sd_sample_pdf": max(float((a - b).abs().max()) for a, b in
                                ((pfin, want_p), (pdf, want_pdf),
                                 (nee, want_nee)))}
    lv3, lv4, lvp = (x["levels"].float() for x in (st3, st4, stp))
    walked = ~uniform
    print(f"phase 9: sd_lookup: {L} lanes compared, {n3} differ in a bit "
          f"(id, voxel, root, uniform, frac; frac at most {frac_ulp} ulp "
          f"apart); spatial levels walked mean {float(lv3.mean()):.3f} max "
          f"{int(lv3.max())}, {int((ids >= 0).sum())} lanes with a dtree, "
          f"{int(uniform.sum())} uniform")
    print(f"phase 9: sd_sample_pdf: {L} lanes compared, {n4} differ in a "
          f"bit (canonical point, pdf), {int((~is_point).sum())} sampling; "
          f"quadtree levels walked on the {int(walked.sum())} non-uniform "
          f"lanes mean {float(lv4[walked].mean()):.3f} max "
          f"{int(lv4.max())}; point mode (pdf_dir2): {L} lanes compared, "
          f"{np_} differ, levels mean {float(lvp[walked].mean()):.3f} max "
          f"{int(lvp.max())}")
    if n3 or n4 or np_:
        raise AssertionError(f"phase 9: {n3} lookup, {n4} walk and {np_} "
                             f"point-mode lanes differ from the plain "
                             f"versions")

    # one [L, 4] row gather of the plain walk (qs_sum[node], PERF.md §7)
    # beside index_select of the same rows, alone in a CUDA graph, at
    # random nodes of the pool
    node = torch.randint(tree.qs_sum.shape[0], (L,), device="cuda")
    adv = graph_ms(lambda: tree.qs_sum[node])
    sel = graph_ms(lambda: torch.index_select(tree.qs_sum, 0, node))
    print(f"phase 9: one [{L}, 4] float row gather at random nodes, alone: "
          f"qs_sum[node] {adv:.4f} ms, index_select {sel:.4f} ms, bound "
          f"{(L * 24 + tree.qs_sum.numel() * 4) / HBM_BYTES_PER_S * 1e3:.5f}"
          f" ms from bytes (8 B of index and 16 of row a lane, the pool "
          f"once) [{tag}]")

    # the bounds, from what the plain walks needed on these lanes
    n_dtrees = int(ids.clamp(min=0).unique().numel())
    samp = walked & ~is_point
    bounds = {
        ("sd_lookup", "cbox"): descent_bound_ms(
            L * (12 + 1 + 4 + 12 + 4 + 1 + 4),
            S_ROW_BYTES * st3["nodes"].numel() + META_ROW_BYTES * n_dtrees,
            OPS_S_LEVEL * float(lv3.sum()) + OPS_LOOKUP_LANE * L),
        ("sd_sample_pdf", "cbox"): descent_bound_ms(
            L * (8 + 4 + 1 + 1 + 8 + 12) + 4 * float(lv4[samp].sum()),
            Q_ROW_BYTES * st4["nodes"].numel(),
            OPS_Q_SAMPLE * float(lv4[samp].sum())
            + OPS_Q_POINT * float(lv4[walked & is_point].sum())
            + OPS_LEAF_POINT * L),
        ("sd_sample_pdf", "point mode"): descent_bound_ms(
            L * (8 + 4 + 1 + 4), Q_ROW_BYTES * stp["nodes"].numel(),
            OPS_Q_POINT * float(lvp.sum()) + L)}
    runs = {("sd_lookup", "cbox"): (
                lambda: G.lookup_meta(tree, p, mask),
                lambda: G.lookup_meta_plain(tree, p, mask)),
            ("sd_sample_pdf", "cbox"): (
                lambda: D.sample_pdf(tree, u, is_point, pc, root, uniform),
                lambda: G.sample_pdf_canonical_plain(tree, u, is_point, pc,
                                                     root, uniform)),
            ("sd_sample_pdf", "point mode"): (
                lambda: D.pdf_point(tree, pc, root, uniform),
                lambda: G.pdf_dir2(tree, G.canonical_to_dir(pc), root,
                                   uniform))}
    rows = {}
    for key, (fn, plain) in runs.items():
        bound, by = bounds[key]
        row = dict(what=key[1], L=L, ms=cuda_ms(fn, 50, batches=5),
                   kernel_only_ms=graph_ms(fn),
                   plain_ms=cuda_ms(plain, 5, batches=3), bound_ms=bound,
                   bound_by=by, bound="memory" if by == "bytes" else "fp32",
                   max_abs_err=err[key[0]])
        rows[key] = row
        print(f"phase 9: {key[0]} {key[1]} L={L}: wrapper {row['ms']:.4f} "
              f"ms, kernel alone {row['kernel_only_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {bound:.5f} ms from "
              f"{row['bound']}; kernel alone at the bound's "
              f"{bound / row['kernel_only_ms']:.1%} [{tag}]")
    return rows


def capture_pending():
    """Patches guiding/sdtree.py so that the training passes leave the
    arguments of their largest bincount_add (K5's accumulation) and their
    last _adam_chain (K6) in the returned dict; returns (dict, undo)."""
    from ppg_tpu_torch.guiding import sdtree as G

    seen = {}
    add, adam = G.bincount_add, G._adam_chain

    def bincount_add(target, idx, val):
        if idx.numel() >= seen.get("k5_n", 0):
            seen.update(k5=(target.clone(), idx, val), k5_n=idx.numel())
        return add(target, idx, val)

    def adam_chain(*args):
        seen["k6"] = args
        return adam(*args)

    G.bincount_add, G._adam_chain = bincount_add, adam_chain

    def undo():
        G.bincount_add, G._adam_chain = add, adam
    return seen, undo


def pending_phase(tag, seen):
    """Phase 10: the plain K5 accumulation, K6 and K7 at the shapes the
    training passes of phase 5 gave them, beside their bound; K5's is one
    index_add_, the library call that computes it. Returns {name: row}."""
    from ppg_tpu_torch.guiding import sdtree as G
    from ppg_tpu_torch.render.film import Film

    rows = {}
    # K5: target[idx] += val; 4 B of index and 4 of value per record, the
    # target read and written, one add per record
    target, idx, val = seen["k5"]
    N, M = idx.numel(), target.numel()
    bound, by = descent_bound_ms(8 * N + 8 * M, 0, N)
    ms = cuda_ms(lambda: target.index_add_(0, idx.long(), val), 20, 3)
    rows["K5"] = dict(what=f"N={N} records into {M} cells", ms=None,
                      plain_ms=ms, library_ms=ms, bound_ms=bound,
                      bound_by=by)
    # K6: the records' 6 fields (24 B) and the dtree's 6 state values in
    # and out; per record about 30 operations (gradient and bucket), per
    # dtree and round 62 buckets of about 10
    args = seen["k6"]
    sdt, n_rec = args[0], args[1].numel()
    T = sdt.opt_var.numel()
    bound, by = descent_bound_ms(24 * n_rec + 2 * 24 * T, 0,
                                 30 * n_rec + T * G.ADAM_ROUNDS
                                 * G.ADAM_B * 10)
    rows["K6"] = dict(what=f"{n_rec} records, {T} dtrees", ms=None,
                      plain_ms=cuda_ms(lambda: G._adam_chain(*args), 3, 3),
                      library_ms=None, bound_ms=bound, bound_by=by)
    # K7: a chunk's box splat into the two film buffers: values (12 B) and
    # the valid flag in, rgb (12 B) and weight (4 B) read and written
    C = CHUNK
    bufs = (torch.zeros((C, 3), device="cuda"), torch.zeros(C, device="cuda"))
    li = torch.rand((C, 3), device="cuda")
    valid = torch.rand(C, device="cuda") < 0.99
    bound, by = descent_bound_ms(C * (12 + 1 + 2 * 12 + 2 * 4), 0, 5 * C)
    rows["K7"] = dict(what=f"C={C}", ms=None, plain_ms=cuda_ms(
        lambda: Film.splat_box_linear(bufs, 0, li, valid), 20, 3),
        library_ms=None, bound_ms=bound, bound_by=by)
    for k, r in rows.items():
        print(f"phase 10: {k} {r['what']}: plain {r['plain_ms']:.4f} ms"
              + (f" (index_add_, the library call)" if k == "K5" else "")
              + f", bound {r['bound_ms']:.5f} ms from {r['bound_by']} "
              f"[{tag}]")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ppg_tpu_torch.accel import brute as B
    from ppg_tpu_torch.accel import bvh_walk as BW
    from ppg_tpu_torch.guiding import descent as D
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.scene import mini_cbox
    from ppg_tpu_torch.tools.sdtree_cases import capture_sampling_trees

    # phase 0: versions and the card
    tag = card()
    print(tag)  # as nvidia-smi prints it: name, power limit
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"card {tag}")

    # phase 1: build the kernels; the port's own host libraries must build
    # and load
    t0 = time.time()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, together
        list(pool.map(lambda build: build(), (B.build, BW.build, D.build)))
    build_s = time.time() - t0
    # A host C++ library may die with SIGILL on a CPU it was not built
    # for, which no try can catch, so they are first driven in a
    # subprocess (which also builds them into build/ppg_tpu_torch/).
    r = subprocess.run(
        [sys.executable, "-c",
         "from ppg_tpu_torch import native; "
         "from ppg_tpu_torch.accel.traverse import "
         "native_builder_loaded, pack_triangles; "
         "from ppg_tpu_torch.guiding.host import HostSDTree; "
         "from ppg_tpu_torch.scene import mini_cbox; "
         "sc = mini_cbox(res=16, budget=4, max_depth=2, nee='never'); "
         "assert native_builder_loaded(); "
         "tri, perm = pack_triangles(sc.positions, sc.faces); "
         "assert sorted(perm) == list(range(len(sc.faces))); "
         "HostSDTree(sc.aabb_min, sc.aabb_max).build(); "
         "print('loaded', native.bvh_lib()._name, native.sdtree_lib()._name)"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0 or "loaded" not in r.stdout:
        raise RuntimeError(f"host native libraries failed to load "
                           f"(rc {r.returncode}): {r.stderr[-2000:]}")
    libs = [os.path.relpath(x, ROOT) for x in r.stdout.split()[1:]]
    print(f"phase 1: built csrc/brute.cu, csrc/bvh.cu and csrc/sdtree.cu in "
          f"{build_s:.2f} s; the host BVH "
          f"builder and SD-tree build run natively in a subprocess from "
          f"{', '.join(libs)}")

    # phase 2: the kernels against their plain version, bit for bit (the
    # stated tolerance, near-ties at most 1e-4 of the lanes, is not
    # needed); the ragged lengths end in a partial block of the grid
    max_err = 0.0
    for T, L, edges in ((12, 1 << 20, False), (130, 1 << 20, False),
                        (1024, 1 << 20, False), (12, (1 << 20) - 37, False),
                        (1024, 1000, False), (12, 1 << 20, True),
                        (1024, 1 << 18, True)):
        args = soup(T, L, seed=T + L, edges=edges)
        hits, err = same_bits(B.brute_closest(*args),
                              B.brute_sweep_plain(*args))
        max_err = max(max_err, err)
        sh = soup(T, L, seed=T + L, shadow=True, edges=edges)
        want_sh = B.brute_sweep_plain(*sh)[0] >= 0
        occ = B.brute_any_hit(*sh)
        differ = int((occ != want_sh).sum())
        if differ or bool(occ[sh[4] < sh[3]].any()):
            raise AssertionError(f"any-hit: {differ} lanes differ in "
                                 f"occlusion, or a parked lane is occluded")
        print(f"phase 2: T={T} L={L}{' rays at edges' if edges else ''}: "
              f"closest-hit 0 lanes pick another triangle (0 near-ties), "
              f"t/u/v bit-identical on {hits} hits; any-hit 0 lanes differ, "
              f"{int(occ.sum())} occluded, parked lanes never occluded")
    # timings: through the wrapper (host side included), the kernel alone
    # (100 launches in a CUDA graph) and the plain version
    rows = {}
    for name, T, L in (("brute_closest", 12, 65536),
                       ("brute_closest", 12, CHUNK),
                       ("brute_closest", 1024, CHUNK),
                       ("brute_any_hit", 12, NEE_RES * NEE_RES),
                       ("brute_any_hit", 12, CHUNK),
                       ("brute_any_hit", 1024, CHUNK)):
        closest = name == "brute_closest"
        args = soup(T, L, seed=7, shadow=not closest)
        fn = B.brute_closest if closest else B.brute_any_hit
        plain = (lambda: B.brute_sweep_plain(*args)) if closest else \
            (lambda: B.brute_sweep_plain(*args)[0] >= 0)
        pairs = T * L if closest else visited_pairs(*args)
        bound, by = bound_ms(T, L, 16 if closest else 1, pairs)
        row = dict(T=T, L=L, ms=cuda_ms(lambda: fn(*args), 50, batches=5),
                   kernel_only_ms=graph_ms(lambda: fn(*args)),
                   plain_ms=cuda_ms(plain, 20 if T < 64 else 3),
                   bound_ms=bound, bound_by=by,
                   bound="memory" if by == "bytes" else "fp32",
                   pairs=pairs)
        rows[(name, T, L)] = row
        print(f"phase 2: {name} T={T} L={L}: wrapper {row['ms']:.4f} ms, "
              f"kernel alone {row['kernel_only_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {bound:.5f} ms from "
              f"{row['bound']} ({pairs} pairs); kernel alone at the bound's "
              f"{bound / row['kernel_only_ms']:.1%}, wrapper at "
              f"{bound / row['ms']:.1%} [{tag}]")

    # phase 3: the guided render, through the kernel only
    sc = mini_cbox(res=RES, budget=BUDGET, max_depth=MAX_DEPTH, nee="never")
    tracer = GuidedPathTracer(sc, chunk=CHUNK, device="cuda")
    with capture_sampling_trees(tracer) as trees3:
        img, counts, wall = guided_run(3, tracer, tag)
    sched = [(s["passes"], s["is_final"]) for s in tracer.stats]
    if sched != [(1, False), (2, False), (4, False), (8, False), (17, True)]:
        raise AssertionError(f"unexpected iteration schedule {sched}")
    rays = sum(s["n_rays"] for s in tracer.stats)
    pass_s = sum(s["seconds"] for s in tracer.stats)
    print(f"phase 3: guided {RES}x{RES} {BUDGET} spp maxDepth {MAX_DEPTH}: "
          f"{wall:.2f} s wall, {pass_s:.2f} s in passes, {rays} rays, "
          f"{rays / pass_s / 1e6:.1f} Mrays/s, {counts['brute_kernel']} "
          f"kernel launches, {counts['sd_lookup']} K3 and "
          f"{counts['sd_sample_pdf']} K4 launches, 0 plain sweeps or "
          f"descents on the card, no jax [{tag}]")

    # phase 4: unguided at the final image's spp; both are unbiased
    spp = tracer.stats[-1]["spp"]
    t0 = time.time()
    ref = driver.render(sc, spp=spp, seed=1, chunk=CHUNK, device="cuda")
    print(f"phase 4: unguided {spp} spp in {time.time() - t0:.2f} s [{tag}]; "
          + gate(img, ref, "phase 4: guided vs unguided"))

    # phase 5: cbox-improved at the reference's settings: 127 one-spp
    # passes in 7 iterations, the final image the inverse-variance mean of
    # the last 4 iteration images
    tracer5 = GuidedPathTracer(sc, chunk=CHUNK, overrides=IMPROVED,
                               device="cuda")
    pending, undo = capture_pending()
    try:
        img5, counts5, wall5 = guided_run(5, tracer5, tag)
    finally:
        undo()
    sched = [(s["passes"], s["is_final"]) for s in tracer5.stats]
    if sched != [(1 << i, i == 6) for i in range(7)]:
        raise AssertionError(f"phase 5: unexpected schedule {sched}")
    opt_var = tracer5.sdtree.opt_var
    n_trained = int((opt_var != 0).sum())
    if n_trained == 0:
        raise AssertionError("phase 5: the kl Adam left every opt_var at 0")
    rays5 = sum(s["n_rays"] for s in tracer5.stats)
    pass5 = sum(s["seconds"] for s in tracer5.stats)
    print(f"phase 5: cbox-improved {RES}x{RES} {BUDGET} spp maxDepth "
          f"{MAX_DEPTH}: {wall5:.2f} s wall, {pass5:.2f} s in passes, "
          f"{rays5} rays, {rays5 / pass5 / 1e6:.1f} Mrays/s, "
          f"{counts5['brute_kernel']} kernel launches, {counts5['sd_lookup']} "
          f"K3 and {counts5['sd_sample_pdf']} K4 launches, 0 plain sweeps or "
          f"descents on the card, {n_trained} of {opt_var.numel()} leaves with a trained "
          f"fraction (|opt_var| max {float(opt_var.abs().max()):.4f}), "
          f"no jax [{tag}]")
    t0 = time.time()
    ref5 = driver.render(sc, spp=BUDGET, seed=2, chunk=CHUNK, device="cuda")
    print(f"phase 5: unguided {BUDGET} spp in {time.time() - t0:.2f} s "
          f"[{tag}]; " + gate(img5, ref5, "phase 5: improved vs unguided"))

    # phase 6: the NEE path, shadow rays through the kernel's any-hit
    sc6 = mini_cbox(res=NEE_RES, budget=NEE_BUDGET, max_depth=MAX_DEPTH,
                    nee="always")
    tracer6 = GuidedPathTracer(sc6, chunk=NEE_RES * NEE_RES,
                               overrides=NEE_FILTERS, device="cuda")
    img6, counts6, wall6 = guided_run(6, tracer6, tag)
    if counts6["any_hit"] <= 0:
        raise AssertionError(f"phase 6: no any-hit launch: {counts6}")
    for s in tracer6.stats:
        # every diffuse shade casts a shadow ray beside its continuation
        # ray: close to 2 rays per shade beyond the camera rays (at most 1
        # without NEE)
        n_samples = s["spp"] * NEE_RES * NEE_RES
        if not s["n_rays"] - n_samples > 1.8 * s["avg_path_length"] \
                * n_samples:
            raise AssertionError(f"phase 6: shadow rays missing from "
                                 f"n_rays: {s}")
    rays6 = sum(s["n_rays"] for s in tracer6.stats)
    pass6 = sum(s["seconds"] for s in tracer6.stats)
    print(f"phase 6: nee always {NEE_RES}x{NEE_RES} {NEE_BUDGET} spp box/box/"
          f"var: {wall6:.2f} s wall, {pass6:.2f} s in passes, {rays6} rays "
          f"with shadow rays, {rays6 / pass6 / 1e6:.1f} Mrays/s, "
          f"{counts6['brute_kernel']} closest-hit and {counts6['any_hit']} "
          f"any-hit kernel launches, {counts6['sd_lookup']} K3 and "
          f"{counts6['sd_sample_pdf']} K4 launches, 0 plain sweeps or "
          f"descents on the card, no jax [{tag}]")
    spp6 = tracer6.stats[-1]["spp"]
    t0 = time.time()
    ref6 = driver.render(sc6, spp=spp6, seed=3, chunk=NEE_RES * NEE_RES,
                         device="cuda")
    print(f"phase 6: unguided nee {spp6} spp in {time.time() - t0:.2f} s "
          f"[{tag}]; " + gate(img6, ref6, "phase 6: nee guided vs unguided"))

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        walk_rows, walk_err, counts8, counts8b = walk_phases(tag, tmp)

    # phase 9: the descent kernels on the tree phase 3's last iteration
    # sampled from; phase 10: the kernels still to port
    sd_rows = descent_phase(tag, trees3[-1], sc)
    pending_phase(tag, pending)

    # launches: every launch of each kernel over the main-path renders
    # (phases 3, 5 and 6 for the sweep, 8a and 8b for the walk); the
    # numbers are those of the kernel's main-path shape (the sweep: T = 12
    # triangles, the render's wavefront; the walk: camera rays and the
    # NEE wavefront's shadow rays on the 1,046,540-triangle scene)
    sweep = (counts, counts5, counts6)
    guided = sweep + (counts8, counts8b)
    launches = {
        "brute_closest": sum(c["brute_kernel"] for c in sweep),
        "brute_any_hit": sum(c["any_hit"] for c in sweep),
        "bvh_closest": counts8["bvh_kernel"] + counts8b["bvh_kernel"],
        "bvh_any_hit": counts8["bvh_any_hit"] + counts8b["bvh_any_hit"],
        "sd_lookup": sum(c["sd_lookup"] for c in guided),
        "sd_sample_pdf": sum(c["sd_sample_pdf"] for c in guided)}
    main = {"brute_closest": (rows, ("brute_closest", 12, CHUNK)),
            "brute_any_hit": (rows, ("brute_any_hit", 12,
                                     NEE_RES * NEE_RES)),
            "bvh_closest": (walk_rows, ("bvh_closest", "camera")),
            "bvh_any_hit": (walk_rows, ("bvh_any_hit", "shadow")),
            "sd_lookup": (sd_rows, ("sd_lookup", "cbox")),
            "sd_sample_pdf": (sd_rows, ("sd_sample_pdf", "cbox"))}
    source = {"brute": ("brute.cu", "ppg_tpu/accel/pallas_brute.py:102",
                        max_err),
              "bvh": ("bvh.cu", "ppg_tpu/accel/traverse.py:333", walk_err),
              "sd_lookup": ("sdtree.cu", "ppg_tpu/guiding/sdtree.py:166",
                            sd_rows[("sd_lookup", "cbox")]["max_abs_err"]),
              "sd_sample_pdf": ("sdtree.cu",
                                "ppg_tpu/guiding/sdtree.py:667",
                                max(r["max_abs_err"] for k, r in
                                    sd_rows.items()
                                    if k[0] == "sd_sample_pdf"))}
    kernels = []
    for name, (table, key) in main.items():
        row = table[key]
        src, replaces, err = source[name if name.startswith("sd")
                                    else name.split("_")[0]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ppg_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": row["ms"], "kernel_only_ms": row["kernel_only_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound": row["bound"],
            "library_ms": None,
            "shapes": [dict(r) for k, r in table.items() if k[0] == name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

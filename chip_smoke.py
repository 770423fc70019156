"""Smoke run of ppg_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the triangle-sweep kernels (closest hit and any hit) from
ppg_tpu_torch/csrc/brute.cu, the BVH16 walk kernels from
ppg_tpu_torch/csrc/bvh.cu, the SD-tree descent kernels (K3 lookup, K4
sample-and-pdf walk) from ppg_tpu_torch/csrc/sdtree.cu, the training
kernels (K5a directional splat targets, K5b spatial box walk, K6 Adam
rounds) from ppg_tpu_torch/csrc/train.cu, K5's accumulation from
ppg_tpu_torch/csrc/reduce.cu and the film splats (K7 for the box
filter, K7s for the others) from ppg_tpu_torch/csrc/film.cu (one nvcc
each, started together) and the
host libraries from ppg_tpu_torch/csrc/host, holds the kernels against
their plain PyTorch versions (the kernels are bit-identical to them by design,
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
Every guided render (phases 3, 5, 6, 8a, 8b, 13, 14) must run its SD-tree
descents through K3 and K4, its splat targets through K5a, the box
spatial filter's walk (phases 6, 8b) through K5b, the learned fraction's
Adam rounds (phases 5, 6, 8b, 13, 14) through K6, every sum into the building
pool and the Adam statistics through K5 and every film splat through K7
(K7s in phase 13),
with no plain descent, target walk, Adam round, sum or film splat and no
index_add_ on the card. Phases 5 and 13 also print, per iteration, the
chunk steps' host times, the host tree's refine and build seconds, its
spatial leaves and the garbage collector's collections and their
seconds (HostTimes), beside the pass seconds, and the host's time a
launch (launch_us), which is also printed after phases 6 and 8-12. Then:
- phase 9: K3 and K4 against their plain versions, bit for bit, at
  L = 262,144 on the tree phase 3's last iteration sampled from (the
  uniforms level-major, as the tracer draws them; K3 in its three
  modes), timed beside their bound (from the plain walks' levels and
  rows), with the spatial levels and K3's loads a lane;
- phase 10: K5 on the largest call of each kind that phases 3, 5 and 6
  made (the statistical weights, the box and the nearest directional
  splats, the Adam bucket sums S0/S1 and the gradient sums G0/W), bit for
  bit against the plain version on the card and on the CPU and against
  itself with the records permuted, and K7 at a chunk of CHUNK pixels,
  bit for bit; each timed beside its bound and, for K5, index_add_'s
  time, the path the call took (shared or global) and each pass's
  device time on its own (torch.profiler);
- phase 11: K5a, K5b and K6 against their plain versions, bit for bit,
  at the shapes the main path gave them (phase 5: K5a's box targets at
  shade time, nearest and at given depths on the same records, K6;
  phase 6: K5b, K5a at splat time), timed beside their bound (from the
  plain versions' levels, pops and steps);
- phase 12: repeatability. One training pass of phase 5's settings run
  twice from the same seed and the same tree must leave bit-identical
  building pools and Adam state; phase 5's render is made twice more
  with digests of every stage of every chunk step (the tree it samples,
  the traced paths and records, the film, the building pools, the Adam
  state), and the script reports whether the images are bit-identical
  and, if not, the first stage whose outputs differ; phase 13's
  configuration at 16 spp, rendered twice from one seed, must be
  bit-identical;
- phase 13: the render front end. Phase 5's settings with a thin lens
  focused on the back wall and the gaussian filter at 512x512, 127 spp,
  every chunk's film through K7s (no K7, no plain splat on the card),
  gated against driver.render with the sobol sampler, with the launches
  per training wavefront (beside phase 5's) and the sobol reference's
  seconds and launches per wavefront; K7s against its plain version for
  the five filters, one film and two, bit for bit on the render's last
  chunk, timed beside its bound; the orthographic, spherical and
  radiance-meter cameras and the five QMC kinds rendered unguided at
  128x128 (finite, and by the mean gate against the independent sampler's
  image of the same camera); a 15 s time-budget render with an .sdt dump
  per iteration read back; a checkpointed render stopped after its first
  iteration and resumed, bit-identical to the uninterrupted render;
- phase 14: the BSDF table. The box in glossy, plastic and glass
  materials (scene/testscenes.py::mini_cbox_materials: a GGX
  roughplastic floor, a Beckmann roughconductor back wall, a plastic
  wall, a Beckmann roughdielectric and a smooth dielectric sphere of
  16,128 triangles each, through the walk) at 512x512, 127 spp, maxDepth
  10 and cbox-improved's settings, every visible-normal sample through
  K8 (one launch a sample_bsdf, no plain sample on the card, and none
  in the diffuse phases), gated against driver.render of the same
  scene, with its launches per training wavefront beside phase 5's;
  the configuration at 16 spp rendered twice from one seed, which must
  be bit-identical; the lanes of each bounce's visible-normal call in
  one training wavefront (gated in, GGX, Beckmann rounds, normal
  incidence, on ended paths); K8 against its plain version with the
  same gate, bit for bit on every lane, on the render's last call, timed
  beside its gated bound and the ungated one; and whether ATen's CUDA
  erfinv is its CPU algorithm (it is not: it is the CUDA math library's
  erfinvf, which K8 calls);
- phase 15: the material wrappers. The box in mask, null, blendbsdf,
  mixturebsdf, coating and roughcoating (scene/testscenes.py::
  mini_cbox_wrappers_xml, loaded through load_scene: a blend floor, a
  GGX roughcoating over a Beckmann roughconductor, a coating over the
  red diffuse, a mixture of the green diffuse and a GGX roughconductor,
  the mask panel above the luminaire, a null rectangle, and a coated
  conductor and a Beckmann roughcoated diffuse sphere: 32,272 triangles
  through the walk) at 512x512, 127 spp, maxDepth 10, cbox-improved's
  settings and nee always, every shadow ray through the null and mask
  walk (its crossings and host reads a bounce printed), every visible
  normal through K8 (the table's and roughcoating's interface's calls,
  no plain sample on the card); gated against driver.render of the
  same scene at 64 spp, and driver.render with nee never against nee
  always (both unbiased for one scene, 64 spp each); its launches per
  training wavefront beside phases 14 and 5 and beside PERF.md's
  prediction, and on its tree with NEE off; the configuration
  at 16 spp rendered twice from one seed, bit-identical; K8 bit for
  bit with its gated plain version on the render's last table call and
  last interface call, timed beside its bound;
- phase 16: the textures. The textured box (scene/testscenes.py::
  mini_cbox_textures_xml: a 2048^2 EXR bitmap floor, filterType ewa and
  uscale 4, whose MIP atlas is 134 MB of float16 on the card; a
  checkerboard back wall; a 512^2 bump map over a GGX roughplastic; a
  normal map over the red diffuse; a sphere in a `scale` texture, 16,142
  triangles through the walk; the mask panel's gridtexture opacity) at
  512x512, 127 spp, maxDepth 10, cbox-improved's settings and nee
  always: every lookup through K9 (a site's stacked rows and fields in
  one launch, the camera's uv Jacobian on the first bounce; the bump
  map's taps in one; the shadow walk's textured opacity at each
  crossing), no plain lookup on the card; gated against driver.render of
  the same scene at 64 spp; its launches per training wavefront (and K9's)
  beside phase 15's and PERF.md's prediction, and with NEE off; rendered
  twice at 16 spp from one seed, bit-identical; K9 bit for bit with its
  plain version on the render's last call of each kind (the site's on
  the first bounce and on a later one, the bump map's, the walk's), each
  with its lookups and timed beside its bound; and 128x128 renders at 16
  spp, each gated against its unguided render, their luminaire turned to
  the floor: vertex colours from a PLY, the wireframe and the curvature
  textures, and an orthographic camera on the EWA floor (the footprint
  path).
Every phase prints its own lines; any failure raises and the script exits
non-zero. The line before the last is a JSON object describing the
kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import copy
import gc
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
# per lookup lane (normalise 3 subtracts and 3 divides, 6 clamp compares)
# and per lane's meta (multiply, divide, 4 compares, negate, exp, add,
# divide), per
# quadtree level of a sampling lane (the sum 3, the conditional CDF 13,
# the factor 3, acc 1, origin 4, scale 1) and of a point lane (the sum 3,
# 4 compares, the rescale 4, the factor 3, acc 1, origin 4, scale 1), and
# per sampled lane's leaf point (2 multiplies, 2 adds, 4 compares); the
# rows: 12 B per spatial node, 32 B per quadtree node, 16 B per dtree's
# meta
OPS_S_LEVEL, OPS_NORMALISE, OPS_META = 4, 12, 10
OPS_LOOKUP_LANE = OPS_NORMALISE + OPS_META
OPS_Q_SAMPLE, OPS_Q_POINT, OPS_LEAF_POINT = 25, 20, 8
S_ROW_BYTES, Q_ROW_BYTES, META_ROW_BYTES = 12, 32, 16
# the training kernels (csrc/train.cu's note): FP32 operations per
# quadtree level of a directional descent (2 compares, the rescale's 2
# subtracts and 2 multiplies) and per box-filter record (the box 5, each
# of 4 corners: 4 clamp compares, the cell's side 1, origin 6, 2 adds, 4
# min/max, 2 subtracts, 2 clamp compares, a multiply and a divide; the
# weights' dedup 6 compares); per box-walk record (normalise 3 subtracts
# and 6 divides, the box 6, the volume 3) and per node popped (the larger
# of a leaf's overlap, 17, and divide, and an internal node's two child
# overlaps and halving, 36); per Adam bucket and gradient evaluation (the
# shift, clamp and reciprocals 6, the two products and their sum 3, its
# share of the halving sum 1), per evaluation (the mean 4) and per step
# taken (the closed form's 30); the rows: 16 B a building quadtree node,
# 4 B a dtree's root, 12 B a spatial node
OPS_DIR_LEVEL, OPS_BOX_LANE = 6, 100
OPS_SBOX_RECORD, OPS_SBOX_POP = 18, 36
OPS_ADAM_BUCKET, OPS_ADAM_EVAL, OPS_ADAM_STEP = 10, 4, 30
QB_ROW_BYTES, ROOT_BYTES = 16, 4
# the training kernels each guided render must launch (csrc/train.cu,
# csrc/reduce.cu)
TRAIN_KERNELS = {3: ("sd_dir_targets", "reduce_add"),
                 5: ("sd_dir_targets", "sd_adam", "reduce_add"),
                 6: ("sd_dir_targets", "sd_stree_box", "sd_adam",
                     "reduce_add"),
                 "8a": ("sd_dir_targets", "reduce_add"),
                 "8b": ("sd_dir_targets", "sd_stree_box", "sd_adam",
                        "reduce_add")}
# the film kernel each guided render must launch: K7 for the box filter,
# K7s for phase 13's gaussian
FILM_KERNELS = {13: "film_splat_filter"}
TRAIN_KERNELS[13] = TRAIN_KERNELS[14] = TRAIN_KERNELS[15] = TRAIN_KERNELS[5]
TRAIN_KERNELS[16] = TRAIN_KERNELS[5]
# the renders whose scenes hold microfacet rows: K8 must launch there and
# nowhere else; the renders of textured scenes: K9 likewise
VNDF_PHASES = {14, 15, 16}
TEX_PHASES = {16}
# copies of K7's timed inputs taken in turn, so that they exceed the L2
K7_SETS = 4
# phase 13: the thin lens at the perspective camera's pose, focused on the
# back wall (4.5 in front of it), the gaussian filter; K7s's timed inputs
# (13 MB a set, two films) taken in turn from K7S_SETS copies; the other
# cameras and the QMC kinds rendered unguided at FRONT_RES^2, FRONT_SPP
# spp; the time-budget render's seconds
APERTURE, FOCUS = 0.05, 4.5
FILTERS = ("tent", "gaussian", "mitchell", "catmullrom", "lanczos")
K7S_SETS = 6
FRONT_RES, FRONT_SPP = 128, 32
TIME_BUDGET_S = 15.0
# K7s's operations, the least the work needs (csrc/film.cu's note): the
# filters are separable, so a sample's filter is evaluated once at each
# column and each row of its window on the film, each evaluation the
# offset's 2 operations and the filter's own (tent: abs, subtract,
# select; gaussian: abs, 2 products, exp, subtract, select; mitchell and
# catmullrom: abs, the cubics' 3 powers, 7 products and 5 sums, 3 selects;
# lanczos: abs, 3 products, 2 sines, 2 quotients, a product, 2 selects);
# per window term the weight's product, 3 products and 4 sums into the
# film (8) and 3 squares, 3 products and 3 sums into the squared film
# (9); the bytes: 20 a sample (position and value), 32 a pixel of the
# rows reached and film (16 read, 16 written)
OPS_FILTER = {"tent": 5, "gaussian": 8, "mitchell": 20, "catmullrom": 20,
              "lanczos": 13}
OPS_TERM, OPS_TERM_SQ = 8, 9
K7S_SAMPLE_BYTES, K7S_PIXEL_BYTES = 20, 32
# phase 14: the box in glossy, plastic and glass materials (K8 samples
# its visible normals); the repeat's budget; copies of K8's timed inputs
# taken in turn, above the L2. K8's ungated bound: 44 B a
# lane (wi 12, the two uniforms 8, alpha_u, alpha_v and dist 12 in, m 12
# out), or the FP32 operations the plain version's steps need on this
# call's lanes, a math function counted as one: every lane's stretch,
# polar angles and unstretch (33), a GGX lane's closed form (45), a
# Beckmann lane's set-up and last erfinvs (32) and 24 a round for each of
# its ROUNDS, or its normal-incidence case (8); the gated count below
MATERIALS_REPEAT_SPP = 16
K8_SETS = 6
VNDF_BYTES = 44
OPS_VNDF_LANE, OPS_VNDF_GGX, OPS_VNDF_BECK = 33, 45, 32
OPS_VNDF_ROUND, OPS_VNDF_NEAR0 = 24, 8
# K8's gated bound: every lane reads its mtype (4 B) and writes m (12 B);
# a lane of a family that samples a visible normal also reads dist (4 B),
# wi (12 B), the two uniforms (8 B), alpha_u and alpha_v (8 B)
VNDF_LANE_BYTES, VNDF_IN_BYTES = 16, 32
# phase 15: the box in the material wrappers with nee always; the
# unguided references' spp (nee always and never; half the guided budget
# keeps the whole run within 600 s) and the repeat's budget; the launches
# a training wavefront that PERF.md's PR 17 findings predicted before the
# first chip run (a range)
WRAPPERS_REF_SPP, WRAPPERS_REPEAT_SPP = 64, 16
WRAPPERS_PREDICTED_LAUNCHES = (45000, 58000)
# phase 16: the textured box with nee always: its floor bitmap's and bump
# map's sides (the floor's MIP atlas 2048^2 * 4/3 rows of 24 B: 134 MB,
# above the L2); the unguided reference's spp, the repeat's budget and
# the smaller renders' size and spp; copies of K9's timed inputs (the
# atlas among them) taken in turn; the launches a training wavefront
# that PERF.md's PR 18 findings predicted before the first chip run
TEX_FLOOR_RES, TEX_BUMP_RES = 2048, 512
TEXTURES_REF_SPP, TEXTURES_REPEAT_SPP = 64, 16
TEXTURES_SMALL_RES, TEXTURES_SMALL_SPP = 128, 16
K9_SETS = 6
TEXTURES_PREDICTED_LAUNCHES = (19000, 22500)
# K9's FP32 operations, as the plain version's steps need them: a
# bilinear tap (the uv transform 4, the texel coordinates 4, 2 floors, 2
# conversions and 2 subtractions, 2 complements, 9 a channel), a
# trilinear lookup (2 taps, the level's floor, conversion and fraction,
# its complement, 3 a channel), the footprint's lod (2 products, 2 abs, 2
# products, the maximum, 2 clamps, log2), the ellipse of a Jacobian (its
# coefficients, roots, radii, levels, the nearest snap, the axis and the
# taps' offsets) and an EWA lookup's 4 taps (each the tap's uv 4, a
# trilinear lookup, its weighted sum 6) and the product by 1 / their sum
OPS_BILINEAR, OPS_TRILINEAR, OPS_FOOT = 43, 99, 11
OPS_ELLIPSE, OPS_EWA_TAPS = 60, 439
# K5's call kinds on the main path (capture_pending)
K5_KINDS = ("db_statw", "qb box", "qb nearest", "adam S0/S1", "adam G0/W")
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
    and timed with events; ms per launch. The capture runs on the stream
    of the warm-up, so what a wrapper keeps per stream (K5's scratch) is
    made outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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


def gate(img, ref, what, names=("guided", "unguided")):
    """tests/test_regen.py's gates: whole-image means within 5%, median
    relative difference of 8x8 block means below 0.25. Returns a summary
    that names the images `names`."""
    mg, mu = float(img.mean()), float(ref.mean())
    bg, bu = blocks(img), blocks(ref)
    mask = bu > 0.1 * bu.mean()
    med = float(np.median(np.abs(bg - bu)[mask] / bu[mask]))
    if not (abs(mg - mu) / mu < 0.05 and med < 0.25):
        raise AssertionError(f"{what}: means {mg} {mu}, block median {med}")
    return (f"means {names[0]} {mg:.5f} {names[1]} {mu:.5f} "
            f"({abs(mg - mu) / mu:.4f} < 0.05), block median {med:.4f} < 0.25")


class IndexAddCount:
    """Counts calls of index_add_ and index_add on CUDA tensors while it is
    entered (the library scatter-add that K5 replaces)."""

    NAMES = ((torch.Tensor, "index_add_"), (torch.Tensor, "index_add"),
             (torch, "index_add"))

    def __enter__(self):
        self.n, self.saved = 0, [getattr(o, n) for o, n in self.NAMES]

        def counted(fn):
            def call(t, *args, **kw):
                self.n += int(t.is_cuda)
                return fn(t, *args, **kw)
            return call
        for (o, n), fn in zip(self.NAMES, self.saved):
            setattr(o, n, counted(fn))
        return self

    def __exit__(self, *exc):
        for (o, n), fn in zip(self.NAMES, self.saved):
            setattr(o, n, fn)


def launch_us(n=2000, batches=5):
    """Host microseconds a launch: n in-place adds to a one-element tensor
    on the card, timed on the host's clock after a synchronisation (the
    card runs each in a few microseconds, so the host does not wait for
    it); the least of `batches` such runs, since the host's load moves
    each."""
    x = torch.zeros(1, device="cuda")
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / n * 1e6


class HostTimes:
    """While entered, per iteration of a guided render (from one
    refine_and_reset of the tracer's host tree to the next): the seconds
    of the host tree's refine_and_reset and build, its spatial leaves
    after the refine, the host seconds and this thread's CPU seconds of
    each chunk step (guided._chunk_step's call, which does not wait for
    the card), and the seconds and count of the garbage collector's
    collections (full ones, of generation 2, apart); also the Python
    objects the collector tracks when it is entered, the host's
    microseconds a launch then and on exit (launch_us) and whether a
    profiler is enabled, and the caching allocator's device allocations
    and frees (cudaMalloc, cudaFree) while it is entered. Changes nothing
    of the render."""

    def __init__(self, tracer):
        self.tree, self.iters = tracer.host_tree, []

    def __enter__(self):
        from ppg_tpu_torch.integrators import guided

        tree, refine, build = self.tree, self.tree.refine_and_reset, \
            self.tree.build
        self.guided = guided
        self._step = step = guided._chunk_step

        def timed_step(*args, **kw):
            t0, c0 = time.perf_counter(), time.thread_time()
            out = step(*args, **kw)
            it = self.iters[-1]
            it["steps"].append(time.perf_counter() - t0)
            it["cpu"].append(time.thread_time() - c0)
            return out

        def timed_refine(*args, **kw):
            it = dict(refine_s=0.0, build_s=0.0, gc_s=0.0, gc_n=0,
                      full_s=0.0, full_n=0, steps=[], cpu=[])
            self.iters.append(it)
            t0 = time.perf_counter()
            refine(*args, **kw)
            it["refine_s"] = time.perf_counter() - t0
            it["leaves"] = int(tree.num_dtrees)

        def timed_build():
            t0 = time.perf_counter()
            build()
            self.iters[-1]["build_s"] = time.perf_counter() - t0
        tree.refine_and_reset, tree.build = timed_refine, timed_build
        guided._chunk_step = timed_step
        self.objects = len(gc.get_objects())
        self.launch_us = launch_us()
        self.profiler = torch.autograd._profiler_enabled()
        self.mem0 = self._device_calls()
        gc.callbacks.append(self._collected)
        return self

    @staticmethod
    def _device_calls():
        m = torch.cuda.memory_stats()
        return m.get("num_device_alloc", 0), m.get("num_device_free", 0)

    def _collected(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self.iters:
            it, dt = self.iters[-1], time.perf_counter() - self._t0
            it["gc_s"] += dt
            it["gc_n"] += 1
            if info["generation"] == 2:
                it["full_s"] += dt
                it["full_n"] += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._collected)
        self.device_calls = tuple(b - a for a, b in zip(
            self.mem0, self._device_calls()))
        self.launch_us_end = launch_us()
        del self.tree.refine_and_reset, self.tree.build
        self.guided._chunk_step = self._step


def guided_run(phase, tracer, tag, walk=False, seed=0, host_times=False):
    """Render through the tracer with the launch counts zeroed just before
    and read just after; checks the image, that the scene's kernel ran
    (the sweep, or with `walk` the BVH walk) and the other did not, that
    the descent kernels K3 and K4, the phase's TRAIN_KERNELS and the film
    splat of the film's filter (K7, or FILM_KERNELS' K7s) ran and the
    other did not, that no plain sweep, walk, descent, target walk, Adam
    round, sum or film splat and no index_add_ ran on the card, and that
    no JAX module was loaded; K9 launches in a textured scene
    (TEX_PHASES) only, and no plain lookup on the card. With host_times,
    each iteration's line also gives HostTimes' numbers. Returns (image, counts, wall seconds)."""
    from ppg_tpu_torch.accel import brute as B
    from ppg_tpu_torch.accel import bvh_walk as BW
    from ppg_tpu_torch.bsdf import microfacet as MF
    from ppg_tpu_torch.guiding import descent as D
    from ppg_tpu_torch.guiding import train as TR
    from ppg_tpu_torch.ops import reduce as R
    from ppg_tpu_torch.render import film as F
    from ppg_tpu_torch.scene import textures as TX

    for m in (B, D, TR, R, F, MF, TX):
        m.reset_counts()
    host = HostTimes(tracer) if host_times else contextlib.nullcontext()
    with IndexAddCount() as index_adds, host:
        t0 = time.time()
        img = tracer.render(seed=seed)
        torch.cuda.synchronize()
        wall = time.time() - t0
    counts = {**B.COUNTS, **BW.COUNTS, **D.COUNTS, **TR.COUNTS, **R.COUNTS,
              **F.COUNTS, **MF.COUNTS, **TX.COUNTS,
              "index_add": index_adds.n}
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
    film_kernel = FILM_KERNELS.get(phase, "film_splat")
    other_film = ({"film_splat", "film_splat_filter"} - {film_kernel}).pop()
    idle = [k for k in TRAIN_KERNELS[phase] + (film_kernel,)
            if counts[k] <= 0]
    if idle or counts["train_plain_on_cuda"] != 0 \
            or counts["reduce_plain_on_cuda"] != 0 \
            or counts["film_plain_on_cuda"] != 0 or counts["index_add"] \
            or counts[other_film]:
        raise AssertionError(f"phase {phase}: the training pass and the film "
                             f"did not run through K5a, K5b, K6, K5 and "
                             f"{film_kernel} alone: {counts}")
    if counts["vndf_plain_on_cuda"] or (counts["vndf_kernel"] > 0) != (
            phase in VNDF_PHASES):
        raise AssertionError(f"phase {phase}: the visible normals did not run "
                             f"through K8 alone, or a scene without "
                             f"microfacet rows launched it: {counts}")
    if counts["atlas_plain_on_cuda"] or (counts["atlas_kernel"] > 0) != (
            phase in TEX_PHASES):
        raise AssertionError(f"phase {phase}: the texture lookups did not run "
                             f"through K9 alone, or an untextured scene "
                             f"launched it: {counts}")
    print(f"phase {phase}: training kernels {counts['sd_dir_targets']} K5a, "
          f"{counts['sd_stree_box']} K5b, {counts['sd_adam']} K6 and "
          f"{counts['reduce_add']} K5 launches (calls by path: "
          f"{counts['reduce_shared']} shared, {counts['reduce_global']} "
          f"global), {counts['film_splat']} K7 and "
          f"{counts['film_splat_filter']} K7s launches, 0 plain target "
          f"walks, Adam rounds, sums or film splats and 0 index_add_ on the "
          f"card [{tag}]")
    bad = [m for m in sys.modules if m in ("jax", "ppg_tpu")
           or m.startswith(("jax.", "ppg_tpu."))]
    if bad:
        raise AssertionError(f"jax or ppg_tpu was imported: {bad[:5]}")
    if host_times:
        print(f"phase {phase}: at the render's start {host.objects} Python "
              f"objects tracked by the garbage collector, "
              f"{host.launch_us:.2f} us of host time a launch (at its end "
              f"{host.launch_us_end:.2f}), a profiler "
              f"{'' if host.profiler else 'not '}enabled; the caching "
              f"allocator's cudaMalloc and cudaFree calls in the render: "
              f"{host.device_calls[0]}, {host.device_calls[1]} [{tag}]")
    for i, s in enumerate(tracer.stats):
        it = host.iters[i] if host_times and i < len(host.iters) else None
        steps = (sorted(it["steps"]) if it else []) or [0.0]
        cpu = (sorted(it["cpu"]) if it else []) or [0.0]
        extra = "" if it is None else (
            f", chunk steps' host ms min {steps[0] * 1e3:.2f} median "
            f"{steps[len(steps) // 2] * 1e3:.2f} max {steps[-1] * 1e3:.2f}"
            f" (CPU ms median {cpu[len(cpu) // 2] * 1e3:.2f})"
            f", host refine {it['refine_s']:.4f} s, build "
            f"{it['build_s']:.4f} s, {it['leaves']} spatial leaves, "
            f"{it['gc_n']} collections in {it['gc_s']:.4f} s ("
            f"{it['full_n']} full in {it['full_s']:.4f} s)")
        print(f"phase {phase}: iteration {i}: {s['passes']} passes, "
              f"{s['seconds']:.3f} s, {s['n_rays']} rays, "
              f"{s['n_rays'] / s['seconds'] / 1e6:.1f} Mrays/s, "
              f"avgPathLength {s['avg_path_length']:.3f}{extra} [{tag}]")
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


def lookup_loads(levels, s_depth):
    """K3's row loads a lane with octant entries: one per three levels
    while three more fit in s_depth (fewer where a leaf ends the step),
    then one a level, for lanes walking `levels` [L] levels."""
    steps = torch.minimum((levels + 2) // 3,
                          torch.full_like(levels, s_depth // 3))
    return steps + (levels - torch.minimum(levels, 3 * steps))


def descent_inputs(sc, L=CHUNK):
    """Phase 9's lanes: positions p [L,3] at the first bounce of cbox's
    camera rays, a mask (90% in), uniforms u [L,22] drawn level-major as
    the tracer draws them (the transpose of a contiguous [22, L]), the
    sampling/point choice and canonical points of uniform directions."""
    from ppg_tpu_torch.accel.traverse import closest_hit
    from ppg_tpu_torch.guiding import sdtree as G
    from ppg_tpu_torch.integrators.wavefront import DeviceScene
    from ppg_tpu_torch.render.sensor import make_sensor
    from ppg_tpu_torch.tools.sdtree_cases import unit

    rng = np.random.default_rng(9)
    pos = rng.uniform(0, 1, (L, 2)) * [sc.film["width"], sc.film["height"]]
    o, d, t_min, t_max = make_sensor(sc.sensor, sc.film, "cuda").sample_rays(
        torch.from_numpy(pos.astype(np.float32)).cuda())
    geom = DeviceScene.from_scene(sc, "cuda").geom
    t = closest_hit(geom, o, d, t_min, t_max)[1]
    p = (o + t[:, None] * d).contiguous()
    mask = torch.from_numpy(rng.random(L) < 0.9).cuda()
    u = torch.from_numpy(rng.random((G.MAX_Q_DEPTH + 2, L)).astype(
        np.float32)).cuda().t()
    is_point = torch.from_numpy(rng.random(L) < 0.5).cuda()
    pc = G.dir_to_canonical(torch.from_numpy(unit(rng, L)).cuda())
    return p, mask, u, is_point, pc


def descent_phase(tag, tree, sc):
    """Phase 9: K3 (lookup with the meta) and K4 (the walk, sampling and
    point lanes, and its point mode) against the plain versions at
    L = CHUNK on `tree`, at the first bounce of cbox's camera rays (the
    positions) with uniform directions and uniforms (descent_inputs);
    raises on any lane that differs in a bit. Times each through its
    wrapper, alone (100 launches in a CUDA graph) and its plain version,
    beside its bound. Returns {(name, what): row}."""
    from ppg_tpu_torch.guiding import descent as D
    from ppg_tpu_torch.guiding import sdtree as G

    L = CHUNK
    p, mask, u, is_point, pc = descent_inputs(sc, L)
    print(f"phase 9: the tree of phase 3's last iteration: "
          f"{tree.s_dtree.shape[0]} spatial nodes (s_depth {tree.s_depth}), "
          f"{tree.ds_root.shape[0]} dtrees, {tree.qs_sum.shape[0]} quadtree "
          f"nodes (q_depth {tree.q_depth}); {L} lanes at the first bounce "
          f"of cbox's camera rays, 90% in the mask; u level-major, strides "
          f"{u.stride()}")

    # K3 bit for bit (frac too: both take the CUDA math library's expf),
    # in its three modes
    got = G.lookup_meta(tree, p, mask)
    want = G.lookup_meta_plain(tree, p, mask)
    got_only = G.lookup(tree, p)
    got_ids = G.dtree_meta(tree, want[0])
    torch.cuda.synchronize()
    *want_only, st3 = G.lookup_plain(tree, p, return_stats=True)
    bad3 = (sum(differ(a, b) for a, b in zip(got, want))
            + sum(differ(a, b) for a, b in zip(got_only, want_only))
            + sum(differ(a, b) for a, b in zip(got_ids, want[2:]))) > 0
    frac_ulp = int((got[4].view(torch.int32).long()
                    - want[4].view(torch.int32).long()).abs().max())
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
    loads3 = lookup_loads(st3["levels"], tree.s_depth)
    print(f"phase 9: sd_lookup: {L} lanes compared, {n3} differ in a bit "
          f"(id, voxel, root, uniform, frac; frac at most {frac_ulp} ulp "
          f"apart; with the meta, the lookup alone, the meta of the "
          f"ids); spatial levels walked "
          f"mean {float(lv3.mean()):.3f} max {int(lv3.max())} (s_depth "
          f"{tree.s_depth}), loads a lane three levels a load mean "
          f"{float(loads3.float().mean()):.3f} max {int(loads3.max())}; "
          f"{int((ids >= 0).sum())} lanes with a dtree, "
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
    bounds[("sd_lookup", "lookup alone")] = descent_bound_ms(
        L * (12 + 4 + 12), S_ROW_BYTES * st3["nodes"].numel(),
        OPS_S_LEVEL * float(lv3.sum()) + OPS_NORMALISE * L)
    bounds[("sd_lookup", "meta of ids")] = descent_bound_ms(
        L * (4 + 4 + 1 + 4), META_ROW_BYTES * n_dtrees, OPS_META * L)
    runs = {("sd_lookup", "cbox"): (
                lambda: G.lookup_meta(tree, p, mask),
                lambda: G.lookup_meta_plain(tree, p, mask)),
            ("sd_lookup", "lookup alone"): (
                lambda: G.lookup(tree, p), lambda: G.lookup_plain(tree, p)),
            ("sd_lookup", "meta of ids"): (
                lambda: G.dtree_meta(tree, ids),
                lambda: G.dtree_meta_plain(tree, ids)),
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


def kernel_ms(fn, reps=10):
    """{kernel name: device ms per call of fn}, each kernel fn launches
    timed on its own (torch.profiler, CUDA activity, reps calls after one
    untimed)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.name().startswith(("Memcpy", "Memset")):
            continue
        name = re.search(r"(\w+)(<[^>]*>)?\(", e.name())
        name = name.group(1) if name else e.name()
        by[name] = by.get(name, 0.0) + e.duration_ns() / 1e6 / reps
    return by


def capture_pending():
    """Patches guiding/sdtree.py so that the training passes leave, in the
    returned dict, the arguments of their largest call of each of K5's
    K5_KINDS ("k5 <kind>": the targets as they were before the call, the
    index and the values; told apart by the target and the directional
    filter of the splat_records call, and by the order of _adam_stats' two
    bincount_add2 calls), of their largest box-mode dir_targets call ("k5a
    box"), of their largest stree_box_targets ("k5b") and of their last
    _adam_rounds ("k6"); returns (dict, undo)."""
    from ppg_tpu_torch.guiding import sdtree as G

    seen, ctx = {}, {"adam": 0}
    saved = (G.bincount_add, G.bincount_add2, G.splat_records,
             G.dir_targets, G.stree_box_targets, G._adam_rounds)
    add, add2, splat, dirt, sbox, rounds = saved

    def keep(key, n, value):
        if n >= seen.get(key + " n", 0):
            seen[key], seen[key + " n"] = value(), n

    def splat_records(sdt, rec, spatial_filter="nearest",
                      directional_filter="nearest", *args, **kw):
        ctx.update(sdt=sdt, dir=directional_filter)
        return splat(sdt, rec, spatial_filter, directional_filter, *args,
                     **kw)

    def bincount_add(target, idx, val):
        kind = ("db_statw" if target.data_ptr() == ctx["sdt"].db_statw
                .data_ptr() else f"qb {ctx['dir']}")
        keep(f"k5 {kind}", idx.numel(),
             lambda: ((target.clone(),), idx, (val,)))
        return add(target, idx, val)

    def bincount_add2(targets, idx, a, b):
        kind = ("adam S0/S1", "adam G0/W")[ctx["adam"] % 2]
        ctx["adam"] += 1
        keep(f"k5 {kind}", idx.numel(),
             lambda: (tuple(t.clone() for t in targets), idx, (a, b)))
        return add2(targets, idx, a, b)

    def dir_targets(sdt, sp_id, pc, box):
        if box:
            keep("k5a box", sp_id.numel(),
                 lambda: (sdt, sp_id, pc.contiguous(), box))
        return dirt(sdt, sp_id, pc, box)

    def stree_box_targets(sdt, p, voxel, mask=None):
        keep("k5b", p.shape[0], lambda: (sdt, p, voxel, mask))
        return sbox(sdt, p, voxel, mask)

    def adam_rounds(*args):
        seen["k6"] = args
        return rounds(*args)

    (G.bincount_add, G.bincount_add2, G.splat_records, G.dir_targets,
     G.stree_box_targets, G._adam_rounds) = (
        bincount_add, bincount_add2, splat_records, dir_targets,
        stree_box_targets, adam_rounds)

    def undo():
        (G.bincount_add, G.bincount_add2, G.splat_records, G.dir_targets,
         G.stree_box_targets, G._adam_rounds) = saved
    return seen, undo


def bits_differ(a, b):
    """Values [n] where two float32 results differ in a bit (two NaNs
    equal)."""
    return (a.view(torch.int32) != b.view(torch.int32)) & ~(a.isnan()
                                                            & b.isnan())


def reduce_film_phase(tag, captured):
    """Phase 10: K5 on the largest call of each kind in `captured` (the
    capture_pending dicts of phases 3, 5 and 6), held bit for bit against
    bincount_add_plain on the card and on the CPU and against itself with
    the records permuted; K7 at a chunk of CHUNK pixels against
    splat_box_linear_plain, both film buffers. Raises on any differing
    bit. Times each through its wrapper, alone (100 launches in a CUDA
    graph), its plain version and, for K5, index_add_ (alone in a CUDA
    graph: the library call that computes the same sums, in no fixed
    order), beside the bound: each record's index and values read once
    and the target of each cell that gets a nonzero value read and
    written once, for each stream. Returns {(name, what): row}."""
    from ppg_tpu_torch.ops import reduce as R
    from ppg_tpu_torch.render import film as F

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(10)
    for kind in K5_KINDS:
        calls = [c[f"k5 {kind}"] for c in captured if f"k5 {kind}" in c]
        if not calls:
            raise AssertionError(f"phase 10: no K5 call of kind {kind}")
        targets, idx, vals = max(calls, key=lambda c: c[1].numel())
        N, M, S = idx.numel(), targets[0].numel(), len(targets)

        def kernel(ts, i=idx, vs=vals):
            if len(ts) == 1:
                return (R.bincount_add(ts[0], i, vs[0]),)
            return R.bincount_add2(ts, i, *vs)

        def plain(ts, i=idx, vs=vals):
            return tuple(R.bincount_add_plain(t, i, v) for t, v in
                         zip(ts, vs))

        got = kernel(tuple(t.clone() for t in targets))
        want = plain(tuple(t.clone() for t in targets))
        cpu = tuple(R.bincount_add_plain(t.to("cpu", copy=True), idx.cpu(),
                                         v.cpu())
                    for t, v in zip(targets, vals))
        perm = torch.randperm(N, generator=gen, device="cuda")
        permuted = kernel(tuple(t.clone() for t in targets),
                          idx[perm].contiguous(),
                          tuple(v[perm].contiguous() for v in vals))
        n_bad = [int(sum(bits_differ(a, b.to(a.device)).sum()
                         for a, b in zip(got, other)))
                 for other in (want, cpu, permuted)]
        # the cells that get a nonzero value, each stream's own: the only
        # targets the sums must read and write
        touched = [int(idx[v != 0].unique().numel()) for v in vals]
        nz = sum(int((v != 0).sum()) for v in vals)
        print(f"phase 10: reduce_add {kind}: {N} records ({nz} nonzero "
              f"values, {idx.element_size()} B indices) into {M} cells x "
              f"{S} stream(s), {touched} cells touched a stream; "
              f"{n_bad[0]} cells differ in a bit from the plain "
              f"sum on the card, {n_bad[1]} from the plain sum on the CPU, "
              f"{n_bad[2]} from the kernel on the records permuted")
        if any(n_bad):
            raise AssertionError(f"phase 10: K5 {kind}: {n_bad} cells differ")
        work = tuple(t.clone() for t in targets)
        lib_work = tuple(t.clone() for t in targets)
        idx_long = idx.long()
        bound = descent_bound_ms(
            N * (idx.element_size() + 4 * S) + 8 * sum(touched), 0, N * S)
        fn = lambda: kernel(work)
        passes = kernel_ms(fn)
        path = R.path(M, S)
        print(f"phase 10: reduce_add {kind}: the {path} path; each pass "
              f"alone: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                    passes.items()) + f" [{tag}]")
        rows[("reduce_add", kind)] = dict(
            what=kind, L=N, cells=M, streams=S, touched=touched,
            index_bytes=idx.element_size(), path=path, passes_ms=passes,
            ms=cuda_ms(fn, 20, batches=3), kernel_only_ms=graph_ms(fn),
            plain_ms=cuda_ms(lambda: plain(tuple(t.clone() for t in
                                                 targets)), 3, batches=2),
            library_ms=graph_ms(lambda: [t.index_add_(0, idx_long, v)
                                         for t, v in zip(lib_work, vals)]),
            bound_ms=bound[0], bound_by=bound[1],
            bound="memory" if bound[1] == "bytes" else "fp32",
            max_abs_err=max(float((a - b).abs().nan_to_num().max())
                            for a, b in zip(got, want)))
    # K7: a chunk's box splat into the film and the squared film: values
    # (12 B) and the valid flag in, both rgb (12 B) and weight (4 B) slices
    # read and written
    C = CHUNK
    li = torch.rand((C, 3), device="cuda", generator=gen) * 4 - 1
    valid = torch.rand(C, device="cuda", generator=gen) < 0.99
    base = [torch.rand(s, device="cuda", generator=gen)
            for s in ((C, 3), (C,), (C, 3), (C,))]
    got = [t.clone() for t in base]
    want = [t.clone() for t in base]
    F.Film.splat_box_linear(got[:2], 0, li, valid, got[2:])
    F.splat_box_linear_plain(want[:2], 0, li, valid, want[2:])
    n_bad = sum(int(bits_differ(a.reshape(-1), b.reshape(-1)).sum())
                for a, b in zip(got, want))
    print(f"phase 10: film_splat C={C}: {n_bad} values differ in a bit from "
          f"the plain splat (film and squared film)")
    if n_bad:
        raise AssertionError(f"phase 10: K7: {n_bad} values differ")
    bound = descent_bound_ms(C * (12 + 1 + 2 * 2 * (12 + 4)), 0, 11 * C)
    fn = lambda: F.Film.splat_box_linear(got[:2], 0, li, valid, got[2:])
    # alone, the launches take K7_SETS copies of the inputs and buffers in
    # turn (20 MB each, together above the 50 MB L2), as the tracer's
    # chunk finds its film cold; one set would stay in L2
    sets = [([t.clone() for t in base], li.clone(), valid.clone())
            for _ in range(K7_SETS)]
    turn = iter(range(1 << 30))

    def cold():
        b, v, ok = sets[next(turn) % K7_SETS]
        F.Film.splat_box_linear(b[:2], 0, v, ok, b[2:])
    rows[("film_splat", f"C={C}")] = dict(
        what=f"C={C}, film and squared film", L=C,
        ms=cuda_ms(fn, 50, batches=5), kernel_only_ms=graph_ms(cold),
        plain_ms=cuda_ms(lambda: F.splat_box_linear_plain(
            want[:2], 0, li, valid, want[2:]), 20, batches=3),
        library_ms=None, bound_ms=bound[0], bound_by=bound[1],
        bound="memory" if bound[1] == "bytes" else "fp32", max_abs_err=0.0)
    for (name, what), r in rows.items():
        lib = (f", index_add_ alone {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        print(f"phase 10: {name} {what}: wrapper {r['ms']:.4f} ms, kernel "
              f"alone {r['kernel_only_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.5f} ms "
              f"from {r['bound']}; kernel alone at the bound's "
              f"{r['bound_ms'] / r['kernel_only_ms']:.1%} [{tag}]")
    return rows


def max_ulp(got, want):
    """The largest distance in units in the last place between two
    float32 arrays (0 where both are NaN)."""
    a, b = got.view(torch.int32).long(), want.view(torch.int32).long()
    # the sign-magnitude bits as one ordered integer line
    a = torch.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = torch.where(b < 0, -(b & 0x7FFFFFFF), b)
    d = torch.where(torch.isnan(got) & torch.isnan(want), 0, (a - b).abs())
    return int(d.max()) if d.numel() else 0


def train_phase(tag, seen5, seen6):
    """Phase 11: K5a (box, and nearest on the same records, at phase 5's
    shade-time shape; box at phase 6's splat-time shape), K5b (phase 6) and K6 (phase 5's last
    batch) against their plain versions; raises on any lane or dtree that
    differs in a bit (K6: beyond LIBM_RTOL of each field's largest
    magnitude, with the differing dtrees and their largest ulp distance
    printed). Times each through its wrapper, alone (100 launches in a
    CUDA graph) and its plain version, beside its bound (from what the
    plain versions needed on these inputs). Returns {(name, what): row}."""
    from ppg_tpu_torch.guiding import sdtree as G
    from ppg_tpu_torch.guiding import train as TR

    rows, LIBM_RTOL = {}, 1e-4
    runs = []
    # K5a: each shape's kernel against dir_targets_plain
    for what, args, box in (("shade time, box (phase 5)", seen5, True),
                            ("shade time, nearest (phase 5's records)",
                             seen5, False),
                            ("splat time, box (phase 6)", seen6, True)):
        sdt, sp_id, pc, _ = args["k5a box"]
        L = sp_id.numel()
        got = TR.dir_targets(sdt, sp_id, pc, box)
        want, st = G.dir_targets_plain(sdt, sp_id, pc, box,
                                       return_stats=True)
        got, want = (got, want) if box else ((got,), (want,))
        bad = sum(differ(a, b) for a, b in zip(got, want)) > 0
        n_bad = int(bad.sum())
        lv = st["levels"].float()
        print(f"phase 11: sd_dir_targets {what}: {L} records compared, "
              f"{n_bad} differ in a bit (cell{'4 and w4' if box else ''}); "
              f"quadtree levels walked per record mean "
              f"{float(lv.mean()):.3f} max {int(lv.max())}, "
              f"{st['nodes'].numel()} distinct nodes read, q_depth "
              f"{sdt.q_depth}, {sdt.qb_child.shape[0]} building nodes")
        if n_bad:
            raise AssertionError(f"phase 11: K5a {what}: {n_bad} records "
                                 f"differ from dir_targets_plain")
        n_dt = int(sp_id.unique().numel())
        bound = descent_bound_ms(
            L * (4 + 8 + (32 if box else 4)),
            QB_ROW_BYTES * st["nodes"].numel() + ROOT_BYTES * n_dt,
            OPS_DIR_LEVEL * float(lv.sum()) + (OPS_BOX_LANE * L if box
                                                else 0))
        err = max(float((a.float() - b.float()).abs().nan_to_num().max())
                  for a, b in zip(got[1:], want[1:])) if box else 0.0
        runs.append((("sd_dir_targets", what), L, bound, err,
                     TR.dir_targets, G.dir_targets_plain,
                     (sdt, sp_id, pc, box)))
    # K5a's box mode at given depths (dtree_box_targets4: no leaf descent,
    # so no path to share), on phase 5's records at their leaf depths
    sdt, sp_id, pc, _ = seen5["k5a box"]
    root = G._take(sdt.db_root, sp_id)
    depth = G.descend_cell_plain(sdt.qb_child, root, pc, None,
                                 sdt.q_depth)[2]
    targs = (sdt.qb_child, root, pc, depth, sdt.q_depth)
    got = TR.box_targets(*targs)
    *want, st = G.dtree_box_targets4_plain(*targs, return_stats=True)
    n_bad = int((differ(got[0], want[0]) | differ(got[1], want[1])).sum())
    lv = st["levels"].float()
    L = root.numel()
    print(f"phase 11: sd_dir_targets given depth (phase 5's records at "
          f"their leaf depths): {L} records compared, {n_bad} differ in a "
          f"bit (cell4 and w4); corner levels per record mean "
          f"{float(lv.mean()):.3f} max {int(lv.max())}")
    if n_bad:
        raise AssertionError(f"phase 11: K5a given depth: {n_bad} records "
                             f"differ from dtree_box_targets4_plain")
    runs.append((("sd_dir_targets", "given depth (phase 5's records)"), L,
                 descent_bound_ms(
                     L * (4 + 8 + 4 + 32),
                     QB_ROW_BYTES * st["nodes"].numel(),
                     OPS_DIR_LEVEL * float(lv.sum()) + OPS_BOX_LANE * L),
                 float((got[1] - want[1]).abs().nan_to_num().max()),
                 TR.box_targets, G.dtree_box_targets4_plain, targs))
    # K5b against stree_box_targets_plain
    sdt, p, voxel, mask = seen6["k5b"]
    N = p.shape[0]
    got = TR.stree_box(sdt, p, voxel, mask)
    *want, st = G.stree_box_targets_plain(sdt, p, voxel, mask,
                                          return_stats=True)
    n_bad = int((differ(got[0], want[0]) | differ(got[1], want[1])).sum())
    pops = st["pops"].float()
    n_full = int(((want[0] >= 0).sum(1) == G.S_TARGETS).sum())
    print(f"phase 11: sd_stree_box phase 6's largest batch: {N} records "
          f"compared ({int(mask.sum()) if mask is not None else N} in the "
          f"mask), {n_bad} differ in a bit (ids and weights); nodes popped "
          f"per record mean {float(pops.mean()):.3f} max {int(pops.max())}, "
          f"{st['nodes'].numel()} distinct nodes, {n_full} records at the "
          f"{G.S_TARGETS}-leaf cap, {sdt.s_dtree.shape[0]} spatial nodes")
    if n_bad:
        raise AssertionError(f"phase 11: K5b: {n_bad} records differ from "
                             f"stree_box_targets_plain")
    # every record's mask byte and row of targets; p and voxel (24 B) and
    # the record's operations only for the records in the mask, which
    # alone walk
    n_in = int(mask.sum()) if mask is not None else N
    bound = descent_bound_ms(
        N * ((1 if mask is not None else 0) + G.S_TARGETS * 8) + n_in * 24,
        S_ROW_BYTES * st["nodes"].numel(),
        OPS_SBOX_RECORD * n_in + OPS_SBOX_POP * float(pops.sum()))
    runs.append((("sd_stree_box", "box walk (phase 6)"), N, bound,
                 float((got[1] - want[1]).abs().max()), TR.stree_box,
                 G.stree_box_targets_plain, (sdt, p, voxel, mask)))
    # K6 against _adam_rounds_plain
    sdt, S0, S1, G0, W, loss = seen5["k6"]
    T = S0.shape[0]
    got = TR.adam_rounds(sdt, S0, S1, G0, W, loss == "kl")
    want = G._adam_rounds_plain(sdt, S0, S1, G0, W, loss)
    n_bad = int(sum(differ(a, b) for a, b in zip(got, want)).gt(0).sum())
    ulp = max(max_ulp(a, b) for a, b in zip(got, want)
              if a.dtype == torch.float32)
    k = torch.floor(W * 0.5).clamp(min=0)
    steps = k.clamp(max=G.ADAM_ROUNDS)
    evals = 1 + steps + (W > 0).float()
    print(f"phase 11: sd_adam phase 5's last batch ({loss}): {T} dtrees "
          f"compared, {n_bad} differ in a bit (at most {ulp} ulp apart); "
          f"{int((k > 0).sum())} dtrees step, {int(steps.sum())} steps in "
          f"all, k mean {float(k.mean()):.1f} max {int(k.max())}")
    for a, b in zip(got, want):
        if a.dtype == torch.float32 and not torch.allclose(
                a, b, rtol=LIBM_RTOL, equal_nan=True,
                atol=LIBM_RTOL * float(b.abs().nan_to_num().max())):
            raise AssertionError("phase 11: K6 beyond its tolerance")
        if a.dtype == torch.int32 and not torch.equal(a, b):
            raise AssertionError("phase 11: K6's step counts differ")
    bound = descent_bound_ms(
        T * (2 * G.ADAM_B * 4 + 6 * 4 + 6 * 4), G.ADAM_B * 4,
        float(evals.sum()) * (G.ADAM_B * OPS_ADAM_BUCKET + OPS_ADAM_EVAL)
        + OPS_ADAM_STEP * float(steps.sum()))
    runs.append((("sd_adam", f"{loss} rounds (phase 5)"), T, bound,
                 max(float((a.float() - b.float()).abs().nan_to_num().max())
                     for a, b in zip(got, want)),
                 lambda *a: TR.adam_rounds(*a[:5], a[5] == "kl"),
                 G._adam_rounds_plain, (sdt, S0, S1, G0, W, loss)))
    for key, n, (bound, by), err, kernel, plain, args in runs:
        fn = lambda: kernel(*args)
        row = dict(what=key[1], L=n, ms=cuda_ms(fn, 50, batches=5),
                   kernel_only_ms=graph_ms(fn),
                   plain_ms=cuda_ms(lambda: plain(*args), 2, batches=2),
                   bound_ms=bound,
                   bound_by=by, bound="memory" if by == "bytes" else "fp32",
                   max_abs_err=err)
        rows[key] = row
        print(f"phase 11: {key[0]} {key[1]} n={n}: wrapper {row['ms']:.4f} "
              f"ms, kernel alone {row['kernel_only_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {bound:.5f} ms from "
              f"{row['bound']}; kernel alone at the bound's "
              f"{bound / row['kernel_only_ms']:.1%} [{tag}]")
    return rows


def digest(x):
    """Two int64 sums over the bits of every tensor in x (a tensor, or a
    dict, list or tuple of them; others skipped): of the bits and of the
    bits times their position. Integer sums wrap and do not depend on
    their order, so equal inputs give equal digests."""
    if isinstance(x, dict):
        return [digest(v) for _, v in sorted(x.items())]
    if isinstance(x, (list, tuple)):
        return [digest(v) for v in x]
    if not isinstance(x, torch.Tensor):
        return None
    b = x.detach().reshape(-1)
    if b.dtype == torch.bool:
        b = b.to(torch.int32)
    elif b.dtype == torch.float32:
        b = b.view(torch.int32)
    b = b.long()
    w = torch.arange(1, b.numel() + 1, device=b.device) * 2654435761
    return torch.stack([b.sum(), (b * w).sum()]).tolist()


def traced_render(tracer, seed):
    """Renders with guided._chunk_step and guided.trace_paths wrapped to
    record, per chunk step, the digests of its stages in order: the tree
    it samples from, the traced paths and records, the film buffers, the
    building pools and the Adam state. Returns (image, [(step, stage,
    digest), ...])."""
    from ppg_tpu_torch.guiding import sdtree as G
    from ppg_tpu_torch.integrators import guided

    log, step, trace = [], guided._chunk_step, guided.trace_paths

    def traced_trace(*args, **kw):
        out = trace(*args, **kw)
        log.append((len(log), "trace", digest(
            {k: out[k] for k in ("li", "vertices", "n_rays")})))
        return out

    def traced_step(*args):
        sdt, film_buf, sq_buf = args[10], args[8], args[9]
        fields = [getattr(sdt, f) for f in G.SDTreeArrays.FIELDS]
        log.append((len(log), "tree", digest(fields)))
        r = step(*args)
        log.append((len(log), "film", digest([film_buf, sq_buf])))
        log.append((len(log), "building pools",
                    digest([sdt.qb_sum, sdt.db_statw])))
        log.append((len(log), "adam state",
                    digest([getattr(sdt, f) for f in G._OPT_FIELDS])))
        return r

    guided._chunk_step, guided.trace_paths = traced_step, traced_trace
    try:
        img = tracer.render(seed=seed)
    finally:
        guided._chunk_step, guided.trace_paths = step, trace
    return img, log


def repeat_phase(tag, sc, tracer5, img5):
    """Phase 12: one training pass of phase 5's settings (the whole frame
    in one chunk step, on the tree phase 5 built) run twice from the same
    seed and tree: raises unless the building pools, the Adam state and
    the film are bit-identical. Then phase 5's render twice more with
    every stage digested (traced_render); reports whether the images are
    bit-identical (and equal to phase 5's) and, if not, the first stage
    whose digests differ. Returns a summary dict."""
    from ppg_tpu_torch.device import generator
    from ppg_tpu_torch.guiding import sdtree as G
    from ppg_tpu_torch.integrators import guided
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer

    cfg = tracer5._cfg(True, False, False)
    out = []
    for _ in range(2):
        sdt = tracer5._push()
        bufs = tracer5._zeros(), tracer5._zeros()
        guided._chunk_step(tracer5.scene_dev, cfg, tracer5.sensor,
                           tracer5.film, CHUNK, tracer5.spatial_filter,
                           tracer5.directional_filter, tracer5.loss, *bufs,
                           sdt, generator(12, "cuda"), 0)
        out.append([sdt.qb_sum, sdt.db_statw,
                    *(getattr(sdt, f) for f in G._OPT_FIELDS), *bufs[0],
                    *bufs[1]])
    torch.cuda.synchronize()
    names = ["qb_sum", "db_statw", *G._OPT_FIELDS, "film rgb", "film w",
             "squared rgb", "squared w"]
    bad = {n: int((a.view(torch.int32) != b.view(torch.int32)).sum())
           for n, a, b in zip(names, *out)}
    print(f"phase 12: one training pass of cbox-improved twice from seed 12 "
          f"on phase 5's tree ({out[0][0].numel()} building cells, "
          f"{out[0][1].numel()} dtrees): values differing in a bit per "
          f"field {bad} [{tag}]")
    if any(bad.values()):
        raise AssertionError(f"phase 12: two training passes differ: {bad}")
    runs = []
    for _ in range(2):
        tracer = GuidedPathTracer(sc, chunk=CHUNK, overrides=IMPROVED,
                                  device="cuda")
        runs.append(traced_render(tracer, 0))
    (img_a, log_a), (img_b, log_b) = runs
    same = bool(np.array_equal(img_a.view(np.int32), img_b.view(np.int32)))
    same5 = bool(np.array_equal(img_a.view(np.int32), img5.view(np.int32)))
    first = next(((i, st) for (i, st, da), (_, _, db) in zip(log_a, log_b)
                  if da != db), None)
    if first is None and len(log_a) != len(log_b):
        first = (min(len(log_a), len(log_b)), "the number of chunk steps")
    steps = sum(st == "tree" for _, st, _ in log_a)
    where = ("no stage differs" if first is None else
             f"the first stage whose outputs differ: {first[1]} (record "
             f"{first[0]} of {len(log_a)}, chunk step "
             f"{sum(st == 'tree' for _, st, _ in log_a[:first[0] + 1])} of "
             f"{steps})")
    print(f"phase 12: cbox-improved rendered twice more from seed 0: the "
          f"images are {'' if same else 'NOT '}bit-identical (and "
          f"{'' if same5 else 'NOT '}bit-identical to phase 5's); "
          f"{steps} chunk steps digested, {where} [{tag}]")
    # phase 13's configuration (a thin lens, the gaussian filter through
    # K7s) at 16 spp, twice from one seed: must be bit-identical
    sc13 = front_end_scene(RES, 16)
    a13, b13 = (GuidedPathTracer(sc13, chunk=CHUNK, overrides=IMPROVED,
                                 device="cuda").render(seed=7)
                for _ in range(2))
    same13 = bool(np.array_equal(a13.view(np.int32), b13.view(np.int32)))
    print(f"phase 12: phase 13's configuration (thin lens, gaussian filter) "
          f"at 16 spp rendered twice from seed 7: the images are "
          f"{'' if same13 else 'NOT '}bit-identical [{tag}]")
    if not same13:
        raise AssertionError("phase 12: two renders of phase 13's "
                             "configuration differ")
    return dict(pass_identical=True, render_identical=same,
                render_equals_phase5=same5,
                first_difference=None if first is None else first[1],
                front_end_identical=same13)


def front_end_scene(res, budget, sampler="independent", sensor="thinlens",
                    settings=""):
    """mini_cbox with phase 13's front end: the gaussian filter, `sampler`
    and `sensor` ("thinlens" at the perspective camera's pose with
    APERTURE, focused FOCUS away on the back wall; "spherical" from the
    box's centre; other types at the camera's pose); `settings` replaces
    the budget type's property (budgetType spp)."""
    from ppg_tpu_torch.scene.testscenes import MINI_CBOX, scene_from_xml

    xml = MINI_CBOX.format(res=res, budget=budget, max_depth=MAX_DEPTH,
                           nee="never")
    head = f'<sensor type="{sensor}">'
    if sensor == "thinlens":
        head += (f'\n    <float name="apertureRadius" value="{APERTURE}"/>'
                 f'\n    <float name="focusDistance" value="{FOCUS}"/>')
    xml = xml.replace('<sensor type="perspective">', head)
    if sensor == "spherical":
        xml = xml.replace('origin="0, 1, -3.5" target="0, 1, -2.5"',
                          'origin="0, 1, 0" target="0, 1, 1"')
    xml = xml.replace('<rfilter type="box"/>', '<rfilter type="gaussian"/>')
    xml = xml.replace('<sampler type="independent">',
                      f'<sampler type="{sampler}">')
    if settings:
        xml = xml.replace('<string name="budgetType" value="spp"/>',
                          settings)
    return scene_from_xml(xml)


def cuda_kernels(fn):
    """(kernel launches, memory copies and fills) that fn makes on the
    card (torch.profiler, CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    copies = sum(e.name().startswith(("Memcpy", "Memset")) for e in ev)
    return len(ev) - copies, copies


def wavefront_launches(tracer, seed=13, do_nee=None):
    """Kernel launches of one training chunk step of the whole frame on
    the tracer's built tree (after one untimed step); `do_nee` False
    leaves NEE out of a nee-always configuration."""
    from ppg_tpu_torch.device import generator
    from ppg_tpu_torch.integrators import guided

    cfg = tracer._cfg(True, tracer._do_nee(0) if do_nee is None else do_nee,
                      False)
    lf = tracer.loss if tracer.loss != "none" else None
    args = (tracer.scene_dev, cfg, tracer.sensor, tracer.film, tracer.chunk,
            tracer.spatial_filter, tracer.directional_filter, lf,
            tracer._zeros(), tracer._zeros(), tracer._push(),
            generator(seed, "cuda"), 0)
    guided._chunk_step(*args)
    return cuda_kernels(lambda: guided._chunk_step(*args))[0]


def mean_gate(img, ref, what):
    """tests/test_regen.py's mean gate alone: whole-image means within 5%.
    Returns a summary."""
    mg, mu = float(img.mean()), float(ref.mean())
    if not (np.isfinite(img).all() and abs(mg - mu) / mu < 0.05):
        raise AssertionError(f"{what}: means {mg} {mu}")
    return f"means {mg:.5f} against {mu:.5f} ({abs(mg - mu) / mu:.4f} < 0.05)"


def k7s_bound_ms(name, W, H, start, pos, films):
    """K7s's bound on this chunk: each sample's position and value read
    once and each pixel of the rows reached read and written once per film
    at the HBM rate, or the FP32 operations that these positions need
    (K7S_* and OPS_*: the filter at each column and row of a sample's
    window on the film, the window terms' products and sums), whichever
    is larger. Returns (ms, which term, window terms)."""
    from ppg_tpu_torch.render import film as F

    r = F.FILTER_RADIUS[name]
    K, n = F._filter_geometry(r)
    last, _, rows = F._reached_rows(W, H, start, pos.shape[0], K)
    p = pos[:last + 1 - start]
    b = torch.ceil(p - 0.5 - r)
    lo = b.clamp(min=0)
    hi = torch.minimum(b + n, torch.tensor([W, H], device=p.device))
    span = (hi - lo).clamp(min=0)  # window pixels on the film, x and y
    terms = int(span.prod(-1).sum())
    evals = int((span.sum(-1) * (span.prod(-1) > 0)).sum())
    ops = (evals * OPS_FILTER[name]
           + terms * (OPS_TERM + (OPS_TERM_SQ if films == 2 else 0)))
    mem = (p.shape[0] * K7S_SAMPLE_BYTES
           + rows * W * K7S_PIXEL_BYTES * films)
    mem_ms, ops_ms = mem / HBM_BYTES_PER_S * 1e3, ops / FP32_PER_S * 1e3
    return max(mem_ms, ops_ms), ("bytes" if mem_ms >= ops_ms
                                 else "operations"), terms


def k7s_rows(tag, start, pos, values):
    """Phase 13's K7s part: for each filter, the kernel into one film and
    into the film and the squared film against splat_filter_plain on the
    card, on the chunk phase 13's render splatted last (raises on any bit
    that differs); each timed through its wrapper, alone (100 launches in
    a CUDA graph over K7S_SETS copies of its inputs, above the L2) and its
    plain version, beside its bound. Returns {(name, what): row}."""
    from ppg_tpu_torch.render import film as F

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(13)
    for name in FILTERS:
        film = F.Film(RES, RES, name, "cuda")
        base = [torch.rand(s, device="cuda", generator=gen)
                for s in ((RES, RES, 3), (RES, RES)) * 2]
        for films in (1, 2):
            got = [t.clone() for t in base]
            want = [t.clone() for t in base]
            sq = (lambda b: b[2:] if films == 2 else None)
            film.splat(got[:2], start, pos, values, sq(got))
            F.splat_filter_plain(name, want[:2], start, pos, values,
                                 sq(want))
            n_bad = sum(int(bits_differ(a.reshape(-1), b.reshape(-1)).sum())
                        for a, b in zip(got, want))
            err = max(float((a - b).abs().nan_to_num().max())
                      for a, b in zip(got, want))
            print(f"phase 13: film_splat_filter {name}, {films} film(s): "
                  f"{n_bad} values differ in a bit from the plain splat")
            if n_bad:
                raise AssertionError(f"phase 13: K7s {name}: {n_bad} values "
                                     f"differ")
            bound, by, terms = k7s_bound_ms(name, RES, RES, start, pos,
                                            films)
            sets = [([t.clone() for t in base], pos.clone(), values.clone())
                    for _ in range(K7S_SETS)]
            turn = iter(range(1 << 30))

            def cold(film=film, sets=sets, turn=turn, sq=sq):
                b, p, v = sets[next(turn) % K7S_SETS]
                film.splat(b[:2], start, p, v, sq(b))
            what = f"{name}, C={pos.shape[0]}, {films} film(s)"
            rows[("film_splat_filter", what)] = row = dict(
                what=what, L=pos.shape[0], terms=terms,
                ms=cuda_ms(lambda: film.splat(got[:2], start, pos, values,
                                              sq(got)), 50, batches=5),
                kernel_only_ms=graph_ms(cold),
                plain_ms=cuda_ms(lambda: F.splat_filter_plain(
                    name, want[:2], start, pos, values, sq(want)), 3,
                    batches=2),
                library_ms=None, bound_ms=bound, bound_by=by,
                bound="memory" if by == "bytes" else "fp32",
                max_abs_err=err)
            print(f"phase 13: film_splat_filter {what}: wrapper "
                  f"{row['ms']:.4f} ms, kernel alone "
                  f"{row['kernel_only_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library: none, bound "
                  f"{bound:.5f} ms from {row['bound']} ({terms} window "
                  f"terms); kernel alone at the bound's "
                  f"{bound / row['kernel_only_ms']:.1%} [{tag}]")
            del sets
    return rows


def front_end_phase(tag, tracer5):
    """Phase 13: the slice at full width. The guided render of cbox-improved
    at 512^2 with a thin lens and the gaussian filter (every chunk's film
    through K7s), gated against driver.render of the same scene with the
    sobol sampler; its launches per training wavefront beside phase 5's
    (tracer5); K7s against its plain version for the five filters
    (k7s_rows); the other cameras and the QMC kinds rendered unguided;
    a time-budget render with .sdt dumps; a checkpointed render stopped
    after its first iteration and resumed, bit-identical to the
    uninterrupted one. Returns (counts, K7s rows)."""
    import glob

    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.io.sdt import read_sdt

    sc = front_end_scene(RES, BUDGET)
    tracer = GuidedPathTracer(sc, chunk=CHUNK, overrides=IMPROVED,
                              device="cuda")
    seen, splat = {}, tracer.film.splat

    def keep(buffers, pix_start, pos, values, sq_buffers=None):
        seen.update(start=pix_start, pos=pos.clone(), values=values.clone())
        return splat(buffers, pix_start, pos, values, sq_buffers)
    tracer.film.splat = keep
    try:
        img, counts, wall = guided_run(13, tracer, tag, host_times=True)
    finally:
        del tracer.film.splat
    sched = [(s["passes"], s["is_final"]) for s in tracer.stats]
    if sched != [(1 << i, i == 6) for i in range(7)]:
        raise AssertionError(f"phase 13: unexpected schedule {sched}")
    steps = sum(s["spp"] for s in tracer.stats)
    if counts["film_splat_filter"] != steps:
        raise AssertionError(f"phase 13: {counts['film_splat_filter']} K7s "
                             f"launches for {steps} chunk steps")
    rays = sum(s["n_rays"] for s in tracer.stats)
    pass_s = sum(s["seconds"] for s in tracer.stats)
    print(f"phase 13: cbox-improved {RES}x{RES} {BUDGET} spp maxDepth "
          f"{MAX_DEPTH}, thin lens (aperture {APERTURE}, focus {FOCUS}), "
          f"gaussian filter: {wall:.2f} s wall, {pass_s:.2f} s in passes "
          f"({pass_s / len(tracer.stats):.3f} s an iteration), {rays} rays, "
          f"{rays / pass_s / 1e6:.1f} Mrays/s, "
          f"{counts['film_splat_filter']} K7s launches (one a chunk step), "
          f"{counts['film_plain_on_cuda']} plain film splats on the card, "
          f"{counts['brute_kernel']} sweep, {counts['sd_lookup']} K3 and "
          f"{counts['sd_sample_pdf']} K4 launches, no jax [{tag}]")
    n13, n5 = wavefront_launches(tracer), wavefront_launches(tracer5)
    print(f"phase 13: kernel launches per training wavefront: {n13} "
          f"(phase 5's configuration on its tree: {n5}) [{tag}]")
    sc_q = front_end_scene(RES, BUDGET, sampler="sobol")
    t0 = time.time()
    ref = driver.render(sc_q, spp=BUDGET, seed=1, chunk=CHUNK,
                        device="cuda")
    ref_s = time.time() - t0
    one, _ = cuda_kernels(lambda: driver.render(sc_q, spp=1, seed=1,
                                                chunk=CHUNK, device="cuda"))
    two, _ = cuda_kernels(lambda: driver.render(sc_q, spp=2, seed=1,
                                                chunk=CHUNK, device="cuda"))
    print(f"phase 13: unguided sobol reference {BUDGET} spp in {ref_s:.2f} s "
          f"({ref_s / BUDGET * 1e3:.1f} ms a wavefront), {two - one} kernel "
          f"launches a wavefront [{tag}]; "
          + gate(img, ref, "phase 13: guided vs the sobol reference"))
    rows = k7s_rows(tag, seen["start"], seen["pos"], seen["values"])
    del seen

    # the other cameras and the QMC kinds, unguided at a small size: every
    # image finite, each against the independent sampler's image of its
    # camera by the mean gate (the radiance meter's only finite)
    small = dict(spp=FRONT_SPP, chunk=FRONT_RES * FRONT_RES, device="cuda")
    for sensor, kinds in (("thinlens", ("stratified", "ldsampler", "halton",
                                        "hammersley", "sobol")),
                          ("orthographic", ("sobol",)),
                          ("spherical", ("sobol",)),
                          ("radiancemeter", ("sobol",))):
        indep = driver.render(front_end_scene(FRONT_RES, 8, sensor=sensor),
                              seed=20, **small)
        for kind in kinds:
            t0 = time.time()
            img_k = driver.render(front_end_scene(FRONT_RES, 8, sampler=kind,
                                                  sensor=sensor),
                                  seed=21, **small)
            what = f"phase 13: {sensor}, {kind}"
            if not (np.isfinite(img_k).all() and np.isfinite(indep).all()):
                raise AssertionError(f"{what}: a non-finite image")
            summary = ("finite, mean " + f"{float(img_k.mean()):.5f}"
                       if sensor == "radiancemeter"
                       else mean_gate(img_k, indep, what))
            print(f"{what} {FRONT_RES}x{FRONT_RES} {FRONT_SPP} spp in "
                  f"{time.time() - t0:.2f} s: {summary} [{tag}]")

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        # a wall-clock budget, with an .sdt dump for each iteration but a
        # final one
        sc_t = front_end_scene(
            RES, TIME_BUDGET_S,
            settings='<string name="budgetType" value="seconds"/>'
                     '<boolean name="dumpSDTree" value="true"/>')
        tr_t = GuidedPathTracer(sc_t, chunk=CHUNK, overrides=IMPROVED,
                                device="cuda")
        tr_t.dump_path = os.path.join(tmp, "cbox")
        leaves, dump = [], tr_t._dump

        def counted(it):
            leaves.append(int((tr_t.host_tree.statw_s > 0).sum()))
            dump(it)
        tr_t._dump = counted
        t0 = time.time()
        img_t = tr_t.render(seed=5)
        wall_t = time.time() - t0
        files = sorted(glob.glob(os.path.join(tmp, "cbox-*.sdt")))
        records = [len(read_sdt(f)[1]) for f in files]
        iters = len(tr_t.tree_stats)
        if iters < 2 or not np.isfinite(img_t).all() or \
                records != leaves or not files:
            raise AssertionError(f"phase 13: time budget: {iters} "
                                 f"iterations, {len(files)} dumps holding "
                                 f"{records} records for {leaves} leaves")
        print(f"phase 13: budgetType seconds, budget {TIME_BUDGET_S} s: "
              f"{wall_t:.2f} s wall, {iters} iterations of "
              f"{[s['passes'] for s in tr_t.stats]} passes; dumpSDTree "
              f"wrote {len(files)} .sdt files, read back with {records} "
              f"records, one per spatial leaf of positive statistical "
              f"weight [{tag}]")

        # a checkpointed render stopped after its first iteration and
        # resumed by a fresh tracer equals the uninterrupted render
        ck = os.path.join(tmp, "r.ckpt")
        tr_a = GuidedPathTracer(sc, chunk=CHUNK, overrides=IMPROVED,
                                device="cuda")
        save = tr_a._save_checkpoint

        class Stop(Exception):
            pass

        def save_and_stop(path, state):
            save(path, state)
            raise Stop()
        tr_a._save_checkpoint = save_and_stop
        try:
            tr_a.render(seed=0, checkpoint=ck)
        except Stop:
            pass
        tr_b = GuidedPathTracer(sc, chunk=CHUNK, overrides=IMPROVED,
                                device="cuda")
        img_b = tr_b.render(seed=0, checkpoint=ck)
        same = bool(np.array_equal(img_b.view(np.int32), img.view(np.int32)))
        print(f"phase 13: a checkpointed render stopped after iteration 0 "
              f"({os.path.getsize(ck)} bytes) and resumed: "
              f"{len(tr_b.tree_stats)} iterations rendered on resume, the "
              f"image {'' if same else 'NOT '}bit-identical to the "
              f"uninterrupted render [{tag}]")
        if not same:
            raise AssertionError("phase 13: the resumed render differs")
    return counts, rows


def vndf_classes(args, gate):
    """The lanes of one K8 call, in the plain version's own terms: (gated
    in, the stretched wi within 1e-4 of the normal), bool [L] each; every
    lane is gated in when `gate` is None, else those whose family (gate[0],
    int32 [L]) has its bit in the mask gate[1]."""
    dist, au, av, wi, u = args
    if gate is None:
        sel = torch.ones_like(dist, dtype=torch.bool)
    else:
        mt, fams = gate
        sel = torch.isin(mt, torch.tensor(
            [t for t in range(32) if fams >> t & 1], dtype=torch.int32,
            device=mt.device))
    s = torch.stack([au * wi[:, 0], av * wi[:, 1], wi[:, 2]], -1)
    z = s[:, 2] / torch.sqrt((s * s).sum(-1))
    theta = torch.where(z < 0.99999, torch.acos(z.clamp(-1, 1)), 0.0)
    return sel, theta < 1e-4


def vndf_bound_ms(dist, near0, sel=None):
    """K8's bound on one call: bytes at the HBM rate or the FP32 operations
    the plain version's steps need (OPS_VNDF_*: a GGX lane's closed form, a
    Beckmann lane's rounds or its normal-incidence case), whichever is
    larger. With `sel` None, the ungated count: VNDF_BYTES and the
    operations of every lane (each lane not GGX counted as Beckmann). With
    `sel` (the gated-in lanes), the gated count: VNDF_LANE_BYTES a lane,
    VNDF_IN_BYTES more and the operations only on the gated-in lanes.
    Returns (ms, which term, operations)."""
    from ppg_tpu_torch.bsdf import microfacet as MF

    L = dist.shape[0]
    every = sel is None
    sel = torch.ones_like(near0) if every else sel
    ggx = sel & (dist == MF.GGX)
    n_in, n_ggx = int(sel.sum()), int(ggx.sum())
    n_near = int((sel & ~ggx & near0).sum())
    n_rounds = n_in - n_ggx - n_near
    n_bytes = (L * VNDF_BYTES if every
               else L * VNDF_LANE_BYTES + n_in * VNDF_IN_BYTES)
    ops = (n_in * OPS_VNDF_LANE + n_ggx * OPS_VNDF_GGX
           + n_near * OPS_VNDF_NEAR0
           + n_rounds * (OPS_VNDF_BECK + MF.ROUNDS * OPS_VNDF_ROUND))
    mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_PER_S * 1e3
    return max(mem_ms, ops_ms), ("bytes" if mem_ms >= ops_ms
                                 else "operations"), ops


def storage_copies(ts):
    """Copies of the tensors ts with their strides and offsets, those that
    view one storage (the gathered material rows) viewing one copy of it."""
    new, out = {}, []
    for t in ts:
        st = t.untyped_storage()
        if st.data_ptr() not in new:
            new[st.data_ptr()] = st.clone()
        out.append(torch.empty(0, dtype=t.dtype, device=t.device).set_(
            new[st.data_ptr()], t.storage_offset(), t.shape, t.stride()))
    return out


def k8_rows(tag, args, phase=14, label="the render's last call"):
    """Phase 14's (or `phase`'s) K8 part: the kernel against
    sample_visible_plain with the same gate on the card, bit for bit on
    every lane (two NaNs equal), on the render's last call (`label`;
    `args`: dist, alpha_u, alpha_v, wi, u and its
    gate, the lanes' families and the present microfacet families' mask);
    timed through its wrapper, alone (100 launches in a CUDA graph over
    K8_SETS copies of its inputs with their strides, the material rows'
    storage copied once a set, above the L2) and its plain version (and
    the plain version's launches counted), beside both bounds
    (vndf_bound_ms: the gated count, and the ungated one as old_bound_ms).
    Returns {(name, what): row}."""
    from ppg_tpu_torch.bsdf import microfacet as MF

    args, gate = tuple(args[:5]), args[5] if len(args) > 5 else None
    dist, au, av, wi, u = args
    L = wi.shape[0]
    got = MF.sample_visible(*args, gate)
    want = MF.sample_visible_plain(*args, gate)
    n_bad = int(bits_differ(got.reshape(-1), want.reshape(-1)).sum())
    err = float((got - want).abs().nan_to_num().max())
    sel, near0 = vndf_classes(args, gate)
    bound, by, ops = vndf_bound_ms(dist, near0, sel)
    old, old_by, old_ops = vndf_bound_ms(dist, near0)
    n_in = int(sel.sum())
    n_ggx = int((sel & (dist == MF.GGX)).sum())
    print(f"phase {phase}: vndf {label}, L={L}, {n_in} lanes gated in "
          f"({n_ggx} GGX, {n_in - n_ggx} Beckmann): {n_bad} values differ "
          f"in a bit from the plain version with the same gate on the card, "
          f"on every lane [{tag}]")
    if n_bad:
        raise AssertionError(f"phase {phase}: K8: {n_bad} values differ")
    ts = list(args) + ([] if gate is None else [gate[0]])
    sets = [storage_copies(ts) for _ in range(K8_SETS)]
    turn = iter(range(1 << 30))

    def cold():
        t = sets[next(turn) % K8_SETS]
        MF.sample_visible(*t[:5], None if gate is None else (t[5], gate[1]))
    what = f"L={L}, {label}"
    plain_launches = cuda_kernels(
        lambda: MF.sample_visible_plain(*args, gate))[0]
    row = dict(what=what, L=L, gated_in=n_in, ggx_lanes=n_ggx, ops=ops,
               plain_launches=plain_launches,
               ms=cuda_ms(lambda: MF.sample_visible(*args, gate), 50,
                          batches=5),
               kernel_only_ms=graph_ms(cold),
               plain_ms=cuda_ms(lambda: MF.sample_visible_plain(*args, gate),
                                3, batches=2),
               library_ms=None, bound_ms=bound, bound_by=by,
               bound="memory" if by == "bytes" else "fp32",
               old_bound_ms=old, old_bound_by=old_by, old_ops=old_ops,
               max_abs_err=err)
    del sets
    print(f"phase {phase}: vndf {what}: wrapper {row['ms']:.4f} ms, kernel "
          f"alone "
          f"{row['kernel_only_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
          f"in {plain_launches} launches, library: none; gated bound "
          f"{bound:.5f} ms from {row['bound']} ({ops} operations), kernel "
          f"alone at its {bound / row['kernel_only_ms']:.1%}; the ungated "
          f"bound "
          f"(44 B and the operations of every lane) {old:.5f} ms from "
          f"{old_by} ({old_ops} operations), at its "
          f"{old / row['kernel_only_ms']:.1%} [{tag}]")
    return {("vndf", what): row}


def vndf_lane_mix(tracer, tag, seed=13):
    """The lanes of each visible-normal call (one a bounce) of one training
    chunk step of the whole frame on the tracer's built tree: lanes, gated
    in, GGX, Beckmann rounds, Beckmann at normal incidence, and gated-in
    lanes whose path has ended (the tracer's `act` false at the call, read
    from trace_paths' frame). Returns the ended paths' share of the
    gated-in lanes."""
    from ppg_tpu_torch.bsdf import microfacet as MF
    from ppg_tpu_torch.device import generator
    from ppg_tpu_torch.integrators import guided

    mix, sample = [], MF.sample_visible

    def count(*args):
        gate = args[5] if len(args) > 5 else None
        sel, near0 = vndf_classes(args[:5], gate)
        ggx = sel & (args[0] == MF.GGX)
        f = sys._getframe(1)
        while f.f_code.co_name != "trace_paths":
            f = f.f_back
        ended = sel & ~f.f_locals["act"]
        mix.append([args[0].shape[0]] + [int(x.sum()) for x in (
            sel, ggx, sel & ~ggx & ~near0, sel & ~ggx & near0, ended)])
        return sample(*args)

    cfg = tracer._cfg(True, tracer._do_nee(0), False)
    lf = tracer.loss if tracer.loss != "none" else None
    MF.sample_visible = count
    try:
        guided._chunk_step(
            tracer.scene_dev, cfg, tracer.sensor, tracer.film, tracer.chunk,
            tracer.spatial_filter, tracer.directional_filter, lf,
            tracer._zeros(), tracer._zeros(), tracer._push(),
            generator(seed, "cuda"), 0)
    finally:
        MF.sample_visible = sample
    for j, (n, n_in, g, r, z, e) in enumerate(mix, 1):
        print(f"phase 14: training wavefront, bounce {j}: {n} lanes, {n_in} "
              f"gated in: {g} GGX, {r} Beckmann rounds, {z} Beckmann at "
              f"normal incidence; {e} gated-in lanes of ended paths [{tag}]")
    n_in, ended = sum(m[1] for m in mix), sum(m[5] for m in mix)
    share = ended / max(n_in, 1)
    print(f"phase 14: training wavefront: {n_in} gated-in lanes over "
          f"{len(mix)} bounces, {ended} of them ({share:.1%}) on ended "
          f"paths [{tag}]")
    return share


def erfinv_probe(tag):
    """Which erfinv ATen runs on the card: torch.erfinv on 2,000,001
    values across (-1, 1) against ATen's CPU algorithm (calc_erfinv) spelt
    out in ATen operations on the card, and against torch.erfinv on the
    CPU. K8 calls the CUDA math library's erfinvf; phase 14's bit-for-bit
    check is what shows ATen's CUDA erfinv to be that function."""
    y = torch.linspace(-0.9999999, 0.9999999, 2_000_001, device="cuda")
    a = (0.886226899, -1.645349621, 0.914624893, -0.140543331)
    b = (-2.118377725, 1.442710462, -0.329097515, 0.012229801)
    c = (-1.970840454, -1.624906493, 3.429567803, 1.641345311)
    d = (3.543889200, 1.637067800)
    z = y * y
    x_in = y * ((((a[3] * z + a[2]) * z + a[1]) * z + a[0])
                / ((((b[3] * z + b[2]) * z + b[1]) * z + b[0]) * z + 1.0))
    w = torch.sqrt(-torch.log((1.0 - y.abs()) / 2.0))
    x_out = torch.copysign(((c[3] * w + c[2]) * w + c[1]) * w + c[0], y) / (
        (d[1] * w + d[0]) * w + 1.0)
    x = torch.where(y.abs() <= 0.7, x_in, x_out)
    k = float(np.float32(2.0) * np.float32(0.564189583547756286948))
    for _ in range(2):
        x = x - (torch.erf(x) - y) / (k * torch.exp(-x * x))
    got = torch.erfinv(y)
    n_calc = int(bits_differ(got, x).sum())
    n_cpu = int(bits_differ(got.cpu(), torch.erfinv(y.cpu())).sum())
    print(f"phase 14: torch.erfinv on the card differs in a bit from ATen's "
          f"calc_erfinv (in ATen operations on the card) on {n_calc} of "
          f"{y.numel()} values (largest difference "
          f"{float((got - x).abs().max()):.3g}) and from torch.erfinv on the "
          f"CPU on {n_cpu}: ATen's CUDA erfinv is the CUDA math library's "
          f"erfinvf, which K8 calls [{tag}]")


def materials_phase(tag, tracer5):
    """Phase 14: the BSDF table at full width. mini_cbox_materials (the
    glossy floor, the copper back wall, the plastic wall, a rough and a
    smooth glass sphere: 32,268 triangles through the BVH walk) at 512^2,
    127 spp, maxDepth 10, cbox-improved's settings, through
    GuidedPathTracer: K2-K7 and K8 launch, no plain visible-normal sample
    on the card; gated against driver.render of the same scene; its
    launches per training wavefront beside phase 5's; the configuration
    rendered twice at MATERIALS_REPEAT_SPP from one seed, bit-identical;
    K8 against its plain version on the render's last call, timed beside
    its bound (k8_rows); which erfinv ATen runs on the card. Returns
    (counts, K8 rows)."""
    from ppg_tpu_torch.bsdf import microfacet as MF
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.scene.testscenes import mini_cbox_materials

    sc = mini_cbox_materials(res=RES, budget=BUDGET, max_depth=MAX_DEPTH)
    tracer = GuidedPathTracer(sc, chunk=CHUNK, overrides=IMPROVED,
                              device="cuda")
    seen, sample = {}, MF.sample_visible

    def keep(*args):
        seen["args"] = args
        return sample(*args)
    MF.sample_visible = keep
    try:
        img, counts, wall = guided_run(14, tracer, tag, walk=True)
    finally:
        MF.sample_visible = sample
    sched = [(s["passes"], s["is_final"]) for s in tracer.stats]
    if sched != [(1 << i, i == 6) for i in range(7)]:
        raise AssertionError(f"phase 14: unexpected schedule {sched}")
    rays = sum(s["n_rays"] for s in tracer.stats)
    pass_s = sum(s["seconds"] for s in tracer.stats)
    print(f"phase 14: materials box ({sc.faces.shape[0]} triangles: "
          f"roughplastic, roughconductor, plastic, roughdielectric, "
          f"dielectric, diffuse) {RES}x{RES} {BUDGET} spp maxDepth "
          f"{MAX_DEPTH}, cbox-improved's settings: {wall:.2f} s wall, "
          f"{pass_s:.2f} s in passes, {rays} rays, "
          f"{rays / pass_s / 1e6:.1f} Mrays/s, {counts['vndf_kernel']} K8 "
          f"launches, {counts['vndf_plain_on_cuda']} plain visible-normal "
          f"samples on the card, {counts['bvh_kernel']} walk, "
          f"{counts['sd_lookup']} K3 and {counts['sd_sample_pdf']} K4 "
          f"launches, no jax [{tag}]")
    n14, n5 = wavefront_launches(tracer), wavefront_launches(tracer5)
    print(f"phase 14: kernel launches per training wavefront: {n14} "
          f"(phase 5's configuration on its tree: {n5}) [{tag}]")
    t0 = time.time()
    ref = driver.render(sc, spp=BUDGET, seed=2, chunk=CHUNK, device="cuda")
    print(f"phase 14: unguided {BUDGET} spp in {time.time() - t0:.2f} s "
          f"[{tag}]; " + gate(img, ref, "phase 14: materials guided vs "
                                         "unguided"))
    sc_r = mini_cbox_materials(res=RES, budget=MATERIALS_REPEAT_SPP,
                               max_depth=MAX_DEPTH)
    twice = [GuidedPathTracer(sc_r, chunk=CHUNK, overrides=IMPROVED,
                              device="cuda").render(seed=3)
             for _ in range(2)]
    same = bool(np.array_equal(twice[0].view(np.int32),
                               twice[1].view(np.int32)))
    print(f"phase 14: the configuration at {MATERIALS_REPEAT_SPP} spp "
          f"rendered twice from seed 3: {'' if same else 'NOT '}"
          f"bit-identical [{tag}]")
    if not same:
        raise AssertionError("phase 14: two renders from one seed differ")
    vndf_lane_mix(tracer, tag)
    rows = k8_rows(tag, seen["args"])
    erfinv_probe(tag)
    return counts, rows, tracer


def wrappers_phase(tag, tracer5, tracer14):
    """Phase 15: the material wrappers at full width (see the module
    docstring). Returns (counts, K8 rows)."""
    from ppg_tpu_torch.bsdf import microfacet as MF
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators import wavefront as WF
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.scene.scene import MAT_ROUGHCOATING
    from ppg_tpu_torch.scene.testscenes import (mini_cbox_wrappers_xml,
                                                scene_from_xml)

    xml = mini_cbox_wrappers_xml(res=RES, budget=BUDGET, max_depth=MAX_DEPTH,
                                 nee="always")
    sc = scene_from_xml(xml)  # through load_scene
    tracer = GuidedPathTracer(sc, chunk=CHUNK, overrides=IMPROVED,
                              device="cuda")
    seen, sample = {}, MF.sample_visible

    def keep(*args):
        gate = args[5] if len(args) > 5 else None
        seen["interface" if gate is not None
             and gate[1] == 1 << MAT_ROUGHCOATING else "table"] = args
        return sample(*args)
    MF.sample_visible = keep
    WF.reset_counts()
    try:
        img, counts, wall = guided_run(15, tracer, tag, walk=True)
    finally:
        MF.sample_visible = sample
    walk = dict(WF.WALK_COUNTS)
    sched = [(s["passes"], s["is_final"]) for s in tracer.stats]
    if sched != [(1 << i, i == 6) for i in range(7)]:
        raise AssertionError(f"phase 15: unexpected schedule {sched}")
    if walk["walks"] == 0 or walk["crossings"] <= walk["walks"]:
        raise AssertionError(f"phase 15: the shadow walk did not cross the "
                             f"panel or the rectangle: {walk}")
    rays = sum(s["n_rays"] for s in tracer.stats)
    pass_s = sum(s["seconds"] for s in tracer.stats)
    print(f"phase 15: wrapper box ({sc.faces.shape[0]} triangles: mask, "
          f"null, blendbsdf, mixturebsdf, coating, roughcoating over "
          f"diffuse, roughplastic, roughconductor and conductor) {RES}x{RES} "
          f"{BUDGET} spp maxDepth {MAX_DEPTH}, cbox-improved's settings, nee "
          f"always: {wall:.2f} s wall, {pass_s:.2f} s in passes, {rays} "
          f"rays, {rays / pass_s / 1e6:.1f} Mrays/s, {counts['vndf_kernel']}"
          f" K8 launches, {counts['vndf_plain_on_cuda']} plain "
          f"visible-normal samples on the card, {counts['bvh_kernel']} "
          f"closest-hit walk launches, {counts['sd_lookup']} K3 and "
          f"{counts['sd_sample_pdf']} K4 launches, no jax [{tag}]")
    per = {k: walk[k] / walk["walks"] for k in ("crossings", "host_reads")}
    print(f"phase 15: shadow walk: {walk['walks']} walks (one a bounce), "
          f"{walk['crossings']} crossings ({per['crossings']:.3f} a "
          f"bounce), {walk['host_reads']} host reads "
          f"({per['host_reads']:.3f} a bounce) [{tag}]")
    n15, n15_off = (wavefront_launches(tracer, do_nee=d)
                    for d in (None, False))
    n14, n5 = wavefront_launches(tracer14), wavefront_launches(tracer5)
    lo, hi = WRAPPERS_PREDICTED_LAUNCHES
    print(f"phase 15: kernel launches per training wavefront: {n15} "
          f"(phase 14's configuration on its tree: {n14}, phase 5's: {n5}; "
          f"predicted in PERF.md {lo}-{hi}"
          f"{', above 1.5 x phase 14' if n15 > 1.5 * n14 else ''}); "
          f"without NEE on the same tree, as phase 14 runs: {n15_off} "
          f"[{tag}]")
    MF.reset_counts()
    t0 = time.time()
    ref = driver.render(sc, spp=WRAPPERS_REF_SPP, seed=2, chunk=CHUNK,
                        device="cuda")
    print(f"phase 15: unguided {WRAPPERS_REF_SPP} spp in "
          f"{time.time() - t0:.2f} s "
          f"[{tag}]; " + gate(img, ref, "phase 15: wrappers guided vs "
                                         "unguided"))
    sc_n = scene_from_xml(mini_cbox_wrappers_xml(
        res=RES, budget=BUDGET, max_depth=MAX_DEPTH, nee="never"))
    t0 = time.time()
    ref_n = driver.render(sc_n, spp=WRAPPERS_REF_SPP, seed=4, chunk=CHUNK,
                          device="cuda")
    print(f"phase 15: unguided nee never {WRAPPERS_REF_SPP} spp in "
          f"{time.time() - t0:.2f} s [{tag}]; "
          + gate(ref_n, ref, "phase 15: unguided nee never vs always",
                 ("nee never", "nee always")))
    if MF.COUNTS["vndf_plain_on_cuda"]:
        raise AssertionError(f"phase 15: a plain visible-normal sample ran "
                             f"on the card: {MF.COUNTS}")
    sc_r = scene_from_xml(mini_cbox_wrappers_xml(
        res=RES, budget=WRAPPERS_REPEAT_SPP, max_depth=MAX_DEPTH,
        nee="always"))
    twice = [GuidedPathTracer(sc_r, chunk=CHUNK, overrides=IMPROVED,
                              device="cuda").render(seed=3)
             for _ in range(2)]
    same = bool(np.array_equal(twice[0].view(np.int32),
                               twice[1].view(np.int32)))
    print(f"phase 15: the configuration at {WRAPPERS_REPEAT_SPP} spp "
          f"rendered twice from seed 3: {'' if same else 'NOT '}"
          f"bit-identical [{tag}]")
    if not same:
        raise AssertionError("phase 15: two renders from one seed differ")
    rows = k8_rows(tag, seen["table"], 15, "the render's last table call")
    rows.update(k8_rows(tag, seen["interface"], 15,
                        "the render's last interface call"))
    return counts, rows, tracer


def atlas_classes(args):
    """Per lookup of a K9 call (TX.kernel_args' inputs: atlas, tex_id, uv,
    foot_uv, duv, bump): the lookups that return white (slot <= 0), and of
    the others the FP32 operations the plain version's steps need, by what
    this call's data asks (OPS_*: a bilinear tap; a trilinear lookup; the
    footprint's lod; the ellipse; an EWA lookup's 4 taps where the
    ellipse is EWA, else the one lookup its taps all repeat)."""
    from ppg_tpu_torch.scene import textures as TX

    atlas, tid, uv, foot, duv, bump = args
    n = 3 * uv.shape[0] if bump else tid.shape[0]
    slot = tid.repeat(3) if bump else tid
    live = slot > 0
    if duv is None:
        per = OPS_BILINEAR if foot is None else OPS_FOOT + OPS_TRILINEAR
        return live, int(live.sum()) * per
    reps = n // uv.shape[0]
    d0, d1 = duv[0].repeat(reps, 1), duv[1].repeat(reps, 1)
    s = torch.clamp(slot, 0, atlas.n_slots - 1).long()
    m0, f = atlas.meta[s], atlas.filt[s]
    x4 = atlas.uvx[s]
    su, sv = x4[:, 0] * m0[:, 1].float(), x4[:, 1] * m0[:, 2].float()
    du0, dv0, du1, dv1 = d0[:, 0] * su, d0[:, 1] * sv, d1[:, 0] * su, \
        d1[:, 1] * sv
    A, C = dv0 * dv0 + dv1 * dv1, du0 * du0 + du1 * du1
    B = -2.0 * (du0 * dv0 + du1 * dv1)
    F = A * C - 0.25 * B * B
    ewa = live & (f[:, 0] == TX.F_EWA) & (F > 0)
    lin = live & ~ewa & (f[:, 0] >= TX.F_BILINEAR)
    tri = live & ~ewa & ~lin
    ops = (int(live.sum()) * OPS_ELLIPSE + int(ewa.sum()) * OPS_EWA_TAPS
           + int(lin.sum()) * OPS_BILINEAR + int(tri.sum()) * OPS_TRILINEAR)
    return live, ops


def atlas_bound_ms(args):
    """K9's bound on this call: each slot id the call is given (4 B: one a
    lookup, one a lane of a bump call, whose three lookups share it), each
    lookup's output (12 B), each lane's uv (8 B) and differentials (8 B a
    footprint, 16 B a Jacobian), and 24 B for each distinct atlas row the
    plain version reads, at the HBM rate; or atlas_classes' FP32 operations, whichever
    takes longer. Returns (ms, "bytes" or "operations", operations,
    distinct rows)."""
    from ppg_tpu_torch.scene import textures as TX

    atlas, tid, uv, foot, duv, bump = args
    rows = []
    TX.sample_atlas_plain(atlas, tid, uv, foot, duv, bump=bump, stats=rows)
    distinct = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    n = 3 * uv.shape[0] if bump else tid.shape[0]
    diff = 16 if duv is not None else 8 if foot is not None else 0
    nbytes = (4 * tid.shape[0] + 12 * n + (8 + diff) * uv.shape[0]
              + 24 * distinct)
    ops = atlas_classes(args)[1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", ops, distinct)


def k9_rows(tag, calls):
    """Phase 16's K9 part: on the render's last call of each kind (`calls`:
    kind -> the _launch arguments), K9 against sample_atlas_plain on the
    card, bit for bit on every lookup (two NaNs equal); each call's
    lookups, its wrapper (TX.sample_atlas or TX.bump_lookups), the kernel
    alone (100 launches in a CUDA graph over K9_SETS copies of its inputs,
    the atlas among them, above the L2) and the plain version (its
    launches counted) beside atlas_bound_ms. Returns {(name, what): row}."""
    from ppg_tpu_torch.scene import textures as TX

    rows = {}
    for kind, args in calls.items():
        atlas, tid, uv, foot, duv, bump = args
        plain = (lambda: TX.sample_atlas_plain(atlas, tid, uv, foot, duv,
                                               bump=bump))
        got = TX._launch(*args)
        want = plain()
        n_bad = int(bits_differ(got.reshape(-1), want.reshape(-1)).sum())
        err = float((got - want).abs().nan_to_num().max())
        live, _ = atlas_classes(args)
        n = got.shape[0]
        print(f"phase 16: atlas {kind}: {n} lookups ({int(live.sum())} "
              f"textured) over {uv.shape[0]} lanes: {n_bad} values differ in "
              f"a bit from the plain version on the card [{tag}]")
        if n_bad:
            raise AssertionError(f"phase 16: K9 {kind}: {n_bad} values differ")
        bound, by, ops, distinct = atlas_bound_ms(args)
        sets = []
        for _ in range(K9_SETS):
            a = copy.copy(atlas)
            a.pixels = atlas.pixels.clone()
            sets.append((a, tid.clone(), uv.clone(),
                         None if foot is None else foot.clone(),
                         None if duv is None else tuple(d.clone()
                                                        for d in duv), bump))
        turn = iter(range(1 << 30))

        def cold():
            TX._launch(*sets[next(turn) % K9_SETS])
        wrap = ((lambda: TX.bump_lookups(atlas, tid, uv)) if bump else
                (lambda: TX.sample_atlas(atlas, tid, uv, foot, duv)))
        plain_launches = cuda_kernels(plain)[0]
        row = dict(what=kind, lookups=n, textured=int(live.sum()), ops=ops,
                   distinct_rows=distinct, plain_launches=plain_launches,
                   ms=cuda_ms(wrap, 50, batches=5),
                   kernel_only_ms=graph_ms(cold),
                   plain_ms=cuda_ms(plain, 3, batches=2),
                   library_ms=None, bound_ms=bound, bound_by=by,
                   bound="memory" if by == "bytes" else "fp32",
                   max_abs_err=err)
        del sets
        print(f"phase 16: atlas {kind}: wrapper {row['ms']:.4f} ms, kernel "
              f"alone {row['kernel_only_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms in {plain_launches} launches, "
              f"library: none (grid_sample takes one image a batch, no "
              f"repeat wrap, no MIP chain); bound {bound:.5f} ms from {by} "
              f"({distinct} distinct atlas rows, {ops} operations), kernel "
              f"alone at its {bound / row['kernel_only_ms']:.1%} [{tag}]")
        rows[("atlas", kind)] = row
    return rows


def textures_phase(tag, tracer15, tmp):
    """Phase 16: the textures at full width (see the module docstring);
    tracer15, phase 15's tracer, gives its launches a training wavefront
    beside phase 16's (None: not printed). The bitmaps are written into
    tmp. Returns (counts of the main render with its K9 launches, K9
    rows)."""
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators import wavefront as WF
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.scene import textures as TX
    from ppg_tpu_torch.scene.testscenes import (
        light_down, mini_cbox_texture_variant_xml, mini_cbox_textures_xml,
        orthographic, scene_from_xml)

    t0 = time.time()
    xml = mini_cbox_textures_xml(tmp, res=RES, budget=BUDGET,
                                 max_depth=MAX_DEPTH, nee="always",
                                 floor_res=TEX_FLOOR_RES,
                                 bump_res=TEX_BUMP_RES, seed=16)
    sc = scene_from_xml(xml)
    tracer = GuidedPathTracer(sc, chunk=CHUNK, overrides=IMPROVED,
                              device="cuda")
    atlas = tracer.scene_dev.tex
    print(f"phase 16: textured box ({sc.faces.shape[0]} triangles; "
          f"{len(sc.textures.specs)} textures: a {TEX_FLOOR_RES}^2 EWA "
          f"bitmap floor, a checkerboard, a {TEX_BUMP_RES}^2 bump map over "
          f"a GGX roughplastic, a normal map, a gridtexture mask opacity, a "
          f"scale texture on the sphere) written, loaded and its atlas "
          f"built in {time.time() - t0:.2f} s: {atlas.pixels.shape[0]} rows, "
          f"{atlas.pixels.numel() * 2 / 1e6:.1f} MB of float16 on the card "
          f"[{tag}]")
    calls, launch = {}, TX._launch

    def keep(atlas, tex_id, uv, foot_uv=None, duv=None, bump=False):
        kind = ("bump" if bump else "walk" if foot_uv is None and duv is None
                else "site, later bounce" if duv is not None and duv[0] is
                duv[1] else "site, first bounce")
        calls[kind] = (atlas, tex_id, uv, foot_uv, duv, bump)
        return launch(atlas, tex_id, uv, foot_uv, duv, bump)
    TX._launch = keep
    WF.reset_counts()
    try:
        img, counts, wall = guided_run(16, tracer, tag, walk=True)
    finally:
        TX._launch = launch
    walk = dict(WF.WALK_COUNTS)
    sched = [(s["passes"], s["is_final"]) for s in tracer.stats]
    if sched != [(1 << i, i == 6) for i in range(7)]:
        raise AssertionError(f"phase 16: unexpected schedule {sched}")
    if set(calls) != {"bump", "walk", "site, later bounce",
                      "site, first bounce"}:
        raise AssertionError(f"phase 16: K9 calls of kinds {sorted(calls)}")
    rays = sum(s["n_rays"] for s in tracer.stats)
    pass_s = sum(s["seconds"] for s in tracer.stats)
    print(f"phase 16: textured box {RES}x{RES} {BUDGET} spp maxDepth "
          f"{MAX_DEPTH}, cbox-improved's settings, nee always: {wall:.2f} s "
          f"wall, {pass_s:.2f} s in passes, {rays} rays, "
          f"{rays / pass_s / 1e6:.1f} Mrays/s, {counts['atlas_kernel']} K9 "
          f"launches, {counts['atlas_plain_on_cuda']} plain lookups on the "
          f"card, {counts['vndf_kernel']} K8, {counts['bvh_kernel']} "
          f"closest-hit walk launches, {walk['crossings']} shadow-walk "
          f"crossings in {walk['walks']} walks, no jax [{tag}]")
    TX.reset_counts()
    n16 = wavefront_launches(tracer)
    k9_wave = TX.COUNTS["atlas_kernel"] // 2  # the untimed step and this
    n16_off = wavefront_launches(tracer, do_nee=False)
    n15 = wavefront_launches(tracer15) if tracer15 is not None else None
    lo, hi = TEXTURES_PREDICTED_LAUNCHES
    print(f"phase 16: kernel launches per training wavefront: {n16} "
          f"({k9_wave} of them K9; phase 15's configuration on its tree: "
          f"{n15}; predicted in PERF.md {lo}-{hi}); without NEE on the same "
          f"tree: {n16_off} [{tag}]")
    t0 = time.time()
    ref = driver.render(sc, spp=TEXTURES_REF_SPP, seed=2, chunk=CHUNK,
                        device="cuda")
    print(f"phase 16: unguided {TEXTURES_REF_SPP} spp in "
          f"{time.time() - t0:.2f} s [{tag}]; "
          + gate(img, ref, "phase 16: textures guided vs unguided"))
    sc_r = scene_from_xml(xml.replace(
        f'<float name="budget" value="{BUDGET}"/>',
        f'<float name="budget" value="{TEXTURES_REPEAT_SPP}"/>'))
    twice = [GuidedPathTracer(sc_r, chunk=CHUNK, overrides=IMPROVED,
                              device="cuda").render(seed=3)
             for _ in range(2)]
    same = bool(np.array_equal(twice[0].view(np.int32),
                               twice[1].view(np.int32)))
    print(f"phase 16: the configuration at {TEXTURES_REPEAT_SPP} spp "
          f"rendered twice from seed 3: {'' if same else 'NOT '}"
          f"bit-identical [{tag}]")
    if not same:
        raise AssertionError("phase 16: two renders from one seed differ")
    rows = k9_rows(tag, calls)
    # the smaller renders, each guided against its unguided render; their
    # luminaire faces the floor (light_down), which it lights directly
    small = {v: mini_cbox_texture_variant_xml(
        v, tmp, res=TEXTURES_SMALL_RES, budget=TEXTURES_SMALL_SPP,
        max_depth=MAX_DEPTH, nee="always")
        for v in ("vertexcolors", "wireframe", "curvature")}
    small["orthographic EWA floor"] = orthographic(light_down(
        mini_cbox_textures_xml(
        tmp, res=TEXTURES_SMALL_RES, budget=TEXTURES_SMALL_SPP,
        max_depth=MAX_DEPTH, nee="always", floor_res=TEX_FLOOR_RES,
        bump_res=TEX_BUMP_RES, seed=16, sphere=False)))
    for name, x in small.items():
        s = scene_from_xml(x)
        TX.reset_counts()
        t0 = time.time()
        g = GuidedPathTracer(s, chunk=TEXTURES_SMALL_RES ** 2,
                             overrides=IMPROVED, device="cuda").render(seed=0)
        u = driver.render(s, spp=TEXTURES_SMALL_SPP, seed=1,
                          chunk=TEXTURES_SMALL_RES ** 2, device="cuda")
        if TX.COUNTS["atlas_kernel"] <= 0 or TX.COUNTS["atlas_plain_on_cuda"]:
            raise AssertionError(f"phase 16: {name}: {TX.COUNTS}")
        print(f"phase 16: {name} {TEXTURES_SMALL_RES}x{TEXTURES_SMALL_RES} "
              f"{TEXTURES_SMALL_SPP} spp ({s.faces.shape[0]} triangles), "
              f"guided and unguided in {time.time() - t0:.2f} s, "
              f"{TX.COUNTS['atlas_kernel']} K9 launches [{tag}]; "
              + gate(g, u, f"phase 16: {name} guided vs unguided"))
    return counts, rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    from ppg_tpu_torch.accel import brute as B
    from ppg_tpu_torch.accel import bvh_walk as BW
    from ppg_tpu_torch.bsdf import microfacet as MF
    from ppg_tpu_torch.guiding import descent as D
    from ppg_tpu_torch.guiding import train as TR
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.ops import reduce as R
    from ppg_tpu_torch.render import film as F
    from ppg_tpu_torch.scene import mini_cbox
    from ppg_tpu_torch.scene import textures as TX
    from ppg_tpu_torch.tools.sdtree_cases import capture_sampling_trees

    # phase 0: versions and the card
    tag = card()
    print(tag)  # as nvidia-smi prints it: name, power limit
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"card {tag}")

    # phase 1: build the kernels; the port's own host libraries must build
    # and load
    t0 = time.time()
    with ThreadPoolExecutor(8) as pool:  # one nvcc per source, together
        list(pool.map(lambda build: build(),
                      (B.build, BW.build, D.build, TR.build, R.build,
                       F.build, MF.build, TX.build)))
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
    print(f"phase 1: built csrc/brute.cu, csrc/bvh.cu, csrc/sdtree.cu, "
          f"csrc/train.cu, csrc/reduce.cu, csrc/film.cu (K7 and K7s), "
          f"csrc/microfacet.cu (K8) and csrc/textures.cu (K9) in "
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
    pending3, undo = capture_pending()
    try:
        with capture_sampling_trees(tracer) as trees3:
            img, counts, wall = guided_run(3, tracer, tag)
    finally:
        undo()
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
        img5, counts5, wall5 = guided_run(5, tracer5, tag, host_times=True)
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
    pending6, undo = capture_pending()
    try:
        img6, counts6, wall6 = guided_run(6, tracer6, tag)
    finally:
        undo()
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

    # the host's cost of a launch after each later phase (HostTimes gives
    # it at phase 5's and phase 13's renders)
    cost = lambda after: print(f"host time a launch after phase {after}: "
                               f"{launch_us():.2f} us [{tag}]")
    cost(6)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        walk_rows, walk_err, counts8, counts8b = walk_phases(tag, tmp)
    cost(8)

    # phase 9: the descent kernels on the tree phase 3's last iteration
    # sampled from; phase 10: K5's sums and K7 at the main path's calls
    sd_rows = descent_phase(tag, trees3[-1], sc)
    cost(9)
    # phase 10 is the first to run torch.profiler: one empty session alone
    cuda_kernels(lambda: torch.zeros(1, device="cuda").add_(1.0))
    cost("9 and one torch.profiler session")
    acc_rows = reduce_film_phase(tag, (pending3, pending, pending6))
    cost(10)
    # phase 11: the training kernels at the shapes phases 5 and 6 gave them
    train_rows = train_phase(tag, pending, pending6)
    del pending3
    cost(11)
    # phase 12: repeatability of a training pass and of renders
    repeat_phase(tag, sc, tracer5, img5)
    cost(12)
    # phase 13: the front end (cameras, QMC samplers, filters through K7s,
    # time budget, checkpoints, .sdt dumps)
    counts13, k7s_rows_ = front_end_phase(tag, tracer5)
    cost(13)
    # phase 14: the BSDF table (glossy, plastic and glass materials, K8)
    counts14, k8_rows_, tracer14 = materials_phase(tag, tracer5)
    cost(14)
    # phase 15: the material wrappers and NEE through masks and null
    # surfaces
    counts15, k8_rows15, tracer15 = wrappers_phase(tag, tracer5, tracer14)
    del tracer14
    k8_rows_.update(k8_rows15)
    cost(15)
    # phase 16: the textures (the MIP atlas, every lookup mode through K9,
    # bump and normal maps, textured opacity in the shadow walk, vertex
    # colours, wireframe, curvature, the footprint path)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-tex-") as tmp:
        counts16, k9_rows_ = textures_phase(tag, tracer15, tmp)
    del tracer15

    # launches: every launch of each kernel over the main-path renders
    # (phases 3, 5, 6 and 13 for the sweep, 8a, 8b, 14 and 15 for the
    # walk, 14 and 15 for K8); the numbers are those of the kernel's
    # main-path shape
    # (the sweep: T = 12 triangles, the render's wavefront; the walk:
    # camera rays and the NEE wavefront's shadow rays on the
    # 1,046,540-triangle scene; K7s: phase 13's chunk, gaussian, film and
    # squared film; K8: phase 14's last call)
    sweep = (counts, counts5, counts6, counts13)
    walk = (counts8, counts8b, counts14, counts15, counts16)
    guided = sweep + walk
    launches = {
        "brute_closest": sum(c["brute_kernel"] for c in sweep),
        "brute_any_hit": sum(c["any_hit"] for c in sweep),
        "bvh_closest": sum(c["bvh_kernel"] for c in walk),
        "bvh_any_hit": sum(c["bvh_any_hit"] for c in walk),
        "vndf": sum(c["vndf_kernel"] for c in (counts14, counts15,
                                                 counts16)),
        "atlas": counts16["atlas_kernel"],
        "sd_lookup": sum(c["sd_lookup"] for c in guided),
        "sd_sample_pdf": sum(c["sd_sample_pdf"] for c in guided),
        **{k: sum(c[k] for c in guided)
           for k in ("sd_dir_targets", "sd_stree_box", "sd_adam",
                     "reduce_add", "film_splat", "film_splat_filter")}}
    main = {"brute_closest": (rows, ("brute_closest", 12, CHUNK)),
            "brute_any_hit": (rows, ("brute_any_hit", 12,
                                     NEE_RES * NEE_RES)),
            "bvh_closest": (walk_rows, ("bvh_closest", "camera")),
            "bvh_any_hit": (walk_rows, ("bvh_any_hit", "shadow")),
            "sd_lookup": (sd_rows, ("sd_lookup", "cbox")),
            "sd_sample_pdf": (sd_rows, ("sd_sample_pdf", "cbox")),
            "sd_dir_targets": (train_rows, ("sd_dir_targets",
                                            "shade time, box (phase 5)")),
            "sd_stree_box": (train_rows, ("sd_stree_box",
                                          "box walk (phase 6)")),
            "sd_adam": (train_rows, ("sd_adam", "kl rounds (phase 5)")),
            "reduce_add": (acc_rows, ("reduce_add", "qb box")),
            "film_splat": (acc_rows, ("film_splat", f"C={CHUNK}")),
            "film_splat_filter": (k7s_rows_, (
                "film_splat_filter", f"gaussian, C={CHUNK}, 2 film(s)")),
            "vndf": (k8_rows_, ("vndf", f"L={CHUNK}, the render's last "
                                        f"call")),
            "atlas": (k9_rows_, ("atlas", "site, first bounce"))}
    source = {"brute": ("brute.cu", "ppg_tpu/accel/pallas_brute.py:102",
                        max_err),
              "bvh": ("bvh.cu", "ppg_tpu/accel/traverse.py:333", walk_err),
              "sd_lookup": ("sdtree.cu", "ppg_tpu/guiding/sdtree.py:166",
                            sd_rows[("sd_lookup", "cbox")]["max_abs_err"]),
              "sd_sample_pdf": ("sdtree.cu",
                                "ppg_tpu/guiding/sdtree.py:667",
                                max(r["max_abs_err"] for k, r in
                                    sd_rows.items()
                                    if k[0] == "sd_sample_pdf")),
              **{name: ("train.cu", f"ppg_tpu/guiding/sdtree.py:{line}",
                        max(r["max_abs_err"] for k, r in train_rows.items()
                            if k[0] == name))
                 for name, line in (("sd_dir_targets", 433),
                                    ("sd_stree_box", 908),
                                    ("sd_adam", 1067))},
              **{name: (src, replaces,
                        max(r["max_abs_err"] for k, r in
                            {**acc_rows, **k7s_rows_}.items()
                            if k[0] == name))
                 for name, src, replaces in (
                     ("reduce_add", "reduce.cu", "ppg_tpu/ops/reduce.py:58"),
                     ("film_splat", "film.cu",
                      "ppg_tpu/render/film.py:122"),
                     ("film_splat_filter", "film.cu",
                      "ppg_tpu/render/film.py:77"))},
              "vndf": ("microfacet.cu", "ppg_tpu/bsdf/microfacet.py:164",
                       k8_rows_[("vndf", f"L={CHUNK}, the render's last "
                                         f"call")]["max_abs_err"]),
              "atlas": ("textures.cu", "ppg_tpu/scene/textures.py:309",
                        max(r["max_abs_err"] for r in k9_rows_.values()))}
    kernels = []
    for name, (table, key) in main.items():
        row = table[key]
        src, replaces, err = source[name if name in source
                                    else name.split("_")[0]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ppg_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": row["ms"], "kernel_only_ms": row["kernel_only_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound": row["bound"],
            "library_ms": row.get("library_ms"),
            "shapes": [dict(r) for k, r in table.items() if k[0] == name]})
    print(f"chip_smoke: {time.time() - t_start:.1f} s, the kernels' builds "
          f"included [{tag}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

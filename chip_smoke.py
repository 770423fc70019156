"""Smoke run of ppg_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the triangle-sweep kernels (closest hit and any hit) from
ppg_tpu_torch/csrc/brute.cu and the host libraries from
ppg_tpu_torch/csrc/host, holds the kernels against their plain PyTorch
version (the kernels are bit-identical to it by design, so any lane that
picks another triangle or differs in a bit fails the run), times them
(through the wrapper, alone in a CUDA graph, and the plain version)
beside their bound, and renders the built-in Cornell box with
GuidedPathTracer on the card, each render checked against an unguided
one:
- phase 3/4: 512x512, 127 spp budget, maxDepth 10, nee never,
  nearest/nearest filters;
- phase 5: the improved configuration (cbox-improved: inversevar,
  kl-trained bsdf sampling fraction, stochastic spatial and box
  directional filters, sTreeThreshold 4000, sppPerPass 1) at the same
  size;
- phase 6: next-event estimation with shadow rays through the kernel's
  any-hit (nee always, box/box filters, variance-trained fraction) at
  256x256, 32 spp.
Every phase prints its own lines; any failure raises and the script exits
non-zero. The line before the last is a JSON object describing the
kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import time

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


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def soup(T, L, seed, shadow=False, edges=False):
    """Random triangles and rays (numpy seed), every 17th lane parked; with
    `shadow`, finite segment ends and a third of the lanes parked, as the
    tracer's shadow rays; with `edges`, half of the rays pass through a
    point on an edge of a random triangle, where evaluations that round
    differently disagree about the side."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, (T, 3, 3)).astype(np.float32)
    tri = np.zeros((T, 12), np.float32)
    tri[:, 0:3] = v[:, 0]
    tri[:, 3:6] = v[:, 1] - v[:, 0]
    tri[:, 6:9] = v[:, 2] - v[:, 0]
    o = rng.uniform(-2.0, 2.0, (L, 3)).astype(np.float32)
    d = rng.normal(size=(L, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if edges:
        h = L // 2
        k, s = rng.integers(0, T, h), rng.random(h)
        side = rng.integers(0, 3, h)
        a = np.where(side == 0, s, np.where(side == 1, 0.0, s))
        b = np.where(side == 0, 0.0, np.where(side == 1, s, 1.0 - s))
        at = tri[k, 0:3] + a[:, None] * tri[k, 3:6] + b[:, None] * tri[k, 6:9]
        o[:h] = at - d[:h] * rng.uniform(0.5, 2.0, (h, 1))
    t_max = np.where(np.arange(L) % 17 == 0, -1.0, 3.4e38).astype(np.float32)
    if shadow:
        t_max = np.where(rng.random(L) < 0.33, -1.0,
                         rng.random(L) * 3.0).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in
            (tri, o, d, np.zeros(L, np.float32), t_max)]


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


def guided_run(phase, tracer, B, tag, seed=0):
    """Render through the tracer with the launch counts zeroed just before
    and read just after; checks the image, the counts and that no JAX
    module was loaded. Returns (image, counts, wall seconds)."""
    B.reset_counts()
    t0 = time.time()
    img = tracer.render(seed=seed)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(B.COUNTS)
    W, H = tracer.film.W, tracer.film.H
    if img.shape != (H, W, 3) or not np.isfinite(img).all() \
            or not img.mean() > 0:
        raise AssertionError(f"phase {phase}: bad image {img.shape} mean "
                             f"{img.mean()}")
    if counts["brute_kernel"] <= 0 or counts["plain_on_cuda"] != 0:
        raise AssertionError(f"phase {phase}: main path did not run on the "
                             f"kernel: {counts}")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ppg_tpu_torch.accel import brute as B
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.scene import mini_cbox

    # phase 0: versions and the card
    tag = card()
    print(tag)  # as nvidia-smi prints it: name, power limit
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"card {tag}")

    # phase 1: build the kernels; the port's own host libraries must build
    # and load
    t0 = time.time()
    B.build()
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
    print(f"phase 1: built csrc/brute.cu in {build_s:.2f} s; the host BVH "
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
    img, counts, wall = guided_run(3, tracer, B, tag)
    sched = [(s["passes"], s["is_final"]) for s in tracer.stats]
    if sched != [(1, False), (2, False), (4, False), (8, False), (17, True)]:
        raise AssertionError(f"unexpected iteration schedule {sched}")
    rays = sum(s["n_rays"] for s in tracer.stats)
    pass_s = sum(s["seconds"] for s in tracer.stats)
    print(f"phase 3: guided {RES}x{RES} {BUDGET} spp maxDepth {MAX_DEPTH}: "
          f"{wall:.2f} s wall, {pass_s:.2f} s in passes, {rays} rays, "
          f"{rays / pass_s / 1e6:.1f} Mrays/s, {counts['brute_kernel']} "
          f"kernel launches, 0 plain sweeps on the card, no jax [{tag}]")

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
    img5, counts5, wall5 = guided_run(5, tracer5, B, tag)
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
          f"{counts5['brute_kernel']} kernel launches, 0 plain sweeps on the "
          f"card, {n_trained} of {opt_var.numel()} leaves with a trained "
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
    img6, counts6, wall6 = guided_run(6, tracer6, B, tag)
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
          f"any-hit kernel launches, 0 plain sweeps on the card, no jax "
          f"[{tag}]")
    spp6 = tracer6.stats[-1]["spp"]
    t0 = time.time()
    ref6 = driver.render(sc6, spp=spp6, seed=3, chunk=NEE_RES * NEE_RES,
                         device="cuda")
    print(f"phase 6: unguided nee {spp6} spp in {time.time() - t0:.2f} s "
          f"[{tag}]; " + gate(img6, ref6, "phase 6: nee guided vs unguided"))

    # launches: every launch of each kernel over the three main-path
    # renders (phases 3, 5 and 6); the numbers are those of the kernel's
    # main-path shape (T = 12 triangles, the render's wavefront)
    launches = {
        "brute_closest": sum(c["brute_kernel"]
                             for c in (counts, counts5, counts6)),
        "brute_any_hit": sum(c["any_hit"] for c in (counts, counts5, counts6))}
    main = {"brute_closest": ("brute_closest", 12, CHUNK),
            "brute_any_hit": ("brute_any_hit", 12, NEE_RES * NEE_RES)}
    kernels = []
    for name, key in main.items():
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ppg_tpu_torch/csrc/brute.cu",
            "replaces": "ppg_tpu/accel/pallas_brute.py:102",
            "launches": launches[name], "max_abs_err": max_err,
            "ms": row["ms"], "kernel_only_ms": row["kernel_only_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound": row["bound"],
            "library_ms": None,
            "shapes": [dict(r) for k, r in rows.items() if k[0] == name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

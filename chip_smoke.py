"""Smoke run of ppg_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the triangle-sweep kernel from ppg_tpu_torch/csrc/brute.cu, holds
it bit for bit against its plain PyTorch version, and renders the
built-in Cornell box with GuidedPathTracer on the card, each render
checked against an unguided one:
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
kernel; the last line is
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


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def soup(T, L, seed):
    """Random triangles and rays (numpy seed), every 17th lane parked."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, (T, 3, 3)).astype(np.float32)
    tri = np.zeros((T, 12), np.float32)
    tri[:, 0:3] = v[:, 0]
    tri[:, 3:6] = v[:, 1] - v[:, 0]
    tri[:, 6:9] = v[:, 2] - v[:, 0]
    o = rng.uniform(-2.0, 2.0, (L, 3)).astype(np.float32)
    d = rng.normal(size=(L, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(np.arange(L) % 17 == 0, -1.0, 3.4e38).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in
            (tri, o, d, np.zeros(L, np.float32), t_max)]


def cuda_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
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

    # phase 1: build the kernel; the shared host libraries must load
    t0 = time.time()
    B.build()
    build_s = time.time() - t0
    # The host C++ libraries may die with SIGILL on a foreign CPU, which no
    # try can catch, so they are first driven in a subprocess.
    r = subprocess.run(
        [sys.executable, "-c",
         "from ppg_tpu_torch.accel.traverse import "
         "native_builder_loaded, pack_triangles; "
         "from ppg_tpu_torch.guiding.host import HostSDTree; "
         "from ppg_tpu_torch.scene import mini_cbox; "
         "sc = mini_cbox(res=16, budget=4, max_depth=2, nee='never'); "
         "assert native_builder_loaded(); "
         "tri, perm = pack_triangles(sc.positions, sc.faces); "
         "assert sorted(perm) == list(range(len(sc.faces))); "
         "HostSDTree(sc.aabb_min, sc.aabb_max).build(); print('loaded')"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0 or "loaded" not in r.stdout:
        raise RuntimeError(f"host native libraries failed to load "
                           f"(rc {r.returncode}): {r.stderr[-2000:]}")
    print(f"phase 1: built csrc/brute.cu in {build_s:.2f} s; the host BVH "
          "builder and SD-tree build run natively in a subprocess")

    # phase 2: kernel against its plain version, bit for bit; the ragged
    # lengths end in a partial block of the launch grid
    max_err = 0.0
    for T, L in ((12, 1 << 20), (130, 1 << 20), (1024, 1 << 20),
                 (12, (1 << 20) - 37), (1024, 1000)):
        args = soup(T, L, seed=T + L)
        got = B.brute_closest(*args)
        want = B.brute_sweep_plain(*args)
        torch.cuda.synchronize()
        hit = want[0] >= 0
        bad_i = int((got[0] != want[0]).sum())
        bad_bits = [int((a[hit].view(torch.int32)
                         != b[hit].view(torch.int32)).sum())
                    for a, b in zip(got[1:], want[1:])]
        if bad_i or any(bad_bits) or not torch.equal(got[1][~hit],
                                                     want[1][~hit]):
            raise AssertionError(f"kernel != plain at T={T} L={L}: {bad_i} "
                                 f"best_i, {bad_bits} t/u/v bit mismatches")
        for a, b in zip(got[1:], want[1:]):
            max_err = max(max_err, float((a[hit] - b[hit]).abs().max()))
        part = L % 256  # lanes in the last, partial block of 256
        print(f"phase 2: T={T} L={L}: best_i identical, t/u/v bitwise "
              f"equal on {int(hit.sum())} hits"
              + (f", {int(hit[L - part:].sum())} of them in the partial "
                 f"block of {part} lanes" if part else ""))
    # any-hit (shadow rays) through the kernel: finite segment ends, a
    # third of the lanes parked with t_max = -1 as the tracer parks them
    from ppg_tpu_torch.accel.traverse import GeometryArrays, any_hit
    for T in (12, 1024):
        tri, o, d, t_min, _ = soup(T, CHUNK, seed=T)
        gen = torch.Generator(device="cuda").manual_seed(T)
        t_max = torch.rand(CHUNK, device="cuda", generator=gen) * 3.0
        t_max = torch.where(torch.rand(CHUNK, device="cuda", generator=gen)
                            < 0.33, -1.0, t_max)
        geom = GeometryArrays(tri, torch.arange(T, dtype=torch.int32,
                                                device="cuda"))
        occ = any_hit(geom, o, d, t_min, t_max)
        want = B.brute_sweep_plain(tri, o, d, t_min, t_max)[0] >= 0
        if not torch.equal(occ, want) or bool(occ[t_max < 0].any()):
            raise AssertionError(f"any-hit != plain at T={T}: "
                                 f"{int((occ != want).sum())} lanes differ")
        print(f"phase 2: any-hit T={T} L={CHUNK}: identical occlusion on "
              f"{int(occ.sum())} occluded lanes, parked lanes never occluded")
    times = {}
    for T, L in ((12, 65536), (12, CHUNK), (1024, CHUNK)):
        args = soup(T, L, seed=7)
        times[(T, L)] = (cuda_ms(lambda: B.brute_closest(*args), 50),
                         cuda_ms(lambda: B.brute_sweep_plain(*args),
                                 20 if T < 64 else 3))
        print(f"phase 2: T={T} L={L}: kernel {times[(T, L)][0]:.4f} ms, "
              f"plain {times[(T, L)][1]:.4f} ms [{tag}]")

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

    kernel_ms, plain_ms = times[(12, CHUNK)]
    # launches: every K1 launch of the three main-path renders (phases 3,
    # 5 and 6), closest-hit and any-hit
    launches = sum(c["brute_kernel"] + c["any_hit"]
                   for c in (counts, counts5, counts6))
    print(json.dumps({"kernels": [{
        "name": "brute_closest", "route": "cuda",
        "source": "ppg_tpu_torch/csrc/brute.cu",
        "replaces": "ppg_tpu/accel/pallas_brute.py:102",
        "serves": "closest-hit and any-hit",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

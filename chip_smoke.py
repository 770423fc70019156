"""Smoke run of ppg_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the triangle-sweep kernel from ppg_tpu_torch/csrc/brute.cu, holds
it bit for bit against its plain PyTorch version, renders the built-in
Cornell box at 512x512 with GuidedPathTracer (127 spp budget, maxDepth
10, nee never) on the card, and checks the image against an unguided
render at the same spp. Every phase prints one line; any failure raises
and the script exits non-zero. The line before the last is a JSON object
describing the kernel; the last line is
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
    B.reset_counts()
    t0 = time.time()
    img = tracer.render(seed=0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(B.COUNTS)
    sched = [(s["passes"], s["is_final"]) for s in tracer.stats]
    if sched != [(1, False), (2, False), (4, False), (8, False), (17, True)]:
        raise AssertionError(f"unexpected iteration schedule {sched}")
    if img.shape != (RES, RES, 3) or not np.isfinite(img).all() \
            or not img.mean() > 0:
        raise AssertionError(f"bad image {img.shape} mean {img.mean()}")
    if counts["brute_kernel"] <= 0 or counts["plain_on_cuda"] != 0:
        raise AssertionError(f"main path did not run on the kernel: {counts}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    rays = sum(s["n_rays"] for s in tracer.stats)
    pass_s = sum(s["seconds"] for s in tracer.stats)
    for i, s in enumerate(tracer.stats):
        print(f"phase 3: iteration {i}: {s['passes']} passes, "
              f"{s['seconds']:.3f} s, {s['n_rays']} rays, "
              f"{s['n_rays'] / s['seconds'] / 1e6:.1f} Mrays/s, "
              f"avgPathLength {s['avg_path_length']:.3f} [{tag}]")
    print(f"phase 3: guided {RES}x{RES} {BUDGET} spp maxDepth {MAX_DEPTH}: "
          f"{wall:.2f} s wall, {pass_s:.2f} s in passes, {rays} rays, "
          f"{rays / pass_s / 1e6:.1f} Mrays/s, {counts['brute_kernel']} "
          f"kernel launches, 0 plain sweeps on the card, no jax [{tag}]")

    # phase 4: unguided at the final image's spp; both are unbiased
    spp = tracer.stats[-1]["spp"]
    t0 = time.time()
    ref = driver.render(sc, spp=spp, seed=1, chunk=CHUNK, device="cuda")
    ref_s = time.time() - t0
    mg, mu = float(img.mean()), float(ref.mean())
    bg, bu = blocks(img), blocks(ref)
    mask = bu > 0.1 * bu.mean()
    med = float(np.median(np.abs(bg - bu)[mask] / bu[mask]))
    if not (abs(mg - mu) / mu < 0.05 and med < 0.25):
        raise AssertionError(f"guided vs unguided: means {mg} {mu}, "
                             f"block median {med}")
    print(f"phase 4: unguided {spp} spp in {ref_s:.2f} s [{tag}]; means "
          f"guided {mg:.5f} unguided {mu:.5f} "
          f"({abs(mg - mu) / mu:.4f} < 0.05), block median {med:.4f} < 0.25")

    kernel_ms, plain_ms = times[(12, CHUNK)]
    print(json.dumps({"kernels": [{
        "name": "brute_closest", "route": "cuda",
        "source": "ppg_tpu_torch/csrc/brute.cu",
        "replaces": "ppg_tpu/accel/pallas_brute.py:102",
        "launches": counts["brute_kernel"], "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

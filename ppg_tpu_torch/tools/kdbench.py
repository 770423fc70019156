"""Ray-accel benchmark and verification (counterpart of
ppg_tpu/tools/kdbench.py, after Mitsuba's kdbench utility).

Loads a scene XML, builds the wide BVH, times camera and incoherent
wavefronts through the BVH walk (the CUDA kernel on a card, the plain walk
on the CPU), and checks a sample of the incoherent rays against the
triangle sweep (the sweep kernel on a card): hit distances must agree
within rtol 1e-4, atol 1e-5, so 0 mismatches are expected.

Usage:
    python -m ppg_tpu_torch.tools.kdbench scene.xml [--device cuda|cpu]
        [--lanes 65536] [--verify 4096] [--reps 3]

Emits one JSON line with the build, walk and verification results and
the device they ran on.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..accel.brute import brute_closest
from ..accel.traverse import build_geometry, closest_hit
from ..device import generator, resolve, synchronize
from ..render.sensor import make_sensor
from ..scene.scene import load_scene


def bench(scene_path, lanes=1 << 16, verify=4096, reps=3, seed=0,
          device="cuda"):
    dev = resolve(device)
    t0 = time.time()
    sc = load_scene(scene_path)
    t_load = time.time() - t0
    t0 = time.time()
    geom = build_geometry(sc.positions, sc.faces, dev)
    synchronize(dev)
    t_build = time.time() - t0
    out = dict(
        scene=scene_path,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        tris=int(geom.num_tris),
        rows=int(geom.rows.shape[0]),
        row_floats=int(geom.rows.shape[1]),
        wide=geom.wide,
        stack_depth=geom.stack_depth,
        load_s=round(t_load, 2),
        build_s=round(t_build, 2),
        lanes=lanes,
    )

    gen = generator(seed, dev)
    sensor = make_sensor(sc.sensor, sc.film, dev)
    W, H = sc.film["width"], sc.film["height"]
    pos = torch.rand((lanes, 2), generator=gen, device=dev) * torch.tensor(
        [W, H], dtype=torch.float32, device=dev)
    camera = sensor.sample_rays(pos)

    # incoherent batch: origins uniform in the scene's AABB, uniform
    # sphere directions (kdbench's random-ray mode)
    lo = torch.tensor(sc.aabb_min, dtype=torch.float32, device=dev)
    hi = torch.tensor(sc.aabb_max, dtype=torch.float32, device=dev)
    o_i = lo + torch.rand((lanes, 3), generator=gen, device=dev) * (hi - lo)
    g = torch.randn((lanes, 3), generator=gen, device=dev)
    d_i = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    incoherent = (o_i, d_i, torch.full((lanes,), 1e-4, device=dev),
                  torch.full((lanes,), 3.4e38, device=dev))

    shoot = lambda o, d, a, b: closest_hit(geom, o, d, a, b, force_bvh=True)
    for tag, rays in (("camera", camera), ("incoherent", incoherent)):
        r = shoot(*rays)  # build and warm up
        synchronize(dev)
        t0 = time.time()
        for _ in range(reps):
            r = shoot(*rays)
        synchronize(dev)
        dt = (time.time() - t0) / reps
        out[f"{tag}_ms"] = round(dt * 1e3, 2)
        out[f"{tag}_mrays_s"] = round(lanes / dt / 1e6, 3)
        out[f"{tag}_hit_rate"] = round(float((r[0] >= 0).float().mean()), 4)

    if verify:
        n = min(verify, lanes)
        sample = [x[:n] for x in incoherent]
        bi, bt, _, _ = shoot(*sample)
        ri, rt, _, _ = brute_closest(geom.tri, *sample)
        bi, bt, ri, rt = (x.cpu().numpy() for x in (bi, bt, ri, rt))
        # triangles at equal t may legitimately differ: compare the hit
        # distances (the kdbench criterion)
        out["verified_rays"] = n
        out["mismatches"] = int(np.sum(~np.isclose(
            np.where(bi >= 0, bt, -1.0), np.where(ri >= 0, rt, -1.0),
            rtol=1e-4, atol=1e-5)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--verify", type=int, default=4096,
                    help="check this many incoherent rays against the "
                         "triangle sweep (0 = skip)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    out = bench(args.scene, args.lanes, args.verify, args.reps,
                device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Command-line renderer.

Usage:
  python -m ppg_tpu_torch.cli scene.xml -o out.exr [--spp N] [--seed N]
      [--chunk N] [--integrator TYPE] [--dump-sdtree]
      [--device cuda|cpu]

The integrator is --integrator's or the scene's. guided_path renders the
scene's spp or seconds budget (--spp overrides it) and, with
--dump-sdtree, writes each iteration's SD-tree beside the output as
<out>-<iteration>.sdt; path (also volpath and volpath_simple, which the
port renders without media) and direct (maxDepth 2) render --spp or the
sampler's sampleCount samples per pixel with the scene's sampler. The
image is written as EXR.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ppg_tpu_torch", description="guided path tracer (PyTorch)")
    ap.add_argument("scene", help="Mitsuba scene XML file")
    ap.add_argument("-o", dest="output", required=True, help="output EXR")
    ap.add_argument("--spp", type=int, default=None,
                    help="sample budget (default: the scene's budget)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1 << 16,
                    help="wavefront lanes per launch")
    ap.add_argument("--integrator", default=None,
                    help="integrator type (guided_path, path, direct; "
                    "default: the scene's)")
    ap.add_argument("--dump-sdtree", action="store_true",
                    help="write each iteration's SD-tree as .sdt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .io import exr
    from .scene import load_scene

    sc = load_scene(args.scene)
    itype = args.integrator or sc.integrator.get("type", "path")
    if itype == "guided_path":
        from .integrators.guided import GuidedPathTracer

        overrides = {"dumpSDTree": True} if args.dump_sdtree else None
        tracer = GuidedPathTracer(sc, chunk=args.chunk, overrides=overrides,
                                  device=args.device)
        tracer.dump_path = os.path.splitext(args.output)[0]
        img = tracer.render(seed=args.seed, spp_budget=args.spp)
    elif itype in ("path", "volpath", "volpath_simple", "direct"):
        from .integrators.driver import make_config, render

        spp = args.spp or int(sc.sampler.get("sampleCount", 16))
        cfg = make_config(sc, guiding=False,
                          **({"max_depth": 2} if itype == "direct" else {}))
        img = render(sc, spp=spp, seed=args.seed, chunk=args.chunk, cfg=cfg,
                     device=args.device)
    else:
        raise SystemExit(f"unsupported integrator {itype!r}")
    exr.write(args.output, img)
    return img


if __name__ == "__main__":
    main()

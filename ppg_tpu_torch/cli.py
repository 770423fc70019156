"""Command-line renderer for the guided path tracer.

Usage:
  python -m ppg_tpu_torch.cli scene.xml -o out.exr [--spp N] [--seed N]
      [--chunk N] [--device cuda|cpu]

The scene's integrator must be guided_path with what the port covers
(see integrators/wavefront.py); the image is written as EXR.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ppg_tpu_torch", description="guided path tracer (PyTorch)")
    ap.add_argument("scene", help="Mitsuba scene XML file")
    ap.add_argument("-o", dest="output", required=True, help="output EXR")
    ap.add_argument("--spp", type=int, default=None,
                    help="sample budget (default: the scene's spp budget)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1 << 16,
                    help="wavefront lanes per launch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .integrators.guided import GuidedPathTracer
    from .io import exr
    from .scene import load_scene

    sc = load_scene(args.scene)
    tracer = GuidedPathTracer(sc, chunk=args.chunk, device=args.device)
    img = tracer.render(seed=args.seed, spp_budget=args.spp)
    exr.write(args.output, img)
    return img


if __name__ == "__main__":
    main()

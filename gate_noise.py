"""How far chip_smoke.py phase 16's smaller renders fall apart from noise
alone, on one CUDA card:

    python3 gate_noise.py

For each of the smaller textured scenes (vertex colours, wireframe,
curvature, the orthographic EWA floor) at phase 16's 128^2, 16 spp, nee
always and cbox-improved's settings, with mini_cbox's luminaire facing
the ceiling (the box lit only through its bounces) and facing the floor
(testscenes.light_down, as phase 16 renders them), it renders guided
from seeds 0, 4 and 5, unguided from seeds 1-3 and an unguided reference at
256 spp, and prints one JSON line a scene and lighting: the relative
difference of the means and the median relative difference of the 8x8
block means (chip_smoke.gate's two measures, not asserted) of each
guided image and of unguided seeds 2 and 3 against unguided seed 1 (the
gate's pairing), and of each 16-spp image against the reference.
"""

import json
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as S

GUIDED_SEEDS, UNGUIDED_SEEDS, REF_SPP = (0, 4, 5), (1, 2, 3), 256


def spread(img, ref):
    """chip_smoke.gate's measures of img against ref: (relative
    difference of the means, median relative block difference)."""
    mg, mu = float(img.mean()), float(ref.mean())
    bg, bu = S.blocks(img), S.blocks(ref)
    mask = bu > 0.1 * bu.mean()
    return (round(abs(mg - mu) / mu, 5),
            round(float(np.median(np.abs(bg - bu)[mask] / bu[mask])), 4))


def ceiling(xml):
    """The scene with mini_cbox's luminaire facing the ceiling again (the
    inverse of testscenes.light_down)."""
    new = '<scale value="0.25"/><rotate x="1" angle="90"/>'
    assert xml.count(new) == 1
    return xml.replace(new, '<scale value="0.25"/><rotate x="1" '
                            'angle="-90"/>')


def main():
    if not torch.cuda.is_available():
        print("gate_noise: no CUDA device", file=sys.stderr)
        return 1
    from ppg_tpu_torch.integrators import driver
    from ppg_tpu_torch.integrators.guided import GuidedPathTracer
    from ppg_tpu_torch.scene.testscenes import (
        light_down, mini_cbox_texture_variant_xml, mini_cbox_textures_xml,
        orthographic, scene_from_xml)

    tag = S.card()
    res, spp = S.TEXTURES_SMALL_RES, S.TEXTURES_SMALL_SPP
    with tempfile.TemporaryDirectory() as tmp:
        floor = {v: mini_cbox_texture_variant_xml(
            v, tmp, res=res, budget=spp, max_depth=S.MAX_DEPTH, nee="always")
            for v in ("vertexcolors", "wireframe", "curvature")}
        floor["orthographic EWA floor"] = orthographic(light_down(
            mini_cbox_textures_xml(
                tmp, res=res, budget=spp, max_depth=S.MAX_DEPTH,
                nee="always", floor_res=S.TEX_FLOOR_RES,
                bump_res=S.TEX_BUMP_RES, seed=16, sphere=False)))
        for name, xml in floor.items():
            for light, x in (("ceiling", ceiling(xml)), ("floor", xml)):
                t0 = time.time()
                s = scene_from_xml(x)
                g = [GuidedPathTracer(s, chunk=res ** 2,
                                      overrides=S.IMPROVED,
                                      device="cuda").render(seed=k)
                     for k in GUIDED_SEEDS]
                u = [driver.render(s, spp=spp, seed=k, chunk=res ** 2,
                                   device="cuda") for k in UNGUIDED_SEEDS]
                ref = driver.render(s, spp=REF_SPP, seed=9, chunk=res ** 2,
                                    device="cuda")
                print(json.dumps({
                    "scene": name, "light": light, "res": res, "spp": spp,
                    "guided_vs_unguided_1": [spread(i, u[0]) for i in g],
                    "unguided_vs_unguided_1": [spread(i, u[0])
                                               for i in u[1:]],
                    "guided_vs_ref": [spread(i, ref) for i in g],
                    "unguided_vs_ref": [spread(i, ref) for i in u],
                    "seconds": round(time.time() - t0, 2), "card": tag}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

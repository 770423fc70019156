"""Counts the card's launches and busy share in one training wavefront of
a guided render, for several checkouts on one CUDA card, so that two
commits are compared in one run:

    git archive <commit> ppg_tpu_torch | tar -x -C build/parent
    python3 launch_profile.py build/parent . . build/parent

For each checkout root given, in turn and in a fresh interpreter, it
renders the 512x512 Cornell box (chip_smoke.py's phase 3: "cbox"), the
same at cbox-improved's settings (phase 5: "improved"), the NEE path
at 256x256 (phase 6: "nee"), cbox-improved with a thin lens and the
gaussian filter (phase 13: "front"), the box in glossy, plastic and
glass materials at cbox-improved's settings (phase 14: "materials") and
the box in the material wrappers with nee always at those settings
(phase 15: "wrappers"), the textured box with nee always at those
settings (phase 16: "textures", its bitmaps written into a temporary
directory) and the sky box with nee always at those settings (phase 17:
"sky", a 4096 x 2048 sunsky, a spot and a point light) and the smoke
box with nee always at those settings (phase 18: "media", a 256^3 grid
of smoke and a Rayleigh medium, its grid written into a temporary
directory) and the translucent box with nee always at those settings
(phase 19: "translucent", a dipole sphere of marble and a
single-scattering cube; a tree that refuses a configuration prints a
"skipped" line)
with that tree's GuidedPathTracer, and stops
each render at its fourth training wavefront of a built tree (one
_chunk_step of the whole frame). The second is traced with
torch.profiler (CUDA activity only); the first, third and fourth are
timed unprofiled, with the card synchronised around them. One JSON line
per tree and configuration: the kernels and the memory copies and fills the
card ran in the traced wavefront, its busy time (the union of their
intervals), the unprofiled walls and the busy share (busy time over the
lesser unprofiled wall; the trace itself slows the host), the eight
kernels that took the most device time, and, under "named", the launches
and device ms of K3 and K4 (csrc/sdtree.cu's lookup_kernel and
walk_kernel), of K5a, K5b and K6 (csrc/train.cu's dir_kernel, box_kernel
and adam_kernel), of K5's kernels
(csrc/reduce.cu: three a call, of the shared or the global path), of K7
and K7s (csrc/film.cu), of the ray casts (K1, csrc/brute.cu, or K2,
csrc/bvh.cu: the scene's), of K8 (csrc/microfacet.cu), of K9
(csrc/textures.cu), of K10 (csrc/envmap.cu), of K11 (csrc/media.cu),
of K12 (csrc/subsurface.cu) and of ATen's index_add_
kernels (indexFuncSmallIndex,
indexFuncLargeIndex), which a tree without K5 runs for its sums; under
"walk", the shadow walk's calls, crossings and host reads in the traced
wavefront (integrators/wavefront.py's WALK_COUNTS, where the tree has
them). Give the trees in turns to see the spread.

    python3 launch_profile.py --digest build/parent . . build/parent

renders, for each tree in a fresh interpreter, the whole of the first
four configurations from seed 0 (chip_smoke.py's phases 3, 5, 6 and 13's
thin lens with the gaussian filter), the materials box (phase 14's scene and settings at 128^2, 8 spp), the
wrapper box, the textured box, the sky box, the smoke box and the
translucent box (phases 15's, 16's, 17's, 18's and 19's, the same way;
"skipped" in a tree that refuses one) and prints a digest of each image's bits: equal digests,
equal images.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

_CHILD = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1]]
DIGEST = sys.argv[2:] == ["--digest"]
import torch
from torch.profiler import ProfilerActivity, profile
from ppg_tpu_torch.integrators import guided, wavefront
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene import mini_cbox

IMPROVED = dict(sampleCombination="inversevar", bsdfSamplingFractionLoss="kl",
                spatialFilter="stochastic", directionalFilter="box",
                sTreeThreshold=4000, sppPerPass=1)
NEE = dict(spatialFilter="box", directionalFilter="box",
           bsdfSamplingFractionLoss="var")
CONFIGS = {"cbox": (512, "never", {}), "improved": (512, "never", IMPROVED),
           "nee": (256, "always", NEE), "front": (512, "never", IMPROVED),
           "materials": (512, "never", IMPROVED),
           "wrappers": (512, "always", IMPROVED),
           "textures": (512, "always", IMPROVED),
           "sky": (512, "always", IMPROVED),
           "media": (512, "always", IMPROVED),
           "translucent": (512, "always", IMPROVED)}
NAMED = {"K3": ("LookupArgs",), "K4": ("WalkArgs",),
         "K5a": ("DirArgs",), "K5b": ("BoxArgs",), "K6": ("AdamArgs",),
         "K5": ("reduce_count", "reduce_quantise", "reduce_finish"),
         "K7": ("film_splat_kernel",), "K7s": ("splat_filter_kernel",),
         "K1/K2": ("Rays",), "K8": ("vndf_kernel",),
         "K9": ("atlas_kernel",), "K10": ("env_kernel",),
         "K11": ("media_kernel",), "K12": ("dipole_kernel",),
         "index_add": ("indexFuncSmallIndex", "indexFuncLargeIndex")}


TMP = []


class Done(Exception):
    pass


def busy_ns(events):
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events)
    total, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def front_end(res):
    # chip_smoke.py's phase 13 scene: a thin lens (aperture 0.05, focused
    # 4.5 away on the back wall) and the gaussian filter
    from ppg_tpu_torch.scene.testscenes import MINI_CBOX, scene_from_xml

    xml = MINI_CBOX.format(res=res, budget=127, max_depth=10, nee="never")
    xml = xml.replace('<sensor type="perspective">',
                      '<sensor type="thinlens"><float name="apertureRadius" '
                      'value="0.05"/><float name="focusDistance" '
                      'value="4.5"/>')
    return scene_from_xml(xml.replace('<rfilter type="box"/>',
                                      '<rfilter type="gaussian"/>'))


def scene(name, res, nee):
    if name == "front":
        return front_end(res)
    if name == "materials":
        # chip_smoke.py's phase 14 scene
        from ppg_tpu_torch.scene.testscenes import mini_cbox_materials

        return mini_cbox_materials(res=res, budget=127, max_depth=10,
                                   nee=nee)
    if name == "wrappers":
        # chip_smoke.py's phase 15 scene
        from ppg_tpu_torch.scene.testscenes import mini_cbox_wrappers

        return mini_cbox_wrappers(res=res, budget=127, max_depth=10,
                                  nee=nee)
    if name == "textures":
        # chip_smoke.py's phase 16 scene (TEX_FLOOR_RES, TEX_BUMP_RES)
        import tempfile

        from ppg_tpu_torch.scene.testscenes import (mini_cbox_textures_xml,
                                                    scene_from_xml)

        # removed when the interpreter exits
        TMP.append(tempfile.TemporaryDirectory(prefix="launch_profile-"))
        return scene_from_xml(mini_cbox_textures_xml(
            TMP[-1].name, res=res, budget=127, max_depth=10, nee=nee,
            floor_res=2048, bump_res=512, seed=16))
    if name == "sky":
        # chip_smoke.py's phase 17 scene (SKY_RESOLUTION)
        from ppg_tpu_torch.scene.testscenes import (mini_cbox_sky_xml,
                                                    scene_from_xml)

        return scene_from_xml(mini_cbox_sky_xml(
            res=res, budget=127 if res == 512 else 8, max_depth=10, nee=nee,
            resolution=4096))
    if name == "media":
        # chip_smoke.py's phase 18 scene (SMOKE_GRID_RES)
        import tempfile

        from ppg_tpu_torch.scene.testscenes import (mini_cbox_smoke_xml,
                                                    scene_from_xml)

        TMP.append(tempfile.TemporaryDirectory(prefix="launch_profile-"))
        return scene_from_xml(mini_cbox_smoke_xml(
            TMP[-1].name, res=res, budget=127 if res == 512 else 8,
            max_depth=10, nee=nee, grid_res=256, seed=0))
    if name == "translucent":
        # chip_smoke.py's phase 19 scene
        from ppg_tpu_torch.scene.testscenes import (
            mini_cbox_translucent_xml, scene_from_xml)

        return scene_from_xml(mini_cbox_translucent_xml(
            res=res, budget=127 if res == 512 else 8, max_depth=10,
            nee=nee))
    return mini_cbox(res=res, budget=127 if res == 512 else 32,
                     max_depth=10, nee=nee)


if DIGEST:
    import hashlib

    for name in ("cbox", "improved", "nee", "front", "materials",
                 "wrappers", "textures", "sky", "media", "translucent"):
        res, nee, over = CONFIGS[name]
        try:
            if name == "textures":
                # phase 16's scene and settings at 128^2, 8 spp
                import tempfile

                from ppg_tpu_torch.scene.testscenes import (
                    mini_cbox_textures_xml, scene_from_xml)

                TMP.append(tempfile.TemporaryDirectory(
                    prefix="launch_profile-"))
                res, sc = 128, scene_from_xml(mini_cbox_textures_xml(
                    TMP[-1].name, res=128, budget=8, max_depth=10, nee=nee,
                    floor_res=2048, bump_res=512, seed=16))
            elif name in ("sky", "media", "translucent"):
                # phase 17's, 18's and 19's scenes and settings at 128^2,
                # 8 spp
                res, sc = 128, scene(name, 128, nee)
            elif name in ("materials", "wrappers"):
                # phase 14's and 15's scenes and settings at 128^2, 8 spp
                from ppg_tpu_torch.scene import testscenes

                make = getattr(testscenes, "mini_cbox_" + name)
                res, sc = 128, make(res=128, budget=8, max_depth=10,
                                    nee=nee)
            else:
                sc = scene(name, res, nee)
            tracer = GuidedPathTracer(sc, chunk=res * res, overrides=over,
                                      device="cuda")
        except (NotImplementedError, ValueError, ImportError,
                AttributeError) as e:
            print(json.dumps(dict(tree=sys.argv[1], config=name,
                                  skipped=str(e)[:200])), flush=True)
            continue
        img = tracer.render(seed=0)
        print(json.dumps(dict(tree=sys.argv[1], config=name,
                              card=torch.cuda.get_device_name(0),
                              digest=hashlib.sha1(img.tobytes()).hexdigest(),
                              mean=float(img.mean()))), flush=True)
    sys.exit(0)

for name, (res, nee, over) in CONFIGS.items():
    try:
        tracer = GuidedPathTracer(scene(name, res, nee), chunk=res * res,
                                  overrides=over, device="cuda")
    except (NotImplementedError, ValueError, ImportError,
            AttributeError) as e:
        print(json.dumps(dict(tree=sys.argv[1], config=name,
                              skipped=str(e)[:200])), flush=True)
        continue
    step, seen, out = guided._chunk_step, [0], {}

    def traced(*args):
        cfg = args[1]
        if not (cfg.is_built and cfg.record_vertices):
            return step(*args)
        seen[0] += 1
        k = seen[0]
        torch.cuda.synchronize()
        if k == 2:
            walk0 = dict(getattr(wavefront, "WALK_COUNTS", {}))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                r = step(*args)
                torch.cuda.synchronize()
            out["walk"] = {n: c - walk0[n] for n, c in
                           getattr(wavefront, "WALK_COUNTS", {}).items()}
            ev = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
            copies = [e for e in ev
                      if e.name().startswith(("Memcpy", "Memset"))]
            kern = [e for e in ev if e not in copies]
            by = {}
            for e in kern:
                n, t = by.get(e.name(), (0, 0))
                by[e.name()] = (n + 1, t + e.duration_ns())
            named = {}
            for key, names in NAMED.items():
                hit = [e for e in kern if any(n in e.name() for n in names)]
                named[key] = dict(launches=len(hit), ms=sum(
                    e.duration_ns() for e in hit) / 1e6)
            out.update(kernels=len(kern), copies=len(copies),
                       busy_ms=busy_ns(ev) / 1e6, named=named,
                       top=[(n[:90], c, t / 1e6) for n, (c, t) in
                            sorted(by.items(), key=lambda x: -x[1][1])[:8]])
            return r
        t0 = time.perf_counter()
        r = step(*args)
        torch.cuda.synchronize()
        out.setdefault("walls_ms", []).append(
            (time.perf_counter() - t0) * 1e3)
        if k == 4:
            raise Done
        return r

    guided._chunk_step = traced
    try:
        tracer.render(seed=0)
    except Done:
        pass
    finally:
        guided._chunk_step = step
    out["busy_share"] = out["busy_ms"] / min(out["walls_ms"])
    print(json.dumps(dict(tree=sys.argv[1], config=name, lanes=res * res,
                          card=torch.cuda.get_device_name(0), **out)),
          flush=True)
"""


def main(args):
    digest = args[:1] == ["--digest"]
    trees = args[1:] if digest else args
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", _CHILD,
                            os.path.abspath(tree)]
                           + (["--digest"] if digest else []), cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
        sys.stdout.write("".join(line + "\n" for line in
                                 r.stdout.splitlines()
                                 if line.startswith("{")))
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Times an intersection kernel of several checkouts on one CUDA card, so
that two commits are compared in one run:

    git archive <commit> ppg_tpu_torch | tar -x -C build/parent
    python3 k1_compare.py build/parent . . build/parent
    python3 k1_compare.py --kernel k2 build/parent . . build/parent

For each checkout root given, in turn and in a fresh interpreter, it
imports that tree's kernel wrappers and prints one JSON line per tree and
shape: the wrapper's time per call back to back (host side included) and
the card's time per call alone (100 calls in one CUDA graph: every kernel
the wrapper launches, no host side). Give the trees in turns to see the
spread.

--kernel k1 (the default): the triangle sweep's closest hit,
accel/brute.py::brute_closest, on this checkout's
ppg_tpu_torch/tools/soups.py soups.

--kernel k2: the BVH16 walk, accel/bvh_walk.py::bvh_closest and
bvh_any_hit, on chip_smoke.py phase 7's five timed shapes: camera and
incoherent rays on the 1,046,540-triangle scene (L = 2^18), the deep soup
(L = 2^20), and any-hit on shadow rays of the scene (L = 65,536) and of the
soup (L = 2^20). The scene, the rays and the timers are this checkout's
chip_smoke.py helpers. Each line also carries a digest of the results
(sums of best_i and of the bits of t, u and v; the occluded count), which
equal trees give alike.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((12, 65536), (12, 262144), (1024, 262144))

_CHILD_K1 = r"""
import importlib.util, json, os, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
from ppg_tpu_torch.accel import brute as B

# the soups of this checkout, whatever the tree under test holds
spec = importlib.util.spec_from_file_location("soups", os.path.join(
    sys.argv[2], "ppg_tpu_torch", "tools", "soups.py"))
soups = importlib.util.module_from_spec(spec)
spec.loader.exec_module(soups)
B.build()
for T, L in json.loads(sys.argv[3]):
    args = [torch.from_numpy(a).cuda() for a in soups.tri_soup(T, L, 7)]
    fn = lambda: B.brute_closest(*args)
    print(json.dumps(dict(tree=sys.argv[1], T=T, L=L,
                          wrapper_ms=S.cuda_ms(fn, 50, batches=5),
                          graph_ms=S.graph_ms(fn))), flush=True)
"""

_CHILD_K2 = r"""
import json, os, sys, tempfile
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
from ppg_tpu_torch.accel import bvh_walk as BW
from ppg_tpu_torch.accel import traverse as TT
from ppg_tpu_torch.tools.soups import deep_soup


def digest(out):
    if isinstance(out, torch.Tensor):  # any-hit: the occluded count
        return int(out.sum())
    return [int(x.view(torch.int32).sum(dtype=torch.int64)) for x in out]


BW.build()
with tempfile.TemporaryDirectory(prefix="k2_compare-") as tmp:
    ply = os.path.join(tmp, "bumpy_sphere.ply")
    S.bumpy_sphere_ply(ply, *S.SPHERE_SUBDIV)
    sc, _ = S.sphere_scene(ply, S.RES, S.BUDGET, "never")
geom = TT.build_geometry(sc.positions, sc.faces, "cuda")
soup = TT.build_geometry(*deep_soup(S.SOUP_T), "cuda")
for name, fn, g, args in (
        ("camera", BW.bvh_closest, geom,
         S.walk_rays("camera", S.WALK_L, 1, sc=sc)),
        ("incoherent", BW.bvh_closest, geom,
         S.walk_rays("incoherent", S.WALK_L, 2, sc=sc, geom=geom)),
        ("soup", BW.bvh_closest, soup, S.walk_rays("soup", S.SOUP_L, 3)),
        ("shadow", BW.bvh_any_hit, geom,
         S.walk_rays("incoherent", S.NEE_RES * S.NEE_RES, 5, sc=sc,
                     geom=geom, shadow=True)),
        ("soup shadow", BW.bvh_any_hit, soup,
         S.walk_rays("soup", S.SOUP_L, 6, shadow=True))):
    call = lambda: fn(g, *args)
    print(json.dumps(dict(tree=sys.argv[1], kernel=fn.__name__, what=name,
                          L=len(args[0]), row_stride=g.rows.stride(0),
                          wrapper_ms=S.cuda_ms(call, 20, batches=3),
                          graph_ms=S.graph_ms(call), digest=digest(call()))),
          flush=True)
"""


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=("k1", "k2"), default="k1")
    p.add_argument("trees", nargs="*")
    a = p.parse_args(argv)
    if not a.trees:
        print(__doc__, file=sys.stderr)
        return 2
    child = _CHILD_K1 if a.kernel == "k1" else _CHILD_K2
    for tree in a.trees:
        r = subprocess.run([sys.executable, "-c", child,
                            os.path.abspath(tree), ROOT, json.dumps(SHAPES)],
                           capture_output=True, text=True, timeout=600)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

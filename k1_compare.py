"""Times the triangle sweep's closest hit (K1) of several checkouts on one
CUDA card, so that two commits are compared in one run:

    git archive <commit> ppg_tpu_torch | tar -x -C build/parent
    python3 k1_compare.py build/parent . . build/parent

For each checkout root given, in turn and in a fresh interpreter, it
imports that tree's ppg_tpu_torch.accel.brute and prints one JSON line per
shape: the wrapper's time per call back to back (host side included) and
the card's time per call alone (100 calls in one CUDA graph: every kernel
the wrapper launches, no host side). The soups are this checkout's
ppg_tpu_torch/tools/soups.py, the timers chip_smoke.py's. Give the trees
in turns to see the spread.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((12, 65536), (12, 262144), (1024, 262144))

_CHILD = r"""
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


def main(trees):
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", _CHILD,
                            os.path.abspath(tree), ROOT, json.dumps(SHAPES)],
                           capture_output=True, text=True, timeout=600)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

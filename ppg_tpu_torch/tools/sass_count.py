"""Registers, spills and the global loads of each kernel of a csrc/ file,
as the card's compiler builds it (needs nvcc and cuobjdump):

    python -m ppg_tpu_torch.tools.sass_count sdtree.cu reduce.cu
    python -m ppg_tpu_torch.tools.sass_count --root build/parent sdtree.cu

For each source (under <root>/ppg_tpu_torch/csrc/, root the checkout given,
default this one), nvcc builds it with its module's NVCC_FLAGS and
-Xptxas -v into build/sass_count/, and cuobjdump -sass disassembles the
library. One JSON line per kernel: the source, the kernel's demangled
name, its registers, stack frame (local memory a thread), spill bytes
and shared memory (ptxas' report), its count of each global, local,
shared and atomic memory instruction and of each multi-function-unit
instruction in the SASS (LDG, STG, LDL, STL, LDS, STS, ATOMS, ATOMG,
RED by their widths; MUFU by function), and under "loops" its innermost
loops that hold a MUFU instruction (a backward branch's range of
addresses): their instructions, MUFU instructions and branches, and the
same on the fast path (the loop less what each conditional forward
branch in it jumps over: the compiler puts each guarded slow path on a
branch's fall-through, as nvcc's IEEE operations and K12's guard do).
With --dump DIR the SASS itself goes to DIR/<root's name>-<source>.sass,
to read a loop's instructions.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

from ..native import BUILD_DIR, nvcc

FLAGS = {"sdtree.cu": "ppg_tpu_torch.guiding.descent",
         "reduce.cu": "ppg_tpu_torch.ops.reduce",
         "train.cu": "ppg_tpu_torch.guiding.train",
         "bvh.cu": "ppg_tpu_torch.accel.bvh_walk",
         "brute.cu": "ppg_tpu_torch.accel.brute",
         "film.cu": "ppg_tpu_torch.render.film",
         "microfacet.cu": "ppg_tpu_torch.bsdf.microfacet",
         "textures.cu": "ppg_tpu_torch.scene.textures",
         "envmap.cu": "ppg_tpu_torch.emitters.envmap",
         "media.cu": "ppg_tpu_torch.media",
         "subsurface.cu": "ppg_tpu_torch.subsurface"}
_OPS = re.compile(r"\b((?:LDG|STG|LDL|STL|LDS|STS|ATOMS|ATOMG|ATOM|RED|MUFU)"
                  r"(?:\.[A-Z0-9_]+)*)\b")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRA = re.compile(r"\bBRA(?:\.[A-Z]+)*\s+(?:!?U?P[T0-9],\s*)?"
                  r"(?:`\(\S+\)\s*)?0x([0-9a-f]+)")


def _demangle(names):
    r = subprocess.run(["c++filt"], input="\n".join(names),
                       capture_output=True, text=True)
    return r.stdout.split("\n") if r.returncode == 0 else names


def mufu_loops(insns):
    """Of a function's instructions [(address, text)], the innermost loops
    (a backward branch's [target, branch] range holding no other such
    range) that hold a MUFU instruction: [dict(start, end, instructions,
    mufu, branches, fast_instructions, fast_mufu)]."""
    loops = []
    for addr, text in insns:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    rows = []
    for a, b in sorted(set(loops)):
        if any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops):
            continue
        body = [(addr, t) for addr, t in insns if a <= addr <= b]
        skipped = set()
        for addr, t in body:
            m = _BRA.search(t)
            if m and t.lstrip().startswith("@") and int(m.group(1), 16) > addr:
                skipped.update(x for x, _ in body
                               if addr < x < int(m.group(1), 16))
        fast = [t for addr, t in body if addr not in skipped]
        row = dict(start=hex(a), end=hex(b), instructions=len(body),
                   mufu=sum("MUFU" in t for _, t in body),
                   branches=sum(bool(_BRA.search(t)) for _, t in body),
                   fast_instructions=len(fast),
                   fast_mufu=sum("MUFU" in t for t in fast))
        if row["mufu"]:
            rows.append(row)
    return rows


def count(src, root, out_dir, dump=None):
    import importlib

    flags = importlib.import_module(FLAGS[src]).NVCC_FLAGS
    compiler = nvcc()
    so = os.path.join(out_dir, src.replace(".cu", ".so"))
    r = subprocess.run([compiler, *flags, "-Xptxas", "-v", "-o", so,
                        os.path.join(root, "ppg_tpu_torch", "csrc", src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-3000:])
    info, name = {}, None
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            info.setdefault(name, {})["stack_frame_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            info.setdefault(name, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            info.setdefault(name, {})["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            info[name]["static_smem_bytes"] = int(s.group(1)) if s else 0
    cuobjdump = os.path.join(os.path.dirname(compiler), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    if dump:
        os.makedirs(dump, exist_ok=True)
        with open(os.path.join(dump, f"{os.path.basename(root)}-{src}.sass"),
                  "w") as f:
            f.write(sass)
    ops, insns, name = {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            ops[name] = collections.Counter()
            insns[name] = []
        elif name:
            ops[name].update(_OPS.findall(line))
            m = _INSN.search(line)
            if m and m.group(2).strip() not in ("", "NOP"):
                insns[name].append((int(m.group(1), 16), m.group(2)))
    names = sorted(set(info) | set(ops))
    for mangled, pretty in zip(names, _demangle(names)):
        yield dict(source=src, kernel=pretty, **info.get(mangled, {}),
                   sass=dict(sorted(ops.get(mangled, {}).items())),
                   loops=mufu_loops(insns.get(mangled, [])))


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        BUILD_DIR)))
    p.add_argument("--dump", help="write each source's SASS into this "
                   "directory")
    p.add_argument("sources", nargs="+", choices=sorted(FLAGS))
    a = p.parse_args(argv)
    out_dir = os.path.join(os.path.dirname(BUILD_DIR), "sass_count",
                           os.path.basename(os.path.abspath(a.root)))
    os.makedirs(out_dir, exist_ok=True)
    for src in a.sources:
        for row in count(src, os.path.abspath(a.root), out_dir, a.dump):
            print(json.dumps(dict(root=a.root, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

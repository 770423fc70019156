"""Times a kernel of several checkouts on one CUDA card, so that two
commits are compared in one run:

    git archive <commit> ppg_tpu_torch | tar -x -C build/parent
    python3 k1_compare.py build/parent . . build/parent
    python3 k1_compare.py --kernel k2 build/parent . . build/parent
    python3 k1_compare.py --kernel k3 build/parent . . build/parent
    python3 k1_compare.py --kernel k4 build/parent . . build/parent
    python3 k1_compare.py --kernel k5 build/parent . . build/parent
    python3 k1_compare.py --kernel k5a build/parent . . build/parent
    python3 k1_compare.py --kernel k5b build/parent . . build/parent
    python3 k1_compare.py --kernel k6 build/parent . . build/parent
    python3 k1_compare.py --kernel k7s build/parent . . build/parent
    python3 k1_compare.py --kernel k8 build/parent . . build/parent
    python3 k1_compare.py --kernel k9 build/parent . . build/parent
    python3 k1_compare.py --kernel k10 build/parent . . build/parent
    python3 k1_compare.py --kernel k11 build/parent . . build/parent
    python3 k1_compare.py --kernel k12 build/parent . . build/parent

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

--kernel k3, k4, k5, k5a, k5b and k6 take their inputs from the main path,
captured once by this checkout into --inputs (build/main_path_inputs.pt,
made if missing: the renders of chip_smoke.py's phases 3, 5 and 6, about
a minute; k5 also takes the box splat's first 65,536 records as a call
of its own, few records into many cells): k3, the spatial lookup
(guiding/descent.py) on phase 9's 262,144 lanes and tree, with the meta
(the tracer's call), alone (the stochastic filter's) and the meta of the
masked ids (dtree_meta); k5a, the directional splat
targets (guiding/train.py) on phase 5's and phase 6's largest box-mode
dir_targets call, in box mode, in nearest mode on the same records and
at given depths (the records' leaf depths: dtree_box_targets4); k5b,
the spatial box walk (guiding/train.py::stree_box) on phase 6's largest
stree_box_targets call, with its record mask; k6, the Adam rounds
(guiding/train.py::adam_rounds) on phase 5's last Adam batch, for both
losses; k4, the
sample-and-pdf walk (guiding/descent.py) on phase 9's 262,144 lanes of
the tree phase 3's last iteration sampled from, sampling and point lanes
and the point mode; each tree gets the uniforms in the layout its wrapper
takes (lane-major [L, 22] before the level-major one), the same values a
lane, and a tree with qs_row also runs its kernel on the lane-major u
through the kernel's strides ("rows only") and times a transposing copy
of u into the level-major layout (what keeping the lane-major draw on a
card would cost a bounce). k5, the accumulation
(ops/reduce.py) on phase 10's five calls (the largest of each kind), also
with each kernel's device time on its own (torch.profiler) and, where
the tree has ops/reduce.py::path, the path taken. Each line carries a
digest of the results (the sum of their bits).

--kernel k7s: the reconstruction filter's film splat,
render/film.py::Film.splat, on one seeded chunk of chip_smoke.py's C =
262,144 lanes at 512 x 512 (positions jittered inside their pixels, 5%
of the coordinates on the pixel's far edge; values over twelve orders of
magnitude), for the five filters into one film and into the film and
the squared film: the wrapper, and the kernel alone over K7S_SETS copies
of its inputs and films (above the L2), as chip_smoke.k7s_rows times it.
The digest is the sum of the bits of one splat into zeroed films.

--kernel k8: visible-normal sampling, bsdf/microfacet.py::sample_visible,
on the inputs of the last call of chip_smoke.py phase 14's render (the
materials box at 512^2, 127 spp), captured once by this checkout into
build/k8_inputs.pt (about two minutes) with their strides (alpha_u, dist
and the lanes' families are views of the gathered material rows), the
families and the mask of the present microfacet families. A tree whose
sample_visible takes a gate runs gated, an older one ungated: on the
lanes as captured (and, gated trees, the same ungated), and on a
compacted contiguous copy of the gated-in lanes. Each line gives the
wrapper's time, the kernel alone over K8_SETS copies of its inputs (the
rows' storage copied once a set, above the L2) and warm in the L2, both
bounds (chip_smoke.vndf_bound_ms: the ungated count and the gated one),
and a digest of m on the gated-in lanes, which equal trees give alike.

--kernel k9: the texture atlas lookup, scene/textures.py::sample_atlas
and bump_lookups, on the last call of each of the four kinds of
chip_smoke.py phase 16's render (the textured box at 512^2, 127 spp: the
site's first and later bounces, the bump map, the walk), captured once
by this checkout into build/k9_inputs.pt (about two minutes) with the
atlas's arrays and the inputs' strides. Each tree builds its own atlas
from the arrays. Each line gives the lookups, the wrapper's time, the
kernel alone over K9_SETS copies of the inputs and the atlas (above the
L2) and warm, a digest of the lookups (NaN counted as 7), which equal
trees give alike, and, for a tree with textures.lookup_classes,
chip_smoke.atlas_bound_ms (the rows the values depend on, those the
plain version reads, the lookups of each class).

--kernel k10: the environment map's sampling and lookup,
emitters/envmap.py's sample_direct and lookup, on the render's last NEE
call and the last bounce's escaped lanes of chip_smoke.py phase 17 (the
sky box at 512^2, 127 spp, a 4096 x 2048 sunsky) and on its NEE call with
the most lanes gated in, captured once by this checkout into
build/k10_inputs.pt (about a minute) with the map's tables, the lanes'
inputs (strided as the tracer hands them over) and their gates. Each tree builds its own EnvmapArrays from the tables; a
tree without emitters/envmap.py prints a "skipped" line. Each line gives
the gated-in lanes, the wrapper's time, the kernel alone over K10_SETS
copies of the lanes' inputs (the map shared, above the L2) and warm, a
digest of the outputs (NaN counted as 7), which equal trees give alike,
and chip_smoke.env_bound_ms.

--kernel k11: Woodcock and ratio tracking through grid media,
media.py's woodcock_sample and ratio_transmittance, on the render's last
track and ratio calls of chip_smoke.py phase 18 (the smoke box at 512^2,
127 spp, a 256^3 grid) and on its track call with the most lanes gated
in and its ratio call with the most gated-in lanes of positive
distance, captured once by this checkout into build/k11_inputs.pt
(about a minute) with the medium rows and grids. A tree without K11
prints a "skipped" line. Each line gives the gated-in lanes and live
events, the wrapper's time, the kernel alone over K11_SETS copies of the
lanes' inputs (the grid shared, above the L2) and warm, a digest of the
outputs, chip_smoke.media_bound_ms and, for a tree whose plain version
gives each lane's events, chip_smoke.media_layout at that tree's
csrc/media.cu BATCH.

--kernel k12: the dipole's exitance sum, subsurface.py's lo_sub, on the
render's last call and its call with the most lanes gated in of
chip_smoke.py phase 19 (the translucent box at 512^2, 127 spp, a marble
sphere's cloud of about 13,000 points), captured once by this checkout
into build/k12_inputs.pt (about two minutes) with the point cloud, and
on an all-gated call (the largest call's gated-in lanes repeated over
its lane count). A
tree without K12 prints a "skipped" line. Each line gives the gated-in
lanes and lane-point pairs, the wrapper's time, the kernel alone over
K12_SETS copies of the lanes' inputs (the cloud shared) and warm, a
digest of the outputs and chip_smoke.dipole_bound_ms.
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


_CAPTURE = r"""
import sys
sys.path[:0] = [sys.argv[1]]
import torch
import chip_smoke as S
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene import mini_cbox
from ppg_tpu_torch.tools.sdtree_cases import capture_sampling_trees

captured = []
for res, spp, nee, over, chunk in (
        (S.RES, S.BUDGET, "never", {}, S.CHUNK),
        (S.RES, S.BUDGET, "never", S.IMPROVED, S.CHUNK),
        (S.NEE_RES, S.NEE_BUDGET, "always", S.NEE_FILTERS,
         S.NEE_RES * S.NEE_RES)):
    sc = mini_cbox(res=res, budget=spp, max_depth=S.MAX_DEPTH, nee=nee)
    tracer = GuidedPathTracer(sc, chunk=chunk, overrides=over, device="cuda")
    seen, undo = S.capture_pending()
    try:
        with capture_sampling_trees(tracer) as trees:
            tracer.render(seed=0)
    finally:
        undo()
    captured.append(seen)
    if not over:
        tree, cbox = trees[-1], sc
cpu = lambda ts: tuple(t.cpu() for t in ts)
k5 = {}
for kind in S.K5_KINDS:
    targets, idx, vals = max((c[f"k5 {kind}"] for c in captured
                              if f"k5 {kind}" in c),
                             key=lambda c: c[1].numel())
    k5[kind] = (cpu(targets), idx.cpu(), cpu(vals))
    if kind == "qb box":  # a batch of its first 65,536 records: few
        # records for many cells
        k5["qb box, 65,536 records"] = (cpu(targets), idx[:65536].cpu(),
                                        cpu(v[:65536] for v in vals))
p, mask, u, is_point, pc = S.descent_inputs(cbox)
from ppg_tpu_torch.guiding import sdtree as G
root, uniform = G.lookup_meta_plain(tree, p, mask)[2:4]
fields = lambda t: {f: getattr(t, f).cpu() for f in G.SDTreeArrays.FIELDS}
# K5a: phase 5's and phase 6's largest box-mode dir_targets call
k5a = {}
for phase, c in (("shade time (phase 5)", captured[1]),
                 ("splat time (phase 6)", captured[2])):
    sdt, sp_id, pcs, _ = c["k5a box"]
    k5a[phase] = dict(s_depth=sdt.s_depth, q_depth=sdt.q_depth,
                      fields=fields(sdt), sp_id=sp_id.cpu(), pc=pcs.cpu())
# K5b: phase 6's largest box walk; K6: phase 5's last Adam batch
sdt, bp, voxel, bmask = captured[2]["k5b"]
k5b = dict(s_depth=sdt.s_depth, q_depth=sdt.q_depth, fields=fields(sdt),
           p=bp.cpu(), voxel=voxel.cpu(),
           mask=None if bmask is None else bmask.cpu())
sdt, S0, S1, G0, W, _ = captured[1]["k6"]
k6 = dict(s_depth=sdt.s_depth, q_depth=sdt.q_depth, fields=fields(sdt),
          stats=cpu((S0, S1, G0, W)))
torch.save(dict(
    s_depth=tree.s_depth, q_depth=tree.q_depth, fields=fields(tree),
    u=u.contiguous().cpu(), is_point=is_point.cpu(), pc=pc.cpu(),
    root=root.cpu(), uniform=uniform.cpu(), p=p.cpu(), mask=mask.cpu(),
    k5=k5, k5a=k5a, k5b=k5b, k6=k6), sys.argv[2])
"""

_DIGEST = r"""
def digest(*ts):
    return sum(int(t.reshape(-1).view(torch.int32).sum(dtype=torch.int64))
               for t in ts if t is not None)
"""

# the prelude of the children that time a kernel on a captured tree:
# tree_of(c) puts a capture's tables back on the card (SDTreeArrays builds
# its rows anew), report() prints one JSON line for a callable
_TREE_CHILD = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
from ppg_tpu_torch.guiding import descent as D
from ppg_tpu_torch.guiding import sdtree as G
from ppg_tpu_torch.guiding import train as TR
""" + _DIGEST + r"""

def tree_of(c):
    return G.SDTreeArrays(c["s_depth"], c["q_depth"],
                          **{k: v.cuda() for k, v in c["fields"].items()})


def report(kernel, what, fn, **extra):
    out = fn()
    torch.cuda.synchronize()
    print(json.dumps(dict(tree=sys.argv[1], kernel=kernel, what=what,
                          **extra, wrapper_ms=S.cuda_ms(fn, 50, batches=5),
                          graph_ms=S.graph_ms(fn), digest=digest(*out))),
          flush=True)
"""

_CHILD_K3 = _TREE_CHILD + r"""
d = torch.load(sys.argv[3])
D.build()
sdt = tree_of(d)
p, mask = d["p"].cuda(), d["mask"].cuda()
ids = G.lookup_meta_plain(sdt, p, mask)[0]
for what, fn in (("lookup with meta", lambda: G.lookup_meta(sdt, p, mask)),
                 ("lookup alone", lambda: G.lookup(sdt, p)),
                 ("meta of ids", lambda: G.dtree_meta(sdt, ids))):
    report("sd_lookup", what, fn, L=p.shape[0])
"""

_CHILD_K5A = _TREE_CHILD + r"""
TR.build()
for phase, c in torch.load(sys.argv[3])["k5a"].items():
    sdt = tree_of(c)
    sp_id, pc = c["sp_id"].cuda(), c["pc"].cuda()
    root = G._take(sdt.db_root, sp_id)
    depth = G.descend_cell_plain(sdt.qb_child, root, pc, None,
                                 sdt.q_depth)[2]
    box = lambda: TR.dir_targets(sdt, sp_id, pc, True)
    given = lambda: TR.box_targets(sdt.qb_child, root, pc, depth,
                                   sdt.q_depth)
    runs = {"box": box,
            "nearest": lambda: (TR.dir_targets(sdt, sp_id, pc, False),),
            "given depth": given}
    for what, fn in runs.items():
        report("sd_dir_targets", f"{phase}, {what}", fn, L=sp_id.numel())
"""

_CHILD_K5B = _TREE_CHILD + r"""
TR.build()
c = torch.load(sys.argv[3])["k5b"]
sdt = tree_of(c)
p, voxel = c["p"].cuda(), c["voxel"].cuda()
mask = None if c["mask"] is None else c["mask"].cuda()
report("sd_stree_box", "box walk (phase 6)",
       lambda: TR.stree_box(sdt, p, voxel, mask), L=p.shape[0],
       in_mask=p.shape[0] if mask is None else int(mask.sum()))
"""

_CHILD_K6 = _TREE_CHILD + r"""
TR.build()
c = torch.load(sys.argv[3])["k6"]
sdt = tree_of(c)
S0, S1, G0, W = (t.cuda() for t in c["stats"])
for kl in (True, False):
    report("sd_adam", f"{'kl' if kl else 'var'} rounds (phase 5)",
           lambda: TR.adam_rounds(sdt, S0, S1, G0, W, kl), T=S0.shape[0])
"""

_CHILD_K4 = _TREE_CHILD + r"""
d = torch.load(sys.argv[3])
lib = D.build()
sdt = tree_of(d)
rows = d["u"].cuda()  # [L, 22], the lane-major values
is_point, pc, root, uniform = (d[k].cuda() for k in
                               ("is_point", "pc", "root", "uniform"))
L = rows.shape[0]
has_row = hasattr(sdt, "qs_row")
u = rows.t().contiguous().t() if has_row else rows
runs = {"sampling and point lanes":
            lambda: D.sample_pdf(sdt, u, is_point, pc, root, uniform),
        "point mode": lambda: (None, D.pdf_point(sdt, pc, root, uniform))}
if has_row:
    pfin = torch.empty((L, 2), device="cuda")
    pdf = torch.empty(L, device="cuda")

    def rows_only():  # on the current stream, a graph's capture included
        assert lib.ppg_sd_sample_pdf(
            sdt.qs_row.data_ptr(), sdt.qs_sum.shape[0], sdt.q_depth,
            rows.data_ptr(), 1, rows.shape[1], is_point.data_ptr(),
            pc.data_ptr(), root.data_ptr(), uniform.data_ptr(), L,
            pfin.data_ptr(), pdf.data_ptr(), 0,
            torch.cuda.current_stream().cuda_stream) == 0
        return pfin, pdf
    runs["sampling and point lanes, rows only (lane-major u)"] = rows_only
    # what the level-major layout would cost a tracer that kept the
    # lane-major draw on the card: one transposing copy a bounce
    runs["a transposing copy of u"] = lambda: (rows.t().contiguous(), None)
for what, fn in runs.items():
    report("sd_sample_pdf", what, fn, L=L)
"""

_CHILD_K5 = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
from ppg_tpu_torch.ops import reduce as R

R.build()
for kind, (targets, idx, vals) in torch.load(sys.argv[3])["k5"].items():
    idx = idx.cuda()
    vals = tuple(v.cuda() for v in vals)

    def kernel(ts):
        if len(ts) == 1:
            return (R.bincount_add(ts[0], idx, vals[0]),)
        return R.bincount_add2(ts, idx, *vals)

    out = kernel(tuple(t.cuda() for t in targets))
    work = tuple(t.cuda() for t in targets)
    fn = lambda: kernel(work)
    path = (R.path(targets[0].numel(), len(targets))
            if hasattr(R, "path") else None)
    print(json.dumps(dict(
        tree=sys.argv[1], kernel="reduce_add", what=kind, N=idx.numel(),
        M=targets[0].numel(), streams=len(targets), path=path,
        wrapper_ms=S.cuda_ms(fn, 20, batches=3), graph_ms=S.graph_ms(fn),
        passes_ms=S.kernel_ms(fn), digest=sum(
            int(t.view(torch.int32).sum(dtype=torch.int64)) for t in out))),
        flush=True)
"""

_CHILD_K7S = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import numpy as np
import torch
import chip_smoke as S
from ppg_tpu_torch.render import film as F
""" + _DIGEST + r"""
F.build()
W = H = S.RES
rng = np.random.default_rng(14)
ids = np.arange(S.CHUNK)
jit = rng.random((S.CHUNK, 2)).astype(np.float32)
jit[rng.random((S.CHUNK, 2)) < 0.05] = 1.0
pos = np.stack([ids % W, ids // W], -1).astype(np.float32) + jit
vals = (rng.normal(size=(S.CHUNK, 3))
        * 10.0 ** rng.uniform(-6, 6, (S.CHUNK, 1))).astype(np.float32)
pos, vals = torch.from_numpy(pos).cuda(), torch.from_numpy(vals).cuda()
for name in S.FILTERS:
    film = F.Film(W, H, name, "cuda")
    for films in (1, 2):
        def splat(b, p=pos, v=vals, films=films):
            film.splat(b[:2], 0, p, v, b[2:] if films == 2 else None)
            return b
        out = splat(film.zeros() + film.zeros())
        sets = [(film.zeros() + film.zeros(), pos.clone(), vals.clone())
                for _ in range(S.K7S_SETS)]
        turn = iter(range(1 << 30))

        def cold():
            b, p, v = sets[next(turn) % S.K7S_SETS]
            splat(b, p, v)
        work = film.zeros() + film.zeros()
        print(json.dumps(dict(
            tree=sys.argv[1], kernel="film_splat_filter", what=name,
            films=films, C=S.CHUNK,
            wrapper_ms=S.cuda_ms(lambda: splat(work), 50, batches=5),
            graph_ms=S.graph_ms(cold), digest=digest(*out[:2 * films]))),
            flush=True)
        del sets
"""


# tensors that view one storage as different types (the material rows'
# floats and ints) saved as that storage's bytes and each view's place
_VIEWS = r"""
def views_state(ts):
    bufs, specs = {}, []
    for t in ts:
        st = t.untyped_storage()
        k = bufs.setdefault(st.data_ptr(), (len(bufs), torch.empty(
            0, dtype=torch.uint8, device=t.device).set_(
                st, 0, (st.nbytes(),), (1,))))[0]
        specs.append((k, t.dtype, t.storage_offset(), tuple(t.shape),
                      t.stride()))
    return dict(bufs=[b for _, b in sorted(bufs.values(),
                                           key=lambda x: x[0])],
                specs=specs)


def views_of(state):
    return [torch.empty(0, dtype=dt, device=state["bufs"][k].device).set_(
        state["bufs"][k].untyped_storage(), off, shape, stride)
        for k, dt, off, shape, stride in state["specs"]]
"""

_CAPTURE_K8 = r"""
import sys
sys.path[:0] = [sys.argv[1]]
import torch
import chip_smoke as S
from ppg_tpu_torch.bsdf import bsdf as B
from ppg_tpu_torch.bsdf import microfacet as MF
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.testscenes import mini_cbox_materials
""" + _VIEWS + r"""
# the last visible-normal call's inputs, and its lanes' families with the
# mask of the present microfacet families (what the gate takes)
seen, families, sample = {}, B._visible_normals, MF.sample_visible


def keep_families(p, mt, on, *rest):
    seen.update(mtype=mt, fams=sum(1 << t for t in B._MF_TYPES if on(t)))
    return families(p, mt, on, *rest)


def keep(*args, **kw):
    seen["args"] = args
    return sample(*args, **kw)


B._visible_normals, MF.sample_visible = keep_families, keep
sc = mini_cbox_materials(res=S.RES, budget=S.BUDGET, max_depth=S.MAX_DEPTH)
GuidedPathTracer(sc, chunk=S.CHUNK, overrides=S.IMPROVED,
                 device="cuda").render(seed=0)
torch.save(dict(views=views_state(list(seen["args"][:5]) + [seen["mtype"]]),
                fams=seen["fams"]), sys.argv[2])
"""

_CHILD_K8 = r"""
import inspect, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
from ppg_tpu_torch.bsdf import microfacet as MF
""" + _DIGEST + _VIEWS + r"""
MF.build()
d = torch.load(sys.argv[3], map_location="cuda")
ts = views_of(d["views"])
args, gate = ts[:5], (ts[5], d["fams"])
gated = "gate" in inspect.signature(MF.sample_visible).parameters
sel, near = S.vndf_classes(args, gate)
ggx = sel & (args[0] == 1)
near0 = sel & ~ggx & near
ids = sel.nonzero()[:, 0]
bounds = dict(old=S.vndf_bound_ms(args[0], near),
              gated=S.vndf_bound_ms(args[0], near, sel))
compact = [t[ids].contiguous() for t in args + [gate[0]]]


def call(ts, g):
    if g is None:
        return MF.sample_visible(*ts[:5])
    return MF.sample_visible(*ts[:5], gate=g)


runs = {"phase 14's lanes": (args + [gate[0]], gate if gated else None)}
if gated:
    runs["phase 14's lanes, ungated"] = (args, None)
runs["gated-in lanes, compacted"] = (compact, (compact[5], gate[1])
                                     if gated else None)
if gated:
    # the same lanes with the mask cut to the GGX families, to the
    # Beckmann ones, or to none (the family read and (0, 0, 1) written on
    # every lane)
    mt = gate[0]
    for what, d in (("GGX", 1), ("Beckmann", 0), ("no", None)):
        fams = 0 if d is None else sum(
            1 << int(t) for t in mt[sel & (args[0] == d)].unique())
        runs[f"phase 14's lanes, {what} families gated in"] = (
            args + [mt], (mt, fams))
for what, (ts, g) in runs.items():
    m = call(ts, g)
    torch.cuda.synchronize()
    sets = [S.storage_copies(ts) for _ in range(S.K8_SETS)]
    turn = iter(range(1 << 30))

    def cold():
        t = sets[next(turn) % S.K8_SETS]
        call(t, None if g is None else (t[5], g[1]))
    print(json.dumps(dict(
        tree=sys.argv[1], kernel="vndf_kernel", what=what,
        fams=None if g is None else g[1],
        L=ts[0].shape[0], gated_in=int(sel.sum()), ggx=int(ggx.sum()),
        near0=int(near0.sum()), gate=g is not None,
        wrapper_ms=S.cuda_ms(lambda: call(ts, g), 50, batches=5),
        graph_ms=S.graph_ms(cold), warm_ms=S.graph_ms(lambda: call(ts, g)),
        bounds=bounds,
        digest=digest(m if ts is compact else m[ids]))), flush=True)
    del sets
"""

_CAPTURE_K9 = r"""
import sys, tempfile
sys.path[:0] = [sys.argv[1]]
import torch
import chip_smoke as S
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene import textures as TX
from ppg_tpu_torch.scene.testscenes import (mini_cbox_textures_xml,
                                            scene_from_xml)
""" + _VIEWS + r"""
# the last K9 call of each kind of phase 16's render (chip_smoke's kinds)
calls, launch = {}, TX._launch


def keep(atlas, tex_id, uv, foot_uv=None, duv=None, bump=False):
    kind = ("bump" if bump else "walk" if foot_uv is None and duv is None
            else "site, later bounce" if duv is not None and duv[0] is duv[1]
            else "site, first bounce")
    calls[kind] = (atlas, tex_id, uv, foot_uv, duv, bump)
    return launch(atlas, tex_id, uv, foot_uv, duv, bump)


TX._launch = keep
with tempfile.TemporaryDirectory(prefix="k1_compare-") as tmp:
    sc = scene_from_xml(mini_cbox_textures_xml(
        tmp, res=S.RES, budget=S.BUDGET, max_depth=S.MAX_DEPTH, nee="always",
        floor_res=S.TEX_FLOOR_RES, bump_res=S.TEX_BUMP_RES, seed=16))
    GuidedPathTracer(sc, chunk=S.CHUNK, overrides=S.IMPROVED,
                     device="cuda").render(seed=0)
atlas = next(iter(calls.values()))[0]
out = dict(atlas={f: getattr(atlas, f).cpu().numpy()
                  for f in TX.TextureAtlas.FIELDS}, calls={})
for kind, (_, tid, uv, foot, duv, bump) in calls.items():
    ts = [tid, uv] + ([foot] if foot is not None else []) + (
        [duv[0]] if duv is not None and duv[0] is duv[1] else
        list(duv) if duv is not None else [])
    out["calls"][kind] = dict(views=views_state(ts), foot=foot is not None,
                              duv=duv is not None, bump=bump)
torch.save(out, sys.argv[2])
"""

_CHILD_K9 = r"""
import copy, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
from ppg_tpu_torch.scene import textures as TX
""" + _DIGEST + _VIEWS + r"""
TX.build()
d = torch.load(sys.argv[3], weights_only=False)
atlas = TX.TextureAtlas(d["atlas"], "cuda")
new = hasattr(TX, "lookup_classes")
for kind, c in d["calls"].items():
    ts = views_of({"bufs": [b.cuda() for b in c["views"]["bufs"]],
                   "specs": c["views"]["specs"]})
    tid, uv = ts[:2]
    foot = ts[2] if c["foot"] else None
    duv = None if not c["duv"] else (ts[2], ts[2]) if len(ts) == 3 else (
        ts[2], ts[3])
    args = (atlas, tid, uv, foot, duv, c["bump"])

    def call(a, t):
        if c["bump"]:
            return TX.bump_lookups(a, t[0], t[1])
        return TX.sample_atlas(a, t[0], t[1], *t[2:])
    wrap_args = [tid, uv] + ([] if c["bump"] else [foot, duv])
    out = call(atlas, wrap_args)
    torch.cuda.synchronize()
    sets = []
    for _ in range(S.K9_SETS):
        a = copy.copy(atlas)
        a.pixels = atlas.pixels.clone()
        cp = S.storage_copies(ts)
        f = cp[2] if c["foot"] else None
        du = None if not c["duv"] else (cp[2], cp[2]) if len(cp) == 3 \
            else (cp[2], cp[3])
        sets.append((a, [cp[0], cp[1]] + ([] if c["bump"] else [f, du])))
    turn = iter(range(1 << 30))

    def cold():
        call(*sets[next(turn) % S.K9_SETS])
    row = dict(tree=sys.argv[1], kernel="atlas_kernel", what=kind,
               lookups=out.shape[0], lanes=uv.shape[0],
               wrapper_ms=S.cuda_ms(lambda: call(atlas, wrap_args), 50,
                                    batches=5),
               graph_ms=S.graph_ms(cold),
               warm_ms=S.graph_ms(lambda: call(atlas, wrap_args)),
               digest=digest(torch.nan_to_num(out, nan=7.0)))
    if new:
        bound, by, ops, need, read, bound_read, classes = \
            S.atlas_bound_ms(args)
        row.update(bound_ms=bound, bound_by=by, rows_needed=need,
                   rows_read=read, bound_read_ms=bound_read,
                   classes=classes)
    print(json.dumps(row), flush=True)
    del sets
"""


_CAPTURE_K10 = r"""
import sys
sys.path[:0] = [sys.argv[1]]
import torch
import chip_smoke as S
from ppg_tpu_torch.emitters import envmap as EV
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.testscenes import mini_cbox_sky_xml, scene_from_xml
""" + _VIEWS + r"""
# the render's last K10 call of each kind (chip_smoke's phase 17 kinds),
# and its NEE call with the most lanes gated in, copied when it is made
calls, launch, largest = {}, EV._launch, {"lanes": -1}


def state(mode, x, ux, uy, gate, n, copy=False):
    views = views_state([t for t in (x, ux, uy, gate.key, gate.m1, gate.m2)
                         if t is not None])
    if copy:
        views["bufs"] = [b.clone() for b in views["bufs"]]
    return dict(views=views, mode=mode, n=n, key_val=gate.key_val,
                present=[t is not None for t in (ux, uy, gate.key, gate.m1,
                                                 gate.m2)])


def keep(mode, env, x, ux, uy, gate, n):
    if mode == EV.SAMPLE:
        calls["sample, the render's last NEE call"] = (mode, x, ux, uy,
                                                       gate, n)
        lanes = int(EV.gate_mask(gate, x.shape[0], x.device).sum())
        if lanes > largest["lanes"]:
            largest.update(lanes=lanes, call=state(mode, x, ux, uy, gate, n,
                                                   copy=True))
    elif gate is not None and gate.m1 is not None:
        calls["lookup, the last bounce's escaped lanes"] = (mode, x, ux, uy,
                                                            gate, n)
    return launch(mode, env, x, ux, uy, gate, n)


EV._launch = keep
sc = scene_from_xml(mini_cbox_sky_xml(
    res=S.RES, budget=S.BUDGET, max_depth=S.MAX_DEPTH, nee="always",
    resolution=S.SKY_RESOLUTION))
tracer = GuidedPathTracer(sc, chunk=S.CHUNK, overrides=S.IMPROVED,
                          device="cuda")
tracer.render(seed=0)
env = tracer.scene_dev.env
out = dict(tables={f: getattr(env, f).cpu().numpy()
                   for f in EV.EnvmapArrays.FIELDS}, calls={})
for kind, c in calls.items():
    out["calls"][kind] = state(*c)
out["calls"]["sample, the render's largest NEE call"] = largest["call"]
torch.save(out, sys.argv[2])
"""

_CHILD_K10 = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
try:
    from ppg_tpu_torch.emitters import envmap as EV
except ImportError as e:
    print(json.dumps(dict(tree=sys.argv[1], skipped=str(e)[:200])))
    sys.exit(0)
""" + _DIGEST + _VIEWS + r"""
EV.build()
d = torch.load(sys.argv[3], weights_only=False)
env = EV.EnvmapArrays(d["tables"], "cuda")


def unpack(c, ts):
    it = iter(ts)
    x = next(it)
    ux, uy, key, m1, m2 = (next(it) if p else None for p in c["present"])
    return x, ux, uy, EV.Gate(key, c["key_val"], m1, m2)


for kind, c in d["calls"].items():
    ts = views_of({"bufs": [b.cuda() for b in c["views"]["bufs"]],
                   "specs": c["views"]["specs"]})
    mode, n = c["mode"], c["n"]
    x, ux, uy, gate = unpack(c, ts)

    def call(x, ux, uy, gate):
        if mode == EV.SAMPLE:
            r = EV.sample_direct(env, x, ux, uy, gate, n)
            return [r[k] for k in ("d", "dist", "pdf", "value")]
        return list(EV.lookup(env, x, gate, n))
    out = call(x, ux, uy, gate)
    torch.cuda.synchronize()
    sets = [unpack(c, S.storage_copies(ts)) for _ in range(S.K10_SETS)]
    turn = iter(range(1 << 30))

    def cold():
        call(*sets[next(turn) % S.K10_SETS])
    bound, by, reads, ops = S.env_bound_ms(env, mode, (x, ux, uy, gate))
    print(json.dumps(dict(
        tree=sys.argv[1], kernel="env_kernel", what=kind, L=x.shape[0],
        gated_in=reads[0], wrapper_ms=S.cuda_ms(lambda: call(x, ux, uy, gate),
                                               50, batches=5),
        graph_ms=S.graph_ms(cold),
        warm_ms=S.graph_ms(lambda: call(x, ux, uy, gate)),
        bound_ms=bound, bound_by=by, reads=reads,
        digest=digest(*(torch.nan_to_num(t, nan=7.0) for t in out)))),
        flush=True)
    del sets
"""


_CAPTURE_K11 = r"""
import sys
sys.path[:0] = [sys.argv[1]]
import tempfile
import torch
import chip_smoke as S
from ppg_tpu_torch import media as ME
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.testscenes import mini_cbox_smoke_xml, scene_from_xml

# the render's last K11 call of each mode, and its call of each mode with
# the most gated-in lanes (of positive distance, ratio), copied when made
calls, launch, largest = {}, ME._launch, {}


def keep(mode, media, mid, o, d, t_end, seed, n_steps=ME.WOODCOCK_STEPS):
    args = (mode, mid, o, d, t_end, seed)
    track = mode == ME.TRACK
    calls["track, the render's last Woodcock call" if track
          else "ratio, the render's last shadow-walk call"] = args
    row = ME.fetch_row(media, mid)
    lanes = int(((mid >= 0) & (row[:, 7] > 0)
                 & (track | (t_end > 0))).sum())
    kind = ("track, the render's largest Woodcock call" if track
            else "ratio, the render's largest shadow-walk call")
    if lanes > largest.get(kind, (-1,))[0]:
        largest[kind] = (lanes, tuple(x.clone() if torch.is_tensor(x) else x
                                      for x in args))
    return launch(mode, media, mid, o, d, t_end, seed, n_steps)


ME._launch = keep
with tempfile.TemporaryDirectory() as tmp:
    sc = scene_from_xml(mini_cbox_smoke_xml(
        tmp, res=S.RES, budget=S.BUDGET, max_depth=S.MAX_DEPTH, nee="always",
        grid_res=S.SMOKE_GRID_RES, seed=0))
tracer = GuidedPathTracer(sc, chunk=S.CHUNK, overrides=S.IMPROVED,
                          device="cuda")
tracer.render(seed=0)
media = tracer.scene_dev.media
out = dict(tables=dict(rows=media.rows.cpu(), grid=media.grid.cpu(),
                       num=media.num), calls={})
for kind, c in list(calls.items()) + [(k, v[1]) for k, v in
                                       largest.items()]:
    out["calls"][kind] = tuple(x.cpu() if torch.is_tensor(x) else x
                               for x in c)
torch.save(out, sys.argv[2])
"""

_CHILD_K11 = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
try:
    from ppg_tpu_torch import media as ME
    from ppg_tpu_torch.tools import media_cases as MC
    ME.woodcock_sample
except (ImportError, AttributeError) as e:
    print(json.dumps(dict(tree=sys.argv[1], skipped=str(e)[:200])))
    sys.exit(0)
""" + _DIGEST + r"""
ME.build()
d = torch.load(sys.argv[3], weights_only=False)
t = d["tables"]
media = ME.MediaArrays(t["rows"].cuda(), t["grid"].cuda(), t["num"])
for kind, c in d["calls"].items():
    mode, args = c[0], tuple(x.cuda() for x in c[1:])
    call = lambda *a: ME._launch(mode, media, *a)
    out = call(*args)
    out = out if mode == ME.TRACK else (out,)
    torch.cuda.synchronize()
    sets = [tuple(x.clone() for x in args) for _ in range(S.K11_SETS)]
    turn = iter(range(1 << 30))

    def cold():
        call(*sets[next(turn) % S.K11_SETS])
    bound, by, stats, ops, want = S.media_bound_ms(media, mode, args)
    # the lanes' layout, where the tree's plain version gives each lane's
    # events (the same for every tree on these inputs)
    layout = (S.media_layout(media, mode, args, stats, want,
                             MC.k11_constants()["BATCH"])
              if "lane_events" in stats else None)
    print(json.dumps(dict(
        tree=sys.argv[1], kernel="media_kernel", what=kind,
        L=args[0].shape[0], gated_in=stats["gated_in"],
        events=stats["events"], wrapper_ms=S.cuda_ms(lambda: call(*args),
                                                    50, batches=5),
        graph_ms=S.graph_ms(cold), warm_ms=S.graph_ms(lambda: call(*args)),
        bound_ms=bound, bound_by=by,
        distinct_grid=stats["distinct_grid"], layout=layout,
        digest=digest(*(x.float() for x in out)))), flush=True)
    del sets
"""

_CAPTURE_K12 = r"""
import sys
sys.path[:0] = [sys.argv[1]]
import torch
import chip_smoke as S
from ppg_tpu_torch import subsurface as SS
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.scene.testscenes import (mini_cbox_translucent_xml,
                                            scene_from_xml)

# the render's last K12 call, and its call with the most gated-in lanes,
# copied when made
calls, launch, largest = {}, SS._launch, [-1, None]


def keep(ss, ss_id, p, cos_o):
    calls["the render's last call"] = (ss_id, p, cos_o)
    lanes = int(((ss_id >= 0) & (cos_o > 0)).sum())
    if lanes > largest[0]:
        largest[:] = [lanes, tuple(x.clone() for x in (ss_id, p, cos_o))]
    return launch(ss, ss_id, p, cos_o)


SS._launch = keep
sc = scene_from_xml(mini_cbox_translucent_xml(
    res=S.RES, budget=S.BUDGET, max_depth=S.MAX_DEPTH, nee="always"))
tracer = GuidedPathTracer(sc, chunk=S.CHUNK, overrides=S.IMPROVED,
                          device="cuda")
tracer.render(seed=0)
calls["the render's largest call"] = largest[1]
ss = tracer.scene_dev.subsurf
out = dict(tables={f: getattr(ss, f).cpu() for f in SS.SubsurfArrays.FIELDS},
           num=ss.num, calls={k: tuple(x.cpu() for x in c)
                              for k, c in calls.items()})
torch.save(out, sys.argv[2])
"""

_CHILD_K12 = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as S
try:
    from ppg_tpu_torch import subsurface as SS
    SS._launch
except (ImportError, AttributeError) as e:
    print(json.dumps(dict(tree=sys.argv[1], skipped=str(e)[:200])))
    sys.exit(0)
""" + _DIGEST + r"""
SS.build()
d = torch.load(sys.argv[3], weights_only=False)
ss = SS.SubsurfArrays(*(d["tables"][f].cuda()
                        for f in SS.SubsurfArrays.FIELDS), num=d["num"])
# a call with every lane gated in: the largest call's gated-in lanes,
# repeated over its lane count
sid, p, co = d["calls"]["the render's largest call"]
on = ((sid >= 0) & (co > 0)).nonzero()[:, 0]
rep = on[torch.arange(sid.shape[0]) % on.shape[0]]
d["calls"]["an all-gated call"] = (sid[rep].contiguous(),
                                   p[rep].contiguous(), co[rep].contiguous())
for kind, c in d["calls"].items():
    args = tuple(x.cuda() for x in c)
    call = lambda *a: SS._launch(ss, *a)
    out = call(*args)
    torch.cuda.synchronize()
    sets = [tuple(x.clone() for x in args) for _ in range(S.K12_SETS)]
    turn = iter(range(1 << 30))

    def cold():
        call(*sets[next(turn) % S.K12_SETS])
    bound, by, n_in, pairs, ops = S.dipole_bound_ms(ss, args)
    print(json.dumps(dict(
        tree=sys.argv[1], kernel="dipole_kernel", what=kind,
        L=args[0].shape[0], gated_in=n_in, pairs=pairs,
        wrapper_ms=S.cuda_ms(lambda: call(*args), 20, batches=3),
        graph_ms=S.graph_ms(cold, n=20),
        warm_ms=S.graph_ms(lambda: call(*args), n=20), bound_ms=bound,
        bound_by=by, digest=digest(out))), flush=True)
    del sets
"""


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=("k1", "k2", "k3", "k4", "k5",
                                        "k5a", "k5b", "k6", "k7s", "k8",
                                        "k9", "k10", "k11", "k12"),
                   default="k1")
    p.add_argument("--inputs", help="the captured main-path inputs "
                   "(default build/main_path_inputs.pt; for k8 "
                   "build/k8_inputs.pt, for k9 build/k9_inputs.pt, for "
                   "k10 build/k10_inputs.pt, for k11 build/k11_inputs.pt, "
                   "for k12 build/k12_inputs.pt)")
    p.add_argument("trees", nargs="*")
    a = p.parse_args(argv)
    if not a.trees:
        print(__doc__, file=sys.stderr)
        return 2
    child = {"k1": _CHILD_K1, "k2": _CHILD_K2, "k3": _CHILD_K3,
             "k4": _CHILD_K4, "k5": _CHILD_K5, "k5a": _CHILD_K5A,
             "k5b": _CHILD_K5B, "k6": _CHILD_K6, "k7s": _CHILD_K7S,
             "k8": _CHILD_K8, "k9": _CHILD_K9, "k10": _CHILD_K10,
             "k11": _CHILD_K11, "k12": _CHILD_K12}[a.kernel]
    arg = json.dumps(SHAPES)
    if a.kernel in ("k3", "k4", "k5", "k5a", "k5b", "k6", "k8", "k9",
                    "k10", "k11", "k12"):
        own = a.kernel in ("k8", "k9", "k10", "k11", "k12")
        arg = a.inputs or os.path.join(
            ROOT, "build", f"{a.kernel}_inputs.pt" if own
            else "main_path_inputs.pt")
        capture = {"k8": _CAPTURE_K8, "k9": _CAPTURE_K9,
                   "k10": _CAPTURE_K10, "k11": _CAPTURE_K11,
                   "k12": _CAPTURE_K12}.get(a.kernel, _CAPTURE)
        if not os.path.exists(arg):
            os.makedirs(os.path.dirname(os.path.abspath(arg)), exist_ok=True)
            r = subprocess.run([sys.executable, "-c", capture, ROOT, arg],
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=900)
            if r.returncode != 0:
                sys.stderr.write(r.stderr[-3000:])
                return r.returncode
    for tree in a.trees:
        r = subprocess.run([sys.executable, "-c", child,
                            os.path.abspath(tree), ROOT, arg],
                           capture_output=True, text=True, timeout=600)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

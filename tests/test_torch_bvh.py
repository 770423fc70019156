"""The port's BVH16 walk (ppg_tpu_torch/accel/traverse.py: build_geometry,
the plain walk bvh_closest_plain and the closest_hit / any_hit dispatch)
against ppg_tpu's (accel/traverse.py: build_geometry, bvh_closest under
jax.jit, any_hit), on scenes and rays made with numpy: the deep random
soup of tests/test_scene.py:130, a tessellated sphere seen from inside and
the built-in Cornell box's one-leaf tree.

The tolerance is K1's (test_torch_brute._assert_agree): the same triangle
except near-ties on at most 1e-4 of the lanes, t/u/v within 1e-5 relative
plus the lane's f32 error bound, since XLA:CPU may contract a multiply-add
that PyTorch rounds twice. What was found: the same triangle on every
lane, and the same steps on every lane (so the step counts are held
exactly); t, u and v differ in their last bits on some hit lanes. The
CUDA kernels are held bit for bit against the plain walk by
test_torch_bvh_gpu.py, on a card; here the kernel source, compiled for
the CPU against a shim header, is held bit for bit against it too."""

import ctypes
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.accel import traverse as JT
from ppg_tpu_torch.accel import brute as TB
from ppg_tpu_torch.accel import bvh_walk as BW
from ppg_tpu_torch.accel import traverse as TT
from ppg_tpu_torch.convert import geometry_from_numpy
from ppg_tpu_torch.scene import mini_cbox
from ppg_tpu_torch.scene.shapes import make_sphere
from ppg_tpu_torch.tools import cuda_shim
from ppg_tpu_torch.tools.soups import (TIE_COPIES, aim_at_edges, deep_soup,
                                      soup_rays, tie_rays, tie_soup)
from test_torch_brute import _assert_agree

_SCENES = {
    "soup": lambda: deep_soup(),
    "sphere": lambda: (lambda m: (m.positions, m.faces))(
        make_sphere(np.zeros(3), 100.0)),
    "cbox": lambda: (lambda sc: (sc.positions, sc.faces))(mini_cbox(res=8)),
}


@pytest.fixture(scope="module")
def geoms():
    """name -> (port geometry, ppg_tpu geometry), built once."""
    out = {}
    for name, make in _SCENES.items():
        pos, faces = make()
        out[name] = (TT.build_geometry(pos, faces, "cpu"),
                     JT.build_geometry(pos, faces))
    return out


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("name", list(_SCENES))
def test_build_geometry_matches_ppg_tpu(geoms, name):
    g, jg = geoms[name]
    np.testing.assert_array_equal(g.tri.numpy(), np.asarray(jg.tri))
    np.testing.assert_array_equal(g.perm.numpy(), np.asarray(jg.perm))
    # empty child slots hold NaN boxes: the rows are compared by their bits
    np.testing.assert_array_equal(_bits(g.rows.numpy()), _bits(jg.rows))
    assert (g.stack_depth, g.wide) == (jg.stack_depth, jg.wide)
    assert g.rows.stride(0) % 4 == 0 and g.rows.stride(1) == 1
    if name == "cbox":  # a root leaf under its one-child wrapping node
        assert g.rows.shape[0] == 2 and g.stack_depth == 8
    # ppg_tpu's arrays carried across give the same tensors
    c = geometry_from_numpy(np.asarray(jg.tri), np.asarray(jg.rows),
                            np.asarray(jg.perm), jg.stack_depth, jg.wide,
                            "cpu")
    assert torch.equal(c.tri, g.tri) and torch.equal(c.perm, g.perm)
    assert torch.equal(c.rows.view(torch.int32), g.rows.view(torch.int32))
    assert (c.stack_depth, c.wide) == (g.stack_depth, g.wide)


def _rays(case):
    """(scene name, numpy o, d, t_min, t_max) of each walk case."""
    if case == "soup":
        o, d, t_min, _ = soup_rays(512, seed=0)
        return "soup", o, d, t_min, np.full(512, 1e9, np.float32)
    if case == "sphere_inside":
        _, d, t_min, _ = soup_rays(256, seed=1)
        return ("sphere", np.zeros((256, 3), np.float32), d, t_min,
                np.full(256, 1e9, np.float32))
    if case == "parked_finite":
        return ("soup",) + soup_rays(512, seed=2, shadow=True)
    # the box's tree, rays from inside the box
    rng = np.random.default_rng(3)
    o = (rng.uniform(-0.9, 0.9, (512, 3)) + [0, 1, 0]).astype(np.float32)
    _, d, t_min, t_max = soup_rays(512, seed=3)
    return "cbox", o, d, t_min, t_max


_CASES = ["soup", "sphere_inside", "parked_finite", "cbox"]


@pytest.mark.parametrize("case", _CASES)
def test_plain_walk_matches_ppg_tpu(geoms, case):
    name, o, d, t_min, t_max = _rays(case)
    g, jg = geoms[name]
    *port, stats = TT.bvh_closest_plain(
        g, *(torch.from_numpy(a) for a in (o, d, t_min, t_max)),
        return_stats=True)
    *ref, jstats = jax.jit(lambda *a: JT.bvh_closest(*a, return_stats=True))(
        jg, *(jnp.asarray(a) for a in (o, d, t_min, t_max)))
    port = [x.numpy() for x in port]
    _assert_agree(port, ref, (g.tri.numpy(), o, d), case)
    # the same walk: the same steps on every lane, and the same turns
    np.testing.assert_array_equal(
        (stats["node_steps"] + stats["leaf_steps"]).numpy(),
        np.asarray(jstats["steps"]))
    assert stats["it"] == int(jstats["it"])
    hits = port[0] >= 0
    assert hits.sum() > len(o) // 8
    assert (port[0][t_max < t_min] == -1).all()
    if case == "sphere_inside":
        assert hits.all() and np.allclose(port[1], 100.0, atol=0.5)
    # the rows read: the root on every walking lane, leaves where it hit
    assert bool(stats["node_rows"][0]) and int(stats["leaf_rows"].sum()) > 0


def test_plain_walk_counts_the_tests_its_steps_need(geoms):
    """return_stats counts the slab tests a node step needs (its row's
    non-empty children in the lane's pending mask) and the triangle tests
    of a leaf step (the leaf's count). The box's tree is one node with one
    child, a leaf of 12 triangles, so both are exact there; on the soup
    they lie between one and W per step."""
    _, o, d, t_min, t_max = _rays("cbox")
    *_, st = TT.bvh_closest_plain(
        geoms["cbox"][0], *(torch.from_numpy(a) for a in (o, d, t_min, t_max)),
        return_stats=True)
    assert torch.equal(st["node_tests"], st["node_steps"])
    assert torch.equal(st["leaf_tests"], 12 * st["leaf_steps"])
    assert int(st["leaf_steps"].sum()) > 256

    g = geoms["soup"][0]
    _, o, d, t_min, t_max = _rays("soup")
    *_, st = TT.bvh_closest_plain(
        g, *(torch.from_numpy(a) for a in (o, d, t_min, t_max)),
        return_stats=True)
    for kind in ("node", "leaf"):
        steps, tests = st[f"{kind}_steps"], st[f"{kind}_tests"]
        assert (steps <= tests).all() and (tests <= g.wide * steps).all()
        assert tests.sum() < g.wide * steps.sum()


@pytest.mark.parametrize("case", ["soup", "parked_finite", "sphere_inside"])
def test_stop_on_hit_matches_ppg_tpu_any_hit(geoms, case):
    name, o, d, t_min, t_max = _rays(case)
    if case == "sphere_inside":  # segments that end inside the sphere
        t_max = np.where(np.arange(len(o)) % 2 == 0, 50.0, 150.0)
        t_max = t_max.astype(np.float32)
    g, jg = geoms[name]
    args = [torch.from_numpy(a) for a in (o, d, t_min, t_max)]
    occ = (TT.bvh_closest_plain(g, *args, stop_on_hit=True)[0] >= 0).numpy()
    want = np.asarray(jax.jit(JT.any_hit)(
        jg, *(jnp.asarray(a) for a in (o, d, t_min, t_max))))
    np.testing.assert_array_equal(occ, want)
    np.testing.assert_array_equal(TT.any_hit(g, *args).numpy(), want)
    assert 0 < occ.sum() < len(o)
    assert not occ[t_max < t_min].any()


def test_plain_walk_matches_the_port_sweep(geoms):
    """On the soup, hit distances agree with the triangle sweep within
    rtol 1e-4, atol 1e-5 (the kdbench criterion); on the box's one-leaf
    tree the walk (force_bvh) picks what the sweep picks, with the same
    bits of t (the sweep keeps a -0.0 u or v where the walk stores +0.0,
    so those compare by value)."""
    g, _ = geoms["soup"]
    o, d, t_min, t_max = (torch.from_numpy(a) for a in soup_rays(256, 4))
    bi, bt, _, _ = TT.bvh_closest_plain(g, o, d, t_min, t_max)
    ri, rt, _, _ = TT.brute_force_closest(g, o, d, t_min, t_max)
    assert (ri >= 0).sum() > 64
    np.testing.assert_allclose(torch.where(bi >= 0, bt, -1.0).numpy(),
                               torch.where(ri >= 0, rt, -1.0).numpy(),
                               rtol=1e-4, atol=1e-5)

    box, _ = geoms["cbox"]
    _, o, d, t_min, t_max = _rays("cbox")
    args = [torch.from_numpy(a) for a in (o, d, t_min, t_max)]
    got = TT.closest_hit(box, *args, force_bvh=True)
    want = TT.brute_force_closest(box, *args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


def test_dispatch_and_no_kernel_launch_on_the_cpu(monkeypatch):
    """closest_hit and any_hit take the sweep up to BRUTE_MAX triangles and
    the walk above it (or with force_bvh); on CPU tensors the wrappers run
    the plain versions and count no kernel launch."""
    rng = np.random.default_rng(5)
    small = TT.build_geometry(*(lambda p: (p, np.arange(len(p)).reshape(
        -1, 3)))(rng.random((3 * TT.BRUTE_MAX, 3))), "cpu")
    large = TT.build_geometry(*(lambda p: (p, np.arange(len(p)).reshape(
        -1, 3)))(rng.random((3 * (TT.BRUTE_MAX + 1), 3))), "cpu")
    assert small.num_tris == TT.BRUTE_MAX and large.num_tris > TT.BRUTE_MAX
    args = [torch.from_numpy(a) for a in soup_rays(64, seed=6)]
    args[0] = args[0] / 8 + 0.5  # origins inside the unit cube
    TB.reset_counts()
    got_small = TT.closest_hit(small, *args)
    got_large = TT.closest_hit(large, *args)
    occ_large = TT.any_hit(large, *args)
    assert TB.COUNTS == {"brute_kernel": 0, "any_hit": 0, "plain_on_cuda": 0}
    assert BW.COUNTS == {"bvh_kernel": 0, "bvh_any_hit": 0}
    for a, b in zip(got_small, TB.brute_sweep_plain(small.tri, *args)):
        assert torch.equal(a, b)
    for a, b in zip(got_large, TT.bvh_closest_plain(large, *args)):
        assert torch.equal(a, b)
    assert torch.equal(occ_large, got_large[0] >= 0)
    assert (got_large[0] >= 0).sum() > 10

    calls = []
    for name in ("brute_closest", "brute_any_hit", "bvh_closest",
                 "bvh_any_hit"):
        monkeypatch.setattr(TT, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    TT.closest_hit(small, *args)
    TT.closest_hit(small, *args, force_bvh=True)
    TT.any_hit(small, *args)
    TT.closest_hit(large, *args)
    TT.any_hit(large, *args)
    assert calls == ["brute_closest", "bvh_closest", "brute_any_hit",
                     "bvh_closest", "bvh_any_hit"]


def test_a_stack_deeper_than_the_kernel_holds_raises_at_build(monkeypatch):
    """The soup's tree needs a 16-entry walk stack; a kernel that held 8
    would silently drop entries and lose hits, so the build refuses."""
    pos, faces = deep_soup()
    assert TT.build_geometry(pos, faces, "cpu").stack_depth == 16
    monkeypatch.setattr(TT, "STACK_CAP", 8)
    with pytest.raises(ValueError, match="stack of 16 entries"):
        TT.build_geometry(pos, faces, "cpu")


def test_kdbench_on_the_sphere_scene_verifies(tmp_path):
    """The port's kdbench on the box with a tessellated sphere (16,140
    triangles) on the CPU: every verified ray agrees with the sweep."""
    from ppg_tpu_torch.scene.testscenes import MINI_CBOX, _SPHERE
    from ppg_tpu_torch.tools import kdbench

    path = tmp_path / "sphere.xml"
    path.write_text(MINI_CBOX.format(res=16, budget=4, max_depth=4,
                                     nee="never")
                    .replace("</scene>", _SPHERE + "</scene>"))
    out = kdbench.bench(str(path), lanes=1024, verify=256, reps=1,
                        device="cpu")
    assert out["tris"] == 16140 and out["device"] == "cpu"
    assert out["stack_depth"] == 16 and out["row_floats"] == 146
    assert out["camera_hit_rate"] > 0.9  # inside the box every ray hits
    assert out["verified_rays"] == 256 and out["mismatches"] == 0
    json.dumps(out)


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """csrc/bvh.cu built by the host compiler without FMA contraction,
    against tools/cuda_shim.py's shim (its launch rewritten as shim::run).
    Returns check(geom, o, d, t_min, t_max), which runs both entry points
    and holds them against the plain walk bit for bit; it returns the
    plain walk's closest hits."""
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    from ppg_tpu_torch.native import CSRC

    lib = cuda_shim.build_host(os.path.join(CSRC, "bvh.cu"),
                               str(tmp_path_factory.mktemp("bvh_host")),
                               "bvh_host", launches=1)
    for fn in (lib.ppg_bvh_closest, lib.ppg_bvh_any_hit):
        fn.argtypes, fn.restype = BW.ARGTYPES, ctypes.c_int

    def run(fn, g, o, d, t_min, t_max, out):
        taken = torch.zeros(1, dtype=torch.int32)
        assert fn(g.rows.data_ptr(), g.rows.stride(0), g.stack_depth,
                  o.data_ptr(), *o.stride(), d.data_ptr(), *d.stride(),
                  t_min.data_ptr(), t_min.stride(0), t_max.data_ptr(),
                  t_max.stride(0), len(o), out.data_ptr(), taken.data_ptr(),
                  0, None) == 0
        # a group takes one count after each ray it walks
        assert int(taken) == len(o)
        return out

    def check(g, *args):
        L = len(args[0])
        out = run(lib.ppg_bvh_closest, g, *args,
                  torch.zeros((4, L), dtype=torch.int32))
        want = TT.bvh_closest_plain(g, *args)
        assert torch.equal(out[0], want[0])
        for a, b in zip(out[1:], want[1:]):
            assert torch.equal(a, b.view(torch.int32))
        occ = run(lib.ppg_bvh_any_hit, g, *args,
                  torch.zeros(L, dtype=torch.uint8)).bool()
        assert torch.equal(occ, TT.bvh_closest_plain(
            g, *args, stop_on_hit=True)[0] >= 0)
        return want

    return check


def test_walk_kernel_source_compiled_for_the_cpu_equals_the_plain_walk(
        geoms, host_walk):
    """csrc/bvh.cu, built for the CPU (host_walk), against the plain walk
    bit for bit: closest hit and any-hit on the soup (rays aimed at edges,
    parked lanes, strided rays, shadow-style segments, a ragged length,
    and five rays, which leave groups without a ray beside groups with
    one), from
    inside the sphere and in the box's one-leaf tree. The kernel itself
    runs on a card in test_torch_bvh_gpu.py; this holds its logic here."""
    def hits(want):
        return int((want[0] >= 0).sum())

    soup = geoms["soup"][0]
    o, d, t_min, t_max = soup_rays(2048, seed=7)
    o = aim_at_edges(soup.tri.numpy(), o, d, 8)
    _, _, _, shadow = soup_rays(2048, seed=9, shadow=True)
    rays = [torch.from_numpy(a) for a in (o, d, t_min, t_max)]
    assert hits(host_walk(soup, *rays)) > 512
    assert hits(host_walk(soup, *rays[:3], torch.from_numpy(shadow))) > 128
    wide = torch.cat([rays[1], rays[1]], 1)[:, 3:]
    origin = torch.tensor([0.1, -0.2, 6.0]).expand(2048, 3)
    assert hits(host_walk(soup, origin, wide, *rays[2:])) > 128
    assert hits(host_walk(soup, *(r[:1001] for r in rays))) > 256
    assert hits(host_walk(soup, *(r[:5] for r in rays))) >= 1
    _, o, d, t_min, t_max = _rays("sphere_inside")
    assert hits(host_walk(geoms["sphere"][0], *(
        torch.from_numpy(a) for a in (o, d, t_min, t_max)))) == len(o)
    _, o, d, t_min, t_max = _rays("cbox")
    assert hits(host_walk(geoms["cbox"][0], *(
        torch.from_numpy(a) for a in (o, d, t_min, t_max)))) > 256


def _coincident_siblings(rows, wide):
    """Node rows holding two non-empty children with the same box."""
    info = rows[:, 6 * wide:7 * wide].view(np.int32)
    out, todo = [], [0]
    while todo:
        r = todo.pop()
        kids = np.flatnonzero(info[r] != 0)
        boxes = rows[r, :6 * wide].reshape(6, wide)[:, kids].T
        if len(np.unique(boxes, axis=0)) < len(kids):
            out.append(r)
        todo += [int(k) for k in info[r, kids] if not k & TT.LEAF_BIT]
    return out


def test_walk_ties_break_to_the_first_index(host_walk):
    """tools/soups.tie_soup stacks 40 and 17 copies of two triangles among
    random ones, so the tree holds coincident sibling boxes (ties in tn)
    over leaves of identical triangles (ties in t). The plain walk must
    break every tie as ppg_tpu's walk does (the same triangle on every
    lane, any-hit the same), and the kernel source, built for the CPU, as
    the plain walk does, bit for bit."""
    pos, faces = tie_soup()
    g = TT.build_geometry(pos, faces, "cpu")
    jg = JT.build_geometry(pos, faces)
    assert _coincident_siblings(g.rows.numpy(), g.wide)
    o, d, t_min, t_max = tie_rays(1024, seed=14)
    args = [torch.from_numpy(a) for a in (o, d, t_min, t_max)]
    jargs = [jnp.asarray(a) for a in (o, d, t_min, t_max)]
    port = [x.numpy() for x in TT.bvh_closest_plain(g, *args)]
    ref = jax.jit(JT.bvh_closest)(jg, *jargs)
    np.testing.assert_array_equal(port[0], np.asarray(ref[0]))
    _assert_agree(port, ref, (g.tri.numpy(), o, d), "ties")
    occ = (TT.bvh_closest_plain(g, *args, stop_on_hit=True)[0]
           >= 0).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jax.jit(JT.any_hit)(
        jg, *jargs)))
    # the rays that end on a stack end on one copy of each: the tie breaks
    # the same way from every direction
    copies = g.perm.numpy() >= len(faces) - sum(TIE_COPIES)
    on_stack = (port[0] >= 0) & copies[np.maximum(port[0], 0)]
    assert on_stack[:512].sum() > 256
    assert len(set(port[0][on_stack].tolist())) == 2
    want = host_walk(g, *args)
    assert torch.equal(want[0], torch.from_numpy(port[0]))

"""The port's box and stochastic splat filters against ppg_tpu's: the
box directional targets, the spatial box targets (with the 16-target
cap) and splat_records for every pair of spatial and directional filter
on both the shade-time (fast) and the splat-time (lookup) path, for
identical trees, record batches and jitter uniforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.guiding import sdtree as JG
from ppg_tpu_torch.convert import sdtree_from_numpy
from ppg_tpu_torch.guiding import sdtree as TG
from test_estimator_oracle import _refined_tree as _dir_tree
from test_estimator_oracle import _spatial_tree
from test_packed_descent import _refined_tree


def _port_tree(jtree):
    """A fresh port copy of a ppg_tpu tree (the port splats in place)."""
    fields = {f: np.asarray(getattr(jtree, f)) for f in JG.SDTreeArrays.FIELDS}
    return sdtree_from_numpy(fields, jtree.s_depth, jtree.q_depth, "cpu")


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_dtree_box_targets4_match():
    """Identical cells (the walks take the same branches) and weights
    within 1e-6: the overlap products are the same f32 operations."""
    _, j = _dir_tree()
    t = _port_tree(j)
    rng = np.random.default_rng(9)
    L = 3000
    pc = rng.uniform(0.0, 1.0, (L, 2)).astype(np.float32)
    pc[:200] = (0.5 + rng.normal(0, 0.01, (200, 2))).clip(0, 1)  # deep cells
    root = np.full(L, int(np.asarray(j.db_root)[0]), np.int32)
    jnode, jquad, jdep = JG.descend_cell_packed(
        j.qb_pack2, jnp.asarray(root), jnp.asarray(pc), None, j.q_depth)
    tnode, tquad, tdep = TG.descend_cell(t.qb_child, torch.from_numpy(root),
                                         torch.from_numpy(pc), None,
                                         t.q_depth)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))
    np.testing.assert_array_equal(tquad.numpy(), np.asarray(jquad))
    np.testing.assert_array_equal(tdep.numpy(), np.asarray(jdep))
    assert np.asarray(jdep).max() >= 4
    jcell, jw = JG.dtree_box_targets4_packed(j.qb_pack2, jnp.asarray(root),
                                             jnp.asarray(pc), jdep, j.q_depth)
    tcell, tw = TG.dtree_box_targets4(t.qb_child, torch.from_numpy(root),
                                      torch.from_numpy(pc), tdep, t.q_depth)
    np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    assert (tw.numpy() == 0).any() and (tw.numpy().sum(1) > 0.2).all()


def test_stree_box_targets_match_with_cap():
    """Identical (id, weight) lists in the same slot order, including
    records whose box overlaps more than S_TARGETS leaves, where the
    depth-first push order decides which leaves are kept."""
    _, j = _spatial_tree()
    t = _port_tree(j)
    rng = np.random.default_rng(13)
    L = 400
    amin = np.asarray(j.aabb_min)
    asize = float(np.asarray(j.aabb_size))
    x = rng.uniform(0.0, 1.0, (L, 3)).astype(np.float32)
    v = rng.uniform(0.02, 0.3, (L, 3)).astype(np.float32)
    x[:40] = rng.uniform(0.0, 0.4, (40, 3))  # where the tree is refined
    v[:40] = rng.uniform(0.3, 0.9, (40, 3))  # boxes over many leaves
    p = (amin + x * asize).astype(np.float32)
    voxel = (v * asize).astype(np.float32)
    jid, jw = JG.stree_box_targets(j, jnp.asarray(p), jnp.asarray(voxel))
    tid, tw = TG.stree_box_targets(t, torch.from_numpy(p),
                                   torch.from_numpy(voxel))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    full = (tid.numpy() >= 0).sum(1)
    assert full.max() == TG.S_TARGETS == JG.S_TARGETS  # the cap is hit
    assert (full > 1).mean() > 0.2


def _records(rng, N, tree):
    rec = dict(
        radiance=rng.random(N).astype(np.float32),
        product=rng.random(N).astype(np.float32),
        wo_pdf=(rng.random(N) + 0.05).astype(np.float32),
        bsdf_pdf=rng.random(N).astype(np.float32),
        dtree_pdf=rng.random(N).astype(np.float32),
        stat_weight=np.ones(N, np.float32),
        is_delta=rng.random(N) < 0.05,
        valid=rng.random(N) < 0.8,
        p=(rng.random((N, 3)) * 2.0).astype(np.float32),
        d=_unit(rng, N),
    )
    _, vox = JG.lookup(tree, jnp.asarray(rec["p"]))
    rec["voxel"] = np.asarray(vox)
    return rec


def _jax_targets(j, rec, spatial, directional, uj):
    """ppg_tpu's shade-time targets (regen.splat_targets) from its own
    walks: jittered lookup, packed building-tree descents."""
    p = jnp.asarray(rec["p"])
    if spatial == "stochastic":
        p = jnp.clip(p + (jnp.asarray(uj) - 0.5) * jnp.asarray(rec["voxel"]),
                     j.aabb_min, j.aabb_min + j.aabb_size)
    sp_id = np.asarray(JG.lookup(j, p)[0])
    sp_id = np.maximum(np.where(rec["valid"], sp_id, 0), 0).astype(np.int32)
    pc = JG.dir_to_canonical(jnp.asarray(rec["d"]))
    root = j.db_root[sp_id]
    node, quad, dep = JG.descend_cell_packed(j.qb_pack2, root, pc, None,
                                             j.q_depth)
    out = dict(sp_id=sp_id)
    if directional == "box":
        cell4, w4 = JG.dtree_box_targets4_packed(j.qb_pack2, root, pc, dep,
                                                 j.q_depth)
        out.update(cell4=np.asarray(cell4), w4=np.asarray(w4))
    else:
        out["cell"] = np.asarray(node * 4 + quad)
    return out


@pytest.fixture(scope="module")
def jtree():
    return _refined_tree().push()


@pytest.mark.parametrize("spatial,directional,path", [
    (s, d, p) for s in ("nearest", "stochastic", "box")
    for d in ("nearest", "box") for p in ("fast", "lookup")
    if not (s == "box" and p == "fast")])
def test_splat_records_filters_match(jtree, spatial, directional, path):
    """Building-tree sums within f32 summation-order tolerance: ppg_tpu
    sums each bin with a compensated prefix sum, the port with index_add_
    in record order, so each bin differs by a few f32 roundings of its
    own total (1e-5 relative plus 1e-5 of the largest bin). The shade-time
    targets themselves are identical."""
    j = jtree
    rng = np.random.default_rng(sum(map(ord, spatial + directional + path)))
    N = 6000
    rec = _records(rng, N, j)
    uj = rng.random((N, 3)).astype(np.float32)
    if path == "fast":
        want_t = _jax_targets(j, rec, spatial, directional, uj)
        got_t = TG.splat_targets(
            _port_tree(j), torch.from_numpy(np.asarray(JG.lookup(
                j, jnp.asarray(rec["p"]))[0])), torch.from_numpy(rec["d"]),
            torch.from_numpy(rec["valid"]), spatial, directional,
            p_rec=torch.from_numpy(rec["p"]),
            voxel=torch.from_numpy(rec["voxel"]),
            u_jitter=torch.from_numpy(uj))
        assert set(got_t) == set(want_t)
        for k in want_t:
            np.testing.assert_allclose(got_t[k].numpy(), want_t[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        for k in ("p", "d", "voxel"):
            del rec[k]
        rec.update(want_t)
    t = _port_tree(j)
    TG.splat_records(t, {k: torch.from_numpy(v) for k, v in rec.items()},
                     spatial, directional, u_jitter=torch.from_numpy(uj))
    j2 = JG.splat_records(j, {k: jnp.asarray(v) for k, v in rec.items()},
                          spatial, directional, u_jitter=jnp.asarray(uj))
    for f in ("qb_sum", "db_statw"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j2, f))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * b.max(),
                                   err_msg=f)
        assert b.max() > 0

"""The port's SD-tree read and write paths against ppg_tpu's, on the
refined trees of tests/test_packed_descent.py brought across with
ppg_tpu_torch.convert, for identical uniforms and record batches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.guiding import records as JR
from ppg_tpu.guiding import sdtree as JG
from ppg_tpu_torch.convert import sdtree_from_numpy
from ppg_tpu_torch.guiding import records as TR
from ppg_tpu_torch.guiding import sdtree as TG
from test_packed_descent import _refined_tree


def _port_tree(jtree):
    fields = {f: np.asarray(getattr(jtree, f)) for f in JG.SDTreeArrays.FIELDS}
    return sdtree_from_numpy(fields, jtree.s_depth, jtree.q_depth, "cpu")


@pytest.fixture(scope="module")
def trees():
    jtree = _refined_tree().push()
    return jtree, _port_tree(jtree)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_converted_tree_dtypes(trees):
    _, t = trees
    assert t.qs_sum.dtype == torch.float32 and t.s_child.dtype == torch.int32
    assert t.aabb_size.dtype == torch.float32 and t.s_depth >= 8


def test_lookup_and_dtree_meta_match(trees):
    j, t = trees
    rng = np.random.default_rng(7)
    p = (rng.random((3000, 3)) * 2.2 - 0.1).astype(np.float32)
    jid, jvox = JG.lookup(j, jnp.asarray(p))
    tid, tvox = TG.lookup(t, torch.from_numpy(p))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tvox.numpy(), np.asarray(jvox))
    assert len(np.unique(tid.numpy())) > 20  # a refined spatial tree
    ids = np.where(rng.random(3000) < 0.1, -1, np.asarray(jid)).astype(
        np.int32)
    for a, b in zip(TG.dtree_meta(t, torch.from_numpy(ids)),
                    JG.dtree_meta(j, jnp.asarray(ids))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_sample_pdf_dir_matches(trees):
    """The walk equals ppg_tpu's exactly: the same pdf bits on every lane,
    and on the sampling lanes the same canonical point (ppg_tpu's
    canonical_to_dir of the port's point gives ppg_tpu's directions bit
    for bit). The port adds a node's four sums in a fixed order, ((s0 +
    s1) + s2) + s3, which is also XLA's on the CPU. The port's own
    directions are held within 1e-5: its canonical_to_dir takes
    PyTorch's sin, cos and sqrt, which may round otherwise than XLA's."""
    j, t = trees
    rng = np.random.default_rng(11)
    L = 4096
    p = (rng.random((L, 3)) * 2.0).astype(np.float32)
    dtree_id = np.array(JG.lookup(j, jnp.asarray(p))[0])
    u = rng.random((L, JG.MAX_Q_DEPTH + 2)).astype(np.float32)
    is_point = rng.random(L) < 0.5
    d_pt = _unit(rng, L)
    jroot, juni, _ = JG.dtree_meta(j, jnp.asarray(dtree_id))
    jd, jpdf = JG.sample_pdf_dir(j, jnp.asarray(dtree_id), jnp.asarray(u),
                                 jnp.asarray(is_point),
                                 JG.dir_to_canonical(jnp.asarray(d_pt)),
                                 root=jroot, uniform=juni)
    tid = torch.from_numpy(dtree_id)
    troot, tuni, _ = TG.dtree_meta(t, tid)
    args = (t, torch.from_numpy(u), torch.from_numpy(is_point),
            TG.dir_to_canonical(torch.from_numpy(d_pt)), troot, tuni)
    td, tpdf = TG.sample_pdf_dir(*args)
    np.testing.assert_array_equal(tpdf.numpy(), np.asarray(jpdf))
    sel = ~is_point  # directions are only drawn on the sampling lanes
    pfin = TG.sample_pdf_canonical_plain(*args)[0].numpy()
    np.testing.assert_array_equal(
        np.asarray(JG.canonical_to_dir(jnp.asarray(pfin)))[sel],
        np.asarray(jd)[sel])
    np.testing.assert_allclose(td.numpy()[sel], np.asarray(jd)[sel],
                               rtol=1e-5, atol=1e-6)
    assert len(np.unique(tpdf.numpy())) > 100  # non-uniform quadtrees


def test_lookup_meta_matches_composition_and_ppg_tpu(trees):
    """lookup_meta's plain version is lookup, the mask, dtree_meta and
    sampling_fraction composed, and equals ppg_tpu's lookup + dtree_meta
    on the masked ids: ids, voxels, roots and uniform flags exactly, the
    fraction within 1e-6 (XLA's and PyTorch's CPU sigmoid)."""
    j, t = trees
    rng = np.random.default_rng(29)
    L = 3000
    p = (rng.random((L, 3)) * 2.2 - 0.1).astype(np.float32)
    mask = rng.random(L) < 0.7
    t = _port_tree(j)
    t.opt_var = torch.from_numpy(
        rng.normal(size=t.opt_var.shape).astype(np.float32) * 4)
    got = TG.lookup_meta(t, torch.from_numpy(p), torch.from_numpy(mask))
    tid, tvox = TG.lookup(t, torch.from_numpy(p))
    tid = torch.where(torch.from_numpy(mask), tid, -1)
    want = (tid, tvox, *TG.dtree_meta(t, tid))
    assert torch.equal(want[4], TG.sampling_fraction(t, tid))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    jid, jvox = JG.lookup(j, jnp.asarray(p))
    jid = jnp.where(jnp.asarray(mask), jid, -1)
    var = jnp.asarray(t.opt_var.numpy())
    fields = {f: getattr(j, f) for f in JG.SDTreeArrays.FIELDS}
    fields.update(opt_var=var, d_meta=j.d_meta.at[:, 3].set(var))
    jmeta = JG.dtree_meta(JG.SDTreeArrays(j.s_depth, j.q_depth, **fields),
                          jid)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jid))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jvox))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jmeta[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(jmeta[1]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(jmeta[2]),
                               rtol=1e-6)
    assert (got[0].numpy() == -1).sum() > 500 and not got[3].numpy().all()
    assert len(np.unique(got[4].numpy())) > 20


def _records(rng, N, with_pd, tree):
    rec = dict(
        radiance=rng.random(N).astype(np.float32),
        product=rng.random(N).astype(np.float32),
        wo_pdf=(rng.random(N) + 0.05).astype(np.float32),
        bsdf_pdf=rng.random(N).astype(np.float32),
        dtree_pdf=rng.random(N).astype(np.float32),
        stat_weight=np.ones(N, np.float32),
        is_delta=rng.random(N) < 0.05,
        valid=rng.random(N) < 0.8,
    )
    p = (rng.random((N, 3)) * 2.0).astype(np.float32)
    d = _unit(rng, N)
    if with_pd:
        rec.update(p=p, d=d)
    else:  # shade-time targets, as ppg_tpu's tracer precomputes them
        sp_id = np.asarray(JG.lookup(tree, jnp.asarray(p))[0])
        sp_id = np.maximum(np.where(rec["valid"], sp_id, 0), 0)
        node, quad, _ = JG.descend_cell_packed(
            tree.qb_pack2, tree.db_root[sp_id],
            JG.dir_to_canonical(jnp.asarray(d)), None, tree.q_depth)
        rec.update(sp_id=sp_id.astype(np.int32),
                   cell=np.asarray(node * 4 + quad).astype(np.int32))
    return rec, d


@pytest.mark.parametrize("path", ["fast", "lookup"])
def test_splat_records_nearest_matches(trees, path):
    """Building-tree sums agree to f32 summation-order tolerance: ppg_tpu
    sums each bin with a compensated prefix sum, the port with index_add_
    in record order; every bin then differs by a few f32 roundings of its
    own total, bounded here by 1e-5 relative plus 1e-5 of the largest
    bin."""
    j, _ = trees
    rng = np.random.default_rng(17)
    rec, _ = _records(rng, 20000, path == "lookup", j)
    t = _port_tree(j)  # fresh copy: the port splats in place
    TG.splat_records(t, {k: torch.from_numpy(v) for k, v in rec.items()})
    j2 = JG.splat_records(j, {k: jnp.asarray(v) for k, v in rec.items()})
    for f in ("qb_sum", "db_statw"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j2, f))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * b.max(),
                                   err_msg=f)
        assert b.max() > 0


def test_shade_time_targets_match(trees):
    j, t = trees
    rng = np.random.default_rng(19)
    N = 4000
    p = (rng.random((N, 3)) * 2.0).astype(np.float32)
    d = _unit(rng, N)
    valid = rng.random(N) < 0.9
    dtree_id = np.array(JG.lookup(j, jnp.asarray(p))[0])
    got = TG.splat_targets(t, torch.from_numpy(dtree_id),
                           torch.from_numpy(d), torch.from_numpy(valid))
    sp, cell = got["sp_id"], got["cell"]
    sp_j = np.maximum(np.where(valid, dtree_id, 0), 0)
    node, quad, _ = JG.descend_cell_packed(
        j.qb_pack2, j.db_root[sp_j], JG.dir_to_canonical(jnp.asarray(d)),
        None, j.q_depth)
    np.testing.assert_array_equal(sp.numpy(), sp_j)
    np.testing.assert_array_equal(cell.numpy(), np.asarray(node * 4 + quad))


def test_vertex_records_match():
    rng = np.random.default_rng(23)
    J, L = 5, 700
    vert = dict(
        throughput=rng.random((J, L, 3)).astype(np.float32) * 2,
        bsdf_val=rng.random((J, L, 3)).astype(np.float32),
        radiance=rng.random((J, L, 3)).astype(np.float32),
        wo_pdf=rng.random((J, L)).astype(np.float32),
        bsdf_pdf=rng.random((J, L)).astype(np.float32),
        dtree_pdf=rng.random((J, L)).astype(np.float32),
        is_delta=rng.random((J, L)) < 0.1,
        valid=rng.random((J, L)) < 0.7,
        sp_id=rng.integers(0, 9, (J, L)).astype(np.int32),
        cell=rng.integers(0, 99, (J, L)).astype(np.int32),
    )
    vert["throughput"][0, :10] = 1e-9  # the Epsilon guard
    vert["radiance"][1, :5, 0] = np.inf  # non-finite records drop
    got = TR.vertex_records({k: torch.from_numpy(v) for k, v in vert.items()},
                            1.0)
    want = JR.vertex_records({k: jnp.asarray(v) for k, v in vert.items()},
                             1.0)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)

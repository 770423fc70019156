"""The port's learned bsdf sampling fraction (Adam on the KL / variance
loss, ppg_tpu's _adam_chain) against ppg_tpu's, and against the exact
per-record reference chain of tests/test_estimator_oracle.py, for
identical record streams.

Tolerances: both sides run the same float32 operations, but the 62-bucket
sums and the sums over records are taken in another order (index_add_ in
record order against XLA's reduction trees and compensated prefix sums),
and PyTorch's CPU pow / sigmoid may round a last bit differently. Over a
64-round chain these differences stay near 1e-6 relative; 1e-4 relative
on every opt_* field leaves room for them and nothing else."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.guiding import sdtree as JG
from ppg_tpu.ops import reduce as JRed
from ppg_tpu_torch.convert import sdtree_from_numpy
from ppg_tpu_torch.guiding import sdtree as TG
from ppg_tpu_torch.ops import reduce as TRed
from test_estimator_oracle import (_adam_oracle_true_cadence, _adam_records,
                                   _device_adam_chunks)
from test_guiding import fresh
from test_packed_descent import _refined_tree

OPT = ("opt_var", "opt_m1", "opt_m2", "opt_iter", "opt_bgrad", "opt_bweight")


def _port_tree(jtree):
    fields = {f: np.asarray(getattr(jtree, f)) for f in JG.SDTreeArrays.FIELDS}
    return sdtree_from_numpy(fields, jtree.s_depth, jtree.q_depth, "cpu")


def _assert_opt_close(t, j, rtol=1e-4):
    for f in OPT:
        a = getattr(t, f).numpy()
        b = np.asarray(getattr(j, f))[:len(a)]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(
            np.abs(b).max(), 1e-30), err_msg=f)


def test_bincount_add2_matches():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 50, 5000).astype(np.int32)
    a = rng.normal(size=5000).astype(np.float32)
    b = rng.random(5000).astype(np.float32)
    base = [rng.random(50).astype(np.float32) for _ in range(2)]
    got = TRed.bincount_add2(tuple(torch.from_numpy(x.copy()) for x in base),
                             torch.from_numpy(idx), torch.from_numpy(a),
                             torch.from_numpy(b))
    want = JRed.bincount_add2(tuple(jnp.asarray(x) for x in base),
                              jnp.asarray(idx), jnp.asarray(a),
                              jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_bucket_centres_and_indices_match():
    """The bucket centres are equal. Bucket indices may differ where
    log10 rounds differently at a bucket boundary: at most 1e-3 of the
    records, and then only into the neighbouring bucket."""
    np.testing.assert_array_equal(TG._ADAM_CHAT.numpy(), JG._ADAM_CHAT)
    rng = np.random.default_rng(4)
    c = np.concatenate([10.0 ** rng.uniform(-4, 4.5, 20000),
                        -1.0 - 10.0 ** rng.uniform(-4, 4.5, 20000),
                        rng.uniform(-1.0, 0.0, 2000)]).astype(np.float32)
    got = TG._adam_bucket_index(torch.from_numpy(c)).numpy()
    want = np.asarray(JG._adam_bucket_index(jnp.asarray(c)))
    diff = got != want
    assert diff.mean() <= 1e-3
    assert (np.abs(got - want)[diff] == 1).all()
    assert len(np.unique(want)) == JG.ADAM_B


def _batch(rs, ids=None):
    n = len(rs)
    arr = lambda i: np.asarray([r[i] for r in rs], np.float32)
    return dict(
        dtree_id=np.zeros(n, np.int32) if ids is None else ids,
        product=arr(0), wo_pdf=arr(1), bsdf_pdf=arr(2), dtree_pdf=arr(3),
        stat_w=arr(4), valid_e=np.ones(n, bool))


def _chain_both(t, j, batch, loss):
    new_t = TG._adam_chain(t, *(torch.from_numpy(batch[k]) for k in (
        "dtree_id", "product", "wo_pdf", "bsdf_pdf", "dtree_pdf", "stat_w",
        "valid_e")), loss)
    new_j = JG._adam_chain(j, *(jnp.asarray(batch[k]) for k in (
        "dtree_id", "product", "wo_pdf", "bsdf_pdf", "dtree_pdf", "stat_w",
        "valid_e")), loss)
    for f, a, b in zip(OPT, new_t, new_j):
        setattr(t, f, a)
        setattr(j, f, b)


@pytest.mark.parametrize("loss", ["kl", "var"])
def test_adam_chain_matches_on_oracle_records(loss):
    """tests/test_estimator_oracle's 24 records, one batch, one leaf."""
    j = fresh().push()
    t = _port_tree(j)
    _chain_both(t, j, _batch(_adam_records(n=24)), loss)
    _assert_opt_close(t, j)
    assert float(t.opt_var[0]) != 0.0 and int(t.opt_iter[0]) == 12


@pytest.mark.parametrize("loss", ["kl", "var"])
def test_adam_chain_matches_on_long_stream(loss):
    """A 2000-record stream in batches of 400 (as _device_adam_chunks),
    with the leaf state carried from batch to batch on each side."""
    rng = np.random.default_rng(3)
    recs = [(float(rng.uniform(0.5, 2.0)), float(rng.uniform(0.3, 1.5)),
             float(rng.uniform(0.6, 1.4)), float(rng.uniform(0.02, 0.4)),
             1.0) for _ in range(2000)]
    j = fresh().push()
    t = _port_tree(j)
    for i in range(0, 2000, 400):
        _chain_both(t, j, _batch(recs[i:i + 400]), loss)
        _assert_opt_close(t, j)
    assert abs(float(torch.sigmoid(t.opt_var[0])) - 0.5) > 0.3


@pytest.fixture(scope="module")
def jtree():
    return _refined_tree().push()


def test_adam_chain_matches_over_many_leaves(jtree):
    """Records spread over the leaves of a refined tree with mixed signs
    of bsdfPdf - dTreePdf, invalid records and fractional weights."""
    j = jtree
    t = _port_tree(j)
    rng = np.random.default_rng(8)
    T = int((np.asarray(j.s_dtree) >= 0).sum())
    for _ in range(3):
        n = 5000
        batch = dict(
            dtree_id=rng.integers(0, T, n).astype(np.int32),
            product=(rng.random(n) * (rng.random(n) < 0.9)).astype(
                np.float32),
            wo_pdf=(rng.random(n) + 0.05).astype(np.float32),
            bsdf_pdf=rng.random(n).astype(np.float32),
            dtree_pdf=rng.random(n).astype(np.float32),
            stat_w=rng.choice([0.5, 1.0], n).astype(np.float32),
            valid_e=rng.random(n) < 0.9)
        _chain_both(t, j, batch, "kl")
        _assert_opt_close(t, j)
    assert (t.opt_iter.numpy()[:T] > 0).mean() > 0.9


@pytest.mark.parametrize("loss,rp", [("kl", 1.0), ("var", 2.0)])
def test_adam_long_stream_tracks_reference(loss, rp):
    """The port's fraction after the stream lands as close to the exact
    reference chain as ppg_tpu's (within 0.02 in fraction space, the
    bound of test_estimator_oracle.test_adam_long_stream_tracks_reference)
    and within 1e-4 of ppg_tpu's own."""
    rng = np.random.default_rng(3)
    up = [(float(rng.uniform(0.5, 2.0)), float(rng.uniform(0.3, 1.5)),
           float(rng.uniform(0.6, 1.4)), float(rng.uniform(0.02, 0.4)), 1.0)
          for _ in range(2000)]
    down = [(p, w, dp, bp, sw) for (p, w, bp, dp, sw) in up]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    for recs in (up, down):
        ref = sig(_adam_oracle_true_cadence(recs, ratio_power=rp))
        jax_f = sig(_device_adam_chunks(recs, loss))
        t = _port_tree(fresh().push())
        for i in range(0, len(recs), 400):
            b = _batch(recs[i:i + 400])
            TG.splat_records(t, dict(
                radiance=torch.ones(len(b["product"])),
                product=torch.from_numpy(b["product"]),
                wo_pdf=torch.from_numpy(b["wo_pdf"]),
                bsdf_pdf=torch.from_numpy(b["bsdf_pdf"]),
                dtree_pdf=torch.from_numpy(b["dtree_pdf"]),
                stat_weight=torch.from_numpy(b["stat_w"]),
                is_delta=torch.zeros(len(b["product"]), dtype=torch.bool),
                valid=torch.ones(len(b["product"]), dtype=torch.bool),
                p=torch.full((len(b["product"]), 3), 0.5),
                d=torch.tensor([[0.0, 0.0, 1.0]]).repeat(len(b["product"]),
                                                         1)),
                learn_fraction=loss)
        port_f = sig(float(t.opt_var[0]))
        assert abs(port_f - ref) < 0.02, (loss, port_f, ref)
        assert abs(port_f - jax_f) < 1e-4, (loss, port_f, jax_f)
        assert abs(ref - 0.5) > 0.3


def test_splat_box_spatial_with_learned_fraction_matches(jtree):
    """The spatial box filter spreads each record over up to 16 leaves
    with fractional weights before Adam; the port drops the (record, leaf)
    pairs without weight first, which changes only summation order."""
    j = jtree
    t = _port_tree(j)
    rng = np.random.default_rng(21)
    N = 3000
    p = (rng.random((N, 3)) * 2.0).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rec = dict(
        radiance=rng.random(N).astype(np.float32),
        product=rng.random(N).astype(np.float32),
        wo_pdf=(rng.random(N) + 0.05).astype(np.float32),
        bsdf_pdf=rng.random(N).astype(np.float32),
        dtree_pdf=rng.random(N).astype(np.float32),
        stat_weight=np.full(N, 0.5, np.float32),
        is_delta=rng.random(N) < 0.05,
        valid=rng.random(N) < 0.8,
        p=p, d=d, voxel=np.asarray(JG.lookup(j, jnp.asarray(p))[1]))
    TG.splat_records(t, {k: torch.from_numpy(v) for k, v in rec.items()},
                     "box", "box", "var")
    j2 = JG.splat_records(j, {k: jnp.asarray(v) for k, v in rec.items()},
                          "box", "box", "var")
    _assert_opt_close(t, j2)
    for f in ("qb_sum", "db_statw"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j2, f))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * b.max(),
                                   err_msg=f)
    assert (t.opt_iter.numpy() > 0).sum() > 10

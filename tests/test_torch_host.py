"""The port's copy of the host SD-tree (ppg_tpu_torch/guiding/host.py)
against ppg_tpu's HostSDTree: both go through the same sequence of
refine_and_reset, push, pull of identical accumulated sums, and build,
and every array they push must be equal (ppg_tpu pads its arrays to
fixed capacities; the port does not, so the comparison covers the
port's length)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.guiding.host import HostSDTree as JHost
from ppg_tpu_torch.guiding.host import HostSDTree as THost
from ppg_tpu_torch.guiding.sdtree import SDTreeArrays

OPT = ("opt_var", "opt_m1", "opt_m2", "opt_iter", "opt_bgrad", "opt_bweight")


def _assert_pushed_equal(tp, jp):
    assert (tp.s_depth, tp.q_depth) == (jp.s_depth, jp.q_depth)
    for f in SDTreeArrays.FIELDS:
        a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        np.testing.assert_array_equal(a, b[:len(a)] if a.ndim else b,
                                      err_msg=f)


@pytest.mark.parametrize("threshold", [100, 500])
@pytest.mark.parametrize("adam", [False, True])
def test_host_tree_sequence_matches(threshold, adam):
    """With adam, the pulled trees also carry non-zero Adam state (the
    learned fraction's variable, moments, step count and carried batch
    remainder), which refine must hand to both children of a split leaf
    in both host trees alike."""
    rng = np.random.default_rng(threshold)
    th = THost(np.zeros(3, np.float32), 2.0)
    jh = JHost(np.zeros(3, np.float32), 2.0)
    for it in range(4):
        th.refine_and_reset(it, 4, threshold, 0.01, -1)
        jh.refine_and_reset(it, 4, threshold, 0.01, -1)
        tp, jp = th.push("cpu"), jh.push()
        _assert_pushed_equal(tp, jp)
        # one pass worth of accumulation, identical for both trees
        n_nodes, n_trees = tp.qb_sum.shape[0], tp.db_statw.shape[0]
        qb = (rng.random((n_nodes, 4)) ** 4 * 10).astype(np.float32)
        sw = (rng.random(n_trees) * 32000.0 / n_trees).astype(np.float32)
        tp.qb_sum[:] = torch.from_numpy(qb)
        tp.db_statw[:] = torch.from_numpy(sw)
        jp.qb_sum = jp.qb_sum.at[:n_nodes].set(jnp.asarray(qb))
        jp.db_statw = jp.db_statw.at[:n_trees].set(jnp.asarray(sw))
        if adam:
            for f in OPT:
                a = getattr(tp, f)
                v = (rng.integers(0, 500, n_trees) if f == "opt_iter" else
                     rng.normal(size=n_trees) * (it + 1))
                setattr(tp, f, torch.from_numpy(v.astype(a.numpy().dtype)))
                setattr(jp, f, getattr(jp, f).at[:n_trees].set(
                    jnp.asarray(v, getattr(jp, f).dtype)))
        th.pull(tp)
        jh.pull(jp)
        th.build()
        jh.build()
        _assert_pushed_equal(th.push("cpu"), jh.push())
        assert th.distribution_stats() == jh.distribution_stats()
    assert th.num_dtrees > 8  # the spatial tree did refine
    th.refine_and_reset(4, 4, threshold, 0.01, -1)
    jh.refine_and_reset(4, 4, threshold, 0.01, -1)
    tp = th.push("cpu")
    _assert_pushed_equal(tp, jh.push())
    if adam:  # the state survived every refine and build
        assert (tp.opt_var.numpy() != 0).all()

"""K5's accumulation on the CPU: ppg_tpu_torch/ops/reduce.py (bincount_add,
bincount_add2) and the kernel source csrc/reduce.cu.

- The plain version (bincount_add_plain, which bincount_add runs on CPU
  tensors) against ppg_tpu's sort-and-compensated-prefix-sum bincount_add
  and bincount_add2 on tests/test_reduce.py's two shapes. Both are held
  against the exact sum (math.fsum): the port within the bound that
  csrc/reduce.cu states (tools/reduce_cases.exact_and_bound), ppg_tpu
  within test_reduce.py's own tolerances; and the two within 1e-6
  relative of each other on every bin, since each rounds a sum accurate
  far beyond float32 once to float32, so they differ by an ulp at most
  (1.2e-7 relative).
- The plain version on tools/reduce_cases' cases: within the bound, each
  case's own property, and bit-identical under a permutation of the
  records.
- The kernel source compiled for the CPU (tools/cuda_shim.build_host)
  equal to the plain version bit for bit on every case, with one stream
  and with two, its scratch left zero. Two NaNs count as equal whatever
  their payloads.
- splat_records with each spatial filter and both losses against
  ppg_tpu's, within the tolerances of test_torch_filters.py (the
  building pools) and test_torch_adam.py (the Adam state).
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.guiding import sdtree as JG
from ppg_tpu.ops import reduce as JRed
from ppg_tpu_torch.guiding import sdtree as TG
from ppg_tpu_torch.native import CSRC
from ppg_tpu_torch.ops import reduce as TRed
from ppg_tpu_torch.tools import cuda_shim
from ppg_tpu_torch.tools import reduce_cases as C
from test_packed_descent import _refined_tree
from test_torch_adam import _assert_opt_close
from test_torch_filters import _port_tree, _records

t_ = torch.from_numpy


def _same(a, b):
    """Bit for bit, two NaNs equal."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).sum())


def _plain(target, idx, val):
    return TRed.bincount_add(t_(target.copy()), t_(idx), t_(val)).numpy()


def _within_bound(got, target, idx, val):
    exact, bound = C.exact_and_bound(target, idx, val)
    fin = np.isfinite(exact) & np.isfinite(got)
    err = np.abs(got.astype(np.float64) - exact)
    assert (err[fin] <= bound[fin]).all(), (err / bound)[fin].max()
    return exact


def test_plain_matches_ppg_tpu_small():
    """test_reduce.py's 17 bins and 1,000 records, one and two streams."""
    rng = np.random.default_rng(0)
    m, n = 17, 1000
    idx = rng.integers(0, m, n).astype(np.int32)
    val = rng.uniform(-1, 1, n).astype(np.float32)
    base = [np.ones(m, np.float32), np.zeros(m, np.float32)]
    got = TRed.bincount_add2(tuple(t_(b.copy()) for b in base), t_(idx),
                             t_(val), t_(np.abs(val)))
    want = JRed.bincount_add2(tuple(jnp.asarray(b) for b in base),
                              jnp.asarray(idx), jnp.asarray(val),
                              jnp.asarray(np.abs(val)))
    for g, w, b, v in zip(got, want, base, (val, np.abs(val))):
        g, w = g.numpy(), np.asarray(w)
        exact = _within_bound(g, b, idx, v)
        np.testing.assert_allclose(w, exact, atol=1e-4)
        np.testing.assert_allclose(g, w, rtol=1e-6)
        _same(g, _plain(b, idx, v))


def test_plain_matches_ppg_tpu_heavy_bins_and_tail():
    """test_reduce.py's 2^22 records: heavy bins first, 1e-6 bins last.
    Every bin, the tail's included, within the bound of the exact sum
    and none negative."""
    rng = np.random.default_rng(1)
    n, m = 1 << 22, 512
    idx = rng.integers(0, m, n).astype(np.int32)
    val = np.where(idx < 8, rng.uniform(0.5, 2.0, n),
                   rng.uniform(0.0, 1e-6, n)).astype(np.float32)
    target = np.zeros(m, np.float32)
    got = _plain(target, idx, val)
    want = np.asarray(JRed.bincount_add(jnp.zeros(m), jnp.asarray(idx),
                                        jnp.asarray(val)))
    exact = _within_bound(got, target, idx, val)
    assert (got >= 0).all() and (want >= 0).all()
    np.testing.assert_allclose(want, exact, rtol=1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[8:].max() < 1e-2 < got[:8].min()


@pytest.mark.parametrize("name", C.CASES)
def test_plain_within_its_bound(name):
    target, idx, val = C.case(name)
    _within_bound(_plain(target, idx, val), target, idx, val)


@pytest.mark.parametrize("name", C.CASES)
def test_plain_is_order_free(name):
    """The same records in another order give the same bits."""
    target, idx, val = C.case(name)
    perm = np.random.default_rng(5).permutation(len(idx))
    _same(_plain(target, idx, val), _plain(target, idx[perm], val[perm]))


def test_zero_values_touch_no_cell():
    """Cells 0-4 get only zeros (of both signs): their targets, -0.0 and
    a NaN among them, keep every bit."""
    target, idx, val = C.case("zeros")
    got = _plain(target, idx, val)
    _same(got[:5], target[:5])
    assert (got[5:] != 0).all()


def test_nonfinite_value_stays_in_its_cell():
    """Cells 1-5 get target + the IEEE sum of their non-finite values;
    every other cell is what it is without the non-finite records."""
    target, idx, val = C.case("nonfinite")
    got = _plain(target, idx, val)
    assert np.isnan(got[1]) and np.isnan(got[4]) and np.isnan(got[5])
    assert got[2] == np.inf and got[3] == -np.inf
    fin = np.isfinite(val)
    clean = _plain(target, idx[fin], val[fin])
    others = np.r_[0, 6:len(target)]
    _same(got[others], clean[others])


def test_extremes_subnormal_sums_exact_and_overflow_to_inf():
    target, idx, val = C.case("extremes")
    got = _plain(target, idx, val)
    exact, _ = C.exact_and_bound(target, idx, val)
    # subnormal values quantise exactly: the sums are the exact ones
    assert (np.abs(val[idx < 4]) < np.finfo(np.float32).tiny).all()
    assert (got[:4] == exact[:4].astype(np.float32)).all()
    assert got[4] == np.inf  # 2 FLT_MAX leaves float32
    assert got[5] == np.float32(C.FLT_MAX / 2)
    assert np.isfinite(got[6]) and got[6] > 0.1 * C.FLT_MAX


def test_cancellation_keeps_the_small_values():
    """Pairs +-x up to 1e8 cancel; what is left is the 1e-3 values, which
    a float32 running sum would bury under its roundings of 1e8 (an ulp
    of 8), and which the port holds within 1e-4 relative."""
    target, idx, val = C.case("cancel")
    got = _plain(target, idx, val)
    exact = _within_bound(got, target, idx, val)
    np.testing.assert_allclose(got, exact, rtol=1e-4)
    assert np.abs(exact).max() < 0.05


def test_one_cell_takes_every_record():
    target, idx, val = C.case("one_cell")
    got = _plain(target, idx, val)
    exact = _within_bound(got, target, idx, val)
    assert (got[np.r_[0:3, 4:8]] == 0).all() and got[3] == np.float32(
        exact[3])


@pytest.mark.parametrize("bad,value", [(-1, 0.0), (17, 0.0), (17, 2.5),
                                       (1 << 40, 1.0)])
def test_plain_refuses_an_index_outside_the_cells(bad, value):
    """As index_add_ does, for a zero value too (the kernel checks every
    record): an index outside [0, M) raises and changes no target."""
    target = torch.ones(17)
    idx = torch.tensor([0, 3, bad, 5])
    val = torch.tensor([1.0, 2.0, value, 4.0])
    with pytest.raises(IndexError):
        TRed.bincount_add_plain(target, idx, val)
    assert (target == 1).all()


@pytest.fixture(scope="module")
def k5_host(tmp_path_factory):
    """csrc/reduce.cu built for the CPU; run(targets, idx, vals) adds in
    place through ppg_reduce_add with a scratch of its own (a larger
    capacity than M, so stream 1's scratch sits apart) and checks that the
    launches leave it zero; run.lib is the library."""
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    lib = cuda_shim.build_host(os.path.join(CSRC, "reduce.cu"),
                               str(tmp_path_factory.mktemp("reduce_host")),
                               "reduce_host", launches=5)
    lib.ppg_reduce_add.argtypes = TRed.ARGTYPES
    lib.ppg_reduce_add.restype = ctypes.c_int
    lib.ppg_reduce_path.argtypes = TRed.PATH_ARGTYPES
    lib.ppg_reduce_path.restype = ctypes.c_int
    scratch = {}

    def run(targets, idx, vals, ok=True):
        """With ok=False the launches must fail; the scratch is then
        made anew."""
        M = targets[0].shape[0]
        cap = max(M + 5, scratch.get("cap", 0))
        if scratch.get("cap") != cap:
            scratch.update(cap=cap, acc=torch.zeros(2 * cap,
                                                    dtype=torch.int64),
                           meta=torch.zeros((3, 2 * cap), dtype=torch.int32))
        acc, meta = scratch["acc"], scratch["meta"]
        two = len(targets) == 2
        err = lib.ppg_reduce_add(
            idx.data_ptr(), int(idx.dtype == torch.int64), idx.shape[0], M,
            len(targets), targets[0].data_ptr(), vals[0].data_ptr(),
            targets[1].data_ptr() if two else None,
            vals[1].data_ptr() if two else None, acc.data_ptr(),
            meta[0].data_ptr(), meta[1].data_ptr(), meta[2].data_ptr(), cap,
            0, None)
        if not ok:
            assert err != 0
            scratch.clear()
            return targets
        assert err == 0
        assert not acc.any() and not meta.any()
        return targets

    run.lib = lib
    return run


@pytest.mark.parametrize("name", C.CASES)
def test_kernel_source_compiled_for_the_cpu_equals_the_plain_sum(k5_host,
                                                                  name):
    """One stream, then two (bincount_add2: the values and their halves
    with the sign flipped, into a second target), bit for bit."""
    target, idx, val = C.case(name)
    want = _plain(target, idx, val)
    got = k5_host((t_(target.copy()),), t_(idx), (t_(val),))[0]
    _same(got, want)
    val_b = (-0.5 * val).astype(np.float32)
    got2 = k5_host((t_(target.copy()), t_(target[::-1].copy())), t_(idx),
                   (t_(val), t_(val_b)))
    _same(got2[0], want)
    _same(got2[1], _plain(target[::-1].copy(), idx, val_b))


@pytest.mark.parametrize("bad", [-1, 40])
def test_kernel_source_traps_on_an_index_outside_the_cells(k5_host, bad):
    """An index outside [0, M), even with a zero value, ends the launch
    with an error (on the card, the kernel's __trap), as index_add_'s
    device assertion does, where a skipped record would lose its mass
    without a word."""
    idx = np.arange(600, dtype=np.int32) % 40
    idx[517] = bad
    val = np.ones(600, dtype=np.float32)
    val[517] = 0.0
    k5_host((t_(np.zeros(40, np.float32)),), t_(idx), (t_(val),), ok=False)


@pytest.mark.parametrize("M,N", [(30000, 600), (20000, 3000)])
def test_kernel_source_traps_on_the_global_path(k5_host, M, N):
    """The global path's trap (cells above what a block's shared memory
    holds), with few records and with more."""
    idx = np.arange(N, dtype=np.int32) * 7 % M
    idx[N // 2] = M
    k5_host((t_(np.zeros(M, np.float32)),), t_(idx),
            (t_(np.ones(N, np.float32)),), ok=False)


@pytest.mark.parametrize("name", C.CASES)
def test_kernel_source_takes_the_path_of_its_size(k5_host, name):
    """Which path (ppg_reduce_path) each case takes with one stream and
    with two, so that the cases cover both: shared where cells x streams
    fit in a block's shared memory (16,384 slots), else global."""
    target, _, _ = C.case(name)
    got = [TRed.path(len(target), n, lib=k5_host.lib) for n in (1, 2)]
    want = {"wide": ["global", "global"], "sparse": ["global", "global"],
            "split": ["shared", "global"]}.get(name, ["shared", "shared"])
    assert got == want


def test_kernel_source_shares_its_scratch_between_calls(k5_host):
    """Calls of other sizes and both paths one after another on one
    scratch: each equals its plain sum, so each leaves the scratch as it
    found it."""
    rng = np.random.default_rng(3)
    for M, N in ((40, 3000), (7, 500), (20000, 5000), (300, 100),
                 (17000, 100), (40, 3000)):
        target = rng.normal(size=M).astype(np.float32)
        idx = rng.integers(0, M, N).astype(np.int32)
        val = (rng.normal(size=N) * (rng.random(N) < 0.7)).astype(np.float32)
        _same(k5_host((t_(target.copy()),), t_(idx), (t_(val),))[0],
              _plain(target, idx, val))


@pytest.fixture(scope="module")
def jtree():
    return _refined_tree().push()


@pytest.mark.parametrize("spatial,loss", [
    (s, l) for s in ("nearest", "stochastic", "box") for l in ("kl", "var")])
def test_splat_records_with_learned_fraction_matches(jtree, spatial, loss):
    """The lookup path with the learned fraction: the building pools
    within test_torch_filters' 1e-5 relative plus 1e-5 of the largest bin,
    the Adam state within test_torch_adam's 1e-4."""
    j = jtree
    directional = "nearest" if spatial == "nearest" else "box"
    rng = np.random.default_rng(sum(map(ord, spatial + loss)))
    N = 6000
    rec = _records(rng, N, j)
    rec["stat_weight"] = rng.choice([0.5, 1.0], N).astype(np.float32)
    uj = rng.random((N, 3)).astype(np.float32)
    t = _port_tree(j)
    TG.splat_records(t, {k: t_(v) for k, v in rec.items()}, spatial,
                     directional, loss, u_jitter=t_(uj))
    j2 = JG.splat_records(j, {k: jnp.asarray(v) for k, v in rec.items()},
                          spatial, directional, loss,
                          u_jitter=jnp.asarray(uj))
    for f in ("qb_sum", "db_statw"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j2, f))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * b.max(),
                                   err_msg=f)
        assert b.max() > 0
    _assert_opt_close(t, j2)
    assert (t.opt_iter.numpy() > 0).sum() > 10

"""K7, the box film splat, on the CPU: ppg_tpu_torch/render/film.py
(Film.splat_box_linear, splat_box_linear_plain) and the kernel source
csrc/film.cu.

- The plain splat of the values and, into the squared-film buffers, of
  their squares against ppg_tpu's Film.splat_box_linear called twice (the
  values, then their squares), bit for bit: both round each square once
  and add each pixel's value with one float32 add. The values there keep
  their squares normal, since XLA on the CPU flushes subnormals to zero;
  the kernel test below has subnormal squares too.
- The kernel source compiled for the CPU (tools/cuda_shim.build_host)
  against the plain splat, bit for bit, with one pair of buffers and
  with two, at several chunk offsets.
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.render import film as JF
from ppg_tpu_torch.native import CSRC
from ppg_tpu_torch.render import film as TF
from ppg_tpu_torch.tools import cuda_shim

W, H, CHUNK = 23, 11, 64  # 253 pixels, padded to 4 chunks of 64


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _chunks(rng, lo=-20):
    """(start, values [C,3], valid [C]) per chunk: values of both signs
    and magnitudes from 10^lo to 1e15 (from 1e-20, some squares are
    subnormal), NaN and inf on invalid lanes, the padding past W * H
    invalid."""
    out = []
    for start in range(0, 4 * CHUNK, CHUNK):
        vals = (rng.normal(size=(CHUNK, 3))
                * 10.0 ** rng.uniform(lo, 15, (CHUNK, 1))).astype(np.float32)
        valid = (rng.random(CHUNK) < 0.9) & (
            start + np.arange(CHUNK) < W * H)
        vals[~valid & (rng.random(CHUNK) < 0.5)] = np.nan
        vals[~valid & (rng.random(CHUNK) < 0.3), 1] = np.inf
        out.append((start, vals, valid))
    return out


def test_plain_splat_of_both_buffers_equals_ppg_tpu_called_twice():
    rng = np.random.default_rng(4)
    tf, jf = TF.Film(W, H, "box", "cpu"), JF.Film(W, H, "box")
    tb, tsq = tf.zeros_flat(CHUNK), tf.zeros_flat(CHUNK)
    jb, jsq = jf.zeros_flat(CHUNK), jf.zeros_flat(CHUNK)
    for _ in range(3):  # three passes over the frame
        # no subnormal square: XLA on the CPU flushes them to zero
        for start, vals, valid in _chunks(rng, lo=-15):
            out = tf.splat_box_linear(tb, start, torch.from_numpy(vals),
                                      torch.from_numpy(valid), tsq)
            assert out is tb
            v, ok = jnp.asarray(vals), jnp.asarray(valid)
            jb = jf.splat_box_linear(jb, start, v, ok)
            jsq = jf.splat_box_linear(jsq, start, v * v, ok)
    for got, want in zip(tb + tsq, jb + jsq):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert np.isfinite(tb[0].numpy()).all() and tb[1].numpy().max() == 3


def test_film_defaults_to_the_card():
    assert TF.Film(W, H).device == "cuda"


@pytest.fixture(scope="module")
def k7_host(tmp_path_factory):
    """csrc/film.cu built for the CPU; run(buffers, start, values, valid,
    sq_buffers) splats in place through ppg_film_splat."""
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    lib = cuda_shim.build_host(os.path.join(CSRC, "film.cu"),
                               str(tmp_path_factory.mktemp("film_host")),
                               "film_host", launches=2)
    lib.ppg_film_splat.argtypes = TF.ARGTYPES
    lib.ppg_film_splat.restype = ctypes.c_int

    def run(buffers, start, values, valid, sq_buffers=None):
        rgb2, w2 = sq_buffers or (None, None)
        assert lib.ppg_film_splat(
            buffers[0].data_ptr(), buffers[1].data_ptr(),
            None if rgb2 is None else rgb2.data_ptr(),
            None if w2 is None else w2.data_ptr(), start,
            values.data_ptr(), valid.data_ptr(), values.shape[0], 0,
            None) == 0
        return buffers

    return run


@pytest.mark.parametrize("squares", [False, True])
def test_kernel_source_compiled_for_the_cpu_equals_the_plain_splat(k7_host,
                                                                   squares):
    rng = np.random.default_rng(5 + squares)
    film = TF.Film(W, H, "box", "cpu")
    got, want = film.zeros_flat(CHUNK), film.zeros_flat(CHUNK)
    got_sq, want_sq = film.zeros_flat(CHUNK), film.zeros_flat(CHUNK)
    for _ in range(2):
        for start, vals, valid in _chunks(rng):
            v, ok = torch.from_numpy(vals), torch.from_numpy(valid)
            k7_host(got, start, v, ok, got_sq if squares else None)
            TF.splat_box_linear_plain(want, start, v, ok,
                                      want_sq if squares else None)
    for a, b in zip(got + got_sq, want + want_sq):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
    assert bool(got_sq[1].any()) == squares

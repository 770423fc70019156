"""The reconstruction filters and K7s, the filter splat, on the CPU:
ppg_tpu_torch/render/film.py (filter_eval, Film.splat,
splat_filter_plain) and the kernel source csrc/film.cu
(ppg_film_splat_filter).

- filter_eval of every filter against ppg_tpu's: bit for bit where both
  use only products, sums and selects (box, tent, mitchell, catmullrom);
  within FILTER_ATOL for gaussian and lanczos, whose exp and sin are
  PyTorch's on one side and XLA's on the other (and lanczos's quotient by
  3 is a product by its reciprocal here, as ATen computes it on a card).
- splat_filter_plain against ppg_tpu's Film.splat (driver.render's calling
  convention: lanes off the film at position -100 with value 0), for the
  five filters, at W, H = 23, 11 in chunks of 64 that start at a row's
  start, mid-row and near the end (the last chunk's lanes off the film),
  film and squared film: within SUM_ULPS float32 ulps of each buffer's
  largest magnitude, since XLA adds a pixel's terms window position by
  window position into the buffer and the gather adds them neighbour by
  neighbour into a sum of its own.
- The kernel source compiled for the CPU (tools/cuda_shim.build_host)
  against splat_filter_plain: bit for bit (two NaNs equal) with the plain
  version's exp and sin patched to the C library's expf and sinf, which
  the shim's build calls, on CASES: a film narrower than the kernel's
  32 x 16 tile, films whose width and reached rows are not multiples of
  it, a one-row film (K exceeds the rows), a chunk smaller than a tile
  in a film's middle, and chunks that cover whole tiles; chunks that
  start and end mid-tile and mid-row, reached rows clipped at the film's
  top and bottom, the last chunk's lanes off the film, NaN and inf
  values. The shim fills a block's shared memory with 0xa5 bytes, so a
  staged slot read but never written differs. Within SUM_ULPS ulps
  without the patch.
- A non-finite sample reaches the same pixels in both (an inf at the
  edge pixels stays inf in the gather where ppg_tpu makes it NaN).
- A sample outside its own pixel makes the plain version raise and the
  kernel trap.
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

FILTERS = ("tent", "gaussian", "mitchell", "catmullrom", "lanczos")
W, H, C = 23, 11, 64
# chunk starts: whole chunks (the last one's lanes 253..255 off the film),
# and chunks from mid-row, one of them reaching past the film's end
STARTS = (0, 64, 128, 192, 5, 100, 230)
FILTER_ATOL = 4e-7  # a few float32 ulps of the filters' peak value, 1
SUM_ULPS = 8
# the kernel-source cases: (W, H, C, chunk starts, NaN and inf values)
CASES = {
    "23x11": (W, H, C, STARTS, False),
    "37x5": (37, 5, 50, (0, 20, 75, 160), True),
    "70x1": (70, 1, 30, (0, 25, 60), True),
    "75x21": (75, 21, 300, (40, 340, 700, 1400), True),
    "100x40 small chunk": (100, 40, 100, (1234,), False),
    "70x40 whole tiles": (70, 40, 1500, (0, 1500), True),
}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _within_ulps(got, want, ulps=SUM_ULPS):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = ulps * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _same_bits(got, want):
    """Bit for bit, two NaNs equal whatever their payloads."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), int((~same).sum())


def _chunk(rng, start, edges=True, w=W, c=C, nonfinite=False):
    """A chunk's positions on a film w pixels wide, jittered inside their
    pixels (5% of the coordinates on the pixel's far edge), and values
    (with nonfinite: NaN in every 7th lane, +inf and -inf in two
    channels of others)."""
    ids = start + np.arange(c)
    pos = np.stack([ids % w, ids // w], -1).astype(np.float32)
    jit = rng.random((c, 2)).astype(np.float32)
    if edges:
        jit[rng.random((c, 2)) < 0.05] = 1.0
    vals = (rng.normal(size=(c, 3))
            * 10.0 ** rng.uniform(-3, 3, (c, 1))).astype(np.float32)
    if nonfinite:
        vals[::7] = np.nan
        vals[3::11, 2] = np.inf
        vals[5::13, 0] = -np.inf
    return ids, pos + jit, vals


@pytest.mark.parametrize("name", ("box",) + FILTERS)
def test_filter_eval_equals_ppg_tpu(name):
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-4, 4, 4000),
                        [0.0, 1e-7, -1e-6, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0,
                         3.0, -3.0, 2.5]]).astype(np.float32)
    got = TF.filter_eval(name, torch.from_numpy(x)).numpy()
    want = np.asarray(JF.filter_eval(name, jnp.asarray(x)))
    if name in ("gaussian", "lanczos"):
        np.testing.assert_allclose(got, want, rtol=0, atol=FILTER_ATOL)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got.dtype == np.float32 and np.isfinite(got).all()


@pytest.mark.parametrize("name", FILTERS)
def test_plain_splat_equals_ppg_tpu(name):
    rng = np.random.default_rng(FILTERS.index(name))
    tf, jf = TF.Film(W, H, name, "cpu"), JF.Film(W, H, name)
    tb, tsq = tf.zeros(), tf.zeros()
    jb, jsq = jf.zeros(), jf.zeros()
    for start in STARTS:
        ids, pos, vals = _chunk(rng, start)
        out = tf.splat(tb, start, torch.from_numpy(pos),
                       torch.from_numpy(vals), tsq)
        assert out is tb
        valid = (ids < W * H)[:, None]
        jp = jnp.asarray(np.where(valid, pos, -100.0))
        jv = np.where(valid, vals, 0.0)
        jb = jf.splat(jb, jp, jnp.asarray(jv))
        jsq = jf.splat(jsq, jp, jnp.asarray(jv * jv))
    for got, want in zip(tb + tsq, jb + jsq):
        _within_ulps(got.numpy(), want)
    assert bool((tb[1] != 0).all())  # every pixel got terms


@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_nonfinite_sample_reaches_the_same_pixels(value):
    """A non-finite sample makes the same pixels non-finite in both: every
    pixel of its window on the film, zero weights included. The one
    difference, on purpose: ppg_tpu also adds 0 x value at the edge pixel
    that each of its window's off-film pixels is clamped to, which turns
    an inf there into NaN; the gather adds only the window's pixels on the
    film, so they stay inf."""
    film = TF.Film(W, H, "gaussian", "cpu")
    buf = film.zeros()
    ids = np.arange(C)
    pos = np.stack([ids % W, ids // W], -1).astype(np.float32) + 0.5
    vals = np.ones((C, 3), np.float32)
    vals[W + 1, 0] = value  # pixel (1, 1): its window spans x, y = -1..2
    film.splat(buf, 0, torch.from_numpy(pos), torch.from_numpy(vals))
    jf = JF.Film(W, H, "gaussian")
    jb = jf.splat(jf.zeros(), jnp.asarray(pos), jnp.asarray(vals))
    got, want = buf[0][..., 0].numpy(), np.asarray(jb[0])[..., 0]
    window = np.zeros((H, W), bool)
    window[:3, :3] = True
    np.testing.assert_array_equal(~np.isfinite(got), window)
    np.testing.assert_array_equal(~np.isfinite(want), window)
    if np.isnan(value):
        assert np.isnan(got[window]).all() and np.isnan(want[window]).all()
    else:
        edge = window & ((np.arange(H)[:, None] == 0)
                         | (np.arange(W)[None, :] == 0))
        assert np.isinf(got[window]).all()
        assert np.isnan(want[edge]).all()
        assert np.isinf(want[window & ~edge]).all()


def test_film_refuses_unknown_filters_and_the_box_splat():
    with pytest.raises(ValueError, match="unknown rfilter"):
        TF.Film(W, H, "sinc", "cpu")
    with pytest.raises(ValueError, match="unknown rfilter"):
        TF.filter_eval("sinc", torch.zeros(3))
    with pytest.raises(ValueError, match="splat_box_linear"):
        film = TF.Film(W, H, "box", "cpu")
        film.splat(film.zeros(), 0, torch.zeros(C, 2), torch.zeros(C, 3))


def test_plain_splat_refuses_a_sample_outside_its_pixel():
    film = TF.Film(W, H, "tent", "cpu")
    _, pos, vals = _chunk(np.random.default_rng(3), 64)
    pos[17, 1] += 1.5
    with pytest.raises(ValueError, match="outside its own pixel"):
        film.splat(film.zeros(), 64, torch.from_numpy(pos),
                   torch.from_numpy(vals))


@pytest.fixture(scope="module")
def k7s_host(tmp_path_factory):
    """csrc/film.cu built for the CPU; run(name, buffers, start, pos,
    values, sq_buffers) splats in place through ppg_film_splat_filter and
    returns its error code."""
    if cuda_shim.host_compiler() is None:
        pytest.skip("needs a C++ compiler")
    lib = cuda_shim.build_host(os.path.join(CSRC, "film.cu"),
                               str(tmp_path_factory.mktemp("k7s_host")),
                               "film_host", launches=2)
    lib.ppg_film_splat_filter.argtypes = TF.FILTER_ARGTYPES
    lib.ppg_film_splat_filter.restype = ctypes.c_int

    def run(name, buffers, start, pos, values, sq_buffers=None):
        rgb2, w2 = sq_buffers or (None, None)
        consts = TF.filter_constants(name)
        h, w = buffers[1].shape
        return lib.ppg_film_splat_filter(
            buffers[0].data_ptr(), buffers[1].data_ptr(),
            None if rgb2 is None else rgb2.data_ptr(),
            None if w2 is None else w2.data_ptr(), pos.data_ptr(),
            values.data_ptr(), start, values.shape[0], w, h,
            TF._KIND[name], TF.FILTER_RADIUS[name], consts.ctypes.data, 0,
            None)

    return run


def _as_the_kernel(monkeypatch):
    """The plain filters' exp and sin as the shim's build computes them:
    the C library's expf and sinf."""
    libm = ctypes.CDLL("libm.so.6")
    for f in (libm.expf, libm.sinf):
        f.argtypes, f.restype = [ctypes.c_float], ctypes.c_float
    each = lambda f, x: torch.tensor([f(v) for v in x.reshape(-1).tolist()],
                                     dtype=torch.float32).reshape(x.shape)
    monkeypatch.setattr(torch, "exp", lambda x: each(libm.expf, x))
    monkeypatch.setattr(torch, "sin", lambda x: each(libm.sinf, x))


def _both(k7s_host, name, squares, seed, case="23x11"):
    """The kernel source and the plain version over the chunks of
    CASES[case], each into its own film (and squared film)."""
    w, h, c, starts, nonfinite = CASES[case]
    rng = np.random.default_rng(seed)
    film = TF.Film(w, h, name, "cpu")
    got, want = film.zeros(), film.zeros()
    got_sq, want_sq = film.zeros(), film.zeros()
    for start in starts:
        _, pos, vals = _chunk(rng, start, w=w, c=c, nonfinite=nonfinite)
        p, v = torch.from_numpy(pos), torch.from_numpy(vals)
        assert k7s_host(name, got, start, p, v,
                        got_sq if squares else None) == 0
        TF.splat_filter_plain(name, want, start, p, v,
                              want_sq if squares else None)
    assert bool(got_sq[1].any()) == squares
    return got + got_sq, want + want_sq


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("squares", [False, True])
@pytest.mark.parametrize("name", FILTERS)
def test_kernel_source_equals_plain_with_its_libm(k7s_host, name, squares,
                                                  case, monkeypatch):
    _as_the_kernel(monkeypatch)
    got, want = _both(k7s_host, name, squares, 10 + squares, case)
    for a, b in zip(got, want):
        _same_bits(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", ("gaussian", "lanczos"))
def test_kernel_source_within_libm_tolerance(k7s_host, name):
    """Against PyTorch's own CPU exp and sin: within SUM_ULPS ulps of each
    buffer's largest magnitude."""
    got, want = _both(k7s_host, name, True, 20)
    for a, b in zip(got, want):
        _within_ulps(a.numpy(), b.numpy())


def test_kernel_source_traps_on_a_sample_outside_its_pixel(k7s_host):
    film = TF.Film(W, H, "lanczos", "cpu")
    _, pos, vals = _chunk(np.random.default_rng(4), 100)
    pos[5, 0] -= 1.25
    assert k7s_host("lanczos", film.zeros(), 100, torch.from_numpy(pos),
                    torch.from_numpy(vals)) != 0


def test_kernel_source_refuses_a_film_of_2_22_pixels_a_side(k7s_host):
    """The kernel's window arithmetic is exact below 2^22 pixels a side
    (csrc/film.cu's note): a wider film is refused with
    cudaErrorInvalidValue before anything is launched or read."""
    wide = (torch.zeros(1, 1, 3).expand(1, 1 << 22, 3),
            torch.zeros(1, 1).expand(1, 1 << 22))
    assert k7s_host("gaussian", wide, 0, torch.full((1, 2), 0.5),
                    torch.ones(1, 3)) == 1

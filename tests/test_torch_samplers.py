"""The port's QMC samplers (ppg_tpu_torch/render/samplers.py::draw)
against ppg_tpu's, kind by kind, on the same pixel ids and sample
indices (one for all lanes, or one a lane): bit for bit for the dims
given as ints, and for a dim given as a 0-d tensor against ppg_tpu's
draw with that dim traced under jax.jit. There the halton and hammersley
values may differ by one float32 ulp, since XLA contracts the radical
inverse's x + digit * scale into a fused multiply-add inside jit (eager,
it rounds the two, as the port does; both are held here). ppg_tpu's
halton and hammersley cache their prime table on first use, so its eager
draws run before its jitted one (a first call under jit leaks a tracer
into the cache)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.render import samplers as JS
from ppg_tpu_torch.device import generator, rand
from ppg_tpu_torch.render import samplers as TS

QMC = TS.KINDS[1:]
L = 301
# (first dim, dims drawn): the camera's two, a bounce's bsdf three, the
# guiding tree's 22 of a later bounce, one rr dim, dims past the Sobol'
# table's 64 and the primes' wrap
DIMS = ((0, 2), (2, 3), (41, 22), (27, 1), (70, 4), (255, 3))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 1 << 22, L).astype(np.int32)
    per_lane = rng.integers(0, 1 << 20, L).astype(np.int32)
    return pid, (0, 5, 1023, per_lane)


@pytest.mark.parametrize("kind", QMC)
def test_draw_equals_ppg_tpu_bit_for_bit(kind):
    pid, sample_idxs = _inputs(QMC.index(kind))
    for dim, n in DIMS:
        shape = (L, n) if n > 1 else (L,)
        for s in sample_idxs:
            want = JS.draw(kind, jnp.asarray(pid), jnp.asarray(s), dim, None,
                           shape)
            got = TS.draw(kind, torch.from_numpy(pid), torch.as_tensor(s),
                          dim, None, shape)
            assert tuple(got.shape) == shape and got.dtype == torch.float32
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
            assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("kind", QMC)
def test_traced_dim(kind):
    pid, _ = _inputs(7)
    p = jnp.asarray(pid)
    eager = np.asarray(JS.draw(kind, p, jnp.int32(3), 9, None, (L, 5)))
    traced = np.asarray(jax.jit(lambda d: JS.draw(
        kind, p, jnp.int32(3), d, None, (L, 5)))(jnp.int32(9)))
    got = TS.draw(kind, torch.from_numpy(pid), 3,
                  torch.tensor(9, dtype=torch.int32), None, (L, 5)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(eager))
    if kind in ("halton", "hammersley"):
        np.testing.assert_allclose(got, traced, rtol=0,
                                   atol=np.spacing(np.float32(1.0)))
    else:
        np.testing.assert_array_equal(_bits(got), _bits(traced))
    other = TS.draw(kind, torch.from_numpy(pid), 3,
                    torch.tensor(13, dtype=torch.int32), None, (L, 5))
    assert not np.array_equal(got, other.numpy())


def test_independent_draws_from_the_generator():
    got = TS.draw("independent", torch.arange(L), 0, 0, generator(4, "cpu"),
                  (L, 3))
    np.testing.assert_array_equal(got.numpy(),
                                  rand(generator(4, "cpu"), L, 3).numpy())


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown sampler kind"):
        TS.draw("faure", torch.arange(4), 0, 0, None, (4, 2))


def test_products_stay_exact():
    """_mul takes a * b mod 2^32 by 16-bit halves: exact for the largest
    operands, where the whole product would pass 2^63."""
    a = torch.tensor([0xFFFFFFFF, 0x9E3779B9, 1, 0], dtype=torch.int64)
    for b in (0xFFFFFFFF, 0x735A2D97, 0x6C50B47C):
        want = [(int(x) * b) % (1 << 32) for x in a]
        assert TS._mul(a, b).tolist() == want
        assert TS._mul(a, torch.full_like(a, b)).tolist() == want

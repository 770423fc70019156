"""The CUDA triangle-sweep kernel (ppg_tpu_torch/csrc/brute.cu) against its
plain PyTorch version, bit for bit, on random triangle soups made with
numpy. The kernel has no CPU mode, so these tests run only on a card and
skip elsewhere. The file imports no JAX, so that it also runs where JAX is
not installed:

    python -m pytest --noconftest tests/test_torch_brute_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.accel import brute as TB


def _soup(T, L, seed):
    """T random triangles as [T,12] rows (p0, e1, e2, pad) and L rays
    (o, d, t_min, t_max) with every 17th lane parked (t_max < t_min), as
    the tracer parks dead paths."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, (T, 3, 3)).astype(np.float32)
    tri = np.zeros((T, 12), np.float32)
    tri[:, 0:3] = v[:, 0]
    tri[:, 3:6] = v[:, 1] - v[:, 0]
    tri[:, 6:9] = v[:, 2] - v[:, 0]
    o = rng.uniform(-2.0, 2.0, (L, 3)).astype(np.float32)
    d = rng.normal(size=(L, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.zeros(L, np.float32)
    t_max = np.where(np.arange(L) % 17 == 0, -1.0, 3.4e38).astype(np.float32)
    return tri, o, d, t_min, t_max


@pytest.mark.gpu
@pytest.mark.parametrize("T,L", [(12, 1 << 16), (130, 1 << 16),
                                 (1024, 1 << 16), (12, (1 << 20) - 37),
                                 (1024, 1000)])
def test_kernel_matches_plain_bitwise_on_card(T, L):
    """L = 2^20 - 37 and 1000 end in a partial block of the launch grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tri, o, d, t_min, t_max = _soup(T, L, seed=100 + T + L)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (tri, o, d, t_min, t_max)]
    TB.reset_counts()
    got = TB.brute_closest(*args)
    torch.cuda.synchronize()
    assert TB.COUNTS["brute_kernel"] == 1
    want = TB.brute_sweep_plain(*args)
    assert torch.equal(got[0], want[0])
    hit = want[0] >= 0
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a[hit].view(torch.int32), b[hit].view(torch.int32))
    assert torch.equal(got[1][~hit], want[1][~hit])

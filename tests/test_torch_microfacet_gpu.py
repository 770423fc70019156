"""K8, visible-normal microfacet sampling (ppg_tpu_torch/csrc/microfacet.cu,
ppg_vndf_sample), on a card: the kernel against its plain PyTorch
version, sample_visible_plain, on the card, bit for bit (two NaNs equal
whatever their payloads), at the main path's L = 262,144 lanes and on a
ragged L, on tools/vndf_cases.py's lanes (GGX and Beckmann, isotropic and
anisotropic roughness, wi over both hemispheres, at the normal, within
1e-4 of it and grazing, uniforms at 0 and 1), with the uniforms as the
strided first two columns of a [L,3] draw and as a contiguous [L,2], and
with alpha and dist as strided columns of a material row; ungated and
gated (the lanes' families, vndf_cases' mtype, read by the kernel as a
strided column of the row too), and on tiles of one kind each (all gated
out, all GGX, all Beckmann). sample_visible on CUDA tensors launches K8
once and never the plain version. The kernel
has no CPU mode, so the `gpu` tests run only on a card and skip
elsewhere. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_microfacet_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ppg_tpu_torch.bsdf import microfacet as MF
from ppg_tpu_torch.tools import vndf_cases


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all()), int((~same).sum())


def _inputs(card, L, seed, strided, gated=False, c=None):
    """vndf_cases' lanes on the card (or the lanes c given), with the gate
    (mtype, vndf_cases.FAMS) after them when `gated`."""
    c = vndf_cases.inputs(np.random.default_rng(seed), L) if c is None else c
    t = {k: torch.from_numpy(v).to(card) for k, v in c.items()}
    if strided:
        # alpha_u, alpha_v, dist and the family as columns of a [L, 8] row,
        # as the material table's gather gives them; u as u3[:, :2]
        row = torch.zeros((L, 8), device=card)
        row[:, 1], row[:, 5] = t["alpha_u"], t["alpha_v"]
        row.view(torch.int32)[:, 3] = t["dist"]
        row.view(torch.int32)[:, 0] = t["mtype"]
        args = (row.view(torch.int32)[:, 3], row[:, 1], row[:, 5], t["wi"],
                t["u"][:, :2])
        mt = row.view(torch.int32)[:, 0]
    else:
        args = (t["dist"], t["alpha_u"], t["alpha_v"], t["wi"],
                t["u"][:, :2].contiguous())
        mt = t["mtype"]
    return args + ((mt, vndf_cases.FAMS),) if gated else args


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1 << 18, 1000])
@pytest.mark.parametrize("strided", [True, False])
def test_vndf_kernel_equals_plain_on_card(card, L, strided):
    _equals_plain_on_card(card, L, strided, False)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1 << 18, 1000])
@pytest.mark.parametrize("strided", [True, False])
def test_gated_vndf_kernel_equals_plain_on_card(card, L, strided):
    _equals_plain_on_card(card, L, strided, True)


def _equals_plain_on_card(card, L, strided, gated):
    args = _inputs(card, L, 3 + L, strided, gated)
    MF.reset_counts()
    got = MF.sample_visible(*args)
    assert MF.COUNTS == {"vndf_kernel": 1, "vndf_plain_on_cuda": 0}
    want = MF.sample_visible_plain(*args)
    torch.cuda.synchronize()
    _same(got, want)
    # finite normals on the upper hemisphere's lanes (at the normal, u1 =
    # 1 gives -log(0) and a NaN, as in ppg_tpu)
    upper = (args[3][:, 2] > 1e-3) & (args[4][:, 0] < 1.0)
    assert bool(torch.isfinite(got[upper]).all())
    if gated:
        out = ~MF.gate_mask(*args[5])
        assert 0 < int(out.sum()) < L
        assert bool((got[out] == got.new_tensor([0.0, 0.0, 1.0])).all())


@pytest.mark.gpu
@pytest.mark.parametrize("ragged", [0, 37])
def test_gated_kernel_on_tiles_of_one_kind(card, ragged):
    """Tiles of 256 lanes (the kernel's BLOCK) all gated out, all GGX, all
    Beckmann or mixed, in runs that fill a block's queues, then a ragged
    end: bit for bit with the gated plain version."""
    kinds = ("out ggx beckmann mixed " * 8 + "ggx " * 40 + "beckmann " * 40
             + "out " * 40 + "mixed " * 40).split()
    n = 256 * len(kinds) + ragged
    c = vndf_cases.inputs(np.random.default_rng(41), n)
    rng = np.random.default_rng(42)
    for j, kind in enumerate(kinds):
        sl = slice(256 * j, 256 * (j + 1))
        if kind == "out":
            c["mtype"][sl] = rng.choice(vndf_cases.OTHER_FAMILIES, 256)
        elif kind != "mixed":
            c["mtype"][sl] = rng.choice(vndf_cases.MF_FAMILIES, 256)
            c["dist"][sl] = (vndf_cases.GGX if kind == "ggx"
                             else vndf_cases.BECKMANN)
    args = _inputs(card, n, 0, True, True, c)
    MF.reset_counts()
    got = MF.sample_visible(*args)
    assert MF.COUNTS == {"vndf_kernel": 1, "vndf_plain_on_cuda": 0}
    _same(got, MF.sample_visible_plain(*args))


@pytest.mark.gpu
def test_vndf_kernel_refuses_what_it_does_not_take(card):
    args = list(_inputs(card, 256, 1, False, True))
    mt, fams = args[5]
    for k, bad in ((0, args[0].float()), (3, args[3][:, :2]),
                   (1, args[1].cpu()), (5, (mt.float(), fams)),
                   (5, (mt.cpu(), fams)), (5, (mt[:-1], fams)),
                   (5, (mt, 1 << 32))):
        a = list(args)
        a[k] = bad
        with pytest.raises(ValueError, match="ppg_vndf_sample"):
            MF.sample_visible(*a)

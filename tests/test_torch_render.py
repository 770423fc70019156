"""The port's GuidedPathTracer as a whole against ppg_tpu's: the
iteration schedule and the inverse-variance weights must be identical
(stubbed passes, as in tests/test_iteration_driver_oracle.py), and whole
renders of the built-in Cornell box must agree statistically with
ppg_tpu's at equal spp (here the nearest/nearest, nee never slice;
test_torch_render_improved.py and test_torch_render_nee.py cover the
other settings). The random streams differ (threefry against Philox /
the CPU generator), so the image comparison uses the gates of
tests/test_regen.py: whole-image mean within 5%, and the median relative
difference of 8x8 block means below 0.25."""

import numpy as np
import pytest
import torch

from ppg_tpu.integrators.guided import GuidedPathTracer as JTracer
from ppg_tpu_torch.integrators import driver as TD
from ppg_tpu_torch.integrators.guided import GuidedPathTracer as TTracer
from ppg_tpu_torch.scene import mini_cbox
from test_iteration_driver_oracle import _DriverProbe, _FakeHostTree


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Wavefronts of about a thousand lanes gain nothing from intra-op
    threads (the port's renders here run faster on one thread than on
    eight even on an idle CPU), and with several test workers on one host
    those threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _PortProbe(TTracer):
    """The port's GuidedPathTracer with scripted passes: exercises the
    real render() control flow only."""

    def __init__(self, spp_per_pass, combination, variances,
                 image_values=()):
        self.spp_per_pass = spp_per_pass
        self.sample_combination = combination
        self.nee = "never"
        self.budget_type = "spp"
        self.budget = None
        self.s_tree_threshold = 12000
        self.d_tree_threshold = 0.01
        self.sd_tree_max_mb = -1
        self.dump_sdtree, self.dump_path = False, None
        self.host_tree = _FakeHostTree()
        self.stats, self.tree_stats = [], []
        self.device = torch.device("cpu")
        self._variances = list(variances)
        self._image_values = list(image_values)
        self.schedule = []

    def _zeros(self):
        return torch.zeros((2, 2, 3)), torch.zeros((2, 2))

    def _to_image_buffers(self, buf):
        return buf

    def _push(self):
        return None

    def _render_passes(self, n_passes, sdtree, is_built, do_nee, is_final,
                       film_buf):
        self.schedule.append((int(n_passes), bool(is_final)))
        i = len(self.schedule) - 1
        variance = self._variances[min(i, len(self._variances) - 1)]
        val = self._image_values[i] if i < len(self._image_values) else 0.0
        return sdtree, film_buf, np.full((2, 2, 3), val, np.float32), variance


@pytest.mark.parametrize("budget", [16, 127, 200, 4096])
@pytest.mark.parametrize("combination,variances", [
    ("automatic", [1.0] * 12),
    # a late variance bump fires the automatic early final (:1399-1408)
    ("automatic", [1.0, 1.0, 1.0, 1.0, 1.0, 40.0, 1.0]),
    ("discard", [1.0, 1.0, 1.0, 1.0, 1.0, 40.0, 1.0]),
    # inversevar never ends early, whatever the variances do
    ("inversevar", [1.0, 1.0, 1.0, 1.0, 1.0, 40.0, 1.0])])
@pytest.mark.parametrize("spp_per_pass", [4, 1])
def test_iteration_schedule_matches(budget, combination, variances,
                                    spp_per_pass):
    port = _PortProbe(spp_per_pass, combination, variances)
    port.render(seed=0, spp_budget=budget)
    ref = _DriverProbe(spp_per_pass, combination, variances,
                       budget_type="spp")
    ref.render(seed=0, spp_budget=budget)
    assert port.schedule == ref.schedule
    assert sum(p for p, _ in port.schedule) == int(
        np.ceil(budget / spp_per_pass))


def test_improved_schedule_is_seven_doublings():
    """cbox-improved (127 spp, sppPerPass 1, inversevar): by the
    merge-final rule 1, 2, ..., 64 passes, the last one final."""
    port = _PortProbe(1, "inversevar", [1.0])
    port.render(seed=0, spp_budget=127)
    ref = _DriverProbe(1, "inversevar", [1.0], budget_type="spp")
    ref.render(seed=0, spp_budget=127)
    assert port.schedule == ref.schedule == [
        (1 << i, i == 6) for i in range(7)]


@pytest.mark.parametrize("n_iters", [2, 7])
def test_inversevar_weights_match(n_iters):
    """The final image is the 1/variance-weighted mean of the last <= 4
    iteration images (all of them when there are fewer), as ppg_tpu's
    (tests/test_iteration_driver_oracle.py:258); equal to 1e-6."""
    budget = (1 << n_iters) - 1  # n_iters doublings at sppPerPass 1
    variances = [1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.0][:n_iters]
    values = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0][:n_iters]
    port = _PortProbe(1, "inversevar", variances, values)
    got = port.render(seed=0, spp_budget=budget)
    ref = _DriverProbe(1, "inversevar", variances, budget_type="spp",
                       image_values=values)
    want = ref.render(seed=0, spp_budget=budget)
    assert len(port.schedule) == n_iters
    np.testing.assert_allclose(got, want, rtol=1e-6)
    k = min(n_iters, 4)
    w = 1.0 / np.maximum(variances[-k:], 1e-20)  # the 1e-20 variance floor
    assert np.allclose(got, (w * values[-k:]).sum() / w.sum(), rtol=1e-6)


def _blocks(im):
    h, w = (im.shape[0] // 8) * 8, (im.shape[1] // 8) * 8
    return im[:h, :w].mean(-1).reshape(h // 8, 8, w // 8, 8).mean((1, 3))


def assert_images_agree(img_a, img_b, block_tol=0.25):
    """tests/test_regen.py:29-45: whole-image means within 5%, and the
    median relative difference of 8x8 block means (blocks above a tenth
    of the mean) below block_tol; nee=never is heavy-tailed."""
    ma, mb = float(img_a.mean()), float(img_b.mean())
    assert abs(ma - mb) / ma < 0.05, (ma, mb)
    ba, bb = _blocks(img_a), _blocks(img_b)
    mask = ba > 0.1 * ba.mean()
    assert np.median(np.abs(ba - bb)[mask] / ba[mask]) < block_tol


def test_guided_render_agrees_with_ppg_tpu():
    # 127 spp budget: 1, 2, 4, 8 training passes, then 17 final passes,
    # so the final image holds 68 spp of 48x48 pixels
    sc = mini_cbox(res=48, budget=127, max_depth=6)
    port = TTracer(sc, chunk=48 * 48, device="cpu")
    img_t = port.render(seed=0)
    ref = JTracer(sc, chunk=48 * 48)
    ref.train_mode = "classic"  # the per-chunk mode the port implements
    img_j = np.asarray(ref.render(seed=0))
    assert [(s["passes"], s["is_final"]) for s in port.stats] == \
        [(s["passes"], s["is_final"]) for s in ref.stats]
    assert img_t.shape == img_j.shape == (48, 48, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert_images_agree(img_j, img_t)
    # the tree was trained and used: several spatial leaves, rays counted
    assert port.tree_stats[-1]["n_dtrees"] > 1
    assert all(s["n_rays"] > 0 and s["avg_path_length"] > 1
               for s in port.stats)


def test_unguided_render_agrees_with_guided():
    """Both estimators are unbiased, so the port's unguided driver.render
    and its guided render must pass the same gates."""
    sc = mini_cbox(res=32, budget=63, max_depth=6)
    guided = TTracer(sc, chunk=32 * 32, device="cpu").render(seed=1)
    plain = TD.render(sc, spp=36, seed=2, chunk=32 * 32, device="cpu")
    assert_images_agree(plain, guided)

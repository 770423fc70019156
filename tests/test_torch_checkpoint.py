"""The guided driver's features beside the spp loop
(ppg_tpu_torch/integrators/guided.py), on the CPU:

- checkpoints (tests/test_checkpoint_resume.py's two tests, ported): a
  render stopped after its first iteration's checkpoint and resumed by a
  fresh tracer equals the uninterrupted render bit for bit (the
  checkpoint keeps the generator's state), with the box filter's flat
  film sums and with the gaussian filter's [H,W] ones; a checkpoint of
  another seed starts the render afresh; the pickled state holds host
  arrays only;
- the time budget (renderTime): the iteration schedule equals ppg_tpu's
  on tests/test_iteration_driver_oracle.py's scripted clocks and
  variances, and a real render of about two seconds runs at least two
  iterations;
- dumpSDTree: one .sdt for every iteration but the last, each read back
  with one record per spatial leaf of positive statistical weight.
"""

import glob
import os
import pickle

import numpy as np
import pytest
import torch

import ppg_tpu_torch.integrators.guided as guided_mod
from ppg_tpu_torch.integrators.guided import GuidedPathTracer
from ppg_tpu_torch.io.sdt import read_sdt
from ppg_tpu_torch.scene.testscenes import MINI_CBOX, scene_from_xml
from test_iteration_driver_oracle import (TIME_SCENARIOS, _DriverProbe,
                                          _FakeClock, _FakeHostTree)
from test_iteration_driver_oracle import guided_mod as ref_guided_mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(res, budget, rfilter="box", budget_type="spp", settings=""):
    xml = MINI_CBOX.format(res=res, budget=budget, max_depth=4, nee="never")
    xml = xml.replace('<rfilter type="box"/>', f'<rfilter type="{rfilter}"/>')
    xml = xml.replace('<string name="budgetType" value="spp"/>',
                      f'<string name="budgetType" value="{budget_type}"/>'
                      + settings)
    return scene_from_xml(xml)


class Abort(Exception):
    pass


@pytest.mark.parametrize("rfilter", ["box", "gaussian"])
def test_resumed_render_matches_uninterrupted(tmp_path, rfilter):
    whole = GuidedPathTracer(_scene(32, 24, rfilter), chunk=512,
                             device="cpu")
    ref = whole.render(seed=3)
    ck = str(tmp_path / "r.ckpt")
    tr = GuidedPathTracer(_scene(32, 24, rfilter), chunk=512, device="cpu")
    save = tr._save_checkpoint
    calls = []

    def save_and_abort(path, state):
        save(path, state)
        calls.append(state["it"])
        raise Abort()

    tr._save_checkpoint = save_and_abort
    with pytest.raises(Abort):
        tr.render(seed=3, checkpoint=ck)
    assert calls == [1] and os.path.exists(ck)
    tr2 = GuidedPathTracer(_scene(32, 24, rfilter), chunk=512, device="cpu")
    out = tr2.render(seed=3, checkpoint=ck)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    # the resumed tracer rendered only the iterations after the first
    assert len(tr2.tree_stats) == len(whole.tree_stats) - 1 >= 1


def test_checkpoint_mismatch_starts_fresh(tmp_path):
    ck = str(tmp_path / "r.ckpt")
    img1 = GuidedPathTracer(_scene(24, 8), chunk=576, device="cpu").render(
        seed=1, checkpoint=ck)
    # a checkpoint written with seed 1 must not poison a seed-2 render
    img2 = GuidedPathTracer(_scene(24, 8), chunk=576, device="cpu").render(
        seed=2, checkpoint=ck)
    fresh = GuidedPathTracer(_scene(24, 8), chunk=576, device="cpu").render(
        seed=2)
    assert np.isfinite(img2).all()
    assert abs(img2.mean() - img1.mean()) / max(img1.mean(), 1e-9) < 0.5
    np.testing.assert_array_equal(img2.view(np.int32), fresh.view(np.int32))
    with open(ck, "wb") as f:
        f.write(b"not a checkpoint")
    again = GuidedPathTracer(_scene(24, 8), chunk=576, device="cpu").render(
        seed=2, checkpoint=ck)
    np.testing.assert_array_equal(again.view(np.int32), fresh.view(np.int32))


def test_checkpoint_holds_host_arrays_only(tmp_path):
    ck = str(tmp_path / "r.ckpt")
    GuidedPathTracer(_scene(16, 8, "gaussian"), chunk=256,
                     device="cpu").render(seed=0, checkpoint=ck)
    with open(ck, "rb") as f:
        st = pickle.load(f)

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
        else:
            yield x

    found = list(leaves(st)) + list(leaves(vars(st["host_tree"])))
    assert not any(isinstance(x, torch.Tensor) for x in found)
    assert [b.shape for b in st["film_buf"]] == [(16, 16, 3), (16, 16)]
    assert st["generator"].dtype == np.uint8


class _PortProbe(GuidedPathTracer):
    """The port's tracer with scripted passes on a scripted clock (as
    ppg_tpu's _DriverProbe): exercises _render_time's control flow."""

    def __init__(self, spp_per_pass, variances, budget, clock, seconds):
        self.spp_per_pass, self.sample_combination = spp_per_pass, \
            "automatic"
        self.nee, self.budget_type, self.budget = "never", "seconds", budget
        self.s_tree_threshold, self.d_tree_threshold = 12000, 0.01
        self.sd_tree_max_mb = -1
        self.dump_sdtree, self.dump_path = False, None
        self.host_tree = _FakeHostTree()
        self.stats, self.tree_stats = [], []
        self.device = torch.device("cpu")
        self._variances, self._seconds = list(variances), list(seconds)
        self._clock = clock
        self.schedule = []

    def _zeros(self):
        return torch.zeros((2, 2, 3)), torch.zeros((2, 2))

    def _to_image_buffers(self, buf):
        return buf

    def _push(self):
        return None

    def _render_passes(self, n_passes, sdtree, is_built, do_nee, is_final,
                       film_buf):
        i = len(self.schedule)
        self.schedule.append((int(n_passes), bool(is_final)))
        self._clock.now += self._seconds[min(i, len(self._seconds) - 1)]
        variance = self._variances[min(i, len(self._variances) - 1)]
        return sdtree, film_buf, np.zeros((2, 2, 3), np.float32), variance


@pytest.mark.parametrize("name,n_seconds,spp,script", TIME_SCENARIOS)
def test_time_schedule_matches_ppg_tpu(name, n_seconds, spp, script,
                                       monkeypatch):
    seconds, variances = [s for s, _ in script], [v for _, v in script]
    clock = _FakeClock()
    monkeypatch.setattr(guided_mod, "time", clock)
    port = _PortProbe(spp, variances, n_seconds, clock, seconds)
    port.render(seed=0)
    ref_clock = _FakeClock()
    monkeypatch.setattr(ref_guided_mod, "time", ref_clock)
    ref = _DriverProbe(spp, "automatic", variances, budget_type="seconds",
                       budget=n_seconds, seconds_script=seconds,
                       clock=ref_clock)
    ref.render(seed=0)
    assert port.schedule == ref.schedule, name


def test_time_budget_render(tmp_path):
    """A budget of two seconds at 16 x 16 runs at least two iterations
    and gives a finite image."""
    sc = _scene(16, 2, "gaussian", "seconds")
    tr = GuidedPathTracer(sc, chunk=256, device="cpu")
    img = tr.render(seed=0)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0 and len(tr.tree_stats) >= 2
    assert sum(s["seconds"] for s in tr.stats) < 30


def test_dump_sdtree_writes_each_iteration(tmp_path):
    sc = _scene(16, 28, settings='<boolean name="dumpSDTree" value="true"/>'
                '<integer name="sTreeThreshold" value="20"/>')
    tr = GuidedPathTracer(sc, chunk=256, device="cpu")
    tr.dump_path = str(tmp_path / "cbox")
    leaves, dump = [], tr._dump

    def counted(it):
        leaves.append(int((tr.host_tree.statw_s > 0).sum()))
        dump(it)

    tr._dump = counted
    tr.render(seed=0)
    files = sorted(glob.glob(str(tmp_path / "cbox-*.sdt")))
    assert [os.path.basename(f) for f in files] == [
        f"cbox-{i:02d}.sdt" for i in range(len(tr.tree_stats) - 1)]
    assert len(files) >= 2 and max(leaves) > 1
    for path, n in zip(files, leaves):
        cam, trees = read_sdt(path)
        np.testing.assert_allclose(cam, sc.sensor["to_world"], atol=1e-6)
        assert len(trees) == n and all(t["stat_weight"] > 0 for t in trees)

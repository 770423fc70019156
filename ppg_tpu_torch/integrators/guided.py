"""GuidedPathTracer: the spp-doubling training and render loop
(counterpart of ppg_tpu/integrators/guided.py in its classic per-chunk
mode; GuidedPathTracer::render / renderSPP / renderTime /
performRenderPasses, guided_path.cpp:1210-1585).

Per iteration the host tree is refined and reset, 2^iter passes are
rendered (each pass: sppPerPass samples of every pixel chunk, training
vertices and NEE records splatted into the building tree, the learned
bsdf sampling fraction stepped by Adam once the tree is built), the pass
batch's variance is tracked with the 1e4 luminance clamp (:1300-1313),
the merge-final and automatic early-final rules apply (:1360-1423), and
the tree is rebuilt. The final image is the whole film ("automatic",
"discard") or the inverse-variance mean of the last <= 4 iteration
images ("inversevar", :1567-1582). One torch.Generator seeded from the
render seed drives every draw. The budget is in spp or, with budgetType
seconds, in wall-clock seconds; an spp render can checkpoint after every
iteration and resume bit for bit, and dumpSDTree writes each iteration's
tree as an .sdt file (io/sdt.py).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from ..device import generator, resolve, synchronize
from ..guiding import records as R
from ..guiding import sdtree as G
from ..guiding.host import HostSDTree
from ..io.sdt import dump_sdtree
from ..render.film import Film
from ..render.sensor import make_sensor
from .driver import chunk_pixels, ensure_subsurface, make_config
from .wavefront import DeviceScene, trace_paths

VAR_CLAMP = 10000.0  # firefly clamp on per-pixel variance (:1310)
_T0 = time.time()


def log(msg):
    """Progress line on stdout, stamped with seconds since import."""
    print(f"[{time.time() - _T0:8.2f}s] INFO   {msg}", flush=True)


def _chunk_step(scene, cfg, sensor, film, chunk, spatial_filter,
                directional_filter, learn_fraction, film_buf, sq_buf, sdtree,
                gen, pix_start):
    """Trace one pixel chunk, splat it into the film buffers and its
    training records into the building tree (all in place). Returns
    (n_rays, n_vertices) as 0-d tensors. As in ppg_tpu the guided tracer
    draws every number from `gen`, whatever the scene's sampler."""
    ids, pos, rays = chunk_pixels(sensor, chunk, pix_start, gen)
    out = trace_paths(scene, cfg, gen, *rays, sdtree=sdtree, sensor=sensor)
    li = out["li"]
    if film.rfilter == "box":
        film.splat_box_linear(film_buf, pix_start, li,
                              ids < sensor.W * sensor.H, sq_buf)
    else:
        film.splat(film_buf, pix_start, pos, li, sq_buf)
    if cfg.record_vertices:
        # NEE that is not "always" shares each vertex with its NEE record
        stat_w = 0.5 if (cfg.do_nee and not cfg.nee_always) else 1.0
        lf = learn_fraction if cfg.is_built else None
        G.splat_records(sdtree, R.vertex_records(out["vertices"]["bsdf"],
                                                 stat_w),
                        spatial_filter, directional_filter, lf)
        if out["vertices"]["nee"] is not None:
            G.splat_records(sdtree, R.nee_records(out["vertices"]["nee"]),
                            spatial_filter, directional_filter, lf)
    return out["n_rays"], out["n_vertices"]


class GuidedPathTracer:
    def __init__(self, sc, chunk=1 << 16, overrides=None, mesh=None,
                 slices=None, slice_id=None, reduce_sum=None,
                 device="cuda"):
        """ppg_tpu's parameter surface. `device` selects the card ("cuda")
        or the CPU; the mesh / slices data-parallel modes are not ported
        and raise."""
        if mesh is not None or slices or slice_id is not None \
                or reduce_sum is not None:
            raise NotImplementedError(
                "mesh and multi-host slices are not ported (ROADMAP Queue "
                "1, scale-out)")
        self.device = resolve(device)
        ip = dict(sc.integrator)
        ip.update(overrides or {})
        self.sc = sc
        self.chunk = chunk
        self.nee = str(ip.get("nee", "never"))
        self.sample_combination = str(ip.get("sampleCombination",
                                             "automatic"))
        self.spatial_filter = str(ip.get("spatialFilter", "nearest"))
        self.directional_filter = str(ip.get("directionalFilter", "nearest"))
        self.loss = str(ip.get("bsdfSamplingFractionLoss", "none"))
        self.sd_tree_max_mb = int(ip.get("sdTreeMaxMemory", -1))
        self.s_tree_threshold = int(ip.get("sTreeThreshold", 12000))
        self.d_tree_threshold = float(ip.get("dTreeThreshold", 0.01))
        self.bsdf_fraction = float(ip.get("bsdfSamplingFraction", 0.5))
        self.spp_per_pass = int(ip.get("sppPerPass", 4))
        self.budget_type = str(ip.get("budgetType", "seconds"))
        self.budget = float(ip.get("budget", 300.0))
        for flag, value, ok in (
                ("nee", self.nee, ("never", "kickstart", "always")),
                ("spatialFilter", self.spatial_filter,
                 ("nearest", "stochastic", "box")),
                ("directionalFilter", self.directional_filter,
                 ("nearest", "box")),
                ("bsdfSamplingFractionLoss", self.loss, ("none", "kl", "var")),
                ("sampleCombination", self.sample_combination,
                 ("automatic", "discard", "inversevar"))):
            if value not in ok:
                raise ValueError(f"{flag}={value!r}: want one of {ok}")
        self.dump_sdtree = bool(ip.get("dumpSDTree", False))
        # with dumpSDTree, each iteration but a final one writes
        # <dump_path>-<iteration>.sdt (the CLI sets it from the output)
        self.dump_path = None

        self.base_cfg = make_config(sc, guiding=True, record_vertices=True)
        self.scene_dev = ensure_subsurface(
            sc, DeviceScene.from_scene(sc, self.device))
        self.sensor = make_sensor(sc.sensor, sc.film, self.device)
        self.film = Film(sc.film["width"], sc.film["height"],
                         sc.film.get("rfilter", "box"), self.device)
        self.host_tree = HostSDTree(sc.aabb_min, sc.aabb_max)
        self.stats = []  # per pass batch: seconds, variance, ttuv, stuv
        self.tree_stats = []  # per iteration SD-tree distribution stats
        self._gen = None

    def _push(self):
        return self.host_tree.push(self.device)

    def _do_nee(self, spp_rendered):
        """doNeeWithSpp (guided_path.cpp:1331-1340)."""
        if self.nee == "never":
            return False
        if self.nee == "kickstart":
            return spp_rendered < 128
        return True

    def _cfg(self, is_built, do_nee, is_final):
        # training passes resolve their splat targets at shade time; the
        # spatial box filter's several leaves per record are walked at
        # splat time
        precompute = (not is_final
                      and self.spatial_filter in ("nearest", "stochastic"))
        return replace(
            self.base_cfg,
            do_nee=do_nee,
            nee_always=self.nee == "always",
            guiding=True,
            is_built=is_built,
            record_vertices=not is_final,
            learn_fraction=self.loss != "none" and is_built,
            bsdf_fraction=self.bsdf_fraction,
            splat_spatial=self.spatial_filter if precompute else "",
            splat_dir=self.directional_filter if precompute else "",
        )

    def _zeros(self):
        if self.film.rfilter == "box":
            return self.film.zeros_flat(self.chunk)
        return self.film.zeros()

    def _to_image_buffers(self, buf):
        if self.film.rfilter == "box":
            return self.film.unflatten(buf)
        return buf

    def _render_passes(self, n_passes, sdtree, is_built, do_nee, is_final,
                       film_buf):
        """One performRenderPasses call: n_passes passes of sppPerPass
        samples over every pixel chunk. Adds the batch into film_buf and
        returns (sdtree, film_buf, the batch's image [H,W,3] as numpy, the
        batch's variance)."""
        W, H = self.film.W, self.film.H
        cfg = self._cfg(is_built, do_nee, is_final)
        lf = self.loss if self.loss != "none" else None
        img_buf, sq_buf = self._zeros(), self._zeros()
        n_chunks = (W * H + self.chunk - 1) // self.chunk
        t0 = time.time()
        n_rays = n_verts = 0
        for _ in range(n_passes * self.spp_per_pass):
            for c in range(n_chunks):
                r, v = _chunk_step(
                    self.scene_dev, cfg, self.sensor, self.film, self.chunk,
                    self.spatial_filter, self.directional_filter, lf,
                    img_buf, sq_buf, sdtree, self._gen, c * self.chunk)
                n_rays = n_rays + r
                n_verts = n_verts + v
        synchronize(self.device)
        seconds = time.time() - t0
        n_rays, n_verts = int(n_rays), int(n_verts)
        n_samples = n_passes * self.spp_per_pass * n_chunks * self.chunk

        # variance of the pass batch (:1300-1313)
        N = n_passes * self.spp_per_pass
        img2d = self._to_image_buffers(img_buf)
        img_sum = img2d[0].cpu().numpy()
        sq_sum = self._to_image_buffers(sq_buf)[0].cpu().numpy()
        local_var = sq_sum - img_sum * img_sum / max(N, 1)
        lum = (0.212671 * local_var[..., 0] + 0.715160 * local_var[..., 1]
               + 0.072169 * local_var[..., 2])
        variance = float(np.minimum(lum, VAR_CLAMP).sum()) / (
            W * H * max(N - 1, 1))
        film_buf = (film_buf[0] + img_buf[0], film_buf[1] + img_buf[1])
        avg_len = n_verts / n_samples if n_samples else 0.0
        self.stats.append(dict(
            seconds=seconds, passes=n_passes, spp=N, variance=variance,
            ttuv=seconds * variance, stuv=N * variance, n_rays=n_rays,
            avg_path_length=avg_len, is_final=bool(is_final),
            training=bool(cfg.record_vertices)))
        log(f"  {seconds:.2f}s, {n_passes} passes, var {variance:.6f}, "
             f"avgPathLength {avg_len:.2f}, {n_rays} rays")
        image = img_sum / np.maximum(img2d[1].cpu().numpy()[..., None], 1e-20)
        return sdtree, film_buf, image, variance

    def _save_checkpoint(self, path, state):
        """Writes `state` to `path` atomically (a temporary file in the
        same directory, then a rename)."""
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".ckpt")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(state, f, protocol=4)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise

    def _load_checkpoint(self, path):
        """The state a checkpoint holds: a file this program wrote."""
        with open(path, "rb") as f:
            return pickle.load(f)

    def _resume(self, checkpoint, seed, budget):
        """The loop state of `checkpoint` if it exists and was written for
        this seed and budget, else None (a mismatched or unreadable file
        starts the render afresh)."""
        if not (checkpoint and os.path.exists(checkpoint)):
            return None
        try:
            st = self._load_checkpoint(checkpoint)
        except (OSError, pickle.UnpicklingError, EOFError, ValueError,
                TypeError, AttributeError, ImportError, IndexError,
                KeyError) as e:
            log(f"checkpoint load failed ({e}): starting afresh")
            return None
        if not isinstance(st, dict) or st.get("seed") != seed \
                or st.get("budget") != budget:
            log("checkpoint seed/budget mismatch: starting afresh")
            return None
        return st

    def render(self, seed=0, spp_budget=None, checkpoint=None):
        """renderSPP (guided_path.cpp:1342-1427): returns the final image,
        float32 [H,W,3] as numpy. Without budgetType spp or spp_budget,
        renderTime's wall-clock budget (_render_time).

        checkpoint: an optional path. After every iteration the loop's
        state (the film sums, the inversevar images and variances, the
        host SD-tree with its Adam state, the counters and the generator's
        state, all host arrays) is written there atomically, and an
        existing file written for the same seed and budget resumes the
        loop at that boundary: the resumed render equals the uninterrupted
        one bit for bit. A time-budget render takes no checkpoint, as in
        ppg_tpu."""
        if self.budget_type != "spp" and spp_budget is None:
            return self._render_time(seed)
        budget = int(spp_budget if spp_budget is not None else self.budget)
        n_passes = int(np.ceil(budget / self.spp_per_pass))
        self._gen = generator(seed, self.device)

        sdtree = None
        is_built = False
        passes_rendered = 0
        it = 0
        images, variances = [], []
        film_buf = self._zeros()
        cur_var_at_end = np.inf
        st = self._resume(checkpoint, seed, budget)
        if st is not None:
            it, passes_rendered = st["it"], st["passes_rendered"]
            is_built, cur_var_at_end = st["is_built"], st["cur_var_at_end"]
            film_buf = tuple(torch.from_numpy(b).to(self.device)
                             for b in st["film_buf"])
            images, variances = list(st["images"]), list(st["variances"])
            self.host_tree = st["host_tree"]
            self._gen.set_state(torch.from_numpy(st["generator"]))
            log(f"resumed checkpoint: iteration {it}, "
                f"{passes_rendered}/{n_passes} passes")
        while passes_rendered < n_passes:
            spp_rendered = passes_rendered * self.spp_per_pass
            do_nee = self._do_nee(spp_rendered)
            remaining = n_passes - passes_rendered
            passes_this_iter = min(remaining, 1 << it)
            # merge-final rule (:1372-1374)
            if remaining - passes_this_iter < 2 * passes_this_iter:
                passes_this_iter = remaining
            is_final = passes_this_iter >= remaining
            log(f"ITERATION {it}, {passes_this_iter} passes "
                 f"(final={is_final}, nee={do_nee}, built={is_built})")

            # resetSDTree (:1108-1113)
            if sdtree is not None:
                self.host_tree.pull(sdtree)
            self.host_tree.refine_and_reset(
                it, self.spp_per_pass, self.s_tree_threshold,
                self.d_tree_threshold, self.sd_tree_max_mb)
            sdtree, film_buf, image, variance = self._render_passes(
                passes_this_iter, self._push(), is_built, do_nee, is_final,
                self._zeros())
            passes_rendered += passes_this_iter
            if self.sample_combination == "inversevar":
                images.append(image)
                variances.append(variance)

            # variance extrapolation (:1383-1391): divide by the remaining
            # passes before this iteration's are subtracted
            last_var = cur_var_at_end
            cur_var_at_end = (passes_this_iter * variance / remaining
                              if remaining > 0 else 0.0)
            remaining -= passes_this_iter
            if (self.sample_combination == "automatic" and remaining > 0
                    and (remaining < passes_this_iter
                         or (spp_rendered > 256
                             and cur_var_at_end > last_var))):
                log(f"FINAL {remaining} passes")
                sdtree, film_buf, image, variance = self._render_passes(
                    remaining, sdtree, is_built, do_nee, True, film_buf)
                passes_rendered += remaining
                if self.sample_combination == "inversevar":
                    images.append(image)
                    variances.append(variance)

            # buildSDTree (:1115-1189)
            self.host_tree.pull(sdtree)
            self.host_tree.build()
            self.tree_stats.append(self.host_tree.distribution_stats())
            sdtree = self._push()
            is_built = True
            if self.dump_sdtree and passes_rendered < n_passes:
                self._dump(it)
            it += 1
            if checkpoint:
                # the next iteration starts from here as it would have
                self._save_checkpoint(checkpoint, dict(
                    seed=seed, budget=budget, it=it,
                    passes_rendered=passes_rendered, is_built=is_built,
                    film_buf=tuple(b.cpu().numpy() for b in film_buf),
                    images=list(images), variances=list(variances),
                    cur_var_at_end=cur_var_at_end, host_tree=self.host_tree,
                    generator=self._gen.get_state().numpy()))

        self.sdtree = sdtree
        return self._final_image(images, variances, film_buf)

    def _final_image(self, images, variances, film_buf):
        """The inverse-variance mean of the last <= 4 iteration images
        (inversevar, :1567-1582), else the last film developed."""
        if self.sample_combination == "inversevar":
            k = min(len(images), 4)
            w = 1.0 / np.maximum(np.array(variances[-k:]), 1e-20)
            w /= w.sum()
            return sum(wi * im for wi, im in zip(w, images[-k:])).astype(
                np.float32)
        return Film.develop(self._to_image_buffers(film_buf)).cpu().numpy()

    def _render_time(self, seed):
        """renderTime (guided_path.cpp:1434-1514): a wall-clock budget of
        `budget` seconds; iteration i renders 2^i passes, and the automatic
        final extension repeats pass batches of that size until the budget
        runs out."""
        n_seconds = self.budget
        self._gen = generator(seed, self.device)
        sdtree = None
        is_built = False
        passes_rendered = 0
        it = 0
        images, variances = [], []
        film_buf = self._zeros()
        cur_var_at_end = np.inf
        start = time.time()
        elapsed = 0.0
        was_final = False
        while elapsed < n_seconds:
            spp_rendered = passes_rendered * self.spp_per_pass
            do_nee = self._do_nee(spp_rendered)
            # the budget still open when the iteration starts (:1457)
            remaining_time = n_seconds - elapsed
            passes_this_iter = 1 << it
            log(f"ITERATION {it}, {passes_this_iter} passes (time budget)")
            iter_start = time.time()
            if sdtree is not None:
                self.host_tree.pull(sdtree)
            self.host_tree.refine_and_reset(
                it, self.spp_per_pass, self.s_tree_threshold,
                self.d_tree_threshold, self.sd_tree_max_mb)
            sdtree, film_buf, image, variance = self._render_passes(
                passes_this_iter, self._push(), is_built, do_nee, False,
                self._zeros())
            passes_rendered += passes_this_iter
            if self.sample_combination == "inversevar":
                images.append(image)
                variances.append(variance)
            seconds_iter = time.time() - iter_start
            # divide by the iteration-start budget, then subtract
            # (:1475-1481)
            last_var = cur_var_at_end
            cur_var_at_end = (seconds_iter * variance / remaining_time
                              if remaining_time > 0 else 0.0)
            remaining_time -= seconds_iter
            if (self.sample_combination == "automatic" and remaining_time > 0
                    and (remaining_time < seconds_iter
                         or (spp_rendered > 256
                             and cur_var_at_end > last_var))):
                log(f"FINAL {remaining_time:.1f} seconds")
                was_final = True
                # a do-while (:1494-1500): at least one extension batch
                while True:
                    sdtree, film_buf, image, variance = self._render_passes(
                        passes_this_iter, sdtree, is_built, do_nee, True,
                        film_buf)
                    passes_rendered += passes_this_iter
                    if time.time() - start >= n_seconds:
                        break
            self.host_tree.pull(sdtree)
            self.host_tree.build()
            self.tree_stats.append(self.host_tree.distribution_stats())
            sdtree = self._push()
            is_built = True
            if self.dump_sdtree and not was_final:
                self._dump(it)
            it += 1
            elapsed = time.time() - start
        self.sdtree = sdtree
        return self._final_image(images, variances, film_buf)

    def _dump(self, it):
        """The host tree as <dump_path>-<it>.sdt, with the camera's matrix
        (nothing without a dump_path)."""
        if self.dump_path is None:
            return
        cam = np.asarray(self.sc.sensor.get("to_world", np.eye(4)))
        dump_sdtree(f"{self.dump_path}-{it:02d}.sdt", self.host_tree, cam)

"""Render drivers (counterpart of ppg_tpu/integrators/driver.py): the
image is a flat pool of pixels traced in fixed-size chunks, one wavefront
per chunk, into the film buffers of the scene's reconstruction filter."""

from __future__ import annotations

import numpy as np
import torch

from ..device import generator, rand, resolve
from ..render import samplers as S
from ..render.film import Film
from ..render.sensor import make_sensor
from ..scene.scene import MAT_COATING, MAT_MASK, MAT_NULL, MAT_ROUGHCOATING
from .wavefront import DeviceScene, PTConfig, check_supported, trace_paths


def make_config(sc, **overrides) -> PTConfig:
    """PTConfig from the scene's integrator properties and content, as in
    ppg_tpu; raises NotImplementedError for what the port lacks (the
    regenerative tracer's flags)."""
    ip = sc.integrator
    nee = str(ip.get("nee", "never"))
    mats = sc.materials
    mt = np.asarray(mats.mtype) if mats is not None else np.zeros(0)
    has = lambda f: bool(mats is not None
                         and np.any(np.asarray(getattr(mats, f)) >= 0))
    kw = dict(
        max_depth=int(ip.get("maxDepth", -1)),
        rr_depth=int(ip.get("rrDepth", 5)),
        strict_normals=bool(ip.get("strictNormals", False)),
        hide_emitters=bool(ip.get("hideEmitters", False)),
        do_nee=nee != "never",
        nee_always=nee == "always",
        bsdf_fraction=float(ip.get("bsdfSamplingFraction", 0.5)),
        has_env=sc.env_emitter is not None,
        has_tex=bool(sc.textures is not None and sc.textures.specs),
        has_tex_ewa=bool(
            sc.textures is not None
            and any(s.otype == "bitmap"
                    and str(s.props.get("filterType", "ewa")).lower()
                    == "ewa" for s in sc.textures.specs)),
        has_tex_opacity=has("tex_opacity"),
        has_mask=bool(np.any(mt == MAT_MASK)),
        has_null=bool(np.any(mt == MAT_NULL)),
        has_media=bool(getattr(sc, "media", None)),
        has_hetero=any(m.get("hetero") for m in getattr(sc, "media", None)
                       or ()),
        has_bump=has("tex_bump"),
        has_blend=has("nested2"),
        has_coating=bool(np.any(np.isin(mt, (MAT_COATING,
                                             MAT_ROUGHCOATING)))),
        has_vertexcolors=getattr(sc, "colors", None) is not None,
        has_wireframe=bool(
            sc.textures is not None
            and any(s.otype == "wireframe" for s in sc.textures.specs)),
        has_subsurf=any(r.get("kind", "dipole") == "dipole"
                        for r in getattr(sc, "subsurfaces", None) or ()),
        has_sss=any(r.get("kind", "dipole") == "singlescatter"
                    for r in getattr(sc, "subsurfaces", None) or ()),
        sampler=str(sc.sampler.get("type", "independent")),
    )
    kw.update(overrides)
    cfg = PTConfig(**kw)
    check_supported(cfg)
    return cfg


def chunk_pixels(sensor, chunk, pix_start, gen, sampler="independent",
                 sample_idx=0):
    """Camera rays of one pixel chunk: (ids, film positions jittered inside
    their pixels, (o, d, t_min, t_max)). The jitter is the sampler's
    dimensions 0-1 of sample `sample_idx`, or for the independent sampler
    two draws from `gen`; a camera with a lens then draws its aperture
    sample from `gen`."""
    dev = gen.device
    ids = pix_start + torch.arange(chunk, device=dev)
    px = (ids % sensor.W).to(torch.float32)
    py = torch.div(ids, sensor.W, rounding_mode="floor").to(torch.float32)
    if sampler != "independent":
        jitter = S.draw(sampler, ids, sample_idx, 0, gen, (chunk, 2))
    else:
        jitter = rand(gen, chunk, 2)
    pos = torch.stack([px, py], -1) + jitter
    u_lens = rand(gen, chunk, 2) if sensor.needs_lens_sample else None
    return ids, pos, sensor.sample_rays(pos, u_lens)


def ensure_subsurface(sc, scene):
    """Give the DeviceScene `scene` the dipole irradiance point cloud
    (scene.subsurf, subsurface.build_subsurface) and the single-scattering
    constants (scene.sss, singlescatter.build_sss) of the scene `sc`, each
    built once and kept on `sc` for its device, as ppg_tpu caches them;
    a no-op for scenes without subsurfaces. Returns `scene`."""
    rows = getattr(sc, "subsurfaces", None)
    if not rows:
        return scene
    key = str(scene.shade.device)
    kinds = {r.get("kind", "dipole") for r in rows}
    if "dipole" in kinds:
        cache = sc.__dict__.setdefault("_subsurf_cache", {})
        if key not in cache:
            from ..subsurface import build_subsurface

            cache[key] = build_subsurface(sc, scene)
        scene.subsurf = cache[key]
    if "singlescatter" in kinds:
        cache = sc.__dict__.setdefault("_sss_cache", {})
        if key not in cache:
            from ..singlescatter import build_sss

            cache[key] = build_sss(sc, scene)
        scene.sss = cache[key]
    return scene


def render(sc, spp, seed=0, chunk=1 << 16, cfg=None, device="cuda"):
    """Unguided render of `spp` samples per pixel with the scene's sensor,
    sampler and reconstruction filter; returns float32 [H,W,3] as
    numpy."""
    dev = resolve(device)
    scene = ensure_subsurface(sc, DeviceScene.from_scene(sc, dev))
    cfg = cfg or make_config(sc, guiding=False)
    W, H = sc.film["width"], sc.film["height"]
    sensor = make_sensor(sc.sensor, sc.film, dev)
    film = Film(W, H, sc.film.get("rfilter", "box"), dev)
    is_box = film.rfilter == "box"
    buffers = film.zeros_flat(chunk) if is_box else film.zeros()
    gen = generator(seed, dev)
    for s in range(spp):
        for c in range((W * H + chunk - 1) // chunk):
            ids, pos, rays = chunk_pixels(sensor, chunk, c * chunk, gen,
                                          cfg.sampler, s)
            out = trace_paths(scene, cfg, gen, *rays, pixel_ids=ids,
                              sample_idx=s, sensor=sensor)
            if is_box:
                film.splat_box_linear(buffers, c * chunk, out["li"],
                                      ids < W * H)
            else:
                film.splat(buffers, c * chunk, pos, out["li"])
    if is_box:
        buffers = film.unflatten(buffers)
    return Film.develop(buffers).cpu().numpy()

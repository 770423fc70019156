"""Scene flattening: PluginSpec tree -> SoA numpy arrays (the port's copy
of ppg_tpu/scene/scene.py; the zero-radius sun is not ported).

This replaces Mitsuba's Scene::initialize (reference librender/scene.cpp:
322-384): shapes expand to world-space triangles, BSDFs become rows of a
material parameter table, area emitters build per-triangle area CDFs and a
uniform scene-level emitter distribution (scene.cpp:376-381), and the scene
AABB feeds the guiding STree. Device upload happens in integrators via
`DeviceScene`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .shapes import build_shape
from .validate import Props
from .xml_parser import SceneXML, Spectrum


def _tcopy(props, **extra):
    """Copy a property dict; Props copies share read-tracking so the
    unqueried-property warnings see reads made through builder copies."""
    out = props.copy() if isinstance(props, Props) else dict(props)
    out.update(extra)
    return out

# Material type enum (device-side dispatch indices)
MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_ROUGHCONDUCTOR = 2
MAT_DIELECTRIC = 3
MAT_THINDIELECTRIC = 4
MAT_ROUGHDIELECTRIC = 5
MAT_PLASTIC = 6
MAT_ROUGHPLASTIC = 7
MAT_MASK = 8
MAT_NULL = 9
MAT_PHONG = 10
MAT_ROUGHDIFFUSE = 11
MAT_WARD = 12
MAT_DIFFTRANS = 13
MAT_BLEND = 14
MAT_COATING = 15
MAT_ROUGHCOATING = 16
MAT_HK = 17

MAT_NAMES = {
    "diffuse": MAT_DIFFUSE,
    "conductor": MAT_CONDUCTOR,
    "roughconductor": MAT_ROUGHCONDUCTOR,
    "dielectric": MAT_DIELECTRIC,
    "thindielectric": MAT_THINDIELECTRIC,
    "roughdielectric": MAT_ROUGHDIELECTRIC,
    "plastic": MAT_PLASTIC,
    "roughplastic": MAT_ROUGHPLASTIC,
    "mask": MAT_MASK,
    "null": MAT_NULL,
    "phong": MAT_PHONG,
    "roughdiffuse": MAT_ROUGHDIFFUSE,
    "ward": MAT_WARD,
    "difftrans": MAT_DIFFTRANS,
    "blendbsdf": MAT_BLEND,
    "mixturebsdf": MAT_BLEND,
    "coating": MAT_COATING,
    "roughcoating": MAT_ROUGHCOATING,
    "hk": MAT_HK,
}

# Scattering presets for the hk BSDF / homogeneous medium ("material"
# property). Measured data published in Jensen et al., "A Practical Model
# for Subsurface Light Transport" (SIGGRAPH'01) and Narasimhan et al.,
# "Acquiring Scattering Properties of Participating Media by Dilution"
# (SIGGRAPH'06); same entries as the reference's
# src/medium/materials.h::materialData (subset: the Jensen rows plus the
# most common dilution rows). Each row: (sigmaS rgb, sigmaA rgb, g rgb).
SCATTERING_PRESETS = {
    "apple": ([2.29, 2.39, 1.97], [0.0030, 0.0034, 0.046], [0, 0, 0]),
    "chicken1": ([0.15, 0.21, 0.38], [0.0015, 0.077, 0.19], [0, 0, 0]),
    "chicken2": ([0.19, 0.25, 0.32], [0.0018, 0.088, 0.20], [0, 0, 0]),
    "cream": ([7.38, 5.47, 3.15], [0.0002, 0.0028, 0.0163], [0, 0, 0]),
    "ketchup": ([0.18, 0.07, 0.03], [0.061, 0.97, 1.45], [0, 0, 0]),
    "marble": ([2.19, 2.62, 3.00], [0.0021, 0.0041, 0.0071], [0, 0, 0]),
    "potato": ([0.68, 0.70, 0.55], [0.0024, 0.0090, 0.12], [0, 0, 0]),
    "skimmilk": ([0.70, 1.22, 1.90], [0.0014, 0.0025, 0.0142], [0, 0, 0]),
    "skin1": ([0.74, 0.88, 1.01], [0.032, 0.17, 0.48], [0, 0, 0]),
    "skin2": ([1.09, 1.59, 1.79], [0.013, 0.070, 0.145], [0, 0, 0]),
    "spectralon": ([11.6, 20.4, 14.9], [0.0, 0.0, 0.0], [0, 0, 0]),
    "wholemilk": ([2.55, 3.21, 3.77], [0.0011, 0.0024, 0.014], [0, 0, 0]),
    "lowfat milk": ([13.1157, 15.4445, 17.9572],
                    [0.00287, 0.00575, 0.01150], [0.932, 0.902, 0.859]),
    "regular milk": ([18.2052, 20.3826, 22.3698],
                     [0.00153, 0.00460, 0.01993], [0.750, 0.714, 0.681]),
    "espresso": ([7.78262, 8.13050, 8.53875],
                 [4.79838, 6.57512, 8.84925], [0.907, 0.896, 0.880]),
    "coke": ([0.00254, 0.00299, 0.0],
             [0.10014, 0.16503, 0.24680], [0.965, 0.972, 0.0]),
    "sprite": ([0.00011, 0.00014, 0.00014],
               [0.00189, 0.00183, 0.00200], [0.943, 0.953, 0.952]),
    "chardonnay": ([0.00021, 0.00033, 0.00048],
                   [0.01078, 0.01186, 0.02400], [0.914, 0.958, 0.975]),
    "shampoo": ([0.00797, 0.00874, 0.01127],
                [0.01411, 0.04569, 0.06172], [0.910, 0.905, 0.920]),
    "sugar powder": ([0.00282, 0.00315, 0.00393],
                     [0.01264, 0.03105, 0.05012], [0.921, 0.919, 0.931]),
}

DIST_BECKMANN = 0
DIST_GGX = 1
DIST_PHONG = 2

# named IOR presets (reference libcore ior data; common subset)
_IOR = {
    "vacuum": 1.0,
    "air": 1.000277,
    "water": 1.3330,
    "glass": 1.5046,
    "bk7": 1.5046,
    "diamond": 2.419,
    "pyrex": 1.470,
    "acrylic glass": 1.49,
    "polypropylene": 1.49,
}


def _rgb(v, default):
    if v is None:
        return np.array(default, np.float64)
    if isinstance(v, Spectrum):
        return np.asarray(v.rgb, np.float64)
    v = np.asarray(v, np.float64)
    return np.full(3, float(v)) if v.ndim == 0 else v


def _ior(props, key, default):
    v = props.get(key, default)
    if isinstance(v, str):
        return _IOR[v.lower()]
    return float(v)


@dataclass
class MaterialTable:
    mtype: np.ndarray
    twosided: np.ndarray
    reflectance: np.ndarray  # diffuse albedo / diffuseReflectance
    specular: np.ndarray  # specularReflectance scale
    transmittance: np.ndarray  # specularTransmittance scale
    eta: np.ndarray  # conductor eta (rgb)
    k: np.ndarray  # conductor k (rgb)
    int_ior: np.ndarray
    ext_ior: np.ndarray
    alpha_u: np.ndarray
    alpha_v: np.ndarray
    dist: np.ndarray
    nonlinear: np.ndarray
    opacity: np.ndarray  # mask opacity (rgb)
    nested: np.ndarray  # nested material row (mask/bumpmap), -1 otherwise
    tex_reflectance: np.ndarray  # texture id or -1
    tex_opacity: np.ndarray
    tex_alpha: np.ndarray
    tex_bump: np.ndarray
    exponent: np.ndarray  # phong
    bump_is_normal: np.ndarray = None  # tex_bump holds a normal map
    nested2: np.ndarray = None  # second child (blend/mixture), -1 otherwise
    blend_w: np.ndarray = None  # probability of child 2
    sigma_s: np.ndarray = None  # [M,3] hk layer scattering coefficient
    sigma_a: np.ndarray = None  # [M,3] hk/coating layer absorption
    thickness: np.ndarray = None  # hk/coating layer thickness
    phase_g: np.ndarray = None  # hk phase anisotropy (0 = isotropic)
    # derived quantities (filled by _derive): relative IOR, 1/eta^2,
    # smooth-plastic internal diffuse Fresnel reflectance, specular sampling
    # weight, rough transmittance table + its internal diffuse average
    eta_rel: np.ndarray = None
    inv_eta2: np.ndarray = None
    fdr_int: np.ndarray = None
    spec_weight: np.ndarray = None
    rt_ext: np.ndarray = None
    rt_fdr_int: np.ndarray = None

    @staticmethod
    def empty():
        z3 = np.zeros((0, 3))
        z = np.zeros((0,))
        zi = np.zeros((0,), np.int32)
        zb = np.zeros((0,), bool)
        return MaterialTable(
            mtype=zi, twosided=zb, reflectance=z3, specular=z3,
            transmittance=z3, eta=z3, k=z3, int_ior=z, ext_ior=z,
            alpha_u=z, alpha_v=z, dist=zi, nonlinear=zb, opacity=z3,
            nested=zi, tex_reflectance=zi, tex_opacity=zi, tex_alpha=zi,
            tex_bump=zi, exponent=z, bump_is_normal=zb, nested2=zi,
            blend_w=z, sigma_s=z3, sigma_a=z3, thickness=z, phase_g=z,
            eta_rel=z, inv_eta2=z, fdr_int=z, spec_weight=z,
            rt_ext=np.zeros((0, 64)), rt_fdr_int=z,
        )


class MaterialBuilder:
    def __init__(self, textures):
        self.rows = []
        self.cache = {}
        self.textures = textures

    def add(self, spec):
        key = id(spec)
        if key in self.cache:
            return self.cache[key]
        row = self._build(spec, twosided=False)
        self.cache[key] = row
        return row

    @staticmethod
    def _defaults():
        return dict(
            mtype=MAT_DIFFUSE,
            twosided=False,
            reflectance=np.full(3, 0.5),
            specular=np.ones(3),
            transmittance=np.ones(3),
            eta=np.zeros(3),
            k=np.ones(3),
            int_ior=1.5046,
            ext_ior=1.000277,
            alpha_u=0.1,
            alpha_v=0.1,
            dist=DIST_BECKMANN,
            nonlinear=False,
            opacity=np.full(3, 0.5),
            nested=-1,
            tex_reflectance=-1,
            tex_opacity=-1,
            tex_alpha=-1,
            tex_bump=-1,
            exponent=30.0,
            bump_is_normal=False,
            nested2=-1,
            blend_w=0.5,
            sigma_s=np.zeros(3),
            sigma_a=np.zeros(3),
            thickness=1.0,
            phase_g=0.0,
        )

    def _texture(self, props, name):
        v = props.get(name)
        if hasattr(v, "cls") and getattr(v, "cls", None) == "texture":
            return self.textures.add(v), np.array([0.5, 0.5, 0.5])
        return -1, None

    def _build(self, spec, twosided):
        # unwrap adapters
        if spec.otype == "twosided":
            inner = spec.child("bsdf")
            if inner is None:
                raise ValueError("twosided: missing nested bsdf")
            return self._build(inner, twosided=True)
        if spec.otype in ("bumpmap", "normalmap"):
            # nested bsdf with a bump-height / normal texture: clone the
            # nested row and attach the perturbation texture
            inner = spec.child("bsdf")
            nested_row = self._build(inner, twosided=twosided)
            tex_spec = spec.child("texture")
            row = dict(self.rows[nested_row])
            if tex_spec is not None:
                tid = self.textures.add(tex_spec)
                row["tex_bump"] = tid
                row["bump_is_normal"] = spec.otype == "normalmap"
            self.rows.append(row)
            return len(self.rows) - 1

        if spec.otype in ("coating", "roughcoating"):
            # dielectric varnish layer over a nested BSDF (Weidlich-Wilkie;
            # reference src/bsdfs/coating.cpp:106-400 /
            # roughcoating.cpp:106-456). The nested BSDF must be a leaf
            # family here (nest coatings by flattening manually).
            inner = spec.child("bsdf")
            if inner is None:
                raise ValueError(f"{spec.otype}: missing nested bsdf")
            nested_row = self._build(inner, twosided=twosided)
            p = _tcopy(spec.props)
            d = dict(
                self._defaults(),
                mtype=(MAT_COATING if spec.otype == "coating"
                       else MAT_ROUGHCOATING),
                twosided=twosided,
                nested=nested_row,
                int_ior=_ior(p, "intIOR", "bk7"),
                ext_ior=_ior(p, "extIOR", "air"),
                thickness=float(p.get("thickness", 1.0)),
                sigma_a=_rgb(p.get("sigmaA"), [0, 0, 0]),
                specular=_rgb(p.get("specularReflectance"), [1, 1, 1]),
            )
            if spec.otype == "roughcoating":
                d["alpha_u"] = d["alpha_v"] = float(p.get("alpha", 0.1))
                d["dist"] = {"beckmann": 0, "ggx": 1, "phong": 2}[
                    p.get("distribution", "beckmann")]
            self.rows.append(d)
            return len(self.rows) - 1

        if spec.otype in ("blendbsdf", "mixturebsdf"):
            kids = [c for c in spec.children if c.cls == "bsdf"]
            if len(kids) != 2:
                raise NotImplementedError(
                    f"{spec.otype} supports exactly 2 nested BSDFs here "
                    f"(got {len(kids)}); nest blends for more")
            if spec.otype == "blendbsdf":
                w = float(spec.props.get("weight", 0.5))
            else:
                ws = [float(x) for x in
                      str(spec.props.get("weights", "0.5, 0.5")).split(",")]
                w = ws[1] / max(ws[0] + ws[1], 1e-9)
            r0 = self._build(kids[0], twosided=twosided)
            r1 = self._build(kids[1], twosided=twosided)
            row = dict(self._defaults(), mtype=MAT_BLEND, twosided=twosided,
                       nested=r0, nested2=r1, blend_w=w)
            self.rows.append(row)
            return len(self.rows) - 1

        d = dict(self._defaults(), mtype=MAT_NAMES.get(spec.otype),
                 twosided=twosided)
        if d["mtype"] is None:
            raise NotImplementedError(f"bsdf type {spec.otype!r}")

        p = _tcopy(spec.props)
        # nested texture children attach by their _name
        for c in spec.children_of("texture"):
            p[c.props.get("_name", "reflectance")] = c

        t = spec.otype
        if t in ("diffuse", "roughdiffuse"):
            tex, _ = self._texture(p, "reflectance")
            if tex >= 0:
                d["tex_reflectance"] = tex
            else:
                d["reflectance"] = _rgb(p.get("reflectance"), [0.5, 0.5, 0.5])
            d["alpha_u"] = d["alpha_v"] = float(p.get("alpha", 0.2))
        elif t in ("conductor", "roughconductor"):
            material = p.get("material", "cu")
            if material == "none":
                d["eta"] = np.zeros(3)
                d["k"] = np.ones(3)
            d["eta"] = _rgb(p.get("eta"), d["eta"])
            d["k"] = _rgb(p.get("k"), d["k"])
            d["specular"] = _rgb(p.get("specularReflectance"), [1, 1, 1])
            d["ext_ior"] = _ior(p, "extEta", 1.0)
            if t == "roughconductor":
                d["alpha_u"] = float(p.get("alphaU", p.get("alpha", 0.1)))
                d["alpha_v"] = float(p.get("alphaV", p.get("alpha", 0.1)))
                d["dist"] = {"beckmann": 0, "ggx": 1, "phong": 2}[
                    p.get("distribution", "beckmann")
                ]
        elif t in ("dielectric", "thindielectric", "roughdielectric"):
            d["int_ior"] = _ior(p, "intIOR", "bk7")
            d["ext_ior"] = _ior(p, "extIOR", "air")
            d["specular"] = _rgb(p.get("specularReflectance"), [1, 1, 1])
            d["transmittance"] = _rgb(p.get("specularTransmittance"), [1, 1, 1])
            if t == "roughdielectric":
                d["alpha_u"] = float(p.get("alphaU", p.get("alpha", 0.1)))
                d["alpha_v"] = float(p.get("alphaV", p.get("alpha", 0.1)))
                d["dist"] = {"beckmann": 0, "ggx": 1, "phong": 2}[
                    p.get("distribution", "beckmann")
                ]
        elif t in ("plastic", "roughplastic"):
            d["int_ior"] = _ior(p, "intIOR", "polypropylene")
            d["ext_ior"] = _ior(p, "extIOR", "air")
            tex, _ = self._texture(p, "diffuseReflectance")
            if tex >= 0:
                d["tex_reflectance"] = tex
            else:
                d["reflectance"] = _rgb(p.get("diffuseReflectance"), [0.5, 0.5, 0.5])
            d["specular"] = _rgb(p.get("specularReflectance"), [1, 1, 1])
            d["nonlinear"] = bool(p.get("nonlinear", False))
            if t == "roughplastic":
                d["alpha_u"] = d["alpha_v"] = float(p.get("alpha", 0.1))
                d["dist"] = {"beckmann": 0, "ggx": 1, "phong": 2}[
                    p.get("distribution", "beckmann")
                ]
        elif t == "mask":
            inner = spec.child("bsdf")
            d["nested"] = self._build(inner, twosided=twosided)
            tex, _ = self._texture(p, "opacity")
            if tex >= 0:
                d["tex_opacity"] = tex
            else:
                d["opacity"] = _rgb(p.get("opacity"), [0.5, 0.5, 0.5])
        elif t == "phong":
            d["exponent"] = float(p.get("exponent", 30.0))
            d["reflectance"] = _rgb(p.get("diffuseReflectance"), [0.5, 0.5, 0.5])
            d["specular"] = _rgb(p.get("specularReflectance"), [0.2, 0.2, 0.2])
        elif t == "ward":
            d["reflectance"] = _rgb(p.get("diffuseReflectance"), [0.5, 0.5, 0.5])
            d["specular"] = _rgb(p.get("specularReflectance"), [0.2, 0.2, 0.2])
            d["alpha_u"] = float(p.get("alphaU", p.get("alpha", 0.1)))
            d["alpha_v"] = float(p.get("alphaV", p.get("alpha", 0.1)))
        elif t == "difftrans":
            d["transmittance"] = _rgb(p.get("transmittance"), [0.5, 0.5, 0.5])
        elif t == "hk":
            # Hanrahan-Krueger single-scattering layer (src/bsdfs/hk.cpp):
            # preset material OR sigmaS/sigmaA OR sigmaT+albedo; phase
            # child (isotropic default / hg)
            ss, sa, g = SCATTERING_PRESETS[
                str(p.get("material", "skin1")).lower()]
            ss, sa, g = map(np.asarray, (ss, sa, g))
            ss = ss * (1.0 - g)  # similarity reduction (hk.cpp:119)
            if "sigmaT" in p or "albedo" in p:
                st = _rgb(p.get("sigmaT"), [1, 1, 1])
                al = _rgb(p.get("albedo"), [0.5, 0.5, 0.5])
                ss, sa = st * al, st * (1 - al)
            elif "sigmaS" in p or "sigmaA" in p:
                ss = _rgb(p.get("sigmaS"), ss)
                sa = _rgb(p.get("sigmaA"), sa)
            d["sigma_s"], d["sigma_a"] = ss, sa
            d["thickness"] = float(p.get("thickness", 1.0))
            ph = spec.child("phase")
            if ph is not None and ph.otype == "hg":
                d["phase_g"] = float(ph.props.get("g", 0.8))
            elif ph is not None and ph.otype != "isotropic":
                raise NotImplementedError(f"hk phase {ph.otype!r}")
        self.rows.append(d)
        return len(self.rows) - 1

    def finalize(self) -> MaterialTable:
        if not self.rows:
            return MaterialTable.empty()

        def col(name, dtype=np.float64):
            return np.array([r[name] for r in self.rows], dtype)

        table = self._make_table(col)
        _derive(table)
        return table

    def _make_table(self, col):
        return MaterialTable(
            mtype=col("mtype", np.int32),
            twosided=col("twosided", bool),
            reflectance=col("reflectance"),
            specular=col("specular"),
            transmittance=col("transmittance"),
            eta=col("eta"),
            k=col("k"),
            int_ior=col("int_ior"),
            ext_ior=col("ext_ior"),
            alpha_u=col("alpha_u"),
            alpha_v=col("alpha_v"),
            dist=col("dist", np.int32),
            nonlinear=col("nonlinear", bool),
            opacity=col("opacity"),
            nested=col("nested", np.int32),
            tex_reflectance=col("tex_reflectance", np.int32),
            tex_opacity=col("tex_opacity", np.int32),
            tex_alpha=col("tex_alpha", np.int32),
            tex_bump=col("tex_bump", np.int32),
            exponent=col("exponent"),
            bump_is_normal=col("bump_is_normal", bool),
            nested2=col("nested2", np.int32),
            blend_w=col("blend_w"),
            sigma_s=col("sigma_s"),
            sigma_a=col("sigma_a"),
            thickness=col("thickness"),
            phase_g=col("phase_g"),
        )


def _derive(t: MaterialTable):
    """Fill the derived per-material quantities (plastic/roughplastic energy
    bookkeeping; reference rtrans.h + plastic.cpp:167-180 m_fdrInt etc.)."""
    from ..bsdf.derived import (
        RT_BINS,
        diffuse_transmittance,
        rough_transmittance_table,
    )
    from ..bsdf.fresnel import fresnel_diffuse_reflectance

    M = len(t.mtype)
    t.eta_rel = t.int_ior / np.maximum(t.ext_ior, 1e-9)
    t.inv_eta2 = 1.0 / np.maximum(t.eta_rel, 1e-9) ** 2
    t.fdr_int = np.zeros(M)
    t.spec_weight = np.zeros(M)
    t.rt_ext = np.ones((M, RT_BINS))
    t.rt_fdr_int = np.zeros(M)

    for i in range(M):
        mt = t.mtype[i]
        if mt == MAT_PLASTIC:
            t.fdr_int[i] = fresnel_diffuse_reflectance(1.0 / t.eta_rel[i])
            s_avg = t.specular[i].mean()
            d_avg = t.reflectance[i].mean()
            t.spec_weight[i] = s_avg / max(d_avg + s_avg, 1e-9)
        elif mt == MAT_ROUGHPLASTIC:
            dist = int(t.dist[i])
            alpha = float(t.alpha_u[i])
            eta = float(t.eta_rel[i])
            t.rt_ext[i] = rough_transmittance_table(dist, alpha, eta)
            rt_int = rough_transmittance_table(dist, alpha, 1.0 / eta)
            t.rt_fdr_int[i] = 1.0 - diffuse_transmittance(rt_int)
            s_avg = t.specular[i].mean()
            d_avg = t.reflectance[i].mean()
            t.spec_weight[i] = s_avg / max(d_avg + s_avg, 1e-9)
        elif mt in (MAT_COATING, MAT_ROUGHCOATING):
            # specularSamplingWeight = 1/(avgAbsorption+1)
            # (coating.cpp:197-202 / roughcoating.cpp:197-202)
            avg_abs = float(
                np.exp(-2.0 * t.thickness[i] * t.sigma_a[i]).mean())
            t.spec_weight[i] = 1.0 / (avg_abs + 1.0)
            if mt == MAT_ROUGHCOATING:
                t.rt_ext[i] = rough_transmittance_table(
                    int(t.dist[i]), float(t.alpha_u[i]), float(t.eta_rel[i]))


class TextureBuilder:
    """Collects bitmap textures into a list (atlas upload done lazily)."""

    def __init__(self, scene_xml):
        self.scene_xml = scene_xml
        self.specs = []

    def add(self, spec):
        self.specs.append(spec)
        return len(self.specs) - 1


@dataclass
class EmitterTable:
    radiance: np.ndarray  # [E, 3]
    tri_offset: np.ndarray  # [E]
    tri_count: np.ndarray  # [E]
    tri_ids: np.ndarray  # [sum counts] global triangle indices
    tri_cdf: np.ndarray  # [sum counts] per-emitter normalized area CDF
    inv_area: np.ndarray  # [E] 1 / total shape surface area
    num: int = 0


@dataclass
class SceneData:
    # triangle soup (world space)
    positions: np.ndarray  # [V, 3]
    faces: np.ndarray  # [F, 3]
    normals: np.ndarray  # [V, 3] shading normals
    texcoords: np.ndarray  # [V, 2]
    tri_mat: np.ndarray  # [F]
    tri_emitter: np.ndarray  # [F], -1 if not emissive
    colors: np.ndarray = None  # [V, 3] vertex colors, None if unused
    materials: MaterialTable = None
    emitters: EmitterTable = None
    textures: TextureBuilder = None
    sensor: dict = field(default_factory=dict)
    film: dict = field(default_factory=dict)
    integrator: dict = field(default_factory=dict)
    sampler: dict = field(default_factory=dict)
    env_emitter: object = None
    delta_emitters: list = field(default_factory=list)
    media: list = field(default_factory=list)
    tri_medium: np.ndarray = None  # [F] interior medium id, -1 = none
    subsurfaces: list = field(default_factory=list)
    tri_subsurf: np.ndarray = None  # [F] subsurface id, -1 = none
    aabb_min: np.ndarray = None
    aabb_max: np.ndarray = None
    xml_root: object = None  # PluginSpec tree (unqueried-prop warnings)
    xml_path: str = ""

    @property
    def num_tris(self):
        return len(self.faces)


def _resolve_xfov(sensor_props, W, H):
    """PerspectiveCamera fovAxis handling (librender/sensor.cpp:241-276);
    with no fov given the default is a 50mm focal length."""
    aspect = W / H
    fov = float(sensor_props.get("fov", 0.0))
    axis = str(sensor_props.get("fovAxis", "x")).lower()
    if "fov" not in sensor_props and "focalLength" not in sensor_props:
        sensor_props = dict(sensor_props, focalLength="50mm")
    if "focalLength" in sensor_props:
        fl = float(str(sensor_props["focalLength"]).replace("mm", ""))
        fov = 2 * np.rad2deg(np.arctan(np.sqrt(36.0**2 + 24.0**2) / (2 * fl)))
        axis = "diagonal"
    if axis == "smaller":
        axis = "y" if aspect > 1 else "x"
    elif axis == "larger":
        axis = "x" if aspect > 1 else "y"
    if axis == "x":
        return fov
    if axis == "y":
        t = np.tan(np.deg2rad(fov) / 2) * aspect
        return 2 * np.rad2deg(np.arctan(t))
    if axis == "diagonal":
        diag = np.sqrt(1 + 1 / (aspect * aspect))
        t = np.tan(np.deg2rad(fov) / 2) / diag
        return 2 * np.rad2deg(np.arctan(t))
    raise ValueError(f"bad fovAxis {axis}")


def build_scene(xml: SceneXML, missing_ok=True) -> SceneData:
    textures = TextureBuilder(xml)
    mats = MaterialBuilder(textures)

    all_pos, all_faces, all_norm, all_uv, all_col = [], [], [], [], []
    any_colors = False
    tri_mat, tri_emitter, tri_medium, tri_subsurf = [], [], [], []
    subsurf_rows = []
    emitter_rows = []
    media_rows = []
    vert_base = 0

    medium_cache = {}

    def add_medium(spec):
        """homogeneous medium (src/medium/homogeneous.cpp): sigmaS+sigmaA
        or sigmaT+albedo, x scale; heterogeneous medium
        (src/medium/heterogeneous.cpp): gridvolume/constvolume density +
        constvolume albedo, Woodcock tracking; phase child (isotropic
        default, hg g). Media referenced by <ref> share one row."""
        if id(spec) in medium_cache:
            return medium_cache[id(spec)]
        if spec.otype not in ("homogeneous", "heterogeneous"):
            raise NotImplementedError(f"medium type {spec.otype!r}")
        pr = spec.props
        scale = float(pr.get("scale", 1.0))
        g = 0.0
        kkay = {}
        ph = spec.child("phase")
        if ph is not None and ph.otype == "hg":
            g = float(ph.props.get("g", 0.8))
        elif ph is not None and ph.otype == "rayleigh":
            from ..media import RAYLEIGH_G

            g = RAYLEIGH_G
        elif ph is not None and ph.otype == "kkay":
            from ..media import KKAY_G

            g = KKAY_G
            kkay = dict(
                ks=float(ph.props.get("ks", 0.4)),
                kd=float(ph.props.get("kd", 0.2)),
                exponent=float(ph.props.get("exponent", 4.0)),
                # constant fiber orientation (the reference reads it from
                # the medium's orientation volume; constvolume subset)
                orientation=np.asarray(
                    pr.get("orientation", [0.0, 0.0, 1.0]), np.float64))
        elif ph is not None and ph.otype == "microflake":
            # SGGX fiber microflake (src/phase/microflake.cpp): stddev of
            # the gaussian fiber distribution; the fiber axis comes from
            # the medium's orientation volume (gridvolume, 3 channels) or
            # a constant `orientation` property
            from ..media import MICROFLAKE_G

            g = MICROFLAKE_G
            kkay = dict(
                stddev=float(ph.props.get("stddev", 0.25)),
                orientation=np.asarray(
                    pr.get("orientation", [0.0, 0.0, 1.0]), np.float64))
        elif ph is not None and ph.otype not in ("isotropic",):
            raise NotImplementedError(f"phase type {ph.otype!r}")

        if spec.otype == "heterogeneous":
            vols = {c.props.get("_name", "density"): c
                    for c in spec.children_of("volume")}
            dens_spec = vols.get("density")
            if dens_spec is None:
                raise ValueError("heterogeneous medium: missing density")
            if dens_spec.otype == "gridvolume":
                from ..io.vol import read_vol

                data, bmin, bmax = read_vol(
                    xml.resolve_path(dens_spec.props["filename"]))
                if data.shape[-1] != 1:
                    raise NotImplementedError(
                        "heterogeneous density must be scalar "
                        "(spectrally uniform sigmaT, heterogeneous.cpp:109)")
                dens = data[..., 0]
            elif dens_spec.otype == "constvolume":
                dens = np.full((2, 2, 2),
                               float(dens_spec.props.get("value", 1.0)),
                               np.float32)
                bmin = np.asarray(pr.get("aabb_min", [-1e3] * 3), np.float64)
                bmax = np.asarray(pr.get("aabb_max", [1e3] * 3), np.float64)
            else:
                raise NotImplementedError(
                    f"density volume {dens_spec.otype!r}")
            ori_spec = vols.get("orientation", vols.get("orientations"))
            if ori_spec is not None:
                if ori_spec.otype == "gridvolume":
                    from ..io.vol import read_vol

                    odata, _, _ = read_vol(
                        xml.resolve_path(ori_spec.props["filename"]))
                    if odata.shape[-1] != 3:
                        raise ValueError("orientation volume must have "
                                         "3 channels")
                    kkay = dict(kkay, orientation_grid=odata)
                elif ori_spec.otype == "constvolume":
                    kkay = dict(kkay, orientation=np.asarray(
                        ori_spec.props.get("value", [0, 0, 1]), np.float64))
            alb_spec = vols.get("albedo")
            if alb_spec is not None:
                if alb_spec.otype != "constvolume":
                    raise NotImplementedError(
                        "only constvolume albedo is supported")
                al = _rgb(alb_spec.props.get("value"), [0.5, 0.5, 0.5])
            else:
                al = _rgb(pr.get("albedo"), [0.9, 0.9, 0.9])
            media_rows.append(dict(
                **kkay,
                hetero=True, density=dens, bbox_min=bmin, bbox_max=bmax,
                to_world=np.asarray(
                    dens_spec.props.get("toWorld",
                                        pr.get("toWorld", np.eye(4)))),
                scale=scale, albedo=al, g=g))
        else:
            if "sigmaT" in pr or "albedo" in pr:
                st = _rgb(pr.get("sigmaT"), [1, 1, 1]) * scale
                al = _rgb(pr.get("albedo"), [0.5, 0.5, 0.5])
            else:
                ss = _rgb(pr.get("sigmaS"), [0.5, 0.5, 0.5]) * scale
                sa = _rgb(pr.get("sigmaA"), [0.5, 0.5, 0.5]) * scale
                st = ss + sa
                al = np.where(st > 0, ss / np.maximum(st, 1e-30), 0.0)
            media_rows.append(dict(sigma_t=st, albedo=al, g=g, **kkay))
        medium_cache[id(spec)] = len(media_rows) - 1
        return medium_cache[id(spec)]

    env_emitter = None
    delta_emitters = []
    for em in xml.root.children_of("emitter"):
        t = em.otype
        p = em.props
        if t in ("envmap", "constant", "sky", "sun", "sunsky"):
            if (t in ("sun", "sunsky")
                    and float(p.get("sunRadiusScale", 1.0)) <= 0):
                # sun.cpp:153-166: zero apparent radius -> the sun becomes
                # a directional delta emitter (ppg_tpu's
                # emitters/sunsky.directional_sun, with its data file)
                raise NotImplementedError(
                    "a sun with sunRadiusScale <= 0 needs the sun/sky "
                    "emitters, which are not ported yet (ROADMAP Queue 1 "
                    "item 2c)")
            else:
                env_emitter = em  # handled by emitters.envmap / sunsky
        elif t == "point":
            delta_emitters.append(dict(
                type=0,
                position=_rgb(p.get("position"), [0, 0, 0]),
                intensity=_rgb(p.get("intensity"), [1, 1, 1]),
            ))
        elif t == "spot":
            M = np.asarray(p.get("toWorld", np.eye(4)))
            cut = float(p.get("cutoffAngle", 20.0))
            delta_emitters.append(dict(
                type=1,
                position=M[:3, 3],
                direction=M[:3, :3] @ np.array([0.0, 0.0, 1.0]),
                intensity=_rgb(p.get("intensity"), [1, 1, 1]),
                cutoff_deg=cut,
                beamwidth_deg=float(p.get("beamWidth", cut * 3.0 / 4.0)),
            ))
        elif t == "directional":
            delta_emitters.append(dict(
                type=2,
                direction=_rgb(p.get("direction"), [0, 0, 1]),
                intensity=_rgb(p.get("irradiance"), [1, 1, 1]),
            ))
        elif t == "collimated":
            # 0D response: sampleDirect always fails in the reference
            # (collimated.cpp sampleDirect pdf=0), so a unidirectional
            # path tracer gets NO contribution from it — parse + warn for
            # parity, contribute nothing (same as the reference here)
            import warnings

            warnings.warn(
                "collimated emitter contributes nothing to unidirectional "
                "path tracing (matches the reference's sampleDirect "
                "failure); use an area/spot light instead")
        else:
            raise NotImplementedError(f"scene-level emitter {t!r}")

    # expand instance/shapegroup: a shapegroup is a container (never
    # rendered directly, src/shapes/shapegroup.cpp); an instance stamps the
    # referenced group's shapes with its own toWorld (src/shapes/instance.cpp)
    expanded = []  # (shape_spec, extra_world_transform | None)
    for shape in xml.root.children_of("shape"):
        if shape.otype == "shapegroup":
            continue
        if shape.otype == "instance":
            group = shape.child("shape", "shapegroup")
            if group is None:
                raise ValueError("instance: missing <ref> to a shapegroup")
            xf = np.asarray(shape.props.get("toWorld", np.eye(4)))
            expanded.extend((child, xf) for child in
                            group.children_of("shape"))
        else:
            expanded.append((shape, None))

    for shape, extra_xf in expanded:
        try:
            mesh = build_shape(shape, xml)
        except FileNotFoundError:
            if missing_ok:
                continue
            raise
        if extra_xf is not None:
            mesh.apply_transform(extra_xf)

        bspec = shape.child("bsdf")
        if bspec is None and shape.child("subsurface") is not None:
            # a subsurface shape without a BSDF gets an all-absorbing
            # one (shape.cpp:49-56): the boundary transport is owned by
            # the subsurface model, not a default Lambertian
            bspec = _black_bsdf()
        mat_id = mats.add(bspec if bspec is not None else _default_bsdf())

        espec = shape.child("emitter")
        emitter_id = -1
        if espec is not None:
            if espec.otype != "area":
                raise NotImplementedError(f"shape emitter {espec.otype!r}")
            radiance = _rgb(espec.props.get("radiance"), [1, 1, 1])
            fn, areas = mesh.face_normals_areas()
            total = areas.sum()
            emitter_rows.append(
                dict(
                    radiance=radiance,
                    tri_start=len(tri_mat),
                    n_tris=len(mesh.faces),
                    areas=areas,
                    inv_area=1.0 / max(total, 1e-30),
                )
            )
            emitter_id = len(emitter_rows) - 1

        F = len(mesh.faces)
        all_pos.append(mesh.positions)
        all_faces.append(mesh.faces + vert_base)
        all_norm.append(
            mesh.normals
            if mesh.normals is not None
            else np.zeros_like(mesh.positions)
        )
        uv = (
            mesh.texcoords
            if mesh.texcoords is not None
            else np.zeros((len(mesh.positions), 2))
        )
        all_uv.append(uv)
        if getattr(mesh, "colors", None) is not None:
            any_colors = True
            all_col.append(mesh.colors)
        else:
            all_col.append(np.ones((len(mesh.positions), 3)))
        tri_mat.extend([mat_id] * F)
        tri_emitter.extend([emitter_id] * F)
        med_spec = shape.child("medium")
        med_id = add_medium(med_spec) if med_spec is not None else -1
        tri_medium.extend([med_id] * F)
        ss_spec = shape.child("subsurface")
        ss_id = -1
        if ss_spec is not None:
            if ss_spec.otype not in ("dipole", "singlescatter"):
                raise NotImplementedError(
                    f"subsurface type {ss_spec.otype!r}")
            sp = ss_spec.props
            scale = float(sp.get("scale", 1.0))
            if "material" in sp:
                ss_v, sa_v, g_v = SCATTERING_PRESETS[
                    str(sp["material"]).lower()]
                ss_s = np.asarray(ss_v, np.float64) * scale
                ss_a = np.asarray(sa_v, np.float64) * scale
                g_v = np.asarray(g_v, np.float64)
            elif "sigmaT" in sp or "albedo" in sp:
                # sigmaT/albedo alternative (medium/materials.h):
                # sigma_s = albedo * sigma_t, sigma_a = sigma_t - sigma_s
                st = _rgb(sp.get("sigmaT"), [2.55, 3.21, 3.77]) * scale
                al = _rgb(sp.get("albedo"), [0.99, 0.99, 0.99])
                ss_s = al * st
                ss_a = st - ss_s
                g_v = _rgb(sp.get("g"), [0, 0, 0])
            else:
                ss_s = _rgb(sp.get("sigmaS"), [2.55, 3.21, 3.77]) * scale
                ss_a = _rgb(sp.get("sigmaA"),
                            [0.0011, 0.0024, 0.014]) * scale
                g_v = _rgb(sp.get("g"), [0, 0, 0])
            g_m = float(np.mean(g_v))
            row = dict(
                sigma_s=ss_s, sigma_a=ss_a, g=g_m, g3=g_v,
                kind=ss_spec.otype,
                irr_samples=int(sp.get("irrSamples", 16)),
                sample_mult=float(sp.get("sampleMultiplier", 1.0)),
                tri_start=len(tri_mat) - F, n_tris=F)
            if ss_spec.otype == "singlescatter":
                # eta comes from the subsurface's child BSDF
                # (singlescatter.cpp configure(): m_BSDF->getEta());
                # fast-path knobs per the plugin ctor (:117-151)
                child_bsdf = ss_spec.child("bsdf")
                bp = child_bsdf.props if child_bsdf is not None else {}
                row["eta"] = (_ior(bp, "intIOR", 1.5046)
                              / _ior(bp, "extIOR", 1.000277))
                row["fast"] = bool(sp.get("fastSingleScatter", True))
                row["fss_samples"] = int(sp.get("fssSamples", 2))
                row["ss_depth"] = int(sp.get("singleScatterDepth", 4))
                if isinstance(sp, Props):
                    sp.mark_read("singleScatterShadowRays",
                                 "singleScatterTransmittance")
            else:
                row["eta"] = (_ior(sp, "intIOR", 1.3)
                              / _ior(sp, "extIOR", 1.000277))
            subsurf_rows.append(row)
            ss_id = len(subsurf_rows) - 1
        tri_subsurf.extend([ss_id] * F)
        vert_base += len(mesh.positions)

    positions = np.concatenate(all_pos) if all_pos else np.zeros((0, 3))
    faces = np.concatenate(all_faces) if all_faces else np.zeros((0, 3), np.int32)
    normals = np.concatenate(all_norm) if all_norm else np.zeros((0, 3))
    texcoords = np.concatenate(all_uv) if all_uv else np.zeros((0, 2))
    colors = np.concatenate(all_col) if any_colors else None

    curv_specs = [s for s in textures.specs if s.otype == "curvature"]
    if curv_specs and colors is None and len(faces):
        # bake the curvature gradient into vertex colors; read lane-side
        # through the vertexcolors path (see TextureAtlas.build)
        sp = curv_specs[0].props
        colors = curvature_colors(
            positions, faces,
            show_k=str(sp.get("curvature", "gaussian")) == "gaussian",
            scale=float(sp.get("scale", 1.0)))

    # emitter CDFs over triangle areas (TriMesh::samplePosition semantics)
    offs, cnts, ids, cdfs, invs, rads = [], [], [], [], [], []
    pos = 0
    for row in emitter_rows:
        areas = row["areas"]
        cdf = np.cumsum(areas)
        cdf = cdf / cdf[-1]
        offs.append(pos)
        cnts.append(len(areas))
        ids.extend(range(row["tri_start"], row["tri_start"] + row["n_tris"]))
        cdfs.extend(cdf)
        invs.append(row["inv_area"])
        rads.append(row["radiance"])
        pos += len(areas)
    emitters = EmitterTable(
        radiance=np.array(rads).reshape(-1, 3),
        tri_offset=np.array(offs, np.int32),
        tri_count=np.array(cnts, np.int32),
        tri_ids=np.array(ids, np.int32),
        tri_cdf=np.array(cdfs),
        inv_area=np.array(invs),
        num=len(emitter_rows),
    )

    sensor_spec = xml.root.child("sensor")
    film_spec = sensor_spec.child("film") if sensor_spec else None
    sampler_spec = sensor_spec.child("sampler") if sensor_spec else None
    rfilter_spec = film_spec.child("rfilter") if film_spec else None
    integrator_spec = xml.root.child("integrator")

    W = int(film_spec.props.get("width", 768)) if film_spec else 768
    H = int(film_spec.props.get("height", 576)) if film_spec else 576

    sensor = {}
    if sensor_spec is not None:
        sensor = _tcopy(sensor_spec.props)
        sensor["type"] = sensor_spec.otype
        sensor["to_world"] = sensor_spec.props.get("toWorld", np.eye(4))
        if sensor_spec.otype in ("perspective", "thinlens"):
            sensor["xfov"] = _resolve_xfov(sensor_spec.props, W, H)
        sensor["near_clip"] = float(sensor_spec.props.get("nearClip", 1e-2))
        sensor["far_clip"] = float(sensor_spec.props.get("farClip", 1e4))

    film = _tcopy(film_spec.props) if film_spec is not None else {}
    film.update(width=W, height=H)
    # parameters the reference plugins query but that are deliberate
    # no-ops here (banner overlay, RNG seed — we use counter-based
    # streams, a documented deviation; shutter interval — no motion
    # blur; perspective focusDistance is only used by thinlens)
    for spec_, keys in ((film_spec, ("banner", "highQualityEdges",
                                     "attachLog")),
                        (sampler_spec, ("seed",)),
                        (sensor_spec, ("focusDistance", "shutterOpen",
                                       "shutterClose"))):
        if spec_ is not None and isinstance(spec_.props, Props):
            spec_.props.mark_read(*keys)
    if film_spec is not None:
        film["type"] = film_spec.otype
    film["rfilter"] = rfilter_spec.otype if rfilter_spec is not None else "gaussian"

    if positions.size:
        aabb_min = positions.min(axis=0)
        aabb_max = positions.max(axis=0)
    else:
        aabb_min = np.zeros(3)
        aabb_max = np.ones(3)

    return SceneData(
        positions=positions,
        faces=faces,
        normals=normals,
        texcoords=texcoords,
        colors=colors,
        tri_mat=np.array(tri_mat, np.int32),
        tri_emitter=np.array(tri_emitter, np.int32),
        materials=mats.finalize(),
        emitters=emitters,
        textures=textures,
        sensor=sensor,
        film=film,
        integrator=(
            _tcopy(integrator_spec.props, type=integrator_spec.otype)
            if integrator_spec
            else {"type": "path"}
        ),
        sampler=(
            _tcopy(sampler_spec.props, type=sampler_spec.otype)
            if sampler_spec
            else {"type": "independent", "sampleCount": 4}
        ),
        env_emitter=env_emitter,
        delta_emitters=delta_emitters,
        media=media_rows,
        tri_medium=np.array(tri_medium, np.int32),
        subsurfaces=subsurf_rows,
        tri_subsurf=np.array(tri_subsurf, np.int32),
        aabb_min=aabb_min,
        aabb_max=aabb_max,
    )


_DEFAULT_BSDF = None


def _default_bsdf():
    global _DEFAULT_BSDF
    if _DEFAULT_BSDF is None:
        from .xml_parser import PluginSpec

        _DEFAULT_BSDF = PluginSpec("bsdf", "diffuse")
    return _DEFAULT_BSDF


_BLACK_BSDF = None


def _black_bsdf():
    global _BLACK_BSDF
    if _BLACK_BSDF is None:
        from .xml_parser import PluginSpec

        _BLACK_BSDF = PluginSpec("bsdf", "diffuse",
                                 props={"reflectance": [0.0, 0.0, 0.0]})
    return _BLACK_BSDF


def load_scene(path, defaults=None, missing_ok=True) -> SceneData:
    xml = SceneXML(path, defaults)
    sc = build_scene(xml, missing_ok=missing_ok)
    # keep the spec tree so callers can emit unqueried-property warnings
    # (properties.h:46 analog) once the integrator/sensor have consumed
    # their parameters — the CLI does this after tracer construction
    sc.xml_root = xml.root
    sc.xml_path = path
    return sc


def curvature_colors(positions, faces, show_k=True, scale=1.0):
    """Per-vertex mean/Gaussian curvature baked to the reference's
    red/blue gradient (curvature.cpp:74-87: negative -> blue, positive
    -> red, |v|*scale clamped to 1). K via the angle-defect formula,
    H via the cotangent Laplacian with the vertex normal fixing the
    sign — standard discrete estimates standing in for Mitsuba's
    per-shape getCurvature()."""
    V = len(positions)
    p = positions[faces].astype(np.float64)  # [F,3,3]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    a2 = np.linalg.norm(fn, axis=-1)
    area = 0.5 * a2
    fn_unit = fn / np.maximum(a2, 1e-30)[:, None]

    ang_sum = np.zeros(V)
    area_sum = np.zeros(V)
    lap = np.zeros((V, 3))
    vnorm = np.zeros((V, 3))
    for i in range(3):
        vi = faces[:, i]
        u = p[:, (i + 1) % 3] - p[:, i]
        w = p[:, (i + 2) % 3] - p[:, i]
        cosang = np.sum(u * w, -1) / np.maximum(
            np.linalg.norm(u, axis=-1) * np.linalg.norm(w, axis=-1), 1e-30)
        ang = np.arccos(np.clip(cosang, -1.0, 1.0))
        np.add.at(ang_sum, vi, ang)
        np.add.at(area_sum, vi, area / 3.0)
        np.add.at(vnorm, vi, fn)
        # cotangent term: the angle at corner i is opposite edge
        # (i+1, i+2); accumulate cot(ang) * (p_a - p_b) on both ends
        cot = cosang / np.maximum(np.sqrt(np.maximum(
            1.0 - cosang * cosang, 1e-30)), 1e-30)
        va, vb = faces[:, (i + 1) % 3], faces[:, (i + 2) % 3]
        d = p[:, (i + 2) % 3] - p[:, (i + 1) % 3]
        np.add.at(lap, va, cot[:, None] * d)
        np.add.at(lap, vb, -cot[:, None] * d)

    if show_k:
        val = (2.0 * np.pi - ang_sum) / np.maximum(area_sum, 1e-30)
    else:
        hn = lap / np.maximum(4.0 * area_sum, 1e-30)[:, None]
        mag = np.linalg.norm(hn, axis=-1)
        # the discrete mean-curvature vector points toward the concave
        # side; convex (sphere-like) surfaces get POSITIVE H
        sign = -np.sign(np.sum(hn * vnorm, -1))
        val = mag * np.where(sign == 0, 1.0, sign)

    out = np.zeros((V, 3), np.float32)
    out[:, 0] = np.clip(np.where(val > 0, val * scale, 0.0), 0.0, 1.0)
    out[:, 2] = np.clip(np.where(val < 0, -val * scale, 0.0), 0.0, 1.0)
    return out

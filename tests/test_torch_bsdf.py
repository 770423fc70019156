"""The port's BSDF table (ppg_tpu_torch/bsdf/bsdf.py) against ppg_tpu's on
the same numpy inputs: eval_bsdf, pdf_bsdf and sample_bsdf for every leaf
family of tests/test_bsdf_gof.py's FAMILIES and DELTA_FAMILIES, GGX
roughplastic and roughdielectric and a two-sided roughconductor, each
row on 1,000 lanes of wi and wo over both hemispheres and uniforms from
a seed, through ppg_tpu eagerly (with its `present`) and through the
port fed the same material rows (convert.materials_from_numpy).

Tolerances:
- eval and pdf (EVAL_RTOL 2e-5 of each value, EVAL_ATOL 1e-6 of the
  row's largest): closed forms whose only difference is XLA's and ATen's
  float32 exp, pow, sqrt, sin and cos, a few ulp each (largest seen
  5.5e-6 relative, roughdielectric's pdf).
- sample_bsdf: wo within SAMPLE_WO_ATOL 1e-4 and weight and pdf within
  SAMPLE_RTOL 2e-3 (relative, above 1e-6 of the row's largest value).
  The cosine and Phong warps carry the libms' sin/cos into z = sqrt(1 -
  r^2) (about 6e-8 / z near the horizon), and the microfacet rows add
  the visible-normal sample, whose Beckmann rounds run on XLA's and
  ATen's different erfinv (test_torch_microfacet.py): a normal a few
  1e-6 apart moves the sampled wo by as much and the pdf and weight of a
  narrow lobe by up to some 6e-4 (largest seen: wo 4.0e-5, the
  two-sided row's grazing lanes; weight and pdf 6.4e-4).
- sampled_delta and eta exactly; the lobe picks (u <= F) fall the same
  way on every lane of these inputs.

Where the port repairs a fault of ppg_tpu's, it is held to the
distribution instead (tests/test_torch_bsdf_gof.py has the chi-square
tests): GGX's visible normals take Heitz's disk basis
(test_torch_microfacet.py), so the GGX rows' samples are held to their
own eval and pdf and to ppg_tpu's pdf at the port's directions; and
roughdielectric, for wi below the surface, draws its normals for -wi and
keeps them on the upper side, as Mitsuba's roughdielectric.cpp does,
where ppg_tpu flips only wi's z and then the normal, which samples the
glass-to-air side with the air-to-glass Fresnel term and does not follow
its pdf: those lanes' pdf and samples are not compared with ppg_tpu's
(their eval is), and the pdf is 0 where no microfacet seen from both
wi's and wo's side takes wi to wo (ppg_tpu's is positive there, where
its f is 0). The rows themselves: materials_from_numpy carries ppg_tpu's
packed rows bit for bit, and the port's own loader
(scene/scene.py::MaterialBuilder) packs every row here as ppg_tpu's
does, bit for bit. sample_bsdf's one visible-normal call equals the
three per-family calls and a select bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppg_tpu.bsdf import bsdf as JB
from ppg_tpu.scene.scene import MaterialBuilder as JBuilder
from ppg_tpu.scene.scene import TextureBuilder as JTextures
from ppg_tpu.scene.xml_parser import PluginSpec as JSpec
from ppg_tpu.scene.xml_parser import Spectrum as JSpectrum
from ppg_tpu_torch.bsdf import bsdf as TB
from ppg_tpu_torch.bsdf import microfacet as MF
from ppg_tpu_torch.convert import materials_from_numpy
from ppg_tpu_torch.scene import scene as TS
from ppg_tpu_torch.scene import xml_parser as TX
from test_bsdf_gof import DELTA_FAMILIES, FAMILIES

EVAL_RTOL, EVAL_ATOL = 2e-5, 1e-6
SAMPLE_WO_ATOL, SAMPLE_RTOL = 1e-4, 2e-3
N_LANES = 1000  # a row's lanes

ROWS = FAMILIES + DELTA_FAMILIES + [
    ("roughplastic", {"alpha": 0.2, "distribution": "ggx"}, ()),
    ("roughdielectric", {"alpha": 0.15, "distribution": "ggx"}, ()),
    ("twosided", {}, (JSpec("bsdf", "roughconductor", {"alpha": 0.2}),)),
]
IDS = [f"{i}-{o}" for i, (o, _, _) in enumerate(ROWS)]
# the rows whose sampling is held to its distribution, not to ppg_tpu's
# samples (GGX), and the roughdielectric rows
GGX_ROWS = {i for i, (_, props, _) in enumerate(ROWS)
            if props.get("distribution") == "ggx"}
RD_ROWS = {i for i, (o, _, _) in enumerate(ROWS) if o == "roughdielectric"}


def _spec(otype, props, children, mod=None):
    """The row's PluginSpec for ppg_tpu (mod None) or, with mod =
    (PluginSpec, Spectrum) of the port's xml_parser, the same spec
    rebuilt from the port's classes."""
    if mod is None:
        spec = JSpec("bsdf", otype)
        spec.props.update(props)
        spec.children.extend(children)
        return spec
    P, S = mod
    conv = lambda v: S(rgb=np.asarray(v.rgb)) if hasattr(v, "rgb") else v
    spec = P("bsdf", otype)
    spec.props.update({k: conv(v) for k, v in props.items()})
    spec.children.extend(
        _spec(c.otype, c.props, c.children, mod) if c.cls == "bsdf" else
        P(c.cls, c.otype, {k: conv(v) for k, v in c.props.items()})
        for c in children)
    return spec


def _table(builder, textures, mod=None):
    mb = builder(textures(None))
    specs = [_spec(*r, mod) for r in ROWS]  # alive: the cache keys on id
    rows = [mb.add(s) for s in specs]
    assert rows == list(range(len(ROWS)))
    return mb.finalize()


@pytest.fixture(scope="module")
def rows():
    """ppg_tpu's MaterialArrays of ROWS and the port's, fed its rows."""
    jm = JB.MaterialArrays.from_table(_table(JBuilder, JTextures))
    tm = materials_from_numpy(np.asarray(jm.packed), jm.present, "cpu")
    return jm, tm


@pytest.fixture(scope="module")
def lanes(rows):
    """Each row on N_LANES lanes: ppg_tpu's and the port's eval, pdf and
    sample on the same wi, wo and u."""
    jm, tm = rows
    rng = np.random.default_rng(21)
    L = N_LANES * len(ROWS)
    mid = np.repeat(np.arange(len(ROWS)), N_LANES).astype(np.int32)
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
        np.float32)
    wi, wo = unit(rng.normal(size=(L, 3))), unit(rng.normal(size=(L, 3)))
    u = rng.random((L, 3)).astype(np.float32)
    jp = JB.gather_params(jm, jnp.asarray(mid))
    tp = TB.gather_params(tm, torch.from_numpy(mid))
    T = torch.from_numpy
    want = [np.asarray(x) for x in JB._eval_pdf(jp, wi, wo, jm.present)]
    want += [np.asarray(x) for x in JB.sample_bsdf(jp, wi, u, jm.present)]
    got = [x.numpy() for x in TB.eval_pdf_bsdf(tp, T(wi), T(wo),
                                               tm.present)]
    got += [x.numpy() for x in TB.sample_bsdf(tp, T(wi), T(u), tm.present)]
    names = ("f", "pdf", "wo", "weight", "spdf", "delta", "eta")
    got, want = dict(zip(names, got)), dict(zip(names, want))
    # ppg_tpu's pdf at the port's sampled directions
    want["pdf_at_got"] = np.asarray(JB.pdf_bsdf(jp, wi, got["wo"],
                                                jm.present))
    got["f_at_got"], got["pdf_at_got"] = (x.numpy() for x in TB.eval_pdf_bsdf(
        tp, T(wi), T(got["wo"]), tm.present))
    return mid, wi, got, want


def _rel_close(got, want, rtol, atol_frac):
    got, want = got.astype(np.float64), want.astype(np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=atol_frac * scale + 1e-30)


@pytest.mark.parametrize("row", range(len(ROWS)), ids=IDS)
def test_eval_pdf_match_ppg_tpu(lanes, row):
    mid, wi, got, want = lanes
    sel = mid == row
    _rel_close(got["f"][sel], want["f"][sel], EVAL_RTOL, EVAL_ATOL)
    if row in RD_ROWS:
        # wi above the surface, where a microfacet takes wi to wo; the
        # others hold 0 where ppg_tpu's f is 0
        above = sel & (wi[:, 2] > 0)
        held = above & (got["pdf"] > 0)
        dropped = above & ~(got["pdf"] > 0)
        assert dropped.sum() > 0 and (want["f"][dropped] == 0).all()
        _rel_close(got["pdf"][held], want["pdf"][held], EVAL_RTOL,
                   EVAL_ATOL)
    else:
        _rel_close(got["pdf"][sel], want["pdf"][sel], EVAL_RTOL, EVAL_ATOL)


@pytest.mark.parametrize("row", sorted(set(range(len(ROWS))) - GGX_ROWS),
                         ids=[IDS[i] for i in sorted(set(range(len(ROWS)))
                                                     - GGX_ROWS)])
def test_sample_matches_ppg_tpu(lanes, row):
    mid, wi, got, want = lanes
    sel = mid == row
    if row in RD_ROWS:
        sel = sel & (wi[:, 2] > 0)  # the lanes whose sampling agrees
    np.testing.assert_array_equal(got["delta"][sel], want["delta"][sel])
    np.testing.assert_array_equal(got["eta"][sel], want["eta"][sel])
    np.testing.assert_allclose(got["wo"][sel], want["wo"][sel], rtol=0,
                               atol=SAMPLE_WO_ATOL)
    for k in ("weight", "spdf"):
        _rel_close(got[k][sel], want[k][sel], SAMPLE_RTOL, 1e-6)
    # the row samples something: a lobe taken on some lanes
    assert (want["spdf"][sel] > 0).mean() > 0.2


@pytest.mark.parametrize("row", sorted(GGX_ROWS),
                         ids=[IDS[i] for i in sorted(GGX_ROWS)])
def test_ggx_rows_sample_their_pdf(lanes, row):
    """The GGX rows' samples: their pdf and weight are the port's pdf and
    f / pdf at the sampled direction, and ppg_tpu's pdf there agrees
    (EVAL_RTOL) on the lanes both sample from (wi above the surface)."""
    mid, wi, got, want = lanes
    sel = (mid == row) & (got["spdf"] > 0)
    assert sel.sum() > N_LANES // 5
    np.testing.assert_array_equal(got["delta"][mid == row], False)
    _rel_close(got["pdf_at_got"][sel], got["spdf"][sel], 1e-6, 0.0)
    _rel_close(got["f_at_got"][sel] / got["spdf"][sel][:, None],
               got["weight"][sel], 1e-5, 1e-6)
    above = sel & (wi[:, 2] > 0)
    _rel_close(got["pdf_at_got"][above], want["pdf_at_got"][above],
               EVAL_RTOL, EVAL_ATOL)


def test_lane_flags_match_ppg_tpu(rows):
    jm, tm = rows
    mid = np.arange(len(ROWS), dtype=np.int32)
    want = JB.lane_flags(JB.gather_params(jm, jnp.asarray(mid)))
    got = TB.lane_flags(TB.gather_params(tm, torch.from_numpy(mid)))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_materials_from_numpy_carries_the_rows(rows):
    jm, tm = rows
    np.testing.assert_array_equal(tm.packed.numpy().view(np.int32),
                                  np.asarray(jm.packed).view(np.int32))
    assert tm.present == jm.present
    with pytest.raises(ValueError, match="materials_from_numpy"):
        materials_from_numpy(np.zeros((2, 5), np.float32), jm.present, "cpu")


def test_port_loader_packs_the_rows_as_ppg_tpu(rows):
    """The port's MaterialBuilder and MaterialArrays.from_table against
    ppg_tpu's: every row of ROWS bit for bit, and the same present set."""
    jm, _ = rows
    tm = TB.MaterialArrays.from_table(
        _table(TS.MaterialBuilder, TS.TextureBuilder,
               (TX.PluginSpec, TX.Spectrum)), "cpu")
    np.testing.assert_array_equal(tm.packed.numpy().view(np.int32),
                                  np.asarray(jm.packed).view(np.int32))
    assert tm.present == jm.present


def _wrapper_specs(P, S):
    """Rows of every wrapper family and of the nests the port composes:
    mask, null, blendbsdf, mixturebsdf, coating, roughcoating, a mask over
    a blend and over a coating, each built from the classes P, S."""
    leaf = lambda t, **k: P("bsdf", t, dict(k))
    mask = lambda c: P("bsdf", "mask", {"opacity": S(rgb=np.full(3, 0.6))},
                       [c])
    blend = P("bsdf", "blendbsdf", {"weight": 0.3},
              [leaf("diffuse"), leaf("roughplastic", alpha=0.1)])
    coat = P("bsdf", "coating", {"intIOR": 1.7, "thickness": 1.0},
             [leaf("diffuse")])
    return [mask(leaf("diffuse")), leaf("null"), blend,
            P("bsdf", "mixturebsdf", {"weights": "0.5, 0.5"},
              [leaf("diffuse"), leaf("roughconductor", alpha=0.2)]),
            coat,
            P("bsdf", "roughcoating", {"alpha": 0.1, "distribution": "ggx"},
              [leaf("roughconductor", alpha=0.3)]),
            mask(blend), mask(coat)]


def test_from_table_packs_the_wrappers_as_ppg_tpu():
    """The wrapper rows (their nested, nested2, blend_w, opacity,
    sigma_a, thickness and rt_ext slots included) through the port's
    loader and from_table, bit for bit with ppg_tpu's, and carried over by
    materials_from_numpy with the same resolution."""
    tables = []
    for builder, textures, P, S in (
            (JBuilder, JTextures, JSpec, JSpectrum),
            (TS.MaterialBuilder, TS.TextureBuilder, TX.PluginSpec,
             TX.Spectrum)):
        mb = builder(textures(None))
        specs = _wrapper_specs(P, S)  # alive: the cache keys on id
        rows = [mb.add(s) for s in specs]
        tables.append((rows, mb.finalize()))
    (jrows, jt), (trows, tt) = tables
    assert jrows == trows
    jm = JB.MaterialArrays.from_table(jt)
    tm = TB.MaterialArrays.from_table(tt, "cpu")
    np.testing.assert_array_equal(tm.packed.numpy().view(np.int32),
                                  np.asarray(jm.packed).view(np.int32))
    assert tm.present == jm.present
    assert set(TB.WRAPPER_TYPES) <= tm.present
    cm = materials_from_numpy(np.asarray(jm.packed), jm.present, "cpu")
    assert torch.equal(cm.wrappers.comp, tm.wrappers.comp)
    assert torch.equal(cm.flags, tm.flags)


def test_from_table_refuses_textures():
    """from_table refused textured rows until the textures were ported;
    now it packs their texture slots as ppg_tpu does and records which
    fields some row textures."""
    tables = []
    for builder, textures, P in ((JBuilder, JTextures, JSpec),
                                 (TS.MaterialBuilder, TS.TextureBuilder,
                                  TX.PluginSpec)):
        mb = builder(textures(None))
        tex = P("texture", "checkerboard", {"_name": "reflectance"})
        spec = P("bsdf", "diffuse", {}, [tex])
        mb.add(spec)
        tables.append(mb.finalize())
    jm = JB.MaterialArrays.from_table(tables[0])
    tm = TB.MaterialArrays.from_table(tables[1], "cpu")
    np.testing.assert_array_equal(tm.packed.numpy().view(np.int32),
                                  np.asarray(jm.packed).view(np.int32))
    assert tm.textured == {"reflectance"}
    assert tm.packed.view(torch.int32)[0, 33] == 0  # the spec's index


def _one_call(monkeypatch, tp, wi, u, present):
    """sample_bsdf's output, with every sample_visible call's arguments
    and result."""
    calls = []

    def record(*args):
        m = MF.sample_visible_plain(*args)
        calls.append((args, m))
        return m

    monkeypatch.setattr(MF, "sample_visible", record)
    return TB.sample_bsdf(tp, wi, u, present), calls


def test_one_visible_normal_call_equals_three_and_a_select(rows,
                                                           monkeypatch):
    """The microfacet rows' lanes in one sample_bsdf: one sample_visible
    call, whose normal equals, bit for bit, that of ppg_tpu's three
    per-family calls (roughconductor: (alpha_u, alpha_v, wi, u[:, :2]);
    roughplastic: (alpha, alpha, wi, u_g); roughdielectric: (alpha_u,
    alpha_v, -wi where wi is below the surface, u[:, :2])) over every lane
    and a select."""
    _, tm = rows
    rng = np.random.default_rng(22)
    mid = torch.from_numpy(rng.integers(0, len(ROWS), 6000).astype(np.int32))
    wi = torch.from_numpy(rng.normal(size=(6000, 3)).astype(np.float32))
    wi = wi / torch.linalg.vector_norm(wi, dim=-1, keepdim=True)
    u = torch.from_numpy(rng.random((6000, 3)).astype(np.float32))
    tp = TB.gather_params(tm, mid)
    _, calls = _one_call(monkeypatch, tp, wi, u, tm.present)
    assert len(calls) == 1
    m = calls[0][1]
    # the per-family inputs (ppg_tpu's bsdf.py:732, :784-798; for
    # roughdielectric Mitsuba's signum(cos) * wi)
    sign = TB._flip_sign(tp, wi)
    wi_l = TB._z(wi, sign)
    ci = wi_l[:, 2]
    dist, au, av = tp["dist"], tp["alpha_u"], tp["alpha_v"]
    u1, u2b = u[:, 0], u[:, 1]
    t12 = TB._rt_lookup(tp, ci)
    sw = tp["spec_weight"]
    psp0 = 1.0 - t12
    psp = (psp0 * sw) / torch.clamp(psp0 * sw + (1 - psp0) * (1 - sw),
                                    min=1e-12)
    u_g = torch.stack([u1, torch.clamp(u2b / torch.clamp(psp, min=1e-9),
                                       0.0, 1.0 - 1e-7)], -1)
    three = {
        TS.MAT_ROUGHCONDUCTOR: MF.sample_visible_plain(dist, au, av, wi_l,
                                                       u[:, :2]),
        TS.MAT_ROUGHPLASTIC: MF.sample_visible_plain(dist, au, au, wi_l, u_g),
        TS.MAT_ROUGHDIELECTRIC: MF.sample_visible_plain(
            dist, au, av, wi_l * torch.sign(ci)[:, None], u[:, :2]),
    }
    mt = tp["mtype"]
    n = 0
    for t, want in three.items():
        sel = mt == t
        n += int(sel.sum())
        got, want = m[sel], want[sel]
        same = (got.view(torch.int32) == want.view(torch.int32)) | (
            got.isnan() & want.isnan())
        assert bool(same.all()), (t, int((~same).sum()))
    assert n > 1000


@pytest.mark.parametrize("fams,calls", [
    ({TS.MAT_DIFFUSE}, 0),
    ({TS.MAT_DIFFUSE, TS.MAT_DIELECTRIC, TS.MAT_PLASTIC}, 0),
    ({TS.MAT_ROUGHCONDUCTOR}, 1),
    ({TS.MAT_DIFFUSE, TS.MAT_ROUGHPLASTIC, TS.MAT_ROUGHDIELECTRIC}, 1)])
def test_present_skips_the_absent_families(rows, monkeypatch, fams, calls):
    """Lanes of the families in `present` get the same bits as with every
    family on, and a scene without microfacet rows draws no visible
    normal; with some, exactly one call."""
    _, tm = rows
    types = [TS.MAT_NAMES[o] if o != "twosided" else TS.MAT_ROUGHCONDUCTOR
             for o, _, _ in ROWS]
    ids = [i for i, t in enumerate(types) if t in fams and ROWS[i][0] != (
        "twosided")]
    rng = np.random.default_rng(23)
    mid = torch.from_numpy(rng.choice(ids, 3000).astype(np.int32))
    wi = torch.from_numpy(rng.normal(size=(3000, 3)).astype(np.float32))
    wi = wi / torch.linalg.vector_norm(wi, dim=-1, keepdim=True)
    wo = torch.flip(wi, [0])
    u = torch.from_numpy(rng.random((3000, 3)).astype(np.float32))
    tp = TB.gather_params(tm, mid)
    got, n = _one_call(monkeypatch, tp, wi, u, frozenset(fams))
    assert len(n) == calls
    want, _ = _one_call(monkeypatch, tp, wi, u, None)
    for a, b in zip(got + TB.eval_pdf_bsdf(tp, wi, wo, frozenset(fams)),
                    want + TB.eval_pdf_bsdf(tp, wi, wo)):
        assert torch.equal(a, b) or bool(
            ((a == b) | (a.isnan() & b.isnan())).all())

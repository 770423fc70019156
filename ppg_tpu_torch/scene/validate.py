"""Scene-XML structural validation and versioned upgrade.

The reference validates scene files against an XML schema
(mitsuba/data/schema/scene.xsd, wired up in
mitsuba/src/mitsuba/mitsuba.cpp:344-357) and upgrades old scene versions
with XSLT transforms (mitsuba/data/schema/upgrade_0.{3,4,5}.0.xsl,
applied by SceneHandler). This module is the TPU framework's
dependency-free equivalent:

* `validate(root, path)` — an "XSD-lite" structural check transcribed
  from scene.xsd: per-container child-tag whitelists, required
  attributes per element kind, and property-value attribute presence.
  Violations raise `SceneValidationError` with an element path (the
  reference reports xerces line numbers; we report a tree path like
  `scene > shape[2] > bsdf`).
* `upgrade(root, path)` — in-place ElementTree rewrites implementing
  the three upgrade stylesheets (pre-0.3 -> 0.3 -> 0.4 -> 0.5), driven
  by the scene's `version` attribute exactly like SceneHandler's
  version dispatch.

Unused-property warnings (the reference's Properties unqueried-key
warnings, mitsuba/include/mitsuba/core/properties.h:46 +
ConfigurableObject teardown) are implemented by `Props` — a dict that
records key reads — plus `warn_unused(spec)` called after scene build.

The port's own copy of ppg_tpu/scene/validate.py.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from ..utils.logging import log


class SceneValidationError(ValueError):
    pass


# -- XSD-lite structure tables (from mitsuba/data/schema/scene.xsd) --------

# the objectGroup property tags every object accepts
_PROP_TAGS = {"integer", "float", "point", "vector", "boolean", "transform",
              "animation", "string", "spectrum", "rgb", "srgb", "blackbody",
              "default"}

# extra (non-property) children each container admits, per scene.xsd
_EXTRA_CHILDREN = {
    "scene": {"sensor", "texture", "bsdf", "subsurface", "integrator",
              "emitter", "shape", "medium", "phase", "include", "null",
              "alias", "ref"},
    "sensor": {"sampler", "film", "ref", "medium"},
    "integrator": {"integrator", "sampler"},
    "emitter": {"texture", "emitter", "medium", "ref"},
    "shape": {"bsdf", "subsurface", "ref", "sensor", "emitter", "shape",
              "medium", "texture", "rfilter"},
    "subsurface": {"phase", "bsdf"},
    "medium": {"shape", "volume", "phase"},
    "volume": {"volume"},
    "bsdf": {"phase", "texture", "bsdf", "ref"},
    "texture": {"texture", "ref", "rfilter"},
    "phase": {"phase"},
    "film": {"rfilter"},
    "sampler": set(),
    "rfilter": set(),
}

# elements requiring a type="..." attribute (objectBase use=required)
_TYPED = set(_EXTRA_CHILDREN) - {"scene"}

# required attributes for property/leaf tags
_REQUIRED_ATTRS = {
    "float": ("name", "value"),
    "integer": ("name", "value"),
    "boolean": ("name", "value"),
    "string": ("name", "value"),
    "rgb": ("name", "value"),
    "srgb": ("name", "value"),
    "blackbody": ("name", "temperature"),
    "ref": ("id",),
    "include": ("filename",),
    "default": ("name", "value"),
    "alias": ("id", "as"),
}

_TRANSFORM_OPS = {"translate", "rotate", "scale", "matrix", "lookat",
                  "lookAt"}


def _path(stack):
    return " > ".join(stack)


def _check(elem, stack, path):
    tag = elem.tag
    if not isinstance(tag, str):  # comments / PIs
        return
    sp = stack + [tag]

    for attr in _REQUIRED_ATTRS.get(tag, ()):
        if attr not in elem.attrib and not (
                tag == "spectrum" and attr == "value"):
            raise SceneValidationError(
                f"{path}: <{tag}> at {_path(sp)} is missing required "
                f"attribute '{attr}' (scene.xsd)")
    if tag == "spectrum" and not ({"value", "filename"} & set(elem.attrib)):
        raise SceneValidationError(
            f"{path}: <spectrum> at {_path(sp)} needs a 'value' or "
            f"'filename' attribute (scene.xsd)")
    if tag in ("point", "vector") and "value" not in elem.attrib and not (
            {"x", "y", "z"} & set(elem.attrib)):
        raise SceneValidationError(
            f"{path}: <{tag}> at {_path(sp)} needs 'value' or x/y/z "
            f"attributes")
    if tag in _TYPED and "type" not in elem.attrib:
        raise SceneValidationError(
            f"{path}: <{tag}> at {_path(sp)} is missing required "
            f"attribute 'type' (scene.xsd objectBase)")

    if tag == "transform":
        for child in elem:
            if isinstance(child.tag, str) and child.tag not in _TRANSFORM_OPS:
                raise SceneValidationError(
                    f"{path}: <{child.tag}> is not a transform operation "
                    f"at {_path(sp)} (allowed: translate/rotate/scale/"
                    f"matrix/lookat)")
        return

    if tag in _EXTRA_CHILDREN:
        allowed = _PROP_TAGS | _EXTRA_CHILDREN[tag]
        seen = {}
        for i, child in enumerate(elem):
            if not isinstance(child.tag, str):
                continue
            if child.tag not in allowed:
                raise SceneValidationError(
                    f"{path}: element <{child.tag}> is not allowed inside "
                    f"<{tag}> at {_path(sp)} (scene.xsd)")
            nm = child.attrib.get("name")
            if nm and child.tag in _PROP_TAGS and child.tag != "default":
                prev = seen.get(nm)
                if prev is not None:
                    log(f"{path}: duplicate property '{nm}' inside <{tag}> "
                        f"at {_path(sp)} (later value wins)", level="warn")
                seen[nm] = child.tag
            _check(child, sp, path)


def validate(root: ET.Element, path: str = "<scene>"):
    """Structural XSD-lite validation; raises SceneValidationError."""
    if root.tag != "scene":
        raise SceneValidationError(f"{path}: root element must be <scene>")
    if "version" not in root.attrib:
        log(f"{path}: <scene> has no version attribute; assuming 0.5.0 "
            f"(the reference refuses such files)", level="warn")
    _check(root, [], path)


# -- version upgrade (mitsuba/data/schema/upgrade_*.xsl) -------------------

def _version_tuple(v):
    try:
        return tuple(int(x) for x in v.strip().split("."))
    except ValueError:
        return (0, 5, 0)


def _rename_prop(elem, old, new):
    for child in elem:
        if isinstance(child.tag, str) and child.attrib.get("name") == old:
            child.set("name", new)


def _iter_named(root, tag, otype=None):
    for e in root.iter(tag):
        if otype is None or e.attrib.get("type") in (
                otype if isinstance(otype, tuple) else (otype,)):
            yield e


def _wrap_scale_texture(parent, node, scale):
    """upgrade_0.3.0.xsl 'scaled' mode: wrap a textured reflectance in a
    <texture type="scale"> with the legacy amount as the scale factor."""
    i = list(parent).index(node)
    wrap = ET.Element("texture", {"type": "scale"})
    if node.attrib.get("name"):
        wrap.set("name", node.attrib["name"])
    f = ET.SubElement(wrap, "float", {"name": "scale", "value": str(scale)})
    f.tail = ""
    node.attrib["name"] = "value"
    parent.remove(node)
    wrap.append(node)
    parent.insert(i, wrap)


def _upgrade_pre_03(root):
    """pre-0.3.0 -> 0.3.0 (upgrade_0.3.0.xsl)."""
    # old attribute-style lookAt
    for tr in root.iter("transform"):
        for la in list(tr):
            if la.tag in ("lookAt", "lookat") and "ox" in la.attrib:
                i = list(tr).index(la)
                a = la.attrib
                la.attrib = {
                    "origin": f"{a['ox']}, {a['oy']}, {a['oz']}",
                    "target": f"{a['tx']}, {a['ty']}, {a['tz']}",
                }
                if "ux" in a:
                    la.set("up", f"{a['ux']}, {a['uy']}, {a['uz']}")
                tr.insert(i, ET.Element("scale", {"x": "-1"}))
    for sh in root.iter("shape"):
        if sh.attrib.get("type") == "obj":
            ET.SubElement(sh, "boolean",
                          {"name": "flipTexCoords", "value": "false"})
        if not any(c.tag in ("bsdf", "ref", "medium", "subsurface")
                   for c in sh):
            ET.SubElement(sh, "bsdf", {"type": "diffuse"})
        if sh.attrib.get("type") == "sphere":
            _rename_prop(sh, "inverted", "flipNormals")
        if sh.attrib.get("type") == "cylinder":
            _rename_prop(sh, "p1", "p0")  # p1->p0 first, then p2->p1
            _rename_prop(sh, "p2", "p1")
    # diffuseAmount/specularAmount folding for microfacet/phong/ward
    spec_defaults = {"microfacet": (1.0, 0.0), "phong": (0.2, 0.5),
                     "ward": (0.2, 0.5)}
    for b in list(root.iter("bsdf")):
        t = b.attrib.get("type")
        if t not in spec_defaults:
            continue
        spec_r, diff_r = spec_defaults[t]
        amounts = {"diffuseAmount": 1.0, "specularAmount": 1.0}
        for c in list(b):
            nm = c.attrib.get("name")
            if nm in amounts:
                amounts[nm] = float(c.attrib.get("value", 1.0))
                b.remove(c)
        for nm, amount, base in (
                ("diffuseReflectance", amounts["diffuseAmount"], diff_r),
                ("specularReflectance", amounts["specularAmount"], spec_r)):
            node = next((c for c in b if c.attrib.get("name") == nm), None)
            if node is None:
                ET.SubElement(b, "spectrum",
                              {"name": nm, "value": str(amount * base)})
            elif amount != 1.0:
                if node.tag in ("texture", "ref"):
                    _wrap_scale_texture(b, node, amount)
                else:
                    v = [str(float(x) * amount) for x in
                         node.attrib["value"].replace(",", " ").split()]
                    node.set("value", ", ".join(v))
    for tex in root.iter("texture"):
        if tex.attrib.get("type") in ("checkerboard", "gridtexture"):
            _rename_prop(tex, "brightColor", "color0")
            _rename_prop(tex, "darkColor", "color1")
    renames = {"lambertian": "diffuse", "microfacet": "roughplastic",
               "roughmetal": "roughconductor", "roughglass": "roughdielectric",
               "composite": "mixturebsdf"}
    for b in root.iter("bsdf"):
        t = b.attrib.get("type")
        if t == "ward":
            _rename_prop(b, "alphaX", "alphaU")
            _rename_prop(b, "alphaY", "alphaV")
        if t == "mirror":
            b.set("type", "conductor")
            ET.SubElement(b, "string", {"name": "material", "value": "Cr"})
        if t in ("microfacet", "roughmetal", "roughglass"):
            _rename_prop(b, "alphaB", "alpha")
        if t == "roughmetal":
            _rename_prop(b, "ior", "eta")
        if t in renames:
            b.set("type", renames[t])
    for e in root.iter():
        _rename_prop(e, "sizeMultiplier", "densityMultiplier")
    for tex in root.iter("texture"):
        if tex.attrib.get("type") in ("exrtexture", "ldrtexture"):
            tex.set("type", "bitmap")


def _retag(elem, new_tag):
    elem.tag = new_tag


def _upgrade_03_to_04(root):
    """0.3.x -> 0.4.0 (upgrade_0.4.0.xsl)."""
    for cam in root.iter("camera"):
        if cam.attrib.get("type") == "perspective":
            axis = "smaller"
            for c in list(cam):
                if c.attrib.get("name") == "mapSmallerSide":
                    if c.attrib.get("value") == "false":
                        axis = "larger"
                    cam.remove(c)
            ET.SubElement(cam, "string", {"name": "fovAxis", "value": axis})
        # handedness fix: prepend <scale x="-1"/> to the toWorld transform
        for tr in cam:
            if tr.tag == "transform" and \
                    tr.attrib.get("name", "toWorld") == "toWorld":
                tr.insert(0, ET.Element("scale", {"x": "-1"}))
        _retag(cam, "sensor")
    for lum in root.iter("luminaire"):
        t = lum.attrib.get("type")
        if t in ("area", "constant"):
            _rename_prop(lum, "intensity", "radiance")
        elif t == "directional":
            _rename_prop(lum, "intensity", "irradiance")
        _retag(lum, "emitter")
    for it in root.iter("integrator"):
        _rename_prop(it, "luminaireSamples", "emitterSamples")
        if it.attrib.get("type") == "errctrl":
            it.set("type", "adaptive")
    for sa in root.iter("sampler"):
        _rename_prop(sa, "depth", "dimension")
    for fi in root.iter("film"):
        if fi.attrib.get("type") == "exrfilm":
            fi.set("type", "hdrfilm")
        elif fi.attrib.get("type") == "pngfilm":
            fi.set("type", "ldrfilm")
        for c in list(fi):
            if c.tag == "boolean" and c.attrib.get("name") == "alpha":
                fmt = "rgba" if c.attrib.get("value") == "true" else "rgb"
                fi.remove(c)
                ET.SubElement(fi, "string",
                              {"name": "pixelFormat", "value": fmt})
    for e in root.iter():
        _rename_prop(e, "focusDepth", "focusDistance")
        _rename_prop(e, "intensityScale", "scale")
        _rename_prop(e, "densityMultiplier", "scale")
    for bb in root.iter("blackbody"):
        if "multiplier" in bb.attrib:
            bb.set("scale", bb.attrib.pop("multiplier"))


def _upgrade_04_to_05(root):
    """0.4.x -> 0.5.0 (upgrade_0.5.0.xsl)."""
    for b in root.iter("bsdf"):
        if b.attrib.get("type") == "bump":
            b.set("type", "bumpmap")


def upgrade(root: ET.Element, path: str = "<scene>") -> bool:
    """Upgrade an old scene tree in place; returns True if rewritten."""
    v = _version_tuple(root.attrib.get("version", "0.5.0"))
    if v >= (0, 5):
        return False
    log(f"{path}: upgrading scene from version "
        f"{root.attrib.get('version')} to 0.5.0", level="info")
    if v < (0, 3):
        _upgrade_pre_03(root)
    if v < (0, 4):
        _upgrade_03_to_04(root)
    _upgrade_04_to_05(root)
    root.set("version", "0.5.0")
    return True


# -- unused-property tracking (properties.h:46 semantics) -------------------

class Props(dict):
    """Property dict recording which keys were read, so scene build can
    emit the reference's 'unqueried property' warnings."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read_keys = set()

    def __getitem__(self, k):
        self.read_keys.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.read_keys.add(k)
        return super().get(k, default)

    def __contains__(self, k):
        self.read_keys.add(k)
        return super().__contains__(k)

    def copy(self):
        """A copy that SHARES the read-key set, so builder-side dict
        copies still credit reads to the originating PluginSpec."""
        out = Props(dict.items(self))
        out.read_keys = self.read_keys
        return out

    def mark_read(self, *keys):
        """Mark keys as consumed (for parameters the builder accepts but
        deliberately ignores, e.g. film 'banner')."""
        self.read_keys.update(keys)

    def unread(self):
        return [k for k in self if k not in self.read_keys
                and not k.startswith("_")]


def warn_unused(spec, path="<scene>", _seen=None):
    """Walk a PluginSpec tree post-build and warn about properties no
    plugin ever read (Properties::printUnqueried analog)."""
    if _seen is None:
        _seen = set()
    if id(spec) in _seen:  # <ref> sharing
        return
    _seen.add(id(spec))
    props = spec.props
    if isinstance(props, Props):
        for k in props.unread():
            log(f"{path}: unqueried property '{k}' on <{spec.cls} "
                f"type=\"{spec.otype}\">", level="warn")
    for c in spec.children:
        warn_unused(c, path, _seen)

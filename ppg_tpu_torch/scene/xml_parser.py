"""Mitsuba 0.5/0.6 scene-XML parser.

Replicates the reference's SceneHandler semantics
(mitsuba/src/librender/scenehandler.cpp): tags become plugin descriptors
with typed Properties; `$key` substitution from `-Dkey=value` defaults
(mitsuba.cpp:168-174); `<transform>` children compose left-multiplied in
document order (scenehandler.cpp:352-439); `<spectrum>` wavelength lists
are CIE-converted to linear RGB (scenehandler.cpp:550-626); `<ref>`
resolves named objects; `<default>` provides fallback parameter values.

The output is a tree of `PluginSpec` nodes — the TPU framework's analog
of Mitsuba's Properties + ConfigurableObject graph, later flattened into
device arrays by scene.build_scene.

The port's own copy of ppg_tpu/scene/xml_parser.py.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from ..core import spectrum as spec
from ..core import transform as tf
from .validate import Props, upgrade, validate


@dataclass
class PluginSpec:
    cls: str  # tag name: bsdf / shape / emitter / sensor / ...
    otype: str  # plugin type attribute: diffuse / obj / area / ...
    props: dict = field(default_factory=Props)
    children: list = field(default_factory=list)  # nested PluginSpecs
    oid: str | None = None

    def child(self, cls, otype=None):
        for c in self.children:
            if c.cls == cls and (otype is None or c.otype == otype):
                return c
        return None

    def children_of(self, cls):
        return [c for c in self.children if c.cls == cls]


@dataclass
class Spectrum:
    """A color value with the context of how it was declared, so reflectance
    vs. radiance conversions match the reference."""

    rgb: np.ndarray

    def __array__(self, dtype=None):
        return np.asarray(self.rgb, dtype)


_OBJECT_TAGS = {
    "integrator",
    "sensor",
    "sampler",
    "film",
    "rfilter",
    "bsdf",
    "shape",
    "emitter",
    "texture",
    "medium",
    "phase",
    "subsurface",
    "volume",
}

_NUM_RE = re.compile(r"[-+0-9.eE]+")


def _subst(value: str, defaults: dict) -> str:
    def repl(m):
        key = m.group(1)
        if key not in defaults:
            raise KeyError(f"scene parameter ${key} has no value (pass -D {key}=...)")
        return str(defaults[key])

    return re.sub(r"\$(\w+)", repl, value)


def _parse_floats(s):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _parse_transform(elem, defaults):
    m = np.eye(4)
    for child in elem:
        a = {k: _subst(v, defaults) for k, v in child.attrib.items()}
        tag = child.tag
        if tag == "translate":
            v = [float(a.get(k, 0.0)) for k in "xyz"]
            m = tf.translate(v) @ m
        elif tag == "scale":
            if "value" in a:
                v = _parse_floats(a["value"])
                v = v * 3 if len(v) == 1 else v
            else:
                v = [float(a.get(k, 1.0)) for k in "xyz"]
            m = tf.scale(v) @ m
        elif tag == "rotate":
            axis = [float(a.get(k, 0.0)) for k in "xyz"]
            m = tf.rotate(axis, float(a["angle"])) @ m
        elif tag == "matrix":
            vals = _parse_floats(a["value"])
            if len(vals) == 16:
                mtx = np.array(vals).reshape(4, 4)
            elif len(vals) == 9:
                mtx = np.eye(4)
                mtx[:3, :3] = np.array(vals).reshape(3, 3)
            else:
                raise ValueError("matrix must have 9 or 16 entries")
            m = mtx @ m
        elif tag == "lookAt" or tag == "lookat":
            origin = _parse_floats(a["origin"])
            target = _parse_floats(a["target"])
            up = _parse_floats(a.get("up", "0 1 0"))
            m = tf.look_at(origin, target, up) @ m
        else:
            raise ValueError(f"unsupported transform op <{tag}>")
    return m


def _parse_spectrum_value(value: str, parent_cls: str, intent: str | None):
    toks = [t for t in re.split(r"[,\s]+", value.strip()) if t]
    if len(toks) == 1 and ":" not in toks[0]:
        v = float(toks[0])
        if intent is None:
            intent = "illuminant" if parent_cls == "emitter" else "reflectance"
        if intent == "reflectance":
            return Spectrum(np.full(3, v))
        return Spectrum(spec.d65_rgb() * v)
    if ":" in toks[0]:
        wl, vals = [], []
        for t in toks:
            w, v = t.split(":")
            wl.append(float(w))
            vals.append(float(v))
        return Spectrum(spec.spectrum_to_rgb(wl, vals))
    if len(toks) == 3:
        return Spectrum(np.array([float(t) for t in toks]))
    raise ValueError(f"cannot parse spectrum value {value!r}")


class SceneXML:
    def __init__(self, path, defaults=None):
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        self.defaults = dict(defaults or {})
        self.named: dict[str, PluginSpec] = {}
        root = ET.parse(path).getroot()
        # versioned upgrade + XSD-lite validation (scenehandler.cpp +
        # data/schema/scene.xsd + upgrade_*.xsl semantics)
        upgrade(root, path)
        validate(root, path)
        self.version = root.attrib.get("version", "0.5.0")
        self.root = PluginSpec("scene", "scene")
        # collect <default> elements first (document order, like the SAX parser)
        for child in root:
            if child.tag == "default":
                self.defaults.setdefault(
                    child.attrib["name"], child.attrib["value"]
                )
        for child in root:
            self._handle(child, self.root)

    def resolve_path(self, p):
        if os.path.isabs(p):
            return p
        return os.path.join(self.dir, p)

    # -- element dispatch ---------------------------------------------------

    def _handle(self, elem, parent: PluginSpec):
        tag = elem.tag
        if tag in ("default", ET.Comment):
            return
        if not isinstance(tag, str):
            return
        a = {k: _subst(v, self.defaults) for k, v in elem.attrib.items()}
        name = a.get("name")

        if tag in _OBJECT_TAGS:
            obj = PluginSpec(tag, a.get("type", ""), oid=a.get("id"))
            if name:
                obj.props["_name"] = name
            for child in elem:
                self._handle(child, obj)
            if obj.oid:
                self.named[obj.oid] = obj
            parent.children.append(obj)
        elif tag == "ref":
            target = self.named.get(a["id"])
            if target is None:
                raise KeyError(f"<ref id={a['id']!r}>: unknown object")
            parent.children.append(target)
        elif tag == "alias":
            self.named[a["as"]] = self.named[a["id"]]
        elif tag == "include":
            sub = SceneXML(self.resolve_path(a["filename"]), self.defaults)
            parent.children.extend(sub.root.children)
            self.named.update(sub.named)
        elif tag == "transform":
            parent.props[name or "toWorld"] = _parse_transform(elem, self.defaults)
        elif tag == "float":
            parent.props[name] = float(a["value"])
        elif tag == "integer":
            parent.props[name] = int(a["value"])
        elif tag == "boolean":
            parent.props[name] = a["value"].strip().lower() == "true"
        elif tag == "string":
            parent.props[name] = a["value"]
        elif tag == "point" or tag == "vector":
            if "value" in a:
                v = _parse_floats(a["value"])
            else:
                v = [float(a.get(k, 0.0)) for k in "xyz"]
            parent.props[name] = np.array(v)
        elif tag == "rgb":
            vals = _parse_floats(a["value"])
            vals = vals * 3 if len(vals) == 1 else vals
            parent.props[name] = Spectrum(np.array(vals))
        elif tag == "srgb":
            vals = _parse_floats(a["value"])
            vals = np.array(vals * 3 if len(vals) == 1 else vals)
            lin = np.where(
                vals <= 0.04045, vals / 12.92, ((vals + 0.055) / 1.055) ** 2.4
            )
            parent.props[name] = Spectrum(lin)
        elif tag == "spectrum":
            if "filename" in a:
                wl, vals = [], []
                with open(self.resolve_path(a["filename"])) as f:
                    for line in f:
                        line = line.split("#")[0].strip()
                        if line:
                            w, v = _parse_floats(line)[:2]
                            wl.append(w)
                            vals.append(v)
                parent.props[name] = Spectrum(spec.spectrum_to_rgb(wl, vals))
            else:
                parent.props[name] = _parse_spectrum_value(
                    a["value"], parent.cls, a.get("intent")
                )
        elif tag == "blackbody":
            scale = float(a.get("scale", 1.0))
            parent.props[name] = Spectrum(
                spec.blackbody_rgb(float(a["temperature"]), scale)
            )
        elif tag == "animation":
            # static snapshot: take the first keyframe transform
            for child in elem:
                if child.tag == "transform":
                    parent.props[name or "toWorld"] = _parse_transform(
                        child, self.defaults
                    )
                    break
        else:
            raise ValueError(f"unsupported XML element <{tag}>")


def load(path, defaults=None) -> SceneXML:
    return SceneXML(path, defaults)

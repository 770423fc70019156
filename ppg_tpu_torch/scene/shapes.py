"""Shape plugins -> world-space triangle meshes (host-side numpy).

Covers the reference's shape plugin surface (mitsuba/src/shapes/):
obj, ply, serialized, rectangle, sphere, cube, disk, cylinder, plus
instance/shapegroup flattening in scene.build_scene. Analytic shapes
are tessellated. Normal generation follows TriMesh::computeNormals
(angle-weighted Thuermer & Wuethrich, librender/trimesh.cpp).

The port's own copy of ppg_tpu/scene/shapes.py.
"""

from __future__ import annotations

import numpy as np

from ..core import transform as tf
from ..io.obj import load_obj
from ..io.ply import load_ply
from ..io.serialized import load_serialized


class TriMeshData:
    def __init__(self, positions, faces, normals=None, texcoords=None,
                 colors=None):
        self.positions = np.asarray(positions, np.float64)
        self.faces = np.asarray(faces, np.int32)
        self.normals = None if normals is None else np.asarray(normals, np.float64)
        self.texcoords = (
            None if texcoords is None else np.asarray(texcoords, np.float64)
        )
        self.colors = None if colors is None else np.asarray(colors, np.float64)

    def apply_transform(self, m):
        self.positions = tf.apply_point(m, self.positions)
        if self.normals is not None:
            n = tf.apply_normal(m, self.normals)
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
            self.normals = n / np.maximum(ln, 1e-20)
        if np.linalg.det(m[:3, :3]) < 0:
            # flip winding to preserve outward orientation
            self.faces = self.faces[:, [0, 2, 1]]
        return self

    def face_normals_areas(self):
        p = self.positions
        f = self.faces
        e1 = p[f[:, 1]] - p[f[:, 0]]
        e2 = p[f[:, 2]] - p[f[:, 0]]
        c = np.cross(e1, e2)
        ln = np.linalg.norm(c, axis=-1)
        n = c / np.maximum(ln, 1e-20)[:, None]
        return n, 0.5 * ln

    def compute_vertex_normals(self, flip=False):
        """Angle-weighted vertex normals (trimesh.cpp computeNormals)."""
        p, f = self.positions, self.faces
        out = np.zeros_like(p)
        fn, _ = self.face_normals_areas()
        for i in range(3):
            v0 = p[f[:, i]]
            v1 = p[f[:, (i + 1) % 3]]
            v2 = p[f[:, (i + 2) % 3]]
            a = v1 - v0
            b = v2 - v0
            an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)
            bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-20)
            angle = np.arccos(np.clip(np.sum(an * bn, axis=-1), -1.0, 1.0))
            np.add.at(out, f[:, i], fn * angle[:, None])
        ln = np.linalg.norm(out, axis=-1, keepdims=True)
        if flip:
            ln = -ln
        mask = np.abs(ln[:, 0]) > 0
        out[mask] = out[mask] / ln[mask]
        self.normals = out
        return self


def make_rectangle():
    """Unit rectangle [-1,1]^2 at z=0, normal +z (rectangle.cpp:174-188)."""
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    n = np.tile([0.0, 0.0, 1.0], (4, 1))
    faces = np.array([[0, 1, 2], [2, 3, 0]], np.int32)
    return TriMeshData(pos, faces, n, uv)


def make_cube():
    """Cube [-1,1]^3 with per-face normals (cube.cpp)."""
    verts, norms, uvs, faces = [], [], [], []
    axes = [
        (np.array([0, 0, 1.0]), np.array([1.0, 0, 0]), np.array([0, 1.0, 0])),
        (np.array([0, 0, -1.0]), np.array([-1.0, 0, 0]), np.array([0, 1.0, 0])),
        (np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0])),
        (np.array([-1.0, 0, 0]), np.array([0, -1.0, 0]), np.array([0, 0, 1.0])),
        (np.array([0, 1.0, 0]), np.array([0, 0, 1.0]), np.array([1.0, 0, 0])),
        (np.array([0, -1.0, 0]), np.array([0, 0, -1.0]), np.array([1.0, 0, 0])),
    ]
    for n, u, v in axes:
        base = len(verts)
        for du, dv, tu, tv in [(-1, -1, 0, 0), (1, -1, 1, 0), (1, 1, 1, 1), (-1, 1, 0, 1)]:
            verts.append(n + du * u + dv * v)
            norms.append(n)
            uvs.append([tu, tv])
        faces += [[base, base + 1, base + 2], [base + 2, base + 3, base]]
    return TriMeshData(np.array(verts), np.array(faces, np.int32), np.array(norms), np.array(uvs))


def make_sphere(center, radius, subdiv_theta=64, subdiv_phi=128):
    """Tessellated sphere; analytic intersection is handled separately when
    the scene uses sphere primitives, this mesh backs sampling/BVH."""
    th = np.linspace(0, np.pi, subdiv_theta + 1)
    ph = np.linspace(0, 2 * np.pi, subdiv_phi + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(T) * np.cos(P)
    y = np.sin(T) * np.sin(P)
    z = np.cos(T)
    n = np.stack([x, y, z], -1).reshape(-1, 3)
    pos = center + radius * n
    uv = np.stack([P / (2 * np.pi), 1 - T / np.pi], -1).reshape(-1, 2)
    faces = []
    W = subdiv_phi + 1
    for i in range(subdiv_theta):
        for j in range(subdiv_phi):
            a, b, c, d = i * W + j, i * W + j + 1, (i + 1) * W + j + 1, (i + 1) * W + j
            if i > 0:
                faces.append([a, d, b])
            if i < subdiv_theta - 1:
                faces.append([b, d, c])
    return TriMeshData(pos, np.array(faces, np.int32), n, uv)


def make_cylinder(p0, p1, radius, subdiv=64):
    """Open-ended cylinder from p0 to p1 (cylinder.cpp: default p0=(0,0,0),
    p1=(0,0,1), radius 1, no caps)."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    axis = p1 - p0
    ln = np.linalg.norm(axis)
    az = axis / max(ln, 1e-20)
    up = np.array([0.0, 0.0, 1.0]) if abs(az[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    ax = np.cross(up, az)
    ax /= np.linalg.norm(ax)
    ay = np.cross(az, ax)
    ang = np.linspace(0, 2 * np.pi, subdiv, endpoint=False)
    ring_n = np.cos(ang)[:, None] * ax + np.sin(ang)[:, None] * ay  # [S,3]
    pos = np.concatenate([p0 + radius * ring_n, p1 + radius * ring_n])
    nrm = np.concatenate([ring_n, ring_n])
    u = ang / (2 * np.pi)
    uv = np.concatenate(
        [np.stack([u, np.zeros_like(u)], -1), np.stack([u, np.ones_like(u)], -1)]
    )
    faces = []
    for i in range(subdiv):
        j = (i + 1) % subdiv
        faces += [[i, j, subdiv + j], [subdiv + j, subdiv + i, i]]
    return TriMeshData(pos, np.array(faces, np.int32), nrm, uv)


def make_disk(subdiv=64):
    ang = np.linspace(0, 2 * np.pi, subdiv, endpoint=False)
    pos = np.concatenate(
        [[[0, 0, 0]], np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)]
    )
    n = np.tile([0.0, 0.0, 1.0], (len(pos), 1))
    uv = 0.5 * (pos[:, :2] + 1)
    faces = [[0, 1 + i, 1 + (i + 1) % subdiv] for i in range(subdiv)]
    return TriMeshData(pos, np.array(faces, np.int32), n, uv)


def build_shape(spec, scene_xml):
    """PluginSpec(shape) -> TriMeshData in world space (+shading normals)."""
    to_world = spec.props.get("toWorld", np.eye(4))
    flip_normals = bool(spec.props.get("flipNormals", False))
    face_normals = bool(spec.props.get("faceNormals", False))

    if spec.otype == "obj":
        raw = load_obj(scene_xml.resolve_path(spec.props["filename"]))
        mesh = TriMeshData(
            raw["positions"], raw["faces"], raw["normals"], raw["texcoords"]
        )
        if spec.props.get("flipTexCoords", True) and mesh.texcoords is not None:
            mesh.texcoords = mesh.texcoords.copy()
            mesh.texcoords[:, 1] = 1.0 - mesh.texcoords[:, 1]
    elif spec.otype == "ply":
        raw = load_ply(scene_xml.resolve_path(spec.props["filename"]))
        mesh = TriMeshData(raw["positions"], raw["faces"], raw["normals"],
                           raw["texcoords"], raw["colors"])
        if bool(spec.props.get("srgb", True)) and mesh.colors is not None:
            # ply.cpp: vertex colors are sRGB by default
            c = mesh.colors
            mesh.colors = np.where(
                c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    elif spec.otype == "serialized":
        raw = load_serialized(
            scene_xml.resolve_path(spec.props["filename"]),
            int(spec.props.get("shapeIndex", 0)))
        mesh = TriMeshData(raw["positions"], raw["faces"], raw["normals"],
                           raw["texcoords"], raw["colors"])
        if raw["face_normals"]:
            face_normals = True
    elif spec.otype == "rectangle":
        mesh = make_rectangle()
    elif spec.otype == "cube":
        mesh = make_cube()
    elif spec.otype == "disk":
        mesh = make_disk()
    elif spec.otype == "cylinder":
        mesh = make_cylinder(
            spec.props.get("p0", np.zeros(3)),
            spec.props.get("p1", np.array([0.0, 0.0, 1.0])),
            float(spec.props.get("radius", 1.0)))
    elif spec.otype == "sphere":
        center = spec.props.get("center", np.zeros(3))
        radius = float(spec.props.get("radius", 1.0))
        mesh = make_sphere(np.asarray(center, np.float64), radius)
    elif spec.otype == "heightfield":
        mesh = make_heightfield(spec, scene_xml)
    elif spec.otype == "hair":
        mesh = make_hair(spec, scene_xml)
    elif spec.otype == "deformable":
        mesh = make_deformable(spec, scene_xml)
    else:
        raise NotImplementedError(f"shape type {spec.otype!r}")

    mesh.apply_transform(to_world)

    if face_normals:
        mesh.normals = None
        if flip_normals:
            mesh.faces = mesh.faces[:, [1, 0, 2]]
    elif mesh.normals is None:
        mesh.compute_vertex_normals(flip=flip_normals)
    elif flip_normals:
        mesh.normals = -mesh.normals
    return mesh


def make_deformable(spec, scene_xml):
    """Deformable (keyframe-animated) shape
    (src/shapes/deformable.cpp:388-694): nested shape children are the
    animation frames, `times` gives each frame's time stamp, and hit
    attributes linearly interpolate between the two bracketing frames
    (fillIntersectionRecord's alpha lerp of positions/normals/uvs).
    TPU-native deviation: the reference builds a 4D space-time kd-tree
    and interpolates at each ray's time for motion blur; this framework
    renders a single time sample (like the reference with
    shutterOpen == shutterClose), so the lerp happens once at build
    time at the scene-level `time` parameter (default 0)."""
    pr = spec.props
    frames = [c for c in spec.children if getattr(c, "cls", None) == "shape"]
    if not frames:
        raise ValueError("deformable: needs nested shape children (frames)")
    times = [float(t) for t in
             str(pr.get("times", "")).replace(",", " ").replace(";", " ")
             .split()]
    if not times:
        times = list(range(len(frames)))
    if len(times) != len(frames):
        raise ValueError(
            f"deformable: {len(times)} times for {len(frames)} frames")
    t = float(pr.get("time", times[0]))
    hi = int(np.searchsorted(np.asarray(times), t, side="right"))
    hi = min(max(hi, 1), len(frames) - 1) if len(frames) > 1 else 0
    lo = max(hi - 1, 0)
    denom = times[hi] - times[lo]
    alpha = 0.0 if denom == 0 else min(max((t - times[lo]) / denom, 0.0),
                                       1.0)
    m0 = build_shape(frames[lo], scene_xml)
    if alpha == 0.0 or lo == hi:
        return m0
    m1 = build_shape(frames[hi], scene_xml)
    if m0.positions.shape != m1.positions.shape or \
            m0.faces.shape != m1.faces.shape:
        raise ValueError("deformable: frames must share mesh topology")
    m0.positions = (1 - alpha) * m0.positions + alpha * m1.positions
    if m0.normals is not None and m1.normals is not None:
        n = (1 - alpha) * m0.normals + alpha * m1.normals
        m0.normals = n / np.maximum(
            np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    else:
        m0.normals = None  # recomputed by the caller
    if m0.texcoords is not None and m1.texcoords is not None:
        m0.texcoords = (1 - alpha) * m0.texcoords + alpha * m1.texcoords
    return m0


def make_heightfield(spec, scene_xml):
    """Height field (src/shapes/heightfield.cpp, createTriMesh path):
    grid vertices at integer object-space (x, y) with z = scale * data,
    uv spanning [0,1]^2, two triangles per cell. Heights come from an
    image file (channel average, like the reference's single-channel
    conversion) or a nested procedural texture rasterized at
    width x height."""
    pr = spec.props
    scale = float(pr.get("scale", 1.0))
    fn = pr.get("filename", "")
    if fn:
        from .textures import load_texture

        img = load_texture(scene_xml.resolve_path(fn), gamma=1.0)
        data = np.asarray(img, np.float64).mean(axis=-1)
    else:
        tex = None
        for c in spec.children:
            if getattr(c, "cls", None) == "texture":
                tex = c
        if tex is None:
            raise ValueError("heightfield: needs filename or a texture")
        from .textures import rasterize_procedural

        res = max(int(pr.get("width", 128)), int(pr.get("height", 128)), 2)
        if tex.otype not in ("checkerboard", "gridtexture"):
            raise NotImplementedError(
                f"heightfield texture {tex.otype!r} (procedural only)")
        data = rasterize_procedural(tex.otype, dict(tex.props),
                                    res=res).mean(axis=-1)
    H, W = data.shape
    ys, xs = np.mgrid[0:H, 0:W]
    pos = np.stack([xs.ravel(), ys.ravel(),
                    scale * data.ravel()], -1).astype(np.float64)
    uv = np.stack([(xs / max(W - 1, 1)).ravel(),
                   (ys / max(H - 1, 1)).ravel()], -1)
    i = (ys[:-1, :-1] * W + xs[:-1, :-1]).ravel()
    f1 = np.stack([i, i + 1, i + W + 1], -1)
    f2 = np.stack([i, i + W + 1, i + W], -1)
    faces = np.concatenate([f1, f2]).astype(np.int32)
    return TriMeshData(pos, faces, None, uv)


def make_hair(spec, scene_xml):
    """Hair fibers (src/shapes/hair.cpp) tessellated into per-segment
    triangular tubes — the reference intersects capsules through a
    dedicated kd-tree; on TPU the segments become ordinary BVH triangles
    (sides x 2 tris per segment, radial smooth normals). `reduction`
    randomly drops fibers like the reference (:660-668)."""
    from ..io.hair import load_hair

    pr = spec.props
    verts, starts = load_hair(scene_xml.resolve_path(pr["filename"]))
    radius = float(pr.get("radius", 0.025))
    reduction = float(pr.get("reduction", 0.0))
    sides = int(pr.get("sides", 4))
    if reduction > 0:
        rng = np.random.default_rng(1234)
        fiber_id = np.cumsum(starts) - 1
        keep_f = rng.random(int(fiber_id.max()) + 1) >= reduction
        keep = keep_f[fiber_id]
        verts, starts = verts[keep], starts[keep]
        starts = starts.copy()
        if len(starts):
            starts[0] = True

    # segments: consecutive vertex pairs within a fiber
    a = verts[:-1]
    b = verts[1:]
    seg_ok = ~starts[1:]
    a, b = a[seg_ok], b[seg_ok]
    axis = b - a
    ln = np.linalg.norm(axis, axis=-1)
    good = ln > 1e-12
    a, b, axis, ln = a[good], b[good], axis[good], ln[good]
    S = len(a)
    if S == 0:
        return TriMeshData(np.zeros((0, 3)), np.zeros((0, 3), np.int32))
    az = axis / ln[:, None]
    up = np.where((np.abs(az[:, 2]) < 0.9)[:, None],
                  np.array([0.0, 0, 1.0]), np.array([1.0, 0, 0.0]))
    ax = np.cross(up, az)
    ax /= np.maximum(np.linalg.norm(ax, axis=-1, keepdims=True), 1e-20)
    ay = np.cross(az, ax)
    ang = 2 * np.pi * np.arange(sides) / sides
    ring = (np.cos(ang)[None, :, None] * ax[:, None]
            + np.sin(ang)[None, :, None] * ay[:, None])  # [S,sides,3]
    pos = np.concatenate([(a[:, None] + radius * ring),
                          (b[:, None] + radius * ring)], axis=1)
    nrm = np.concatenate([ring, ring], axis=1)
    pos = pos.reshape(-1, 3)
    nrm = nrm.reshape(-1, 3)
    base = (2 * sides) * np.arange(S)[:, None]
    i = np.arange(sides)
    j = (i + 1) % sides
    f1 = np.concatenate([
        (np.stack([i, j, sides + j], -1)[None] + base[..., None]),
        (np.stack([sides + j, sides + i, i], -1)[None] + base[..., None]),
    ], axis=1)
    faces = f1.reshape(-1, 3).astype(np.int32)
    return TriMeshData(pos, faces, nrm, None)

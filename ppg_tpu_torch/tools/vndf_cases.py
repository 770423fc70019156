"""Inputs for holding K8 (csrc/microfacet.cu) against
bsdf/microfacet.py::sample_visible_plain: numpy only, shared by the CPU
tests, the card tests and chip_smoke.py.

`inputs(rng, L)` gives L lanes, each a (dist, alpha_u, alpha_v, wi, u)
case. The lanes cycle through GGX and Beckmann, isotropic and
anisotropic roughness from 1e-3 to 1, wi over both hemispheres, and
these edges: wi at the normal (theta = 0, the stretched wi's z >=
0.99999) and within 1e-4 of it, grazing wi (z = 0, 1e-6, 1e-4 and
slightly below the surface), and uniforms at 0 and 1 (either column).
The uniforms come as three columns, as the tracer draws them, so that a
caller can hand over the strided view of the first two. Each lane also
has a family (`mtype`, scene/scene.py's ids) for K8's gate (mtype,
FAMS): the edge lanes are all of the three families that sample a
visible normal (MF_FAMILIES), the others of those in three lanes of five
and of families that do not (diffuse, dielectric, plastic) elsewhere.
"""

from __future__ import annotations

import numpy as np

GGX, BECKMANN = 1, 0
# roughconductor, roughdielectric, roughplastic; diffuse, dielectric,
# plastic
MF_FAMILIES, OTHER_FAMILIES = (2, 5, 7), (0, 3, 6)
FAMS = sum(1 << t for t in MF_FAMILIES)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def inputs(rng, L):
    """dict(dist [L] int32, alpha_u, alpha_v [L] float32, wi [L,3]
    float32 unit vectors, u [L,3] float32 in [0, 1], mtype [L] int32)."""
    dist = np.where(np.arange(L) % 2 == 0, GGX, BECKMANN).astype(np.int32)
    alpha_u = np.exp(rng.uniform(np.log(1e-3), 0.0, L))
    alpha_v = np.where(rng.random(L) < 0.5, alpha_u,
                       np.exp(rng.uniform(np.log(1e-3), 0.0, L)))
    wi = _unit(rng.normal(size=(L, 3)))
    u = rng.random((L, 3))
    # the edges, each on a stretch of 16 lanes (both distributions)
    edges = []
    k = 0
    for z in (1.0, 1.0 - 1e-9, np.cos(5e-5), np.cos(2e-4), 1e-4, 1e-6, 0.0,
              -1e-3):
        edges.append((slice(k, k + 16), z))
        k += 16
    for sl, z in edges:
        n = sl.stop - sl.start
        phi = rng.uniform(0.0, 2.0 * np.pi, n)
        s = np.sqrt(max(1.0 - z * z, 0.0))
        wi[sl] = np.stack([s * np.cos(phi), s * np.sin(phi),
                           np.full(n, z)], -1)
    # wi at the normal with isotropic roughness: the stretched wi too
    alpha_v[:32] = alpha_u[:32]
    for col, val in ((0, 0.0), (0, 1.0), (1, 0.0), (1, 1.0)):
        u[k:k + 16, col] = val
        k += 16
    # uniforms at the edges on wi at the normal as well
    u[0:4, 0] = 0.0
    u[4:8, 0] = 1.0
    u[8:12, 1] = 0.0
    u[12:16, 1] = 1.0
    assert k <= L, "inputs: L below the edge cases' lanes"
    mtype = np.where(rng.random(L) < 0.6,
                     rng.choice(MF_FAMILIES, L), rng.choice(OTHER_FAMILIES, L))
    mtype[:k] = np.resize(MF_FAMILIES, k)
    return dict(dist=dist, alpha_u=alpha_u.astype(np.float32),
                alpha_v=alpha_v.astype(np.float32),
                wi=wi.astype(np.float32), u=u.astype(np.float32),
                mtype=mtype.astype(np.int32))

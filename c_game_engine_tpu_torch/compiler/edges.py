"""Mesh active-edge detection for the static collision soup (counterpart
of c_game_engine_tpu/compiler/edges.py; numpy, in the same order, so the
flags come out bit for bit).

Jolt builds its static world as a MeshShape (MapLoader.c:200-273) whose
cooking marks each triangle edge ACTIVE or INACTIVE by the dihedral angle
to its neighbour; contacts whose closest feature is an inactive (interior)
edge get their normal replaced by the face normal, so bodies slide across
tessellation seams instead of catching on phantom lateral normals
(PlayerPhysics.c:176-194 enables the same treatment for the character).

Here the detection runs once at compile time over the world-space soup:
an edge is ACTIVE when it has no twin (mesh boundary), more than one twin
(non-manifold — conservative), or its two faces bend by more than the
threshold angle. Coplanar interior edges — every diagonal and seam of a
tessellated floor/ramp — come out INACTIVE. The flags ride the spare
tri16 columns into the contact kernels (ops/body_contacts.py) and the XLA
fallback (physics/batched.py), which apply the normal fix.
"""

from __future__ import annotations

import numpy as np

# Faces within ~5 degrees of coplanar share an inactive edge (Jolt's
# MeshShapeSettings::mActiveEdgeCosThresholdAngle default).
COS_COPLANAR = 0.996195

# Vertex quantization for adjacency matching: editor-emitted sectors and
# the JSON compiler both weld at well above this scale.
QUANT = 1e-4


def edge_active_flags(tris: np.ndarray, tri_valid: np.ndarray) -> np.ndarray:
    """tris [T, 3, 3] world-space triangles, tri_valid [T] bool.
    Returns [T, 3] f32 flags, edge k spanning vertex k -> (k+1)%3:
    1.0 = active (boundary / sharp / non-manifold), 0.0 = interior."""
    t = len(tris)
    flags = np.ones((t, 3), np.float32)
    valid_idx = np.where(tri_valid)[0]
    if len(valid_idx) == 0:
        return flags

    v = tris[valid_idx]  # [Tv, 3, 3]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    q = np.round(v / QUANT).astype(np.int64)  # [Tv, 3, 3]
    _, vid = np.unique(q.reshape(-1, 3), axis=0, return_inverse=True)
    vid = vid.reshape(-1, 3)  # [Tv, 3]
    edges = np.stack([vid, np.roll(vid, -1, axis=1)], axis=-1)  # [Tv, 3, 2]
    ekey = np.sort(edges, axis=-1).reshape(-1, 2)  # undirected, [Tv*3, 2]
    _, inv, counts = np.unique(
        ekey, axis=0, return_inverse=True, return_counts=True
    )
    order = np.argsort(inv, kind="stable")
    so = inv[order]
    # adjacent positions with the same edge id and exactly two twins
    first = np.where(
        (so[:-1] == so[1:]) & (counts[so[:-1]] == 2)
    )[0]
    i1, i2 = order[first], order[first + 1]
    t1, e1 = i1 // 3, i1 % 3
    t2, e2 = i2 // 3, i2 % 3
    coplanar = np.einsum("ij,ij->i", n[t1], n[t2]) > COS_COPLANAR
    g1, g2 = valid_idx[t1[coplanar]], valid_idx[t2[coplanar]]
    flags[g1, e1[coplanar]] = 0.0
    flags[g2, e2[coplanar]] = 0.0
    return flags

"""Host-side mesh builders in numpy (port of the builders of
gomavatar_tpu/ops/mesh_ops.py that the eval forward needs): the padded
vertex->face incidence table, 1->4 midpoint subdivision and per-face
attribute replication."""

from __future__ import annotations

import numpy as np


def vertex_face_incidence(faces: np.ndarray, num_vertices: int, max_degree: int = 16):
    """Padded per-vertex incident-face table.

    Returns (incidence (N, maxdeg) int64, valid (N, maxdeg) float32): each
    vertex lists its incident faces in ascending face order, padded with face
    0 at weight 0.  A vertex with more than ``max_degree`` incident faces
    keeps only its first ``max_degree``."""
    faces = np.asarray(faces, dtype=np.int64)
    N = num_vertices
    vert = faces.reshape(-1)
    face = np.repeat(np.arange(len(faces), dtype=np.int64), faces.shape[1])
    order = np.argsort(vert, kind="stable")  # per vertex: ascending face id
    vert, face = vert[order], face[order]
    degree = np.bincount(vert, minlength=N)
    first = np.concatenate([[0], np.cumsum(degree)[:-1]])
    rank = np.arange(len(vert)) - first[vert]
    maxdeg = min(max(1, int(degree.max(initial=0))), max_degree)
    keep = rank < maxdeg
    inc = np.zeros((N, maxdeg), dtype=np.int64)
    valid = np.zeros((N, maxdeg), dtype=np.float32)
    inc[vert[keep], rank[keep]] = face[keep]
    valid[vert[keep], rank[keep]] = 1.0
    return inc, valid


def subdivide_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_attributes: dict[str, np.ndarray] | None = None,
):
    """1-to-4 midpoint triangle subdivision with attribute propagation.

    One midpoint per unique edge; old face k becomes new faces 4k..4k+3 =
    (v0, m01, m20), (m01, v1, m12), (m20, m12, v2), (m01, m12, m20), so
    per-face quantities replicate x4 in the same layout.  Vertex attribute
    midpoints: 'so3' -> 0, 'scale' -> edge length, otherwise the mean of the
    endpoints.  Returns (new_vertices, new_faces, new_attributes, face_index).
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)

    edges = np.sort(
        np.stack(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=1
        ).reshape(-1, 2),
        axis=1,
    )
    unique, inverse = np.unique(edges, axis=0, return_inverse=True)
    mid = vertices[unique].mean(axis=1)
    mid_idx = inverse.reshape(-1, 3) + len(vertices)  # (F, 3): m01, m12, m20

    m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
    new_faces = np.column_stack(
        [
            faces[:, 0], m01, m20,
            m01, faces[:, 1], m12,
            m20, m12, faces[:, 2],
            m01, m12, m20,
        ]
    ).reshape(-1, 3)
    new_vertices = np.vstack([vertices, mid])
    face_index = np.repeat(np.arange(len(faces), dtype=np.int64), 4)

    new_attributes = {}
    if vertex_attributes is not None:
        for key, values in vertex_attributes.items():
            values = np.asarray(values)
            if key == "so3":
                attr_mid = np.zeros((len(unique), 3), dtype=values.dtype)
            elif key == "scale":
                edge_len = np.linalg.norm(
                    vertices[unique[:, 1]] - vertices[unique[:, 0]], axis=-1
                )
                attr_mid = np.ones((len(unique), 3), dtype=values.dtype) * edge_len[:, None]
            else:
                attr_mid = values[unique].mean(axis=1)
            new_attributes[key] = np.vstack([values, attr_mid])

    return new_vertices, new_faces, new_attributes, face_index


def replicate_face_attribute(attr: np.ndarray) -> np.ndarray:
    """Per-face attribute (F, C) -> (4F, C) in subdivision face order."""
    return np.repeat(np.asarray(attr), 4, axis=0)

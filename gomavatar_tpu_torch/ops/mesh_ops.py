"""Mesh operations (port of gomavatar_tpu/ops/mesh_ops.py).

* Host-side topology in numpy, built once per training phase
  (``MeshTopology.build``): unique edges, faces sharing an edge, the
  normal-consistency quads, vertex degrees and the padded vertex->face
  incidence table; plus 1->4 midpoint subdivision.
* Per-step quantities in PyTorch, differentiable by autograd: vertex
  normals, the uniform Laplacian, normal- and color-consistency and edge
  losses.  The reference computes its index transposes with gather tables
  (``DualIndex``, ``NeighborTable``) because scatter-adds are slow on a TPU;
  here plain indexing and ``index_add`` compute the same values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def unique_edges(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique undirected edges (E, 2), each row sorted and the rows in
    lexicographic order, and the (F, 3) edge index of each face's edges
    (v1, v2), (v0, v2), (v0, v1)."""
    faces = np.asarray(faces, dtype=np.int64)
    all_edges = np.sort(np.concatenate([faces[:, [1, 2]], faces[:, [0, 2]], faces[:, [0, 1]]], axis=0), axis=1)
    edges, inverse = np.unique(all_edges, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    F = faces.shape[0]
    face_to_edge = np.stack([inverse[:F], inverse[F : 2 * F], inverse[2 * F :]], axis=1)
    return edges.astype(np.int64), face_to_edge.astype(np.int64)


def face_connectivity_pairs(faces: np.ndarray) -> np.ndarray:
    """(P, 2) pairs of faces sharing an interior (2-manifold) edge."""
    _, face_to_edge = unique_edges(faces)
    F = face_to_edge.shape[0]
    edge_ids = face_to_edge.reshape(-1)
    face_ids = np.repeat(np.arange(F, dtype=np.int64), 3)
    order = np.argsort(edge_ids, kind="stable")
    edge_ids, face_ids = edge_ids[order], face_ids[order]
    same = edge_ids[:-1] == edge_ids[1:]  # interior edges appear exactly twice
    return np.stack([face_ids[:-1][same], face_ids[1:][same]], axis=1)


def normal_consistency_pairs(faces: np.ndarray) -> np.ndarray:
    """(P, 4) quads (v0, v1, a, b): for each interior edge (v0, v1) shared
    by faces fa and fb, a and b are their vertices opposite the edge."""
    faces = np.asarray(faces, dtype=np.int64)
    pairs = face_connectivity_pairs(faces)
    edges, face_to_edge = unique_edges(faces)
    fa, fb = pairs[:, 0], pairs[:, 1]
    ea, eb = face_to_edge[fa], face_to_edge[fb]
    shared = np.zeros(pairs.shape[0], dtype=np.int64)
    for i in range(3):
        for j in range(3):
            shared = np.where(ea[:, i] == eb[:, j], ea[:, i], shared)
    v0, v1 = edges[shared, 0], edges[shared, 1]

    def opposite(face_rows):
        opp = np.zeros(face_rows.shape[0], dtype=np.int64)
        for k in range(3):
            vk = face_rows[:, k]
            opp = np.where((vk != v0) & (vk != v1), vk, opp)
        return opp

    return np.stack([v0, v1, opposite(faces[fa]), opposite(faces[fb])], axis=1)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Static per-phase topology (host numpy)."""

    faces: np.ndarray  # (F, 3) int
    edges: np.ndarray  # (E, 2) int, unique undirected
    face_to_edge: np.ndarray  # (F, 3) int
    face_connectivity: np.ndarray  # (P, 2) int, faces sharing an edge
    nc_quads: np.ndarray  # (P, 4) int: (v0, v1, a, b) per interior edge
    vertex_degree: np.ndarray  # (N,) float, neighbours per vertex
    vf_incidence: np.ndarray  # (N, maxdeg) int, incident faces per vertex
    vf_valid: np.ndarray  # (N, maxdeg) float mask
    num_vertices: int

    @staticmethod
    def build(faces: np.ndarray, num_vertices: int) -> "MeshTopology":
        faces = np.asarray(faces, dtype=np.int64)
        edges, face_to_edge = unique_edges(faces)
        degree = np.bincount(edges.reshape(-1), minlength=num_vertices).astype(np.float32)
        inc, valid = vertex_face_incidence(faces, num_vertices)
        return MeshTopology(
            faces=faces,
            edges=edges,
            face_to_edge=face_to_edge,
            face_connectivity=face_connectivity_pairs(faces),
            nc_quads=normal_consistency_pairs(faces),
            vertex_degree=degree,
            vf_incidence=inc,
            vf_valid=valid,
            num_vertices=num_vertices,
        )


# -- per-step quantities -------------------------------------------------------

def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` along dim 0, through ``index_select``: its backward is
    an ``index_add`` (atomic adds), where the backward of ``values[idx]``
    sorts the indices and walks each run of duplicates serially.  The
    gathers of the train step repeat each face about 6 times in the entries
    and each vertex about 6 times in the triangles; with plain indexing
    their backward took ~146 ms of a 205 ms step on the H100
    (``profile_train.py``)."""
    return torch.index_select(values, 0, idx.reshape(-1)).reshape(*idx.shape, *values.shape[1:])


def abs_l1(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at x == 0 is +1, the subgradient of the reference's
    abs (torch's abs takes 0).  The L1 terms of the loss use it, so they
    move as the reference's do where a value equals its target, as the
    equal colors of a fresh model do in :func:`color_consistency_loss`."""
    return torch.where(x >= 0, x, -x)


def vertex_normals_from_tri(tri: torch.Tensor, vf_incidence: torch.Tensor, vf_valid: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (N, 3) from gathered triangles (F, 3, 3):
    the sum of the unnormalised normals of each vertex's incident faces,
    normalised."""
    crosses = torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)  # (F, 3)
    acc = torch.sum(gather_rows(crosses, vf_incidence) * vf_valid[..., None], dim=1)
    return acc / (torch.linalg.norm(acc, dim=-1, keepdim=True) + 1e-12)


def edge_lengths(verts: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    e = gather_rows(verts, edges)
    return torch.linalg.norm(e[:, 0] - e[:, 1], dim=-1)


def uniform_laplacian_loss(verts: torch.Tensor, edges: torch.Tensor, degree: torch.Tensor) -> torch.Tensor:
    """mean_i || (1/deg_i) sum_{j in N(i)} (v_j - v_i) ||^2, the uniform
    Laplacian smoothing objective; ``degree`` is a constant."""
    e = gather_rows(verts, edges)
    diff01 = e[:, 1] - e[:, 0]
    acc = torch.zeros_like(verts).index_add(0, edges[:, 0], diff01).index_add(0, edges[:, 1], -diff01)
    lap = acc / torch.clamp_min(degree, 1.0)[:, None]
    return torch.mean(torch.sum(lap * lap, dim=-1))


def normal_consistency_loss(verts: torch.Tensor, nc_quads: torch.Tensor) -> torch.Tensor:
    """PyTorch3D ``mesh_normal_consistency``: for each interior edge (v0, v1)
    with opposite vertices a, b, the mean of
    1 - cos(cross(v1 - v0, a - v0), -cross(v1 - v0, b - v0))."""
    q = gather_rows(verts, nc_quads)
    v0, v1, a, b = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    e = v1 - v0
    n0 = torch.cross(e, a - v0, dim=-1)
    n1 = -torch.cross(e, b - v0, dim=-1)
    cos = torch.sum(n0 * n1, dim=-1) / (torch.linalg.norm(n0, dim=-1) * torch.linalg.norm(n1, dim=-1) + 1e-12)
    return torch.mean(1.0 - cos)


def color_consistency_loss(colors: torch.Tensor, face_connectivity: torch.Tensor) -> torch.Tensor:
    """Mean L1 between the colors of edge-adjacent faces."""
    cc = gather_rows(colors, face_connectivity)
    return torch.mean(abs_l1(cc[:, 0] - cc[:, 1]))


def mesh_edge_loss(verts: torch.Tensor, edges: torch.Tensor, target_length: torch.Tensor) -> torch.Tensor:
    """Mean squared deviation of edge lengths from their targets."""
    return torch.mean((edge_lengths(verts, edges) - target_length) ** 2)

"""The avatar's mesh and its static topology, worked out from the state's
``meta`` record alone (numpy on the host).

Frozen copies, at commit a92d513, of the program's mesh generator and
topology builders: ``synthetic_body`` (gomavatar_tpu_torch/models/smpl.py:80),
``subdivide_mesh`` (ops/mesh_ops.py:249), ``unique_edges`` (:310),
``face_connectivity_pairs`` (:323), ``normal_consistency_pairs`` (:335) and
``vertex_face_incidence`` (:224).  The lbs weights of a subdivided mesh are
the endpoints' means, as ``models/gom.py:551`` (``subdivide_gom``) takes
them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def synthetic_body(n_rings: int, n_seg: int, height: float = 1.7, radius: float = 0.15, seed: int = 0):
    """(vertices (N, 3) float64, faces (F, 3) int64, lbs weights (N, 24),
    joints (24, 3)) of the procedural tube body."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(-height / 2, height / 2, n_rings)
    angles = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    prof = radius * (0.6 + 0.4 * np.sin(np.linspace(0.15, np.pi - 0.15, n_rings)))
    verts = np.asarray([[prof[r] * np.cos(a), y, prof[r] * np.sin(a)] for r, y in enumerate(ys) for a in angles],
                       np.float64)
    faces = []
    for r in range(n_rings - 1):
        for s in range(n_seg):
            a, b = r * n_seg + s, r * n_seg + (s + 1) % n_seg
            c, d = (r + 1) * n_seg + s, (r + 1) * n_seg + (s + 1) % n_seg
            faces += [[a, b, c], [b, d, c]]
    verts_list = [verts]
    n_base = len(verts)

    def add_cap(end_ring_start, y_end, r_end, direction):
        nonlocal n_base
        prev = [end_ring_start + s for s in range(n_seg)]
        for k in range(1, 4):
            frac = k / 4.0
            rk = r_end * (1.0 - frac)
            yk = y_end + direction * 0.035 * np.sin(frac * np.pi / 2)
            verts_list.append(np.asarray([[rk * np.cos(a), yk, rk * np.sin(a)] for a in angles]))
            cur = [n_base + s for s in range(n_seg)]
            n_base += n_seg
            for s in range(n_seg):
                a0, b0, c0, d0 = prev[s], prev[(s + 1) % n_seg], cur[s], cur[(s + 1) % n_seg]
                faces.extend([[a0, b0, c0], [b0, d0, c0]] if direction > 0 else [[b0, a0, c0], [d0, b0, c0]])
            prev = cur
        verts_list.append(np.asarray([[0.0, y_end + direction * 0.04, 0.0]]))
        pole = n_base
        n_base += 1
        for s in range(n_seg):
            faces.append([prev[s], prev[(s + 1) % n_seg], pole] if direction > 0
                         else [prev[(s + 1) % n_seg], prev[s], pole])

    add_cap((n_rings - 1) * n_seg, ys[-1], prof[-1], +1.0)
    add_cap(0, ys[0], prof[0], -1.0)
    verts = np.vstack(verts_list)
    faces = np.asarray(faces, np.int64)
    joints = np.zeros((24, 3))
    joints[:, 1] = np.linspace(-height * 0.35, height * 0.45, 24)
    joints[:, 0] = rng.normal(scale=0.02, size=24)
    joints[0] = [0.0, -height * 0.1, 0.0]
    d2 = ((verts[:, None, :] - joints[None, :, :]) ** 2).sum(-1)
    w = np.exp(-d2 / (2 * 0.12**2))
    w = w / w.sum(axis=1, keepdims=True)
    return verts, faces, w, joints


def subdivide(vertices: np.ndarray, faces: np.ndarray, weights: np.ndarray):
    """1-to-4 midpoint subdivision: old face k becomes faces 4k..4k+3; the
    midpoints' weights are their endpoints' means."""
    edges = np.sort(np.stack([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=1).reshape(-1, 2), axis=1)
    unique, inverse = np.unique(edges, axis=0, return_inverse=True)
    mid_idx = inverse.reshape(-1, 3) + len(vertices)
    m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
    new_faces = np.column_stack([faces[:, 0], m01, m20, m01, faces[:, 1], m12, m20, m12, faces[:, 2],
                                 m01, m12, m20]).reshape(-1, 3)
    new_verts = np.vstack([vertices, vertices[unique].mean(axis=1)])
    new_w = np.vstack([weights, weights[unique].mean(axis=1)])
    return new_verts, new_faces, new_w


def unique_edges(faces: np.ndarray):
    all_edges = np.sort(np.concatenate([faces[:, [1, 2]], faces[:, [0, 2]], faces[:, [0, 1]]], axis=0), axis=1)
    edges, inverse = np.unique(all_edges, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    F = faces.shape[0]
    return edges.astype(np.int64), np.stack([inverse[:F], inverse[F:2 * F], inverse[2 * F:]], axis=1)


def face_pairs(faces: np.ndarray) -> np.ndarray:
    """(P, 2) faces sharing an interior edge."""
    _, face_to_edge = unique_edges(faces)
    edge_ids = face_to_edge.reshape(-1)
    face_ids = np.repeat(np.arange(faces.shape[0], dtype=np.int64), 3)
    order = np.argsort(edge_ids, kind="stable")
    edge_ids, face_ids = edge_ids[order], face_ids[order]
    same = edge_ids[:-1] == edge_ids[1:]
    return np.stack([face_ids[:-1][same], face_ids[1:][same]], axis=1)


def normal_quads(faces: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """(P, 4) (v0, v1, a, b) per interior edge: its ends and the two
    opposite vertices."""
    edges, face_to_edge = unique_edges(faces)
    fa, fb = pairs[:, 0], pairs[:, 1]
    ea, eb = face_to_edge[fa], face_to_edge[fb]
    shared = np.zeros(pairs.shape[0], dtype=np.int64)
    for i in range(3):
        for j in range(3):
            shared = np.where(ea[:, i] == eb[:, j], ea[:, i], shared)
    v0, v1 = edges[shared, 0], edges[shared, 1]

    def opposite(rows):
        opp = np.zeros(rows.shape[0], dtype=np.int64)
        for k in range(3):
            opp = np.where((rows[:, k] != v0) & (rows[:, k] != v1), rows[:, k], opp)
        return opp

    return np.stack([v0, v1, opposite(faces[fa]), opposite(faces[fb])], axis=1)


def incidence(faces: np.ndarray, num_vertices: int, max_degree: int = 16):
    """(N, maxdeg) incident faces per vertex in ascending face order, padded
    with face 0 at weight 0, at most ``max_degree`` kept."""
    vert = faces.reshape(-1)
    face = np.repeat(np.arange(len(faces), dtype=np.int64), faces.shape[1])
    order = np.argsort(vert, kind="stable")
    vert, face = vert[order], face[order]
    degree = np.bincount(vert, minlength=num_vertices)
    first = np.concatenate([[0], np.cumsum(degree)[:-1]])
    rank = np.arange(len(vert)) - first[vert]
    maxdeg = min(max(1, int(degree.max(initial=0))), max_degree)
    keep = rank < maxdeg
    inc = np.zeros((num_vertices, maxdeg), dtype=np.int64)
    valid = np.zeros((num_vertices, maxdeg), dtype=np.float32)
    inc[vert[keep], rank[keep]] = face[keep]
    valid[vert[keep], rank[keep]] = 1.0
    return inc, valid


class Mesh(NamedTuple):
    """The static tensors of one phase, on the device."""

    faces: object  # (F, 3) int64
    lbs_weights: object  # (N, 24) float32
    joints: np.ndarray  # (24, 3) canonical joints, host
    edges: object  # (E, 2) int64
    degree: object  # (N,) float32
    pairs: object  # (P, 2) int64 edge-adjacent faces
    quads: object  # (P, 4) int64
    vf_inc: object  # (N, maxdeg) int64
    vf_valid: object  # (N, maxdeg) float32


def build_mesh(body: dict, phase: int, device) -> Mesh:
    """The mesh of ``synthetic_body(**body)`` after ``phase`` subdivisions."""
    import torch

    verts, faces, w, joints = synthetic_body(**body)
    for _ in range(phase):
        # the weights are float32 between phases, as the program keeps them
        verts, faces, w = subdivide(verts, faces, w.astype(np.float32).astype(np.float64))
    edges, _ = unique_edges(faces)
    pairs = face_pairs(faces)
    inc, valid = incidence(faces, len(verts))

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return Mesh(
        faces=dev(faces, np.int64), lbs_weights=dev(w, np.float32), joints=joints.astype(np.float32),
        edges=dev(edges, np.int64),
        degree=dev(np.bincount(edges.reshape(-1), minlength=len(verts)), np.float32),
        pairs=dev(pairs, np.int64), quads=dev(normal_quads(faces, pairs), np.int64),
        vf_inc=dev(inc, np.int64), vf_valid=dev(valid, np.float32),
    )

"""Mesh operations (port of gomavatar_tpu/ops/mesh_ops.py).

* Host-side topology in numpy, built once per training phase
  (``MeshTopology.build``): unique edges, faces sharing an edge, the
  normal-consistency quads, vertex degrees, the padded vertex->face
  incidence table, and the gather tables of every index transpose of the
  train step (``DualIndex``, ``NeighborTable``); plus 1->4 midpoint
  subdivision.
* Per-step quantities in PyTorch, differentiable by autograd: vertex
  normals, the uniform Laplacian, normal- and color-consistency and edge
  losses.

The transpose of a gather ``values[idx]`` adds each output row's gradient
back onto its value.  As a scatter (``index_add``) on the card, its atomics
add a value's terms in no fixed order, so two runs of one step differ in the
last bits.  :func:`gather_vjp` adds them instead by a GATHER over the
``DualIndex`` of ``idx`` (each value's positions in ``idx``) and a sum along
the table, as the reference does to avoid TPU scatters: the same bits on
every run.  :func:`neighbor_sum` computes the Laplacian's neighbour sums the
same way.  ``gather_rows`` and ``uniform_laplacian_loss`` keep the plain
forms for the eval path and the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# -- gather tables: the transposes of index gathers ----------------------------

def _as_tensors(cls, arrays: dict):
    return cls(**{k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in arrays.items()})


def _to(table, device):
    return type(table)(**{f.name: getattr(table, f.name).to(device) for f in dataclasses.fields(table)})


def _overflow_rows(ov_val: np.ndarray, ov_item: np.ndarray, num_values: int) -> dict:
    """The overflow list (``ov_val`` ascending, each value's items in order)
    as a table of its own: ``ov_row`` (V,) each value's row, U (a zero row)
    where it has none; ``ov_tab`` / ``ov_tvalid`` (U, w) the items of each
    of the U values with overflow, w the most any has."""
    rows, first, counts = np.unique(ov_val, return_index=True, return_counts=True)
    width = max(int(counts.max()) if counts.size else 1, 1)
    r = np.searchsorted(rows, ov_val)
    rank = np.arange(len(ov_val)) - first[r]
    ov_row = np.full((num_values,), len(rows), np.int64)
    ov_row[rows] = np.arange(len(rows))
    ov_tab = np.zeros((len(rows), width), np.int64)
    ov_tvalid = np.zeros((len(rows), width), np.float32)
    ov_tab[r, rank] = ov_item
    ov_tvalid[r, rank] = 1.0
    return dict(ov_row=ov_row, ov_tab=ov_tab, ov_tvalid=ov_tvalid)


def _table_sum(x: torch.Tensor, tab: torch.Tensor, valid: torch.Tensor, table) -> torch.Tensor:
    """Per row v: sum_j valid[v, j] * x[tab[v, j]] over the capped table,
    plus the sum over v's row of the overflow table (``table.ov_*``).  Only
    gathers and fixed-order sums along the rows: the same bits on every
    run."""
    trailing = x.shape[1:]

    def rows_sum(t, w):
        g = torch.index_select(x, 0, t.reshape(-1)).reshape(*t.shape, *trailing)
        return torch.sum(g * w.reshape(*w.shape, *(1,) * len(trailing)), dim=1)

    s = rows_sum(tab, valid)
    if table.ov_tab.shape[0]:
        extra = torch.cat([rows_sum(table.ov_tab, table.ov_tvalid), x.new_zeros((1, *trailing))])
        s = s + torch.index_select(extra, 0, table.ov_row)
    return s


@dataclasses.dataclass(frozen=True, eq=False)
class DualIndex:
    """The transpose of an integer index array ``idx`` over ``num_values``
    values: for each value v, the FLAT positions in ``idx.reshape(-1)``
    where v appears.  ``pos`` / ``valid`` / ``ov_pos`` / ``ov_val`` are the
    reference's tables: each value's first ``width`` positions (ascending,
    padded with 0 at weight 0), and the positions beyond the cap as an
    overflow list.  The reference adds that list with one scatter; here it
    is a second table (``ov_row``, ``ov_tab``, ``ov_tvalid``), summed in a
    fixed order like the first, so the transpose is exact and reproducible
    for any degree.  Compared by identity: a program keys on the object, and
    its tables stay fixed for the phase."""

    pos: torch.Tensor  # (V, width) int64
    valid: torch.Tensor  # (V, width) f32
    ov_pos: torch.Tensor  # (n_ov,) int64
    ov_val: torch.Tensor  # (n_ov,) int64, ascending
    ov_row: torch.Tensor  # (V,) int64 row of ov_tab, U where none
    ov_tab: torch.Tensor  # (U, w) int64 overflow positions per value
    ov_tvalid: torch.Tensor  # (U, w) f32

    def to(self, device) -> "DualIndex":
        return _to(self, device)


def build_dual_index(idx: np.ndarray, num_values: int, cap: int = 16, mask: np.ndarray | None = None) -> DualIndex:
    """The :class:`DualIndex` of ``idx`` (any shape) over ``num_values``, on
    the host; ``mask`` (the shape of ``idx``, truthy = real) leaves out the
    padding slots of masked index tables."""
    flat = np.asarray(idx).reshape(-1)
    keep = np.ones(flat.shape[0], bool) if mask is None else np.asarray(mask).reshape(-1) > 0
    order = np.argsort(flat[keep], kind="stable")
    positions = np.nonzero(keep)[0][order]
    vals = flat[keep][order]
    counts = np.bincount(vals, minlength=num_values)
    width = int(min(counts.max() if counts.size else 1, cap)) or 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(vals)) - starts[vals]
    inb = rank < width
    pos = np.zeros((num_values, width), np.int64)
    valid = np.zeros((num_values, width), np.float32)
    pos[vals[inb], rank[inb]] = positions[inb]
    valid[vals[inb], rank[inb]] = 1.0
    ov_pos, ov_val = positions[~inb].astype(np.int64), vals[~inb].astype(np.int64)
    return _as_tensors(DualIndex, dict(pos=pos, valid=valid, ov_pos=ov_pos, ov_val=ov_val,
                                       **_overflow_rows(ov_val, ov_pos, num_values)))


def entry_dual_index(entry_gauss: torch.Tensor, entry_valid: torch.Tensor, num_values: int,
                     width: int) -> DualIndex:
    """The :class:`DualIndex` of a binning's per-entry primitive ids, built
    on the device each frame with static shapes and no host read (a step
    program captures it): a stable sort of the ids, each primitive's run
    found by a search.  Pad entries (``entry_valid`` 0; they carry
    primitive 0) are left out.  ``width`` is the binning's per-primitive
    budget: a primitive enumerates at most that many distinct tiles, each
    once, so no run is longer, which is asserted on the device."""
    with torch.no_grad():
        dev = entry_gauss.device
        key = torch.where(entry_valid > 0, entry_gauss, torch.full_like(entry_gauss, num_values))
        skey, order = torch.sort(key, stable=True)
        bounds = torch.searchsorted(skey, torch.arange(num_values + 1, dtype=skey.dtype, device=dev))
        start, count = bounds[:-1], bounds[1:] - bounds[:-1]
        torch._assert_async(torch.all(count <= width), "a primitive has more entries than its tile budget")
        j = torch.arange(width, dtype=torch.int64, device=dev)
        slot = torch.clamp_max(start[:, None] + j, key.shape[0] - 1)
        valid = j < count[:, None]
        pos = torch.where(valid, order[slot], torch.zeros_like(slot))
        none = torch.zeros((0,), dtype=torch.int64, device=dev)
        return DualIndex(pos=pos, valid=valid.to(torch.float32), ov_pos=none, ov_val=none,
                         ov_row=torch.zeros((num_values,), dtype=torch.int64, device=dev),
                         ov_tab=torch.zeros((0, 1), dtype=torch.int64, device=dev),
                         ov_tvalid=torch.zeros((0, 1), dtype=torch.float32, device=dev))


class GatherVJP(torch.autograd.Function):
    """``values[idx]`` along dim 0 (an ``index_select``) whose backward adds
    each value's gradient terms by a gather over ``dual``, the
    :class:`DualIndex` of ``idx`` over the values, and a sum in table order
    (:func:`_table_sum`), where ``index_select``'s own backward is an
    ``index_add`` with atomics."""

    @staticmethod
    def forward(ctx, values: torch.Tensor, idx: torch.Tensor, dual: DualIndex) -> torch.Tensor:
        ctx.trailing, ctx.dual = values.shape[1:], dual
        return torch.index_select(values, 0, idx.reshape(-1)).reshape(*idx.shape, *values.shape[1:])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dual = ctx.dual
        flat = g.reshape(-1, *ctx.trailing)
        return _table_sum(flat, dual.pos, dual.valid, dual), None, None


gather_vjp = GatherVJP.apply


@dataclasses.dataclass(frozen=True, eq=False)
class NeighborTable:
    """Padded vertex-neighbour table from the undirected edge list (the
    reference's ``nbr``, ``valid``, ``ov_v``, ``ov_nbr``: the first ``cap``
    neighbours of each vertex, the rest as an overflow list), with the
    overflow as a second table as in :class:`DualIndex`.  The adjacency is
    symmetric, so :func:`neighbor_sum`'s transpose is the same sum over the
    same table, where the reference gathers through the dual of ``nbr``."""

    nbr: torch.Tensor  # (V, width) int64, 0 at padding
    valid: torch.Tensor  # (V, width) f32
    ov_v: torch.Tensor  # (n_ov,) int64, ascending
    ov_nbr: torch.Tensor  # (n_ov,) int64
    ov_row: torch.Tensor  # (V,) int64 row of ov_tab, U where none
    ov_tab: torch.Tensor  # (U, w) int64 overflow neighbours per vertex
    ov_tvalid: torch.Tensor  # (U, w) f32

    def to(self, device) -> "NeighborTable":
        return _to(self, device)


def build_neighbor_table(edges: np.ndarray, num_vertices: int, cap: int = 16) -> NeighborTable:
    edges = np.asarray(edges)
    directed = np.concatenate([edges, edges[:, ::-1]], axis=0)  # (2E, 2)
    d_src = build_dual_index(directed[:, 0], num_vertices, cap=cap)
    pos, valid = d_src.pos.numpy(), d_src.valid.numpy()
    ov_v, ov_nbr = d_src.ov_val.numpy(), directed[:, 1][d_src.ov_pos.numpy()].astype(np.int64)
    return _as_tensors(NeighborTable, dict(
        nbr=directed[:, 1][pos].astype(np.int64) * (valid > 0), valid=valid, ov_v=ov_v, ov_nbr=ov_nbr,
        **_overflow_rows(ov_v, ov_nbr, num_vertices)))


class _NeighborSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values: torch.Tensor, nt: NeighborTable) -> torch.Tensor:
        ctx.nt = nt
        return _table_sum(values, nt.nbr, nt.valid, nt)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _table_sum(g, ctx.nt.nbr, ctx.nt.valid, ctx.nt), None


def neighbor_sum(values: torch.Tensor, nt: NeighborTable) -> torch.Tensor:
    """Per-vertex sum of the neighbours' values (V, C) -> (V, C), exact for
    any degree, gathers and fixed-order sums in both directions."""
    return _NeighborSum.apply(values, nt)


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
    """Static per-phase topology (host numpy), with the gather tables of the
    train step's index transposes (host tensors; ``.to(device)`` each)."""

    faces: np.ndarray  # (F, 3) int
    edges: np.ndarray  # (E, 2) int, unique undirected
    face_to_edge: np.ndarray  # (F, 3) int
    face_connectivity: np.ndarray  # (P, 2) int, faces sharing an edge
    nc_quads: np.ndarray  # (P, 4) int: (v0, v1, a, b) per interior edge
    vertex_degree: np.ndarray  # (N,) float, neighbours per vertex
    vf_incidence: np.ndarray  # (N, maxdeg) int, incident faces per vertex
    vf_valid: np.ndarray  # (N, maxdeg) float mask
    num_vertices: int
    dual_faces: DualIndex  # dual of faces over vertices
    dual_nc: DualIndex  # dual of nc_quads over vertices
    dual_conn: DualIndex  # dual of face_connectivity over faces
    dual_vfinc: DualIndex  # dual of the masked vf_incidence over faces
    nbr_table: NeighborTable  # vertex neighbours (the Laplacian)

    @staticmethod
    def build(faces: np.ndarray, num_vertices: int) -> "MeshTopology":
        faces = np.asarray(faces, dtype=np.int64)
        edges, face_to_edge = unique_edges(faces)
        degree = np.bincount(edges.reshape(-1), minlength=num_vertices).astype(np.float32)
        inc, valid = vertex_face_incidence(faces, num_vertices)
        conn = face_connectivity_pairs(faces)
        quads = normal_consistency_pairs(faces)
        return MeshTopology(
            faces=faces,
            edges=edges,
            face_to_edge=face_to_edge,
            face_connectivity=conn,
            nc_quads=quads,
            vertex_degree=degree,
            vf_incidence=inc,
            vf_valid=valid,
            num_vertices=num_vertices,
            dual_faces=build_dual_index(faces, num_vertices),
            dual_nc=build_dual_index(quads, num_vertices),
            dual_conn=build_dual_index(conn, len(faces)),
            dual_vfinc=build_dual_index(inc, len(faces), mask=valid),
            nbr_table=build_neighbor_table(edges, num_vertices),
        )


# -- per-step quantities -------------------------------------------------------

def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` along dim 0, through ``index_select``, whose backward
    is an ``index_add`` (atomic adds: not reproducible bit for bit on the
    card).  The train step's gathers go through :func:`gather_vjp`; the
    backward of plain ``values[idx]`` sorts the indices and walks each run
    of duplicates serially (~146 ms of a 205 ms step on the H100 for the
    step's gathers, ``profile_train.py``)."""
    return torch.index_select(values, 0, idx.reshape(-1)).reshape(*idx.shape, *values.shape[1:])


def abs_l1(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at x == 0 is +1, the subgradient of the reference's
    abs (torch's abs takes 0).  The L1 terms of the loss use it, so they
    move as the reference's do where a value equals its target, as the
    equal colors of a fresh model do in :func:`color_consistency_loss`."""
    return torch.where(x >= 0, x, -x)


def _normalized(acc: torch.Tensor) -> torch.Tensor:
    return acc / (torch.linalg.norm(acc, dim=-1, keepdim=True) + 1e-12)


def face_normals(verts: torch.Tensor, faces: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """(N, 3), (F, 3) -> (F, 3) face normals (cross of the edges, CCW)."""
    tri = gather_rows(verts, faces)
    n = torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    return _normalized(n) if normalize else n


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals (PyTorch3D ``verts_normals_packed``):
    each face's unnormalised normal added to its three vertices, then
    normalised.  Scatter-based, the plain form; the train step takes
    :func:`vertex_normals_from_tri`."""
    n = face_normals(verts, faces, normalize=False)
    acc = torch.zeros_like(verts)
    for k in range(3):
        acc = acc.index_add(0, faces[:, k], n)
    return _normalized(acc)


def vertex_normals_incidence(verts: torch.Tensor, faces: torch.Tensor, vf_incidence: torch.Tensor,
                             vf_valid: torch.Tensor) -> torch.Tensor:
    """:func:`vertex_normals` as a gather: the sum of the unnormalised
    normals of each vertex's (padded, capped) incident faces."""
    n = face_normals(verts, faces, normalize=False)
    return _normalized(torch.sum(gather_rows(n, vf_incidence) * vf_valid[..., None], dim=1))


def vertex_normals_from_tri(tri: torch.Tensor, vf_incidence: torch.Tensor, vf_valid: torch.Tensor,
                            dual: DualIndex) -> torch.Tensor:
    """:func:`vertex_normals_incidence` from gathered triangles (F, 3, 3),
    its gather transposed through ``dual`` (the DualIndex of the masked
    incidence over faces)."""
    crosses = torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)  # (F, 3)
    return _normalized(torch.sum(gather_vjp(crosses, vf_incidence, dual) * vf_valid[..., None], dim=1))


def edge_lengths(verts: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    e = gather_rows(verts, edges)
    return torch.linalg.norm(e[:, 0] - e[:, 1], dim=-1)


def uniform_laplacian_loss(verts: torch.Tensor, edges: torch.Tensor, degree: torch.Tensor) -> torch.Tensor:
    """mean_i || (1/deg_i) sum_{j in N(i)} (v_j - v_i) ||^2, the uniform
    Laplacian smoothing objective, as edge scatters (the plain form);
    ``degree`` is a constant."""
    e = gather_rows(verts, edges)
    diff01 = e[:, 1] - e[:, 0]
    acc = torch.zeros_like(verts).index_add(0, edges[:, 0], diff01).index_add(0, edges[:, 1], -diff01)
    lap = acc / torch.clamp_min(degree, 1.0)[:, None]
    return torch.mean(torch.sum(lap * lap, dim=-1))


def uniform_laplacian_loss_nbr(verts: torch.Tensor, nt: NeighborTable, degree: torch.Tensor) -> torch.Tensor:
    """:func:`uniform_laplacian_loss` through the neighbour table
    (:func:`neighbor_sum`): no scatter in either direction; the same value
    up to the order of the sums."""
    acc = neighbor_sum(verts, nt) - degree[:, None] * verts
    lap = acc / torch.clamp_min(degree, 1.0)[:, None]
    return torch.mean(torch.sum(lap * lap, dim=-1))


def normal_consistency_loss(verts: torch.Tensor, nc_quads: torch.Tensor, dual: DualIndex | None = None) -> torch.Tensor:
    """PyTorch3D ``mesh_normal_consistency``: for each interior edge (v0, v1)
    with opposite vertices a, b, the mean of
    1 - cos(cross(v1 - v0, a - v0), -cross(v1 - v0, b - v0)).  ``dual``
    (the quads' DualIndex over vertices) transposes the gather by a gather."""
    q = gather_rows(verts, nc_quads) if dual is None else gather_vjp(verts, nc_quads, dual)
    v0, v1, a, b = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    e = v1 - v0
    n0 = torch.cross(e, a - v0, dim=-1)
    n1 = -torch.cross(e, b - v0, dim=-1)
    cos = torch.sum(n0 * n1, dim=-1) / (torch.linalg.norm(n0, dim=-1) * torch.linalg.norm(n1, dim=-1) + 1e-12)
    return torch.mean(1.0 - cos)


def color_consistency_loss(colors: torch.Tensor, face_connectivity: torch.Tensor,
                           dual: DualIndex | None = None) -> torch.Tensor:
    """Mean L1 between the colors of edge-adjacent faces; ``dual`` as in
    :func:`normal_consistency_loss`, over faces."""
    cc = gather_rows(colors, face_connectivity) if dual is None else gather_vjp(colors, face_connectivity, dual)
    return torch.mean(abs_l1(cc[:, 0] - cc[:, 1]))


def mesh_edge_loss(verts: torch.Tensor, edges: torch.Tensor, target_length: torch.Tensor) -> torch.Tensor:
    """Mean squared deviation of edge lengths from their targets."""
    return torch.mean((edge_lengths(verts, edges) - target_length) ** 2)

"""The GoM (Gaussians-on-Mesh) avatar model (port of
gomavatar_tpu/models/gom.py).

State is split three ways, as in the reference:
  * ``params``: learnable tensors in a plain dict (vertices, per-face
    so3/scale, appearance colors, MLP weights, optionally lbs logits);
  * ``GoMStatics``: per-phase non-learnable tensors (faces, mesh topology
    and the gather tables of its index transposes, target edge lengths,
    fixed lbs weights);
  * ``GoMConfig``: static Python scalars.

Both paths start with pose refinement -> non-rigid offsets -> FK + LBS.
``gom_forward(train=False)`` is the novel-view eval frame:
``render_frame_eval`` (per-face geometry table, per-face shadow MLP, sorted
binning, kernel B1, untile, shading).  ``gom_forward(train=True)`` is the
differentiable train frame: Steiner covariances, one union binning shared
by the splat blend (kernels B2/B3) and the mesh raster with its soft
silhouette (kernels B4/B5), and the shadow MLP per pixel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.models import modules as M
from gomavatar_tpu_torch.ops.frame_render import NCMAX, render_frame_sorted
from gomavatar_tpu_torch.ops.fused_render import frame_union_bins
from gomavatar_tpu_torch.ops.geometry import frame_geometry
from gomavatar_tpu_torch.ops.mesh_ops import (
    DualIndex,
    MeshTopology,
    NeighborTable,
    entry_dual_index,
    gather_rows,
    gather_vjp,
    replicate_face_attribute,
    subdivide_mesh,
    vertex_normals_from_tri,
)
from gomavatar_tpu_torch.ops.mesh_raster import np_log_blur, rasterize_mesh
from gomavatar_tpu_torch.ops.skeleton import apply_lbs, get_global_RTs
from gomavatar_tpu_torch.ops.splat.binning import CHUNK, bin_sorted, compact_tiles, count_frame
from gomavatar_tpu_torch.ops.splat.render import render_gaussians
from gomavatar_tpu_torch.ops.steiner import face_covariances, face_covariances_tri
from gomavatar_tpu_torch.ops.transforms import mm, so3_exp


class GoMStatics(NamedTuple):
    """Per-phase non-learnable tensors.  The gather tables transpose the
    train step's static index gathers by gathers (``mesh_ops.gather_vjp``),
    so its backward adds in a fixed order."""

    faces: torch.Tensor  # (F, 3) int64
    vf_incidence: torch.Tensor  # (N, maxdeg) int64 incident faces per vertex
    vf_valid: torch.Tensor  # (N, maxdeg) f32 mask
    lbs_weights: torch.Tensor  # (N, J) f32 (fixed path; ignored when refining)
    edges: torch.Tensor  # (E, 2) int64 unique undirected edges
    nc_quads: torch.Tensor  # (Q, 4) int64 normal-consistency quads
    face_connectivity: torch.Tensor  # (Q, 2) int64 faces sharing an edge
    vertex_degree: torch.Tensor  # (N,) f32
    target_edge_length: torch.Tensor  # (E,) f32 canonical edge lengths
    dual_faces: DualIndex  # faces over vertices
    dual_nc: DualIndex  # nc_quads over vertices
    dual_conn: DualIndex  # face_connectivity over faces
    dual_vfinc: DualIndex  # the masked vf_incidence over faces
    nbr_table: NeighborTable  # vertex neighbours (the Laplacian)


# The default tile budgets (16 per primitive, entry buffer factor 4) were
# tuned at the post-subdivision SMPL face count; coverage per face at fixed
# 512^2 framing scales ~ 1/F, so a coarser phase needs proportionally larger
# per-primitive budgets while total entries stay ~flat.
_TUNED_FACE_COUNT = 55104  # one midpoint subdivision of SMPL's 13776 faces

# Floor on the per-gaussian budget at ANY phase: trained splat scales grow
# past the untrained coverage the budgets were tuned on (the trained
# 57,600-face avatar needs 32 for zero drops).
_MTG_FLOOR = 32

# The frame the budgets were tuned at.  At fixed framing a splat's tile
# count grows with the frame's area, so above it the per-gaussian budget
# grows by the area ratio times _FRAME_MARGIN; at it and below the budgets
# are those of the JAX package.  At 544^2 the widest splat of JAX's trained
# avatar spans 36 tiles (32 at 512^2 drops entries there), the port's own
# 42, and training the former on the PeopleSnapshot recipe widens it to 49
# (7 x 7) within 2,000 steps: 7/4 of the area ratio gives 64 (8 x 8).
_TUNED_FRAME_AREA = 512 * 512
_FRAME_MARGIN = (7, 4)


def tile_budget_factor(num_faces: int) -> int:
    """Budget multiplier for a phase with ``num_faces`` faces: the face-area
    ratio vs the tuned scale, ceil'd, clamped to [1, 4]."""
    return max(1, min(4, -(-_TUNED_FACE_COUNT // max(num_faces, 1))))


def frame_tile_budget(budget: int, img_size) -> int:
    """A per-gaussian tile budget tuned at 512^2, at a frame of ``img_size``:
    ``budget`` itself up to 512^2 in area, above it ``budget`` times the
    area ratio and _FRAME_MARGIN, ceil'd."""
    area = int(img_size[0]) * int(img_size[1])
    if area <= _TUNED_FRAME_AREA:
        return budget
    num, den = _FRAME_MARGIN
    return -(-budget * area * num // (_TUNED_FRAME_AREA * den))


@dataclasses.dataclass(frozen=True)
class GoMConfig:
    """Static scalars of the model."""

    img_size: tuple[int, int]
    num_vertices: int
    num_faces: int
    sigma: float = 0.001
    radius_scale: float = 1.0
    deform_so3: bool = True
    deform_scale: bool = True
    lbs_refine: bool = False
    use_smplx: bool = False
    # module configs as hashable tuples of items (None = module disabled)
    pose_refinement: tuple | None = None
    non_rigid: tuple | None = None
    shadow: tuple | None = None
    normal_renderer_sigma: float = 1e-5
    # 'auto': the train splat blend goes by device (kernels B2/B3 on CUDA,
    # their plain version on the CPU); 'reference': the brute-force oracle
    splat_impl: str = "auto"
    max_tiles_per_gaussian: int = 16
    max_tiles_per_face: int = 8
    # the sorted binning keeps N * buffer_factor + min(T, A) * CHUNK entries
    buffer_factor: int = 4
    # static cap on non-empty tiles (a 512^2 body view covers ~200 of 1024;
    # overflow is counted in the binning telemetry)
    active_tile_cap: int = 512
    # two-band binning: every face gets binning_band0 tile slots, faces
    # covering more share an overflow band; None = single band
    binning_band0: int | None = 4
    # the same for the train path's union binning (from_model_cfg sets 4*bf)
    binning_band0_train: int | None = None
    # cap on the non-empty tiles the train kernels sweep (None = every tile);
    # tiles beyond it render empty and count as dropped in the telemetry
    train_active_tile_cap: int | None = None

    @staticmethod
    def from_model_cfg(model_cfg: dict, num_vertices: int, num_faces: int) -> "GoMConfig":
        def tup(d):
            if d is None or d.get("name", "none") == "none":
                return None
            return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in d.items()))

        cg = model_cfg["canonical_geometry"]
        bf = tile_budget_factor(num_faces)
        return GoMConfig(
            img_size=tuple(model_cfg["img_size"]),
            num_vertices=num_vertices,
            num_faces=num_faces,
            sigma=float(cg["sigma"]),
            radius_scale=float(cg["radius_scale"]),
            deform_so3=bool(cg["deform_so3"]),
            deform_scale=bool(cg["deform_scale"]),
            lbs_refine=bool(model_cfg["lbs_weights"]["refine"]),
            use_smplx=bool(model_cfg.get("use_smplx", False)),
            pose_refinement=tup(model_cfg.get("pose_refinement")),
            non_rigid=tup(model_cfg.get("non_rigid")),
            shadow=tup(model_cfg.get("shadow_module")),
            normal_renderer_sigma=float(model_cfg.get("normal_renderer", {}).get("sigma", 1e-5)),
            max_tiles_per_gaussian=frame_tile_budget(max(_MTG_FLOOR, 16 * bf), model_cfg["img_size"]),
            max_tiles_per_face=8 * bf,
            buffer_factor=4 * bf,
            binning_band0_train=4 * bf,
            binning_band0=4 * bf,
        )

    def module_cfg(self, name: str) -> dict | None:
        t = getattr(self, name)
        if t is None:
            return None
        return {k: (list(v) if isinstance(v, tuple) else v) for k, v in t}


def _build_statics(faces: np.ndarray, vertices: np.ndarray, lbs_weights: np.ndarray, device) -> GoMStatics:
    topo = MeshTopology.build(faces, len(vertices))
    tel = np.linalg.norm(vertices[topo.edges[:, 0]] - vertices[topo.edges[:, 1]], axis=-1).astype(np.float32)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return GoMStatics(
        faces=dev(faces, np.int64),
        vf_incidence=dev(topo.vf_incidence, np.int64),
        vf_valid=dev(topo.vf_valid, np.float32),
        lbs_weights=dev(lbs_weights, np.float32),
        edges=dev(topo.edges, np.int64),
        nc_quads=dev(topo.nc_quads, np.int64),
        face_connectivity=dev(topo.face_connectivity, np.int64),
        vertex_degree=dev(topo.vertex_degree, np.float32),
        target_edge_length=dev(tel),
        dual_faces=topo.dual_faces.to(device),
        dual_nc=topo.dual_nc.to(device),
        dual_conn=topo.dual_conn.to(device),
        dual_vfinc=topo.dual_vfinc.to(device),
        nbr_table=topo.nbr_table.to(device),
    )


def init_gom(
    model_cfg: dict,
    canonical_info: dict,
    device="cuda",
    key=None,
):
    """Build (params, statics, gom_cfg) from a model config and a canonical
    info dict (canonical_vertex (N,3), canonical_lbs_weights (N,J), faces
    (F,3)).  MLP weights are drawn from the ``prng`` key (``prng.key(0)``
    if None), split three ways as the reference splits it."""
    k_pr, k_nr, k_sh = prng.split(prng.key(0) if key is None else key, 3)
    vertices = np.asarray(canonical_info["canonical_vertex"], np.float32)
    faces = np.asarray(canonical_info["faces"], np.int64)
    lbs_w = np.asarray(canonical_info["canonical_lbs_weights"], np.float32)
    N, F = len(vertices), len(faces)

    gom_cfg = GoMConfig.from_model_cfg(model_cfg, N, F)
    statics = _build_statics(faces, vertices, lbs_w, device)
    params: dict[str, Any] = {
        "vertices": torch.as_tensor(vertices, device=device),
        "so3": torch.zeros((F, 3), dtype=torch.float32, device=device),
        "scale": torch.full((F, 3), gom_cfg.radius_scale, dtype=torch.float32, device=device),
        "appearance": M.appearance_init(F, model_cfg["appearance"]["color_init"], device=device),
    }
    if gom_cfg.lbs_refine:
        params["lbs_logits"] = torch.log(statics.lbs_weights + 1e-9)
    if gom_cfg.pose_refinement is not None:
        params["pose_refinement"] = M.pose_refinement_init(k_pr, gom_cfg.module_cfg("pose_refinement"), device)
    if gom_cfg.non_rigid is not None:
        params["non_rigid"] = M.non_rigid_init(k_nr, gom_cfg.module_cfg("non_rigid"), device)
    if gom_cfg.shadow is not None:
        params["shadow"] = M.shadow_init(k_sh, gom_cfg.module_cfg("shadow"), device)
    return params, statics, gom_cfg


def _lbs_weights(params: dict, statics: GoMStatics, cfg: GoMConfig) -> torch.Tensor:
    if cfg.lbs_refine:
        return torch.softmax(params["lbs_logits"], dim=-1)
    return statics.lbs_weights


def frame_table_and_bins(
    params: dict,
    statics: GoMStatics,
    cfg: GoMConfig,
    verts_obs: torch.Tensor,
    colors: torch.Tensor,
    K: torch.Tensor,
    E: torch.Tensor,
    blur_margin_px: float = 0.0,
):
    """The inputs of kernel B1 for one frame: (table (F, NCH) with the
    per-face shading in channel 22, SortedBinning, shading0 or None)."""
    geom = frame_geometry(
        verts_obs, statics.faces, params["so3"], params["scale"], colors,
        statics.vf_incidence, statics.vf_valid, K, E, cfg.img_size,
        cfg.sigma, blur_margin_px,
    )
    table = geom.table
    shading0 = None
    if cfg.shadow is not None:
        # the reference's per-pixel shadow MLP input is the summed normal of
        # the winning face, constant per face: run the MLP once per face and
        # let B1 z-buffer-select the scalar (channel 22)
        sh_cfg = cfg.module_cfg("shadow")
        face_sh = M.shadow_apply(params["shadow"], sh_cfg, table[:, 19:22])[:, 0] * 2.0
        shading0 = M.shadow_apply(
            params["shadow"], sh_cfg, torch.zeros((1, 3), dtype=table.dtype, device=table.device)
        )[0, 0] * 2.0
        table[:, 22] = face_sh  # in place: the table was made by this call
    ub = geom.union_box
    bins = bin_sorted(
        ub[0], ub[1], ub[2], ub[3], geom.depth, geom.valid,
        cfg.img_size,
        max_tiles_per_primitive=cfg.max_tiles_per_gaussian,
        buffer_factor=cfg.buffer_factor,
        active_cap=cfg.active_tile_cap,
        flag_boxes=(
            (geom.sx0, geom.sx1, geom.sy0, geom.sy1, geom.valid_splat),
            (geom.mx0, geom.mx1, geom.my0, geom.my1, geom.valid_mesh),
        ),
        band0=cfg.binning_band0,
        overflow_cap=max(statics.faces.shape[0] // 8, 2048),
    )
    return table, bins, shading0


def render_frame_eval(
    params: dict,
    statics: GoMStatics,
    cfg: GoMConfig,
    verts_obs: torch.Tensor,
    colors: torch.Tensor,
    K: torch.Tensor,
    E: torch.Tensor,
    blur_margin_px: float = 0.0,
    with_normal: bool = False,
):
    """Eval-frame render: per-face geometry table + per-face shadow MLP +
    sorted-segment binning + kernel B1.  Returns (rgb, mask[, normal, hit],
    aux) with aux = {"binning": telemetry, "tile_overflow": entries beyond
    what B1 ingests per tile}."""
    table, bins, shading0 = frame_table_and_bins(
        params, statics, cfg, verts_obs, colors, K, E, blur_margin_px
    )
    outs = render_frame_sorted(table, bins, cfg.img_size, shading0=shading0, with_normal=with_normal)
    return outs + (eval_aux(bins),)


def eval_aux(bins) -> dict:
    """The eval frame's aux: {"binning": telemetry, "tile_overflow": entries
    beyond what B1 ingests per tile (NCMAX chunks from the aligned-down
    start; worst-case head alignment wastes CHUNK-1)}."""
    tel = bins.telemetry
    return {
        "binning": tel,
        "tile_overflow": torch.clamp_min(tel.max_tile_entries - (NCMAX * CHUNK - (CHUNK - 1)), 0),
    }


def posed_vertices(
    params: dict,
    statics: GoMStatics,
    cfg: GoMConfig,
    cnl_gtfms: torch.Tensor,
    dst_Rs: torch.Tensor,
    dst_Ts: torch.Tensor,
    dst_posevec: torch.Tensor | None = None,
    i_iter=1e7,
    global_R: torch.Tensor | None = None,
    global_T: torch.Tensor | None = None,
) -> torch.Tensor:
    """Observation-space vertices (N, 3): pose refinement, non-rigid
    offsets, FK + LBS and the optional global transform, each gated by its
    kick-in iteration.  ``i_iter`` is a float32 device scalar in a step
    program (``programs.py``), which replays with the value it finds there; a
    Python float is filled into one here, outside any program."""
    if isinstance(i_iter, torch.Tensor):
        i_iter = i_iter.to(dtype=torch.float32, device=dst_Rs.device)
    else:
        # filled on the device: a host-to-device copy would wait for the stream
        i_iter = torch.full((), float(i_iter), dtype=torch.float32, device=dst_Rs.device)

    if cfg.pose_refinement is not None:
        pr_cfg = cfg.module_cfg("pose_refinement")
        delta = M.pose_refinement_apply(
            params["pose_refinement"],
            dst_posevec,
            total_bones=pr_cfg["total_bones"],
            refine_root=pr_cfg["refine_root"],
        )
        eye = torch.eye(3, dtype=delta.dtype, device=delta.device).expand(delta.shape)
        delta = torch.where(i_iter >= pr_cfg["kick_in_iter"], delta, eye)
        dst_Rs = mm(dst_Rs, delta)

    verts_pose = params["vertices"]
    if cfg.non_rigid is not None:
        nr_cfg = cfg.module_cfg("non_rigid")
        verts_nr = M.non_rigid_apply(params["non_rigid"], nr_cfg, verts_pose, dst_posevec, i_iter)
        verts_pose = torch.where(i_iter >= nr_cfg["kick_in_iter"], verts_nr, verts_pose)

    gR, gT = get_global_RTs(cnl_gtfms, dst_Rs, dst_Ts, use_smplx=cfg.use_smplx)
    verts_obs = apply_lbs(verts_pose, gR, gT, _lbs_weights(params, statics, cfg))

    if global_R is not None:
        verts_obs = mm(verts_obs, so3_exp(global_R).T) + global_T
    return verts_obs


def train_geometry(params: dict, statics: GoMStatics, cfg: GoMConfig, verts_obs: torch.Tensor,
                   K: torch.Tensor, E: torch.Tensor) -> dict:
    """The per-frame inputs of the train renderers: the gathered triangles,
    Steiner covariances, centroids, colors, camera-space vertex normals, and
    the shared union binning with the DualIndex of its entries (integers
    only, built without autograd)."""
    faces = statics.faces
    # one gather for every consumer, transposed by a gather
    tri = gather_vjp(verts_obs, faces, statics.dual_faces)  # (F, 3, 3)
    cov = face_covariances_tri(tri, params["so3"], params["scale"], cfg.sigma)
    centroids = tri.mean(dim=1)
    normals = vertex_normals_from_tri(tri, statics.vf_incidence, statics.vf_valid, statics.dual_vfinc)
    W, H = cfg.img_size
    # the soft silhouette's blur radius in pixels (NDC spans 2 over the
    # short side), plus one pixel
    blur_margin_px = (np_log_blur(cfg.normal_renderer_sigma) ** 0.5) / (2.0 / min(W, H)) + 1.0
    with torch.no_grad():
        bins = frame_union_bins(
            centroids, cov, verts_obs, faces, K, E, cfg.img_size,
            blur_margin_px=blur_margin_px,
            max_tiles_per_primitive=cfg.max_tiles_per_gaussian,
            buffer_factor=cfg.buffer_factor,
            dual_faces=statics.dual_faces,
            band0=cfg.binning_band0_train,
            overflow_cap=max(faces.shape[0] // 8, 2048),
        )[4]
        # the splat and the mesh entries gather per-face rows by entry_gauss:
        # one table transposes both
        bins = bins._replace(entry_dual=entry_dual_index(
            bins.entry_gauss, bins.entry_valid, cfg.num_faces, cfg.max_tiles_per_gaussian))
    return {
        "cov": cov,
        "centroids": centroids,
        "colors": M.appearance_apply(params["appearance"]),
        "opacity": torch.ones((cfg.num_faces,), dtype=torch.float32, device=verts_obs.device),
        "normals_cam": mm(normals, E[:3, :3].T),
        "bins": bins,
    }


def render_frame_train(params: dict, statics: GoMStatics, cfg: GoMConfig, verts_obs: torch.Tensor,
                       K: torch.Tensor, E: torch.Tensor):
    """The differentiable train frame: splat blend (kernels B2/B3) and mesh
    raster with the soft silhouette (kernels B4/B5) over one shared binning,
    then the shadow MLP per pixel.  Returns (rgb, mask, aux)."""
    g = train_geometry(params, statics, cfg, verts_obs, K, E)
    bins = g["bins"]
    albedo, mask = render_gaussians(
        g["centroids"], g["cov"], g["colors"], g["opacity"], K, E, cfg.img_size,
        implementation=cfg.splat_impl,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        bins=bins,
        active_cap=cfg.train_active_tile_cap,
    )
    mesh_out = rasterize_mesh(
        verts_obs, g["normals_cam"], statics.faces, K, E, cfg.img_size,
        soft_mask=True,
        blur_sigma=cfg.normal_renderer_sigma,
        max_tiles_per_face=cfg.max_tiles_per_face,
        bins=bins,
        dual_faces=statics.dual_faces,
        active_cap=cfg.train_active_tile_cap,
    )
    if cfg.shadow is not None:
        # the shadow MLP on the normal map, x2 for identity at init
        W, H = cfg.img_size
        shading = M.shadow_apply(params["shadow"], cfg.module_cfg("shadow"), mesh_out.normal.reshape(-1, 3))
        shading = shading.reshape(H, W, 1) * 2.0
        rgb = albedo * shading
    else:
        shading = None
        rgb = albedo

    tel = bins.telemetry
    if cfg.train_active_tile_cap is not None:
        # entries of the non-empty tiles beyond the cap are never swept
        dropped_active = compact_tiles(bins.tile_start, bins.tile_count, cfg.train_active_tile_cap)[5]
        tel = tel._replace(dropped_buffer=tel.dropped_buffer + dropped_active)
    aux = {
        "colors": g["colors"],
        "verts_obs": verts_obs,
        "verts_cnl": params["vertices"],
        "albedo": albedo,
        "normal": mesh_out.normal,
        "normal_mask": mesh_out.soft_mask,
        "shadow": shading,
        # all zero means no binning budget dropped an entry
        "binning": tel,
    }
    return rgb, mask, aux


def gom_forward(
    params: dict,
    statics: GoMStatics,
    cfg: GoMConfig,
    K: torch.Tensor,
    E: torch.Tensor,
    cnl_gtfms: torch.Tensor,
    dst_Rs: torch.Tensor,
    dst_Ts: torch.Tensor,
    dst_posevec: torch.Tensor | None = None,
    i_iter=1e7,
    global_R: torch.Tensor | None = None,
    global_T: torch.Tensor | None = None,
    train: bool = False,
    device="cuda",
):
    """Single-frame forward on ``device``, where params and statics must
    already live; the per-frame inputs (tensors or arrays) are moved there.
    Returns (rgb (H, W, 3), mask (H, W), aux).  Eval (``train=False``): aux
    holds the binning telemetry and ``tile_overflow``.  Train: differentiable
    in ``params``; aux holds colors, verts_obs, verts_cnl, albedo, normal,
    normal_mask (the soft silhouette), shadow and the telemetry."""
    device = torch.device(device)
    if params["vertices"].device.type != device.type or statics.faces.device.type != device.type:
        raise ValueError(f"params and statics must live on {device} (see init_gom / load_trained)")

    def dev(x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=device)

    K, E, cnl_gtfms, dst_Rs, dst_Ts, dst_posevec, global_R, global_T = map(
        dev, (K, E, cnl_gtfms, dst_Rs, dst_Ts, dst_posevec, global_R, global_T)
    )
    verts_obs = posed_vertices(
        params, statics, cfg, cnl_gtfms, dst_Rs, dst_Ts, dst_posevec, i_iter, global_R, global_T
    )
    if train:
        return render_frame_train(params, statics, cfg, verts_obs, K, E)
    colors = M.appearance_apply(params["appearance"])
    return render_frame_eval(params, statics, cfg, verts_obs, colors, K, E)


def eval_forward(params: dict, statics: GoMStatics, cfg: GoMConfig, K, E, cnl_gtfms, dst_Rs, dst_Ts,
                 dst_posevec=None, i_iter=1e7, global_R=None, global_T=None):
    """``gom_forward(train=False)`` without autograd, positional: the
    function of :func:`eval_program`."""
    with torch.no_grad():
        return gom_forward(params, statics, cfg, K, E, cnl_gtfms, dst_Rs, dst_Ts, dst_posevec=dst_posevec,
                           i_iter=i_iter, global_R=global_R, global_T=global_T, device=params["vertices"].device)


def eval_program():
    """The eval frame as one program per (config, shapes): call it with
    :func:`eval_forward`'s arguments (``i_iter`` a float or a device scalar).
    The counterpart of ``bench.py``'s ``jax.jit(forward)``; on CUDA tensors
    one captured CUDA graph replayed per frame, on CPU tensors the eager
    forward.  Its outputs are overwritten by its next call.  Each call
    counts the frame (``binning.count_frame``) when recording."""
    from gomavatar_tpu_torch.programs import Program

    class EvalProgram(Program):
        def __call__(self, params, statics, cfg, *args):
            count_frame(cfg.img_size)
            return super().__call__(params, statics, cfg, *args)

    return EvalProgram(eval_forward)


def _splat_export(params: dict, statics: GoMStatics, cfg: GoMConfig, verts: torch.Tensor) -> dict:
    faces = statics.faces
    return {
        "xyz": gather_rows(verts, faces).mean(dim=1),
        "vertices": verts,
        "opacity": torch.ones((cfg.num_faces,), dtype=torch.float32, device=verts.device),
        "colors": M.appearance_apply(params["appearance"]),
        "cov": face_covariances(verts, faces, params["so3"], params["scale"], cfg.sigma),
    }


def export_canonical_pointcloud(params: dict, statics: GoMStatics, cfg: GoMConfig) -> dict:
    """The splats in canonical space, for external 3DGS viewers: per-face
    centroids ``xyz``, the mesh ``vertices``, ``opacity`` (all 1),
    ``colors`` and covariances ``cov``."""
    return _splat_export(params, statics, cfg, params["vertices"])


def export_warped_pointcloud(
    params: dict,
    statics: GoMStatics,
    cfg: GoMConfig,
    cnl_gtfms: torch.Tensor,
    dst_Rs: torch.Tensor,
    dst_Ts: torch.Tensor,
    dst_posevec: torch.Tensor | None = None,
    i_iter=1e7,
) -> dict:
    """The splats in observation space for one pose, with the keys of
    :func:`export_canonical_pointcloud`.  The pose-refinement and non-rigid
    modules take part only with a ``dst_posevec``, each from its kick-in
    iteration."""
    if dst_posevec is None:
        cfg = dataclasses.replace(cfg, pose_refinement=None, non_rigid=None)
    verts_obs = posed_vertices(params, statics, cfg, cnl_gtfms, dst_Rs, dst_Ts, dst_posevec, i_iter)
    return _splat_export(params, statics, cfg, verts_obs)


def subdivide_gom(params: dict, statics: GoMStatics, cfg: GoMConfig):
    """1->4 midpoint subdivision of the whole model state (host side):
    vertices and lbs weights by midpoint, per-face so3/scale/appearance
    replicated x4, tile budgets rescaled for the new face count.  Returns
    new (params, statics, cfg)."""
    device = params["vertices"].device
    verts = params["vertices"].detach().cpu().double().numpy()
    faces = statics.faces.cpu().numpy()
    lbs_attr = _lbs_weights(params, statics, cfg).detach().cpu().double().numpy()

    new_verts, new_faces, attrs, _ = subdivide_mesh(verts, faces, {"weights": lbs_attr})
    new_lbs = attrs["weights"].astype(np.float32)
    N2, F2 = len(new_verts), len(new_faces)

    def rep(t):
        return torch.as_tensor(
            replicate_face_attribute(t.detach().cpu().numpy()), dtype=torch.float32, device=device
        )

    new_params = dict(params)
    new_params["vertices"] = torch.as_tensor(new_verts, dtype=torch.float32, device=device)
    new_params["so3"] = rep(params["so3"])
    new_params["scale"] = rep(params["scale"])
    new_params["appearance"] = {"colors": rep(params["appearance"]["colors"])}
    if cfg.lbs_refine:
        new_params["lbs_logits"] = torch.log(torch.as_tensor(new_lbs, device=device) + 1e-9)

    new_statics = _build_statics(new_faces, new_verts, new_lbs, device)
    # Rescale the tile budgets by the ratio of budget factors; the per-
    # gaussian budget keeps its floor at the frame's size, which wins over
    # any custom value below it (sub-floor budgets drop trained splat
    # coverage at every phase).
    bf_old = tile_budget_factor(cfg.num_faces)
    bf_new = tile_budget_factor(F2)
    new_cfg = dataclasses.replace(
        cfg,
        num_vertices=N2,
        num_faces=F2,
        max_tiles_per_gaussian=max(frame_tile_budget(_MTG_FLOOR, cfg.img_size),
                                   cfg.max_tiles_per_gaussian * bf_new // bf_old),
        max_tiles_per_face=max(1, cfg.max_tiles_per_face * bf_new // bf_old),
        buffer_factor=max(1, cfg.buffer_factor * bf_new // bf_old),
        binning_band0=(
            None if cfg.binning_band0 is None else max(1, cfg.binning_band0 * bf_new // bf_old)
        ),
        binning_band0_train=(
            None if cfg.binning_band0_train is None else max(1, cfg.binning_band0_train * bf_new // bf_old)
        ),
    )
    return new_params, new_statics, new_cfg

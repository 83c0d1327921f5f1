"""Model modules: appearance, pose refinement, non-rigid offset, shadow
(port of gomavatar_tpu/models/modules.py).

Init/apply pairs over plain dicts of tensors; kick-in gating happens in the
caller (models/gom.py).
"""

from __future__ import annotations

import torch

from gomavatar_tpu_torch.nn import mlp_apply, mlp_init
from gomavatar_tpu_torch.ops.embedding import (
    annealed_positional_encoding,
    embed_dim,
    positional_encoding,
)
from gomavatar_tpu_torch.ops.transforms import so3_exp


# -- appearance --------------------------------------------------------------

def appearance_init(num_faces: int, color_init: float = 0.5, device="cuda"):
    """Per-face color table, every entry ``color_init``."""
    return {"colors": torch.full((num_faces, 3), color_init, dtype=torch.float32, device=device)}


def appearance_apply(params):
    return params["colors"]


# -- pose refinement ----------------------------------------------------------

def pose_refinement_init(key, cfg, device="cuda"):
    total = cfg["total_bones"] if cfg.get("refine_root", False) else cfg["total_bones"] - 1
    return mlp_init(
        key,
        d_in=cfg["embedding_size"],
        width=cfg["mlp_width"],
        depth=cfg["mlp_depth"],
        d_out=3 * total,
        last_init_scale=1e-5,
        device=device,
    )


def pose_refinement_apply(params, posevec, total_bones: int = 24, refine_root: bool = False):
    """posevec (69,) -> delta rotations (J, 3, 3), identity for the root
    unless ``refine_root``."""
    Rs = so3_exp(mlp_apply(params, posevec).reshape(-1, 3))
    if not refine_root:
        eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)[None]
        Rs = torch.cat([eye, Rs], dim=0)
    return Rs


# -- non-rigid offsets --------------------------------------------------------

def non_rigid_embed_dim(cfg) -> int:
    return embed_dim(cfg["multires"], include_input=False)


def non_rigid_init(key, cfg, device="cuda"):
    pe = non_rigid_embed_dim(cfg)
    return mlp_init(
        key,
        d_in=pe + cfg["condition_code_size"],
        width=cfg["mlp_width"],
        depth=cfg["mlp_depth"],
        d_out=3,
        skips=tuple(cfg["skips"]),
        skip_dim=pe,
        last_init_scale=cfg.get("init_scale", 1e-5),
        device=device,
    )


def non_rigid_apply(params, cfg, xyz, posevec, i_iter):
    """xyz (N, 3), posevec (69,) -> offset vertices (N, 3); the MLP input is
    [posevec, annealed encoding] and skip layers re-concat the encoding."""
    pe = annealed_positional_encoding(
        xyz,
        cfg["multires"],
        i_iter,
        kick_in_iter=cfg["kick_in_iter"],
        full_band_iter=cfg["full_band_iter"],
    )
    N = xyz.shape[0]
    cond = posevec[None, :].expand(N, posevec.shape[0])
    h = torch.cat([cond, pe], dim=-1)
    offset = mlp_apply(params, h, skips=tuple(cfg["skips"]), skip_input=pe)
    return xyz + offset[:, :3]


# -- shadow -------------------------------------------------------------------

def shadow_embed_dim(cfg) -> int:
    return embed_dim(cfg["multires"], include_input=True)


def _shadow_skips(cfg) -> tuple[int, ...]:
    return tuple(s for s in cfg["skips"] if s < cfg["mlp_depth"])


def shadow_init(key, cfg, device="cuda"):
    pe = shadow_embed_dim(cfg)
    return mlp_init(
        key,
        d_in=pe,
        width=cfg["mlp_width"],
        depth=cfg["mlp_depth"],
        d_out=1,
        skips=_shadow_skips(cfg),
        skip_dim=pe,
        last_init_scale=cfg.get("init_scale", 1e-5),
        device=device,
    )


def _to_bf16(tree):
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_bf16(v) for v in tree]
    return tree.to(torch.bfloat16)


def shadow_apply(params, cfg, normals):
    """normals (..., 3) -> sigmoid shading (..., 1); the caller applies the
    x2 identity-at-init scale.  Runs in bfloat16 like the reference (its
    encoding is computed in float32, the MLP in bfloat16, the sigmoid in
    float32), so both sides round at the same places."""
    pe = positional_encoding(normals, cfg["multires"], include_input=True).to(torch.bfloat16)
    out = mlp_apply(_to_bf16(params), pe, skips=_shadow_skips(cfg), skip_input=pe)
    return torch.sigmoid(out.float())

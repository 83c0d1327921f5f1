"""Shared inputs of the tests that hold gomavatar_tpu_torch to gomavatar_tpu.

The gate scene of both packages: the synthetic body at rings (16, 18), 64^2,
the trained avatar's model config, and the bench gate's camera and pose.  The
per-face so3/scale/colors are drawn with numpy from a seed and the MLP
weights are the trained avatar's, so every module runs at full strength;
the same arrays go to both sides (JAX params carried across with
``params_from_jax``).  The JAX reference of the eval forward is composed by
hand (steps 1-3 of ``gom_forward``, then ``render_frame_eval`` with the
Pallas kernel in interpret mode), because ``gom_forward`` never takes the
fused path on the CPU.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gomavatar_tpu.models import modules as JM
from gomavatar_tpu.models.gom import init_gom as jax_init_gom
from gomavatar_tpu.models.gom import render_frame_eval as jax_render_frame_eval
from gomavatar_tpu.models.smpl import synthetic_body, synthetic_camera
from gomavatar_tpu.ops import skeleton as JS
from gomavatar_tpu.ops.transforms import mm as jax_mm
from gomavatar_tpu_torch.convert import TRAINED, params_from_jax, unflatten_params
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.scene import gate_model_cfg

IMG = (64, 64)
RINGS = (16, 18)
MLPS = ("pose_refinement", "non_rigid", "shadow")

# criteria of the JAX package's fused/unfused gate (bench.py): more than
# 99.95 % of values within 1e-4 and the worst under 5e-3 (reassociation near
# the T < 1e-4 termination can flip one entry on isolated pixels)
CLOSE_TOL, CLOSE_FRAC, WORST_MAX = 1e-4, 0.9995, 5e-3


# frame_geometry table tolerances, per channel, of the JAX package's own
# geometry check (tests/test_frame_render.py:90-138)
# (channels, atol, rtol)
CHANNEL_TOL = [
    ((0, 1), 1e-3, 1e-5),  # splat mean
    ((2, 3, 4), 1e-5, 1e-4),  # conic
    ((5,), 0, 0),  # opacity = splat valid
    ((6, 7, 8), 0, 0),  # colors pass through
    ((9, 10, 11, 12), 1e-5, 1e-4),  # barycentric plane slopes
    ((13, 14), 1e-3, 1e-5),  # anchor vertex
    ((15, 16), 1e-4, 1e-3),  # depth plane slopes
    ((17,), 1e-5, 1e-6),  # anchor depth
    ((18,), 0, 0),  # mesh valid
    ((19, 20, 21), 1e-5, 0),  # summed camera-space normal
    ((22, 23), 0, 0),  # zeros
]


def assert_close_frac(a, b, label=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    d = np.abs(a - b)
    frac = float((d <= CLOSE_TOL).mean())
    assert frac > CLOSE_FRAC and float(d.max()) < WORST_MAX, (
        f"{label}: {(1 - frac):.2e} of values off by > {CLOSE_TOL}, worst {d.max():.3g}"
    )


def trained_mlps() -> dict:
    """The trained avatar's MLP weights as numpy pytrees."""
    with np.load(TRAINED) as npz:
        params = unflatten_params(npz)
    return {k: params[k] for k in MLPS}


def gate_frame_np(info) -> dict:
    K, E = synthetic_camera(IMG, distance=2.4, focal=1.15 * IMG[1])
    joints = jnp.asarray(info["canonical_joints"])
    pose = np.zeros(72, np.float32)
    pose[12] = 0.3
    Rs, Ts = JS.body_pose_to_body_RTs(jnp.asarray(pose), joints)
    frame = {
        "K": K, "E": E,
        "cnl_gtfms": JS.get_canonical_global_tfms(joints),
        "dst_Rs": Rs, "dst_Ts": Ts,
        "dst_posevec": pose[3:] + 1e-2,
    }
    return {k: np.array(v, np.float32) for k, v in frame.items()}


def jax_gate_scene(seed: int = 0):
    """(params, statics, cfg, frame_np, info) of the JAX gate scene."""
    info = synthetic_body(n_rings=RINGS[0], n_seg=RINGS[1])
    params, statics, cfg = jax_init_gom(jax.random.PRNGKey(seed), gate_model_cfg(IMG), info)
    rng = np.random.default_rng(seed)
    F = cfg.num_faces
    params["so3"] = jnp.asarray(0.2 * rng.standard_normal((F, 3)), jnp.float32)
    params["scale"] = jnp.asarray(1.0 + 0.2 * rng.standard_normal((F, 3)), jnp.float32)
    params["appearance"] = {"colors": jnp.asarray(rng.uniform(0.05, 0.95, (F, 3)), jnp.float32)}
    for k, v in trained_mlps().items():
        params[k] = jax.tree_util.tree_map(jnp.asarray, v)
    return params, statics, cfg, gate_frame_np(info), info


def torch_scene_from(jax_scene):
    """The port's side of a JAX gate scene, on the CPU: params carried across,
    statics and config built by the port from the same mesh."""
    jp, _, _, frame_np, info = jax_scene
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    _, statics, cfg = TG.init_gom(gate_model_cfg(IMG), info, device="cpu")
    frame = {k: torch.as_tensor(v) for k, v in frame_np.items()}
    return params, statics, cfg, frame


def jax_verts_obs(params, statics, cfg, frame_np, i_iter=1e7):
    """Steps 1-3 of gomavatar_tpu's gom_forward: pose refinement, non-rigid
    offsets, FK + LBS."""
    f = {k: jnp.asarray(v) for k, v in frame_np.items()}
    i_iter = jnp.float32(i_iter)
    dst_Rs = f["dst_Rs"]
    pr = cfg.module_cfg("pose_refinement")
    delta = JM.pose_refinement_apply(
        params["pose_refinement"], f["dst_posevec"],
        total_bones=pr["total_bones"], refine_root=pr["refine_root"],
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=delta.dtype), delta.shape)
    dst_Rs = jax_mm(dst_Rs, jnp.where(i_iter >= pr["kick_in_iter"], delta, eye))
    nr = cfg.module_cfg("non_rigid")
    verts = params["vertices"]
    verts_nr = JM.non_rigid_apply(params["non_rigid"], nr, verts, f["dst_posevec"], i_iter)
    verts = jnp.where(i_iter >= nr["kick_in_iter"], verts_nr, verts)
    gR, gT = JS.get_global_RTs(f["cnl_gtfms"], dst_Rs, f["dst_Ts"], use_smplx=cfg.use_smplx)
    return JS.apply_lbs(verts, gR, gT, statics.lbs_weights)


def jax_forward(params, statics, cfg, frame_np, with_normal=False):
    """The JAX package's eval forward on the CPU, kernel B1 in interpret mode."""
    verts_obs = jax_verts_obs(params, statics, cfg, frame_np)
    return jax_render_frame_eval(
        params, statics, cfg, verts_obs, params["appearance"]["colors"],
        jnp.asarray(frame_np["K"]), jnp.asarray(frame_np["E"]),
        with_normal=with_normal, interpret=True,
    )


def assert_bins_identical(j, t):
    """Two SortedBinnings (JAX, port) hold identical integers: every real
    segment of order and its pass flags, the slot arrays and telemetry."""
    for field in ("active_id", "seg_start", "seg_count", "pos_of_tile", "n_active"):
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)), err_msg=field)
    assert (t.num_tiles_x, t.num_tiles_y) == (j.num_tiles_x, j.num_tiles_y)
    assert t.order.shape == j.order.shape
    for field in j.telemetry._fields:
        assert int(getattr(t.telemetry, field)) == int(getattr(j.telemetry, field)), field
    st, ct = np.asarray(j.seg_start), np.asarray(j.seg_count)
    n = min(int(j.n_active), st.shape[0])
    assert n > 0
    for name in ("order", "entry_splat", "entry_mesh"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        for p in range(n):
            s, c = st[p], ct[p]
            np.testing.assert_array_equal(a[s : s + c], b[s : s + c], err_msg=f"{name} slot {p}")


def tree_leaves_by_path(tree, prefix=""):
    """(path, leaf) pairs of nested dicts and lists, dict keys sorted, list
    positions as path segments: the same tree of JAX arrays, numpy arrays or
    tensors gives the same paths."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_by_path(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_by_path(v, f"{prefix}/{i}")
    else:
        yield prefix, tree

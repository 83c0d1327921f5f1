"""The train step of gomavatar_tpu_torch against gomavatar_tpu's Trainer on the
CPU: the same 48^2 body, config and params go through three optimizer steps
of both; the per-step loss terms and the step-1 gradient of every parameter
leaf must agree.  Every module of the train step is on: pose refinement and
non-rigid offsets from iteration 0, the shadow MLP, the soft silhouette and
all seven loss terms (LPIPS on the random trunk each package draws from
one seed).

The step-1 gradients are read from Adam's first moments after step 1: both
optimizers start from zero moments, so mu = (1 - 0.9) * gradient exactly.

LPIPS runs its convolutions in float32 on both sides here: XLA's and
torch's bfloat16 convolutions round differently, which moves the LPIPS
gradient by up to ~10 % of its largest value
(test_torch_losses.py holds the bfloat16 LPIPS to JAX's at its own
tolerance).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu import losses as JLosses
from gomavatar_tpu.config import default_cfg as jax_default_cfg
from gomavatar_tpu.models import lpips as JL
from gomavatar_tpu.models.smpl import synthetic_body, synthetic_camera
from gomavatar_tpu.ops.skeleton import body_pose_to_body_RTs, get_canonical_global_tfms
from gomavatar_tpu.trainer import Trainer as JaxTrainer
from gomavatar_tpu_torch import losses as TLosses
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import params_from_jax
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.models import lpips as TLpips
from gomavatar_tpu_torch.models.lpips import HEADS_PATH
from gomavatar_tpu_torch.optim import tree_leaves
from gomavatar_tpu_torch.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401

IMG = (48, 48)
STEPS = 3
# Loss terms: each within rtol 1e-5 at step 0.  Later steps start from
# params that differ by float roundings, which Adam's first updates
# (lr * g / |g|) turn into steps of up to 2 lr where a gradient element is
# near 0: rtol 1e-3 there.
LOSS_RTOL_STEP0, LOSS_RTOL = 1e-5, 1e-3
# Step-1 gradients, per leaf: within 1e-3 of the leaf's largest |gradient|
# (the plain kernel versions sum over their entries in another order than
# the reference's jnp paths).  The shadow MLP runs in bfloat16 (as in the
# reference), and its bias gradients, sums of cancelling per-pixel terms,
# are held within 5e-2 of the leaf's largest value.
GRAD_ATOL_REL, SHADOW_ATOL_REL = 1e-3, 5e-2


def _configure(cfg, subdivide_at=None):
    """The small trainer config of tests/test_trainer.py with every module
    of the train step switched on from iteration 0."""
    cfg["img_size"] = list(IMG)
    m = cfg["model"]
    m["img_size"] = list(IMG)
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["pose_refinement"]["name"] = "basic"
    m["pose_refinement"]["kick_in_iter"] = 0
    m["non_rigid"]["name"] = "basic"
    m["non_rigid"]["kick_in_iter"] = 0
    m["non_rigid"]["full_band_iter"] = 10
    if subdivide_at is not None:
        m["subdivide_iters"] = [subdivide_at]
    t = cfg["train"]
    t["lr_decay_steps"] = 4
    t["losses"]["laplacian"]["coeff_observation"] = 10.0
    t["losses"]["normal"]["coeff_mask"] = 1.0
    t["losses"]["normal"]["mask_dilate"] = True
    t["losses"]["normal"]["coeff_consist"] = 0.1
    t["losses"]["color_consist"]["coeff"] = 0.05
    return cfg


def _batch_np(info):
    """The frame of tests/test_trainer.py: camera at distance 3, rest pose,
    a red box target on black."""
    K, E = synthetic_camera(IMG, distance=3.0, focal=45.0)
    joints = jnp.asarray(info["canonical_joints"])
    Rs, Ts = body_pose_to_body_RTs(jnp.zeros(72, jnp.float32), joints)
    H, W = IMG[1], IMG[0]
    target = np.zeros((H, W, 3), np.float32)
    target[12:36, 18:30] = [0.8, 0.2, 0.2]
    tmask = np.zeros((H, W), np.float32)
    tmask[12:36, 18:30] = 1.0
    batch = {
        "K": K, "E": E, "cnl_gtfms": get_canonical_global_tfms(joints), "dst_Rs": Rs, "dst_Ts": Ts,
        "dst_posevec": np.full(69, 1e-2, np.float32), "bgcolor": np.zeros(3, np.float32),
        "target_rgbs": target, "target_masks": tmask,
    }
    return {k: np.array(v, np.float32) for k, v in batch.items()}


@pytest.fixture(scope="module")
def info():
    return synthetic_body(n_rings=10, n_seg=8)


def _lpips_f32(lpips_fn):
    return lambda params, pred, gt: lpips_fn(params, pred, gt, bf16=False)


@pytest.fixture(scope="module")
def trajectories(info):
    """(JAX losses per step, JAX step-1 mu, port losses per step, port
    step-1 mu, port trainer) over STEPS steps from the same params: the
    initial params with the per-face so3, scale and colors drawn from a
    seed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLosses, "lpips_fn", _lpips_f32(JL.lpips))
        mp.setattr(TLosses, "lpips_fn", _lpips_f32(TLpips.lpips))
        return _run_both(info)


def _run_both(info):
    with np.load(HEADS_PATH) as z:
        heads = [z[f"head_{i}"] for i in range(5)]
    j_lpips, _ = JL.init_lpips(heads=heads)
    jtr = JaxTrainer(_configure(jax_default_cfg()), info, lpips_params=j_lpips, seed=0)
    rng = np.random.default_rng(0)
    F = jtr.gom_cfg.num_faces
    jtr.params["so3"] = jnp.asarray(0.2 * rng.standard_normal((F, 3)), jnp.float32)
    jtr.params["scale"] = jnp.asarray(1.0 + 0.2 * rng.standard_normal((F, 3)), jnp.float32)
    jtr.params["appearance"] = {"colors": jnp.asarray(rng.uniform(0.05, 0.95, (F, 3)), jnp.float32)}
    cfg = _configure(default_cfg())
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params), device="cpu")
    _, statics, gom_cfg = TG.init_gom(cfg["model"], info, device="cpu")
    ttr = Trainer(cfg, lpips_params=TLpips.init_lpips(heads=heads, device="cpu")[0], device="cpu",
                  state=(params, statics, gom_cfg, 0, 0))

    batch = _batch_np(info)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    t_batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    j_losses, t_losses = [], []
    for step in range(STEPS):
        jt, jl = jtr.step(j_batch)
        tt, tl = ttr.step(t_batch)
        j_losses.append({"total": float(jt), **{k: float(v) for k, v in jl.items()}})
        t_losses.append({"total": float(tt), **{k: float(v) for k, v in tl.items()}})
        if step == 0:
            j_mu = [np.asarray(a) for a in jax.tree_util.tree_leaves(jtr.opt_state[0].mu)]
            t_mu = [m.numpy().copy() for m in ttr.opt_state.mu]
    return j_losses, j_mu, t_losses, t_mu, ttr


def test_loss_terms_match_jax_trainer(trajectories):
    j_losses, _, t_losses, _, _ = trajectories
    # the port's telemetry adds the most tiles one splat covered
    assert set(j_losses[0]) == set(t_losses[0]) - {"bin_most_tiles"}
    assert all(t["bin_most_tiles"] > 0 for t in t_losses)
    assert {"rgb", "mask", "lpips", "laplacian_observation", "normal_mask", "normal_consist",
            "color_consist"} <= set(t_losses[0])
    for step, (j, t) in enumerate(zip(j_losses, t_losses)):
        for k in j:
            if k.startswith("bin_drop"):
                assert t[k] == j[k] == 0, (step, k)
            else:
                assert np.isfinite(t[k]), (step, k)
                rtol = LOSS_RTOL_STEP0 if step == 0 else LOSS_RTOL
                np.testing.assert_allclose(t[k], j[k], rtol=rtol, err_msg=f"step {step} {k}")
    assert t_losses[-1]["total"] < t_losses[0]["total"]


def test_step1_gradients_match_jax_trainer(trajectories):
    _, j_mu, _, t_mu, ttr = trajectories
    names = [k for k in sorted(ttr.params) for _ in tree_leaves(ttr.params[k])]
    assert len(j_mu) == len(t_mu) == len(names)
    for name, a, b in zip(names, t_mu, j_mu):
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        scale = float(np.abs(b).max())
        assert scale > 0, name  # every leaf gets a gradient
        rel = SHADOW_ATOL_REL if name == "shadow" else GRAD_ATOL_REL
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=name)


def test_phase_change_subdivides_and_keeps_the_schedule(info):
    cfg = _configure(default_cfg(), subdivide_at=2)
    cfg["train"]["losses"]["lpips"]["coeff"] = 0.0
    tr = Trainer(cfg, info, device="cpu", seed=0)
    batch = {k: torch.as_tensor(v) for k, v in _batch_np(info).items()}
    f0 = tr.gom_cfg.num_faces
    for _ in range(STEPS):
        total, _ = tr.step(batch)
    assert tr.phase == 1 and tr.gom_cfg.num_faces == 4 * f0
    assert tr.params["so3"].shape[0] == 4 * f0 and tr.statics.faces.shape[0] == 4 * f0
    # the rebuilt optimizer's schedule continues from the global iteration,
    # while Adam's own count restarts with the new moments
    assert tr.opt_state.schedule_count == STEPS and tr.opt_state.count == STEPS - 2
    assert np.isfinite(float(total))


def test_debug_binning_fails_on_a_dropped_entry(info, monkeypatch):
    """GOMAVATAR_DEBUG_BINNING (the opt-in sync): a step whose binning
    dropped an entry raises; one that dropped none goes on."""
    from gomavatar_tpu_torch import trainer as T

    cfg = _configure(default_cfg())
    cfg["train"]["losses"]["lpips"]["coeff"] = 0.0
    tr = Trainer(cfg, info, device="cpu", seed=0)
    batch = {k: torch.as_tensor(v) for k, v in _batch_np(info).items()}
    monkeypatch.setattr(T, "_DEBUG_BINNING", True)
    tr.step(batch)
    real = tr._step_fn

    def dropping(*args):
        params, opt_state, total, losses = real(*args)
        return params, opt_state, total, dict(losses, bin_drop_buffer=torch.tensor(3))

    tr._step_fn = dropping
    with pytest.raises(RuntimeError, match="binning dropped 3 entries at iter 1"):
        tr.step(batch)

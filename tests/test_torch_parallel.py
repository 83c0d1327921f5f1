"""gomavatar_tpu_torch.parallel on the CPU: ranks in processes of their own
(``parallel.spawn``) over gloo, one torch thread each, against JAX's
``parallel`` on a CPU device mesh and against the port's own one-process
versions.

* The data-parallel step on 2 ranks (tests/test_parallel.py's 48^2 body,
  LPIPS off, per-face so3, scale and colors from a numpy seed): its loss
  terms and Adam's first moments after one step against JAX's
  ``make_data_parallel_train_step`` on 2 devices, at the tolerances of
  tests/test_torch_trainer.py; its params bit for bit against the
  one-process mean-gradient step (``make_mean_gradient_step``) over 2
  steps, both replicas bit-equal; a subdivision under 2 ranks; world 1
  bit-equal to ``Trainer.step``.  JAX's own test
  (tests/test_parallel.py:57) checks only that its step is finite and
  moves the params.
* The multi-scene render: 2 scenes on 2 ranks against JAX's
  ``make_multi_scene_render`` under the eval gate, and 4 scenes on 2 ranks
  bit-equal to the port's scene loop, every scene of each rank's block in
  order (JAX's renders only the first of each block).
The driver's data-parallel run is tested in test_torch_cli_parallel.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gomavatar_tpu.cli import animate as jax_animate
from gomavatar_tpu.config import default_cfg as jax_default_cfg
from gomavatar_tpu.models.gom import init_gom as jax_init_gom
from gomavatar_tpu.models.smpl import synthetic_body
from gomavatar_tpu.optim import make_optimizer as jax_make_optimizer
from gomavatar_tpu.parallel import make_data_parallel_train_step as jax_dp_step
from gomavatar_tpu.parallel import make_mesh, stack_batches
from gomavatar_tpu.parallel import make_multi_scene_render as jax_multi_scene_render
from gomavatar_tpu.parallel.mesh import SCENE_AXIS
from gomavatar_tpu_torch.cli import animate as anim_cli
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.optim import make_optimizer, tree_leaves
from gomavatar_tpu_torch.parallel import make_mean_gradient_step, spawn
from gomavatar_tpu_torch.trainer import Trainer
from tests.test_parallel import make_item
from torch_parallel_ranks import IMG, dp_cfg, multi_scene_run, numpy_leaves, tensors, trainer_run, trainer_runs
from torch_port_scene import assert_close_frac
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 2
# tests/test_torch_trainer.py's tolerances: loss terms at step 0 within rtol
# 1e-5; step-1 gradients within 1e-3 of each leaf's largest |value|, the
# shadow MLP's (bfloat16) within 5e-2
LOSS_RTOL, GRAD_ATOL_REL, SHADOW_ATOL_REL = 1e-5, 1e-3, 5e-2


@pytest.fixture(scope="module")
def info():
    return synthetic_body(n_rings=10, n_seg=8)


def _jax_params(cfg, info):
    """JAX's init at seed 0 with per-face so3, scale and colors from numpy
    seed 0 (a fresh model's are constant, and the so3 gradient at 0 is
    rounding noise)."""
    params, statics, gom_cfg = jax_init_gom(jax.random.PRNGKey(0), cfg["model"], info)
    rng = np.random.default_rng(0)
    F = gom_cfg.num_faces
    params["so3"] = jnp.asarray(0.2 * rng.standard_normal((F, 3)), jnp.float32)
    params["scale"] = jnp.asarray(1.0 + 0.2 * rng.standard_normal((F, 3)), jnp.float32)
    params["appearance"] = {"colors": jnp.asarray(rng.uniform(0.05, 0.95, (F, 3)), jnp.float32)}
    return params, statics, gom_cfg


def _frames(info, steps, world):
    """frames[s][r]: tests/test_parallel.py's item of seed s * world + r."""
    return [[make_item(info, s * world + r) for r in range(world)] for s in range(steps)]


def _mean_gradient_run(params_np, info, frames, subdivide_at=None):
    """The one-process reference: (params leaves after each step, losses per
    step) of ``make_mean_gradient_step`` over each step's frames."""
    cfg = dp_cfg(default_cfg(), subdivide_at)
    _, statics, gom_cfg = TG.init_gom(cfg["model"], info, device="cpu")
    from gomavatar_tpu_torch.convert import params_from_jax

    params = params_from_jax(params_np, device="cpu")
    tx = make_optimizer(cfg["train"], params)
    opt_state = tx.init(params)
    step = make_mean_gradient_step(gom_cfg, cfg["train"]["losses"], tx)
    out_params, out_losses = [], []
    for s, per_rank in enumerate(frames):
        params, opt_state, total, losses = step(params, opt_state, statics, None,
                                                [tensors(f, "cpu") for f in per_rank], float(s))
        out_params.append(numpy_leaves(params))
        out_losses.append({"total": float(total), **{k: float(v) for k, v in losses.items()}})
    return out_params, out_losses


@pytest.fixture(scope="module")
def dp_runs(info):
    """JAX's data-parallel step on 2 devices (one step), the port's on 2
    ranks (STEPS steps, and 2 steps subdividing at step 1) and on 1 rank,
    and the one-process references."""
    cfg = dp_cfg(jax_default_cfg())
    jp, js, jcfg = _jax_params(cfg, info)
    params_np = jax.tree_util.tree_map(np.asarray, jp)
    frames = _frames(info, STEPS, 2)

    tx = jax_make_optimizer(cfg["train"], jp)
    step = jax_dp_step(make_mesh(2), jcfg, cfg["train"]["losses"], tx)
    _, j_opt, j_total, j_losses = step(jp, tx.init(jp), js, None, stack_batches(frames[0]), jnp.float32(0.0))
    jax_out = {"losses": {"total": float(j_total), **{k: float(v) for k, v in j_losses.items()}},
               "mu": [np.asarray(a) for a in jax.tree_util.tree_leaves(j_opt[0].mu)]}

    (two, sub), (two1, sub1) = spawn(trainer_runs, ["cpu", "cpu"], params_np, info, frames, (None, 1))
    one = spawn(trainer_run, ["cpu"], params_np, info, [f[:1] for f in frames])
    return {"params_np": params_np, "frames": frames, "jax": jax_out, "two": [two, two1], "sub": [sub, sub1],
            "one": one}


def test_data_parallel_step_matches_jax(dp_runs):
    j, t = dp_runs["jax"], dp_runs["two"][0]
    # JAX's data-parallel step returns no binning telemetry; the port's
    # (its trainer's) must show no drop, and some splat covering tiles
    extra = set(t["losses"][0]) - set(j["losses"])
    drops = {"bin_drop_budget", "bin_drop_buffer", "bin_drop_ncmax"}
    assert extra == drops | {"bin_most_tiles"}
    assert all(t["losses"][0][k] == 0 for k in drops)
    assert t["losses"][0]["bin_most_tiles"] > 0
    assert {"total", "rgb", "mask"} <= set(j["losses"])
    for k, want in j["losses"].items():
        np.testing.assert_allclose(t["losses"][0][k], want, rtol=LOSS_RTOL, err_msg=k)
    names = [k for k in sorted(dp_runs["params_np"]) for _ in tree_leaves(dp_runs["params_np"][k])]
    assert len(names) == len(t["mu"]) == len(j["mu"])
    for name, a, b in zip(names, t["mu"], j["mu"]):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        scale = float(np.abs(b).max())
        assert scale > 0, name
        rel = SHADOW_ATOL_REL if name == "shadow" else GRAD_ATOL_REL
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=name)


def test_data_parallel_step_is_the_mean_gradient_step(info, dp_runs):
    r0, r1 = dp_runs["two"]
    ref_params, ref_losses = _mean_gradient_run(dp_runs["params_np"], info, dp_runs["frames"])
    for s in range(STEPS):
        for a, b, c in zip(r0["params"][s], r1["params"][s], ref_params[s]):
            assert np.array_equal(a, b), f"step {s}: the replicas differ"
            assert np.array_equal(a, c), f"step {s}: the ranks' step differs from the mean-gradient step"
        assert r0["losses"][s] == r1["losses"][s] == ref_losses[s]
    before = tree_leaves(dp_runs["params_np"])
    assert all(not np.array_equal(a, b) for a, b in zip(r0["params"][-1], before))


def test_subdivision_under_two_ranks(dp_runs, info):
    r0, r1 = dp_runs["sub"]
    faces0 = TG.init_gom(dp_cfg(default_cfg())["model"], info, device="cpu")[2].num_faces
    assert (r0["phase"], r0["faces"]) == (r1["phase"], r1["faces"]) == (1, 4 * faces0)
    assert any(a.shape == (4 * faces0, 3) for a in r0["params"][-1])
    for a, b in zip(r0["params"][-1], r1["params"][-1]):
        assert np.array_equal(a, b)
    assert np.isfinite(r0["losses"][-1]["total"])


def test_world_one_is_the_trainer_step(dp_runs, info):
    (one,) = dp_runs["one"]
    cfg = dp_cfg(default_cfg())
    _, statics, gom_cfg = TG.init_gom(cfg["model"], info, device="cpu")
    from gomavatar_tpu_torch.convert import params_from_jax

    tr = Trainer(cfg, device="cpu", state=(params_from_jax(dp_runs["params_np"], "cpu"), statics, gom_cfg, 0, 0))
    for s, per_rank in enumerate(dp_runs["frames"]):
        total, losses = tr.step(tensors(per_rank[0], "cpu"))
        for a, b in zip(one["params"][s], numpy_leaves(tr.params)):
            assert np.array_equal(a, b), f"step {s}"
        assert one["losses"][s] == {"total": float(total), **{k: float(v) for k, v in losses.items()}}


# ---- the multi-scene render --------------------------------------------------

def _synthetic_model_cfg(img):
    cfg = default_cfg()
    m = cfg["model"]
    m["img_size"] = list(img)
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    return m


def _jax_scenes(n, img):
    """JAX's animate scenes, per-face so3, scale and colors from numpy seed
    s for scene s: (JAX packs, infos, numpy params)."""
    j_packs, infos = jax_animate._synthetic_scenes(n, img)
    for s, (jp, _, jcfg) in enumerate(j_packs):
        rng = np.random.default_rng(s)
        F = jcfg.num_faces
        jp["so3"] = jnp.asarray(0.2 * rng.standard_normal((F, 3)), jnp.float32)
        jp["scale"] = jnp.asarray(1.0 + 0.2 * rng.standard_normal((F, 3)), jnp.float32)
        jp["appearance"] = {"colors": jnp.asarray(rng.uniform(0.05, 0.95, (F, 3)), jnp.float32)}
    return j_packs, infos, [jax.tree_util.tree_map(np.asarray, p[0]) for p in j_packs]


@pytest.fixture(scope="module")
def scenes():
    """4 scenes at 48^2 and the second orbit frame of each; the port's
    multi-scene render of the first 2 and of all 4 on 2 ranks."""
    j_packs, infos, params_np = _jax_scenes(4, IMG)
    items = anim_cli._orbit_items(infos, 0, 4, IMG)[1]
    m = _synthetic_model_cfg(IMG)
    runs = spawn(multi_scene_run, ["cpu", "cpu"], m, list(zip(params_np, infos)), items)
    return j_packs, infos, params_np, items, runs


def test_multi_scene_render_matches_jax(scenes):
    j_packs, _, _, items, runs = scenes
    gom_cfg = jax_animate.check_homogeneous_scenes(j_packs[:2])
    params_s = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[p[0] for p in j_packs[:2]])
    statics_s = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[p[1] for p in j_packs[:2]])
    render = jax_multi_scene_render(make_mesh(2, axis=SCENE_AXIS), gom_cfg)
    want, _ = render(params_s, statics_s, stack_batches(items[:2]), jnp.float32(1e7))
    for s in range(2):
        assert_close_frac(runs[0][0][s], np.asarray(want[s]), f"scene {s}")
        assert float(runs[0][0][s].max()) > 0.05


def test_every_scene_of_every_block_in_order(scenes):
    """4 scenes on 2 ranks (2 per rank): each equals the port's scene loop
    bit for bit, in scene order, on both ranks."""
    _, infos, params_np, items, runs = scenes
    from gomavatar_tpu_torch.convert import params_from_jax

    m = _synthetic_model_cfg(IMG)
    packs = []
    for p, info in zip(params_np, infos):
        _, statics, cfg = TG.init_gom(m, info, device="cpu")
        packs.append((params_from_jax(p, "cpu"), statics, cfg))
    want, want_mask = anim_cli.render_in_turn(len(packs), "cpu")(packs, items)
    (rgb0, mask0), (rgb1, mask1) = runs
    assert rgb0.shape == (4, IMG[1], IMG[0], 3) and mask0.shape == (4, IMG[1], IMG[0])
    assert np.array_equal(rgb0, rgb1) and np.array_equal(mask0, mask1)
    for s in range(4):
        assert np.array_equal(rgb0[s], want[s].numpy()), f"scene {s}"
        assert np.array_equal(mask0[s], want_mask[s].numpy()), f"scene {s}"
    assert all(float(np.abs(rgb0[s] - rgb0[s + 1]).max()) > 1e-3 for s in range(3))

"""The rank programs of gomavatar_tpu_torch (``programs.RankProgram``: the
data-parallel step, the tile-parallel render, and the multi-scene render
through per-scene eval programs) on the CPU, where a program runs its
function eagerly over its buffers and the collective over gloo: ranks in
processes of their own (``parallel.spawn``, one torch thread each), one
rank start per world for every job (tests/torch_parallel_ranks.py).

* The data-parallel step (``Trainer(group=...)``) at world 2 on
  tests/test_parallel.py's 48^2 body: bit-equal to the eager
  ``make_data_parallel_train_step`` on the same ranks and to the one-process
  ``make_mean_gradient_step`` over 2 steps; against JAX's
  ``make_data_parallel_train_step`` on 2 CPU devices at
  tests/test_torch_parallel.py's tolerances; across a subdivision, one
  program per phase; at world 1 bit-equal to ``Trainer.step``.
* The protocol: the outputs are the program's tensors, overwritten by the
  next call; the state is the program's buffers, updated in place; one
  all-reduce per call; one program of the gloo form (two graphs around a
  host collective on a card) captured once per phase.
* ``pre`` and ``post`` of the data-parallel step and of the tile render
  bake no host value and read nothing back (the op-trace check of
  tests/test_torch_programs.py).
* The tile-parallel render's program at worlds 2 and 4 on the 64^2 gate
  scene, two frames in turn: each bit-equal to ``render_frame_eval`` on
  every rank, the outputs the same tensors, one all-gather per frame; at
  world 2 against JAX's ``make_tile_parallel_render`` on
  tests/test_tile_parallel.py's scene and cap at atol 1e-5.
* The multi-scene render, two calls: 4 scenes on 2 ranks bit-equal to the
  one-process scene loop (``parallel.render_in_turn``), one all-gather per
  output per call; the first 2 against JAX's ``make_multi_scene_render``
  under the eval gate.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.cli import animate as jax_animate
from gomavatar_tpu.config import default_cfg as jax_default_cfg
from gomavatar_tpu.models.smpl import synthetic_body
from gomavatar_tpu.optim import make_optimizer as jax_make_optimizer
from gomavatar_tpu.parallel import make_data_parallel_train_step as jax_dp_step
from gomavatar_tpu.parallel import make_mesh, stack_batches
from gomavatar_tpu.parallel import make_multi_scene_render as jax_multi_scene_render
from gomavatar_tpu.parallel import make_tile_parallel_render as jax_tile_parallel_render
from gomavatar_tpu.parallel.mesh import SCENE_AXIS
from gomavatar_tpu.parallel.tile_render import TILE_AXIS
from gomavatar_tpu_torch.cli import animate as anim_cli
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import params_from_jax
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.ops import frame_render as FR
from gomavatar_tpu_torch.optim import tree_leaves
from gomavatar_tpu_torch.parallel import RankGroup, make_data_parallel_program, make_tile_parallel_render
from gomavatar_tpu_torch.parallel import render_in_turn, spawn
from gomavatar_tpu_torch.parallel import tile_render as TR
from gomavatar_tpu_torch.scene import gate_model_cfg
from gomavatar_tpu_torch.trainer import Trainer
from tests.test_frame_render import _scene as jax_test_scene
from tests.test_frame_render import _verts_obs as jax_test_verts_obs
from tests.test_torch_parallel import (
    GRAD_ATOL_REL,
    LOSS_RTOL,
    SHADOW_ATOL_REL,
    STEPS,
    _frames,
    _jax_params,
    _jax_scenes,
    _mean_gradient_run,
    _synthetic_model_cfg,
)
from tests.test_torch_programs import (
    ITERS,
    _batch,
    _perturbed,
    _trainer,
    _unrecorded,
    assert_same_trace,
    kernels_as_single_ops,  # noqa: F401
    trace,
)
from tests.test_torch_tile_parallel import _jax_test_model_cfg
from torch_parallel_ranks import IMG, dp_cfg, numpy_leaves, program_jobs, tensors
from torch_port_scene import IMG as GATE_IMG
from torch_port_scene import assert_close_frac, jax_gate_scene, torch_scene_from
from torch_threads import one_torch_thread  # noqa: F401

CAPS = {2: 16, 4: 20}  # world -> the gate scene's active_tile_cap, as tests/test_torch_tile_parallel.py
CALLS = 2  # calls of each render program


@pytest.fixture(scope="module")
def info():
    return synthetic_body(n_rings=10, n_seg=8)


@pytest.fixture(scope="module")
def dp_inputs(info):
    """JAX's init with per-face so3, scale and colors (as numpy), the frames
    of STEPS steps of 2 ranks, and JAX's data-parallel step on 2 devices
    (one step): its losses and Adam's first moments."""
    cfg = dp_cfg(jax_default_cfg())
    jp, js, jcfg = _jax_params(cfg, info)
    frames = _frames(info, STEPS, 2)
    tx = jax_make_optimizer(cfg["train"], jp)
    step = jax_dp_step(make_mesh(2), jcfg, cfg["train"]["losses"], tx)
    _, j_opt, j_total, j_losses = step(jp, tx.init(jp), js, None, stack_batches(frames[0]), jnp.float32(0.0))
    jax_out = {"losses": {"total": float(j_total), **{k: float(v) for k, v in j_losses.items()}},
               "mu": [np.asarray(a) for a in jax.tree_util.tree_leaves(j_opt[0].mu)]}
    return jax.tree_util.tree_map(np.asarray, jp), frames, jax_out


@pytest.fixture(scope="module")
def gate():
    """The 64^2 gate scene: JAX's, the port's, and a second frame."""
    scene = jax_gate_scene()
    port = torch_scene_from(scene)
    second = {k: v.numpy() for k, v in _perturbed(port[3], 1).items()}
    return scene, port, second


@pytest.fixture(scope="module")
def jax_tile_scene():
    """tests/test_tile_parallel.py's scene (tests/test_frame_render.py:_scene,
    shadow on) at cap 16: (params, statics, cfg, batch, info)."""
    params, statics, cfg, batch = jax_test_scene(shadow=True)
    return params, statics, dataclasses.replace(cfg, active_tile_cap=16), batch, synthetic_body(n_rings=10, n_seg=12)


@pytest.fixture(scope="module")
def scenes():
    """4 animate scenes at 48^2 (JAX packs, numpy params, infos) and the
    second orbit frame of each."""
    j_packs, infos, params_np = _jax_scenes(4, IMG)
    items = anim_cli._orbit_items(infos, 0, 4, IMG)[1]
    return j_packs, params_np, infos, items


def _tile_job(gate, cap):
    (jp, _, _, frame_np, info), _, second = gate
    return ("tile_program_run", (gate_model_cfg(GATE_IMG), cap, jax.tree_util.tree_map(np.asarray, jp), info,
                                 [frame_np, second]))


@pytest.fixture(scope="module")
def runs(info, dp_inputs, gate, jax_tile_scene, scenes):
    """Every rank's results: world 2 (the data-parallel step without and with
    a subdivision, the tile render on the gate scene and on the JAX test's,
    the multi-scene render), world 4 (the tile render) and world 1 (the
    data-parallel step)."""
    params_np, frames, _ = dp_inputs
    p2, _, _, b2, info2 = jax_tile_scene
    _, scene_params, infos, items = scenes
    worlds = {
        2: [("dp_program_run", (params_np, info, frames)),
            ("dp_program_run", (params_np, info, frames, 1)),
            _tile_job(gate, CAPS[2]),
            ("tile_program_run", (_jax_test_model_cfg(), 16, jax.tree_util.tree_map(np.asarray, p2), info2,
                                  [{k: np.asarray(v) for k, v in b2.items()}])),
            ("multi_scene_calls", (_synthetic_model_cfg(IMG), list(zip(scene_params, infos)), items, CALLS))],
        4: [_tile_job(gate, CAPS[4])],
        1: [("dp_program_run", (params_np, info, [f[:1] for f in frames]))],
    }
    # the three worlds start together: most of a world's time is its ranks' start
    with ThreadPoolExecutor(len(worlds)) as pool:
        futures = {w: pool.submit(spawn, program_jobs, ["cpu"] * w, jobs) for w, jobs in worlds.items()}
        two, four, (one,) = (futures[w].result() for w in (2, 4, 1))
    return {"dp": [r[0] for r in two], "sub": [r[1] for r in two], "tile": {2: [r[2] for r in two],
            4: [r[0] for r in four]}, "jax_tile": [r[3] for r in two], "scenes": [r[4] for r in two], "one": one[0]}


# ---- the data-parallel step ----------------------------------------------------


def test_rank_program_is_the_eager_step(runs):
    r0, r1 = runs["dp"]
    for s in range(STEPS):
        for a, b, c in zip(r0["params"][s], r1["params"][s], r0["eager"][s]):
            assert np.array_equal(a, b), f"step {s}: the replicas differ"
            assert np.array_equal(a, c), f"step {s}: the program differs from the eager rank step"
        assert all(np.array_equal(a, b) for a, b in zip(r1["params"][s], r1["eager"][s]))


def test_rank_program_is_the_mean_gradient_step(runs, info, dp_inputs):
    params_np, frames, _ = dp_inputs
    ref_params, ref_losses = _mean_gradient_run(params_np, info, frames)
    for s in range(STEPS):
        for a, b in zip(runs["dp"][0]["params"][s], ref_params[s]):
            assert np.array_equal(a, b), f"step {s}"
        assert runs["dp"][0]["losses"][s] == runs["dp"][1]["losses"][s] == ref_losses[s]


def test_rank_program_matches_jax(runs, dp_inputs):
    params_np, _, j = dp_inputs
    t = runs["dp"][0]
    for k, want in j["losses"].items():
        np.testing.assert_allclose(t["losses"][0][k], want, rtol=LOSS_RTOL, err_msg=k)
    assert all(t["losses"][0][k] == 0 for k in ("bin_drop_budget", "bin_drop_buffer", "bin_drop_ncmax"))
    names = [k for k in sorted(params_np) for _ in tree_leaves(params_np[k])]
    assert len(names) == len(t["mu"]) == len(j["mu"])
    for name, a, b in zip(names, t["mu"], j["mu"]):
        scale = float(np.abs(b).max())
        assert a.shape == b.shape and scale > 0, name
        rel = SHADOW_ATOL_REL if name == "shadow" else GRAD_ATOL_REL
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=name)


def test_rank_program_protocol(runs):
    """Outputs overwritten by the next call, the state in the program's
    buffers, one all-reduce per call, one program of the gloo form captured
    once."""
    for r in runs["dp"]:
        assert r["overwritten"]
        assert r["in_place"] == [True] * STEPS
        assert r["reduces"] == [1] * STEPS
        assert r["programs"] == [("RankProgram", 1, False)]


def test_one_rank_program_per_phase(runs, info):
    r0, r1 = runs["sub"]
    faces0 = TG.init_gom(dp_cfg(default_cfg())["model"], info, device="cpu")[2].num_faces
    assert (r0["phase"], r0["faces"]) == (r1["phase"], r1["faces"]) == (1, 4 * faces0)
    assert r0["programs"] == r1["programs"] == [("RankProgram", 1, False)] * 2
    assert r0["reduces"] == [1] * STEPS
    for a, b in zip(r0["params"][-1], r1["params"][-1]):
        assert np.array_equal(a, b)
    assert np.isfinite(r0["losses"][-1]["total"])


def test_world_one_program_is_the_trainer_step(runs, info, dp_inputs):
    params_np, frames, _ = dp_inputs
    one = runs["one"]
    cfg = dp_cfg(default_cfg())
    _, statics, gom_cfg = TG.init_gom(cfg["model"], info, device="cpu")
    tr = Trainer(cfg, device="cpu", state=(params_from_jax(params_np, "cpu"), statics, gom_cfg, 0, 0))
    for s, per_rank in enumerate(frames):
        total, losses = tr.step(tensors(per_rank[0], "cpu"))
        for a, b in zip(one["params"][s], numpy_leaves(tr.params)):
            assert np.array_equal(a, b), f"step {s}"
        assert one["losses"][s] == {"total": float(total), **{k: float(v) for k, v in losses.items()}}
    assert one["reduces"] == [1] * STEPS and one["programs"] == [("RankProgram", 1, False)]


# ---- pre and post bake no host value ---------------------------------------------


@pytest.fixture(scope="module")
def trace_scene(gate):
    return gate[1]


@pytest.fixture(scope="module")
def lpips_params():
    from gomavatar_tpu_torch.models import lpips as TLpips

    return TLpips.init_lpips(device="cpu")[0]


def _group(world=2):
    """A rank's view without a process group: ``pre`` and ``post`` never
    touch it."""
    return RankGroup(0, world, torch.device("cpu"), "gloo", None)


def test_data_parallel_pre_and_post_bake_no_host_value(trace_scene, lpips_params, kernels_as_single_ops):  # noqa: F811
    """``pre`` at an iteration before the non-rigid kick-in and one inside
    its annealing band; ``post`` at Adam counts 1 and 2 on two sums."""
    tr = _trainer(trace_scene, lpips_params)
    prog = make_data_parallel_program(_group(), tr.gom_cfg, tr.loss_cfg, tr.tx, tr.statics, lpips_params)
    batch = _batch(trace_scene[3])
    send, like = prog.pre(tr.params, tr.opt_state, batch, torch.tensor(ITERS[0]))  # the warm-up
    pres = [trace(prog.pre, tr.params, tr.opt_state, batch, torch.tensor(i)) for i in ITERS]
    assert_same_trace(*pres, "data-parallel pre")
    prog.post(send.clone(), like, tr.params, tr.opt_state, batch, torch.tensor(ITERS[0]))  # the warm-up
    sums = [send * 2.0, send * 0.5]
    posts = [trace(prog.post, x, like, tr.params, tr.opt_state, batch, torch.tensor(i)) for x, i in zip(sums, ITERS)]
    assert_same_trace(*posts, "data-parallel post")
    assert int(tr.opt_state.count) == 3  # every post wrote its state in place


def test_tile_pre_and_post_bake_no_host_value(trace_scene, kernels_as_single_ops, monkeypatch):  # noqa: F811
    """``pre`` and ``post`` of the tile render (with the normal) on two
    frames: the same ops with the same scalars, no host read."""
    monkeypatch.setattr(TR, "frame_sweep", _unrecorded(FR.frame_sweep))
    params, statics, cfg, frame = trace_scene
    cfg = dataclasses.replace(cfg, active_tile_cap=CAPS[2])
    prog = make_tile_parallel_render(_group(), cfg, statics, with_normal=True)

    def args(f):
        verts = TG.posed_vertices(params, statics, cfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"])
        return params, verts, params["appearance"]["colors"], f["K"], f["E"]

    frames = [_perturbed(frame, s) for s in (1, 2)]
    prog.pre(*args(frame))  # the warm-up
    pres = [trace(prog.pre, *args(f)) for f in frames]
    assert_same_trace(*pres, "tile pre")
    mids = [prog.pre(*args(f)) for f in frames]
    gathered = [torch.cat([send, send]) for send, _ in mids]  # world 2
    prog.post(gathered[0], mids[0][1], *args(frames[0]))  # the warm-up
    posts = [trace(prog.post, g, carry, *args(f)) for g, (_, carry), f in zip(gathered, mids, frames)]
    # the untiling and shading: a few dozen ops
    assert_same_trace(*posts, "tile post", least=20)


# ---- the tile-parallel render ----------------------------------------------------


@pytest.mark.parametrize("world", sorted(CAPS))
def test_tile_program_equals_render_frame_eval(gate, runs, world):
    _, (params, statics, cfg, frame), second = gate
    cfg = dataclasses.replace(cfg, active_tile_cap=CAPS[world])
    frames = [frame, tensors(second, "cpu")]
    wants = []
    for f in frames:
        verts = TG.posed_vertices(params, statics, cfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"])
        *want, _ = TG.render_frame_eval(params, statics, cfg, verts, params["appearance"]["colors"], f["K"], f["E"],
                                        with_normal=True)
        wants.append(want)
    assert float(wants[0][1].max()) > 0.5 and float((wants[0][0] - wants[1][0]).abs().max()) > 1e-3
    for rank, r in enumerate(runs["tile"][world]):
        assert r["same_outputs"] and r["captures"] == 1
        for call, ((outs, gathers), want) in enumerate(zip(r["calls"], wants)):
            assert gathers == 1, f"world {world} rank {rank} call {call}: {gathers} all-gathers"
            for name, a, b in zip(("rgb", "alpha", "normal", "hit"), outs, want):
                assert np.array_equal(a, b.numpy()), f"world {world} rank {rank} call {call}: {name}"


def test_tile_program_matches_jax(jax_tile_scene, runs):
    params, statics, cfg, batch, _ = jax_tile_scene
    verts_obs = jax_test_verts_obs(params, statics, batch, cfg)
    render = jax_tile_parallel_render(make_mesh(2, axis=TILE_AXIS), cfg, statics, interpret=True)
    rgb, alpha = render(params, verts_obs, params["appearance"]["colors"], batch["K"], batch["E"])
    assert float(jnp.max(alpha)) > 0.5
    for r in runs["jax_tile"]:
        (outs, gathers), = r["calls"]
        assert gathers == 1
        np.testing.assert_allclose(outs[1], np.asarray(alpha), atol=1e-5)
        np.testing.assert_allclose(outs[0], np.asarray(rgb), atol=1e-5)


# ---- the multi-scene render ------------------------------------------------------


def test_multi_scene_program_is_the_scene_loop(scenes, runs):
    _, params_np, infos, items = scenes
    m = _synthetic_model_cfg(IMG)
    packs = []
    for p, info in zip(params_np, infos):
        _, statics, cfg = TG.init_gom(m, info, device="cpu")
        packs.append((params_from_jax(p, "cpu"), statics, cfg))
    want, want_mask = render_in_turn(len(packs), "cpu")(packs, items)
    for rank, calls in enumerate(runs["scenes"]):
        assert len(calls) == CALLS
        for call, (rgb, mask, gathers) in enumerate(calls):
            assert gathers == 2, f"rank {rank} call {call}: {gathers} all-gathers"
            assert np.array_equal(rgb, want.numpy()) and np.array_equal(mask, want_mask.numpy()), \
                f"rank {rank} call {call}"
    assert all(float((want[s] - want[s + 1]).abs().max()) > 1e-3 for s in range(3))


def test_multi_scene_program_matches_jax(scenes, runs):
    j_packs, _, _, items = scenes
    gom_cfg = jax_animate.check_homogeneous_scenes(j_packs[:2])
    params_s = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[p[0] for p in j_packs[:2]])
    statics_s = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[p[1] for p in j_packs[:2]])
    render = jax_multi_scene_render(make_mesh(2, axis=SCENE_AXIS), gom_cfg)
    want, _ = render(params_s, statics_s, stack_batches(items[:2]), jnp.float32(1e7))
    rgb = runs["scenes"][0][-1][0]
    for s in range(2):
        assert_close_frac(rgb[s], np.asarray(want[s]), f"scene {s}")
        assert float(rgb[s].max()) > 0.05

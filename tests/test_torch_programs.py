"""The capture contract of gomavatar_tpu_torch's one-program steps
(``programs.py``), checked on the CPU without a card.

A captured CUDA graph replays the launches of its capture with the scalars
they were given then.  So a step may not bake a value from the host: a
``TorchDispatchMode`` records every aten op and its non-tensor arguments
while the step runs, and two runs whose only difference is such a value
must give the same trace.  The steps: the train step on the gate scene
(tests/torch_port_scene.py) at an iteration before the non-rigid kick-in
and one inside its annealing band; one pose step at two Adam counts on
either side of a decay boundary; the eval forward on two perturbed frames.
No op may read a device value on the host (``_local_scalar_dense``,
``nonzero``, ``masked_select``, ``unique``) or make a tensor from host data
(``lift_fresh``: a host-to-device copy on the card, which capture refuses).

The kernels' plain versions (the CPU side of each wrapper) read the host by
design; on the card each is one launch.  They run inside a monkeypatched
wrapper with the recording switched off, their backward too.

Then the program's static-buffer protocol, which runs eagerly on the CPU:
outputs overwritten by the next call, no copy for the program's own
buffers, a new program per key, and a Trainer whose state is rebound
(``_subdivide``, ``resume``) stepping from the new tensors, never from the
old buffers.
"""

import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gomavatar_tpu_torch.cli import train_pose as TP
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.models import lpips as TLpips
from gomavatar_tpu_torch.ops import frame_render as FR
from gomavatar_tpu_torch.ops import mesh_raster_pallas as MK
from gomavatar_tpu_torch.ops.splat import render as SR
from gomavatar_tpu_torch.optim import counter, tree_leaves
from gomavatar_tpu_torch.programs import Program
from gomavatar_tpu_torch.scene import E2E_TRAIN, gate_model_cfg
from gomavatar_tpu_torch.trainer import Trainer, make_program_step, make_train_step
from torch_port_scene import IMG, jax_gate_scene, torch_scene_from
from torch_threads import one_torch_thread  # noqa: F401

# ops that read a device value on the host or copy host data to the device
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten._unique", "aten.unique",
             "aten.lift_fresh")
# the gate model's non-rigid module: kick-in 3000, full band at 4000
ITERS = (2990.0, 3500.0)


class OpTrace(TorchDispatchMode):
    """Every aten op with its non-tensor arguments (tensors as their dtype),
    except while ``paused``."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            self.ops.append((str(func), _scalars(args), _scalars(kwargs)))
        return func(*args, **kwargs)


def _scalars(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", x.dtype)
    if isinstance(x, dict):
        return tuple((k, _scalars(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_scalars(v) for v in x)
    return x


_active: list = []


class _paused:
    def __enter__(self):
        for t in _active:
            t.paused += 1

    def __exit__(self, *exc):
        for t in _active:
            t.paused -= 1


class _Opaque(torch.autograd.Function):
    """A plain kernel version as one unrecorded op, forward and backward."""

    @staticmethod
    def forward(ctx, fn, n_args, *args):
        with _paused(), torch.enable_grad():
            ins = [a.detach().requires_grad_(ctx.needs_input_grad[2 + i]) if isinstance(a, torch.Tensor) else a
                   for i, a in enumerate(args)]
            outs = fn(*ins)
        ctx.ins, ctx.outs = ins, outs
        return tuple(o.detach() if o is not None else None for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        with _paused():
            pairs = [(o, g) for o, g in zip(ctx.outs, grads) if o is not None and o.requires_grad]
            need = [i for i, a in enumerate(ctx.ins) if isinstance(a, torch.Tensor) and a.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], [ctx.ins[i] for i in need], [g for _, g in pairs],
                                      allow_unused=True)
        out = [None] * len(ctx.ins)
        for i, g in zip(need, got):
            out[i] = g
        return (None, None, *out)


def _opaque(fn):
    def wrapper(*args):
        return _Opaque.apply(fn, len(args), *args)

    return wrapper


def _unrecorded(fn):
    def wrapper(*args, **kwargs):
        with _paused():
            return fn(*args, **kwargs)

    return wrapper


@pytest.fixture
def kernels_as_single_ops(monkeypatch):
    monkeypatch.setattr(FR, "frame_sweep", _unrecorded(FR.frame_sweep))
    monkeypatch.setattr(SR, "composite_tiles", _opaque(SR.composite_tiles))
    monkeypatch.setattr(MK, "mesh_composite", _opaque(MK.mesh_composite))


def trace(fn, *args):
    """The ops of ``fn(*args)``.  The caller warms ``fn`` up first, as the
    program does before its capture (a per-device constant is made once
    then)."""
    t = OpTrace()
    _active.append(t)
    try:
        with t:
            fn(*args)
    finally:
        _active.remove(t)
    return t.ops


def assert_same_trace(a, b, label, least=100):
    """The same ops with the same scalars, none of them FORBIDDEN, and more
    than ``least`` of them (the step was recorded)."""
    names = {op for op, _, _ in a} | {op for op, _, _ in b}
    bad = sorted(n for n in names if n.startswith(FORBIDDEN))
    assert not bad, f"{label}: host reads or host data inside the step: {bad}"
    assert len(a) > least, f"{label}: only {len(a)} ops recorded"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"{label}: op {i} differs:\n  {x}\n  {y}"
    assert len(a) == len(b), f"{label}: {len(a)} ops against {len(b)}"


@pytest.fixture(scope="module")
def scene():
    """The gate scene of tests/torch_port_scene.py on the port's side."""
    return torch_scene_from(jax_gate_scene(0))


@pytest.fixture(scope="module")
def lpips_params():
    return TLpips.init_lpips(device="cpu")[0]


def _train_cfg():
    return {"model": gate_model_cfg(IMG), "train": copy.deepcopy(E2E_TRAIN)}


def _batch(frame):
    rng = np.random.default_rng(3)
    H, W = IMG[1], IMG[0]
    b = {k: v.clone() for k, v in frame.items()}
    b["bgcolor"] = torch.zeros(3)
    b["target_rgbs"] = torch.as_tensor(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    b["target_masks"] = torch.as_tensor((rng.uniform(0, 1, (H, W)) > 0.5).astype(np.float32))
    return b


def _trainer(scene, lpips_params, i_iter=0):
    params, statics, cfg, _ = scene
    params = {k: copy.deepcopy(v) for k, v in params.items()}
    return Trainer(_train_cfg(), lpips_params=lpips_params, device="cpu",
                   state=(params, statics, cfg, i_iter, 1))


def _perturbed(frame, seed):
    rng = np.random.default_rng(seed)
    f = {k: v.clone() for k, v in frame.items()}
    f["dst_posevec"] = f["dst_posevec"] + torch.as_tensor(0.05 * rng.standard_normal(69).astype(np.float32))
    f["E"][:3, 3] += torch.as_tensor(0.02 * rng.standard_normal(3).astype(np.float32))
    return f


def test_train_step_bakes_no_host_value(scene, lpips_params, kernels_as_single_ops):
    """The train step as its program runs it, at an iteration before the
    non-rigid kick-in and one inside its annealing band: the same ops with
    the same scalars, no host read."""
    tr = _trainer(scene, lpips_params)
    step = make_program_step(tr.gom_cfg, tr.loss_cfg, tr.tx, tr.statics, lpips_params)
    batch = _batch(scene[3])
    step(tr.params, tr.opt_state, batch, torch.tensor(ITERS[0]))  # the warm-up
    traces = [trace(step, tr.params, tr.opt_state, batch, torch.tensor(i)) for i in ITERS]
    assert_same_trace(*traces, "train step")
    assert int(tr.opt_state.count) == 3  # every step wrote its state in place


def test_pose_step_bakes_no_host_value(scene, lpips_params, kernels_as_single_ops):
    """One pose step at Adam counts 1 and 2 with the step size halving
    every 2: on either side of the decay boundary, the same trace."""
    params, statics, cfg, frame = scene
    tx = TP.PoseAdam({"lr": 1e-2, "decay": 2})
    step = TP.make_pose_step(cfg, E2E_TRAIN["losses"], tx)
    batch = _batch(frame)
    batch["dst_tpose_joints"] = torch.as_tensor(np.random.default_rng(4).normal(0, 0.3, (24, 3)).astype(np.float32))
    poses = torch.as_tensor(np.random.default_rng(5).normal(0, 0.05, 72).astype(np.float32))

    def carry(count):
        leaves = [torch.zeros(3), torch.zeros(3), poses.clone()]
        opt = tx.init(leaves)._replace(count=counter(count, "cpu"))
        return TP.PoseCarry(leaves, opt, [t.clone() for t in leaves], torch.tensor(float("inf")), torch.zeros(4),
                            torch.zeros(4, dtype=torch.int32), torch.zeros((), dtype=torch.int32))

    step(params, statics, lpips_params, batch, carry(0), torch.tensor(1e7))  # the warm-up
    carries = [carry(1), carry(2)]
    traces = [trace(step, params, statics, lpips_params, batch, c, torch.tensor(1e7)) for c in carries]
    assert_same_trace(*traces, "pose step")
    # each step wrote its loss at its own row and moved its count
    for c, row in zip(carries, (1, 2)):
        assert int(c.opt.count) == row + 1 and float(c.losses[row]) > 0
        assert float(c.losses.sum()) == float(c.losses[row])


def test_eval_forward_bakes_no_host_value(scene, kernels_as_single_ops):
    params, statics, cfg, frame = scene
    frames = [_perturbed(frame, s) for s in (1, 2)]
    f = frame
    TG.eval_forward(params, statics, cfg, f["K"], f["E"], f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"],
                    f["dst_posevec"], torch.tensor(6100.0), None, None)  # the warm-up
    traces = [
        trace(TG.eval_forward, params, statics, cfg, f["K"], f["E"], f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"],
              f["dst_posevec"], torch.tensor(6100.0), None, None)
        for f in frames
    ]
    assert_same_trace(*traces, "eval forward")


# ---- the static-buffer protocol ----------------------------------------------------


def test_program_outputs_are_static_and_keyed_by_shape():
    calls = []

    def fn(x, scale, tag):
        calls.append(tag)
        return {"y": x * scale, "tag_sum": x.sum()}

    prog = Program(fn)
    a = prog(torch.ones(3), 2.0, "a")
    y0 = a["y"]
    b = prog(torch.full((3,), 5.0), 3.0, "a")
    # the same key: the same output tensors, overwritten by the second call
    assert b["y"] is y0 and torch.equal(y0, torch.full((3,), 15.0))
    assert prog.captures == 1
    # a float is an input: it reached fn as a 0-d tensor
    assert isinstance(prog.last_args[1], torch.Tensor) and prog.last_args[1].dim() == 0
    # a new shape or a new static leaf is a new program
    prog(torch.ones(4), 1.0, "a")
    prog(torch.ones(3), 1.0, "b")
    assert prog.captures == 3 and calls == ["a", "a", "a", "b"]
    # the program's own buffers are taken as they are: no copy into them
    buf = prog.last_args[0]
    with torch.no_grad():
        buf.fill_(7.0)
    out = prog(*prog.last_args)
    assert torch.equal(out["y"], torch.full((3,), 7.0))


def test_program_state_in_place(scene, lpips_params):
    """The train step's program: the state it returns is its input buffers,
    updated in place, and equal to the functional step's."""
    tr = _trainer(scene, lpips_params, i_iter=3500)
    params0 = {k: copy.deepcopy(v) for k, v in tr.params.items()}
    state0 = tr.opt_state
    batch = _batch(scene[3])
    total, losses = tr.step(batch)
    prog = tr._step_fn
    bufs = prog.last_args
    assert tr.params is bufs[0] and tr.opt_state is bufs[1]
    ref_params, ref_state, ref_total, _ = make_train_step(tr.gom_cfg, tr.loss_cfg, tr.tx)(
        params0, state0, tr.statics, lpips_params, batch, torch.tensor(3500.0))
    for a, b in zip(tree_leaves(tr.params), tree_leaves(ref_params)):
        assert torch.equal(a, b)
    assert torch.equal(total, ref_total) and int(tr.opt_state.count) == int(ref_state.count) == 1
    kept = total.clone()
    total2, _ = tr.step(batch)
    assert total2 is total and not torch.equal(total, kept)  # overwritten by the next step


def test_trainer_steps_from_rebound_state(scene, lpips_params, tmp_path):
    """After a subdivision the trainer steps through a new program on the
    new shapes; after a resume its next step starts from the restored
    tensors, not from the buffers the program held."""
    params, statics, cfg, frame = scene
    tcfg = _train_cfg()
    tcfg["model"]["subdivide_iters"] = [2]
    tr = Trainer(tcfg, lpips_params=None, device="cpu",
                 state=({k: copy.deepcopy(v) for k, v in params.items()}, statics, cfg, 0, 0))
    batch = _batch(frame)
    tr.step(batch)
    tr.save(str(tmp_path))  # iter_1
    saved = [p.clone() for p in tree_leaves(tr.params)]
    prog0 = tr._step_fn
    tr.step(batch)  # iter 1 -> 2
    tr.step(batch)  # subdivides at 2
    assert tr._step_fn is not prog0 and tr.gom_cfg.num_faces == 4 * cfg.num_faces
    assert tr.params is tr._step_fn.last_args[0] and tr.params["so3"].shape[0] == 4 * cfg.num_faces

    # back to iter_1 (phase 0): a fresh trainer replays nothing, restores
    fresh = Trainer(tcfg, lpips_params=None, device="cpu",
                    state=({k: copy.deepcopy(v) for k, v in params.items()}, statics, cfg, 0, 0))
    fresh.step(batch)
    fresh.step(batch)  # its program's buffers now hold iteration 2's state
    old_bufs = [t.clone() for t in tree_leaves(fresh.params)]
    assert fresh.resume(str(tmp_path)) and fresh.i_iter == 1
    for a, b in zip(tree_leaves(fresh.params), saved):
        assert torch.equal(a, b)
    ref = Trainer(tcfg, lpips_params=None, device="cpu",
                  state=({k: copy.deepcopy(v) for k, v in params.items()}, statics, cfg, 0, 0))
    ref.resume(str(tmp_path))
    # another target than the steps before: a step from the old buffers
    # would not give the reference's state
    batch2 = dict(batch, target_rgbs=1.0 - batch["target_rgbs"])
    ref_params, _, _, _ = make_train_step(ref.gom_cfg, ref.loss_cfg, ref.tx)(
        ref.params, ref.opt_state, ref.statics, None, batch2, torch.tensor(1.0))
    fresh.step(batch2)
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(ref_params)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, old) for a, old in zip(tree_leaves(fresh.params), old_bufs))

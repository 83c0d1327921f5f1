"""The train step, the phase-managing trainer and its checkpoints (port of
gomavatar_tpu/trainer.py).

One step is ``gom_forward(train=True)`` -> ``unpack`` -> ``compute_loss`` ->
the backward (kernels B3 and B5 on the card) -> one Adam update.  A
subdivision milestone (``cfg["model"]["subdivide_iters"]``) changes the
phase: the state is subdivided and the optimizer rebuilt, with its decay
schedule fast-forwarded to the global iteration.  No step waits for the
device: the losses and the binning telemetry come back as device tensors
(``GOMAVATAR_DEBUG_BINNING=1`` reads the drop counters after every step and
fails on a drop, a sync per step).  Under recording (``utils.profiling``)
the telemetry is also counted every ``log_freq`` steps, the loop's cadence
of reads: ``binning.most_tiles`` (the most tiles one splat covered since the
last count), ``binning.dropped`` (the entries dropped since then) and
``binning.budget`` (the per-splat budget in force), with the frame's
``frame.px`` and ``frame.swept_px`` (``binning.count_frame``); the first
two stay device scalars until the records are read, so no step waits for
them.

The per-splat tile budget follows the state (ROADMAP C5): training widens
the splats, and a budget they outgrow drops binning entries.  The trainer
keeps the most tiles one splat covered (the step's ``bin_most_tiles``) over
every step of the phase on the device, and every ``log_freq`` steps copies
it to pinned memory without waiting, to read at the next such check.  When
it passes 2/3 of the budget, the budget grows to the smallest multiple of
16 at or above 3/2 of it (``grown_budget``): only the step's program is
built anew, over the same params and Adam state, and captures at its next
call (counter ``binning.budget_grow``).  Until it grows, every step is the
one the static budget gives.  A phase change starts again from the new
phase's static budget; a resumed run from the static budget.

The step runs as one program (``programs.py``), the counterpart of the JAX
package's jitted step: on CUDA tensors one captured CUDA graph per phase,
replayed every step, on CPU tensors the same function eagerly.  The params
and the Adam state live in the program's buffers and the step writes their
new values back into them; the iteration reaches it as a device scalar.
The eval forward (``Trainer.forward(train=False)``) is a program too
(``models.gom.eval_program``).  Every path that rebinds the state (a
restore, a resume, a checkpoint load) leaves the new tensors to be copied
into the buffers by the next call; a phase change builds new programs,
which capture anew, as JAX re-jits.

``Trainer.save`` writes the params, the Adam state, the iteration and the
phase (``checkpoint.py``); ``resume`` and ``load_for_eval`` build the
phase-0 model first, replay the stored number of subdivisions, then load.

Under a rank group (``parallel/``) each rank steps on its own frame and the
gradients and loss terms are averaged over the ranks between the backward
and Adam; only rank 0 saves.  That step is the rank's program
(``parallel.step.make_data_parallel_program``, one per phase, with the same
buffers and outputs): over NCCL one captured CUDA graph around the
all-reduce, over gloo on CUDA two graphs with the all-reduce run on the
host between their replays, on CPU tensors the same step eagerly.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from gomavatar_tpu_torch import checkpoint as ckpt_lib
from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.losses import compute_loss, unpack
from gomavatar_tpu_torch.models import lpips as lpips_lib
from gomavatar_tpu_torch.models.gom import (
    GoMConfig,
    GoMStatics,
    eval_program,
    gom_forward,
    init_gom,
    subdivide_gom,
)
from gomavatar_tpu_torch.optim import (
    apply_updates,
    fast_forward_schedule,
    make_optimizer,
    tree_leaves,
    tree_unflatten,
)
from gomavatar_tpu_torch.ops.splat.binning import CHUNK, count_frame
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX
from gomavatar_tpu_torch.programs import Program
from gomavatar_tpu_torch.utils.profiling import count, enabled, span

log = logging.getLogger(__name__)

# fail on any binning-budget overflow (reads the counters: a device sync per
# step; debugging only)
_DEBUG_BINNING = bool(int(os.environ.get("GOMAVATAR_DEBUG_BINNING", "0")))

# the per-splat budget grows when the widest splat seen passes GROW_AT of it,
# to a multiple of GROW_STEP at or above GROW_TO of that splat (module docstring)
GROW_AT = (2, 3)
GROW_TO = (3, 2)
GROW_STEP = 16


def grown_budget(budget: int, most_tiles: int) -> int:
    """The per-splat tile budget after a check that saw a splat cover
    ``most_tiles`` tiles: ``budget`` while that is at most GROW_AT of it,
    else the smallest multiple of GROW_STEP at or above GROW_TO of
    ``most_tiles``."""
    if most_tiles * GROW_AT[1] <= budget * GROW_AT[0]:
        return budget
    want = -(-most_tiles * GROW_TO[0] // GROW_TO[1])
    return max(budget, -(-want // GROW_STEP) * GROW_STEP)


def train_loss(params: dict, statics: GoMStatics, gom_cfg: GoMConfig, loss_cfg: dict, lpips_params,
               batch: dict, i_iter):
    """(total loss, per-term losses with the binning telemetry) of one frame;
    differentiable in ``params``."""
    device = params["vertices"].device
    rgb, mask, aux = gom_forward(
        params, statics, gom_cfg, batch["K"], batch["E"], batch["cnl_gtfms"], batch["dst_Rs"], batch["dst_Ts"],
        dst_posevec=batch["dst_posevec"], i_iter=i_iter, train=True, device=device,
    )

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    rgb_u = unpack(rgb, mask, dev(batch["bgcolor"]))
    total, losses = compute_loss(
        rgb_u, mask, aux, dev(batch["target_rgbs"]), dev(batch["target_masks"]), statics, loss_cfg,
        lpips_params=lpips_params,
    )
    tel = aux["binning"]
    losses["bin_drop_budget"] = tel.dropped_budget
    losses["bin_drop_buffer"] = tel.dropped_buffer
    # entries beyond the train kernels' per-tile chunk cap: the forward
    # truncates them
    losses["bin_drop_ncmax"] = torch.clamp_min(tel.max_tile_entries - NCMAX * CHUNK, 0)
    # the most tiles one splat covered, against max_tiles_per_gaussian
    losses["bin_most_tiles"] = tel.most_tiles
    return total, losses


def loss_and_grads(params: dict, statics: GoMStatics, gom_cfg: GoMConfig, loss_cfg: dict, lpips_params,
                   batch: dict, i_iter):
    """(gradient of every leaf in ``tree_leaves`` order, total, losses) of
    one frame, detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    total, losses = train_loss(tree_unflatten(params, leaves), statics, gom_cfg, loss_cfg, lpips_params, batch, i_iter)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return grads, total.detach(), {k: v.detach() for k, v in losses.items()}


def make_train_step(gom_cfg: GoMConfig, loss_cfg: dict, tx, reduce=None):
    """The train step of one phase: (params, opt_state, statics, lpips_params,
    batch, i_iter) -> (params, opt_state, total, losses).  ``reduce``, when
    given, maps the frame's (grads, total, losses) to the ones Adam takes
    (the mean over the ranks: ``parallel.step``)."""

    def step(params, opt_state, statics, lpips_params, batch, i_iter):
        grads, total, losses = loss_and_grads(params, statics, gom_cfg, loss_cfg, lpips_params, batch, i_iter)
        if reduce is not None:
            grads, total, losses = reduce(grads, total, losses)
        updates, opt_state = tx.update(grads, opt_state)
        with torch.no_grad():
            params = apply_updates(params, updates)
        return params, opt_state, total, losses

    return step


def update_in_place(tx, params: dict, opt_state, grads: list) -> None:
    """One Adam update of ``make_train_step``, its new params and Adam state
    written into the tensors of ``params`` and ``opt_state`` (a program's
    buffers, as optax's donated ones)."""
    updates, new_state = tx.update(grads, opt_state)
    with torch.no_grad():
        new_params = apply_updates(params, updates)
        torch._foreach_copy_(tree_leaves(params) + tree_leaves(list(opt_state)),
                             tree_leaves(new_params) + tree_leaves(list(new_state)))


def make_program_step(gom_cfg: GoMConfig, loss_cfg: dict, tx, statics: GoMStatics, lpips_params):
    """The train step as its program runs it: (params, opt_state, batch,
    i_iter) -> (params, opt_state, total, losses), where the new params and
    Adam state are written into the tensors it was given
    (:func:`update_in_place`) and returned.  The statics and the LPIPS
    trunk are read where they lie: the trainer never rebinds them within a
    phase."""

    def run(params, opt_state, batch, i_iter):
        grads, total, losses = loss_and_grads(params, statics, gom_cfg, loss_cfg, lpips_params, batch, i_iter)
        update_in_place(tx, params, opt_state, grads)
        return params, opt_state, total, losses

    return run


class Trainer:
    """Owns params, statics and the optimizer across subdivision phases, and
    saves and loads them.

    The model starts from ``init_gom`` on ``canonical_info`` (the phase-0
    mesh, which ``resume`` and ``load_for_eval`` subdivide to a checkpoint's
    phase), or from ``state`` = (params, statics, gom_cfg, i_iter, phase), a
    loaded model (e.g. ``convert.load_trained``); the optimizer is then new,
    with its schedule fast-forwarded to ``i_iter``.  ``lpips_calibrated``
    says whether ``lpips_params`` hold a converted pretrained trunk.

    With ``group`` (a ``parallel.RankGroup``) the trainer is one rank of a
    data-parallel run: every rank holds the same state, ``step`` takes this
    rank's frame, and ``save`` writes on rank 0 only."""

    def __init__(self, cfg, canonical_info: dict | None = None, lpips_params=None, seed: int = 0,
                 device="cuda", state=None, lpips_calibrated: bool = False, group=None):
        self.cfg = cfg
        self.group = group
        self.loss_cfg = cfg["train"]["losses"]
        # the trunk's weights laid out for its device once, whoever made them
        self.lpips_params = None if lpips_params is None else lpips_lib.laid_out(lpips_params)
        self.lpips_calibrated = lpips_calibrated
        self.subdivide_iters = sorted(cfg["model"].get("subdivide_iters", []))
        self.device = torch.device(device)
        self.log_freq = int(cfg["train"]["log_freq"])
        self._binning = None  # (most tiles, dropped) since the last count, under recording
        if state is None:
            self.params, self.statics, self.gom_cfg = init_gom(cfg["model"], canonical_info, self.device,
                                                               prng.key(seed))
            self.i_iter, self.phase = 0, 0
        else:
            self.params, self.statics, self.gom_cfg, self.i_iter, self.phase = state
        self._rebuild_optimizer()

    # -- phase management ----------------------------------------------------

    def _rebuild_optimizer(self):
        self.tx = make_optimizer(self.cfg["train"], self.params)
        self.opt_state = self.tx.init(self.params)
        if self.i_iter:
            # keep the lr decay continuous across the phase change
            self.opt_state = fast_forward_schedule(self.opt_state, self.i_iter)
        # the eval program of the previous phase renders no more
        self._eval = eval_program()
        # the phase's budget, from its static one (module docstring)
        self.step_cfg = self.gom_cfg
        self._widest_dev = None  # the most tiles of one splat over every step of the phase, on the device
        self._widest_read = None  # (host buffer, event) of the copy taken at the last check
        self._build_step()

    def _build_step(self):
        """The step's program at ``step_cfg``."""
        if self.group is None:
            self._step_fn = Program(make_program_step(self.step_cfg, self.loss_cfg, self.tx, self.statics,
                                                      self.lpips_params))
        else:
            from gomavatar_tpu_torch.parallel.step import make_data_parallel_program

            self._step_fn = make_data_parallel_program(self.group, self.step_cfg, self.loss_cfg, self.tx,
                                                       self.statics, self.lpips_params)

    def _subdivide(self):
        log.info("subdividing at iter %d: %d -> %d faces", self.i_iter, self.gom_cfg.num_faces,
                 self.gom_cfg.num_faces * 4)
        with span("train.subdivide", self.i_iter):
            self.params, self.statics, self.gom_cfg = subdivide_gom(self.params, self.statics, self.gom_cfg)
            self.phase += 1
            self._rebuild_optimizer()

    def maybe_subdivide(self) -> bool:
        """Subdivide on reaching the next milestone."""
        if self.phase < len(self.subdivide_iters) and self.i_iter >= self.subdivide_iters[self.phase]:
            self._subdivide()
            return True
        return False

    # -- stepping ------------------------------------------------------------

    def step(self, batch: dict):
        """One optimizer step on one frame; returns (total, losses) as device
        tensors.  Under a rank group ``batch`` is this rank's frame and the
        step's gradients and losses are the ranks' means: the rank-per-process
        form of JAX's ``step`` over a list of ``data_parallel`` frames.

        The step is the phase's program, with or without a group: ``batch``
        is copied into its inputs, the state is updated in place in its
        buffers, and (total, losses) are its outputs, which the next step
        overwrites (clone what is kept longer)."""
        self.maybe_subdivide()
        self.params, self.opt_state, total, losses = self._step_fn(
            self.params, self.opt_state, batch, float(self.i_iter)
        )
        if _DEBUG_BINNING:
            # float: under a rank group the counters are means over the ranks
            dropped = sum(float(losses[k]) for k in ("bin_drop_budget", "bin_drop_buffer", "bin_drop_ncmax"))
            if dropped:
                raise RuntimeError(
                    f"binning dropped {dropped:g} entries at iter {self.i_iter}: raise max_tiles_per_gaussian / "
                    f"buffer_factor / the kernels' NCMAX (GOMAVATAR_DEBUG_BINNING=1 makes this fatal)"
                )
        self.i_iter += 1
        self._watch_budget(losses["bin_most_tiles"])
        if enabled():
            self._count_binning(losses)
        elif self._binning is not None:
            self._binning = None
        return total, losses

    def _watch_budget(self, most: torch.Tensor) -> None:
        """Keep the widest splat of the phase on the device; every
        ``log_freq`` steps read the copy taken at the last check, grow the
        budget where it asks for it, and take a new copy (module
        docstring)."""
        if self._widest_dev is None:
            self._widest_dev = most.clone()
        else:
            torch.maximum(self._widest_dev, most, out=self._widest_dev)
        if self.i_iter % self.log_freq:
            return
        if self._widest_read is not None:
            buf, done = self._widest_read
            if done is not None:
                done.synchronize()
            widest = int(buf)
            budget = grown_budget(self.step_cfg.max_tiles_per_gaussian, widest)
            if budget != self.step_cfg.max_tiles_per_gaussian:
                log.info("iter %d: a splat covered %d tiles: the per-splat tile budget grows %d -> %d",
                         self.i_iter, widest, self.step_cfg.max_tiles_per_gaussian, budget)
                self._grow(budget)
        if self._widest_dev.is_cuda:
            buf = torch.empty((), dtype=self._widest_dev.dtype, pin_memory=True)
            buf.copy_(self._widest_dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._widest_read = (buf, done)
        else:
            self._widest_read = (self._widest_dev.clone(), None)

    def _grow(self, budget: int) -> None:
        """Rebuild the step's program at ``budget``, over the same state."""
        self.step_cfg = dataclasses.replace(self.step_cfg, max_tiles_per_gaussian=budget)
        self._build_step()
        count("binning.budget_grow")

    def _count_binning(self, losses: dict) -> None:
        """Keep the step's binning telemetry on the device (the most tiles of
        any step, the dropped entries summed) and count it every ``log_freq``
        steps (module docstring)."""
        most = losses["bin_most_tiles"]
        dropped = losses["bin_drop_budget"] + losses["bin_drop_buffer"] + losses["bin_drop_ncmax"]
        if self._binning is None:
            self._binning = (most.clone(), dropped)
        else:
            self._binning = (torch.maximum(self._binning[0], most), self._binning[1] + dropped)
        if self.i_iter % self.log_freq == 0:
            most, dropped = self._binning
            count("binning.most_tiles", most)
            count("binning.dropped", dropped)
            count("binning.budget", self.step_cfg.max_tiles_per_gaussian)
            count_frame(self.step_cfg.img_size)
            self._binning = None

    def forward(self, batch: dict, train: bool = False):
        """The frame at the current iteration: (rgb, mask, aux).  Eval
        (``train=False``) through the trainer's eval program, whose outputs
        the next eval call overwrites; ``train=True`` eagerly, with
        autograd."""
        frame = (batch["K"], batch["E"], batch["cnl_gtfms"], batch["dst_Rs"], batch["dst_Ts"],
                 batch.get("dst_posevec"))
        if not train:
            return self._eval(self.params, self.statics, self.gom_cfg, *frame, float(self.i_iter),
                              batch.get("global_R"), batch.get("global_T"))
        i_iter = torch.full((), float(self.i_iter), dtype=torch.float32, device=self.device)
        with torch.enable_grad():
            return gom_forward(self.params, self.statics, self.gom_cfg, *frame, i_iter=i_iter,
                               global_R=batch.get("global_R"), global_T=batch.get("global_T"), train=True,
                               device=self.device)

    # -- checkpointing -------------------------------------------------------

    def save(self, ckpt_dir: str):
        """Write a checkpoint (on rank 0 only under a rank group)."""
        if self.group is not None and self.group.rank != 0:
            return
        ckpt_lib.save_checkpoint(ckpt_dir, self.i_iter, self.params, self.opt_state, self.phase)

    def _replay_and_restore(self, path: str):
        """Subdivide to the checkpoint's phase (shapes change across
        phases), then load params and Adam state into that shape."""
        phase = ckpt_lib.read_phase(path)
        while self.phase < phase:
            self._subdivide()
        return ckpt_lib.restore_checkpoint(path, self.params, self.opt_state)

    def resume(self, ckpt_dir: str) -> bool:
        """Restore the latest checkpoint of ``ckpt_dir``: params, Adam state
        and iteration.  False when there is none."""
        latest = ckpt_lib.latest_checkpoint(ckpt_dir)
        if latest is None:
            return False
        path, _ = latest
        self.params, self.opt_state, self.i_iter, phase = self._replay_and_restore(path)
        log.info("resumed from %s (iter %d, phase %d)", path, self.i_iter, phase)
        return True

    def load_for_eval(self, ckpt_dir: str, it: int | None = None) -> int:
        """Load the params of checkpoint ``iter_{it}`` (the latest when
        ``it`` is None) for rendering; returns its iteration."""
        latest = ckpt_lib.latest_checkpoint(ckpt_dir)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        path = latest[0] if it is None else os.path.join(ckpt_dir, f"iter_{it}")
        self.params, _, self.i_iter, _ = self._replay_and_restore(path)
        return self.i_iter

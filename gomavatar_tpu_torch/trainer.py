"""The train step, the phase-managing trainer and its checkpoints (port of
gomavatar_tpu/trainer.py).

One step is ``gom_forward(train=True)`` -> ``unpack`` -> ``compute_loss`` ->
the backward (kernels B3 and B5 on the card) -> one Adam update.  A
subdivision milestone (``cfg["model"]["subdivide_iters"]``) changes the
phase: the state is subdivided and the optimizer rebuilt, with its decay
schedule fast-forwarded to the global iteration.  No step waits for the
device: the losses and the binning telemetry come back as device tensors
(``GOMAVATAR_DEBUG_BINNING=1`` reads the drop counters after every step and
fails on a drop, a sync per step).

``Trainer.save`` writes the params, the Adam state, the iteration and the
phase (``checkpoint.py``); ``resume`` and ``load_for_eval`` build the
phase-0 model first, replay the stored number of subdivisions, then load.

Under a rank group (``parallel/``) each rank steps on its own frame and the
gradients and loss terms are averaged over the ranks between the backward
and Adam (``parallel.step.make_data_parallel_train_step``); only rank 0
saves.
"""

from __future__ import annotations

import logging
import os

import torch

from gomavatar_tpu_torch import checkpoint as ckpt_lib
from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.losses import compute_loss, unpack
from gomavatar_tpu_torch.models.gom import GoMConfig, GoMStatics, gom_forward, init_gom, subdivide_gom
from gomavatar_tpu_torch.optim import (
    apply_updates,
    fast_forward_schedule,
    make_optimizer,
    tree_leaves,
    tree_unflatten,
)
from gomavatar_tpu_torch.ops.splat.binning import CHUNK
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX

log = logging.getLogger(__name__)

# fail on any binning-budget overflow (reads the counters: a device sync per
# step; debugging only)
_DEBUG_BINNING = bool(int(os.environ.get("GOMAVATAR_DEBUG_BINNING", "0")))


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
        self.lpips_params = lpips_params
        self.lpips_calibrated = lpips_calibrated
        self.subdivide_iters = sorted(cfg["model"].get("subdivide_iters", []))
        self.device = torch.device(device)
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
        if self.group is None:
            self._step_fn = make_train_step(self.gom_cfg, self.loss_cfg, self.tx)
        else:
            from gomavatar_tpu_torch.parallel.step import make_data_parallel_train_step

            self._step_fn = make_data_parallel_train_step(self.group, self.gom_cfg, self.loss_cfg, self.tx)

    def _subdivide(self):
        log.info("subdividing at iter %d: %d -> %d faces", self.i_iter, self.gom_cfg.num_faces,
                 self.gom_cfg.num_faces * 4)
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
        form of JAX's ``step`` over a list of ``data_parallel`` frames."""
        self.maybe_subdivide()
        self.params, self.opt_state, total, losses = self._step_fn(
            self.params, self.opt_state, self.statics, self.lpips_params, batch, float(self.i_iter)
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
        return total, losses

    def forward(self, batch: dict, train: bool = False):
        with torch.set_grad_enabled(train):
            return gom_forward(
                self.params, self.statics, self.gom_cfg, batch["K"], batch["E"], batch["cnl_gtfms"],
                batch["dst_Rs"], batch["dst_Ts"], dst_posevec=batch.get("dst_posevec"), i_iter=float(self.i_iter),
                global_R=batch.get("global_R"), global_T=batch.get("global_T"), train=train, device=self.device,
            )

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

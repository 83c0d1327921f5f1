"""Where the time of the port's train step goes, on the card.

Runs ``Trainer.step`` on the trained avatar at 512^2 (its train config, the
optimizer fast-forwarded to its iteration, the packed frame with the port's
own eval render as target), eagerly (``trainer.make_train_step``) and as
the trainer's program (one captured CUDA graph, replayed), and reports,
after a warm-up:
  * the whole step, each way, host clock around a synchronised call
    (median, p90);
  * the step's stages, each timed on the host clock with a synchronise
    before and after it (median): ``gom_forward(train=True)``, the loss
    without LPIPS, LPIPS alone, the backward, the Adam update;
  * for each way, torch.profiler's device time by kernel over a steady
    window of steps, the kernels per step, and the device's busy share:
    kernel time over the unprofiled step's time (the profiler's own host
    cost slows the profiled window).
The first line names the card and its power limit.

    python -m gomavatar_tpu_torch.profile_train [--iters 10] [--json profile_train.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from gomavatar_tpu_torch.convert import load_trained_state
from gomavatar_tpu_torch.losses import compute_loss, unpack
from gomavatar_tpu_torch.models import gom as G
from gomavatar_tpu_torch.models.lpips import load_lpips
from gomavatar_tpu_torch.optim import apply_updates, tree_leaves, tree_unflatten
from gomavatar_tpu_torch.scene import trained_train_cfg
from gomavatar_tpu_torch.profile_eval import card_name, measure, report
from gomavatar_tpu_torch.trainer import Trainer, make_train_step


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def stage_times(trainer: Trainer, batch: dict, iters: int) -> dict:
    """The train step's stages, composed here one by one as
    ``trainer.make_train_step`` composes them (the update is not kept)."""
    loss_cfg = dict(trainer.loss_cfg)
    no_lpips = dict(loss_cfg, lpips={"coeff": 0.0})
    dev = trainer.device
    bg = torch.as_tensor(batch["bgcolor"], device=dev)
    res: dict[str, list] = {k: [] for k in ("forward", "loss_without_lpips", "lpips", "backward", "adam")}
    for _ in range(iters):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(trainer.params)]
        params = tree_unflatten(trainer.params, leaves)
        ms, (rgb, mask, aux) = _timed(lambda: G.gom_forward(
            params, trainer.statics, trainer.gom_cfg, batch["K"], batch["E"], batch["cnl_gtfms"], batch["dst_Rs"],
            batch["dst_Ts"], dst_posevec=batch["dst_posevec"], i_iter=float(trainer.i_iter), train=True,
            device=dev))
        res["forward"].append(ms)

        def loss(cfg, lpips_params):
            return compute_loss(unpack(rgb, mask, bg), mask, aux, batch["target_rgbs"], batch["target_masks"],
                                trainer.statics, cfg, lpips_params=lpips_params)[0]

        ms, base = _timed(lambda: loss(no_lpips, None))
        res["loss_without_lpips"].append(ms)
        ms, l_lpips = _timed(lambda: loss(dict(loss_cfg, rgb={"coeff": 0.0}, mask={"coeff": 0.0},
                                               laplacian={"coeff_canonical": 0.0, "coeff_observation": 0.0},
                                               normal={"coeff_mask": 0.0, "coeff_consist": 0.0},
                                               color_consist={"coeff": 0.0}), trainer.lpips_params))
        res["lpips"].append(ms)
        ms, grads = _timed(lambda: torch.autograd.grad(base + l_lpips, leaves, allow_unused=True))
        res["backward"].append(ms)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]

        def adam():
            updates, _ = trainer.tx.update(grads, trainer.opt_state)
            with torch.no_grad():
                return apply_updates(tree_unflatten(trainer.params, [p.detach() for p in leaves]), updates)

        ms, _ = _timed(adam)
        res["adam"].append(ms)
    return {k: statistics.median(v) for k, v in res.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json", default=None, help="also write the numbers to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card; no CUDA device is present")
    card = card_name()
    state, frame = load_trained_state(device="cuda")
    params, statics, cfg = state[:3]
    rgb, mask, _ = G.eval_forward(params, statics, cfg, frame["K"], frame["E"], frame["cnl_gtfms"], frame["dst_Rs"],
                                  frame["dst_Ts"], frame["dst_posevec"])
    bg = torch.zeros(3, device="cuda")
    batch = dict(frame, bgcolor=bg, target_rgbs=unpack(rgb, mask, bg, clamp=True), target_masks=mask)
    trainer = Trainer(trained_train_cfg(), lpips_params=load_lpips(device="cuda")[0], device="cuda", state=state)
    # the eager step from the trainer's state, its result dropped: the state
    # does not move
    eager_step = make_train_step(trainer.gom_cfg, trainer.loss_cfg, trainer.tx)
    i_iter = torch.full((), float(trainer.i_iter), device="cuda")
    ways = {
        "eager": lambda: eager_step(trainer.params, trainer.opt_state, trainer.statics, trainer.lpips_params, batch,
                                    i_iter),
        "captured": lambda: trainer.step(batch),
    }
    measured = {k: measure(fn, args.iters) for k, fn in ways.items()}
    stages = stage_times(trainer, batch, args.iters)

    print(f"card: {card}")
    for k, m in measured.items():
        report(f"train step, {k}", m, "step", 30 if k == "eager" else 12)
    for name, ms in stages.items():
        print(f"  stage {name:20s} {ms:8.3f} ms")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card, **measured, "stages_ms": stages}, fh, indent=1)


if __name__ == "__main__":
    main()

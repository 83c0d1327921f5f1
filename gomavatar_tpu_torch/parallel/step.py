"""The data-parallel train step and the multi-scene render over a rank group
(port of gomavatar_tpu/parallel/step.py).

* ``make_data_parallel_train_step``: one avatar trained on one frame per
  rank per optimizer step.  It is ``trainer.make_train_step`` with one
  collective between the backward and Adam: every gradient leaf and loss
  term packed into one float32 buffer, one all-reduce (SUM) over the ranks,
  a division by the world size (JAX's ``pmean`` of grads, total and
  losses).  Adam then runs identically on every rank, so the replicas stay
  bit-equal; at world 1 the step is bit-equal to ``make_train_step``'s.
  ``make_mean_gradient_step`` is its plain version in one process, over a
  list of frames, which the tests and the chip smoke hold it to.
* ``rank_items``: which frame of an epoch's order goes to which rank: rank r
  takes item g * world + r of step g, as JAX's driver groups consecutive
  items (item k of a group on device k); an epoch's leftover items are
  dropped.  JAX's ``stack_batches`` has no counterpart: each rank takes its
  own item.
* ``render_scenes``: n scenes rendered in turn through ``gom_forward``
  (the eval forward) in one process; ``make_multi_scene_render``: n scenes
  over the ranks, each rank running ``render_scenes`` on its contiguous
  block of n / world, the frames gathered in scene order.
"""

from __future__ import annotations

import torch

from gomavatar_tpu_torch.data.dataset import to_device
from gomavatar_tpu_torch.models.gom import GoMConfig, gom_forward
from gomavatar_tpu_torch.optim import apply_updates
from gomavatar_tpu_torch.parallel.mesh import RankGroup, all_gather_cat, all_reduce_sum


def pack_terms(grads: list, total: torch.Tensor, losses: dict) -> torch.Tensor:
    """One flat float32 buffer of every gradient leaf, the total and every
    loss term (the binning's drop counters included)."""
    return torch.cat([g.reshape(-1).float() for g in grads] + [total.reshape(1).float()]
                     + [v.reshape(1).float() for v in losses.values()])


def unpack_terms(buf: torch.Tensor, grads: list, losses: dict):
    """(grads, total, losses) of a buffer :func:`pack_terms` made, shaped as
    ``grads`` and keyed as ``losses``; the loss terms come back float32."""
    parts = torch.split(buf, [g.numel() for g in grads] + [1] * (1 + len(losses)))
    out = [p.view(g.shape).to(g.dtype) for p, g in zip(parts, grads)]
    total = parts[len(grads)].reshape(())
    return out, total, {k: p.reshape(()) for k, p in zip(losses, parts[len(grads) + 1:])}


def mean_over_ranks(group: RankGroup):
    """The step's reducer: (grads, total, losses) -> their means over the
    ranks, by one all-reduce."""

    def reduce(grads, total, losses):
        buf = all_reduce_sum(group, pack_terms(grads, total, losses))
        return unpack_terms(buf / group.world, grads, losses)

    return reduce


def make_data_parallel_train_step(group: RankGroup, gom_cfg: GoMConfig, loss_cfg: dict, tx):
    """The train step of one rank: (params, opt_state, statics, lpips_params,
    this rank's batch, i_iter) -> (params, opt_state, total, losses), the
    gradients and losses averaged over the ranks before Adam."""
    from gomavatar_tpu_torch.trainer import make_train_step

    return make_train_step(gom_cfg, loss_cfg, tx, reduce=mean_over_ranks(group))


def make_mean_gradient_step(gom_cfg: GoMConfig, loss_cfg: dict, tx):
    """Plain version of the data-parallel step in one process: (params,
    opt_state, statics, lpips_params, batches, i_iter), the packed terms of
    the frames summed in order and divided by their number, then Adam."""
    from gomavatar_tpu_torch.trainer import loss_and_grads

    def step(params, opt_state, statics, lpips_params, batches, i_iter):
        terms = [loss_and_grads(params, statics, gom_cfg, loss_cfg, lpips_params, b, i_iter) for b in batches]
        buf = pack_terms(*terms[0])
        for t in terms[1:]:
            buf = buf + pack_terms(*t)
        grads, total, losses = unpack_terms(buf / len(batches), terms[0][0], terms[0][2])
        updates, opt_state = tx.update(grads, opt_state)
        with torch.no_grad():
            params = apply_updates(params, updates)
        return params, opt_state, total, losses

    return step


def rank_items(order, world: int, rank: int) -> list:
    """Rank ``rank``'s items of an epoch's ``order``: item g * world + rank
    for each full group g; the leftover items are dropped."""
    order = list(order)
    return order[: len(order) // world * world][rank::world]


def render_scenes(packs, items, device):
    """The eval forward of each scene on its frame, in turn: (rgb (n, H, W,
    3), mask (n, H, W)); ``packs`` the scenes' (params, statics, cfg) on
    ``device``, ``items`` their frames (numpy items)."""
    rgbs, masks = [], []
    for (params, statics, gom_cfg), item in zip(packs, items):
        batch = to_device(item, device)
        with torch.no_grad():
            rgb, mask, _ = gom_forward(
                params, statics, gom_cfg, batch["K"], batch["E"], batch["cnl_gtfms"], batch["dst_Rs"],
                batch["dst_Ts"], dst_posevec=batch.get("dst_posevec"), i_iter=1e7, device=device,
            )
        rgbs.append(rgb)
        masks.append(mask)
    return torch.stack(rgbs), torch.stack(masks)


def make_multi_scene_render(group: RankGroup):
    """``render(packs, items) -> (rgb (n, H, W, 3), mask (n, H, W))`` on
    every rank, as :func:`render_scenes` gives it in one process: rank r
    renders scenes [r n / world, (r + 1) n / world) through
    :func:`render_scenes` and the blocks are gathered in rank order (n must
    divide over the ranks, as JAX asserts)."""

    def render(packs, items):
        n = len(packs)
        if n % group.world or len(items) != n:
            raise ValueError(f"{n} scenes ({len(items)} frames) do not divide onto {group.world} ranks")
        lo, hi = group.rank * n // group.world, (group.rank + 1) * n // group.world
        rgb, mask = render_scenes(packs[lo:hi], items[lo:hi], group.device)
        return all_gather_cat(group, rgb), all_gather_cat(group, mask)

    return render

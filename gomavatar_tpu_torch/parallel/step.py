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
* ``make_data_parallel_program``: that step as the rank's program
  (``programs.RankProgram``), the counterpart of JAX's jitted ``shard_map``
  and what ``Trainer(group=...)`` steps through: ``pre`` the backward and
  the packing, the all-reduce, ``post`` the division, the unpacking and
  Adam into the program's buffers.  Over NCCL one captured CUDA graph, over
  gloo on CUDA two graphs with the all-reduce on the host between their
  replays, on CPU tensors eagerly.
* ``rank_items``: which frame of an epoch's order goes to which rank: rank r
  takes item g * world + r of step g, as JAX's driver groups consecutive
  items (item k of a group on device k); an epoch's leftover items are
  dropped.  JAX's ``stack_batches`` has no counterpart: each rank takes its
  own item.
* ``render_in_turn``: n scenes rendered in turn in one process, each
  through its own eval program (``models.gom.eval_program``: a captured
  graph on the card); ``make_multi_scene_render``: n scenes over the ranks,
  each rank running ``render_in_turn`` on its contiguous block of n /
  world, the frames gathered in scene order by one all-gather per output
  outside the graphs (JAX's jit covers its gather too).
"""

from __future__ import annotations

import torch

from gomavatar_tpu_torch.data.dataset import to_device
from gomavatar_tpu_torch.models.gom import GoMConfig, GoMStatics, eval_program
from gomavatar_tpu_torch.optim import apply_updates
from gomavatar_tpu_torch.parallel.mesh import RankGroup, all_gather_cat, all_reduce_sum
from gomavatar_tpu_torch.programs import RankProgram


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


def make_data_parallel_program(group: RankGroup, gom_cfg: GoMConfig, loss_cfg: dict, tx, statics: GoMStatics,
                               lpips_params) -> RankProgram:
    """:func:`make_data_parallel_train_step` as the rank's program, called
    as ``trainer.make_program_step``'s step is: (params, opt_state, batch,
    i_iter) -> (params, opt_state, total, losses), the new state written
    into the program's buffers and returned.  The statics and the LPIPS
    trunk are read where they lie, as there."""
    from gomavatar_tpu_torch.trainer import loss_and_grads, update_in_place

    def pre(params, opt_state, batch, i_iter):
        grads, total, losses = loss_and_grads(params, statics, gom_cfg, loss_cfg, lpips_params, batch, i_iter)
        # grads and losses ride along for their shapes and names
        return pack_terms(grads, total, losses), (grads, losses)

    def post(summed, like, params, opt_state, batch, i_iter):
        grads, total, losses = unpack_terms(summed / group.world, *like)
        update_in_place(tx, params, opt_state, grads)
        return params, opt_state, total, losses

    return RankProgram(group, pre, all_reduce_sum, post)


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


def render_in_turn(n: int, device):
    """``render(packs, items) -> (rgb (n, H, W, 3), mask (n, H, W))``: the
    eval forward of each scene on its frame, in turn, each scene through its
    own eval program (a program's outputs are overwritten by its next
    call); ``packs`` the scenes' (params, statics, cfg) on ``device``,
    ``items`` their frames (numpy items)."""
    programs = [eval_program() for _ in range(n)]

    def render(packs, items):
        rgbs, masks = [], []
        for prog, (params, statics, gom_cfg), item in zip(programs, packs, items):
            b = to_device(item, device)
            rgb, mask, _ = prog(params, statics, gom_cfg, b["K"], b["E"], b["cnl_gtfms"], b["dst_Rs"], b["dst_Ts"],
                                b.get("dst_posevec"), 1e7, None, None)
            rgbs.append(rgb)
            masks.append(mask)
        return torch.stack(rgbs), torch.stack(masks)

    return render


def make_multi_scene_render(group: RankGroup):
    """``render(packs, items) -> (rgb (n, H, W, 3), mask (n, H, W))`` on
    every rank, as :func:`render_in_turn` gives it in one process: rank r
    renders scenes [r n / world, (r + 1) n / world) through
    :func:`render_in_turn` (its programs made at the first call) and the
    blocks are gathered in rank order (n must divide over the ranks, as JAX
    asserts)."""
    block = []

    def render(packs, items):
        n = len(packs)
        if n % group.world or len(items) != n:
            raise ValueError(f"{n} scenes ({len(items)} frames) do not divide onto {group.world} ranks")
        lo, hi = group.rank * n // group.world, (group.rank + 1) * n // group.world
        if not block:
            block.append(render_in_turn(hi - lo, group.device))
        rgb, mask = block[0](packs[lo:hi], items[lo:hi])
        return all_gather_cat(group, rgb), all_gather_cat(group, mask)

    return render

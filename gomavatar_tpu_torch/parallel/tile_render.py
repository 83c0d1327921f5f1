"""The eval frame's active tiles split over a rank group (port of
gomavatar_tpu/parallel/tile_render.py).

Every rank prepares the frame in full (geometry, the per-face shadow MLP,
the sorted binning and the entry gather: ``models.gom.frame_table_and_bins``
and ``ops.frame_render.gather_entries``, as ``render_frame_eval`` does).
Kernel B1 then sweeps only the rank's contiguous share of the
``active_tile_cap`` slots, [r A / n, (r + 1) A / n), with its local count
of active slots ``clamp(n_active - r A / n, 0, A / n)`` computed on the
device (no host read).  The compact rgb, alpha and selection are gathered
in slot order (packed along the channels into one tensor: one all-gather)
and untiled and shaded as ``render_frame_sorted`` does, so the frame equals
the one-rank render.

The render is the rank's program (``programs.RankProgram``), the
counterpart of JAX's jitted ``shard_map``: ``pre`` the preparation and B1
on the share, the all-gather, ``post`` the untiling and shading.  Over
NCCL one captured CUDA graph, over gloo on CUDA two graphs with the
all-gather on the host between their replays, on CPU tensors eagerly.

On the card B1 leaves a slot at or above its local count unwritten: the
gathered buffers hold garbage in those rows, which ``untile`` never reads.
"""

from __future__ import annotations

import torch

from gomavatar_tpu_torch.models.gom import eval_aux, frame_table_and_bins
from gomavatar_tpu_torch.ops.frame_render import compose_frame, frame_sweep, gather_entries
from gomavatar_tpu_torch.ops.splat.binning import SortedBinning
from gomavatar_tpu_torch.parallel.mesh import RankGroup, all_gather_cat
from gomavatar_tpu_torch.programs import RankProgram


def shard_slots(bins: SortedBinning, rank: int, world: int):
    """(active_id, seg_start, seg_count, n_local) of rank ``rank``'s share of
    the slots: contiguous int32 views, and the count of active slots among
    them as a device scalar."""
    A = bins.active_id.shape[0]
    if A % world:
        raise ValueError(f"active_tile_cap {A} does not divide onto {world} ranks")
    local = A // world
    lo = rank * local
    n_local = torch.clamp(bins.n_active - lo, 0, local).to(torch.int32)
    sl = slice(lo, lo + local)
    return bins.active_id[sl], bins.seg_start[sl], bins.seg_count[sl], n_local


def make_tile_parallel_render(group: RankGroup, cfg, statics, with_normal: bool = False) -> RankProgram:
    """``render(params, verts_obs, colors, K, E) -> (rgb, alpha[, normal,
    hit], aux)`` on every rank, as ``models.gom.render_frame_eval`` returns
    it, with B1 run on this rank's share of the slots.  The outputs are the
    program's, overwritten by its next call."""
    if cfg.active_tile_cap % group.world:
        raise ValueError(f"active_tile_cap {cfg.active_tile_cap} does not divide onto {group.world} ranks")
    with_mesh = cfg.shadow is not None or with_normal
    channels = [3, 1, 5] if with_mesh else [3, 1]  # rgb, alpha[, sel]

    def pre(params, verts_obs, colors, K, E):
        table, bins, shading0 = frame_table_and_bins(params, statics, cfg, verts_obs, colors, K, E)
        entries = gather_entries(table, bins)
        compact = frame_sweep(entries, *shard_slots(bins, group.rank, group.world), bins.num_tiles_x,
                              with_mesh=with_mesh)
        return torch.cat([c for c in compact if c is not None], dim=1), (bins, shading0)

    def post(gathered, carry, *args):
        bins, shading0 = carry
        compact = list(torch.split(gathered, channels, dim=1)) + [None] * (3 - len(channels))
        return compose_frame(compact, bins, cfg.img_size, shading0, with_normal) + (eval_aux(bins),)

    return RankProgram(group, pre, all_gather_cat, post)

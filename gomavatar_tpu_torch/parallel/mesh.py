"""The rank group (port of gomavatar_tpu/parallel/mesh.py).

JAX drives every device of a ``Mesh`` from one process.  Here each rank is
a process of its own, joined to the others by ``torch.distributed``: the
port's steps are host-bound (thousands of launches each), so one process
driving n cards would issue every card's launches in turn, and only a
process per card lets n cards run n times as fast.  ``shard_map`` with
``pmean`` / ``all_gather`` becomes rank-local code with explicit
collectives, the two of this module, each counted in its ``calls`` (a
captured program's replay ticks them too: ``programs.RankProgram``).

A group's backend follows its device, NCCL for CUDA and gloo for the CPU,
unless the caller names one (gloo lets several ranks share one card).  A
rank's store is a file, so no network is involved.  ``spawn`` starts one
process per entry of ``devices`` (the ``spawn`` start method: a forked
child cannot use a CUDA context its parent made) and returns what each
rank's function returned; a rank that raises ends the run with its
traceback, and the others are stopped.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

# A rank waits in the next step's all-reduce while rank 0 logs, saves and
# evaluates: the group's timeout must outlast the longest of those.
TIMEOUT = datetime.timedelta(hours=2)


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """One rank's view of its group."""

    rank: int
    world: int
    device: torch.device
    backend: str
    pg: object  # the torch.distributed process group


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(rank: int, world: int, init_file: str, device, backend: str | None = None) -> RankGroup:
    """Join this process to the group of ``world`` ranks that meet at the
    file ``init_file`` (which must not exist before the group's first rank
    starts) as ``rank``, on ``device``, over ``backend`` (by default
    :func:`default_backend`)."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or default_backend(device)
    dist.init_process_group(backend, init_method=f"file://{os.path.abspath(init_file)}", rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return RankGroup(rank, world, device, backend, dist.group.WORLD)


def close_group(group: RankGroup) -> None:
    dist.destroy_process_group(group.pg)


def all_reduce_sum(group: RankGroup, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place (``ReduceOp.SUM``: ``AVG`` is not
    on every backend)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)
    all_reduce_sum.calls += 1
    return t


def all_gather_cat(group: RankGroup, t: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order, on every
    rank: gathered into ``out`` when it is given, else into one new
    tensor."""
    t = t.contiguous()
    if out is None:
        out = t.new_empty((group.world * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group.pg)
    all_gather_cat.calls += 1
    return out


def barrier(group: RankGroup) -> None:
    dist.barrier(group=group.pg)


all_reduce_sum.calls = 0
all_gather_cat.calls = 0


def _rank_main(rank, fn, devices, backend, tmp, args):
    device = torch.device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(1)
    group = init_group(rank, len(devices), os.path.join(tmp, "store"), device, backend)
    out = fn(group, *args)
    close_group(group)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def spawn(fn, devices, *args, backend: str | None = None) -> list:
    """Run ``fn(group, *args)`` on one new process per entry of ``devices``
    (rank r on ``devices[r]``), all in one group over ``backend``, and
    return their results in rank order.  ``fn`` must be importable by name
    (a module-level function) and its arguments and result picklable; a
    result travels through a file (``torch.save``), so tensors in it should
    be on the CPU.  A CPU rank runs on one torch thread."""
    devices = [str(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="gom_ranks_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, devices, backend, tmp, args), nprocs=len(devices), join=True,
            start_method="spawn",
        )
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(len(devices))]

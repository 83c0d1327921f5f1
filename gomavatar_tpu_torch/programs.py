"""One-program steps: what ``jax.jit`` gives the JAX package's train step,
pose-refinement scan and eval forward (trace once, run as one program),
here by CUDA graph capture and replay.

``Program(fn)`` wraps a step function over pytrees of tensors (dicts,
lists, tuples and NamedTuples of tensors in, the same out).  Its leaves:

* tensors and numpy arrays are inputs: the program owns a buffer for each,
  and every call copies the argument into it (non-blocking), unless the
  argument is that buffer;
* Python floats are inputs too: a 0-d float32 buffer on the program's
  device, filled on every call (so an iteration number reaches the step as a
  device tensor, never as a constant), interchangeable with a 0-d float32
  tensor;
* every other leaf (None, bools, ints, strings, a frozen config) is static:
  part of the cache key and passed through as it is.

The cache is keyed as jit's is: the pytree's structure, its static leaves
and every input's shape and dtype.  A new key captures a new program.

On CUDA tensors the first call of a key warms ``fn`` up on a side stream
(three calls, so that autograd, cuDNN's algorithm choice and the caching
allocator settle; the input buffers are put back after each, since a step
may write its state into its inputs), then captures one call into a
``torch.cuda.CUDAGraph`` with a memory pool of its own (PyTorch's
whole-network capture), and every call replays that graph.  A failed
capture raises: nothing carries on eagerly.  On CPU tensors the same
protocol runs ``fn`` eagerly over the buffers, as each kernel wrapper runs
its plain version there.

The outputs are the program's static tensors on both paths: the next call
of the same key overwrites them, so a caller that keeps a value past the
next call clones it.  Outputs that are input buffers (a state the step
updates in place) are returned as those buffers.  ``last_args`` holds the
last call's buffers as an argument tree: a loop that calls the program
with them again copies nothing.

Launch counts: the kernel wrappers count a launch when they enqueue it, and
the collectives of ``parallel.mesh`` count their calls; a replay enqueues
without either.  So the program takes back the counts of its set-up
(warm-up and capture, as jit's trace is set-up) and keeps those of the
captured call, which it adds to the counters on every replay.

``RankProgram(group, pre, collective, post)`` is one rank's step over a
``parallel.RankGroup``, the counterpart of a jitted ``shard_map``: the
function ``post(collective(group, send), carry, *args)`` with ``(send,
carry) = pre(*args)``, one all-reduce or all-gather between two parts of
device work.  Its form follows from the group's backend when it is built:

* NCCL (one card per rank): ``pre``, the collective and ``post`` captured
  as one graph, after the warm-up has created the communicator;
* gloo on CUDA tensors (ranks sharing a card): a gloo collective cannot be
  captured, so ``pre`` and ``post`` are two graphs (one memory pool), and
  the collective runs on the host between their replays, on ``pre``'s
  static output, once per call;
* CPU tensors: the same function eagerly over the program's buffers.

Spans and counters (``utils.profiling``; recorded only while a profiler
session or a ``recording()`` block is open), each with the program's call
count as its id: ``program.call`` around a whole call (with the function's
``__qualname__``), and inside it ``program.capture`` (a new key: its buffers,
warm-up and capture), ``program.load`` (the arguments copied into the
buffers) and ``program.launch`` (the replay and the counters' ticks, or on
CPU tensors the eager call); on the gloo form of ``RankProgram``
``program.collective`` around the host collective.  All of them are host
work around the captured function, never inside it.

torch.profiler and captured graphs: on an H100 with torch 2.11 and CUDA
12.8, where the profiler keeps CUPTI set up between its sessions (the
default), a profiled replay of a graph segfaulted in ``CUDAGraph.replay``
in 6 to 9 of 10 processes once that process had run several profiler
sessions and captured graphs after them; with CUPTI torn down at the end
of each session (``TEARDOWN_CUPTI=1``) in none of 10.  This module sets
that when it is imported, before any profiler session of a process that
captures graphs, unless the process set it already.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gomavatar_tpu_torch.utils.profiling import span

os.environ.setdefault("TEARDOWN_CUPTI", "1")

WARMUP_CALLS = 3


def kernel_wrappers() -> dict:
    """The counted wrapper of every kernel launch, by name: each holds its
    ``launches``."""
    from gomavatar_tpu_torch.models import lpips as LP
    from gomavatar_tpu_torch.ops import frame_render as FR
    from gomavatar_tpu_torch.ops import mesh_raster_pallas as MK
    from gomavatar_tpu_torch.ops.splat import pallas_kernel as SK

    return {"B1a": FR.frame_partials, "B1b": FR.frame_merge, "B2a": SK.splat_fwd_partials,
            "B2b": SK.splat_fwd_merge, "B3a": SK.splat_bwd_partials, "B3b": SK.splat_bwd_grads,
            "B4a": MK.mesh_fwd_partials, "B4b": MK.mesh_fwd_merge, "B5": MK.mesh_bwd, "lpips_head": LP.lpips_head}


def _counters() -> dict:
    """Every counter a replay must tick, by name: (holder, attribute) of
    each kernel wrapper's ``launches`` and each collective's ``calls``."""
    from gomavatar_tpu_torch.parallel import mesh

    out = {k: (w, "launches") for k, w in kernel_wrappers().items()}
    out.update(all_reduce=(mesh.all_reduce_sum, "calls"), all_gather=(mesh.all_gather_cat, "calls"))
    return out


def _counts() -> dict:
    return {k: getattr(h, a) for k, (h, a) in _counters().items()}


def _set_counts(counts: dict) -> None:
    for k, (h, a) in _counters().items():
        setattr(h, a, counts[k])


def _tick(delta: dict) -> None:
    counters = _counters()
    for k, n in delta.items():
        h, a = counters[k]
        setattr(h, a, getattr(h, a) + n)


def _capture_graph(fn, pool=None):
    """(graph, outputs, counts per replay) of ``fn()`` captured into a new
    CUDA graph (in ``pool`` when given).  The capture is thread-local: other
    threads go on with their own CUDA work meanwhile (the train data's
    threads, which launch and allocate on their own stream: data/dataset.py;
    ProcessGroupNCCL's watchdog, which queries its works' events), which
    under the "global" mode would invalidate it."""
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    after = _counts()
    return graph, out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


# ---- pytrees ---------------------------------------------------------------------

_TENSOR = "tensor"


def _flatten(x, leaves: list):
    """The structure of ``x`` (hashable), its input leaves appended to
    ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, np.ndarray):
        leaves.append(torch.from_numpy(np.ascontiguousarray(x)))
        return _TENSOR
    if isinstance(x, (float, np.floating)):
        leaves.append(float(x))
        return _TENSOR
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    return ("static", x)


def _unflatten(spec, it):
    if spec == _TENSOR:
        return next(it)
    kind, body = spec
    if kind == "static":
        return body
    if kind is dict:
        return {k: _unflatten(s, it) for k, s in body}
    children = [_unflatten(s, it) for s in body]
    if kind is list:
        return children
    return kind(*children) if hasattr(kind, "_fields") else kind(children)


def _tensor_leaves(tree) -> list:
    """Every tensor of a pytree, in the program's order."""
    leaves: list = []
    _flatten(tree, leaves)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


# ---- the program -----------------------------------------------------------------


class _Captured:
    """One key's buffers, graphs (none on the CPU), static outputs and
    counts per call."""

    def __init__(self, spec, leaves: list, device: torch.device):
        with torch.no_grad():
            self.bufs = [
                torch.full((), x, dtype=torch.float32, device=device) if isinstance(x, float)
                else torch.empty_like(x, device=device).copy_(x)
                for x in leaves
            ]
        self.args = _unflatten(spec, iter(self.bufs))
        self.graphs: list = []
        self.out = None
        self.launches: dict = {}

    @torch.no_grad()
    def load(self, leaves: list) -> None:
        """Copy the call's arguments into the buffers (none where the
        argument is the buffer)."""
        same_dev, other = ([], []), []
        for b, x in zip(self.bufs, leaves):
            if isinstance(x, float):
                b.fill_(x)
            elif x is not b and not (x.data_ptr() == b.data_ptr() and x.stride() == b.stride()):
                if x.device == b.device:
                    same_dev[0].append(b)
                    same_dev[1].append(x)
                else:
                    other.append((b, x))
        if same_dev[0]:
            torch._foreach_copy_(same_dev[0], same_dev[1], non_blocking=True)
        for b, x in other:
            b.copy_(x, non_blocking=True)


class Program:
    """``fn`` run as one program per key (see the module docstring):
    ``Program(fn)(*args)`` returns ``fn(*args)``'s outputs as the program's
    static tensors, which the next call overwrites."""

    def __init__(self, fn):
        self.fn = fn
        self._cache: dict = {}
        self.captures = 0  # keys seen so far: on CUDA tensors, graphs captured
        self.calls = 0
        self.name = getattr(fn, "__qualname__", type(fn).__name__)
        self.last_args = None

    def pool_bytes(self) -> int:
        """Device memory reserved by the memory pools of this program's
        graphs (0 on the CPU): what keeps every activation of a captured
        step alive between its replays."""
        pools = {tuple(g.pool()) for cap in self._cache.values() for g in cap.graphs}
        if not pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)

    def __call__(self, *args):
        self.calls += 1
        with span("program.call", self.calls, fn=self.name):
            leaves: list = []
            spec = _flatten(args, leaves)
            tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
            device = next((t.device for t in tensors if t.is_cuda), torch.device("cpu"))
            key = (spec, device,
                   tuple(((), torch.float32) if isinstance(x, float) else (tuple(x.shape), x.dtype) for x in leaves))
            cap = self._cache.get(key)
            fresh = cap is None
            if fresh:
                with span("program.capture", self.calls):
                    cap = self._cache[key] = _Captured(spec, leaves, device)
                    self.captures += 1
                    self.last_args = cap.args
                    if device.type == "cuda":
                        try:
                            self._capture(cap, device)
                        except BaseException:
                            del self._cache[key]
                            raise
            else:
                with span("program.load", self.calls):
                    cap.load(leaves)
                self.last_args = cap.args
            with span("program.launch", self.calls):
                if device.type == "cuda":
                    self._replay(cap)
                elif fresh:
                    cap.out = self.fn(*cap.args)
                else:
                    self._copy_out(cap, self.fn(*cap.args))
            return cap.out

    def _replay(self, cap: _Captured) -> None:
        cap.graphs[0].replay()
        _tick(cap.launches)

    @staticmethod
    @torch.no_grad()
    def _copy_out(cap: _Captured, out) -> None:
        dst, src = _tensor_leaves(cap.out), _tensor_leaves(out)
        pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])

    def _warm_up(self, cap: _Captured, device: torch.device) -> None:
        """WARMUP_CALLS calls of ``fn`` on a side stream, the input buffers
        put back after each."""
        with torch.no_grad():
            saved = [b.clone() for b in cap.bufs]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(*cap.args)
                if saved:
                    with torch.no_grad():
                        torch._foreach_copy_(cap.bufs, saved)
        torch.cuda.current_stream(device).wait_stream(side)

    def _capture(self, cap: _Captured, device: torch.device) -> None:
        counts0 = _counts()
        self._warm_up(cap, device)
        graph, cap.out, cap.launches = _capture_graph(lambda: self.fn(*cap.args))
        cap.graphs = [graph]
        _set_counts(counts0)


class RankProgram(Program):
    """One rank's step over ``group`` as one program (see the module
    docstring): ``pre(*args) -> (send, carry)`` and ``post(recv, carry,
    *args) -> outputs`` are device work, ``collective(group, send) -> recv``
    is ``parallel.all_reduce_sum`` (in place) or ``parallel.all_gather_cat``
    (which gathers into its ``out`` when it is given).  The program keeps
    ``Program``'s contract: buffers per input, a cache keyed as jit's is,
    static outputs, ``last_args``, and the counters ticked per call (the
    collective's too)."""

    def __init__(self, group, pre, collective, post):
        super().__init__(self._run)
        self.group, self.pre, self.collective, self.post = group, pre, collective, post
        # the form, fixed here: one graph around an NCCL collective, two
        # graphs around a host collective otherwise (gloo)
        self.one_graph = group.backend == "nccl"

    def _run(self, *args):
        send, carry = self.pre(*args)
        return self.post(self.collective(self.group, send), carry, *args)

    def _capture(self, cap: _Captured, device: torch.device) -> None:
        counts0 = _counts()
        # the first warm-up call's collective creates the NCCL communicator
        self._warm_up(cap, device)
        if self.one_graph:
            from gomavatar_tpu_torch.parallel.mesh import barrier

            # nothing of the warm-up pending on any rank when capture begins
            torch.cuda.synchronize(device)
            barrier(self.group)
            torch.cuda.synchronize(device)
            graph, cap.out, cap.launches = _capture_graph(lambda: self.fn(*cap.args))
            cap.graphs = [graph]
        else:
            pre, (cap.send, cap.carry), launches = _capture_graph(lambda: self.pre(*cap.args))
            # the collective's static output (pre's own output when in place),
            # made by one collective over the unreplayed buffer: every rank
            # captures at the same call
            cap.recv = self.collective(self.group, cap.send)
            post, cap.out, post_launches = _capture_graph(lambda: self.post(cap.recv, cap.carry, *cap.args),
                                                          pool=pre.pool())
            for k, n in post_launches.items():
                launches[k] = launches.get(k, 0) + n
            cap.graphs, cap.launches = [pre, post], launches
        _set_counts(counts0)

    def _replay(self, cap: _Captured) -> None:
        if self.one_graph:
            super()._replay(cap)
            return
        pre, post = cap.graphs
        pre.replay()
        # gloo orders its copies of CUDA tensors after the current stream's
        # work (pre's replay) and the current stream after them (post's)
        with span("program.collective", self.calls):
            if cap.recv is cap.send:
                self.collective(self.group, cap.send)
            else:
                self.collective(self.group, cap.send, out=cap.recv)
        post.replay()
        _tick(cap.launches)

"""Kernels B2 (splat compositing forward, in two launches B2a and B2b) and
B3 (its analytic backward, in two launches B3a and B3b) and their wrapper
(port of gomavatar_tpu/ops/splat/pallas_kernel.py).

* ``composite_tiles`` is the wrapper: on CUDA tensors it is a
  ``torch.autograd.Function`` whose forward launches B2a then B2b and whose
  backward launches B3a then B3b (``csrc/splat_composite.cu``), each
  counted in its own wrapper's ``launches``; on CPU tensors it runs the
  plain PyTorch version (``tiled_jnp.composite_tiles_plain``),
  differentiated by autograd; any other device raises.
* Entries are packed channel-major (NCH_pad, Dp) by
  :func:`pack_gaussian_channels`: mean xy, conic abc, opacity, C colors,
  zero rows up to a multiple of 8.
* B2 saves, for the backward, each pixel's transmittance at the start of
  every chunk its tile owns, or -1 once the pixel is spent
  (:func:`splat_chunk_state_plain` is its plain version).
* :func:`splat_chunk_partials_plain` and :func:`splat_split_plain` are the
  plain twins of B2's two launches (per-chunk partials from T = 1, then the
  in-order merge with its let-through margin), held to the one-pass plain
  version on the CPU and to the kernels on the card.

Source note for the kernels (details in the .cu file): they replace
gomavatar_tpu/ops/splat/pallas_kernel.py:_fwd_kernel and _bwd_kernel.  On
the H100 both are bound by arithmetic, not bytes: a 512^2 frame of the
trained avatar reads ~1.4e3 chunks (~6 MB) as ~2.4e7 live (pixel, entry)
pairs of ~30 (forward) to ~100 (backward, with its per-entry reductions)
fp32 operations.  Its tiles own up to ~14 chunks against a mean of ~6, so
every launch runs one block per chunk of the entry buffer and one thread
per pixel, and the longest segment no longer runs on one SM.  B2a sweeps
each chunk alone from T = 1; B2b re-sweeps, for each pixel, the chunk where
it is not let through, from the transmittance the earlier chunks leave, and
the last block of each tile (an atomic ticket) merges its chunks in order
and writes the state.  B3 replays nothing: B3a sums u w per pixel over its
chunk from the saved transmittance, B3b takes the suffix from the later
chunks' partials and reduces each entry's gradient over the block (a warp
fold of 16 shuffles, then shared memory), with one plain store per entry,
since every entry belongs to exactly one tile.
"""

from __future__ import annotations

import ctypes

import torch

from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE, written_slot_mask
from gomavatar_tpu_torch.ops.splat.reference import ALPHA_MAX, ALPHA_MIN, T_EPS
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, P, chunk_alpha, composite_tiles_plain, tile_pixels

MAX_COLORS = 4  # the kernels are instantiated for 1..MAX_COLORS channels


def pack_gaussian_channels(mean2d, conic, opacity, colors):
    """Per-gaussian channel matrix (N, NCH_pad): mean (2), conic (3),
    opacity (1), colors (C), zero rows up to a multiple of 8."""
    parts = [mean2d, conic, opacity[:, None], colors]
    nch = 6 + colors.shape[-1]
    nch_pad = -(-nch // 8) * 8
    if nch_pad != nch:
        parts.append(torch.zeros((mean2d.shape[0], nch_pad - nch), dtype=mean2d.dtype, device=mean2d.device))
    return torch.cat(parts, dim=-1)


def _untile(color_t, alpha_t, num_tiles_x, num_tiles_y, C):
    """(T, C, P), (T, 1, P) per-tile outputs -> (H, W, C), (H, W) images."""
    H, W = num_tiles_y * TILE, num_tiles_x * TILE
    img = color_t.reshape(num_tiles_y, num_tiles_x, C, TILE, TILE).permute(0, 3, 1, 4, 2).reshape(H, W, C)
    alpha = alpha_t.reshape(num_tiles_y, num_tiles_x, TILE, TILE).permute(0, 2, 1, 3).reshape(H, W)
    return img, alpha


def _retile(g_img, g_alpha, num_tiles_x, num_tiles_y, C):
    """The inverse layout change of :func:`_untile`, for the cotangents."""
    g_color_t = (
        g_img.reshape(num_tiles_y, TILE, num_tiles_x, TILE, C)
        .permute(0, 2, 4, 1, 3)
        .reshape(num_tiles_y * num_tiles_x, C, P)
    )
    g_alpha_t = (
        g_alpha.reshape(num_tiles_y, TILE, num_tiles_x, TILE)
        .permute(0, 2, 1, 3)
        .reshape(num_tiles_y * num_tiles_x, 1, P)
    )
    return g_color_t.contiguous(), g_alpha_t.contiguous()


def composite_plain_entries(entries, tile_start, tile_count, C, num_tiles_x, num_tiles_y, ncmax=NCMAX):
    """The plain version on packed entries: (color (T, C, P), alpha (T, 1, P))."""
    return composite_tiles_plain(
        entries[0:2].T, entries[2:5].T, entries[6 : 6 + C].T, entries[5],
        tile_start, tile_count, num_tiles_x, num_tiles_y, max_chunks=ncmax,
    )


SPENT = -1.0  # the chunk-start state of a pixel whose transmittance is spent


def splat_chunk_state_plain(entries, tile_start, tile_count, num_tiles_x, ncmax=NCMAX):
    """The plain version of B2's saved state: (Dp / CHUNK, P) f32, each
    pixel's transmittance at the start of every chunk its tile sweeps (the
    first min(count / CHUNK, ncmax) chunks of its segment), or ``SPENT``
    once an earlier entry took it below 1e-4; 0 on slots no tile owns.  The
    transmittance is the log-space sum of the plain version."""
    Dp = entries.shape[1]
    n_slots = Dp // CHUNK
    dev = entries.device
    state = torch.zeros((n_slots + 1, P), dtype=torch.float32, device=dev)  # the last row takes the rest
    tiles = torch.nonzero(tile_count > 0).flatten()
    if tiles.numel() == 0:
        return state[:n_slots]
    start, count = tile_start[tiles].long(), tile_count[tiles].long()
    nchunks = torch.clamp_max(torch.div(count, CHUNK, rounding_mode="floor"), ncmax)
    px, py = tile_pixels(tiles, num_tiles_x)
    lane = torch.arange(CHUNK, device=dev)
    log_T = torch.zeros_like(px)
    for k in range(int(nchunks.max())):
        T = torch.exp(log_T)
        slot = torch.where(k < nchunks, torch.div(start, CHUNK, rounding_mode="floor") + k, n_slots)
        state.index_copy_(0, slot, torch.where(T < T_EPS, SPENT, T))
        idx = torch.clamp_max(start + k * CHUNK, Dp - CHUNK)[:, None] + lane
        alpha = chunk_alpha(entries[0:2, idx].permute(1, 2, 0), entries[2:5, idx].permute(1, 2, 0),
                            entries[5, idx], px, py)  # (n, CHUNK, P)
        log_T = log_T + torch.log1p(-alpha).sum(dim=1)
    return state[:n_slots]


# -- B2 as two launches: per-chunk partials, then the in-order merge ------------

CROSSED = -1.0  # B2a's local T of a chunk whose sweep from T = 1 fell below 1e-4
T_THROUGH = 1.001e-4  # T_EPS (1 + 1e-3): the least T * T_k that lets a chunk through unswept


def owned_chunks(tile_start, tile_count, ncmax=NCMAX):
    """Every (slot, tile, k) a tile sweeps: chunk k of tile t is slot
    tile_start[t] / CHUNK + k, for k < min(tile_count[t] / CHUNK, ncmax).
    Returns (slot, tile, k), (m,) int64 each."""
    n = torch.clamp_max(torch.div(tile_count.long(), CHUNK, rounding_mode="floor"), ncmax)
    tile = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device), n)
    first = torch.cumsum(n, 0) - n
    k = torch.arange(tile.shape[0], device=n.device) - first[tile]
    return torch.div(tile_start[tile].long(), CHUNK, rounding_mode="floor") + k, tile, k


def sweep_chunks_plain(entries, slot, px, py, T0, C):
    """The per-entry rule of B2 and B3a over whole chunks, in the kernels'
    arithmetic (each multiply, add and subtract rounded on its own, the
    transmittance a running product): for each of the m chunks ``slot`` and
    its pixels (px, py) (m, P), from T0 (m, P) (a negative T0 sweeps
    nothing), each entry's weight T alpha while the transmittance after it
    stays >= 1e-4; the first entry that takes it below spends the pixel.
    Returns (sums (m, C + 1, P): the colour and alpha sums; T (m, P) where
    the sweep ended; stopped (m, P) bool; the (pixel, entry) pairs
    evaluated, a 0-dim tensor)."""
    e = entries[:, slot[:, None] * CHUNK + torch.arange(CHUNK, device=entries.device)]  # (NCH, m, CHUNK)
    T = T0.clone()
    done = T0 < 0
    sums = torch.zeros((slot.shape[0], C + 1, P), dtype=torch.float32, device=entries.device)
    pairs = torch.zeros((), dtype=torch.int64, device=entries.device)
    zero = torch.zeros((), dtype=torch.float32, device=entries.device)
    for j in range(CHUNK):
        r = e[:, :, j, None]  # (NCH, m, 1)
        dx, dy = px - r[0], py - r[1]
        power = -0.5 * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
        alpha = torch.where(power > 0.0, zero, torch.clamp_max(r[5] * torch.exp(power), ALPHA_MAX))
        alpha = torch.where(alpha < ALPHA_MIN, zero, alpha)
        t_next = T * (1.0 - alpha)
        pairs += (~done).sum()
        stop = ~done & (t_next < T_EPS)
        take = ~done & ~stop
        w = torch.where(take, T * alpha, zero)
        sums[:, :C] += w[:, None, :] * r[6 : 6 + C].transpose(0, 1)
        sums[:, C] += w
        T = torch.where(take, t_next, T)
        done = done | stop
    return sums, T, done & (T0 >= 0), pairs


@torch.no_grad()
def splat_chunk_partials_plain(entries, tile_start, tile_count, C, num_tiles_x, ncmax=NCMAX, stats=None):
    """Plain version of kernel B2a: (Dp / CHUNK, C + 2, P), each owned chunk
    swept alone from T = 1 with the per-entry rule: its colour sums, alpha
    sum, and local transmittance or ``CROSSED`` where the sweep fell below
    1e-4; zero on slots no tile owns.  With ``stats`` (a dict) it also
    counts ``swept_pairs``, the (pixel, entry) pairs B2a evaluates."""
    n_slots = entries.shape[1] // CHUNK
    part = torch.zeros((n_slots, C + 2, P), dtype=torch.float32, device=entries.device)
    slot, tile, _ = owned_chunks(tile_start, tile_count, ncmax)
    px, py = tile_pixels(tile, num_tiles_x)
    sums, T, stopped, pairs = sweep_chunks_plain(entries, slot, px, py, torch.ones_like(px), C)
    part[slot] = torch.cat([sums, torch.where(stopped, CROSSED, T)[:, None]], dim=1)
    if stats is not None:
        stats["swept_pairs"] = int(pairs)
    return part


@torch.no_grad()
def splat_split_plain(entries, tile_start, tile_count, C, num_tiles_x, ncmax=NCMAX, stats=None):
    """Kernel B2 as its two launches compute it, in plain PyTorch: the
    partials of :func:`splat_chunk_partials_plain` (B2a), merged per tile in
    chunk order (B2b).  A chunk that did not cross on its own and keeps
    T * T_k >= ``T_THROUGH`` adds T times its partials and T *= T_k; any
    other chunk the pixel reaches is re-swept from T with the per-entry rule
    (:func:`sweep_chunks_plain`), and the pixel is spent there or carries on
    from the re-sweep's end T.  Returns (color (T, C, P), alpha (T, 1, P),
    state (Dp / CHUNK, P)): the state is each pixel's T at the start of every
    owned chunk, ``SPENT`` from its stop on, 0 on slots no tile owns.  With
    ``stats`` (a dict) it also gives ``let_through`` (Dp / CHUNK, P) bool,
    the (chunk, pixel) pairs let through, and counts of (pixel, chunk)
    re-sweeps: ``resweeps``, ``margin`` (re-swept only for the margin: not
    crossed, T * T_k >= 1e-4), ``carries`` (ended without a stop) and
    ``own`` (after a carry, which the tile's last block of B2b does)."""
    dev = entries.device
    n_slots = entries.shape[1] // CHUNK
    part = splat_chunk_partials_plain(entries, tile_start, tile_count, C, num_tiles_x, ncmax)
    f32 = dict(dtype=torch.float32, device=dev)
    color, alpha = torch.zeros((tile_start.shape[0], C, P), **f32), torch.zeros((tile_start.shape[0], 1, P), **f32)
    state = torch.zeros((n_slots + 1, P), **f32)  # the last rows take the rest
    through_at = torch.zeros((n_slots + 1, P), dtype=torch.bool, device=dev)
    counts = dict.fromkeys(("resweeps", "margin", "carries", "own"), 0)
    nchunks = torch.clamp_max(torch.div(tile_count.long(), CHUNK, rounding_mode="floor"), ncmax)
    tiles = torch.nonzero(nchunks > 0).flatten()
    if tiles.numel():
        s0, n = torch.div(tile_start[tiles].long(), CHUNK, rounding_mode="floor"), nchunks[tiles]
        px, py = tile_pixels(tiles, num_tiles_x)
        T = torch.ones_like(px)
        alive = torch.ones_like(px, dtype=torch.bool)
        carried = torch.zeros_like(alive)
        acc = torch.zeros((tiles.shape[0], C + 1, P), **f32)
        for k in range(int(n.max())):
            slot = torch.where(k < n, s0 + k, n_slots)
            state.index_copy_(0, slot, torch.where(alive, T, SPENT))
            p = part[torch.clamp_max(slot, n_slots - 1)]
            t_k = p[:, C + 1]
            live = alive & (k < n)[:, None]
            through = live & (t_k != CROSSED) & (T * t_k >= T_THROUGH)
            through_at.index_copy_(0, slot, through)
            acc = torch.where(through[:, None], acc + T[:, None] * p[:, : C + 1], acc)
            T = torch.where(through, T * t_k, T)
            again = live & ~through
            if not bool(again.any()):
                continue
            sums, t_end, stopped, _ = sweep_chunks_plain(entries, torch.clamp_max(slot, n_slots - 1), px, py,
                                                         torch.where(again, T, SPENT), C)
            acc = acc + sums
            carry = again & ~stopped
            for key, mask in (("resweeps", again), ("margin", again & (t_k != CROSSED) & (T * t_k >= T_EPS)),
                              ("carries", carry), ("own", again & carried)):
                counts[key] += int(mask.sum())
            T = torch.where(carry, t_end, T)
            alive = alive & ~stopped
            carried = carried | carry
        color[tiles] = acc[:, :C]
        alpha[tiles, 0] = acc[:, C]
    if stats is not None:
        stats.update(counts, let_through=through_at[:n_slots])
    return color, alpha, state[:n_slots]


# -- the CUDA kernels ----------------------------------------------------------

_FWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,  # entries, nch, dp
    ctypes.c_void_p, ctypes.c_void_p,  # tile_start, tile_count
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # num_tiles, tiles_x, C, ncmax
]
_STREAM = [ctypes.c_void_p]
_B2A_ARGTYPES = _FWD_ARGTYPES + [ctypes.c_void_p] * 2 + _STREAM  # part, tickets
_B2B_ARGTYPES = _FWD_ARGTYPES + [ctypes.c_void_p] * 6 + _STREAM  # part, sweep, tickets, color, alpha, t_start
_B3A_ARGTYPES = _FWD_ARGTYPES + [ctypes.c_void_p] * 4 + _STREAM  # g_color, g_alpha, t_start, partial
_B3B_ARGTYPES = _FWD_ARGTYPES + [ctypes.c_void_p] * 5 + _STREAM  # ..., partial, d_entries


def _kernel_fns():
    """The C launchers of (B2a, B2b, B3a, B3b)."""
    from gomavatar_tpu_torch import cuda_build

    lib = cuda_build.load("splat_composite")
    fns = lib.gom_splat_fwd_partials, lib.gom_splat_fwd_merge, lib.gom_splat_bwd_partials, lib.gom_splat_bwd_grads
    for fn, argtypes in zip(fns, (_B2A_ARGTYPES, _B2B_ARGTYPES, _B3A_ARGTYPES, _B3B_ARGTYPES)):
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fns


def _check_cuda_inputs(entries, tile_start, tile_count, C):
    dev = entries.device
    if entries.dtype != torch.float32 or entries.dim() != 2 or not entries.is_contiguous():
        raise ValueError(f"entries must be a contiguous (NCH, Dp) float32 tensor, got {tuple(entries.shape)}")
    if not 1 <= C <= MAX_COLORS or entries.shape[0] < 6 + C or entries.shape[1] % CHUNK:
        raise ValueError(f"kernels B2/B3 take 1..{MAX_COLORS} colors and Dp a multiple of {CHUNK}")
    T = tile_start.shape[0]
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (T,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({T},) int32 tensor on {dev}")


def check_tensor(name, x, shape, dev, dtype=torch.float32):
    """Raise unless ``x`` is a contiguous ``shape`` tensor of ``dtype`` on ``dev``."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on {dev}")


def launch_kernel(name, fn, *args):
    """Call the C launcher ``fn`` on the current stream of the first
    argument's device, tensors passed as pointers; raise on a CUDA error."""
    with torch.cuda.device(args[0].device):
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel {name} launch failed with CUDA error {err}")


def _tile_args(entries, tile_start, tile_count, C, num_tiles_x, ncmax):
    return (entries, entries.shape[0], entries.shape[1], tile_start, tile_count, tile_start.shape[0],
            num_tiles_x, C, ncmax)


def splat_fwd_partials(entries, tile_start, tile_count, C, num_tiles_x, ncmax=NCMAX):
    """Kernel B2a on CUDA tensors: (part (Dp / CHUNK, C + 2, P), tickets (T,)
    int32): the partials of :func:`splat_chunk_partials_plain` on the slots a
    tile owns (the other rows unwritten), and B2b's tickets, zeroed for every
    tile that sweeps a chunk."""
    _check_cuda_inputs(entries, tile_start, tile_count, C)
    dev = entries.device
    part = torch.empty((entries.shape[1] // CHUNK, C + 2, P), dtype=torch.float32, device=dev)
    tickets = torch.empty((tile_start.shape[0],), dtype=torch.int32, device=dev)
    launch_kernel("B2a", _kernel_fns()[0], *_tile_args(entries, tile_start, tile_count, C, num_tiles_x, ncmax),
                  part, tickets)
    splat_fwd_partials.launches += 1
    return part, tickets


def splat_fwd_merge(entries, tile_start, tile_count, partials, C, num_tiles_x, ncmax=NCMAX):
    """Kernel B2b on CUDA tensors: B2a's ``partials`` merged per tile in chunk
    order into (color (T, C, P), alpha (T, 1, P), t_start (Dp / CHUNK, P)),
    every tile's outputs written, t_start on the slots a tile owns.  It
    leaves the partials and the tickets as it found them, so it can run
    again on them."""
    _check_cuda_inputs(entries, tile_start, tile_count, C)
    T, dev = tile_start.shape[0], entries.device
    part, tickets = partials
    check_tensor("part", part, (entries.shape[1] // CHUNK, C + 2, P), dev)
    check_tensor("tickets", tickets, (T,), dev, torch.int32)
    f32 = dict(dtype=torch.float32, device=dev)
    sweep = torch.empty_like(part)
    color, alpha = torch.empty((T, C, P), **f32), torch.empty((T, 1, P), **f32)
    t_start = torch.empty((entries.shape[1] // CHUNK, P), **f32)
    launch_kernel("B2b", _kernel_fns()[1], *_tile_args(entries, tile_start, tile_count, C, num_tiles_x, ncmax),
                  part, sweep, tickets, color, alpha, t_start)
    splat_fwd_merge.launches += 1
    return color, alpha, t_start


def splat_fwd(entries, tile_start, tile_count, C, num_tiles_x, ncmax=NCMAX):
    """Kernel B2 on CUDA tensors, B2a then B2b: (color (T, C, P), alpha (T,
    1, P), t_start (Dp / CHUNK, P)), t_start written on the slots a tile
    owns."""
    partials = splat_fwd_partials(entries, tile_start, tile_count, C, num_tiles_x, ncmax)
    return splat_fwd_merge(entries, tile_start, tile_count, partials, C, num_tiles_x, ncmax)


def _check_bwd_inputs(entries, tile_start, tile_count, t_start, g_color_t, g_alpha_t, C):
    _check_cuda_inputs(entries, tile_start, tile_count, C)
    T, dev = tile_start.shape[0], entries.device
    check_tensor("t_start", t_start, (entries.shape[1] // CHUNK, P), dev)
    check_tensor("g_color", g_color_t, (T, C, P), dev)
    check_tensor("g_alpha", g_alpha_t, (T, 1, P), dev)


def splat_bwd_partials(entries, tile_start, tile_count, t_start, g_color_t, g_alpha_t, C, num_tiles_x, ncmax=NCMAX):
    """Kernel B3a on CUDA tensors: (Dp / CHUNK, P), each pixel's sum of u w
    over each owned chunk alone."""
    _check_bwd_inputs(entries, tile_start, tile_count, t_start, g_color_t, g_alpha_t, C)
    partial = torch.empty_like(t_start)
    launch_kernel("B3a", _kernel_fns()[2], *_tile_args(entries, tile_start, tile_count, C, num_tiles_x, ncmax),
            g_color_t, g_alpha_t, t_start, partial)
    splat_bwd_partials.launches += 1
    return partial


def splat_bwd_grads(entries, tile_start, tile_count, t_start, partial, g_color_t, g_alpha_t, C, num_tiles_x,
                    ncmax=NCMAX):
    """Kernel B3b on CUDA tensors: d_entries (NCH, Dp).  Every slot a tile
    owns is written (zeros past its last contribution and in the padding
    rows); slots no tile owns are left unwritten."""
    _check_bwd_inputs(entries, tile_start, tile_count, t_start, g_color_t, g_alpha_t, C)
    check_tensor("partial", partial, t_start.shape, entries.device)
    d_entries = torch.empty_like(entries)
    launch_kernel("B3b", _kernel_fns()[3], *_tile_args(entries, tile_start, tile_count, C, num_tiles_x, ncmax),
            g_color_t, g_alpha_t, t_start, partial, d_entries)
    splat_bwd_grads.launches += 1
    return d_entries


def splat_bwd(entries, tile_start, tile_count, t_start, g_color_t, g_alpha_t, C, num_tiles_x, ncmax=NCMAX):
    """Kernel B3 on CUDA tensors, B3a then B3b: d_entries (NCH, Dp) from B2's
    ``t_start``, written on every slot a tile owns."""
    partial = splat_bwd_partials(entries, tile_start, tile_count, t_start, g_color_t, g_alpha_t, C, num_tiles_x,
                                 ncmax)
    return splat_bwd_grads(entries, tile_start, tile_count, t_start, partial, g_color_t, g_alpha_t, C,
                           num_tiles_x, ncmax)


splat_fwd_partials.launches = 0
splat_fwd_merge.launches = 0
splat_bwd_partials.launches = 0
splat_bwd_grads.launches = 0


def select_d_entries(d_entries, entry_valid, tile_start, tile_count, n_real_rows, ncmax=NCMAX):
    """Keep the gradient of the slots a tile wrote, of real entries, in the
    first ``n_real_rows`` rows, and SELECT zero elsewhere: unwritten slots
    hold stale bytes that may decode as NaN, and 0 * NaN = NaN."""
    written = written_slot_mask(tile_start, tile_count, d_entries.shape[1], ncmax)
    row_real = (torch.arange(d_entries.shape[0], device=d_entries.device) < n_real_rows)[:, None]
    keep = row_real & ((entry_valid > 0) & (written > 0))[None, :]
    return torch.where(keep, d_entries, torch.zeros((), dtype=d_entries.dtype, device=d_entries.device))


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, entries, entry_valid, tile_start, tile_count, C, num_tiles_x, num_tiles_y):
        color_t, alpha_t, t_start = splat_fwd(entries, tile_start, tile_count, C, num_tiles_x)
        ctx.save_for_backward(entries, entry_valid, tile_start, tile_count, t_start)
        ctx.geometry = (C, num_tiles_x, num_tiles_y)
        return _untile(color_t, alpha_t, num_tiles_x, num_tiles_y, C)

    @staticmethod
    def backward(ctx, g_img, g_alpha):
        entries, entry_valid, tile_start, tile_count, t_start = ctx.saved_tensors
        C, num_tiles_x, num_tiles_y = ctx.geometry
        g_color_t, g_alpha_t = _retile(g_img, g_alpha, num_tiles_x, num_tiles_y, C)
        d_entries = splat_bwd(entries, tile_start, tile_count, t_start, g_color_t, g_alpha_t, C, num_tiles_x)
        d_entries = select_d_entries(d_entries, entry_valid, tile_start, tile_count, 6 + C)
        return d_entries, None, None, None, None, None, None


def composite_tiles(entries, entry_valid, tile_start, tile_count, C: int, num_tiles_x: int, num_tiles_y: int):
    """Composite all tiles: (img (H, W, C), alpha (H, W)), differentiable in
    ``entries`` (NCH_pad, Dp), whose opacity row must already be zero on
    padding entries.  CUDA tensors go through kernels B2/B3, CPU tensors
    through the plain version."""
    if entries.device.type == "cpu":
        color_t, alpha_t = composite_plain_entries(entries, tile_start, tile_count, C, num_tiles_x, num_tiles_y)
        return _untile(color_t, alpha_t, num_tiles_x, num_tiles_y, C)
    if entries.device.type != "cuda":
        raise ValueError(f"kernels B2/B3 run on CUDA or CPU tensors, not {entries.device}")
    return _CompositeTiles.apply(
        entries.contiguous(), entry_valid, tile_start.to(torch.int32).contiguous(),
        tile_count.to(torch.int32).contiguous(), C, num_tiles_x, num_tiles_y,
    )

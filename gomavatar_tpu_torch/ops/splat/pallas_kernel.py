"""Kernels B2 (splat compositing forward) and B3 (its analytic backward, in
two launches B3a and B3b) and their wrapper (port of
gomavatar_tpu/ops/splat/pallas_kernel.py).

* ``composite_tiles`` is the wrapper: on CUDA tensors it is a
  ``torch.autograd.Function`` whose forward launches B2 and whose backward
  launches B3a then B3b (``csrc/splat_composite.cu``), each counted in
  ``launches``; on CPU tensors it runs the plain PyTorch version
  (``tiled_jnp.composite_tiles_plain``), differentiated by autograd; any
  other device raises.
* Entries are packed channel-major (NCH_pad, Dp) by
  :func:`pack_gaussian_channels`: mean xy, conic abc, opacity, C colors,
  zero rows up to a multiple of 8.
* B2 saves, for the backward, each pixel's transmittance at the start of
  every chunk its tile owns, or -1 once the pixel is spent
  (:func:`splat_chunk_state_plain` is its plain version).

Source note for the kernels (details in the .cu file): they replace
gomavatar_tpu/ops/splat/pallas_kernel.py:_fwd_kernel and _bwd_kernel.  On
the H100 both are bound by arithmetic, not bytes: a 512^2 frame of the
trained avatar reads ~1.4e3 chunks (~6 MB) as ~2.4e7 live (pixel, entry)
pairs of ~30 (forward) to ~100 (backward, with its per-entry reductions)
fp32 operations.  B2 runs one block per tile and one thread per pixel.  B3
replays nothing and runs one block per chunk of the entry buffer, so the
longest segment no longer runs on one SM: B3a sums u w per pixel over its
chunk from the saved transmittance, B3b takes the suffix from the later
chunks' partials and reduces each entry's gradient over the block (a warp
fold of 16 shuffles, then shared memory), with one plain store per entry,
since every entry belongs to exactly one tile.
"""

from __future__ import annotations

import ctypes

import torch

from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE, written_slot_mask
from gomavatar_tpu_torch.ops.splat.reference import T_EPS
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


# -- the CUDA kernels ----------------------------------------------------------

_FWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,  # entries, nch, dp
    ctypes.c_void_p, ctypes.c_void_p,  # tile_start, tile_count
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # num_tiles, tiles_x, C, ncmax
]
_STREAM = [ctypes.c_void_p]
_FWD_ARGTYPES_ALL = _FWD_ARGTYPES + [ctypes.c_void_p] * 3 + _STREAM  # color, alpha, t_start
_B3A_ARGTYPES = _FWD_ARGTYPES + [ctypes.c_void_p] * 4 + _STREAM  # g_color, g_alpha, t_start, partial
_B3B_ARGTYPES = _FWD_ARGTYPES + [ctypes.c_void_p] * 5 + _STREAM  # ..., partial, d_entries


def _kernel_fns():
    from gomavatar_tpu_torch import cuda_build

    lib = cuda_build.load("splat_composite")
    fns = lib.gom_splat_fwd, lib.gom_splat_bwd_partials, lib.gom_splat_bwd_grads
    for fn, argtypes in zip(fns, (_FWD_ARGTYPES_ALL, _B3A_ARGTYPES, _B3B_ARGTYPES)):
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


def splat_fwd(entries, tile_start, tile_count, C, num_tiles_x, ncmax=NCMAX):
    """Kernel B2 on CUDA tensors: (color (T, C, P), alpha (T, 1, P), t_start
    (Dp / CHUNK, P)), t_start written on the slots a tile owns."""
    _check_cuda_inputs(entries, tile_start, tile_count, C)
    T = tile_start.shape[0]
    f32 = dict(dtype=torch.float32, device=entries.device)
    color, alpha = torch.empty((T, C, P), **f32), torch.empty((T, 1, P), **f32)
    t_start = torch.empty((entries.shape[1] // CHUNK, P), **f32)
    launch_kernel("B2", _kernel_fns()[0], *_tile_args(entries, tile_start, tile_count, C, num_tiles_x, ncmax),
            color, alpha, t_start)
    splat_fwd.launches += 1
    return color, alpha, t_start


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
    launch_kernel("B3a", _kernel_fns()[1], *_tile_args(entries, tile_start, tile_count, C, num_tiles_x, ncmax),
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
    launch_kernel("B3b", _kernel_fns()[2], *_tile_args(entries, tile_start, tile_count, C, num_tiles_x, ncmax),
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


splat_fwd.launches = 0
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

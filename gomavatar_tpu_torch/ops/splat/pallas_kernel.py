"""Kernels B2 (splat compositing forward) and B3 (its analytic backward) and
their wrapper (port of gomavatar_tpu/ops/splat/pallas_kernel.py).

* ``composite_tiles`` is the wrapper: on CUDA tensors it is a
  ``torch.autograd.Function`` whose forward launches B2 and whose backward
  launches B3 (``csrc/splat_composite.cu``), each counted in ``launches``;
  on CPU tensors it runs the plain PyTorch version
  (``tiled_jnp.composite_tiles_plain``), differentiated by autograd; any
  other device raises.
* Entries are packed channel-major (NCH_pad, Dp) by
  :func:`pack_gaussian_channels`: mean xy, conic abc, opacity, C colors,
  zero rows up to a multiple of 8.

Source note for the kernels (details in the .cu file): they replace
gomavatar_tpu/ops/splat/pallas_kernel.py:_fwd_kernel and _bwd_kernel.  On
the H100 both are bound by arithmetic, not bytes: a 512^2 frame of the
trained avatar sweeps ~2e5 entries (~13 MB) as ~5e7 (pixel, entry) pairs of
~30 (forward) to ~90 (backward, with its per-entry reductions) fp32
operations.  One block per tile and one thread per pixel keep every
per-pixel sum in registers; each 128-entry chunk is staged once in shared
memory; B3's per-entry gradients are block reductions (warp shuffles, then
shared memory) with one plain store per entry, since every entry belongs to
exactly one tile.
"""

from __future__ import annotations

import ctypes

import torch

from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE, written_slot_mask
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, P, composite_tiles_plain

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


# -- the CUDA kernels ----------------------------------------------------------

_FWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,  # entries, nch, dp
    ctypes.c_void_p, ctypes.c_void_p,  # tile_start, tile_count
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # num_tiles, tiles_x, C, ncmax
    ctypes.c_void_p, ctypes.c_void_p,  # color_out, alpha_out
    ctypes.c_void_p,  # stream
]
_BWD_ARGTYPES = _FWD_ARGTYPES[:9] + [
    ctypes.c_void_p, ctypes.c_void_p,  # g_color, g_alpha
    ctypes.c_void_p,  # d_entries
    ctypes.c_void_p,  # stream
]


def _kernel_fns():
    from gomavatar_tpu_torch import cuda_build

    lib = cuda_build.load("splat_composite")
    fwd, bwd = lib.gom_splat_fwd, lib.gom_splat_bwd
    fwd.argtypes, fwd.restype = _FWD_ARGTYPES, ctypes.c_int
    bwd.argtypes, bwd.restype = _BWD_ARGTYPES, ctypes.c_int
    return fwd, bwd


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


def splat_fwd(entries, tile_start, tile_count, C, num_tiles_x, ncmax=NCMAX):
    """Kernel B2 on CUDA tensors: (color (T, C, P), alpha (T, 1, P))."""
    _check_cuda_inputs(entries, tile_start, tile_count, C)
    T = tile_start.shape[0]
    color = torch.empty((T, C, P), dtype=torch.float32, device=entries.device)
    alpha = torch.empty((T, 1, P), dtype=torch.float32, device=entries.device)
    fwd, _ = _kernel_fns()
    with torch.cuda.device(entries.device):
        err = fwd(
            entries.data_ptr(), entries.shape[0], entries.shape[1],
            tile_start.data_ptr(), tile_count.data_ptr(), T, num_tiles_x, C, ncmax,
            color.data_ptr(), alpha.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel B2 launch failed with CUDA error {err}")
    splat_fwd.launches += 1
    return color, alpha


def splat_bwd(entries, tile_start, tile_count, g_color_t, g_alpha_t, C, num_tiles_x, ncmax=NCMAX):
    """Kernel B3 on CUDA tensors: d_entries (NCH, Dp).  Every slot a tile
    owns is written (zeros past its last contribution and in the padding
    rows); slots no tile owns are left unwritten."""
    _check_cuda_inputs(entries, tile_start, tile_count, C)
    T = tile_start.shape[0]
    for name, g, c in (("g_color", g_color_t, C), ("g_alpha", g_alpha_t, 1)):
        if g.dtype != torch.float32 or g.shape != (T, c, P) or not g.is_contiguous() or g.device != entries.device:
            raise ValueError(f"{name} must be a contiguous ({T}, {c}, {P}) float32 tensor")
    d_entries = torch.empty_like(entries)
    _, bwd = _kernel_fns()
    with torch.cuda.device(entries.device):
        err = bwd(
            entries.data_ptr(), entries.shape[0], entries.shape[1],
            tile_start.data_ptr(), tile_count.data_ptr(), T, num_tiles_x, C, ncmax,
            g_color_t.data_ptr(), g_alpha_t.data_ptr(), d_entries.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel B3 launch failed with CUDA error {err}")
    splat_bwd.launches += 1
    return d_entries


splat_fwd.launches = 0
splat_bwd.launches = 0


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
        color_t, alpha_t = splat_fwd(entries, tile_start, tile_count, C, num_tiles_x)
        ctx.save_for_backward(entries, entry_valid, tile_start, tile_count)
        ctx.geometry = (C, num_tiles_x, num_tiles_y)
        return _untile(color_t, alpha_t, num_tiles_x, num_tiles_y, C)

    @staticmethod
    def backward(ctx, g_img, g_alpha):
        entries, entry_valid, tile_start, tile_count = ctx.saved_tensors
        C, num_tiles_x, num_tiles_y = ctx.geometry
        g_color_t, g_alpha_t = _retile(g_img, g_alpha, num_tiles_x, num_tiles_y, C)
        d_entries = splat_bwd(entries, tile_start, tile_count, g_color_t, g_alpha_t, C, num_tiles_x)
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

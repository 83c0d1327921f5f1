"""Kernels B4 (mesh raster forward) and B5 (its analytic backward) and their
wrapper (port of gomavatar_tpu/ops/mesh_raster_pallas.py).

* ``mesh_composite`` is the wrapper: on CUDA tensors it is a
  ``torch.autograd.Function`` whose forward launches B4 (B4a then B4b) and
  whose backward launches B5 (``csrc/mesh_raster.cu``), each kernel counted
  in its own wrapper's ``launches`` (``mesh_fwd_partials``,
  ``mesh_fwd_merge``, ``mesh_bwd``); on CPU tensors it runs
  ``mesh_raster.mesh_composite_plain``, differentiated by autograd; any
  other device raises.
* Entries are (16, Dp): x0 y0 x1 y1 x2 y2 | z0 z1 z2 | summed normal xyz |
  valid | zero rows.
* B4 saves three residuals for B5 (``mesh_raster.mesh_residuals_plain`` is
  their plain version): each pixel's winning entry, each pixel's final
  sum S of log(1 - p), and each tile's number of live soft chunks.

Both kernels skip the soft term of a tile's later chunks once every pixel of
the tile has sum log(1 - p) at or below ``_LOG_SAT``: such a chunk changes
the silhouette by less than exp(-18) per face, and B5 gives its entries zero
soft gradient, the exact gradient of the truncated sum.  The plain version
has no skip; the kernel tests' tolerances cover the difference.

Source note for the kernels (details in the .cu file): they replace
gomavatar_tpu/ops/mesh_raster_pallas.py:_fwd_kernel and _bwd_kernel.  On
the H100 they are bound by arithmetic: the soft term costs ~60 fp32
operations, an exp and a log per (pixel, entry) pair, its chain in B5 ~240.
A tile's segment runs to 14 chunks while the mean is 6.5, so the pair work
runs one block per chunk of the entry buffer, not one per tile.  B4 is two
launches: B4a sweeps one chunk per block, one thread per pixel, each
entry's set-up derived once in shared memory, and stores each pixel's hard
partial (z, entry index) and soft partial (the chunk's sum of log(1 - p),
computed for every chunk since liveness depends on the earlier chunks);
B4b, one block per tile, merges them in chunk order with the saturation
rule.  The hard pass uses IEEE division and FMA-free arithmetic, so the
z-buffer picks the same face as the plain version on the same inputs
(``mesh_raster.mesh_split_plain`` is the plain twin of the two launches).
B5 replays nothing: it reads the residuals and runs one block per chunk;
each entry's two threads, each over half of its tile's pixels, add their
sums once and store the gradient once, with no cross-warp reductions and
no atomics.
"""

from __future__ import annotations

import ctypes

import torch

from gomavatar_tpu_torch.ops.mesh_raster import _LOG_SAT, _ONE_MINUS, NCH, mesh_composite_plain
from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE
from gomavatar_tpu_torch.ops.splat.pallas_kernel import check_tensor, launch_kernel, select_d_entries
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, P

_ENTRY_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong,  # entries, dp
    ctypes.c_void_p, ctypes.c_void_p,  # tile_start, tile_count
]
_TILE_ARGTYPES = _ENTRY_ARGTYPES + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # num_tiles, tiles_x, ncmax
    ctypes.c_int, ctypes.c_float,  # soft, sigma_px2
]
_B4A_ARGTYPES = _TILE_ARGTYPES + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # z_part, i_part, s_part
    ctypes.c_void_p,  # stream
]
_B4B_ARGTYPES = _ENTRY_ARGTYPES + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,  # num_tiles, ncmax, soft, log_sat
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # z_part, i_part, s_part
    ctypes.c_void_p, ctypes.c_void_p,  # hard_out, soft_out
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # win, S, live
    ctypes.c_void_p,  # stream
]
_BWD_ARGTYPES = _TILE_ARGTYPES + [
    ctypes.c_void_p, ctypes.c_void_p,  # g_hard, g_soft
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # win, S, live
    ctypes.c_void_p,  # d_entries
    ctypes.c_void_p,  # stream
]


def _kernel_fns():
    """The C launchers of (B4a, B4b, B5)."""
    from gomavatar_tpu_torch import cuda_build

    lib = cuda_build.load("mesh_raster")
    fns = lib.gom_mesh_fwd_partials, lib.gom_mesh_fwd_merge, lib.gom_mesh_bwd
    for fn, argtypes in zip(fns, (_B4A_ARGTYPES, _B4B_ARGTYPES, _BWD_ARGTYPES)):
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fns


def _check_cuda_inputs(entries, tile_start, tile_count):
    dev = entries.device
    if entries.dtype != torch.float32 or entries.shape[0] != NCH or entries.dim() != 2:
        raise ValueError(f"entries must be ({NCH}, Dp) float32, got {tuple(entries.shape)} {entries.dtype}")
    if not entries.is_contiguous() or entries.shape[1] % CHUNK:
        raise ValueError(f"entries must be contiguous with Dp a multiple of {CHUNK}")
    T = tile_start.shape[0]
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (T,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({T},) int32 tensor on {dev}")


def mesh_fwd_partials(entries, tile_start, tile_count, num_tiles_x, soft, sigma_px2, ncmax=NCMAX):
    """Kernel B4a on CUDA tensors: each owned chunk's partials, from that
    chunk alone (``mesh_raster.mesh_chunk_partials_plain`` is the plain
    version): z (Dp / CHUNK, P), i (Dp / CHUNK, P) int32, s (Dp / CHUNK, P),
    written on the slots a tile owns."""
    _check_cuda_inputs(entries, tile_start, tile_count)
    T, dev = tile_start.shape[0], entries.device
    shape = (entries.shape[1] // CHUNK, P)
    z, i, s = (torch.empty(shape, dtype=dt, device=dev) for dt in (torch.float32, torch.int32, torch.float32))
    launch_kernel("B4a", _kernel_fns()[0], entries, entries.shape[1], tile_start, tile_count, T, num_tiles_x, ncmax,
                  int(soft), sigma_px2, z, i, s)
    mesh_fwd_partials.launches += 1
    return z, i, s


def mesh_fwd_merge(entries, tile_start, tile_count, partials, soft, ncmax=NCMAX):
    """Kernel B4b on CUDA tensors: B4a's ``partials`` merged in chunk order
    into (hard (T, 4, P), soft (T, 1, P)) and B5's residuals (win (T, P)
    int32, S (T, P), live (T,) int32)."""
    _check_cuda_inputs(entries, tile_start, tile_count)
    T, dev = tile_start.shape[0], entries.device
    shape = (entries.shape[1] // CHUNK, P)
    for name, x, dt in zip("zis", partials, (torch.float32, torch.int32, torch.float32)):
        check_tensor(f"{name}_part", x, shape, dev, dt)
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    hard, soft_t = torch.empty((T, 4, P), **f32), torch.empty((T, 1, P), **f32)
    win, S, live = torch.empty((T, P), **i32), torch.empty((T, P), **f32), torch.empty((T,), **i32)
    launch_kernel("B4b", _kernel_fns()[1], entries, entries.shape[1], tile_start, tile_count, T, ncmax, int(soft),
                  _LOG_SAT, *partials, hard, soft_t, win, S, live)
    mesh_fwd_merge.launches += 1
    return hard, soft_t, win, S, live


def mesh_fwd(entries, tile_start, tile_count, num_tiles_x, soft, sigma_px2, ncmax=NCMAX):
    """Kernel B4 on CUDA tensors, B4a then B4b: (hard (T, 4, P), soft (T, 1,
    P)) and B5's residuals (win (T, P) int32, S (T, P), live (T,) int32)."""
    partials = mesh_fwd_partials(entries, tile_start, tile_count, num_tiles_x, soft, sigma_px2, ncmax)
    return mesh_fwd_merge(entries, tile_start, tile_count, partials, soft, ncmax)


def mesh_bwd(entries, tile_start, tile_count, g_hard_t, g_soft_t, win, S, live, num_tiles_x, soft, sigma_px2,
             ncmax=NCMAX):
    """Kernel B5 on CUDA tensors, from B4's residuals: d_entries (16, Dp).
    Every slot a tile owns is written (zero where no gradient flows); slots
    no tile owns are left unwritten."""
    _check_cuda_inputs(entries, tile_start, tile_count)
    T, dev = tile_start.shape[0], entries.device
    check_tensor("g_hard", g_hard_t, (T, 4, P), dev)
    check_tensor("g_soft", g_soft_t, (T, 1, P), dev)
    check_tensor("win", win, (T, P), dev, torch.int32)
    check_tensor("S", S, (T, P), dev)
    check_tensor("live", live, (T,), dev, torch.int32)
    d_entries = torch.empty_like(entries)
    launch_kernel("B5", _kernel_fns()[2], entries, entries.shape[1], tile_start, tile_count, T, num_tiles_x, ncmax,
                  int(soft), sigma_px2, g_hard_t, g_soft_t, win, S, live, d_entries)
    mesh_bwd.launches += 1
    return d_entries


mesh_fwd_partials.launches = 0
mesh_fwd_merge.launches = 0
mesh_bwd.launches = 0


def _edge_grads(px, py, ax, ay, bx, by, g_d):
    """Gradient of one edge's squared distance D(p; a, b) with cotangent
    ``g_d``, written out: D = |p - (a + tc (b - a))|^2 with
    tc = clip(((p - a).(b - a)) / max(|b - a|^2, 1e-12), 0, 1).  Returns
    (D, g_ax, g_ay, g_bx, g_by).  The clip passes the gradient of t only
    strictly inside (0, 1) and half of it at a bound, as the reference's
    autodiff of clip does."""
    abx, aby = bx - ax, by - ay
    d2ab = abx * abx + aby * aby
    inv = 1.0 / torch.clamp_min(d2ab, 1e-12)
    num = (px - ax) * abx + (py - ay) * aby
    t = num * inv
    tc = torch.clamp(t, 0.0, 1.0)
    dx = px - (ax + tc * abx)
    dy = py - (ay + tc * aby)
    gdx, gdy = 2.0 * dx * g_d, 2.0 * dy * g_d
    g_tc = -(gdx * abx + gdy * aby)
    pass_t = ((t > 0.0) & (t < 1.0)).to(t.dtype) + 0.5 * ((t == 0.0) | (t == 1.0)).to(t.dtype)
    g_t = g_tc * pass_t
    g_num = g_t * inv
    g_d2ab = -g_t * num * inv * inv * (d2ab > 1e-12).to(t.dtype)
    g_ax = gdx * (tc - 1.0) + g_num * (-abx - (px - ax)) - 2.0 * abx * g_d2ab
    g_bx = -gdx * tc + g_num * (px - ax) + 2.0 * abx * g_d2ab
    g_ay = gdy * (tc - 1.0) + g_num * (-aby - (py - ay)) - 2.0 * aby * g_d2ab
    g_by = -gdy * tc + g_num * (py - ay) + 2.0 * aby * g_d2ab
    return dx * dx + dy * dy, g_ax, g_ay, g_bx, g_by


def _min_split(a, b, g):
    """Cotangents of (a, b) from min(a, b) with cotangent g; ties split."""
    tie = (a == b).to(g.dtype)
    return g * ((a < b).to(g.dtype) + 0.5 * tie), g * ((b < a).to(g.dtype) + 0.5 * tie)


def soft_log1m_grad(coords, px, py, valid, inside, sigma_px2: float, g_S):
    """The soft term's gradient as kernel B5 computes it, written out in
    plain PyTorch: S(p) = sum_e log1p(-min(sigmoid(-signed_e(p) / sigma),
    1 - 1e-7)) over a chunk's valid entries, with signed = -d2 inside the
    triangle and d2 the minimum over the three edges.  ``coords`` (6, E)
    rows x0 y0 x1 y1 x2 y2, px/py (P, 1), valid (1, E), inside (P, E) bool,
    ``g_S`` (P, 1) the cotangent of S.  Returns dS-weighted d coords (6, E).

    The chain: log1p(-q) -> -1/(1 - q), zero where the clamp of q holds;
    the sigmoid -> p (1 - p); the sign flip inside; the minimum over three
    edges -> its argmin edge (ties split evenly); the edge projection
    (:func:`_edge_grads`).  No gradient flows through ``inside``."""
    x0, y0, x1, y1, x2, y2 = (coords[i : i + 1] for i in range(6))
    zeros = torch.zeros(torch.broadcast_shapes(px.shape, x0.shape), dtype=coords.dtype, device=coords.device)
    d01 = _edge_grads(px, py, x0, y0, x1, y1, zeros)[0]
    d12 = _edge_grads(px, py, x1, y1, x2, y2, zeros)[0]
    d20 = _edge_grads(px, py, x2, y2, x0, y0, zeros)[0]
    m12 = torch.minimum(d12, d20)
    d2 = torch.minimum(d01, m12)
    signed = torch.where(inside, -d2, d2)
    prob = torch.sigmoid(-signed / sigma_px2)
    q = torch.minimum(prob, torch.full_like(prob, _ONE_MINUS))
    g_q = -g_S / (1.0 - q)
    g_prob = g_q * ((prob < _ONE_MINUS).to(prob.dtype) + 0.5 * (prob == _ONE_MINUS).to(prob.dtype))
    g_prob = torch.where(valid > 0, g_prob, torch.zeros_like(g_prob))
    g_signed = -(g_prob * prob * (1.0 - prob)) / sigma_px2
    g_d2 = torch.where(inside, -g_signed, g_signed)
    g01, g_m12 = _min_split(d01, m12, g_d2)
    g12, g20 = _min_split(d12, d20, g_m12)
    _, a0x, a0y, a1x, a1y = _edge_grads(px, py, x0, y0, x1, y1, g01)
    _, b1x, b1y, b2x, b2y = _edge_grads(px, py, x1, y1, x2, y2, g12)
    _, c2x, c2y, c0x, c0y = _edge_grads(px, py, x2, y2, x0, y0, g20)
    rows = (a0x + c0x, a0y + c0y, a1x + b1x, a1y + b1y, b2x + c2x, b2y + c2y)
    return torch.stack([r.sum(dim=0) for r in rows])


def _untile1(x_t, num_tiles_x, num_tiles_y):
    H, W = num_tiles_y * TILE, num_tiles_x * TILE
    return x_t.reshape(num_tiles_y, num_tiles_x, TILE, TILE).permute(0, 2, 1, 3).reshape(H, W)


def _untile_outputs(hard_t, soft_t, num_tiles_x, num_tiles_y):
    """(T, 4, P), (T, 1, P) -> normal (H, W, 3), mask (H, W), soft (H, W)."""
    TY, TX = num_tiles_y, num_tiles_x
    H, W = TY * TILE, TX * TILE
    normal = hard_t[:, 0:3, :].reshape(TY, TX, 3, TILE, TILE).permute(0, 3, 1, 4, 2).reshape(H, W, 3)
    return normal, _untile1(hard_t[:, 3, :], TX, TY), _untile1(soft_t[:, 0, :], TX, TY)


def _retile_cotangents(g_normal, g_soft, num_tiles_x, num_tiles_y):
    TY, TX = num_tiles_y, num_tiles_x
    g_hard_t = torch.cat(
        [
            g_normal.reshape(TY, TILE, TX, TILE, 3).permute(0, 2, 4, 1, 3).reshape(TY * TX, 3, P),
            torch.zeros((TY * TX, 1, P), dtype=torch.float32, device=g_normal.device),
        ],
        dim=1,
    )
    g_soft_t = g_soft.reshape(TY, TILE, TX, TILE).permute(0, 2, 1, 3).reshape(TY * TX, 1, P)
    return g_hard_t.contiguous(), g_soft_t.contiguous()


class _MeshComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, entries, entry_valid, tile_start, tile_count, num_tiles_x, num_tiles_y, soft, sigma_px2):
        hard_t, soft_t, win, S, live = mesh_fwd(entries, tile_start, tile_count, num_tiles_x, soft, sigma_px2)
        ctx.save_for_backward(entries, entry_valid, tile_start, tile_count, win, S, live)
        ctx.geometry = (num_tiles_x, num_tiles_y, soft, sigma_px2)
        normal, mask, soft_img = _untile_outputs(hard_t, soft_t, num_tiles_x, num_tiles_y)
        ctx.mark_non_differentiable(mask)  # the hard mask carries no gradient
        return normal, mask, soft_img

    @staticmethod
    def backward(ctx, g_normal, _g_mask, g_soft):
        entries, entry_valid, tile_start, tile_count, win, S, live = ctx.saved_tensors
        num_tiles_x, num_tiles_y, soft, sigma_px2 = ctx.geometry
        g_hard_t, g_soft_t = _retile_cotangents(g_normal, g_soft, num_tiles_x, num_tiles_y)
        d_entries = mesh_bwd(entries, tile_start, tile_count, g_hard_t, g_soft_t, win, S, live, num_tiles_x, soft,
                             sigma_px2)
        d_entries = select_d_entries(d_entries, entry_valid, tile_start, tile_count, NCH)
        return d_entries, None, None, None, None, None, None, None


def mesh_composite(entries, entry_valid, tile_start, tile_count, num_tiles_x: int, num_tiles_y: int,
                   soft: bool, sigma_px2: float):
    """(normal (H, W, 3), mask (H, W), soft (H, W)), differentiable in
    ``entries`` (16, Dp), whose valid row must already hold the entry's
    flags.  CUDA tensors go through kernels B4/B5, CPU tensors through the
    plain version."""
    if entries.device.type == "cpu":
        hard_t, soft_t = mesh_composite_plain(
            entries, tile_start, tile_count, num_tiles_x, num_tiles_y, soft, sigma_px2
        )
        return _untile_outputs(hard_t, soft_t, num_tiles_x, num_tiles_y)
    if entries.device.type != "cuda":
        raise ValueError(f"kernels B4/B5 run on CUDA or CPU tensors, not {entries.device}")
    return _MeshComposite.apply(
        entries.contiguous(), entry_valid, tile_start.to(torch.int32).contiguous(),
        tile_count.to(torch.int32).contiguous(), num_tiles_x, num_tiles_y, bool(soft), float(sigma_px2),
    )

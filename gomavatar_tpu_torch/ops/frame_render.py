"""Fused single-pass frame renderer of the eval path (port of
gomavatar_tpu/ops/frame_render.py).

Kernel B1 sweeps every active 16x16 tile's depth-sorted entry segment once
and computes the splat blend (rgb, alpha) and the z-buffered selection of
[normal | shading | hit] in the same pass.

* ``frame_sweep`` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel ``csrc/frame_render.cu`` (and counts the launch in
  ``frame_sweep.launches``); on a CPU tensor it runs ``frame_sweep_plain``;
  on any other device it raises.
* ``frame_sweep_plain`` is the plain PyTorch version of the same function,
  vectorised over active tiles with a loop over chunk index k, in the
  reference's log-space form (transmittance = exp of the cumulative sum of
  log1p(-alpha)).  The CPU tests hold it to the JAX kernel and the chip
  smoke holds the CUDA kernel to it.

Source note for the kernel (details in csrc/frame_render.cu): it replaces
gomavatar_tpu/ops/frame_render.py:_frame_kernel/_frame_tile.  On the H100
it is bound by arithmetic, not bytes: a 512^2 frame of the trained avatar is
~163k swept (face, tile) entries (~16 MB) but ~42M (pixel, entry) pairs of
~50 fp32 operations and one exp.  The design keeps each 128-entry chunk in
shared memory with its tile-local coefficients derived once per block,
keeps every accumulator in registers (one thread per pixel), reads
``n_active`` on the device, and lets a saturated pixel skip its splat math.
"""

from __future__ import annotations

import ctypes

import torch

from gomavatar_tpu_torch.ops.geometry import NCH
from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE, SortedBinning
from gomavatar_tpu_torch.ops.splat.reference import ALPHA_MAX, ALPHA_MIN, T_EPS

P = TILE * TILE
_BIG = 1e10

NCMAX = 64  # max CHUNK-sized entry chunks a tile sweep ingests, counted from
# the aligned-down segment start (binning telemetry reports the overflow)


def gather_entries(table: torch.Tensor, bins: SortedBinning) -> torch.Tensor:
    """(NCH, Dcap) entry stream of the sorted binning, with the per-pass
    flags folded in: opacity row 5 *= splat flag, mesh-valid row 18 *=
    mesh flag."""
    entries = torch.index_select(table.T.contiguous(), 1, bins.order)
    entries[5] *= bins.entry_splat
    entries[18] *= bins.entry_mesh
    return entries


def frame_sweep_plain(
    entries: torch.Tensor,  # (NCH, Dcap) f32
    active_id: torch.Tensor,  # (A,) i32
    seg_start: torch.Tensor,  # (A,) i32
    seg_count: torch.Tensor,  # (A,) i32
    n_active: torch.Tensor,  # () i32
    num_tiles_x: int,
    ncmax: int = NCMAX,
    with_mesh: bool = True,
):
    """Plain PyTorch B1: returns (rgb (A,3,P), alpha (A,1,P), sel (A,5,P) or
    None); slots at or above ``n_active`` are zero."""
    A = active_id.shape[0]
    dev = entries.device
    dcap = entries.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    rgb = torch.zeros((A, 3, P), **f32)
    alpha_out = torch.zeros((A, 1, P), **f32)
    sel = torch.zeros((A, 5, P), **f32) if with_mesh else None
    n = min(int(n_active), A)
    if n == 0:
        return rgb, alpha_out, sel

    tile = active_id[:n].long()
    start = seg_start[:n].long()
    count = seg_count[:n].long()
    astart = torch.div(start, CHUNK, rounding_mode="floor") * CHUNK
    head = start - astart
    nchunks = torch.clamp_max(torch.div(head + count + CHUNK - 1, CHUNK, rounding_mode="floor"), ncmax)
    kmax = int(nchunks.max())

    # tile origin + TILE-RELATIVE pixel coordinates: the polynomials are
    # evaluated in tile-local coordinates against per-chunk rebased
    # coefficients (image-absolute ones would cancel catastrophically)
    px0 = ((tile % num_tiles_x) * TILE).to(torch.float32)[:, None, None]  # (n,1,1)
    py0 = (torch.div(tile, num_tiles_x, rounding_mode="floor") * TILE).to(torch.float32)[:, None, None]
    lin = torch.arange(P, device=dev)
    prx = (lin % TILE).to(torch.float32)[None, :, None]  # (1,P,1)
    pry = torch.div(lin, TILE, rounding_mode="floor").to(torch.float32)[None, :, None]
    prx2, pry2, prxy = prx * prx, pry * pry, prx * pry
    lane = torch.arange(CHUNK, device=dev)[None, :]

    log_T = torch.zeros((n, P), **f32)
    color_acc = torch.zeros((n, 3, P), **f32)
    alpha_acc = torch.zeros((n, P), **f32)
    best_z = torch.full((n, P), _BIG, **f32)
    best_s = torch.zeros((n, 4, P), **f32)
    zero = torch.zeros((), **f32)

    for k in range(kmax):
        pos = k * CHUNK + lane
        lane_ok = (pos >= head[:, None]) & (pos < (head + count)[:, None])  # (n, CHUNK)
        idx = torch.clamp_max(astart[:, None] + pos, dcap - 1)
        chunk = entries[:, idx]  # (NCH, n, CHUNK)

        def row(r):
            return chunk[r][:, None, :]  # (n, 1, CHUNK)

        ok3 = lane_ok[:, None, :]
        mx, my = row(0), row(1)
        ca, cb, cc = row(2), row(3), row(4)
        dx0 = px0 - mx
        dy0 = py0 - my
        qc = -0.5 * (ca * dx0 * dx0 + cc * dy0 * dy0) - cb * dx0 * dy0
        qx = -(ca * dx0 + cb * dy0)
        qy = -(cc * dy0 + cb * dx0)
        power = qc + qx * prx + qy * pry - 0.5 * (ca * prx2 + cc * pry2) - cb * prxy

        op = row(5) * ok3.to(torch.float32)
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        alpha = torch.where((power > 0.0) | ~ok3, zero, alpha)
        alpha = torch.where(alpha < ALPHA_MIN, zero, alpha)
        log1m = torch.log1p(-alpha)
        cum = torch.cumsum(log1m, dim=-1) + log_T[..., None]
        T_incl = torch.exp(cum)
        T_excl = torch.exp(cum - log1m)
        w = torch.where(T_incl < T_EPS, zero, T_excl * alpha)  # (n, P, CHUNK)
        log_T = cum[..., -1]
        color_acc += torch.einsum("npl,cnl->ncp", w, chunk[6:9])
        alpha_acc += torch.sum(w, dim=-1)

        if with_mesh:
            # z-buffered selection of [normal | shading]: plane coefficients
            # are per-face constants, only the tile-origin rebase happens here
            w0x, w0y = row(9), row(10)
            w1x, w1y = row(11), row(12)
            dx2 = px0 - row(13)
            dy2 = py0 - row(14)
            zx, zy = row(15), row(16)
            w0c = w0x * dx2 + w0y * dy2
            w1c = w1x * dx2 + w1y * dy2
            zc0 = zx * dx2 + zy * dy2 + row(17)
            w0 = w0c + w0x * prx + w0y * pry
            w1 = w1c + w1x * prx + w1y * pry
            z_px = zc0 + zx * prx + zy * pry
            w2 = 1.0 - w0 - w1
            ok = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (row(18) > 0) & ok3
            z_cand = torch.where(ok, z_px, torch.full_like(z_px, _BIG))
            chunk_min = torch.amin(z_cand, dim=-1)  # (n, P)
            better = chunk_min < best_z
            # first eligible lane at the chunk minimum
            cand_lane = torch.where(
                (z_cand <= chunk_min[..., None]) & ok, lane[:, None, :], 2 * CHUNK
            )
            first = torch.clamp_max(torch.amin(cand_lane, dim=-1), CHUNK - 1)  # (n, P)
            sel_rows = chunk[19:23].permute(1, 0, 2)  # (n, 4, CHUNK)
            s_chunk = torch.gather(sel_rows, 2, first[:, None, :].expand(n, 4, P))
            best_s = torch.where(better[:, None, :], s_chunk, best_s)
            best_z = torch.minimum(best_z, chunk_min)

    rgb[:n] = color_acc
    alpha_out[:n, 0] = alpha_acc
    if with_mesh:
        sel[:n, :4] = best_s
        sel[:n, 4] = (best_z < _BIG).to(torch.float32)
    return rgb, alpha_out, sel


_C_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong,  # entries, dcap
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # active_id, seg_start, seg_count
    ctypes.c_void_p,  # n_active
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # active_cap, tiles_x, ncmax, with_mesh
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rgb, alpha, sel
    ctypes.c_void_p,  # stream
]


def _kernel_fn():
    from gomavatar_tpu_torch import cuda_build

    fn = cuda_build.load("frame_render").gom_frame_render
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(entries, active_id, seg_start, seg_count, n_active):
    dev = entries.device
    if entries.dtype != torch.float32 or entries.dim() != 2 or entries.shape[0] != NCH:
        raise ValueError(f"entries must be ({NCH}, Dcap) float32, got {tuple(entries.shape)} {entries.dtype}")
    if not entries.is_contiguous():
        raise ValueError("entries must be contiguous")
    A = active_id.shape[0]
    for name, t in (("active_id", active_id), ("seg_start", seg_start), ("seg_count", seg_count)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (A,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({A},) int32 tensor on {dev}")
    if n_active.device != dev or n_active.dtype != torch.int32 or n_active.numel() != 1:
        raise ValueError(f"n_active must be a one-element int32 tensor on {dev}")


def frame_sweep(
    entries: torch.Tensor,
    active_id: torch.Tensor,
    seg_start: torch.Tensor,
    seg_count: torch.Tensor,
    n_active: torch.Tensor,
    num_tiles_x: int,
    ncmax: int = NCMAX,
    with_mesh: bool = True,
):
    """Kernel B1: (rgb (A,3,P), alpha (A,1,P), sel (A,5,P) or None).  On a
    CUDA tensor it launches the CUDA kernel, whose slots at or above
    ``n_active`` are left unwritten (``untile`` never reads them); on a CPU
    tensor it runs :func:`frame_sweep_plain`."""
    if entries.device.type == "cpu":
        return frame_sweep_plain(
            entries, active_id, seg_start, seg_count, n_active, num_tiles_x, ncmax, with_mesh
        )
    if entries.device.type != "cuda":
        raise ValueError(f"kernel B1 runs on CUDA or CPU tensors, not {entries.device}")
    _check_cuda_inputs(entries, active_id, seg_start, seg_count, n_active)
    A = active_id.shape[0]
    empty = dict(dtype=torch.float32, device=entries.device)
    rgb = torch.empty((A, 3, P), **empty)
    alpha = torch.empty((A, 1, P), **empty)
    sel = torch.empty((A, 5, P), **empty) if with_mesh else None
    fn = _kernel_fn()
    with torch.cuda.device(entries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            entries.data_ptr(), entries.shape[1],
            active_id.data_ptr(), seg_start.data_ptr(), seg_count.data_ptr(),
            n_active.data_ptr(), A, num_tiles_x, ncmax, int(with_mesh),
            rgb.data_ptr(), alpha.data_ptr(), sel.data_ptr() if with_mesh else None,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"kernel B1 launch failed with CUDA error {err}")
    frame_sweep.launches += 1
    return rgb, alpha, sel


frame_sweep.launches = 0


def untile(compact: torch.Tensor, bins: SortedBinning, img_size: tuple[int, int]) -> torch.Tensor:
    """(A, c, P) per-slot tiles -> (H, W, c) image; tiles without a slot read
    an appended zeros row (a gather, no scatter)."""
    W, H = img_size
    TX, TY = bins.num_tiles_x, bins.num_tiles_y
    c = compact.shape[1]
    full = torch.cat([compact, compact.new_zeros((1,) + compact.shape[1:])])[bins.pos_of_tile.long()]
    return full.reshape(TY, TX, c, TILE, TILE).permute(0, 3, 1, 4, 2).reshape(H, W, c)


def render_frame_sorted(
    table: torch.Tensor,  # (F, NCH) from ops.geometry.frame_geometry
    bins: SortedBinning,
    img_size: tuple[int, int],
    shading0: torch.Tensor | None = None,  # shading of the zero normal (no-hit
    # pixels); None disables the shading multiply (albedo passthrough)
    with_normal: bool = False,
    ncmax: int = NCMAX,
):
    """Render the frame: returns (rgb (H,W,3), alpha (H,W)) and, with
    ``with_normal``, also (normal (H,W,3), hard mask (H,W)).  ``table``
    channel 22 must hold the per-face shading (x2 applied) when ``shading0``
    is given."""
    with_shadow = shading0 is not None
    with_mesh = with_shadow or with_normal
    entries = gather_entries(table, bins)
    rgb_c, alpha_c, sel_c = frame_sweep(
        entries, bins.active_id, bins.seg_start, bins.seg_count, bins.n_active,
        bins.num_tiles_x, ncmax=ncmax, with_mesh=with_mesh,
    )
    rgb = untile(rgb_c, bins, img_size)
    alpha = untile(alpha_c, bins, img_size)[..., 0]
    if with_mesh:
        sel = untile(sel_c, bins, img_size)
        hit = sel[..., 4]
        if with_shadow:
            shading = torch.where(hit > 0, sel[..., 3], shading0)
            rgb = rgb * shading[..., None]
    if with_normal:
        return rgb, alpha, sel[..., :3], hit
    return rgb, alpha

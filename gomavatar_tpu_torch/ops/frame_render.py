"""Fused single-pass frame renderer of the eval path (port of
gomavatar_tpu/ops/frame_render.py).

Kernel B1 sweeps every active 16x16 tile's depth-sorted entry segment once
and computes the splat blend (rgb, alpha) and the z-buffered selection of
[normal | shading | hit] in the same pass.

* ``frame_sweep`` is the wrapper: on a CUDA tensor it launches the
  hand-written kernels of ``csrc/frame_render.cu``, B1a then B1b, each
  counted in its own wrapper's ``launches`` (``frame_partials``,
  ``frame_merge``); on a CPU tensor it runs ``frame_sweep_plain``; on any
  other device it raises.
* ``frame_sweep_plain`` is the plain PyTorch version of the same function,
  vectorised over active tiles with a loop over chunk index k, in the
  reference's log-space form (transmittance = exp of the cumulative sum of
  log1p(-alpha)).  The CPU tests hold it to the JAX kernel and the chip
  smoke holds the CUDA kernel to it.
* ``frame_split_plain`` is the plain twin of the two launches (per-chunk
  partials from T = 1, then the merge with one re-sweep per pixel), held
  to both on the CPU and to the kernels on the card.

Source note for the kernel (details in csrc/frame_render.cu): it replaces
gomavatar_tpu/ops/frame_render.py:_frame_kernel/_frame_tile.  On the H100
it is bound by arithmetic, not bytes: a 512^2 frame of the trained avatar is
~163k swept (face, tile) entries (~16 MB) but ~42M (pixel, entry) pairs of
~50 fp32 operations and one exp.  Its largest tile holds 14 chunks against a
mean of 6.8, so the sweep does not run one block per tile.  Both launches
run one block per (tile, chunk) pair, one thread per pixel.  B1a derives
the chunk plan on the device (its plain version is :func:`chunk_plan`; the
grid is sized from shapes, so the host never reads ``n_active``), holds the
chunk and its tile-local coefficients in shared memory and stores each
pixel's partials from T = 1.  B1b re-sweeps, for each pixel, the one chunk
where its transmittance is spent, from the transmittance the earlier
chunks leave; the last block of each tile to finish (an atomic ticket)
merges the tile's chunks in order.
"""

from __future__ import annotations

import ctypes

import torch

from gomavatar_tpu_torch.ops.geometry import NCH
from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE, SortedBinning, crop_frame
from gomavatar_tpu_torch.ops.splat.pallas_kernel import check_tensor, launch_kernel
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


def _slot_chunks(entries, active_id, seg_start, seg_count, n, num_tiles_x, ncmax, with_mesh):
    """The chunk terms of the first n slots, chunk by chunk, in the plain
    version's arithmetic: yields (k, in_range (n,) bool, the chunk's lanes
    (n, CHUNK) bool, alpha (n, P, CHUNK), log1p(-alpha), colours (3, n,
    CHUNK), and with the mesh pass (z of each eligible pair, _BIG elsewhere
    (n, P, CHUNK), the selection rows (n, 4, CHUNK))."""
    dev, dcap = entries.device, entries.shape[1]
    tile = active_id[:n].long()
    start, count = seg_start[:n].long(), seg_count[:n].long()
    astart = torch.div(start, CHUNK, rounding_mode="floor") * CHUNK
    head = start - astart
    nchunks = torch.clamp(torch.div(head + count + CHUNK - 1, CHUNK, rounding_mode="floor"), 1, ncmax)
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
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k in range(int(nchunks.max()) if n else 0):
        pos = k * CHUNK + lane
        lane_ok = (pos >= head[:, None]) & (pos < (head + count)[:, None])  # (n, CHUNK)
        chunk = entries[:, torch.clamp_max(astart[:, None] + pos, dcap - 1)]  # (NCH, n, CHUNK)

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
        mesh = None
        if with_mesh:
            # z-buffered selection of [normal | shading]: plane coefficients
            # are per-face constants, only the tile-origin rebase happens here
            w0x, w0y = row(9), row(10)
            w1x, w1y = row(11), row(12)
            dx2 = px0 - row(13)
            dy2 = py0 - row(14)
            zx, zy = row(15), row(16)
            w0 = w0x * dx2 + w0y * dy2 + w0x * prx + w0y * pry
            w1 = w1x * dx2 + w1y * dy2 + w1x * prx + w1y * pry
            z_px = zx * dx2 + zy * dy2 + row(17) + zx * prx + zy * pry
            w2 = 1.0 - w0 - w1
            ok = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (row(18) > 0) & ok3
            mesh = torch.where(ok, z_px, torch.full_like(z_px, _BIG)), chunk[19:23].permute(1, 0, 2)
        yield k, k < nchunks, lane_ok, alpha, torch.log1p(-alpha), chunk[6:9], mesh


def _first_lane_at_min(z_cand):
    """(each pixel's minimum z over the chunk (n, P), the first lane there)."""
    chunk_min = torch.amin(z_cand, dim=-1)
    lane = torch.arange(CHUNK, device=z_cand.device)
    return chunk_min, torch.clamp_max(torch.amin(torch.where(z_cand <= chunk_min[..., None], lane, 2 * CHUNK), -1),
                                      CHUNK - 1)


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
    f32 = dict(dtype=torch.float32, device=entries.device)
    rgb = torch.zeros((A, 3, P), **f32)
    alpha_out = torch.zeros((A, 1, P), **f32)
    sel = torch.zeros((A, 5, P), **f32) if with_mesh else None
    n = min(int(n_active), A)
    log_T = torch.zeros((n, P), **f32)
    color_acc = torch.zeros((n, 3, P), **f32)
    alpha_acc = torch.zeros((n, P), **f32)
    best_z = torch.full((n, P), _BIG, **f32)
    best_s = torch.zeros((n, 4, P), **f32)
    for _, _, _, alpha, log1m, colors, mesh in _slot_chunks(
            entries, active_id, seg_start, seg_count, n, num_tiles_x, ncmax, with_mesh):
        cum = torch.cumsum(log1m, dim=-1) + log_T[..., None]
        T_incl = torch.exp(cum)
        T_excl = torch.exp(cum - log1m)
        w = torch.where(T_incl < T_EPS, 0.0, T_excl * alpha)  # (n, P, CHUNK)
        log_T = cum[..., -1]
        color_acc += torch.einsum("npl,cnl->ncp", w, colors)
        alpha_acc += torch.sum(w, dim=-1)
        if with_mesh:
            z_cand, sel_rows = mesh
            chunk_min, first = _first_lane_at_min(z_cand)  # (n, P)
            better = chunk_min < best_z
            s_chunk = torch.gather(sel_rows, 2, first[:, None, :].expand(n, 4, P))
            best_s = torch.where(better[:, None, :], s_chunk, best_s)
            best_z = torch.minimum(best_z, chunk_min)

    rgb[:n] = color_acc
    alpha_out[:n, 0] = alpha_acc
    if with_mesh:
        sel[:n, :4] = best_s
        sel[:n, 4] = (best_z < _BIG).to(torch.float32)
    return rgb, alpha_out, sel


# ---- B1 as two launches: per-(tile, chunk) partials, then a per-tile merge ----

NPART = 6  # partial rows per pixel: local r, g, b, alpha sums, local T (or CROSSED), z
CROSSED = -1.0  # the local T of a chunk whose sweep from T = 1 fell below 1e-4


def num_pairs(dcap: int, active_cap: int) -> int:
    """An upper bound, known on the host, of the (tile, chunk) pairs B1a
    sweeps: the segments are disjoint, so the chunk slots they touch number
    at most ceil(dcap / CHUNK) plus one shared slot per segment."""
    return -(-dcap // CHUNK) + active_cap


def chunk_plan(seg_start, seg_count, n_active, ncmax: int, n_pairs: int):
    """Plain version of the chunk plan kernel B1a derives: (A,) int32, the
    inclusive cumsum of each slot's chunk count, min(ceil((head + count) /
    CHUNK), ncmax) and at least 1 below ``n_active`` (so that every active
    slot's outputs are written), 0 above, capped at ``n_pairs``."""
    A = seg_start.shape[0]
    head = torch.remainder(seg_start, CHUNK)
    n = torch.clamp(torch.div(head + seg_count + (CHUNK - 1), CHUNK, rounding_mode="floor"), 1, ncmax)
    n = torch.where(torch.arange(A, device=seg_start.device) < n_active, n, 0)
    return torch.clamp_max(torch.cumsum(n, 0, dtype=torch.int32), n_pairs)


@torch.no_grad()
def frame_chunk_partials_plain(entries, active_id, seg_start, seg_count, n_active, num_tiles_x: int,
                               ncmax: int = NCMAX, with_mesh: bool = True):
    """Plain version of kernel B1a: every (slot, chunk) pair swept alone from
    T = 1, in the plain version's log-space arithmetic.  Returns (part
    (n_pairs, NPART, P): the local r, g, b and alpha sums, the local
    transmittance or ``CROSSED`` where it fell below 1e-4, and the z of the
    chunk's first entry at its minimum depth (_BIG where none); idx
    (n_pairs, P) int32, that entry's index or -1), on the rows of
    :func:`chunk_plan`; the other rows are zero (idx -1)."""
    A, dev = active_id.shape[0], entries.device
    n_pairs = num_pairs(entries.shape[1], A)
    end = chunk_plan(seg_start, seg_count, n_active, ncmax, n_pairs).long()
    part = torch.zeros((n_pairs + 1, NPART, P), dtype=torch.float32, device=dev)  # the last row takes the rest
    idx = torch.full((n_pairs + 1, P), -1, dtype=torch.int32, device=dev)
    n = min(int(n_active), A)
    c0 = torch.cat([end.new_zeros(1), end[:-1]])[:n]
    astart = torch.div(seg_start[:n].long(), CHUNK, rounding_mode="floor") * CHUNK
    for k, in_range, _, alpha, log1m, colors, mesh in _slot_chunks(
            entries, active_id, seg_start, seg_count, n, num_tiles_x, ncmax, with_mesh):
        row = torch.where(in_range, c0 + k, n_pairs)
        cum = torch.cumsum(log1m, dim=-1)
        t_incl = torch.exp(cum)
        w = torch.where(t_incl < T_EPS, 0.0, torch.exp(cum - log1m) * alpha)  # (n, P, CHUNK)
        crossed = (t_incl < T_EPS).any(dim=-1)
        vals = [torch.einsum("npl,cnl->ncp", w, colors), w.sum(dim=-1)[:, None],
                torch.where(crossed, CROSSED, t_incl[..., -1])[:, None]]
        if mesh is not None:
            z_min, first = _first_lane_at_min(mesh[0])
            vals.append(z_min[:, None])
            idx.index_copy_(0, row, torch.where(z_min < _BIG, (astart + k * CHUNK)[:, None] + first, -1).to(torch.int32))
        part[:, : 5 + (mesh is not None)].index_copy_(0, row, torch.cat(vals, dim=1))
    return part[:n_pairs], idx[:n_pairs]


@torch.no_grad()
def frame_split_plain(entries, active_id, seg_start, seg_count, n_active, num_tiles_x: int, ncmax: int = NCMAX,
                      with_mesh: bool = True, stats: dict | None = None):
    """Kernel B1 as its two launches compute it, in plain PyTorch: the
    partials of :func:`frame_chunk_partials_plain` (B1a), merged per slot in
    chunk order (B1b).  A chunk that did not cross locally and keeps T * T_k
    >= 1e-4 adds T times its partials and T *= T_k; otherwise the pixel
    re-sweeps that chunk from T with the per-entry rule and, if it stops
    there, takes nothing more.  The z-buffer keeps the first chunk at the
    minimum z.  Returns (rgb (A,3,P), alpha (A,1,P), sel (A,5,P) or None) as
    :func:`frame_sweep_plain`; with ``stats`` (a dict) it also counts the
    re-sweeps: ``resweeps`` (pixel, chunk) and ``resweep_pairs`` (pixel,
    entry)."""
    A, dev = active_id.shape[0], entries.device
    part, idx = frame_chunk_partials_plain(entries, active_id, seg_start, seg_count, n_active, num_tiles_x, ncmax,
                                           with_mesh)
    end = chunk_plan(seg_start, seg_count, n_active, ncmax, part.shape[0]).long()
    f32 = dict(dtype=torch.float32, device=dev)
    rgb, alpha_out = torch.zeros((A, 3, P), **f32), torch.zeros((A, 1, P), **f32)
    sel = torch.zeros((A, 5, P), **f32) if with_mesh else None
    n = min(int(n_active), A)
    c0 = torch.cat([end.new_zeros(1), end[:-1]])[:n]
    T = torch.ones((n, P), **f32)
    acc = torch.zeros((n, 4, P), **f32)  # r, g, b, alpha
    stopped = torch.zeros((n, P), dtype=torch.bool, device=dev)
    best_z = torch.full((n, P), _BIG, **f32)
    best_i = torch.full((n, P), -1, dtype=torch.int32, device=dev)
    resweeps = resweep_pairs = 0
    for k, in_range, lane_ok, alpha, log1m, colors, _ in _slot_chunks(
            entries, active_id, seg_start, seg_count, n, num_tiles_x, ncmax, False):
        p = part[torch.where(in_range, c0 + k, 0)]  # (n, NPART, P)
        live = in_range[:, None] & ~stopped
        t_k = p[:, 4]
        through = live & (t_k != CROSSED) & (T * t_k >= T_EPS)
        acc = torch.where(through[:, None], acc + T[:, None] * p[:, 0:4], acc)
        T = torch.where(through, T * t_k, T)
        again = live & ~through  # the pixel stops in this chunk: re-sweep it from T
        cum = torch.log(T)[..., None] + torch.cumsum(log1m, dim=-1)
        t_incl = torch.exp(cum)
        w = torch.where(again[..., None] & (t_incl >= T_EPS), torch.exp(cum - log1m) * alpha, 0.0)
        acc = acc + torch.cat([torch.einsum("npl,cnl->ncp", w, colors), w.sum(dim=-1)[:, None]], dim=1)
        stop_here = again & (t_incl < T_EPS).any(dim=-1)
        T = torch.where(again & ~stop_here, t_incl[..., -1], T)
        stopped |= stop_here
        resweeps += int(again.sum())
        resweep_pairs += int((again[..., None] & lane_ok[:, None, :]).sum())
        if with_mesh:
            z = p[:, 5]
            better = in_range[:, None] & (z < best_z)
            best_i = torch.where(better, idx[torch.where(in_range, c0 + k, 0)], best_i)
            best_z = torch.where(better, z, best_z)
    rgb[:n], alpha_out[:n, 0] = acc[:, 0:3], acc[:, 3]
    if with_mesh:
        hit = best_i >= 0
        sel[:n, :4] = entries[19:23, best_i.clamp_min(0).long()].permute(1, 0, 2) * hit[:, None]
        sel[:n, 4] = hit.to(torch.float32)
    if stats is not None:
        stats.update(resweeps=resweeps, resweep_pairs=resweep_pairs)
    return rgb, alpha_out, sel


NSWEEP = 5  # B1b's re-sweep rows per pixel: r, g, b, alpha taken, T at the end (or CROSSED)

_PARTIALS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong,  # entries, dcap
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # active_id, seg_start, seg_count
    ctypes.c_void_p,  # n_active
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # active_cap, ncmax, n_pairs, tiles_x, with_mesh
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # part, part_idx, chunk_end, tickets
    ctypes.c_void_p,  # stream
]
_MERGE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong,  # entries, dcap
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # active_id, seg_start, seg_count
    ctypes.c_void_p,  # chunk_end
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # active_cap, n_pairs, tiles_x, with_mesh
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # part, part_idx, sweep, tickets
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rgb, alpha, sel
    ctypes.c_void_p,  # stream
]


def _kernel_fns():
    """The C launchers of (B1a, B1b)."""
    from gomavatar_tpu_torch import cuda_build

    lib = cuda_build.load("frame_render")
    fns = lib.gom_frame_partials, lib.gom_frame_merge
    for fn, argtypes in zip(fns, (_PARTIALS_ARGTYPES, _MERGE_ARGTYPES)):
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fns


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
    CUDA tensor it launches the CUDA kernels B1a then B1b, whose slots at or
    above ``n_active`` are left unwritten (``untile`` never reads them); on a
    CPU tensor it runs :func:`frame_sweep_plain`."""
    if entries.device.type == "cpu":
        return frame_sweep_plain(
            entries, active_id, seg_start, seg_count, n_active, num_tiles_x, ncmax, with_mesh
        )
    if entries.device.type != "cuda":
        raise ValueError(f"kernel B1 runs on CUDA or CPU tensors, not {entries.device}")
    partials = frame_partials(entries, active_id, seg_start, seg_count, n_active, num_tiles_x, ncmax, with_mesh)
    return frame_merge(entries, active_id, seg_start, seg_count, n_active, num_tiles_x, partials, with_mesh)


def frame_partials(entries, active_id, seg_start, seg_count, n_active, num_tiles_x: int, ncmax: int = NCMAX,
                   with_mesh: bool = True):
    """Kernel B1a on CUDA tensors: (part (n_pairs, NPART, P), idx (n_pairs,
    P) int32, chunk_end (A,) int32, tickets (A,) int32): the partials of
    :func:`frame_chunk_partials_plain` on the pairs of the chunk plan (the
    other rows unwritten), the plan (:func:`chunk_plan`), which the kernel
    derives on the device, and B1b's tickets, zeroed."""
    _check_cuda_inputs(entries, active_id, seg_start, seg_count, n_active)
    A, dev = active_id.shape[0], entries.device
    n = num_pairs(entries.shape[1], A)
    part = torch.empty((n, NPART, P), dtype=torch.float32, device=dev)
    idx = torch.empty((n, P), dtype=torch.int32, device=dev)
    chunk_end, tickets = (torch.empty((A,), dtype=torch.int32, device=dev) for _ in range(2))
    launch_kernel("B1a", _kernel_fns()[0], entries, entries.shape[1], active_id, seg_start, seg_count, n_active,
                  A, ncmax, n, num_tiles_x, int(with_mesh), part, idx, chunk_end, tickets)
    frame_partials.launches += 1
    return part, idx, chunk_end, tickets


def frame_merge(entries, active_id, seg_start, seg_count, n_active, num_tiles_x: int, partials,
                with_mesh: bool = True):
    """Kernel B1b on CUDA tensors: B1a's ``partials`` merged per slot into
    (rgb (A,3,P), alpha (A,1,P), sel (A,5,P) or None), slots at or above
    ``n_active`` unwritten.  It leaves the partials and the tickets as it
    found them, so it can run again on them."""
    _check_cuda_inputs(entries, active_id, seg_start, seg_count, n_active)
    A, dev = active_id.shape[0], entries.device
    part, idx, chunk_end, tickets = partials
    n = num_pairs(entries.shape[1], A)
    check_tensor("part", part, (n, NPART, P), dev)
    check_tensor("part_idx", idx, (n, P), dev, torch.int32)
    check_tensor("chunk_end", chunk_end, (A,), dev, torch.int32)
    check_tensor("tickets", tickets, (A,), dev, torch.int32)
    f32 = dict(dtype=torch.float32, device=dev)
    sweep = torch.empty((n, NSWEEP, P), **f32)
    rgb, alpha = torch.empty((A, 3, P), **f32), torch.empty((A, 1, P), **f32)
    sel = torch.empty((A, 5, P), **f32) if with_mesh else None
    launch_kernel("B1b", _kernel_fns()[1], entries, entries.shape[1], active_id, seg_start, seg_count, chunk_end,
                  A, n, num_tiles_x, int(with_mesh), part, idx, sweep, tickets, rgb, alpha, sel)
    frame_merge.launches += 1
    return rgb, alpha, sel


frame_partials.launches = 0
frame_merge.launches = 0


def untile(compact: torch.Tensor, bins: SortedBinning, img_size: tuple[int, int]) -> torch.Tensor:
    """(A, c, P) per-slot tiles -> (H, W, c) image, the whole-tile canvas
    cropped to the frame; tiles without a slot read an appended zeros row
    (a gather, no scatter)."""
    TX, TY = bins.num_tiles_x, bins.num_tiles_y
    c = compact.shape[1]
    full = torch.cat([compact, compact.new_zeros((1,) + compact.shape[1:])])[bins.pos_of_tile.long()]
    canvas = full.reshape(TY, TX, c, TILE, TILE).permute(0, 3, 1, 4, 2).reshape(TY * TILE, TX * TILE, c)
    return crop_frame(canvas, img_size)


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
    entries = gather_entries(table, bins)
    compact = frame_sweep(
        entries, bins.active_id, bins.seg_start, bins.seg_count, bins.n_active,
        bins.num_tiles_x, ncmax=ncmax, with_mesh=shading0 is not None or with_normal,
    )
    return compose_frame(compact, bins, img_size, shading0, with_normal)


def compose_frame(compact, bins: SortedBinning, img_size: tuple[int, int], shading0=None, with_normal: bool = False):
    """B1's compact per-slot outputs (rgb, alpha, sel or None) untiled into
    the frame, the shading applied: the outputs of
    :func:`render_frame_sorted`."""
    rgb_c, alpha_c, sel_c = compact
    rgb = untile(rgb_c, bins, img_size)
    alpha = untile(alpha_c, bins, img_size)[..., 0]
    if sel_c is not None:
        sel = untile(sel_c, bins, img_size)
        hit = sel[..., 4]
        if shading0 is not None:
            shading = torch.where(hit > 0, sel[..., 3], shading0)
            rgb = rgb * shading[..., None]
    if with_normal:
        return rgb, alpha, sel[..., :3], hit
    return rgb, alpha

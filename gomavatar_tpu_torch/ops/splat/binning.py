"""Tile binning (port of gomavatar_tpu/ops/splat/binning.py).

Each primitive emits up to ``max_tiles_per_primitive`` (tile, depth) entries
covering its bounding box; entries are sorted by tile, then by the 21-bit
depth key, then by (primitive id << 2 | pass flags).  Two layouts follow:

* ``bin_sorted`` (the eval renderer, kernel B1): every non-empty tile is a
  (start, count) segment of the sorted order, and non-empty tiles are
  compacted into ``active_cap`` static slots;
* ``bin_bboxes`` (the train kernels B2-B5): the sorted entries are repacked
  so that every tile's segment starts at a 128-aligned offset of a flat
  buffer and is zero-padded to a multiple of 128.

Shapes depend only on the inputs' shapes, so nothing here waits for the
device.

A frame whose side is not a multiple of 16 is covered by ceil(W / 16) x
ceil(H / 16) tiles (:func:`tile_grid`): the kernels sweep the whole-tile
canvas, and the renderers crop it to the frame (:func:`crop_frame`) before
anything reads it.  A box that runs past the frame is clamped into the
last, partial tile, as one past a whole-tile frame is into its last tile.

The sort: the reference sorts the u32 key ``tile << 21 | depth21`` and then
the payload (``lax.sort(num_keys=2)``).  The port packs both into one int64,
``key << 31 | payload``.  The payload stays below 2^31, so this is exact and
positive.  ``key << 32`` would not be: the sentinel tile T = 1024 of a 512^2
frame sets bit 31 of the key, the shifted key overflows the sign, and the
sentinel entries would sort FIRST instead of last.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gomavatar_tpu_torch.utils.profiling import count

TILE = 16  # pixels per tile side
CHUNK = 128  # entries per sweep step of kernel B1; also the alignment unit

_PAYLOAD_BITS = 31


def written_slot_mask(
    tile_start: torch.Tensor, tile_count: torch.Tensor, num_entries: int, ncmax: int
) -> torch.Tensor:
    """(num_entries,) f32 mask: 1 where a train kernel's tile WRITES its
    ``d_entries`` slot, i.e. the first ``min(tile_count, ncmax * CHUNK)``
    entries of each tile's segment.  Gradients of other slots must be
    *selected* out with ``torch.where``: multiplying by 0 keeps a NaN.

    Computed as interval coverage (+1/-1 at the segments' chunk bounds, then
    a cumsum), which stays exact where buffer clamping makes several tiles
    share a ``tile_start``."""
    n_slots = num_entries // CHUNK
    dev = tile_start.device
    nonempty = tile_count > 0
    s = torch.where(nonempty, tile_start.long() // CHUNK, torch.full_like(tile_start, n_slots, dtype=torch.int64))
    e = s + torch.where(
        nonempty, torch.clamp_max(tile_count.long(), ncmax * CHUNK) // CHUNK, torch.zeros_like(s)
    )
    # one spare bin past the end takes what the reference drops
    delta = torch.zeros((n_slots + 2,), dtype=torch.int32, device=dev)
    ones = torch.ones_like(s, dtype=torch.int32)
    delta.index_add_(0, torch.clamp_max(s, n_slots + 1), ones)
    delta.index_add_(0, torch.clamp_max(e, n_slots + 1), -ones)
    covered = torch.cumsum(delta[:n_slots], 0) > 0
    return torch.repeat_interleave(covered.to(torch.float32), CHUNK)


def compact_tiles(tile_start: torch.Tensor, tile_count: torch.Tensor, active_cap: int):
    """Compact non-empty tiles into ``active_cap`` static slots.

    Returns ``(active_id, st, ct, pos_of_tile, n_active, dropped)``: per-slot
    tile id / segment start / count (0 for unused slots), each tile's slot
    (``active_cap`` if empty or over the cap), the number of non-empty tiles,
    and the entries on tiles beyond the cap."""
    T = tile_start.shape[0]
    A = active_cap
    dev = tile_start.device
    nonempty = tile_count > 0
    rank = torch.cumsum(nonempty.to(torch.int32), 0, dtype=torch.int32) - 1
    n_active = torch.sum(nonempty.to(torch.int32)).to(torch.int32)
    in_cap = nonempty & (rank < A)
    slot = torch.where(in_cap, rank, torch.full_like(rank, A)).long()

    def scatter(values):
        # empty/over-cap tiles all land in the trash slot A, which is cut
        # off; a scatter, unlike a boolean mask, never waits for the device
        out = torch.zeros((A + 1,), dtype=torch.int32, device=dev)
        out[slot] = values.to(torch.int32)
        return out[:A]

    active_id = scatter(torch.arange(T, dtype=torch.int32, device=dev))
    st = scatter(tile_start)
    ct = scatter(tile_count)
    over = nonempty & (rank >= A)
    dropped = torch.sum(torch.where(over, tile_count, torch.zeros_like(tile_count))).to(torch.int32)
    return active_id, st, ct, slot.to(torch.int32), n_active, dropped


def depth_sort_bits(depth: torch.Tensor) -> torch.Tensor:
    """21-bit monotone sort key of a positive f32 depth: the bit pattern of a
    positive float is order-preserving, and the low 11 mantissa bits are
    dropped (~2e-4 relative resolution).  int64 result."""
    bits = torch.clamp_min(depth.to(torch.float32), 0.0).contiguous().view(torch.int32)
    return (bits.to(torch.int64) & 0xFFFFFFFF) >> 11


class BinningTelemetry(NamedTuple):
    """Overflow counters for the static binning budgets (0-d int32 tensors).
    All zero means the binning covered every (primitive, tile) pair."""

    truncated_prims: torch.Tensor  # primitives whose bbox covers > budget tiles
    dropped_budget: torch.Tensor  # (prim, tile) entries dropped to that budget
    dropped_buffer: torch.Tensor  # entries dropped to the Dcap prefix or active cap
    max_tile_entries: torch.Tensor  # max real entries in any tile
    # the most tiles any valid primitive's box covers: what the
    # per-primitive budget has to hold (None where built from telemetry
    # without it, such as the JAX package's)
    most_tiles: torch.Tensor | None = None

    def total_dropped(self) -> torch.Tensor:
        return self.dropped_budget + self.dropped_buffer


class TileBinning(NamedTuple):
    """128-aligned per-tile segments of a flat entry buffer (the train
    kernels' layout).  ``entry_splat``/``entry_mesh`` are 1 iff the entry's
    tile lies in the primitive's own splat/mesh box: a union binning serves
    both passes, and each pass gates its entries with its flag."""

    entry_gauss: torch.Tensor  # (Dp,) int64 primitive index per entry (0 for pad)
    entry_valid: torch.Tensor  # (Dp,) f32 1/0 (0 for pad)
    entry_splat: torch.Tensor  # (Dp,) f32 1/0
    entry_mesh: torch.Tensor  # (Dp,) f32 1/0
    tile_start: torch.Tensor  # (T,) int32, 128-aligned offsets into the entries
    tile_count: torch.Tensor  # (T,) int32, multiples of CHUNK (padded counts)
    num_tiles_x: int
    num_tiles_y: int
    telemetry: BinningTelemetry
    # mesh_ops.DualIndex of entry_gauss over the primitives, pads left out:
    # the train path sets it to transpose its entry gathers by a gather
    entry_dual: Any = None


class SortedBinning(NamedTuple):
    """Per-tile entry lists as (start, count) ranges into the depth-sorted
    entry order; kernel B1 reads each segment from its aligned-down 128
    boundary and masks the head and tail lanes."""

    order: torch.Tensor  # (Dcap,) int64 primitive index per sorted entry
    entry_splat: torch.Tensor  # (Dcap,) f32 per-entry splat-pass flag
    entry_mesh: torch.Tensor  # (Dcap,) f32 per-entry mesh-pass flag
    active_id: torch.Tensor  # (A,) int32 tile id per active slot (0 for unused)
    seg_start: torch.Tensor  # (A,) int32 segment starts into `order`
    seg_count: torch.Tensor  # (A,) int32 counts (0 for unused slots)
    pos_of_tile: torch.Tensor  # (T,) int32 active slot of each tile, A if none
    n_active: torch.Tensor  # () int32
    num_tiles_x: int
    num_tiles_y: int
    telemetry: BinningTelemetry


def tile_grid(img_size) -> tuple[int, int]:
    """(TX, TY): the tiles that cover a (W, H) frame, the last column and
    row partial where a side is not a multiple of TILE.  Their whole-tile
    canvas is (TY * TILE, TX * TILE) pixels; what lies past the frame is no
    part of it (:func:`crop_frame`)."""
    W, H = img_size
    return -(-int(W) // TILE), -(-int(H) // TILE)


def crop_frame(x: torch.Tensor, img_size) -> torch.Tensor:
    """The (H, W, ...) frame of a whole-tile canvas (Hc, Wc, ...): a view of
    its first H rows and W columns, or ``x`` itself where the frame fills
    the canvas, so whole-tile frames run as they did.  The pixels past the
    frame take no part in any output, loss or gradient (autograd's backward
    of the view pads their cotangent with zeros)."""
    W, H = img_size
    if x.shape[0] == H and x.shape[1] == W:
        return x
    return x[:H, :W]


def count_frame(img_size) -> None:
    """Count a frame's pixels, ``frame.px`` (W H), and the lanes that the
    kernels sweep over its whole tiles, ``frame.swept_px`` (TX TY 256), when
    spans and counters are recorded (``utils/profiling.py``)."""
    TX, TY = tile_grid(img_size)
    count("frame.px", int(img_size[0]) * int(img_size[1]))
    count("frame.swept_px", TX * TY * TILE * TILE)


def _most_tiles(n_cover: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The most tiles a valid primitive covers, a 0-d int32 tensor."""
    return torch.max(torch.where(valid.to(torch.bool), n_cover, torch.zeros_like(n_cover))).to(torch.int32)


def _tile_ranges(x0, x1, y0, y1, TX, TY):
    """Pixel bbox -> inclusive tile-index ranges (clipped to the grid)."""
    def cl(v, n):
        return torch.clamp(torch.floor(v / TILE), 0, n - 1).to(torch.int64)

    return cl(x0, TX), cl(x1, TX), cl(y0, TY), cl(y1, TY)


def _pack_payload(idx, tx, ty, flag_boxes, TX, TY, expand):
    """Sort payload: primitive index in the high bits (equal-depth ties break
    on the index, like the CUDA rasterizer's stable radix sort), per-pass
    flag bits in the low 2 bits.  ``expand`` broadcasts an (N,) array to the
    (M, N) enumeration layout of ``tx``/``ty``."""
    if flag_boxes is None:
        return (idx << 2) | 3
    bits = []
    for bx0, bx1, by0, by1, bvalid in flag_boxes:
        tx0, tx1, ty0, ty1 = _tile_ranges(bx0, bx1, by0, by1, TX, TY)
        inside = (
            (tx >= expand(tx0)) & (tx <= expand(tx1))
            & (ty >= expand(ty0)) & (ty <= expand(ty1))
            & expand(bvalid)
        )
        bits.append(inside.to(torch.int64))
    return (idx << 2) | bits[0] | (bits[1] << 1)


def _sorted_entry_keys(
    x0, y0, bw, n_cover, valid, depth, flag_boxes,
    TX, TY, T, M, band0, overflow_cap,
):
    """Enumerate (primitive, covered-tile) entries and sort them by (tile,
    depth21, payload).  Returns ``(s_key, s_payload, total_slots, lost_cap,
    trimmed_prims)``.

    Two-band enumeration (``band0`` not None): band A holds the first
    ``band0`` covered tiles of every primitive; primitives covering more are
    compacted, in ascending id, into ``overflow_cap`` slots that enumerate
    their remaining ``M - band0`` tiles in band B.  Primitives beyond the cap
    lose those tiles, reported as ``lost_cap`` entries / ``trimmed_prims``."""
    N = x0.shape[0]
    dev = x0.device
    depth_bits = depth_sort_bits(depth)
    ids = torch.arange(N, dtype=torch.int64, device=dev)

    def band_keys(j, x0_, y0_, bw_, n_cover_, valid_, depth_bits_, idx_, fb):
        # covered tile j of each primitive, laid out (len(j), n)
        ty = y0_[None, :] + torch.div(j, bw_[None, :], rounding_mode="floor")
        tx = x0_[None, :] + torch.remainder(j, bw_[None, :])
        ok = (j < n_cover_[None, :]) & valid_[None, :]
        tile_id = torch.where(ok, ty * TX + tx, torch.full_like(tx, T))  # sentinel sorts last
        key = (tile_id << 21) | depth_bits_[None, :]
        idx2 = idx_[None, :].expand(tile_id.shape)
        payload = _pack_payload(idx2, tx, ty, fb, TX, TY, lambda a: a[None, :])
        return key.reshape(-1), payload.reshape(-1)

    B0 = M if band0 is None else min(band0, M)
    j = torch.arange(B0, dtype=torch.int64, device=dev)[:, None]
    flat_key, flat_payload = band_keys(j, x0, y0, bw, n_cover, valid, depth_bits, ids, flag_boxes)
    lost_cap = torch.zeros((), dtype=torch.int64, device=dev)
    trimmed_prims = torch.zeros((), dtype=torch.int64, device=dev)
    total_slots = B0 * N
    if B0 < M:
        K = min(max(N // 8 if overflow_cap is None else overflow_cap, 1), N)
        over_mask = (n_cover > B0) & valid
        oid = torch.sort(torch.where(over_mask, ids, torch.full_like(ids, N))).values[:K]
        ovalid = oid < N
        o = torch.clamp_max(oid, N - 1)
        fb_o = None
        if flag_boxes is not None:
            fb_o = tuple(tuple(arr[o] for arr in box) for box in flag_boxes)
        jb = torch.arange(B0, M, dtype=torch.int64, device=dev)[:, None]
        key_b, payload_b = band_keys(
            jb, x0[o], y0[o], bw[o], torch.where(ovalid, n_cover[o], torch.zeros_like(o)),
            ovalid, depth_bits[o], o, fb_o,
        )
        flat_key = torch.cat([flat_key, key_b])
        flat_payload = torch.cat([flat_payload, payload_b])
        total_slots += (M - B0) * K
        rank = torch.cumsum(over_mask.to(torch.int64), 0) - 1
        cap_trim = over_mask & (rank >= K)
        lost_cap = torch.sum(torch.where(cap_trim, torch.clamp_max(n_cover, M) - B0, 0))
        trimmed_prims = torch.sum(cap_trim.to(torch.int64))
    # one int64 sort on (key << 31 | payload): see the module docstring
    packed = torch.sort((flat_key << _PAYLOAD_BITS) | flat_payload).values
    s_key = packed >> _PAYLOAD_BITS
    s_payload = packed & ((1 << _PAYLOAD_BITS) - 1)
    return s_key, s_payload, total_slots, lost_cap, trimmed_prims


def bin_sorted(
    bx0: torch.Tensor,
    bx1: torch.Tensor,
    by0: torch.Tensor,
    by1: torch.Tensor,
    depth: torch.Tensor,
    valid: torch.Tensor,
    img_size: tuple[int, int],
    max_tiles_per_primitive: int = 16,
    buffer_factor: int = 4,
    active_cap: int = 512,
    flag_boxes=None,
    band0: int | None = None,
    overflow_cap: int | None = None,
) -> SortedBinning:
    """Bin primitives into depth-sorted per-tile segments (see SortedBinning).

    Real entries form a prefix of the sorted order (sentinel tiles sort
    last), so only the first ``Dcap`` entries are kept; telemetry counts the
    entries lost to the per-primitive budget, to the Dcap prefix and to the
    active-tile cap.  ``flag_boxes`` = (splat_box, mesh_box), each
    (bx0, bx1, by0, by1, valid), records per entry whether its tile lies in
    each pass's own box."""
    TX, TY = tile_grid(img_size)
    T = TX * TY
    # the sort key holds tile_id (sentinel = T) in 11 bits above the depth
    if T >= 2048:
        raise ValueError(f"{TX}x{TY}={T} tiles overflows the 11-bit sort key")
    N = bx0.shape[0]
    M = max_tiles_per_primitive
    A = active_cap
    dev = bx0.device

    x0, x1, y0, y1 = _tile_ranges(bx0, bx1, by0, by1, TX, TY)
    bw = x1 - x0 + 1
    n_cover = bw * (y1 - y0 + 1)

    s_key, s_payload, total_slots, lost_cap, trimmed_prims = _sorted_entry_keys(
        x0, y0, bw, n_cover, valid, depth, flag_boxes,
        TX, TY, T, M, band0, overflow_cap,
    )

    bounds = torch.arange(T + 1, dtype=torch.int64, device=dev) << 21
    start = torch.searchsorted(s_key, bounds)
    counts = start[1:] - start[:-1]
    start = start[:-1]

    # clamp segments to the gathered prefix [0, Dcap).  Dcap is CHUNK-aligned
    # so B1's aligned-down chunk reads never overrun the entry array; the
    # min(T, A)*CHUNK slack keeps small scenes drop-free.
    Dcap = min(
        ((N * buffer_factor + min(T, A) * CHUNK + CHUNK - 1) // CHUNK) * CHUNK,
        ((total_slots + CHUNK - 1) // CHUNK) * CHUNK,
    )
    kept = torch.clamp_min(torch.clamp_max(start + counts, Dcap) - torch.clamp_max(start, Dcap), 0)
    start = torch.clamp_max(start, Dcap - 1)

    active_id, seg_start, seg_count, pos_of_tile, n_active, dropped_active = compact_tiles(
        start, kept, A
    )

    over = torch.clamp_min(n_cover - M, 0) * valid.to(torch.int64)
    telemetry = BinningTelemetry(
        truncated_prims=(torch.sum((over > 0).to(torch.int64)) + trimmed_prims).to(torch.int32),
        dropped_budget=(torch.sum(over) + lost_cap).to(torch.int32),
        dropped_buffer=(torch.sum(counts - kept) + dropped_active).to(torch.int32),
        max_tile_entries=torch.max(counts).to(torch.int32),
        most_tiles=_most_tiles(n_cover, valid),
    )

    if Dcap <= total_slots:
        packed = s_payload[:Dcap]
    else:
        packed = torch.cat(
            [s_payload, torch.zeros((Dcap - total_slots,), dtype=s_payload.dtype, device=dev)]
        )
    return SortedBinning(
        order=packed >> 2,
        entry_splat=(packed & 1).to(torch.float32),
        entry_mesh=((packed >> 1) & 1).to(torch.float32),
        active_id=active_id,
        seg_start=seg_start,
        seg_count=seg_count,
        pos_of_tile=pos_of_tile,
        n_active=n_active,
        num_tiles_x=TX,
        num_tiles_y=TY,
        telemetry=telemetry,
    )


def bin_bboxes(
    bx0: torch.Tensor,
    bx1: torch.Tensor,
    by0: torch.Tensor,
    by1: torch.Tensor,
    depth: torch.Tensor,
    valid: torch.Tensor,
    img_size: tuple[int, int],
    max_tiles_per_primitive: int = 32,
    buffer_factor: int = 8,
    flag_boxes=None,
    band0: int | None = None,
    overflow_cap: int | None = None,
) -> TileBinning:
    """Bin primitives given pixel bounding boxes into 128-aligned per-tile
    segments of a flat buffer of ``(N * buffer_factor + T * CHUNK) // CHUNK``
    chunks (see TileBinning).  Segments that would overflow the buffer are
    clamped, and the telemetry counts what was dropped.  ``flag_boxes`` =
    (splat_box, mesh_box) records per-entry pass membership, as in
    :func:`bin_sorted`."""
    TX, TY = tile_grid(img_size)
    T = TX * TY
    # the sort key holds tile_id (sentinel = T) in 11 bits above the depth
    if T >= 2048:
        raise ValueError(f"{TX}x{TY}={T} tiles overflows the 11-bit sort key")
    N = bx0.shape[0]
    M = max_tiles_per_primitive
    dev = bx0.device

    x0, x1, y0, y1 = _tile_ranges(bx0, bx1, by0, by1, TX, TY)
    bw = x1 - x0 + 1
    n_cover = bw * (y1 - y0 + 1)

    s_key, s_payload, _, lost_cap, trimmed_prims = _sorted_entry_keys(
        x0, y0, bw, n_cover, valid, depth, flag_boxes,
        TX, TY, T, M, band0, overflow_cap,
    )

    bounds = torch.arange(T + 1, dtype=torch.int64, device=dev) << 21
    start = torch.searchsorted(s_key, bounds)
    counts = start[1:] - start[:-1]  # (T,) real entries per tile
    start = start[:-1]

    # 128-aligned repack as a gather: segments are laid out in tile order,
    # so the tile owning an output chunk is found by one search per chunk
    padded_counts = ((counts + CHUNK - 1) // CHUNK) * CHUNK
    aligned_start = torch.cat(
        [torch.zeros((1,), dtype=torch.int64, device=dev), torch.cumsum(padded_counts, 0)[:-1]]
    )
    Dp = N * buffer_factor + T * CHUNK
    n_slots = Dp // CHUNK
    slot_d = torch.arange(n_slots, dtype=torch.int64, device=dev) * CHUNK
    t_of_slot = torch.searchsorted(aligned_start, slot_d, right=True) - 1
    slot_r0 = slot_d - aligned_start[t_of_slot]
    slot_src0 = start[t_of_slot] + slot_r0
    slot_count = counts[t_of_slot]
    lane = torch.arange(CHUNK, dtype=torch.int64, device=dev)[None, :]
    real = ((slot_r0[:, None] + lane) < slot_count[:, None]).reshape(-1)
    # each output chunk is a contiguous 128-run of the sorted payload; the
    # zero tail keeps every run in bounds (a run may start at the end)
    payload_pad = torch.cat([s_payload, torch.zeros((CHUNK,), dtype=s_payload.dtype, device=dev)])
    src = torch.clamp(slot_src0, 0, payload_pad.shape[0] - CHUNK)
    packed = payload_pad[src[:, None] + lane].reshape(-1)
    packed = torch.where(real, packed, torch.zeros_like(packed))

    # clamp the counts of tiles whose aligned segment would overflow the buffer
    seg_end = torch.clamp_max(aligned_start + padded_counts, Dp)
    tile_count = torch.clamp_min(seg_end - torch.clamp_max(aligned_start, Dp), 0)
    tile_count = (tile_count // CHUNK) * CHUNK
    tile_start = torch.clamp_max(aligned_start, Dp - CHUNK)

    over = torch.clamp_min(n_cover - M, 0) * valid.to(torch.int64)
    kept = torch.minimum(counts, tile_count)
    telemetry = BinningTelemetry(
        truncated_prims=(torch.sum((over > 0).to(torch.int64)) + trimmed_prims).to(torch.int32),
        dropped_budget=(torch.sum(over) + lost_cap).to(torch.int32),
        dropped_buffer=torch.sum(counts - kept).to(torch.int32),
        max_tile_entries=torch.max(counts).to(torch.int32),
        most_tiles=_most_tiles(n_cover, valid),
    )
    return TileBinning(
        entry_gauss=packed >> 2,
        entry_valid=real.to(torch.float32),
        entry_splat=(packed & 1).to(torch.float32),
        entry_mesh=((packed >> 1) & 1).to(torch.float32),
        tile_start=tile_start.to(torch.int32),
        tile_count=tile_count.to(torch.int32),
        num_tiles_x=TX,
        num_tiles_y=TY,
        telemetry=telemetry,
    )


def bin_gaussians(
    mean2d: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,
    valid: torch.Tensor,
    img_size: tuple[int, int],
    max_tiles_per_gaussian: int = 32,
    buffer_factor: int = 8,
    band0: int | None = None,
    overflow_cap: int | None = None,
) -> TileBinning:
    """:func:`bin_bboxes` of the gaussians' square radius boxes: mean2d
    (N, 2) pixel centres, radius (N,) pixel radii (0 = culled)."""
    r = torch.where(valid, radius, torch.zeros_like(radius))
    return bin_bboxes(
        mean2d[:, 0] - r, mean2d[:, 0] + r, mean2d[:, 1] - r, mean2d[:, 1] + r,
        depth, valid, img_size,
        max_tiles_per_primitive=max_tiles_per_gaussian,
        buffer_factor=buffer_factor,
        band0=band0,
        overflow_cap=overflow_cap,
    )

"""gomavatar_tpu_torch bin_sorted against gomavatar_tpu's: the same box
inputs give IDENTICAL integers (each real segment of ``order`` and its pass
flags, active_id, seg_start, seg_count, pos_of_tile, n_active, telemetry).

The 512^2 case has 1024 tiles, so the sentinel tile id (T = 1024) sets bit
31 of the u32 sort key: a port that packed ``key << 32 | payload`` into an
int64 would overflow the sign and sort the sentinels first."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.ops.splat import binning as JB
from gomavatar_tpu_torch.ops.splat import binning as TB
from torch_port_scene import assert_bins_identical
from torch_threads import one_torch_thread  # noqa: F401


def _random_boxes(seed, img, N=400, r_max=9.0):
    W, H = img
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-10, W + 10, N).astype(np.float32)
    cy = rng.uniform(-10, H + 10, N).astype(np.float32)
    r = rng.uniform(0.5, r_max, N).astype(np.float32)
    depth = rng.uniform(0.5, 5, N).astype(np.float32)
    # a few exact depth ties, so the primitive-id tie-break is exercised
    depth[1::7] = depth[0]
    valid = rng.random(N) > 0.1
    return [cx - r, cx + r, cy - r, cy + r, depth, valid]


def _flag_boxes(arrs):
    bx0, bx1, by0, by1, _, valid = arrs
    # two sub-boxes whose union is the outer box (splat shrunk, mesh shifted)
    return (bx0, bx1 - 3.0, by0, by1, valid), (bx0 + 2.0, bx1, by0, by1, valid)


def _run_both(arrs, img, flags=False, **kw):
    jargs = [jnp.asarray(a) for a in arrs]
    targs = [torch.as_tensor(a) for a in arrs]
    if flags:
        kw_j = dict(kw, flag_boxes=tuple(tuple(jnp.asarray(a) for a in b) for b in _flag_boxes(arrs)))
        kw_t = dict(kw, flag_boxes=tuple(tuple(torch.as_tensor(a) for a in b) for b in _flag_boxes(arrs)))
    else:
        kw_j = kw_t = kw
    return JB.bin_sorted(*jargs, img, **kw_j), TB.bin_sorted(*targs, img, **kw_t)


CASES_64 = {
    "single_band": dict(band0=None),
    "two_bands": dict(band0=4, overflow_cap=400),
    "two_bands_capped": dict(band0=4, overflow_cap=8),  # trimmed primitives counted
}


@pytest.mark.parametrize("case", sorted(CASES_64))
@pytest.mark.parametrize("flags", [False, True])
def test_bin_sorted_identical_64(case, flags):
    img = (64, 64)
    arrs = _random_boxes(2, img, r_max=20.0)
    j, t = _run_both(arrs, img, flags=flags, max_tiles_per_primitive=16, buffer_factor=8,
                     active_cap=16, **CASES_64[case])
    assert_bins_identical(j, t)
    if case == "two_bands_capped":
        assert int(t.telemetry.dropped_budget) > 0


def test_bin_sorted_active_cap_overflow():
    img = (64, 64)
    rng = np.random.default_rng(2)
    N = 300
    cx = rng.uniform(0, 64, N).astype(np.float32)
    cy = rng.uniform(0, 64, N).astype(np.float32)
    r = np.full(N, 6.0, np.float32)
    arrs = [cx - r, cx + r, cy - r, cy + r, rng.uniform(1, 2, N).astype(np.float32), np.ones(N, bool)]
    j, t = _run_both(arrs, img, max_tiles_per_primitive=16, buffer_factor=8, active_cap=2)
    assert_bins_identical(j, t)
    assert int(t.n_active) > 2 and int(t.telemetry.dropped_buffer) > 0


@pytest.mark.parametrize("band0", [None, 4])
def test_bin_sorted_identical_512(band0):
    img = (512, 512)
    arrs = _random_boxes(7, img, N=6000, r_max=24.0)
    j, t = _run_both(arrs, img, flags=True, max_tiles_per_primitive=32, buffer_factor=4,
                     active_cap=512, band0=band0, overflow_cap=2048)
    assert t.num_tiles_x * t.num_tiles_y == 1024
    assert_bins_identical(j, t)
    # real entries form a prefix of the sorted order: every segment lies
    # below the number of real entries
    real = int(t.seg_count.sum())
    n = int(t.n_active)
    assert int((t.seg_start[:n] + t.seg_count[:n]).max()) <= real


def test_depth_sort_bits_and_compact_tiles():
    rng = np.random.default_rng(3)
    depth = np.concatenate([rng.uniform(0.01, 100, 500), [0.0, -1.0, 1e-30]]).astype(np.float32)
    np.testing.assert_array_equal(
        TB.depth_sort_bits(torch.as_tensor(depth)).numpy(),
        np.asarray(JB.depth_sort_bits(jnp.asarray(depth))).astype(np.int64),
    )
    start = np.sort(rng.integers(0, 5000, 64)).astype(np.int32)
    count = (rng.integers(0, 40, 64) * (rng.random(64) > 0.4)).astype(np.int32)
    for cap in (8, 64):
        jo = JB.compact_tiles(jnp.asarray(start), jnp.asarray(count), cap)
        to = TB.compact_tiles(torch.as_tensor(start), torch.as_tensor(count), cap)
        for a, b in zip(to, jo):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

"""The train path's binning of gomavatar_tpu_torch against gomavatar_tpu:
``bin_bboxes`` (with and without the per-pass flag boxes and the two-band
layout), ``bin_gaussians``, ``written_slot_mask`` and ``frame_union_bins``
give IDENTICAL integers on the same inputs (entry_gauss, entry_valid,
entry_splat, entry_mesh, tile_start, tile_count and the telemetry), on the
64^2 gate scene and on the trained avatar's 512^2 frame."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.ops import fused_render as JF
from gomavatar_tpu.ops.splat import binning as JB
from gomavatar_tpu_torch.convert import load_trained
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.ops import fused_render as TF
from gomavatar_tpu_torch.ops.splat import binning as TB
from gomavatar_tpu_torch.scene import gate_scene
from torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("entry_gauss", "entry_valid", "entry_splat", "entry_mesh", "tile_start", "tile_count")


def assert_tile_bins_identical(j, t):
    assert (t.num_tiles_x, t.num_tiles_y) == (j.num_tiles_x, j.num_tiles_y)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    for f in j.telemetry._fields:
        assert int(getattr(t.telemetry, f)) == int(getattr(j.telemetry, f)), f


def _random_boxes(seed, img, N, r_max):
    W, H = img
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-10, W + 10, N).astype(np.float32)
    cy = rng.uniform(-10, H + 10, N).astype(np.float32)
    r = rng.uniform(0.5, r_max, N).astype(np.float32)
    depth = rng.uniform(0.5, 5, N).astype(np.float32)
    depth[1::7] = depth[0]  # exact depth ties: the primitive-id tie-break
    valid = rng.random(N) > 0.1
    return [cx - r, cx + r, cy - r, cy + r, depth, valid]


CASES = {
    "single_band": dict(band0=None),
    "two_bands": dict(band0=4, overflow_cap=400),
    "two_bands_capped": dict(band0=4, overflow_cap=8),  # trimmed primitives counted
    # large boxes into a one-entry-per-primitive buffer: segments clamped,
    # dropped_buffer > 0
    "small_buffer": dict(band0=None, buffer_factor=1, r_max=40.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("flags", [False, True])
def test_bin_bboxes_identical_64(case, flags):
    img = (64, 64)
    kw = dict(max_tiles_per_primitive=16, buffer_factor=8)
    kw.update(CASES[case])
    arrs = _random_boxes(2, img, 400, kw.pop("r_max", 20.0))
    if flags:
        bx0, bx1, by0, by1, _, valid = arrs
        boxes = ((bx0, bx1 - 3.0, by0, by1, valid), (bx0 + 2.0, bx1, by0, by1, valid))
        kw_j = dict(kw, flag_boxes=tuple(tuple(jnp.asarray(a) for a in b) for b in boxes))
        kw_t = dict(kw, flag_boxes=tuple(tuple(torch.as_tensor(a) for a in b) for b in boxes))
    else:
        kw_j = kw_t = kw
    j = JB.bin_bboxes(*(jnp.asarray(a) for a in arrs), img, **kw_j)
    t = TB.bin_bboxes(*(torch.as_tensor(a) for a in arrs), img, **kw_t)
    assert_tile_bins_identical(j, t)
    if case == "small_buffer":
        assert int(t.telemetry.dropped_buffer) > 0
    if case == "two_bands_capped":
        assert int(t.telemetry.dropped_budget) > 0
    # the train kernels' written-slot mask, with and without the chunk cap
    for ncmax in (64, 1):
        np.testing.assert_array_equal(
            TB.written_slot_mask(t.tile_start, t.tile_count, t.entry_gauss.shape[0], ncmax).numpy(),
            np.asarray(JB.written_slot_mask(j.tile_start, j.tile_count, j.entry_gauss.shape[0], ncmax)),
        )


def test_bin_gaussians_identical():
    rng = np.random.default_rng(5)
    N = 300
    mean = rng.uniform(-5, 69, (N, 2)).astype(np.float32)
    radius = rng.uniform(0, 12, N).astype(np.float32)
    depth = rng.uniform(0.5, 4, N).astype(np.float32)
    valid = rng.random(N) > 0.2
    args = (mean, radius, depth, valid)
    j = JB.bin_gaussians(*(jnp.asarray(a) for a in args), (64, 64), max_tiles_per_gaussian=8, buffer_factor=4)
    t = TB.bin_gaussians(*(torch.as_tensor(a) for a in args), (64, 64), max_tiles_per_gaussian=8, buffer_factor=4)
    assert_tile_bins_identical(j, t)


def _union_inputs(params, statics, cfg, frame):
    """The train forward's inputs of frame_union_bins, as numpy."""
    verts = TG.posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                              frame["dst_posevec"])
    g = TG.train_geometry(params, statics, cfg, verts, frame["K"], frame["E"])
    out = dict(centroids=g["centroids"], cov3d=g["cov"], verts=verts, faces=statics.faces,
               K=frame["K"], E=frame["E"])
    return {k: v.detach().numpy() for k, v in out.items()}


def _union_both(inp, cfg, band0):
    W, H = cfg.img_size
    margin = (TG.np_log_blur(cfg.normal_renderer_sigma) ** 0.5) / (2.0 / min(W, H)) + 1.0
    kw = dict(blur_margin_px=margin, max_tiles_per_primitive=cfg.max_tiles_per_gaussian,
              buffer_factor=cfg.buffer_factor, band0=band0, overflow_cap=max(cfg.num_faces // 8, 2048))
    order = ("centroids", "cov3d", "verts", "faces", "K", "E")
    j = JF.frame_union_bins(*(jnp.asarray(inp[k]) for k in order), cfg.img_size, **kw)
    with torch.no_grad():
        t = TF.frame_union_bins(*(torch.as_tensor(inp[k]) for k in order), cfg.img_size, **kw)
    return j, t


def _check_union(j, t):
    assert_tile_bins_identical(j[4], t[4])
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))  # in_front
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-6)  # tris_xy
    assert int(t[4].telemetry.total_dropped()) == 0


@pytest.mark.parametrize("band0", [None, 4])
def test_frame_union_bins_identical_gate(band0):
    params, statics, cfg, frame = gate_scene(device="cpu", seed=0)
    _check_union(*_union_both(_union_inputs(params, statics, cfg, frame), cfg, band0))


@pytest.fixture(scope="module")
def trained_inputs():
    params, statics, cfg, frame = load_trained(device="cpu")
    with torch.no_grad():
        return _union_inputs(params, statics, cfg, frame), cfg


@pytest.mark.parametrize("band0", [None, 4])
def test_frame_union_bins_identical_trained_512(trained_inputs, band0):
    inp, cfg = trained_inputs
    assert cfg.num_faces == 57600 and cfg.img_size == (512, 512)
    j, t = _union_both(inp, cfg, band0)
    _check_union(j, t)
    assert t[4].num_tiles_x * t[4].num_tiles_y == 1024

"""The decompositions kernels B4 and B1 compute, held to gomavatar_tpu on the
CPU.

Both kernels run as two launches, one block per chunk and then one per
tile; their plain-PyTorch twins live in the package, so that the chip smoke
holds the kernels to them as well:
* B4 "per chunk, then merged" (``mesh_raster.mesh_split_plain``): each
  chunk's hard partial (its first entry at the minimum z, as (z, entry
  index)) and soft partial (its sum of log(1 - p) from 0), then the merge
  in chunk order with the saturation rule;
* B1 "per (tile, chunk), then merged" (``frame_render.frame_split_plain``):
  each chunk's colour and alpha sums, transmittance and z-buffer partial
  from T = 1, then the merge in chunk order with one re-sweep of the chunk
  where the pixel's transmittance is spent.
Each twin runs on numpy-seeded inputs against the one-pass plain version and
the reference's Pallas kernel in interpret mode, at the tolerances of
tests/test_torch_mesh_raster.py and tests/test_torch_frame_render.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gomavatar_tpu.ops import frame_render as JF
from gomavatar_tpu.ops import mesh_raster_pallas as JRP
from gomavatar_tpu_torch.models import modules as M
from gomavatar_tpu_torch.models.gom import frame_table_and_bins, posed_vertices, train_geometry
from gomavatar_tpu_torch.ops import frame_render as TF
from gomavatar_tpu_torch.ops import mesh_raster as TR
from gomavatar_tpu_torch.ops.splat.binning import CHUNK
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, P
from gomavatar_tpu_torch.scene import gate_scene
from torch_port_scene import assert_close_frac
from torch_threads import one_torch_thread  # noqa: F401

S_RTOL, SOFT_TOL = 1e-6, 1e-6
HIT_FRAC, SEL_TOL = 0.999, 1e-4  # B1's selection: hit equal, normal and shading where the hits agree


# ---- B4: per-chunk partials, merged in chunk order ---------------------------

def _gate_mesh_inputs():
    """The gate scene's mesh entries as the port's train forward builds them
    (64^2, 792 faces, seed 0): (entries, tile_start, tile_count, TX, TY,
    sigma_px2)."""
    params, statics, cfg, frame = gate_scene(device="cpu", seed=0)
    K, E = frame["K"], frame["E"]
    with torch.no_grad():
        verts = posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                               frame["dst_posevec"])
        g = train_geometry(params, statics, cfg, verts, K, E)
        tris_xy, tris_z, in_front = TR.project_faces(verts, statics.faces, K, E)
        entries, _ = TR.mesh_entries(tris_xy, tris_z, in_front, g["normals_cam"], statics.faces, g["bins"])
    bins = g["bins"]
    return (entries.contiguous(), bins.tile_start, bins.tile_count, bins.num_tiles_x, bins.num_tiles_y,
            TR.soft_sigma_px2(1e-4, cfg.img_size))


def _covered_tile(rng, n_chunks, cover=True):
    """2x2 tiles of 16 px; tile 0 owns ``n_chunks`` chunks of small random
    triangles; with ``cover``, entries 5 and 6 of chunk 0 are two triangles
    over the whole tile, so that every pixel has S < -18 after chunk 0."""
    D = (n_chunks + 3) * CHUNK
    E = n_chunks * CHUNK
    entries = torch.zeros((16, D))
    centre = rng.uniform(-3, 19, (2, E))
    entries[0:6, :E] = torch.tensor(np.concatenate([centre + rng.normal(0, 2, (2, E)) for _ in range(3)]),
                                    dtype=torch.float32)
    entries[6:9, :E] = torch.tensor(rng.uniform(1, 3, (3, E)), dtype=torch.float32)
    entries[9:12, :E] = torch.tensor(rng.normal(0, 1, (3, E)), dtype=torch.float32)
    entries[12, :E] = torch.tensor(rng.random(E) < 0.9, dtype=torch.float32)
    if cover:
        for j, z in ((5, 0.5), (6, 0.7)):
            entries[0:13, j] = torch.tensor([-40.0, -40.0, 80.0, -40.0, -40.0, 80.0, z, z, z, 0.0, 0.0, 1.0, 1.0])
    start = torch.tensor([0, E, E, E], dtype=torch.int32)
    count = torch.tensor([E, 0, 0, 0], dtype=torch.int32)
    return entries, start, count, 2, 2, TR.soft_sigma_px2(1e-4, (512, 512))


def _mesh_case(case, rng):
    if case == "gate":
        return _gate_mesh_inputs() + (NCMAX,)
    if case == "saturated":
        return _covered_tile(rng, 3) + (NCMAX,)
    return _covered_tile(rng, 4, cover=False) + (2,)  # "clamp": 4 chunks under a clamp of 2


@pytest.mark.parametrize("case", ["gate", "saturated", "clamp"])
def test_mesh_split_matches_one_pass_and_jax(rng, case):
    entries, start, count, TX, TY, s2, ncmax = _mesh_case(case, rng)
    hard, soft, win, S, live = TR.mesh_split_plain(entries, start, count, TX, True, s2, ncmax)
    # the residuals of the one-pass plain version
    win_p, S_p, live_p = TR.mesh_residuals_plain(entries, start, count, TX, True, s2, ncmax)
    np.testing.assert_array_equal(win.numpy(), win_p.numpy())
    np.testing.assert_array_equal(live.numpy(), live_p.numpy())
    np.testing.assert_allclose(S.numpy(), S_p.numpy(), rtol=S_RTOL, atol=0)
    # the outputs of the plain forward (no saturation skip: a skipped chunk
    # moves 1 - e^S by < e^-18)
    hard_p, soft_p = TR.mesh_composite_plain(entries, start, count, TX, TY, True, s2, ncmax)
    np.testing.assert_array_equal(hard.numpy(), hard_p.numpy())
    np.testing.assert_allclose(soft.numpy(), soft_p.numpy(), rtol=0, atol=SOFT_TOL)
    # the reference's kernel in interpret mode
    with pltpu.force_tpu_interpret_mode():
        hard_j, soft_j = JRP._fwd_call(jnp.asarray(entries.numpy()), jnp.asarray(start.numpy()),
                                       jnp.asarray(count.numpy()), TX, TY, True, s2, ncmax=ncmax)
    hard_j, soft_j = np.asarray(hard_j), np.asarray(soft_j)
    np.testing.assert_array_equal(hard[:, 3].numpy(), hard_j[:, 3])  # hit
    both = (hard[:, 3].numpy() > 0)[:, None, :].repeat(3, 1)
    np.testing.assert_array_equal(hard[:, 0:3].numpy()[both], hard_j[:, 0:3][both])  # the winner's normal
    np.testing.assert_allclose(soft.numpy(), soft_j, rtol=0, atol=SOFT_TOL)
    assert int((win >= 0).sum()) > 100
    if case == "saturated":
        assert live.tolist() == [1, 0, 0, 0] and bool((win[0] == 5).all())
    if case == "clamp":
        assert live.tolist() == [2, 0, 0, 0] and int(win.max()) < 2 * CHUNK


def test_mesh_partials_are_per_chunk(rng):
    """B4a's partials: each chunk taken alone, the soft partial computed for
    every swept chunk (dead ones too), merged only while live."""
    entries, start, count, TX, TY, s2 = _covered_tile(rng, 3)
    z, idx, s = TR.mesh_chunk_partials_plain(entries, start, count, TX, True, s2)
    assert z.shape == idx.shape == s.shape == (entries.shape[1] // CHUNK, P)
    for k in range(3):  # each winner lies in its own chunk, at the chunk's z
        hit = idx[k] >= 0
        assert bool(((idx[k][hit] >= k * CHUNK) & (idx[k][hit] < (k + 1) * CHUNK)).all())
        assert bool((z[k][~hit] == TR._BIG).all()) and int(hit.sum()) > 0
    assert float(s[1:3].min()) < 0  # speculative soft partials of the dead chunks
    assert bool((z[3:] == TR._BIG).all() and (idx[3:] == -1).all() and (s[3:] == 0).all())  # unswept slots
    _, _, _, S, live = TR.mesh_merge_plain(entries, start, count, (z, idx, s), True)
    assert live.tolist() == [1, 0, 0, 0]
    np.testing.assert_array_equal(S[0].numpy(), s[0].numpy())  # only the live chunk's partial


def test_mesh_split_without_the_soft_pass(rng):
    entries, start, count, TX, TY, s2 = _covered_tile(rng, 3)
    hard, soft, win, S, live = TR.mesh_split_plain(entries, start, count, TX, False, s2)
    hard_p, _ = TR.mesh_composite_plain(entries, start, count, TX, TY, False, s2)
    np.testing.assert_array_equal(hard.numpy(), hard_p.numpy())
    assert float(soft.abs().max()) == 0.0 and float(S.abs().max()) == 0.0 and int(live.max()) == 0


# ---- B1: per-(tile, chunk) partials, merged with one re-sweep per pixel ------

TX_B1 = 2  # 2x2 tiles of 16 px


def _plane_rows(rng, n):
    """Rows 9-17 of random triangles over a 32^2 frame: the barycentric
    planes w0 = w0x (x - x2) + w0y (y - y2), w1 likewise, and the depth
    plane z = zx (x - x2) + zy (y - y2) + z2, as ops/geometry.py writes
    them."""
    v = rng.uniform(-8, 40, (6, n))
    x0, y0, x1, y1, x2, y2 = v
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    denom = np.where(np.abs(denom) < 1.0, 1.0, denom)
    w0x, w0y = (y1 - y2) / denom, (x2 - x1) / denom
    w1x, w1y = (y2 - y0) / denom, (x0 - x2) / denom
    z0, z1, z2 = rng.uniform(1, 3, (3, n))
    zx, zy = w0x * (z0 - z2) + w1x * (z1 - z2), w0y * (z0 - z2) + w1y * (z1 - z2)
    return np.stack([w0x, w0y, w1x, w1y, x2, y2, zx, zy, z2])


def _stack(e, pos, ops):
    """Wide, flat splats (conic 1e-6) at entry positions ``pos`` with
    opacities ``ops``: alpha ~ min(0.99, op) on every pixel of the frame."""
    for j, op in zip(pos, ops):
        e[0:6, j] = [16.0, 16.0, 1e-6, 0.0, 1e-6, op]


def _frame_scene(rng):
    """Three active slots of four on a 2x2-tile frame, their segments not
    128-aligned, so that neighbouring slots share chunk slots: tile 0 owns
    entries [0, 200), tile 1 [200, 330), tile 3 [330, 600).  Random splats
    and triangles everywhere, and flat splats that spend the
    transmittance:
      * tile 0: lanes 126, 127 of chunk 0 and lane 0 of chunk 1, so the
        pixels are spent exactly at the chunk boundary;
      * tile 1: one flat splat (alpha 0.99) in its chunk 0 and one at lane
        34 of its chunk 1: neither chunk crosses on its own, but the pixels
        are spent in the middle of chunk 1;
      * tile 3: positions 394-396 (lanes 10-12 of its chunk 1), after which
        that chunk is opaque on its own (its sweep from T = 1 crosses)."""
    D = 640
    e = np.zeros((24, D), np.float32)
    e[0:2] = rng.uniform(-2, 34, (2, D))
    e[2] = e[4] = rng.uniform(0.02, 0.3, D)
    e[3] = rng.uniform(-0.01, 0.01, D)
    e[5] = rng.uniform(0.02, 0.2, D)
    e[6:9] = rng.random((3, D))
    e[9:18] = _plane_rows(rng, D)
    e[18] = rng.random(D) < 0.9
    e[19:22] = rng.normal(0, 1, (3, D))
    e[22] = rng.uniform(0.5, 1.5, D)
    _stack(e, (126, 127, 128), (1.0, 0.5, 1.0))
    _stack(e, (220, 290), (1.0, 1.0))
    _stack(e, (394, 395, 396), (1.0, 0.5, 1.0))
    i32 = dict(dtype=torch.int32)
    return (torch.tensor(e), torch.tensor([0, 1, 3, 0], **i32), torch.tensor([0, 200, 330, 0], **i32),
            torch.tensor([200, 130, 270, 0], **i32), torch.tensor(3, **i32))


def _gate_frame_inputs():
    """The gate scene's B1 inputs as the port's eval forward builds them."""
    params, statics, cfg, frame = gate_scene(device="cpu", seed=0)
    with torch.no_grad():
        verts = posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                               frame["dst_posevec"])
        table, bins, _ = frame_table_and_bins(params, statics, cfg, verts, M.appearance_apply(params["appearance"]),
                                              frame["K"], frame["E"])
    entries = TF.gather_entries(table, bins)
    # pad so that the reference's chunk copies stay inside the buffer
    entries = torch.cat([entries, entries.new_zeros((entries.shape[0], 2 * CHUNK))], dim=1)
    return entries, bins.active_id, bins.seg_start, bins.seg_count, bins.n_active, bins.num_tiles_x, bins.num_tiles_y


def _check_sel(a, b, n):
    a, b = a[:n].numpy(), np.asarray(b)[:n]
    same = a[:, 4] == b[:, 4]
    assert same.mean() >= HIT_FRAC
    both = (same & (a[:, 4] > 0))[:, None, :].repeat(4, 1)
    np.testing.assert_allclose(a[:, :4][both], b[:, :4][both], atol=SEL_TOL, rtol=0)


@pytest.mark.parametrize("scene,with_mesh,ncmax", [
    ("stacks", True, NCMAX), ("stacks", False, NCMAX), ("stacks", True, 2), ("stacks", True, 1),
    ("gate", True, NCMAX), ("gate", True, 1),
])
def test_frame_split_matches_one_pass_and_jax(rng, scene, with_mesh, ncmax):
    if scene == "stacks":
        args, TY = _frame_scene(rng) + (TX_B1,), 2
    else:
        *args, TY = _gate_frame_inputs()
    entries, active_id, seg_start, seg_count, n_active = args[:5]
    n = int(n_active)
    stats = {}
    got = TF.frame_split_plain(*args, ncmax=ncmax, with_mesh=with_mesh, stats=stats)
    plain = TF.frame_sweep_plain(*args, ncmax=ncmax, with_mesh=with_mesh)
    jax_out = JF._frame_call(*(jnp.asarray(a.numpy()) for a in args[:5]), args[5], TY, ncmax=ncmax,
                             with_mesh=with_mesh, interpret=True)
    for i, label in ((0, "rgb"), (1, "alpha")):
        assert_close_frac(got[i][:n].numpy(), plain[i][:n].numpy(), f"{label} vs one pass")
        assert_close_frac(got[i][:n].numpy(), np.asarray(jax_out[i])[:n], f"{label} vs jax")
    if with_mesh:
        _check_sel(got[2], plain[2], n)
        _check_sel(got[2], jax_out[2], n)
    assert float(got[1][:n].max()) > 0.5
    assert stats["resweeps"] > 0 or ncmax == 1  # one chunk per tile never stops there
    assert float(got[0][n:].abs().sum() + got[1][n:].abs().sum()) == 0.0  # slots past n_active


def test_frame_partials_cover_the_stop_cases(rng):
    """The three stacks of the scene do what they were built for."""
    entries, active_id, seg_start, seg_count, n_active = _frame_scene(rng)
    part, idx = TF.frame_chunk_partials_plain(entries, active_id, seg_start, seg_count, n_active, TX_B1)
    end = TF.chunk_plan(seg_start, seg_count, n_active, NCMAX, part.shape[0])
    # unaligned segments: tile 0 sweeps chunk slots 0-1, tile 1 slots 1-2,
    # tile 3 slots 2-4; seven (tile, chunk) pairs on five slots
    assert end.tolist() == [2, 4, 7, 7]
    assert part.shape[0] == TF.num_pairs(640, 4) == 9
    t_local = part[:, 4]
    # tile 0, chunk 0 ends at T ~ 0.005 on every pixel, not crossed; its
    # chunk 1 is spent at its first lane, so the frame's alpha is chunk 0's
    assert bool(((t_local[0] > 1e-4) & (t_local[0] < 0.01)).all())
    rgb, alpha, _ = TF.frame_split_plain(entries, active_id, seg_start, seg_count, n_active, TX_B1)
    np.testing.assert_allclose(alpha[0, 0].numpy(), part[0, 3].numpy(), rtol=1e-6)
    np.testing.assert_allclose(rgb[0].numpy(), part[0, 0:3].numpy(), rtol=1e-6)
    # tile 1: neither chunk (pairs 2, 3) crosses on its own, but together
    # they do, so every pixel is spent inside chunk 1 and re-sweeps it
    assert bool(((t_local[2] > 1e-4) & (t_local[3] > 1e-4) & (t_local[2] * t_local[3] < 1e-4)).all())
    assert bool((alpha[1, 0] < part[2, 3] + t_local[2] * part[3, 3] - 1e-6).all())  # chunk 1 cut short
    # tile 3's chunk 1 (pair 5) is opaque on its own, after the stack
    assert bool((t_local[5] == TF.CROSSED).all())
    # the z-buffer partials name entries of their own chunk
    for pair, astart, k in ((0, 0, 0), (1, 0, 1), (2, 128, 0), (4, 256, 0), (6, 256, 2)):
        hit = idx[pair] >= 0
        assert bool(((idx[pair][hit] >= astart + k * CHUNK) & (idx[pair][hit] < astart + (k + 1) * CHUNK)).all())


def test_frame_split_takes_any_number_of_active_slots(rng):
    """B1 has no cap on its active slots: the scene's slot arrays padded to
    2,304 slots (nine runs of 256, past n_active) plan and render as the
    unpadded ones."""
    entries, active_id, seg_start, seg_count, n_active = _frame_scene(rng)
    pad = 2304 - active_id.shape[0]
    padded = [torch.cat([t, t.new_zeros(pad)]) for t in (active_id, seg_start, seg_count)]
    n_pairs = TF.num_pairs(entries.shape[1], 2304)
    end = TF.chunk_plan(*padded[1:], n_active, NCMAX, n_pairs)
    assert end.shape == (2304,) and end[:4].tolist() == [2, 4, 7, 7] and bool((end[4:] == 7).all())
    got = TF.frame_split_plain(entries, *padded, n_active, TX_B1)
    want = TF.frame_split_plain(entries, active_id, seg_start, seg_count, n_active, TX_B1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:4].numpy(), w.numpy())
        assert float(g[4:].abs().sum()) == 0.0

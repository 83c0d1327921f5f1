"""The decomposition kernel B2 computes, held to gomavatar_tpu on the CPU.

B2 runs as two launches over chunks; its plain-PyTorch twins live in the
package (``pallas_kernel.splat_chunk_partials_plain`` for B2a,
``pallas_kernel.splat_split_plain`` for the two together), so that the chip
smoke holds the kernels to them as well: each chunk's colour and alpha sums
and transmittance from T = 1, then the merge in chunk order, where a chunk
lets a pixel through unswept only if it did not cross on its own and
T * T_k clears 1e-4 by the margin, and any other chunk the pixel reaches is
re-swept from T.  The twin runs on numpy-seeded inputs against the one-pass
plain version and the reference's Pallas kernel in interpret mode (the
forward call of ``composite_tiles_pallas``, which takes the chunk clamp),
at the kernel gate's tolerances (tests/torch_port_scene.py); its state against
the plain chunk-start state and, fed to the plain B3 split, against JAX's
VJP.  A constructed scene puts pixels within 1e-5 relative of 1e-4 at a
chunk boundary, on both sides, and pins what B3 trusts: its per-entry
replay from the state crosses 1e-4 only where the state turns -1, and
never on a chunk B2 let through."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gomavatar_tpu.ops.splat import pallas_kernel as JP
from gomavatar_tpu_torch.models.gom import posed_vertices, train_geometry
from gomavatar_tpu_torch.ops.splat import pallas_kernel as TK
from gomavatar_tpu_torch.ops.splat.binning import CHUNK
from gomavatar_tpu_torch.ops.splat.projection import project_gaussians
from gomavatar_tpu_torch.ops.splat.reference import T_EPS
from gomavatar_tpu_torch.ops.splat.render import gaussian_entries
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, P, chunk_alpha, tile_pixels
from gomavatar_tpu_torch.scene import gate_scene
from test_torch_backward_split import (GRAD_ATOL, GRAD_RTOL, _jax_splat_grads, _splat_scene, _stacked_splats,
                                       splat_bwd_split)
from torch_port_scene import assert_close_frac
from torch_threads import one_torch_thread  # noqa: F401

STATE_TOL = 1e-4  # the chunk-start state against its log-space plain version


def _gate_splat_inputs():
    """The gate scene's splat entries as the port's train forward builds them
    (64^2, 792 faces, seed 0): (entries, entry_valid, tile_start,
    tile_count, TX, TY)."""
    params, statics, cfg, frame = gate_scene(device="cpu", seed=0)
    K, E = frame["K"], frame["E"]
    with torch.no_grad():
        verts = posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                               frame["dst_posevec"])
        g = train_geometry(params, statics, cfg, verts, K, E)
        proj = project_gaussians(g["centroids"], g["cov"], K, E, cfg.img_size)
        entries = gaussian_entries(proj, g["colors"], g["opacity"], g["bins"]).contiguous()
    bins = g["bins"]
    return entries, bins.entry_valid, bins.tile_start, bins.tile_count, bins.num_tiles_x, bins.num_tiles_y


def _case(case, rng):
    """(entries, entry_valid, tile_start, tile_count, TX, TY, ncmax)."""
    if case == "gate":
        return _gate_splat_inputs() + (NCMAX,)
    if case == "random":
        entries, bins = _splat_scene(rng, 160, 64, 64)
        return entries, bins.entry_valid, bins.tile_start, bins.tile_count, bins.num_tiles_x, bins.num_tiles_y, NCMAX
    if case == "stacked":  # opaque splats spend the pixels inside chunks 0 and 1 of 3
        big = [(70, 0.0, 0.02), (71, 2.0, 0.02), (72, 1.0, 0.02), (158, 15.0, 0.02), (159, 13.0, 0.02),
               (160, 14.0, 0.02)]
        return _stacked_splats(rng, 3, big) + (2, 2, NCMAX)
    return _stacked_splats(rng, 4, []) + (2, 2, 2)  # "clamp": 4 chunks under a clamp of 2


def _check_state(state, plain, owned):
    """The chunk-start state on the owned slots: the spent sentinel equal, the
    transmittance within STATE_TOL where both hold it."""
    s, p = state[owned], plain[owned]
    np.testing.assert_array_equal((s < 0).numpy(), (p < 0).numpy())
    both = (s >= 0) & (p >= 0)
    np.testing.assert_allclose(s[both].numpy(), p[both].numpy(), rtol=0, atol=STATE_TOL)


def _owned_mask(start, count, n_slots, ncmax):
    owned = torch.zeros(n_slots, dtype=torch.bool)
    owned[TK.owned_chunks(start, count, ncmax)[0]] = True
    return owned


@pytest.mark.parametrize("case", ["gate", "random", "stacked", "clamp"])
def test_splat_split_matches_one_pass_and_jax(rng, case):
    entries, valid, start, count, TX, TY, ncmax = _case(case, rng)
    C = 3
    stats = {}
    color, alpha, state = TK.splat_split_plain(entries, start, count, C, TX, ncmax, stats=stats)
    color_p, alpha_p = TK.composite_plain_entries(entries, start, count, C, TX, TY, ncmax)
    with pltpu.force_tpu_interpret_mode():
        color_j, alpha_j = JP._fwd_call(jnp.asarray(entries.numpy()), jnp.asarray(start.numpy()),
                                        jnp.asarray(count.numpy()), C, TX, TY, ncmax=ncmax)
    for label, got, plain, ref in (("color", color, color_p, color_j), ("alpha", alpha, alpha_p, alpha_j)):
        assert_close_frac(got.numpy(), plain.numpy(), f"{label} vs one pass")
        assert_close_frac(got.numpy(), np.asarray(ref), f"{label} vs jax")
    assert float(alpha.max()) > 0.5
    owned = _owned_mask(start, count, entries.shape[1] // CHUNK, ncmax)
    _check_state(state, TK.splat_chunk_state_plain(entries, start, count, TX, ncmax), owned)
    assert bool(stats["let_through"][owned].any())
    if case == "stacked":  # the pixels are spent inside chunks, which they re-sweep
        assert stats["resweeps"] > 0 and bool((state[2] == TK.SPENT).all())
    if case == "clamp":
        assert bool((state[2:] == 0).all())  # the unswept slots stay unset


@pytest.mark.parametrize("case", ["gate", "stacked", "clamp"])
def test_splat_split_state_feeds_b3(rng, case):
    """The twin's state, fed to the plain B3 split, gives the gradients of
    JAX's VJP at B3's tolerances."""
    entries, valid, start, count, TX, TY, ncmax = _case(case, rng)
    C = 3
    _, _, state = TK.splat_split_plain(entries, start, count, C, TX, ncmax)
    g_img = torch.tensor(rng.random((TY * 16, TX * 16, C)), dtype=torch.float32)
    g_alpha = torch.tensor(rng.random((TY * 16, TX * 16)), dtype=torch.float32)
    g_color_t, g_alpha_t = TK._retile(g_img, g_alpha, TX, TY, C)
    got = splat_bwd_split(entries, start, count, C, TX, g_color_t, g_alpha_t, ncmax, state=state)
    keep = (TK.select_d_entries(torch.ones_like(entries), valid, start, count, 6 + C, ncmax) > 0).numpy()
    want = np.where(keep, _jax_splat_grads(entries, start, count, C, TX, TY, g_img, g_alpha, ncmax), 0)
    got = np.where(keep, got.numpy(), 0)
    assert np.isfinite(got).all() and float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_splat_partials_are_per_chunk(rng):
    """B2a's partials: each owned chunk swept alone from T = 1 (a chunk after
    the pixels are spent too), zero on slots no tile owns."""
    entries, _, start, count, TX, TY, _ = _case("stacked", rng)
    stats = {}
    part = TK.splat_chunk_partials_plain(entries, start, count, 3, TX, stats=stats)
    assert part.shape == (entries.shape[1] // CHUNK, 5, P)
    assert bool((part[3:] == 0).all())  # unowned slots
    t_local = part[:, 4]
    assert bool((t_local[2] > T_EPS).all())  # chunk 2 alone does not cross
    crossed = t_local[:2] == TK.CROSSED
    assert bool(crossed[0][torch.arange(P) % 16 < 4].all()) and bool(crossed[1][torch.arange(P) % 16 >= 12].all())
    # each chunk's sums are its own sweep's, from T = 1
    for k in range(3):
        one = torch.zeros_like(count)
        starts = torch.full_like(start, k * CHUNK)
        one[0] = CHUNK
        color_k, alpha_k = TK.composite_plain_entries(entries, starts, one, 3, TX, TY)
        np.testing.assert_allclose(part[k, :3].numpy(), color_k[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(part[k, 3].numpy(), alpha_k[0, 0].numpy(), atol=1e-5)
    assert stats["swept_pairs"] <= 3 * CHUNK * P and stats["swept_pairs"] > 2 * CHUNK * P


# ---- pixels at the threshold --------------------------------------------------

def _flat(e, j, op):
    """A splat at entry j with conic 0: alpha = op on every pixel, exactly."""
    e[5, j] = op


def _near_threshold_scene(rng):
    """2x2 tiles of 16 px; tiles 0 and 1 own 4 chunks each.  Chunk 0 holds 20
    flat splats of opacity 0.2; chunk 1 holds 10 more, a wide splat whose
    alpha varies across the tile (a tuner; on tile 0 by ~2e-4 relative, on
    tile 1 by ~6e-3), and a flat splat whose opacity puts the median of
    T_0 T_1 at 1e-4; chunk 2 holds five flat splats of opacity 0.5, chunk 3
    faint random splats.  So on tile 0 the product of chunk products lands
    within 1e-5 relative of 1e-4 for pixels on both sides, and every pixel
    of tile 0 re-sweeps chunk 1; on tile 1 some pixels clear the margin."""
    D = 9 * CHUNK
    e = np.zeros((16, D), np.float32)
    e[6:9] = rng.random((3, D))
    for tile, conic in ((0, 4.3e-7), (1, 1.3e-5)):
        base = tile * 4 * CHUNK
        for j in range(20):
            _flat(e, base + j, 0.2)
        for j in range(10):
            _flat(e, base + CHUNK + j, 0.2)
        e[0:6, base + CHUNK + 10] = [16 * tile - 8.0, -8.0, conic, 0.0, conic, 0.5]
        for j in range(5):
            _flat(e, base + 2 * CHUNK + j, 0.5)
        faint = base + 3 * CHUNK + np.arange(CHUNK)
        e[0:2, faint] = rng.uniform(16 * tile, 16 * tile + 16, (2, CHUNK))
        e[2, faint] = e[4, faint] = 0.1
        e[5, faint] = 0.05
    start = torch.tensor([0, 4 * CHUNK, 8 * CHUNK, 8 * CHUNK], dtype=torch.int32)
    count = torch.tensor([4 * CHUNK, 4 * CHUNK, 0, 0], dtype=torch.int32)
    # the flat splat that centres T_0 T_1 on 1e-4
    part = TK.splat_chunk_partials_plain(torch.tensor(e), start, count, 3, 2)
    for tile in (0, 1):
        prod = part[4 * tile, 4] * part[4 * tile + 1, 4]
        _flat(e, tile * 4 * CHUNK + CHUNK + 11, 1.0 - T_EPS / float(prod.median()))
    return torch.tensor(e), start, count


def _replay_crossed(entries, start, count, state, TX):
    """B3a's per-entry rule, replayed from the state on every owned chunk
    (numpy float32, one rounded multiply per entry): (slot (m,), crossed
    (m, P)), crossed where the replay takes T below 1e-4."""
    slot, tile, _ = TK.owned_chunks(start, count)
    px, py = tile_pixels(tile, TX)
    idx = slot[:, None] * CHUNK + torch.arange(CHUNK)
    alpha = chunk_alpha(entries[0:2, idx].permute(1, 2, 0), entries[2:5, idx].permute(1, 2, 0), entries[5, idx],
                        px, py).numpy()  # (m, CHUNK, P)
    T = state[slot].numpy().copy()
    crossed = np.zeros(T.shape, bool)
    live = T >= 0
    one, eps = np.float32(1.0), np.float32(T_EPS)
    for j in range(CHUNK):
        t_next = T * (one - alpha[:, j])
        stop = live & (t_next < eps)
        crossed |= stop
        live &= ~stop
        T = np.where(live, t_next, T)
    return slot, crossed


def test_splat_split_at_the_threshold(rng):
    entries, start, count = _near_threshold_scene(rng)
    C, TX = 3, 2
    part = TK.splat_chunk_partials_plain(entries, start, count, C, TX)
    rel = (part[0, 4] * part[1, 4]).double() / T_EPS - 1.0  # tile 0's product of chunk products
    assert bool(((rel > 0) & (rel < 1e-5)).any()) and bool(((rel < 0) & (rel > -1e-5)).any())
    stats = {}
    color, alpha, state = TK.splat_split_plain(entries, start, count, C, TX, stats=stats)
    # (i) the margin re-sweeps, the carries, and the re-sweeps after a carry
    # (B2b's last block) all run
    assert stats["margin"] > 0 and stats["carries"] > 0 and stats["own"] > 0
    assert bool(stats["let_through"][5].any())  # tile 1's chunk 1 lets some pixels through
    # (ii) the replay from the state crosses only in the chunk after which
    # the state turns -1 (and there it does)
    slot, crossed = _replay_crossed(entries, start, count, state, TX)
    st = state.numpy()
    for i, s in enumerate(slot.tolist()):
        if s % 4 < 3:  # a chunk followed by one of its tile's
            np.testing.assert_array_equal(crossed[i], (st[s] >= 0) & (st[s + 1] < 0), err_msg=f"slot {s}")
    assert bool(crossed[1].any()) and bool(crossed[2].any())  # spent in chunk 1, and in chunk 2 after a carry
    # (iii) never on a chunk B2 let through
    assert not (crossed & stats["let_through"][slot].numpy()).any()
    assert float(alpha[:2].min()) > 0.99 and bool(torch.isfinite(color).all())

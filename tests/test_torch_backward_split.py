"""The decompositions kernels B3 and B5 compute, held to gomavatar_tpu on
the CPU.

Plain-PyTorch twins of the kernels' algorithms:
* B5 "from residuals, per entry": B4's residuals (each pixel's winning
  entry, its S = sum log(1 - p), each tile's live soft chunks) feed a sum
  over the tile's pixels for every entry;
* B3 "split over chunks": B2's transmittance at each chunk's start, then
  each chunk's partial sum of u w (B3a), then per entry the suffix from the
  later chunks' partials and the local prefix (B3b).
Each twin runs on the same numpy-seeded inputs as the reference's VJP (its
jnp path, as tests/test_torch_splat.py and tests/test_torch_mesh_raster.py
run it), at their tolerances.  Pinned besides: the live chunk count against
a per-chunk replay of the reference's soft sum, the winner against the hard
normal, a tile whose pixels are spent in the middle of a chunk, and a tile
cut by the chunk clamp."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.models.smpl import synthetic_body, synthetic_camera
from gomavatar_tpu.ops import mesh_raster as JR
from gomavatar_tpu.ops import mesh_raster_pallas as JRP
from gomavatar_tpu.ops.splat import tiled_jnp as JT
from gomavatar_tpu_torch.ops import mesh_raster as TR
from gomavatar_tpu_torch.ops import mesh_raster_pallas as TRP
from gomavatar_tpu_torch.ops.splat import pallas_kernel as TK
from gomavatar_tpu_torch.ops.splat.binning import CHUNK, bin_bboxes, bin_gaussians
from gomavatar_tpu_torch.ops.splat.projection import project_gaussians
from gomavatar_tpu_torch.ops.splat.reference import ALPHA_MAX, ALPHA_MIN, T_EPS
from gomavatar_tpu_torch.ops.splat.render import gaussian_entries
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, P, composite_tiles_plain, tile_pixels
from torch_threads import one_torch_thread  # noqa: F401

# the tolerances of tests/test_torch_splat.py (splat gradients, atol 2e-4 +
# rtol 1e-3) and tests/test_torch_mesh_raster.py (vertex and normal
# gradients within 5e-3 on > 99.9 % of values)
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
MESH_TOL, MESH_FRAC = 5e-3, 0.999


# ---- the twins -------------------------------------------------------------

def splat_bwd_split(entries, tile_start, tile_count, C, num_tiles_x, g_color_t, g_alpha_t, ncmax=NCMAX, state=None):
    """B3 as B3a and B3b compute it, in plain PyTorch: d_entries (NCH, Dp),
    zero on slots no tile sweeps.  The transmittance inside a chunk is the
    running product from B2's saved state, as in the kernels: ``state``, or
    by default its plain version."""
    if state is None:
        state = TK.splat_chunk_state_plain(entries, tile_start, tile_count, num_tiles_x, ncmax)
    d = torch.zeros_like(entries)
    lane = torch.arange(CHUNK)
    for t in torch.nonzero(tile_count > 0).flatten().tolist():
        s0, n = int(tile_start[t]) // CHUNK, min(int(tile_count[t]) // CHUNK, ncmax)
        px, py = (c[0][None, :] for c in tile_pixels(torch.tensor([t]), num_tiles_x))  # (1, P)
        g, ga = g_color_t[t], g_alpha_t[t, 0]
        chunks = []
        for k in range(n):  # B3a: each chunk's terms and its partial sum from the chunk-start state
            idx = (s0 + k) * CHUNK + lane
            e = entries[:, idx]
            col = lambda r: e[r][:, None]  # noqa: E731  (CHUNK, 1)
            dx, dy = px - col(0), py - col(1)
            power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
            G = torch.exp(power)
            raw = col(5) * G
            alpha = torch.where(power > 0, 0.0, torch.clamp_max(raw, ALPHA_MAX))
            alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)  # (CHUNK, P)
            T0 = state[s0 + k]
            T_excl = torch.clamp_min(T0, 0.0) * torch.cumprod(torch.cat([torch.ones(1, P), 1.0 - alpha[:-1]]), 0)
            sat = (T_excl * (1.0 - alpha) < T_EPS).to(torch.int32)
            reached = (T0 >= 0) & (torch.cumsum(sat, 0) - sat == 0)  # the pixel is not spent before the entry
            live = reached & (sat == 0)
            w = torch.where(live, T_excl * alpha, 0.0)
            u = ga + e[6 : 6 + C].T @ g
            prefix = torch.cumsum(u * w, 0)
            chunks.append((idx, e, dx, dy, power, G, raw, alpha, T_excl, reached, live, w, u, prefix))
        partials = [c[-1][-1] for c in chunks]
        for k, (idx, e, dx, dy, power, G, raw, alpha, T_excl, reached, live, w, u, prefix) in enumerate(chunks):
            later = sum(partials[k + 1 :], torch.zeros(P))  # B3b: the suffix from the later chunks
            suffix = later + (partials[k] - prefix)
            d_alpha = torch.where(live & (alpha > 0), T_excl * u, 0.0) - suffix / (1.0 - alpha)
            gate = reached & (power <= 0) & (raw >= ALPHA_MIN) & (raw <= ALPHA_MAX)
            d_raw = torch.where(gate, d_alpha, 0.0)
            d_power = d_raw * e[5][:, None] * G
            ca, cb, cc = e[2][:, None], e[3][:, None], e[4][:, None]
            rows = [d_power * (ca * dx + cb * dy), d_power * (cc * dy + cb * dx), d_power * (-0.5 * dx * dx),
                    d_power * (-dx * dy), d_power * (-0.5 * dy * dy), d_raw * G] + [g[c] * w for c in range(C)]
            d[: 6 + C, idx] = torch.stack([r.sum(dim=1) for r in rows])
    return d


def _inside(e, px, py):
    """Barycentric coverage (P, CHUNK) of a chunk's triangles, in the hard
    pass's arithmetic (the kernels use it for the soft term's sign)."""
    x0, y0, x1, y1, x2, y2 = (e[i][None, :] for i in range(6))
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
    w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / denom
    w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / denom
    return (w0 >= 0) & (w1 >= 0) & (1.0 - w0 - w1 >= 0)


def mesh_bwd_per_entry(entries, tile_start, tile_count, num_tiles_x, sigma_px2, g_hard_t, g_soft_t, residuals,
                       ncmax=NCMAX):
    """B5 as it computes, in plain PyTorch, from B4's residuals alone (win,
    S, live): every entry's gradient is a sum over its tile's pixels, the
    normal cotangent where it won the pixel, the soft chain in the live
    chunks.  Returns d_entries (16, Dp), zero on slots no tile sweeps."""
    win, S, live = residuals
    d = torch.zeros_like(entries)
    lane = torch.arange(CHUNK)
    for t in torch.nonzero(tile_count > 0).flatten().tolist():
        s0, n = int(tile_start[t]) // CHUNK, min(int(tile_count[t]) // CHUNK, ncmax)
        px, py = (c[0][:, None] for c in tile_pixels(torch.tensor([t]), num_tiles_x))  # (P, 1)
        dl_ds = -g_soft_t[t, 0] * torch.exp(S[t])  # soft = 1 - e^S
        for k in range(n):
            idx = (s0 + k) * CHUNK + lane
            e = entries[:, idx]
            d[9:12, idx] = g_hard_t[t, 0:3] @ (win[t].long()[:, None] == idx[None, :]).to(torch.float32)
            if k < int(live[t]):
                d[0:6, idx] = TRP.soft_log1m_grad(e[0:6], px, py, e[12:13], _inside(e, px, py), sigma_px2,
                                                  dl_ds[:, None])
    return d


# ---- the splat split against JAX -------------------------------------------

def _jax_splat_grads(entries, tile_start, tile_count, C, TX, TY, g_img, g_alpha, max_chunks=NCMAX):
    """d_entries (NCH, Dp) of the reference's jnp composite, by jax.vjp."""
    e = jnp.asarray(entries.numpy())

    def f(mean, conic, color, opacity):
        return JT.composite_tiles_jnp(mean, conic, color, opacity, jnp.asarray(tile_start.numpy()),
                                      jnp.asarray(tile_count.numpy()), TX, TY, max_chunks)

    _, vjp = jax.vjp(f, e[0:2].T, e[2:5].T, e[6 : 6 + C].T, e[5])
    dm, dc, dcol, dop = vjp((jnp.asarray(g_img.numpy()), jnp.asarray(g_alpha.numpy())))
    out = np.zeros(entries.shape, np.float32)
    out[0:2], out[2:5], out[5], out[6 : 6 + C] = np.asarray(dm).T, np.asarray(dc).T, np.asarray(dop), np.asarray(dcol).T
    return out


def _check_splat_twin(entries, valid, start, count, C, TX, TY, g_img, g_alpha, max_chunks=NCMAX):
    g_color_t, g_alpha_t = TK._retile(g_img, g_alpha, TX, TY, C)
    got = splat_bwd_split(entries, start, count, C, TX, g_color_t, g_alpha_t, max_chunks)
    keep = TK.select_d_entries(torch.ones_like(entries), valid, start, count, 6 + C, max_chunks) > 0
    got = torch.where(keep, got, 0.0).numpy()
    want = np.where(keep.numpy(), _jax_splat_grads(entries, start, count, C, TX, TY, g_img, g_alpha, max_chunks), 0)
    assert np.isfinite(got).all()
    assert float(np.abs(want).max()) > 1e-2  # live gradient
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    return got


def _splat_scene(rng, n, w, h, c=3):
    """The random splat scene of tests/test_train_kernels_interpret.py,
    binned and packed as the port's train path does."""
    means = rng.normal(size=(n, 3)) * np.array([0.5, 0.5, 0.2]) + np.array([0, 0, 3.0])
    A = rng.normal(size=(n, 3, 3)) * 0.05
    cov = A @ np.transpose(A, (0, 2, 1)) + np.eye(3) * 1e-4
    colors = rng.random(size=(n, c))
    opacity = rng.random(size=(n,)) * 0.9 + 0.05
    K = np.array([[w * 0.95, 0, w / 2], [0, h * 0.95, h / 2], [0, 0, 1]])
    means, cov, colors, opacity, K = (torch.tensor(np.asarray(x, np.float32)) for x in (means, cov, colors, opacity, K))
    proj = project_gaussians(means, cov, K, torch.eye(4), (w, h))
    bins = bin_gaussians(proj.mean2d, proj.radius, proj.depth, proj.valid, (w, h), max_tiles_per_gaussian=32)
    return gaussian_entries(proj, colors, opacity, bins), bins


@pytest.mark.parametrize("w,h,n", [(32, 32, 64), (64, 64, 160)])
def test_splat_split_matches_jax(rng, w, h, n):
    entries, bins = _splat_scene(rng, n, w, h)
    g_img = torch.tensor(rng.random((h, w, 3)), dtype=torch.float32)
    g_alpha = torch.tensor(rng.random((h, w)), dtype=torch.float32)
    _check_splat_twin(entries, bins.entry_valid, bins.tile_start, bins.tile_count, 3, bins.num_tiles_x,
                      bins.num_tiles_y, g_img, g_alpha)


def _stacked_splats(rng, n_chunks, big):
    """2x2 tiles of 16 px; tile 0 owns ``n_chunks`` chunks of random small
    splats, and ``big`` lists (entry, mean x, conic a) of opaque splats
    (opacity 1, wide in y) that spend the pixels near their mean x."""
    D = (n_chunks + 3) * CHUNK
    E = n_chunks * CHUNK
    entries = torch.zeros((16, D))
    entries[0:2, :E] = torch.tensor(rng.uniform(-2, 18, (2, E)), dtype=torch.float32)
    entries[2, :E] = entries[4, :E] = torch.tensor(rng.uniform(0.05, 0.5, E), dtype=torch.float32)
    entries[3, :E] = torch.tensor(rng.uniform(-0.02, 0.02, E), dtype=torch.float32)
    entries[5, :E] = torch.tensor(rng.uniform(0.05, 0.6, E), dtype=torch.float32)
    entries[6:9, :E] = torch.tensor(rng.random((3, E)), dtype=torch.float32)
    for j, mx, a in big:
        entries[0:6, j] = torch.tensor([mx, 7.5, a, 0.0, 1e-4, 1.0])
    valid = torch.zeros(D)
    valid[:E] = 1.0
    start = torch.tensor([0, E, E, E], dtype=torch.int32)
    count = torch.tensor([E, 0, 0, 0], dtype=torch.int32)
    return entries, valid, start, count


def test_splat_spent_in_the_middle_of_a_chunk(rng):
    """Opaque splats spend the left pixels at entry ~70 of chunk 0 and the
    right ones at entry ~30 of chunk 1: B2's state holds the sentinel from
    there on, and the twin's gradient matches the reference's."""
    big = [(70, 0.0, 0.02), (71, 2.0, 0.02), (72, 1.0, 0.02), (128 + 30, 15.0, 0.02), (128 + 31, 13.0, 0.02),
           (128 + 32, 14.0, 0.02)]
    entries, valid, start, count = _stacked_splats(rng, 3, big)
    state = TK.splat_chunk_state_plain(entries, start, count, 2)
    left = torch.arange(P) % 16 < 4
    right = torch.arange(P) % 16 >= 12
    assert bool((state[0] == 1.0).all())
    assert bool((state[1][left] == TK.SPENT).all()) and bool((state[1][right] > T_EPS).all())
    assert bool((state[2] == TK.SPENT).all())
    g_img = torch.tensor(rng.random((32, 32, 3)), dtype=torch.float32)
    g_alpha = torch.tensor(rng.random((32, 32)), dtype=torch.float32)
    got = _check_splat_twin(entries, valid, start, count, 3, 2, 2, g_img, g_alpha)
    assert np.abs(got[:, 2 * CHUNK : 3 * CHUNK]).max() < 1e-6  # the spent chunk takes no gradient
    # and the plain version's autograd agrees
    leaf = entries.clone().requires_grad_(True)
    color_t, alpha_t = composite_tiles_plain(leaf[0:2].T, leaf[2:5].T, leaf[6:9].T, leaf[5], start, count, 2, 2)
    g_color_t, g_alpha_t = TK._retile(g_img, g_alpha, 2, 2, 3)
    (want,) = torch.autograd.grad((color_t * g_color_t).sum() + (alpha_t * g_alpha_t).sum(), leaf)
    np.testing.assert_allclose(got[:9, :384], want[:9, :384].numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_splat_chunk_clamp(rng):
    """A tile owning 4 chunks under a clamp of 2: B2's state covers the two
    swept chunks only, and the twin matches the reference cut the same
    way."""
    entries, valid, start, count = _stacked_splats(rng, 4, [])
    state = TK.splat_chunk_state_plain(entries, start, count, 2, ncmax=2)
    assert bool((state[1] > 0).all()) and bool((state[2:] == 0).all())  # unswept slots stay unset
    g_img = torch.tensor(rng.random((32, 32, 3)), dtype=torch.float32)
    g_alpha = torch.tensor(rng.random((32, 32)), dtype=torch.float32)
    got = _check_splat_twin(entries, valid, start, count, 3, 2, 2, g_img, g_alpha, max_chunks=2)
    assert np.abs(got[:, 2 * CHUNK :]).max() == 0.0


# ---- the mesh per-entry backward against JAX ---------------------------------

def _mesh(rings, w, h):
    info = synthetic_body(n_rings=rings[0], n_seg=rings[1])
    verts = np.asarray(info["canonical_vertex"], np.float32)
    faces = np.asarray(info["faces"], np.int64)
    normals = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    K, E = synthetic_camera((w, h), distance=2.2, focal=1.1 * h)
    return verts, faces, normals, np.asarray(K, np.float32), np.asarray(E, np.float32)


def _mesh_entries(tv, tn, faces, K, E, w, h):
    """(entries, validity, bins, sigma_px2) as ``rasterize_mesh`` builds them."""
    tris_xy, tris_z, in_front = TR.project_faces(tv, faces, K, E)
    margin = (TR.np_log_blur(1e-5) ** 0.5) / (2.0 / min(w, h)) + 1.0
    with torch.no_grad():
        bins = bin_bboxes(tris_xy[..., 0].amin(1) - margin, tris_xy[..., 0].amax(1) + margin,
                          tris_xy[..., 1].amin(1) - margin, tris_xy[..., 1].amax(1) + margin,
                          tris_z.amin(-1), in_front, (w, h), max_tiles_per_primitive=16, buffer_factor=8)
    entries, valid = TR.mesh_entries(tris_xy, tris_z, in_front, tn, faces, bins)
    return entries, valid, bins, TR.soft_sigma_px2(1e-4, (w, h))


@pytest.mark.parametrize("rings,size", [((4, 6), 32), ((8, 10), 64)])
def test_mesh_per_entry_matches_jax(rings, size):
    """B5's decomposition, pushed back to the vertices and normals, against
    the reference's jnp VJP (as tests/test_torch_mesh_raster.py runs it)."""
    verts, faces, normals, K, E = _mesh(rings, size, size)
    rng = np.random.default_rng(1)
    g_n = rng.standard_normal((size, size, 3)).astype(np.float32)
    g_s = rng.standard_normal((size, size)).astype(np.float32)

    def jf(v, n):
        out = JR.rasterize_mesh(v, n, jnp.asarray(faces, jnp.int32), jnp.asarray(K), jnp.asarray(E), (size, size),
                                soft_mask=True, blur_sigma=1e-5, implementation="jnp", max_tiles_per_face=16,
                                buffer_factor=8)
        return out.normal, out.soft_mask

    _, vjp = jax.vjp(jf, jnp.asarray(verts), jnp.asarray(normals))
    jdv, jdn = vjp((jnp.asarray(g_n), jnp.asarray(g_s)))

    tv, tn = torch.tensor(verts, requires_grad=True), torch.tensor(normals, requires_grad=True)
    entries, valid, bins, s2 = _mesh_entries(tv, tn, torch.tensor(faces), torch.tensor(K), torch.tensor(E),
                                             size, size)
    start, count, TX, TY = bins.tile_start, bins.tile_count, bins.num_tiles_x, bins.num_tiles_y
    e = entries.detach()
    res = TR.mesh_residuals_plain(e, start, count, TX, True, s2)
    g_hard_t, g_soft_t = TRP._retile_cotangents(torch.tensor(g_n), torch.tensor(g_s), TX, TY)
    d = TRP.select_d_entries(mesh_bwd_per_entry(e, start, count, TX, s2, g_hard_t, g_soft_t, res), valid, start,
                             count, TR.NCH)
    tdv, tdn = torch.autograd.grad(entries, (tv, tn), grad_outputs=d)
    for name, a, b in (("d_verts", tdv, jdv), ("d_normals", tdn, jdn)):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all() and float(np.abs(b).max()) > 1e-2, name
        close = np.isclose(a, b, atol=MESH_TOL, rtol=0)
        assert close.mean() > MESH_FRAC, f"{name}: {(~close).mean():.3%} off by > {MESH_TOL}"


def _replayed_live(entries, start, count, TX, s2, ncmax=NCMAX):
    """Each tile's live soft chunks by a replay of the reference's own soft
    sum (``_soft_log1m``) chunk by chunk: chunk k is live while some pixel
    has S > -18 at its start; the flags must form a prefix."""
    out = []
    e = np.asarray(entries.numpy())
    for t in range(start.shape[0]):
        n = min(int(count[t]) // CHUNK, ncmax)
        px, py = (np.asarray(c[0][:, None].numpy()) for c in tile_pixels(torch.tensor([t]), TX))
        S = np.zeros((P, 1), np.float32)
        flags = []
        for k in range(n):
            flags.append(bool((S > JRP._LOG_SAT).any()))
            if flags[-1]:
                chunk = e[:, int(start[t]) + k * CHUNK + np.arange(CHUNK)]
                S = S + np.asarray(JRP._soft_log1m(jnp.asarray(chunk[0:6]), jnp.asarray(px), jnp.asarray(py),
                                                   jnp.asarray(chunk[12:13]), s2))
        assert flags == sorted(flags, reverse=True)  # the live chunks are a prefix
        out.append(sum(flags))
    return out


def _covered_tile(rng, n_chunks):
    """2x2 tiles of 16 px; tile 0 owns ``n_chunks`` chunks of small random
    triangles, and entries 5 and 6 of chunk 0 are two triangles that cover
    the whole tile, so that every pixel has S < -18 after chunk 0."""
    D = (n_chunks + 3) * CHUNK
    E = n_chunks * CHUNK
    entries = torch.zeros((16, D))
    centre = rng.uniform(-3, 19, (2, E))
    entries[0:6, :E] = torch.tensor(np.concatenate([centre + rng.normal(0, 2, (2, E)) for _ in range(3)]),
                                    dtype=torch.float32)
    entries[6:9, :E] = torch.tensor(rng.uniform(1, 3, (3, E)), dtype=torch.float32)
    entries[9:12, :E] = torch.tensor(rng.normal(0, 1, (3, E)), dtype=torch.float32)
    entries[12, :E] = torch.tensor(rng.random(E) < 0.9, dtype=torch.float32)
    for j, z in ((5, 0.5), (6, 0.7)):
        entries[0:13, j] = torch.tensor([-40.0, -40.0, 80.0, -40.0, -40.0, 80.0, z, z, z, 0.0, 0.0, 1.0, 1.0])
    valid = torch.zeros(D)
    valid[:E] = 1.0
    start = torch.tensor([0, E, E, E], dtype=torch.int32)
    count = torch.tensor([E, 0, 0, 0], dtype=torch.int32)
    return entries, valid, start, count


@pytest.mark.parametrize("scene", ["body", "covered"])
def test_mesh_residuals_pin_winner_and_live(rng, scene):
    """``win`` against the hard normal and hit of the plain forward, and the
    live chunk count against the replay of the reference's soft sum; 1 - e^S
    is the plain forward's silhouette where nothing was skipped."""
    if scene == "body":
        verts, faces, normals, K, E = _mesh((8, 10), 64, 64)
        entries, _, bins, s2 = _mesh_entries(*(torch.tensor(a) for a in (verts, normals, faces, K, E)), 64, 64)
        entries, start, count, TX, TY = entries.detach(), bins.tile_start, bins.tile_count, bins.num_tiles_x, 4
    else:
        entries, _, start, count = _covered_tile(rng, 3)
        TX = TY = 2
        s2 = TR.soft_sigma_px2(1e-4, (512, 512))
    win, S, live = TR.mesh_residuals_plain(entries, start, count, TX, True, s2)
    hard_t, soft_t = TR.mesh_composite_plain(entries, start, count, TX, TY, True, s2)
    hit = win >= 0
    np.testing.assert_array_equal(hit.numpy(), hard_t[:, 3].numpy() > 0)
    normal = entries[9:12, win.clamp_min(0).long()].permute(1, 0, 2) * hit[:, None]
    np.testing.assert_array_equal(normal.numpy(), hard_t[:, 0:3].numpy())
    assert live.tolist() == _replayed_live(entries, start, count, TX, s2)
    full = (live == torch.div(count, CHUNK, rounding_mode="floor").clamp_max(NCMAX))[:, None].expand(-1, P)
    # where nothing was skipped, 1 - e^S is the silhouette (compared as such:
    # log(1 - soft) loses S below about -16)
    np.testing.assert_allclose((1.0 - torch.exp(S))[full].numpy(), soft_t[:, 0][full].numpy(), rtol=0, atol=1e-6)
    if scene == "covered":
        assert live.tolist() == [1, 0, 0, 0] and float(S[0].max()) < JRP._LOG_SAT
        assert bool((win[0] == 5).all())  # the nearer cover wins every pixel
    else:
        assert int(hit.sum()) > 100


def test_mesh_per_entry_on_a_saturated_tile(rng):
    """Every pixel saturates in chunk 0: B5's twin gives the later chunks no
    soft gradient and still matches the plain forward's autograd, whose
    extra terms are scaled by e^S < e^-18."""
    entries, valid, start, count = _covered_tile(rng, 3)
    s2 = TR.soft_sigma_px2(1e-4, (512, 512))
    g_hard_t = torch.tensor(rng.standard_normal((4, 4, P)), dtype=torch.float32)
    g_soft_t = torch.tensor(rng.standard_normal((4, 1, P)), dtype=torch.float32)
    res = TR.mesh_residuals_plain(entries, start, count, 2, True, s2)
    got = mesh_bwd_per_entry(entries, start, count, 2, s2, g_hard_t, g_soft_t, res)
    assert float(got[0:6, CHUNK : 3 * CHUNK].abs().max()) == 0.0
    leaf = entries.clone().requires_grad_(True)
    hard_t, soft_t = TR.mesh_composite_plain(leaf, start, count, 2, 2, True, s2)
    (want,) = torch.autograd.grad((hard_t * g_hard_t).sum() + (soft_t * g_soft_t).sum(), leaf)
    rows = list(range(6)) + [9, 10, 11]
    np.testing.assert_allclose(got[rows, :384].numpy(), want[rows, :384].numpy(), atol=MESH_TOL, rtol=0)


def test_mesh_chunk_clamp(rng):
    """A tile owning 4 chunks under a clamp of 2: the residuals and the twin
    see two chunks, as the plain forward cut the same way."""
    entries, valid, start, count = _covered_tile(rng, 4)
    entries[0:13, 5:7] = entries[0:13, 300:302]  # no cover: the soft term stays live
    s2 = TR.soft_sigma_px2(1e-4, (64, 64))
    win, S, live = res = TR.mesh_residuals_plain(entries, start, count, 2, True, s2, max_chunks=2)
    assert live.tolist() == [2, 0, 0, 0] and int(win.max()) < 2 * CHUNK
    g_hard_t = torch.tensor(rng.standard_normal((4, 4, P)), dtype=torch.float32)
    g_soft_t = torch.tensor(rng.standard_normal((4, 1, P)), dtype=torch.float32)
    got = mesh_bwd_per_entry(entries, start, count, 2, s2, g_hard_t, g_soft_t, res, ncmax=2)
    assert float(got[:, 2 * CHUNK :].abs().max()) == 0.0
    leaf = entries.clone().requires_grad_(True)
    hard_t, soft_t = TR.mesh_composite_plain(leaf, start, count, 2, 2, True, s2, max_chunks=2)
    (want,) = torch.autograd.grad((hard_t * g_hard_t).sum() + (soft_t * g_soft_t).sum(), leaf)
    assert float(want[0:6].abs().max()) > 1e-2
    rows = list(range(6)) + [9, 10, 11]
    close = np.isclose(got[rows].numpy(), want[rows].numpy(), atol=MESH_TOL, rtol=0)
    assert close.mean() > MESH_FRAC

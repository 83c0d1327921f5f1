"""The mesh rasterizer of gomavatar_tpu_torch against gomavatar_tpu on the
CPU: the projection, the plain version of kernels B4/B5 (forward and
autograd) against the reference's jnp path and its Pallas kernel in
interpret mode, and the soft term's hand-derived gradient (the chain kernel
B5 computes) against the reference kernel's in-kernel jax.vjp."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gomavatar_tpu.models.smpl import synthetic_body, synthetic_camera
from gomavatar_tpu.ops import mesh_raster as JR
from gomavatar_tpu.ops import mesh_raster_pallas as JRP
from gomavatar_tpu_torch.ops import mesh_raster as TR
from gomavatar_tpu_torch.ops import mesh_raster_pallas as TRP
from torch_threads import one_torch_thread  # noqa: F401

# the JAX package's own kernel-vs-jnp tolerances
# (tests/test_train_kernels_interpret.py:132-137), each held on > 99.9 % of
# values: normal 1e-5, soft 1e-4, d_verts and d_normals 5e-3
TOLS = {"normal": 1e-5, "soft": 1e-4, "d_verts": 5e-3, "d_normals": 5e-3}
FRAC = 0.999


def _mesh(rings, w, h):
    info = synthetic_body(n_rings=rings[0], n_seg=rings[1])
    verts = np.asarray(info["canonical_vertex"], np.float32)
    faces = np.asarray(info["faces"], np.int64)
    normals = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    K, E = synthetic_camera((w, h), distance=2.2, focal=1.1 * h)
    return verts, faces, normals, np.asarray(K, np.float32), np.asarray(E, np.float32)


def test_project_mesh_matches_jax():
    verts, _, _, K, E = _mesh((8, 10), 64, 64)
    jxy, jz = JR.project_mesh(jnp.asarray(verts), jnp.asarray(K), jnp.asarray(E))
    txy, tz = TR.project_mesh(torch.tensor(verts), torch.tensor(K), torch.tensor(E))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6)


def _run(rings, w, h, impl, budgets, interpret=False):
    verts, faces, normals, K, E = _mesh(rings, w, h)
    rng = np.random.default_rng(1)
    g_n = rng.standard_normal((h, w, 3)).astype(np.float32)
    g_s = rng.standard_normal((h, w)).astype(np.float32)

    def jf(v, n):
        out = JR.rasterize_mesh(v, n, jnp.asarray(faces, jnp.int32), jnp.asarray(K), jnp.asarray(E), (w, h),
                                soft_mask=True, blur_sigma=1e-5, implementation=impl, **budgets)
        return out.normal, out.soft_mask

    @jax.jit  # one compiled program: op-by-op dispatch took 3-4x as long
    def reference(v, n, cot_n, cot_s):
        outs, vjp = jax.vjp(jf, v, n)
        return outs, vjp((cot_n, cot_s))

    args = [jnp.asarray(a) for a in (verts, normals, g_n, g_s)]
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            (jn, js), (jdv, jdn) = reference(*args)
    else:
        (jn, js), (jdv, jdn) = reference(*args)

    tv, tn = torch.tensor(verts, requires_grad=True), torch.tensor(normals, requires_grad=True)
    t_budgets = {k: v for k, v in budgets.items() if k != "max_chunks"}
    out = TR.rasterize_mesh(tv, tn, torch.tensor(faces), torch.tensor(K), torch.tensor(E), (w, h),
                            soft_mask=True, blur_sigma=1e-5, **t_budgets)
    tdv, tdn = torch.autograd.grad((out.normal * torch.tensor(g_n)).sum() + (out.soft_mask * torch.tensor(g_s)).sum(),
                                   (tv, tn))
    j = {"normal": jn, "soft": js, "d_verts": jdv, "d_normals": jdn}
    t = {"normal": out.normal.detach(), "soft": out.soft_mask.detach(), "d_verts": tdv, "d_normals": tdn}
    assert float(np.asarray(js).mean()) > 0.05  # the body covers the frame
    for name, tol in TOLS.items():
        a, b = np.asarray(t[name]), np.asarray(j[name])
        assert np.isfinite(a).all(), name
        close = np.isclose(a, b, atol=tol, rtol=0)
        assert close.mean() > FRAC, f"{name}: {(~close).mean():.3%} off by > {tol}"


@pytest.mark.parametrize("rings,size", [((4, 6), 32), ((8, 10), 64)])
def test_plain_raster_matches_jax_jnp(rings, size):
    _run(rings, size, size, "jnp", dict(max_tiles_per_face=16, buffer_factor=8))


def test_plain_raster_matches_jax_pallas_interpret():
    """The mini size of tests/test_train_kernels_interpret.py: 2x2 tiles,
    rings (4, 6), shrunk budgets."""
    _run((4, 6), 32, 32, "pallas", dict(max_tiles_per_face=8, buffer_factor=4), interpret=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soft_gradient_derivation_matches_jax_vjp(seed):
    """Random chunks of 128 triangles over a 16x16 tile: the written-out
    chain of ``soft_log1m_grad`` against jax.vjp of the reference kernel's
    ``_soft_log1m``, rtol 1e-4."""
    rng = np.random.default_rng(seed)
    E = 128
    centre = rng.uniform(-4, 20, (2, E))
    # rows x0 y0 x1 y1 x2 y2: three vertices scattered about each centre
    coords = np.concatenate([centre + rng.normal(0, 4, (2, E)) for _ in range(3)]).astype(np.float32)
    valid = (rng.random((1, E)) < 0.9).astype(np.float32)
    lin = np.arange(256)
    px = (lin % 16).astype(np.float32)[:, None]
    py = (lin // 16).astype(np.float32)[:, None]
    g_S = rng.standard_normal((256, 1)).astype(np.float32)
    sigma_px2 = 1e-4 / (2.0 / 64) ** 2

    S, vjp = jax.vjp(lambda c: JRP._soft_log1m(c, jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid), sigma_px2),
                     jnp.asarray(coords))
    (want,) = vjp(jnp.asarray(g_S))

    c = torch.tensor(coords)
    x0, y0, x1, y1, x2, y2 = (c[i : i + 1] for i in range(6))
    tpx, tpy = torch.tensor(px), torch.tensor(py)
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    w0 = (y1 - y2) * (tpx - x2) + (x2 - x1) * (tpy - y2)
    w1 = (y2 - y0) * (tpx - x2) + (x0 - x2) * (tpy - y2)
    sgn = torch.sign(denom)
    inside = (w0 * sgn >= 0) & (w1 * sgn >= 0) & ((denom - w0 - w1) * sgn >= 0) & (denom.abs() >= 1e-12)
    got = TRP.soft_log1m_grad(c, tpx, tpy, torch.tensor(valid), inside, sigma_px2, torch.tensor(g_S))
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 1e-3  # the chunk has live gradient
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_cpu_mesh_composite_runs_the_plain_version():
    verts, faces, normals, K, E = _mesh((4, 6), 32, 32)
    tv = torch.tensor(verts, requires_grad=True)
    out = TR.rasterize_mesh(tv, torch.tensor(normals), torch.tensor(faces), torch.tensor(K), torch.tensor(E), (32, 32))
    (out.normal.sum() + out.soft_mask.sum()).backward()
    assert TRP.mesh_fwd_partials.launches == TRP.mesh_fwd_merge.launches == TRP.mesh_bwd.launches == 0
    assert torch.isfinite(tv.grad).all() and float(tv.grad.abs().sum()) > 0

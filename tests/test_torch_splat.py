"""The train-path splat renderer of gomavatar_tpu_torch against gomavatar_tpu
on the CPU: the Steiner covariances, the EWA projection, the brute-force
oracle, and the plain version of kernels B2/B3 (forward and autograd)
against the reference's jnp path and its Pallas kernel in interpret mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gomavatar_tpu.ops import steiner as JSt
from gomavatar_tpu.ops.splat.projection import project_gaussians as jax_project
from gomavatar_tpu.ops.splat.render import render_gaussians as jax_render
from gomavatar_tpu_torch.ops import steiner as TSt
from gomavatar_tpu_torch.ops.splat import pallas_kernel as TK
from gomavatar_tpu_torch.ops.splat.projection import project_gaussians as torch_project
from gomavatar_tpu_torch.ops.splat.render import render_gaussians as torch_render
from torch_threads import one_torch_thread  # noqa: F401

# image and alpha: the JAX package's kernel-vs-jnp tolerance
# (tests/test_train_kernels_interpret.py:80); gradients of colors and
# opacity likewise; the means and covariances sit at the same absolute
# tolerance, relative to their larger magnitudes (rtol 1e-3)
IMG_ATOL, GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4, 1e-3


def _scene(rng, n, c=3, w=64, h=64):
    """The random splat scene of tests/test_train_kernels_interpret.py."""
    means = rng.normal(size=(n, 3)) * np.array([0.5, 0.5, 0.2]) + np.array([0, 0, 3.0])
    A = rng.normal(size=(n, 3, 3)) * 0.05
    cov = A @ np.transpose(A, (0, 2, 1)) + np.eye(3) * 1e-4
    colors = rng.random(size=(n, c))
    opacity = rng.random(size=(n,)) * 0.9 + 0.05
    K = np.array([[w * 0.95, 0, w / 2], [0, h * 0.95, h / 2], [0, 0, 1]])
    E = np.eye(4)
    return tuple(np.asarray(x, np.float32) for x in (means, cov, colors, opacity, K, E))


def test_steiner_covariances_match_jax(rng):
    tris = rng.normal(size=(200, 3, 3)).astype(np.float32)
    so3 = (0.3 * rng.normal(size=(200, 3))).astype(np.float32)
    scale = (1.0 + 0.2 * rng.normal(size=(200, 3))).astype(np.float32)
    j_T = np.asarray(JSt.steiner_transform(jnp.asarray(tris), 0.001))
    t_T = TSt.steiner_transform(torch.tensor(tris), 0.001).numpy()
    np.testing.assert_allclose(t_T, j_T, rtol=1e-6, atol=1e-6 * np.abs(j_T).max())
    j_cov = np.asarray(JSt.face_covariances_tri(jnp.asarray(tris), jnp.asarray(so3), jnp.asarray(scale)))
    t_cov = TSt.face_covariances_tri(torch.tensor(tris), torch.tensor(so3), torch.tensor(scale)).numpy()
    np.testing.assert_allclose(t_cov, j_cov, rtol=1e-6, atol=1e-6 * np.abs(j_cov).max())


def test_projection_matches_jax(rng):
    means, cov, _, _, K, E = _scene(rng, 300)
    means[:10, 2] = 0.1  # behind the near plane
    j = jax_project(*(jnp.asarray(a) for a in (means, cov, K, E)), (64, 64))
    t = torch_project(*(torch.tensor(a) for a in (means, cov, K, E)), (64, 64))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.radius.numpy(), np.asarray(j.radius))
    for name in ("mean2d", "conic", "depth"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(), err_msg=name)


def _grads(rng, n, w, h, impl_jax, budgets, impl_torch="auto", interpret=False):
    means, cov, colors, opacity, K, E = _scene(rng, n, w=w, h=h)
    img_size = (w, h)
    g_img = rng.random((h, w, 3)).astype(np.float32)
    g_alpha = rng.random((h, w)).astype(np.float32)

    def jf(m, c, col, op):
        return jax_render(m, c, col, op, jnp.asarray(K), jnp.asarray(E), img_size,
                          implementation=impl_jax, **budgets)

    args = tuple(jnp.asarray(a) for a in (means, cov, colors, opacity))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            (j_img, j_alpha), vjp = jax.vjp(jf, *args)
            j_grads = vjp((jnp.asarray(g_img), jnp.asarray(g_alpha)))
    else:
        (j_img, j_alpha), vjp = jax.vjp(jf, *args)
        j_grads = vjp((jnp.asarray(g_img), jnp.asarray(g_alpha)))

    t_args = [torch.tensor(a, requires_grad=True) for a in (means, cov, colors, opacity)]
    t_budgets = {k: v for k, v in budgets.items() if k != "max_chunks"}
    t_img, t_alpha = torch_render(*t_args, torch.tensor(K), torch.tensor(E), img_size,
                                  implementation=impl_torch, **t_budgets)
    t_grads = torch.autograd.grad((t_img * torch.tensor(g_img)).sum() + (t_alpha * torch.tensor(g_alpha)).sum(), t_args)
    return (j_img, j_alpha, *j_grads), (t_img.detach(), t_alpha.detach(), *t_grads)


def _compare(j, t):
    for name, a, b in zip(("img", "alpha", "d_means", "d_cov", "d_colors", "d_opacity"), t, j):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), name
        if name in ("img", "alpha"):
            np.testing.assert_allclose(a, b, atol=IMG_ATOL, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("w,h,n", [(32, 32, 64), (64, 64, 160)])
def test_plain_composite_matches_jax_jnp(rng, w, h, n):
    j, t = _grads(rng, n, w, h, "jnp", dict(max_tiles_per_gaussian=32, buffer_factor=8))
    assert float(np.asarray(j[1]).max()) > 0.5  # the scene covers the image
    _compare(j, t)


def test_plain_composite_matches_jax_pallas_interpret(rng):
    """The mini size of tests/test_train_kernels_interpret.py: 2x2 tiles,
    64 gaussians, shrunk budgets."""
    j, t = _grads(rng, 64, 32, 32, "pallas", dict(max_tiles_per_gaussian=8, buffer_factor=4), interpret=True)
    _compare(j, t)


def test_plain_composite_matches_the_oracle(rng):
    """The brute-force oracle and the tiled plain version, both in the port."""
    means, cov, colors, opacity, K, E = (torch.tensor(a) for a in _scene(rng, 100, w=32, h=32))
    ref = torch_render(means, cov, colors, opacity, K, E, (32, 32), implementation="reference")
    tiled = torch_render(means, cov, colors, opacity, K, E, (32, 32))
    for a, b in zip(tiled, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=IMG_ATOL)


def test_cpu_composite_tiles_runs_the_plain_version(rng):
    means, cov, colors, opacity, K, E = (torch.tensor(a) for a in _scene(rng, 64, w=32, h=32))
    colors.requires_grad_(True)
    img, alpha = torch_render(means, cov, colors, opacity, K, E, (32, 32))
    (img.sum() + alpha.sum()).backward()
    assert (TK.splat_fwd_partials.launches == TK.splat_fwd_merge.launches == TK.splat_bwd_partials.launches
            == TK.splat_bwd_grads.launches == 0)
    assert torch.isfinite(colors.grad).all() and float(colors.grad.abs().sum()) > 0

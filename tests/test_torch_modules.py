"""gomavatar_tpu_torch embeddings, MLP and model modules against
gomavatar_tpu, with the trained avatar's MLP weights carried across."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu import nn as JN
from gomavatar_tpu.models import modules as JM
from gomavatar_tpu.ops import embedding as JE
from gomavatar_tpu_torch import nn as TN
from gomavatar_tpu_torch.convert import params_from_jax, trained_meta
from gomavatar_tpu_torch.models import modules as TM
from gomavatar_tpu_torch.ops import embedding as TE
from torch_port_scene import trained_mlps
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
# Shadow MLP: bfloat16 on both sides (the reference's dtype), so both round
# at the same places; the remaining difference is bf16 accumulation order.
# Tolerance of the JAX package's own bf16-vs-f32 shading check
# (tests/test_frame_render.py:206).  Observed maximum on the CPU: 0.0 (the
# two sides agree bit for bit on these inputs).
SHADOW_ATOL = 2e-2

MODEL_CFG = trained_meta()["model_cfg"]
NR_CFG = MODEL_CFG["non_rigid"]  # kick_in_iter 3000, full_band_iter 4000
PR_CFG = MODEL_CFG["pose_refinement"]
SH_CFG = MODEL_CFG["shadow_module"]


@pytest.fixture(scope="module")
def mlps():
    jax_side = trained_mlps()
    return jax_side, params_from_jax(jax_side, device="cpu")


def _points(n=500, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


def _posevec(seed=1):
    return (0.2 * np.random.default_rng(seed).standard_normal(69)).astype(np.float32)


@pytest.mark.parametrize("include_input", [True, False])
def test_positional_encoding(include_input):
    x = _points()
    t = TE.positional_encoding(torch.as_tensor(x), 6, include_input)
    j = JE.positional_encoding(jnp.asarray(x), 6, include_input)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


# 2000: before kick-in; 3000..4000: inside the Hann ramp; 1e7: full band
I_ITERS = [2000.0, 3000.0, 3250.0, 3600.0, 3999.0, 1e7]


@pytest.mark.parametrize("i_iter", I_ITERS)
def test_annealed_encoding(i_iter):
    x = _points()
    w_t = TE.hann_window_weights(6, i_iter, 3000.0, 4000.0)
    w_j = JE.hann_window_weights(6, jnp.float32(i_iter), 3000.0, 4000.0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL, rtol=0)
    t = TE.annealed_positional_encoding(torch.as_tensor(x), 6, i_iter, 3000.0, 4000.0)
    j = JE.annealed_positional_encoding(jnp.asarray(x), 6, jnp.float32(i_iter), 3000.0, 4000.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_pose_refinement(mlps):
    jp, tp = mlps
    pv = _posevec()
    t = TM.pose_refinement_apply(tp["pose_refinement"], torch.as_tensor(pv), PR_CFG["total_bones"], PR_CFG["refine_root"])
    j = JM.pose_refinement_apply(jnp_tree(jp["pose_refinement"]), jnp.asarray(pv), PR_CFG["total_bones"], PR_CFG["refine_root"])
    assert t.shape == (24, 3, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("i_iter", I_ITERS)
def test_non_rigid(mlps, i_iter):
    jp, tp = mlps
    x, pv = _points(seed=2), _posevec(seed=3)
    t = TM.non_rigid_apply(tp["non_rigid"], NR_CFG, torch.as_tensor(x), torch.as_tensor(pv), i_iter)
    j = JM.non_rigid_apply(jnp_tree(jp["non_rigid"]), NR_CFG, jnp.asarray(x), jnp.asarray(pv), jnp.float32(i_iter))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_shadow_bf16(mlps):
    jp, tp = mlps
    n = _points(2000, seed=4) * 1.5  # summed unit normals span ~[-3, 3]
    t = TM.shadow_apply(tp["shadow"], SH_CFG, torch.as_tensor(n))
    j = np.asarray(JM.shadow_apply(jnp_tree(jp["shadow"]), SH_CFG, jnp.asarray(n)))
    assert t.dtype == torch.float32 and t.shape == (2000, 1)
    observed = float(np.abs(t.numpy() - j).max())
    assert observed <= SHADOW_ATOL, f"shadow max abs diff {observed}"


@pytest.mark.parametrize("skips", [(), (2,)])
def test_mlp_init_rules(skips):
    gen = torch.Generator().manual_seed(0)
    p = TN.mlp_init(gen, d_in=10, width=32, depth=3, d_out=4, skips=skips, skip_dim=10,
                    last_init_scale=1e-5, device="cpu")
    shapes = [tuple(layer["w"].shape) for layer in p["layers"]]
    jref = JN.mlp_init(jax.random.PRNGKey(0), 10, 32, 3, 4, skips=skips, skip_dim=10)
    assert shapes == [tuple(layer["w"].shape) for layer in jref["layers"]]
    for i, layer in enumerate(p["layers"]):
        limit = TN.RELU_GAIN * np.sqrt(6.0 / sum(layer["w"].shape))
        assert float(layer["w"].abs().max()) <= limit and float(layer["w"].abs().max()) > 0.5 * limit, i
        assert float(layer["b"].abs().max()) == 0.0
    assert float(p["head"]["w"].abs().max()) <= 1e-5 and float(p["head"]["b"].abs().max()) == 0.0
    # the same seed gives the same weights
    q = TN.mlp_init(torch.Generator().manual_seed(0), 10, 32, 3, 4, skips=skips, skip_dim=10, device="cpu")
    assert torch.equal(p["layers"][0]["w"], q["layers"][0]["w"])


def jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: jnp_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jnp_tree(v) for v in tree]
    return jnp.asarray(tree)

"""gomavatar_tpu_torch transforms and skeleton against gomavatar_tpu: the same
numpy inputs through both, float32, atol 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.ops import skeleton as JS
from gomavatar_tpu.ops import transforms as JT
from gomavatar_tpu_torch.ops import skeleton as TS
from gomavatar_tpu_torch.ops import transforms as TT
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 2.0])  # 1e-6: Taylor branch
def test_so3_exp(scale):
    rvec = (scale * np.random.default_rng(0).standard_normal((64, 3))).astype(np.float32)
    _close(TT.so3_exp(torch.as_tensor(rvec)), JT.so3_exp(jnp.asarray(rvec)))


def test_so3_exp_at_zero_is_identity():
    R = TT.so3_exp(torch.zeros((2, 3)))
    np.testing.assert_array_equal(R.numpy(), np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)))


@pytest.mark.parametrize("scale", [1e-5, 0.5, 2.0, 3.0])  # 1e-5: Taylor branch; 3.0: near pi
def test_so3_log(scale):
    rng = np.random.default_rng(7)
    axis = rng.standard_normal((64, 3))
    rvec = (scale * axis / np.linalg.norm(axis, axis=-1, keepdims=True)).astype(np.float32)
    R = np.asarray(JT.so3_exp(jnp.asarray(rvec)))
    _close(TT.so3_log(torch.as_tensor(R)), JT.so3_log(jnp.asarray(R)))


def test_quat_to_mat():
    q = (2.0 * np.random.default_rng(8).standard_normal((64, 4))).astype(np.float32)  # normalised inside
    _close(TT.quat_to_mat(torch.as_tensor(q)), JT.quat_to_mat(jnp.asarray(q)))


def test_construct_G():
    rng = np.random.default_rng(1)
    R = rng.standard_normal((5, 3, 3)).astype(np.float32)
    T = rng.standard_normal((5, 3)).astype(np.float32)
    _close(TT.construct_G(torch.as_tensor(R), torch.as_tensor(T)), JT.construct_G(jnp.asarray(R), jnp.asarray(T)))


def _pose_inputs(use_smplx, seed=2):
    J = 55 if use_smplx else 24
    rng = np.random.default_rng(seed)
    jangles = (0.3 * rng.standard_normal(J * 3)).astype(np.float32)
    joints = rng.standard_normal((J, 3)).astype(np.float32)
    return jangles, joints


@pytest.mark.parametrize("use_smplx", [False, True])
def test_body_pose_to_body_RTs(use_smplx):
    jangles, joints = _pose_inputs(use_smplx)
    tR, tT = TS.body_pose_to_body_RTs(torch.as_tensor(jangles), torch.as_tensor(joints), use_smplx)
    jR, jT = JS.body_pose_to_body_RTs(jnp.asarray(jangles), jnp.asarray(joints), use_smplx)
    _close(tR, jR)
    _close(tT, jT)


def test_get_canonical_global_tfms():
    _, joints = _pose_inputs(False)
    _close(
        TS.get_canonical_global_tfms(torch.as_tensor(joints)),
        JS.get_canonical_global_tfms(jnp.asarray(joints)),
    )


@pytest.mark.parametrize("use_smplx", [False, True])
def test_fk_chain(use_smplx):
    jangles, joints = _pose_inputs(use_smplx, seed=3)
    jR, jT = JS.body_pose_to_body_RTs(jnp.asarray(jangles), jnp.asarray(joints), use_smplx)
    G = np.array(JT.construct_G(jR, jT))
    _close(TS.fk_chain(torch.as_tensor(G), use_smplx), JS.fk_chain(jnp.asarray(G), use_smplx))


@pytest.mark.parametrize("use_smplx", [False, True])
def test_get_global_RTs(use_smplx):
    jangles, joints = _pose_inputs(use_smplx, seed=4)
    jR, jT = JS.body_pose_to_body_RTs(jnp.asarray(jangles), jnp.asarray(joints), use_smplx)
    cnl = np.asarray(JS.get_canonical_global_tfms(jnp.asarray(joints)))
    tout = TS.get_global_RTs(torch.as_tensor(cnl), torch.as_tensor(np.asarray(jR)), torch.as_tensor(np.asarray(jT)), use_smplx)
    jout = JS.get_global_RTs(jnp.asarray(cnl), jR, jT, use_smplx)
    for t, j in zip(tout, jout):
        _close(t, j)


def test_apply_lbs():
    rng = np.random.default_rng(5)
    N, J = 300, 24
    xyz = rng.standard_normal((N, 3)).astype(np.float32)
    w = rng.random((N, J)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    gR = np.asarray(JT.so3_exp(jnp.asarray(0.4 * rng.standard_normal((J, 3)), jnp.float32)))
    gT = rng.standard_normal((J, 3)).astype(np.float32)
    _close(
        TS.apply_lbs(*(torch.as_tensor(a) for a in (xyz, gR, gT, w))),
        JS.apply_lbs(*(jnp.asarray(a) for a in (xyz, gR, gT, w))),
    )


def test_parent_tables_match():
    np.testing.assert_array_equal(TS.SMPL_PARENT, JS.SMPL_PARENT)
    np.testing.assert_array_equal(TS.SMPLX_PARENT, JS.SMPLX_PARENT)

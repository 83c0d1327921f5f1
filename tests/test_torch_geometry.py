"""gomavatar_tpu_torch frame_geometry against gomavatar_tpu's on the gate
scene (64^2), the same observation-space vertices on both sides, at the
per-channel tolerances of the JAX package's own geometry check
(tests/test_frame_render.py:90-138)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.ops.geometry import frame_geometry as jax_frame_geometry
from gomavatar_tpu_torch.ops.geometry import NCH, frame_geometry
from torch_port_scene import CHANNEL_TOL, IMG, jax_gate_scene, jax_verts_obs, torch_scene_from
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scenes():
    js = jax_gate_scene()
    jp, jst, jcfg, frame_np, _ = js
    verts = np.array(jax_verts_obs(jp, jst, jcfg, frame_np))
    return js, torch_scene_from(js), verts


def _both(scenes, K, margin):
    (jp, jst, jcfg, frame_np, _), (tp, tst, tcfg, _), verts = scenes
    E = frame_np["E"]
    jg = jax_frame_geometry(
        jnp.asarray(verts), jst.faces, jp["so3"], jp["scale"], jp["appearance"]["colors"],
        jst.vf_incidence, jst.vf_valid, jnp.asarray(K), jnp.asarray(E), IMG, jcfg.sigma, margin,
    )
    tg = frame_geometry(
        torch.as_tensor(verts), tst.faces, tp["so3"], tp["scale"], tp["appearance"]["colors"],
        tst.vf_incidence, tst.vf_valid, torch.as_tensor(K), torch.as_tensor(E), IMG, tcfg.sigma, margin,
    )
    return jg, tg


def _shifted_K(frame_np, dx):
    K = frame_np["K"].copy()
    K[0, 2] -= dx
    return K


# (principal point shift, blur margin): the centred frame, the eval path's
# zero margin, and a half-window view that exercises the mesh window cull
CASES = [(0, 2.0), (0, 0.0), (IMG[0] // 2, 2.0)]


@pytest.mark.parametrize("shift,margin", CASES)
def test_frame_geometry_table(scenes, shift, margin):
    jg, tg = _both(scenes, _shifted_K(scenes[0][3], shift), margin)
    jt, tt = np.asarray(jg.table), tg.table.numpy()
    assert tt.shape == jt.shape == (jt.shape[0], NCH)
    assert (tt[:, 18] > 0).sum() > 0 and (tt[:, 5] > 0).sum() > 0
    for chans, atol, rtol in CHANNEL_TOL:
        for c in chans:
            np.testing.assert_allclose(tt[:, c], jt[:, c], atol=atol, rtol=rtol, err_msg=f"channel {c}")


@pytest.mark.parametrize("shift,margin", CASES)
def test_frame_geometry_boxes_flags_depth(scenes, shift, margin):
    jg, tg = _both(scenes, _shifted_K(scenes[0][3], shift), margin)
    np.testing.assert_array_equal(tg.valid_splat.numpy(), np.asarray(jg.valid_splat))
    np.testing.assert_array_equal(tg.valid_mesh.numpy(), np.asarray(jg.valid_mesh))
    np.testing.assert_allclose(tg.depth.numpy(), np.asarray(jg.depth), rtol=1e-5, atol=0)
    for name in ("sx0", "sx1", "sy0", "sy1", "mx0", "mx1", "my0", "my1"):
        np.testing.assert_allclose(
            getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), atol=1e-3, rtol=1e-5, err_msg=name
        )
    for t, j in zip(tg.union_box, jg.union_box):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-3, rtol=1e-5)
    if shift:
        assert 0 < int(tg.valid_mesh.sum()) < tg.valid_mesh.numel()  # the cull bites

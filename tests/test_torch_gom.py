"""The whole eval slice of gomavatar_tpu_torch against gomavatar_tpu at 64^2:
pose refinement -> non-rigid -> FK/LBS -> geometry table -> per-face shadow
MLP -> sorted binning -> B1 -> untile -> shading, with the JAX params
carried across.  The JAX reference is composed by hand and runs B1 in
interpret mode (torch_port_scene.jax_forward)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.models.gom import subdivide_gom as jax_subdivide_gom
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.ops import frame_render as TF
from gomavatar_tpu_torch.scene import gate_scene
from torch_port_scene import (
    IMG, assert_close_frac, jax_forward, jax_gate_scene, jax_verts_obs, torch_scene_from,
)
from torch_threads import one_torch_thread  # noqa: F401

# per-face shading: bf16 MLP on both sides, the tolerance of the JAX
# package's bf16 shading check (tests/test_frame_render.py:206)
SHADING_ATOL = 2e-2


@pytest.fixture(scope="module")
def scenes():
    js = jax_gate_scene()
    return js, torch_scene_from(js)


@pytest.fixture(scope="module")
def jax_out(scenes):
    jp, jst, jcfg, frame_np, _ = scenes[0]
    return jax_forward(jp, jst, jcfg, frame_np, with_normal=True)


def _forward(ts, **kw):
    tp, tst, tcfg, f = ts
    return TG.gom_forward(
        tp, tst, tcfg, f["K"], f["E"], f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"],
        dst_posevec=f["dst_posevec"], device="cpu", **kw,
    )


def test_eval_forward_matches_jax(scenes, jax_out):
    rgb, mask, aux = _forward(scenes[1])
    j_rgb, j_mask, _, _, j_aux = jax_out
    assert rgb.shape == (IMG[1], IMG[0], 3) and mask.shape == IMG[::-1]
    assert float(mask.mean()) > 0.05
    assert_close_frac(rgb.numpy(), np.asarray(j_rgb), "rgb")
    assert_close_frac(mask.numpy(), np.asarray(j_mask), "mask")
    for field in j_aux["binning"]._fields:
        assert int(getattr(aux["binning"], field)) == int(getattr(j_aux["binning"], field)), field
    assert int(aux["tile_overflow"]) == int(j_aux["tile_overflow"]) == 0
    assert int(aux["binning"].total_dropped()) == 0


def test_eval_normal_map_matches_jax(scenes, jax_out):
    tp, tst, tcfg, f = scenes[1]
    verts = TG.posed_vertices(tp, tst, tcfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"])
    _, _, normal, hit, _ = TG.render_frame_eval(
        tp, tst, tcfg, verts, tp["appearance"]["colors"], f["K"], f["E"], with_normal=True
    )
    j_normal, j_hit = np.asarray(jax_out[2]), np.asarray(jax_out[3])
    assert (hit.numpy() == j_hit).mean() >= 0.999
    both = (hit.numpy() == j_hit) & (j_hit > 0)
    np.testing.assert_allclose(normal.numpy()[both], j_normal[both], atol=1e-4, rtol=0)


def test_per_face_shading_matches_jax(scenes):
    (jp, jst, jcfg, frame_np, _), (tp, tst, tcfg, f) = scenes
    from gomavatar_tpu.models import modules as JM
    from gomavatar_tpu.ops.geometry import frame_geometry as jax_frame_geometry

    verts = jax_verts_obs(jp, jst, jcfg, frame_np)
    jg = jax_frame_geometry(
        verts, jst.faces, jp["so3"], jp["scale"], jp["appearance"]["colors"], jst.vf_incidence,
        jst.vf_valid, jnp.asarray(frame_np["K"]), jnp.asarray(frame_np["E"]), IMG, jcfg.sigma, 0.0,
    )
    j_sh = np.asarray(JM.shadow_apply(jp["shadow"], jcfg.module_cfg("shadow"), jg.table[:, 19:22]))[:, 0] * 2
    table, _, shading0 = TG.frame_table_and_bins(
        tp, tst, tcfg, torch.tensor(np.asarray(verts)), tp["appearance"]["colors"], f["K"], f["E"]
    )
    np.testing.assert_allclose(table[:, 22].numpy(), j_sh, atol=SHADING_ATOL, rtol=0)
    j_sh0 = float(JM.shadow_apply(jp["shadow"], jcfg.module_cfg("shadow"), jnp.zeros((1, 3)))[0, 0]) * 2
    assert abs(float(shading0) - j_sh0) <= SHADING_ATOL


# 2500: pose refinement on, non-rigid off; 3500: inside the Hann ramp
@pytest.mark.parametrize("i_iter", [2500.0, 3500.0, 1e7])
def test_posed_vertices_match_jax(scenes, i_iter):
    (jp, jst, jcfg, frame_np, _), (tp, tst, tcfg, f) = scenes
    t = TG.posed_vertices(tp, tst, tcfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"], i_iter)
    j = jax_verts_obs(jp, jst, jcfg, frame_np, i_iter)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_statics_and_config_match_jax(scenes):
    (_, jst, jcfg, _, _), (_, tst, tcfg, _) = scenes
    for name in ("faces", "vf_incidence", "vf_valid", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
    for field in dataclasses.fields(tcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name


def test_subdivide_gom_matches_jax(scenes):
    (jp, jst, jcfg, _, _), (tp, tst, tcfg, _) = scenes
    jp2, jst2, jcfg2 = jax_subdivide_gom(jp, jst, jcfg)
    tp2, tst2, tcfg2 = TG.subdivide_gom(tp, tst, tcfg)
    for field in dataclasses.fields(tcfg2):
        assert getattr(tcfg2, field.name) == getattr(jcfg2, field.name), field.name
    for name in ("faces", "vf_incidence", "vf_valid", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tst2, name).numpy(), np.asarray(getattr(jst2, name)), err_msg=name)
    for t, j in (
        (tp2["vertices"], jp2["vertices"]), (tp2["so3"], jp2["so3"]), (tp2["scale"], jp2["scale"]),
        (tp2["appearance"]["colors"], jp2["appearance"]["colors"]),
    ):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_global_transform_matches_jax(scenes):
    (jp, jst, jcfg, frame_np, _), (tp, tst, tcfg, f) = scenes
    from gomavatar_tpu.ops.transforms import mm, so3_exp

    gR = np.array([0.1, -0.2, 0.05], np.float32)
    gT = np.array([0.01, 0.02, -0.03], np.float32)
    t = TG.posed_vertices(
        tp, tst, tcfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"],
        global_R=torch.as_tensor(gR), global_T=torch.as_tensor(gT),
    )
    j = mm(jax_verts_obs(jp, jst, jcfg, frame_np), so3_exp(jnp.asarray(gR)).T) + gT
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_gate_scene_is_seeded_and_renders():
    a = gate_scene(device="cpu", seed=0)
    b = gate_scene(device="cpu", seed=0)
    flat = jax.tree_util.tree_leaves
    assert all(torch.equal(x, y) for x, y in zip(flat(a[0]), flat(b[0])))
    rgb, mask, aux = _forward(a)
    assert torch.isfinite(rgb).all() and float(mask.mean()) > 0.05
    assert int(aux["binning"].total_dropped()) == 0 and int(aux["tile_overflow"]) == 0
    assert TF.frame_partials.launches == TF.frame_merge.launches == 0


def test_train_path_matches_jax(scenes):
    """gom_forward(train=True) of the port against the JAX package's on the
    CPU (its jnp splat and mesh paths): the image, the mask, the albedo, the
    soft silhouette, the normal map and the binning telemetry."""
    from gomavatar_tpu.models.gom import gom_forward as jax_gom_forward

    jp, jst, jcfg, frame_np, _ = scenes[0]
    f = {k: jnp.asarray(v) for k, v in frame_np.items()}
    j_rgb, j_mask, j_aux = jax_gom_forward(jp, jst, jcfg, f["K"], f["E"], f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"],
                                           dst_posevec=f["dst_posevec"], train=True)
    rgb, mask, aux = _forward(scenes[1], train=True)
    assert float(mask.mean()) > 0.05
    for name, a, b in (("rgb", rgb, j_rgb), ("mask", mask, j_mask), ("albedo", aux["albedo"], j_aux["albedo"]),
                       ("normal_mask", aux["normal_mask"], j_aux["normal_mask"]),
                       ("normal", aux["normal"], j_aux["normal"])):
        assert_close_frac(a.detach().numpy(), np.asarray(b), name)
    for field in j_aux["binning"]._fields:
        assert int(getattr(aux["binning"], field)) == int(getattr(j_aux["binning"], field)), field
    assert int(aux["binning"].total_dropped()) == 0

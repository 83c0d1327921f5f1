"""The e2e capture's teacher and its 2x render windows in gomavatar_tpu_torch
against gomavatar_tpu.

* The committed shadow trunk (``weights/e2e_teacher_shadow.npz``) is JAX's
  draw for ``teacher_model(synthetic_body(144, 48))``; the port's whole
  teacher equals JAX's leaf for leaf at rings (16, 18).
* The raw-ZJU renders run at a 544^2 quadrant window (1,156 tiles, above
  the 1,024 at which the sort key's sign bit comes into play) with x4
  budgets and one binning band: the port's ``bin_sorted`` gives JAX's
  integers there, on random boxes and on the teacher's own window.
* The windowed, stitched frame equals one render of the whole frame within
  the fused/unfused gate (``bench.py:116-124``).
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.models.smpl import synthetic_body as jax_synthetic_body
from gomavatar_tpu.ops.splat import binning as JB
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import unflatten_params
from gomavatar_tpu_torch.data.dataset import body_pose_to_body_RTs_np, get_canonical_global_tfms_np
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.models import modules as TM
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.ops.camera import apply_global_tfm_to_camera
from gomavatar_tpu_torch.ops.geometry import frame_geometry
from gomavatar_tpu_torch.ops.splat import binning as TB
from gomavatar_tpu_torch.tools import make_e2e_data as T
from torch_port_scene import CLOSE_FRAC, CLOSE_TOL, WORST_MAX, assert_bins_identical, tree_leaves_by_path
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools import make_e2e_data as J  # noqa: E402  (the JAX package's generator)

RINGS = (16, 18)
WINDOW = (544, 544)  # a quadrant of the 1024^2 raw frame plus the 32 px apron


def test_committed_shadow_trunk_is_jaxs_draw():
    params, _, cfg = J.teacher_model(jax_synthetic_body(n_rings=144, n_seg=48))
    assert cfg.num_faces == 57600
    with np.load(T.TEACHER_SHADOW) as npz:
        trunk = unflatten_params(npz)["shadow"]["layers"]
    want = params["shadow"]["layers"]
    assert len(trunk) == len(want) == 3
    for got, ref in zip(trunk, want):
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
            assert got[k].dtype == np.float32


@pytest.fixture(scope="module")
def teachers():
    jp, js, jc = J.teacher_model(jax_synthetic_body(*RINGS), seed=7)
    tp, ts, tc = T.teacher_model(synthetic_body(*RINGS), seed=7, img=J.IMG, device="cpu")
    return (jp, js, jc), (tp, ts, tc)


def test_teacher_matches_jax_leaf_for_leaf(teachers):
    (jp, js, jc), (tp, ts, tc) = teachers
    jl, tl = dict(tree_leaves_by_path(jp)), dict(tree_leaves_by_path(tp))
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)
    np.testing.assert_array_equal(ts.faces.numpy(), np.asarray(js.faces))
    np.testing.assert_array_equal(ts.lbs_weights.numpy(), np.asarray(js.lbs_weights))
    assert tc.num_faces == jc.num_faces == 4 * len(synthetic_body(*RINGS)["faces"])
    assert (tc.max_tiles_per_gaussian, tc.buffer_factor, tc.active_tile_cap, tc.binning_band0) == (
        jc.max_tiles_per_gaussian, jc.buffer_factor, jc.active_tile_cap, jc.binning_band0)


def _random_boxes(seed, img, N, r_max):
    W, H = img
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-10, W + 10, N).astype(np.float32)
    cy = rng.uniform(-10, H + 10, N).astype(np.float32)
    r = rng.uniform(0.5, r_max, N).astype(np.float32)
    depth = rng.uniform(0.5, 5, N).astype(np.float32)
    depth[1::7] = depth[0]  # exact depth ties: the primitive-id tie-break
    valid = rng.random(N) > 0.1
    return [cx - r, cx + r, cy - r, cy + r, depth, valid], [
        (cx - r, cx + r - 3.0, cy - r, cy + r, valid), (cx - r + 2.0, cx + r, cy - r, cy + r, valid)]


def _bin_both(boxes, flags, kw):
    j = JB.bin_sorted(*[jnp.asarray(a) for a in boxes], WINDOW,
                      flag_boxes=tuple(tuple(jnp.asarray(a) for a in b) for b in flags), **kw)
    t = TB.bin_sorted(*[torch.as_tensor(a) for a in boxes], WINDOW,
                      flag_boxes=tuple(tuple(torch.as_tensor(a) for a in b) for b in flags), **kw)
    return j, t


def _window_kw(cfg2, num_faces):
    """bin_sorted's budgets as frame_table_and_bins takes them from a
    quadrant window's config."""
    return dict(max_tiles_per_primitive=cfg2.max_tiles_per_gaussian, buffer_factor=cfg2.buffer_factor,
                active_cap=cfg2.active_tile_cap, band0=cfg2.binning_band0,
                overflow_cap=max(num_faces // 8, 2048))


def test_bin_sorted_identical_544_window():
    """Random boxes over a window with the budgets of the 512^2 capture's
    57,600-face teacher."""
    cfg2 = T.window_cfg(TG.GoMConfig.from_model_cfg(default_cfg()["model"], 28802, 57600), WINDOW)
    assert (cfg2.max_tiles_per_gaussian, cfg2.buffer_factor, cfg2.active_tile_cap, cfg2.binning_band0) == (
        128, 16, 2048, None)
    boxes, flags = _random_boxes(11, WINDOW, N=6000, r_max=40.0)
    j, t = _bin_both(boxes, flags, _window_kw(cfg2, 57600))
    assert t.num_tiles_x * t.num_tiles_y == 34 * 34 == 1156
    assert int(t.n_active) > 1024  # active slots past the 512^2 frame's whole tile count
    assert_bins_identical(j, t)
    assert int(t.telemetry.total_dropped()) == 0


def _teacher_frame(info, t=4, T_total=5):
    """The pose, camera inputs and 2x intrinsics of a raw-ZJU frame of the
    teacher capture (novel view 1 at 140 degrees)."""
    rng = np.random.default_rng(3)
    tracks = [(float(rng.uniform(0.1, 0.3)), float(rng.integers(1, 4)), float(rng.uniform(0, 2 * np.pi)),
               int(rng.integers(0, 3))) for _ in range(10)]
    pose, Rh, Th = T.pose_track(t, T_total, tracks)
    joints = np.asarray(info["canonical_joints"], np.float32)
    Rs, Ts = body_pose_to_body_RTs_np(pose, joints)
    E = np.asarray(apply_global_tfm_to_camera(T.orbit_E(140.0), Rh, Th), np.float32)
    return dict(E=E, cnl=get_canonical_global_tfms_np(joints), Rs=Rs, Ts=Ts, posevec=pose[3:] + 1e-2)


def test_bin_sorted_identical_on_the_teachers_544_window(teachers):
    """The lower-right quadrant window of the 1024^2 raw frame: the
    teacher's own geometry (its union and pass boxes) binned by both."""
    _, (tp, ts, tc) = teachers
    info = synthetic_body(*RINGS)
    fr = _teacher_frame(info)
    W = H = 1024
    K = np.array([[1.1 * H, 0, W / 2 - (W // 2 - 32)], [0, 1.1 * H, H / 2 - (H // 2 - 32)], [0, 0, 1]], np.float32)
    cfg2 = T.window_cfg(tc, WINDOW)
    with torch.no_grad():
        verts = TG.posed_vertices(tp, ts, cfg2, *[torch.as_tensor(fr[k]) for k in ("cnl", "Rs", "Ts", "posevec")])
        geom = frame_geometry(verts, ts.faces, tp["so3"], tp["scale"], TM.appearance_apply(tp["appearance"]),
                              ts.vf_incidence, ts.vf_valid, torch.as_tensor(K), torch.as_tensor(fr["E"]),
                              WINDOW, cfg2.sigma, 0.0)
    ub = geom.union_box
    boxes = [ub[0].numpy(), ub[1].numpy(), ub[2].numpy(), ub[3].numpy(), geom.depth.numpy(), geom.valid.numpy()]
    flags = [tuple(x.numpy() for x in (geom.sx0, geom.sx1, geom.sy0, geom.sy1, geom.valid_splat)),
             tuple(x.numpy() for x in (geom.mx0, geom.mx1, geom.my0, geom.my1, geom.valid_mesh))]
    j, t = _bin_both(boxes, flags, _window_kw(cfg2, tc.num_faces))
    assert t.num_tiles_x * t.num_tiles_y == 1156
    assert int(t.n_active) > 0
    assert_bins_identical(j, t)
    assert int(t.telemetry.total_dropped()) == 0


def test_windowed_frame_equals_one_render(teachers):
    """The raw frame of a 32^2 capture (64^2) stitched from four 64^2
    windows against one 64^2 render with the same budgets."""
    _, (tp, ts, tc) = teachers
    fr = _teacher_frame(synthetic_body(*RINGS))
    W = H = 64
    K = np.array([[1.1 * H, 0, W / 2], [0, 1.1 * H, H / 2], [0, 0, 1]], np.float64)
    rgb, mask, dropped = T.render_windowed(tp, ts, tc, K, fr["E"], fr["cnl"], fr["Rs"], fr["Ts"], fr["posevec"],
                                           (H, W), device="cpu")
    assert dropped == 0
    with torch.no_grad():
        rgb1, mask1, aux = TG.gom_forward(tp, ts, T.window_cfg(tc, (W, H)), K, fr["E"], fr["cnl"], fr["Rs"], fr["Ts"],
                                          dst_posevec=fr["posevec"], i_iter=1e7, train=False, device="cpu")
    assert T.frame_dropped(aux) == 0
    assert float(mask1.mean()) > 0.05  # the body is in the frame
    for got, want in ((rgb, rgb1.numpy()), (mask, mask1.numpy())):
        d = np.abs(got - want)
        assert np.isfinite(got).all()
        assert (d <= CLOSE_TOL).mean() > CLOSE_FRAC and d.max() < WORST_MAX, (float((d <= CLOSE_TOL).mean()), d.max())

"""The host layer of gomavatar_tpu_torch against gomavatar_tpu's on the CPU: the
synthetic SMPL weight file and raw captures (byte for byte), the SMPL
loader's forward, the ZJU-MoCap and PeopleSnapshot preprocessors on those
captures, the LBS-weight volume priors, the auxiliary losses and kNN, and
the profiling utilities."""

import os
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gomavatar_tpu.data import synthetic as JSyn
from gomavatar_tpu.data.prepare_snapshot import prepare_snapshot as jax_prepare_snapshot
from gomavatar_tpu.data.prepare_zju import prepare_zju as jax_prepare_zju
from gomavatar_tpu.models.smpl import SMPL as JaxSMPL
from gomavatar_tpu.ops import aux_losses as JAux
from gomavatar_tpu.ops import lbs_volume as JVol
from gomavatar_tpu_torch.data import synthetic as TSyn
from gomavatar_tpu_torch.data.prepare_snapshot import prepare_snapshot
from gomavatar_tpu_torch.data.prepare_zju import prepare_zju
from gomavatar_tpu_torch.models.smpl import SMPL, synthetic_body
from gomavatar_tpu_torch.ops import aux_losses as TAux
from gomavatar_tpu_torch.ops import lbs_volume as TVol
from gomavatar_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

# a small rig: the loader is size-agnostic (the licensed asset has 6890
# vertices)
SMPL_VERTS, SMPL_FACES = 400, 700
SMPL_TOL = 1e-6  # float64 numpy on both sides
VOLUME_TOL = 1e-6  # float32 numpy on both sides
AUX_TOL = 1e-5  # float32 matmuls and eigh, torch against XLA


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _assert_same_bytes(a, b):
    assert _files(a) == _files(b) and _files(a)
    for f in _files(a):
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def _assert_same_value(a, b, where=""):
    """Nested dicts / lists of arrays equal as arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _assert_same_value(a[k], b[k], f"{where}/{k}")
    elif a is None:
        assert b is None, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def _assert_same_outputs(a, b):
    """The same files; images equal as decoded arrays, pickles and npy equal
    as arrays."""
    assert _files(a) == _files(b) and _files(a)
    for f in _files(a):
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)), err_msg=f)
        elif f.endswith(".pkl"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                _assert_same_value(pickle.load(fa), pickle.load(fb), f)
        elif f.endswith(".npy"):
            _assert_same_value(np.load(pa, allow_pickle=True), np.load(pb, allow_pickle=True), f)
        else:
            raise AssertionError(f"unexpected output {f}")


@pytest.fixture(scope="module")
def smpl_pkl(tmp_path_factory):
    """(the port's file, JAX's file), each in a directory of its own."""
    d = tmp_path_factory.mktemp("smpl")
    paths = []
    for side, writer in (("port", TSyn), ("jax", JSyn)):
        os.makedirs(d / side)
        paths.append(writer.write_synthetic_smpl_pkl(str(d / side / "SMPL_NEUTRAL.pkl"), n_verts=SMPL_VERTS,
                                                     n_faces=SMPL_FACES))
    return tuple(paths)


def test_smpl_pkl_writer_is_byte_equal(smpl_pkl):
    got, want = smpl_pkl
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_smpl_forward_matches_jax(smpl_pkl):
    path = smpl_pkl[0]
    rng = np.random.default_rng(0)
    pose, beta = rng.normal(0.0, 0.3, 72), rng.normal(0.0, 1.0, 10)
    got = SMPL(path)(pose, beta, return_weights=True)
    want = JaxSMPL(path)(pose, beta, return_weights=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=SMPL_TOL)
    assert got[0].shape == (SMPL_VERTS, 3) and got[1].shape == (24, 3)
    v0, j0 = SMPL(path)(np.zeros(72), beta)
    np.testing.assert_allclose(v0, JaxSMPL(path)(np.zeros(72), beta)[0], rtol=0, atol=SMPL_TOL)


def test_prepare_zju_matches_jax(tmp_path, smpl_pkl):
    raw = {}
    for side, writer in (("port", TSyn), ("jax", JSyn)):
        raw[side] = writer.write_synthetic_zju_capture(str(tmp_path / side / "zju"), subject="377", n_frames=3)
    _assert_same_bytes(raw["port"], raw["jax"])
    outs = {}
    for side, prepare in (("port", prepare_zju), ("jax", jax_prepare_zju)):
        cfg = {
            "dataset": {"zju_mocap_path": raw["port"], "subject": "377", "sex": "neutral"},
            "training_view": 1,
            "max_frames": -1,
            "output": {"dir": str(tmp_path / side / "out"), "name": "377"},
        }
        outs[side] = prepare(cfg, smpl_pkl[0])
    _assert_same_outputs(outs["port"], outs["jax"])
    assert len(os.listdir(os.path.join(outs["port"], "images"))) == 3


def test_prepare_snapshot_matches_jax(tmp_path, smpl_pkl):
    roots = {}
    for side, writer in (("port", TSyn), ("jax", JSyn)):
        roots[side] = writer.write_synthetic_snapshot_capture(str(tmp_path / side / "snap"),
                                                              subject="female-3-casual", n_frames=4)
    _assert_same_bytes(roots["port"][0], roots["jax"][0])
    snap_root, pose_root = roots["port"]
    outs = {}
    for side, prepare in (("port", prepare_snapshot), ("jax", jax_prepare_snapshot)):
        cfg = {
            "dataset": {"snapshot_path": snap_root, "pose_path": pose_root, "subject": "female-3-casual"},
            "split": "train",
            "start_frame": 0,
            "end_frame": 3,
            "skip": 1,
            "output": {"dir": str(tmp_path / side / "out"), "name": "f3c_train"},
        }
        outs[side] = prepare(cfg, smpl_pkl[0])
    _assert_same_outputs(outs["port"], outs["jax"])
    assert len(os.listdir(os.path.join(outs["port"], "masks"))) == 4


@pytest.mark.parametrize("use_smplx", [False, True])
def test_gaussian_bone_volumes_match_jax(use_smplx):
    rng = np.random.default_rng(0)
    J = 55 if use_smplx else 24
    joints = rng.normal(0.0, 0.3, (J, 3)).astype(np.float32)
    lo, hi = joints.min(0) - 0.1, joints.max(0) + 0.1
    got = TVol.gaussian_bone_volumes(joints, lo, hi, grid_size=16, use_smplx=use_smplx)
    want = JVol.gaussian_bone_volumes(joints, lo, hi, grid_size=16, use_smplx=use_smplx)
    assert got.shape == (J + 1, 16, 16, 16) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=VOLUME_TOL)


def test_lbs_weights_knn_matches_jax():
    body = synthetic_body(n_rings=10, n_seg=8)
    rng = np.random.default_rng(0)
    xyzs = rng.normal(0.0, 0.3, (3, 200)).astype(np.float32)
    for K in (1, 4):
        got = TVol.lbs_weights_knn(body["canonical_vertex"], body["canonical_lbs_weights"], xyzs, K=K)
        want = JVol.lbs_weights_knn(body["canonical_vertex"], body["canonical_lbs_weights"], xyzs, K=K)
        np.testing.assert_allclose(got, want, rtol=0, atol=VOLUME_TOL)


def test_aux_losses_match_jax():
    rng = np.random.default_rng(0)
    img = rng.random((2, 12, 10, 3)).astype(np.float32)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(48, 3)).astype(np.float32)
    a2 = rng.normal(size=(32, 2)).astype(np.float32)
    t, j = torch.as_tensor, jnp.asarray
    pairs = [
        ("tv", TAux.tv_loss(t(img)), JAux.tv_loss(j(img))),
        ("pairwise", TAux.pairwise_sq_dists(t(a), t(b)), JAux.pairwise_sq_dists(j(a), j(b))),
        ("chamfer 3d", TAux.chamfer_distance(t(a), t(b)), JAux.chamfer_distance(j(a), j(b))),
        ("chamfer 2d", TAux.chamfer_distance(t(a2), t(a2[::-1] + 0.1)), JAux.chamfer_distance(j(a2), j(a2[::-1] + 0.1))),
    ]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=AUX_TOL, atol=AUX_TOL, err_msg=name)

    d_t, i_t = TAux.knn_points(t(a), t(b), 5)
    d_j, i_j = JAux.knn_points(j(a), j(b), 5)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=AUX_TOL, atol=AUX_TOL)

    w_t, v_t = TAux.estimate_pointcloud_local_coord_frames(t(a), k=8)
    w_j, v_j = JAux.estimate_pointcloud_local_coord_frames(j(a), k=8)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=AUX_TOL, atol=AUX_TOL)
    # each eigenvector is defined up to its sign
    v_t, v_j = v_t.numpy(), np.asarray(v_j)
    sign = np.sign(np.sum(v_t * v_j, axis=1, keepdims=True))
    np.testing.assert_allclose(v_t * sign, v_j, rtol=0, atol=1e-4)


def test_timer_reports_its_sections():
    timer = profiling.Timer()
    for _ in range(3):
        with timer.section("fk"):
            sum(range(1000))
    with timer.section("render", sync=True):
        pass
    rep = timer.report()
    assert set(rep) == {"fk", "render"} and rep["fk"]["count"] == 3 and rep["render"]["count"] == 1
    assert 0 <= rep["fk"]["min_ms"] <= rep["fk"]["mean_ms"]
    timer.reset()
    assert timer.report() == {}


def test_trace_and_debug_mode(tmp_path):
    """trace writes a TensorBoard trace of the block; debug_mode turns
    autograd's anomaly detection on inside the block only."""
    with profiling.trace(str(tmp_path / "trace")):
        (torch.ones(8) * 2).sum()
    assert any(f.endswith(".pt.trace.json") for f in _files(tmp_path / "trace"))
    assert not torch.is_anomaly_enabled()
    with profiling.debug_mode():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    assert not torch.is_anomaly_enabled()

"""gomavatar_tpu_torch's e2e capture generator against gomavatar_tpu's, at
32^2 with a small body (rings 16, segs 18): JAX's ``tools/make_e2e_data.py``
writes one directory from its own teacher, the port writes another from the
same teacher carried across with ``params_from_jax``.

* The pickles (cameras, mesh_infos, canonical_joints, the noisy split's
  poses and its ground truth), ``annots.npy`` and ``mdm_poses.npy`` are
  equal byte for byte and array for array; ``teacher.npz`` array for array.
* PNG images and masks are within 1 level on >= 99.9 % of values: both
  truncate to uint8, and the port renders through the plain version of
  kernel B1 where JAX's CPU path takes its unfused renderer.
* The raw JPEGs (quality 95) of the stitched 2x windows: a mean absolute
  difference of at most 0.5 levels, >= 97 % of values within 2 levels and
  none beyond 8.  The encoder's 8x8 DCT quantisation spreads a 1-level
  input difference over its block (observed: mean 0.22-0.24, 99th
  percentile 3, worst 6), so the PNG criterion cannot hold there; the masks
  of the raw capture are PNGs and keep it.
* 0 dropped entries on both sides: both generators fail on a drop.
"""

import dataclasses
import glob
import os
import pickle
import sys

import jax
import numpy as np
import pytest
from PIL import Image

from gomavatar_tpu.models.smpl import synthetic_body as jax_synthetic_body
from gomavatar_tpu_torch.convert import params_from_jax
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.tools import make_e2e_data as T
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools import make_e2e_data as J  # noqa: E402  (the JAX package's generator)

RINGS, SEGS, S = 16, 18, 32
FLAGS = dict(frames=5, test_frames=4, mdm_frames=2)
PICKLES = [f"{split}/{name}.pkl" for split in ("train", "test", "test_noisy")
           for name in ("cameras", "mesh_infos", "canonical_joints")] + ["test_noisy/mesh_infos_gt.pkl"]


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e_data")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    argv = ["make_e2e_data.py", "--out", jdir, "--rings", str(RINGS), "--segs", str(SEGS), "--img", str(S),
            "--frames", str(FLAGS["frames"]), "--test_frames", str(FLAGS["test_frames"]),
            "--mdm_frames", str(FLAGS["mdm_frames"])]
    saved_argv, saved_img = sys.argv, J.IMG
    try:
        sys.argv = argv
        J.main()
        jax_teacher, _, _ = J.teacher_model(jax_synthetic_body(n_rings=RINGS, n_seg=SEGS))
    finally:
        sys.argv, J.IMG = saved_argv, saved_img
    info = synthetic_body(n_rings=RINGS, n_seg=SEGS)
    _, statics, gom_cfg = T.teacher_model(info, img=(S, S), device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_teacher), "cpu")
    summary = T.write_capture(tdir, info, (params, statics, gom_cfg), img=(S, S), device="cpu", **FLAGS)
    return jdir, tdir, summary, (params, statics, gom_cfg)


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("rel", PICKLES)
def test_pickles_equal(captures, rel):
    jdir, tdir, *_ = captures
    j, t = os.path.join(jdir, rel), os.path.join(tdir, rel)
    with open(j, "rb") as fj, open(t, "rb") as ft:
        _assert_same(pickle.load(fj), pickle.load(ft), rel)
    assert _read(j) == _read(t), rel


@pytest.mark.parametrize("rel", ["zju_raw/annots.npy", "mdm_poses.npy"])
def test_fixtures_equal(captures, rel):
    jdir, tdir, *_ = captures
    j, t = os.path.join(jdir, rel), os.path.join(tdir, rel)
    _assert_same(np.load(j, allow_pickle=True).item(), np.load(t, allow_pickle=True).item(), rel)
    assert _read(j) == _read(t), rel


def test_teacher_npz_equal(captures):
    jdir, tdir, *_ = captures
    with np.load(os.path.join(jdir, "teacher.npz")) as j, np.load(os.path.join(tdir, "teacher.npz")) as t:
        assert sorted(j.files) == sorted(t.files) == ["colors", "scale", "so3", "vertices"]
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def _pairs(jdir, tdir, pattern):
    paths = sorted(glob.glob(os.path.join(jdir, pattern)))
    assert paths, pattern
    for p in paths:
        rel = os.path.relpath(p, jdir)
        yield rel, np.asarray(Image.open(p)).astype(np.int32), np.asarray(Image.open(os.path.join(tdir, rel))).astype(
            np.int32)


@pytest.mark.parametrize("pattern", ["train/*/*.png", "test/*/*.png", "test_noisy/*/*.png", "zju_raw/mask*/*/*.png"])
def test_pngs_within_one_level(captures, pattern):
    jdir, tdir, *_ = captures
    for rel, a, b in _pairs(jdir, tdir, pattern):
        assert a.shape == b.shape, rel
        d = np.abs(a - b)
        assert (d <= 1).mean() >= 0.999, (rel, float((d <= 1).mean()))
        if "images" in rel or "Camera" in rel:
            assert a.max() > 0, rel  # the teacher is in the frame


def test_raw_jpegs_within_tolerance(captures):
    jdir, tdir, *_ = captures
    pairs = list(_pairs(jdir, tdir, "zju_raw/Camera_B*/*.jpg"))
    assert len(pairs) == 2  # the last fifth of 5 frames, 2 novel views
    for rel, a, b in pairs:
        assert a.shape == b.shape == (2 * S, 2 * S, 3), rel
        d = np.abs(a - b)
        assert d.mean() <= 0.5 and (d <= 2).mean() >= 0.97 and d.max() <= 8, (rel, d.mean(), d.max())


def test_nothing_dropped(captures):
    jdir, tdir, summary, (params, statics, gom_cfg) = captures
    # both writers fail on a dropped entry, so both captures are complete
    # without one; the port's summary counts the frames it rendered
    assert (summary["train"], summary["test"], summary["zju_raw"]) == (5, 4, 2)
    assert os.path.exists(os.path.join(jdir, "teacher.npz")) and os.path.exists(os.path.join(tdir, "teacher.npz"))
    # a budget of one tile per primitive drops entries: the first frame fails
    # before anything is written
    starved = dataclasses.replace(gom_cfg, max_tiles_per_gaussian=1, max_tiles_per_face=1)
    with pytest.raises(RuntimeError, match="dropped"):
        T.render_split(os.path.join(tdir, "train"), params, statics, starved, img=(S, S), device="cpu")

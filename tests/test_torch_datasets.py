"""gomavatar_tpu_torch's data layer against gomavatar_tpu's on the CPU: the
fixture writers byte for byte, every dataset class item for item (arrays
exact, the same rng seed), the native decode path, ``to_device``, the
``Prefetcher``, the camera helpers, the frame sampling and the TB logger's
cadence gate."""

import filecmp
import os
import pickle
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomavatar_tpu.data import dataset as JD
from gomavatar_tpu.data import synthetic as JS
from gomavatar_tpu.ops import camera as JC
from gomavatar_tpu.utils import sampling as JSamp
from gomavatar_tpu_torch.data import dataset as TD
from gomavatar_tpu_torch.data import native_loader as TN
from gomavatar_tpu_torch.data import synthetic as TS
from gomavatar_tpu_torch.ops import camera as TC
from gomavatar_tpu_torch.utils import sampling as TSamp
from torch_threads import one_torch_thread  # noqa: F401

HW = (48, 48)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return TS.write_synthetic_dataset(str(tmp_path_factory.mktemp("synth")), n_frames=5, img_hw=HW)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory, data_dir):
    return TS.write_synthetic_zju_raw(str(tmp_path_factory.mktemp("raw")), data_dir, n_views=3, img_hw=HW)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("writer", ["dataset", "zju_raw", "mdm_poses"])
def test_writer_is_byte_equal_to_jax(writer, tmp_path):
    if writer == "dataset":
        for pkg, d in ((JS, "j"), (TS, "t")):
            pkg.write_synthetic_dataset(str(tmp_path / d), n_frames=3, img_hw=HW, seed=2)
    elif writer == "zju_raw":
        pre = JS.write_synthetic_dataset(str(tmp_path / "pre"), n_frames=3, img_hw=HW)
        for pkg, d in ((JS, "j"), (TS, "t")):
            pkg.write_synthetic_zju_raw(str(tmp_path / d), pre, n_views=2, img_hw=HW)
    else:
        for pkg, d in ((JS, "j"), (TS, "t")):
            os.makedirs(tmp_path / d)
            pkg.write_synthetic_mdm_poses(str(tmp_path / d / "mdm.npy"), n_frames=4)
    files = _tree_files(tmp_path / "j")
    assert files and files == _tree_files(tmp_path / "t")
    for f in files:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f, shallow=False), f


def assert_items_equal(t, j):
    assert set(t) == set(j)
    for k in j:
        if isinstance(j[k], str):
            assert t[k] == j[k], k
        else:
            a, b = np.asarray(t[k]), np.asarray(j[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


TRAIN_CASES = {
    "fixed_bg": dict(bgcolor=[0, 0, 0]),
    "random_bg": dict(bgcolor=None, seeded=True),
    "crop": dict(bgcolor=[0, 0, 0], crop_size=(32, 32), seeded=True),
    "target_size": dict(bgcolor=[10, 20, 30], target_size=(40, 40)),
    "split_skip_max": dict(bgcolor=[0, 0, 0], split_for_pose=True, skip=1, maxframes=5),
    "native": dict(bgcolor=None, seeded=True, use_native=True, target_size=(48, 48)),
    "prefetch": dict(bgcolor=None, seeded=True, prefetch=True, crop_size=(32, 32)),
    # the port's store (retain, port only) read twice: the first pass reads
    # and keeps each frame, the second composites the kept one-channel mask
    "retain_distorted_gray": dict(bgcolor=None, seeded=True, target_size=(48, 48), distorted=True, retain=True,
                                  passes=2),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_dataset_items_match_jax(data_dir, gray_distorted_dir, case):
    kw = dict(TRAIN_CASES[case])
    if kw.get("use_native") and not TN.available():
        pytest.skip("the native library cannot be built or loaded here")
    seeded = kw.pop("seeded", False)
    path = gray_distorted_dir if kw.pop("distorted", False) else data_dir
    passes = kw.pop("passes", 1)
    port_only = {"retain": kw.pop("retain")} if "retain" in kw else {}
    sets = []
    for mod, own in ((TD, port_only), (JD, {})):
        extra = {"rng": np.random.default_rng(3)} if seeded else {}
        sets.append(mod.TrainDataset(path, **kw, **extra, **own))
    t, j = sets
    assert len(t) == len(j) and t.framelist == j.framelist
    for _ in range(passes):
        for i in range(len(j)):
            assert_items_equal(t[i], j[i])
    if port_only:
        assert sorted(t._store) == sorted(t.framelist)
        assert all(alpha.ndim == 2 for _, alpha in t._store.values())
    info_t, info_j = t.get_canonical_info(), j.get_canonical_info()
    for k in ("canonical_joints", "canonical_vertex", "canonical_lbs_weights", "faces"):
        np.testing.assert_array_equal(info_t[k], info_j[k], err_msg=k)
    for k in ("min_xyz", "max_xyz", "scale_xyz"):
        np.testing.assert_array_equal(info_t["canonical_bbox"][k], info_j["canonical_bbox"][k])
    np.testing.assert_array_equal(t.get_all_Es(), j.get_all_Es())


@pytest.mark.parametrize("test_type", ["view", "pose"])
def test_zju_test_dataset_items_match_jax(data_dir, raw_dir, test_type):
    t = TD.ZJUTestDataset(raw_dir, data_dir, test_type=test_type, bgcolor=[0, 0, 0], skip=1, exclude_view=0)
    j = JD.ZJUTestDataset(raw_dir, data_dir, test_type=test_type, bgcolor=[0, 0, 0], skip=1, exclude_view=0)
    assert len(t) == len(j) > 0
    for i in range(len(j)):
        assert_items_equal(t[i], j[i])


@pytest.mark.parametrize("src_type", ["zju_mocap", "wild"])
def test_freeview_dataset_items_match_jax(data_dir, src_type):
    kw = dict(frame_idx=1, total_frames=6, src_type=src_type, target_size=(48, 48))
    t, j = TD.FreeviewDataset(data_dir, **kw), JD.FreeviewDataset(data_dir, **kw)
    assert len(t) == len(j) == 6
    for i in (0, 2, 5):
        assert_items_equal(t[i], j[i])


def test_newpose_dataset_items_match_jax(data_dir, tmp_path):
    path = TS.write_synthetic_mdm_poses(str(tmp_path / "mdm.npy"), n_frames=3)
    t, j = TD.NewPoseDataset(data_dir, path, img_size=(64, 64)), JD.NewPoseDataset(data_dir, path, img_size=(64, 64))
    assert len(t) == len(j) == 3
    for i in range(3):
        assert_items_equal(t[i], j[i])


def test_native_loader_matches_jax(data_dir):
    if not TN.available():
        pytest.skip("the native library cannot be built or loaded here")
    from gomavatar_tpu.data import native_loader as JN

    img = os.path.join(data_dir, "images", "frame_000001.png")
    mask = os.path.join(data_dir, "masks", "frame_000001.png")
    K = np.array([[80.0, 0, 48], [0, 80, 48], [0, 0, 1]])
    D = np.array([0.01, -0.02, 0, 0, 0.0])
    bg = np.array([10.0, 200.0, 30.0], np.float32)
    assert TN.probe_image(img) == JN.probe_image(img) == (2 * HW[0], 2 * HW[1])
    for a, b in zip(TN.load_frame(img, mask, K, D, bg, HW), JN.load_frame(img, mask, K, D, bg, HW)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TN.rodrigues(np.array([0.1, 0.2, 0.3])), JN.rodrigues(np.array([0.1, 0.2, 0.3])))


def test_to_device_gives_float32_tensors_without_the_name_keys(data_dir):
    item = TD.TrainDataset(data_dir, bgcolor=[0, 0, 0])[0]
    item["img_width"], item["img_height"] = 96, 96
    out = TD.to_device(item, "cpu")
    assert set(out) == set(item) - set(TD.EXCLUDE_KEYS)
    for k, v in out.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device.type == "cpu", k
        np.testing.assert_array_equal(v.numpy(), np.asarray(item[k], np.float32), err_msg=k)


# ---- the Prefetcher (the cases of tests/test_datasets.py) ---------------------


def test_prefetcher_yields_in_order(data_dir):
    ds = TD.TrainDataset(data_dir, bgcolor=[0, 0, 0])
    items = list(TD.Prefetcher(ds, order=[3, 0, 1, 2]))
    assert [it["frame_name"] for it in items] == ["frame_000003", "frame_000000", "frame_000001", "frame_000002"]


class _Boom:
    def __init__(self, n, bad):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError("decode failed")
        return {"i": i}


@pytest.mark.parametrize("workers", [1, 4])
def test_prefetcher_forwards_worker_errors(workers):
    out = []
    with pytest.raises(RuntimeError, match="Prefetcher worker failed"):
        for item in TD.Prefetcher(_Boom(8, 5), workers=workers):
            out.append(item["i"])
    assert out == [0, 1, 2, 3, 4]


def test_prefetcher_pool_keeps_order_under_backpressure():
    class Slow:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            time.sleep(0.02 if i % 3 == 0 else 0.001)
            return {"i": i}

    order = [7, 2, 9, 0, 5, 1, 11, 3]
    assert [it["i"] for it in TD.Prefetcher(Slow(), order=order, workers=4, depth=3)] == order


def test_threaded_getitem_keeps_the_random_stream_intact(data_dir):
    ds = TD.TrainDataset(data_dir, bgcolor=None)
    items = list(TD.Prefetcher(ds, order=list(range(4)) * 8, workers=8))
    assert len(items) == 32
    for it in items:
        assert np.isfinite(it["bgcolor"]).all() and (it["bgcolor"] >= 0).all() and (it["bgcolor"] <= 1).all()


def test_seeded_prefetcher_draws_do_not_depend_on_the_workers(data_dir):
    """With a seed, item ``pos`` draws its background from (seed, pos): the
    same items on 1 and 8 workers and on every run, each equal to
    ``dataset.item`` with that generator."""
    ds = TD.TrainDataset(data_dir, bgcolor=None)
    order = list(range(4)) * 4
    runs = [list(TD.Prefetcher(ds, order=order, workers=w, seed=(3, 0))) for w in (1, 8, 8)]
    for items in runs[1:]:
        for a, b in zip(runs[0], items):
            np.testing.assert_array_equal(a["bgcolor"], b["bgcolor"])
            np.testing.assert_array_equal(a["target_rgbs"], b["target_rgbs"])
    want = ds.item(order[5], np.random.default_rng((3, 0, 5)))
    np.testing.assert_array_equal(runs[0][5]["bgcolor"], want["bgcolor"])
    assert len({tuple(it["bgcolor"]) for it in runs[0]}) == len(order)


def test_prefetcher_early_break_releases_workers():
    class Slow:
        def __len__(self):
            return 50

        def __getitem__(self, i):
            time.sleep(0.002)
            return {"i": i}

    before = threading.active_count()
    pf = TD.Prefetcher(Slow(), workers=4, depth=2)
    for item in pf:
        if item["i"] == 3:
            break
    for t in pf._threads:
        t.join(timeout=5)
    assert all(not t.is_alive() for t in pf._threads)
    assert threading.active_count() <= before + 1


# ---- the decoded-frame store ---------------------------------------------------

DISTORTIONS = np.array([-0.12, 0.03, 0.002, -0.001, 0.0])
STORE_KW = dict(bgcolor=None, crop_size=(32, 32))


def _distorted_copy(src, out, mask):
    """A copy of the capture ``src`` at ``out`` with radially distorted
    cameras; its masks as written (three equal channels, ``gray_mask``),
    one channel (``gray_png``), or three that differ (``color_mask``)."""
    from PIL import Image

    shutil.copytree(src, out)
    path = os.path.join(out, "cameras.pkl")
    with open(path, "rb") as f:
        cams = pickle.load(f)
    for cam in cams.values():
        cam["distortions"] = DISTORTIONS.copy()
    with open(path, "wb") as f:
        pickle.dump(cams, f)
    for name in os.listdir(os.path.join(out, "masks")) if mask != "gray_mask" else ():
        p = os.path.join(out, "masks", name)
        m = np.array(Image.open(p))
        if mask == "gray_png":
            m = np.ascontiguousarray(m[..., 0])
        else:
            m[..., 1] //= 2
        Image.fromarray(m).save(p)
    return out


@pytest.fixture(scope="module", params=["gray_mask", "color_mask"])
def distorted_dir(request, tmp_path_factory, data_dir):
    """The synthetic capture with distorted cameras; its masks three equal
    channels (stored in one), or three that differ (stored in three)."""
    return _distorted_copy(data_dir, str(tmp_path_factory.mktemp("distorted") / "data"), request.param), request.param


@pytest.fixture(scope="module")
def gray_distorted_dir(tmp_path_factory, data_dir):
    """The synthetic capture with distorted cameras and one-channel PNG
    masks."""
    return _distorted_copy(data_dir, str(tmp_path_factory.mktemp("gray") / "data"), "gray_png")


def _epochs(ds, n_epochs, order_seed=5):
    """``n_epochs`` epochs of ``ds`` through the training loop's feed
    (``cli/train.py:train_feed``): (epoch, pos, frame index, item), and per
    epoch the counts of hits, misses, reads and undistorts."""
    from gomavatar_tpu_torch.cli.train import train_feed
    from gomavatar_tpu_torch.utils import profiling

    out, bounds = [], [time.perf_counter()]
    with profiling.recording():
        for epoch, pos, item, _ in train_feed(ds, np.random.default_rng(order_seed), "cpu"):
            if epoch > n_epochs:
                break
            out.append((epoch, pos, ds.framelist.index(item["frame_name"]), item))
            if pos == len(ds) - 1:
                bounds.append(time.perf_counter())
    counts = []
    for t0, t1 in zip(bounds, bounds[1:]):
        recs = profiling.records(t0, t1)
        counts.append({n: sum(r.n for r in recs if isinstance(r, profiling.Count) and r.name == n)
                       for n in ("data.decode_cache_hit", "data.decode_cache_miss")}
                      | {n: sum(1 for r in recs if isinstance(r, profiling.Span) and r.name == n)
                         for n in ("data.read", "data.undistort")})
    return out, counts


def test_retained_items_equal_fresh_reads_bit_for_bit(distorted_dir):
    """Two epochs of a retaining dataset through the training loop's feed
    (its seeded Prefetcher): every item, the second epoch's hits included,
    equals bit for bit, every key, that of a dataset that keeps nothing,
    drawn with the same (epoch, pos) seed; the first epoch counts only
    misses (each with its read and undistort), the second only hits."""
    data, mask = distorted_dir
    ds = TD.TrainDataset(data, retain=True, **STORE_KW)
    fresh = TD.TrainDataset(data, **STORE_KW)
    items, counts = _epochs(ds, 2)
    n = len(ds)
    assert counts[0] == {"data.decode_cache_hit": 0, "data.decode_cache_miss": n,
                         "data.read": n, "data.undistort": n}
    assert counts[1] == {"data.decode_cache_hit": n, "data.decode_cache_miss": 0,
                         "data.read": 0, "data.undistort": 0}
    for epoch, pos, i, it in items:
        assert_items_equal(it, fresh.item(i, np.random.default_rng((epoch, 0, pos))))
    assert not fresh._store
    assert sorted(ds._store) == sorted(ds.framelist)
    for img, alpha in ds._store.values():
        assert img.dtype == alpha.dtype == np.uint8
        assert alpha.shape == (img.shape[:2] if mask == "gray_mask" else img.shape)


@pytest.mark.parametrize("k", [0, 2, 5])
def test_store_budget_admits_exactly_k_frames(data_dir, monkeypatch, k):
    """Half the host's available memory (patched here) admits ``k`` frames
    of the first epoch and no more, in the second epoch either; every item
    equals a fresh read's."""
    probe = TD.TrainDataset(data_dir, **STORE_KW)
    img, alpha = probe._load_raw(probe.framelist[0])
    frame_bytes = img.nbytes + alpha.nbytes
    monkeypatch.setattr(TD, "_available_memory_bytes", lambda: 2 * (k * frame_bytes + frame_bytes // 2))
    ds = TD.TrainDataset(data_dir, retain=True, **STORE_KW)
    items, counts = _epochs(ds, 2)
    assert len(ds._store) == k and ds._store_bytes == k * frame_bytes
    assert [c["data.decode_cache_hit"] for c in counts] == [0, k]
    for epoch, pos, i, it in items:
        assert_items_equal(it, probe.item(i, np.random.default_rng((epoch, 0, pos))))


def test_prefetch_store_holds_compact_uint8_frames(data_dir):
    """``prefetch=True`` reads every frame at construction into the same
    store: uint8, 4 bytes a pixel (the mask in one channel)."""
    ds = TD.TrainDataset(data_dir, prefetch=True, **STORE_KW)
    assert sorted(ds._store) == sorted(ds.framelist)
    for img, alpha in ds._store.values():
        assert img.dtype == alpha.dtype == np.uint8
        assert img.nbytes + alpha.nbytes <= 4 * img.shape[0] * img.shape[1]


def test_single_pass_readers_keep_nothing(data_dir, tmp_path, monkeypatch):
    """The datasets of ``cli/evaluate.py`` (train and snapshot view splits)
    and ``cli/train_pose.py`` read each frame once: after a pass their
    store is empty; ``cli/train.py``'s keeps every frame."""
    import types

    import yaml

    from gomavatar_tpu_torch.cli import evaluate as eval_cli
    from gomavatar_tpu_torch.cli import train as train_cli
    from gomavatar_tpu_torch.cli import train_pose as pose_cli
    from gomavatar_tpu_torch.config import make_cfg

    path = str(tmp_path / "exp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"exp_name": "store", "log_dir": str(tmp_path / "log"), "img_size": list(HW),
                        "dataset": {"train": {"dataset_path": data_dir},
                                    "test_view": {"dataset_path": data_dir, "name": "snapshot", "skip": 1}}}, f)
    cfg = make_cfg(path)
    sets = [eval_cli.build_dataset(cfg, types.SimpleNamespace(type=t, dataset_path=None))[0]
            for t in ("train", "view")]

    class Built(Exception):
        pass

    def stop(_cfg, info, device):
        raise Built

    made = []

    class Spy(TD.TrainDataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(pose_cli, "TrainDataset", Spy)
    monkeypatch.setattr(pose_cli, "Trainer", stop)
    with pytest.raises(Built):
        pose_cli.main(["--cfg", path, "--device", "cpu"])
    for ds in sets + made:
        for i in range(len(ds)):
            ds[i]
        assert not ds._store
    assert len(made) == 1
    ds = train_cli.train_dataset(cfg)
    list(TD.Prefetcher(ds))
    assert sorted(ds._store) == sorted(ds.framelist)


@pytest.mark.parametrize("balanced", [False, True], ids=["permutation", "pose_balanced"])
def test_train_feed_draws_each_item_from_its_epoch_rank_and_position(data_dir, balanced):
    """``cli/train.py:train_feed`` at world 2, each rank over two epochs:
    epochs from 1, the rank's items (``rank_items``) of each epoch's order
    from ``order_rng`` (the same order on both ranks), each item
    ``dataset.item(i, default_rng((epoch, rank, pos)))`` of a dataset that
    keeps nothing, bit for bit, and its batch ``to_device``'s; fewer frames
    than ranks raises."""
    from gomavatar_tpu_torch.cli.train import train_feed
    from gomavatar_tpu_torch.parallel import rank_items

    ds = TD.TrainDataset(data_dir, bgcolor=None, retain=True)
    fresh = TD.TrainDataset(data_dir, bgcolor=None)
    Es = ds.get_all_Es() if balanced else None
    for rank in range(2):
        order_rng = np.random.default_rng(7)
        feed = train_feed(ds, np.random.default_rng(7), "cpu", world=2, rank=rank, balanced_Es=Es)
        for epoch in (1, 2):
            order = TSamp.balanced_order(Es, len(ds), order_rng) if balanced else order_rng.permutation(len(ds))
            for pos, i in enumerate(rank_items(order, 2, rank)):
                e, p, item, batch = next(feed)
                assert (e, p) == (epoch, pos)
                assert_items_equal(item, fresh.item(i, np.random.default_rng((epoch, rank, pos))))
                want = TD.to_device(item, "cpu")
                assert set(batch) == set(want) and all(torch.equal(batch[k], want[k]) for k in want)
        feed.close()
    with pytest.raises(ValueError, match=f"at least {len(ds) + 1} train frames"):
        next(train_feed(ds, np.random.default_rng(7), "cpu", world=len(ds) + 1))


@pytest.mark.parametrize("stop", ["break", "close"])
def test_train_feed_releases_its_workers_when_the_consumer_stops(data_dir, monkeypatch, stop):
    """A consumer that breaks out of the feed mid-epoch, or closes it (as
    ``train`` does), leaves no decode thread of the epoch's Prefetcher
    alive."""
    from gomavatar_tpu_torch.cli import train as train_cli

    made = []

    class Spy(TD.Prefetcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(train_cli, "Prefetcher", Spy)
    ds = TD.TrainDataset(data_dir, bgcolor=None)
    feed = train_cli.train_feed(ds, np.random.default_rng(0), "cpu")
    if stop == "break":
        for _, pos, _, _ in feed:
            if pos == 1:
                break
        del feed
    else:
        next(feed)
        feed.close()
    assert len(made) == 1
    for t in made[0]._threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in made[0]._threads)


# ---- camera helpers and sampling ------------------------------------------------


def test_camera_helpers_match_jax():
    rng = np.random.default_rng(0)
    E = np.eye(4)
    E[:3, :3] = TC._np_rodrigues(rng.normal(size=3))
    E[:3, 3] = [0.1, -0.2, 3.0]
    Rh, Th = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    for a, b in zip(TC.apply_global_tfm_to_camera(E, Rh, Th, return_global_tfms=True),
                    JC.apply_global_tfm_to_camera(E, Rh, Th, return_global_tfms=True)):
        np.testing.assert_array_equal(a, b)
    for axis, inv in (("y", False), ("z", True)):
        for idx in (0, 7):
            kw = dict(trans=np.array([0.0, 0.1, 0.2]), rotate_axis=axis, period=30, inv_angle=inv)
            np.testing.assert_array_equal(TC.rotate_camera_by_frame_idx(E, idx, **kw),
                                          JC.rotate_camera_by_frame_idx(E, idx, **kw))
    np.testing.assert_array_equal(TC.get_camrot([1.0, 2.0, 3.0], inv_camera=True),
                                  JC.get_camrot([1.0, 2.0, 3.0], inv_camera=True))
    assert TC.focal2fov(500.0, 512) == JC.focal2fov(500.0, 512)


def test_projections_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(20, 3)).astype(np.float32) * 0.3
    K = np.array([[500, 0, 256], [0, 480, 200], [0, 0, 1]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = [0.05, 0.0, 3.0]
    t = [torch.as_tensor(x) for x in (pts, K, E)]
    j = [jnp.asarray(x) for x in (pts, K, E)]
    np.testing.assert_allclose(TC.img_T_world(*t).numpy(), np.asarray(JC.img_T_world(*j)), rtol=1e-6, atol=1e-4)
    for H, W in ((200, 300), (300, 200)):
        np.testing.assert_allclose(TC.ndc_T_world(*t, H, W).numpy(), np.asarray(JC.ndc_T_world(*j, H, W)),
                                   rtol=1e-6, atol=1e-6)


def test_balanced_order_matches_jax(data_dir):
    Es = TD.TrainDataset(data_dir, bgcolor=[0, 0, 0]).get_all_Es()
    np.testing.assert_array_equal(TSamp.make_weights_for_pose_balance(Es), JSamp.make_weights_for_pose_balance(Es))
    a = TSamp.balanced_order(Es, 11, np.random.default_rng(4))
    b = JSamp.balanced_order(Es, 11, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)


def test_tb_reads_a_scalar_only_on_its_cadence(tmp_path):
    """Off the cadence a scalar is not converted (a device tensor would make
    the host wait); on it, it is written."""
    from gomavatar_tpu_torch.utils.tb import TBLogger

    class NoRead:
        def __float__(self):
            raise AssertionError("read off the cadence")

    tb = TBLogger(str(tmp_path), freq=4)
    tb.set_step(3)
    tb.summ_scalar("x", NoRead())
    tb.summ_image("img", np.zeros((4, 4, 3)))
    tb.set_step(4)
    tb.summ_scalar("x", torch.tensor(2.5))
    tb.summ_feat("feat", np.random.default_rng(0).normal(size=(8, 6, 5)).astype(np.float32))
    tb.summ_pointcloud2d("pts", np.array([[1.0, 2.0], [4.0, 3.0], [-5.0, 99.0]]), (8, 8))
    tb.close()
    assert any(f.startswith("events") for f in os.listdir(tmp_path))

"""A train item's composite and resizes on the card (``data/composite.py``,
``csrc/composite_resize.cu``), on the CPU: the plain float64 version the
kernel is held to against the host path's numpy composite and
``cv2.resize`` bit for bit at both of the train cells' scales, its exact
fused multiply-add, ``TrainDataset``'s items through the store-and-composite
path against the host path's (arrays, counters, ``to_device``), and the
reader of ``device_composite_pct.train``."""

import importlib.util
import math
import os
import pickle
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from gomavatar_tpu_torch.data import composite as C
from gomavatar_tpu_torch.data import dataset as TD
from gomavatar_tpu_torch.data import synthetic as TS
from gomavatar_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

# (source, output) sides of the train cells: zju377 (1024^2 PNGs to 512^2)
# and snapshot_m3c (540^2 to 544^2)
SCALES = [(1024, 512), (540, 544)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(side: int, seed: int):
    """A uint8 image and a one-channel mask with every kind of value: 0, 255
    and the levels of a soft edge."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (side, side), dtype=np.uint8)
    mask[rng.random((side, side)) < 0.35] = 0
    mask[rng.random((side, side)) < 0.35] = 255
    return img, mask


@pytest.mark.parametrize("background", ["random", "fixed"])
@pytest.mark.parametrize("src, out", SCALES, ids=["1024to512", "540to544"])
def test_plain_version_equals_the_host_path_bit_for_bit(src, out, background):
    """The host path (``TrainDataset._composite_resize`` over the stored
    one-channel mask / 255, then / 255 and float32) and the plain version
    on the same frame and background; the host path over the mask in three
    equal channels (the reference's format, its first channel kept) gives
    the same bits."""
    img, mask = _frame(src, src + out)
    bg = ((np.random.default_rng(7).random(3) * 255.0).astype(np.float32) if background == "random"
          else np.zeros(3, np.float32))
    host = TD.TrainDataset.__new__(TD.TrainDataset)
    host.target_size = (out, out)
    rgb, m = host._composite_resize(img.astype(np.float32), mask / 255.0, bg)
    rgb, m = (rgb / 255.0).astype(np.float32), m.astype(np.float32)
    rgb3, m3 = host._composite_resize(img.astype(np.float32), mask[..., None].repeat(3, axis=-1) / 255.0, bg)
    assert np.array_equal((rgb3 / 255.0).astype(np.float32), rgb) and np.array_equal(m3[..., 0].astype(np.float32), m)
    prgb, pm = C.composite_resize_plain(torch.from_numpy(img), torch.from_numpy(mask), bg, (out, out))
    assert prgb.dtype == pm.dtype == torch.float32
    assert prgb.shape == (out, out, 3) and pm.shape == (out, out)
    assert np.array_equal(prgb.numpy(), rgb) and np.array_equal(pm.numpy(), m)
    # the plain version on the CPU is the wrapper's CPU path
    wrgb, wm = C.composite_resize(torch.from_numpy(img), torch.from_numpy(mask), bg, (out, out))
    assert torch.equal(wrgb, prgb) and torch.equal(wm, pm)


def test_exact_fma_against_rational_arithmetic():
    """``fma`` rounds x * y + z once: against exact rationals on random
    operands, on OpenCV's interpolation operands (differences of k / 255 by
    fractions) and on products that cancel the addend to a few ulps."""
    g = torch.Generator().manual_seed(0)
    n = 4000
    a = torch.randint(0, 256, (n,), generator=g).double() / 255.0
    b = torch.randint(0, 256, (n,), generator=g).double() / 255.0
    x = torch.cat([torch.rand(n, generator=g, dtype=torch.float64) * 2 - 1, b - a,
                   torch.randint(-8, 8, (n,), generator=g).double() / 16.0])
    y = torch.cat([torch.randn(n, generator=g, dtype=torch.float64) * 1e3, torch.rand(n, generator=g, dtype=torch.float64),
                   torch.randint(0, 64, (n,), generator=g).double() / 64.0])
    z = torch.cat([torch.randn(n, generator=g, dtype=torch.float64), a, torch.zeros(n, dtype=torch.float64)])
    z[2 * n:] = -x[2 * n:] * y[2 * n:] + torch.randint(-3, 4, (n,), generator=g).double() * 2.0 ** -60
    got = C.fma(x, y, z)
    want = torch.tensor([float(Fraction(p) * Fraction(q) + Fraction(r))
                         for p, q, r in zip(x.tolist(), y.tolist(), z.tolist())], dtype=torch.float64)
    assert torch.equal(got, want)


@pytest.mark.parametrize("src, out", SCALES + [(96, 48)], ids=["1024to512", "540to544", "96to48"])
def test_tables_are_opencvs_taps(src, out):
    """The Lanczos coefficients sum to 1 within float32 rounding, each
    axis's taps lie in the frame around the output's centre, and the
    linear fractions lie in [0, 1)."""
    taps, coef = C.lanczos_axis(src, out)
    assert taps.shape == coef.shape == (out, C.LANCZOS_TAPS) and taps.min() >= 0 and taps.max() < src
    assert np.allclose(coef.astype(np.float64).sum(1), 1.0, atol=1e-6)
    centre = (np.arange(out) + 0.5) * src / out - 0.5
    assert np.all(np.abs(taps[:, 3] - np.clip(np.floor(centre), 0, src - 1)) <= 1)
    ltaps, frac = C.linear_axis(src, out)
    assert ltaps.min() >= 0 and ltaps.max() < src and np.all((frac >= 0) & (frac < 1))
    assert np.all(ltaps[:, 1] - ltaps[:, 0] <= 1)


@pytest.fixture(scope="module")
def distorted_dir(tmp_path_factory):
    """A 96^2 synthetic capture with distorted cameras and soft mask edges,
    read at 48^2: an exact 2x, as the 1024^2 frames to 512^2."""
    from PIL import Image

    out = TS.write_synthetic_dataset(str(tmp_path_factory.mktemp("card")), n_frames=4, img_hw=(96, 96))
    path = os.path.join(out, "cameras.pkl")
    with open(path, "rb") as f:
        cams = pickle.load(f)
    for cam in cams.values():
        cam["distortions"] = np.array([-0.2, 0.1, 0.0, 0.0, 0.0])
    with open(path, "wb") as f:
        pickle.dump(cams, f)
    for name in os.listdir(os.path.join(out, "masks")):
        p = os.path.join(out, "masks", name)
        m = np.array(Image.open(p))
        m = (m if m.ndim == 2 else m[..., 0]).astype(np.float64)
        soft = np.clip(m * 0.6 + 40 * (np.indices(m.shape).sum(0) % 3), 0, 255)
        Image.fromarray(soft.astype(np.uint8)).save(p)
    return out


@pytest.mark.parametrize("bgcolor", [None, (0.0, 255.0, 64.0)], ids=["random_bg", "fixed_bg"])
def test_store_and_composite_path_equals_the_host_path(distorted_dir, monkeypatch, bgcolor):
    """Two epochs through the training loop's feed (``cli/train.py:
    train_feed``), with the card's store and composite on the CPU
    (``CARD_TYPES``: the plain version in the kernel's place): every item's
    arrays, ``np.asarray`` of the ``CardArray``s included, equal the host
    path's bit for bit; the frames are stored as tensors (the mask one
    channel), every item counts ``data.device_composite`` and none
    ``data.host_composite``, and ``to_device`` hands the arrays over as
    they are."""
    from gomavatar_tpu_torch.cli.train import train_feed

    monkeypatch.setattr(TD.TrainDataset, "CARD_TYPES", ("cuda", "cpu"))
    kw = dict(bgcolor=bgcolor, target_size=(48, 48), retain=True)
    card = TD.TrainDataset(distorted_dir, device="cpu", **kw)
    host = TD.TrainDataset(distorted_dir, **kw)
    assert card._card_dev == torch.device("cpu") and host._card_dev is None
    n = len(card)
    fed, bounds = [], [time.perf_counter()]
    with profiling.recording():
        for epoch, pos, it, batch in train_feed(card, np.random.default_rng(5), "cpu"):
            if epoch > 2:
                break
            fed.append((epoch, pos, it, batch))
            if pos == n - 1:  # the epoch's last item: all of its items decoded, none of the next epoch's
                bounds.append(time.perf_counter())
    for epoch, (t0, t1) in enumerate(zip(bounds, bounds[1:]), 1):
        recs = profiling.records(t0, t1)
        counts = {name: sum(r.n for r in recs if isinstance(r, profiling.Count) and r.name == name)
                  for name in ("data.device_composite", "data.host_composite", "data.decode_cache_hit")}
        assert counts == {"data.device_composite": n, "data.host_composite": 0,
                          "data.decode_cache_hit": n * (epoch - 1)}, epoch
    assert len(fed) == 2 * n
    for epoch, pos, it, batch in fed:
        want = host.item(card.framelist.index(it["frame_name"]), np.random.default_rng((epoch, 0, pos)))
        assert set(it) == set(want)
        for k, v in want.items():
            if k == "frame_name":
                assert it[k] == v
                continue
            got = np.asarray(it[k])
            assert got.dtype == np.asarray(v).dtype and np.array_equal(got, v), (epoch, pos, k)
        assert isinstance(it["target_rgbs"], TD.CardArray) and isinstance(it["target_masks"], TD.CardArray)
        assert batch["target_rgbs"] is it["target_rgbs"].tensor
        assert torch.equal(batch["target_masks"], torch.from_numpy(want["target_masks"]))
    assert sorted(card._store) == sorted(card.framelist)
    for img, mask in card._store.values():
        assert img.dtype == mask.dtype == torch.uint8 and img.dim() == 3 and mask.dim() == 2


def test_card_path_stays_off_where_it_does_not_apply(distorted_dir, monkeypatch):
    """No store on the device for a single-pass reader, a random crop or no
    target size, and none for a CPU device unless the CPU is a card type;
    past the device store's room a frame is read each time (two passes:
    ``data.decode_cache_miss`` each time) and its items take the host path
    (``data.host_composite``), bit for bit the host dataset's, and the
    store keeps only the frame it had room for."""
    assert TD.TrainDataset(distorted_dir, target_size=(48, 48), retain=True, device="cpu")._card_dev is None
    monkeypatch.setattr(TD.TrainDataset, "CARD_TYPES", ("cuda", "cpu"))
    for kw in (dict(target_size=(48, 48)), dict(target_size=(48, 48), retain=True, crop_size=(32, 32)),
               dict(retain=True)):
        assert TD.TrainDataset(distorted_dir, device="cpu", **kw)._card_dev is None, kw
    ds = TD.TrainDataset(distorted_dir, target_size=(48, 48), retain=True, device="cpu")
    probe = ds._load_raw(ds.framelist[0])
    ds._store_room = probe[0].nbytes + probe[1].nbytes  # room for one frame
    n = len(ds)
    t0 = time.perf_counter()
    with profiling.recording():
        items = [ds.item(i, np.random.default_rng(i)) for _ in range(2) for i in range(n)]
    recs = profiling.records(t0)
    counts = {name: sum(r.n for r in recs if isinstance(r, profiling.Count) and r.name == name)
              for name in ("data.device_composite", "data.host_composite", "data.decode_cache_hit",
                           "data.decode_cache_miss")}
    assert counts == {"data.device_composite": 2, "data.host_composite": 2 * (n - 1), "data.decode_cache_hit": 1,
                      "data.decode_cache_miss": 1 + 2 * (n - 1)}
    assert list(ds._store) == ds.framelist[:1] and ds._store_bytes == ds._store_room
    host = TD.TrainDataset(distorted_dir, target_size=(48, 48))
    for k, it in enumerate(items):
        want = host.item(k % n, np.random.default_rng(k % n))
        for key in ("target_rgbs", "target_masks"):
            assert np.array_equal(np.asarray(it[key]), want[key])


def _reader():
    path = os.path.join(REPO, "portbench", "metrics", "device_composite_pct.train.py")
    spec = importlib.util.spec_from_file_location("probe_device_composite", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_records(monkeypatch, recs):
    def when(r):
        return r.t0 if isinstance(r, profiling.Span) else r.t

    monkeypatch.setattr(profiling, "records", lambda since=-math.inf, until=math.inf: [
        r for r in sorted(recs, key=when) if since <= when(r) < until])


def test_device_composite_share_by_hand(monkeypatch):
    """Stretch [4, 11), its first unit at 10: three items on the card and
    one on the host from there on; a host item before the first unit and a
    card item at the stretch's end are left out, and so are other
    counters."""
    P = profiling
    _stub_records(monkeypatch, [
        P.Count("data.host_composite", 9.0, 1),
        P.Span("program.call", 10.0, 10.01, None, 1, 1, None),
        P.Count("data.device_composite", 10.1, 1), P.Count("data.decode_cache_hit", 10.1, 1),
        P.Count("data.host_composite", 10.2, 1), P.Count("data.device_composite", 10.3, 2),
        P.Count("data.device_composite", 11.0, 1),
    ])
    traced = {"t_prof": [4.0, 11.0], "units_prof": 2, "digest": None}
    assert _reader().read(traced) == pytest.approx(75.0)


@pytest.mark.parametrize("no_counters", ["other_records", "no_records"])
def test_device_composite_share_is_none_without_its_counters(monkeypatch, no_counters):
    """A program older than the counters (the parent's): None, no raise."""
    P = profiling
    if no_counters == "no_records":
        monkeypatch.delattr(P, "records")
    else:
        _stub_records(monkeypatch, [P.Span("program.call", 10.0, 10.01, None, 1, 1, None),
                                   P.Count("data.decode_cache_hit", 10.3, 1)])
    traced = {"t_prof": [4.0, 11.0], "units_prof": 2, "digest": None}
    assert _reader().read(traced) is None

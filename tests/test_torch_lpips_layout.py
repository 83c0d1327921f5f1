"""The LPIPS trunk's channels-last layout (``models/lpips.py``:
``channels_last``, ``laid_out``, ``_trunk_input``), on the CPU with the
layout rule patched to channels-last: both trunks against the NCHW trunk at
even, odd and non-square sizes (the taps, and the input gradient with every
ReLU and max-pool choice pinned to the NCHW trunk's), the weights made once,
no weight cast or copy in a trunk call, ``lpips.trunk_nhwc`` counted once a
channels-last trunk call and never on the CPU's own path, and the callers
that lay a trunk out once (``Trainer``, the pose optimizer)."""

import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from gomavatar_tpu_torch import trainer as T
from gomavatar_tpu_torch.cli import train_pose
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.models import lpips as L
from gomavatar_tpu_torch.scene import E2E_TRAIN, gate_model_cfg, gate_scene
from gomavatar_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

CL = torch.channels_last
TRUNKS = {"vgg": (L.init_lpips, L._vgg_features), "alex": (L.init_lpips_alex, L._alex_features)}
SIZES = [(64, 64), (67, 67), (135, 136)]
# the channels-last trunk against the NCHW one in float32: each tap within
# this share of its largest value, the input gradient within this share of
# its norm (the two layouts' convs add in other orders)
RTOL = 1e-5


@pytest.fixture
def nhwc(monkeypatch):
    """The layout rule patched to channels-last on every device."""
    monkeypatch.setattr(L, "channels_last", lambda device: True)


@pytest.fixture(scope="module")
def raw_params():
    """Both random trunks on the CPU, as made there (NCHW, not laid out)."""
    return {k: init(device="cpu")[0] for k, (init, _) in TRUNKS.items()}


def image(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.0, 1.0, (*shape, 3)).astype(np.float32))


class Decisions(TorchFunctionMode):
    """Records every ReLU mask and max-pool choice of a trunk call, or, given
    a record, makes them again in that order: ReLU as x times the recorded
    mask, the pool as a gather at the recorded indices, each in its input's
    layout.  Two trunk calls then differ by their rounding alone: a ReLU
    input or two pooled values within rounding of each other may otherwise
    decide apart, and move the gradient of a whole receptive field."""

    def __init__(self, record=None):
        super().__init__()
        self.replay = record is not None
        self.record = list(record) if self.replay else []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.relu:
            x = args[0]
            if not self.replay:
                self.record.append(x > 0)
                return func(x)
            return x * torch.zeros_like(x).masked_fill_(self.record.pop(0), 1.0)
        if func is F.max_pool2d:
            x = args[0]
            if not self.replay:
                out, idx = F.max_pool2d_with_indices(*args, **kwargs)
                self.record.append(idx)
                return out
            idx = self.record.pop(0)
            layout = CL if not x.is_contiguous() else torch.contiguous_format
            out = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            return out.contiguous(memory_format=layout)
        return func(*args, **kwargs)


def taps_and_grad(params, features, x, weights, decisions=None):
    """(taps, input gradient of sum_k <tap_k, weights_k>) of one float32
    trunk call under ``decisions`` (a :class:`Decisions`, or none)."""
    x = x.clone().requires_grad_()
    if decisions is None:
        taps = features(params, x, False)
    else:
        with decisions:
            taps = features(params, x, False)
    loss = sum((t * w).sum() for t, w in zip(taps, weights))
    return [t.detach() for t in taps], torch.autograd.grad(loss, x)[0]


@pytest.mark.parametrize("shape", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_channels_last_trunk_is_the_nchw_trunk(trunk, shape, raw_params, monkeypatch):
    """The channels-last trunk (its taps channels-last, the input gradient
    (H, W, 3) contiguous) against the NCHW trunk in float32: every tap within
    RTOL of its largest value, unpinned; the input gradient within RTOL of
    its norm, with the ReLU and max-pool choices pinned to the NCHW trunk's
    (AlexNet's 3/2 and VGG's 2x2/2 pools crop odd sides alike: 67 -> 33,
    135 -> 67)."""
    params, features = raw_params[trunk], TRUNKS[trunk][1]
    x = image(shape, seed=shape[0] + shape[1])
    rng = np.random.default_rng(7)
    with torch.no_grad():
        shapes = [t.shape for t in features(params, x, False)]
    weights = [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in shapes]
    record = Decisions()
    want_taps, want_grad = taps_and_grad(params, features, x, weights, record)
    assert all(t.is_contiguous() for t in want_taps)

    monkeypatch.setattr(L, "channels_last", lambda device: True)
    laid = L.laid_out(params)
    taps, _ = taps_and_grad(laid, features, x, weights)
    pin = Decisions(record.record)
    pinned_taps, grad = taps_and_grad(laid, features, x, weights, pin)
    assert record.record and not pin.record  # every choice made again, in order
    for got, pinned, want in zip(taps, pinned_taps, want_taps):
        assert got.shape == want.shape and got.is_contiguous(memory_format=CL) and not got.is_contiguous()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= RTOL * scale
        assert float((pinned - want).abs().max()) <= RTOL * scale
    assert grad.shape == x.shape and grad.is_contiguous()
    assert float((grad - want_grad).norm()) <= RTOL * float(want_grad.norm())


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_laid_out_weights(trunk, raw_params, nhwc):
    """``laid_out`` makes each conv's bfloat16 copy channels-last equal to
    ``w.to(bfloat16)`` value for value, its bias in bfloat16, and its float32
    weight channels-last with the same values; the caller's params are left
    as they were, and laid-out params come back as they are."""
    params = raw_params[trunk]
    laid = L.laid_out(params)
    assert laid is not params and L.laid_out(laid) is laid
    assert laid["heads"] is params["heads"] and ("alex" in laid) == (trunk == "alex")
    for c, raw in zip(laid["convs"], params["convs"]):
        assert raw.keys() == {"w", "b"} and raw["w"].is_contiguous()
        assert c["w_bf16"].dtype == torch.bfloat16 and c["w_bf16"].is_contiguous(memory_format=CL)
        assert torch.equal(c["w_bf16"], raw["w"].to(torch.bfloat16))
        assert c["b_bf16"].dtype == torch.bfloat16 and torch.equal(c["b_bf16"], raw["b"].to(torch.bfloat16))
        assert c["w"].dtype == torch.float32 and c["w"].is_contiguous(memory_format=CL)
        assert torch.equal(c["w"], raw["w"]) and c["b"] is raw["b"]


def test_the_cpu_keeps_its_layout(raw_params):
    """On the CPU (the rule as it is) params are never laid out: ``laid_out``
    and every ``init``/``load`` give NCHW params with no copies."""
    for trunk, (init, _) in TRUNKS.items():
        params = raw_params[trunk]
        assert not L.channels_last("cpu") and L.channels_last(torch.device("cuda", 0))
        assert L.laid_out(params) is params
        assert all(c.keys() == {"w", "b"} and c["w"].is_contiguous() for c in init(device="cpu")[0]["convs"])


# the aten ops that cast or copy a tensor
COPIES = ("aten._to_copy", "aten.clone", "aten.copy_", "aten._copy_from")


class Copies(TorchDispatchMode):
    """Counts the casts and copies whose input is one of ``tensors``."""

    def __init__(self, tensors):
        super().__init__()
        self.ptrs = {t.data_ptr() for t in tensors}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(COPIES) and any(isinstance(a, torch.Tensor) and a.data_ptr() in self.ptrs for a in args):
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_a_channels_last_trunk_call_casts_no_weight(trunk, bf16, raw_params, monkeypatch):
    """Over one trunk call, forward and backward, a dispatch mode counts the
    casts and copies of a weight or bias: none channels-last with laid-out
    params; on the NCHW path, two a conv in bfloat16 (what it cast per call)
    and none in float32."""
    params, features = raw_params[trunk], TRUNKS[trunk][1]
    x = image((32, 32), seed=1).requires_grad_()
    n_convs = len(params["convs"])

    def copies(p):
        tensors = [t for c in p["convs"] for t in c.values()]
        with Copies(tensors) as mode:
            taps = features(p, x, bf16)
            torch.autograd.grad(sum(t.float().sum() for t in taps), x)
        return mode.count

    assert copies(params) == (2 * n_convs if bf16 else 0)
    monkeypatch.setattr(L, "channels_last", lambda device: True)
    assert copies(L.laid_out(params)) == 0


def test_trunk_nhwc_is_counted_once_a_channels_last_trunk_call(raw_params, monkeypatch):
    """``lpips.trunk_nhwc``: once a trunk call on the channels-last path (two
    an ``lpips`` call: the prediction's trunk and the target's), never on
    the CPU's NCHW path."""
    pred, gt = image((40, 40), seed=2), image((40, 40), seed=3)

    def counted(params):
        with profiling.recording():
            t0 = time.perf_counter()
            L.lpips(params, pred, gt)
            return sum(1 for r in profiling.records(t0) if getattr(r, "name", None) == "lpips.trunk_nhwc")

    for params in raw_params.values():
        assert counted(params) == 0
    monkeypatch.setattr(L, "channels_last", lambda device: True)
    for params in raw_params.values():
        assert counted(L.laid_out(params)) == 2
        assert counted(params) == 2  # params not laid out: laid out in the call, counted alike


def test_trainer_lays_its_trunk_out_once(raw_params, nhwc):
    """``Trainer`` holds its LPIPS params laid out, whoever made them, and
    keeps laid-out params as they are."""
    params, statics, cfg, _ = gate_scene((32, 32), device="cpu")
    tcfg = {"model": gate_model_cfg((32, 32)), "train": dict(E2E_TRAIN)}
    state = (params, statics, cfg, 0, 0)
    raw = raw_params["vgg"]
    tr = T.Trainer(tcfg, lpips_params=raw, device="cpu", state=state)
    assert "w_bf16" in tr.lpips_params["convs"][0] and "w_bf16" not in raw["convs"][0]
    laid = L.laid_out(raw)
    assert T.Trainer(tcfg, lpips_params=laid, device="cpu", state=state).lpips_params is laid
    assert T.Trainer(tcfg, lpips_params=None, device="cpu", state=state).lpips_params is None


class Steps:
    """A stand-in for the pose program: keeps each call's LPIPS params and
    hands the carry back."""

    def __init__(self):
        self.trunks = []
        self.last_args = None

    def __call__(self, *args):
        self.trunks.append(args[2])
        self.last_args = args
        return args[4]


def test_pose_optimizer_lays_a_trunk_out_once(raw_params, nhwc, monkeypatch):
    """The pose optimizer lays out the LPIPS params it is given once, on the
    first frame, and hands its steps the laid-out params on every frame
    after; new params are laid out anew."""
    made = []
    lay = L.laid_out
    monkeypatch.setattr(L, "laid_out", lambda p: made.append(p) or lay(p))
    opt = train_pose.make_pose_optimizer(None, {}, default_cfg()["pose"], 3)
    opt.program = steps = Steps()
    raw = raw_params["vgg"]
    for _ in range(2):
        opt(None, None, raw, None, torch.zeros(72))
    assert made == [raw] and len(steps.trunks) == 6
    assert all(t is steps.trunks[0] for t in steps.trunks) and "w_bf16" in steps.trunks[0]["convs"][0]
    other = raw_params["alex"]
    opt(None, None, other, None, torch.zeros(72))
    assert made == [raw, other] and "alex" in steps.trunks[-1]

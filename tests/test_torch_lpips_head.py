"""LPIPS's distance head (``models/lpips.py``: ``lpips_head``,
``lpips_head_plain``; the kernels ``csrc/lpips_head.cu``), on the CPU: the
plain version against the head as ``lpips`` wrote it inline before it became
a function (value and gradient bit for bit), a plain-torch mirror of the
kernels' arithmetic against autograd of the plain version, ``lpips`` itself
against the trunk followed by the inline head, the kernels' tiling, and the
dispatch (CPU taps never reach the kernels; other devices raise)."""

import time

import numpy as np
import pytest
import torch

from gomavatar_tpu_torch import cuda_build
from gomavatar_tpu_torch.models import lpips as L
from gomavatar_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

VGG = (64, 128, 256, 512, 512)
ALEX = (64, 192, 384, 256, 256)


def vgg_taps(side):
    """VGG16's five tap shapes (C, h, w) at a side x side input."""
    sides = [side, side // 2, side // 4, side // 8, side // 16]
    return [(c, s, s) for c, s in zip(VGG, sides)]


def alex_taps(side):
    """AlexNet's five tap shapes at a side x side input: conv1 11/4 pad 2,
    then a 3x3/2 pool before conv2 and conv3."""
    s1 = (side + 4 - 11) // 4 + 1
    s2 = (s1 - 3) // 2 + 1
    s3 = (s2 - 3) // 2 + 1
    return [(c, s, s) for c, s in zip(ALEX, (s1, s2, s3, s3, s3))]


CASES = {
    "vgg64": vgg_taps(64),
    "vgg68": vgg_taps(68),  # 34^2 and 17^2 pixels: rows not 16-byte aligned
    "alex64": alex_taps(64),
    "zeros": vgg_taps(32),
}


def make_taps(shapes, seed, zeros=False):
    """bfloat16 post-ReLU taps of the prediction (requiring grad) and the
    target, the target near the prediction on half the pixels; with
    ``zeros`` both images have all-zero feature vectors at some pixels
    (flat regions) and the prediction at more; and five heads with
    negative entries (clamped by the head)."""
    rng = np.random.default_rng(seed)
    f_p, f_g, heads = [], [], []
    for C, h, w in shapes:
        a = np.maximum(rng.normal(size=(1, C, h, w)), 0.0).astype(np.float32)
        b = np.maximum(rng.normal(size=(1, C, h, w)), 0.0).astype(np.float32)
        near = rng.random((1, 1, h, w)) < 0.5
        b = np.where(near, a + 0.01 * rng.normal(size=a.shape).astype(np.float32) * a, b)
        if zeros:
            flat = rng.random((1, 1, h, w)) < 0.3
            a = np.where(flat, 0.0, a)
            b = np.where(flat & (rng.random((1, 1, h, w)) < 0.5), 0.0, b)
        f_p.append(torch.tensor(a, dtype=torch.bfloat16).requires_grad_())
        f_g.append(torch.tensor(b, dtype=torch.bfloat16))
        heads.append(torch.tensor(rng.normal(size=(C, 1)).astype(np.float32) * 0.1))
    return f_p, f_g, heads


def inline_head(f_p, f_g, heads):
    """The head as ``lpips`` computed it inline on its float32 taps before
    ``lpips_head_plain`` existed, copied unchanged: the oracle of (a)."""
    total = torch.zeros((), dtype=torch.float32, device=f_p[0].device)
    for fp, fg, head in zip(f_p, f_g, heads):
        np_ = fp * torch.rsqrt(torch.sum(fp * fp, dim=1, keepdim=True) + 1e-20)
        ng_ = fg * torch.rsqrt(torch.sum(fg * fg, dim=1, keepdim=True) + 1e-20)
        d = (np_ - ng_) ** 2  # (1, C, h, w)
        w = torch.clamp_min(head[:, 0], 0.0)[None, :, None, None]
        total = total + torch.mean(torch.sum(d * w, dim=1))
    return total


def mirror_head(f_p, f_g, heads, g_out):
    """The kernels' arithmetic in plain torch on float32 taps: the forward
    (rp, rg per pixel, the difference squared, the taps' means added in
    order) and the closed-form backward rp g - rp^3 fp S with
    g = 2 max(w, 0) (fp rp - fg rg) g_out / (h w) and S = sum_c g fp."""
    total = torch.zeros((), dtype=torch.float32)
    grads = []
    for fp, fg, head in zip(f_p, f_g, heads):
        w = torch.clamp_min(head.reshape(-1), 0.0)[None, :, None, None]
        rp = torch.rsqrt((fp * fp).sum(dim=1, keepdim=True) + 1e-20)
        rg = torch.rsqrt((fg * fg).sum(dim=1, keepdim=True) + 1e-20)
        e = fp * rp - fg * rg
        total = total + (w * e * e).sum(dim=1).mean()
        g = w * e * (2.0 * g_out / (fp.shape[2] * fp.shape[3]))
        S = (g * fp).sum(dim=1, keepdim=True)
        grads.append(rp * g - rp ** 3 * fp * S)
    return total, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_head_equals_the_inline_head_bit_for_bit(case):
    """(a) ``lpips_head`` on CPU taps (the float32 copies of bfloat16 taps,
    through ``lpips_head_plain``) against the inline head on the same
    copies: the value and the bfloat16 gradient of every tap equal, bit for
    bit, all-zero feature vectors included."""
    f_p, f_g, heads = make_taps(CASES[case], seed=len(case), zeros=case == "zeros")
    got = L.lpips_head(f_p, f_g, heads)
    g_got = torch.autograd.grad(got * 0.7, f_p)
    want = inline_head([f.float() for f in f_p], [f.float() for f in f_g], heads)
    g_want = torch.autograd.grad(want * 0.7, f_p)
    assert torch.equal(got, want)
    for a, b in zip(g_got, g_want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_arithmetic_matches_autograd_of_the_plain_head(case):
    """(b) the mirror of the kernels' forward and closed-form backward on
    float32 taps against ``lpips_head_plain`` and its autograd gradient,
    within float32 rounding (the gradient within 1e-5 of its tap's
    largest); at all-zero feature vectors rp = 1e10 and the product is
    finite, as autograd gives it."""
    f_p, f_g, heads = make_taps(CASES[case], seed=len(case) + 1, zeros=case == "zeros")
    fp32 = [f.detach().float().requires_grad_() for f in f_p]
    fg32 = [f.float() for f in f_g]
    want = L.lpips_head_plain(fp32, fg32, heads)
    g_want = torch.autograd.grad(want * 1.3, fp32)
    got, g_got = mirror_head([f.detach() for f in fp32], fg32, heads, torch.tensor(1.3))
    assert float(got) == pytest.approx(float(want.detach()), rel=1e-6)
    for a, b in zip(g_got, g_want):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_lpips_is_the_trunk_then_the_inline_head():
    """``lpips`` on the CPU equals the bfloat16 trunk's taps, cast to
    float32, through the inline head, value and input gradient bit for bit,
    for both trunks."""
    rng = np.random.default_rng(3)
    pred = torch.tensor(rng.uniform(-1, 1, (40, 40, 3)).astype(np.float32))
    gt = torch.tensor(rng.uniform(-1, 1, (40, 40, 3)).astype(np.float32))
    for params in (L.init_lpips(device="cpu")[0], L.init_lpips_alex(device="cpu")[0]):
        feats = L._alex_features if "alex" in params else L._vgg_features
        x = pred.clone().requires_grad_()
        got = L.lpips(params, x, gt)
        g_got = torch.autograd.grad(got, x)[0]
        y = pred.clone().requires_grad_()
        want = inline_head([f.float() for f in feats(params, y, True)],
                           [f.float() for f in feats(params, gt, True)], params["heads"])
        g_want = torch.autograd.grad(want, y)[0]
        assert torch.equal(got, want) and torch.equal(g_got, g_want)


def test_cpu_taps_never_reach_the_kernels(monkeypatch):
    """(c) CPU taps leave the launch count at its value and never load the
    kernels' library, nor count ``lpips.head_kernel``; a ``meta`` tensor
    raises."""
    def no_build(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(cuda_build, "load", no_build)
    before = L.lpips_head.launches
    f_p, f_g, heads = make_taps(vgg_taps(32), seed=5)
    with profiling.recording():
        t0 = time.perf_counter()
        v = L.lpips_head(f_p, f_g, heads)
        torch.autograd.grad(v, f_p)
        counted = [r for r in profiling.records(t0) if getattr(r, "name", None) == "lpips.head_kernel"]
    assert L.lpips_head.launches == before and not counted
    meta = [torch.empty(f.shape, dtype=f.dtype, device="meta") for f in f_p]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        L.lpips_head(meta, meta, heads)


@pytest.mark.parametrize("trunk, side", [("vgg", 512), ("vgg", 544), ("alex", 512), ("vgg", 68)])
@pytest.mark.parametrize("elem", [2, 4])
def test_tiling_follows_the_tap_shapes(trunk, side, elem):
    """The kernels' (tile, vec) from (C, h w): a power of two from 8 to 256
    pixels whose two tiles fit 48 KB beside the head and scratch, and the
    widest load that divides a channel row: 16 B where h w is a multiple of
    8 (bfloat16) or 4 (float32), 8 B at 34^2 = 1,156 pixels in bfloat16,
    2 B at AlexNet's odd sides; an address off the vector width narrows
    it."""
    for C, h, w in (vgg_taps if trunk == "vgg" else alex_taps)(side):
        P = h * w
        tile, vec = L.head_plan(C, P, elem)
        assert 8 <= tile <= 256 and tile & (tile - 1) == 0
        smem = 2 * C * tile * elem + 4 * C + 8 * 256  # both tiles, the head, the groups' sums
        assert smem <= 48 * 1024 and (tile == 256 or smem + 2 * C * tile * elem > 48 * 1024)
        assert vec >= elem and (P * elem) % vec == 0 and (vec == 16 or (P * elem) % (2 * vec))
        if elem == 2 and P % 8 == 0:
            assert vec == 16
    assert L.head_plan(512, 1156, 2) == (16, 8)
    assert L.head_plan(512, 34 * 34, 2, [0x1000, 0x1004]) == (16, 4)
    assert L.head_plan(64, 127 * 127, 2) == (128, 2)
    assert L.head_plan(64, 512 * 512, 2) == (128, 16)


@pytest.mark.parametrize("trunk, side", [("vgg", 512), ("vgg", 540), ("vgg", 544), ("alex", 512)])
@pytest.mark.parametrize("elem", [2, 4])
def test_channels_last_tiling(trunk, side, elem):
    """Channels-last taps (a tile: ``tile`` pixel rows of C + 4 / elem in
    shared memory): 16-byte loads along each pixel's channels at every tap,
    540^2's odd ones (135^2, 67^2, 33^2) and AlexNet's included, the same
    tile rule as the NCHW taps' (the same tile at these widths), both tiles
    within 48 KB beside the head and scratch; and the NCHW plans as they
    were."""
    for C, h, w in (vgg_taps if trunk == "vgg" else alex_taps)(side):
        P = h * w
        tile, vec = L.head_plan(C, P, elem, [0x1000, 0x2000], nhwc=True)
        assert vec == 16 and tile == L.head_plan(C, P, elem)[0]
        smem = 2 * tile * (C + 4 // elem) * elem + 4 * C + 8 * 256
        assert smem <= 48 * 1024 and (tile == 256 or smem + 2 * tile * (C + 4 // elem) * elem > 48 * 1024)
    assert L.head_plan(512, 34 * 34, 2, nhwc=True) == (16, 16)
    assert L.head_plan(64, 135 * 135, 2, nhwc=True) == (128, 16)
    assert L.head_plan(64, 127 * 127, 2, nhwc=True) == (128, 16)
    assert L.head_plan(512, 34 * 34, 2, [0x1000, 0x1004], nhwc=True) == (16, 4)
    assert L.head_plan(512, 1156, 2) == (16, 8) and L.head_plan(64, 127 * 127, 2) == (128, 2)


def test_tiling_refuses_what_the_kernels_do_not_take():
    """Too many channels for two 8-pixel tiles in 48 KB, and a float32 tap
    at an address off 4 bytes, raise."""
    with pytest.raises(ValueError, match="channels"):
        L.head_plan(4096, 64, 2)
    with pytest.raises(ValueError, match="aligned"):
        L.head_plan(64, 64, 4, [0x1002])
    with pytest.raises(ValueError, match="channels"):
        L.head_plan(4096, 64, 2, nhwc=True)

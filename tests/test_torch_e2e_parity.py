"""Both trainers from one seed over several hundred steps across the
subdivision: whether the port leans toward wider splats (ROADMAP C5).

``test_torch_e2e_scale.py`` holds 12 steps from one init at 32^2.  Here each
package starts from its own draw of seed 0 (the same numbers, by
``gomavatar_tpu_torch.prng``; nothing is carried across) under its own
VGG-LPIPS (the shipped heads on the random trunk each draws) and trains for
STEPS steps on a toy teacher capture at 64^2, with the e2e yaml's losses and
learning rates, the kick-ins moved to iteration 0 and the subdivision at
step SPLIT.  In each phase it compares the per-face scale changes, the
largest scale, the widest splat's span on the first frame (in 16 px
tiles) and the loss trajectories.  It holds what C5 asks, no lean of the
port toward wider splats, and holds how far the two runs part face by face
against a witness: JAX's own run from the same init with every float leaf
of its params nudged to its next float32 up before each step, which shows
how far rounding-sized differences alone part two runs of one
implementation over the same steps.

Marked slow: JAX's jitted step takes ~2.5 s at 64^2 on the CPU and the
file runs it twice, so it takes ~38 min, far past the aim of ~60 s per
file of the tier-1 run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomavatar_tpu import losses as JLosses
from gomavatar_tpu.config import make_cfg as jax_make_cfg
from gomavatar_tpu.models import lpips as JL
from gomavatar_tpu.trainer import Trainer as JaxTrainer
from gomavatar_tpu_torch import losses as TLosses
from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.data.dataset import EXCLUDE_KEYS, TrainDataset
from gomavatar_tpu_torch.models import lpips as TLpips
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.tools import make_e2e_data as T
from gomavatar_tpu_torch.tools import tune_trained_budgets as TT
from gomavatar_tpu_torch.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "exps", "e2e_synthetic.yaml")
S = 64
RINGS = (16, 18)
FRAMES, STEPS, SPLIT = 4, 300, 150


def _configure(cfg):
    cfg["img_size"] = [S, S]
    m = cfg["model"]
    m["img_size"] = [S, S]
    m["subdivide_iters"] = [SPLIT]
    m["pose_refinement"]["kick_in_iter"] = 0
    m["non_rigid"]["kick_in_iter"] = 0
    m["non_rigid"]["full_band_iter"] = SPLIT
    return cfg


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_tree(v) for v in tree]
    return torch.as_tensor(np.array(tree))


def span(params, statics, cfg, batch) -> int:
    """The widest valid splat's span in tiles on a frame, by the port's
    geometry."""
    frame = {k: torch.as_tensor(batch[k]) for k in ("K", "E", "cnl_gtfms", "dst_Rs", "dst_Ts", "dst_posevec")}
    return TT.widest_span(torch_tree(params), statics, cfg, frame)


def nudged(tree):
    """Every float leaf moved to its next float32 up."""
    return jax.tree_util.tree_map(
        lambda x: jnp.nextafter(x, jnp.inf) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per run (JAX's, the port's, and the witness: JAX's with its params
    nudged before each step): the scales at the start, just before the
    split, one step after it and at the end; the losses; the widest spans at
    the end of each phase."""
    info = synthetic_body(*RINGS)
    out = str(tmp_path_factory.mktemp("toy") / "train")
    T.write_split(out, FRAMES, azimuth_deg=0.0, info=info, img=(S, S))
    T.render_split(out, *T.teacher_model(info, img=(S, S), device="cpu"), img=(S, S), device="cpu")
    ds = TrainDataset(out, bgcolor=[0, 0, 0], target_size=(S, S))
    batches = [{k: np.asarray(v, np.float32) for k, v in ds[i].items() if k not in EXCLUDE_KEYS}
               for i in range(len(ds))]
    with pytest.MonkeyPatch.context() as mp:
        # float32 LPIPS on both sides (test_torch_trainer.py says why)
        mp.setattr(JLosses, "lpips_fn", lambda p, a, b: JL.lpips(p, a, b, bf16=False))
        mp.setattr(TLosses, "lpips_fn", lambda p, a, b: TLpips.lpips(p, a, b, bf16=False))
        jax_lpips = JL.load_lpips("vgg", quiet=True)[0]
        jtr = JaxTrainer(_configure(jax_make_cfg(YAML)), info, lpips_params=jax_lpips, seed=0)
        wtr = JaxTrainer(_configure(jax_make_cfg(YAML)), info, lpips_params=jax_lpips, seed=0)
        ttr = Trainer(_configure(make_cfg(YAML)), info, lpips_params=TLpips.load_lpips("vgg", quiet=True,
                                                                                       device="cpu")[0],
                      seed=0, device="cpu")
        trainers = {"jax": jtr, "witness": wtr, "port": ttr}
        res = {name: {"scale": [], "loss": [], "span": []} for name in trainers}

        def record_scales():
            for name, tr in trainers.items():
                res[name]["scale"].append(np.array(tr.params["scale"]))

        def record_spans():
            for name, tr in trainers.items():
                res[name]["span"].append(span(tr.params, ttr.statics, ttr.gom_cfg, batches[0]))

        record_scales()
        for step in range(STEPS):
            if step == SPLIT:
                record_scales()
                record_spans()
            b = batches[step % len(batches)]
            wtr.params = nudged(wtr.params)
            for name, tr in trainers.items():
                as_array = torch.as_tensor if tr is ttr else jnp.asarray
                res[name]["loss"].append(float(tr.step({k: as_array(v) for k, v in b.items()})[0]))
            if step == SPLIT:
                record_scales()
        record_scales()
        record_spans()
    assert jtr.phase == wtr.phase == ttr.phase == 1
    assert jtr.gom_cfg.num_faces == wtr.gom_cfg.num_faces == ttr.gom_cfg.num_faces
    return res


def _phase_changes(res, name, phase):
    """Phase 0: from init to just before the split; phase 1: from one step
    after the split to the end."""
    s = res[name]["scale"]
    return s[1] - s[0] if phase == 0 else s[3] - s[2]


def test_losses_agree_and_fall(runs):
    jl, tl = np.asarray(runs["jax"]["loss"]), np.asarray(runs["port"]["loss"])
    assert np.isfinite(jl).all() and np.isfinite(tl).all()
    print(f"\nloss first {jl[0]:.6g} / {tl[0]:.6g}, at the split {jl[SPLIT]:.6g} / {tl[SPLIT]:.6g}, "
          f"last {jl[-1]:.6g} / {tl[-1]:.6g}; max rel diff {np.max(np.abs(tl - jl) / np.abs(jl)):.3g}")
    np.testing.assert_allclose(tl[:3], jl[:3], rtol=1e-3)
    assert tl[SPLIT - 1] < tl[0] and jl[SPLIT - 1] < jl[0]


@pytest.mark.parametrize("phase", [0, 1])
def test_no_lean_toward_wider_splats(runs, phase):
    """What C5 asks: the mean per-face scale change within 5e-2 of its
    spread of JAX's, the largest scale within 5 %, the widest splat's span
    in tiles no wider than JAX's.  Face by face the port's changes part
    from JAX's by at most twice what the witness's do (the relative L2
    difference), and the witness does part: rounding alone, through Adam's
    sign-sensitive first steps, sends two runs of JAX apart."""
    dj, dt, dw = (_phase_changes(runs, name, phase) for name in ("jax", "port", "witness"))
    assert np.abs(dj).max() > 0
    rel = float(np.linalg.norm(dt - dj) / np.linalg.norm(dj))
    rel_w = float(np.linalg.norm(dw - dj) / np.linalg.norm(dj))
    lean = float(dt.mean() - dj.mean()) / float(dj.std())
    sj, st = runs["jax"]["scale"][2 * phase + 1], runs["port"]["scale"][2 * phase + 1]
    tj, tt, tw = (runs[name]["span"][phase] for name in ("jax", "port", "witness"))
    print(f"\nphase {phase}: scale change L2 difference of JAX's, port {rel:.4g}, witness {rel_w:.4g}; mean change "
          f"port {dt.mean():.4g} JAX {dj.mean():.4g} witness {dw.mean():.4g} ({lean:+.3g} of the spread), largest "
          f"scale port {st.max():.6g} JAX {sj.max():.6g}, widest span port {tt} JAX {tj} witness {tw} tiles")
    assert abs(lean) < 0.05, lean
    np.testing.assert_allclose(st.max(), sj.max(), rtol=0.05)
    assert tt <= tj, (tt, tj)
    assert 0 < rel_w and rel <= 2 * rel_w, (rel, rel_w)

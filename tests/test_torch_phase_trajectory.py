"""The train step of gomavatar_tpu_torch against gomavatar_tpu's Trainer on the
CPU through the subdivision: test_torch_trainer.py's 48^2 body, config and
batch with the mesh subdivided at step SPLIT, STEPS optimizer steps of both
from the same params (JAX's, through ``params_from_jax``), LPIPS in float32
on both sides (test_torch_trainer.py says why), and the shadow MLP too:
torch's and XLA's bfloat16 matmuls round differently, which on the
subdivided mesh (four times the faces, each over fewer pixels) moves the
first post-split step's gradients from the same params by up to 1.9 % of a
leaf's largest value (the appearance colors; 5.3 % for the shadow MLP's
own), against at most 2.1e-5 with the MLP in float32 on both sides.

Both packages rebuild the optimizer at the split: new moments and a new
Adam count, the lr schedule continued from the global iteration.  Each loss
term, the face count, both counts and the first post-split step's gradients
(read from Adam's first moments, which the rebuild zeroed: mu = (1 - 0.9) *
gradient) are held to JAX's.

Past the first post-split step rounding alone parts the loss terms by more
than LOSS_RTOL: a witness, JAX's own run with every float leaf of its params
moved to its next float32 up before each step, parted from JAX's by up to
1.7e-3 (normal_consist) at step 3.  So there the port's largest relative
difference over the terms is held within WITNESS_K times the witness's
(the multiple of test_torch_e2e_parity.py), or LOSS_RTOL where that is
larger.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu import losses as JLosses
from gomavatar_tpu.config import default_cfg as jax_default_cfg
from gomavatar_tpu.models import lpips as JL
from gomavatar_tpu.models import modules as JM
from gomavatar_tpu.models.smpl import synthetic_body
from gomavatar_tpu.trainer import Trainer as JaxTrainer
from gomavatar_tpu_torch import losses as TLosses
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import params_from_jax
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.models import lpips as TLpips
from gomavatar_tpu_torch.models import modules as TM
from gomavatar_tpu_torch.models.lpips import HEADS_PATH
from gomavatar_tpu_torch.optim import tree_leaves
from gomavatar_tpu_torch.trainer import Trainer
from test_torch_trainer import (GRAD_ATOL_REL, LOSS_RTOL, LOSS_RTOL_STEP0, SHADOW_ATOL_REL, _batch_np, _configure,
                                _lpips_f32)
from torch_threads import one_torch_thread  # noqa: F401

SPLIT, STEPS = 2, 4
WITNESS_K = 2.0


def _jax_shadow_f32(params, cfg, normals):
    """JAX's ``shadow_apply`` with its MLP in float32."""
    pe = JM.positional_encoding(normals, cfg["multires"], include_input=True)
    skips = tuple(s for s in cfg["skips"] if s < cfg["mlp_depth"])
    return jax.nn.sigmoid(JM.mlp_apply(params, pe, skips=skips, skip_input=pe))


def _torch_shadow_f32(params, cfg, normals):
    """The port's ``shadow_apply`` with its MLP in float32."""
    pe = TM.positional_encoding(normals, cfg["multires"], include_input=True)
    return torch.sigmoid(TM.mlp_apply(params, pe, skips=TM._shadow_skips(cfg), skip_input=pe))


def _jax_lpips(heads):
    """JAX's ``init_lpips(heads=heads)`` params, from the port's draw of the
    same random trunk (bit for bit JAX's, tests/test_torch_init.py): the
    draw in JAX takes seconds longer."""
    ws = TLpips.random_trunk(1234, tuple(TLpips.vgg_shapes()))
    return {"convs": [{"w": jnp.asarray(w), "b": jnp.zeros((w.shape[3],), jnp.float32)} for w in ws],
            "heads": [jnp.asarray(np.asarray(h, np.float32).reshape(-1, 1)) for h in heads]}


def _counts(jtr, ttr):
    """(JAX's Adam count, its schedule count, the port's two)."""
    return (int(jtr.opt_state[0].count), int(jtr.opt_state[-1].count), int(ttr.opt_state.count),
            int(ttr.opt_state.schedule_count))


@pytest.fixture(scope="module")
def runs():
    """Per step of each package: the loss terms, the face count and the
    counts after the step; the witness's loss terms; JAX's first moments
    after step SPLIT and the port's after the same step from JAX's params;
    the port's trainer."""
    info = synthetic_body(n_rings=10, n_seg=8)
    with np.load(HEADS_PATH) as z:
        heads = [z[f"head_{i}"] for i in range(5)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLosses, "lpips_fn", _lpips_f32(JL.lpips))
        mp.setattr(TLosses, "lpips_fn", _lpips_f32(TLpips.lpips))
        mp.setattr(JM, "shadow_apply", _jax_shadow_f32)
        mp.setattr(TM, "shadow_apply", _torch_shadow_f32)
        jtr = JaxTrainer(_configure(jax_default_cfg(), subdivide_at=SPLIT), info,
                         lpips_params=_jax_lpips(heads), seed=0)
        rng = np.random.default_rng(0)
        F = jtr.gom_cfg.num_faces
        jtr.params["so3"] = jnp.asarray(0.2 * rng.standard_normal((F, 3)), jnp.float32)
        jtr.params["scale"] = jnp.asarray(1.0 + 0.2 * rng.standard_normal((F, 3)), jnp.float32)
        jtr.params["appearance"] = {"colors": jnp.asarray(rng.uniform(0.05, 0.95, (F, 3)), jnp.float32)}
        wtr = copy.copy(jtr)  # the witness: JAX's trainer on a state of its own
        cfg = _configure(default_cfg(), subdivide_at=SPLIT)
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params), device="cpu")
        _, statics, gom_cfg = TG.init_gom(cfg["model"], info, device="cpu")
        ttr = Trainer(cfg, lpips_params=TLpips.init_lpips(heads=heads, device="cpu")[0], device="cpu",
                      state=(params, statics, gom_cfg, 0, 0))
        batch = _batch_np(info)
        j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        t_batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        out = {"jax": [], "port": [], "witness": [], "faces0": F}
        for step in range(STEPS):
            if step == SPLIT:
                # a port trainer from JAX's params just before the split: its
                # first post-split gradients are taken where JAX's are
                synced = Trainer(cfg, lpips_params=ttr.lpips_params, device="cpu",
                                 state=(params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params), device="cpu"),
                                        statics, gom_cfg, SPLIT, 0))
                synced.step(t_batch)
                out["t_mu"] = [m.numpy().copy() for m in synced.opt_state.mu]
            jt, jl = jtr.step(j_batch)
            wtr.params = jax.tree_util.tree_map(lambda x: jnp.asarray(np.nextafter(np.asarray(x), np.float32(np.inf))),
                                                wtr.params)
            wtr.maybe_subdivide()
            wtr._step_fn = jtr._step_fn  # JAX's step of this phase, compiled once
            wt, wl = wtr.step(j_batch)
            out["witness"].append({"total": float(wt), **{k: float(v) for k, v in wl.items()}})
            tt, tl = ttr.step(t_batch)
            counts = _counts(jtr, ttr)
            out["jax"].append(({"total": float(jt), **{k: float(v) for k, v in jl.items()}},
                               jtr.gom_cfg.num_faces, counts[:2]))
            out["port"].append(({"total": float(tt), **{k: float(v) for k, v in tl.items()}},
                                ttr.gom_cfg.num_faces, counts[2:]))
            if step == SPLIT:
                out["j_mu"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(jtr.opt_state[0].mu)]
    out["trainer"] = ttr
    return out


def test_loss_terms_match_jax_through_the_split(runs):
    for step, ((j, _, _), (t, _, _), w) in enumerate(zip(runs["jax"], runs["port"], runs["witness"])):
        # the port's telemetry adds the most tiles one splat covered
        assert set(j) == set(t) - {"bin_most_tiles"} == set(w) and t["bin_most_tiles"] > 0, step
        terms = [k for k in j if not k.startswith("bin_drop")]
        for k in set(j) - set(terms):
            assert t[k] == j[k] == 0, (step, k)
        assert all(np.isfinite(t[k]) for k in terms), step
        if step <= SPLIT:
            rtol = LOSS_RTOL_STEP0 if step == 0 else LOSS_RTOL
            for k in terms:
                np.testing.assert_allclose(t[k], j[k], rtol=rtol, err_msg=f"step {step} {k}")
        else:
            port = max(abs(t[k] - j[k]) / abs(j[k]) for k in terms)
            witness = max(abs(w[k] - j[k]) / abs(j[k]) for k in terms)
            assert witness > 0 and port <= max(LOSS_RTOL, WITNESS_K * witness), (step, port, witness)


def test_faces_and_counts_across_the_split(runs):
    """Faces x4 from step SPLIT on in both; Adam's count restarts at the
    rebuild and the schedule's runs on with the global iteration, equal in
    both packages after every step."""
    f0 = runs["faces0"]
    for step, ((_, jf, jc), (_, tf, tc)) in enumerate(zip(runs["jax"], runs["port"])):
        want = 4 * f0 if step >= SPLIT else f0
        assert jf == tf == want, (step, jf, tf)
        assert jc == tc, (step, jc, tc)
        adam = step + 1 if step < SPLIT else step + 1 - SPLIT
        assert tc == (adam, step + 1), (step, tc)
    ttr = runs["trainer"]
    assert ttr.phase == 1 and ttr.params["so3"].shape[0] == 4 * f0


def test_first_post_split_gradients_match_jax(runs):
    """The gradients of step SPLIT, the first on the subdivided mesh, both
    from JAX's params just before the split (after two free steps rounding
    alone parts them: with the shadow MLP in bfloat16 the witness's by up to
    8 % of a leaf's largest value): each leaf within GRAD_ATOL_REL of its
    largest |gradient| (the shadow MLP's within SHADOW_ATOL_REL), as
    test_torch_trainer.py holds step 1's."""
    ttr = runs["trainer"]
    names = [k for k in sorted(ttr.params) for _ in tree_leaves(ttr.params[k])]
    j_mu, t_mu = runs["j_mu"], runs["t_mu"]
    assert len(j_mu) == len(t_mu) == len(names)
    for name, a, b in zip(names, t_mu, j_mu):
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        scale = float(np.abs(b).max())
        assert scale > 0, name
        rel = SHADOW_ATOL_REL if name == "shadow" else GRAD_ATOL_REL
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=name)

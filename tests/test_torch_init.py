"""One seed into both packages, and no conversion: the port's seeded draws
(``gomavatar_tpu_torch.prng``) give the JAX package's initial state.

Nothing here carries an array across with ``convert.params_from_jax``:
each package draws its own init from the same seed, and the two are held
equal leaf for leaf, bit for bit.  That covers ``init_gom``
under two experiment configs, ``Trainer(seed=s)`` (and one train step from
there, within ``test_torch_trainer.py``'s tolerances), ``cli.animate``'s
synthetic avatars, the gate scene against ``__graft_entry__._flagship``, the
e2e teacher's shadow MLP against JAX's draw and the committed witness, and
both LPIPS trunks as ``load_lpips`` builds them (params equal, LPIPS within
rtol 1e-5 on a 64^2 pair).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomavatar_tpu import losses as JLosses
from gomavatar_tpu.cli import animate as JA
from gomavatar_tpu.config import default_cfg as jax_default_cfg
from gomavatar_tpu.config import make_cfg as jax_make_cfg
from gomavatar_tpu.models import lpips as JL
from gomavatar_tpu.models.gom import init_gom as jax_init_gom
from gomavatar_tpu.models.smpl import synthetic_body as jax_synthetic_body
from gomavatar_tpu.trainer import Trainer as JaxTrainer
from gomavatar_tpu_torch import losses as TLosses
from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.cli import animate as TA
from gomavatar_tpu_torch.config import default_cfg, make_cfg
from gomavatar_tpu_torch.convert import unflatten_params
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.models import lpips as TL
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.optim import tree_leaves
from gomavatar_tpu_torch.scene import gate_scene
from gomavatar_tpu_torch.tools import make_e2e_data as TD
from gomavatar_tpu_torch.trainer import Trainer
from test_torch_trainer import GRAD_ATOL_REL, LOSS_RTOL_STEP0, SHADOW_ATOL_REL, _batch_np, _configure
from torch_port_scene import tree_leaves_by_path
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import __graft_entry__ as GE  # noqa: E402  (the JAX package's gate scene)
from tools import make_e2e_data as JD  # noqa: E402  (the JAX package's generator)

YAMLS = {name: os.path.join(REPO, "configs", "exps", f"{name}.yaml") for name in ("e2e_synthetic", "zju-mocap_377")}
RINGS = (10, 8)


def assert_trees_equal(got, want):
    g, w = dict(tree_leaves_by_path(got)), dict(tree_leaves_by_path(want))
    assert sorted(g) == sorted(w)
    for k in w:
        a = g[k].cpu().numpy() if isinstance(g[k], torch.Tensor) else np.asarray(g[k])
        np.testing.assert_array_equal(a, np.asarray(w[k]), err_msg=k)
        assert a.dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("exp", sorted(YAMLS))
def test_init_gom_matches_jax(exp, seed):
    info = synthetic_body(*RINGS)
    jp, js, jc = jax_init_gom(jax.random.PRNGKey(seed), jax_make_cfg(YAMLS[exp])["model"], info)
    tp, ts, tc = TG.init_gom(make_cfg(YAMLS[exp])["model"], info, device="cpu", key=prng.key(seed))
    assert {"pose_refinement", "non_rigid", "shadow"} <= set(tp)
    assert_trees_equal(tp, jp)
    assert tc.num_faces == jc.num_faces


def test_init_gom_defaults_to_seed_0():
    m = make_cfg(YAMLS["e2e_synthetic"])["model"]
    info = synthetic_body(*RINGS)
    assert_trees_equal(TG.init_gom(m, info, device="cpu")[0],
                       jax_init_gom(jax.random.PRNGKey(0), jax_make_cfg(YAMLS["e2e_synthetic"])["model"], info)[0])


@pytest.fixture(scope="module")
def lpips_pair():
    """Both packages' default VGG-LPIPS: the shipped heads on the random
    trunk each draws for itself."""
    return JL.load_lpips("vgg", quiet=True)[0], TL.load_lpips("vgg", quiet=True, device="cpu")[0]


@pytest.fixture(scope="module")
def trainers(lpips_pair):
    """Both Trainers from seed 3 (their init), then one step of each on one
    frame, LPIPS in float32 on both sides (test_torch_trainer.py says why)."""
    j_lpips, t_lpips = lpips_pair
    info = jax_synthetic_body(n_rings=10, n_seg=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLosses, "lpips_fn", lambda p, a, b: JL.lpips(p, a, b, bf16=False))
        mp.setattr(TLosses, "lpips_fn", lambda p, a, b: TL.lpips(p, a, b, bf16=False))
        jtr = JaxTrainer(_configure(jax_default_cfg()), info, lpips_params=j_lpips, seed=3)
        ttr = Trainer(_configure(default_cfg()), info, lpips_params=t_lpips, seed=3, device="cpu")
        init = (jax.tree_util.tree_map(np.asarray, jtr.params), dict(ttr.params))
        # per-face so3, scale and colors off their constant init, the same
        # numpy arrays on both sides, as in test_torch_trainer.py: at so3 = 0
        # and equal scales the so3 gradient is 0 up to float noise
        rng = np.random.default_rng(0)
        F = jtr.gom_cfg.num_faces
        for k, v in (("so3", 0.2 * rng.standard_normal((F, 3))), ("scale", 1.0 + 0.2 * rng.standard_normal((F, 3)))):
            jtr.params[k], ttr.params[k] = jnp.asarray(v, jnp.float32), torch.as_tensor(v, dtype=torch.float32)
        colors = rng.uniform(0.05, 0.95, (F, 3))
        jtr.params["appearance"] = {"colors": jnp.asarray(colors, jnp.float32)}
        ttr.params["appearance"] = {"colors": torch.as_tensor(colors, dtype=torch.float32)}
        batch = _batch_np(info)
        jt, jl = jtr.step({k: jnp.asarray(v) for k, v in batch.items()})
        tt, tl = ttr.step({k: torch.as_tensor(v) for k, v in batch.items()})
    j_mu = [np.asarray(a) for a in jax.tree_util.tree_leaves(jtr.opt_state[0].mu)]
    return init, ({"total": float(jt), **{k: float(v) for k, v in jl.items()}}, j_mu), (
        {"total": float(tt), **{k: float(v) for k, v in tl.items()}}, [m.numpy() for m in ttr.opt_state.mu], ttr)


def test_trainer_seed_gives_jaxs_params(trainers):
    (jp, tp), _, _ = trainers
    assert_trees_equal(tp, jp)


def test_trainer_first_step_matches_jax(trainers):
    _, (jl, j_mu), (tl, t_mu, ttr) = trainers
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=LOSS_RTOL_STEP0, err_msg=k)
    names = [k for k in sorted(ttr.params) for _ in tree_leaves(ttr.params[k])]
    assert len(names) == len(t_mu) == len(j_mu)
    for name, a, b in zip(names, t_mu, j_mu):
        scale = float(np.abs(b).max())
        rel = SHADOW_ATOL_REL if name == "shadow" else GRAD_ATOL_REL
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=name)


def test_animate_synthetic_avatars_match_jax():
    jpacks, _ = JA._synthetic_scenes(2, (32, 32))
    tpacks, _ = TA._synthetic_scenes(2, (32, 32), "cpu")
    for (jp, _, jc), (tp, _, tc) in zip(jpacks, tpacks):
        assert_trees_equal(tp, jp)
        assert tc.num_faces == jc.num_faces
    # the two scenes draw from different seeds
    assert not torch.equal(tpacks[0][0]["shadow"]["head"]["w"], tpacks[1][0]["shadow"]["head"]["w"])


def test_gate_scene_is_jaxs_flagship_gate():
    jp, js, jc, _, _ = GE._flagship(img_size=(64, 64), subdivide=False, rings=(16, 18))
    tp, ts, tc, _ = gate_scene(device="cpu")
    assert_trees_equal(tp, jp)
    np.testing.assert_array_equal(ts.faces.numpy(), np.asarray(js.faces))
    assert tc.num_faces == jc.num_faces == 792


def test_teacher_shadow_is_jaxs_draw_and_the_witness():
    tp, _, _ = TD.teacher_model(synthetic_body(*RINGS), img=(32, 32), device="cpu")
    jp, _, _ = JD.teacher_model(jax_synthetic_body(*RINGS))
    with np.load(TD.TEACHER_SHADOW) as npz:
        witness = unflatten_params(npz)["shadow"]["layers"]
    assert_trees_equal(tp["shadow"], jp["shadow"])
    assert_trees_equal(tp["shadow"]["layers"], witness)


def _pair(seed=0, S=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (S, S, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("trunk, shipped", [("vgg", True), ("vgg", False), ("alex", False)],
                         ids=["vgg-shipped-heads", "vgg-empty-dir", "alex-empty-dir"])
def test_lpips_trunks_match_jax(trunk, shipped, tmp_path, lpips_pair):
    if shipped:
        jp, tp = lpips_pair
    else:
        jp, j_cal, _ = JL.load_lpips(trunk, weights_dir=str(tmp_path), quiet=True)
        tp, t_cal, _ = TL.load_lpips(trunk, weights_dir=str(tmp_path), quiet=True, device="cpu")
        assert not j_cal and not t_cal
    assert ("alex" in tp) == ("alex" in jp) == (trunk == "alex")
    assert len(tp["convs"]) == len(jp["convs"])
    for t, j in zip(tp["convs"], jp["convs"]):
        np.testing.assert_array_equal(t["w"].numpy(), np.asarray(j["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(t["b"].numpy(), np.asarray(j["b"]))
    for t, j in zip(tp["heads"], jp["heads"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    a, b = _pair()
    jv = float(JL.lpips(jp, jnp.asarray(a), jnp.asarray(b), bf16=False))
    tv = float(TL.lpips(tp, torch.as_tensor(a), torch.as_tensor(b), bf16=False))
    assert jv > 0
    np.testing.assert_allclose(tv, jv, rtol=1e-5)

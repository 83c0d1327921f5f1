"""The training loss of gomavatar_tpu_torch against gomavatar_tpu on the CPU:
the mesh topology and the mesh loss terms, ``dilate_mask``, ``unpack``, every
term of ``compute_loss``, LPIPS on the random trunk each package draws, and the
config defaults and the trained avatar's train config."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu import config as JC
from gomavatar_tpu import losses as JLo
from gomavatar_tpu.models import lpips as JL
from gomavatar_tpu.ops import mesh_ops as JM
from gomavatar_tpu_torch import config as TC
from gomavatar_tpu_torch import losses as TLo
from gomavatar_tpu_torch.models import lpips as TL
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.ops import mesh_ops as TM
from gomavatar_tpu_torch.scene import E2E_TRAIN
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5  # each loss term and its gradients
# LPIPS, value: rtol 1e-4 in float32, 1e-3 in bfloat16 (the default, as in
# the reference), where XLA's and torch's convolutions round differently.
# Its gradient in the image is discontinuous where a pre-activation crosses
# 0, and a float32 rounding flips about one ReLU gate in 10^5 (one flip at
# relu2_1 moves ~2 % of the input gradient's pixels by up to ~2 % of its
# largest value, against a float64 run): the float32 gradient within 1e-4
# of its largest value on > 95 % of values and within 5e-2 everywhere; in
# bfloat16 within 5e-2 of its largest value on > 99 % of values.
LPIPS_RTOL, LPIPS_BF16_RTOL = 1e-4, 1e-3
LPIPS_GRAD = {False: (1e-4, 0.95, 5e-2), True: (5e-2, 0.99, None)}


@pytest.fixture(scope="module")
def mesh():
    info = synthetic_body(n_rings=8, n_seg=10)
    verts = np.asarray(info["canonical_vertex"], np.float32)
    faces = np.asarray(info["faces"], np.int64)
    rng = np.random.default_rng(3)
    verts_obs = (verts + 0.01 * rng.standard_normal(verts.shape)).astype(np.float32)
    return verts, verts_obs, faces, JM.MeshTopology.build(faces, len(verts)), TM.MeshTopology.build(faces, len(verts))


def test_topology_matches_jax(mesh):
    _, _, _, j, t = mesh
    for name in ("edges", "face_to_edge", "face_connectivity", "nc_quads", "vertex_degree", "vf_incidence",
                 "vf_valid"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)


def _value_and_grad_both(jax_fn, torch_fn, *arrays):
    """(value, grads) of a scalar function of the arrays, on both sides."""
    jv, jg = jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays))))(*(jnp.asarray(a) for a in arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = torch_fn(*leaves)
    tg = torch.autograd.grad(tv, leaves)
    return (float(jv), [np.asarray(g) for g in jg]), (float(tv.detach()), [g.numpy() for g in tg])


def _assert_value_and_grads(j, t, label):
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, err_msg=label)
    for i, (a, b) in enumerate(zip(t[1], j[1])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * float(np.abs(b).max()), err_msg=f"{label} grad {i}")


def test_mesh_losses_match_jax(mesh):
    verts, verts_obs, faces, jt, tt = mesh
    j_statics = {k: jnp.asarray(getattr(jt, k)) for k in ("edges", "nc_quads", "face_connectivity", "vertex_degree")}
    t_statics = {k: torch.as_tensor(getattr(tt, k)) for k in ("edges", "nc_quads", "face_connectivity", "vertex_degree")}
    # both train steps take the neighbour-table Laplacian and the quads'
    # dual; the plain forms are held below
    j, t = _value_and_grad_both(
        lambda v: JM.uniform_laplacian_loss_nbr(v, jt.nbr_table, j_statics["vertex_degree"]),
        lambda v: TM.uniform_laplacian_loss_nbr(v, tt.nbr_table, t_statics["vertex_degree"]),
        verts_obs,
    )
    _assert_value_and_grads(j, t, "laplacian")
    j, t = _value_and_grad_both(
        lambda v: JM.normal_consistency_loss(v, j_statics["nc_quads"], jt.dual_nc),
        lambda v: TM.normal_consistency_loss(v, t_statics["nc_quads"], tt.dual_nc),
        verts_obs,
    )
    _assert_value_and_grads(j, t, "normal consistency")
    tel = np.linalg.norm(verts[jt.edges[:, 0]] - verts[jt.edges[:, 1]], axis=-1).astype(np.float32)
    j, t = _value_and_grad_both(
        lambda v: JM.mesh_edge_loss(v, j_statics["edges"], jnp.asarray(tel)),
        lambda v: TM.mesh_edge_loss(v, t_statics["edges"], torch.as_tensor(tel)),
        verts_obs,
    )
    _assert_value_and_grads(j, t, "edge")
    tri = verts_obs[faces]
    j_n = JM.vertex_normals_from_tri(jnp.asarray(tri), jnp.asarray(jt.vf_incidence), jnp.asarray(jt.vf_valid),
                                     jt.dual_vfinc)
    t_n = TM.vertex_normals_from_tri(torch.as_tensor(tri), torch.as_tensor(tt.vf_incidence),
                                     torch.as_tensor(tt.vf_valid), tt.dual_vfinc)
    np.testing.assert_allclose(t_n.numpy(), np.asarray(j_n), rtol=RTOL, atol=1e-6)


def test_plain_mesh_losses_match_jax(mesh):
    """The plain forms the eval path and the tests keep: the Laplacian as
    edge scatters (index_add) and the normal consistency through a plain
    gather, against JAX's train-step forms."""
    _, verts_obs, _, jt, tt = mesh
    j, t = _value_and_grad_both(
        lambda v: JM.uniform_laplacian_loss_nbr(v, jt.nbr_table, jnp.asarray(jt.vertex_degree)),
        lambda v: TM.uniform_laplacian_loss(v, torch.as_tensor(tt.edges), torch.as_tensor(tt.vertex_degree)),
        verts_obs,
    )
    _assert_value_and_grads(j, t, "laplacian")
    j, t = _value_and_grad_both(
        lambda v: JM.normal_consistency_loss(v, jnp.asarray(jt.nc_quads), jt.dual_nc),
        lambda v: TM.normal_consistency_loss(v, torch.as_tensor(tt.nc_quads)),
        verts_obs,
    )
    _assert_value_and_grads(j, t, "normal consistency")


@pytest.mark.parametrize("equal", [False, True])
def test_color_consistency_matches_jax(mesh, equal):
    """Also where adjacent colors are equal, as on a fresh model: the
    reference's |x| has gradient +1 at 0, torch's abs 0."""
    _, _, faces, jt, tt = mesh
    rng = np.random.default_rng(4)
    colors = np.full((len(faces), 3), 0.5, np.float32) if equal else rng.random((len(faces), 3), np.float32)
    j, t = _value_and_grad_both(
        lambda c: JM.color_consistency_loss(c, jnp.asarray(jt.face_connectivity), jt.dual_conn),
        lambda c: TM.color_consistency_loss(c, torch.as_tensor(tt.face_connectivity), tt.dual_conn),
        colors,
    )
    _assert_value_and_grads(j, t, "color consistency")
    assert np.abs(t[1][0]).max() > 0


@pytest.mark.parametrize("k", [3, 7])
def test_dilate_mask_matches_jax(rng, k):
    mask = (rng.random((48, 64)) > 0.97).astype(np.float32) * rng.random((48, 64)).astype(np.float32)
    j = np.asarray(JLo.dilate_mask(jnp.asarray(mask), k))
    t = TLo.dilate_mask(torch.as_tensor(mask), k).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL)
    assert (t >= mask).all() and t.sum() > mask.sum()


def test_unpack_matches_jax(rng):
    rgb = rng.random((16, 32, 3)).astype(np.float32) * 1.2
    mask = rng.random((16, 32)).astype(np.float32)
    bg = np.array([0.2, 0.5, 1.0], np.float32)
    for clamp in (False, True):
        j = np.asarray(JLo.unpack(jnp.asarray(rgb), jnp.asarray(mask), jnp.asarray(bg), clamp=clamp))
        t = TLo.unpack(torch.as_tensor(rgb), torch.as_tensor(mask), torch.as_tensor(bg), clamp=clamp).numpy()
        np.testing.assert_allclose(t, j, rtol=RTOL)


class _Statics:
    def __init__(self, topo, lib):
        conv = jnp.asarray if lib == "jax" else torch.as_tensor
        for name in ("edges", "nc_quads", "face_connectivity", "vertex_degree"):
            setattr(self, name, conv(getattr(topo, name)))
        self.nbr_table, self.dual_nc, self.dual_conn = topo.nbr_table, topo.dual_nc, topo.dual_conn


def test_compute_loss_terms_match_jax(mesh):
    """Every term but LPIPS (below) of E2E_TRAIN's losses, with the
    per-term values and the gradients of the total in every input."""
    verts, verts_obs, faces, jt, tt = mesh
    rng = np.random.default_rng(5)
    H, W = 32, 48
    inputs = {
        "rgb": rng.random((H, W, 3)).astype(np.float32),
        "mask": rng.random((H, W)).astype(np.float32),
        "normal_mask": rng.random((H, W)).astype(np.float32),
        "verts_obs": verts_obs,
        "colors": rng.random((len(faces), 3)).astype(np.float32),
    }
    rgb_gt = rng.random((H, W, 3)).astype(np.float32)
    mask_gt = (rng.random((H, W)) > 0.6).astype(np.float32)
    cfg = E2E_TRAIN["losses"]
    names = tuple(inputs)

    def aux_of(arrs):
        return dict(zip(names, arrs), verts_cnl=arrs[3])

    def jax_total(*arrs):
        aux = aux_of(arrs)
        total, losses = JLo.compute_loss(arrs[0], arrs[1], aux, jnp.asarray(rgb_gt), jnp.asarray(mask_gt),
                                         _Statics(jt, "jax"), cfg)
        return total, losses

    (j_total, j_losses), j_grads = jax.value_and_grad(jax_total, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(inputs[k]) for k in names)
    )
    leaves = [torch.tensor(inputs[k], requires_grad=True) for k in names]
    t_total, t_losses = TLo.compute_loss(leaves[0], leaves[1], aux_of(leaves), torch.as_tensor(rgb_gt),
                                         torch.as_tensor(mask_gt), _Statics(tt, "torch"), cfg)
    t_grads = torch.autograd.grad(t_total, leaves)
    assert set(t_losses) == set(j_losses) == {"rgb", "mask", "laplacian_observation", "normal_mask",
                                              "normal_consist", "color_consist"}
    for k in j_losses:
        np.testing.assert_allclose(float(t_losses[k]), float(j_losses[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=RTOL)
    for name, a, b in zip(names, t_grads, j_grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=RTOL * float(np.abs(b).max()), err_msg=name)


@pytest.fixture(scope="module")
def lpips_pair():
    with np.load(TL.HEADS_PATH) as z:
        heads = [z[f"head_{i}"] for i in range(5)]
    j_params, _ = JL.init_lpips(heads=heads)
    return j_params, TL.init_lpips(heads=heads, device="cpu")[0]


@pytest.mark.parametrize("bf16", [False, True])
def test_lpips_matches_jax(lpips_pair, bf16):
    """64^2 images in [-1, 1]: the value and its gradient in the prediction."""
    j_params, t_params = lpips_pair
    rng = np.random.default_rng(6)
    gt = rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    pred = np.clip(gt + 0.3 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda p: JL.lpips(j_params, p, jnp.asarray(gt), bf16=bf16))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    tv = TL.lpips(t_params, p, torch.as_tensor(gt), bf16=bf16)
    (tg,) = torch.autograd.grad(tv, p)
    jg, tg = np.asarray(jg), tg.numpy()
    assert float(tv.detach()) > 0.01 and np.isfinite(tg).all()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=LPIPS_BF16_RTOL if bf16 else LPIPS_RTOL)
    tol, frac, worst = LPIPS_GRAD[bf16]
    d = np.abs(tg - jg) / np.abs(jg).max()
    assert (d <= tol).mean() > frac, f"{(d > tol).mean():.3%} of the gradient off by > {tol} of its largest value"
    if worst is not None:
        assert d.max() <= worst


def test_lpips_trunk_is_drawn_from_its_seed():
    a, calibrated = TL.init_lpips(device="cpu")
    b, _ = TL.init_lpips(device="cpu")
    assert not calibrated
    assert [c["w"].shape for c in a["convs"]][:2] == [(64, 3, 3, 3), (64, 64, 3, 3)]
    for ca, cb in zip(a["convs"], b["convs"]):
        assert torch.equal(ca["w"], cb["w"])
    # He scale: std sqrt(2 / fan_in)
    w = a["convs"][4]["w"]
    assert float(w.std()) == pytest.approx(np.sqrt(2.0 / (128 * 9)), rel=0.02)
    params, calibrated, status = TL.load_lpips(device="cpu")
    assert not calibrated and "UNCALIBRATED" in status and len(params["heads"]) == 5


def test_defaults_match_jax():
    assert TC.default_cfg() == JC.default_cfg()


@pytest.mark.parametrize("path", sorted((ROOT / "configs" / "exps").glob("*.yaml")), ids=lambda p: p.stem)
def test_make_cfg_matches_jax(path):
    assert TC.make_cfg(str(path)) == JC.make_cfg(str(path))


def test_trained_train_config_matches_yaml():
    """The trained avatar's train config, written out in scene.py, is the
    train section of configs/exps/e2e_synthetic.yaml over the defaults."""
    assert E2E_TRAIN == JC.make_cfg(str(ROOT / "configs" / "exps" / "e2e_synthetic.yaml"))["train"]

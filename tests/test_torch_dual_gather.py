"""The gather tables of gomavatar_tpu_torch's index transposes
(ops/mesh_ops.py: DualIndex, gather_vjp, NeighborTable, neighbor_sum) against
gomavatar_tpu's on the CPU, on a body whose pole degree (20) is past the
tables' cap of 16, so their overflow runs: the tables themselves, gather_vjp's
gradient with and without a mask, the Laplacian, the vertex normals and the
consistency losses with their duals in value and gradient, and the per-frame
entry table of a real train binning.  Values and gradients within 1e-6 of
their largest magnitude, or 1e-7 absolute: XLA and torch add a table's rows
in different orders, so results that cancel differ in their last bits."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.ops import mesh_ops as JM
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.ops import mesh_ops as TM
from gomavatar_tpu_torch.ops.splat.render import entry_rows
from gomavatar_tpu_torch.scene import gate_scene
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7
DUALS = ("dual_faces", "dual_nc", "dual_conn", "dual_vfinc")


@pytest.fixture(scope="module")
def body():
    info = synthetic_body(n_rings=8, n_seg=20)  # pole degree 20 > cap 16
    faces = np.asarray(info["faces"], np.int64)
    verts = np.asarray(info["canonical_vertex"], np.float32)
    rng = np.random.default_rng(11)
    verts = (verts + 0.01 * rng.standard_normal(verts.shape)).astype(np.float32)
    return verts, faces, JM.MeshTopology.build(faces, len(verts)), TM.MeshTopology.build(faces, len(verts))


def _close(t, j, label):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=0, atol=max(RTOL * float(np.abs(j).max()), ATOL),
                               err_msg=label)


def _jdual(d):
    return jax.tree_util.tree_map(jnp.asarray, d)


def test_tables_equal_jax(body):
    _, _, jt, tt = body
    for name in DUALS:
        j, t = getattr(jt, name), getattr(tt, name)
        for field in ("pos", "valid", "ov_pos", "ov_val"):
            np.testing.assert_array_equal(getattr(t, field).numpy(), getattr(j, field), err_msg=f"{name}.{field}")
    for field in ("nbr", "valid", "ov_v", "ov_nbr"):
        np.testing.assert_array_equal(getattr(tt.nbr_table, field).numpy(), getattr(jt.nbr_table, field),
                                      err_msg=f"nbr_table.{field}")
    # the overflow runs at the poles, in both the faces' dual and the neighbours
    assert tt.dual_faces.ov_pos.numel() > 0 and tt.nbr_table.ov_v.numel() > 0


def test_overflow_table_holds_each_overflow_once(body):
    """The second table is the overflow list regrouped: each value's row
    lists its overflow items in order, every other value points at the
    zero row."""
    _, _, _, tt = body
    for table, vals, items in ((tt.dual_faces, "ov_val", "ov_pos"), (tt.dual_nc, "ov_val", "ov_pos"),
                               (tt.nbr_table, "ov_v", "ov_nbr")):
        v, it = getattr(table, vals).numpy(), getattr(table, items).numpy()
        row, tab, ok = table.ov_row.numpy(), table.ov_tab.numpy(), table.ov_tvalid.numpy() > 0
        assert (row[np.setdiff1d(np.arange(len(row)), v)] == tab.shape[0]).all()
        rebuilt = [(u, x) for u in np.unique(v) for x in tab[row[u]][ok[row[u]]]]
        assert rebuilt == list(zip(v, it))


@pytest.mark.parametrize("masked", [False, True])
def test_gather_vjp_gradient_matches_jax(body, masked):
    """Without a mask: the vertices gathered by faces; with one: the face
    crosses gathered by the padded vertex->face incidence (the padding
    slots left out of the dual, as the vertex normals use it)."""
    verts, faces, jt, tt = body
    rng = np.random.default_rng(12)
    if masked:
        values = rng.standard_normal((len(faces), 3)).astype(np.float32)
        idx, jd, td = jt.vf_incidence, jt.dual_vfinc, tt.dual_vfinc
        w = jt.vf_valid[..., None]
    else:
        values, idx, jd, td = verts, faces, jt.dual_faces, tt.dual_faces
        w = np.ones(faces.shape + (1,), np.float32)
    g = (rng.standard_normal(idx.shape + (3,)) * w).astype(np.float32)

    jv, jgrad = jax.value_and_grad(lambda v: jnp.sum(JM.gather_vjp(v, jnp.asarray(idx), _jdual(jd)) * g))(
        jnp.asarray(values))
    tv = torch.tensor(values, requires_grad=True)
    out = TM.gather_vjp(tv, torch.as_tensor(idx), td)
    np.testing.assert_array_equal(out.detach().numpy(), values[idx])
    (tgrad,) = torch.autograd.grad(torch.sum(out * torch.as_tensor(g)), tv)
    _close(tgrad, jgrad, "gather_vjp gradient")
    # and the plain transpose (index_add) within the same tolerance
    (pgrad,) = torch.autograd.grad(torch.sum(TM.gather_rows(tv, torch.as_tensor(idx)) * torch.as_tensor(g)), tv)
    _close(tgrad, pgrad, "gather_vjp against index_add")


def test_gather_vjp_overflow_only():
    """One value past a cap of 4 (degree 16 against 4): its overflow row
    carries the rest exactly."""
    idx = np.zeros((40, 2), np.int64)
    idx[:, 1] = np.arange(40) % 5
    jd, td = JM.build_dual_index(idx, 5, cap=4), TM.build_dual_index(idx, 5, cap=4)
    assert td.ov_pos.numel() == len(jd.ov_pos) > 0
    rng = np.random.default_rng(13)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    g = rng.standard_normal((40, 2, 3)).astype(np.float32)
    jgrad = jax.grad(lambda v: jnp.sum(JM.gather_vjp(v, jnp.asarray(idx), _jdual(jd)) * g))(jnp.asarray(v))
    tv = torch.tensor(v, requires_grad=True)
    (tgrad,) = torch.autograd.grad(torch.sum(TM.gather_vjp(tv, torch.as_tensor(idx), td) * torch.as_tensor(g)), tv)
    _close(tgrad, jgrad, "overflow gradient")


def _value_and_grad_both(jax_fn, torch_fn, x):
    jv, jg = jax.value_and_grad(jax_fn)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tv = torch_fn(tx)
    (tg,) = torch.autograd.grad(tv, tx)
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tg.numpy())


def _assert_both(j, t, label):
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, err_msg=f"{label} value")
    _close(t[1], j[1], f"{label} gradient")


def test_laplacian_nbr_matches_jax(body):
    verts, _, jt, tt = body
    deg = jt.vertex_degree
    j, t = _value_and_grad_both(
        lambda v: JM.uniform_laplacian_loss_nbr(v, _jdual(jt.nbr_table), jnp.asarray(deg)),
        lambda v: TM.uniform_laplacian_loss_nbr(v, tt.nbr_table, torch.as_tensor(deg)),
        verts,
    )
    _assert_both(j, t, "laplacian")
    # the neighbour sum alone, with its transpose, on (V, 3) values
    g = np.random.default_rng(14).standard_normal(verts.shape).astype(np.float32)
    j, t = _value_and_grad_both(
        lambda v: jnp.sum(JM.neighbor_sum(v, _jdual(jt.nbr_table)) * g),
        lambda v: torch.sum(TM.neighbor_sum(v, tt.nbr_table) * torch.as_tensor(g)),
        verts,
    )
    _assert_both(j, t, "neighbor_sum")


def test_vertex_normals_from_tri_matches_jax(body):
    verts, faces, jt, tt = body
    g = np.random.default_rng(15).standard_normal(verts.shape).astype(np.float32)

    def jax_fn(v):
        tri = JM.gather_vjp(v, jnp.asarray(faces), _jdual(jt.dual_faces))
        n = JM.vertex_normals_from_tri(tri, jnp.asarray(jt.vf_incidence), jnp.asarray(jt.vf_valid),
                                       _jdual(jt.dual_vfinc))
        return jnp.sum(n * g)

    def torch_fn(v):
        tri = TM.gather_vjp(v, torch.as_tensor(faces), tt.dual_faces)
        n = TM.vertex_normals_from_tri(tri, torch.as_tensor(tt.vf_incidence), torch.as_tensor(tt.vf_valid),
                                       tt.dual_vfinc)
        return torch.sum(n * torch.as_tensor(g))

    _assert_both(*_value_and_grad_both(jax_fn, torch_fn, verts), "vertex normals")


def test_consistency_losses_with_duals_match_jax(body):
    verts, faces, jt, tt = body
    j, t = _value_and_grad_both(
        lambda v: JM.normal_consistency_loss(v, jnp.asarray(jt.nc_quads), _jdual(jt.dual_nc)),
        lambda v: TM.normal_consistency_loss(v, torch.as_tensor(tt.nc_quads), tt.dual_nc),
        verts,
    )
    _assert_both(j, t, "normal consistency")
    colors = np.random.default_rng(16).random((len(faces), 3)).astype(np.float32)
    j, t = _value_and_grad_both(
        lambda c: JM.color_consistency_loss(c, jnp.asarray(jt.face_connectivity), _jdual(jt.dual_conn)),
        lambda c: TM.color_consistency_loss(c, torch.as_tensor(tt.face_connectivity), tt.dual_conn),
        colors,
    )
    _assert_both(j, t, "color consistency")


@pytest.mark.parametrize("name", ["face_normals", "vertex_normals", "vertex_normals_incidence"])
def test_normals_match_jax(body, name):
    verts, faces, jt, tt = body
    if name == "vertex_normals_incidence":
        j = JM.vertex_normals_incidence(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(jt.vf_incidence),
                                        jnp.asarray(jt.vf_valid))
        t = TM.vertex_normals_incidence(torch.as_tensor(verts), torch.as_tensor(faces),
                                        torch.as_tensor(tt.vf_incidence), torch.as_tensor(tt.vf_valid))
    else:
        j = getattr(JM, name)(jnp.asarray(verts), jnp.asarray(faces))
        t = getattr(TM, name)(torch.as_tensor(verts), torch.as_tensor(faces))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def gate_bins():
    """The gate scene's union binning at 64^2 with its entry table, as the
    train step builds them."""
    params, statics, cfg, frame = gate_scene(device="cpu", seed=0)
    verts_obs = TG.posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                                  frame["dst_posevec"])
    with torch.no_grad():
        bins = TG.train_geometry(params, statics, cfg, verts_obs, frame["K"], frame["E"])["bins"]
    return bins, cfg


def test_entry_table_over_the_gate_binning(gate_bins):
    bins, cfg = gate_bins
    d, valid = bins.entry_dual, bins.entry_valid.numpy() > 0
    pos, ok = d.pos.numpy(), d.valid.numpy() > 0
    assert d.pos.shape == (cfg.num_faces, cfg.max_tiles_per_gaussian)
    # every real entry once, under its own primitive, in ascending order;
    # no pad entry (primitive 0 at weight 0) anywhere
    assert sorted(pos[ok].tolist()) == np.nonzero(valid)[0].tolist()
    gauss = bins.entry_gauss.numpy()
    assert (gauss[pos] == np.arange(cfg.num_faces)[:, None])[ok].all()
    assert all((np.diff(row[m]) > 0).all() for row, m in zip(pos, ok))
    assert (~valid).sum() > 0 and (gauss[~valid] == 0).all()


def test_entry_table_gradient_matches_gather_rows(gate_bins):
    """The entry gather's gradient through the table equals index_add's on
    the real entries' cotangents; the pads' cotangents reach nothing."""
    bins, cfg = gate_bins
    rng = np.random.default_rng(17)
    per_prim = rng.standard_normal((cfg.num_faces, 16)).astype(np.float32)
    g = torch.as_tensor(rng.standard_normal((bins.entry_gauss.shape[0], 16)).astype(np.float32))
    x = torch.tensor(per_prim, requires_grad=True)
    (with_table,) = torch.autograd.grad(torch.sum(entry_rows(x, bins) * g), x)
    masked = g * bins.entry_valid[:, None]
    (plain,) = torch.autograd.grad(torch.sum(TM.gather_rows(x, bins.entry_gauss) * masked), x)
    _close(with_table, plain, "entry gradient")
    (pads_only,) = torch.autograd.grad(torch.sum(entry_rows(x, bins) * (g - masked)), x)
    assert not pads_only.any()

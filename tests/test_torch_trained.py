"""The trained avatar (artifacts/e2e_trained.npz) through gomavatar_tpu_torch
on the CPU, against gomavatar_tpu at the full 512^2 frame: the mesh rebuild
(57,600 faces), the observation-space vertices, the geometry table and the
sorted binning, whose counts on this frame are 221 active tiles, 163,205
(face, tile) entries, at most 1,700 in one tile, and none dropped."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.models.gom import GoMConfig as JaxGoMConfig
from gomavatar_tpu.models.smpl import synthetic_body
from gomavatar_tpu.ops import mesh_ops as JMO
from gomavatar_tpu.ops.geometry import frame_geometry as jax_frame_geometry
from gomavatar_tpu.ops.splat import binning as JB
from gomavatar_tpu_torch.convert import load_trained, trained_meta
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.ops import frame_render as TF
from gomavatar_tpu_torch.ops.splat import binning as TB
from torch_port_scene import CHANNEL_TOL, assert_bins_identical, jax_verts_obs
from torch_threads import one_torch_thread  # noqa: F401

ACTIVE_TILES, ENTRIES, MAX_TILE = 221, 163205, 1700


@pytest.fixture(scope="module")
def trained():
    return load_trained(device="cpu")


@pytest.fixture(scope="module")
def reference(trained):
    """The JAX side: mesh from the reference's own numpy builders, params and
    frame from the npz (the same arrays the port loaded)."""
    tp, _, tcfg, frame = trained
    meta = trained_meta()
    info = synthetic_body(**meta["body"])
    verts, faces = info["canonical_vertex"], info["faces"]
    lbs = info["canonical_lbs_weights"]
    for _ in range(meta["phase"]):
        verts, faces, attrs, _ = JMO.subdivide_mesh(verts, faces, {"weights": np.asarray(lbs, np.float64)})
        lbs = attrs["weights"].astype(np.float32)
    inc, valid = JMO.vertex_face_incidence(faces, len(verts))
    statics = SimpleNamespace(faces=jnp.asarray(faces, jnp.int32), vf_incidence=jnp.asarray(inc),
                              vf_valid=jnp.asarray(valid), lbs_weights=jnp.asarray(lbs))
    cfg = JaxGoMConfig.from_model_cfg(meta["model_cfg"], len(verts), len(faces))

    def jtree(t):
        if isinstance(t, dict):
            return {k: jtree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [jtree(v) for v in t]
        return jnp.asarray(t.numpy())

    params = jtree(tp)
    frame_np = {k: v.numpy() for k, v in frame.items()}
    verts_obs = jax_verts_obs(params, statics, cfg, frame_np)
    geom = jax_frame_geometry(
        verts_obs, statics.faces, params["so3"], params["scale"], params["appearance"]["colors"],
        statics.vf_incidence, statics.vf_valid, jnp.asarray(frame_np["K"]), jnp.asarray(frame_np["E"]),
        tuple(tcfg.img_size), cfg.sigma, 0.0,
    )
    return statics, cfg, verts_obs, geom


def _bin_kwargs(cfg, n_faces, geom, conv):
    return dict(
        max_tiles_per_primitive=cfg.max_tiles_per_gaussian, buffer_factor=cfg.buffer_factor,
        active_cap=cfg.active_tile_cap, band0=cfg.binning_band0, overflow_cap=max(n_faces // 8, 2048),
        flag_boxes=tuple(
            tuple(conv(a) for a in box) for box in (
                (geom.sx0, geom.sx1, geom.sy0, geom.sy1, geom.valid_splat),
                (geom.mx0, geom.mx1, geom.my0, geom.my1, geom.valid_mesh),
            )
        ),
    )


def test_load_trained_rebuilds_the_mesh(trained, reference):
    _, tst, tcfg, frame = trained
    jst, jcfg, _, _ = reference
    assert tcfg.num_faces == 57600 and tcfg.img_size == (512, 512)
    for name in ("faces", "vf_incidence", "vf_valid", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
    for field in ("num_vertices", "max_tiles_per_gaussian", "buffer_factor", "binning_band0", "active_tile_cap"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert set(frame) == {"K", "E", "cnl_gtfms", "dst_Rs", "dst_Ts", "dst_posevec"}


def test_trained_geometry_matches_jax(trained, reference):
    tp, tst, tcfg, frame = trained
    _, _, j_verts, jg = reference
    t_verts = TG.posed_vertices(tp, tst, tcfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"], frame["dst_posevec"])
    np.testing.assert_allclose(t_verts.numpy(), np.asarray(j_verts), atol=1e-5, rtol=0)
    from gomavatar_tpu_torch.ops.geometry import frame_geometry

    tg = frame_geometry(
        torch.tensor(np.asarray(j_verts)), tst.faces, tp["so3"], tp["scale"], tp["appearance"]["colors"],
        tst.vf_incidence, tst.vf_valid, frame["K"], frame["E"], tcfg.img_size, tcfg.sigma, 0.0,
    )
    tt, jt = tg.table.numpy(), np.asarray(jg.table)
    for chans, atol, rtol in CHANNEL_TOL:
        for c in chans:
            np.testing.assert_allclose(tt[:, c], jt[:, c], atol=atol, rtol=rtol, err_msg=f"channel {c}")
    np.testing.assert_array_equal(tg.valid_splat.numpy(), np.asarray(jg.valid_splat))
    np.testing.assert_array_equal(tg.valid_mesh.numpy(), np.asarray(jg.valid_mesh))


def test_trained_binning_identical_to_jax(trained, reference):
    _, tst, tcfg, _ = trained
    _, jcfg, _, jg = reference
    F = tcfg.num_faces
    ub = [np.asarray(a) for a in jg.union_box]
    depth, valid = np.asarray(jg.depth), np.asarray(jg.valid)
    j = JB.bin_sorted(*(jnp.asarray(a) for a in ub), jnp.asarray(depth), jnp.asarray(valid),
                      (512, 512), **_bin_kwargs(jcfg, F, jg, jnp.asarray))
    t = TB.bin_sorted(*(torch.tensor(a) for a in ub), torch.tensor(depth), torch.tensor(valid),
                      (512, 512), **_bin_kwargs(tcfg, F, jg, lambda a: torch.tensor(np.asarray(a))))
    assert_bins_identical(j, t)
    assert int(t.n_active) == ACTIVE_TILES and int(t.seg_count.sum()) == ENTRIES
    assert int(t.telemetry.max_tile_entries) == MAX_TILE and int(t.telemetry.total_dropped()) == 0


def test_trained_frame_counts_through_the_port(trained):
    """The port's own pipeline (geometry + binning from its own vertices)
    lands on the same counts, with B1's sweep clamp unreached."""
    tp, tst, tcfg, frame = trained
    verts = TG.posed_vertices(tp, tst, tcfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"], frame["dst_posevec"])
    _, bins, _ = TG.frame_table_and_bins(tp, tst, tcfg, verts, tp["appearance"]["colors"], frame["K"], frame["E"])
    assert int(bins.n_active) == ACTIVE_TILES and int(bins.seg_count.sum()) == ENTRIES
    assert int(bins.telemetry.max_tile_entries) == MAX_TILE and int(bins.telemetry.total_dropped()) == 0
    assert bins.order.shape == (295936,)  # Dcap = 57600 * 4 + 512 * 128
    assert MAX_TILE < TF.NCMAX * TB.CHUNK - (TB.CHUNK - 1)  # tile_overflow 0

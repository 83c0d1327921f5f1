"""The plain PyTorch B1 (gomavatar_tpu_torch.ops.frame_render) against the
JAX package's B1 in interpret mode, on the same entry table and bins of the
gate scene: with and without the mesh pass, and at ncmax=1, where tiles with
more than one chunk of entries are clamped.

Criteria (bench.py's fused/unfused gate): rgb and alpha within 1e-4 on more
than 99.95 % of values, worst under 5e-3; hit equal on >= 99.9 % of pixels
and the normal within 1e-4 wherever the hits agree."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.models import modules as JM
from gomavatar_tpu.ops.frame_render import render_frame_sorted as jax_render_frame_sorted
from gomavatar_tpu.ops.geometry import frame_geometry as jax_frame_geometry
from gomavatar_tpu.ops.splat import binning as JB
from gomavatar_tpu_torch.ops import frame_render as TF
from gomavatar_tpu_torch.ops.splat.binning import BinningTelemetry, SortedBinning
from torch_port_scene import IMG, assert_close_frac, jax_gate_scene, jax_verts_obs
from torch_threads import one_torch_thread  # noqa: F401


def _torch_bins(b) -> SortedBinning:
    def t(x, dtype=None):
        return torch.tensor(np.asarray(x), dtype=dtype)

    return SortedBinning(
        order=t(b.order, torch.int64),
        entry_splat=t(b.entry_splat), entry_mesh=t(b.entry_mesh),
        active_id=t(b.active_id), seg_start=t(b.seg_start), seg_count=t(b.seg_count),
        pos_of_tile=t(b.pos_of_tile), n_active=t(b.n_active),
        num_tiles_x=b.num_tiles_x, num_tiles_y=b.num_tiles_y,
        telemetry=BinningTelemetry(*(t(v) for v in b.telemetry)),
    )


@pytest.fixture(scope="module")
def inputs():
    """The JAX side's B1 inputs, built as its render_frame_eval builds them."""
    jp, jst, jcfg, frame_np, _ = jax_gate_scene()
    verts = jax_verts_obs(jp, jst, jcfg, frame_np)
    geom = jax_frame_geometry(
        verts, jst.faces, jp["so3"], jp["scale"], jp["appearance"]["colors"],
        jst.vf_incidence, jst.vf_valid, jnp.asarray(frame_np["K"]), jnp.asarray(frame_np["E"]),
        IMG, jcfg.sigma, 0.0,
    )
    sh_cfg = jcfg.module_cfg("shadow")
    table = geom.table.at[:, 22].set(JM.shadow_apply(jp["shadow"], sh_cfg, geom.table[:, 19:22])[:, 0] * 2.0)
    shading0 = JM.shadow_apply(jp["shadow"], sh_cfg, jnp.zeros((1, 3)))[0, 0] * 2.0
    ub = geom.union_box
    bins = JB.bin_sorted(
        ub[0], ub[1], ub[2], ub[3], geom.depth, geom.valid, IMG,
        max_tiles_per_primitive=jcfg.max_tiles_per_gaussian,
        buffer_factor=jcfg.buffer_factor, active_cap=jcfg.active_tile_cap,
        flag_boxes=(
            (geom.sx0, geom.sx1, geom.sy0, geom.sy1, geom.valid_splat),
            (geom.mx0, geom.mx1, geom.my0, geom.my1, geom.valid_mesh),
        ),
        band0=jcfg.binning_band0, overflow_cap=max(jst.faces.shape[0] // 8, 2048),
    )
    assert int(bins.telemetry.max_tile_entries) > JB.CHUNK  # the ncmax=1 clamp bites
    return table, bins, shading0


@pytest.mark.parametrize("with_mesh,ncmax", [(True, TF.NCMAX), (False, TF.NCMAX), (True, 1)])
def test_plain_b1_matches_jax_interpret(inputs, with_mesh, ncmax):
    table, bins, shading0 = inputs
    kw = dict(with_normal=True, shading0=shading0) if with_mesh else {}
    j = jax_render_frame_sorted(table, bins, IMG, ncmax=ncmax, interpret=True, **kw)
    t_kw = dict(with_normal=True, shading0=torch.tensor(float(shading0))) if with_mesh else {}
    t = TF.render_frame_sorted(torch.tensor(np.asarray(table)), _torch_bins(bins), IMG, ncmax=ncmax, **t_kw)
    assert TF.frame_partials.launches == TF.frame_merge.launches == 0  # CPU tensors never reach the kernel
    assert_close_frac(t[0].numpy(), np.asarray(j[0]), "rgb")
    assert_close_frac(t[1].numpy(), np.asarray(j[1]), "alpha")
    if with_mesh:
        hit_t, hit_j = t[3].numpy(), np.asarray(j[3])
        assert (hit_t == hit_j).mean() >= 0.999
        both = (hit_t == hit_j) & (hit_j > 0)
        assert both.sum() > 0
        np.testing.assert_allclose(t[2].numpy()[both], np.asarray(j[2])[both], atol=1e-4, rtol=0)


def test_frame_sweep_slots_and_untile(inputs):
    """Slots at or above n_active are zero in the plain version and never
    read by untile; tiles without a slot come out zero."""
    table, bins, _ = inputs
    tb = _torch_bins(bins)
    entries = TF.gather_entries(torch.tensor(np.asarray(table)), tb)
    rgb, alpha, sel = TF.frame_sweep_plain(
        entries, tb.active_id, tb.seg_start, tb.seg_count, tb.n_active, tb.num_tiles_x
    )
    n = int(tb.n_active)
    assert rgb.shape == (tb.active_id.shape[0], 3, TF.P) and sel.shape[1] == 5
    assert float(rgb[n:].abs().sum() + alpha[n:].abs().sum() + sel[n:].abs().sum()) == 0.0
    img = TF.untile(alpha, tb, IMG)[..., 0]
    empty = (tb.pos_of_tile >= tb.active_id.shape[0]).reshape(IMG[1] // 16, IMG[0] // 16)
    tiles = img.reshape(IMG[1] // 16, 16, IMG[0] // 16, 16).sum(dim=(1, 3))
    assert float(tiles[empty].abs().sum()) == 0.0 and float(tiles[~empty].sum()) > 0

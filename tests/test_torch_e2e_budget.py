"""Where the port's e2e run and JAX's part on the tile budget (ROADMAP C5).

The port's chain, run from init on the card, dropped 4-12 binning entries
per frame after the subdivision, where JAX's run dropped none: every drop a
budget drop (``max_tiles_per_gaussian`` = 32, the floor ``_MTG_FLOOR`` of
both packages).  On each trained avatar's packed frame, the port's
``bin_sorted`` and JAX's give the same integers and the same telemetry, so
the binning does not part: the trained params do.  JAX's avatar's widest
splat spans 30 tiles of the 32 (5 x 6), the port's two widest 36 (6 x 6),
at per-face scales of the same spread (largest 1.237 and 1.231)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomavatar_tpu.ops.splat import binning as JB
from gomavatar_tpu_torch.convert import TRAINED, load_trained
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.models import modules as TM
from gomavatar_tpu_torch.ops.geometry import frame_geometry
from gomavatar_tpu_torch.ops.splat import binning as TB
from torch_port_scene import assert_bins_identical
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TRAINED = os.path.join(REPO, "gomavatar_tpu_torch", "artifacts", "e2e_trained.npz")
TILE = 16


@pytest.mark.parametrize("path, widest, dropped", [(TRAINED, 30, 0), (PORT_TRAINED, 36, 8)], ids=["jax", "port"])
def test_trained_avatar_binning_matches_jax(path, widest, dropped):
    params, statics, cfg, f = load_trained(path, "cpu")
    with torch.no_grad():
        verts = TG.posed_vertices(params, statics, cfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"])
        g = frame_geometry(verts, statics.faces, params["so3"], params["scale"],
                           TM.appearance_apply(params["appearance"]), statics.vf_incidence, statics.vf_valid, f["K"],
                           f["E"], cfg.img_size, cfg.sigma, 0.0)
    ub = [x.numpy() for x in g.union_box]
    valid = g.valid.numpy()
    flags = [tuple(x.numpy() for x in (g.sx0, g.sx1, g.sy0, g.sy1, g.valid_splat)),
             tuple(x.numpy() for x in (g.mx0, g.mx1, g.my0, g.my1, g.valid_mesh))]
    boxes = ub + [g.depth.numpy(), valid]
    kw = dict(max_tiles_per_primitive=cfg.max_tiles_per_gaussian, buffer_factor=cfg.buffer_factor,
              active_cap=cfg.active_tile_cap, band0=cfg.binning_band0,
              overflow_cap=max(cfg.num_faces // 8, 2048))
    j = JB.bin_sorted(*[jnp.asarray(a) for a in boxes], cfg.img_size,
                      flag_boxes=tuple(tuple(jnp.asarray(a) for a in b) for b in flags), **kw)
    t = TB.bin_sorted(*[torch.as_tensor(a) for a in boxes], cfg.img_size,
                      flag_boxes=tuple(tuple(torch.as_tensor(a) for a in b) for b in flags), **kw)
    assert_bins_identical(j, t)

    tiles = ((np.floor(ub[1] / TILE) - np.floor(ub[0] / TILE) + 1) * (np.floor(ub[3] / TILE) - np.floor(ub[2] / TILE) + 1))
    tiles = np.where(valid, np.maximum(tiles, 0), 0)
    assert cfg.max_tiles_per_gaussian == 32 and cfg.num_faces == 57600
    assert tiles.max() == widest
    assert int(j.telemetry.dropped_budget) == int(t.telemetry.dropped_budget) == dropped
    assert int(t.telemetry.dropped_buffer) == 0

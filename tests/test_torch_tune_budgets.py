"""gomavatar_tpu_torch/tools/tune_trained_budgets.py (the port of the JAX
package's budget sweep) against the JAX package, on the CPU.

At each of the tool's settings of (max_tiles_per_gaussian, binning_band0,
active_tile_cap), the port's counters (dropped_budget, dropped_buffer,
tile_overflow) on each committed avatar's packed frame equal the JAX
package's under the same ``dataclasses.replace``: JAX's steps 1-3 of
``gom_forward``, its ``frame_geometry`` and ``bin_sorted``, and its eval
aux's tile_overflow.  The counters come from the binning alone on both
sides: a whole 512^2 forward with B1's plain version takes ~9 s on one
core here, and the tool's own run at 32^2 shows that the forward's counters
are its binning's.  At the default budget the port's avatar drops 8 entries
and JAX's none (ROADMAP C5)."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gomavatar_tpu.models.gom import init_gom as jax_init_gom
from gomavatar_tpu.models.gom import subdivide_gom as jax_subdivide_gom
from gomavatar_tpu.models.smpl import synthetic_body as jax_synthetic_body
from gomavatar_tpu.ops.frame_render import NCMAX
from gomavatar_tpu.ops.geometry import frame_geometry as jax_frame_geometry
from gomavatar_tpu.ops.splat import binning as JB
from gomavatar_tpu_torch.convert import TRAINED, load_trained
from gomavatar_tpu_torch.tools import tune_trained_budgets as TT
from torch_port_scene import jax_verts_obs
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools.export_trained import unflatten_params as jax_unflatten_params  # noqa: E402

PORT_TRAINED = os.path.join(REPO, "gomavatar_tpu_torch", "artifacts", "e2e_trained.npz")
AVATARS = {"jax": str(TRAINED), "port": PORT_TRAINED}
DEFAULT = (32, 4, 512)


def jax_binned(path: str):
    """The avatar at ``path`` in the JAX package (loaded as ``bench.py``'s
    ``_trained_scene`` loads its own), and a function of a setting that bins
    its packed frame there and returns the eval aux's counters."""
    with np.load(path) as npz:
        meta = json.loads(str(npz["meta"]))
        p0, statics, cfg = jax_init_gom(jax.random.PRNGKey(0), meta["model_cfg"], jax_synthetic_body(**meta["body"]))
        params = jax.tree_util.tree_map(jnp.asarray, jax_unflatten_params(npz))
        frame = {k.split("/", 1)[1]: np.asarray(npz[k], np.float32) for k in npz.files if k.startswith("frame/")}
    for _ in range(meta["phase"]):
        p0, statics, cfg = jax_subdivide_gom(p0, statics, cfg)
    verts = jax_verts_obs(params, statics, cfg, frame)
    g = jax_frame_geometry(verts, statics.faces, params["so3"], params["scale"], params["appearance"]["colors"],
                           statics.vf_incidence, statics.vf_valid, jnp.asarray(frame["K"]),
                           jnp.asarray(frame["E"]), cfg.img_size, cfg.sigma, 0.0)

    def counters(setting):
        mtg, band0, cap = setting
        c = dataclasses.replace(cfg, max_tiles_per_gaussian=mtg, binning_band0=band0, active_tile_cap=cap)
        ub = g.union_box
        bins = JB.bin_sorted(ub[0], ub[1], ub[2], ub[3], g.depth, g.valid, c.img_size,
                             max_tiles_per_primitive=c.max_tiles_per_gaussian, buffer_factor=c.buffer_factor,
                             active_cap=c.active_tile_cap,
                             flag_boxes=((g.sx0, g.sx1, g.sy0, g.sy1, g.valid_splat),
                                         (g.mx0, g.mx1, g.my0, g.my1, g.valid_mesh)),
                             band0=c.binning_band0, overflow_cap=max(statics.faces.shape[0] // 8, 2048))
        tel = bins.telemetry
        return {"dropped_budget": int(tel.dropped_budget), "dropped_buffer": int(tel.dropped_buffer),
                "tile_overflow": max(int(tel.max_tile_entries) - (NCMAX * JB.CHUNK - (JB.CHUNK - 1)), 0)}

    return cfg, counters


@pytest.fixture(scope="module")
def avatars():
    """Per avatar: (JAX's cfg, JAX's counters of a setting, the port's
    loaded avatar)."""
    return {name: jax_binned(path) + (load_trained(path, "cpu"),) for name, path in AVATARS.items()}


def port_counters(avatar, setting):
    params, statics, cfg, frame = avatar
    mtg, band0, cap = setting
    c = dataclasses.replace(cfg, max_tiles_per_gaussian=mtg, binning_band0=band0, active_tile_cap=cap)
    return TT.binned_counters(params, statics, c, frame)


@pytest.mark.parametrize("setting", TT.SETTINGS, ids=lambda s: "mtg{}-band{}-cap{}".format(*s))
@pytest.mark.parametrize("name", sorted(AVATARS))
def test_counters_match_jax(avatars, name, setting):
    jcfg, jax_counters, avatar = avatars[name]
    assert jcfg.num_faces == avatar[2].num_faces == 57600
    assert port_counters(avatar, setting) == jax_counters(setting)


def test_the_default_drops_8_on_the_ports_avatar_and_none_on_jaxs(avatars):
    for name, dropped, widest in (("jax", 0, 30), ("port", 8, 36)):
        _, jax_counters, avatar = avatars[name]
        params, statics, cfg, frame = avatar
        assert (cfg.max_tiles_per_gaussian, cfg.binning_band0, cfg.active_tile_cap) == DEFAULT
        want = {"dropped_budget": dropped, "dropped_buffer": 0, "tile_overflow": 0}
        assert TT.binned_counters(params, statics, cfg, frame) == jax_counters(DEFAULT) == want, name
        assert TT.widest_span(params, statics, cfg, frame) == widest, name


def test_main_at_32(monkeypatch):
    """The tool's own entry point at 32^2 on the plain kernel versions, two
    of its settings and two timed forwards each: one row per setting, the
    forward's counters equal to its binning's."""
    settings = ((32, 4, 512), (40, 4, 512))
    monkeypatch.setattr(TT, "SETTINGS", settings)
    monkeypatch.setattr(TT, "ITERS", 2)
    monkeypatch.setattr(TT, "WARMUP", 1)
    res = TT.main(["--avatar", PORT_TRAINED, "--img", "32", "--device", "cpu"])
    assert res["img_size"] == [32, 32] and res["num_faces"] == 57600 and res["widest_span"] >= 1
    params, statics, cfg, frame = load_trained(PORT_TRAINED, "cpu")
    frame["K"][:2] *= 32 / cfg.img_size[0]
    cfg = dataclasses.replace(cfg, img_size=(32, 32))
    assert [tuple(r[k] for k in ("max_tiles_per_gaussian", "binning_band0", "active_tile_cap"))
            for r in res["settings"]] == list(settings)
    for r, s in zip(res["settings"], settings):
        assert {k: r[k] for k in ("dropped_budget", "dropped_buffer", "tile_overflow")} == port_counters(
            (params, statics, cfg, frame), s)
        assert 0 < r["median_ms"] <= r["p90_ms"]

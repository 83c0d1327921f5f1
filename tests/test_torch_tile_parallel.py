"""gomavatar_tpu_torch.parallel.tile_render on the CPU: the eval frame's
active slots split over gloo ranks (``parallel.spawn``, one torch thread
each), B1 on its plain version, on the 64^2 gate scene with the normal.

* Worlds 2 (active_tile_cap 16) and 4 (cap 20: the frame's 8 active slots
  fall 5 on rank 0, 3 on rank 1 and none on ranks 2 and 3, n_local = 0)
  bit-equal to ``render_frame_eval`` at the same cap, on every rank;
* world 2 against JAX's ``make_tile_parallel_render`` on a 2-device mesh
  with the Pallas kernel in interpret mode, on the JAX test's own scene
  (tests/test_frame_render.py:_scene, shadow on) at its atol 1e-5
  (tests/test_tile_parallel.py:37-38, cap 16).  Not on the gate scene: its
  trained shadow MLP makes JAX's jitted program (the tile-parallel render
  is one) differ from JAX's own eager ``render_frame_eval`` by up to 4.8e-5
  in rgb, and the port matches the eager one;
* the shard sweeps of n = 2, 4 and 8 concatenated in rank order, bit-equal
  to the one-call sweep on every slot below n_active;
* a cap that does not divide onto the ranks raises.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.parallel import make_mesh
from gomavatar_tpu.parallel import make_tile_parallel_render as jax_tile_parallel_render
from gomavatar_tpu.parallel.tile_render import TILE_AXIS
from gomavatar_tpu.models.smpl import synthetic_body
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.ops.frame_render import frame_sweep, gather_entries
from gomavatar_tpu_torch.parallel import RankGroup, make_tile_parallel_render, shard_slots, spawn
from gomavatar_tpu_torch.scene import gate_model_cfg
from tests.test_frame_render import _scene as jax_test_scene
from tests.test_frame_render import _verts_obs as jax_test_verts_obs
from torch_parallel_ranks import tile_runs
from torch_port_scene import IMG, jax_gate_scene, torch_scene_from
from torch_threads import one_torch_thread  # noqa: F401

CAPS = {2: 16, 4: 20}  # world -> active_tile_cap


@pytest.fixture(scope="module")
def scene():
    return jax_gate_scene()


def _port_inputs(scene, cap):
    params, statics, cfg, frame = torch_scene_from(scene)
    cfg = dataclasses.replace(cfg, active_tile_cap=cap)
    verts_obs = TG.posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                                  frame["dst_posevec"])
    return params, statics, cfg, frame, verts_obs


def _jax_test_model_cfg():
    """tests/test_frame_render.py:_scene's model config in the port."""
    m = default_cfg()["model"]
    m["img_size"] = list(IMG)
    m["pose_refinement"]["name"] = "none"
    m["non_rigid"]["name"] = "none"
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    return m


@pytest.fixture(scope="module")
def jax_scene():
    """The JAX test's scene: (params, statics, cfg at cap 16, batch, info)."""
    params, statics, cfg, batch = jax_test_scene(shadow=True)
    return params, statics, dataclasses.replace(cfg, active_tile_cap=16), batch, synthetic_body(n_rings=10, n_seg=12)


@pytest.fixture(scope="module")
def runs(scene, jax_scene):
    """{world: each rank's (outputs, info)} on the gate scene, and "jax":
    each rank's on the JAX test's scene at world 2."""
    jp, _, _, frame_np, info = scene
    gate = [gate_model_cfg(IMG), None, jax.tree_util.tree_map(np.asarray, jp), info, frame_np]
    p2, _, _, b2, info2 = jax_scene
    other = (_jax_test_model_cfg(), 16, jax.tree_util.tree_map(np.asarray, p2), info2,
             {k: np.asarray(v) for k, v in b2.items()})
    out = {}
    for w, cap in CAPS.items():
        gate[1] = cap
        cases = [tuple(gate)] + ([other] if w == 2 else [])
        per_rank = spawn(tile_runs, ["cpu"] * w, cases)
        out[w] = [r[0] for r in per_rank]
        if w == 2:
            out["jax"] = [r[1] for r in per_rank]
    return out


@pytest.mark.parametrize("world", sorted(CAPS))
def test_tile_parallel_equals_render_frame_eval(scene, runs, world):
    params, statics, cfg, frame, verts_obs = _port_inputs(scene, CAPS[world])
    *want, aux = TG.render_frame_eval(params, statics, cfg, verts_obs, params["appearance"]["colors"], frame["K"],
                                      frame["E"], with_normal=True)
    assert float(want[1].max()) > 0.5  # the scene renders
    for rank, (outs, info) in enumerate(runs[world]):
        for name, a, b in zip(("rgb", "alpha", "normal", "hit"), outs, want):
            assert np.array_equal(a, b.numpy()), f"world {world} rank {rank}: {name}"
        assert info["dropped"] == 0 and info["tile_overflow"] == 0 and int(aux["tile_overflow"]) == 0


def test_a_rank_without_active_slots(runs):
    """World 4 at cap 20: ranks own 5 slots each; the frame's active slots
    fill rank 0, part of rank 1 and none of ranks 2 and 3."""
    infos = [info for _, info in runs[4]]
    n_active = infos[0]["n_active"]
    assert 5 < n_active < 10
    assert [i["n_local"] for i in infos] == [5, n_active - 5, 0, 0]


def test_tile_parallel_matches_jax(jax_scene, runs):
    params, statics, cfg, batch, _ = jax_scene
    verts_obs = jax_test_verts_obs(params, statics, batch, cfg)
    render = jax_tile_parallel_render(make_mesh(2, axis=TILE_AXIS), cfg, statics, interpret=True)
    rgb, alpha = render(params, verts_obs, params["appearance"]["colors"], batch["K"], batch["E"])
    assert float(jnp.max(alpha)) > 0.5
    for outs, info in runs["jax"]:
        np.testing.assert_allclose(outs[1], np.asarray(alpha), atol=1e-5)
        np.testing.assert_allclose(outs[0], np.asarray(rgb), atol=1e-5)
        assert info["dropped"] == 0 and info["tile_overflow"] == 0


@pytest.mark.parametrize("world", [2, 4, 8])
def test_shard_sweeps_concatenate_to_the_whole_sweep(scene, world):
    params, statics, cfg, frame, verts_obs = _port_inputs(scene, 16)
    table, bins, _ = TG.frame_table_and_bins(params, statics, cfg, verts_obs, params["appearance"]["colors"],
                                             frame["K"], frame["E"])
    entries = gather_entries(table, bins)
    whole = frame_sweep(entries, bins.active_id, bins.seg_start, bins.seg_count, bins.n_active, bins.num_tiles_x)
    shards = [frame_sweep(entries, *shard_slots(bins, r, world), bins.num_tiles_x) for r in range(world)]
    n = int(bins.n_active)
    assert 0 < n < 16
    for i, name in enumerate(("rgb", "alpha", "sel")):
        got = torch.cat([s[i] for s in shards])
        assert torch.equal(got[:n], whole[i][:n]), name
    assert sum(int(shard_slots(bins, r, world)[3]) for r in range(world)) == n


def test_cap_must_divide_onto_the_ranks(scene):
    _, statics, cfg, _, _ = _port_inputs(scene, 16)
    with pytest.raises(ValueError, match="active_tile_cap 16 does not divide onto 3 ranks"):
        make_tile_parallel_render(RankGroup(0, 3, torch.device("cpu"), "gloo", None), cfg, statics)

"""The pose-refinement and animation drivers of gomavatar_tpu_torch in-process
on the CPU (``--device cpu``) over a 48^2 synthetic workspace, LPIPS off,
and the pieces they share with the JAX package: the refined-pose file both
packages' ``evaluate`` read, the animation's per-frame items byte for byte,
the multi-scene render scene by scene against JAX's sharded one on a
2-device CPU mesh, and the point-cloud exports."""

import os
import pickle
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml
from PIL import Image

from gomavatar_tpu.cli import animate as jax_animate
from gomavatar_tpu.cli.evaluate import load_refined_poses as jax_load_refined_poses
from gomavatar_tpu.models import gom as JG
from gomavatar_tpu.parallel import make_mesh, make_multi_scene_render, stack_batches
from gomavatar_tpu.parallel.mesh import SCENE_AXIS
from gomavatar_tpu_torch.cli import animate as anim_cli
from gomavatar_tpu_torch.cli import evaluate as eval_cli
from gomavatar_tpu_torch.cli import train_pose as pose_cli
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import params_from_jax
from gomavatar_tpu_torch.data.synthetic import write_synthetic_dataset
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.trainer import Trainer
from torch_port_scene import assert_close_frac, jax_gate_scene, torch_scene_from
from torch_threads import one_torch_thread  # noqa: F401

HW = (48, 48)
FRAMES = 2
POSE_ITERS = 3
# the exports: float32 geometry through the same ops in another order
EXPORT_ATOL = 1e-5


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A 2-frame capture, the exp yaml (snapshot test protocol, LPIPS off,
    3 pose steps halving after 2) and the untrained model saved as its
    iter_0 checkpoint."""
    root = tmp_path_factory.mktemp("torch_cli_pose")
    data = write_synthetic_dataset(str(root / "data"), n_frames=FRAMES, img_hw=HW)
    cfg = {
        "exp_name": "pose_smoke",
        "log_dir": str(root / "log"),
        "random_bgcolor": False,
        "bgcolor": [0.0, 0.0, 0.0],
        "img_size": list(HW),
        "dataset": {
            "train": {"dataset_path": data},
            "test_view": {"dataset_path": data, "name": "snapshot", "skip": 1},
        },
        "model": {
            "img_size": list(HW),
            "canonical_geometry": {"deform_so3": True, "deform_scale": True},
            "normal_renderer": {"name": "mesh"},
            "shadow_module": {"name": "basic"},
            "pose_refinement": {"name": "basic"},
            "non_rigid": {"name": "basic"},
        },
        "pose": {"lr": 1e-2, "decay": 2, "iters": POSE_ITERS},
        "train": {"losses": {"lpips": {"coeff": 0.0}}},
    }
    path = str(root / "exp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    from gomavatar_tpu_torch.config import make_cfg
    from gomavatar_tpu_torch.data.dataset import TrainDataset

    exp = make_cfg(path)
    Trainer(exp, TrainDataset(data).get_canonical_info(), device="cpu").save(os.path.join(exp["save_dir"],
                                                                                          "checkpoints"))
    return {"root": root, "cfg_path": path, "save_dir": root / "log" / "pose_smoke"}


@pytest.fixture(scope="module")
def refined(workspace):
    return pose_cli.main(["--cfg", workspace["cfg_path"], "--max_frames", str(FRAMES), "--device", "cpu"])


def test_train_pose_refines_and_writes_pose_pkl(workspace, refined):
    save_dir = workspace["save_dir"]
    assert refined["frames"] == FRAMES and refined["iters"] == POSE_ITERS
    assert refined["dropped"] == [0] * FRAMES
    assert all(b <= f for f, b in zip(refined["first_loss"], refined["best_loss"]))
    assert set(refined["metrics"]) == {"raw", "zeroed", "refined"}
    for means in refined["metrics"].values():
        assert means and all(np.isfinite(v) for v in means.values())
    with open(save_dir / "checkpoints" / "pose.pkl", "rb") as f:
        poses = pickle.load(f)
    assert set(poses) == {"Rhs", "Ths", "dst_poses"}
    for key, shape in (("Rhs", (FRAMES, 3)), ("Ths", (FRAMES, 3)), ("dst_poses", (FRAMES, 72))):
        assert isinstance(poses[key], np.ndarray) and poses[key].dtype == np.float32 and poses[key].shape == shape
        assert np.isfinite(poses[key]).all()
    assert np.abs(poses["Rhs"]).max() > 0  # the global transform moved
    pngs = sorted(os.listdir(save_dir / "eval" / "test_refine"))
    assert len(pngs) == 3 * FRAMES and {p.rsplit("_", 1)[1] for p in pngs} == {"raw.png", "zeroed.png", "refined.png"}
    log = (save_dir / "log_pose.txt").read_text()
    assert "frame 1: loss" in log and "eval [refined]" in log and "saved refined poses" in log


def test_both_packages_read_the_refined_poses(workspace, refined):
    got = eval_cli.load_refined_poses(refined["pose_path"])
    want = jax_load_refined_poses(refined["pose_path"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    res = eval_cli.main(["--cfg", workspace["cfg_path"], "--type", "view", "--device", "cpu", "--pose_path",
                         refined["pose_path"], "--tag", "view_refined"])
    assert res["frames"] == FRAMES and all(np.isfinite(v) for v in res["metrics"].values())
    assert "using refined poses" in (workspace["save_dir"] / "log_eval_view_refined.txt").read_text()


@pytest.mark.parametrize("kind", ["freeview", "mdm"])
def test_animate_writes_one_strip_per_frame(tmp_path, kind):
    """Every scene lands in the strip: n x W wide for n scenes."""
    W, H = 64, 48
    out = tmp_path / kind
    res = anim_cli.main(["--synthetic", "2", "--type", kind, "--n_frames", "2", "--img", str(W), str(H),
                         "--out", str(out), "--device", "cpu"])
    assert (res["frames"], res["scenes"]) == (2, 2)
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert pngs == ["frame_0000.png", "frame_0001.png"]
    for name in pngs:
        img = np.asarray(Image.open(out / name))
        assert img.shape == (H, 2 * W, 3)
        assert img[:, :W].mean() > 1.0 and img[:, W:].mean() > 1.0


def test_check_homogeneous_scenes_rejects_mixed_phases():
    def pack(faces):
        return (None, None, types.SimpleNamespace(num_faces=faces))

    same = [pack(360), pack(360)]
    assert anim_cli.check_homogeneous_scenes(same).num_faces == 360
    mixed = [pack(360), pack(1440)]
    with pytest.raises(SystemExit, match="SAME subdivision phase") as got:
        anim_cli.check_homogeneous_scenes(mixed)
    with pytest.raises(SystemExit) as want:
        jax_animate.check_homogeneous_scenes(mixed)
    assert str(got.value) == str(want.value)


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for frame_got, frame_want in zip(got, want):
        assert len(frame_got) == len(frame_want)
        for a, b in zip(frame_got, frame_want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), k


def test_animation_items_are_byte_equal_to_jax(tmp_path):
    from gomavatar_tpu_torch.data.synthetic import write_synthetic_mdm_poses
    from gomavatar_tpu_torch.models.smpl import synthetic_body

    infos = [synthetic_body(n_rings=24, n_seg=20, seed=s) for s in range(2)]
    img = (64, 48)
    _assert_items_equal(anim_cli._orbit_items(infos, 0, 4, img), jax_animate._orbit_items(infos, 0, 4, img))
    path = write_synthetic_mdm_poses(str(tmp_path / "mdm.npy"), n_frames=3)
    _assert_items_equal(anim_cli._mdm_items(infos, path, 3, img), jax_animate._mdm_items(infos, path, 3, img))


def test_scene_loop_matches_jax_multi_scene_render():
    """Two synthetic scenes (per-face so3, scale and colors from a numpy seed
    each), JAX's parameters carried across: the port's scene-by-scene render
    against JAX's make_multi_scene_render on a 2-device CPU mesh, under the
    eval gate (> 99.95 % of values within 1e-4, worst < 5e-3)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 JAX devices")
    img = HW
    j_packs, infos = jax_animate._synthetic_scenes(2, img)
    t_packs = []
    for s, (jp, _, jcfg) in enumerate(j_packs):
        rng = np.random.default_rng(s)
        F = jcfg.num_faces
        jp["so3"] = jnp.asarray(0.2 * rng.standard_normal((F, 3)), jnp.float32)
        jp["scale"] = jnp.asarray(1.0 + 0.2 * rng.standard_normal((F, 3)), jnp.float32)
        jp["appearance"] = {"colors": jnp.asarray(rng.uniform(0.05, 0.95, (F, 3)), jnp.float32)}
        _, statics, cfg = TG.init_gom(_synthetic_model_cfg(img), infos[s], device="cpu")
        t_packs.append((params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"), statics, cfg))
    items = anim_cli._orbit_items(infos, 0, 4, img)[1]

    gom_cfg = jax_animate.check_homogeneous_scenes(j_packs)
    params_s = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[p[0] for p in j_packs])
    statics_s = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[p[1] for p in j_packs])
    render = make_multi_scene_render(make_mesh(2, axis=SCENE_AXIS), gom_cfg)
    want, _ = render(params_s, statics_s, stack_batches(items), jnp.float32(1e7))
    got, _ = anim_cli.render_in_turn(len(t_packs), "cpu")(t_packs, items)
    assert len(got) == 2
    for s in range(2):
        assert_close_frac(got[s].numpy(), np.asarray(want[s]), f"scene {s}")
        assert float(got[s].max()) > 0.05


def _synthetic_model_cfg(img):
    cfg = default_cfg()
    m = cfg["model"]
    m["img_size"] = list(img)
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    return m


@pytest.mark.parametrize("i_iter,with_posevec", [(1e7, True), (0.0, True), (1e7, False)])
def test_point_cloud_exports_match_jax(i_iter, with_posevec):
    """The canonical and the warped exports on the gate scene (every MLP
    on), with the pose-refinement and non-rigid gates open and shut."""
    scene = jax_gate_scene()
    jp, js, jc, frame_np, _ = scene
    tp, ts, tc, frame = torch_scene_from(scene)
    got = TG.export_canonical_pointcloud(tp, ts, tc)
    want = JG.export_canonical_pointcloud(jp, js, jc)
    posevec = frame["dst_posevec"] if with_posevec else None
    got_w = TG.export_warped_pointcloud(tp, ts, tc, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                                        dst_posevec=posevec, i_iter=i_iter)
    want_w = JG.export_warped_pointcloud(
        jp, js, jc, jnp.asarray(frame_np["cnl_gtfms"]), jnp.asarray(frame_np["dst_Rs"]),
        jnp.asarray(frame_np["dst_Ts"]), dst_posevec=jnp.asarray(frame_np["dst_posevec"]) if with_posevec else None,
        i_iter=i_iter,
    )
    for g, w in ((got, want), (got_w, want_w)):
        assert g.keys() == w.keys() == {"xyz", "vertices", "opacity", "colors", "cov"}
        for k in g:
            np.testing.assert_allclose(g[k].detach().numpy(), np.asarray(w[k]), rtol=0, atol=EXPORT_ATOL, err_msg=k)
    if with_posevec and i_iter > 0:
        # the gates are open: the modules moved the vertices
        shut = TG.export_warped_pointcloud(tp, ts, tc, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"], i_iter=1e7)
        assert float((got_w["vertices"] - shut["vertices"]).abs().max()) > 1e-4


def test_refine_frame_gives_mains_results(workspace, refined):
    """main's per-frame body is ``refine_frame``: on each test frame from the
    dataset's pose it gives main's losses, dropped entries and pose.pkl,
    and equals the optimizer's outputs read directly."""
    from gomavatar_tpu_torch.config import make_cfg
    from gomavatar_tpu_torch.data.dataset import TrainDataset, to_device

    cfg = make_cfg(workspace["cfg_path"])
    d = cfg["dataset"]["test_view"]
    dataset = TrainDataset(d["dataset_path"], bgcolor=cfg["bgcolor"], skip=d.get("skip", 1),
                           target_size=cfg["img_size"])
    trainer = Trainer(cfg, dataset.get_canonical_info(), device="cpu")
    trainer.load_for_eval(os.path.join(cfg["save_dir"], "checkpoints"))
    optimize = pose_cli.make_pose_optimizer(trainer.gom_cfg, cfg["train"]["losses"], cfg["pose"], POSE_ITERS)
    with open(refined["pose_path"], "rb") as f:
        saved = pickle.load(f)
    for i in range(FRAMES):
        item = dataset[i]
        batch = to_device(item, "cpu")
        pose = np.asarray(item["dst_poses"], np.float32)
        r = pose_cli.refine_frame(optimize, trainer.params, trainer.statics, None, batch, pose, position=i)
        best, best_loss, losses, drops = optimize(trainer.params, trainer.statics, None, batch, torch.as_tensor(pose))
        np.testing.assert_array_equal(r.losses, losses.numpy())
        assert (r.best_loss, r.dropped, r.first_loss) == (float(best_loss), int(drops.sum()), float(losses[0]))
        assert r.finite and r.most_tiles == int(optimize.most_tiles) > 0
        for got, key in ((r.Rh, "Rh"), (r.Th, "Th"), (r.poses, "poses")):
            np.testing.assert_array_equal(got, best[key].numpy(), err_msg=key)
        assert (r.first_loss, r.best_loss, r.dropped) == (refined["first_loss"][i], refined["best_loss"][i],
                                                          refined["dropped"][i])
        for got, key in ((r.Rh, "Rhs"), (r.Th, "Ths"), (r.poses, "dst_poses")):
            np.testing.assert_array_equal(got, saved[key][i], err_msg=key)

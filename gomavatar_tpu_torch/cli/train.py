"""Training driver (port of gomavatar_tpu/cli/train.py).

    python -m gomavatar_tpu_torch.cli.train --cfg configs/exps/zju-mocap_377.yaml \
        [--resume] [--max_iters N] [--device cpu] [--data_parallel N]

The loop: the iter-0 checkpoint, the batches of :func:`train_feed` (each
item's random background and crop drawn from its epoch, rank and position,
so two runs of one config see the same batches), one
``Trainer.step`` per frame (on the card one replay of the phase's captured
train program), and at their cadences the log line, TensorBoard, a
checkpoint and the periodic eval; then a final checkpoint.  The host reads
the loss only at ``log_freq`` and the TB scalars only at ``tb_freq``, so no
other step waits for the device.  It runs on the card unless ``--device
cpu``; ``main`` returns the ``Trainer``.

``--data_parallel N`` (N > 1) trains on N frames per optimizer step: N rank
processes (``parallel.spawn``; on CUDA one card each, ``cuda:0`` ..
``cuda:N-1``, so N cards are needed; on the CPU gloo ranks), each stepping
on its own frame with the gradients averaged by one all-reduce per step.
The step is the rank's program (``parallel.make_data_parallel_program``):
over NCCL one CUDA graph per phase, the all-reduce captured in it, replayed
every step; on the CPU the same step eagerly.
Every rank draws the same epoch order and takes its items by
``parallel.rank_items`` (item g * N + r of step g; an epoch's leftover
items dropped), as JAX's driver groups them.  Every rank checks the
averaged loss for non-finite values at ``log_freq``; rank 0 alone logs,
writes TensorBoard (on its own frame), saves and runs the periodic eval
while the others wait in the next all-reduce.  ``main`` then returns each
rank's {"i_iter", "phase"}.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import logging
import os
import sys
import time

import numpy as np
import torch

from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.data.dataset import Prefetcher, TrainDataset, ZJUTestDataset, to_device
from gomavatar_tpu_torch.eval_lib import Evaluator, EvaluatorSnapshot
from gomavatar_tpu_torch.losses import unpack
from gomavatar_tpu_torch.models import lpips as lpips_lib
from gomavatar_tpu_torch.parallel import barrier, rank_items, spawn
from gomavatar_tpu_torch.trainer import Trainer
from gomavatar_tpu_torch.utils.sampling import balanced_order
from gomavatar_tpu_torch.utils.tb import TBLogger


def setup_logging(save_dir: str, filename: str = "log.txt"):
    os.makedirs(save_dir, exist_ok=True)
    logging.basicConfig(
        handlers=[logging.FileHandler(os.path.join(save_dir, filename)), logging.StreamHandler()],
        format="%(asctime)s %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
        force=True,
    )


def check_device(name: str) -> torch.device:
    """The driver's device; a CUDA device that is not there is an error,
    never a fall-back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found: the drivers run on the card (--device cpu runs them on the CPU)")
    return device


def evaluate_on(trainer: Trainer, dataset, tb, split: str, random_bgcolor: bool,
                max_items=None, protocol: str = "zju"):
    """Periodic eval, protocol-aware: a snapshot test split takes the
    Anim-NeRF evaluator (gaussian-window SSIM, AlexNet-LPIPS)."""
    if protocol == "snapshot":
        evaluator = EvaluatorSnapshot(device=trainer.device)
    else:
        evaluator = Evaluator(lpips_params=trainer.lpips_params, lpips_calibrated=trainer.lpips_calibrated,
                              device=trainer.device)
    bg = np.asarray(dataset.bgcolor if dataset.bgcolor is not None else [0, 0, 0], np.float32) / 255.0
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    for i in range(n):
        batch = to_device(dataset[i], trainer.device)
        rgb, mask, _ = trainer.forward(batch)
        # composite over the background the item's target was composited
        # with: under random_bgcolor each item has its own, and a static bg
        # would score the background mismatch, not the model
        item_bg = batch.get("bgcolor", None)
        pred = unpack(rgb, mask, item_bg if item_bg is not None else torch.as_tensor(bg, device=trainer.device),
                      clamp=True)
        evaluator.evaluate(pred.cpu().numpy(), batch["target_rgbs"].cpu().numpy())
    means = evaluator.summarize()
    logging.info("evaluate on %s: %s", split, {k: round(v, 4) for k, v in means.items()})
    for k, v in means.items():
        tb.summ_scalar(f"{split}/{k}", v, force=True)
    return means


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def log_tb_visuals(trainer: Trainer, tb, batch):
    """Rendered maps and the canonical / observation point clouds with LBS
    colouring, as TB summaries."""
    rgb, mask, aux = trainer.forward(batch, train=True)
    rgb = _np(rgb)
    tb.summ_image("model/rgb", rgb)
    tb.summ_image("model/albedo", _np(aux["albedo"]))
    tb.summ_image("model/mask", _np(mask))
    normal = _np(aux["normal"])
    tb.summ_image("model/normal", 1.0 - (normal + 1.0) * 0.5)
    if aux.get("normal_mask") is not None:
        tb.summ_image("model/normal_mask", _np(aux["normal_mask"]))
    if aux.get("shadow") is not None:
        sh = _np(aux["shadow"])
        tb.summ_image("model/shadow", sh[..., 0] / max(float(sh.max()), 1e-6))
    tb.summ_error_map("model/error", rgb, _np(batch["target_rgbs"]))
    tb.summ_feat("model/normal_pca", normal.transpose(2, 0, 1))

    verts_cnl = _np(aux["verts_cnl"])
    verts_obs = _np(aux["verts_obs"])
    # projected observation vertices as a 2D raster
    K = _np(batch["K"])
    E = _np(batch["E"])
    cam = verts_obs @ E[:3, :3].T + E[:3, 3]
    uvw = cam @ K.T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)
    H, W = rgb.shape[:2]
    tb.summ_pointcloud2d("observation/projected", uv, (W, H))
    faces = _np(trainer.statics.faces)
    colors = _np(aux["colors"])
    tb.summ_pointcloud("canonical/density", verts_cnl, faces=faces)
    tb.summ_pointcloud("observation/density", verts_obs, faces=faces)
    # per-face colors -> per-vertex for mesh display
    vc = np.zeros_like(verts_cnl)
    for k in range(3):
        np.add.at(vc, faces[:, k], colors)
    cnt = np.zeros(len(verts_cnl))
    np.add.at(cnt, faces.reshape(-1), 1.0)
    vc = vc / np.maximum(cnt, 1.0)[:, None]
    tb.summ_pointcloud("canonical/color", verts_cnl, colors=vc, faces=faces)
    # LBS-weight colouring via a simple palette
    lbs = _np(trainer.statics.lbs_weights)
    J = lbs.shape[1]
    palette = np.asarray([np.cos(np.arange(J)), np.sin(np.arange(J)), np.linspace(0, 1, J)]).T * 0.5 + 0.5
    tb.summ_pointcloud("canonical/lbs", verts_cnl, colors=lbs @ palette, faces=faces)


def evaluate_test_split(trainer: Trainer, cfg, tb):
    """Periodic novel-view eval on the configured test split (at most 8
    items); skipped when its data is absent."""
    try:
        d = cfg["dataset"]["test_view"]
        if d.get("name", "zju-mocap") == "snapshot":
            ds = TrainDataset(d["dataset_path"], bgcolor=cfg["bgcolor"], skip=d.get("skip", 1),
                              target_size=cfg["img_size"])
        else:
            ds = ZJUTestDataset(d["raw_dataset_path"], d["dataset_path"], test_type="view", bgcolor=cfg["bgcolor"],
                                exclude_view=d.get("exclude_view", 0), skip=d.get("skip", 30))
    except (FileNotFoundError, KeyError, OSError) as e:
        logging.info("skipping test-split eval (%s)", e)
        return None
    protocol = "snapshot" if d.get("name", "zju-mocap") == "snapshot" else "zju"
    return evaluate_on(trainer, ds, tb, "test", cfg["random_bgcolor"], max_items=8, protocol=protocol)


def train_dataset(cfg, device=None) -> TrainDataset:
    """The train split of the exp config, native decode when asked for and
    available; the loop reads every frame each epoch, so the dataset keeps
    each frame's decoded pixels after its first read (``retain``), on the
    card of ``device`` where it is one (by default the current CUDA device
    where there is one), which then composites and resizes each item."""
    dcfg = cfg["dataset"]["train"]
    use_native = bool(dcfg.get("use_native", False))
    if use_native:
        from gomavatar_tpu_torch.data import native_loader

        if not native_loader.available():
            logging.warning(
                "dataset.train.use_native requested but the native library is unavailable; falling back to the "
                "cv2 path"
            )
            use_native = False
    return TrainDataset(
        dcfg["dataset_path"],
        maxframes=dcfg["maxframes"],
        bgcolor=None if cfg["random_bgcolor"] else cfg["bgcolor"],
        skip=dcfg["skip"],
        target_size=cfg["img_size"],
        crop_size=dcfg["crop_size"],
        prefetch=dcfg["prefetch"],
        split_for_pose=dcfg["split_for_pose"],
        use_native=use_native,
        retain=True,
        device=device if device is not None else ("cuda" if torch.cuda.is_available() else None),
    )


def train_feed(dataset, order_rng, device, world: int = 1, rank: int = 0, balanced_Es=None):
    """The training loop's batches, endlessly: ``(epoch, position, item,
    batch)``, epochs from 1.  Each epoch a new order from ``order_rng``
    (pose-balanced over ``balanced_Es`` where given), rank ``rank``'s items
    of it (``rank_items``) through a ``Prefetcher`` seeded by ``(epoch,
    rank)``, and ``to_device``.  Fewer frames than ranks raises; closing
    the feed releases the decode threads."""
    if len(dataset) < world:
        raise ValueError(f"{world} ranks need at least {world} train frames, found {len(dataset)}")
    for epoch in itertools.count(1):
        if balanced_Es is not None:
            order = balanced_order(balanced_Es, len(dataset), order_rng)
        else:
            order = order_rng.permutation(len(dataset))
        for pos, item in enumerate(Prefetcher(dataset, order=rank_items(order, world, rank), seed=(epoch, rank))):
            yield epoch, pos, item, to_device(item, device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train an avatar (gomavatar_tpu_torch).")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max_iters", type=int, default=None, help="override total_iters")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    ap.add_argument("--data_parallel", type=int, default=1,
                    help="frames per optimizer step, one rank process each (on CUDA one card each)")
    return ap.parse_args(argv)


def rank_devices(device: torch.device, n: int) -> list[torch.device]:
    """The devices of n ranks: cuda:0 .. cuda:n-1 (an error when fewer cards
    are visible), or the CPU n times."""
    if device.type != "cuda":
        return [device] * n
    have = torch.cuda.device_count()
    if n > have:
        raise SystemExit(f"--data_parallel {n} needs {n} CUDA devices, {have} found")
    return [torch.device("cuda", i) for i in range(n)]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    device = check_device(args.device)
    if args.data_parallel > 1:
        return spawn(_train_rank, rank_devices(device, args.data_parallel), argv)
    return train(args, device)


def _train_rank(group, argv):
    trainer = train(parse_args(argv), group.device, group)
    return {"i_iter": trainer.i_iter, "phase": trainer.phase}


def train(args, device: torch.device, group=None) -> Trainer:
    """The training loop on ``device``; under ``group``, one rank of a
    data-parallel run."""
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    lead = rank == 0
    cfg = make_cfg(args.cfg)
    ckpt_dir = os.path.join(cfg["save_dir"], "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    if lead:
        setup_logging(cfg["save_dir"])
        with open(os.path.join(cfg["save_dir"], "config.yaml"), "w") as f:
            f.write(cfg.dump())
    else:
        logging.basicConfig(level=logging.WARNING, force=True)

    tcfg = cfg["train"]
    dataset = train_dataset(cfg, device)
    logging.info("train frames: %d", len(dataset))
    if len(dataset) < world:
        raise SystemExit(f"--data_parallel {world} needs at least {world} train frames, found {len(dataset)}")
    if group is not None:
        logging.info("data-parallel over %d ranks (%s on %s), one frame per rank per step through the rank's "
                     "program", world, group.backend, group.device.type)

    lpips_params, calibrated = None, False
    if tcfg["losses"]["lpips"]["coeff"] > 0:
        # best-available weights; load_lpips logs the calibration status
        lpips_params, calibrated, _ = lpips_lib.load_lpips("vgg", device=device)

    trainer = Trainer(cfg, dataset.get_canonical_info(), lpips_params=lpips_params, device=device,
                      lpips_calibrated=calibrated, group=group)
    if args.resume:
        trainer.resume(ckpt_dir)
    if group is not None:
        barrier(group)  # every rank has read the checkpoints before rank 0 writes one

    tb = TBLogger(os.path.join(cfg["save_dir"], "tb"), freq=tcfg["tb_freq"]) if lead else None
    total_iters = args.max_iters or tcfg["total_iters"]

    if trainer.i_iter == 0:
        trainer.save(ckpt_dir)  # the iter-0 baseline

    t_last = time.perf_counter()
    balanced_Es = None
    if tcfg.get("pose_balanced_sampling", False):
        balanced_Es = dataset.get_all_Es()
        logging.info("pose-balanced frame sampling ON (%d frames)", len(balanced_Es))
    feed = train_feed(dataset, np.random.default_rng(0), device, world, rank, balanced_Es)
    with contextlib.closing(feed):
        while trainer.i_iter < total_iters:
            _, _, _, batch = next(feed)
            # the step copies the batch into its program's inputs; total and
            # losses are the program's outputs, which the next step
            # overwrites: everything below reads them before that
            total, losses = trainer.step(batch)
            it = trainer.i_iter

            if it % tcfg["log_freq"] == 0:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                # one read of every term: the only wait on the device here
                total_f, *terms = torch.stack([total.float()] + [v.float() for v in losses.values()]).tolist()
                loss_str = ", ".join(f"{k}: {v:.4f}" for k, v in zip(losses, terms))
                logging.info("iter %d (%.2f it/s) - loss: %.4f (%s)", it, tcfg["log_freq"] / max(dt, 1e-9), total_f,
                             loss_str)
                if not np.isfinite(total_f):
                    # fail fast: going on would poison every parameter and
                    # the next checkpoint; the last good one stays usable.
                    # Every rank reads the same averaged loss, so all raise.
                    raise RuntimeError(f"non-finite training loss at iter {it}: {loss_str}")
            if not lead:
                continue
            tb.set_step(it)
            # device scalars pass through: TBLogger reads them after its
            # cadence gate, so an off-cadence step does not wait
            tb.summ_scalar("train/total_loss", total)
            for k, v in losses.items():
                tb.summ_scalar(f"train/loss_{k}", v)

            if it % tcfg["tb_freq"] == 0:
                log_tb_visuals(trainer, tb, batch)
            if it % tcfg["save_freq"] == 0:
                trainer.save(ckpt_dir)
            if it % tcfg["eval_freq"] == 0:
                evaluate_on(trainer, dataset, tb, "test_on_train", cfg["random_bgcolor"], max_items=4)
                evaluate_test_split(trainer, cfg, tb)

    trainer.save(ckpt_dir)
    if lead:
        tb.close()
    logging.info("training done at iter %d", trainer.i_iter)
    return trainer


if __name__ == "__main__":
    main()

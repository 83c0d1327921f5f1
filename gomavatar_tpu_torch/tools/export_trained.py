"""Export a trained avatar into one small flat artifact (port of the JAX
package's ``tools/export_trained.py``).

Reads the latest checkpoint of an experiment (``Trainer.load_for_eval``,
which replays its subdivisions), converts the params to numpy and packs one
animation frame (pose + camera) of the train split, so that a bench or a
renderer needs neither the training data nor the checkpoints.

Format, the JAX package's: a flat ``.npz`` (no pickle) whose ``meta`` holds
the JSON scalars and the model config (iter, phase, model_cfg, num_faces,
body), ``params/<path>`` the flattened params (list positions as integer
segments) and ``frame/<key>`` the packed frame.  JAX's ``unflatten_params``
and this package's ``convert.load_trained`` both read it; ``body`` names the
``synthetic_body`` the capture was made from, which ``load_trained``
rebuilds.

    python -m gomavatar_tpu_torch.tools.export_trained [--cfg configs/exps/e2e_synthetic.yaml] \
        [--out gomavatar_tpu_torch/artifacts/e2e_trained.npz] [--rings 144 --segs 48] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gomavatar_tpu_torch.cli.train import check_device
from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.convert import FRAME_KEYS
from gomavatar_tpu_torch.data.dataset import TrainDataset
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.trainer import Trainer

ARTIFACT = os.path.join("gomavatar_tpu_torch", "artifacts", "e2e_trained.npz")


def flatten_params(params, prefix="params"):
    """Nested dicts/lists of tensors -> {"params/a/0/b": np.ndarray}: the
    MLPs' ``layers`` are lists of per-layer dicts, whose positions become
    integer path segments, so nothing ends up an object array in the npz."""
    out = {}
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for k, v in items:
        key = f"{prefix}/{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_params(v, key))
        else:
            out[key] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def check_body(dataset: TrainDataset, body: dict) -> None:
    """The capture's canonical mesh must be ``synthetic_body(**body)``, the
    mesh ``load_trained`` rebuilds."""
    info = synthetic_body(**body)
    same = (np.array_equal(np.asarray(info["faces"]), np.asarray(dataset.faces))
            and np.array_equal(np.asarray(info["canonical_vertex"], np.float32), dataset.canonical_vertex))
    if not same:
        raise SystemExit(f"the capture's canonical mesh is not synthetic_body({body}): pass its --rings / --segs")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Export a trained avatar as a flat npz.")
    ap.add_argument("--cfg", default="configs/exps/e2e_synthetic.yaml")
    ap.add_argument("--out", default=ARTIFACT)
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--rings", type=int, default=144, help="the capture's synthetic_body n_rings")
    ap.add_argument("--segs", type=int, default=48, help="the capture's synthetic_body n_seg")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    cfg = make_cfg(args.cfg)
    dataset = TrainDataset(
        cfg["dataset"]["train"]["dataset_path"], bgcolor=cfg["bgcolor"], target_size=cfg["img_size"],
    )
    body = {"n_rings": args.rings, "n_seg": args.segs}
    check_body(dataset, body)
    trainer = Trainer(cfg, dataset.get_canonical_info(), device=device)
    it = trainer.load_for_eval(os.path.join(cfg["save_dir"], "checkpoints"))
    item = dataset[args.frame]

    meta = {
        "iter": int(it),
        "phase": int(trainer.phase),
        "model_cfg": dict(cfg["model"]),
        # the mesh rebuilds from synthetic_body + the subdivision replay;
        # the face count detects generator drift
        "num_faces": int(trainer.gom_cfg.num_faces),
        "body": body,
    }
    arrays = flatten_params(trainer.params)
    arrays.update({f"frame/{k}": np.asarray(item[k]) for k in FRAME_KEYS})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, meta=json.dumps(meta), **arrays)
    mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({mb:.1f} MB, iter {it}, {meta['num_faces']} faces)", flush=True)
    return {"path": args.out, "iter": int(it), "phase": int(trainer.phase), "num_faces": meta["num_faces"],
            "frame": item["frame_name"], "mb": mb}


if __name__ == "__main__":
    main()

"""A tiny cell for the CPU tests: a 1,152-face avatar made from a seed with
the reference's mesh generator, written in the state's npz layout, and the
configurations and mixes of BENCHMARK.json cut to a 32^2 frame."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np

from portbench.reference.mesh import subdivide, synthetic_body

ROOT = Path(__file__).resolve().parents[2]
BODY = {"n_rings": 12, "n_seg": 8}


def mlp(rng, dims, scale=0.05):
    layers = [{"w": rng.normal(size=(a, b)).astype(np.float32) * np.float32(scale), "b": np.zeros(b, np.float32)}
              for a, b in zip(dims[:-2], dims[1:-1])]
    return {"layers": layers, "head": {"w": rng.normal(size=dims[-2:]).astype(np.float32) * np.float32(1e-3),
                                       "b": np.zeros(dims[-1], np.float32)}}


def write_state(path: Path, model: dict, seed: int = 0) -> None:
    """An avatar in the layout of ``inputs/e2e_trained.npz``: ``meta``,
    ``params/...`` and ``frame/...``."""
    rng = np.random.default_rng(seed)
    verts, faces, w, _ = synthetic_body(**BODY)
    verts, faces, w = subdivide(verts, faces, w.astype(np.float32).astype(np.float64))
    F = len(faces)
    params = {
        "vertices": verts.astype(np.float32),
        "so3": (rng.normal(size=(F, 3)) * 0.1).astype(np.float32),
        "scale": (1.0 + rng.normal(size=(F, 3)) * 0.1).astype(np.float32),
        "appearance": {"colors": rng.uniform(0.2, 0.8, size=(F, 3)).astype(np.float32)},
        "non_rigid": mlp(rng, [105, 128, 128, 128, 128, 128, 128, 3]),
        "pose_refinement": mlp(rng, [69, 256, 256, 256, 256, 69]),
        "shadow": mlp(rng, [39, 128, 128, 128, 1], scale=0.2),
    }
    params["non_rigid"]["layers"][4]["w"] = (rng.normal(size=(164, 128)) * 0.05).astype(np.float32)
    flat = {}

    def put(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                put(f"{prefix}/{k}", v)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                put(f"{prefix}/{i}", v)
        else:
            flat[prefix] = t

    put("params", params)
    K = np.array([[563.2, 0, 256.0], [0, 563.2, 256.0], [0, 0, 1]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[2, 3] = 2.4
    j = synthetic_body(**BODY)[3].astype(np.float32)
    G = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    G[:, :3, 3] = j
    flat.update({"frame/K": K, "frame/E": E, "frame/cnl_gtfms": G, "frame/dst_Ts": j,
                 "frame/dst_Rs": np.tile(np.eye(3, dtype=np.float32), (24, 1, 1)),
                 "frame/dst_posevec": np.full(69, 0.01, np.float32)})
    meta = {"iter": 0, "phase": 1, "model_cfg": model, "num_faces": F, "body": BODY}
    np.savez(path, meta=json.dumps(meta), **flat)


def spec(workload: str, tmp: Path, size: int = 32) -> dict:
    """The resolved cell ``workload`` of BENCHMARK.json at a ``size``^2
    frame on the tiny avatar, its limits those of the cell."""
    import sys

    sys.path.insert(0, str(ROOT))
    from portbench import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    s = run.resolve(bench, workload)
    conf = copy.deepcopy(s["config"])
    conf["frame_size"] = size
    conf["model"]["img_size"] = [size, size]
    state = tmp / "tiny_state.npz"
    if not state.exists():
        write_state(state, conf["model"])
    conf["state"] = str(state)
    conf["train_frames"] = {**conf["train_frames"], "count": 6, "png_size": 2 * size}
    mix = copy.deepcopy(s["mix"])
    mix.update({k: v for k, v in {"pool": 8, "sample": 2, "sample_span": 4}.items() if k in mix})
    mix["trace"] = {"start": 0.0, "units": 2}
    return {**s, "config": conf, "mix": mix}


def limits(workload: str) -> dict:
    return json.loads((ROOT / "portbench" / "limits" / f"{workload}.json").read_text())["limits"]

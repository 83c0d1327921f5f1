"""The port's side of the seeded-draw witness: the numbers that
``weights/prng_witness.npz`` holds from ``jax.random`` and the JAX package's
LPIPS inits, drawn here by ``prng`` and ``models.lpips``.

``draws()`` gives them under the npz's names; ``mismatches()`` lists the
names whose values differ from the npz (every value is bit for bit).
``chip_smoke.py`` runs it on the card's host, where there is no JAX; the
JAX side, which writes the npz, is ``tests/torch_prng_witness.py``.

    python -m gomavatar_tpu_torch.tools.prng_witness
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.models import lpips

WITNESS = Path(__file__).resolve().parent.parent / "weights" / "prng_witness.npz"
SEEDS = (0, 1, 7, 1234, 4321, 2**31 - 1)
SHAPE = (5, 7)
BIG = (257, 300)  # 77,100 values: counters past 2**16
EDGE = 64  # the first and last values kept of each LPIPS conv draw


def edges(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a).ravel()
    return np.concatenate([a[:EDGE], a[-EDGE:]])


def draws() -> dict[str, np.ndarray]:
    out = {}
    for s in SEEDS:
        k = prng.key(s)
        out[f"key/{s}"] = k
        out[f"split/{s}"] = prng.split(k, 3)
        out[f"bits/{s}"] = prng.bits(k, SHAPE)
        out[f"uniform/{s}"] = prng.uniform(k, SHAPE)
        out[f"uniform_sym/{s}"] = prng.uniform(k, SHAPE, -0.3, 0.3)
        out[f"normal/{s}"] = prng.normal(k, SHAPE)
    out["normal_big/edges"] = edges(prng.normal(prng.key(0), BIG))
    for name, seed, shapes in (("vgg", 1234, lpips.vgg_shapes()), ("alex", 4321, lpips.alex_shapes())):
        for i, w in enumerate(lpips.random_trunk(seed, tuple(shapes))):  # HWIO, as drawn
            out[f"lpips_{name}/{i}"] = edges(w)
    return out


def mismatches(path=WITNESS) -> list[str]:
    got = draws()
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    if sorted(got) != sorted(want):
        return sorted(set(got) ^ set(want))
    return [k for k in want if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k])]


if __name__ == "__main__":
    bad = mismatches()
    print(f"{WITNESS}: " + (f"{len(bad)} draws differ: {bad}" if bad else "every draw equal"))
    raise SystemExit(1 if bad else 0)

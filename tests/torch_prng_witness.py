"""JAX's side of the seeded-draw witness (``gomavatar_tpu_torch/tools/prng_witness.py``
is the port's): the same names drawn with ``jax.random`` and the JAX
package's LPIPS inits.  ``tests/test_torch_prng.py`` holds the committed npz
equal to ``witness()``.  Rewrite the npz, only after a deliberate change of
what it holds, with

    JAX_PLATFORMS=cpu python tests/torch_prng_witness.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from gomavatar_tpu_torch.tools.prng_witness import BIG, SEEDS, SHAPE, WITNESS, edges  # noqa: E402


def witness() -> dict[str, np.ndarray]:
    import jax

    from gomavatar_tpu.models import lpips as JL

    out = {}
    for s in SEEDS:
        k = jax.random.PRNGKey(s)
        out[f"key/{s}"] = np.asarray(k)
        out[f"split/{s}"] = np.asarray(jax.random.split(k, 3))
        out[f"bits/{s}"] = np.asarray(jax.random.bits(k, SHAPE))
        out[f"uniform/{s}"] = np.asarray(jax.random.uniform(k, SHAPE))
        out[f"uniform_sym/{s}"] = np.asarray(jax.random.uniform(k, SHAPE, minval=-0.3, maxval=0.3))
        out[f"normal/{s}"] = np.asarray(jax.random.normal(k, SHAPE))
    out["normal_big/edges"] = edges(jax.random.normal(jax.random.PRNGKey(0), BIG))
    for name, init in (("vgg", JL.init_lpips), ("alex", JL.init_lpips_alex)):
        for i, conv in enumerate(init()[0]["convs"]):
            out[f"lpips_{name}/{i}"] = edges(conv["w"])  # HWIO, as drawn
    return out


if __name__ == "__main__":
    np.savez_compressed(WITNESS, **witness())
    print(f"wrote {WITNESS}")

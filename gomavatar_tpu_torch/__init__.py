"""gomavatar_tpu_torch: the PyTorch + CUDA port of ``gomavatar_tpu`` for one
NVIDIA H100.

The JAX package beside it is the reference; every module here mirrors the
reference file at the same relative path and is tested against it on the
same inputs (``tests/test_torch_*.py``).  This package imports ``torch`` and
numpy only, never ``jax`` and nothing of ``gomavatar_tpu``.

Entry points (the drivers ``python -m gomavatar_tpu_torch.cli.train`` and
``.cli.evaluate``, ``convert.load_trained``, ``scene.gate_scene``,
``models.gom.init_gom``, ``models.gom.gom_forward``) put their tensors on
``device="cuda"`` unless the caller asks for another device (the drivers'
``--device cpu``); on a CPU tensor every hand-written kernel runs its plain
PyTorch version instead.
"""

import torch

__version__ = "0.1.0"  # the JAX package's, whose port this is

# The reference runs its MLPs and geometry matmuls at precision="highest"
# (gomavatar_tpu/nn.py, ops/transforms.py).  TF32 keeps ~3 decimal digits,
# so float32 matmuls and convolutions here run in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

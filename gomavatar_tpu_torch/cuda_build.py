"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
under the repository root, at first use; the hash of the source and of the
shared headers ``csrc/*.cuh`` names the library, so an edited source is
never served a stale build.  Libraries are loaded with ``ctypes``.  Nothing
here runs at import time.

    python -m gomavatar_tpu_torch.cuda_build      # build every kernel, print ptxas info
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNEL_SOURCES = ("frame_render", "splat_composite", "mesh_raster", "composite_resize", "lpips_head")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # loaders on several threads (the dataset's workers) build once


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp_path, out_path) or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu"),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every missing kernel library, one nvcc per source, all started
    together.  Returns {name: compiler output} for the sources it built and
    raises if any build fails."""
    started = {n: _start_build(n) for n in names}
    logs, failed = {}, []
    for name, job in started.items():
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all((name,))
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib


if __name__ == "__main__":
    t0 = time.perf_counter()
    for name, log in build_all().items():
        print(f"== {name}\n{log}")
    print(f"built in {time.perf_counter() - t0:.1f} s into {BUILD_DIR}")

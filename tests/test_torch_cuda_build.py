"""The kernel build names each library by everything its source includes
from csrc/, so an edited shared header is never served a stale build."""

import re
import shutil

import pytest

from gomavatar_tpu_torch import cuda_build
from torch_threads import one_torch_thread  # noqa: F401


def test_every_local_include_is_a_csrc_header():
    for name in cuda_build.KERNEL_SOURCES:
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        for header in re.findall(r'#include\s+"([^"]+)"', src):
            assert header.endswith(".cuh") and (cuda_build.CSRC / header).is_file(), (name, header)


@pytest.mark.parametrize("edited", ["source", "header"])
def test_library_name_follows_source_and_headers(tmp_path, monkeypatch, edited):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    before = {n: cuda_build.library_path(n) for n in cuda_build.KERNEL_SOURCES}
    path = csrc / ("mesh_raster.cu" if edited == "source" else "common.cuh")
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.KERNEL_SOURCES}
    changed = {n for n in before if before[n] != after[n]}
    assert changed == ({"mesh_raster"} if edited == "source" else set(cuda_build.KERNEL_SOURCES))

"""The port's kernel build (``ops/_build.py``) on the CPU: a library's
file name carries a hash of its source, of every ``csrc/`` header the
source includes (followed through the headers) and of the nvcc flags, so
an edited header rebuilds every source that includes it. No ``nvcc`` is
needed: only the paths are computed."""

import os

from tensorflowonspark_tpu_torch.ops import _build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n'
           '#include "a.cuh"\nint k;\n')
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\nint a;\n')
    _write(tmp_path / "b.cuh", "#pragma once\nint b;\n")
    _write(tmp_path / "unused.cuh", "int u;\n")
    assert _build._sources(_build.source("k")) == [
        str(tmp_path / n) for n in ("k.cu", "a.cuh", "b.cuh")]
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    _write(tmp_path / "unused.cuh", "int u2;\n")
    assert _build.library_path("k") == first
    _write(tmp_path / "b.cuh", "#pragma once\nint b2;\n")
    second = _build.library_path("k")
    assert second != first
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\nint a2;\n')
    assert _build.library_path("k") not in (first, second)
    assert os.path.dirname(first) == _build.BUILD_DIR


def test_package_sources_share_the_tensor_core_header():
    """Both kernel sources include ``tc_common.cuh`` (the flash source
    also ``wgmma_bf16.cuh``, its bfloat16 kernels' building blocks), and
    every C symbol the wrappers bind is listed for its source."""
    extra = {"paged_attention": [], "flash_attention": ["wgmma_bf16.cuh"]}
    for name in ("paged_attention", "flash_attention"):
        deps = [os.path.basename(p) for p in
                _build._sources(_build.source(name))]
        assert deps == [name + ".cu", "tc_common.cuh"] + extra[name]
    assert set(_build.KERNELS["paged_attention"]) == {
        "tfos_paged_attention_tiled", "tfos_paged_attention_split",
        "tfos_paged_attention_window", "tfos_paged_budget"}
    with open(_build.source("paged_attention")) as f:
        text = f.read()
    for symbol in _build.KERNELS["paged_attention"]:
        assert 'extern "C" int {}('.format(symbol) in text

"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes`` — seconds per source, where a
build that includes PyTorch's headers takes minutes. One source may
export several C functions (``flash_attention.cu``: forward, dQ, dK/dV
and the kernels' resource query; ``wide_attention.cu``: both ops at head
dims above 256); :data:`KERNELS` lists each
source's symbols. Builds happen at first use (never at import, so the
CPU tests import every module on a machine without ``nvcc``), from the
sources in the package alone, into
``_build/`` beside them (git-ignored). A library's file name carries a
hash of its source and flags, so an edited source rebuilds; the output
is written to a temporary name and renamed into place, so concurrent
builds never load a half-written file. The hash covers the headers
a source includes from ``csrc/`` (``#include "name.cuh"``, followed
through the headers), so an edited header rebuilds every source that
includes it.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: nvcc flags every kernel is built with (sm_90a: Hopper with wgmma)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int

_F = ctypes.c_float

#: source name (``csrc/<name>.cu``) -> {C symbol: argtypes}; every
#: pointer and the stream are ``c_void_p`` so ctypes never narrows them
#: to 32 bits
KERNELS = {
    "paged_attention": {
        "tfos_paged_attention_tiled": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
        "tfos_paged_attention_split": [_P] * 10 + [_I] * 7 + [_F, _I, _P],
        "tfos_paged_attention_window": [_P] * 10 + [_I] * 8 + [_F, _I, _P],
        "tfos_paged_budget": [_I] * 4 + [_P],
    },
    "flash_attention": {
        "tfos_flash_fwd": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "tfos_flash_dq": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
        "tfos_flash_dkv": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
        "tfos_flash_budget": [_I] * 3 + [_P],
    },
    "wide_attention": {
        "tfos_wide_flash_fwd": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "tfos_wide_flash_dq": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
        "tfos_wide_flash_dkv": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
        "tfos_wide_paged_split": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
        "tfos_wide_paged_tiled": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
        "tfos_wide_budget": [_I] * 3 + [_P],
    },
}

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``,
    then ``/usr/local/cuda/bin``. Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                       "the port's CUDA kernels build at first launch")


def source(name):
    return os.path.join(CSRC, name + ".cu")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path):
    """``path`` and every header it includes from beside it, followed
    through the headers, each once, in first-include order."""
    seen, todo = [], [path]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        with open(p, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(p), inc.decode())
            if os.path.isfile(dep):
                todo.append(dep)
    return seen


def library_path(name):
    """Where ``name``'s library is (or will be) built: the file name
    carries a hash of the source, the ``csrc/`` headers it includes and
    the flags."""
    h = hashlib.sha256()
    for p in _sources(source(name)):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib{}-{}.so".format(
        name, h.hexdigest()[:16]))


def build(names=None):
    """Compile ``names`` (default: every source) that are not built yet,
    all ``nvcc`` processes started together. Returns ``{name:
    {"seconds": wall, "ptxas": register/spill report}}`` for the ones
    it built; raises with the compiler's output on any failure."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        tmp = "{}.tmp{}".format(target, os.getpid())
        cmd = [nvcc] + list(NVCC_FLAGS) + ["-Xptxas=-v", "-o", tmp,
                                           source(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, target, time.monotonic())
    report, failed = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("{} (nvcc exit {}):\n{}".format(
                name, proc.returncode, output))
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": time.monotonic() - t0,
                        "ptxas": output.strip()}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name):
    """The loaded library of source ``name`` (built first if needed),
    with every C function's argument and return types set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = _libs[name] = bind(path, name)
        return lib


def bind(path, name):
    """The library at ``path`` loaded with source ``name``'s C functions'
    argument and return types set."""
    lib = ctypes.CDLL(path)
    for symbol, argtypes in KERNELS[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib

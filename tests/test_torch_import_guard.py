"""The port stands alone: it imports nothing of JAX, flax or the JAX
package, and its kernel modules import (and serve and train on the CPU)
without a CUDA compiler — kernels build at their first launch on a
card."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tensorflowonspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tensorflowonspark_tpu")


def _run(code):
    env = dict(os.environ)
    env.pop("CUDA_HOME", None)
    env.pop("CUDA_PATH", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_serves_with_jax_unimportable():
    res = _run("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import torch
        from tensorflowonspark_tpu_torch import serving
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        model = DecoderLM(32, hidden=16, num_heads=2, num_layers=1,
                          max_len=32)
        model.init_weights(torch.Generator().manual_seed(0))
        with serving.DecodeEngine(model, slots=2, device="cpu") as eng:
            out = eng.generate([1, 2, 3], 4, timeout=120)
        assert len(out) == 7 and out[:3] == [1, 2, 3], out
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_port_trains_with_jax_unimportable():
    res = _run("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import torch
        from tensorflowonspark_tpu_torch import infeed, training
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        model = DecoderLM(32, hidden=16, num_heads=2, num_layers=1,
                          max_len=128)
        trainer = training.Trainer(model, training.adamw(1e-2),
                                   device="cpu")
        state = trainer.init(torch.Generator().manual_seed(0))
        rows = np.random.RandomState(0).randint(0, 32, (3, 2, 129))
        feed = ({"x": r[:, :-1], "y": r[:, 1:]} for r in rows)
        state, steps, rate = trainer.train_loop(
            state, infeed.device_batches(feed, device="cpu"))
        assert steps == 3 and state["step"] == 3 and rate > 0
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_port_file_imports_jax_or_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    bad = [(f, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel wrapper and its builder runs no compiler and
    loads no library: the build happens at the first launch."""
    res = _run("""
        import subprocess

        def refuse(*a, **k):
            raise AssertionError("a compiler ran at import time")

        subprocess.Popen = refuse
        subprocess.run = refuse
        from tensorflowonspark_tpu_torch import infeed, training
        from tensorflowonspark_tpu_torch.ops import _build
        from tensorflowonspark_tpu_torch.ops import flash_attention
        from tensorflowonspark_tpu_torch.ops import paged_attention
        assert _build._libs == {}
        assert paged_attention.launches == 0
        assert flash_attention.launches == {"fwd": 0, "dq": 0, "dkv": 0}
        assert set(_build.KERNELS) == {"paged_attention", "flash_attention"}
        assert set(_build.KERNELS["flash_attention"]) == {
            "tfos_flash_fwd", "tfos_flash_dq", "tfos_flash_dkv",
            "tfos_flash_budget"}
        for name in _build.KERNELS:
            assert _build.library_path(name).endswith(".so")
        print("OK")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")

"""tensorflowonspark_tpu_torch — the PyTorch/CUDA port of tensorflowonspark_tpu.

The JAX package (``tensorflowonspark_tpu``) is the reference this port
is held against; the port imports nothing of it. Module names mirror
the reference so each counterpart is easy to find:

- :mod:`~tensorflowonspark_tpu_torch.device_info` — CUDA discovery.
- :mod:`~tensorflowonspark_tpu_torch.convert` — flax ``DecoderLM``
  params <-> the port's ``state_dict``.
- :mod:`~tensorflowonspark_tpu_torch.ops.paged_attention` — paged
  attention through a block table (hand-written Hopper kernel + plain
  PyTorch versions).
- :mod:`~tensorflowonspark_tpu_torch.ops.flash_attention` — fused
  attention forward and backward (three hand-written Hopper kernels +
  plain PyTorch versions, one ``torch.autograd.Function``).
- :mod:`~tensorflowonspark_tpu_torch.models.decoder` — ``DecoderLM``:
  full-sequence (training) forward and paged decode path.
- :mod:`~tensorflowonspark_tpu_torch.paging` — host block allocator.
- :mod:`~tensorflowonspark_tpu_torch.generation` — paged prefill/decode
  step functions and sampling.
- :mod:`~tensorflowonspark_tpu_torch.serving` — continuous-batching
  ``DecodeEngine`` and an engine-only ``ModelServer``.
- :mod:`~tensorflowonspark_tpu_torch.training` — the data-parallel
  ``Trainer`` (DDP under a process group, one card per rank),
  ``softmax_xent``, ``adamw``.
- :mod:`~tensorflowonspark_tpu_torch.checkpoint` — ``Checkpointer`` on
  ``torch.distributed.checkpoint``; :mod:`~tensorflowonspark_tpu_torch.export`
  — the model export directory (``tfos-torch-export-v1``).
- :mod:`~tensorflowonspark_tpu_torch.tfrecord` (with the native codec
  :mod:`~tensorflowonspark_tpu_torch._tfrecord_native`, built into
  ``_build/``), :mod:`~tensorflowonspark_tpu_torch.dfutil` and
  :mod:`~tensorflowonspark_tpu_torch.pipeline` (``TFEstimator``,
  ``TFModel``) — the data I/O and the ML-pipeline layer.
- :mod:`~tensorflowonspark_tpu_torch.infeed` — ``prefetch`` and
  ``device_batches`` (pinned staging, side-stream copies).
- The cluster and feed plane, each the port's own copy of the module of
  the same name: :mod:`~tensorflowonspark_tpu_torch.cluster`
  (``run``, ``InputMode``, ``TFCluster``),
  :mod:`~tensorflowonspark_tpu_torch.node` (bootstrap, feed helpers,
  ``NodeContext.initialize_torch``),
  :mod:`~tensorflowonspark_tpu_torch.engine` (local Spark-shaped
  engine, its closure serializer and ``DataFrame``),
  :mod:`~tensorflowonspark_tpu_torch.reservation`,
  :mod:`~tensorflowonspark_tpu_torch.manager`,
  :mod:`~tensorflowonspark_tpu_torch.datafeed` (and ``tfnode``),
  :mod:`~tensorflowonspark_tpu_torch.shm` (the native ring, built into
  ``_build/``), :mod:`~tensorflowonspark_tpu_torch.frames`,
  :mod:`~tensorflowonspark_tpu_torch.marker`,
  :mod:`~tensorflowonspark_tpu_torch.goodput`,
  :mod:`~tensorflowonspark_tpu_torch.chaos`,
  :mod:`~tensorflowonspark_tpu_torch.fs` and
  :mod:`~tensorflowonspark_tpu_torch.util`;
  :mod:`~tensorflowonspark_tpu_torch.tracing` holds the metrics
  registry, event log and flight recorder they report through.

``flash_attention``, ``flash_attention_lse`` and ``Trainer`` are also
reachable from the package itself.

Import discipline: nothing here imports torch at package scope, so the
package is cheap to import in processes that never touch a device.
"""

__version__ = "0.1.0"

#: package attribute -> (module, name), imported at first access
_EXPORTS = {
    "flash_attention": ("ops.flash_attention", "flash_attention"),
    "flash_attention_lse": ("ops.flash_attention", "flash_attention_lse"),
    "Trainer": ("training", "Trainer"),
}


def __getattr__(name):
    """Lazy submodule access (``tensorflowonspark_tpu_torch.serving``
    etc.) and the exports above, without importing torch at
    package-import time."""
    import importlib

    if name.startswith("_"):
        raise AttributeError(name)
    if name in _EXPORTS:
        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(
            "tensorflowonspark_tpu_torch." + module), attr)
    try:
        return importlib.import_module("tensorflowonspark_tpu_torch." + name)
    except ModuleNotFoundError:
        raise AttributeError(name)

"""Model export/load — the SavedModel analog; the port of
``tensorflowonspark_tpu/export.py``.

Reference: chief-only ``compat.export_saved_model`` / TF SavedModel
consumed by ``pipeline.TFModel._transform`` (SURVEY.md §2 "TF1/TF2 compat
shims", §3.4). The port's exchange format is a directory::

    export_dir/
      meta.json        {"format": "tfos-torch-export-v1", "signature": {...}}
      apply_fn.pkl     (variables, batch) -> outputs, pickled by value
                       with engine/serializer.py
      variables.pt     the variables (a state_dict), torch.save

The JAX package writes ``tfos-tpu-export-v1`` (an orbax checkpoint and a
cloudpickled JAX function); its pickle needs JAX, so :func:`load_model`
refuses it with a ``ValueError`` that names both formats.

A module-backed ``apply_fn`` builds the module's skeleton (no weights
of its own: ``device="meta"``) and calls it on the loaded variables::

    def apply_fn(variables, batch):
        import torch
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
        skeleton = DecoderLM(vocab, hidden=768, num_heads=12,
                             num_layers=12, max_len=1024, device="meta")
        with torch.no_grad():
            logits = torch.func.functional_call(skeleton, variables,
                                                (batch["x"],))
        return {"next_token": logits[:, -1].argmax(-1)}

Loading is cached per process keyed on the directory (the reference's
``pipeline._run_model`` global-singleton trick) and the device, so
Spark-style repeated partition tasks reuse the loaded model.

Nothing is left out: both functions of the reference are here.
"""

import json
import logging
import os
import threading

logger = logging.getLogger(__name__)

_FORMAT = "tfos-torch-export-v1"
#: the JAX package's format tag, recognised only to refuse it clearly
_JAX_FORMAT = "tfos-tpu-export-v1"
_CACHE = {}
_CACHE_LOCK = threading.Lock()


def save_model(export_dir, apply_fn, variables, signature=None):
    """Write an export the pipeline's TFModel can serve.

    Args:
      export_dir: target directory (created; must not exist).
      apply_fn: ``(variables, batch_dict) -> outputs`` — pickled by value
        with the port's serializer, so a closure defined in ``__main__``
        or nested in a function ships; a module-level function of an
        importable module ships by reference.
      variables: ``{name: tensor}`` (e.g. ``model.state_dict()``); saved
        on the host.
      signature: optional {"inputs": [...], "outputs": [...]} column names,
        the SignatureDef analog used by default input/output mappings.
    """
    import torch

    from tensorflowonspark_tpu_torch import fs
    from tensorflowonspark_tpu_torch.engine import serializer

    export_dir = fs.require_local(export_dir, "model export")
    os.makedirs(export_dir, exist_ok=False)
    host = {k: v.detach().cpu() for k, v in variables.items()}
    torch.save(host, os.path.join(export_dir, "variables.pt"))
    with open(os.path.join(export_dir, "apply_fn.pkl"), "wb") as f:
        f.write(serializer.dumps(apply_fn))
    with open(os.path.join(export_dir, "meta.json"), "w") as f:
        json.dump({"format": _FORMAT, "signature": signature or {}}, f)
    logger.info("exported model to %s", export_dir)


def load_model(export_dir, cache=True, device=None):
    """(apply_fn, variables, signature) — cached per process.

    ``device`` is :func:`device_info.default_device`'s argument: the
    variables load onto the card unless ``"cpu"`` is asked for
    (``torch.load(weights_only=True, map_location=device)``).

    Reference: ``pipeline._run_model``'s args-keyed cached SavedModel load.
    """
    from tensorflowonspark_tpu_torch import device_info, fs

    export_dir = fs.require_local(export_dir, "model load")
    device = device_info.default_device(device)
    key = (os.path.abspath(export_dir), str(device))
    with _CACHE_LOCK:
        if cache and key in _CACHE:
            return _CACHE[key]
    import torch

    from tensorflowonspark_tpu_torch.engine import serializer

    with open(os.path.join(export_dir, "meta.json")) as f:
        meta = json.load(f)
    fmt = meta.get("format")
    if fmt != _FORMAT:
        raise ValueError(
            "not a {} export: {} holds {!r}{}".format(
                _FORMAT, export_dir, fmt,
                " (the JAX package's format; load it with "
                "tensorflowonspark_tpu.export)" if fmt == _JAX_FORMAT
                else ""))
    with open(os.path.join(export_dir, "apply_fn.pkl"), "rb") as f:
        apply_fn = serializer.loads(f.read())
    variables = torch.load(os.path.join(export_dir, "variables.pt"),
                           weights_only=True, map_location=device)
    result = (apply_fn, variables, meta.get("signature", {}))
    with _CACHE_LOCK:
        if cache:
            _CACHE[key] = result
    return result

"""CUDA device discovery — the port's counterpart of ``device_info``.

Reference: ``tensorflowonspark/gpu_info.py`` (parse ``nvidia-smi``,
honour ``CUDA_VISIBLE_DEVICES``). The port's entry points run on the
card unless the caller asks for the CPU: :func:`default_device` raises
when no card is present and ``"cpu"`` was not requested, so nothing
carries on quietly on the CPU.
"""

import os
import subprocess


def get_devices(num_devices=None):
    """Local CUDA device ids as strings (``CUDA_VISIBLE_DEVICES`` order
    when set, else ``0..device_count-1``). Raises when fewer than
    ``num_devices`` are visible."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [v.strip() for v in visible.split(",") if v.strip()][:count]
    else:
        ids = [str(i) for i in range(count)]
    if num_devices is not None and len(ids) < num_devices:
        raise RuntimeError(
            "requested {} local CUDA devices, found {}".format(
                num_devices, len(ids)))
    return ids


def default_device(device=None):
    """The ``torch.device`` an entry point runs on: ``device`` when
    given (a CUDA request without a card raises), else ``cuda:0``.
    With no card and no explicit ``"cpu"`` this raises."""
    import torch

    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device {} requested but torch sees no CUDA device".format(
                    device))
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def describe():
    """The card's name and power limit, one line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (raises when ``nvidia-smi`` is missing or fails)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()

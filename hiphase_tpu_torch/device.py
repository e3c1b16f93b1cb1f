"""Explicit device resolution for the device engine.

The engine's device is always named: a caller passes a ``torch.device``, or
asks for CUDA and gets an error when no CUDA device is present. Nothing
here falls back to the CPU on its own; the CPU runs the plain versions of
the kernels only when a caller passes ``torch.device("cpu")``.
"""

from __future__ import annotations

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device is not present on this machine."""


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device the engine runs on. ``None`` means CUDA device 0."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "the cuda engine needs a CUDA device, and "
                "torch.cuda.is_available() is False on this machine")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceUnavailableError(f"unsupported device type {dev.type!r}")
    return dev

"""Explicit device resolution for the device engine.

The engine's device is always named: a caller passes a ``torch.device``
(or a list of them), or asks for CUDA and gets an error when no CUDA device
is present. Nothing here falls back to the CPU on its own; the CPU runs the
plain versions of the kernels only when a caller passes
``torch.device("cpu")``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device is not present on this machine."""


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device the engine runs on. ``None`` means CUDA device 0."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        _require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceUnavailableError(f"unsupported device type {dev.type!r}")
    return dev


def resolve_devices(device: torch.device | str | Sequence | None = None
                    ) -> tuple[torch.device, ...]:
    """The devices a batch is split over, one contiguous row chunk each.

    ``None`` means every CUDA device of this host (``cuda:0`` …
    ``cuda:{device_count() - 1}``); one device means that device alone; a
    list may repeat a device (``[cpu] * 3``, ``[cuda:0, cuda:0]``), and
    each entry is one chunk. The entries must all be CUDA devices or all
    the CPU."""
    if device is None:
        _require_cuda()
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if isinstance(device, (torch.device, str)):
        return (resolve_device(device),)
    devs = tuple(resolve_device(d) for d in device)
    if not devs:
        raise ValueError("an empty list of devices")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices of more than one type: {devs}")
    return devs


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "the cuda engine needs a CUDA device, and "
            "torch.cuda.is_available() is False on this machine")

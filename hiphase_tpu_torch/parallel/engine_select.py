"""Engine selection for the torch port.

``--engine auto`` resolves once, before the run, from what the machine
has: the device engine when a CUDA device is present, else the native C++
beam when its library loads, else the host A* oracle. The choice is logged
and holds for the whole run; a device error ends the run instead of
switching engines. Choosing by measured rates is not ported yet.
"""

from __future__ import annotations

import logging

import torch

from hiphase_tpu_torch.io import native

logger = logging.getLogger(__name__)

ENGINES = ("auto", "cuda", "native", "astar")


def choose_engine(requested: str) -> str:
    """Resolve the --engine flag."""
    if requested != "auto":
        return requested
    if torch.cuda.is_available():
        engine, why = "cuda", f"CUDA device {torch.cuda.get_device_name(0)!r}"
    elif native.available():
        engine, why = "native", "no CUDA device; native library loaded"
    else:
        engine, why = "astar", "no CUDA device and no native library"
    logger.info("Engine 'auto' resolved to %r (%s)", engine, why)
    return engine

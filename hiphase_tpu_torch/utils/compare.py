"""Phasing results as plain Python values, for exact comparison across
devices and across packages (each package has its own dataclasses)."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


def plain_values(x):
    """A phasing result as plain Python values: dataclasses as (class name,
    fields), enums by value, numpy values as lists and ints."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: plain_values(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [plain_values(v) for v in x]
    if isinstance(x, dict):
        return {k: plain_values(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x

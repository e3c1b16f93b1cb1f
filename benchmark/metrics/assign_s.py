"""Host prepare, dual mode on the device WFA: pass 2, the allele assignment of every read from its band-ladder result (the host aligner for uncertified reads), seconds a job summed over the prepare threads; span prepare.assign."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("prepare.assign",))

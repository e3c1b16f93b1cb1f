"""Host prepare: loading the block's variants (phasing/phaser.py prepare_block: load_variant_calls and the tandem-repeat marks), seconds a job summed over the prepare threads; span prepare.variants."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("prepare.variants",))

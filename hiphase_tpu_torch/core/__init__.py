from hiphase_tpu_torch.core.variants import (
    AlleleType,
    Variant,
    VariantError,
    VariantType,
    Zygosity,
)
from hiphase_tpu_torch.core.read_segments import ReadSegment, collapse_read_segments
from hiphase_tpu_torch.core.reference_genome import ReferenceGenome

__all__ = [
    "AlleleType",
    "Variant",
    "VariantError",
    "VariantType",
    "Zygosity",
    "ReadSegment",
    "collapse_read_segments",
    "ReferenceGenome",
]

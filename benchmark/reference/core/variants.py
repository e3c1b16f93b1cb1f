"""Variant data model.

Re-designs the reference's variant types (ref: src/data_types/variants.rs,
src/data_types/read_segments.rs:5-16) for the TPU build. The semantics —
validating constructors per variant type, two materialized alleles with
original VCF indices, reference-context extension for realignment, and
exact/inexact allele matching — are behavior-parity requirements; the
representation here is plain Python objects that are later tensorized into
dense per-block arrays for the device kernels.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from reference.align.edit_distance import edit_distance

# Sentinel written to VCF for ambiguous / TR-overlap alleles
# (ref: variants.rs:649-661 uses u8::MAX).
UNDETERMINED_ALLELE = 255


class VariantType(enum.IntEnum):
    """Variant classes. Numeric order is load-bearing: per-type stats arrays
    are indexed by value (ref: variants.rs:9-33, read_parsing.rs:129-133)."""

    SNV = 0
    INSERTION = 1
    DELETION = 2
    INDEL = 3
    SV_INSERTION = 4
    SV_DELETION = 5
    SV_DUPLICATION = 6
    SV_INVERSION = 7
    SV_BREAKEND = 8
    TANDEM_REPEAT = 9
    UNKNOWN = 10  # must stay last


class Zygosity(enum.IntEnum):
    """(ref: variants.rs:36-42)"""

    HOMOZYGOUS_REFERENCE = 0
    HETEROZYGOUS = 1
    HOMOZYGOUS_ALTERNATE = 2
    UNKNOWN = 3  # must stay last


class AlleleType(enum.IntEnum):
    """Observed allele call for one read at one variant
    (ref: read_segments.rs:5-16). An allele is "set" iff < AMBIGUOUS."""

    REFERENCE = 0
    ALTERNATE = 1
    AMBIGUOUS = 2
    NO_OVERLAP = 3


class VariantError(ValueError):
    """Raised by Variant constructors on malformed allele combinations
    (ref: variants.rs:44-62)."""


@dataclass
class Variant:
    """One (het-normalized) variant: exactly two materialized alleles.

    Multi-allelic sites only materialize the two genotyped alleles;
    ``index_allele0/1`` remember the original VCF allele indices
    (ref: variants.rs:64-94).

    ``position`` is 0-based; ``prefix_len``/``postfix_len`` track reference
    context added around the alleles for inexact matching
    (ref: variants.rs:497-539).
    """

    vcf_index: int
    variant_type: VariantType
    position: int
    ref_len: int
    allele0: bytes
    allele1: bytes
    index_allele0: int
    index_allele1: int
    prefix_len: int = 0
    postfix_len: int = 0
    is_ignored: bool = field(default=False)

    # ---- validating constructors (ref: variants.rs:109-492) ----

    @staticmethod
    def _check_order(index_allele0: int, index_allele1: int) -> None:
        if index_allele0 >= index_allele1:
            raise VariantError("index_allele0 must be < index_allele1")

    @classmethod
    def new_snv(cls, vcf_index, position, allele0, allele1,
                index_allele0, index_allele1):
        """(ref: variants.rs:109-136) — all alleles length 1."""
        cls._check_order(index_allele0, index_allele1)
        if len(allele0) != 1:
            raise VariantError("allele0 must be length 1")
        if len(allele1) != 1:
            raise VariantError("allele1 must be length 1")
        return cls(vcf_index, VariantType.SNV, position, 1,
                   bytes(allele0), bytes(allele1), index_allele0, index_allele1)

    @classmethod
    def new_deletion(cls, vcf_index, position, ref_len, allele0, allele1,
                     index_allele0, index_allele1):
        """(ref: variants.rs:152-201) — REF len > 1, ALT len 1."""
        cls._check_order(index_allele0, index_allele1)
        if ref_len <= 1:
            raise VariantError("reference must have length > 1")
        if index_allele0 == 0:
            if len(allele0) != ref_len:
                raise VariantError("allele0 length must match ref_len")
        elif len(allele0) != 1:
            raise VariantError("allele0 must be length 1")
        if len(allele1) != 1:
            raise VariantError("allele1 must be length 1")
        return cls(vcf_index, VariantType.DELETION, position, ref_len,
                   bytes(allele0), bytes(allele1), index_allele0, index_allele1)

    @classmethod
    def new_insertion(cls, vcf_index, position, allele0, allele1,
                      index_allele0, index_allele1):
        """(ref: variants.rs:215-257) — REF len 1; ALTs non-empty
        (multi-allelics allow any non-empty length)."""
        cls._check_order(index_allele0, index_allele1)
        if index_allele0 == 0:
            if len(allele0) != 1:
                raise VariantError("allele0 must be length 1")
        elif len(allele0) == 0:
            raise VariantError("allele0 is empty")
        if len(allele1) == 0:
            raise VariantError("allele1 is empty")
        return cls(vcf_index, VariantType.INSERTION, position, 1,
                   bytes(allele0), bytes(allele1), index_allele0, index_allele1)

    @classmethod
    def new_indel(cls, vcf_index, position, ref_len, allele0, allele1,
                  index_allele0, index_allele1):
        """(ref: variants.rs:273-318) — REF len > 1, ALTs any non-empty."""
        cls._check_order(index_allele0, index_allele1)
        if ref_len <= 1:
            raise VariantError("reference must have length > 1")
        if index_allele0 == 0:
            if len(allele0) != ref_len:
                raise VariantError("allele0 length must match ref_len")
        elif len(allele0) == 0:
            raise VariantError("allele0 is empty")
        if len(allele1) == 0:
            raise VariantError("allele1 is empty")
        return cls(vcf_index, VariantType.INDEL, position, ref_len,
                   bytes(allele0), bytes(allele1), index_allele0, index_allele1)

    @classmethod
    def new_sv_deletion(cls, vcf_index, position, ref_len, allele0, allele1,
                        index_allele0, index_allele1):
        """(ref: variants.rs:334-381) — GT indices must be 0/1; ALT ≤ REF."""
        cls._check_order(index_allele0, index_allele1)
        if index_allele0 != 0 or index_allele1 != 1:
            raise VariantError("SvDeletion does not support multi-allelic sites")
        if len(allele0) != ref_len:
            raise VariantError("allele0 length must match ref_len")
        if len(allele1) > len(allele0):
            raise VariantError("SV deletion ALT length must be <= REF length")
        if len(allele1) == 0:
            raise VariantError("allele1 is empty")
        return cls(vcf_index, VariantType.SV_DELETION, position, ref_len,
                   bytes(allele0), bytes(allele1), index_allele0, index_allele1)

    @classmethod
    def new_sv_insertion(cls, vcf_index, position, ref_len, allele0, allele1,
                         index_allele0, index_allele1):
        """(ref: variants.rs:396-440) — GT indices must be 0/1; ALT ≥ REF."""
        cls._check_order(index_allele0, index_allele1)
        if index_allele0 != 0 or index_allele1 != 1:
            raise VariantError("SvInsertion does not support multi-allelic sites")
        if len(allele0) != ref_len:
            raise VariantError("allele0 length must match ref_len")
        if len(allele1) < len(allele0):
            raise VariantError("SV insertion ALT length must be >= REF length")
        if len(allele0) == 0:
            raise VariantError("allele0 is empty")
        return cls(vcf_index, VariantType.SV_INSERTION, position, ref_len,
                   bytes(allele0), bytes(allele1), index_allele0, index_allele1)

    @classmethod
    def new_tandem_repeat(cls, vcf_index, position, ref_len, allele0, allele1,
                          index_allele0, index_allele1):
        """(ref: variants.rs:456-492) — alleles non-empty; REF length must
        match when allele0 is the reference allele."""
        cls._check_order(index_allele0, index_allele1)
        if len(allele0) == 0:
            raise VariantError("allele0 is empty")
        if len(allele1) == 0:
            raise VariantError("allele1 is empty")
        if index_allele0 == 0 and len(allele0) != ref_len:
            raise VariantError("allele0 length must match ref_len")
        return cls(vcf_index, VariantType.TANDEM_REPEAT, position, ref_len,
                   bytes(allele0), bytes(allele1), index_allele0, index_allele1)

    # ---- reference-context extension (ref: variants.rs:497-539) ----

    def add_reference_prefix(self, prefix: bytes) -> None:
        assert len(prefix) <= self.position - self.prefix_len
        self.allele0 = bytes(prefix) + self.allele0
        self.allele1 = bytes(prefix) + self.allele1
        self.prefix_len += len(prefix)

    def add_reference_postfix(self, postfix: bytes) -> None:
        self.allele0 = self.allele0 + bytes(postfix)
        self.allele1 = self.allele1 + bytes(postfix)
        self.postfix_len += len(postfix)

    def truncate_reference_postfix(self, amount: int) -> None:
        assert amount <= self.postfix_len
        if amount:
            self.allele0 = self.allele0[:-amount]
            self.allele1 = self.allele1[:-amount]
            self.postfix_len -= amount

    def get_truncated_allele0(self) -> bytes:
        end = len(self.allele0) - self.postfix_len
        return self.allele0[self.prefix_len:end]

    def get_truncated_allele1(self) -> bytes:
        end = len(self.allele1) - self.postfix_len
        return self.allele1[self.prefix_len:end]

    # ---- allele matching (ref: variants.rs:598-661) ----

    def match_allele(self, allele: bytes) -> int:
        """Exact match → 0/1, else 2."""
        if allele == self.allele0:
            return 0
        if allele == self.allele1:
            return 1
        return 2

    def closest_allele(self, allele: bytes):
        return self.closest_allele_clip(allele, 0, 0)

    def closest_allele_clip(self, allele: bytes, head_clip: int, tail_clip: int):
        """Nearest allele by edit distance; ties → AMBIGUOUS.

        Returns (AlleleType, min_ed, other_ed) (ref: variants.rs:624-641).
        """
        assert head_clip <= self.prefix_len
        assert tail_clip <= self.postfix_len
        d0 = edit_distance(allele, self.allele0[head_clip:len(self.allele0) - tail_clip])
        d1 = edit_distance(allele, self.allele1[head_clip:len(self.allele1) - tail_clip])
        if d0 < d1:
            return (AlleleType.REFERENCE, d0, d1)
        if d1 < d0:
            return (AlleleType.ALTERNATE, d1, d0)
        return (AlleleType.AMBIGUOUS, d0, d1)

    def convert_index(self, index: AlleleType) -> int:
        """Map internal 0/1/2 back to original VCF allele indices
        (ref: variants.rs:649-661)."""
        if index == AlleleType.REFERENCE:
            return self.index_allele0
        if index == AlleleType.ALTERNATE:
            return self.index_allele1
        if index == AlleleType.AMBIGUOUS:
            return UNDETERMINED_ALLELE
        raise ValueError("index must be Reference, Alternate, or Ambiguous")

    def set_ignored(self) -> None:
        self.is_ignored = True

"""The ordered VCF writer's rewrite of one record: a frozen copy of
``transform_record`` and ``_unphase_sort_gt`` from the program's
``writers/vcf_writer.py`` (ref: ordered_vcf_writer.rs:291-434)."""

from __future__ import annotations

from reference.core.variants import UNDETERMINED_ALLELE  # noqa: F401
from reference.io.vcf import MISSING


class VcfWriteError(Exception):
    pass


def _unphase_sort_gt(gt: bytes) -> bytes:
    """Unphase and sort one GT value (missing first), single pass."""
    if b"|" in gt:
        parts = gt.replace(b"|", b"/").split(b"/")
    else:
        parts = gt.split(b"/")
    if len(parts) == 1:
        return parts[0]
    if len(parts) != 2:
        raise VcfWriteError(f"Encountered GT of length {len(parts)}")
    a, b = parts
    ka = -1 if a in (b".", b"") else int(a)
    kb = -1 if b in (b".", b"") else int(b)
    if kb < ka:
        a, b = b, a
    return a + b"/" + b


def transform_record(record: VcfRecord, phased: dict[int, tuple[int, int, int]],
                     flagged: dict[int, bytes]) -> None:
    """Fused strip + rewrite: one split/join per sample column.

    Equivalent to strip_record_phasing + per-sample set_genotype/PS/PF
    (ref: ordered_vcf_writer.rs:291-434), but single-pass for throughput.
    """
    keys = record.fields[8].split(b":") if len(record.fields) > 8 else []
    drop = [i for i, k in enumerate(keys) if k in (b"PS", b"PF")]
    new_keys = [k for k in keys if k not in (b"PS", b"PF")]
    try:
        gt_idx = new_keys.index(b"GT")
    except ValueError:
        raise VcfWriteError("record has no GT FORMAT field")
    add_ps = bool(phased)
    add_pf = bool(flagged)
    if add_ps:
        new_keys.append(b"PS")
    if add_pf:
        new_keys.append(b"PF")
    record.fields[8] = b":".join(new_keys)
    n_base = len(new_keys) - add_ps - add_pf

    for si in range(len(record.fields) - 9):
        vals = record.fields[9 + si].split(b":")
        if drop:
            vals = [v for i, v in enumerate(vals) if i not in drop]
        if gt_idx < len(vals):
            if not vals[gt_idx]:
                raise VcfWriteError(
                    f"Encountered empty genotype record at position "
                    f"{record.pos0}")
            upd = phased.get(si)
            if upd is not None:
                h1, h2, _block = upd
                vals[gt_idx] = b"%d|%d" % (h1, h2)
            else:
                vals[gt_idx] = _unphase_sort_gt(vals[gt_idx])
        if add_ps or add_pf:
            # pad trailing-dropped fields only when appending new tags
            # (matches the incremental set_sample_field behavior)
            while len(vals) < n_base:
                vals.append(MISSING)
        if add_ps:
            upd = phased.get(si)
            vals.append(str(upd[2]).encode() if upd is not None else MISSING)
        if add_pf:
            vals.append(flagged.get(si, MISSING))
        record.fields[9 + si] = b":".join(vals)
    record._fmt_cache = None

"""Ordered phased-VCF writer (ref: src/writers/ordered_vcf_writer.rs).

Streams every input VCF record through a copy-transform: strip pre-existing
phasing (PS/PF removed, GT unphased + sorted), then rewrite GT to ``h1|h2``
with a PS tag for variants the solver phased. Out-of-order block results are
held in a map and drained in block-index order, with per-sample watermarks
so multi-sample runs interleave correctly.
"""

from __future__ import annotations

import logging

from hiphase_tpu_torch.core.variants import UNDETERMINED_ALLELE
from collections import deque

from hiphase_tpu_torch.io.vcf import MISSING, VcfHeader, VcfReader, VcfRecord, VcfWriter
from hiphase_tpu_torch.phasing.block_gen import is_phasable_variant

logger = logging.getLogger(__name__)

U64_MAX = 2**63 - 1


class VcfWriteError(Exception):
    pass


def strip_record_phasing(record: VcfRecord) -> None:
    """Remove PS/PF and unphase+sort every sample's GT
    (ref: ordered_vcf_writer.rs:444-480)."""
    record.strip_format_tag("PS")
    record.strip_format_tag("PF")
    num_samples = max(len(record.fields) - 9, 0)
    for si in range(num_samples):
        alleles, _phased = record.genotype(si)
        if not alleles:
            raise VcfWriteError(
                f"Encountered empty genotype record at position {record.pos0}")
        if len(alleles) == 1:
            record.set_genotype(si, alleles, phased=False)
        elif len(alleles) == 2:
            a0, a1 = alleles
            # missing sorts first like htslib's int encoding of '.'
            key = lambda a: -1 if a is None else a
            lo, hi = sorted((a0, a1), key=key)
            record.set_genotype(si, [lo, hi], phased=False)
        else:
            raise VcfWriteError(
                f"Encountered GT of length {len(alleles)} at {record.chrom}:"
                f"{record.pos0 + 1}")


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


class OrderedVcfWriter:
    """In-order merge of out-of-order phase results into output VCFs."""

    def __init__(self, input_vcfs: list[str], output_vcfs: list[str],
                 min_quality: int, sample_names: list[str],
                 program_version: str = "", command_line: str = "",
                 csi: bool = False, io_threads: int = 4):
        assert len(input_vcfs) == len(output_vcfs)
        self.input_vcfs = input_vcfs
        self.output_paths = output_vcfs
        self.min_quality = min_quality
        self.sample_names = list(sample_names)
        self.readers = [VcfReader(p) for p in input_vcfs]
        self.sample_indices: list[dict[str, int]] = []
        # per (vcf, sample): queue of (h1, h2, block_id) in variant order
        self.phase_queues: list[dict[str, list[tuple[int, int, int]]]] = []
        self.writers: list[VcfWriter] = []
        for path, out_path, rd in zip(input_vcfs, output_vcfs, self.readers):
            lookup = {}
            queues = {}
            for s in sample_names:
                if s not in rd.samples:
                    raise VcfWriteError(
                        f"Sample name {s!r} was not found in VCF: {path}")
                lookup[s] = rd.samples.index(s)
                queues[s] = deque()
            self.sample_indices.append(lookup)
            self.phase_queues.append(queues)

            # output header: template minus PS/PF defs, plus provenance and
            # fresh PS/PF definitions (ref: ordered_vcf_writer.rs:100-118)
            header = VcfHeader(list(rd.header.lines), list(rd.samples))
            header.remove_format("PS")
            header.remove_format("PF")
            header.add_line(f'##hiphase_tpu_version="{program_version}"')
            header.add_line(f'##hiphase_tpu_command="{command_line}"')
            header.add_line('##FORMAT=<ID=PS,Number=1,Type=Integer,'
                            'Description="Phase set identifier">')
            header.add_line('##FORMAT=<ID=PF,Number=1,Type=String,'
                            'Description="Phasing flag">')
            self.writers.append(VcfWriter(out_path, header, csi=csi,
                                          io_threads=io_threads))

        self.map_store: dict[int, object] = {}
        self.current_index = 0
        self.current_chrom = ""
        self.current_pos = 0
        self.current_positions = {s: 0 for s in sample_names}

    def get_wait_block(self) -> int:
        return self.current_index

    def write_phase_block(self, phase_result) -> None:
        block_index = phase_result.phase_block.block_index
        if block_index < self.current_index:
            raise VcfWriteError("Block index is smaller than next expected index")
        if block_index in self.map_store:
            raise VcfWriteError("Block index was already present in the map_store")
        self.map_store[block_index] = phase_result
        self._drain_map_store()

    def _drain_map_store(self) -> None:
        while self.map_store:
            phase_result = self.map_store.pop(self.current_index, None)
            if phase_result is None:
                break
            chrom_result = phase_result.phase_block.chrom
            if chrom_result != self.current_chrom:
                if self.current_index == 0:
                    self.current_chrom = chrom_result
                else:
                    self.write_to_end_position()
                    self.current_chrom = chrom_result
                    self.current_pos = 0
                    for k in self.current_positions:
                        self.current_positions[k] = 0

            sample_name = phase_result.phase_block.sample_name
            for vcf_index, queues in enumerate(self.phase_queues):
                sample_queue = queues[sample_name]
                for i, h1_allele in enumerate(phase_result.haplotype_1):
                    variant = phase_result.variants[i]
                    if vcf_index != variant.vcf_index:
                        continue
                    h1 = variant.convert_index(h1_allele)
                    h2 = variant.convert_index(phase_result.haplotype_2[i])
                    block_id = phase_result.block_ids[i] + 1  # 1-based PS
                    sample_queue.append((h1, h2, block_id))

            self.current_positions[sample_name] = phase_result.phase_block.end
            self._write_to_min_position()
            self.current_index += 1

    def write_to_end_position(self) -> None:
        self._write_to_position(U64_MAX)
        for queues in self.phase_queues:
            for sample_name, queue in queues.items():
                if queue:
                    raise VcfWriteError(
                        "Finished writing chromosome, but variant queues are "
                        "not empty")

    def _write_to_min_position(self) -> None:
        self._write_to_position(min(self.current_positions.values()))

    def _write_to_position(self, final_position: int) -> None:
        """Copy-transform records in [current_pos, final_position] (inclusive)
        (ref: ordered_vcf_writer.rs:291-434)."""
        if self.current_pos == final_position:
            return
        start_pos = self.current_pos
        fetch_end = final_position + 1 if final_position < U64_MAX else U64_MAX
        for vcf_index, writer in enumerate(self.writers):
            if self._write_window_arrays(vcf_index, writer, start_pos,
                                         final_position):
                continue
            reader = self.readers[vcf_index]
            for record in reader.fetch(self.current_chrom, start_pos, fetch_end):
                record_pos = record.pos0
                if record_pos < start_pos:
                    continue  # long indel overlapping a previous window
                if record_pos > final_position:
                    break
                vcf_sample_indices = self.sample_indices[vcf_index]
                phased: dict[int, tuple[int, int, int]] = {}
                flagged: dict[int, bytes] = {}

                for sample_name, sample_index in vcf_sample_indices.items():
                    if not is_phasable_variant(record, sample_index,
                                               self.min_quality, False):
                        continue
                    queue = self.phase_queues[vcf_index][sample_name]
                    if not queue:
                        raise VcfWriteError(
                            "Variant requested from empty queue during VCF "
                            "writing")
                    h1, h2, block_id = queue.popleft()
                    if h1 == h2:
                        # hom conversion is not written through; flag only
                        # intentionally-ignored variants (TR overlap)
                        if h1 == UNDETERMINED_ALLELE:
                            flagged[sample_index] = b"TR_OVERLAP"
                    else:
                        phased[sample_index] = (h1, h2, block_id)

                transform_record(record, phased, flagged)
                writer.write(record)
        self.current_pos = (final_position if final_position == U64_MAX
                            else final_position + 1)

    def _write_window_arrays(self, vcf_index: int, writer, start_pos: int,
                             final_position: int) -> bool:
        """Array path for one (vcf, window): decisions from the native chrom
        scan, bulk strip+rewrite via hn_vcf_transform, raw batched write.
        Returns False (before any state mutation) to use the record path."""
        import numpy as np

        from hiphase_tpu_torch.io import native
        from hiphase_tpu_torch.io.vcf_scan import scan_chrom

        if not self.current_chrom or not native.available():
            return False
        reader = self.readers[vcf_index]
        S = len(reader.samples)
        scan = scan_chrom(self.input_vcfs[vcf_index], self.current_chrom, S)
        if scan is None:
            return False
        lo = int(np.searchsorted(scan.pos, start_pos, "left"))
        hi = len(scan.pos) if final_position >= U64_MAX else \
            int(np.searchsorted(scan.pos, final_position, "right"))
        if hi <= lo:
            return True
        sample_items = list(self.sample_indices[vcf_index].items())
        masks = {}
        for sample_name, sidx in sample_items:
            # any row the native parser couldn't classify for a tracked
            # sample -> record path (identical errors)
            if np.any(scan.vtype[lo:hi] == -1) or \
                    np.any(scan.zyg[lo:hi, sidx] == -1):
                return False
            masks[sample_name] = scan.phasable_mask(sidx, self.min_quality,
                                                    False)
        k = hi - lo
        mode = np.zeros((k, S), dtype=np.uint8)
        h1a = np.zeros((k, S), dtype=np.uint8)
        h2a = np.zeros((k, S), dtype=np.uint8)
        psa = np.zeros((k, S), dtype=np.int64)
        for r in range(lo, hi):
            for sample_name, sidx in sample_items:
                if not masks[sample_name][r]:
                    continue
                queue = self.phase_queues[vcf_index][sample_name]
                if not queue:
                    raise VcfWriteError(
                        "Variant requested from empty queue during VCF "
                        "writing")
                h1, h2, block_id = queue.popleft()
                if h1 == h2:
                    if h1 == UNDETERMINED_ALLELE:
                        mode[r - lo, sidx] = 2
                else:
                    mode[r - lo, sidx] = 1
                    h1a[r - lo, sidx] = h1
                    h2a[r - lo, sidx] = h2
                    psa[r - lo, sidx] = block_id
        out = native.vcf_transform_batch(
            scan.text, scan.line_off[lo:hi], scan.line_len[lo:hi], S,
            mode, h1a, h2a, psa)
        if out is None or bool(out[2].any()):
            # native transform declined a line (odd sample column, ploidy
            # error, ...): redo the whole window per-record in Python using
            # the SAME decisions (queues already popped)
            self._write_window_python(vcf_index, writer, lo, hi, scan,
                                      mode, h1a, h2a, psa)
            return True
        data, out_off, _err = out
        poss = scan.pos[lo:hi]
        ends = poss + np.maximum(scan.ref_len[lo:hi], 1)
        writer.write_raw_lines(data.tobytes(), out_off, poss, ends,
                               self.current_chrom)
        return True

    def _write_window_python(self, vcf_index, writer, lo, hi, scan,
                             mode, h1a, h2a, psa) -> None:
        for r in range(lo, hi):
            record = scan.record(r)
            phased = {}
            flagged = {}
            for s in range(mode.shape[1]):
                m = mode[r - lo, s]
                if m == 1:
                    phased[s] = (int(h1a[r - lo, s]), int(h2a[r - lo, s]),
                                 int(psa[r - lo, s]))
                elif m == 2:
                    flagged[s] = b"TR_OVERLAP"
            transform_record(record, phased, flagged)
            writer.write(record)

    def close(self) -> None:
        for w in self.writers:
            w.close()

    def write_indexes(self) -> None:
        for w in self.writers:
            w.write_index()

"""Ordered haplotagged-BAM writer (ref: src/writers/ordered_bam_writer.rs).

Same in-order drain pattern as the VCF writer, one writer per sample. Blocks
belonging to other samples advance the index via ``write_dummy_block``.
Records are copied with HP/PS aux tags stripped and re-added from the
block's haplotag result (PS = block_id + 1 as i32, HP = haplotag + 1 as u8).
"""

from __future__ import annotations

import logging

from hiphase_tpu_torch.io.bam import BamWriter, open_alignment

logger = logging.getLogger(__name__)


class BamWriteError(Exception):
    pass


class OrderedBamWriter:
    def __init__(self, sample_name: str, input_bams: list[str],
                 output_bams: list[str], program_version: str = "",
                 command_line: str = "", io_threads: int = 4):
        assert len(input_bams) == len(output_bams)
        self.sample_name = sample_name
        self.readers = [open_alignment(p) for p in input_bams]
        self.writers = []
        for rd, out_path in zip(self.readers, output_bams):
            header = rd.header.with_pg_line(
                f"hiphase-tpu-v{program_version}", "hiphase-tpu",
                program_version, command_line)
            if out_path.endswith(".cram"):
                # CRAM output by extension (ref: ordered_bam_writer.rs:76-80)
                from hiphase_tpu_torch.io.bam import _CRAM_REFERENCE
                from hiphase_tpu_torch.io.cram import CramError, CramWriter
                if _CRAM_REFERENCE is None:
                    raise CramError("CRAM output requires the reference "
                                    "genome (--reference)")
                self.writers.append(CramWriter(out_path, header,
                                               _CRAM_REFERENCE,
                                               io_threads=io_threads))
            else:
                # level 4: haplotagged BAMs are bulk throughput outputs and
                # deflate is the writer's dominant CPU line; libdeflate-4 is
                # ~1.6x faster than 6 for ~8% larger output (any BGZF level
                # is a valid BAM — the reference doesn't pin one either)
                self.writers.append(BamWriter(out_path, header, level=4,
                                              io_threads=io_threads))
        self.map_store: dict[int, object] = {}
        self.skip_set: set[int] = set()
        self.current_index = 0
        self.current_chrom = ""
        self.current_pos = 0
        self.finished_chroms: set[str] = set()

    def get_wait_block(self) -> int:
        return self.current_index

    def write_phase_block(self, haplotag_result) -> None:
        block_index = haplotag_result.phase_block.block_index
        if block_index < self.current_index:
            raise BamWriteError("Block index is smaller than next expected index")
        if haplotag_result.phase_block.sample_name != self.sample_name:
            raise BamWriteError(
                "Received haplotag result for sample other than the one specified")
        if block_index in self.map_store:
            raise BamWriteError("Block index was already present in the map_store")
        self.map_store[block_index] = haplotag_result
        self._drain_map_store()

    def write_dummy_block(self, block_index: int) -> None:
        if block_index < self.current_index:
            raise BamWriteError("Block index is smaller than next expected index")
        self.skip_set.add(block_index)
        self._drain_map_store()

    def _drain_map_store(self) -> None:
        while True:
            haplotag_result = self.map_store.pop(self.current_index, None)
            if haplotag_result is None:
                if self.current_index in self.skip_set:
                    self.skip_set.remove(self.current_index)
                    self.current_index += 1
                    continue
                break
            chrom_result = haplotag_result.phase_block.chrom
            if chrom_result != self.current_chrom:
                if self.current_chrom:
                    self.finalize_chromosome()
                self.current_chrom = chrom_result
                self.current_pos = 0

            start_pos = self.current_pos
            end_pos = haplotag_result.phase_block.end
            lookup = haplotag_result.reads
            for reader, writer in zip(self.readers, self.writers):
                if self._write_window_native(reader, writer, chrom_result,
                                             start_pos, end_pos, lookup):
                    continue
                for record in reader.fetch(chrom_result, start_pos, end_pos + 1):
                    if record.pos < start_pos:
                        continue  # overlaps but started in a prior window
                    assert record.pos <= end_pos
                    record = record.strip_tags({"HP", "PS"})
                    tag = lookup.get(record.read_name)
                    if tag is not None:
                        phase_block_id, haplotag = tag
                        record = record.with_int_tags([
                            ("PS", phase_block_id + 1), ("HP", haplotag + 1)])
                    writer.write(record)

            self.current_pos = end_pos + 1
            self.current_index += 1

    # windowed native copy: strip+retag whole fetched ranges in C++
    # (hn_bam_retag) and write them in one batch; the per-record path above
    # remains for CRAM outputs and as the no-native fallback
    _NATIVE_WINDOW = 16 << 20  # bp per native sub-window (bounds raw memory)

    def _write_window_native(self, reader, writer, chrom, start_pos,
                             end_pos, lookup) -> bool:
        from hiphase_tpu_torch.io import native
        from hiphase_tpu_torch.io.bam import BamWriter
        import numpy as np
        if not isinstance(writer, BamWriter) or not native.available():
            return False
        if not hasattr(reader, "stream_raw_window"):
            return False
        tid = reader.tid(chrom)
        names = list(lookup.keys())
        tag_names = [n.encode() for n in names]
        tag_ps = np.fromiter((lookup[n][0] + 1 for n in names), np.int32,
                             len(names))
        tag_hp = np.fromiter((lookup[n][1] + 1 for n in names), np.uint8,
                             len(names))
        lo = start_pos
        while lo <= end_pos:
            hi = min(lo + self._NATIVE_WINDOW - 1, end_pos)
            chunks = reader.stream_raw_window(chrom, lo, hi)
            if chunks is None:
                return False
            for raw, rec_off, rec_size, pos, rend, flag in chunks:
                out = native.bam_retag(raw, rec_off, rec_size, tag_names,
                                       tag_ps, tag_hp)
                if out is None:
                    return False
                data, out_off = out
                writer.write_raw_records(data, out_off, tid, pos, rend, flag)
            lo = hi + 1
        return True

    def finalize_chromosome(self) -> None:
        """Copy the chromosome tail (ref: ordered_bam_writer.rs:263-303)."""
        assert self.current_chrom not in self.finished_chroms
        start_pos = self.current_pos
        for reader, writer in zip(self.readers, self.writers):
            tid = reader.tid(self.current_chrom)
            if tid < 0:
                continue
            end = reader.header.ref_lengths[tid]
            if self._write_window_native(reader, writer, self.current_chrom,
                                         start_pos, max(end, start_pos + 1),
                                         {}):
                self.current_pos = max(self.current_pos, end)
                continue
            for record in reader.fetch(self.current_chrom, start_pos, max(end, start_pos + 1)):
                if record.pos < start_pos:
                    continue
                writer.write(record.strip_tags({"HP", "PS"}))
                self.current_pos = max(self.current_pos, record.pos + 1)
        self.finished_chroms.add(self.current_chrom)

    def copy_remaining_chromosomes(self) -> None:
        """Copy untouched contigs and unplaced reads
        (ref: ordered_bam_writer.rs:305-355)."""
        for reader, writer in zip(self.readers, self.writers):
            for tid, name in enumerate(reader.header.ref_names):
                if name in self.finished_chroms:
                    continue
                length = reader.header.ref_lengths[tid]
                if self._write_window_native(reader, writer, name, 0,
                                             length, {}):
                    continue
                for record in reader.fetch(name, 0, length):
                    writer.write(record.strip_tags({"HP", "PS"}))
            if self._copy_unmapped_native(reader, writer):
                continue
            for record in reader.fetch_unmapped():
                writer.write(record.strip_tags({"HP", "PS"}))

    def _copy_unmapped_native(self, reader, writer) -> bool:
        from hiphase_tpu_torch.io import native
        from hiphase_tpu_torch.io.bam import BamWriter
        import numpy as np
        if not isinstance(writer, BamWriter) or not native.available():
            return False
        if not hasattr(reader, "fetch_unmapped_raw"):
            return False
        chunks = reader.fetch_unmapped_raw()
        if chunks is None:
            return False
        empty_ps = np.empty(0, dtype=np.int32)
        empty_hp = np.empty(0, dtype=np.uint8)
        for raw, rec_off, rec_size, pos, rend, flag in chunks:
            out = native.bam_retag(raw, rec_off, rec_size, [], empty_ps,
                                   empty_hp)
            if out is None:
                return False
            data, out_off = out
            writer.write_raw_records(data, out_off, -1, pos, rend, flag)
        return True

    def close(self) -> None:
        for w in self.writers:
            w.close()

    def write_indexes(self) -> None:
        for w in self.writers:
            w.write_index()

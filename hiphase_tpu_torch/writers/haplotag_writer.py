"""--haplotag-file TSV/CSV output (ref: src/writers/haplotag_writer.rs)."""

from __future__ import annotations

HAPLOTAG_COLUMNS = ["source_block_index", "sample_name", "chrom",
                    "phase_block_id", "read_name", "haplotag"]


class HaplotagWriter:
    def __init__(self, filename: str):
        self.delimiter = "," if filename.endswith(".csv") else "\t"
        self._fh = open(filename, "w")
        self._fh.write(self.delimiter.join(HAPLOTAG_COLUMNS) + "\n")

    def write_block(self, haplotag_result) -> None:
        pb = haplotag_result.phase_block
        for read_name, (phase_block_id, haplotag) in haplotag_result.reads.items():
            self._fh.write(self.delimiter.join(str(x) for x in [
                pb.block_index, pb.sample_name, pb.chrom,
                phase_block_id + 1, read_name, haplotag + 1]) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

"""The reference has no native host library: every caller of this module
takes its pure-Python path. Each entry point of the program's
``io/native.py`` that the frozen modules call is here, and says that no
library is loaded (``available()`` is False, every function gives None)."""

from __future__ import annotations

LOADED: dict = {"origin": None, "error": "the reference runs pure Python"}


def available() -> bool:
    return False


def _none(*_args, **_kwargs):
    return None


bam_scan_records = realign_block = bgzf_compress_blocks = _none
bgzf_decompress_all_arr = bgzf_decompress_all = _none
edit_distance_batch_native = wfa_batch = window_alleles = _none
wfa_align = wfa_build = beam_solve_batch_native = bam_span_scan_file = _none
vcf_transform_batch = rans_uncompress = bam_retag = _none

"""`BamReader.fetch_raw`, the native bulk region fetch, on the CPU.

Its contract: the same records, in the same order, as `fetch` followed by
`filter_out_alignment_record`. Each index chunk is inflated to the end of
the BGZF block that holds the chunk's end, so the records after that end
in the block must be left to the chunks they belong to. The BAM here is
built so that a region's chunks start in the block where the chunk before
them ends: spliced reads (one long N op) cross a 16 kb bin boundary into
the queried region, in the parent bin, and short reads of the bin before,
which the query leaves out, lie between them, all in BGZF blocks of a few
records.
"""

import numpy as np
import pytest

from hiphase_tpu_torch.io import bam as bam_mod
from hiphase_tpu_torch.io import bgzf, native
from hiphase_tpu_torch.phasing.block_gen import filter_out_alignment_record
from hiphase_tpu_torch.utils.simulate import make_read_raw

MIN_MAPQ = 5


def _records(rng):
    """(pos, raw) sorted by pos: short reads in [8,000, 24,000), spliced
    reads from [12,000, 16,300) spanning 6-7 kb, some with flags or MAPQ
    that the filter drops."""
    out = []
    for i, pos in enumerate(sorted(rng.integers(8_000, 24_000, 300))):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 120 + i % 7)
        out.append((int(pos), make_read_raw(
            b"s%d" % i, 0, int(pos), seq, [("M", len(seq))], 30, 0, b"")))
    for i, pos in enumerate(sorted(rng.integers(12_000, 16_300, 120))):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 61)
        flag = (0, 0, 0, 0x100, 0x400, 0x800)[i % 6]
        raw = make_read_raw(
            b"n%d" % i, 0, int(pos), seq,
            [("M", 30), ("N", int(rng.integers(6_000, 7_000))), ("M", 31)],
            30, flag, b"")
        if i % 7 == 3:
            raw = raw[:9] + bytes([MIN_MAPQ - 1]) + raw[10:]
        out.append((int(pos), raw))
    out.sort(key=lambda t: t[0])
    return out


@pytest.fixture(scope="module")
def shared_block_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bam") / "reads.bam")
    header = bam_mod.SamHeader("@HD\tVN:1.6\tSO:coordinate\n", ["chr1"],
                               [60_000])
    with pytest.MonkeyPatch.context() as mp:
        # blocks of 1 kb: a few records each
        mp.setattr(bgzf, "MAX_BLOCK_PAYLOAD", 1024)
        w = bam_mod.BamWriter(path, header, io_threads=1)
        for _pos, raw in _records(np.random.default_rng(20)):
            w.write(bam_mod.BamRecord.parse(raw))
        w.close()
        w.write_index()
    return path


REGIONS = [(s, s + w) for s in range(16_400, 24_000, 450)
           for w in (1, 300, 2_500)]


def test_fetch_raw_equals_fetch_and_filter(shared_block_bam):
    """On every region, fetch_raw returns exactly the records that fetch
    and filter_out_alignment_record return, in their order, and the test
    reaches chunks that start in the BGZF block where the chunk before them
    ends."""
    assert native.available()
    rd = bam_mod.BamReader(shared_block_bam)
    shared = 0
    for start, end in REGIONS:
        chunks = rd._index.query(0, start, end)
        shared += sum(cb >> 16 == prev_end >> 16
                      for (_pb, prev_end), (cb, _ce) in zip(chunks,
                                                            chunks[1:]))
        want = [r.raw for r in rd.fetch("chr1", start, end)
                if not filter_out_alignment_record(r, MIN_MAPQ)]
        got = [buf[o:o + n].tobytes()
               for buf, rec_off, rec_size in rd.fetch_raw("chr1", start, end,
                                                          MIN_MAPQ)
               for o, n in zip(rec_off.tolist(), rec_size.tolist())]
        assert got == want, (start, end)
    rd.close()
    assert shared > 20

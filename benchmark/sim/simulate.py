"""Fast vectorized WGS-scale dataset simulator for benchmarks.

A frozen copy of the program's ``utils/simulate.py``: the same draws from
the same seed give the same records. It writes through the frozen I/O
modules of ``reference/io`` and takes ``total_mb`` as any number of
megabases (whole ones give the original's contig lengths).

Generates a reference FASTA, a bgzipped+indexed VCF, and a coordinate-sorted
indexed BAM of HiFi-like reads — the input shape of the reference's published
baseline run (HG001 WGS, local-only mode; ref: docs/user_guide.md:60-82).

Realism model (matched to the reference's observed WGS structure,
ref: docs/user_guide.md:67-82 — ~1 phase block per 250 kb):
  * each contig is partitioned into *segments* (mean ``block_kb`` kb)
    separated by small coverage deserts: no variants fall in a desert and no
    read spans one, so each segment becomes roughly one phase block;
  * variant mix: het SNVs (~82%), 1–6 bp insertions/deletions (~8% each),
    occasional SV deletions (SVTYPE=DEL, 80–300 bp) and tandem repeats
    (TRID tag), plus hom-alt variants at ``hom_spacing``;
  * reads are sampled from the two truth haplotypes, so indel carriers get
    real M/I/D CIGARs (derived from the haplotype→reference coordinate map);
  * per-segment coverage multipliers (0.6–1.4×) and uniform mismatch
    sequencing errors (default 1%);
  * a fraction of desert boundaries are bridged by split reads (primary +
    supplementary with reciprocal SA tags), exercising supplemental joins
    (ref: block_gen.rs:722-799).

Unlike tests/sim.py (tiny adversarial cases) this generator is vectorized to
produce 100 Mb+ datasets in seconds.
"""

from __future__ import annotations

import struct

import numpy as np

from reference.io.bam import CIGAR_OPS, BamWriter, SamHeader, reg2bin
from reference.io.vcf import VcfHeader, VcfRecord, VcfWriter

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# base byte -> BAM 4-bit nibble (A=1 C=2 G=4 T=8, N=15)
_NIB = np.zeros(256, dtype=np.uint8)
_NIB[ord("A")] = 1
_NIB[ord("C")] = 2
_NIB[ord("G")] = 4
_NIB[ord("T")] = 8
_NIB[ord("N")] = 15


def pack_seq(seq: np.ndarray) -> bytes:
    """4-bit pack an ASCII base array (BAM §4.2.3)."""
    nib = _NIB[seq]
    if len(nib) % 2:
        nib = np.concatenate([nib, np.zeros(1, dtype=np.uint8)])
    return ((nib[0::2] << 4) | nib[1::2]).tobytes()


def _random_bases(rng, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, size=n)]


class SimVariants:
    """Struct-of-arrays variant table for one contig."""

    def __init__(self):
        self.pos: list[int] = []          # 0-based ref position
        self.ref: list[bytes] = []
        self.alt: list[bytes] = []
        self.is_het: list[bool] = []
        self.phase: list[int] = []        # hap carrying ALT (het only)
        self.info: list[bytes] = []       # INFO column

    def add(self, pos, ref, alt, is_het, phase, info=b"."):
        self.pos.append(pos)
        self.ref.append(ref)
        self.alt.append(alt)
        self.is_het.append(is_het)
        self.phase.append(phase)
        self.info.append(info)

    def __len__(self):
        return len(self.pos)


def stratified_segments(rng, length: int, block_kb: int,
                        desert_bp: int) -> list[tuple[int, int]]:
    """Segments whose lengths are the same for every seed: the quantiles
    at (i + 0.5) / n of the original's clipped Exp(block_kb), for the
    largest n that fits, stretched to tile the contig as the original's
    draws do (its last segment ends at the contig's end), with deserts of
    the original's mean width, in an order drawn from ``rng``."""
    lo, hi = 60_000, 4 * block_kb * 1000
    desert = (desert_bp // 2 + desert_bp * 2) // 2

    def lengths(n):
        q = (np.arange(n) + 0.5) / n
        return np.clip(-np.log1p(-q) * block_kb * 1000, lo, hi).astype(int)

    n = 1
    while (lengths(n + 1).sum() + n * desert) <= length:
        n += 1
    base = lengths(n)
    stretched = (base * ((length - (n - 1) * desert) / base.sum())).astype(int)
    segments, cursor = [], 0
    for seg_len in rng.permutation(stretched):
        seg_end = min(cursor + int(seg_len), length)
        segments.append((cursor, seg_end))
        cursor = seg_end + desert
    return segments


def stratified_coverages(segments) -> list[float]:
    """Per-segment coverage multipliers that are the same set for every
    seed: evenly spaced over the original's [0.6, 1.4], the k-th longest
    segment taking the k-th of them in a fixed interleaved order, so that
    the reads a dataset holds do not depend on the seed."""
    n = len(segments)
    levels = 0.6 + 0.8 * (np.arange(n) + 0.5) / n
    interleave = [levels[(i // 2) if i % 2 == 0 else n - 1 - i // 2]
                  for i in range(n)]
    by_length = np.argsort([-(e - s) for s, e in segments], kind="stable")
    out = [0.0] * n
    for rank, si in enumerate(by_length):
        out[si] = float(interleave[rank])
    return out


def simulate_contig(rng, length: int, het_spacing: int = 800,
                    hom_spacing: int = 2000, block_kb: int = 250,
                    desert_bp: int = 5000, sv_del_every: int = 500_000,
                    tr_every: int = 200_000, stratified: bool = False):
    """Random sequence + segment structure + mixed variants.

    Returns (seq uint8[L], SimVariants, segments) where segments is a list of
    (ref_start, ref_end) half-open intervals; deserts between segments carry
    no variants and no reads.
    """
    seq = _random_bases(rng, length)

    # segment partition: lengths ~ Exp(block_kb) clipped to [60kb, 4*block_kb]
    segments = []
    cursor = 0
    if stratified:
        segments = stratified_segments(rng, length, block_kb, desert_bp)
        cursor = length
    while cursor < length - 20_000:
        seg_len = int(np.clip(rng.exponential(block_kb * 1000),
                              60_000, 4 * block_kb * 1000))
        seg_end = min(cursor + seg_len, length)
        segments.append((cursor, seg_end))
        cursor = seg_end + int(rng.integers(desert_bp // 2, desert_bp * 2))
    if not segments:
        segments.append((0, length))

    variants = SimVariants()
    p_hom = het_spacing / (het_spacing + hom_spacing)
    mean_spacing = 1.0 / (1.0 / het_spacing + 1.0 / hom_spacing)
    sv_p = mean_spacing / sv_del_every
    tr_p = mean_spacing / tr_every

    for seg_start, seg_end in segments:
        pos = seg_start + 60
        while True:
            pos += max(int(rng.exponential(mean_spacing)), 10)
            if pos >= seg_end - 400:
                break
            r = rng.random()
            is_het = rng.random() >= p_hom
            phase = int(rng.integers(0, 2))
            if r < sv_p:
                # SV deletion, 80-300 bp, always het
                dlen = int(rng.integers(80, 300))
                if pos + dlen + 1 >= seg_end - 60:
                    continue
                ref = seq[pos:pos + dlen + 1].tobytes()
                variants.add(pos, ref, ref[:1], True, phase, b"SVTYPE=DEL")
                pos += dlen
            elif r < sv_p + tr_p:
                # tandem-repeat site (TRGT-style TRID tag), length change
                rl = int(rng.integers(12, 40))
                al = rl + int(rng.integers(3, 15)) * (1 if rng.random() < 0.5
                                                      else -1)
                al = max(al, 2)
                ref = seq[pos:pos + rl].tobytes()
                alt = ref[:1] + _random_bases(rng, al - 1).tobytes()
                variants.add(pos, ref, alt, True, phase,
                             b"TRID=TR_%d" % pos)
                pos += rl
            else:
                kind = rng.random()
                if kind < 0.84:  # SNV
                    ref = seq[pos:pos + 1].tobytes()
                    alt = BASES[(int(np.searchsorted(BASES, ref[0]))
                                 + int(rng.integers(1, 4))) % 4]
                    variants.add(pos, ref, bytes([alt]), is_het, phase)
                elif kind < 0.92:  # insertion 1-6bp
                    ref = seq[pos:pos + 1].tobytes()
                    ins = _random_bases(rng, int(rng.integers(1, 7))).tobytes()
                    variants.add(pos, ref, ref + ins, is_het, phase)
                else:  # deletion 1-6bp
                    dlen = int(rng.integers(1, 7))
                    ref = seq[pos:pos + dlen + 1].tobytes()
                    variants.add(pos, ref, ref[:1], is_het, phase)
                    pos += dlen
    return seq, variants, segments


def build_haplotype(seq: np.ndarray, variants: SimVariants, hap: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Apply the truth alleles for one haplotype.

    Returns (hap_seq uint8[Lh], h2r int64[Lh]) where h2r[i] is the reference
    coordinate of haplotype base i, or -1 for inserted bases. Built from
    numpy chunks so it stays fast at 100 Mb scale.
    """
    chunks: list[np.ndarray] = []
    maps: list[np.ndarray] = []
    cursor = 0
    n = len(variants)
    for i in range(n):
        if variants.is_het[i]:
            carries = variants.phase[i] == hap
        else:
            carries = True
        if not carries:
            continue
        p = variants.pos[i]
        ref = variants.ref[i]
        alt = variants.alt[i]
        assert p >= cursor, "overlapping variants in sim"
        chunks.append(seq[cursor:p])
        maps.append(np.arange(cursor, p, dtype=np.int64))
        n_aligned = min(len(ref), len(alt))
        chunks.append(np.frombuffer(alt, dtype=np.uint8))
        m = np.full(len(alt), -1, dtype=np.int64)
        m[:n_aligned] = np.arange(p, p + n_aligned)
        maps.append(m)
        cursor = p + len(ref)
    chunks.append(seq[cursor:])
    maps.append(np.arange(cursor, len(seq), dtype=np.int64))
    return np.concatenate(chunks), np.concatenate(maps)


def cigar_ops_from_h2r(h2r: np.ndarray) -> list[tuple[str, int]]:
    """Derive CIGAR ops from an h2r window whose first/last entries are
    mapped. Vectorized: events are the positions where insertions (h2r < 0)
    or reference jumps (deletions) occur."""
    mp = np.flatnonzero(h2r >= 0)
    refs = h2r[mp]
    qgap = np.diff(mp) - 1            # inserted bases between mapped bases
    rgap = np.diff(refs) - 1          # deleted ref bases between mapped bases
    events = np.flatnonzero((qgap > 0) | (rgap > 0))
    ops: list[tuple[str, int]] = []
    prev = 0
    for e in events:
        mlen = int(e - prev + 1)
        ops.append(("M", mlen))
        if qgap[e] > 0:
            ops.append(("I", int(qgap[e])))
        if rgap[e] > 0:
            ops.append(("D", int(rgap[e])))
        prev = e + 1
    ops.append(("M", int(len(mp) - prev)))
    # merge adjacent Ms produced when an I and D abut
    merged: list[tuple[str, int]] = []
    for op, ln in ops:
        if ln <= 0:
            continue
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + ln)
        else:
            merged.append((op, ln))
    return merged


def write_fasta_fast(path: str, names, seqs) -> None:
    with open(path, "wb") as fh:
        for name, seq in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n")
            n = len(seq)
            # 60-col wrap via one reshape-ish pass
            for i in range(0, n, 6_000_000):
                chunk = seq[i:i + 6_000_000]
                m = len(chunk)
                pad = (-m) % 60
                arr = np.concatenate(
                    [chunk, np.full(pad, ord("\n"), dtype=np.uint8)])
                arr = arr.reshape(-1, 60)
                out = np.concatenate(
                    [arr, np.full((arr.shape[0], 1), ord("\n"),
                                  dtype=np.uint8)], axis=1)
                data = out.tobytes()
                if pad:
                    data = data[:-(pad + 1)] + b"\n"
                fh.write(data)


def write_vcf_fast(path: str, names, chrom_variants, chrom_lens,
                   sample: str = "SAMPLE", io_threads: int = 2) -> int:
    """chrom_variants: list of SimVariants. Returns total het count."""
    lines = [b"##fileformat=VCFv4.2",
             b'##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">',
             b'##INFO=<ID=TRID,Number=1,Type=String,Description="TR id">',
             b'##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             b'##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Quality">']
    for name, ln in zip(names, chrom_lens):
        lines.append(f"##contig=<ID={name},length={ln}>".encode())
    cols = (b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + sample.encode())
    header = VcfHeader.parse(lines + [cols])
    wr = VcfWriter(path, header, io_threads=io_threads)
    n_het = 0
    for name, v in zip(names, chrom_variants):
        nameb = name.encode()
        for i in range(len(v)):
            het = v.is_het[i]
            gt = b"0/1" if het else b"1/1"
            n_het += bool(het)
            wr.write(VcfRecord([
                nameb, b"%d" % (v.pos[i] + 1), b".", v.ref[i], v.alt[i],
                b"60", b"PASS", v.info[i], b"GT:GQ", gt + b":60"]))
    wr.close()
    wr.write_index()
    return n_het


def make_read_raw(name: bytes, refid: int, pos: int, seq: np.ndarray,
                  cigar: list[tuple[str, int]], qual: int, flag: int,
                  tags: bytes) -> bytes:
    """Assemble one BAM record body (no leading block_size)."""
    L = len(seq)
    nameb = name + b"\x00"
    rend = pos + sum(ln for op, ln in cigar if op in "MDN=X")
    head = struct.pack("<iiBBHHHIiii", refid, pos, len(nameb), 60,
                       reg2bin(pos, rend), len(cigar), flag, L, -1, -1, 0)
    cig = b"".join(struct.pack("<I", (ln << 4) | CIGAR_OPS.index(op))
                   for op, ln in cigar)
    return head + nameb + cig + pack_seq(seq) + bytes([qual]) * L + tags


def cigar_str(cigar: list[tuple[str, int]]) -> str:
    return "".join(f"{ln}{op}" for op, ln in cigar)


def _apply_errors(rng, rseq: np.ndarray, error_rate: float) -> None:
    if error_rate <= 0:
        return
    n_err = rng.binomial(len(rseq), error_rate)
    if n_err:
        at = rng.integers(0, len(rseq), size=n_err)
        ref_idx = np.searchsorted(BASES, rseq[at])
        rseq[at] = BASES[(ref_idx + rng.integers(1, 4, n_err)) % 4]


def simulate_reads(rng, seq, variants: SimVariants, segments, refid: int,
                   read_length: int, coverage: int, error_rate: float,
                   rg: bytes = b"RGZrg1\x00", sa_bridge_rate: float = 0.12,
                   stratified: bool = False):
    """Yield (start, raw_record) coordinate-sorted.

    Reads are confined to segments (so deserts break phase blocks); a
    fraction of desert boundaries get a split read (primary + supplementary
    with SA tags) bridging the two segments.
    """
    haps = [build_haplotype(seq, variants, 0),
            build_haplotype(seq, variants, 1)]
    # monotone ref-coordinate view per hap (inserted bases inherit the
    # previous mapped coordinate) so ref→hap lookup is a searchsorted
    hmono = [np.maximum.accumulate(h2r) for _hs, h2r in haps]
    out: list[tuple[int, bytes]] = []
    ctr = 0

    def emit_read(hap: int, hs: int, he: int, name: bytes, flag: int,
                  tags: bytes):
        """One read from hap coords [hs, he); returns (pos, cigar) or None."""
        hseq, h2r = haps[hap]
        s, e = hs, he
        while s < e and h2r[s] < 0:
            s += 1
        while e > s and h2r[e - 1] < 0:
            e -= 1
        if e - s < 100:
            return None
        window = h2r[s:e]
        cigar = cigar_ops_from_h2r(window)
        rseq = hseq[s:e].copy()
        _apply_errors(rng, rseq, error_rate)
        pos = int(window[0])
        out.append((pos, make_read_raw(name, refid, pos, rseq, cigar, 30,
                                       flag, tags)))
        return pos, cigar

    covs = stratified_coverages(segments) if stratified else None
    # with ``stratified``, ceil(rate x boundaries) bridges (the expected
    # count rounded up, so a contig of few segments keeps one) at
    # boundaries drawn from the seed, not one draw a boundary
    bridges = (set(rng.permutation(len(segments) - 1)[
        :int(np.ceil(sa_bridge_rate * (len(segments) - 1)))].tolist())
        if stratified else None)
    for si, (seg_start, seg_end) in enumerate(segments):
        seg_len = seg_end - seg_start
        cov = coverage * (covs[si] if stratified else rng.uniform(0.6, 1.4))
        n_reads = max(1, int(cov * seg_len / read_length))
        # hap coords of the segment bounds per hap
        for _ in range(n_reads):
            hap = int(rng.integers(0, 2))
            hm = hmono[hap]
            rs = int(rng.integers(seg_start - read_length + 300,
                                  seg_end - 300))
            re_ = rs + read_length
            rs = max(rs, seg_start)
            re_ = min(re_, seg_end)
            # ref→hap: first hap index whose ref coord reaches rs / re_
            hs = int(np.searchsorted(hm, rs))
            he = int(np.searchsorted(hm, re_))
            name = b"m%d_%d" % (refid, ctr)
            ctr += 1
            emit_read(hap, hs, he, name, 0, rg)

    # split reads bridging deserts (SA-joined supplementary pairs)
    for si in range(len(segments) - 1):
        if (si not in bridges if stratified
                else rng.random() >= sa_bridge_rate):
            continue
        l_start, l_end = segments[si]
        r_start, r_end = segments[si + 1]
        hap = int(rng.integers(0, 2))
        hm = hmono[hap]
        plen = int(rng.integers(4000, max(min(read_length, l_end - l_start),
                                          4001)))
        slen = int(rng.integers(4000, max(min(read_length, r_end - r_start),
                                          4001)))
        name = b"sa%d_%d" % (refid, si)
        ctr += 1
        p_hs = int(np.searchsorted(hm, max(l_end - plen, l_start)))
        p_he = int(np.searchsorted(hm, l_end))
        s_hs = int(np.searchsorted(hm, r_start))
        s_he = int(np.searchsorted(hm, min(r_start + slen, r_end)))
        # emit both; build SA tags afterwards via a two-pass assembly
        before = len(out)
        p = emit_read(hap, p_hs, p_he, name, 0, rg)
        s = emit_read(hap, s_hs, s_he, name, 0x800, rg)
        if p is None or s is None:
            del out[before:]
            continue
        # rewrite the two records to append reciprocal SA tags
        (p_pos, p_cig), (s_pos, s_cig) = p, s
        chrom = b"chr%d" % (refid + 1)
        sa_of = {0: b"SAZ%s,%d,+,%s,60,0;\x00"
                 % (chrom, s_pos + 1, cigar_str(s_cig).encode()),
                 1: b"SAZ%s,%d,+,%s,60,0;\x00"
                 % (chrom, p_pos + 1, cigar_str(p_cig).encode())}
        for k, idx in enumerate((before, before + 1)):
            pos_k, raw = out[idx]
            out[idx] = (pos_k, raw + sa_of[k])

    out.sort(key=lambda t: t[0])
    return out


def build_benchmark_dataset(out_dir: str, total_mb: int = 100,
                            n_contigs: int = 4, coverage: int = 30,
                            read_length: int = 15_000, seed: int = 0,
                            het_spacing: int = 800, hom_spacing: int = 2000,
                            error_rate: float = 0.01, block_kb: int = 250,
                            sample: str = "SAMPLE", io_threads: int = 2,
                            stratified: bool = False):
    """Build fasta/vcf/bam under out_dir; returns dict of paths + counts.
    ``stratified`` gives every seed the same segment lengths, coverages and
    number of bridging reads, in an order drawn from the seed (see
    `stratified_segments`); every mix of the benchmark runs with it. Without
    it the draws are the original's, as the equality test holds."""
    import os

    from reference.io.bam import BamRecord

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    contig_len = int(total_mb * 1_000_000) // n_contigs
    names = [f"chr{i + 1}" for i in range(n_contigs)]
    fasta = os.path.join(out_dir, "ref.fa")
    vcf = os.path.join(out_dir, "calls.vcf.gz")
    bam = os.path.join(out_dir, "reads.bam")

    chrom_data = []
    n_segments = 0
    for i in range(n_contigs):
        seq, variants, segments = simulate_contig(
            rng, contig_len, het_spacing, hom_spacing, block_kb=block_kb,
            stratified=stratified)
        chrom_data.append((seq, variants, segments))
        n_segments += len(segments)
    write_fasta_fast(fasta, names, [c[0] for c in chrom_data])
    n_het = write_vcf_fast(vcf, names, [c[1] for c in chrom_data],
                           [contig_len] * n_contigs, sample=sample,
                           io_threads=io_threads)

    header = SamHeader(
        "@HD\tVN:1.6\tSO:coordinate\n"
        f"@RG\tID:rg1\tSM:{sample}\n",
        names, [contig_len] * n_contigs)
    w = BamWriter(bam, header, io_threads=io_threads)
    n_reads = 0
    for refid, (seq, variants, segments) in enumerate(chrom_data):
        for _s, raw in simulate_reads(rng, seq, variants, segments, refid,
                                      read_length, coverage, error_rate,
                                      stratified=stratified):
            w.write(BamRecord.parse(raw))
            n_reads += 1
    w.close()
    w.write_index()
    return {"fasta": fasta, "vcf": vcf, "bam": bam, "n_het": n_het,
            "n_reads": n_reads, "total_bp": contig_len * n_contigs,
            "n_segments": n_segments}

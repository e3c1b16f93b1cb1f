"""The golden end-to-end dataset's settings and its output digest.

The same values and the same normalization as tests/test_e2e_golden.py
(which pins the phasing output of a WGS-realistic simulated dataset in
tests/goldens/e2e_wgs_sim.json), kept in the package so that a run of the
port can check itself against the committed digest without loading the
JAX package's test module.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

from hiphase_tpu_torch.io.bam import BamReader
from hiphase_tpu_torch.io.vcf import VcfReader

GOLDEN = (pathlib.Path(__file__).resolve().parents[2] / "tests" / "goldens"
          / "e2e_wgs_sim.json")

DATASET_KW = dict(total_mb=2, n_contigs=2, coverage=15, read_length=8000,
                  seed=99, block_kb=120)


def committed_sha256() -> str:
    return json.loads(GOLDEN.read_text())["sha256"]


def normalize(out_vcf, out_bam, blocks_file) -> dict:
    """Normalized, compression-independent view of the outputs."""
    vcf_lines = []
    for rec in VcfReader(out_vcf):
        gt = rec.sample_field(0, "GT")
        ps = rec.sample_field(0, "PS")
        pf = rec.sample_field(0, "PF")
        vcf_lines.append("\t".join([
            rec.chrom, str(rec.pos0 + 1),
            (gt or b".").decode(),
            (ps or b".").decode() if isinstance(ps, bytes) else str(ps or "."),
            (pf or b".").decode() if isinstance(pf, bytes) else str(pf or "."),
        ]))
    bam_lines = []
    with BamReader(out_bam) as bam:
        for rec in bam:
            bam_lines.append(
                f"{rec.read_name}\t{rec.refid}\t{rec.pos}\t"
                f"{rec.get_tag('HP')}\t{rec.get_tag('PS')}")
    # full-record fidelity: every byte of every output record
    vcf_full = [b"\t".join(rec.fields).decode()
                for rec in VcfReader(out_vcf)]
    blocks = pathlib.Path(blocks_file).read_text().splitlines()
    return {"vcf": vcf_lines, "vcf_full": vcf_full, "bam": bam_lines,
            "blocks": blocks}


def digest(norm: dict) -> str:
    blob = json.dumps(norm, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()

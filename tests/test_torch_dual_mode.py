"""Dual mode (global realignment) on the port's device WFA, end to end on
the CPU.

``--wfa-engine device`` with ``device=torch.device("cpu")`` runs the WFA
kernel's plain PyTorch version; its output must be record-identical to the
JAX package's host WFA, the parity target tests/test_wfa_device.py holds
the JAX package's own device WFA to.
"""

import pytest
import torch

from hiphase_tpu.cli import main as jax_cli_main
from hiphase_tpu.io.vcf import VcfReader
from hiphase_tpu_torch import cli
from hiphase_tpu_torch.device import DeviceUnavailableError

from tests.sim import build_dataset

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _argv(fasta, vcf, bam, out_vcf, extra):
    return ["--bam", bam, "--vcf", vcf, "--reference", fasta,
            "--output-vcf", out_vcf] + extra


def _records(path):
    return [tuple(r.fields) for r in VcfReader(path)]


def _jax_host_wfa(tmp_path, fasta, vcf, bam):
    out = str(tmp_path / "jax_host.vcf.gz")
    assert jax_cli_main(_argv(fasta, vcf, bam, out,
                              ["--engine", "native", "--wfa-engine", "host",
                               "--threads", "1"])) == 0
    return _records(out)


@pytest.mark.parametrize("engine,contig_len,threads", [
    ("cuda", 12000, 1),
    # astar prepares on threads of this process (no fork): a smaller
    # contig keeps the plain WFA's CPU time down
    ("astar", 4000, 2)])
def test_device_wfa_matches_jax_host_wfa(tmp_path, engine, contig_len,
                                         threads):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=11, n_contigs=1, contig_len=contig_len, coverage=12)
    out = str(tmp_path / "port.vcf.gz")
    assert cli.main(_argv(fasta, vcf, bam, out,
                          ["--engine", engine, "--wfa-engine", "device",
                           "--threads", str(threads)]), device=CPU) == 0
    stats = cli.LAST_RUN_STATS
    assert stats["engine"] == engine and stats["wfa_device"] == "cpu"
    wfa = stats["wfa"]
    assert wfa["reads"] > 0
    assert sum(wfa["certified"].values()) + wfa["uncertified"] == wfa["reads"]
    # one launch per block and rung (no sub-batches on the CPU), each
    # carrying every read of the block still pending at that rung
    assert wfa["band_calls"] <= 3 * stats["blocks"] and wfa["h2d_copies"] == 0
    assert wfa["band_calls"] < wfa["reads"]
    assert wfa["max_pairs_per_launch"] > 1
    # the plain versions ran: no kernel was launched
    assert set(stats["kernel_launches"].values()) == {0}
    want = _jax_host_wfa(tmp_path, fasta, vcf, bam)
    assert want, "empty phased VCF"
    assert _records(out) == want


def test_device_wfa_without_a_cuda_device_raises(tmp_path, monkeypatch):
    """--wfa-engine device resolves its device whatever the engine: with no
    CUDA device and no explicit device it raises, as --engine cuda does."""
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=27, n_contigs=1, contig_len=3000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="CUDA device"):
        cli.main(_argv(fasta, vcf, bam, str(tmp_path / "o.vcf.gz"),
                       ["--engine", "native", "--wfa-engine", "device"]))

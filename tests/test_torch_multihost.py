"""Multi-host runs of the torch port: real ``torch.distributed`` gloo
process groups of 2 and 4 processes on the CPU, met through a ``file://``
store in the test's directory, whose rank-0 outputs must equal the
single-process run — phased VCF, haplotagged BAM and the four statistics
files (tests/test_multihost.py's check, on the port). The cuda engine runs
its kernels' plain versions in each rank (``device=torch.device("cpu")``).
Every subprocess runs under a timeout, and every rank checks that no
module of JAX or of the JAX package was loaded."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from hiphase_tpu.parallel import multihost as jmh
from hiphase_tpu_torch import cli
from hiphase_tpu_torch.parallel import multihost as mh

from tests.sim import build_dataset
from tests.test_e2e import run_cli as jax_run_cli
from tests.test_torch_sharding import assert_same_outputs

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RANK_TIMEOUT = 300

PRELUDE = textwrap.dedent("""
    import datetime, json, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    from hiphase_tpu_torch.parallel import multihost
    rank, n = int(sys.argv[1]), {n!r}
    multihost.initialize("file://" + {store!r}, n, rank,
                         timeout=datetime.timedelta(seconds=120))


    def foreign_modules():
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "hiphase_tpu"))
""")

CLI_RANK_SCRIPT = PRELUDE + textwrap.dedent("""
    from hiphase_tpu_torch import cli
    out = {outputs!r}
    out = {{k: v.format(rank=rank) for k, v in out.items()}}
    main_kw = {{}}
    {setup}
    rc = cli.main(["--bam", {bam!r}, "--vcf", {vcf!r},
                   "--reference", {fasta!r},
                   "--output-vcf", out["vcf.gz"], "--output-bam", out["bam"],
                   "--stats-file", out["stats.csv"],
                   "--haplotag-file", out["tags.tsv"],
                   "--blocks-file", out["blocks.tsv"],
                   "--summary-file", out["summary.tsv"],
                   "--engine", {engine!r}, "--threads", "2",
                   "--beam-width", "64", "--batch-size", "4",
                   "--disable-global-realignment"],
                  device=torch.device("cpu"), **main_kw)
    print("STATS " + json.dumps(cli.LAST_RUN_STATS))
    print("FOREIGN " + json.dumps(foreign_modules()))
    torch.distributed.destroy_process_group()
    sys.exit(rc)
""")

GATHER_RANK_SCRIPT = PRELUDE + textwrap.dedent("""
    payloads = [b"", b"abc\\x00def" * 1000, b"\\x00", b"xyz"]
    got = multihost.allgather_bytes(payloads[rank])
    assert got == payloads[:n], got
    # replay: every rank stashes the results of its blocks, ticks on every
    # global block; rank 0 receives all of them
    replay = multihost.ResultReplay(gather_every=3)
    seen = []
    for b in range(10):
        if multihost.blocks_for_host(b):
            replay.stash(("block", b, rank))
        seen.extend(replay.tick())
    seen.extend(replay.finish())
    print("SEEN " + json.dumps(seen))
    print("HOSTS " + json.dumps([multihost.host_index(),
                                 multihost.host_count()]))
    print("FOREIGN " + json.dumps(foreign_modules()))
    torch.distributed.destroy_process_group()
""")

ASTAR_RANK_SCRIPT = PRELUDE + textwrap.dedent("""
    from hiphase_tpu_torch import cli
    from hiphase_tpu_torch.io import native
    native.available = lambda: False   # so that 'auto' resolves to astar
    refused = []
    # the last run: rank 0 asks for native, and is refused with rank 1
    for engine in ("astar", "auto", "native" if rank == 0 else "astar"):
        try:
            cli.main(["--bam", {bam!r}, "--vcf", {vcf!r},
                      "--reference", {fasta!r},
                      "--output-vcf", {out!r}, "--engine", engine,
                      "--disable-global-realignment"])
        except SystemExit as e:
            refused.append(str(e))
    print("REFUSED " + json.dumps(refused))
    print("FOREIGN " + json.dumps(foreign_modules()))
    torch.distributed.destroy_process_group()
""")


def run_ranks(tmp_path, name, template, n, **fields):
    """Run ``n`` ranks of a script; returns each rank's stdout."""
    store = tmp_path / f"{name}.store"
    script = tmp_path / f"{name}.py"
    script.write_text(template.format(repo=str(REPO), store=str(store), n=n,
                                      **fields))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    # each rank writes to files, never to a pipe that nobody reads while
    # another rank is waited on
    logs = [(tmp_path / f"{name}.{r}.out", tmp_path / f"{name}.{r}.err")
            for r in range(n)]
    procs = []
    try:
        for r, (out, err) in enumerate(logs):
            with open(out, "w") as so, open(err, "w") as se:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(r)], stdout=so,
                    stderr=se, env=env, cwd=str(tmp_path)))
        deadline = time.monotonic() + RANK_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, err.read_text()[-3000:]
    return [out.read_text() for out, _err in logs]


def field(stdout: str, name: str):
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith(name + " "))
    return json.loads(line[len(name) + 1:])


def _outputs(tmp_path, name):
    return {k: str(tmp_path / f"{name}.{k}") for k in
            ("vcf.gz", "bam", "stats.csv", "tags.tsv", "blocks.tsv",
             "summary.tsv")}


def run_cli_ranks(tmp_path, data, n, engine, setup=""):
    """The CLI in ``n`` ranks; each rank's outputs are named after it.
    ``setup`` is code run in each rank before `cli.main` (it may set
    ``main_kw``, the keyword arguments of `cli.main` but ``device``).
    Returns (rank-0 outputs, each rank's LAST_RUN_STATS, each rank's
    foreign modules)."""
    fasta, vcf, bam = data
    outs = run_ranks(tmp_path, f"cli{n}", CLI_RANK_SCRIPT, n,
                     outputs=_outputs(tmp_path, f"multi{n}.r{{rank}}"),
                     fasta=fasta, vcf=vcf, bam=bam, engine=engine,
                     setup=textwrap.dedent(setup).strip() or "pass")
    for r in range(1, n):
        assert not [p for p in _outputs(tmp_path, f"multi{n}.r{r}").values()
                    if os.path.exists(p)], f"rank {r} wrote output files"
    return (_outputs(tmp_path, f"multi{n}.r0"),
            [field(o, "STATS") for o in outs],
            [field(o, "FOREIGN") for o in outs])


@pytest.mark.parametrize("n_procs,engine", [(2, "cuda"), (4, "native")])
def test_multiprocess_run_matches_single(tmp_path, n_procs, engine):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=31, n_contigs=4, contig_len=6000, coverage=15)
    single = _outputs(tmp_path, "single")
    assert cli.main(["--bam", bam, "--output-bam", single["bam"],
                     "--vcf", vcf, "--output-vcf", single["vcf.gz"],
                     "--reference", fasta,
                     "--stats-file", single["stats.csv"],
                     "--haplotag-file", single["tags.tsv"],
                     "--blocks-file", single["blocks.tsv"],
                     "--summary-file", single["summary.tsv"],
                     "--engine", engine, "--threads", "2",
                     "--beam-width", "64", "--batch-size", "4",
                     "--disable-global-realignment"], device=CPU) == 0

    multi, stats, foreign = run_cli_ranks(tmp_path, (fasta, vcf, bam),
                                          n_procs, engine)
    assert foreign == [[]] * n_procs
    assert [s["engine"] for s in stats] == [engine] * n_procs
    # rank 0 writes every result; the others solved their shares
    assert stats[0]["blocks"] > 0 and all(s["blocks"] == 0
                                          for s in stats[1:])
    if engine == "cuda":
        assert all(s["device_batches"] >= 1 for s in stats)
    assert_same_outputs(single, multi)

    # and the JAX package's single-process run (its native engine: every
    # engine of both packages gives the same bytes); --stats-file differs
    # by design (the port reports the A* oracle's cost, ROADMAP §3)
    jax_vcf, jax_bam = jax_run_cli(tmp_path, fasta, vcf, bam, name="jax",
                                   extra=["--engine", "native",
                                          "--beam-width", "64",
                                          "--batch-size", "4"])
    jax = {"vcf.gz": jax_vcf, "bam": jax_bam,
           "blocks.tsv": str(tmp_path / "jax.blocks.tsv"),
           "summary.tsv": str(tmp_path / "jax.summary.tsv")}
    assert_same_outputs(jax, multi, keys=("blocks.tsv", "summary.tsv"))


def test_allgather_and_replay_over_two_ranks(tmp_path):
    outs = run_ranks(tmp_path, "gather", GATHER_RANK_SCRIPT, 2)
    seen0 = field(outs[0], "SEEN")
    assert sorted(seen0) == [["block", b, b % 2] for b in range(10)]
    assert field(outs[1], "SEEN") == []
    assert [field(o, "HOSTS") for o in outs] == [[0, 2], [1, 2]]
    assert [field(o, "FOREIGN") for o in outs] == [[], []]


def test_astar_is_refused_under_multihost(tmp_path):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=33, n_contigs=1, contig_len=3000)
    out = str(tmp_path / "astar.vcf.gz")
    outs = run_ranks(tmp_path, "astar", ASTAR_RANK_SCRIPT, 2, fasta=fasta,
                     vcf=vcf, bam=bam, out=out)
    for o in outs:
        refused = field(o, "REFUSED")
        assert len(refused) == 3, refused
        assert all("multi-host" in msg for msg in refused)
        assert all("on rank(s) [0, 1]" in msg for msg in refused[:2])
        assert "on rank(s) [1]" in refused[2]
        assert field(o, "FOREIGN") == []
    assert not os.path.exists(out)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4])
def test_block_sharding_matches_jax(n_hosts):
    class B:
        def __init__(self, i):
            self.block_index = i

    blocks = [B(i) for i in range(17)]
    seen = []
    for h in range(n_hosts):
        mine = [b.block_index
                for b in mh.shard_block_stream(iter(blocks), n_hosts, h)]
        want = [b.block_index
                for b in jmh.shard_block_stream(iter(blocks), n_hosts, h)]
        assert mine == want
        assert all(mh.blocks_for_host(i, n_hosts, h)
                   == jmh.blocks_for_host(i, n_hosts, h) for i in range(17))
        seen.extend(mine)
    assert sorted(seen) == list(range(17))


def test_single_process_is_host_0_of_1():
    assert not mh.is_multihost()
    assert (mh.host_index(), mh.host_count()) == (0, 1)
    mh.initialize(None, 1, 0)        # one process: no group is made
    assert not torch.distributed.is_initialized()

"""CLI of the torch port — ``python -m hiphase_tpu_torch.cli``.

The flag surface is the reference CLI's (``hiphase_tpu.cli``: the same
flags, defaults and settings checks, copied here), with ``--engine
{auto,cuda,native,astar}``: ``cuda`` is the batched device engine on the
hand-written kernels, over every CUDA device of the host unless `main` is
given its devices (each batch split into one row chunk a device, see
`parallel.sharding`). The pipeline is the JAX package's: streaming block
generation, host prepare on a thread pool, the solver, ``finalize_block``,
and the ordered writers on their own thread.

Multi-host: when this process is one rank of several in a
``torch.distributed`` group (`parallel.multihost.initialize`, then
`main`), every rank walks the same global block stream and solves its
round-robin share of the blocks, the other ranks' blocks passing as
``skip``; results replay to rank 0 at a fixed cadence, and rank 0 alone
writes the outputs, which equal a single-process run's. Each rank resolves
its own engine.

Differences from ``hiphase_tpu.cli``, all deliberate:
  * the device engine is not wrapped in a host fallback: a device or kernel
    error ends the run with that error;
  * ``--engine auto`` with a device and the native beam starts the run on
    native at once, rates the device engine against it on a seeded batch
    on a thread (or reads the rates from its cache, ``rate_cache``), and
    moves the rest of the run to the device when it wins (see
    `parallel.engine_select`); a kernel build or rating error ends the
    run, and a rating still going when the run ends is stopped. Without
    the native beam, and in a multi-host run, ``auto`` resolves before
    any work. There is no probe of the device's link and no timeout that
    moves a run back to the host;
  * ``--wfa-engine device`` aligns dual-mode reads on the CUDA kernel (or,
    with ``device=torch.device("cpu")``, its plain version) whatever the
    engine; with ``--engine astar`` it prepares blocks on threads of this
    process, never in forked workers (see `HostAStarSolver`);
  * a multi-host run refuses ``--engine astar`` (and an ``auto`` that
    resolves to it) before any work: the JAX package has no multi-host
    handling on its astar paths;
  * `main` raises on error instead of returning 1; run as a command
    (`run_command`), an error is logged as one line and exits 1.
"""

from __future__ import annotations

import argparse
import logging
import os
import queue
import sys
import threading
import time
from collections.abc import Sequence

import torch

from hiphase_tpu_torch import kernels, tracing
from hiphase_tpu_torch.device import resolve_devices
from hiphase_tpu_torch.io import native
from hiphase_tpu_torch.parallel import engine_select
from hiphase_tpu_torch.parallel import multihost as mh
from hiphase_tpu_torch.parallel.engine_select import (
    DEFAULT_RATE_CACHE, ENGINES, RATE_MARGIN, DeferredUpgradeSolver,
    EngineChoice, choose_engine)
from hiphase_tpu_torch.phasing.astar import take_sweep_counts
from hiphase_tpu_torch.version import full_version

logger = logging.getLogger("hiphase_tpu_torch")

U64_MAX = 2**63 - 1

# telemetry of the last run in this process (benches, tests, chip_smoke):
# engine, device, solver and device-transfer counters, kernel launches,
# the blocks of each estimated-cost sweep path
LAST_RUN_STATS: dict = {}


def build_parser() -> argparse.ArgumentParser:
    """Flag surface (ref: cli.rs:28-239) with this package's engines."""
    p = argparse.ArgumentParser(
        prog="hiphase-tpu-torch",
        description="Joint phaser for small, structural and tandem-repeat "
                    "variants from HiFi BAMs (PyTorch/CUDA device engine)")
    p.add_argument("--version", action="version", version=full_version())
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="Enable verbose output (-vv for trace)")

    io = p.add_argument_group("Input/Output")
    io.add_argument("--bam", dest="bams", action="append", default=[],
                    required=True, help="Input alignment file (indexed BAM)")
    io.add_argument("--output-bam", dest="output_bams", action="append",
                    default=[], help="Output haplotagged alignment file")
    io.add_argument("--vcf", dest="vcfs", action="append", default=[],
                    required=True, help="Input variant file (indexed vcf.gz)")
    io.add_argument("--output-vcf", dest="output_vcfs", action="append",
                    default=[], required=True, help="Output phased variant file")
    io.add_argument("-r", "--reference", required=True,
                    help="Reference FASTA file")
    io.add_argument("-s", "--sample-name", dest="sample_names",
                    action="append", default=[],
                    help="Sample name to phase (default: first in VCF)")
    io.add_argument("--ignore-read-groups", action="store_true",
                    help="Ignore BAM read groups (single sample only)")
    io.add_argument("--summary-file", help="Summary statistics output (tsv/csv)")
    io.add_argument("--stats-file", help="Algorithm statistics output (tsv/csv)")
    io.add_argument("--blocks-file", help="Phase block output (tsv/csv)")
    io.add_argument("--haplotag-file", help="Haplotag output (tsv/csv)")
    io.add_argument("--io-threads", type=int, default=None,
                    help="I/O threads (default: min(threads, 4))")
    io.add_argument("--csi-index", action="store_true",
                    help="Use CSI indexes for outputs")

    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Number of host threads")
    p.add_argument("--engine", choices=ENGINES, default="auto",
                   help="Phasing engine: 'cuda' = batched device beam engine "
                        "on the CUDA kernels; 'native' = C++ host beam "
                        "engine; 'astar' = host A* oracle; 'auto' (default) "
                        "= with a CUDA device, cuda when its rate measured "
                        "on a seeded batch beats the host engine's by "
                        f"{RATE_MARGIN}x, "
                        "else the host engine: native when its library "
                        "loads, else astar. With native, auto starts on it "
                        "at once and moves to cuda mid-run once the rating "
                        "(cached for an hour in ~/.cache/hiphase_tpu_torch/"
                        "engine_rates.json) favours it. All engines produce "
                        "identical output.")
    p.add_argument("--beam-width", type=int, default=None,
                   help="TPU engine fast beam width; blocks not provably "
                        "optimal at this width re-solve at the full "
                        "--phase-min-queue-size width (default: solve "
                        "directly at the full width)")
    p.add_argument("--batch-size", type=int, default=64,
                   help="TPU engine blocks per device batch (cap; the "
                        "per-bucket defaults are sized to the measured "
                        "kernel sweet spot)")

    filt = p.add_argument_group("Variant Filtering")
    filt.add_argument("--min-vcf-qual", dest="min_variant_quality", type=int,
                      default=0, help="Minimum GQ to include a variant")
    filt.add_argument("--min-mapq", dest="min_mapping_quality", type=int,
                      default=5, help="Minimum MAPQ to include a read")
    filt.add_argument("--min-matched-alleles", type=int, default=2,
                      help="Minimum matched alleles for a phasing read")

    bg = p.add_argument_group("Phase Block Generation")
    bg.add_argument("--min-spanning-reads", type=int, default=1,
                    help="Minimum reads to span two loci to join them")
    bg.add_argument("--no-supplemental-joins", dest="disable_supplemental_joins",
                    action="store_true",
                    help="Disable supplemental-mapping block joins")
    bg.add_argument("--phase-singletons", action="store_true",
                    help="Phase blocks with a single variant")

    aa = p.add_argument_group("Allele Assignment")
    aa.add_argument("--max-reference-buffer", dest="reference_buffer",
                    type=int, default=15,
                    help="Reference context around alleles (bp)")
    aa.add_argument("--disable-global-realignment", action="store_true",
                    help="Local realignment only")
    aa.add_argument("--global-realignment-max-ed", dest="max_edit_distance",
                    type=int, default=500,
                    help="Max edit distance before local fallback")
    aa.add_argument("--global-pruning-distance", dest="wfa_prune_distance",
                    type=int, default=500,
                    help="WFA wavefront prune distance (0 = off)")
    aa.add_argument("--max-global-failure-ratio", dest="global_failure_ratio",
                    type=float, default=0.5,
                    help="Failure ratio before block-level local fallback")
    aa.add_argument("--global-failure-count", dest="global_failure_minimum",
                    type=int, default=50,
                    help="Minimum failures before the ratio applies")
    aa.add_argument("--wfa-engine", choices=["host", "device"],
                    default="host",
                    help="Graph-WFA aligner for global realignment: 'host' "
                         "(C++ wavefront) or 'device' (accelerator banded-DP"
                         " kernel; uncertifiable reads fall back per-read)")

    ph = p.add_argument_group("Phasing")
    ph.add_argument("--phase-min-queue-size", dest="phase_min_queue_size",
                    type=int, default=1000, help="Minimum queue/beam size")
    ph.add_argument("--phase-queue-increment", dest="phase_queue_increment",
                    type=int, default=3,
                    help="Queue growth per variant")

    dbg = p.add_argument_group("Debug")
    dbg.add_argument("--skip", type=int, default=0, help=argparse.SUPPRESS)
    dbg.add_argument("--take", type=int, default=0, help=argparse.SUPPRESS)
    return p


def check_settings(args) -> None:
    """Validation + sentinel rewrites (ref: cli.rs:324-420)."""
    from hiphase_tpu_torch.io.bgzf import is_bgzf

    for path in args.bams + args.vcfs + [args.reference]:
        if not os.path.exists(path):
            raise SystemExit(f"File does not exist: {path}")
    for vcf in args.vcfs:
        if not is_bgzf(vcf):
            raise SystemExit(f"VCF file is not bgzip-compressed: {vcf}")
        if not (os.path.exists(vcf + ".tbi") or os.path.exists(vcf + ".csi")):
            raise SystemExit(f"VCF index not found for: {vcf}")
    for bam in args.bams:
        if bam.endswith(".cram"):
            if not os.path.exists(bam + ".crai"):
                raise SystemExit(f"CRAM index not found for: {bam}")
        elif not (os.path.exists(bam + ".bai")
                  or os.path.exists(bam + ".csi")):
            raise SystemExit(f"BAM index not found for: {bam}")

    if len(args.vcfs) != len(args.output_vcfs):
        raise SystemExit("--vcf and --output-vcf must be specified the same "
                         "number of times")
    if args.output_bams and len(args.bams) != len(args.output_bams):
        raise SystemExit("--bam and --output-bam must be specified the same "
                         "number of times")

    # sentinel rewrites (ref: cli.rs:349-354)
    if args.take == 0:
        args.take = U64_MAX
    if args.wfa_prune_distance == 0:
        args.wfa_prune_distance = U64_MAX
    args.min_spanning_reads = max(args.min_spanning_reads, 1)
    args.min_matched_alleles = max(args.min_matched_alleles, 1)
    if args.io_threads is None:
        args.io_threads = min(args.threads, 4)


def global_realignment_config(args):
    """(ref: cli.rs:302-313)"""
    if args.disable_global_realignment:
        return None
    from hiphase_tpu_torch.phasing.read_parsing import GlobalRealignmentConfig
    return GlobalRealignmentConfig(
        max_edit_distance=args.max_edit_distance,
        wfa_prune_distance=args.wfa_prune_distance,
        global_failure_ratio=args.global_failure_ratio,
        global_failure_minimum=args.global_failure_minimum,
        wfa_engine=args.wfa_engine)


def main(argv=None, device: torch.device | Sequence | None = None,
         rate_cache: str | os.PathLike | None = DEFAULT_RATE_CACHE) -> int:
    """Run the phaser; returns 0 or raises.

    ``device`` is where the cuda engine runs: None means every CUDA device
    of this host (an error when there is none); one ``torch.device``, or a
    list of them, one row chunk of each batch an entry (a device may
    repeat). ``torch.device("cpu")`` runs the kernels' plain PyTorch
    versions instead. The device WFA (``--wfa-engine device``) runs on the
    first of them. ``rate_cache`` is the file in which ``--engine auto``
    keeps its measured rates (None: no cache).
    """
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 1 else logging.INFO,
        format="[%(asctime)s.%(msecs)03d %(levelname)s %(name)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    logger.info("hiphase-tpu-torch version %s", full_version())
    check_settings(args)
    LAST_RUN_STATS.clear()
    take_sweep_counts()

    # multi-host: rank 0 alone runs the writers; each rank resolves its own
    # engine (all engines give the same bytes); 'auto' rates the devices
    # the cuda engine would run on, when there are any
    devices = (resolve_devices(device)
               if device is not None or torch.cuda.is_available() else None)
    widths = dict(beam_width=args.beam_width, batch_size=args.batch_size,
                  min_queue_size=args.phase_min_queue_size,
                  queue_increment=args.phase_queue_increment)
    multihost = mh.is_multihost()
    # 'auto' with devices and the native beam does not wait for the
    # choice: the run starts on native while the kernels build and the
    # engines are rated on a thread. A multi-host run waits (its ranks
    # refuse astar together), and so does a run without the native beam,
    # which has nothing quick to start on.
    background = None
    if (args.engine == "auto" and devices is not None and not multihost
            and native.available()):
        background = engine_select.BackgroundChoice(
            devices, args.threads, rate_cache, **widths)
        choice = EngineChoice("native")
        logger.info("Engine 'auto': starting on 'native' while the device "
                    "engine is rated")
    else:
        choice = choose_engine(args.engine, devices, args.threads,
                               rate_cache=rate_cache, **widths)
    engine = choice.engine
    if multihost:
        if torch.distributed.get_backend() != "gloo":
            raise SystemExit("a multi-host run needs a gloo process group "
                             "(hiphase_tpu_torch.parallel.multihost."
                             "initialize)")
        # every rank refuses together, so that none waits in a collective
        # for a rank that has left
        astar = mh.ranks_where(engine == "astar")
        if astar:
            raise SystemExit(
                f"--engine resolved to the host A* oracle (astar) on rank(s) "
                f"{astar}, which cannot run as ranks of a multi-host run; "
                "use --engine cuda or native, or run in a single process")
        logger.info("Multi-host run: rank %d of %d", mh.host_index(),
                    mh.host_count())
    try:
        return _run(args, argv, device, devices, choice, background)
    finally:
        if background is not None:
            background.stop()


def _run(args, argv, device, devices, choice, background) -> int:
    """The run of `main` on the engine it chose, or, with ``background``,
    on native until the background choice upgrades it."""
    engine = choice.engine
    multihost = mh.is_multihost()
    is_writer_host = mh.host_index() == 0

    from hiphase_tpu_torch.core.reference_genome import ReferenceGenome
    from hiphase_tpu_torch.io.bam import set_cram_reference
    from hiphase_tpu_torch.io.vcf import get_vcf_samples
    from hiphase_tpu_torch.phasing.block_gen import (
        MultiPhaseBlockIterator, PhaseBlockIterator, get_sample_bams)
    from hiphase_tpu_torch.phasing.phaser import (
        create_unphased_result, prepare_block, solve_block)
    from hiphase_tpu_torch.writers.bam_writer import OrderedBamWriter
    from hiphase_tpu_torch.writers.block_stats import BlockStatsCollector
    from hiphase_tpu_torch.writers.haplotag_writer import HaplotagWriter
    from hiphase_tpu_torch.writers.phase_stats import StatsWriter
    from hiphase_tpu_torch.writers.vcf_writer import OrderedVcfWriter

    command_line = " ".join(sys.argv if argv is None
                            else ["hiphase-tpu-torch"] + list(argv))

    sample_names = list(args.sample_names)
    if not sample_names:
        all_names = get_vcf_samples(args.vcfs[0])
        if len(all_names) > 1:
            logger.warning("Multi-sample VCF detected, but sample name was "
                           "not provided. Assuming name is %r.", all_names[0])
        sample_names.append(all_names[0])
    if args.ignore_read_groups and len(sample_names) > 1:
        raise SystemExit("--ignore-read-groups cannot be used with multiple "
                         "sample names")

    global_config = global_realignment_config(args)
    # the run's spans; their intervals too while a profiler records this
    # thread (the pool's threads follow this decision: the flag is per
    # thread)
    spans = tracing.Recorder(log=torch._C._autograd._profiler_enabled())
    wfa_device = wfa_counters = None
    if global_config is not None and global_config.wfa_engine == "device":
        from hiphase_tpu_torch.align.wfa_device import WfaCounters
        wfa_device = resolve_devices(device)[0]
        wfa_counters = WfaCounters()
        logger.info("Device WFA on %s", _device_name(wfa_device))

    def device_solver():
        from hiphase_tpu_torch.parallel.orchestrator import BatchedDeviceSolver
        devs = devices if devices is not None else resolve_devices(device)
        logger.info("Device engine on %s",
                    ", ".join(_device_name(d) for d in devs))
        return BatchedDeviceSolver(
            devs, beam_width=args.beam_width, batch_size=args.batch_size,
            min_queue_size=args.phase_min_queue_size,
            queue_increment=args.phase_queue_increment,
            compute_estimates=args.stats_file is not None, spans=spans)

    solver = None
    if engine == "cuda":
        solver = device_solver()
    elif engine == "native":
        from hiphase_tpu_torch.phasing.native_beam import NativeBeamSolver
        solver = NativeBeamSolver(
            beam_width=args.beam_width, batch_size=args.batch_size,
            min_queue_size=args.phase_min_queue_size,
            queue_increment=args.phase_queue_increment, threads=args.threads,
            compute_estimates=args.stats_file is not None, spans=spans)
        if background is not None:
            solver = DeferredUpgradeSolver(solver, background, device_solver,
                                           started=background.started)
    elif wfa_device is not None:
        solver = HostAStarSolver(args.phase_min_queue_size,
                                 args.phase_queue_increment)
    launches_before = kernels.launch_counts()

    logger.info("Loading reference genome...")
    reference_genome = ReferenceGenome.from_fasta(args.reference)
    set_cram_reference(reference_genome)

    # per-sample BAM assignment + block iterators (ref: main.rs:77-141)
    sample_to_bams: dict[str, list[str]] = {}
    sample_to_output_bams: dict[str, list[str]] = {}
    block_iterators = []
    for sample_name in sample_names:
        if args.ignore_read_groups:
            sample_bams = list(args.bams)
            bam_indices = list(range(len(args.bams)))
        else:
            sample_bams = get_sample_bams(args.bams, sample_name)
            bam_indices = [args.bams.index(b) for b in sample_bams]
        sample_to_bams[sample_name] = sample_bams
        if args.output_bams:
            sample_to_output_bams[sample_name] = [
                args.output_bams[i] for i in bam_indices]
        block_iterators.append(PhaseBlockIterator(
            args.vcfs, sample_bams, sample_name,
            min_quality=args.min_variant_quality,
            min_mapq=args.min_mapping_quality,
            min_spanning_reads=args.min_spanning_reads,
            allow_supplemental_joins=not args.disable_supplemental_joins))
    block_iterator = MultiPhaseBlockIterator(block_iterators)

    # writers (ref: main.rs:153-234), on the writer host only
    vcf_writer = None if not is_writer_host else OrderedVcfWriter(
        args.vcfs, args.output_vcfs, args.min_variant_quality, sample_names,
        program_version=full_version(), command_line=command_line,
        csi=args.csi_index, io_threads=args.io_threads)
    bam_writers: dict[str, OrderedBamWriter] = {}
    for sample_name in (sample_names if args.output_bams and is_writer_host
                        else []):
        bam_writers[sample_name] = OrderedBamWriter(
            sample_name, sample_to_bams[sample_name],
            sample_to_output_bams[sample_name],
            program_version=full_version(), command_line=command_line,
            io_threads=args.io_threads)
    stats_writer = (StatsWriter(args.stats_file)
                    if args.stats_file and is_writer_host else None)
    haplotag_writer = (HaplotagWriter(args.haplotag_file)
                       if args.haplotag_file and is_writer_host else None)
    block_collector = BlockStatsCollector()

    max_chrom_len = max((reference_genome.contig_length(c)
                         for c in reference_genome.contig_keys()), default=0)
    if max_chrom_len >= 2**29 - 1 and not args.csi_index:
        raise SystemExit("Output files will require .csi indexing; use "
                         "--csi-index to enable")

    debug_run = args.skip > 0 or args.take != U64_MAX

    start_time = time.time()
    results_received = 0
    # blocks each engine solved (a deferred 'auto' run counts its own)
    engine_blocks = {engine: 0}
    total_variants = 0
    logger.info("Phase block generation starting...")

    def should_solve(block):
        return (not block.unphased_block
                and (args.phase_singletons or block.num_variants > 1)
                and block.num_variants > 0)

    def write_result(phase_result, haplotag_result):
        nonlocal results_received, total_variants
        total_variants += phase_result.phase_block.num_variants
        results_received += 1
        if stats_writer is not None:
            stats_writer.write_stats(phase_result)
        block_collector.add_result(phase_result)
        for sub_block in phase_result.sub_phase_blocks:
            block_collector.add_block(sub_block)
        if haplotag_writer is not None:
            haplotag_writer.write_block(haplotag_result)
        vcf_writer.write_phase_block(phase_result)
        this_sample = phase_result.phase_block.sample_name
        for sample_name, writer in bam_writers.items():
            if sample_name == this_sample:
                writer.write_phase_block(haplotag_result)
            else:
                writer.write_dummy_block(phase_result.phase_block.block_index)
        if results_received % 100 == 0:
            elapsed = time.time() - start_time
            logger.info("Received results for %d phase blocks: %.4f "
                        "blocks/sec, %.4f hets/sec, writer waiting on "
                        "block %d", results_received,
                        results_received / elapsed, total_variants / elapsed,
                        vcf_writer.get_wait_block())

    # the ordered writers drain on their own thread, so the VCF/BAM rewrite
    # overlaps block gen + prepare + solve; bounded queue for backpressure,
    # the first writer error is raised back in the producer
    write_queue: queue.Queue = queue.Queue(maxsize=256)
    writer_errors: list[BaseException] = []

    def writer_loop():
        while True:
            item = write_queue.get()
            if item is None:
                return
            try:
                with spans.span("writer"):
                    write_result(*item)
            except BaseException as e:  # re-raised by emit / finish_writes
                writer_errors.append(e)
                while write_queue.get() is not None:
                    pass
                return

    writer_thread = threading.Thread(target=writer_loop, daemon=True,
                                     name="ordered-writers")
    writer_thread.start()

    def emit(phase_result, haplotag_result):
        if writer_errors:
            raise writer_errors[0]
        write_queue.put((phase_result, haplotag_result))

    def windowed(iterator):
        it = iter(iterator)
        i = 0
        while True:
            with spans.span("block_gen"):
                block = next(it, None)
            if block is None or i >= args.skip + args.take:
                return
            if i >= args.skip:
                yield block
            i += 1

    try:
        if solver is not None:
            from hiphase_tpu_torch.parallel.orchestrator import iter_prepared

            def prepare_fn(block):
                with spans.span("prepare"):
                    return prepare_block(
                        block, args.vcfs, sample_to_bams[block.sample_name],
                        reference_genome, args.reference_buffer,
                        args.min_matched_alleles, args.min_mapping_quality,
                        global_config, wfa_device, wfa_counters, spans)

            # multi-host: every rank walks the same global stream and solves
            # its round-robin share; the other ranks' blocks pass as 'skip',
            # so every rank ticks the replay on every block and reaches the
            # same collectives
            replay = mh.ResultReplay() if multihost else None

            def classify(block):
                if not should_solve(block):
                    return "unphased"
                return ("solve" if replay is None
                        or mh.blocks_for_host(block.block_index) else "skip")

            def publish(results):
                for pr, hr in results:
                    if replay is None:
                        emit(pr, hr)
                    else:
                        replay.stash((pr, hr))

            for kind, item in iter_prepared(
                    windowed(block_iterator), prepare_fn, classify,
                    threads=args.threads, spans=spans):
                if kind == "unphased" and is_writer_host:
                    emit(*create_unphased_result(item))
                elif kind == "solve":
                    with spans.span("solve"):
                        results = solver.submit(item)
                    if not isinstance(solver, DeferredUpgradeSolver):
                        engine_blocks[engine] += 1
                    publish(results)
                if replay is not None:
                    for pr, hr in replay.tick():
                        emit(pr, hr)
            with spans.span("solve"):
                results = solver.drain()
            publish(results)
            if replay is not None:
                for pr, hr in replay.finish():
                    emit(pr, hr)
        elif args.threads > 1:
            engine_blocks[engine] = _astar_pool(
                args, reference_genome, sample_to_bams, global_config,
                windowed(block_iterator), should_solve, emit)
        else:
            for block in windowed(block_iterator):
                if should_solve(block):
                    engine_blocks[engine] += 1
                    emit(*solve_block(
                        block, args.vcfs, sample_to_bams[block.sample_name],
                        reference_genome,
                        reference_buffer=args.reference_buffer,
                        min_matched_alleles=args.min_matched_alleles,
                        min_mapq=args.min_mapping_quality,
                        min_queue_size=args.phase_min_queue_size,
                        queue_increment=args.phase_queue_increment,
                        global_config=global_config, solver="astar"))
                else:
                    emit(*create_unphased_result(block))
    finally:
        write_queue.put(None)
        writer_thread.join()
    if writer_errors:
        raise writer_errors[0]

    # finalization (ref: main.rs:464-570); only the writer host owns files
    if not is_writer_host:
        pass
    elif not debug_run:
        vcf_writer.write_to_end_position()
        vcf_writer.close()
        vcf_writer.write_indexes()
        for writer in bam_writers.values():
            writer.finalize_chromosome()
            writer.copy_remaining_chromosomes()
            writer.close()
            writer.write_indexes()
        if args.blocks_file:
            block_collector.write_blocks(args.blocks_file)
        if args.summary_file:
            block_collector.write_block_stats(
                sample_names, args.summary_file, reference_genome,
                block_iterator.variant_stats())
    else:
        logger.warning("Debug run (--skip/--take): output files are not "
                       "finalized")
        vcf_writer.close()
        for writer in bam_writers.values():
            writer.close()
    if stats_writer is not None:
        stats_writer.close()
    if haplotag_writer is not None:
        haplotag_writer.close()

    elapsed = time.time() - start_time
    logger.info("Phasing complete: %d blocks, %d variants in %.2fs",
                results_received, total_variants, elapsed)
    upgrade = None
    native_solver = dev_solver = None
    if isinstance(solver, DeferredUpgradeSolver):
        # the choice made in the background, None when the run ended first
        choice = solver.choice or EngineChoice("native")
        engine, engine_blocks = solver.engine, dict(solver.blocks)
        if solver.upgrade is not None:
            block, before, secs = solver.upgrade
            upgrade = {"block": block, "native_blocks_before": before,
                       "seconds": secs}
        if engine_blocks["native"]:
            native_solver = solver.native
        dev_solver = solver.device
    elif engine == "native":
        native_solver = solver
    elif engine == "cuda":
        dev_solver = solver
    LAST_RUN_STATS.update(engine=engine, engine_rates=choice.rates,
                          engine_blocks=engine_blocks, engine_upgrade=upgrade,
                          blocks=results_received, variants=total_variants)
    if choice.rates:
        LAST_RUN_STATS["engine_rating"] = {
            "seconds": choice.seconds,
            "kernel_build_seconds": choice.build_seconds,
            "cached": choice.cached}
    if background is not None:
        LAST_RUN_STATS["engine_rating"] = {
            **LAST_RUN_STATS.get("engine_rating", {}),
            "in_background": True,
            "resolved": solver.choice is not None,
            "ended_seconds": background.ended_at - background.started,
            "late_blocks": solver.late_blocks}
    if native_solver is not None:
        LAST_RUN_STATS["node_expansions"] = native_solver.total_expansions
    if dev_solver is not None:
        LAST_RUN_STATS.update(
            device=_device_name(dev_solver.device),
            devices=[_device_name(d) for d in dev_solver.devices],
            device_batches=dev_solver.device_batches,
            device_transfers=dev_solver.device_transfers,
            transfers_per_batch=(
                round(dev_solver.device_transfers
                      / dev_solver.device_batches, 2)
                if dev_solver.device_batches else None))
    if wfa_device is not None:
        LAST_RUN_STATS.update(wfa_device=_device_name(wfa_device),
                              wfa=wfa_counters.as_dict())
    if dev_solver is not None or wfa_device is not None:
        after = kernels.launch_counts()
        LAST_RUN_STATS["kernel_launches"] = {
            k: after[k] - launches_before[k] for k in after}
    # blocks whose estimated-cost sweep ran in C++ and in Python
    LAST_RUN_STATS["estimate_sweeps"] = take_sweep_counts()
    # the four stages (prepare summed over its threads; stages overlap)
    totals = spans.totals()
    LAST_RUN_STATS["stage_seconds"] = {
        k: round(totals.get(k, {"wall": 0.0})["wall"], 3)
        for k in ("block_gen", "prepare", "solve", "writer")}
    LAST_RUN_STATS["spans"] = totals
    trace = spans.trace()
    if trace is not None:
        LAST_RUN_STATS["trace"] = trace
    logger.debug("Spans (wall/cpu s ×n): %s", spans.summary())
    return 0


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


class HostAStarSolver:
    """The host A* oracle behind the solver interface of
    `BatchedDeviceSolver`, for ``--engine astar --wfa-engine device``.

    Blocks are prepared on `iter_prepared`'s threads in this process and
    solved here one by one (``astar_solver`` + ``finalize_block``, as
    ``solve_block`` does). There is no fork: allele assignment launches the
    device WFA, and a forked worker cannot use the CUDA context made in its
    parent."""

    def __init__(self, min_queue_size: int, queue_increment: int):
        self.min_queue_size = min_queue_size
        self.queue_increment = queue_increment

    def submit(self, data):
        from hiphase_tpu_torch.phasing.astar import astar_solver
        from hiphase_tpu_torch.phasing.phaser import finalize_block
        result = astar_solver(data.phase_block.block_index, data.variants,
                              data.read_segments, self.min_queue_size,
                              self.queue_increment)
        return [finalize_block(data, result.haplotype_1, result.haplotype_2,
                               result.statistics)]

    def drain(self):
        return []


def _astar_pool(args, reference_genome, sample_to_bams, global_config,
                blocks, should_solve, emit) -> int:
    """Host A* on a fork-based process pool with the reference's
    40×threads in-flight window (ref: main.rs:325-462); returns the
    number of blocks solved."""
    import multiprocessing
    from collections import deque

    from hiphase_tpu_torch.parallel import workers
    from hiphase_tpu_torch.phasing.phaser import create_unphased_result

    workers.init_parent(
        reference_genome, args.vcfs, sample_to_bams,
        reference_buffer=args.reference_buffer,
        min_matched_alleles=args.min_matched_alleles,
        min_mapq=args.min_mapping_quality,
        min_queue_size=args.phase_min_queue_size,
        queue_increment=args.phase_queue_increment,
        global_config=global_config)
    ctx = multiprocessing.get_context("fork")
    job_slots = 40 * args.threads
    solved = 0
    with ctx.Pool(args.threads) as pool:
        inflight: deque = deque()

        def emit_one(kind, item):
            emit(*(item.get() if kind == "solve"
                   else create_unphased_result(item)))

        for block in blocks:
            if should_solve(block):
                solved += 1
                inflight.append(("solve", pool.apply_async(
                    workers.solve_block_worker, (block,))))
            else:
                inflight.append(("unphased", block))
            while len(inflight) >= job_slots:
                emit_one(*inflight.popleft())
        while inflight:
            emit_one(*inflight.popleft())
    return solved


def run_command(argv=None) -> int:
    """`main` as a command: an error is logged as one line and gives exit
    status 1, as in the JAX package (``SystemExit`` keeps its own)."""
    try:
        return main(argv)
    except Exception as e:
        logger.error("%s: %s", type(e).__name__, e)
        return 1


if __name__ == "__main__":
    sys.exit(run_command())

"""The benchmark of hiphase_tpu_torch: whole phasing jobs through the port's
own command entry, ``hiphase_tpu_torch.cli.main(argv)``, on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run: set-up (torch, the CUDA context, the program, the cell's dataset
generated from the seed by ``sim/``, two warm-up jobs that build and load
the host library and the kernels), then the window (jobs back to back over
the dataset while the window is open; the last one started runs to its
end), then the comparison with the plain reference (``reference/``), and
last one JSON line on standard output. With ``--trace 1`` the window runs
under torch.profiler and the line holds the cell's per-layer metrics and
the breakdown instead of its end-to-end metrics.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file named there, its traffic mix in
``traffic/<mix>.json``, each per-layer metric in ``metrics/<name>.py``.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH_DIR = os.path.basename(HERE)
for _p in (ROOT, HERE):  # the program's package, then the benchmark's
    if _p not in sys.path:
        sys.path.insert(0, _p)

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "hiphase_tpu")
# the card's machine gives a run 8 cores: the generator's compression
# threads and the reference's worker processes
WORKERS = 8


class BenchError(RuntimeError):
    """The run cannot measure the cell (no card, an unknown name)."""


# ---------------------------------------------------------------------------
# finding things by name

def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)

    @property
    def flags(self) -> dict:
        return {**self.config["flags"], **self.traffic.get("flags", {})}


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, BENCH_DIR, "traffic",
                           entry["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return Cell(name, entry, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def load_metric(name: str, root: str = ROOT):
    """The reader of a per-layer metric: ``metrics/<name>.py``'s
    ``read(record)``, which gives a number or None."""
    path = os.path.join(root, BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# a job

def job_argv(cell: Cell, data: dict, out_dir: str,
             stats: bool = True) -> list[str]:
    """The job's command line; without ``stats`` no ``--stats-file``, whose
    estimated costs are host work alone (the warm-up's saving)."""
    argv = ["--bam", data["bam"], "--vcf", data["vcf"],
            "--reference", data["fasta"],
            "--output-vcf", os.path.join(out_dir, "out.vcf.gz"),
            "--blocks-file", os.path.join(out_dir, "blocks.tsv"),
            "--summary-file", os.path.join(out_dir, "summary.tsv")]
    if stats:
        argv += ["--stats-file", os.path.join(out_dir, "stats.tsv")]
    for flag, value in cell.flags.items():
        if value is True:
            argv.append(flag)
        elif value is not False:
            argv += [flag, str(value)]
    return argv


def settings_of(cell: Cell):
    """The reference's settings, from the same flags the program gets."""
    from reference.oracle import Settings
    f = cell.flags
    g = None
    if not f.get("--disable-global-realignment"):
        g = {"max_edit_distance": f["--global-realignment-max-ed"],
             "wfa_prune_distance": f["--global-pruning-distance"],
             "global_failure_ratio": f["--max-global-failure-ratio"],
             "global_failure_minimum": f["--global-failure-count"],
             "wfa_engine": "host"}
    return Settings(
        reference_buffer=f["--max-reference-buffer"],
        min_matched_alleles=f["--min-matched-alleles"],
        min_mapq=f["--min-mapq"], min_vcf_qual=f["--min-vcf-qual"],
        min_spanning_reads=f["--min-spanning-reads"],
        supplemental_joins=not f.get("--no-supplemental-joins", False),
        phase_singletons=bool(f.get("--phase-singletons", False)),
        min_queue_size=f["--phase-min-queue-size"],
        queue_increment=f["--phase-queue-increment"],
        global_realignment=g)


def make_dataset(cell: Cell, seed: int, out_dir: str) -> dict:
    from sim.simulate import build_benchmark_dataset
    shapes = cell.config["shapes"]
    return build_benchmark_dataset(
        out_dir, total_mb=cell.traffic["job_mb"],
        n_contigs=cell.traffic["contigs"], seed=seed,
        coverage=shapes["coverage"], read_length=shapes["read_length"],
        het_spacing=shapes["het_spacing"], hom_spacing=shapes["hom_spacing"],
        error_rate=shapes["error_rate"], block_kb=shapes["block_kb"],
        io_threads=WORKERS, stratified=True)


@dataclass
class Record:
    """What the per-layer metrics read: the window's jobs (the program's
    ``LAST_RUN_STATS`` after each, its output directory, its hets) and the
    reduced trace."""

    cell: Cell
    jobs: list[dict]
    trace: object = None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# a run

def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             start: float = START, workers: int = WORKERS) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object
    and prints the compared numbers, each beside its limit, last on
    standard error."""
    import torch

    import compare
    import tracing as tr
    from hiphase_tpu_torch import cli
    from reference.oracle import Dataset, expect

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    seed = seed & 0xFFFF_FFFF_FFFF_FFFF
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.set_device(device)
    work = tempfile.mkdtemp(prefix="hiphase-bench-")
    try:
        t = time.perf_counter()
        data = make_dataset(cell, seed, os.path.join(work, "data"))
        print(f"dataset {data['n_het']} hets, {data['n_reads']} reads in "
              f"{time.perf_counter() - t:.2f} s", file=sys.stderr)

        def job(out_dir: str, stats: bool = True, threads=None,
                extra=()) -> None:
            os.makedirs(out_dir)
            argv = job_argv(cell, data, out_dir, stats) + list(extra)
            if threads is not None:
                argv[argv.index("--threads") + 1] = str(threads)
            cli.main(argv, device=device, rate_cache=None)
            if on_card:
                torch.cuda.synchronize(device)

        # The warm-up runs every kernel at the shapes of the window's jobs,
        # without the stats file's estimated-cost sweep (host code alone,
        # nothing to build or warm). CUDA loads a kernel at its first
        # launch, and the graph WFA sizes its scratch from the card's free
        # memory on each ladder's own stream, so the scratch cached on
        # several streams can fill the card before a later first launch
        # (PERF.md, section 7). So the beam kernels launch first, in a job
        # without global realignment, and the graph WFA's first job runs
        # on one thread.
        if not cell.flags.get("--disable-global-realignment"):
            job(os.path.join(work, "warmup-beam"), stats=False,
                extra=["--disable-global-realignment"])
        job(os.path.join(work, "warmup"), stats=False, threads=1)
        jobs: list[dict] = []
        failed = 0
        prof_ctx = tr.profiler(traced)
        with prof_ctx as prof:
            with tr.span(tr.WINDOW_SPAN, traced):
                t0 = time.perf_counter()
                setup_s = t0 - start
                while time.perf_counter() - t0 < seconds:
                    out_dir = os.path.join(work, f"job{len(jobs)}")
                    try:
                        with tr.span(f"{tr.JOB_SPAN} {len(jobs)}", traced):
                            job(out_dir)
                    except Exception:
                        traceback.print_exc()
                        failed += 1
                        break
                    jobs.append({"stats": copy.deepcopy(cli.LAST_RUN_STATS),
                                 "out_dir": out_dir, "hets": data["n_het"]})
                    print(f"job {len(jobs) - 1} ended at "
                          f"{time.perf_counter() - t0:.3f} s: stages "
                          f"{cli.LAST_RUN_STATS.get('stage_seconds')}",
                          file=sys.stderr)
                window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)
        result = {"correct": False, "attempted": len(jobs) + failed,
                  "failed": failed}
        if traced:
            record = Record(cell, jobs, tr.reduce(prof))
            metrics = {}
            for m in cell.per_layer:
                value = load_metric(m["name"])(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["breakdown"] = tr.breakdown(record.trace)
        else:
            hets = sum(j["hets"] for j in jobs)
            metrics = {"hets_per_s": {"value": hets / window_s,
                                      "unit": "hets/s"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
            metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}
        del prof_ctx, prof
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # the comparison, once the window has closed
        outputs = [compare.read_outputs(j["out_dir"]) for j in jobs]
        t = time.perf_counter()
        exp = expect(Dataset(data["fasta"], data["vcf"], data["bam"]),
                     settings_of(cell), "SAMPLE",
                     cell.traffic["sampled_blocks"], seed, workers)
        print(f"reference: block generation {exp.block_gen_seconds:.2f} s, "
              f"in all {time.perf_counter() - t:.2f} s; blocks "
              + ", ".join(f"{b} {e.seconds:.2f} s" for b, e in
                                     sorted(exp.sampled.items())),
              file=sys.stderr)
        notes: list[str] = []
        checks = compare.checks(outputs, failed, exp,
                                compare.read_input_vcf(data["vcf"]), notes)
        for note in notes[:20]:
            print(f"differs: {note}", file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["correct"] = all(compare.passed(c) for c in checks.values())
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    if traced:
        result["device"].update(busy_s=record.trace.busy_s,
                                window_s=record.trace.window_s)
    result["checks"] = checks
    for name, c in checks.items():
        op = ">=" if c.get("at_least") else "<="
        print(f"check {name} {c['value']} limit {op} {c['limit']}",
              file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": nothing measured", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the port must run "
              "without JAX and without the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

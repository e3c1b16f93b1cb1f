"""The control of a cell's comparison: the reference put in the program's
place with one guarantee of the configuration broken (its ``control``
entry), at the cell's own size. Its outputs must come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed: the cell's dataset, the reference's expectation and the
control's (the same sampled blocks), and one JSON line with the
comparison's numbers for the control. No CUDA device is used: the
reference and the control run on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import run


def control_numbers(cell: run.Cell, seed: int, workers: int) -> dict:
    import compare
    from reference.oracle import Dataset, expect
    work = tempfile.mkdtemp(prefix="hiphase-control-")
    try:
        data = run.make_dataset(cell, seed, os.path.join(work, "data"))
        ds = Dataset(data["fasta"], data["vcf"], data["bam"])
        k = cell.traffic["sampled_blocks"]
        t0 = time.perf_counter()
        ref = expect(ds, run.settings_of(cell), "SAMPLE", k, seed, workers)
        t1 = time.perf_counter()
        ctl = expect(ds, run.settings_of(cell), "SAMPLE", k, seed, workers,
                     control=cell.config["control"]["settings"])
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"seed": seed, "sampled_blocks": len(ref.sampled),
            **compare.sampled_unlike(ctl.sampled, ref.sampled),
            "reference_s": t1 - t0, "control_s": t2 - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--workers", type=int, default=run.WORKERS)
    args = p.parse_args(argv)
    cell = run.find_cell(run.load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_numbers(cell, seed, args.workers)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

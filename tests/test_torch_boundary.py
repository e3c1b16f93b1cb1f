"""The torch port never imports JAX.

Checked in a subprocess, because tests/conftest.py imports JAX into the
test process: import every module of hiphase_tpu_torch and chip_smoke.py,
run a tiny solve and tiny CLI runs on the CPU (local mode, and dual mode
with --wfa-engine device), then assert that no JAX module was loaded.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile, pathlib
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])

import hiphase_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hiphase_tpu_torch.__path__,
                                               "hiphase_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.load_golden_test()

from hiphase_tpu_torch.phasing.beam import solve_blocks
rng = np.random.default_rng(0)
alleles = rng.integers(0, 2, size=(2, 8, 6)).astype(np.uint8)
quals = rng.integers(10, 60, size=(2, 8, 6)).astype(np.int32)
res = solve_blocks(alleles, quals, np.zeros((2, 6), bool), beam_width=64,
                   device=torch.device("cpu"))
assert res.h1.shape == (2, 6)

from tests.sim import build_dataset
from hiphase_tpu_torch import cli
with tempfile.TemporaryDirectory() as d:
    d = pathlib.Path(d)
    fasta, vcf, bam, _c, _ = build_dataset(d, seed=3, n_contigs=1,
                                           contig_len=3000)
    for engine in ("cuda", "native"):
        assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                         "--output-vcf", str(d / f"{engine}.vcf.gz"),
                         "--engine", engine, "--beam-width", "64"],
                        device=torch.device("cpu")) == 0
    # dual mode on the device WFA's plain version
    assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(d / "dual.vcf.gz"),
                     "--engine", "cuda", "--wfa-engine", "device"],
                    device=torch.device("cpu")) == 0
    assert cli.LAST_RUN_STATS["wfa"]["reads"] > 0

jax_modules = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("modules", len(names), "jax", jax_modules)
assert not jax_modules, jax_modules
"""


def test_port_and_chip_smoke_never_import_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO)],
                          capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "jax []" in proc.stdout

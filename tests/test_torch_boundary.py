"""The torch port imports neither JAX nor anything of the JAX package.

The port keeps its own copy of the host layer, so no module of
``hiphase_tpu`` (the JAX package; ``hiphase_tpu_torch`` is the port) may
load while it runs. Checked two ways:

- in a subprocess, because tests/conftest.py imports JAX into the test
  process: import every module of hiphase_tpu_torch and chip_smoke.py, run
  a tiny solve and tiny CLI runs on the CPU (the cuda and native engines
  in dual mode on the host WFA, astar in local mode, dual mode with
  --wfa-engine device, the cuda engine over three devices, and --engine
  auto upgrading from native to the device engine), then
  assert that no JAX module and no module of the JAX package was loaded.
  The dataset is built in this process beforehand, so the subprocess sees
  only the port. The ranks of a two-process multi-host run make the same
  check;
- statically: no import statement of any port source or of chip_smoke.py,
  at module level or inside a function, names the JAX package.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from tests.sim import build_dataset

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys, pathlib
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
fasta, vcf, bam, out = sys.argv[2:6]
out = pathlib.Path(out)

import hiphase_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hiphase_tpu_torch.__path__,
                                               "hiphase_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from hiphase_tpu_torch.utils import golden
golden.committed_sha256()

from hiphase_tpu_torch.phasing.beam import solve_blocks
rng = np.random.default_rng(0)
alleles = rng.integers(0, 2, size=(2, 8, 6)).astype(np.uint8)
quals = rng.integers(10, 60, size=(2, 8, 6)).astype(np.int32)
res = solve_blocks(alleles, quals, np.zeros((2, 6), bool), beam_width=64,
                   device=torch.device("cpu"))
assert res.h1.shape == (2, 6)

from hiphase_tpu_torch import cli
from hiphase_tpu_torch.phasing import global_realign
# count the blocks each WFA engine loads in dual mode
loads = []
load = global_realign.load_full_read_segments
def counted(*args, **kwargs):
    loads.append(args[7].wfa_engine)
    return load(*args, **kwargs)
global_realign.load_full_read_segments = counted

# dual mode on the host WFA (the default), and local mode
for engine, mode in (("cuda", []), ("native", []),
                     ("astar", ["--disable-global-realignment"])):
    loads.clear()
    assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(out / f"{engine}.vcf.gz"),
                     "--engine", engine, "--beam-width", "64", *mode],
                    device=torch.device("cpu")) == 0
    assert loads == ([] if mode else ["host"] * len(loads)), (engine, loads)
    assert mode or loads, engine
# dual mode on the device WFA's plain version
assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                 "--output-vcf", str(out / "dual.vcf.gz"),
                 "--engine", "cuda", "--wfa-engine", "device"],
                device=torch.device("cpu")) == 0
assert cli.LAST_RUN_STATS["wfa"]["reads"] > 0
# the cuda engine over three devices: one row chunk of each batch a device
assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                 "--output-vcf", str(out / "chunks.vcf.gz"),
                 "--engine", "cuda", "--beam-width", "64",
                 "--batch-size", "4", "--disable-global-realignment"],
                device=[torch.device("cpu")] * 3) == 0
assert cli.LAST_RUN_STATS["transfers_per_batch"] == 6.0
# --engine auto: started on native, rated on a thread (fixed rates), the
# rates cached, and upgraded to the device engine at its first block
from hiphase_tpu_torch.parallel import engine_select
engine_select.measure_rates = lambda *a, **kw: {"cuda": 1e9, "native": 1.0}
class ResolvedFirst(engine_select.BackgroundChoice):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._thread.join()
engine_select.BackgroundChoice = ResolvedFirst
assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                 "--output-vcf", str(out / "auto.vcf.gz"),
                 "--engine", "auto", "--disable-global-realignment"],
                device=torch.device("cpu"),
                rate_cache=out / "rates.json") == 0
assert cli.LAST_RUN_STATS["engine"] == "cuda", cli.LAST_RUN_STATS
assert cli.LAST_RUN_STATS["engine_upgrade"] is not None
assert (out / "rates.json").exists()

jax_modules = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib")))
reference = sorted(m for m in sys.modules
                   if m == "hiphase_tpu" or m.startswith("hiphase_tpu."))
print("modules", len(names), "jax", jax_modules, "hiphase_tpu", reference)
assert not jax_modules, jax_modules
assert not reference, reference
"""


def test_port_and_chip_smoke_never_import_jax(tmp_path):
    fasta, vcf, bam, _c, _ = build_dataset(tmp_path, seed=3, n_contigs=1,
                                           contig_len=3000)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO), fasta,
                           vcf, bam, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "jax [] hiphase_tpu []" in proc.stdout


def test_multihost_ranks_never_import_jax(tmp_path):
    from tests.test_torch_multihost import run_cli_ranks
    fasta, vcf, bam, _c, _ = build_dataset(tmp_path, seed=3, n_contigs=1,
                                           contig_len=3000)
    _out, stats, foreign = run_cli_ranks(tmp_path, (fasta, vcf, bam), 2,
                                         "cuda")
    assert [s["engine"] for s in stats] == ["cuda", "cuda"]
    assert foreign == [[], []]


SOURCES = sorted(str(p.relative_to(REPO)) for p in
                 [*REPO.glob("hiphase_tpu_torch/**/*.py"),
                  REPO / "chip_smoke.py"])


def _reference_imports(source: str) -> list[str]:
    """Names of the JAX package's modules that import statements anywhere
    in ``source`` (functions included) import."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names
                  if n == "hiphase_tpu" or n.startswith("hiphase_tpu.")]
    return found


@pytest.mark.parametrize("path", SOURCES)
def test_no_import_of_the_jax_package(path):
    assert _reference_imports((REPO / path).read_text()) == []


def test_the_static_check_sees_lazy_imports():
    source = ("import os\n"
              "def f():\n"
              "    from hiphase_tpu.io import native\n"
              "    import hiphase_tpu.cli as c\n"
              "    from hiphase_tpu_torch.io import bam\n")
    assert _reference_imports(source) == ["hiphase_tpu.io", "hiphase_tpu.cli"]

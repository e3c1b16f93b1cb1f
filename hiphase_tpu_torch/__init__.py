"""hiphase_tpu_torch — the phaser's device engine in PyTorch and CUDA.

A second package beside ``hiphase_tpu`` (the JAX reference, which it never
imports a JAX module of). The host layers — I/O, block generation, allele
assignment, A*, finalize and the ordered writers — are JAX-free and are
imported from ``hiphase_tpu``; this package supplies what runs on the card:

  phasing/beam.py          the lockstep beam (plain torch + kernel dispatch)
  kernels/                 nvcc build, ctypes bindings, launch counters
  csrc/*.cu                hand-written Hopper kernels (sm_90a)
  parallel/orchestrator.py batched device solver (buckets, tiles, escalation)
  parallel/engine_select.py  --engine auto resolution
  phasing/native_beam.py   JAX-free twin of the native C++ beam engine
  cli.py                   ``python -m hiphase_tpu_torch.cli --engine cuda``
"""

from hiphase_tpu.version import __version__

__all__ = ["__version__"]

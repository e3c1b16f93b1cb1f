"""hiphase_tpu_torch — the phaser in PyTorch and CUDA.

A second package beside ``hiphase_tpu`` (the JAX reference). It imports
nothing of ``hiphase_tpu``: the host layers — I/O (``io/``), variants and
reads (``core/``), block generation, allele assignment and A*
(``phasing/``), the ordered writers (``writers/``) — are this package's own
copies of the reference's JAX-free modules, at the same relative paths and
with the same behaviour. What runs on the card is this package's:

  phasing/beam.py          the lockstep beam (plain torch + kernel dispatch)
  align/wfa_device.py      the banded graph WFA of dual mode (plain torch +
                           kernel dispatch, the batched band ladder)
  kernels/                 nvcc build, ctypes bindings, launch counters
  csrc/*.cu                hand-written Hopper kernels (sm_90a)
  parallel/orchestrator.py batched device solver (buckets, tiles, escalation)
  parallel/sharding.py     a batch split into one row chunk per device
  parallel/multihost.py    several processes (a gloo group): sharded block
                           stream, results replayed to rank 0
  parallel/engine_select.py  --engine auto: the device rated against the host
                           (rates cached), native until the verdict
  phasing/native_beam.py   the native C++ beam engine behind the solver interface
  cli.py                   ``python -m hiphase_tpu_torch.cli --engine cuda``

The C++ host library is loaded through ``io/native.py``: the committed
``native/libhiphase_native.so``, else the port's own build of
``csrc/hiphase_native.cc`` (``kernels/build.py``, at first use); without
either the host layers run in pure Python.
"""

from hiphase_tpu_torch.version import __version__

__all__ = ["__version__"]

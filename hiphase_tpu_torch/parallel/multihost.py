"""Multi-host (multi-process) execution — the counterpart of
``hiphase_tpu/parallel/multihost.py`` on ``torch.distributed``.

  * every process runs the same program in one process group, made by
    `initialize` (rank and world size stand in for the JAX package's
    ``process_index`` / ``process_count``);
  * the block stream is sharded by host deterministically — host h takes
    blocks with ``block_index % num_hosts == h`` — so no coordination is
    needed while producing (each host reads the shared BAM/VCF inputs and
    the replicated reference FASTA);
  * each host solves its shard with its own devices (`parallel.sharding`);
  * per-block results live on the host that solved them; the ordered
    writers run on host 0 only. `ResultReplay` moves results there: hosts
    pickle finished (PhaseResult, HaplotagResult) pairs and exchange them
    in fixed-cadence all-gathers (every ``gather_every`` global blocks plus
    one final round — a collective schedule every process hits
    identically), and host 0 replays the union into its ordered writers,
    which reorder by block_index.

The collectives run over **gloo** whatever the engine: their payloads are
host bytes, and none touches a device.
"""

from __future__ import annotations

import datetime
import pickle

import numpy as np
import torch
import torch.distributed as dist

# how long a collective (or the group's rendezvous) waits for every rank
# before it fails, so that a lost rank ends the run instead of hanging it
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def initialize(init_method: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group of a multi-host run: a gloo group of
    ``num_processes`` ranks met at ``init_method`` (``tcp://host:port`` or
    ``file:///shared/path``). A no-op for one process."""
    if num_processes is not None and num_processes > 1:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_multihost() -> bool:
    """Whether this process is one of several ranks of a process group."""
    return _grouped() and dist.get_world_size() > 1


def host_count() -> int:
    return dist.get_world_size() if _grouped() else 1


def host_index() -> int:
    return dist.get_rank() if _grouped() else 0


def ranks_where(flag: bool) -> list[int]:
    """The ranks whose ``flag`` is set (collective: every rank must call
    it), so that all ranks can take one decision together."""
    flags = [torch.zeros(1, dtype=torch.int32) for _ in range(host_count())]
    dist.all_gather(flags, torch.tensor([int(flag)], dtype=torch.int32))
    return [r for r, f in enumerate(flags) if int(f)]


def blocks_for_host(block_index: int, n_hosts: int | None = None,
                    host: int | None = None) -> bool:
    """Deterministic round-robin block→host assignment."""
    n = n_hosts if n_hosts is not None else host_count()
    h = host if host is not None else host_index()
    return block_index % n == h


def shard_block_stream(block_iterator, n_hosts: int | None = None,
                       host: int | None = None):
    """Yield only this host's blocks from the global (renumbered) stream."""
    for block in block_iterator:
        if blocks_for_host(block.block_index, n_hosts, host):
            yield block


def allgather_bytes(payload: bytes) -> list[bytes]:
    """Gather one bytes blob from every process (collective: every process
    must call with its own payload; returns all, ordered by rank).

    Two all-gathers of CPU tensors: the lengths (int64), then the blobs
    zero-padded to the longest (uint8)."""
    n = dist.get_world_size()
    length = torch.tensor([len(payload)], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, length)
    lens = [int(t) for t in lens]
    mx = max(max(lens), 1)
    buf = np.zeros(mx, dtype=np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    blobs = [torch.empty(mx, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(blobs, torch.from_numpy(buf))
    return [b[:k].numpy().tobytes() for b, k in zip(blobs, lens)]


class ResultReplay:
    """Fixed-cadence exchange of per-block results with replay on host 0.

    Usage on every host, with an identical global block stream:

        replay = ResultReplay(gather_every=64)
        for block in stream:                       # the GLOBAL stream
            if blocks_for_host(block.block_index):
                results = solve(block)             # this host's work
                replay.stash(results)
            for r in replay.tick():                # host 0: replayed results
                emit(r)
        for r in replay.finish():
            emit(r)

    `tick` fires a collective every `gather_every` global blocks, so all
    processes reach the same all-gather schedule regardless of which blocks
    they solved. On hosts ≠ 0 the returned list is always empty. The
    payloads are pickles that the ranks of this run made.
    """

    def __init__(self, gather_every: int = 64):
        self.gather_every = max(gather_every, 1)
        self._seen = 0
        self._local: list = []

    def stash(self, result) -> None:
        self._local.append(result)

    def _exchange(self) -> list:
        payload = pickle.dumps(self._local, protocol=pickle.HIGHEST_PROTOCOL)
        self._local = []
        blobs = allgather_bytes(payload)
        if host_index() != 0:
            return []
        out = []
        for blob in blobs:
            out.extend(pickle.loads(blob))
        return out

    def tick(self) -> list:
        """Count one global block; exchange when the window fills."""
        self._seen += 1
        if self._seen % self.gather_every == 0:
            return self._exchange()
        return []

    def finish(self) -> list:
        """Final exchange (always runs, even with an empty tail)."""
        return self._exchange()

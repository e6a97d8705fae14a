"""Multi-process counting for khmer_tpu_torch.

Port of khmer_tpu/parallel/multihost.py.  Every process runs the same
program: `initialize` joins the processes into one torch.distributed
group, every process parses its own share of the input files with the
native loader, and the sharded consume's collectives (parallel/comm.py)
run over the group, whose backend the caller names: NCCL where each
process has its own card, gloo on the CPU (and, through host copies,
where several processes share one card).

distributed_count keeps khmer_tpu's lockstep rule: before each dispatch
the processes agree on whether any of them still has chunks, and a
process whose files are exhausted keeps dispatching empty chunks until
every process is done, so that every process runs the same collectives.
A process's chunks take its shards' ranks, so the chunks are numbered
in file order across the mesh as in a one-process run.
"""

import itertools
import os

import numpy as np
import torch

from khmer_tpu_torch import _u64
from khmer_tpu_torch._config import resolve_device
from khmer_tpu_torch.parallel.sharded import (ShardedDeferredConsumer,
                                              default_devices, make_mesh,
                                              make_sharded_query)


def _dist():
    import torch.distributed as dist

    return dist


def _multi():
    dist = _dist()
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None):
    """Join this process to the group, from the arguments or the
    variables JAX_COORDINATOR_ADDRESS (host:port of process 0),
    JAX_NUM_PROCESSES and JAX_PROCESS_ID, the names khmer_tpu reads.
    Nothing happens for one process.  backend, required for more than
    one: "nccl" (process p on card p of this machine, which must have a
    card for every process) or "gloo" (CPU tensors, or CUDA tensors
    through host copies, so processes may share a card).  Returns the
    backend, or None."""
    num_processes = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return None
    address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not address:
        raise ValueError("initialize: no coordinator address (argument or "
                         "JAX_COORDINATOR_ADDRESS)")
    pid = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    if backend not in ("nccl", "gloo"):
        raise ValueError("initialize: backend must be 'nccl' or 'gloo', "
                         "got {!r}".format(backend))
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < num_processes:
            raise RuntimeError(
                "initialize: NCCL needs a card for each of the {} processes "
                "and the machine has {}; use gloo".format(num_processes,
                                                         cards))
        # NCCL works on the process's current card: its own
        torch.cuda.set_device(pid)
    _dist().init_process_group(backend, init_method="tcp://" + address,
                               world_size=num_processes, rank=pid)
    return backend


def shard_files_for_host(filenames, process_id=None, num_processes=None):
    """Round-robin file assignment: each process consumes its own share
    of the inputs (the reference's analogue is one ReadParser per
    thread, oxli/functions.py:42-66)."""
    multi = _multi()
    pid = process_id if process_id is not None else (
        _dist().get_rank() if multi else 0)
    n = num_processes if num_processes is not None else (
        _dist().get_world_size() if multi else 1)
    return [f for i, f in enumerate(filenames) if i % n == pid]


def process_devices(device=None):
    """This process's shard in a group, for tables on `device` (None:
    CUDA, which raises without a card): the CPU, the card asked for, or
    the card numbered by the rank mod the machine's cards, which is the
    process's own under NCCL and may be shared under gloo."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev]
    return [torch.device("cuda",
                         _dist().get_rank() % torch.cuda.device_count())]


class DistributedCountResult:
    """What a distributed count leaves: the partial tables stay on their
    shards; queries sum over the mesh (exact serial Count-Min reads)."""

    n_dropped = 0  # drops cannot happen in the deferred design

    def __init__(self, consumer, delta, n_unique, n_consumed, cands,
                 cap=None):
        self._consumer = consumer
        self._delta = delta
        self._n_unique = n_unique
        self._n_consumed = n_consumed
        self.bigcount_candidates = cands
        self.spec = consumer.spec
        self.mesh = consumer.mesh
        self._query = make_sharded_query(self.spec, self.mesh, cap)

    def n_unique_kmers(self):
        return self._n_unique

    @property
    def n_consumed(self):
        return self._n_consumed

    def get_counts(self, hashes):
        """Counts of uint64 hashes, uint16 numpy (every process takes
        part)."""
        return self._query(self._consumer.tables,
                           _u64.as_tensor(hashes, "cpu")).cpu().numpy()

    def merged_table(self):
        """The serial-equal flat u32 table (host numpy)."""
        return self._delta.cpu().numpy().view(np.uint32)


def distributed_count(filenames, spec, k, hash_kind="2bit", data_axis=None,
                      chunk=1 << 20, devices=None, use_bigcount=False,
                      device=None):
    """Count the k-mers of `filenames` over every shard of every process.

    Builds a [data, shard] mesh of this process's shards (devices: by
    default process_devices(device) in a group, default_devices(device)
    alone; device None means CUDA and raises without a card) and,
    in a group, every other process's; streams this process's share of
    the files through the native loader into the sharded consumer; and
    returns a DistributedCountResult.  Chunks carry 2-bit codes, so
    hash_kind may be any of the consumer's."""
    from khmer_tpu_torch.native import NativeChunkReader

    multi = _multi()
    if devices is None:
        devices = process_devices(device) if multi else \
            default_devices(device)
    group = _dist().group.WORLD if multi else None
    mesh = make_mesh(devices, data=data_axis, group=group)
    consumer = ShardedDeferredConsumer(spec, k, hash_kind, mesh=mesh,
                                       chunk=chunk, from_codes=True,
                                       use_bigcount=use_bigcount)
    n_local = consumer._batch_rows

    def local_chunks():
        for filename in shard_files_for_host(filenames):
            with NativeChunkReader(filename, k, chunk) as reader:
                yield from reader

    it = local_chunks()
    while True:
        batch = list(itertools.islice(it, n_local))
        got = len(batch)
        if multi:
            if mesh.total([got], "max") == 0:
                break
        elif got == 0:
            break
        for data, weights in batch:
            consumer.add_chunk(data, weights)  # dispatches when full
        # lockstep: ONE dispatch per process a round (a full batch has
        # dispatched above; a short or empty one pads out here)
        if multi and (consumer._pending or got < n_local):
            consumer._dispatch(force=True)
    delta, n_unique, n_consumed, cands = consumer.finish(virgin=True)
    return DistributedCountResult(consumer, delta, n_unique, n_consumed,
                                  cands, 65535 if use_bigcount else None)

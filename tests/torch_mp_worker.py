"""Worker process of the two-process gloo count
(tests/test_torch_multiprocess.py).  Not a test module.

    python torch_mp_worker.py PORT PROCESS_ID N_PROCESSES FILE OUTDIR \
        [BACKEND]

With gloo (the default) each process holds two CPU shards; with nccl
one shard on its own card.  Together they form a [1, shards] mesh over a
loopback group.  Only process 0 gets the file, so the others keep
dispatching empty chunks: the lockstep of distributed_count.  Process 0
writes the merged table, n_unique, n_consumed, the bigcount candidates
and query counts to OUTDIR/result.npz.
"""

import os
import sys

import numpy as np


def main():
    port, pid, nproc, infile, outdir = sys.argv[1:6]
    backend = sys.argv[6] if len(sys.argv) > 6 else "gloo"
    import torch.distributed as dist

    from khmer_tpu_torch.ops.sketch_ops import SketchSpec
    from khmer_tpu_torch.parallel import distributed_count, initialize
    from khmer_tpu_torch.primes import get_n_primes_near_x

    initialize("127.0.0.1:" + port, int(nproc), int(pid), backend=backend)
    spec = SketchSpec("byte", tuple(get_n_primes_near_x(3, 100000)))
    c = distributed_count([infile], spec, 20, chunk=4096,
                          devices=["cpu", "cpu"] if backend == "gloo"
                          else None, use_bigcount=True)
    probe = np.array(sorted(c.bigcount_candidates) + [0, 1, 2], np.uint64)
    counts = c.get_counts(probe)  # a collective: every process queries
    if int(pid) == 0:
        np.savez(os.path.join(outdir, "result.npz"), table=c.merged_table(),
                 uniq=np.int64(c.n_unique_kmers()),
                 consumed=np.int64(c.n_consumed), probe=probe,
                 counts=counts, shards=np.int64(c.mesh.size),
                 backend=np.array(backend))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

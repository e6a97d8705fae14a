"""Two processes count one file over a loopback gloo group
(khmer_tpu_torch.parallel.distributed_count) on the CPU.

The file list is uneven (one file, two processes), so process 1 keeps
dispatching empty chunks until process 0 is done.  The merged table,
n_unique, n_consumed, the bigcount candidates' counts and a query over
the mesh must equal a serial consume of the port, bit for bit.  Each
process has 120 s."""

import os
import socket
import subprocess
import sys

import numpy as np

from khmer_tpu_torch import Countgraph, _u64
from khmer_tpu_torch.primes import get_n_primes_near_x

from . import khmer_tst_utils as tst
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

WORKER = os.path.join(os.path.dirname(__file__), "torch_mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_reads(path, seed=4):
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 30000)
    starts = rng.integers(0, genome.size - 100, 1500)
    seqs = [genome[s:s + 100].tobytes().decode() for s in starts]
    seqs += ["A" * 150] * 3  # one k-mer past 255
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))


def test_two_process_gloo_count_bit_equal(tmp_path):
    infile = str(tmp_path / "reads.fa")
    _write_reads(infile)
    port = _free_port()
    env = tst.subprocess_env()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(pid), "2", infile,
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, "worker failed:\n%s\n%s" % (out[-2000:],
                                                    err[-2000:])
    got = np.load(str(tmp_path / "result.npz"))
    assert int(got["shards"]) == 4 and str(got["backend"]) == "gloo"

    g = Countgraph(20, primes=get_n_primes_near_x(3, 100000), device="cpu")
    g.set_use_bigcount(True)
    _, n_consumed = g.consume_seqfile(infile)
    assert np.array_equal(got["table"],
                          g.storage.table.numpy().view(np.uint32))
    assert int(got["uniq"]) == g.n_unique_kmers()
    assert int(got["consumed"]) == n_consumed
    probe = got["probe"]
    assert probe.size > 3
    want = g.storage.get_lanes(_u64.as_tensor(probe, "cpu"), 65535).numpy()
    assert np.array_equal(got["counts"], want)
    assert want[:-3].min() > 255

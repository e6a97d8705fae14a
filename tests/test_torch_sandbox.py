"""Port parity of the slice-4c sandbox scripts: khmer_tpu_torch.sandbox's
correct_reads, sweep_reads and assemble_on_the_go (device="cpu") against
khmer_tpu's sandbox/correct-reads.py, sweep-reads.py and
assemble-on-the-go.py on the same generated reads.

Inputs, a few hundred reads each: interleaved pairs of 100-base reads at
30x over a random 2-kb genome with 0.5% substitutions (correct-reads,
-k 20 -N 4 -x 2e4 -Z 10, also with -V); a reference of reads over six
random genomes named with their genome's index and reads to sweep over
four of them and two absent genomes (sweep-reads --label-by-pid, -N 1
at the script's least table of 4e7 bins); reads at 40x over a 450-base
genome of stop-free codons (assemble-on-the-go, whose
hard-coded Countgraph(21, 1e8, 4) is cut to 4 x 20011 bins on both sides
for the CPU).

Held equal: every output file's bytes, stdout and every stderr line
(the banner's runtime line and correct-reads' temporary directory aside),
with the port's sweep batch also cut to 5 reads."""

import contextlib
import io
import os
import sys
from unittest import mock

import numpy as np
import pytest

import khmer_tpu
import khmer_tpu.khmer_logger as jax_logger
import khmer_tpu_torch
from khmer_tpu_torch import khmer_logger
from khmer_tpu_torch.sandbox import (assemble_on_the_go, correct_reads,
                                     sweep_reads)
from .khmer_tst_utils import runscript
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

_RC = str.maketrans("ACGT", "TGCA")


def _genome(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _read(rng, genome, readlen=100, sub=0.005):
    s = int(rng.integers(0, len(genome) - readlen + 1))
    r = list(genome[s: s + readlen])
    for p in np.nonzero(rng.random(readlen) < sub)[0]:
        r[p] = "ACGT"[int(rng.integers(4))]
    r = "".join(r)
    return r.translate(_RC)[::-1] if rng.random() < 0.5 else r


def write_pairs(path, seed, n_pairs=300, genome_len=2000):
    """Interleaved pairs; pair 3's first read carries an N and pair 5's
    second read is shorter than k."""
    rng = np.random.default_rng(seed)
    genome = _genome(rng, genome_len)
    with open(path, "w") as f:
        for i in range(n_pairs):
            a, b = _read(rng, genome), _read(rng, genome)
            if i == 3:
                a = a[:40] + "N" + a[41:]
            if i == 5:
                b = b[:12]
            f.write(">p%d/1\n%s\n>p%d/2\n%s\n" % (i, a, i, b))


def write_sweep_files(ref, reads, seed):
    """Genome 5 starts with genome 4's first 150 bases, so that reads
    there carry both labels; genomes 6 and 7 are not in the reference."""
    rng = np.random.default_rng(seed)
    genomes = [_genome(rng, int(rng.integers(300, 500))) for _ in range(8)]
    genomes[5] = genomes[4][:150] + genomes[5]
    with open(ref, "w") as f:
        for i in range(66):
            g = i % 6
            f.write(">ref%d\t%d\n%s\n" % (i, g, _read(rng, genomes[g])))
    with open(reads, "w") as f:
        for i in range(48):
            g = (0, 1, 4, 5, 6, 7)[i % 6]
            f.write(">q%d\n%s\n" % (i, _read(rng, genomes[g])))
        f.write(">short\nACGTACGT\n")


def write_coding_reads(path, seed, genome_len=450, n_reads=180):
    """Reads over a genome of random stop-free codons, so that its
    contigs hold open reading frames."""
    rng = np.random.default_rng(seed)
    codons = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
              if a + b + c not in ("TAA", "TAG", "TGA")]
    genome = "".join(codons[i] for i in
                     rng.integers(0, len(codons), genome_len // 3))
    with open(path, "w") as f:
        for i in range(n_reads):
            f.write(">c%d\n%s\n" % (i, _read(rng, genome)))


def _lines(err):
    """stderr's lines with the banner's runtime line and the temporary
    directory's name (random) marked."""
    out = []
    for ln in err.splitlines():
        if ln.startswith("|| You are also using the ") and \
                ln.endswith(" runtime"):
            ln = "<runtime>"
        elif "tmp" in ln and "khmer" in ln:
            ln = "<tempdir>"
        out.append(ln)
    return out


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _run_port(module, name, argv, cwd):
    here = os.getcwd()
    out, err = io.StringIO(), io.StringIO()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err), \
                mock.patch.object(sys, "argv", [name] + argv):
            module.main(argv, device="cpu")
    finally:
        os.chdir(here)
    return out.getvalue(), err.getvalue()


def _both(tmp_path, name, module, argv, inputs, small=None):
    """The script in khmer_tpu and the port, each in a directory of its
    own holding copies of `inputs`; returns ((stdout, stderr lines,
    files) of khmer_tpu, the same of the port)."""
    got = []
    for side in ("jax", "port"):
        # each script starts from the loggers' default, as from a shell: a
        # script run with -q earlier in this process leaves its package's
        # logger quiet, and the banner compared below would go
        jax_logger.configure_logging(False)
        khmer_logger.configure_logging(False)
        d = tmp_path / side
        d.mkdir()
        for p in inputs:
            (d / os.path.basename(p)).write_bytes(open(p, "rb").read())
        if side == "jax":
            with small or contextlib.nullcontext():
                status, out, err = runscript(name, argv, in_directory=str(d),
                                             sandbox=True)
            assert status == 0, err
        else:
            out, err = _run_port(module, name, argv, str(d))
        got.append((out, _lines(err), _files(str(d))))
    return got


def _private_snapshot():
    """khmer_tpu's Storage.host_counts with its host snapshot taken as a
    private copy of the table.  As it stands (khmer_tpu/storage.py:289)
    the snapshot is np.asarray(table), a read-only view of the device
    buffer on the CPU backend, and _mirror_host_add (:212) adds into it
    with np.add.at, which ignores the read-only flag, right after
    sketch_update has donated that buffer (ops/sketch_ops.py:127): the
    result then depends on whether XLA has reused the buffer yet, so
    under load correct-reads -V wrote 597 reads where it writes 590 (5 of
    24 concurrent runs, each in a process of its own).  With the copy it
    wrote 590 in 24 of 24.  The patch asserts what it relies on, so that
    it fails here if khmer_tpu's snapshot changes."""
    from khmer_tpu import storage

    for name in ("_host_table", "_host_version", "_mirror_host_add",
                 "host_counts"):
        assert hasattr(storage.Storage, name), name
    probe = khmer_tpu.Countgraph(20, 1000, 2).storage
    assert isinstance(probe, storage.Storage)
    probe.host_counts(np.zeros(1, np.uint64))
    snap = probe._host_table
    assert isinstance(snap, np.ndarray) and not snap.flags.writeable
    assert probe._host_version is probe.table
    host_counts = storage.Storage.host_counts

    def on_a_copy(self, hashes):
        if self._host_table is None or self._host_version is not self.table:
            self._host_table = np.array(self.table)
            self._host_version = self.table
        return host_counts(self, hashes)

    return mock.patch.object(storage.Storage, "host_counts", on_a_copy)


@pytest.mark.parametrize("extra", [[], ["-V"]])
def test_correct_reads(tmp_path, extra):
    fa = str(tmp_path / "pairs.fa")
    write_pairs(fa, 31)
    argv = ["-k", "20", "-N", "4", "-x", "2e4", "-Z", "10"] + extra + \
        ["pairs.fa"]
    (jo, je, jf), (po, pe, pf) = _both(tmp_path, "correct-reads.py",
                                        correct_reads, argv, [fa],
                                        _private_snapshot())
    assert pe == je
    assert po == jo
    assert pf == jf
    assert any(ln.startswith("corrected ") and ln != "corrected 0 reads"
               for ln in pe)
    assert len(pf["pairs.fa.corr"]) > 0


def test_sweep_reads(tmp_path, monkeypatch):
    ref, reads = str(tmp_path / "ref.fa"), str(tmp_path / "reads.fa")
    write_sweep_files(ref, reads, 32)
    argv = ["--label-by-pid", "-N", "1", "-k", "21", "--outdir", ".", "ref.fa",
            "reads.fa"]
    (jo, je, jf), (po, pe, pf) = _both(tmp_path, "sweep-reads.py",
                                        sweep_reads, argv, [ref, reads])
    assert pe == je
    assert po == jo
    assert pf == jf
    assert "reads_orphaned.fa" in pf and "reads_multi.fa" in pf
    assert any(ln.startswith("...with ") for ln in pe)
    # the port again, sweeping 5 reads at a time
    monkeypatch.setattr(sweep_reads, "SWEEP_BATCH", 5)
    d = tmp_path / "port5"
    d.mkdir()
    for p in (ref, reads):
        (d / os.path.basename(p)).write_bytes(open(p, "rb").read())
    out, err = _run_port(sweep_reads, "sweep-reads.py", argv, str(d))
    assert (out, _lines(err), _files(str(d))) == (po, pe, pf)


def test_assemble_on_the_go(tmp_path):
    fa = str(tmp_path / "coding.fa")
    write_coding_reads(fa, 33)
    jcg, pcg = khmer_tpu.Countgraph, khmer_tpu_torch.Countgraph
    small = mock.patch.object(
        khmer_tpu, "Countgraph",
        lambda k, size, n, **kw: jcg(k, 20011, n, **kw))
    with mock.patch.object(assemble_on_the_go, "Countgraph",
                           lambda k, size, n, **kw: pcg(k, 20011, n, **kw)):
        (jo, je, jf), (po, pe, pf) = _both(
            tmp_path, "assemble-on-the-go.py", assemble_on_the_go,
            ["coding.fa"], [fa], small)
    assert po == jo and pe == je and pf == jf
    assert po.count(">orf") >= 1

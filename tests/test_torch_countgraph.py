"""Port parity: the load-into-counting + abundance-dist path of
khmer_tpu_torch against khmer_tpu, on a generated FASTA (4000 x 100 bp
reads over a random 20 kb genome, plus one read repeated 300 times so
that counts pass 255 into the bigcount section).

Integer data throughout: the tolerance is exact equality.  The tracking
tables are 1e6 bins x 4, so with ~20k distinct k-mers a Bloom false
positive is improbable (about 20e3 * (20e3/1e6)**4 = 3e-3 expected);
tests/test_torch_abundance.py holds the histogram to khmer_tpu's where
tracking false positives are frequent."""

import numpy as np
import pytest
import torch

import khmer_tpu
from khmer_tpu_torch import Countgraph, Nodegraph, convert
from khmer_tpu_torch.io.fastx import FastxReader

K = 20
SIZE = 1000000
N_TABLES = 4


def write_reads(path, seed=5, n_reads=4000, genome_len=20000, readlen=100,
                repeats=300):
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), genome_len)
    starts = rng.integers(0, genome_len - readlen, n_reads)
    seqs = [genome[s:s + readlen].tobytes().decode() for s in starts]
    # a few lowercase and N bases exercise the loader's cleaning
    seqs[0] = seqs[0][:10] + "N" + seqs[0][11:50].lower() + seqs[0][50:]
    seqs += [seqs[1]] * repeats
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))
    return seqs


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cg")
    fa = str(d / "reads.fa")
    seqs = write_reads(fa)

    j = khmer_tpu.Countgraph(K, SIZE, N_TABLES)
    j.set_use_bigcount(True)
    j_consumed = j.consume_seqfile(fa)
    j_ct = str(d / "jax.ct")
    j.save(j_ct)
    j_track = khmer_tpu.Nodegraph(K, 1, 1, primes=j.hashsizes())
    j_hist = j.abundance_distribution(fa, j_track)
    j_loaded = khmer_tpu.Countgraph.load(j_ct)
    j_loaded_hist = j_loaded.abundance_distribution(
        fa, khmer_tpu.Nodegraph(K, 1, 1, primes=j.hashsizes()))

    p = Countgraph(K, SIZE, N_TABLES, device="cpu")
    p.set_use_bigcount(True)
    p_consumed = p.consume_seqfile(fa)
    p_ct = str(d / "port.ct")
    p.save(p_ct)
    return dict(dir=d, fa=fa, seqs=seqs, j=j, p=p, j_ct=j_ct, p_ct=p_ct,
                j_consumed=j_consumed, p_consumed=p_consumed,
                j_hist=j_hist, j_loaded_hist=j_loaded_hist,
                j_table=np.asarray(j.storage.table))


def _queries(seqs):
    return seqs[:40] + [seqs[1]]


def test_consume_counters_match(data):
    j, p = data["j"], data["p"]
    assert data["p_consumed"] == data["j_consumed"]
    assert p.n_unique_kmers() == j.n_unique_kmers()
    assert p.n_occupied() == j.n_occupied()
    np.testing.assert_array_equal(
        p.storage.table.numpy().view(np.uint32), data["j_table"])
    assert p.n_unique_kmers() > 15000


def test_kmer_counts_match(data):
    j, p = data["j"], data["p"]
    for s in _queries(data["seqs"]):
        assert p.get_kmer_counts(s) == j.get_kmer_counts(s)
    assert min(p.get_kmer_counts(data["seqs"][1])) > 300
    kmer = data["seqs"][2][:K]
    assert p.get(kmer) == j.get(kmer)
    assert p.get_kmer_hashes(data["seqs"][3]) == \
        j.get_kmer_hashes(data["seqs"][3])


def test_saved_ct_bytes_match(data):
    with open(data["p_ct"], "rb") as a, open(data["j_ct"], "rb") as b:
        pb, jb = a.read(), b.read()
    assert pb == jb
    # the bigcount section holds the repeated read's k-mers
    assert int.from_bytes(pb[-8 - 10 * 81: -10 * 81], "little") == 81


def test_abundance_distribution_matches(data):
    p = data["p"]
    tracking = Nodegraph(K, 1, 1, primes=p.hashsizes(), device="cpu")
    hist = p.abundance_distribution(data["fa"], tracking)
    assert hist == data["j_hist"]
    assert sum(hist[301:]) == 81


def test_load_jax_ct_gives_same_counts(data):
    """A .ct written by khmer_tpu loads into the port: the same counts
    (bigcounts overlaid on saturated reads) and the same histogram."""
    loaded = Countgraph.load(data["j_ct"], device="cpu")
    j = khmer_tpu.Countgraph.load(data["j_ct"])
    for s in _queries(data["seqs"]):
        assert loaded.get_kmer_counts(s) == j.get_kmer_counts(s)
    assert loaded.n_occupied() == j.n_occupied()
    tracking = Nodegraph(K, 1, 1, primes=loaded.hashsizes(), device="cpu")
    hist = loaded.abundance_distribution(data["fa"], tracking)
    assert hist == data["j_loaded_hist"]
    assert sum(hist[301:]) == 81


def test_countgraph_from_numpy(data):
    j = data["j"]
    st = j.storage
    cg = convert.countgraph_from_numpy(
        K, j.hashsizes(), data["j_table"], j.n_unique_kmers(),
        st.bigcount_candidates, st.bigcounts, j.get_use_bigcount(),
        device="cpu")
    for s in _queries(data["seqs"]):
        assert cg.get_kmer_counts(s) == j.get_kmer_counts(s)
    assert cg.n_unique_kmers() == j.n_unique_kmers()
    out = str(data["dir"] / "converted.ct")
    cg.save(out)
    with open(out, "rb") as a, open(data["j_ct"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("source", ["native-chunk-997", "python-parser"])
def test_split_invariance(data, source):
    """Other chunk sizes and the Python _FlatBatcher path give the same
    table and n_unique as the default chunk."""
    cg = Countgraph(K, SIZE, N_TABLES, device="cpu")
    if source == "python-parser":
        n = cg.consume_seqfile(FastxReader(data["fa"]), chunk=4099)
    else:
        n = cg.consume_seqfile(data["fa"], chunk=997)
    assert n == data["p_consumed"]
    assert cg.n_unique_kmers() == data["p"].n_unique_kmers()
    assert torch.equal(cg.storage.table, data["p"].storage.table)


def test_gzip_fastq_at_k32_matches(data):
    """k = 32 puts half the hashes above 2**63 (unsigned compare and
    modulo in every table); the input is gzip FASTQ through the native
    loader."""
    import gzip

    fq = str(data["dir"] / "reads.fq.gz")
    with gzip.open(fq, "wt") as f:
        for i, s in enumerate(data["seqs"][:1500]):
            f.write("@r%d\n%s\n+\n%s\n" % (i, s, "I" * len(s)))
    j = khmer_tpu.Countgraph(32, 100003, 3)
    p = Countgraph(32, 100003, 3, device="cpu")
    assert p.consume_seqfile(fq) == j.consume_seqfile(fq)
    assert p.n_unique_kmers() == j.n_unique_kmers()
    np.testing.assert_array_equal(p.storage.table.numpy().view(np.uint32),
                                  np.asarray(j.storage.table))
    assert max(p.get_kmer_hashes(data["seqs"][5])) >= 1 << 63


def test_consume_matches_for_single_sequences(data):
    """Countgraph.consume (raw sequence, no cleaning) against khmer_tpu."""
    j = khmer_tpu.Countgraph(K, 10007, 2)
    p = Countgraph(K, 10007, 2, device="cpu")
    for s in data["seqs"][:30] + ["ACGTNacgt" * 5]:
        assert p.consume(s) == j.consume(s)
    assert p.n_unique_kmers() == j.n_unique_kmers()
    np.testing.assert_array_equal(p.storage.table.numpy().view(np.uint32),
                                  np.asarray(j.storage.table))

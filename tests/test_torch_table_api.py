"""Port parity of the rest of the table API (slices 2b and 3c):
khmer_tpu_torch against khmer_tpu on the same generated reads.

get_kmers, n_tables and get_raw_tables (per-table OXLI bytes of a
Countgraph, a SmallCountgraph and a Nodegraph), consume_fasta and
consume_fasta_with_reads_parser, Nodegraph.update / update_from, the
abundance_distribution_with_reads_parser alias and
get_kmer_hashes_as_hashset on tables of 4 x 20011 bins at k = 20 (one
table for new_hashtable); the
hash helpers forward_hash, forward_hash_no_rc, reverse_hash and
reverse_complement; get_n_primes_near_x and is_prime;
extract_nodegraph_info and __version_cpp__; FastxParser and
SanitizedFastxParser records; ThreadedSequenceProcessor's output;
HashSet, Kmer, Hashbits, new_hashbits and new_hashtable; the two
positional dumps' output.  Integer data: exact equality."""

import io

import numpy as np
import pytest

import khmer_tpu
import khmer_tpu.parsing
import khmer_tpu.thread_utils
import khmer_tpu_torch
from khmer_tpu_torch import parsing, thread_utils

K = 20
SIZE = 20011
N_TABLES = 4
KMERS = ["ACGTACGTACGTACGTACGT", "TTTTTTTTTTTTTTTTTTTT",
         "GATTACAGATTACAGATTAC", "CCCCGGGGAAAATTTTACGT"]


def _reads(seed, n=80, genome_len=3000, readlen=100):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    starts = rng.integers(0, genome_len - readlen, n)
    return [genome[s:s + readlen] for s in starts]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """reads.fa (80 reads, one with N and lowercase bases, one shorter
    than k), reads.fq (the same as FASTQ, paired names) and the two
    halves of reads.fa."""
    d = tmp_path_factory.mktemp("torch_table_api")
    reads = _reads(11)
    reads[5] = reads[5][:40] + "NNacgtN" + reads[5][47:]
    reads.append("ACGTAC")
    out = {"dir": d, "reads": reads}
    for name, part in (("reads.fa", reads), ("a.fa", reads[:40]),
                       ("b.fa", reads[40:])):
        with open(d / name, "w") as f:
            for i, s in enumerate(part):
                f.write(">r%d\n%s\n" % (i, s))
        out[name] = str(d / name)
    with open(d / "reads.fq", "w") as f:
        for i, s in enumerate(reads):
            f.write("@p%d/%d\n%s\n+\n%s\n" % (i // 2, i % 2 + 1, s,
                                              "I" * len(s)))
    out["reads.fq"] = str(d / "reads.fq")
    return out


def _pair(name, *args):
    jc, pc = getattr(khmer_tpu, name), getattr(khmer_tpu_torch, name)
    return jc(*args), pc(*args, device="cpu")


@pytest.fixture(scope="module")
def countgraphs(files):
    """A Countgraph of reads.fa on each side, through consume_fasta."""
    tables = _pair("Countgraph", K, SIZE, N_TABLES)
    got = [t.consume_fasta(files["reads.fa"]) for t in tables]
    assert got[0] == got[1]
    return tables


def _raw(table):
    return [bytes(b) for b in table.get_raw_tables()]


@pytest.mark.parametrize("name", ["Countgraph", "SmallCountgraph",
                                  "Nodegraph"])
def test_raw_tables_and_kmers(files, countgraphs, name):
    if name == "Countgraph":
        j, p = countgraphs
    else:
        j, p = _pair(name, K, SIZE, N_TABLES)
        assert j.consume_fasta(files["reads.fa"]) == \
            p.consume_fasta(files["reads.fa"])
    assert p.n_tables() == j.n_tables() == N_TABLES
    assert _raw(j) == _raw(p)
    assert [len(b) for b in _raw(p)] == list(p.storage.spec.bytes_per_table)
    read = files["reads"][0]
    assert p.get_kmers(read) == j.get_kmers(read)
    assert len(p.get_kmers(read)) == len(read) - K + 1
    with pytest.raises(ValueError):
        p.get_kmers(read[:K - 1])
    hs = [t.get_kmer_hashes_as_hashset(read) for t in (j, p)]
    assert list(hs[0]) == list(hs[1]) and len(hs[1]) > 0


def test_consume_fasta_with_reads_parser(files, countgraphs):
    j, p = _pair("Countgraph", K, SIZE, N_TABLES)
    got = [j.consume_fasta_with_reads_parser(
               khmer_tpu.FastxParser(files["reads.fq"])),
           p.consume_fasta_with_reads_parser(
               khmer_tpu_torch.FastxParser(files["reads.fq"]))]
    assert got[0] == got[1]
    assert _raw(j) == _raw(p) == _raw(countgraphs[1])
    cls = khmer_tpu_torch.Countgraph
    assert cls.abundance_distribution_with_reads_parser is \
        cls.abundance_distribution


def test_nodegraph_update(files):
    """Two Nodegraphs of the two halves; update (and update_from) makes
    the one that consumed the whole file's bytes; n_unique stays."""
    halves = [_pair("Nodegraph", K, SIZE, N_TABLES) for _ in range(2)]
    whole = _pair("Nodegraph", K, SIZE, N_TABLES)
    for (j, p), f in zip(halves, ("a.fa", "b.fa")):
        j.consume_seqfile(files[f])
        p.consume_seqfile(files[f])
    for t in whole:
        t.consume_seqfile(files["reads.fa"])
    (ja, pa), (jb, pb) = halves
    before = pa.n_unique_kmers()
    ja.update(jb)
    pa.update(pb)
    raw = [_raw(t) for t in (ja, pa, whole[1])]
    assert raw[0] == raw[1] == raw[2]
    assert pa.n_unique_kmers() == ja.n_unique_kmers() == before
    assert pa.n_occupied() == ja.n_occupied()
    pb.update_from(pa)
    assert _raw(pb) == raw[2]
    with pytest.raises(ValueError, match="same k size"):
        pa.update(khmer_tpu_torch.Nodegraph(K + 1, SIZE, N_TABLES,
                                            device="cpu"))
    with pytest.raises(ValueError, match="same table sizes"):
        pa.update(khmer_tpu_torch.Nodegraph(K, SIZE + 100, N_TABLES,
                                            device="cpu"))


def test_hash_helpers():
    for kmer in KMERS + ["ACGTNACGTAAAAACCCCGG"]:
        for k in (K, 10, 1):
            for fn in ("forward_hash", "forward_hash_no_rc"):
                assert getattr(khmer_tpu_torch, fn)(kmer, k) == \
                    getattr(khmer_tpu, fn)(kmer, k)
        h = khmer_tpu_torch.forward_hash_no_rc(kmer, K)
        assert khmer_tpu_torch.reverse_hash(h, K) == \
            khmer_tpu.reverse_hash(h, K)
        assert khmer_tpu_torch.reverse_complement(kmer) == \
            khmer_tpu.reverse_complement(kmer)
    assert khmer_tpu_torch.reverse_complement("ACGTRYKMN") == \
        khmer_tpu.reverse_complement("ACGTRYKMN")
    for mod in (khmer_tpu, khmer_tpu_torch):
        with pytest.raises(ValueError):
            mod.forward_hash("ACGT" * 9, 33)
        with pytest.raises(TypeError):
            mod.reverse_hash("ACGT", 4)


def test_prime_helpers():
    for x, n in ((20011, 4), (1e8, 4), (100, 1), (1000, 7)):
        assert khmer_tpu_torch.get_n_primes_near_x(n, x) == \
            khmer_tpu.get_n_primes_near_x(n, x)
    for n in (0, 1, 2, 3, 4, 97, 100, 20011, 2 ** 31 - 1, 2 ** 31 + 1):
        assert khmer_tpu_torch.is_prime(n) == khmer_tpu.is_prime(n)


def test_file_info_and_version(files):
    j, p = _pair("Nodegraph", K, SIZE, N_TABLES)
    d = files["dir"]
    for t, f in ((j, "j.ng"), (p, "p.ng")):
        t.consume_seqfile(files["reads.fa"])
        t.save(str(d / f))
    assert khmer_tpu_torch.extract_nodegraph_info(str(d / "p.ng")) == \
        khmer_tpu.extract_nodegraph_info(str(d / "j.ng"))
    with open(d / "bad.ng", "wb") as f:
        f.write(b"NOPE" + bytes(30))
    for mod in (khmer_tpu, khmer_tpu_torch):
        with pytest.raises(ValueError, match="missing file type"):
            mod.extract_nodegraph_info(str(d / "bad.ng"))
    assert khmer_tpu_torch.__version_cpp__() == khmer_tpu.__version_cpp__()


def _records(parser):
    return [(r.name, r.sequence, getattr(r, "quality", None),
             r.cleaned_seq) for r in parser]


def test_parsers(files, tmp_path):
    for f in ("reads.fa", "reads.fq"):
        assert _records(khmer_tpu_torch.FastxParser(files[f])) == \
            _records(khmer_tpu.FastxParser(files[f]))
    bad = tmp_path / "bad.fa"
    bad.write_text(">a\nACGTN\n>b\nACGXT\n>c\nacgt\n")
    got = []
    for mod in (khmer_tpu.parsing, parsing):
        p = mod.SanitizedFastxParser(str(bad))
        got.append(([r.sequence for r in p], p.n_bad))
    assert got[0] == got[1] == (["ACGTA", "ACGT"], 1)
    pairs = [list((n, ip, a.name, b.name if b else None)
                  for n, ip, a, b in mod.BrokenPairedReader(
                      mod.FastxParser(files["reads.fq"])))
             for mod in (khmer_tpu.parsing, parsing)]
    assert pairs[0] == pairs[1] and pairs[1][0][1]
    assert parsing.Alphabets.get("DNAN_SIMPLE") == "ACGTN"
    s = parsing.Sequence("x", "acgNt")
    assert (s.cleaned_seq, len(s)) == \
        (khmer_tpu.parsing.Sequence("x", "acgNt").cleaned_seq, 5)


def test_threaded_sequence_processor(files):
    """One worker: the output is in input order on both sides."""
    def process(record):
        seq = record.sequence
        return (record.name, seq[:50]) if "N" not in seq else (None, None)

    outs = []
    for mod in (khmer_tpu.thread_utils, thread_utils):
        tsp = mod.ThreadedSequenceProcessor(process, n_workers=1,
                                            verbose=False)
        buf = io.StringIO()
        tsp.start(mod.verbose_loader(files["reads.fq"]), buf)
        outs.append((buf.getvalue(), tsp.n_processed, tsp.n_written,
                     tsp.bp_processed, tsp.bp_written))
    assert outs[0] == outs[1]
    assert outs[1][1] == len(files["reads"]) > outs[1][2] > 0


def test_hashset_and_kmer():
    h = [khmer_tpu.HashSet(K, [5, 1, 9]), khmer_tpu_torch.HashSet(K,
                                                                   [5, 1, 9])]
    for s in h:
        s.add(3)
        s.remove(5)
        s += type(s)(K, [100])
    assert list(h[0]) == list(h[1]) == [1, 3, 9, 100]
    for mod in (khmer_tpu, khmer_tpu_torch):
        s = mod.HashSet(K, [mod.forward_hash_no_rc(KMERS[2], K)])
        assert KMERS[2] in s
        with pytest.raises(ValueError):
            s.remove(7)
        with pytest.raises(ValueError, match="different ksize"):
            s + mod.HashSet(K + 1)
    for kmer in KMERS:
        a, b = khmer_tpu.Kmer(kmer), khmer_tpu_torch.Kmer(kmer)
        assert (a.kmer_f, a.kmer_r, a.kmer_u, a.is_forward, str(a)) == \
            (b.kmer_f, b.kmer_r, b.kmer_u, b.is_forward, str(b))
        a.reverse_complement()
        b.reverse_complement()
        assert (str(a), a.kmer_f, a.is_forward) == \
            (str(b), b.kmer_f, b.is_forward)
        c = [m.Kmer.create(a.kmer_u, K) for m in (khmer_tpu,
                                                   khmer_tpu_torch)]
        assert (str(c[0]), c[0].kmer_u) == (str(c[1]), c[1].kmer_u)


def test_legacy_names(files):
    j = [khmer_tpu.new_hashtable(K, SIZE),
         khmer_tpu.new_hashbits(K, SIZE, N_TABLES),
         khmer_tpu.Hashbits(K, SIZE, N_TABLES)]
    p = [khmer_tpu_torch.new_hashtable(K, SIZE, device="cpu"),
         khmer_tpu_torch.new_hashbits(K, SIZE, N_TABLES, device="cpu"),
         khmer_tpu_torch.Hashbits(K, SIZE, N_TABLES, device="cpu")]
    assert isinstance(p[1], khmer_tpu_torch.Hashbits)
    assert isinstance(p[2], khmer_tpu_torch.Nodegraph)
    assert [a.hashsizes() for a in j] == [b.hashsizes() for b in p]
    assert p[0].n_tables() == 1
    for a, b in zip(j[1:], p[1:]):
        assert a.consume_seqfile(files["reads.fa"]) == \
            b.consume_seqfile(files["reads.fa"])
        assert [a.get(x) for x in KMERS] == [b.get(x) for x in KMERS]


def test_positional_dumps(files, countgraphs):
    d = files["dir"]
    for t, f in zip(countgraphs, ("j.freq", "p.freq")):
        t.output_fasta_kmer_pos_freq(files["reads.fa"], str(d / f))
    with open(d / "j.freq", "rb") as a, open(d / "p.freq", "rb") as b:
        freq = b.read()
        assert a.read() == freq and freq.count(b"\n") == len(files["reads"])
    for limit in (0, 2):
        got = [t.fasta_count_kmers_by_position(files["reads.fa"], 100,
                                               limit) for t in countgraphs]
        assert got[0] == got[1] and got[1][0] > 0

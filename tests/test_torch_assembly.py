"""Port parity of the assemblers (slice 4c): khmer_tpu_torch
(device="cpu") against khmer_tpu on the same generated graphs.

The graph shapes of tests/graph_features.py at k = 21, generated here
from a seed: a linear path, a circle, a tip, a SNP bubble, a triple fork
and tandem repeats, each in a Countgraph and a Nodegraph of 4 x 5003
bins.  khmer_tpu takes a device call for every assembler step, so the
paths stay short (200 bases).

Held equal: LinearAssembler's assemble, assemble_left and
assemble_right from the first, a middle and the last k-mer (as strings,
hashes and Kmer objects) and from an absent one, with and without a stop
filter; Hashgraph.assemble_linear_path; JunctionCountAssembler's
consume (returns and junction table) and assemble;
SimpleLabeledAssembler's assemble over labels made both ways (labelled
consumes and label_across_high_degree_nodes).  Strings: exact
equality."""

import numpy as np
import pytest

import khmer_tpu
import khmer_tpu_torch

K = 21
SIZE = 5003
N_TABLES = 4
LENGTH = 200
SHAPES = ("linear", "circle", "tip", "bubble", "triple_fork", "tandem")
KINDS = ("Countgraph", "Nodegraph")


def _random(rng, n):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)] \
        .tobytes().decode()


def _other(base, j):
    return "ACGT".replace(base, "")[j]


def shape_reads(name, seed=21):
    """The sequences that make one graph shape (graph_features.py), and
    the main path's sequence."""
    rng = np.random.default_rng(seed + SHAPES.index(name))
    seq = _random(rng, LENGTH)
    p = LENGTH // 2
    if name == "linear":
        return [seq], seq
    if name == "circle":
        return [seq + seq[:K]], seq
    if name == "tip":
        return [seq, seq[p - K + 1: p + 1] + _random(rng, 2 * K)], seq
    if name == "bubble":
        return [seq, seq[:p] + _other(seq[p], 0) + seq[p + 1:]], seq
    if name == "triple_fork":
        return [seq] + [seq[p - K + 1: p + 1] + _other(seq[p + 1], j) +
                        _random(rng, 2 * K) for j in range(2)], seq
    unit = seq[:47]
    return [seq[:80] + unit * 5 + seq[80:]], seq


def build(kind, seqs):
    """The same graph in both packages."""
    jg = getattr(khmer_tpu, kind)(K, SIZE, N_TABLES)
    pg = getattr(khmer_tpu_torch, kind)(K, SIZE, N_TABLES, device="cpu")
    for s in seqs:
        jg.consume(s)
        pg.consume(s)
    return jg, pg


def seeds(seq, g):
    """Seeds from the path's start, middle and end, as strings, a hash and
    Kmer objects, and one absent k-mer."""
    mid = seq[LENGTH // 2 - 3: LENGTH // 2 - 3 + K]
    return [seq[:K], mid, seq[-K:], g.hash(mid),
            "ACGT" * 5 + "A"]


def stop_filters(seq):
    """A Nodegraph in both packages holding one k-mer of the path."""
    js = khmer_tpu.Nodegraph(K, SIZE, N_TABLES)
    ps = khmer_tpu_torch.Nodegraph(K, SIZE, N_TABLES, device="cpu")
    kmer = seq[2 * LENGTH // 3: 2 * LENGTH // 3 + K]
    js.count(kmer)
    ps.count(kmer)
    return js, ps


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_linear_assembler(shape, kind):
    seqs, seq = shape_reads(shape)
    jg, pg = build(kind, seqs)
    js, ps = stop_filters(seq)
    ja = khmer_tpu.LinearAssembler(jg)
    pa = khmer_tpu_torch.LinearAssembler(pg)
    for seed in seeds(seq, jg):
        assert pa.assemble(seed) == ja.assemble(seed), seed
    for seed in seeds(seq, jg)[1:3]:
        assert pa.assemble_left(seed) == ja.assemble_left(seed), seed
        assert pa.assemble_right(seed) == ja.assemble_right(seed), seed
    assert pa.assemble(khmer_tpu_torch.Kmer(seq[5:5 + K])) == \
        ja.assemble(khmer_tpu.Kmer(seq[5:5 + K]))
    assert ja.assemble(seq[:K])  # the path exists
    # with a stop filter
    ja.set_stop_filter(js)
    pa.set_stop_filter(ps)
    assert pa.assemble(seq[:K]) == ja.assemble(seq[:K])
    assert pa.assemble_left(seq[-K:]) == ja.assemble_left(seq[-K:])
    assert pg.assemble_linear_path(seq[:K], ps) == \
        jg.assemble_linear_path(seq[:K], js)
    assert pg.assemble_linear_path(seq[:K]) == \
        jg.assemble_linear_path(seq[:K])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", ("bubble", "triple_fork"))
def test_junction_count_assembler(shape, kind):
    seqs, seq = shape_reads(shape)
    jg, pg = build(kind, [])
    ja = khmer_tpu.JunctionCountAssembler(jg)
    pa = khmer_tpu_torch.JunctionCountAssembler(pg)
    # the shape's reads, the main path twice more (its junctions pass 2)
    for s in seqs + [seq, seq]:
        assert pa.consume(s) == ja.consume(s)
    for a in (ja, pa):
        with pytest.raises(ValueError):
            a.consume(seq[:15])
    assert bytes(np.asarray(ja.junctions.storage.raw_bytes())) == \
        bytes(pa.junctions.storage.raw_bytes())
    assert pa.junctions.n_unique_kmers() == ja.junctions.n_unique_kmers()
    assert bytes(np.asarray(jg.storage.raw_bytes())) == \
        bytes(pg.storage.raw_bytes())
    for seed in seeds(seq, jg)[:2]:
        assert pa.assemble(seed) == ja.assemble(seed)
    js, ps = stop_filters(seq)
    ja.set_stop_filter(js)
    pa.set_stop_filter(ps)
    assert pa.assemble(seq[:K]) == ja.assemble(seq[:K])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", ("tip", "triple_fork"))
def test_simple_labeled_assembler(shape, kind, tmp_path):
    seqs, seq = shape_reads(shape)
    fa = tmp_path / "reads.fa"
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))
    jg, pg = build(kind, [])
    jl = khmer_tpu.GraphLabels(jg)
    pl = khmer_tpu_torch.GraphLabels(pg)
    assert pl.consume_seqfile_and_tag_with_labels(str(fa)) == \
        jl.consume_seqfile_and_tag_with_labels(str(fa))
    # every read labelled across the high-degree nodes, as
    # assemble-on-the-go does, under labels of its own
    for i, s in enumerate(seqs):
        jh = jg.find_high_degree_nodes(s)
        ph = pg.find_high_degree_nodes(s)
        assert sorted(ph) == sorted(jh)
        jl.label_across_high_degree_nodes(s, jh, 10 + i)
        pl.label_across_high_degree_nodes(s, ph, 10 + i)
    assert pl.tag_labels == jl.tag_labels
    assert pg.all_tags == jg.all_tags
    js, ps = stop_filters(seq)
    ja = khmer_tpu.SimpleLabeledAssembler(jl)
    pa = khmer_tpu_torch.SimpleLabeledAssembler(pl)
    for seed in seeds(seq, jg)[:3]:
        assert pa.assemble(seed) == ja.assemble(seed), seed
    ja.set_stop_filter(js)
    pa.set_stop_filter(ps)
    assert pa.assemble(seq[:K]) == ja.assemble(seq[:K])
    assert pl.assemble_labeled_path(seq[:K]) == \
        jl.assemble_labeled_path(seq[:K])

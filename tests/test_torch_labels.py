"""Port parity of GraphLabels (slice 4c): khmer_tpu_torch (device="cpu")
against khmer_tpu on the same generated reads.

Inputs: a small metagenome (test_torch_partition.write_metagenome: a read
shorter than k, one with an N, one with lowercase bases), written plain
and with partition ids in the names, and a lump of eight 700-base sequences
sharing a 200-base core (test_torch_traversal.write_lump); Nodegraphs and
Countgraphs of 4 x 10007 bins at k = 20.

Held equal: both labelled consumes (returns, tags, the tag<->label maps,
table bytes), also with the port's batch cut to 7 reads and with a bad
partitioned name; sweep_tag_neighborhood and sweep_label_neighborhood at
radius 0, 5 and None, with stop tags and with the big-traversal abort;
get_labels_for_sequence, label_across_high_degree_nodes, get_tag_labels
and get_tags_from_label; the saved labels file byte for byte, and each
load error (signature, version, type, k, truncated).  The batched sweep
is held to one sweep per read.  Integer data: exact equality."""

import os
import struct

import numpy as np
import pytest

import khmer_tpu
import khmer_tpu_torch
from khmer_tpu_torch import labeling
from .test_torch_partition import write_metagenome
from .test_torch_traversal import write_lump

K = 20
SIZE = 10007
N_TABLES = 4
KINDS = ("Nodegraph", "Countgraph")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_labels")
    meta = str(d / "meta.fa")
    seqs = write_metagenome(meta, seed=12, n_genomes=6, n_reads=120)
    part = str(d / "part.fa")
    with open(part, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\t%d\n%s\n" % (i, i % 5, s))
    bad = str(d / "bad.fa")
    with open(bad, "w") as f:
        for i, s in enumerate(seqs[:30]):
            name = "r%d" % i if i == 20 else "r%d\t%d" % (i, i % 3)
            f.write(">%s\n%s\n" % (name, s))
    lump = str(d / "lump.fa")
    lump_seqs = write_lump(lump, 4, flank=250)
    return {"meta": meta, "part": part, "bad": bad, "lump": lump,
            "seqs": seqs, "lump_seqs": lump_seqs}


def labels_pair(kind):
    return (khmer_tpu.GraphLabels(getattr(khmer_tpu, kind)(
                K, SIZE, N_TABLES)),
            khmer_tpu_torch.GraphLabels(getattr(khmer_tpu_torch, kind)(
                K, SIZE, N_TABLES, device="cpu")))


def same_state(jl, pl):
    assert pl.tag_labels == jl.tag_labels
    assert pl.label_tag == jl.label_tag
    assert pl.all_labels == jl.all_labels
    assert pl.graph.all_tags == jl.graph.all_tags
    assert bytes(pl.graph.storage.raw_bytes()) == \
        bytes(np.asarray(jl.graph.storage.raw_bytes()))
    assert pl.graph.n_unique_kmers() == jl.graph.n_unique_kmers()


@pytest.fixture(scope="module")
def labelled(files):
    """(khmer_tpu, port) GraphLabels of the partitioned metagenome in a
    Nodegraph, a seventh of the tags stop tags on both."""
    jl, pl = labels_pair("Nodegraph")
    assert pl.consume_partitioned_fasta_and_tag_with_labels(files["part"]) \
        == jl.consume_partitioned_fasta_and_tag_with_labels(files["part"])
    stops = sorted(jl.graph.all_tags)[::7]
    for g in (jl.graph, pl.graph):
        g.stop_tags = set(stops)
    return jl, pl


@pytest.mark.parametrize("batch", [labeling.LABEL_BATCH, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_consumes_with_labels(files, kind, batch, monkeypatch):
    monkeypatch.setattr(labeling, "LABEL_BATCH", batch)
    jl, pl = labels_pair(kind)
    got = pl.consume_seqfile_and_tag_with_labels(files["meta"])
    assert got == jl.consume_seqfile_and_tag_with_labels(files["meta"])
    assert got[0] == len(files["seqs"])
    # read 3 is shorter than k and takes label 3 all the same
    assert 3 not in pl.all_labels and 4 in pl.all_labels
    same_state(jl, pl)
    jl, pl = labels_pair(kind)
    assert pl.consume_partitioned_fasta_and_tag_with_labels(files["part"]) \
        == jl.consume_partitioned_fasta_and_tag_with_labels(files["part"])
    same_state(jl, pl)
    assert pl.n_labels == 5 and pl.labels() == jl.labels()


@pytest.mark.parametrize("batch", [labeling.LABEL_BATCH, 7])
def test_bad_partitioned_name(files, batch, monkeypatch):
    monkeypatch.setattr(labeling, "LABEL_BATCH", batch)
    jl, pl = labels_pair("Countgraph")
    errs = []
    for gl in (jl, pl):
        with pytest.raises(ValueError) as err:
            gl.consume_partitioned_fasta_and_tag_with_labels(files["bad"])
        errs.append(str(err.value))
    assert errs[0] == errs[1] and "r20" in errs[1]
    same_state(jl, pl)


def test_sequence_consume_and_queries(files):
    jl, pl = labels_pair("Countgraph")
    for i, s in enumerate(files["seqs"][:60]):
        if len(s) >= K:
            assert pl.consume_sequence_and_tag_with_labels(s, i % 4) == \
                jl.consume_sequence_and_tag_with_labels(s, i % 4)
    same_state(jl, pl)
    for s in files["seqs"][60:90]:
        if len(s) < K:
            continue
        assert pl.get_labels_for_sequence(s) == \
            jl.get_labels_for_sequence(s)
        jh = jl.graph.find_high_degree_nodes(s)
        ph = pl.graph.find_high_degree_nodes(s)
        jl.label_across_high_degree_nodes(s, jh, 9)
        pl.label_across_high_degree_nodes(s, ph, 9)
    # a high-degree node in the middle of a read, and at its ends
    s = files["seqs"][0]
    hashes = pl.graph.get_kmer_hashes(s)
    for hdns in ([hashes[10]], [hashes[0], hashes[-1]]):
        jl.label_across_high_degree_nodes(s, hdns, 11)
        pl.label_across_high_degree_nodes(s, hdns, 11)
    same_state(jl, pl)
    for tag in sorted(pl.graph.all_tags)[:40] + [12345]:
        assert pl.get_tag_labels(tag) == jl.get_tag_labels(tag)
    kmer = s[:K]
    assert pl.get_tag_labels(kmer) == jl.get_tag_labels(kmer)
    for label in range(12):
        assert pl.get_tags_from_label(label) == \
            jl.get_tags_from_label(label)
    jl.link_tag_and_label(kmer, 40)
    pl.link_tag_and_label(kmer, 40)
    same_state(jl, pl)


@pytest.mark.parametrize("radius", [0, 5, None])
def test_sweeps(files, labelled, radius):
    jl, pl = labelled
    reads = [s for s in files["seqs"] if len(s) >= K][:25]
    for s in reads:
        for stop in (False, True):
            assert sorted(pl.sweep_tag_neighborhood(s, radius, stop)) == \
                sorted(jl.sweep_tag_neighborhood(s, radius, stop))
            assert pl.sweep_label_neighborhood(s, radius, stop) == \
                jl.sweep_label_neighborhood(s, radius, stop)
    batch = files["seqs"][:40] + ["ACGT"]
    for stop in (False, True):
        assert pl.sweep_label_neighborhood_batch(batch, radius, stop) == \
            [pl.sweep_label_neighborhood(s, radius, stop) for s in batch]


@pytest.fixture(scope="module")
def lump_labels(files):
    """The lump consumed without tags and then tagged at the first and
    the last k-mer of each sequence, each tag its sequence's label: a
    sweep from a short read outgrows 200 * len(read) k-mers before it
    meets most tags."""
    jl, pl = labels_pair("Nodegraph")
    for i, s in enumerate(files["lump_seqs"]):
        jl.graph.consume(s)
        pl.graph.consume(s)
        for h in pl.graph.get_kmer_hashes(s)[::len(s) - K]:
            for gl in (jl, pl):
                gl.graph.add_tag(h)
                gl.link_tag_and_label(h, i)
    return jl, pl


@pytest.mark.parametrize("radius", [5, 60, 400])
def test_sweep_abort(files, lump_labels, radius):
    jl, pl = lump_labels
    seqs = files["lump_seqs"]
    reads = [seqs[0][350:370], seqs[1][:25], seqs[2][500:560],
             seqs[3][245:270], seqs[4], "ACGT" * 6]
    for big in (False, True):
        want = [jl.sweep_label_neighborhood(s, radius, False, big)
                for s in reads]
        assert [pl.sweep_label_neighborhood(s, radius, False, big)
                for s in reads] == want
        assert pl.sweep_label_neighborhood_batch(reads, radius, False,
                                                 big) == want
    if radius == 400:
        jt = jl.graph.partition.sweep_for_tags(reads[0], radius, False, True)
        pt = pl.graph.partition.sweep_for_tags(reads[0], radius, False, True)
        assert pt == jt
        assert pl.graph.partition.sweep_for_tags_batch(
            reads, radius, False, True)[0] == pt
        # the abort cut that sweep short of the lump's every tag
        assert len(pt) < len(pl.graph.partition.sweep_for_tags(
            reads[0], radius, False, False))


def test_save_and_load(labelled, tmp_path):
    jl, pl = labelled
    jf, pf = str(tmp_path / "j.labels"), str(tmp_path / "p.labels")
    jl.save_labels_and_tags(jf)
    pl.save_labels_and_tags(pf)
    with open(jf, "rb") as a, open(pf, "rb") as b:
        data = a.read()
        assert b.read() == data
    assert data[:6] == b"OXLI\x04\x06" and len(data) == 18 + 16 * sum(
        len(v) for v in pl.tag_labels.values())
    g = khmer_tpu_torch.Nodegraph(K, SIZE, N_TABLES, device="cpu")
    loaded = khmer_tpu_torch.GraphLabels.load(pf, g)
    assert loaded.tag_labels == pl.tag_labels
    assert g.all_tags == set(pl.tag_labels)

    def corrupt(name, blob):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(blob)
        return path

    cases = {
        "signature": corrupt("sig", b"OXLX" + data[4:]),
        "version": corrupt("ver", data[:4] + b"\x03" + data[5:]),
        "type": corrupt("type", data[:5] + b"\x03" + data[6:]),
        "k": corrupt("k", data[:6] + struct.pack("<I", 21) + data[10:]),
        "truncated": corrupt("trunc", data[:-5]),
        "short header": corrupt("short", data[:4]),
        "empty": corrupt("empty", b""),
    }
    for name, path in cases.items():
        errs = []
        for mod in (khmer_tpu, khmer_tpu_torch):
            graph = mod.Nodegraph(K, SIZE, N_TABLES,
                                  **({} if mod is khmer_tpu
                                     else {"device": "cpu"}))
            with pytest.raises(OSError) as err:
                mod.GraphLabels(graph).load_labels_and_tags(path)
            errs.append((type(err.value).__name__,
                         str(err.value).replace(os.sep, "/")))
        assert errs[0] == errs[1], name


def test_constructors():
    cl = khmer_tpu_torch.labeling.CountGraphLabels(K, 1000, 2,
                                                   device="cpu")
    nl = khmer_tpu_torch.GraphLabels.NodeGraphLabels(K, 1000, 2,
                                                     device="cpu")
    assert isinstance(cl.graph, khmer_tpu_torch.Countgraph)
    assert isinstance(nl.graph, khmer_tpu_torch.Nodegraph)
    assert khmer_tpu_torch.labeling.LabelHash is khmer_tpu_torch.GraphLabels
    assert cl.graph.hashsizes() == \
        khmer_tpu.labeling.CountGraphLabels(K, 1000, 2).graph.hashsizes()

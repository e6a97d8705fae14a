"""Port parity of the ReadAligner (slice 4c) and of the host count
snapshot it searches: khmer_tpu_torch (device="cpu") against khmer_tpu
on the same generated reads.

Input: reads of 100 bases over a random 3-kb genome, with substitutions,
deletions and insertions; Countgraphs of 4 x 10007 bins at k = 20.

Held equal: align, align_forward and align_many (strings, truncation
and coverage exactly, scores within 1e-9), with the default matrices and
with a params file written by the test; the native search against the
Python one (as tests/test_read_aligner.py holds khmer_tpu's); the next
alignments after adds through add_batch and after a write that bypasses
the snapshot.  The snapshot itself is held to get_batch after every
writer of the table, the batch steps of the streaming filters among
them."""

import json

import numpy as np
import pytest
import torch

import khmer_tpu
import khmer_tpu_torch
from khmer_tpu_torch import convert

K = 20
SIZE = 10007
N_TABLES = 4
TOL = 1e-9


def make_reads(seed, n, genome_len=3000, readlen=100):
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, genome_len))
    reads = []
    for i in range(n):
        s = int(rng.integers(0, genome_len - readlen))
        r = list(genome[s: s + readlen])
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, readlen))] = "ACGT"[int(rng.integers(4))]
        if i % 5 == 1:
            del r[int(rng.integers(25, 75))]
        if i % 7 == 2:
            r.insert(int(rng.integers(25, 75)), "ACGT"[i % 4])
        reads.append("".join(r))
    return reads


@pytest.fixture(scope="module")
def graphs():
    reads = make_reads(8, 240)
    jg = khmer_tpu.Countgraph(K, SIZE, N_TABLES)
    pg = khmer_tpu_torch.Countgraph(K, SIZE, N_TABLES, device="cpu")
    for r in reads[:160]:
        jg.consume(r)
        pg.consume(r)
    return jg, pg, reads


def same(a, b):
    """Alignment tuples equal, the score within TOL."""
    assert len(a) == len(b)
    assert abs(a[0] - b[0]) <= TOL or a[0] == b[0]
    assert a[1:] == b[1:]


def test_align_and_forward(graphs):
    jg, pg, reads = graphs
    ja = khmer_tpu.ReadAligner(jg, 2, 1.0)
    pa = khmer_tpu_torch.ReadAligner(pg, 2, 1.0)
    for r in reads[150:200] + [reads[0][:K], "ACGT" * 25]:
        same(ja.align(r), pa.align(r))
        same(ja.align_forward(r), pa.align_forward(r))
    for ja_, pa_ in zip(ja.align_many(reads[180:240]),
                        pa.align_many(reads[180:240])):
        same(ja_, pa_)
    assert pa.align_many([]) == []
    for a in (ja, pa):
        with pytest.raises(ValueError):
            a.align(reads[0][:K - 1])
    assert pa.scoring_matrix == ja.scoring_matrix
    assert pa.transition_probabilities == ja.transition_probabilities
    assert pa.defaultScoringMatrix == ja.defaultScoringMatrix
    assert pa.defaultTransitionProbabilities == \
        ja.defaultTransitionProbabilities


def test_params_file(graphs, tmp_path):
    jg, pg, reads = graphs
    trans = khmer_tpu_torch.ReadAligner(pg).transition_probabilities
    params = {"scoring_matrix": [-0.06, -6.5, -0.5, -4.0],
              "transition_probabilities": [
                  [x * 1.1 for x in grp] for grp in trans]}
    path = str(tmp_path / "params.json")
    with open(path, "w") as f:
        json.dump(params, f)
    ja = khmer_tpu.ReadAligner(jg, 1, 0.5, filename=path)
    pa = khmer_tpu_torch.ReadAligner(pg, 1, 0.5, filename=path)
    assert pa.scoring_matrix == ja.scoring_matrix == \
        params["scoring_matrix"]
    assert pa.transition_probabilities == ja.transition_probabilities
    for r in reads[200:230]:
        same(ja.align(r), pa.align(r))
        same(ja.align_forward(r), pa.align_forward(r))


def test_native_matches_python_search(graphs):
    jg, pg, reads = graphs
    al = khmer_tpu_torch.ReadAligner(pg, 2, 1.0)
    native = [al.align(r) for r in reads[150:180]]
    forward = [al.align_forward(r) for r in reads[150:180]]
    al._native_subalign = lambda *a, **k: None  # the Python search
    for a, b in zip(native, [al.align(r) for r in reads[150:180]]):
        same(a, b)
    for a, b in zip(forward, [al.align_forward(r) for r in reads[150:180]]):
        same(a, b)


def test_alignments_follow_the_table():
    """After adds through add_batch (applied to the snapshot) and after
    a load that replaces the table (a new snapshot), the next alignments
    are khmer_tpu's."""
    reads = make_reads(9, 120)
    jg = khmer_tpu.Countgraph(K, SIZE, N_TABLES)
    pg = khmer_tpu_torch.Countgraph(K, SIZE, N_TABLES, device="cpu")
    for r in reads[:40]:
        jg.consume(r)
        pg.consume(r)
    ja = khmer_tpu.ReadAligner(jg, 2, 1.0)
    pa = khmer_tpu_torch.ReadAligner(pg, 2, 1.0)
    for r in reads[100:110]:
        same(ja.align(r), pa.align(r))
    snap = pg.storage.host_table()
    for r in reads[40:80]:
        h = np.asarray(pg.get_kmer_hashes(r), np.uint64)
        jg.storage.add_batch(h)
        pg.storage.add_batch(h)
        for q in reads[100:103]:
            same(ja.align(q), pa.align(q))
    assert pg.storage.host_table() is snap  # kept up by the adds
    other = khmer_tpu_torch.Countgraph(K, SIZE, N_TABLES, device="cpu")
    for r in reads[:100]:
        other.consume(r)
    data = other.storage.raw_bytes()
    jg.storage.set_raw_bytes(data)
    pg.storage.set_raw_bytes(data)
    for r in reads[100:120]:
        same(ja.align(r), pa.align(r))
    assert pg.storage.host_table() is not snap


def _snapshot_equals_counts(g, hashes):
    st = g.storage
    assert np.array_equal(st.host_counts(hashes), st.get_batch(hashes))


@pytest.mark.parametrize("kind", ["Countgraph", "Nodegraph",
                                  "SmallCountgraph"])
def test_snapshot_follows_every_writer(kind):
    """host_counts equals get_batch (capped, no loaded map) after each
    writer of the table, a snapshot taken before each."""
    reads = make_reads(10, 200)
    g = getattr(khmer_tpu_torch, kind)(K, SIZE, N_TABLES, device="cpu")
    hashes = np.unique(np.concatenate(
        [np.asarray(g.get_kmer_hashes(r), np.uint64) for r in reads]))
    pairs = [(reads[i], reads[i + 1]) for i in range(0, 120, 2)]

    def writers():
        yield "consume", lambda: [g.consume(r) for r in reads[:30]]
        yield "add_batch", lambda: g.storage.add_batch(hashes[:500])
        yield "consume_and_tag", lambda: g.consume_seqfile_and_tag(
            [khmer_tpu_torch.Read("r", reads[30])])
        yield "diginorm_batch", lambda: g.diginorm_batch(pairs[:30], 5)
        yield "trim_pass1_batch", lambda: g.trim_pass1_batch(pairs[30:], 3)
        other = getattr(khmer_tpu_torch, kind)(K, SIZE, N_TABLES,
                                              device="cpu")
        other.consume(reads[150])
        yield "set_raw_bytes", lambda: g.storage.set_raw_bytes(
            other.storage.raw_bytes())
        yield "replace_table", lambda: g.storage.replace_table(
            torch.ones_like(g.storage.table))
        if kind == "Nodegraph":
            yield "update", lambda: g.update(other)
        yield "add_lanes", lambda: g.storage.add_lanes(
            torch.from_numpy(hashes[:300].view(np.int64)),
            torch.full((300,), 3, dtype=torch.int32))

    before = g.storage.writes
    for name, write in writers():
        g.storage.host_counts(hashes[:1])  # a snapshot before the write
        write()
        _snapshot_equals_counts(g, hashes)
        assert g.storage.writes > before, name
        before = g.storage.writes
    loaded = convert.table_from_numpy(
        getattr(khmer_tpu_torch, kind), K, g.hashsizes(),
        g.storage.table.numpy().view(np.uint32), device="cpu")
    _snapshot_equals_counts(loaded, hashes)
    assert loaded.storage.writes == 1


def test_snapshot_caps_without_the_bigcount_map():
    """Counts above 255 under bigcount; the snapshot reads min(bins)
    capped at the read cap, with no loaded map, as khmer_tpu's does."""
    read = make_reads(11, 1)[0]
    jg = khmer_tpu.Countgraph(K, SIZE, N_TABLES)
    pg = khmer_tpu_torch.Countgraph(K, SIZE, N_TABLES, device="cpu")
    h = np.asarray(pg.get_kmer_hashes(read), np.uint64)
    for g in (jg, pg):
        g.storage.add_batch(np.repeat(h[:5], 300))
        g.storage.add_batch(h)
    for use in (True, False):
        jg.set_use_bigcount(use)
        pg.set_use_bigcount(use)
        got = pg.storage.host_counts(h)
        assert np.array_equal(got, jg.storage.host_counts(h))
        assert got.max() == (301 if use else 255)

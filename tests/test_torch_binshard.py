"""Port parity of the bin-sharded table (Storage.shard_table): khmer_tpu's
shard_table over the conftest's 8 virtual CPU devices, the port's over
an in-process mesh of S CPU shards.

* khmer_tpu's test_bin_sharded_graph_layer_parity
  (tests/test_parallel.py:299-336) for S = 1, 2, 3 and 4: consume_and_tag
  into a bin-sharded Nodegraph; the table on its unpadded bins, n_unique,
  tags, get, kmer_degree and find_all_tags, and the layout's pieces.
* __graft_entry__.py's 1b: consume_seqfile_and_tag into a bin-sharded
  Nodegraph, then do_partition_device(mesh=), against khmer_tpu's host
  engine (do_partition): the partitions as sets of tags.
* A bin-sharded Countgraph with bigcount: consume_seqfile, the per-read
  count queries (K1 + K20 in place of K5) and the saved .ct against
  khmer_tpu's, and the host snapshot.
* Every table operation outside the slice raises NotImplementedError on a
  bin-sharded table, as does a mesh over a process group.

One table geometry on khmer_tpu's side (4 x ~20,000 bins) at k = 20.
Integer data throughout: exact equality."""

import types

import numpy as np
import pytest
import torch

import khmer_tpu
from khmer_tpu.partitioning import SubsetPartition as JaxSubsetPartition
from khmer_tpu_torch import (Countgraph, Nodegraph, SmallCountgraph,
                             SubsetPartition)
from khmer_tpu_torch.parallel import make_mesh
from khmer_tpu_torch.storage import PIECE_ALIGN

from .test_torch_partition import write_metagenome

K = 20
SIZE, N_TABLES = 20011, 4


def _seqs():
    rng = np.random.default_rng(17)
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, 120))
            for _ in range(30)]


@pytest.fixture(scope="module")
def jax_graph():
    """khmer_tpu's bin-sharded Nodegraph after consume_and_tag of the
    30 reads, and its queries."""
    seqs = _seqs()
    g = khmer_tpu.Nodegraph(K, SIZE, N_TABLES)
    g.storage.shard_table()
    for s in seqs:
        g.consume_and_tag(s)
    n = g.storage.spec.total_bins + 1
    seed = g.hash(seqs[0][:K])
    return dict(
        table=np.asarray(g.storage.table)[:n], n_unique=g.n_unique_kmers(),
        tags=set(g.all_tags),
        get=[g.get(s[:K]) for s in seqs[:6]],
        degree=[g.kmer_degree(s[:K]) for s in seqs[:6]],
        found=set(JaxSubsetPartition(g).find_all_tags(seed).tagged_kmers))


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_bin_sharded_graph_layer_parity(jax_graph, S):
    seqs = _seqs()
    g = Nodegraph(K, SIZE, N_TABLES, device="cpu")
    lay = g.storage.shard_table(make_mesh(["cpu"] * S))
    n = g.storage.spec.total_bins + 1
    assert len(lay.pieces) == S and lay.n_bins == n
    assert lay.bounds[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(lay.bounds, lay.bounds[1:]))
    assert [p.numel() for p in lay.pieces] == [hi - lo
                                              for lo, hi in lay.bounds]
    spec = g.storage.spec
    for _, cut in lay.bounds[:-1]:
        assert any(cut == off + size or
                   (off <= cut < off + size and
                    (cut - off) % PIECE_ALIGN == 0)
                   for size, off in zip(spec.tablesizes, spec.bin_offsets))
    with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
        g.storage.table
    for s in seqs:
        g.consume_and_tag(s)
    assert np.array_equal(g.storage.host_table(), jax_graph["table"])
    # the spare bin stays 0
    assert not lay.pieces[-1][-1]
    assert g.n_unique_kmers() == jax_graph["n_unique"]
    assert g.all_tags == jax_graph["tags"]
    assert [g.get(s[:K]) for s in seqs[:6]] == jax_graph["get"]
    assert [g.kmer_degree(s[:K]) for s in seqs[:6]] == jax_graph["degree"]
    found = SubsetPartition(g).find_all_tags(g.hash(seqs[0][:K]))
    assert set(found.tagged_kmers) == jax_graph["found"]


@pytest.mark.parametrize("S", [3, 4])
def test_sharded_tag_then_partition_device(tmp_path, S):
    """__graft_entry__.py:99-131: tagging into a bin-sharded Nodegraph and
    the device CC over the mesh give khmer_tpu's host-engine partitions
    as sets of tags."""
    fa = str(tmp_path / "reads.fa")
    write_metagenome(fa, seed=11, n_reads=200)
    j = khmer_tpu.Nodegraph(K, SIZE, N_TABLES)
    jr = j.consume_seqfile_and_tag(fa)
    js = JaxSubsetPartition(j)
    js.do_partition()

    p = Nodegraph(K, SIZE, N_TABLES, device="cpu")
    mesh = make_mesh(["cpu"] * S)
    p.storage.shard_table(mesh)
    assert p.consume_seqfile_and_tag(fa) == tuple(jr)
    assert p.all_tags == j.all_tags
    ps = SubsetPartition(p)
    ps.do_partition_device(mesh=mesh)
    assert _partition_sets(ps) == _partition_sets(js)
    assert ps.device_stats["edges"] > 0 and len(_partition_sets(ps)) > 1


def _partition_sets(subset):
    """A subset partition's partitions as a set of frozensets of tags."""
    by_pid = {}
    for tag, pid in subset.partition_map.items():
        if pid is not None:
            by_pid.setdefault(pid, set()).add(tag)
    return {frozenset(t) for t in by_pid.values()}


def _write_reads(path, seed, n_reads=150, repeats=300):
    """Random reads, one of them repeated past 255."""
    rng = np.random.default_rng(seed)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 90))
            for _ in range(n_reads)]
    seqs += [seqs[2]] * repeats
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))
    return seqs


@pytest.mark.parametrize("S", [2, 3])
def test_sharded_countgraph_consume_and_save(tmp_path, S):
    """consume_seqfile into a bin-sharded Countgraph with bigcount (the
    deferred counter) against khmer_tpu's consume: return, n_unique,
    n_occupied, counts, per-read medians (K1 + K20), the saved .ct with
    its bigcount section; the host snapshot against the table."""
    fa = str(tmp_path / "reads.fa")
    seqs = _write_reads(fa, seed=S)
    j = khmer_tpu.Countgraph(K, SIZE, N_TABLES)
    j.set_use_bigcount(True)
    jr = j.consume_seqfile(fa)
    j.save(str(tmp_path / "jax.ct"))

    p = Countgraph(K, SIZE, N_TABLES, device="cpu")
    p.set_use_bigcount(True)
    p.storage.shard_table(make_mesh(["cpu"] * S))
    assert p.consume_seqfile(fa, chunk=1 << 14) == tuple(jr)
    assert p.n_unique_kmers() == j.n_unique_kmers()
    assert p.n_occupied() == j.n_occupied()
    assert np.array_equal(p.storage.host_table(),
                          np.asarray(j.storage.table))
    assert [p.get(s[:K]) for s in seqs[:4]] == \
        [j.get(s[:K]) for s in seqs[:4]]
    assert p.get(seqs[2][:K]) > 255
    assert p.get_median_count_batch(seqs[:5]) == \
        [j.get_median_count(s) for s in seqs[:5]]
    assert p.count_rows(seqs[:3])[2].tolist() == \
        j.get_kmer_counts(seqs[2])
    p.save(str(tmp_path / "port.ct"))
    with open(str(tmp_path / "jax.ct"), "rb") as a, \
            open(str(tmp_path / "port.ct"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("cls", [Countgraph, SmallCountgraph, Nodegraph])
def test_sharded_raw_bytes_every_kind(cls, S):
    """raw_bytes of a bin-sharded table, packed a piece at a time in the
    table's kind (K14), against the whole table's, on tables of a few
    bins each so that pieces cut tables mid-way and some pieces hold
    several tables; counts up to 300, past every kind's cap."""
    rng = np.random.default_rng(S)
    sizes = [int(x) for x in rng.integers(3, 40, 5)]
    keys = rng.integers(0, 1 << 62, 400).astype(np.uint64)
    weights = rng.integers(1, 300, 400).astype(np.uint32)
    want = cls(K, primes=sizes, device="cpu")
    want.storage.add_batch(keys, weights)
    g = cls(K, primes=sizes, device="cpu")
    g.storage.shard_table(make_mesh(["cpu"] * S))
    g.storage.add_batch(keys, weights)
    assert np.array_equal(g.storage.host_table(), want.storage.host_table())
    assert np.array_equal(g.storage.raw_bytes(), want.storage.raw_bytes())


def test_outside_the_slice_raises(tmp_path):
    """What is not ported to the layout raises NotImplementedError
    naming the ROADMAP item; nothing assembles the whole table."""
    fa = str(tmp_path / "reads.fa")
    seqs = _write_reads(fa, seed=5, n_reads=20, repeats=0)
    g = Countgraph(K, SIZE, N_TABLES, device="cpu")
    g.storage.shard_table(make_mesh(["cpu"] * 2))
    g.consume_seqfile(fa)
    track = Nodegraph(K, SIZE, N_TABLES, device="cpu")
    whole = Countgraph(K, SIZE, N_TABLES, device="cpu")
    sharded_mask = Nodegraph(K, SIZE, N_TABLES, device="cpu")
    sharded_mask.storage.shard_table(make_mesh(["cpu"] * 2))
    other = Nodegraph(K, SIZE, N_TABLES, device="cpu")
    calls = [
        lambda: g.storage.table,
        lambda: g.abundance_distribution(fa, track),
        lambda: whole.abundance_distribution(fa, sharded_mask),
        lambda: g.diginorm_batch([(seqs[0], None)], 20),
        lambda: g.trim_pass1_batch([(seqs[0], None)], 20),
        lambda: whole.consume_seqfile_with_mask(fa, sharded_mask),
        lambda: g.storage.set_raw_bytes(whole.storage.raw_bytes()),
        lambda: g.storage.replace_table(whole.storage.table),
        lambda: sharded_mask.update(other),
        lambda: other.update(sharded_mask),
        lambda: Countgraph(K, SIZE, N_TABLES, device="cpu").storage
        .shard_table(types.SimpleNamespace(group=object(),
                                           devices=("cpu",))),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
            call()
    with pytest.raises(ValueError, match="already"):
        g.storage.shard_table(make_mesh(["cpu"] * 2))
    # the calls left the sharded table as it was
    ref = Countgraph(K, SIZE, N_TABLES, device="cpu")
    ref._consume_deferred(fa)
    assert np.array_equal(g.storage.raw_bytes(), ref.storage.raw_bytes())

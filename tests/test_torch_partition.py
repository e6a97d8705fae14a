"""Port parity of tag-based partitioning: khmer_tpu_torch against
khmer_tpu on the same generated reads and graph state.

* K10's plain version (kernels.cc_rounds on the CPU) against khmer_tpu's
  cc_rounds, (labels, changed) at rounds = 1 and 8, on the six random
  graphs of tests/test_partition_device.py, a 2,048-node path, no edges
  and padding edges; connected_components against host_union_find.
* Tagging: Nodegraph.consume_seqfile_and_tag's (n_reads, n_consumed),
  tags, n_unique and the saved graph and tagset bytes, at tag density 40
  and 4, on reads with N, lowercase bases and reads shorter than k.
* Partitioning on one graph state (khmer_tpu's bins and tags carried
  over by convert.graph_from_numpy): do_subset_partition's pmap bytes
  over three subsets, with and without stop_big_traversals (on a sparse
  tag set, where searches pass 200 k-mers), and with a stoptags file
  written by khmer_tpu; do_partition_device's pmap bytes, and its
  partitions as sets equal to do_partition's.

khmer_tpu is held to one table geometry (4 x 20011 bins) at k = 20 and
32.  Integer data throughout: exact equality."""

import numpy as np
import pytest
import torch

import khmer_tpu
from khmer_tpu.partition_device import cc_rounds as jax_cc_rounds
from khmer_tpu.partitioning import SubsetPartition as JaxSubsetPartition
from khmer_tpu_torch import Nodegraph, convert, graph, kernels, partitioning
from khmer_tpu_torch.partition_device import (connected_components,
                                              host_union_find)
from khmer_tpu_torch.parallel import make_mesh
from khmer_tpu_torch.partitioning import SubsetPartition

SIZE = 20011
N_TABLES = 4


def write_metagenome(path, seed, n_genomes=12, genome_len=(200, 600),
                     n_reads=300, readlen=100, sub=0.005):
    """Reads of `readlen` bases from random genomes (lengths drawn from
    genome_len), half of them reverse-complemented, with `sub`
    substitutions a base; read 3 is cut below k = 20, read 5 carries an N
    and read 7 lowercase bases."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    lens = rng.integers(genome_len[0], genome_len[1] + 1, n_genomes)
    genomes = [bases[rng.integers(0, 4, n)] for n in lens]
    starts = lens - readlen + 1
    which = rng.choice(n_genomes, n_reads, p=starts / starts.sum())
    seqs = []
    for g in which:
        s = rng.integers(0, starts[g])
        r = genomes[g][s:s + readlen].copy()
        m = rng.random(readlen) < sub
        r[m] = bases[rng.integers(0, 4, int(m.sum()))]
        seq = r.tobytes().decode()
        if rng.random() < 0.5:
            seq = seq[::-1].translate(str.maketrans("ACGT", "TGCA"))
        seqs.append(seq)
    seqs[3] = seqs[3][:15]
    seqs[5] = seqs[5][:40] + "N" + seqs[5][41:]
    seqs[7] = seqs[7][:30].lower() + seqs[7][30:]
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))
    return seqs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# K10's plain version
# ---------------------------------------------------------------------------

GRAPHS = {"n1_e1": (1, 1, 0), "n17_e3": (17, 3, 1), "n100_e50": (100, 50, 2),
          "n1000_e800": (1000, 800, 3), "n1000_e5000": (1000, 5000, 4),
          "n4096_e4096": (4096, 4096, 5)}


def _graph(name):
    """(n, src, dst) uint32: the random graphs of test_partition_device
    (_random_graph), a 2,048-node path, no edges, and a 64-node graph
    whose edge list is mostly padding (0, 0)."""
    if name in GRAPHS:
        n, e, seed = GRAPHS[name]
        rng = np.random.default_rng(seed)
        return (n, rng.integers(0, n, e).astype(np.uint32),
                rng.integers(0, n, e).astype(np.uint32))
    if name == "path2048":
        src = np.arange(2047, dtype=np.uint32)
        return 2048, src, src + 1
    if name == "no_edges":
        return 5, np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    rng = np.random.default_rng(9)
    src = np.zeros(200, np.uint32)
    dst = np.zeros(200, np.uint32)
    src[::10] = rng.integers(0, 64, 20)
    dst[::10] = rng.integers(0, 64, 20)
    return 64, src, dst


CC_CASES = list(GRAPHS) + ["path2048", "no_edges", "padding"]


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("rounds", [1, 8])
@pytest.mark.parametrize("name", CC_CASES)
def test_cc_rounds_matches_khmer_tpu(name, rounds):
    """One call from arange labels and a second from the first's output
    (labels that are no longer indices of themselves)."""
    n, src, dst = _graph(name)
    want = np.arange(n, dtype=np.uint32)
    got = _i32(want)
    for _ in range(2):
        want, w_changed = jax_cc_rounds(want.copy(), src, dst,
                                        rounds=rounds)
        want = np.asarray(want)
        got, g_changed = kernels.cc_rounds(got, _i32(src), _i32(dst),
                                           rounds)
        assert np.array_equal(got.numpy().view(np.uint32), want)
        assert bool(g_changed) == bool(w_changed)


@pytest.mark.parametrize("name", CC_CASES)
def test_connected_components_matches_union_find(name):
    n, src, dst = _graph(name)
    stats = {}
    got = connected_components(n, src, dst, device="cpu", stats=stats)
    assert np.array_equal(got.numpy().view(np.uint32),
                          host_union_find(n, src, dst))
    assert stats["calls"] >= 1


def test_cc_rounds_leaves_its_input():
    n, src, dst = _graph("n100_e50")
    labels = _i32(np.arange(n, dtype=np.uint32))
    before = labels.clone()
    out, _ = kernels.cc_rounds(labels, _i32(src), _i32(dst), 8)
    assert torch.equal(labels, before)
    assert out.data_ptr() != labels.data_ptr()


# ---------------------------------------------------------------------------
# tagging
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    fa = str(tmp_path_factory.mktemp("torch_partition") / "reads.fa")
    write_metagenome(fa, seed=3)
    return fa


def _tagged(cls, fa, k, density, device=None):
    g = cls(k, SIZE, N_TABLES) if device is None else \
        cls(k, SIZE, N_TABLES, device=device)
    g.tag_density = density
    return g, g.consume_seqfile_and_tag(fa)


@pytest.mark.parametrize("k,density,batch", [(20, 40, None), (20, 4, None),
                                             (32, 40, None), (20, 40, 64)])
def test_consume_and_tag_matches_khmer_tpu(reads, tmp_path, monkeypatch, k,
                                           density, batch):
    """batch: reads a consume-and-tag batch of the port (khmer_tpu takes
    the file's 300 reads in one)."""
    if batch:
        monkeypatch.setattr(graph, "TAG_BATCH", batch)
    j, j_out = _tagged(khmer_tpu.Nodegraph, reads, k, density)
    p, p_out = _tagged(Nodegraph, reads, k, density, device="cpu")
    assert p_out == j_out
    assert p.all_tags == j.all_tags
    assert len(p.all_tags) > 10
    assert p.n_unique_kmers() == j.n_unique_kmers()
    for side, g in (("jax", j), ("port", p)):
        g.save(str(tmp_path / (side + ".graph")))
        g.save_tagset(str(tmp_path / (side + ".tagset")))
    for ext in (".graph", ".tagset"):
        assert _read(str(tmp_path / ("port" + ext))) == \
            _read(str(tmp_path / ("jax" + ext)))
    loaded = Nodegraph.load(str(tmp_path / "jax.graph"), device="cpu")
    loaded.load_tagset(str(tmp_path / "jax.tagset"))
    assert loaded.all_tags == j.all_tags
    assert loaded.tag_density == density


# ---------------------------------------------------------------------------
# partitioning on one graph state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def state(reads):
    """khmer_tpu's k = 20 graph with its tags, and the port's copy."""
    j, _ = _tagged(khmer_tpu.Nodegraph, reads, 20, 40)
    p = convert.graph_from_numpy(
        Nodegraph, 20, j.hashsizes(), np.asarray(j.storage.table),
        tags=j.all_tags, tag_density=j.tag_density, device="cpu")
    return j, p


def _subsets(tags, n):
    """divide_tags_into_subsets' bounds for n subsets, 0 at the end."""
    divvy = sorted(tags)[::-(-len(tags) // n)]
    return list(zip(divvy, divvy[1:] + [0]))


def _pmaps(graph, tmp_path, side, **kw):
    out = []
    for i, (lo, hi) in enumerate(_subsets(graph.all_tags, 3)):
        path = str(tmp_path / "{}.{}.pmap".format(side, i))
        graph.do_subset_partition(lo, hi, **kw).save_partitionmap(path)
        out.append(_read(path))
    return out


def _with_tags(graph, tags):
    graph.all_tags = set(tags)
    return graph


@pytest.mark.parametrize("tags,big,batch", [("all", False, None),
                                            ("all", False, 7),
                                            ("sparse", False, None),
                                            ("sparse", True, None)])
def test_subset_partitions_match_khmer_tpu(state, tmp_path, monkeypatch,
                                           tags, big, batch):
    """batch: seeds a search batch of the port (khmer_tpu searches up to
    2,048 at once)."""
    if batch:
        monkeypatch.setattr(partitioning, "SEED_BATCH", batch)
    j, p = state
    chosen = sorted(j.all_tags)
    if tags == "sparse":
        chosen = chosen[::7]
    saved = set(j.all_tags), set(p.all_tags)
    try:
        _with_tags(j, chosen)
        _with_tags(p, chosen)
        want = _pmaps(j, tmp_path, "jax", stop_big_traversals=big)
        got = _pmaps(p, tmp_path, "port", stop_big_traversals=big)
        if big:
            # the flag changes the partitions of the sparse tag set
            assert got != _pmaps(p, tmp_path, "free")
    finally:
        j.all_tags, p.all_tags = saved
    assert len(got) == 3
    assert got == want


def test_subset_partitions_with_stoptags(state, tmp_path, reads):
    j, p = state
    seqs = [s for s in write_metagenome(str(tmp_path / "again.fa"), seed=3)
            if len(s) >= 60 and s.isupper()]
    stops = {j.get_kmer_hashes(s)[30] for s in seqs[::4]}
    path = str(tmp_path / "stop.stoptags")
    j.stop_tags = set(stops)
    j.save_stop_tags(path)
    p.load_stop_tags(path)
    try:
        assert p.stop_tags == stops
        want = _pmaps(j, tmp_path, "jax", break_on_stop_tags=True)
        got = _pmaps(p, tmp_path, "port", break_on_stop_tags=True)
        assert got != _pmaps(p, tmp_path, "free")
    finally:
        j.stop_tags, p.stop_tags = set(), set()
    assert got == want


def _partition_sets(subset):
    by_pid = {}
    for tag, pid in subset.partition_map.items():
        if pid is not None:
            by_pid.setdefault(pid, set()).add(tag)
    return {frozenset(s) for s in by_pid.values()}


def test_partition_device_matches_khmer_tpu(state, tmp_path):
    j, p = state
    js = JaxSubsetPartition(j)
    js.do_partition_device()
    js.save_partitionmap(str(tmp_path / "jax.pmap"))
    ps = SubsetPartition(p)
    ps.do_partition_device()
    ps.save_partitionmap(str(tmp_path / "port.pmap"))
    assert _read(str(tmp_path / "port.pmap")) == \
        _read(str(tmp_path / "jax.pmap"))
    host = SubsetPartition(p)
    host.do_partition()
    sets = _partition_sets(host)
    assert len(sets) > 3
    assert _partition_sets(ps) == sets
    assert ps.count_partitions() == host.count_partitions()
    assert ps.device_stats["edges"] > 0 and ps.device_stats["calls"] >= 1
    # the sharded engine over four CPU shards gives the same pmap
    meshed = SubsetPartition(p)
    meshed.do_partition_device(mesh=make_mesh(["cpu"] * 4))
    meshed.save_partitionmap(str(tmp_path / "mesh.pmap"))
    assert _read(str(tmp_path / "mesh.pmap")) == \
        _read(str(tmp_path / "jax.pmap"))


def test_cc_sizes_checked_below_int32():
    """K10 indexes labels as int32: 2**31 nodes or edges are refused
    (checked on the sizes, without such arrays)."""
    kernels.check_cc_sizes((1 << 31) - 1, (1 << 31) - 1)
    for T, E in ((1 << 31, 0), (1, 1 << 31)):
        with pytest.raises(ValueError, match="2\\*\\*31"):
            kernels.check_cc_sizes(T, E)
    empty = torch.zeros(0, dtype=torch.int32)
    labels, changed = kernels.cc_rounds(empty, empty, empty, 8)
    assert labels.numel() == 0 and not bool(changed)


def test_graph_and_subset_api_matches_khmer_tpu(state, tmp_path):
    """The rest of the ported surface on one state: fr_from_hash and
    counts_of, find_all_tags, the tag accessors, and SubsetPartition's
    id bookkeeping (set/get_partition_id, join_partitions,
    partition_sizes, count_partitions, merge) with its saved bytes."""
    from khmer_tpu import traversal as jax_traversal
    from khmer_tpu_torch import traversal

    j, p = state
    tags = sorted(j.all_tags)
    rng = np.random.default_rng(4)
    probe = np.concatenate([np.asarray(tags[:50], np.uint64),
                            rng.integers(0, 4 ** 20, 50, dtype=np.uint64)])
    assert np.array_equal(traversal.counts_of(p, probe),
                          np.asarray(jax_traversal.counts_of(j, probe)))
    for t in tags[:5]:
        assert traversal.fr_from_hash(t, 20) == \
            jax_traversal.fr_from_hash(t, 20)
    js, ps = JaxSubsetPartition(j), SubsetPartition(p)
    for t in tags[::40]:
        assert ps.find_all_tags(t).tagged_kmers == \
            js.find_all_tags(t).tagged_kmers
    assert p.n_tags == j.n_tags and p.get_tagset() == j.get_tagset()

    ops = [("set_partition_id", tags[0], 7), ("set_partition_id", tags[1], 9),
           ("set_partition_id", tags[2], 9), ("join_partitions", 7, 9),
           ("join_partitions", 7, 0), ("join_partitions", 7, 99),
           ("set_partition_id", j.reverse_hash(tags[3]), 12)]
    out = {}
    for side, sub, cls in (("jax", js, JaxSubsetPartition),
                           ("port", ps, SubsetPartition)):
        got = [getattr(sub, op)(*args) for op, *args in ops]
        got += [sub.get_partition_id(t) for t in tags[:5]]
        got.append(sub.get_partition_id(j.reverse_hash(tags[3])))
        other = cls(sub.graph)
        other.do_partition(tags[10], tags[60])
        sub.merge(other)
        got += [sub.partition_sizes(), sub.count_partitions()]
        sub.save_partitionmap(str(tmp_path / side))
        out[side] = got + [_read(str(tmp_path / side))]
    assert out["port"] == out["jax"]

    seqs = write_metagenome(str(tmp_path / "one.fa"), seed=5, n_reads=40)
    jg = khmer_tpu.Nodegraph(20, SIZE, N_TABLES)
    pg = Nodegraph(20, SIZE, N_TABLES, device="cpu")
    for s in seqs:
        if len(s) >= 20:
            found_j, found_p = set(), set()
            assert pg.consume_and_tag(s, found_p) == \
                jg.consume_and_tag(s, found_j)
            assert found_p == found_j
    assert pg.all_tags == jg.all_tags and len(pg.all_tags) > 5

    g = Nodegraph(20, SIZE, N_TABLES, device="cpu")
    g.add_tag("ACGTACGTACGTACGTACGT")
    g.add_tag(12345)
    g.add_stop_tag("TTTTTTTTTTTTTTTTTTTT")
    assert g.n_tags == 2 and len(g.stop_tags) == 1
    with pytest.raises(RuntimeError):
        g.tag_density = 10
    with pytest.raises(ValueError):
        Nodegraph(20, SIZE, N_TABLES, device="cpu").tag_density = 3

"""Port parity of the graph traversal queries (slice 4b): khmer_tpu_torch
(device="cpu") against khmer_tpu on the same generated graphs.

Two read sets, each at k = 20 and 32 in Nodegraphs of 4 x 10007 bins
(crowded enough that false-positive neighbours branch the searches): a
lump of eight 1-kb sequences that share a 200-base core (the fakelump
idea, with a longer shared stretch), and a small metagenome
(test_torch_partition.write_metagenome).  A seventh of the tags are stop
tags on both sides.

Held equal: traverse_from_kmer's keepers (as sets and in iteration
order) at radius 0, 1, 5 and 40 and with a small max_count, from tags,
k-mer strings, Kmer objects and absent hashes; the batched level search
against one search per seed; count_kmers_within_radius;
calc_connected_graph_size with max_size and break_on_circumference;
kmer_degree, neighbors and the Traverser's methods;
find_high_degree_nodes; traverse_linear_path; trim_on_stoptags,
identify_stoptags_by_position and extract_unique_paths; the tag and
stop-tag accessors.  Integer data: exact equality."""

import numpy as np
import pytest

import khmer_tpu
import khmer_tpu.traversal as jax_traversal
import khmer_tpu_torch
from khmer_tpu_torch import traversal
from .test_torch_partition import write_metagenome

SIZE = 10007
N_TABLES = 4
KS = (20, 32)
GRAPHS = ("lump", "meta")


def write_lump(path, seed, n_seqs=8, core=200, flank=400):
    """n_seqs sequences of `flank` random bases, a `core` of random bases
    they all share, and `flank` more random bases; one record each.
    Returns the sequences."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def rand(n):
        return bases[rng.integers(0, 4, n)].tobytes().decode()

    shared = rand(core)
    seqs = [rand(flank) + shared + rand(flank) for _ in range(n_seqs)]
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">s%d\n%s\n" % (i, s))
    return seqs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_traversal")
    out = {"lump": str(d / "lump.fa"), "meta": str(d / "meta.fa")}
    seqs = {"lump": write_lump(out["lump"], 3),
            "meta": write_metagenome(out["meta"], seed=5, n_genomes=8,
                                     n_reads=160)}
    return out, seqs


@pytest.fixture(scope="module")
def graphs(files):
    """(khmer_tpu graph, port graph, reads) for every read set and k, one
    seventh of the tags stop tags on both."""
    paths, seqs = files
    out = {}
    for name in GRAPHS:
        for k in KS:
            jg = khmer_tpu.Nodegraph(k, SIZE, N_TABLES)
            pg = khmer_tpu_torch.Nodegraph(k, SIZE, N_TABLES, device="cpu")
            jg.consume_seqfile_and_tag(paths[name])
            pg.consume_seqfile_and_tag(paths[name])
            assert bytes(np.asarray(jg.storage.raw_bytes())) == \
                bytes(pg.storage.raw_bytes())
            assert pg.all_tags == jg.all_tags
            stops = set(sorted(jg.all_tags)[::7])
            for g in (jg, pg):
                for t in sorted(stops):
                    g.add_stop_tag(t)
            out[name, k] = (jg, pg, [s for s in seqs[name] if len(s) >= k])
    return out


def _seeds(jg, reads, k):
    """Tags (not stop tags), k-mer strings, a Kmer and an absent hash."""
    tags = sorted(jg.all_tags - jg.stop_tags)
    seeds = tags[:: max(1, len(tags) // 5)][:5]
    seeds += [reads[0][:k], reads[-1][10:10 + k]]
    seeds.append(khmer_tpu.Kmer(reads[1][:k]))
    seeds.append(int(khmer_tpu.forward_hash("A" * k, k)))
    return seeds


def _port_seed(seed):
    if isinstance(seed, khmer_tpu.Kmer):
        return khmer_tpu_torch.Kmer(str(seed))
    return seed


@pytest.mark.parametrize("radius", [0, 1, 5, 40])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", GRAPHS)
def test_traverse_from_kmer(graphs, name, k, radius):
    jg, pg, reads = graphs[name, k]
    for seed in _seeds(jg, reads, k):
        want = jg.traverse_from_kmer(seed, radius)
        got = pg.traverse_from_kmer(_port_seed(seed), radius)
        assert got == want and list(got) == list(want), seed
    # a keeper cut at max_count + 1 k-mers, in the reference's order
    seed = sorted(jg.all_tags - jg.stop_tags)[0]
    for cap in (0, 3, 17):
        want = jg.traverse_from_kmer(seed, 40, max_count=cap)
        got = pg.traverse_from_kmer(seed, 40, max_count=cap)
        assert list(got) == list(want), cap
        assert pg.count_kmers_within_radius(seed, 40, cap) == \
            jg.count_kmers_within_radius(seed, 40, cap)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", GRAPHS)
def test_batched_searches_equal_one_at_a_time(graphs, name, k):
    """_keeper_pairs over a batch of seeds gives every seed the keeper, in
    order, that its own search gives (khmer_tpu's), also when a seed is a
    stop tag or its keeper is cut."""
    jg, pg, _ = graphs[name, k]
    tags = sorted(jg.all_tags)[::3]
    stops = traversal.stop_keys(pg)
    for cap in (traversal.MAX_KEEPER_SIZE, 50):
        keepers, ends = traversal.keeper_arrays(
            pg, [traversal.fr_from_hash(t, k) for t in tags], 40, cap, stops)
        starts = np.concatenate([[0], ends[:-1]])
        for t, a, b in zip(tags, starts, ends):
            want = jax_traversal.traverse_from_kmer(jg, t, 40,
                                                    max_count=cap)
            # a set built in the keeper's order iterates as khmer_tpu's
            assert list(set(keepers[a:b].tolist())) == list(want), t


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", GRAPHS)
def test_connected_graph_size(graphs, name, k):
    jg, pg, reads = graphs[name, k]
    cases = [(25, False), (1, True), (25, True)]
    if name == "meta":  # small components: the whole search stays cheap
        cases += [(0, False), (0, True)]
    for seed in _seeds(jg, reads, k)[:3] + [reads[2][:k]]:
        for max_size, circ in cases:
            assert traversal.calc_connected_graph_size(
                pg, seed, max_size, circ) == \
                jax_traversal.calc_connected_graph_size(
                    jg, seed, max_size, circ), (seed, max_size, circ)
        assert pg.calc_connected_graph_size(seed) == \
            jg.calc_connected_graph_size(seed)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", GRAPHS)
def test_degrees_and_neighbours(graphs, name, k):
    jg, pg, reads = graphs[name, k]
    jt, pt = jax_traversal.Traverser(jg), traversal.Traverser(pg)
    for read in reads[:3]:
        for i in (0, 17, len(read) - k):
            kmer = read[i:i + k]
            assert pg.kmer_degree(kmer) == jg.kmer_degree(kmer)
            assert [str(x) for x in pg.neighbors(kmer)] == \
                [str(x) for x in jg.neighbors(kmer)]
            h = jg.hash(kmer)
            assert [str(x) for x in pg.neighbors(h)] == \
                [str(x) for x in jg.neighbors(h)]
            for m in ("neighbors", "right_neighbors", "left_neighbors",
                      "degree", "right_degree", "left_degree"):
                assert getattr(pt, m)(kmer) == getattr(jt, m)(kmer), m
            f, r = jax_traversal.fr_from_hash(h, k)
            assert traversal.kmer_degree_fr(pg, f, r, k) == \
                jax_traversal.kmer_degree_fr(jg, np.uint64(f), np.uint64(r),
                                             k)
    assert pt.ksize() == k
    with pytest.raises(ValueError):
        pg.neighbors("A" * (k - 1))
    with pytest.raises(TypeError):
        pg.neighbors(1.5)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", GRAPHS)
def test_high_degree_nodes_and_linear_paths(graphs, name, k):
    jg, pg, reads = graphs[name, k]
    for read in reads[:2]:
        want = jg.find_high_degree_nodes(read)
        got = pg.find_high_degree_nodes(read)
        assert sorted(got.hashes) == sorted(want.hashes)
        for i in (0, len(read) // 2):
            kmer = read[i:i + k]
            jsize, jadj, jvis = jg.traverse_linear_path(kmer, want)
            psize, padj, pvis = pg.traverse_linear_path(kmer, got)
            assert (psize, sorted(padj.hashes), sorted(pvis.hashes)) == \
                (jsize, sorted(jadj.hashes), sorted(jvis.hashes))
            # with a Bloom filter that marks the high-degree nodes
            jf = khmer_tpu.Nodegraph(k, 997, 2)
            pf = khmer_tpu_torch.Nodegraph(k, 997, 2, device="cpu")
            jr = jg.traverse_linear_path(kmer, want, jf)
            pr = pg.traverse_linear_path(kmer, got, pf)
            assert pr[0] == jr[0] and sorted(pr[2].hashes) == \
                sorted(jr[2].hashes)
            assert bytes(pf.storage.raw_bytes()) == \
                bytes(np.asarray(jf.storage.raw_bytes()))
    assert traversal.fr_from_hash_codes(
        np.array([0, 1, 2, 3, 3, 2], np.uint8)) == \
        jax_traversal.fr_from_hash_codes(np.array([0, 1, 2, 3, 3, 2],
                                                  np.uint8))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", GRAPHS)
def test_stop_tag_trims_and_unique_paths(graphs, name, k):
    jg, pg, reads = graphs[name, k]
    for read in reads[:6] + [reads[0][:k - 1], reads[1][:k]]:
        assert pg.trim_on_stoptags(read) == jg.trim_on_stoptags(read)
        assert pg.identify_stoptags_by_position(read) == \
            jg.identify_stoptags_by_position(read)
        assert pg.get_tags_and_positions(read) == \
            jg.get_tags_and_positions(read)
        assert sorted(pg.get_tags_for_sequence(read).hashes) == \
            sorted(jg.get_tags_for_sequence(read).hashes)
    # a fresh graph of half the reads: the other half's unique stretches
    half = len(reads) // 2
    jh = khmer_tpu.Nodegraph(k, SIZE, N_TABLES)
    ph = khmer_tpu_torch.Nodegraph(k, SIZE, N_TABLES, device="cpu")
    for read in reads[:half]:
        jh.consume(read)
        ph.consume(read)
    joined = "".join(reads[half:half + 4])
    for min_length, min_unique in ((k, 0.5), (2 * k, 0.1), (3 * k, 1.0),
                                   (len(joined) + 1, 0.5)):
        assert ph.extract_unique_paths(joined, min_length, min_unique) == \
            jh.extract_unique_paths(joined, min_length, min_unique)


@pytest.mark.parametrize("k", KS)
def test_tag_accessors(graphs, tmp_path, k):
    jg, pg, _ = graphs["lump", k]
    assert pg._get_tag_density() == jg._get_tag_density()
    assert list(pg.tags()) == list(jg.tags())
    assert pg.get_stop_tags() == jg.get_stop_tags()
    assert list(pg.iter_stop_tags()) == list(jg.iter_stop_tags())
    for m in ("print_tagset", "print_stop_tags"):
        getattr(jg, m)(str(tmp_path / "j"))
        getattr(pg, m)(str(tmp_path / "p"))
        assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    f = traversal._Frontier(*traversal._fr_tensors("cpu", [(5, 3), (1, 9)]))
    assert f.canon.tolist() == [3, 1]

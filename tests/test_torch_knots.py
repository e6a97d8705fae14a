"""Port parity of stop tags, the rest of partitioning and the
knot-removal workflow (slice 4b): khmer_tpu_torch (device="cpu") against
khmer_tpu on the same generated graphs.

Inputs: a lump of six 520-base sequences sharing a 120-base core and a
"knot" of six 200-base sequences sharing a 40-base core (whose
radius-40 searches pass the scripts' 200 k-mers), from
test_torch_traversal.write_lump, and a small metagenome
(test_torch_partition.write_metagenome); graphs of 4 x 10007 bins at
k = 20 and 32.  khmer_tpu takes a device call for every search level
and every count it walks, so the inputs stay this small.

Held equal: repartition_largest_partition's size, stop tags (in
iteration order), partition map and counting table, with counting tables
whose bins every walked k-mer shares with others (primes 5, 7, 11, 13)
and with the port's batch of tags cut to 3 (so that traversals are taken
again); consume_seqfile_and_tag_with_stoptags on a Nodegraph and a
Countgraph, also over tables so small that a batch's empty bins are
shared; sweep_for_tags; find_unpart on an odd/even split;
do_subset_partition_with_abundance; the partition API; the older
consume names, consume_partitioned_fasta and filter_if_present; and the
scripts make-initial-stoptags, find-knots, filter-stoptags and
do-partition: every output file's bytes and every stderr line, chained
as docs/user/partitioning-big-data.md chains them.  Integer data: exact
equality."""

import contextlib
import io
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import khmer_tpu
import khmer_tpu_torch
from khmer_tpu_torch import graph as port_graph, partitioning
from khmer_tpu_torch.scripts import (do_partition, filter_stoptags,
                                     find_knots, load_graph,
                                     make_initial_stoptags, partition_graph)
from .khmer_tst_utils import runscript
from .test_torch_partition import write_metagenome
from .test_torch_traversal import write_lump
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

SIZE = 10007
N_TABLES = 4
TINY = [5, 7, 11, 13]  # counting primes: every walked k-mer shares bins


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_knots")
    paths = {n: str(d / (n + ".fa")) for n in ("lump", "knot", "meta")}
    write_lump(paths["lump"], 7, n_seqs=6, core=120, flank=200)
    write_lump(paths["knot"], 8, n_seqs=8, core=60, flank=100)
    reads = write_metagenome(paths["meta"], seed=9, n_genomes=8,
                             n_reads=160)
    for part in (0, 1):
        with open(str(d / "meta{}.fa".format(part)), "w") as f:
            for i, s in enumerate(reads[part::2]):
                f.write(">r%d\n%s\n" % (2 * i + part, s))
    paths["dir"] = d
    return paths


def _graphs(path, k, cls="Nodegraph", primes=None):
    """The same consume-and-tagged graph in both packages."""
    shape = (1, 1) if primes else (SIZE, N_TABLES)
    jg = getattr(khmer_tpu, cls)(k, *shape, primes=primes)
    pg = getattr(khmer_tpu_torch, cls)(k, *shape, primes=primes,
                                       device="cpu")
    for g in (jg, pg):
        g.consume_seqfile_and_tag(path)
    return jg, pg


def _raw(g):
    return bytes(np.asarray(g.storage.raw_bytes()))


def _state(g):
    return (list(g.all_tags), list(g.stop_tags),
            list(g.partition.partition_map.items()), _raw(g),
            g.n_unique_kmers())


# graph, k, counting table, distance, threshold, frequency, KNOT_BATCH
REPARTITION = {
    "lump-32-shared-bins": ("lump", 32, TINY, 20, 60, 1, None),
    "meta-20-subset-freq-0-batch-3": ("meta", 20, (SIZE, N_TABLES), 10, 20,
                                      0, 3),
}


@pytest.mark.parametrize("case", list(REPARTITION))
def test_repartition_largest_partition(files, case):
    name, k, counting, distance, threshold, frequency, batch = \
        REPARTITION[case]
    jg, pg = _graphs(files[name], k)
    if counting == TINY:
        jc = khmer_tpu.Countgraph(k, 1, 1, primes=TINY)
        pc = khmer_tpu_torch.Countgraph(k, 1, 1, primes=TINY, device="cpu")
    else:
        jc = khmer_tpu.Countgraph(k, *counting)
        pc = khmer_tpu_torch.Countgraph(k, *counting, device="cpu")
    subs = name == "meta"
    sizes = []
    for g, c in ((jg, jc), (pg, pc)):
        subset = g.do_subset_partition(0, 0)
        if not subs:
            g.merge_subset(subset)
        with mock.patch.object(partitioning, "KNOT_BATCH",
                               batch or partitioning.KNOT_BATCH):
            sizes.append(g.repartition_largest_partition(
                c, distance, threshold, frequency,
                subs=subset if subs else None))
        if subs:
            g.partition = subset
    assert sizes[1] == sizes[0]
    assert _state(pg) == _state(jg)
    assert _raw(pc) == _raw(jc) and pc.n_unique_kmers() == jc.n_unique_kmers()
    stats = pg.partition.knot_stats
    assert jg.stop_tags and stats["stop_tags_added"] == len(jg.stop_tags)
    # a traversal taken again with the stop tags of its turn
    assert stats["retraced"] > 0
    assert stats["batches"] == (11 if batch == 3 else 1)


def test_repartition_with_cut_keepers(files):
    """With MAX_KEEPER_SIZE cut to 30, keepers are cut and traversed again
    on the device; the result equals a tag-by-tag walk of the port's own
    traverse_from_kmer, get and add (khmer_tpu's loop)."""
    out = []
    for walk in ("batched", "one by one"):
        g = khmer_tpu_torch.Nodegraph(20, SIZE, N_TABLES, device="cpu")
        g.consume_seqfile_and_tag(files["knot"])
        g.merge_subset(g.do_subset_partition(0, 0))
        c = khmer_tpu_torch.Countgraph(20, 97, 2, device="cpu")
        if walk == "batched":
            with mock.patch.object(partitioning, "MAX_KEEPER_SIZE", 30):
                g.repartition_largest_partition(c, 20, 25, 1)
            assert g.partition.knot_stats["retraced"] > 0
        else:
            part = g.partition
            sizes, _ = part.partition_sizes()
            big = max(sizes, key=lambda ps: ps[1])[0]
            for tag in [t for t, p in part.partition_map.items()
                        if p == big]:
                keeper = g.traverse_from_kmer(tag, 20, max_count=30)
                if len(keeper) >= 25:
                    for km in keeper:
                        if c.get(km) > 1:
                            g.add_stop_tag(km)
                        else:
                            c.add(km)
        out.append((list(g.stop_tags), _raw(c)))
    assert out[0] == out[1] and out[0][0]


@pytest.mark.parametrize("table,tag_batch", [
    ("nodegraph", 7), ("countgraph", port_graph.TAG_BATCH),
    ("tiny-nodegraph", port_graph.TAG_BATCH), ("tiny-countgraph", 7)])
def test_consume_and_tag_with_stoptags(files, table, tag_batch):
    """Also over tables so small (3 x ~100 bins) that a batch's empty
    bins are shared and settled on the host."""
    cls = "Nodegraph" if table.endswith("nodegraph") else "Countgraph"
    primes = [101, 103, 107] if table.startswith("tiny") else None
    k = 20
    state = []
    for mod, kw in ((khmer_tpu, {}), (khmer_tpu_torch, {"device": "cpu"})):
        g = getattr(mod, cls)(k, *((1, 1) if primes else (SIZE, N_TABLES)),
                              primes=primes, **kw)
        # stop tags: one k-mer in 25 of the knot's sequences
        seqs = [r.sequence for r in khmer_tpu.FastxReader(files["knot"])]
        for s in seqs:
            for i in range(5, len(s) - k, 25):
                g.add_stop_tag(s[i:i + k])
        with mock.patch.object(port_graph, "TAG_BATCH", tag_batch):
            ret = [g.consume_seqfile_and_tag_with_stoptags(files["knot"]),
                   g.consume_fasta_and_tag_with_stoptags(
                       str(files["dir"] / "meta0.fa"))]
        state.append((ret, _state(g)))
    assert state[1] == state[0]


@pytest.mark.parametrize("k", [20, 32])
def test_sweep_for_tags(files, k):
    jg, pg = _graphs(files["lump"], k)
    for g in (jg, pg):
        g.merge_subset(g.do_subset_partition(0, 0))
        for t in sorted(g.all_tags)[::9]:
            g.add_stop_tag(t)
    seqs = [r.sequence for r in khmer_tpu.FastxReader(files["lump"])]
    for seq in (seqs[0][380:480], seqs[3][:k], seqs[5][100:100 + k - 1]):
        for args in ((0,), (5,), (40, True), (100, False, True)):
            assert pg.sweep_for_tags(seq, *args) == \
                jg.sweep_for_tags(seq, *args), args


@pytest.mark.parametrize("traverse", [True, False])
def test_find_unpart(files, traverse):
    d = files["dir"]
    out = []
    for mod, kw in ((khmer_tpu, {}), (khmer_tpu_torch, {"device": "cpu"})):
        g = mod.Nodegraph(20, SIZE, N_TABLES, **kw)
        g.consume_seqfile_and_tag(str(d / "meta1.fa"))
        g.merge_subset(g.do_subset_partition(0, 0))
        n = g.find_unpart(str(d / "meta0.fa"), traverse, False)
        out.append((n, g.count_partitions(), _state(g)))
    assert out[1] == out[0]
    assert out[0][0] > 0


def test_partition_with_abundance(files, tmp_path):
    jg, pg = _graphs(files["knot"], 20, cls="Countgraph")
    pg.consume_seqfile(files["lump"])
    jg.consume_seqfile(files["lump"])
    for lo, hi in ((2, 100),):
        for g, side in ((jg, "j"), (pg, "p")):
            sub = g.do_subset_partition_with_abundance(lo, hi)
            sub.save_partitionmap(str(tmp_path / side))
        assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def test_partition_api(files, tmp_path, capsys):
    jg, pg = _graphs(files["meta"], 20)
    jc, pc = _graphs(files["meta"], 20, cls="Countgraph")
    seqs = [r.sequence for r in khmer_tpu.FastxReader(files["meta"])]
    got = []
    for g, c, mod in ((jg, jc, khmer_tpu), (pg, pc, khmer_tpu_torch)):
        sub = g.do_subset_partition(0, 0)
        out = [g.subset_count_partitions(sub)]
        g.merge_subset(sub)
        g._validate_partitionmap()
        sub._validate_partitionmap()
        seed = seqs[4][:20]
        ppi = g.find_all_tags(seed)
        assert isinstance(ppi, mod.PrePartitionInfo)
        out += [sorted(ppi.tagged_kmers), g.assign_partition_id(ppi),
                sorted(g.find_all_tags_list(seqs[9][:20]).hashes),
                g.partition.partition_size_distribution(),
                g.partition.partition_average_coverages(c), _state(g)]
        g.save_partitionmap(str(tmp_path / "pmap"))
        loaded = type(g.partition).load(str(tmp_path / "pmap"), g)
        out.append(list(loaded.partition_map.items()))
        g.partition.report_on_partitions()
        out.append(capsys.readouterr().out)
        got.append(out)
    assert got[1] == got[0]


def test_older_consumes_and_filter_if_present(files, tmp_path):
    d = files["dir"]
    # a partition-annotated file, then loads of it
    jg, pg = _graphs(files["meta"], 20)
    for g, side in ((jg, "j"), (pg, "p")):
        g.merge_subset(g.do_subset_partition(0, 0))
        g.output_partitions(str(d / "meta0.fa"),
                            str(tmp_path / (side + ".part")), True)
    part = str(tmp_path / "j.part")
    assert (tmp_path / "p.part").read_bytes() == open(part, "rb").read()
    with open(part) as f, open(str(tmp_path / "bad.part"), "w") as g:
        g.write(f.read() + ">no partition here\n" + "ACGT" * 10 + "\n")
    got = []
    for mod, kw in ((khmer_tpu, {}), (khmer_tpu_torch, {"device": "cpu"})):
        g = mod.Nodegraph(20, SIZE, N_TABLES, **kw)
        out = [g.consume_partitioned_fasta(part), _state(g)]
        g = mod.Nodegraph(20, SIZE, N_TABLES, **kw)
        with pytest.raises(ValueError):
            g.consume_partitioned_fasta(str(tmp_path / "bad.part"))
        out.append(_state(g))
        g = mod.Nodegraph(20, SIZE, N_TABLES, **kw)
        out += [g.consume_fasta_and_tag(str(d / "meta0.fa")),
                g.consume_fasta_and_tag_with_reads_parser(
                    mod.FastxReader(str(d / "meta1.fa"))),
                g.consume_seqfile_and_tag_with_reads_parser(
                    mod.FastxReader(files["lump"])), _state(g)]
        g = mod.Nodegraph(20, SIZE, N_TABLES, **kw)
        for read in mod.FastxReader(str(d / "meta0.fa")):
            if read.name in ("r0", "r2", "r4", "r6", "r8"):
                g.consume(read.sequence)
        out_path = str(tmp_path / (mod.__name__ + ".present"))
        g.filter_if_present(files["meta"], out_path)
        g.filter_if_present(files["lump"], out_path + "2")
        out += [open(out_path, "rb").read(), open(out_path + "2", "rb").read()]
        got.append(out)
    assert got[1] == got[0]
    assert got[0][-1].count(b">") == 6 and got[0][-2].count(b">") > 100


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------

TABLE = ["-k", "20", "-N", "4", "-x", str(SIZE)]
STEPS = [
    ("do-partition.py", do_partition,
     TABLE + ["-s", "50", "--keep-subsets", "dp", "meta.fa"]),
    ("do-partition.py", do_partition, TABLE + ["-s", "50", "dq", "meta.fa"]),
    ("load-graph.py", load_graph, TABLE + ["lump", "knot.fa"]),
    ("make-initial-stoptags.py", make_initial_stoptags,
     ["-k", "20", "-x", str(SIZE), "lump"]),
    ("partition-graph.py", partition_graph,
     ["--stoptags", "lump.stoptags", "-s", "30", "lump"]),
    ("find-knots.py", find_knots, ["-x", str(SIZE), "-N", "4", "lump"]),
    ("filter-stoptags.py", filter_stoptags,
     ["-k", "20", "lump.stoptags", "knot.fa", "meta0.fa"]),
]


def _snapshot(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def chains(files):
    """Both packages' runs of STEPS, each in its own directory holding the
    inputs: every file after every step, and every step's stderr."""
    out = {}
    for side in ("jax", "port"):
        d = files["dir"] / side
        d.mkdir()
        for name in ("knot", "meta"):
            (d / (name + ".fa")).write_bytes(open(files[name], "rb").read())
        (d / "meta0.fa").write_bytes((files["dir"] / "meta0.fa").read_bytes())
        for script, module, argv in STEPS:
            if side == "jax":
                _, _, err = runscript(script, argv, in_directory=str(d))
            else:
                err = _run_port(script, module, argv, str(d))
            out[side, script, tuple(argv)] = (err, _snapshot(str(d)))
    return out


def _run_port(script, module, argv, cwd):
    """module.main(argv) in cwd with the script's name as argv[0] (which
    the banner prints); returns its stderr."""
    here = os.getcwd()
    buf = io.StringIO()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stderr(buf), \
                mock.patch.object(sys, "argv", [script] + argv):
            module.main(argv, device="cpu")
    finally:
        os.chdir(here)
    return buf.getvalue()


def _lines(err):
    """stderr's lines, the banner's line that names the runtime (the
    port's names itself) marked as such."""
    return ["<runtime>" if ln.startswith("|| You are also using the ") and
            ln.endswith(" runtime") else ln for ln in err.splitlines()]


@pytest.mark.parametrize("step", range(len(STEPS)),
                         ids=[s[0] + str(i) for i, s in enumerate(STEPS)])
def test_script_output_and_stderr(chains, step):
    script, _, argv = STEPS[step]
    want_err, want = chains["jax", script, tuple(argv)]
    got_err, got = chains["port", script, tuple(argv)]
    assert _lines(got_err) == _lines(want_err)
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f


def test_the_knots_are_found(chains):
    """find-knots adds to make-initial-stoptags' stop tags, the filter
    cuts reads at them, and do-partition's .part names partitions."""
    files = chains["port", "filter-stoptags.py", tuple(STEPS[-1][2])][1]
    initial = chains["port", "make-initial-stoptags.py",
                     tuple(STEPS[3][2])][1]["lump.stoptags"]
    assert len(files["lump.stoptags"]) >= len(initial) > 26 + 8 * 20
    assert "lump.subset.0.pmap.processed" in files
    assert len(files["knot.fa.stopfilt"]) < len(files["knot.fa"])
    assert b"\t" in files["meta.fa.part"]
    assert not [f for f in files if f.startswith("dq.subset")]


@pytest.mark.parametrize("module", [make_initial_stoptags, find_knots,
                                    filter_stoptags, do_partition],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_scripts_default_to_the_card(chains, files, tmp_path, module):
    """Without device=, every entry point asks for CUDA and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    d = files["dir"] / "port"
    argv = {do_partition: TABLE + [str(tmp_path / "x"), str(d / "meta.fa")],
            make_initial_stoptags: [str(d / "lump")],
            find_knots: [str(d / "lump")],
            filter_stoptags: ["-k", "20", str(d / "lump.stoptags"),
                              str(d / "meta0.fa")]}[module]
    here = os.getcwd()
    os.chdir(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main(argv)
    finally:
        os.chdir(here)

"""Port parity of the 4-bit tables, SmallCountgraph and SmallCounttable
(NibbleStorage), and of the five scripts behind --small-count:
khmer_tpu_torch against khmer_tpu on the same generated reads.

At k = 20, on tables of 4 x 20011 bins (odd sizes: each table's saved
bytes end in a pad nibble): consume_seqfile (n_unique, n_occupied),
consume, add and get past the cap of 15, get_kmer_counts, count_rows,
get_median_count(_batch), median_at_least_batch, abundance_distribution
(folded at 15), the saved bytes and their load, and
convert.storage_from_numpy("nibble", ...) of khmer_tpu's bins.  Then
load-into-counting, abundance-dist-single, normalize-by-median -C 20
(above the cap: pre-counts read at 15), filter-abund-single and
trim-low-abund (with -Z 20 above the cap, and with --loadgraph of the
small .ct) with --small-count write the same bytes as scripts/*.py,
both cutting batches of BATCH bundles.  Integer data: exact equality."""

import os

import numpy as np
import pytest

import khmer_tpu
from khmer_tpu_torch import (SmallCountgraph, SmallCounttable, Nodegraph,
                             Nodetable, convert)
from khmer_tpu_torch.scripts import (abundance_dist_single,
                                     filter_abund_single, load_into_counting,
                                     normalize_by_median, trim_low_abund)

from .khmer_tst_utils import runscript
from .test_torch_filters import write_pairs
from .test_torch_rows import _with_errors
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

K = 20
SIZE = 20011
N_TABLES = 4
BATCH = 64
N_PAIRS = 200
ODD = "ACGTNacgtRYKMacgtACGTTGCAAGGCTTAACCGGTTAACGTAGCTAGCTAGGCTAACGTTT"
CLASSES = {"SmallCountgraph": (khmer_tpu.SmallCountgraph, SmallCountgraph,
                               khmer_tpu.Nodegraph, Nodegraph),
           "SmallCounttable": (khmer_tpu.SmallCounttable, SmallCounttable,
                               khmer_tpu.Nodetable, Nodetable)}


def _reads(seed, n=300, genome_len=1500, readlen=100):
    """Reads at 20x over a short genome, so most counts pass 15."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    starts = rng.integers(0, genome_len - readlen, n)
    return [genome[s:s + readlen] for s in starts]


@pytest.fixture(scope="module", params=sorted(CLASSES))
def tables(request, tmp_path_factory):
    jcls, pcls, _, _ = CLASSES[request.param]
    d = tmp_path_factory.mktemp("torch_small_" + request.param)
    reads = _reads(7)
    fa = str(d / "reads.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(reads):
            f.write(">r%d\n%s\n" % (i, s))
    out = {"name": request.param, "reads": reads, "fa": fa, "dir": d}
    for side, cls in (("jax", jcls), ("port", pcls)):
        kw = {} if side == "jax" else {"device": "cpu"}
        t = cls(K, SIZE, N_TABLES, **kw)
        out[side + "_consumed"] = t.consume_seqfile(fa)
        # past the cap one k-mer at a time, and a read with N and IUPAC
        # bytes where the table hashes them (murmur)
        out[side + "_new"] = [t.add(ODD[:K]) for _ in range(18)]
        if request.param == "SmallCounttable":
            out[side + "_new"].append(t.consume(ODD))
        out[side] = t
    return out


def test_counts_match(tables):
    j, t = tables["jax"], tables["port"]
    assert tables["port_consumed"] == tables["jax_consumed"]
    assert tables["port_new"] == tables["jax_new"]
    assert t.n_unique_kmers() == j.n_unique_kmers() > 0
    assert t.n_occupied() == j.n_occupied()
    assert t.get(ODD[:K]) == j.get(ODD[:K]) == 15
    queries = tables["reads"][:4] + _with_errors(tables["reads"][4:8], 0.02,
                                                 3)
    for s in queries:
        assert t.get(s[:K]) == j.get(s[:K])
        assert t.get_kmer_counts(s) == j.get_kmer_counts(s)
        assert t.get_median_count(s) == j.get_median_count(s)
    assert max(max(t.get_kmer_counts(s)) for s in queries) == 15
    for got, want in zip(t.count_rows(queries), j.count_rows(queries)):
        assert np.array_equal(got, want)
    for cutoff in (3, 15, 16):
        assert np.array_equal(
            t.median_at_least_batch(queries, cutoff),
            np.asarray(j.median_at_least_batch(queries, cutoff)))
    assert t.get_median_count_batch(queries) == \
        [tuple(x) for x in j.get_median_count_batch(queries)]


def test_histogram_folds_at_the_cap(tables):
    _, _, jtrack, ptrack = CLASSES[tables["name"]]
    j, t, fa = tables["jax"], tables["port"], tables["fa"]
    want = j.abundance_distribution(fa, jtrack(K, 1, 1,
                                               primes=j.hashsizes()))
    got = t.abundance_distribution(fa, ptrack(K, 1, 1, primes=t.hashsizes(),
                                              device="cpu"))
    assert got == want
    assert want[15] > 0 and sum(want[16:]) == 0


def test_saved_bytes_and_load_match(tables):
    j, t, d = tables["jax"], tables["port"], tables["dir"]
    j.save(str(d / "jax.ct"))
    t.save(str(d / "port.ct"))
    raw = open(d / "port.ct", "rb").read()
    assert raw == open(d / "jax.ct", "rb").read()
    assert raw[5] == 7  # SAVED_SMALLCOUNT
    # header 4 + 1 + 1 + 4 + 1 + 8, then per table a size and its bytes
    assert len(raw) == 19 + sum(8 + s // 2 + 1 for s in t.hashsizes())
    pcls = CLASSES[tables["name"]][1]
    loaded = pcls.load(str(d / "jax.ct"), device="cpu")
    for s in tables["reads"][:3]:
        assert loaded.get_kmer_counts(s) == j.get_kmer_counts(s)
    assert loaded.n_occupied() == j.n_occupied()
    loaded.save(str(d / "again.ct"))
    assert open(d / "again.ct", "rb").read() == raw
    with pytest.raises(ValueError, match="bigcount"):
        loaded.set_use_bigcount(True)


def test_storage_from_numpy_nibble(tables):
    j = tables["jax"]
    bins = np.asarray(j.storage.table)
    st = convert.storage_from_numpy("nibble", j.hashsizes(), bins,
                                    j.n_unique_kmers(), device="cpu")
    assert st.kind == "nibble" and st.read_cap() == 15
    assert np.array_equal(st.raw_bytes(), np.asarray(j.storage.raw_bytes()))
    pcls = CLASSES[tables["name"]][1]
    t = convert.table_from_numpy(pcls, K, j.hashsizes(), bins,
                                 j.n_unique_kmers(), device="cpu")
    for s in tables["reads"][:3]:
        assert t.get_kmer_counts(s) == j.get_kmer_counts(s)
    assert t.n_unique_kmers() == j.n_unique_kmers()


TABLE = ["--small-count", "-k", str(K), "-N", str(N_TABLES), "-x",
         str(SIZE)]
RUNS = [  # (khmer_tpu script, port module, argv, outputs)
    ("load-into-counting.py", load_into_counting,
     TABLE + ["lic.ct", "reads.fa"], ["lic.ct", "lic.ct.info"]),
    ("abundance-dist-single.py", abundance_dist_single,
     TABLE + ["--savegraph", "ads.ct", "reads.fa", "ads.hist"],
     ["ads.hist", "ads.ct"]),
    ("normalize-by-median.py", normalize_by_median,
     TABLE + ["-p", "-C", "20", "--savegraph", "nbm.ct", "reads.fa"],
     ["reads.fa.keep", "nbm.ct"]),
    ("filter-abund-single.py", filter_abund_single,
     TABLE + ["-C", "2", "-o", "single.fa", "reads.fa"], ["single.fa"]),
    ("trim-low-abund.py", trim_low_abund,
     TABLE + ["-C", "3", "-V", "-o", "trim.fa", "reads.fa"], ["trim.fa"]),
    ("trim-low-abund.py", trim_low_abund,
     ["--small-count", "-C", "3", "--loadgraph", "lic.ct", "-o",
      "trimlg.fa", "reads.fa"], ["trimlg.fa"]),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for side in ("jax", "port"):
        d = tmp_path_factory.mktemp("torch_small_scripts_" + side)
        write_pairs(str(d / "reads.fa"), seed=5, n_pairs=N_PAIRS,
                    genome_len=1200)
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            mp.setenv("KHMER_TPU_DN_BATCH", str(BATCH))
            mp.setenv("KHMER_TPU_TRIM_BATCH", str(BATCH))
            for script, module, argv, _ in RUNS:
                argv = ["-q"] + argv
                if side == "jax":
                    status, _, err = runscript(script, argv)
                    assert status == 0, err
                else:
                    kw = dict(batch=BATCH) if module in (
                        normalize_by_median, trim_low_abund) else {}
                    module.main(argv, device="cpu", **kw)
        out[side] = {name: open(os.path.join(d, name), "rb").read()
                     for run in RUNS for name in run[3]}
    return out


@pytest.mark.parametrize("name", [n for run in RUNS for n in run[3]])
def test_small_count_script_output_bytes_match(runs, name):
    assert runs["port"][name] == runs["jax"][name]
    assert len(runs["port"][name]) > 0


def test_small_count_scripts_read_at_the_cap(runs):
    port = runs["port"]
    rows = port["ads.hist"].decode().splitlines()
    assert int(rows[-1].split(",")[0]) == 15
    for name in ("lic.ct", "ads.ct", "nbm.ct"):
        assert port[name][5] == 7

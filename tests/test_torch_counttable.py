"""Port parity of the murmur tables, Counttable and Nodetable, and of the
streaming filters with -H murmur: khmer_tpu_torch against khmer_tpu on
the same generated reads.

At k = 20 and 51, on tables of 4 x 20011 bins (with bin collisions):
hash, get_kmer_hashes (lowercase, N and IUPAC bytes), consume and get,
consume_seqfile (the port's native-loader chunks hashed by K8 and added
by K2 in stream order, so n_unique follows the same claim rule),
count_rows and the per-read queries over K5's murmur variant,
abundance_distribution, the saved bytes, reverse_hash's error and the
k limits; convert.table_from_numpy of khmer_tpu's bins answers the same.
Then normalize-by-median -p, trim-low-abund and filter-abund-single
with -H murmur -k 51 write the same bytes as scripts/*.py, both cutting
batches of BATCH bundles.  Integer data: exact equality."""

import os

import numpy as np
import pytest
import torch

import khmer_tpu
from khmer_tpu_torch import Counttable, Nodetable, convert
from khmer_tpu_torch.scripts import (filter_abund_single,
                                     normalize_by_median, trim_low_abund)

from .khmer_tst_utils import runscript
from .test_torch_filters import write_pairs
from .test_torch_rows import _with_errors
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

SIZE = 20011
N_TABLES = 4
BATCH = 64
# 170 pairs cut into batches of 64, 64 and 42: the last batch is partial
# yet pads to the same 128 rows, so khmer_tpu compiles one row shape
N_PAIRS = 170
ODD = "ACGTNacgtRYKMacgtACGTTGCAAGGCTTAACCGGTTAACGTAGCTAGCTAGGCTAACGTTT"


def _reads(seed, n=120, genome_len=3000, readlen=100):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    starts = rng.integers(0, genome_len - readlen, n)
    return [genome[s:s + readlen] for s in starts]


@pytest.fixture(scope="module", params=[20, 51])
def tables(request, tmp_path_factory):
    k = request.param
    d = tmp_path_factory.mktemp("torch_ct{}".format(k))
    reads = _reads(k)
    fa = str(d / "reads.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(reads + [ODD]):
            f.write(">r%d\n%s\n" % (i, s))
    out = {"k": k, "reads": reads, "fa": fa, "dir": d}
    for side, cls in (("jax", khmer_tpu.Counttable), ("port", Counttable)):
        kw = {} if side == "jax" else {"device": "cpu"}
        t = cls(k, SIZE, N_TABLES, **kw)
        out[side + "_consumed"] = t.consume_seqfile(fa)
        out[side + "_new"] = [t.add(r[:k]) for r in reads[:3]] + \
            [t.consume(ODD)]
        out[side] = t
    return out


def test_hashes_match(tables):
    k, j, t = tables["k"], tables["jax"], tables["port"]
    for s in (ODD, tables["reads"][0], ODD[:k]):
        assert t.get_kmer_hashes(s) == j.get_kmer_hashes(s)
    assert t.hash(ODD[:k]) == j.hash(ODD[:k])
    assert t.hash(12345) == 12345
    with pytest.raises(ValueError, match="Expected k-mer length"):
        t.hash(ODD[:k + 1])
    with pytest.raises(ValueError, match="not implemented"):
        t.reverse_hash(t.hash(ODD[:k]))
    assert any(h >= 1 << 63 for h in t.get_kmer_hashes(ODD))


def test_counts_match(tables):
    j, t = tables["jax"], tables["port"]
    assert tables["port_consumed"] == tables["jax_consumed"]
    assert tables["port_new"] == tables["jax_new"]
    assert t.n_unique_kmers() == j.n_unique_kmers()
    assert t.n_occupied() == j.n_occupied()
    queries = tables["reads"][:3] + _with_errors(tables["reads"][3:6], 0.02,
                                                 3) + [ODD]
    for s in queries:
        assert t.get(s[:tables["k"]]) == j.get(s[:tables["k"]])
        assert t.get_kmer_counts(s) == j.get_kmer_counts(s)
        assert t.get_median_count(s) == j.get_median_count(s)
        assert t.trim_on_abundance(s, 3) == j.trim_on_abundance(s, 3)
    for got, want in zip(t.count_rows(queries), j.count_rows(queries)):
        assert np.array_equal(got, want)
    assert np.array_equal(t.median_at_least_batch(queries, 3),
                          np.asarray(j.median_at_least_batch(queries, 3)))
    assert t.get_median_count_batch(queries) == \
        [tuple(x) for x in j.get_median_count_batch(queries)]


def test_saved_bytes_and_histogram_match(tables):
    j, t, d, fa = tables["jax"], tables["port"], tables["dir"], tables["fa"]
    j.save(str(d / "jax.ct"))
    t.save(str(d / "port.ct"))
    assert open(d / "port.ct", "rb").read() == open(d / "jax.ct", "rb").read()
    k = tables["k"]
    want = j.abundance_distribution(
        fa, khmer_tpu.Nodetable(k, 1, 1, primes=j.hashsizes()))
    got = t.abundance_distribution(
        fa, Nodetable(k, 1, 1, primes=t.hashsizes(), device="cpu"))
    assert got == want and sum(want) > 0
    loaded = Counttable.load(str(d / "jax.ct"), device="cpu")
    assert loaded.get_kmer_counts(ODD) == j.get_kmer_counts(ODD)


def test_table_from_numpy_matches(tables):
    j = tables["jax"]
    for cls, jcls in ((Counttable, khmer_tpu.Counttable),
                      (Nodetable, khmer_tpu.Nodetable)):
        jt = j if jcls is khmer_tpu.Counttable else \
            jcls(tables["k"], SIZE, N_TABLES)
        if jt is not j:
            jt.consume(ODD)
        t = convert.table_from_numpy(
            cls, jt.ksize(), jt.hashsizes(), np.asarray(jt.storage.table),
            jt.n_unique_kmers(), device="cpu")
        assert t.get_kmer_counts(ODD) == jt.get_kmer_counts(ODD)
        assert t.n_unique_kmers() == jt.n_unique_kmers()
        assert t.hash_kind == "murmur"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    for cls in (Counttable, Nodetable):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(51, 1000, 4)


def test_k_limits():
    assert Counttable(255, 101, 1, device="cpu").ksize() == 255
    for k in (0, 256):
        with pytest.raises(ValueError):
            Counttable(k, 101, 1, device="cpu")
    Nodetable(51, 101, 1, device="cpu").consume("ACGT" * 13)


RUNS = [  # (khmer_tpu script, port module, argv, outputs)
    ("normalize-by-median.py", normalize_by_median,
     ["-p", "-C", "5", "reads.fa"], ["reads.fa.keep"]),
    ("trim-low-abund.py", trim_low_abund,
     ["-C", "2", "-o", "trim.fa", "reads.fa"], ["trim.fa"]),
    ("filter-abund-single.py", filter_abund_single,
     ["-C", "3", "-o", "single.fa", "reads.fa"], ["single.fa"]),
]
TABLE = ["-H", "murmur", "-k", "51", "-N", "4", "-x", str(SIZE)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for side in ("jax", "port"):
        d = tmp_path_factory.mktemp("torch_murmur_filters_" + side)
        write_pairs(str(d / "reads.fa"), n_pairs=N_PAIRS)
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            mp.setenv("KHMER_TPU_DN_BATCH", str(BATCH))
            mp.setenv("KHMER_TPU_TRIM_BATCH", str(BATCH))
            for script, module, argv, _ in RUNS:
                if side == "jax":
                    status, _, err = runscript(script, ["-q"] + TABLE + argv)
                    assert status == 0, err
                else:
                    kw = {} if module is filter_abund_single else \
                        dict(batch=BATCH)
                    module.main(["-q"] + TABLE + argv, device="cpu", **kw)
        out[side] = {name: open(os.path.join(d, name), "rb").read()
                     for run in RUNS for name in run[3]}
    return out


@pytest.mark.parametrize("name", [n for run in RUNS for n in run[3]])
def test_murmur_script_output_bytes_match(runs, name):
    assert runs["port"][name] == runs["jax"][name]
    assert 0 < runs["port"][name].count(b">") <= 2 * N_PAIRS

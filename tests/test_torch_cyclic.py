"""Port parity of kernel K11 (cyclic_hashes), of K5's cyclic variant and
of CyclicCounttable: khmer_tpu_torch against khmer_tpu on the same numpy
inputs.

K11's plain version is held to kmer_hashes_cyclic_bytes at k = 1, 20,
63, 64, 65, 100 and 255 (the rotations wrap at 64, and the j = k - 1 term
of h and the j = 0 mod 64 terms of r rotate by 0), on padded rows with
lowercase, N and IUPAC bytes and lengths 0, below k, k and shorter than
the row; the canonical sum wraps mod 2**64, which hashes with the top bit
set exercise.  The scalar hash, with khmer_tpu's three goldens of
tests/test_hashing.py, and csrc/cyclic.cuh's table against the Python
one.  Then CyclicCounttable at k = 20 on 4 x 20011 bins: consume_seqfile
(the loader's chunks decoded to ASCII and hashed by K11), consume, get,
get_kmer_counts, the median queries over K5c's plain version,
abundance_distribution and the saved bytes.  Exact equality."""

import os
import re

import numpy as np
import pytest
import torch

import khmer_tpu
from khmer_tpu.ops.rollinghash import kmer_hashes_cyclic_bytes
from khmer_tpu_torch import CyclicCounttable, Nodetable, _u64, kernels
from khmer_tpu_torch.kernels import _build, plain
from khmer_tpu_torch.ops.rollinghash import _CYCLIC_TABLE, hash_cyclic_scalar
from khmer_tpu_torch.ops.sketch_ops import SketchSpec

from .test_torch_rows import _with_errors

KS = (1, 20, 63, 64, 65, 100, 255)
ALPHABET = np.frombuffer(b"ACGTacgtNnRYKMSWBDHVU.-", np.uint8)
ODD = "ACGTNacgtRYKMacgtACGTTGCAAGGCTTAACCGGTTAACGTAGCTAGCTAGGCTAACGTTT"
SIZE = 20011
N_TABLES = 4


def _batch(k, seed):
    """uint8 rows [5, L] and lengths 0, k - 1, k, L and L - 7: row 3
    mixes in lowercase, N, IUPAC and other bytes."""
    rng = np.random.default_rng(seed)
    L = 40 + k
    byts = rng.choice(np.frombuffer(b"ACGT", np.uint8), (5, L))
    mixed = rng.random(L) < 0.3
    byts[3, mixed] = rng.choice(ALPHABET, int(mixed.sum()))
    lengths = np.array([0, k - 1, k, L, L - 7], np.int32)
    return byts, lengths


@pytest.mark.parametrize("k", KS)
def test_cyclic_hashes_match_kmer_hashes_cyclic_bytes(k):
    byts, lengths = _batch(k, k)
    want, want_valid = kmer_hashes_cyclic_bytes(byts, lengths, k)
    got, valid = kernels.cyclic_hashes(torch.from_numpy(byts),
                                       torch.from_numpy(lengths), k)
    assert np.array_equal(_u64.to_numpy(got), np.asarray(want))
    assert np.array_equal(valid.numpy(), np.asarray(want_valid))
    assert (_u64.to_numpy(got) >= 1 << 63).any()
    # the window at column 0 of the mixed row, hashed on the host
    kmer = byts[3, :k].tobytes().decode("latin-1")
    assert int(_u64.to_numpy(got)[3, 0]) == hash_cyclic_scalar(kmer)[0]


def test_cyclic_hashes_limits():
    byts = torch.zeros((2, 300), dtype=torch.uint8)
    lengths = torch.zeros(2, dtype=torch.int32)
    for k in (0, 256):
        with pytest.raises(ValueError):
            kernels.cyclic_hashes(byts, lengths, k)
    with pytest.raises(ValueError):
        kernels.cyclic_hashes(byts[:, :19], lengths, 20)
    h, v = kernels.cyclic_hashes(byts[:0], lengths[:0], 20)
    assert h.shape == (0, 281) and v.shape == (0, 281)


def test_scalar_hash_and_goldens():
    assert hash_cyclic_scalar('ACGTACGTACGTACGTACGT') == (
        7799567892625678318, 13123155983167614967, 13123155983167614967)
    assert hash_cyclic_scalar('TTTTTT') == (
        13218220985018796895, 11878804279949710440, 1339416705069086455)
    assert hash_cyclic_scalar('GATTACAGATTACAGATTACAGATTACAGATTACA') == (
        16756336693072190462, 7513208593411347810, 9243128099660842652)
    from khmer_tpu.ops.rollinghash import hash_cyclic_scalar as jax_scalar

    rng = np.random.default_rng(3)
    for k in KS:
        kmer = rng.choice(ALPHABET, k).tobytes().decode()
        assert hash_cyclic_scalar(kmer) == jax_scalar(kmer)
    with pytest.raises(ValueError):
        hash_cyclic_scalar("ACGT", 5)


def test_cuda_table_matches_python_table():
    with open(os.path.join(_build.CSRC, "cyclic.cuh")) as f:
        body = f.read().split("kTable[256] = {")[1].split("};")[0]
    values = [int(x, 16) for x in re.findall(r"0x([0-9a-f]{16})ULL", body)]
    assert values == [int(x) for x in _CYCLIC_TABLE]


def test_row_counts_cyclic_matches_hash_then_get():
    """K5c's plain version: the counts of K11's hashes read through K3's
    plain version at the cap, 0 past each row's length."""
    k = 65
    byts, lengths = _batch(k, 9)
    b, n = torch.from_numpy(byts), torch.from_numpy(lengths)
    spec = SketchSpec("byte", (1009, 1013))
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.integers(0, 40, spec.total_bins + 1,
                                          dtype=np.int32))
    geom = spec.geometry("cpu")
    counts, hashes = kernels.row_counts(b, n, k, table, *geom, 15, True,
                                        "cyclic")
    h, valid = kernels.cyclic_hashes(b, n, k)
    assert torch.equal(hashes, h)
    want = plain.sketch_get(table, h.reshape(-1), *geom, 15).reshape(h.shape)
    assert torch.equal(counts, torch.where(valid, want, 0).to(torch.uint16))


def _reads(seed, n=150, genome_len=2500, readlen=100):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    starts = rng.integers(0, genome_len - readlen, n)
    return [genome[s:s + readlen] for s in starts]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cyclic")
    reads = _reads(4)
    fa = str(d / "reads.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(reads + [ODD]):
            f.write(">r%d\n%s\n" % (i, s))
    out = {"reads": reads, "fa": fa, "dir": d}
    for side, cls in (("jax", khmer_tpu.CyclicCounttable),
                      ("port", CyclicCounttable)):
        kw = {} if side == "jax" else {"device": "cpu"}
        t = cls(20, SIZE, N_TABLES, **kw)
        out[side + "_consumed"] = t.consume_seqfile(fa)
        out[side + "_new"] = [t.add(r[:20]) for r in reads[:3]] + \
            [t.consume(ODD)]
        out[side] = t
    return out


def test_cyclic_counttable_matches(tables):
    j, t = tables["jax"], tables["port"]
    assert tables["port_consumed"] == tables["jax_consumed"]
    assert tables["port_new"] == tables["jax_new"]
    assert t.n_unique_kmers() == j.n_unique_kmers() > 0
    assert t.n_occupied() == j.n_occupied()
    assert t.hash(ODD[:20]) == j.hash(ODD[:20]) == \
        hash_cyclic_scalar(ODD[:20])[0]
    assert t.get_kmer_hashes(ODD) == j.get_kmer_hashes(ODD)
    with pytest.raises(ValueError, match="not implemented"):
        t.reverse_hash(t.hash(ODD[:20]))
    queries = tables["reads"][:3] + _with_errors(tables["reads"][3:6], 0.02,
                                                 3) + [ODD]
    for s in queries:
        assert t.get(s[:20]) == j.get(s[:20])
        assert t.get_kmer_counts(s) == j.get_kmer_counts(s)
        assert t.get_median_count(s) == j.get_median_count(s)
        assert t.median_at_least(s, 3) == j.median_at_least(s, 3)
        assert t.trim_on_abundance(s, 3) == j.trim_on_abundance(s, 3)
    kernels.reset_launches()
    for got, want in zip(t.count_rows(queries), j.count_rows(queries)):
        assert np.array_equal(got, want)
    assert np.array_equal(t.median_at_least_batch(queries, 3),
                          np.asarray(j.median_at_least_batch(queries, 3)))
    assert t.get_median_count_batch(queries) == \
        [tuple(x) for x in j.get_median_count_batch(queries)]
    # launches count CUDA kernels only: the CPU path launches none
    assert kernels.ROW_COUNTS_BY_HASH["cyclic"] == 0


def test_cyclic_histogram_and_saved_bytes_match(tables):
    j, t, d, fa = tables["jax"], tables["port"], tables["dir"], tables["fa"]
    want = j.abundance_distribution(
        fa, khmer_tpu.Nodetable(20, 1, 1, primes=j.hashsizes()))
    got = t.abundance_distribution(
        fa, Nodetable(20, 1, 1, primes=t.hashsizes(), device="cpu"))
    assert got == want and sum(want) > 0
    j.save(str(d / "jax.ct"))
    t.save(str(d / "port.ct"))
    assert open(d / "port.ct", "rb").read() == open(d / "jax.ct", "rb").read()
    loaded = CyclicCounttable.load(str(d / "jax.ct"), device="cpu")
    assert loaded.get_kmer_counts(ODD) == j.get_kmer_counts(ODD)
    assert loaded.hash_kind == "cyclic"


def test_k_limits():
    assert CyclicCounttable(255, 101, 1, device="cpu").ksize() == 255
    for k in (0, 256):
        with pytest.raises(ValueError):
            CyclicCounttable(k, 101, 1, device="cpu")

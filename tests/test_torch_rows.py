"""Port parity of kernel K5 (row_counts) and the read-level queries built
on it: khmer_tpu_torch against khmer_tpu on the same numpy inputs.

K5's plain version is held to khmer_tpu's jitted row functions
(_make_row_hashes_counts_fn, _make_row_counts_fn) on padded batches
with rows of length 0, shorter than k, exactly k and longer than 64;
the Countgraph methods (count_rows, _hash_count_rows,
median_at_least_batch, get_median_count(_batch), median_at_least,
trim_on/below_abundance, find_spectral_error_positions) to khmer_tpu's
on a table of 4 x 20011 bins (with bin collisions) filled from
generated reads, queried with some of those reads and short reads, and
with their 1% error variant, and on a loaded .ct with a bigcount map
(which the per-read methods overlay and the row functions do not).
One table size keeps khmer_tpu's CPU compiles to one per function.
Integer data: exact equality; the float averages of get_median_count
are computed by the same numpy code on equal counts, so they are equal
too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import khmer_tpu
from khmer_tpu.hashtable import (_make_median_at_least_fn,
                                 _make_row_counts_fn,
                                 _make_row_hashes_counts_fn)
from khmer_tpu.ops import sketch_ops as jsk
from khmer_tpu_torch import Countgraph, _u64, kernels
from khmer_tpu_torch.hashtable import _pad_rows, _row_width
from khmer_tpu_torch.ops.sketch_ops import SketchSpec

from .test_torch_countgraph import write_reads

K = 20
SIZE = 20011


def _with_errors(seqs, rate, seed):
    """The reads with a share `rate` of their bases substituted."""
    rng = np.random.default_rng(seed)
    out = []
    for s in seqs:
        b = np.frombuffer(s.upper().encode(), np.uint8).copy()
        hit = rng.random(b.size) < rate
        b[hit] = rng.choice(np.frombuffer(b"ACGT", np.uint8), hit.sum())
        out.append(b.tobytes().decode())
    return out


@pytest.mark.parametrize("k,bigcount", [(20, False), (32, True),
                                        (1, False)])
def test_row_counts_match_row_fns(k, bigcount):
    """K5 (plain) against _make_row_hashes_counts_fn and
    _make_row_counts_fn on one padded batch: every valid window's hash
    and count equal; the port's counts are 0 elsewhere."""
    rng = np.random.default_rng(k)
    sizes = tuple(khmer_tpu.primes.get_n_primes_near_x(4, 20011))
    table = rng.integers(0, 70000, sum(sizes) + 1).astype(np.uint32)
    table[rng.random(table.size) < 0.4] = 0
    lens = [0, 1, k - 1, k, k + 1, 64, 100, 150]
    L = _row_width(max(lens), k)
    data = rng.integers(0, 4, (len(lens), L), dtype=np.uint8)
    for i, n in enumerate(lens):
        data[i, n:] = 0
    lengths = np.asarray(lens, np.int32)

    spec = jsk.SketchSpec("byte", sizes, bigcount)
    jh, jc = _make_row_hashes_counts_fn(spec, k, "2bit")(
        jnp.asarray(table), jnp.asarray(data), jnp.asarray(lengths))
    jc2 = _make_row_counts_fn(spec, k, "2bit")(
        jnp.asarray(table), jnp.asarray(data), jnp.asarray(lengths))

    geom = SketchSpec("byte", sizes).geometry("cpu")
    counts, hashes = kernels.row_counts(
        torch.from_numpy(data), torch.from_numpy(lengths), k,
        torch.from_numpy(table.view(np.int32)), *geom,
        65535 if bigcount else 255, want_hashes=True)
    counts = counts.numpy()
    valid = np.arange(L - k + 1)[None, :] + k <= lengths[:, None]
    assert valid.sum() > 0
    assert np.array_equal(_u64.to_numpy(hashes)[valid],
                          np.asarray(jh)[valid])
    assert np.array_equal(counts[valid], np.asarray(jc)[valid])
    assert np.array_equal(counts[valid], np.asarray(jc2)[valid])
    assert not counts[~valid].any()


def test_median_at_least_matches_fn():
    """median_at_least_batch's reduction over K5 against
    _make_median_at_least_fn on one padded batch, at cutoffs 1, 2 and
    30 (rows with no valid window give False)."""
    rng = np.random.default_rng(3)
    sizes = tuple(khmer_tpu.primes.get_n_primes_near_x(4, 50021))
    table = rng.integers(0, 40, sum(sizes) + 1).astype(np.uint32)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in
            (0, 5, 19, 20, 21, 70, 100, 100, 150)]
    data, lengths = _pad_rows(seqs, K)
    fn = _make_median_at_least_fn(jsk.SketchSpec("byte", sizes), K, "2bit")
    p = Countgraph(K, 1, 1, primes=sizes, device="cpu")
    p.storage.table = torch.from_numpy(table.view(np.int32))
    for cutoff in (1, 2, 30):
        want = np.asarray(fn(jnp.asarray(table), jnp.asarray(data),
                             jnp.asarray(lengths), jnp.uint32(cutoff)))
        got = p.median_at_least_batch(seqs, cutoff)
        assert np.array_equal(got, want[:len(seqs)])


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Built once: khmer_tpu's and the port's Countgraph of 4 x SIZE
    bins over the same reads, both loading the port's saved .ct (with a
    bigcount map), and two query sets of equal shape: 16 reads, the
    repeated one and three short ones, and the same with 1% errors."""
    d = tmp_path_factory.mktemp("torch_rows")
    fa = str(d / "reads.fa")
    seqs = write_reads(fa, seed=7, n_reads=500, repeats=280)
    reads = [s.upper().replace("N", "A") for s in seqs[:16]] + [seqs[1]]
    short = ["ACGTACGTACGTACGTACG", reads[2][:K], reads[3][:K + 1]]
    queries = dict(reads=reads + short,
                   errors=_with_errors(reads, 0.01, seed=1) + short)
    j = khmer_tpu.Countgraph(K, SIZE, 4)
    j.consume_seqfile(fa)
    p = Countgraph(K, SIZE, 4, device="cpu")
    p.set_use_bigcount(True)
    p.consume_seqfile(fa)
    ct = str(d / "big.ct")
    p.save(ct)
    p.set_use_bigcount(False)
    built = {False: (j, p), True: (khmer_tpu.Countgraph.load(ct),
                                   Countgraph.load(ct, device="cpu"))}
    return lambda which, loaded: (built[loaded], queries[which])


CASES = [("reads", False), ("errors", False), ("reads", True)]


@pytest.mark.parametrize("which,loaded", CASES)
def test_row_queries_match(graphs, which, loaded):
    """count_rows, _hash_count_rows, median_at_least_batch and
    get_median_count_batch equal khmer_tpu's."""
    (j, p), q = graphs(which, loaded)
    for a, b in zip(p.count_rows(q), j.count_rows(q)):
        assert np.array_equal(a, np.asarray(b))
    for (ph, pc), (jh, jc) in zip(p._hash_count_rows(q),
                                  j._hash_count_rows(q)):
        assert np.array_equal(ph, np.asarray(jh))
        assert np.array_equal(pc, np.asarray(jc))
    for cutoff in (2, 5, 300):
        assert np.array_equal(p.median_at_least_batch(q, cutoff),
                              j.median_at_least_batch(q, cutoff))
    assert p.get_median_count_batch(q) == j.get_median_count_batch(q)
    if loaded:  # the repeated read passes 255; the row functions cap it
        assert max(p.count_rows([q[16]])[0]) == 255


@pytest.mark.parametrize("which,loaded", CASES)
def test_per_read_queries_match(graphs, which, loaded):
    """The per-read methods, which read through storage.get_batch and
    so overlay a loaded bigcount map, equal khmer_tpu's."""
    (j, p), q = graphs(which, loaded)
    for s in q:
        if len(s) < K:
            with pytest.raises(ValueError):
                p.median_at_least(s, 2)
            continue
        assert p.get_median_count(s) == j.get_median_count(s)
        assert p.get_min_count(s) == j.get_min_count(s)
        assert p.get_max_count(s) == j.get_max_count(s)
        for c in (2, 5):
            assert p.median_at_least(s, c) == j.median_at_least(s, c)
            assert p.trim_on_abundance(s, c) == j.trim_on_abundance(s, c)
            assert p.trim_below_abundance(s, c) == \
                j.trim_below_abundance(s, c)
            assert p.find_spectral_error_positions(s, c) == \
                j.find_spectral_error_positions(s, c)
    if loaded:
        assert p.get_max_count(q[16]) > 255

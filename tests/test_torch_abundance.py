"""Port parity of abundance_distribution with tracking Bloom false
positives present: khmer_tpu_torch against khmer_tpu on the same files.

The tracking Nodegraph has the main table's sizes (as the scripts make
it), and the tables are small against ~20k distinct k-mers, so a good
share of tracking reads are false positives.  khmer_tpu tests tracking
membership once per window of flush_slice() distinct keys in order of
first occurrence (ops/deferred.py:748-766), or, for a table loaded with
a bigcount map, once per CHUNK = 2**20 bases (hashtable.py:1725-1755);
where such a false positive falls across a boundary the result depends
on it, so the port must draw the same boundaries.  On a file with more
distinct k-mers than its ledger's budget, khmer_tpu also flushes the
ledger early as a segment (ops/deferred.py:708-721), and the windows
start again in each segment.  Integer data throughout: the tolerance is
exact equality."""

import numpy as np
import pytest
import torch

import khmer_tpu
from khmer_tpu.hashtable import _chunk_lane_count, _make_abund_flush_fn
from khmer_tpu.ops import deferred
from khmer_tpu.ops import sketch_ops as jsk
from khmer_tpu_torch import Countgraph, Nodegraph, _u64, hashtable, kernels
from khmer_tpu_torch.ops.sketch_ops import SketchSpec, alloc_table
from khmer_tpu_torch.storage import BitStorage

from .test_torch_countgraph import write_reads

K = 20
SIZES = (20011, 50021)
CHUNKS = (1 << 14, 1 << 16, 1 << 23)


def _jax_hist(j, fa, flush_log=None):
    """khmer_tpu's histogram and tracking n_unique; flush_log sets
    KHMER_TPU_FLUSH_LOG, which flush_slice() reads on every call."""
    with pytest.MonkeyPatch.context() as mp:
        if flush_log is not None:
            mp.setenv("KHMER_TPU_FLUSH_LOG", str(flush_log))
        track = khmer_tpu.Nodegraph(K, 1, 1, primes=j.hashsizes())
        hist = j.abundance_distribution(fa, track)
    return hist, track.n_unique_kmers()


def _tables(fa, ct, size, bigcount=False):
    """The port's table of fa, saved to ct and loaded by khmer_tpu (the
    two packages' .ct bytes are equal, tests/test_torch_countgraph.py),
    which saves khmer_tpu's consume here."""
    p = Countgraph(K, size, 4, device="cpu")
    p.set_use_bigcount(bigcount)
    p.consume_seqfile(fa)
    p.save(ct)
    return p, khmer_tpu.Countgraph.load(ct)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """One read set (4000 x 100 bp over a 20 kb genome, ~20k distinct
    k-mers); per table size the port's table and khmer_tpu's results,
    in one window (the default) and in windows of 2**14 distinct keys."""
    d = tmp_path_factory.mktemp("torch_abund")
    fa = str(d / "reads.fa")
    write_reads(fa, repeats=0)
    out = {}
    for size in SIZES:
        p, j = _tables(fa, str(d / "{}.ct".format(size)), size)
        out[size] = (p, {None: _jax_hist(j, fa), 14: _jax_hist(j, fa, 14)})
    return fa, out


def _port_hist(p, fa, **kwargs):
    track = Nodegraph(K, 1, 1, primes=p.hashsizes(), device="cpu")
    hist = p.abundance_distribution(fa, track, **kwargs)
    return hist, track.n_unique_kmers()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("size", SIZES)
def test_histogram_matches_in_one_window(ref, size, chunk):
    """Every distinct k-mer is tested against the empty tracking filter,
    whatever the port's chunk: the total is the exact distinct count."""
    fa, (p, jax) = ref[0], ref[1][size]
    got = _port_hist(p, fa, chunk=chunk)
    assert got == jax[None]
    assert sum(got[0]) == 19967


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("size", SIZES)
def test_histogram_matches_in_windows(ref, size, chunk):
    """Windows of 2**14 distinct keys: the second window's false
    positives against the first window's keys drop k-mers, the same
    ones in both packages."""
    fa, (p, jax) = ref[0], ref[1][size]
    got = _port_hist(p, fa, chunk=chunk, window=1 << 14)
    assert got == jax[14]
    assert sum(got[0]) < 19967


@pytest.mark.parametrize("bases", [1 << 14, 3 << 14, 1 << 20])
@pytest.mark.parametrize("k", [1, 17, 20, 32])
def test_lane_count_matches(k, bases):
    """The lanes that khmer_tpu's deferred counter books per chunk."""
    assert hashtable._lane_count(k, bases) == \
        _chunk_lane_count(k, "2bit", bases)


def _random_reads(seed=21, n_reads=2500, repeats=1450, readlen=100):
    """n_reads random reads (about 81 distinct k-mers each, ~2e5 in
    all), then `repeats` of them again in another order."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (n_reads, readlen), dtype=np.uint8)
    seqs = np.concatenate([seqs, seqs[rng.permutation(n_reads)[:repeats]]])
    return [s.tobytes().decode()
            for s in np.frombuffer(b"ACGT", np.uint8)[seqs]]


@pytest.mark.parametrize("source", ["file", "parser"])
def test_histogram_matches_across_ledger_overflows(tmp_path, monkeypatch,
                                                   source):
    """khmer_tpu at its smallest chunk (2**14 bases), append buffer
    (DEFER_CAP=1: two chunks' lanes, 2**16) and flush window (2**14):
    its ledger of 2**18 lanes overflows twice on ~2e5 distinct k-mers,
    so it flushes three segments.  The port, given the same settings,
    draws the same segments: equal histogram and tracking n_unique,
    through the native loader (a file) and _FlatBatcher (a list of
    reads, whose padded last chunk counts fewer lanes).  One segment
    with the same windows (the port's rule before the repair) gives
    another histogram."""
    seqs = _random_reads()
    fa = str(tmp_path / "reads.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))
    src = fa if source == "file" else seqs
    p, j = _tables(fa, str(tmp_path / "reads.ct"), SIZES[0])

    overflows = []
    ledger_overflow = deferred.DeferredCounter._ledger_overflow

    def counted(self):
        overflows.append(self.ledger_fill)
        return ledger_overflow(self)

    monkeypatch.setattr(deferred.DeferredCounter, "_ledger_overflow",
                        counted)
    monkeypatch.setenv("KHMER_TPU_CHUNK", "16384")
    monkeypatch.setenv("KHMER_TPU_DEFER_CAP", "1")
    monkeypatch.setenv("KHMER_TPU_FLUSH_LOG", "14")
    track = khmer_tpu.Nodegraph(K, 1, 1, primes=j.hashsizes())
    want = j.abundance_distribution(src, track), track.n_unique_kmers()
    assert len(overflows) == 2

    got = _port_hist(p, src, chunk=1 << 14, window=1 << 14, max_cap=1)
    assert got == want
    one_segment = _port_hist(p, src, chunk=1 << 14, window=1 << 14)
    assert one_segment[0] != want[0]


def test_overlay_path_matches(tmp_path):
    """A table loaded with a bigcount map: membership per 2**20 bases.
    The file (1.33 Mbases) ends with reads of a second genome, whose
    k-mers first occur in the second chunk and meet the first chunk's
    tracking false positives."""
    a, b, fa = (str(tmp_path / n) for n in ("a.fa", "b.fa", "reads.fa"))
    write_reads(a, n_reads=11000, repeats=300)
    write_reads(b, seed=6, n_reads=2000, repeats=0)
    with open(fa, "w") as out:
        for name in (a, b):
            with open(name) as f:
                out.write(f.read())
    ct = str(tmp_path / "reads.ct")
    _, j = _tables(fa, ct, 50021, bigcount=True)
    want = j.abundance_distribution(
        fa, khmer_tpu.Nodegraph(K, 1, 1, primes=j.hashsizes()))
    p = Countgraph.load(ct, device="cpu")
    assert p.storage.bigcounts
    hist = p.abundance_distribution(
        fa, Nodegraph(K, 1, 1, primes=p.hashsizes(), device="cpu"))
    assert hist == want
    assert sum(hist[256:]) == 81
    # the whole file as one membership window counts more k-mers
    p.storage.bigcounts = {}
    one = p.abundance_distribution(
        fa, Nodegraph(K, 1, 1, primes=p.hashsizes(), device="cpu"))
    assert sum(one) > sum(hist)


@pytest.mark.parametrize("bigcount,tables", [(False, 4), (True, 1),
                                             (True, 3)])
def test_fused_k4_matches_abund_flush_fn(bigcount, tables):
    """K4's plain version, then K2 on tracking weighted by its flags,
    against the body of khmer_tpu's _make_abund_flush_fn on the same
    numpy keys and tables: histogram, flags, tracking table and n_unique
    equal."""
    rng = np.random.default_rng(11 + tables)
    sizes = tuple(khmer_tpu.primes.get_n_primes_near_x(tables, 3001))
    keys = np.unique(np.concatenate([
        rng.integers(0, 2 ** 64, 3000, dtype=np.uint64),
        rng.integers(2 ** 63, 2 ** 64, 1000, dtype=np.uint64)]))
    rng.shuffle(keys)
    main = rng.integers(0, 70000, sum(sizes) + 1).astype(np.uint32)
    main[rng.random(main.size) < 0.3] = 0
    # a dense tracking filter: about half of the keys read as members
    track = (rng.random(sum(sizes) + 1) < 0.5 ** (1 / tables)).astype(
        np.uint32)

    import jax.numpy as jnp

    mspec = jsk.SketchSpec("byte", sizes, bigcount)
    tspec = jsk.SketchSpec("bit", sizes)
    jkeys = jnp.asarray(keys)
    want_new = np.asarray(jsk.sketch_get(tspec, jnp.asarray(track), jkeys)
                          == 0)
    t_table, t_uniq, dist = _make_abund_flush_fn(mspec, tspec)(
        jnp.asarray(track), jnp.zeros((), jnp.uint64), jkeys,
        jnp.asarray(main), jnp.zeros(65536, jnp.uint64))

    ts = BitStorage(sizes, device="cpu")
    ts.table = torch.from_numpy(track.view(np.int32).copy())
    spec = SketchSpec("byte", sizes)
    table = alloc_table(spec, "cpu")
    table.copy_(torch.from_numpy(main.view(np.int32)))
    hist = torch.zeros(65536, dtype=torch.int64)
    h = _u64.as_tensor(keys, "cpu")
    new = kernels.abund_hist(h, table, *spec.geometry("cpu"), ts.table,
                             *ts._geom, 65535 if bigcount else 255, hist)
    ts.add_lanes(h, new)
    np.testing.assert_array_equal(new.numpy() != 0, want_new)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(dist))
    np.testing.assert_array_equal(ts.table.numpy().view(np.uint32),
                                  np.asarray(t_table))
    assert ts.n_unique_kmers() == int(t_uniq)
    assert 0.3 < want_new.mean() < 0.7


def test_fused_k4_counts_run_starts_only():
    """Sorted keys with duplicates (the overlay path): only the first
    lane of a run is counted and flagged."""
    spec = SketchSpec("byte", (101, 103))
    table = alloc_table(spec, "cpu") + 7
    track = alloc_table(spec, "cpu")
    keys = torch.tensor([3, 3, 3, 8, 9, 9, -5, -5], dtype=torch.int64)
    hist = torch.zeros(65536, dtype=torch.int64)
    new = kernels.abund_hist(keys, table, *spec.geometry("cpu"), track,
                             *spec.geometry("cpu"), 255, hist)
    assert new.tolist() == [1, 0, 0, 1, 1, 0, 1, 0]
    assert int(hist[7]) == 4 and int(hist.sum()) == 4

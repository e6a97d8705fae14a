"""Port parity of the banded and masked consume: khmer_tpu_torch against
khmer_tpu on the same generated reads.

consume_seqfile_banding, consume_seqfile_with_mask and
consume_seqfile_banding_with_mask on a Countgraph (2-bit hash, k = 20),
a Counttable (murmur) and a CyclicCounttable, with masks that are a
Nodegraph, a Nodetable, a Countgraph (bigcount off and on) and a
SmallCountgraph, thresholds 0, 1 and at the mask's cap, and
consume_masked both ways: the same bins, n_unique and (n_reads,
consumed), and with bigcount on the same saved bytes (a filtered lane is
no bigcount candidate).  The port reads a file name through its native
loader and adds each chunk through kernel K12 (plain version here) and
K2; khmer_tpu through its Python reader and deferred counter.  The band
tables add up to the full table bin for bin; 2-bit hashes at k = 20 lie
in band 0; the error texts; K12's plain version on crafted hashes at the
band edges.  All tables are 4 x 20011 bins.  Integer data: exact
equality."""

import numpy as np
import pytest
import torch

import khmer_tpu
import khmer_tpu_torch
from khmer_tpu_torch import _u64
from khmer_tpu_torch.kernels import plain
from khmer_tpu_torch.ops.hashing import compute_band_interval
from khmer_tpu_torch.ops.sketch_ops import SketchSpec

K = 20
SIZE = 20011
N_TABLES = 4
# a read with N (cleaned to A) and one shorter than k
ODD = ["ACGTNACGTTTGCAGGCATTAGCANNGATTACAGGATTACAGATTACAGGCAT", "ACGTA"]
# a read that the file repeats 300 times: counts past 255 (bigcount)
REPEATS = 300


def _genome_reads(seed, n, genome_len=4000, readlen=100):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    starts = rng.integers(0, genome_len - readlen, n)
    return [genome[s:s + readlen] for s in starts]


def _write(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))
    return str(path)


def _bins(table):
    t = table.storage.table
    if isinstance(t, torch.Tensor):
        return t.numpy().view(np.uint32)
    return np.asarray(t).astype(np.uint32)


def _pair(name):
    """(khmer_tpu class, port class) of a table type."""
    return getattr(khmer_tpu, name), getattr(khmer_tpu_torch, name)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """reads.fa (160 reads over a 4 kbase genome, the two odd reads and one
    read 300 times) and mask.fa (the first 60 reads and the same read 300
    times: mask counts at every cap), and the masks built from mask.fa on
    both sides."""
    d = tmp_path_factory.mktemp("torch_band_mask")
    reads = _genome_reads(7, 160)
    out = {"reads": _write(d / "reads.fa", reads + ODD
                           + [reads[3]] * REPEATS),
           "mask": _write(d / "mask.fa", reads[:60] + [reads[3]] * REPEATS),
           "dir": d}
    masks = {}
    for name in ("Nodegraph", "Nodetable", "Countgraph", "SmallCountgraph"):
        jc, pc = _pair(name)
        j, p = jc(K, SIZE, N_TABLES), pc(K, SIZE, N_TABLES, device="cpu")
        for t in (j, p):
            t.consume_seqfile(out["mask"])
        masks[name] = (j, p)
    out["masks"] = masks
    return out


def _both(files, table, method, *args, mask=None, bigcount=False, **kw):
    """Run one filtered consume on both sides; check bins, n_unique and
    the returned (n_reads, consumed) equal.  Returns the two tables and
    the port's result."""
    jc, pc = _pair(table)
    j, p = jc(K, SIZE, N_TABLES), pc(K, SIZE, N_TABLES, device="cpu")
    if bigcount:
        j.set_use_bigcount(True)
        p.set_use_bigcount(True)
    extra = () if mask is None else (files["masks"][mask],)
    got = []
    for side, t in enumerate((j, p)):
        m = tuple(x[side] for x in extra)
        got.append(getattr(t, method)(files["reads"], *args, *m, **kw))
    assert got[0] == got[1]
    assert np.array_equal(_bins(j), _bins(p))
    assert j.n_unique_kmers() == p.n_unique_kmers()
    return j, p, got[1]


@pytest.mark.parametrize("table", ["Countgraph", "Counttable",
                                   "CyclicCounttable"])
def test_band_union_is_the_full_table(files, table):
    """Each band of 4 against khmer_tpu; the four tables sum to the full
    table bin for bin and the consumed counts to its n_consumed; the
    n_unique counts add up to at least its n_unique (a k-mer whose bins
    all hold k-mers of other bands is new in its band table only)."""
    _, full = _pair(table)
    full = full(K, SIZE, N_TABLES, device="cpu")
    n_reads, n_consumed = full.consume_seqfile(files["reads"])
    total = np.zeros(_bins(full).size, np.uint64)
    consumed = n_unique = 0
    for band in range(4):
        _, p, (nr, c) = _both(files, table, "consume_seqfile_banding", 4,
                              band)
        assert nr == n_reads
        total += _bins(p)
        consumed += c
        n_unique += p.n_unique_kmers()
    assert np.array_equal(total, _bins(full).astype(np.uint64))
    assert consumed == n_consumed
    assert 0 <= n_unique - full.n_unique_kmers() <= 4


def test_two_bit_hashes_lie_in_band_zero(files):
    """At k = 20 a 2-bit hash is < 4**20, below the first band edge for
    any num_bands <= 2**24: band 0 is the full table, the others empty;
    with 2**26 bands the hashes spread over the low bands."""
    full = khmer_tpu_torch.Countgraph(K, SIZE, N_TABLES, device="cpu")
    n_reads, n_consumed = full.consume_seqfile(files["reads"])
    _, p, got = _both(files, "Countgraph", "consume_seqfile_banding", 2 ** 24,
                      0)
    assert got == (n_reads, n_consumed)
    assert np.array_equal(_bins(p), _bins(full))
    assert _both(files, "Countgraph", "consume_seqfile_banding", 2,
                 1)[2] == (n_reads, 0)
    band = 2 ** 26
    c = [_both(files, "Countgraph", "consume_seqfile_banding", band,
               b)[2][1] for b in (1, 2)]
    assert 0 < c[0] < n_consumed and 0 < c[1] < n_consumed


@pytest.mark.parametrize("table,mask,threshold,consume_masked", [
    ("Countgraph", "Nodegraph", 0, False),
    ("Countgraph", "Nodegraph", 1, True),
    ("Countgraph", "Nodegraph", 1, False),     # at the cap: all pass
    ("Countgraph", "Countgraph", 1, False),
    ("Countgraph", "Countgraph", 255, True),   # at the cap
    ("Countgraph", "SmallCountgraph", 15, True),
    ("Counttable", "Nodegraph", 0, False),     # murmur hashes, 2-bit mask
    ("CyclicCounttable", "Nodetable", 1, True),
])
def test_masked_consume(files, table, mask, threshold, consume_masked):
    _, _, (_, consumed) = _both(files, table, "consume_seqfile_with_mask",
                                mask=mask, threshold=threshold,
                                consume_masked=consume_masked)
    assert consumed > 0


def test_masked_and_unmasked_add_up(files):
    """threshold 0 keeps the k-mers absent from the mask, threshold 1 with
    consume_masked those present: together the full table and count."""
    full = khmer_tpu_torch.Countgraph(K, SIZE, N_TABLES, device="cpu")
    n_consumed = full.consume_seqfile(files["reads"])[1]
    parts = [_both(files, "Countgraph", "consume_seqfile_with_mask",
                   mask="Nodegraph", threshold=t, consume_masked=cm)
             for t, cm in ((0, False), (1, True))]
    assert sum(p[2][1] for p in parts) == n_consumed
    total = sum(_bins(p[1]).astype(np.uint64) for p in parts)
    assert np.array_equal(total, _bins(full).astype(np.uint64))


@pytest.mark.parametrize("threshold,consume_masked", [(0, False),
                                                      (1, True)])
def test_banded_and_masked(files, threshold, consume_masked):
    """Band 3 of 4 (hashes >= 2**63 * 3 / 2) of a Counttable with a
    Nodetable mask."""
    _both(files, "Counttable", "consume_seqfile_banding_with_mask", 4, 3,
          mask="Nodetable", threshold=threshold,
          consume_masked=consume_masked)


@pytest.mark.parametrize("mask,threshold", [("Countgraph", 0),
                                            ("Nodegraph", 1)])
def test_filtered_lanes_are_no_bigcount_candidates(files, mask, threshold):
    """Bigcount on: the read repeated 300 times lies in mask.fa, so
    threshold 0 drops its k-mers (no bigcount section) and threshold 1
    with consume_masked keeps them (counts of 300 in the section); the
    saved bytes equal khmer_tpu's."""
    j, p, _ = _both(files, "Countgraph", "consume_seqfile_with_mask",
                    mask=mask, threshold=threshold,
                    consume_masked=threshold == 1, bigcount=True)
    d = files["dir"]
    j.save(str(d / "j.ct"))
    p.save(str(d / "p.ct"))
    with open(d / "j.ct", "rb") as f, open(d / "p.ct", "rb") as g:
        assert f.read() == g.read()
    probe = p.get_kmers(_genome_reads(7, 160)[3])[0]
    assert (p.get(probe) > 255) == (threshold == 1)


def test_parser_input(files):
    """A parser goes through the Python batcher, chunk by chunk."""
    parsers = (khmer_tpu.FastxParser(files["reads"]),
               khmer_tpu_torch.FastxParser(files["reads"]))
    j = khmer_tpu.Counttable(K, SIZE, N_TABLES)
    p = khmer_tpu_torch.Counttable(K, SIZE, N_TABLES, device="cpu")
    got = [j.consume_seqfile_banding(parsers[0], 2, 1),
           p.consume_seqfile_banding(parsers[1], 2, 1, chunk=1 << 14)]
    assert got[0] == got[1]
    assert np.array_equal(_bins(j), _bins(p))
    assert j.n_unique_kmers() == p.n_unique_kmers()


@pytest.mark.parametrize("name", ["Countgraph", "Counttable"])
def test_errors(files, name):
    """khmer_tpu's exception types and texts (tests/test_banding.py)."""
    jc, pc = _pair(name)
    tables = jc(31, 1e5, 4), pc(31, 1e5, 4, device="cpu")
    texts = []
    for t in tables:
        with pytest.raises(ValueError) as ve:
            t.consume_seqfile_banding(files["reads"], 8, 13)
        texts.append(str(ve.value))
        with pytest.raises(OSError) as ose:
            t.consume_seqfile_banding("file-no-exist.fa", 16, 3)
        assert "No such file or directory" in str(ose.value)
    assert texts[0] == texts[1]
    assert "'band' must be in the interval [0, 'num_bands')" in texts[1]


@pytest.mark.parametrize("num_bands,band", [(4, 0), (4, 3), (2, 0), (2, 1),
                                            (3, 2), (1, 0)])
def test_k12_plain_edges(num_bands, band):
    """K12's plain version on hashes 0, 2**63 - 1, 2**63, the band's edges
    and 2**64 - 1, with weights 0, 1 and 2**32 - 1 (the total is a sum of
    uint32), against Python integers; then a mask on top."""
    lo, hi = compute_band_interval(num_bands, band)
    assert (lo, hi) == khmer_tpu.ops.hashing.compute_band_interval(
        num_bands, band)
    hs = [0, 1, 2 ** 63 - 1, 2 ** 63, lo, lo + 1, hi - 1, hi, 2 ** 64 - 1]
    hs = [h for h in hs if 0 <= h < 2 ** 64]
    ws = [(i * 7 + 1) % 3 for i in range(len(hs))]
    ws = [[0, 1, 2 ** 32 - 1][w] for w in ws]
    hashes = _u64.as_tensor(np.array(hs, np.uint64), "cpu")
    weights = torch.from_numpy(np.array(ws, np.uint32).view(np.int32))
    total = torch.full((1,), 5, dtype=torch.int64)
    out = plain.band_mask_weights(hashes, weights, total, band=(lo, hi))
    want = [w if lo <= h < hi else 0 for h, w in zip(hs, ws)]
    assert out.numpy().view(np.uint32).tolist() == want
    assert int(total) == 5 + sum(want)
    # a one-table mask holding count c at bin h % p: h passes iff c <= 1
    spec = SketchSpec("byte", (7,))
    table = torch.arange(8, dtype=torch.int32)
    out = plain.band_mask_weights(hashes, weights, total, (lo, hi), table,
                                  *spec.geometry("cpu"), cap=255,
                                  threshold=1)
    want2 = [w if h % 7 <= 1 else 0 for h, w in zip(hs, want)]
    assert out.numpy().view(np.uint32).tolist() == want2
    assert int(total) == 5 + sum(want) + sum(want2)

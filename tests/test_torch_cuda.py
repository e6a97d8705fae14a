"""Each CUDA kernel of khmer_tpu_torch against its plain PyTorch version
on the card, at small sizes and edge cases that chip_smoke.py does not
reach (empty and ragged inputs, one table and 32, weights >= 2**31,
hashes >= 2**63, a candidate buffer that overflows, a hot partition,
bins beside partition and table boundaries, all lanes masked, unsorted
and duplicate scatter bins, inputs that are unaligned views, khmer_tpu's
ledger overflows).  Integer data: exact
equality.  Marked `cuda`: they skip without a CUDA device and run on
the card with `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (the suite's conftest imports jax, which the
port does not need, and this module imports nothing of it)."""

import numpy as np
import pytest
import torch

from khmer_tpu_torch import Countgraph, Nodegraph, _u64, hashtable, kernels
from khmer_tpu_torch.kernels import plain
from khmer_tpu_torch.ops.sketch_ops import SketchSpec, unpack_oxli_bytes
from khmer_tpu_torch.primes import get_n_primes_near_x
from khmer_tpu_torch.storage import ByteStorage

pytestmark = pytest.mark.cuda

SIZES = (1009, 1013, 1019)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _write_reads(path, seed, n_reads=2000, genome_len=20000, readlen=100,
                 repeats=280):
    """Random-genome reads plus one read repeated (counts past 255)."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), genome_len)
    starts = rng.integers(0, genome_len - readlen, n_reads)
    seqs = [genome[s:s + readlen].tobytes().decode() for s in starts]
    seqs += [seqs[1]] * repeats
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))


def _hashes(rng, n, distinct):
    pool = rng.integers(0, 2 ** 64, distinct, dtype=np.uint64)
    pool[0] = 2 ** 64 - 1
    return pool[rng.integers(0, distinct, n)]


def _table(rng, sizes, high):
    t = rng.integers(0, high, sum(sizes) + 1, dtype=np.uint64)
    t[rng.random(t.size) < 0.5] = 0
    return torch.from_numpy(t.astype(np.uint32).view(np.int32))


K1_TILE = 1024  # window starts per block of csrc/hash2bit.cu


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 19, 20, 257, K1_TILE - 1,
                               K1_TILE, K1_TILE + 1, 5000, (1 << 20) + 3])
@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 20, 31, 32])
def test_hash2bit_canonical(dev, n, k, offset):
    """Every lane, masked or not, the tail lanes whose windows run past
    the end included; a word's 16 codes and a tile's edges at n +- 1; the
    inputs as views `offset` bytes into their buffers (offset 5: no
    16-byte loads)."""
    rng = np.random.default_rng(n * 100 + k)
    codes = torch.from_numpy(rng.integers(0, 4, n + offset, dtype=np.uint8))
    mask = torch.from_numpy((rng.random(n + offset) < 0.8).astype(np.uint8))
    h, w = kernels.hash2bit_canonical(codes.to(dev)[offset:],
                                      mask.to(dev)[offset:], k)
    ph, pw = plain.hash2bit_canonical(codes[offset:], mask[offset:], k)
    assert torch.equal(h.cpu(), ph) and torch.equal(w.cpu(), pw)


def _k2_both(dev, sizes, table, hashes, weights, cap, plain_dev="cpu"):
    """K2 on the card and its plain version on plain_dev from the same
    inputs: [table, n_unique, is_new, cand_count, sorted candidates (None
    when they overflowed cap)] for each side."""
    spec = SketchSpec("byte", sizes)
    out = {}
    for side, d in (("kernel", dev), ("plain", torch.device(plain_dev))):
        t = table.clone().to(d)
        nu = torch.zeros(1, dtype=torch.int64, device=d)
        cand = torch.zeros(cap, dtype=torch.int64, device=d)
        cnt = torch.zeros(1, dtype=torch.int32, device=d)
        fn = kernels.sketch_update if side == "kernel" else \
            plain.sketch_update
        is_new = fn(t, hashes.to(d), weights.to(d), *spec.geometry(d), nu,
                    cand, cnt)
        c = int(cnt)
        out[side] = [x.cpu() for x in (t, nu, is_new, cnt)]
        out[side].append(
            torch.sort(cand[:c]).values.cpu() if c <= cap else None)
    for a, b in zip(out["kernel"], out["plain"]):
        assert (a is None and b is None) or torch.equal(a, b)
    return out["kernel"]


@pytest.mark.parametrize("sizes", [SIZES[:1], SIZES])
@pytest.mark.parametrize("cap", [16, 1 << 16])
def test_sketch_update(dev, sizes, cap):
    rng = np.random.default_rng(len(sizes) + cap)
    table = _table(rng, sizes, 300)
    hashes = _u64.as_tensor(_hashes(rng, 3001, 700), "cpu")
    weights = torch.from_numpy(
        rng.choice(np.array([0, 1, 2, 2 ** 31 + 5], np.uint32), 3001,
                   p=[0.2, 0.6, 0.19, 0.01]).view(np.int32))
    got = _k2_both(dev, sizes, table, hashes, weights, cap)
    assert int(got[3]) > 0


def test_sketch_update_hot_partition(dev):
    """One hash on 2**22 lanes amid random ones: its partition in every
    table is split across blocks and combined through global atomics."""
    rng = np.random.default_rng(12)
    sizes = (1000003, 999983, 999979)
    n_hot, n_rand = 1 << 22, 1 << 18
    hashes = np.concatenate([np.full(n_hot, 0x9E3779B97F4A7C15, np.uint64),
                             _hashes(rng, n_rand, 50000)])
    hashes = hashes[rng.permutation(hashes.size)]
    weights = (rng.random(hashes.size) < 0.95).astype(np.int32)
    got = _k2_both(dev, sizes, _table(rng, sizes, 3),
                   _u64.as_tensor(hashes, "cpu"), torch.from_numpy(weights),
                   1 << 16, plain_dev=dev)
    assert int(got[3]) > n_hot // 2 and got[4] is None


def test_sketch_update_boundaries(dev):
    """Bins on both sides of partition boundaries (multiples of 2048) and
    of table offsets that are not multiples of it."""
    rng = np.random.default_rng(13)
    sizes = (12289, 8209, 16411)
    picks = np.array([8191, 8192, 8193, 12288, 0, 1, 16383, 16384, 4095,
                      4096, 8208, 20497, 2047, 2048, 2049], np.uint64)
    hashes = np.concatenate([picks, picks + np.uint64(12289 * 8209 * 16411),
                             _hashes(rng, 4000, 900)])
    hashes = np.concatenate([hashes, hashes[::-1]])
    weights = rng.integers(1, 3, hashes.size).astype(np.int32)
    table = _table(rng, sizes, 2)
    got = _k2_both(dev, sizes, table, _u64.as_tensor(hashes, "cpu"),
                   torch.from_numpy(weights), 1 << 16)
    assert int(got[1]) > 0


def test_sketch_update_sparse_batch(dev):
    """A few thousand lanes over 4 x ~5e6 bins: a tile of records spans
    more partitions than a tile ranks in shared memory, and the rest take
    their own global atomics."""
    rng = np.random.default_rng(19)
    sizes = tuple(get_n_primes_near_x(4, 5e6))
    hashes = _u64.as_tensor(_hashes(rng, 3000, 2000), "cpu")
    weights = torch.from_numpy(rng.integers(0, 3, 3000).astype(np.int32))
    table = torch.zeros(sum(sizes) + 1, dtype=torch.int32)
    got = _k2_both(dev, sizes, table, hashes, weights, 1 << 16)
    assert int(got[1]) > 0


def test_sketch_update_all_masked(dev):
    rng = np.random.default_rng(14)
    table = _table(rng, SIZES, 300)
    hashes = _u64.as_tensor(_hashes(rng, 5000, 800), "cpu")
    got = _k2_both(dev, SIZES, table, hashes,
                   torch.zeros(5000, dtype=torch.int32), 1 << 16)
    assert torch.equal(got[0], table) and int(got[1]) == 0
    assert not bool(got[2].any()) and int(got[3]) == 0


@pytest.mark.parametrize("T", [1, 32])
def test_sketch_update_table_counts(dev, T):
    rng = np.random.default_rng(15 + T)
    sizes = tuple(get_n_primes_near_x(T, 3000))
    hashes = _u64.as_tensor(_hashes(rng, 20000, 2500), "cpu")
    weights = torch.from_numpy(rng.integers(0, 3, 20000).astype(np.int32))
    got = _k2_both(dev, sizes, _table(rng, sizes, 300), hashes, weights,
                   1 << 16)
    assert int(got[1]) > 0 and int(got[3]) > 0


def test_sketch_update_candidate_overflow(dev):
    """More than 2**16 lanes cross 255: the count says so on both sides."""
    rng = np.random.default_rng(16)
    sizes = (70001, 69997)
    hashes = np.unique(rng.integers(0, 2 ** 64, 70000, dtype=np.uint64))
    table = torch.full((sum(sizes) + 1,), 300, dtype=torch.int32)
    got = _k2_both(dev, sizes, table, _u64.as_tensor(hashes, "cpu"),
                   torch.ones(hashes.size, dtype=torch.int32), 1 << 16)
    assert int(got[3]) == hashes.size and got[4] is None


def test_barrett_bins_on_card(dev):
    """K2, K3 and K4 against their plain versions on the same hashes, for
    the bench primes (4 x ~1e8 bins) and for table sizes 1, 2 and 3."""
    rng = np.random.default_rng(17)
    hashes = np.concatenate([
        rng.integers(0, 2 ** 64, 1 << 16, dtype=np.uint64),
        rng.integers(2 ** 63, 2 ** 64, 1 << 16, dtype=np.uint64),
        np.array([0, 1, 2, 3, 2 ** 64 - 1, 2 ** 63], np.uint64)])
    for sizes in (tuple(get_n_primes_near_x(4, 1e8)), (1, 2, 3)):
        spec = SketchSpec("byte", sizes)
        geom = spec.geometry(dev)
        table = torch.zeros(spec.total_bins + 1, dtype=torch.int32,
                            device=dev)
        h = _u64.as_tensor(hashes, dev)
        w = torch.ones(h.numel(), dtype=torch.int32, device=dev)
        nu = torch.zeros(1, dtype=torch.int64, device=dev)
        tp, nup = table.clone(), nu.clone()
        assert torch.equal(kernels.sketch_update(table, h, w, *geom, nu),
                           plain.sketch_update(tp, h, w, *geom, nup))
        assert torch.equal(table, tp) and torch.equal(nu, nup)
        assert torch.equal(kernels.sketch_get(table, h, *geom, 65535),
                           plain.sketch_get(tp, h, *geom, 65535))
        keys = torch.sort(h).values
        hk = torch.zeros(65536, dtype=torch.int64, device=dev)
        hp = torch.zeros_like(hk)
        track = torch.zeros_like(table)
        assert torch.equal(
            kernels.abund_hist(keys, table, *geom, track, *geom, 65535, hk),
            plain.abund_hist(keys, tp, *geom, track, *geom, 65535, hp))
        assert torch.equal(hk, hp)


@pytest.mark.parametrize("n,offset", [(3, 0), (777, 1), (16386, 0),
                                      (16386, 1)])
@pytest.mark.parametrize("cap", [1, 15, 255, 65535])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 32])
def test_sketch_get(dev, T, cap, n, offset):
    """T = 1-4 (the unrolled gather) and 5, 32 (the loop); n not a
    multiple of a thread's four keys; the hashes as a view one lane into
    their buffer (offset 1: no 16-byte loads)."""
    rng = np.random.default_rng(T * 1000 + cap + n)
    sizes = _primes(T)
    table = _table(rng, sizes, 2 ** 32)
    hashes = _u64.as_tensor(_hashes(rng, n + offset, 500), "cpu")
    geom = SketchSpec("byte", sizes).geometry("cpu")
    got = kernels.sketch_get(table.to(dev), hashes.to(dev)[offset:],
                             *[g.to(dev) for g in geom], cap)
    assert torch.equal(got.cpu(), plain.sketch_get(table, hashes[offset:],
                                                   *geom, cap))


def _track(rng, sizes, density):
    """A tracking table whose bins are set with the given probability."""
    t = (rng.random(sum(sizes) + 1) < density).astype(np.uint32)
    return torch.from_numpy(t.view(np.int32))


def _k4_both(dev, keys, msizes, main, tsizes, track, cap):
    """K4 on the card and its plain version on the CPU from the same
    inputs; asserts equal histograms and flags, returns the plain ones."""
    out = []
    for d in (dev, torch.device("cpu")):
        hist = torch.zeros(65536, dtype=torch.int64, device=d)
        before = kernels.LAUNCHES["abund_hist"]
        new = kernels.abund_hist(
            keys.to(d), main.to(d), *SketchSpec("byte", msizes).geometry(d),
            track.to(d), *SketchSpec("bit", tsizes).geometry(d), cap, hist)
        if d.type == "cuda":
            assert kernels.LAUNCHES["abund_hist"] == before + (
                1 if keys.numel() else 0)
        out.append((hist.cpu(), new.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    return out[1]


def _primes(T):
    return tuple(get_n_primes_near_x(T, 1009))


def _distinct(rng, n):
    keys = np.unique(rng.integers(0, 2 ** 64, n, dtype=np.uint64))
    rng.shuffle(keys)
    return _u64.as_tensor(keys, "cpu")


# name -> (main tables, tracking tables, cap, tracking density); the main
# bins are random in [0, 400) with half of them 0 unless test_abund_hist
# says otherwise
K4_CASES = {
    "sorted-duplicates": (SIZES, SIZES, 255, 0.0),
    "all-counts-zero": (_primes(4), _primes(4), 65535, 0.0),
    "shared-range-edge": (_primes(4), _primes(4), 65535, 0.0),
    "cap-1": (_primes(4), _primes(4), 1, 0.5),
    "cap-15": (_primes(4), _primes(4), 15, 0.5),
    "cap-255": (_primes(4), _primes(4), 255, 0.5),
    "cap-65535": (_primes(4), _primes(4), 65535, 0.5),
    "one-table": (_primes(1), _primes(1), 65535, 0.5),
    "three-tables": (_primes(3), _primes(4), 255, 0.8),
    "four-tables": (_primes(4), _primes(3), 255, 0.8),
    "32-tables": (_primes(32), _primes(32), 65535, 0.98),
    "empty": (_primes(4), _primes(4), 255, 0.5),
    "dense-tracking": (_primes(4), _primes(4), 65535, 0.85),
}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_abund_hist(dev, case):
    """K4 against its plain version: one hot histogram bin (every count
    0), counts at and above the shared sub-histogram's 4096 bins, caps
    255, 65535 and 1, T = 1, 3, 4 and 32, empty keys, sorted keys with
    duplicates (the overlay path) and a tracking filter dense enough for
    false positives (about half the keys members)."""
    msizes, tsizes, cap, density = K4_CASES[case]
    rng = np.random.default_rng(len(case))
    main = _table(rng, msizes, 400)
    keys = _distinct(rng, 50000)
    if case == "sorted-duplicates":
        keys = torch.sort(_u64.as_tensor(_hashes(rng, 4000, 900),
                                         "cpu")).values
    elif case == "all-counts-zero":
        main.zero_()
        keys = _distinct(rng, 1 << 20)
    elif case == "shared-range-edge":
        main = torch.from_numpy(rng.integers(
            4090, 4102, main.numel()).astype(np.int32))
        main[:main.numel() // 3] = 70000
    elif case.startswith("cap-"):
        # low counts and counts past 65535 (where the four bins all are)
        main = torch.from_numpy(np.where(
            rng.random(main.numel()) < 0.5,
            rng.integers(0, 300, main.numel()),
            rng.integers(60000, 70000, main.numel())).astype(np.int32))
    elif case == "32-tables":
        main = torch.from_numpy(rng.integers(
            1, 400, main.numel()).astype(np.int32))
    elif case == "empty":
        keys = keys[:0]
    hist, new = _k4_both(dev, keys, msizes, main, tsizes,
                         _track(rng, tsizes, density), cap)
    n_new = int(new.sum())
    assert int(hist.sum()) == n_new
    if case == "all-counts-zero":
        assert int(hist[0]) == keys.numel()
    elif case == "shared-range-edge":
        assert int(hist[:4096].sum()) > 0 and int(hist[4096:].sum()) > 0
    elif case == "dense-tracking":
        assert 0.3 < n_new / keys.numel() < 0.7
    elif case == "sorted-duplicates":
        assert n_new == torch.unique(keys).numel() and int(hist[0]) > 0
    elif case == "empty":
        assert new.numel() == 0


def test_bin_scatter_add_any_bins(dev):
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 1000, 5000))
    vals = torch.from_numpy(rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    tk = torch.zeros(1000, dtype=torch.int32, device=dev)
    tp = torch.zeros(1000, dtype=torch.int32)
    kernels.bin_scatter_add(tk, idx.to(dev), vals.to(dev))
    plain.bin_scatter_add(tp, idx, vals)
    assert torch.equal(tk.cpu(), tp)
    with pytest.raises(IndexError):
        kernels.bin_scatter_add(tk, torch.tensor([-1], device=dev),
                                torch.ones(1, dtype=torch.int32,
                                           device=dev))


@pytest.mark.parametrize("order", ["sorted", "unsorted", "sorted-dups",
                                   "hot"])
def test_bin_scatter_add_orders(dev, order):
    """Sorted unique bins (the .ct load), the same shuffled, sorted bins
    with duplicates, and one bin repeated past a block's share."""
    rng = np.random.default_rng(18)
    B = 300007
    if order == "hot":
        idx = np.concatenate([np.full(70000, 123457),
                              rng.integers(0, B, 20000)])
    elif order == "sorted-dups":
        idx = rng.integers(0, B, 50000)
    else:  # unique bins, shuffled
        idx = rng.choice(B, 50000, replace=False)
    if order != "unsorted":
        idx = np.sort(idx)
    idx = torch.from_numpy(idx.astype(np.int64))
    vals = torch.from_numpy(rng.integers(1, 5, idx.numel()).astype(np.int32))
    base = _table(rng, (B - 1,), 2 ** 32)
    tk, tp = base.to(dev), base.clone()
    before = kernels.LAUNCHES["bin_scatter_add"]
    kernels.bin_scatter_add(tk, idx.to(dev), vals.to(dev))
    assert kernels.LAUNCHES["bin_scatter_add"] == \
        before + kernels.KERNELS_PER_CALL["bin_scatter_add"]
    plain.bin_scatter_add(tp, idx, vals)
    assert torch.equal(tk.cpu(), tp)


@pytest.mark.parametrize("bad", [-5, 300007])
def test_bin_scatter_add_out_of_range(dev, bad):
    """A bin outside the table raises after the launch; the lanes inside
    it have been added."""
    idx = torch.tensor([3, 7, bad, 9], device=dev)
    vals = torch.ones(4, dtype=torch.int32, device=dev)
    table = torch.zeros(300007, dtype=torch.int32, device=dev)
    with pytest.raises(IndexError):
        kernels.bin_scatter_add(table, idx, vals)
    assert int(table.sum()) == 3


@pytest.mark.parametrize("kind", ["byte", "nibble", "bit"])
def test_unpack_oxli_bytes_on_card(dev, kind):
    """The .ct load's widening on the card equals the CPU's."""
    rng = np.random.default_rng(8)
    spec = SketchSpec(kind, SIZES)
    data = rng.integers(0, 256, spec.total_bytes, dtype=np.uint8)
    data[rng.random(data.size) < 0.7] = 0
    before = kernels.LAUNCHES["bin_scatter_add"]
    got = unpack_oxli_bytes(spec, data, dev)
    assert kernels.LAUNCHES["bin_scatter_add"] == \
        before + kernels.KERNELS_PER_CALL["bin_scatter_add"]
    assert torch.equal(got.cpu(), unpack_oxli_bytes(spec, data, "cpu"))


def test_bigcount_overflow_recovery_on_card(dev):
    """More crossing lanes than the candidate buffer: the exact recovery
    gives the same candidate set on the card as on the CPU."""
    rng = np.random.default_rng(6)
    hashes = np.unique(rng.integers(0, 2 ** 64, 70000, dtype=np.uint64))
    sets = []
    for d in (dev, "cpu"):
        st = ByteStorage((70001,), use_bigcount=True, device=d)
        st.table.fill_(300)
        st.add_batch(hashes)
        sets.append(st.bigcount_candidates)
    assert sets[0] == sets[1] and len(sets[0]) == hashes.size


def test_main_path_small_on_card(dev, tmp_path):
    """consume, save and abundance_distribution on the card equal the
    CPU run, bigcounts included."""
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, seed=7)
    out = []
    for d in (dev, "cpu"):
        cg = Countgraph(20, 100003, 4, device=d)
        cg.set_use_bigcount(True)
        n = cg.consume_seqfile(fa, chunk=7919)
        ct = str(tmp_path / "{}.ct".format(torch.device(d).type))
        cg.save(ct)
        hist = cg.abundance_distribution(
            fa, Nodegraph(20, 1, 1, primes=cg.hashsizes(), device=d))
        with open(ct, "rb") as f:
            out.append((n, cg.n_unique_kmers(), f.read(), hist))
    assert out[0] == out[1]
    assert sum(out[0][3][256:]) > 0


@pytest.mark.parametrize("path", ["windows", "overflow", "overlay"])
def test_abundance_paths_on_card(dev, tmp_path, monkeypatch, path):
    """abundance_distribution on the card equals the CPU run in windows
    of 2**12 distinct keys; with khmer_tpu's smallest chunk and append
    buffer, where its ledger overflows (2**14-base chunks, a 2**18-lane
    ledger); and on a table loaded with a bigcount map (tracking
    membership per 2**20 bases of a 1.1 Mbase file)."""
    overflows = []
    schedule_overflows = hashtable._DeferSchedule.overflows

    def counted(self, n, bucket):
        over = schedule_overflows(self, n, bucket)
        overflows.append(over)
        return over

    monkeypatch.setattr(hashtable._DeferSchedule, "overflows", counted)
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, seed=8, n_reads=11000)
    ct = str(tmp_path / "reads.ct")
    if path == "overlay":
        cg = Countgraph(20, 50021, 4, device="cpu")
        cg.set_use_bigcount(True)
        cg.consume_seqfile(fa)
        cg.save(ct)
    out = []
    for d in (dev, "cpu"):
        if path == "overlay":
            cg = Countgraph.load(ct, device=d)
            assert cg.storage.bigcounts
            kwargs = {}
        else:
            cg = Countgraph(20, 50021, 4, device=d)
            cg.consume_seqfile(fa)
            kwargs = {"window": 1 << 12}
            if path == "overflow":
                kwargs.update(chunk=1 << 14, max_cap=1)
        track = Nodegraph(20, 1, 1, primes=cg.hashsizes(), device=d)
        out.append((cg.abundance_distribution(fa, track, **kwargs),
                    track.n_unique_kmers()))
    assert out[0] == out[1]
    # two overflows on each device on the overflow path, none elsewhere
    assert sum(overflows) == (4 if path == "overflow" else 0)


# ---- K5 row_counts, K6 diginorm_chain, K7 trim_chain -------------------------


def _rows_input(rng, B, L, k, offset):
    """codes [B, L] as a view `offset` bytes into its buffer, and ragged
    lengths: 0, below k, k, and up to L."""
    buf = torch.from_numpy(rng.integers(0, 4, offset + B * L,
                                        dtype=np.uint8))
    lens = rng.integers(0, L + 1, B)
    lens[:4] = [0, max(k - 1, 0), k, L][:min(4, B)]
    return buf, torch.from_numpy(lens.astype(np.int32))


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("width", [64, 128])  # L = width + k: 84, 148 at k 20
@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("T", [1, 4, 5])
def test_row_counts(dev, k, width, offset, T):
    """K5 on ragged rows, codes at an offset that is not 16-byte aligned
    or aligned; counts at caps 255 and 65535, with and without hashes;
    rows wider than a block's tile."""
    rng = np.random.default_rng(k * 1000 + width + T)
    B, L = 301, width + k
    buf, lengths = _rows_input(rng, B, L, k, offset)
    sizes = _primes(T)
    table = _table(rng, sizes, 400)
    geom = SketchSpec("byte", sizes).geometry("cpu")
    gdev = [g.to(dev) for g in geom]
    codes_d = buf.to(dev)[offset:].view(B, L)
    codes = buf[offset:].view(B, L)
    for cap in (255, 65535):
        for want in (False, True):
            c, h = kernels.row_counts(codes_d, lengths.to(dev), k,
                                      table.to(dev), *gdev, cap, want)
            pc, ph = plain.row_counts(codes, lengths, k, table, *geom, cap,
                                      want)
            assert torch.equal(c.cpu().to(torch.int32),
                               pc.to(torch.int32))
            assert (h is None) == (not want)
            if want:
                assert torch.equal(h.cpu(), ph)


def _chain_input(rng, B, nw, n_distinct, repeat):
    """ids, valid (a prefix of each row), real and pre of B bundles; with
    `repeat`, every other bundle repeats the bundle before it; the last
    8 bundles are pad bundles (real false, no valid window)."""
    ids = rng.integers(0, n_distinct, (2 * B, nw)).astype(np.int32)
    nvalid = rng.integers(0, nw + 1, 2 * B)
    nvalid[:2] = [0, nw]
    valid = (np.arange(nw)[None, :] < nvalid[:, None]).astype(np.uint8)
    real = (rng.random(2 * B) < 0.9).astype(np.uint8)
    if repeat:
        for b in range(1, B, 2):
            ids[2 * b: 2 * b + 2] = ids[2 * b - 2: 2 * b]
            valid[2 * b: 2 * b + 2] = valid[2 * b - 2: 2 * b]
            real[2 * b: 2 * b + 2] = real[2 * b - 2: 2 * b]
    real[-16:] = 0
    valid[-16:] = 0
    pre = rng.integers(0, 12, n_distinct).astype(np.uint16)
    return [torch.from_numpy(a) for a in (ids, valid, real, pre)]


CHAIN_CASES = {  # name: (B, nw, n_distinct, repeat)
    "repeats": (600, 81, 900, True),
    "random": (300, 129, 20000, False),
    "wide": (40, 700, 3000, True),  # 2 nw > 1024 threads: a thread loops
}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
@pytest.mark.parametrize("C", [1, 3, 65535])
def test_diginorm_chain(dev, case, C):
    """K6 against its plain version: bundles that repeat the bundle
    before them (whose windows read the tally it just added), pad
    bundles, rows with no valid window, C = 1 and 65535."""
    B, nw, n, repeat = CHAIN_CASES[case]
    args = _chain_input(np.random.default_rng(B + C), B, nw, n, repeat)
    keep, tally = kernels.diginorm_chain(*[a.to(dev) for a in args], C)
    pkeep, ptally = plain.diginorm_chain(*args, C)
    assert torch.equal(keep.cpu(), pkeep)
    assert torch.equal(tally.cpu(), ptally)
    if C == 3:
        assert 0 < int(pkeep.sum()) < B


@pytest.mark.parametrize("case", list(CHAIN_CASES))
@pytest.mark.parametrize("trim_at,dn_cov,cutoff", [
    (3, None, 2), (3, 5, 2), (1, 65535, 1), (65535, 1, 65535)])
def test_trim_chain(dev, case, trim_at, dn_cov, cutoff):
    """K7 against its plain version: branches, first_bad of every row
    (pad rows too) and tally."""
    B, nw, n, repeat = CHAIN_CASES[case]
    args = _chain_input(np.random.default_rng(B + trim_at), B, nw, n,
                        repeat)
    out = kernels.trim_chain(*[a.to(dev) for a in args], trim_at, dn_cov,
                             cutoff)
    want = plain.trim_chain(*args, trim_at, dn_cov, cutoff)
    for a, b in zip(out, want):
        assert torch.equal(a.cpu(), b)


def _round_input(rng, kind, B, nw=17):
    """ids, valid, real and pre of B bundles for K6 / K7's rounds (a
    block's 32 warps take a bundle each): `random` (k-mers drawn from
    40 B, so that nearby bundles share some; random valid prefixes, 10%
    of rows not real), `pads` (as random, with bundles 3-6 and 34 pads,
    real false and no valid window, among bundles still undecided), and,
    with every window valid and every row real, `distinct` (no k-mer
    shared), `identical` (every bundle is the first), `readers` (as
    identical, every k-mer counted 100 times before the batch),
    `one_shared` (k-mer 0 in every bundle, nothing else shared),
    `last_warp` (distinct, but bundle 31, the last warp of the first
    block, holds a k-mer of bundle 0) and `sorted` (as reads sorted by
    position: each bundle's first row holds the last half of the first
    row before it, shifted by one window)."""
    n = 2 * B * nw
    if kind in ("random", "pads"):
        ids = rng.integers(0, 40 * B, n)
    else:
        ids = rng.permutation(n) + 1
    ids = ids.reshape(2 * B, nw).astype(np.int32)
    valid = np.ones((2 * B, nw), np.uint8)
    real = np.ones(2 * B, np.uint8)
    if kind in ("random", "pads"):
        nvalid = rng.integers(0, nw + 1, 2 * B)
        valid = (np.arange(nw)[None, :] < nvalid[:, None]).astype(np.uint8)
        real = (rng.random(2 * B) < 0.9).astype(np.uint8)
    if kind == "pads":
        for b in (3, 4, 5, 6, 34):
            if b < B:
                real[2 * b: 2 * b + 2] = 0
                valid[2 * b: 2 * b + 2] = 0
    if kind in ("identical", "readers"):
        ids = np.ascontiguousarray(np.tile(ids[:2], (B, 1)))
    if kind == "one_shared":
        ids[0::2, 0] = 0
    if kind == "last_warp" and B > 31:
        ids[63, nw - 1] = ids[0, 0]
    if kind == "sorted":
        half = nw // 2
        for b in range(1, B):
            ids[2 * b, :half] = ids[2 * b - 2, half + 1: 2 * half + 1]
    pre = rng.integers(0, 12, int(ids.max()) + 1).astype(np.uint16)
    if kind == "readers":
        pre[:] = 100
    return [torch.from_numpy(a) for a in (ids, valid, real, pre)]


def _ready_rounds(ids, valid):
    """(rounds, bundles walked) of csrc/chain.cu when every bundle takes:
    each round decides every undecided bundle whose k-mers no earlier
    holder of a tag holds (the holders: the bundles that the round
    before left undecided); after a round that decides fewer than
    CHAIN_WALK_BELOW bundles, a walk decides the next undecided bundles
    in order, CHAIN_WALK_FIRST of them, four times as many each later
    walk, and all of them after round CHAIN_MAX_ROUNDS."""
    B = ids.shape[0] // 2
    lanes = valid.numpy().reshape(B, -1) != 0
    bundle = np.broadcast_to(np.arange(B)[:, None], lanes.shape)[lanes]
    kmer = ids.numpy().reshape(B, -1)[lanes].astype(np.int64)
    undecided = np.ones(B, bool)
    holders = undecided.copy()
    rounds = walked = 0
    limit = kernels.CHAIN_WALK_FIRST
    while undecided.any():
        rounds += 1
        live = holders[bundle]
        first = np.full(int(kmer.max(initial=0)) + 1, B)
        np.minimum.at(first, kmer[live], bundle[live])
        ready = undecided.copy()
        ready[bundle[live & (first[kmer] != bundle)]] = False
        undecided &= ~ready
        holders = undecided.copy()
        left = int(undecided.sum())
        if left and (rounds == kernels.CHAIN_MAX_ROUNDS or
                     ready.sum() < kernels.CHAIN_WALK_BELOW):
            count = left if rounds == kernels.CHAIN_MAX_ROUNDS else \
                min(left, limit)
            undecided[np.flatnonzero(undecided)[:count]] = False
            walked += count
            limit *= 4
    return rounds, walked


ROUND_CASES = {  # name: (kind, B, nw)
    "B=1": ("random", 1, 17), "B=31": ("random", 31, 17),
    "B=32": ("random", 32, 17), "B=33": ("random", 33, 17),
    "B=65": ("random", 65, 17),
    "B=9000": ("random", 9000, 3),  # more bundles than the grid's warps
    "pads": ("pads", 65, 17), "distinct": ("distinct", 65, 17),
    "identical": ("identical", 65, 17), "readers": ("readers", 65, 17),
    "one_shared": ("one_shared", 65, 17), "last_warp": ("last_warp", 65, 17),
    # two walks (1,024 bundles, then the rest), across the walk's
    # 1024-bundle chunks
    "sorted": ("sorted", 2100, 5),
}
DN_PARAMS = (1, 3, 65535)
TRIM_PARAMS = ((3, None, 2), (3, 5, 2), (1, 65535, 1), (65535, 1, 65535))


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_chain_rounds(dev, case):
    """K6 / K7's rounds against the plain versions: batches of 1, 31,
    32, 33 and 65 bundles (a block's 32 warps take one each) and of more
    bundles than the grid has warps, pads among undecided bundles, every
    bundle identical (one round, then the walk), identical bundles none
    of which takes (K6 drops them all in round 1; K7 walks them, since
    branches 0 and 1 need exact counts), one k-mer in all bundles, a
    conflict only at the last warp of a block, and a chain of 2,100
    bundles, each sharing k-mers with the one before it (walks of 1,024
    bundles and of the rest, with a round between them that decides
    none: its tags still name the walked bundles).  When every bundle
    takes (nothing counted before the batch, thresholds at 65535, every
    row real), K6 and K7 take exactly the rounds and walk of
    _ready_rounds."""
    kind, B, nw = ROUND_CASES[case]
    args = _round_input(np.random.default_rng(B + len(case)), kind, B, nw)
    on_card = [a.to(dev) for a in args]

    def steps(name):
        rounds, walked = kernels.CHAIN_ROUNDS[name].tolist()
        assert 1 <= rounds <= kernels.CHAIN_MAX_ROUNDS and 0 <= walked < B
        return rounds, walked

    for C in DN_PARAMS:
        for a, b in zip(kernels.diginorm_chain(*on_card, C),
                        plain.diginorm_chain(*args, C)):
            assert torch.equal(a.cpu(), b)
        steps("diginorm_chain")
    for p in TRIM_PARAMS:
        for a, b in zip(kernels.trim_chain(*on_card, *p),
                        plain.trim_chain(*args, *p)):
            assert torch.equal(a.cpu(), b)
        steps("trim_chain")
    if kind == "readers":
        kernels.diginorm_chain(*on_card, 3)
        assert steps("diginorm_chain") == (1, 0)
        for dn_cov in (None, 5):
            branch = kernels.trim_chain(*on_card, 3, dn_cov, 2)[0]
            assert int((branch == 2).sum()) == 0
            assert steps("trim_chain") == (1, B - 1)
    if kind in ("random", "pads", "readers"):
        return
    want = _ready_rounds(args[0], args[1])
    assert want == {"distinct": (1, 0), "identical": (1, B - 1),
                    "one_shared": (1, B - 1), "last_warp": (2, 0),
                    "sorted": (2, B - 1)}[kind]
    zero = on_card[:3] + [torch.zeros_like(on_card[3])]
    keep, _ = kernels.diginorm_chain(*zero, 65535)
    assert int(keep.sum()) == B
    assert steps("diginorm_chain") == want
    branch = kernels.trim_chain(*zero, 65535, None, 1)[0]
    assert int((branch == 2).sum()) == B
    assert steps("trim_chain") == want


def test_chain_back_to_back(dev):
    """Three K6 and three K7 calls queued on one stream with no
    synchronisation between them, on two inputs in turn: each call's
    tally and scratch come from the caching allocator, which hands a
    call the memory an earlier call freed."""
    rng = np.random.default_rng(7)
    inputs = [_round_input(rng, "random", 101, 17),
              _chain_input(rng, 200, 81, 900, True)]
    on_card = [[a.to(dev) for a in args] for args in inputs]
    got = []
    for i in (0, 1, 0):
        got.append((kernels.diginorm_chain(*on_card[i], 3)[0],
                    kernels.trim_chain(*on_card[i], 3, 5, 2)[:2]))
    for i, (keep, (branch, first_bad)) in zip((0, 1, 0), got):
        assert torch.equal(keep.cpu(),
                           plain.diginorm_chain(*inputs[i], 3)[0])
        want = plain.trim_chain(*inputs[i], 3, 5, 2)
        assert torch.equal(branch.cpu(), want[0])
        assert torch.equal(first_bad.cpu(), want[1])


def test_chain_rejects_more_bundles_than_tags_hold(dev, monkeypatch):
    """More bundles than a tag's bundle field holds raise before any
    launch (a small MAX_CHAIN_BUNDLES stands in for 2^26 - 1)."""
    monkeypatch.setattr(kernels, "MAX_CHAIN_BUNDLES", 40)
    args = [a.to(dev) for a in _round_input(np.random.default_rng(0),
                                            "random", 41)]
    with pytest.raises(ValueError, match="exceed"):
        kernels.diginorm_chain(*args, 3)
    with pytest.raises(ValueError, match="exceed"):
        kernels.trim_chain(*args, 3, None, 2)


def test_streaming_filters_small_on_card(dev, tmp_path):
    """normalize-by-median and trim-low-abund batch steps, count_rows and
    median_at_least_batch on the card equal the CPU run on generated
    reads (three batches of 256 bundles)."""
    rng = np.random.default_rng(4)
    genome = "".join(rng.choice(list("ACGT"), 8000))
    reads = [genome[s:s + 100] for s in rng.integers(0, 7900, 1536)]
    batches = [[(reads[2 * i], reads[2 * i + 1] if i % 9 else None)
                for i in range(b * 256, (b + 1) * 256)] for b in range(3)]
    out = []
    for d in (dev, "cpu"):
        dn = Countgraph(20, 20011, 4, device=d)
        tr = Countgraph(20, 20011, 4, device=d)
        got = []
        for batch in batches:
            got.append(dn.diginorm_batch(batch, 6).cpu())
            got += [t.cpu() for t in tr.trim_pass1_batch(batch, 5, 8, 2)]
        got.append(dn.storage.table.cpu())
        got.append(tr.storage.table.cpu())
        got.append(torch.tensor([dn.n_unique_kmers(), tr.n_unique_kmers()]))
        got += [torch.from_numpy(c.astype(np.int32))
                for c in dn.count_rows(reads[:50])]
        got.append(torch.from_numpy(tr.median_at_least_batch(reads[:50], 4)))
        out.append(got)
    for a, b in zip(*out):
        assert torch.equal(a, b)


# --- slice 3a: the murmur kernels (K8, K9, K5's murmur variant) -----------

MURMUR_BYTES = np.frombuffer(b"ACGTACGTACGTacgtNnRYKMSWBDHVU.- \x00\xff",
                             np.uint8)


def _ascii_rows(rng, B, L, k, offset, mixed=0.2):
    """ASCII rows [B, L] as a view `offset` bytes into their buffer, a
    share `mixed` of their bytes lowercase, N, IUPAC or other; ragged
    lengths (0, below k, k, up to L)."""
    buf = rng.choice(np.frombuffer(b"ACGT", np.uint8), offset + B * L)
    hit = rng.random(buf.size) < mixed
    buf[hit] = rng.choice(MURMUR_BYTES, int(hit.sum()))
    lens = rng.integers(0, L + 1, B)
    lens[:4] = [0, max(k - 1, 0), k, L][:min(4, B)]
    return torch.from_numpy(buf), torch.from_numpy(lens.astype(np.int32))


MURMUR_TILE = 256  # window starts per block of csrc/murmur.cu and hll.cu


@pytest.mark.parametrize("acgt", [False, True], ids=["full", "acgt"])
@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("k", [1, 15, 16, 17, 32, 33, 255])
def test_murmur_hashes(dev, k, offset, acgt):
    """K8 on ragged rows (rows shorter than k included) of ASCII with
    non-ACGT bytes, both complement forms, every window valid or not;
    then the flat form of one row across many tiles."""
    rng = np.random.default_rng(k * 10 + offset)
    for B, L in ((37, k + 70), (3, k), (1, 5 * MURMUR_TILE + k + 3)):
        buf, lengths = _ascii_rows(rng, B, L, k, offset)
        byts = buf[offset:].view(B, L)
        h, v = kernels.murmur_hashes(buf.to(dev)[offset:].view(B, L),
                                     lengths.to(dev), k, acgt)
        ph, pv = plain.murmur_hashes(byts, lengths, k, acgt)
        assert torch.equal(h.cpu(), ph) and torch.equal(v.cpu(), pv)
    assert (_u64.to_numpy(ph) >= 1 << 63).any() or k == 255


@pytest.mark.parametrize("case", ["masked", "hot", "short"])
@pytest.mark.parametrize("p", [4, 15, 16])
def test_hll_update(dev, p, case):
    """K9 from zero registers and from filled ones: a third of the lanes
    masked; half the lanes one k-mer (poly-A), so on one register; a
    chunk shorter than k, and of k.  h >> p == 0 has probability
    2**(p - 64) a window and is not reached from data:
    test_torch_hll.py checks the plain version's clz(0) = 64."""
    rng = np.random.default_rng(p)
    k = 20 if case != "short" else 33
    n = 3 * MURMUR_TILE + 7 if case != "short" else k
    byts = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n)
    if case == "hot":
        byts[: n // 2] = ord("A")
    weights = (rng.random(n) < (0.66 if case == "masked" else 1.0))
    weights = torch.from_numpy(weights.astype(np.uint8))
    byts = torch.from_numpy(byts)
    m = 1 << p
    for start in (torch.zeros(m, dtype=torch.uint8),
                  torch.from_numpy(rng.integers(0, 8, m, dtype=np.uint8))):
        regs = start.clone()
        r = regs.to(dev)
        kernels.hll_update(byts.to(dev), weights.to(dev), k, p, m, r)
        plain.hll_update(byts, weights, k, p, m, regs)
        assert torch.equal(r.cpu(), regs)
        assert case == "short" or not torch.equal(regs, start)
    short = byts[: k - 1]
    r = torch.zeros(m, dtype=torch.uint8, device=dev)
    kernels.hll_update(short.to(dev), weights[: k - 1].to(dev), k, p, m, r)
    assert not bool(r.any())


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("k", [1, 20, 51, 255])
@pytest.mark.parametrize("T", [1, 4, 5])
def test_row_counts_murmur(dev, k, offset, T):
    """K5's murmur variant on ragged ASCII rows with non-ACGT bytes, caps
    255 and 65535, with and without hashes."""
    rng = np.random.default_rng(k * 1000 + T + offset)
    B, L = 211, 64 + k
    buf, lengths = _ascii_rows(rng, B, L, k, offset)
    sizes = _primes(T)
    table = _table(rng, sizes, 400)
    geom = SketchSpec("byte", sizes).geometry("cpu")
    gdev = [g.to(dev) for g in geom]
    byts = buf[offset:].view(B, L)
    kernels.reset_launches()
    for cap in (255, 65535):
        for want in (False, True):
            c, h = kernels.row_counts(buf.to(dev)[offset:].view(B, L),
                                      lengths.to(dev), k, table.to(dev),
                                      *gdev, cap, want, "murmur")
            pc, ph = plain.row_counts(byts, lengths, k, table, *geom, cap,
                                      want, "murmur")
            assert torch.equal(c.cpu().to(torch.int32), pc.to(torch.int32))
            if want:
                assert torch.equal(h.cpu(), ph)
    assert kernels.ROW_COUNTS_BY_HASH == {"2bit": 0, "murmur": 4,
                                          "cyclic": 0}


def test_sketch_ops_on_murmur_hashes(dev):
    """K2 and K3 on murmur hashes (all 64 bits used, half with the top bit
    set) against their plain versions, at the bench primes; and the
    Barrett h % p of such hashes exact: with table[i] = i, one table of
    p = 65521 bins, K3 returns h % p itself."""
    rng = np.random.default_rng(23)
    buf, lengths = _ascii_rows(rng, 64, 164, 51, 0, mixed=0.0)
    h, _ = plain.murmur_hashes(buf.view(64, 164), lengths, 51, True)
    h = h.reshape(-1)
    assert (_u64.to_numpy(h) >= 1 << 63).mean() > 0.4
    spec = SketchSpec("byte", tuple(get_n_primes_near_x(4, 1e8)))
    geom = spec.geometry(dev)
    table = torch.zeros(spec.total_bins + 1, dtype=torch.int32, device=dev)
    hd = h.to(dev)
    w = torch.ones(h.numel(), dtype=torch.int32, device=dev)
    nu = torch.zeros(1, dtype=torch.int64, device=dev)
    tp, nup = table.clone(), nu.clone()
    assert torch.equal(kernels.sketch_update(table, hd, w, *geom, nu),
                       plain.sketch_update(tp, hd, w, *geom, nup))
    assert torch.equal(table, tp) and torch.equal(nu, nup)
    assert torch.equal(kernels.sketch_get(table, hd, *geom, 65535),
                       plain.sketch_get(tp, hd, *geom, 65535))
    one = SketchSpec("byte", (65521,))
    ident = torch.arange(65522, dtype=torch.int32, device=dev)
    got = kernels.sketch_get(ident, hd, *one.geometry(dev), 65535)
    want = [int(x) % 65521 for x in _u64.to_numpy(h)]
    assert got.cpu().to(torch.int64).tolist() == want


def test_murmur_tables_small_on_card(dev, tmp_path):
    """A Counttable at k = 51 (consume_seqfile, count_rows, the
    normalize-by-median and trim-low-abund batch steps, the histogram)
    and HLLCounters at p = 14 and 16 on the card equal the CPU run on
    generated reads."""
    from khmer_tpu_torch import Counttable, HLLCounter, Nodetable

    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, 8)
    rng = np.random.default_rng(8)
    genome = "".join(rng.choice(list("ACGT"), 8000))
    reads = [genome[s:s + 100] for s in rng.integers(0, 7900, 1024)]
    batches = [[(reads[2 * i], reads[2 * i + 1] if i % 9 else None)
                for i in range(b * 256, (b + 1) * 256)] for b in range(2)]
    out = []
    kernels.reset_launches()
    for d in (dev, "cpu"):
        ct = Counttable(51, 20011, 4, device=d)
        got = [torch.tensor(ct.consume_seqfile(fa))]
        got += [torch.from_numpy(c.astype(np.int32))
                for c in ct.count_rows(reads[:50] + ["ACGTNacgt" * 8])]
        got.append(torch.tensor(ct.abundance_distribution(
            fa, Nodetable(51, 1, 1, primes=ct.hashsizes(), device=d))))
        dn = Counttable(51, 20011, 4, device=d)
        tr = Counttable(51, 20011, 4, device=d)
        for batch in batches:
            got.append(dn.diginorm_batch(batch, 6).cpu())
            got += [t.cpu() for t in tr.trim_pass1_batch(batch, 5, 8, 2)]
        for t in (ct, dn, tr):
            got += [t.storage.table.cpu(), torch.tensor(t.n_unique_kmers())]
        for e in (0.01, 0.005):
            hll = HLLCounter(e, 51, device=d)
            got.append(torch.tensor(hll.consume_seqfile(fa)))
            hll.consume_string("acgtNACGT" * 20)
            got.append(torch.tensor(hll.counters + [len(hll)]))
        out.append(got)
        if d == dev:
            launches = dict(kernels.LAUNCHES)
    for a, b in zip(*out):
        assert torch.equal(a.cpu(), b)
    assert launches["murmur_hashes"] and launches["hll_update"] and \
        kernels.ROW_COUNTS_BY_HASH["murmur"]


# --- slice 3b: K11 cyclic_hashes, K5c and the nibble tables --------------

CYCLIC_KS = [1, 20, 63, 64, 65, 100, 255]
CYCLIC_TILE = 256  # window starts per block of csrc/cyclic.cu


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("k", CYCLIC_KS)
def test_cyclic_hashes(dev, k, offset):
    """K11 on ragged rows (lengths 0, below k, k and L) of ASCII with
    lowercase, N, IUPAC and other bytes, every window valid or not, at
    widths L that are not a multiple of the tile; B = 0; then the flat
    form of one row across many tiles."""
    rng = np.random.default_rng(k * 10 + offset)
    kernels.reset_launches()
    for B, L in ((37, k + 70), (3, k), (0, k + 9),
                 (1, 5 * CYCLIC_TILE + k + 3)):
        buf, lengths = _ascii_rows(rng, B, L, k, offset)
        byts = buf[offset:].view(B, L)
        h, v = kernels.cyclic_hashes(buf.to(dev)[offset:].view(B, L),
                                     lengths.to(dev), k)
        ph, pv = plain.cyclic_hashes(byts, lengths, k)
        assert h.shape == (B, L - k + 1)
        assert torch.equal(h.cpu(), ph) and torch.equal(v.cpu(), pv)
    assert (_u64.to_numpy(ph) >= 1 << 63).any()
    assert kernels.LAUNCHES["cyclic_hashes"] == 3


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("k", CYCLIC_KS)
@pytest.mark.parametrize("T", [1, 4, 5])
def test_row_counts_cyclic(dev, k, offset, T):
    """K5c on ragged ASCII rows with non-ACGT bytes, rows wider than a
    block's tile at k = 255, caps 15, 255 and 65535, with and without
    hashes; B = 0 launches nothing."""
    rng = np.random.default_rng(k * 1000 + T + offset)
    B, L = 211, 64 + k
    buf, lengths = _ascii_rows(rng, B, L, k, offset)
    sizes = _primes(T)
    table = _table(rng, sizes, 400)
    geom = SketchSpec("byte", sizes).geometry("cpu")
    gdev = [g.to(dev) for g in geom]
    byts = buf[offset:].view(B, L)
    kernels.reset_launches()
    for cap in (15, 255, 65535):
        for want in (False, True):
            c, h = kernels.row_counts(buf.to(dev)[offset:].view(B, L),
                                      lengths.to(dev), k, table.to(dev),
                                      *gdev, cap, want, "cyclic")
            pc, ph = plain.row_counts(byts, lengths, k, table, *geom, cap,
                                      want, "cyclic")
            assert torch.equal(c.cpu().to(torch.int32), pc.to(torch.int32))
            if want:
                assert torch.equal(h.cpu(), ph)
    c, _ = kernels.row_counts(buf.to(dev)[:0].view(0, L),
                              lengths.to(dev)[:0], k, table.to(dev), *gdev,
                              15, False, "cyclic")
    assert c.shape == (0, L - k + 1)
    assert kernels.ROW_COUNTS_BY_HASH == {"2bit": 0, "murmur": 0,
                                          "cyclic": 6}


def test_small_tables_on_card(dev, tmp_path):
    """A SmallCountgraph and a SmallCounttable (consume_seqfile past the
    cap of 15, count_rows, the normalize-by-median and trim-low-abund
    batch steps, the histogram, the saved bytes and their load) and a
    CyclicCounttable (consume_seqfile, count_rows, the batch steps, the
    histogram, the saved bytes) on the card equal the CPU run on
    generated reads; NibbleStorage refuses bigcount."""
    from khmer_tpu_torch import (CyclicCounttable, Nodetable,
                                 SmallCountgraph, SmallCounttable)

    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, 9, repeats=30)
    rng = np.random.default_rng(9)
    genome = "".join(rng.choice(list("ACGT"), 8000))
    reads = [genome[s:s + 100] for s in rng.integers(0, 7900, 1024)]
    batches = [[(reads[2 * i], reads[2 * i + 1] if i % 9 else None)
                for i in range(b * 256, (b + 1) * 256)] for b in range(2)]
    out = []
    kernels.reset_launches()
    for d in (dev, "cpu"):
        got = []
        for cls, track in ((SmallCountgraph, Nodegraph),
                           (SmallCounttable, Nodetable),
                           (CyclicCounttable, Nodetable)):
            ct = cls(20, 20011, 4, device=d)
            got.append(torch.tensor(ct.consume_seqfile(fa)))
            got += [torch.from_numpy(c.astype(np.int32))
                    for c in ct.count_rows(reads[:50] + ["ACGTNacgt" * 8])]
            got.append(torch.tensor(ct.abundance_distribution(
                fa, track(20, 1, 1, primes=ct.hashsizes(), device=d))))
            path = str(tmp_path / "{}-{}.ct".format(cls.__name__, d))
            ct.save(path)
            got.append(torch.from_numpy(np.fromfile(path, np.uint8)))
            got.append(cls.load(path, device=d).storage.table.cpu())
            dn = cls(20, 20011, 4, device=d)
            tr = cls(20, 20011, 4, device=d)
            for batch in batches:
                got.append(dn.diginorm_batch(batch, 20).cpu())
                got += [t.cpu() for t in tr.trim_pass1_batch(batch, 20, 8,
                                                             2)]
            for t in (ct, dn, tr):
                got += [t.storage.table.cpu(),
                        torch.tensor(t.n_unique_kmers())]
            if cls is not CyclicCounttable:
                assert int(got[-6].max()) > 15
                with pytest.raises(ValueError, match="bigcount"):
                    ct.set_use_bigcount(True)
        out.append(got)
        if d == dev:
            launches = dict(kernels.LAUNCHES)
            by_hash = dict(kernels.ROW_COUNTS_BY_HASH)
    for a, b in zip(*out):
        assert torch.equal(a.cpu(), b)
    for name in ("cyclic_hashes", "sketch_get", "abund_hist",
                 "bin_scatter_add", "diginorm_chain", "trim_chain"):
        assert launches[name], name
    assert by_hash["cyclic"] and by_hash["2bit"] and by_hash["murmur"]


# ---------------------------------------------------------------------------
# K10 cc_rounds
# ---------------------------------------------------------------------------


def _cc_graph(case):
    """(T, src, dst) uint32 numpy: one node and no edge; padding edges
    only; a star; a path of 2**16 nodes; duplicate edges (each of 300
    edges eight times, with padding); 2**20 random edges on 2**18 nodes."""
    rng = np.random.default_rng(len(case))
    if case == "one_node":
        return 1, np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    if case == "padding":
        return 100, np.zeros(500, np.uint32), np.zeros(500, np.uint32)
    if case == "star":
        leaves = np.arange(1, 5000, dtype=np.uint32)
        return 5000, np.full(leaves.size, 2500, np.uint32), leaves
    if case == "path":
        src = np.arange((1 << 16) - 1, dtype=np.uint32)
        return 1 << 16, src, src + 1
    if case == "duplicates":
        src = np.repeat(rng.integers(0, 1000, 300), 8).astype(np.uint32)
        dst = np.repeat(rng.integers(0, 1000, 300), 8).astype(np.uint32)
        return 1000, np.concatenate([src, np.zeros(100, np.uint32)]), \
            np.concatenate([dst, np.zeros(100, np.uint32)])
    T = 1 << 18
    return T, rng.integers(0, T, 1 << 20).astype(np.uint32), \
        rng.integers(0, T, 1 << 20).astype(np.uint32)


def _as_i32(a, dev=None):
    t = torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))
    return t if dev is None else t.to(dev)


@pytest.mark.parametrize("rounds", [1, 8, 17])
@pytest.mark.parametrize("case", ["one_node", "padding", "star", "path",
                                  "duplicates", "random"])
def test_cc_rounds(dev, case, rounds):
    """Labels and the changed flag equal the plain version's, bit for
    bit, for a call from arange labels and a second call from its
    output; the input labels are left as they were."""
    T, src, dst = _cc_graph(case)
    s, d = _as_i32(src, dev), _as_i32(dst, dev)
    lab = torch.arange(T, dtype=torch.int32, device=dev)
    want = torch.arange(T, dtype=torch.int32)
    for _ in range(2):
        before = lab.clone()
        kernels.reset_launches()
        got, changed = kernels.cc_rounds(lab, s, d, rounds)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["cc_rounds"] == 4 * rounds
        assert torch.equal(lab, before)
        want, w_changed = plain.cc_rounds(want, _as_i32(src), _as_i32(dst),
                                          rounds)
        assert torch.equal(got.cpu(), want)
        assert bool(changed) == bool(w_changed)
        lab = got


def test_cc_rounds_refuses_past_int32(dev, monkeypatch):
    """The size check runs before any launch (checked with the limit
    lowered, so that no array of 2**31 labels is allocated)."""
    with pytest.raises(ValueError, match="2\\*\\*31"):
        kernels.check_cc_sizes(1 << 31, 0)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        kernels.check_cc_sizes(10, 1 << 31)
    monkeypatch.setattr(kernels, "MAX_CC", 99)
    kernels.reset_launches()
    edges = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.cc_rounds(torch.arange(100, dtype=torch.int32, device=dev),
                          edges, edges, 8)
    with pytest.raises(ValueError):
        big = torch.zeros(100, dtype=torch.int32, device=dev)
        kernels.cc_rounds(torch.arange(10, dtype=torch.int32, device=dev),
                          big, big, 8)
    assert kernels.LAUNCHES["cc_rounds"] == 0


def test_partition_scripts_small_on_card(dev, tmp_path):
    """load-graph, partition-graph (three subsets, and
    --no-big-traverse), merge-partitions, annotate-partitions and
    extract-partitions on the card write the CPU run's bytes, and
    do_partition_device's partitions on the card equal the CPU run's."""
    import os

    from khmer_tpu_torch import Nodegraph, SubsetPartition
    from khmer_tpu_torch.scripts import (annotate_partitions,
                                         extract_partitions, load_graph,
                                         merge_partitions, partition_graph)

    rng = np.random.default_rng(21)
    with open(str(tmp_path / "reads.fa"), "w") as f:
        for g in range(8):
            genome = "".join(rng.choice(list("ACGT"), 600))
            for i, s in enumerate(rng.integers(0, 500, 40)):
                f.write(">g%dr%d\n%s\n" % (g, i, genome[s:s + 100]))
    out = {}
    here = os.getcwd()
    kernels.reset_launches()
    for d in (dev, "cpu"):
        wd = tmp_path / str(d)
        wd.mkdir()
        os.chdir(str(wd))
        try:
            load_graph.main(["-k", "20", "-N", "4", "-x", "20011", "g",
                             "../reads.fa"], device=d)
            partition_graph.main(["-s", "40", "g"], device=d)
            merge_partitions.main(["-k", "20", "--keep-subsets", "g"],
                                  device=d)
            annotate_partitions.main(["-k", "20", "g", "../reads.fa"],
                                     device=d)
            extract_partitions.main(["-m", "2", "g", "reads.fa.part"],
                                    device=d)
            partition_graph.main(["--no-big-traverse", "g"], device=d)
            ng = Nodegraph.load("g", device=d)
            ng.load_tagset("g.tagset")
            sp = SubsetPartition(ng)
            sp.do_partition_device()
            sp.save_partitionmap("device.pmap")
        finally:
            os.chdir(here)
        out[str(d)] = {f: open(str(wd / f), "rb").read()
                       for f in sorted(os.listdir(str(wd)))}
        if d == dev:
            launches = dict(kernels.LAUNCHES)
    assert out[str(dev)] == out["cpu"]
    assert len(out["cpu"]) >= 8
    for name in ("hash2bit_canonical", "sketch_update", "sketch_get",
                 "cc_rounds"):
        assert launches[name], name


# K12: bands of (num_bands, band): the first and last of 4, the upper half,
# band 1 of 3 across 2**63, and the one band that holds all but 2**64 - 1
K12_BANDS = [(4, 0), (4, 3), (2, 1), (3, 1), (1, 0)]
# mask storage kinds: (kind, read cap)
K12_MASKS = [("bit", 1), ("nibble", 15), ("byte", 255), ("byte", 65535)]


def _k12_lanes(rng, n, band=None):
    """n hashes (random, the crafted edges 0, 2**63 - 1, 2**63, 2**64 - 1
    and, with a band, its edges and their neighbours, repeated through the
    batch) and weights 0, 1, 2 and 2**32 - 1."""
    edges = [0, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1]
    if band is not None:
        lo, hi = band
        edges += [lo, max(lo - 1, 0), hi - 1, min(hi, 2 ** 64 - 1)]
    h = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
    h[::3] = np.array(edges, np.uint64)[np.arange(0, n, 3) % len(edges)]
    w = rng.choice(np.array([0, 1, 2, 2 ** 32 - 1], np.uint32), n,
                   p=[0.2, 0.6, 0.15, 0.05])
    return (_u64.as_tensor(h, "cpu"),
            torch.from_numpy(w.view(np.int32)))


def _k12_both(dev, hashes, weights, offset=0, mask=None, **kw):
    """K12 on the card and its plain version on the CPU from the same
    inputs (hashes and weights as views `offset` lanes into their buffers;
    mask a (kind, sizes, table) or None), from a total of 7: asserts equal
    weights and totals and one launch for a nonempty batch; returns the
    plain weights."""
    out = []
    for d in (dev, torch.device("cpu")):
        total = torch.full((1,), 7, dtype=torch.int64, device=d)
        extra = {}
        if mask is not None:
            kind, sizes, table = mask
            extra = dict(zip(("table", "sizes", "offsets", "recips"),
                             (table.to(d),
                              *SketchSpec(kind, sizes).geometry(d))))
        before = kernels.LAUNCHES["band_mask_weights"]
        w = kernels.band_mask_weights(hashes.to(d)[offset:],
                                      weights.to(d)[offset:], total,
                                      **extra, **kw)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["band_mask_weights"] == before + (
                1 if hashes.numel() > offset else 0)
        out.append((w.cpu(), total.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    return out[1][0]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 3, 5, 255, 1025, (1 << 20) + 3])
@pytest.mark.parametrize("bands", K12_BANDS, ids=str)
def test_band_mask_weights_band(dev, bands, n, offset):
    """The band alone: n not a multiple of four lanes or of a block, the
    crafted hashes at and beside the band's edges; offset 1: no 16-byte
    loads or stores."""
    from khmer_tpu_torch.ops.hashing import compute_band_interval

    band = compute_band_interval(*bands)
    rng = np.random.default_rng(n + 7 * offset + bands[0])
    hashes, weights = _k12_lanes(rng, n + offset, band)
    w = _k12_both(dev, hashes, weights, offset, band=band)
    if n >= 255:
        assert 0 < int((w != 0).sum()) < int((weights[offset:] != 0).sum())


@pytest.mark.parametrize("consume_masked", [False, True])
@pytest.mark.parametrize("at_cap", [False, True], ids=["t0", "tcap"])
@pytest.mark.parametrize("kind,cap", K12_MASKS, ids=str)
@pytest.mark.parametrize("T", [1, 4, 5])
def test_band_mask_weights_mask(dev, T, kind, cap, at_cap, consume_masked):
    """The mask alone, of 1 and 4 tables (the unrolled gather) and 5 (the
    loop), read at each storage kind's cap, threshold 0 and at the cap;
    3001 lanes as a view one lane in (no vector path) and whole."""
    rng = np.random.default_rng(T * 100 + cap)
    sizes = _primes(T)
    table = _table(rng, sizes, 2 * cap + 2)
    hashes, weights = _k12_lanes(rng, 3002)
    for offset in (0, 1):
        _k12_both(dev, hashes, weights, offset, (kind, sizes, table),
                  cap=cap, threshold=cap if at_cap else 0,
                  consume_masked=consume_masked)


@pytest.mark.parametrize("consume_masked", [False, True])
@pytest.mark.parametrize("bands", [(4, 0), (4, 3), (3, 1)], ids=str)
def test_band_mask_weights_both(dev, bands, consume_masked):
    from khmer_tpu_torch.ops.hashing import compute_band_interval

    band = compute_band_interval(*bands)
    rng = np.random.default_rng(bands[1])
    sizes = _primes(4)
    table = _table(rng, sizes, 8)
    hashes, weights = _k12_lanes(rng, 5001, band)
    _k12_both(dev, hashes, weights, 0, ("byte", sizes, table), band=band,
              cap=255, threshold=2, consume_masked=consume_masked)


def test_band_mask_weights_total_over_calls(dev):
    """The total is added to, over several calls, and never reset."""
    rng = np.random.default_rng(3)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    want = 0
    for n in (1 << 16, 17, 1 << 20):
        hashes, weights = _k12_lanes(rng, n)
        w = kernels.band_mask_weights(hashes.to(dev), weights.to(dev),
                                      total, band=(2 ** 62, 2 ** 64 - 5))
        want += int(_u64.u32(w.cpu()).sum())
    assert int(total) == want > 2 ** 32


def test_band_mask_weights_refuses(dev):
    """A mask on another device, no filter at all, a bad band or
    threshold: ValueError, and nothing launched."""
    hashes, weights = _k12_lanes(np.random.default_rng(4), 64)
    hashes, weights = hashes.to(dev), weights.to(dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    geom = SketchSpec("bit", SIZES).geometry("cpu")
    table = torch.zeros(sum(SIZES) + 1, dtype=torch.int32)
    before = kernels.LAUNCHES["band_mask_weights"]
    with pytest.raises(ValueError):
        kernels.band_mask_weights(hashes, weights, total, table=table,
                                  sizes=geom[0], offsets=geom[1],
                                  recips=geom[2], cap=1)
    with pytest.raises(ValueError, match="need a band, a mask"):
        kernels.band_mask_weights(hashes, weights, total)
    with pytest.raises(ValueError, match="bmin <= bmax"):
        kernels.band_mask_weights(hashes, weights, total, band=(5, 2 ** 64))
    dgeom = SketchSpec("bit", SIZES).geometry(dev)
    with pytest.raises(ValueError, match="threshold"):
        kernels.band_mask_weights(hashes, weights, total, table=table.to(dev),
                                  sizes=dgeom[0], offsets=dgeom[1],
                                  recips=dgeom[2], cap=1, threshold=-1)
    assert kernels.LAUNCHES["band_mask_weights"] == before


def test_band_mask_consume_small_on_card(dev, tmp_path):
    """consume_seqfile_banding, consume_seqfile_with_mask and
    consume_seqfile_banding_with_mask on the card equal the CPU run: a
    Countgraph with bigcount (saved bytes), a Counttable and a
    CyclicCounttable, with Nodegraph, Nodetable, Countgraph and
    SmallCountgraph masks; a mask on the CPU raises."""
    from khmer_tpu_torch import (Counttable, CyclicCounttable, Nodetable,
                                 SmallCountgraph)

    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, 12)
    mfa = str(tmp_path / "mask.fa")
    _write_reads(mfa, 12, n_reads=700, repeats=300)
    runs = [
        (Countgraph, "consume_seqfile_with_mask", (), Nodegraph, {}),
        (Countgraph, "consume_seqfile_with_mask", (), Countgraph,
         dict(threshold=255, consume_masked=True)),
        (Countgraph, "consume_seqfile_with_mask", (), SmallCountgraph,
         dict(threshold=3)),
        (Counttable, "consume_seqfile_banding", (4, 3), None, {}),
        (CyclicCounttable, "consume_seqfile_banding", (3, 1), None, {}),
        (Counttable, "consume_seqfile_banding_with_mask", (4, 2), Nodetable,
         dict(threshold=1, consume_masked=True)),
    ]
    out = []
    kernels.reset_launches()
    for d in (dev, "cpu"):
        got = []
        for i, (cls, method, args, mcls, kw) in enumerate(runs):
            t = cls(20, 20011, 4, device=d)
            if cls is Countgraph:
                t.set_use_bigcount(True)
            m = ()
            if mcls is not None:
                m = (mcls(20, 20011, 4, device=d),)
                m[0].consume_seqfile(mfa)
            got.append(torch.tensor(getattr(t, method)(fa, *args, *m,
                                                       chunk=1 << 14, **kw)))
            got += [t.storage.table.cpu(), torch.tensor(t.n_unique_kmers())]
            path = str(tmp_path / "{}-{}.ct".format(i, d))
            t.save(path)
            got.append(torch.from_numpy(np.fromfile(path, np.uint8)))
        out.append(got)
        if d == dev:
            assert kernels.LAUNCHES["band_mask_weights"] > len(runs)
    for a, b in zip(*out):
        assert torch.equal(a, b)
    mask = Nodegraph(20, 20011, 4, device="cpu")
    with pytest.raises(ValueError, match="mask on cpu"):
        Countgraph(20, 20011, 4, device=dev).consume_seqfile_with_mask(
            fa, mask)


# ---------------------------------------------------------------------------
# slice 4b: traversal, stop tags and the knot-removal workflow
# ---------------------------------------------------------------------------


def _knot_fa(path, seed=8, n_seqs=8, core=60, flank=100):
    """n_seqs sequences of random flanks around one shared random core
    (radius-40 searches from the core pass 200 k-mers)."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), n))

    shared = rand(core)
    with open(path, "w") as f:
        for i in range(n_seqs):
            f.write(">s%d\n%s\n" % (i, rand(flank) + shared + rand(flank)))


def _knot_graphs(dev, path, k=20):
    """The same consume-and-tagged, partitioned Nodegraph on the card and
    on the CPU."""
    from khmer_tpu_torch import Nodegraph

    out = []
    for d in (dev, "cpu"):
        g = Nodegraph(k, 10007, 4, device=d)
        g.consume_seqfile_and_tag(path)
        g.merge_subset(g.do_subset_partition(0, 0))
        out.append(g)
    return out


@pytest.mark.parametrize("cap", [1000000, 30])
@pytest.mark.parametrize("radius", [0, 5, 40])
def test_batched_traversal_on_card(dev, tmp_path, radius, cap):
    """traversal.keeper_arrays over every tag at once on the card: every
    keeper, in order, equals the CPU's, with a seventh of the tags stop
    tags; and one traverse_from_kmer a seed."""
    from khmer_tpu_torch import traversal

    path = str(tmp_path / "knot.fa")
    _knot_fa(path)
    gd, gc = _knot_graphs(dev, path)
    tags = sorted(gc.all_tags)
    for g in (gd, gc):
        g.stop_tags = set(tags[::7])
    seeds = [traversal.fr_from_hash(t, 20) for t in tags]
    before = kernels.LAUNCHES["sketch_get"]
    got = traversal.keeper_arrays(gd, seeds, radius, cap,
                                  traversal.stop_keys(gd))
    want = traversal.keeper_arrays(gc, seeds, radius, cap,
                                   traversal.stop_keys(gc))
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    # one probe a level for the whole batch
    assert kernels.LAUNCHES["sketch_get"] - before <= radius
    for t in tags[1::9]:
        assert list(gd.traverse_from_kmer(t, radius, cap)) == \
            list(gc.traverse_from_kmer(t, radius, cap))


@pytest.mark.parametrize("case", ["default", "shared-bins", "batch-3"])
def test_repartition_on_card(dev, tmp_path, case, monkeypatch):
    """repartition_largest_partition on the card: its size, stop tags (in
    order), partition map and counting table equal the CPU's, with the
    speculative traversals taken again (the batch of every tag), with
    counting bins that every walked k-mer shares, and in batches of 3;
    the counting table is read and written once a batch."""
    from khmer_tpu_torch import Countgraph, partitioning

    path = str(tmp_path / "knot.fa")
    _knot_fa(path)
    if case == "batch-3":
        monkeypatch.setattr(partitioning, "KNOT_BATCH", 3)
    out = []
    for g in _knot_graphs(dev, path):
        if case == "shared-bins":
            c = Countgraph(20, 1, 1, primes=[5, 7, 11, 13], device=g.device)
        else:
            c = Countgraph(20, 10007, 4, device=g.device)
        k2 = kernels.LAUNCHES["sketch_update"]
        size = g.repartition_largest_partition(c, 20, 100, 1)
        stats = g.partition.knot_stats
        if g.device.type == "cuda":
            # at most one add a batch (none for a batch that walks nothing)
            k2 = kernels.LAUNCHES["sketch_update"] - k2
            assert 0 < k2 <= kernels.KERNELS_PER_CALL["sketch_update"] * \
                stats["batches"]
        out.append((size, list(g.stop_tags),
                    list(g.partition.partition_map.items()),
                    bytes(c.storage.raw_bytes()), c.n_unique_kmers(), stats))
    assert out[0] == out[1]
    stats = out[0][-1]
    assert stats["stop_tags_added"] > 0 and stats["walked"] > 0
    if case != "batch-3":
        assert stats["retraced"] > 0


@pytest.mark.parametrize("primes", [None, [101, 103, 107]])
@pytest.mark.parametrize("cls", ["Nodegraph", "Countgraph"])
def test_consume_and_tag_with_stoptags_on_card(dev, tmp_path, cls, primes,
                                               monkeypatch):
    """consume_seqfile_and_tag_with_stoptags on the card (in batches of 7
    reads) equals the CPU run: returns, tags, stop tags, partition map,
    table bytes and n_unique; over 3 x ~100 bins too, where a batch's
    empty bins are shared."""
    import khmer_tpu_torch
    from khmer_tpu_torch import graph

    path = str(tmp_path / "reads.fa")
    _write_reads(path, 31, n_reads=300, repeats=5)
    _knot_fa(str(tmp_path / "knot.fa"))
    monkeypatch.setattr(graph, "TAG_BATCH", 7)
    out = []
    for d in (dev, "cpu"):
        g = getattr(khmer_tpu_torch, cls)(
            20, *((1, 1) if primes else (10007, 4)), primes=primes, device=d)
        with open(path) as f:
            seqs = f.read().split("\n")[1::2]
        for s in seqs[::10]:
            g.add_stop_tag(s[30:50])
        ret = [g.consume_seqfile_and_tag_with_stoptags(path),
               g.consume_seqfile_and_tag_with_stoptags(
                   str(tmp_path / "knot.fa"))]
        out.append((ret, list(g.all_tags), list(g.stop_tags),
                    list(g.partition.partition_map.items()),
                    bytes(g.storage.raw_bytes()), g.n_unique_kmers()))
    assert out[0] == out[1]


def test_knot_scripts_small_on_card(dev, tmp_path):
    """do-partition, load-graph, make-initial-stoptags, partition-graph
    --stoptags, find-knots and filter-stoptags on the card write the CPU
    run's bytes, and the stop tags are not empty."""
    import os

    from khmer_tpu_torch.scripts import (do_partition, filter_stoptags,
                                         find_knots, load_graph,
                                         make_initial_stoptags,
                                         partition_graph)

    _knot_fa(str(tmp_path / "knot.fa"))
    out = {}
    here = os.getcwd()
    kernels.reset_launches()
    for d in (dev, "cpu"):
        wd = tmp_path / str(d)
        wd.mkdir()
        os.chdir(str(wd))
        try:
            table = ["-k", "20", "-N", "4", "-x", "10007"]
            do_partition.main(table + ["-s", "20", "dp", "../knot.fa"],
                              device=d)
            load_graph.main(table + ["g", "../knot.fa"], device=d)
            make_initial_stoptags.main(["-k", "20", "-x", "10007", "g"],
                                       device=d)
            partition_graph.main(["--stoptags", "g.stoptags", "-s", "30",
                                  "g"], device=d)
            find_knots.main(["-x", "10007", "-N", "4", "g"], device=d)
            filter_stoptags.main(["-k", "20", "g.stoptags", "../knot.fa"],
                                 device=d)
        finally:
            os.chdir(here)
        out[str(d)] = {f: open(str(wd / f), "rb").read()
                       for f in sorted(os.listdir(str(wd)))}
        if d == dev:
            launches = dict(kernels.LAUNCHES)
    assert out[str(dev)] == out["cpu"]
    assert len(out["cpu"]["g.stoptags"]) > 18 + 8 * 20
    for name in ("hash2bit_canonical", "sketch_update", "sketch_get",
                 "bin_scatter_add"):
        assert launches[name], name


# slice 4c: the host count snapshot, the read aligner, labels and the
# sandbox scripts on the card


def _slice4c_reads(path, seed, n=300, genome_len=2000, names=None,
                   coding=False):
    """n reads of 100 bases over a random genome (of stop-free codons when
    `coding`), 0.5% substitutions, half reverse-complemented, named
    names(i) (default r<i>); returns the sequences."""
    rng = np.random.default_rng(seed)
    if coding:
        codons = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
                  if a + b + c not in ("TAA", "TAG", "TGA")]
        genome = "".join(codons[i] for i in
                         rng.integers(0, len(codons), genome_len // 3))
    else:
        genome = "".join("ACGT"[c] for c in rng.integers(0, 4, genome_len))
    seqs = []
    for i in range(n):
        s = int(rng.integers(0, len(genome) - 99))
        r = list(genome[s:s + 100])
        for p in np.nonzero(rng.random(100) < 0.005)[0]:
            r[p] = "ACGT"[int(rng.integers(4))]
        r = "".join(r)
        if rng.random() < 0.5:
            r = r[::-1].translate(str.maketrans("ACGT", "TGCA"))
        seqs.append(r)
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">%s\n%s\n" % (names(i) if names else "r%d" % i, s))
    return seqs


@pytest.mark.parametrize("cls", ["Countgraph", "Nodegraph"])
def test_snapshot_on_card(dev, tmp_path, cls):
    """host_counts equals get_batch on the card (capped, no loaded map)
    after each writer of the table, a snapshot taken before each."""
    import khmer_tpu_torch

    seqs = _slice4c_reads(str(tmp_path / "r.fa"), 41)
    g = getattr(khmer_tpu_torch, cls)(20, 20011, 4, device=dev)
    hashes = np.unique(np.concatenate(
        [np.asarray(g.get_kmer_hashes(s), np.uint64) for s in seqs]))
    pairs = [(seqs[i], seqs[i + 1]) for i in range(0, 200, 2)]
    other = getattr(khmer_tpu_torch, cls)(20, 20011, 4, device=dev)
    other.consume(seqs[250])
    writers = [
        lambda: [g.consume(s) for s in seqs[:50]],
        lambda: g.storage.add_batch(np.repeat(hashes[:20], 300)),
        lambda: g.consume_seqfile_and_tag(str(tmp_path / "r.fa")),
        lambda: g.diginorm_batch(pairs[:50], 5),
        lambda: g.trim_pass1_batch(pairs[50:], 3),
        lambda: g.storage.set_raw_bytes(other.storage.raw_bytes()),
        lambda: g.storage.replace_table(torch.ones_like(g.storage.table))]
    if cls == "Nodegraph":
        writers.append(lambda: g.update(other))
    for write in writers:
        g.storage.host_counts(hashes[:1])
        write()
        got = g.storage.host_counts(hashes)
        assert np.array_equal(got, g.storage.get_batch(hashes))


def test_read_aligner_on_card(dev, tmp_path):
    """align, align_forward and align_many against a card table equal the
    same calls against the CPU table, also after more adds."""
    from khmer_tpu_torch import Countgraph, ReadAligner

    seqs = _slice4c_reads(str(tmp_path / "r.fa"), 42, n=400)
    graphs = {d: Countgraph(20, 20011, 4, device=d) for d in (dev, "cpu")}
    out = {}
    for d, g in graphs.items():
        for s in seqs[:250]:
            g.consume(s)
        al = ReadAligner(g, 2, 1.0)
        got = [al.align(s) for s in seqs[250:300]]
        got += [al.align_forward(s) for s in seqs[250:300]]
        got += al.align_many(seqs[300:350])
        g.storage.add_batch(np.asarray(g.get_kmer_hashes(seqs[300]),
                                       np.uint64))
        got += [al.align(s) for s in seqs[350:]]
        out[str(d)] = got
    assert out[str(dev)] == out["cpu"]


@pytest.mark.parametrize("radius", [0, 5, None])
def test_batched_sweep_on_card(dev, tmp_path, radius):
    """sweep_label_neighborhood_batch on the card equals one sweep a read,
    and the CPU's, with stop tags and with the big-traversal abort."""
    from khmer_tpu_torch import GraphLabels

    fa = str(tmp_path / "ref.fa")
    seqs = _slice4c_reads(fa, 43, n=200,
                          names=lambda i: "r%d\t%d" % (i, i % 4))
    out = {}
    for d in (dev, "cpu"):
        gl = GraphLabels.NodeGraphLabels(21, 20011, 4, device=d)
        gl.consume_partitioned_fasta_and_tag_with_labels(fa)
        gl.graph.stop_tags = set(sorted(gl.graph.all_tags)[::5])
        got = []
        for stop in (False, True):
            for big in (False, True):
                batch = gl.sweep_label_neighborhood_batch(
                    seqs[:60] + ["ACGT"], radius, stop, big)
                assert batch == [gl.sweep_label_neighborhood(
                    s, radius, stop, big) for s in seqs[:60] + ["ACGT"]]
                got.append(batch)
        out[str(d)] = got
    assert out[str(dev)] == out["cpu"]


def test_slice4c_scripts_small_on_card(dev, tmp_path):
    """correct-reads, sweep-reads and assemble-on-the-go (its Countgraph
    cut to 4 x 20011 bins) on the card write the CPU run's bytes."""
    import contextlib
    import io
    import os
    from unittest import mock

    from khmer_tpu_torch import Countgraph
    from khmer_tpu_torch.sandbox import (assemble_on_the_go, correct_reads,
                                         sweep_reads)

    _slice4c_reads(str(tmp_path / "pairs.fa"), 44, n=600,
                   names=lambda i: "p%d/%d" % (i // 2, 1 + i % 2))
    _slice4c_reads(str(tmp_path / "ref.fa"), 45, n=150,
                   names=lambda i: "r%d\t%d" % (i, i % 3))
    _slice4c_reads(str(tmp_path / "reads.fa"), 45, n=60)
    _slice4c_reads(str(tmp_path / "coding.fa"), 46, n=180, genome_len=450,
                   coding=True)
    runs = [(correct_reads, ["-k", "20", "-N", "4", "-x", "2e4", "-Z", "10",
                             "../pairs.fa"]),
            (sweep_reads, ["--label-by-pid", "-N", "1", "--outdir", ".",
                           "../ref.fa", "../reads.fa"]),
            (assemble_on_the_go, ["../coding.fa"])]
    small = mock.patch.object(assemble_on_the_go, "Countgraph",
                              lambda k, size, n, **kw: Countgraph(
                                  k, 20011, n, **kw))
    out = {}
    here = os.getcwd()
    for d in (dev, "cpu"):
        wd = tmp_path / str(d)
        wd.mkdir()
        os.chdir(str(wd))
        stdout = io.StringIO()
        try:
            with small, contextlib.redirect_stdout(stdout), \
                    contextlib.redirect_stderr(io.StringIO()):
                for module, argv in runs:
                    module.main(argv, device=d)
        finally:
            os.chdir(here)
        out[str(d)] = (stdout.getvalue(),
                       {f: open(str(wd / f), "rb").read()
                        for f in sorted(os.listdir(str(wd)))})
    assert out[str(dev)] == out["cpu"]
    assert "pairs.fa.corr" in out["cpu"][1] and ">orf" in out["cpu"][0]


# -- K13 count_nonzero and K14 pack_oxli_bytes --------------------------------


def _bins(rng, n, density, big=False):
    """n u32 bins (int32 patterns): a share `density` nonzero, values up
    to 2**32 - 1 with big, else below 300."""
    vals = rng.integers(1, 2 ** 32 if big else 300, n, dtype=np.uint64)
    vals[rng.random(n) >= density] = 0
    return torch.from_numpy(vals.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("begin,end", [(0, 0), (5, 5), (0, 1), (3, 4100),
                                       (4096, 1000003), (0, (1 << 24) + 6)])
def test_count_nonzero(dev, begin, end, density):
    rng = np.random.default_rng(end)
    table = _bins(rng, (1 << 24) + 6, density, big=True)
    kernels.reset_launches()
    got = kernels.count_nonzero(table.to(dev), begin, end)
    assert got.dtype == torch.int64 and got.shape == (1,)
    assert int(got) == int(plain.count_nonzero(table, begin, end))
    assert kernels.LAUNCHES["count_nonzero"] == (1 if end > begin else 0)


def test_count_nonzero_one_bin(dev):
    """One nonzero bin (2**32 - 1) at each tile edge is counted once."""
    for at in (0, 1, 4095, 4096, 99999):
        table = torch.zeros(100001, dtype=torch.int32)
        table[at] = -1  # 2**32 - 1
        assert int(kernels.count_nonzero(table.to(dev), 0, 100000)) == 1


def test_count_nonzero_refuses(dev):
    t = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.count_nonzero(t, 0, 11)
    with pytest.raises(ValueError):
        kernels.count_nonzero(t, 4, 3)


PACK_SIZES = [(1,), (7,), (8,), (9,), (1009, 1013, 1019), (16,) * 32,
              ((1 << 24) + 3, 101)]


@pytest.mark.parametrize("big", [False, True], ids=["small", "ge2^31"])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("sizes", PACK_SIZES, ids=lambda s: "x".join(
    map(str, s[:3])) + ("..." if len(s) > 3 else ""))
@pytest.mark.parametrize("kind", ["byte", "nibble", "bit"])
def test_pack_oxli_bytes(dev, kind, sizes, density, big):
    rng = np.random.default_rng(len(sizes) + int(10 * density))
    spec = SketchSpec(kind, sizes)
    table = _bins(rng, spec.total_bins + 1, density, big)
    geom = [g.to(dev) for g in spec.geometry("cpu")[:2]]
    kernels.reset_launches()
    got = kernels.pack_oxli_bytes(table.to(dev), kind, *geom,
                                  spec.bytes_per_table)
    want = plain.pack_oxli_bytes(table, kind, *spec.geometry("cpu")[:2],
                                 spec.bytes_per_table)
    assert got.dtype == torch.uint8 and got.numel() == spec.total_bytes
    assert torch.equal(got.cpu(), want)
    assert kernels.LAUNCHES["pack_oxli_bytes"] == 1


@pytest.mark.parametrize("kind", ["byte", "nibble", "bit"])
@pytest.mark.parametrize("density", [1e-4, 0.5])
def test_raw_bytes_routes_on_card(dev, kind, density):
    """Storage.raw_bytes on the card equals the CPU's, through K14, with
    its nonzero bins on each side of khmer_tpu's sparse threshold."""
    from khmer_tpu_torch.convert import storage_from_numpy

    sizes = (100003, 100019, 100043)
    rng = np.random.default_rng(int(density * 1e4))
    bins = _bins(rng, sum(sizes) + 1, density, big=True).numpy()
    bins[-1] = 0
    raw = {}
    for d in ("cpu", dev):
        st = storage_from_numpy(kind, sizes, bins.view(np.uint32), device=d)
        kernels.reset_launches()
        raw[str(d)] = st.raw_bytes()
    assert np.array_equal(raw["cpu"], raw[str(dev)])
    assert kernels.LAUNCHES["pack_oxli_bytes"] == 1


# ---------------------------------------------------------------------------
# slice 7a: K15 band_route, K16 combine_lanes, K17 claim_news, K3t
# sketch_get_tables and K10's split, and the sharded consume on the card
# ---------------------------------------------------------------------------


def _route_lanes(case, n=5000, seed=0):
    """(hash, weight, first) lanes: random; empty; all dead; every lane
    one key (one owner); a hot key on half the lanes."""
    rng = np.random.default_rng(seed)
    if case == "empty":
        n = 0
    h = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
    w = rng.integers(1, 5, n).astype(np.uint32)
    w[rng.random(n) < 0.1] = 0
    f = rng.permutation(n).astype(np.uint32)
    if case == "dead":
        h[:] = 2 ** 64 - 1
        w[:] = 0
    elif case == "one_key":
        h[:] = h[0] if n else 0
    elif case == "hot":
        h[::2] = 0
    return (_u64.as_tensor(h, "cpu"), torch.from_numpy(w.view(np.int32)),
            torch.from_numpy(f.view(np.int32)))


ROUTE_CASES = ["random", "empty", "dead", "one_key", "hot"]


@pytest.mark.parametrize("ns,cap", [(1, 64), (1, 7000), (4, 1400), (4, 3),
                                    (8, 700), (256, 30)])
@pytest.mark.parametrize("case", ROUTE_CASES)
def test_band_route(dev, case, ns, cap):
    """Every output (send and leftover buffers, n_left) equals the plain
    version's stable placement bit for bit, over tiles of 2048 lanes."""
    lanes = _route_lanes(case)
    kernels.reset_launches()
    got = kernels.band_route(*(t.to(dev) for t in lanes), ns, cap)
    torch.cuda.synchronize()
    want = plain.band_route(*lanes, ns, cap)
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)
    if lanes[0].numel():
        assert kernels.LAUNCHES["band_route"] == 3


@pytest.mark.parametrize("n", [0, 1, 31, 33, 5000, (1 << 20) + 7])
@pytest.mark.parametrize("case", ["random", "dead", "one_key", "hot"])
def test_combine_lanes(dev, case, n):
    """The distinct keys, totals (weights near the 2**20 clamp, sums that
    wrap mod 2**32) and first positions equal the plain version's after
    a sort by key; n_valid equal; the tail dead."""
    rng = np.random.default_rng(n)
    h, _, f = _route_lanes(case, n, seed=n)
    if case == "random":
        h = h[torch.from_numpy(rng.integers(0, max(n // 3, 1), n))]
    w = torch.from_numpy(rng.choice(np.array(
        [0, 1, 7, (1 << 20) - 1, 1 << 20, (1 << 21) + 3, (1 << 32) - 1],
        np.uint32), n).view(np.int32))
    kernels.reset_launches()
    gk, gw, gf, gn = kernels.combine_lanes(h.to(dev), w.to(dev), f.to(dev))
    torch.cuda.synchronize()
    pk, pw, pf, pn = plain.combine_lanes(h, w, f)
    m = int(pn)
    assert int(gn) == m
    gk, gw, gf = gk.cpu(), gw.cpu(), gf.cpu()
    order = torch.sort(_u64.sort_key(gk[:m]), stable=True)[1]
    for g, x in zip((gk, gw, gf), (pk, pw, pf)):
        assert torch.equal(g[:m][order], x[:m])
        assert torch.equal(g[m:], x[m:])
    assert kernels.LAUNCHES["combine_lanes"] == (2 if n else 0)


@pytest.mark.parametrize("virgin", [True, False])
@pytest.mark.parametrize("sizes", [(1009,), (1009, 1013, 1019), (16,) * 32])
@pytest.mark.parametrize("case", ["random", "empty", "dead", "one_key"])
def test_claim_news(dev, case, sizes, virgin):
    """K17 (a) over two shards' lanes into one claim array each, the
    unsigned min of the two, then (b): the claims and the count equal
    the plain version's."""
    spec = SketchSpec("byte", sizes)
    geom = [g.to(dev) for g in spec.geometry("cpu")]
    rng = np.random.default_rng(len(sizes))
    base = _table(rng, sizes, 3) if not virgin else None
    shards = [_route_lanes(case, 3000, seed=s) for s in range(2)]
    out = {}
    for side, fns, d, g in (("card", kernels, dev, geom),
                            ("plain", plain, "cpu",
                             spec.geometry("cpu"))):
        claims = []
        for k, w, f in shards:
            c = torch.full((spec.total_bins + 1,), -1, dtype=torch.int32,
                           device=d)
            fns.claim_scatter(k.to(d), w.to(d), f.to(d), *g, c)
            claims.append(c)
        c = (claims[0] ^ -(1 << 31)).minimum(claims[1] ^ -(1 << 31)) ^ \
            -(1 << 31)
        n_new = torch.zeros(1, dtype=torch.int64, device=d)
        for k, w, f in shards:
            fns.claim_count(k.to(d), w.to(d), f.to(d), *g, c,
                            None if base is None else base.to(d), n_new)
        out[side] = (c.cpu(), int(n_new))
    assert torch.equal(out["card"][0], out["plain"][0])
    assert out["card"][1] == out["plain"][1]


# table counts of K3t's and K20's edges: the four template widths, the
# first runtime one and khmer's most
GATHER_TABLES = [1, 2, 3, 4, 5, 32]


def _gather_keys(rng, n, edges=()):
    """n uint64 keys: `edges` first, then 2**64 - 1, then random ones."""
    keys = list(edges) + [2 ** 64 - 1] + \
        rng.integers(0, 2 ** 64, max(n, 1), dtype=np.uint64).tolist()
    return np.array(keys[:n], np.uint64)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 257, 100003, 100004])
@pytest.mark.parametrize("T", GATHER_TABLES)
def test_sketch_get_tables(dev, T, n, offset):
    """K3t equals its plain version bit for bit with one launch a call: a
    ragged last quad of keys (n % 4 != 0; no 16-byte stores), the hashes
    as a view 8 bytes into their buffer (offset 1: no 16-byte loads), 2**64
    - 1 among them, and T from 1 to 32 (the template widths and the
    loop)."""
    rng = np.random.default_rng(n * 64 + T * 2 + offset)
    sizes = tuple(get_n_primes_near_x(T, 1000))
    spec = SketchSpec("byte", sizes)
    table = _table(rng, sizes, 2 ** 32)
    h = _u64.as_tensor(_gather_keys(rng, n + offset), "cpu")
    kernels.reset_launches()
    got = kernels.sketch_get_tables(table.to(dev), h.to(dev)[offset:],
                                    *spec.geometry(dev))
    want = plain.sketch_get_tables(table, h[offset:], *spec.geometry("cpu"))
    assert got.shape == (T, n)
    assert torch.equal(got.cpu(), want)
    assert kernels.LAUNCHES["sketch_get_tables"] == (1 if n else 0)


@pytest.mark.parametrize("case", ["one_node", "padding", "star", "path",
                                  "duplicates", "random"])
def test_cc_relax_jump(dev, case):
    """Three rounds of K10's relax and jump entry points equal the plain
    versions' and cc_rounds' labels and changed flag."""
    T, src, dst = _cc_graph(case)
    s, d = _as_i32(src, dev), _as_i32(dst, dev)
    lab = torch.arange(T, dtype=torch.int32, device=dev)
    want = torch.arange(T, dtype=torch.int32)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    w_changed = torch.zeros(1, dtype=torch.int32)
    kernels.reset_launches()
    for _ in range(3):
        m = kernels.cc_relax(lab, s, d)
        pm = plain.cc_relax(want, _as_i32(src), _as_i32(dst))
        assert torch.equal(m.cpu(), pm)
        lab = kernels.cc_jump(m, lab, changed)
        want = plain.cc_jump(pm, want, w_changed)
        assert torch.equal(lab.cpu(), want)
    torch.cuda.synchronize()
    rounds, r_changed = plain.cc_rounds(torch.arange(T, dtype=torch.int32),
                                        _as_i32(src), _as_i32(dst), 3)
    assert torch.equal(lab.cpu(), rounds)
    assert bool(changed.item()) == bool(w_changed.item()) == bool(r_changed)
    assert kernels.LAUNCHES["cc_relax"] == kernels.LAUNCHES["cc_jump"] == 6


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_consume_on_card(dev, tmp_path, shards):
    """consume_seqfile over `shards` in-process shards on the card (a
    poly-A read past 255) equals the serial consume on the card: table,
    n_unique, n_consumed and bigcounts; K15, K16 and K17 launched."""
    from khmer_tpu_torch.parallel import sharded

    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, 5)
    # tables wide enough that no bin passes 255 by collisions (the
    # sharded consume's bigcount candidates are the k-mers whose own
    # count passes 255, as in khmer_tpu)
    primes = get_n_primes_near_x(3, 1_000_000)
    serial = Countgraph(20, primes=primes, device=dev)
    serial.set_use_bigcount(True)
    want = serial.consume_seqfile(fa)
    g = Countgraph(20, primes=primes, device=dev)
    g.set_use_bigcount(True)
    kernels.reset_launches()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sharded, "default_devices",
                   lambda device=None: [torch.device(dev)] * shards)
        mp.setenv("KHMER_TPU_SHARDED", "1")
        got = g.consume_seqfile(fa, chunk=1 << 14)
    finally:
        mp.undo()
    assert got == want
    assert torch.equal(g.storage.table, serial.storage.table)
    assert g.n_unique_kmers() == serial.n_unique_kmers()
    assert g.storage.resolved_bigcounts() == \
        serial.storage.resolved_bigcounts()
    for name in ("band_route", "combine_lanes", "claim_scatter",
                 "claim_count", "bin_scatter_add", "hash2bit_canonical"):
        assert kernels.LAUNCHES[name] > 0, name


def test_mesh_across_cards(tmp_path):
    """With two cards or more: the sharded consume over one in-process
    shard a card, and distributed_count over one NCCL process a card
    (tests/torch_mp_worker.py, one file, so that the other processes
    idle), each equal to the serial consume on the first card (table,
    n_unique, n_consumed and, for the processes, the query of the
    bigcount candidates)."""
    import os
    import socket
    import subprocess
    import sys

    from khmer_tpu_torch.native import NativeChunkReader
    from khmer_tpu_torch.parallel import ShardedDeferredConsumer, make_mesh

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    n = torch.cuda.device_count()
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, 7, n_reads=3000)
    primes = get_n_primes_near_x(3, 100000)
    serial = Countgraph(20, primes=primes, device="cuda:0")
    serial.set_use_bigcount(True)
    _, n_consumed = serial.consume_seqfile(fa)
    table = serial.storage.table
    spec = serial.storage.spec
    mesh = make_mesh([torch.device("cuda", i) for i in range(n)])
    c = ShardedDeferredConsumer(spec, 20, "2bit", mesh=mesh, chunk=4096,
                                from_codes=True, use_bigcount=True)
    with NativeChunkReader(fa, 20, 4096) as reader:
        for codes, mask in reader:
            c.add_chunk(codes, mask)
    delta, n_unique, n_cons, _ = c.finish(virgin=True)
    assert torch.equal(delta.to("cuda:0"), table)
    assert (n_unique, n_cons) == (serial.n_unique_kmers(), n_consumed)
    worker = os.path.join(os.path.dirname(__file__), "torch_mp_worker.py")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, worker, port, str(pid),
                               str(n), fa, str(tmp_path), "nccl"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for pid in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=240), p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (out, err), rc in outs:
        assert rc == 0, err[-3000:]
    got = np.load(str(tmp_path / "result.npz"))
    assert str(got["backend"]) == "nccl" and int(got["shards"]) == n
    assert np.array_equal(got["table"], table.cpu().numpy().view(np.uint32))
    assert int(got["uniq"]) == serial.n_unique_kmers()
    assert int(got["consumed"]) == n_consumed
    want = serial.storage.get_lanes(_u64.as_tensor(got["probe"], "cuda:0"),
                                    65535).cpu().numpy()
    assert np.array_equal(got["counts"], want)


# ---------------------------------------------------------------------------
# slice 15: K18 owned_claims, K19 owned_add, K20 owned_get, and the
# bin-sharded table's consume on the card
# ---------------------------------------------------------------------------


def _piece_lanes(case, spec, bounds, n=6000, seed=0):
    """Distinct-or-not (key, total, first) lanes for the piece kernels:
    random; empty; all dead; a hot key on half the lanes; and keys whose
    table-t bins fall on every piece's first and last bins and on the last
    table's last bin."""
    rng = np.random.default_rng(seed)
    if case == "empty":
        n = 0
    h = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
    w = rng.choice(np.array([0, 1, 3, 200, 300, (1 << 32) - 1], np.uint32),
                   n)
    f = rng.permutation(n).astype(np.uint32) * np.uint32(7)
    if case == "dead":
        h[::2] = 2 ** 64 - 1
        w[1::2] = 0
    elif case == "hot":
        h[::2] = h[0]
    elif case == "edges":
        sizes, offs = spec.tablesizes, spec.bin_offsets
        edges = [g for lo, hi in bounds for g in (lo, hi - 1)] + \
            [spec.total_bins - 1]
        j = 0
        for g in edges:
            for t, (p, o) in enumerate(zip(sizes, offs)):
                if o <= g < o + p and j < n:
                    h[j] = np.uint64(g - o) + np.uint64(p) * \
                        np.uint64(rng.integers(0, 2 ** 40))
                    w[j] = 1 + j % 3
                    j += 1
    return (_u64.as_tensor(h, "cpu"), torch.from_numpy(w.view(np.int32)),
            torch.from_numpy(f.view(np.int32)))


PIECE_CASES = ["random", "empty", "dead", "hot", "edges"]


def _pieces(spec, S, seed):
    """A random u32 table of spec's bins and its spare bin (about half
    zero) cut into S pieces as Storage.shard_table cuts it."""
    from khmer_tpu_torch.storage import piece_bounds

    n = spec.total_bins + 1
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 400, n).astype(np.uint32)
    t[rng.random(t.size) < 0.5] = 0
    t[-1] = 0
    t = torch.from_numpy(t.view(np.int32))
    bounds = piece_bounds(spec, n, S)
    return [t[lo:hi].clone() for lo, hi in bounds], bounds


@pytest.mark.parametrize("virgin", [True, False])
@pytest.mark.parametrize("sizes", [(100003,), (1009, 1013, 1019, 1021)])
@pytest.mark.parametrize("case", PIECE_CASES)
def test_owned_kernels(dev, case, sizes, virgin):
    """K18 (flags, candidates as a set and their count, the piece left as
    it was), K19 (the piece after) and K20 (the minima) on each of three
    pieces equal the plain versions', at T = 1 and 4, with the pieces'
    edge bins and the last table's last bin hit."""
    spec = SketchSpec("byte", sizes)
    pieces, bounds = _pieces(spec, 3, seed=len(sizes))
    if virgin:
        pieces = [torch.zeros_like(p) for p in pieces]
    k, w, f = _piece_lanes(case, spec, bounds, seed=len(case))
    g_cpu, g_dev = spec.geometry("cpu"), spec.geometry(dev)
    kd, wd, fd = k.to(dev), w.to(dev), f.to(dev)
    n = k.numel()
    for piece, (lo, _) in zip(pieces, bounds):
        kernels.reset_launches()
        out = {}
        for side, fns, args, p, g in (
                ("kernel", kernels, (kd, wd, fd), piece.clone().to(dev),
                 g_dev),
                ("plain", plain, (k, w, f), piece.clone(), g_cpu)):
            d = args[0].device
            flags = torch.zeros(n, dtype=torch.int32, device=d)
            cand = torch.zeros(64, dtype=torch.int64, device=d)
            count = torch.zeros(1, dtype=torch.int32, device=d)
            fns.owned_claims(*args, p, lo, *g, flags, virgin, cand, count)
            before = p.clone()
            fns.owned_add(args[0], args[1], p, lo, *g)
            got = fns.owned_get(args[0], p, lo, *g)
            m = min(int(count), 64)
            out[side] = (flags.cpu(), set(cand[:m].cpu().tolist()),
                         int(count), before.cpu(), p.cpu(), got.cpu())
        torch.cuda.synchronize()
        kf, kc, kn, kb, kp, kg = out["kernel"]
        pf, pc, pn, pb, pp, pg = out["plain"]
        assert torch.equal(kf, pf) and kn == pn and torch.equal(kg, pg)
        assert torch.equal(kb, piece) and torch.equal(kp, pp)
        if pn <= 64:
            assert kc == pc
        if n:
            assert kernels.LAUNCHES["owned_claims"] == 2
            assert kernels.LAUNCHES["owned_add"] == 1
            assert kernels.LAUNCHES["owned_get"] == 1


@pytest.mark.parametrize("kind", ["byte", "nibble", "bit"])
def test_binshard_raw_bytes_on_card(dev, kind):
    """raw_bytes of a 4-piece table of each kind equals the whole
    table's: K14 packs each piece on the card in the table's kind, one
    launch a piece."""
    from khmer_tpu_torch.graph import SmallCountgraph
    from khmer_tpu_torch.parallel import make_mesh

    cls = {"byte": Countgraph, "nibble": SmallCountgraph,
           "bit": Nodegraph}[kind]
    rng = np.random.default_rng(3)
    primes = get_n_primes_near_x(4, 100_000)
    keys = rng.integers(0, 1 << 62, 200_000).astype(np.uint64)
    weights = rng.integers(1, 300, keys.size).astype(np.uint32)
    whole = cls(20, primes=primes, device=dev)
    whole.storage.add_batch(keys, weights)
    g = cls(20, primes=primes, device=dev)
    g.storage.shard_table(make_mesh([torch.device("cuda", 0)] * 4))
    g.storage.add_batch(keys, weights)
    want = whole.storage.raw_bytes()
    kernels.reset_launches()
    assert np.array_equal(g.storage.raw_bytes(), want)
    assert kernels.LAUNCHES["pack_oxli_bytes"] == 4


def _binshard_devices(which):
    if which == "cuda:0" or torch.cuda.device_count() < 4:
        return [torch.device("cuda", 0)] * 4
    return [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("which", ["cuda:0", "cuda:0-3"])
def test_binshard_consume_on_card(dev, tmp_path, which):
    """consume_seqfile into a 4-piece Countgraph (on cuda:0 four times, and
    on four cards where the machine has them) equals the serial K2 consume
    on the card: return, table bytes, n_unique, n_occupied, counts and
    the bigcount section; K18-K20 launched; and so does tagging into a
    4-piece Nodegraph (tags, table, n_unique)."""
    from khmer_tpu_torch.parallel import make_mesh

    if which == "cuda:0-3" and torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, 11)
    primes = get_n_primes_near_x(4, 1_000_000)
    serial = Countgraph(20, primes=primes, device=dev)
    serial.set_use_bigcount(True)
    want = serial.consume_seqfile(fa)
    g = Countgraph(20, primes=primes, device=dev)
    g.set_use_bigcount(True)
    mesh = make_mesh(_binshard_devices(which))
    lay = g.storage.shard_table(mesh)
    assert [p.device for p in lay.pieces] == list(mesh.devices)
    kernels.reset_launches()
    assert g.consume_seqfile(fa, chunk=1 << 14) == want
    probe = serial.storage._take_snapshot()
    assert np.array_equal(g.storage.host_table(), probe)
    assert np.array_equal(g.storage.raw_bytes(), serial.storage.raw_bytes())
    assert g.n_unique_kmers() == serial.n_unique_kmers()
    assert g.n_occupied() == serial.n_occupied()
    assert g.storage.resolved_bigcounts() == \
        serial.storage.resolved_bigcounts()
    h = _u64.as_tensor(np.random.default_rng(1).integers(
        0, 2 ** 64, 5000, dtype=np.uint64), dev)
    assert torch.equal(g.storage.get_lanes(h, 65535),
                       serial.storage.get_lanes(h, 65535))
    for name in ("owned_claims", "owned_add", "owned_get", "combine_lanes",
                 "hash2bit_canonical"):
        assert kernels.LAUNCHES[name] > 0, name
    a = Nodegraph(20, primes=primes, device=dev)
    b = Nodegraph(20, primes=primes, device=dev)
    b.storage.shard_table(make_mesh(_binshard_devices(which)))
    assert a.consume_seqfile_and_tag(fa) == b.consume_seqfile_and_tag(fa)
    assert a.all_tags == b.all_tags
    assert np.array_equal(a.storage.raw_bytes(), b.storage.raw_bytes())


def _k20_bounds(spec):
    """Pieces of spec's bins and its spare bin that cut table 0 in its
    middle, the last table 7 bins in, and the spare bin off (a piece that
    holds no table's bin), with an empty piece at table 0's cut."""
    mid = spec.bin_offsets[0] + spec.tablesizes[0] // 2
    total = spec.total_bins + 1
    cuts = sorted([0, mid, mid, spec.bin_offsets[-1] + 7, total - 1, total])
    return list(zip(cuts[:-1], cuts[1:]))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1001, 4099])
@pytest.mark.parametrize("T", GATHER_TABLES)
def test_owned_get_edges(dev, T, n, offset):
    """K20 equals its plain version bit for bit with one launch a call on
    pieces that cut a table mid-range, hold several whole tables, hold no
    table (the spare bin alone) or nothing, with keys whose bins are each
    piece's first and last bin first, then 2**64 - 1; bins past 2**31
    (the min is unsigned); ragged quads (n % 4 != 0) and the keys as a
    view 8 bytes into their buffer (offset 1)."""
    rng = np.random.default_rng(n * 64 + T * 2 + offset)
    spec = SketchSpec("byte", tuple(get_n_primes_near_x(T, 1000)))
    bounds = _k20_bounds(spec)
    table = _table(rng, spec.tablesizes, 2 ** 32)
    edges = []
    for g in [b for lo, hi in bounds if hi > lo for b in (lo, hi - 1)]:
        for p, off in zip(spec.tablesizes, spec.bin_offsets):
            if off <= g < off + p:
                edges.append((g - off) + p * int(rng.integers(1, 1 << 40)))
    h = _u64.as_tensor(_gather_keys(rng, n + offset, edges), "cpu")
    hd = h.to(dev)[offset:]
    g_cpu, g_dev = spec.geometry("cpu"), spec.geometry(dev)
    for lo, hi in bounds:
        piece = table[lo:hi].clone()
        kernels.reset_launches()
        got = kernels.owned_get(hd, piece.to(dev), lo, *g_dev)
        want = plain.owned_get(h[offset:], piece, lo, *g_cpu)
        assert torch.equal(got.cpu(), want), (lo, hi)
        assert kernels.LAUNCHES["owned_get"] == (1 if n else 0)

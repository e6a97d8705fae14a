"""Each CUDA kernel of khmer_tpu_torch against its plain PyTorch version
on the card, at small sizes and edge cases that chip_smoke.py does not
reach (empty and ragged inputs, one table, weights >= 2**31, hashes >=
2**63, a candidate buffer that overflows).  Integer data: exact
equality.  Marked `cuda`: they skip without a CUDA device and run on
the card with `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (the suite's conftest imports jax, which the
port does not need, and this module imports nothing of it)."""

import numpy as np
import pytest
import torch

from khmer_tpu_torch import Countgraph, Nodegraph, _u64, kernels
from khmer_tpu_torch.kernels import plain
from khmer_tpu_torch.ops.sketch_ops import (SketchSpec, alloc_claim,
                                            unpack_oxli_bytes)
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


@pytest.mark.parametrize("n", [0, 1, 19, 20, 257, 5000])
@pytest.mark.parametrize("k", [1, 20, 32])
def test_hash2bit_canonical(dev, n, k):
    rng = np.random.default_rng(n * 100 + k)
    codes = torch.from_numpy(rng.integers(0, 4, n, dtype=np.uint8))
    mask = torch.from_numpy((rng.random(n) < 0.8).astype(np.uint8))
    h, w = kernels.hash2bit_canonical(codes.to(dev), mask.to(dev), k)
    ph, pw = plain.hash2bit_canonical(codes, mask, k)
    assert torch.equal(h.cpu(), ph) and torch.equal(w.cpu(), pw)


@pytest.mark.parametrize("sizes", [SIZES[:1], SIZES])
@pytest.mark.parametrize("cap", [16, 1 << 16])
def test_sketch_update(dev, sizes, cap):
    rng = np.random.default_rng(len(sizes) + cap)
    spec = SketchSpec("byte", sizes)
    geom = [torch.tensor(x) for x in (spec.tablesizes, spec.bin_offsets)]
    table = _table(rng, sizes, 300)
    hashes = _u64.as_tensor(_hashes(rng, 3001, 700), "cpu")
    weights = torch.from_numpy(
        rng.choice(np.array([0, 1, 2, 2 ** 31 + 5], np.uint32), 3001,
                   p=[0.2, 0.6, 0.19, 0.01]).view(np.int32))
    out = {}
    for side, d in (("kernel", dev), ("plain", torch.device("cpu"))):
        t = table.clone().to(d)
        claim = alloc_claim(spec, d)
        nu = torch.zeros(1, dtype=torch.int64, device=d)
        cand = torch.zeros(cap, dtype=torch.int64, device=d)
        cnt = torch.zeros(1, dtype=torch.int32, device=d)
        fn = kernels.sketch_update if side == "kernel" else \
            plain.sketch_update
        is_new = fn(t, claim, hashes.to(d), weights.to(d),
                    geom[0].to(d), geom[1].to(d), nu, cand, cnt)
        assert bool((claim == plain.CLAIM_FREE).all())
        c = int(cnt)
        out[side] = [x.cpu() for x in (t, nu, is_new, cnt)]
        out[side].append(
            torch.sort(cand[:c]).values.cpu() if c <= cap else None)
    for a, b in zip(out["kernel"], out["plain"]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int(out["kernel"][3]) > 0


@pytest.mark.parametrize("cap", [1, 255, 65535])
def test_sketch_get(dev, cap):
    rng = np.random.default_rng(cap)
    table = _table(rng, SIZES, 2 ** 32)
    hashes = _u64.as_tensor(_hashes(rng, 777, 500), "cpu")
    geom = [torch.tensor(x) for x in (SIZES, SketchSpec("byte", SIZES)
                                      .bin_offsets)]
    got = kernels.sketch_get(table.to(dev), hashes.to(dev),
                             geom[0].to(dev), geom[1].to(dev), cap)
    assert torch.equal(got.cpu(), plain.sketch_get(table, hashes, *geom,
                                                   cap))


def test_abund_hist(dev):
    rng = np.random.default_rng(4)
    table = _table(rng, SIZES, 400)
    keys = torch.sort(_u64.as_tensor(_hashes(rng, 4000, 900), "cpu")).values
    geom = [torch.tensor(x) for x in (SIZES, SketchSpec("byte", SIZES)
                                      .bin_offsets)]
    hk = torch.zeros(65536, dtype=torch.int64, device=dev)
    hp = torch.zeros(65536, dtype=torch.int64)
    kernels.abund_hist(keys.to(dev), table.to(dev), geom[0].to(dev),
                       geom[1].to(dev), 255, hk)
    plain.abund_hist(keys, table, *geom, 255, hp)
    assert torch.equal(hk.cpu(), hp) and int(hp[0]) > 0


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


@pytest.mark.parametrize("kind", ["byte", "bit"])
def test_unpack_oxli_bytes_on_card(dev, kind):
    """The .ct load's widening on the card equals the CPU's."""
    rng = np.random.default_rng(8)
    spec = SketchSpec(kind, SIZES)
    data = rng.integers(0, 256, spec.total_bytes, dtype=np.uint8)
    data[rng.random(data.size) < 0.7] = 0
    before = kernels.LAUNCHES["bin_scatter_add"]
    got = unpack_oxli_bytes(spec, data, dev)
    assert kernels.LAUNCHES["bin_scatter_add"] == before + 1
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

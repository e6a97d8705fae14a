"""Port parity of the sharded consume, query and CC
(khmer_tpu_torch.parallel): khmer_tpu on the conftest's 8 virtual CPU
devices, the port on in-process CPU shards of the same mesh shape.

* band_owner against khmer_tpu's for 1, 3, 4 and 8 shards, on random
  hashes and on hashes whose mixed image sits at the band edges.
* K15's plain version (kernels.band_route on the CPU) with a tiny room a
  destination, drained round after round until nothing is left.
* combine_lanes and combine_unit_lanes against khmer_tpu's, as sets
  sorted by key, with weights near 2**20 and positions near 2**32.
* The claims (K17 around an all-reduce min) against khmer_tpu's
  make_claims_step, on a virgin table and against a base.
* ShardedDeferredConsumer at shapes (1, 4) and (2, 2) against khmer_tpu's
  on the same chunks: delta table, n_unique (and the reference's
  sequential n_unique), n_consumed, bigcount candidates and query
  counts, on a virgin table and against a base.
* consume_seqfile's sharded dispatch against the port's serial consume
  and khmer_tpu's sharded one: a Countgraph, a poly-A file with bigcount
  and a Nodegraph's raw bytes.
* The sharded CC labels against khmer_tpu's, and do_partition_device(
  mesh=) against khmer_tpu's.
* The mesh's sum mod 2**32 against khmer_tpu's merge, and the device
  and backend rules of the multi-process entry points.

One table geometry (3 x ~10,000 bins) at k = 20.  Integer data
throughout: exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import khmer_tpu
from khmer_tpu.ops import deferred as jax_dfr
from khmer_tpu.ops.sketch_ops import SketchSpec as JaxSpec
from khmer_tpu.parallel import sharded as jax_sharded
from khmer_tpu.partition_device import \
    connected_components_sharded as jax_cc_sharded
from khmer_tpu.partitioning import SubsetPartition as JaxSubsetPartition
from khmer_tpu_torch import Countgraph, Nodegraph, _u64, convert, kernels
from khmer_tpu_torch.kernels import plain
from khmer_tpu_torch.ops import deferred as dfr
from khmer_tpu_torch.ops.sketch_ops import SketchSpec
from khmer_tpu_torch.parallel import (ShardedDeferredConsumer, band_owner,
                                      make_mesh, make_sharded_query,
                                      merge_tables_saturating, multihost,
                                      sharded)
from khmer_tpu_torch.partition_device import connected_components_sharded
from khmer_tpu_torch.partitioning import SubsetPartition
from khmer_tpu_torch.primes import get_n_primes_near_x

from .test_parallel import _ref_n_unique
from .test_torch_partition import write_metagenome

K = 20
CHUNK = 256
PRIMES = tuple(get_n_primes_near_x(3, 10_000))
U64_MAX = (1 << 64) - 1


def _jax_mesh(D, S):
    return jax_sharded.make_mesh(jax.devices()[:D * S], data=D)


def _unfmix(x):
    """The inverse of fmix64 on uint64 numpy values."""
    x = np.asarray(x, np.uint64).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= np.uint64(pow(0xC4CEB9FE1A85EC53, -1, 1 << 64))
        x ^= x >> np.uint64(33)
        x *= np.uint64(pow(0xFF51AFD7ED558CCD, -1, 1 << 64))
        x ^= x >> np.uint64(33)
    return x


# ---------------------------------------------------------------------------
# band_owner and K15
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ns", [1, 3, 4, 8])
def test_band_owner_matches_khmer_tpu(ns):
    rng = np.random.default_rng(ns)
    band = U64_MAX // ns
    edges = [0, U64_MAX, U64_MAX - 1, ns * band, ns * band - 1]
    for s in range(1, ns + 1):
        edges += [s * band - 1, s * band, min(s * band + 1, U64_MAX)]
    mixed = np.array(edges, np.uint64)
    h = np.concatenate([_unfmix(mixed),
                        rng.integers(0, 1 << 64, 4000, dtype=np.uint64),
                        np.arange(64, dtype=np.uint64)])
    want = np.asarray(jax_sharded.band_owner(jnp.asarray(h), ns))
    got = band_owner(h, ns).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() <= ns - 1


def _lanes(rng, n, distinct, zero_share=0.1):
    keys = rng.integers(0, 1 << 64, distinct, dtype=np.uint64)
    h = keys[rng.integers(0, distinct, n)]
    w = rng.integers(1, 4, n).astype(np.uint32)
    w[rng.random(n) < zero_share] = 0
    f = rng.permutation(n).astype(np.uint32)
    return (_u64.as_tensor(h, "cpu"), torch.from_numpy(w.view(np.int32)),
            torch.from_numpy(f.view(np.int32)))


@pytest.mark.parametrize("ns,cap", [(1, 3), (4, 5), (8, 2)])
def test_band_route_drains_to_the_owners(ns, cap):
    """K15's plain version: the first round's sends are each owner's
    first cap lanes in lane order, the leftovers the rest in (owner,
    lane) order; routing the leftovers again until none is left delivers
    every owned lane to its owner exactly once."""
    h, w, f = _lanes(np.random.default_rng(ns), 300, 120)
    owner = torch.where(w != 0, band_owner(h, ns), ns)
    lanes = (h, w, f)
    got = [[] for _ in range(ns)]
    rounds = 0
    while True:
        sh, sw, sf, lh, lw, lf, n_left = kernels.band_route(*lanes, ns, cap)
        assert sh.shape == (ns, cap)
        if rounds == 0:
            left = []
            for o in range(ns):
                mine = torch.nonzero(owner == o).squeeze(1)
                k = min(cap, mine.numel())
                assert torch.equal(sh[o, :k], h[mine[:k]])
                assert torch.equal(sf[o, :k], f[mine[:k]])
                assert (sh[o, k:] == plain.SENTINEL).all()
                assert (sw[o, k:] == 0).all()
                left.append(mine[cap:])
            left = torch.cat(left)
            assert int(n_left) == left.numel()
            assert torch.equal(lh[:left.numel()], h[left])
            assert torch.equal(lw[:left.numel()], w[left])
        for o in range(ns):
            live = sw[o] != 0
            got[o] += list(zip(sh[o][live].tolist(), sw[o][live].tolist(),
                               sf[o][live].tolist()))
        rounds += 1
        if int(n_left) == 0:
            break
        m = int(n_left)
        lanes = (lh[:m], lw[:m], lf[:m])
    assert rounds > 1
    for o in range(ns):
        mine = owner == o
        want = sorted(zip(h[mine].tolist(), w[mine].tolist(),
                          f[mine].tolist()))
        assert sorted(got[o]) == want


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------


def _sorted_valid(k, w, f, n):
    k, w, f = (np.asarray(x)[:n] for x in (k, w, f))
    k = k.astype(np.int64).view(np.uint64) if k.dtype != np.uint64 else k
    order = np.argsort(k, kind="stable")
    return (k[order], w.astype(np.int64).astype(np.uint32)[order],
            f.astype(np.int64).astype(np.uint32)[order])


@pytest.mark.parametrize("seed", [0, 1])
def test_combine_lanes_matches_khmer_tpu(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    pool = rng.integers(0, 1 << 64, 700, dtype=np.uint64)
    pool[0] = 0
    keys = pool[rng.integers(0, pool.size, n)]
    keys[:40] = pool[1]  # a hot key: 40 lanes near the clamp each
    keys[rng.random(n) < 0.05] = U64_MAX
    w = rng.choice(np.array([1, 2, (1 << 20) - 1, 1 << 20, (1 << 20) + 5,
                             (1 << 32) - 1], np.uint32), n)
    f = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    f[:3] = [0, (1 << 32) - 1, (1 << 31)]
    jk, jw, jf, jn = jax_dfr.combine_lanes(jnp.asarray(keys),
                                           jnp.asarray(w), jnp.asarray(f))
    pk, pw, pf, pn = dfr.combine_lanes(_u64.as_tensor(keys, "cpu"),
                                       torch.from_numpy(w.view(np.int32)),
                                       torch.from_numpy(f.view(np.int32)))
    assert int(pn) == int(jn)
    got = _sorted_valid(pk.numpy(), pw.numpy(), pf.numpy(), int(pn))
    want = _sorted_valid(np.asarray(jk), np.asarray(jw), np.asarray(jf),
                         int(jn))
    for g, x in zip(got, want):
        assert np.array_equal(g, x)
    assert (pk[int(pn):] == plain.SENTINEL).all()
    # unit lanes
    jk, jw, jf, jn = jax_dfr.combine_unit_lanes(jnp.asarray(keys),
                                                jnp.asarray(f))
    pk, pw, pf, pn = dfr.combine_unit_lanes(
        _u64.as_tensor(keys, "cpu"), torch.from_numpy(f.view(np.int32)))
    assert int(pn) == int(jn)
    got = _sorted_valid(pk.numpy(), pw.numpy(), pf.numpy(), int(pn))
    want = _sorted_valid(np.asarray(jk), np.asarray(jw), np.asarray(jf),
                         int(jn))
    for g, x in zip(got, want):
        assert np.array_equal(g, x)


# ---------------------------------------------------------------------------
# K17
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("virgin", [True, False])
def test_claims_match_khmer_tpu(virgin):
    """Distinct keys split over 4 owners by band, unique first
    positions, a few dead lanes; the summed n_unique of khmer_tpu's
    make_claims_step against K17 (a), the mesh's min and K17 (b)."""
    rng = np.random.default_rng(7)
    NS, n = 4, 3000
    primes = (101, 103, 107)
    keys = np.unique(rng.integers(0, 1 << 64, n, dtype=np.uint64))
    firsts = rng.permutation(1 << 20)[:keys.size].astype(np.uint32)
    wgts = rng.integers(1, 3, keys.size).astype(np.uint32)
    wgts[::50] = 0
    owner = band_owner(keys, NS).numpy()
    width = int(np.bincount(owner, minlength=NS).max())
    kb = np.full((1, NS, width), U64_MAX, np.uint64)
    wb = np.zeros((1, NS, width), np.uint32)
    fb = np.full((1, NS, width), (1 << 32) - 1, np.uint32)
    for s in range(NS):
        m = owner == s
        kb[0, s, :m.sum()] = keys[m]
        wb[0, s, :m.sum()] = wgts[m]
        fb[0, s, :m.sum()] = firsts[m]
    base = np.zeros(sum(primes) + 1, np.uint32)
    if not virgin:
        base[rng.random(base.size) < 0.5] = 3
    jspec = JaxSpec("byte", primes, True)
    mesh = _jax_mesh(1, NS)
    step = jax_sharded.make_claims_step(jspec, mesh, virgin)
    args = (jnp.zeros((1, NS), jnp.uint64), jnp.asarray(kb), jnp.asarray(wb),
            jnp.asarray(fb)) + (() if virgin else (jnp.asarray(base),))
    want = int(np.asarray(step(*args)).sum())

    spec = SketchSpec("byte", primes)
    pmesh = make_mesh(["cpu"] * NS)
    geom = spec.geometry("cpu")
    lanes = [(_u64.as_tensor(kb[0, s], "cpu"),
              torch.from_numpy(wb[0, s].view(np.int32)),
              torch.from_numpy(fb[0, s].view(np.int32))) for s in range(NS)]
    claims = []
    for k, w, f in lanes:
        c = torch.full((spec.total_bins + 1,), -1, dtype=torch.int32)
        kernels.claim_scatter(k, w, f, *geom, c)
        claims.append(c)
    claims = pmesh.all_reduce(claims, "umin32")
    b = None if virgin else torch.from_numpy(base.view(np.int32))
    total = torch.zeros(1, dtype=torch.int64)
    for (k, w, f), c in zip(lanes, claims):
        kernels.claim_count(k, w, f, *geom, c, b, total)
    assert int(total) == want
    assert 0 < want < keys.size


# ---------------------------------------------------------------------------
# the consumer
# ---------------------------------------------------------------------------


def _chunks(seed, n_chunks):
    """Random 2-bit chunks with the last k - 1 windows masked, and every
    fourth chunk poly-A (its k-mer passes 255: a bigcount candidate)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4, (n_chunks, CHUNK), dtype=np.uint8)
    data[::4] = 0
    mask = np.ones((n_chunks, CHUNK), np.uint8)
    mask[:, CHUNK - K + 1:] = 0
    mask[1, 50:90] = 0
    return data, mask


def _consume_jax(shape, data, mask, base=None):
    D, S = shape
    spec = JaxSpec("byte", PRIMES, True)
    mesh = _jax_mesh(D, S)
    # khmer_tpu's buffer must hold every distinct lane of a shard (a
    # merge that leaves it too full overwrites lanes); the port's keeps
    # the lanes past its cap, and combines at every dispatch then
    c = jax_sharded.ShardedDeferredConsumer(spec, K, "2bit", mesh=mesh,
                                            chunk=CHUNK, cap=8 * CHUNK,
                                            from_codes=True)
    for d, m in zip(data, mask):
        c.add_chunk(d, m)
    if base is None:
        out = c.finish(virgin=True)
    else:
        out = c.finish(jnp.asarray(base))
    query = jax_sharded.make_sharded_query(spec, mesh)
    return c, out, query


def _consume_port(shape, data, mask, base=None):
    D, S = shape
    spec = SketchSpec("byte", PRIMES)
    mesh = make_mesh(["cpu"] * (D * S), data=D)
    c = ShardedDeferredConsumer(spec, K, "2bit", mesh=mesh, chunk=CHUNK,
                                cap=4 * CHUNK, from_codes=True,
                                use_bigcount=True)
    for d, m in zip(data, mask):
        c.add_chunk(d, m)
    if base is None:
        out = c.finish(virgin=True)
    else:
        out = c.finish(torch.from_numpy(base.view(np.int32)))
    return c, out, make_sharded_query(spec, mesh, cap=65535)


@pytest.mark.parametrize("virgin", [True, False])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_consumer_matches_khmer_tpu(shape, virgin):
    """Seven chunks a shard (merges every few dispatches, a last short
    batch), the poly-A chunks crossing 255."""
    NS = shape[0] * shape[1]
    data, mask = _chunks(NS, 7 * NS - 1)
    base = None
    if not virgin:
        base = np.zeros(sum(PRIMES) + 1, np.uint32)
        base[np.random.default_rng(1).random(base.size) < 0.3] = 250
    jc, (jdelta, juniq, jcons, jcands), jquery = _consume_jax(
        shape, data, mask, base)
    pc, (pdelta, puniq, pcons, pcands), pquery = _consume_port(
        shape, data, mask, base)
    assert np.array_equal(pdelta.numpy().view(np.uint32), np.asarray(jdelta))
    assert (puniq, pcons) == (juniq, jcons)
    assert pcands == jcands and len(pcands) >= 1
    assert pc.n_dropped == 0
    assert sharded.LAST_CONSUME_STATS["devices"] == NS
    if virgin:
        lanes = [plain.hash2bit_canonical(torch.from_numpy(d),
                                          torch.from_numpy(m), K)
                 for d, m in zip(data, mask)]
        stream = np.concatenate([_u64.to_numpy(hh[ww != 0])
                                 for hh, ww in lanes])
        assert puniq == _ref_n_unique(PRIMES, stream)
        assert pcons == stream.size
    hashes = _u64.to_numpy(plain.hash2bit_canonical(
        torch.from_numpy(data[2]), torch.from_numpy(mask[2]), K)[0])[:150]
    hashes = np.concatenate([hashes, np.zeros(1, np.uint64)])
    want = np.asarray(jquery(jc.tables, jnp.asarray(hashes)))
    got = pquery(pc.tables, hashes).numpy()
    assert np.array_equal(got, want) and got.max() > 255
    merged = merge_tables_saturating(pc.tables)
    assert torch.equal(merged, pdelta)


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_mesh_sum_wraps_mod_2_32(shards):
    """merge_tables_saturating and the mesh's all-reduce "sum" add the
    int32 patterns of uint32 partial tables mod 2**32, as khmer_tpu's
    merge does."""
    rng = np.random.default_rng(shards)
    parts = rng.integers(0, 1 << 32, (1, shards, 101), dtype=np.uint64)
    parts[0, :, :4] = (1 << 32) - 1
    parts = parts.astype(np.uint32)
    spec = JaxSpec("byte", (101,))
    want = np.asarray(jax_sharded.merge_tables_saturating(
        jnp.asarray(parts), spec))
    tables = [torch.from_numpy(t.view(np.int32).copy()) for t in parts[0]]
    got = merge_tables_saturating(tables)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    reduced = make_mesh(["cpu"] * shards).all_reduce(tables, "sum")
    assert all(torch.equal(r, got) for r in reduced)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present: the entry points would not raise")
@pytest.mark.parametrize("call", ["process_devices", "distributed_count",
                                  "make_mesh"])
def test_no_card_raises_unless_cpu_is_asked(call, tmp_path):
    """device=None means CUDA: without a card the multi-process entry
    points raise instead of running on the CPU; device="cpu" takes the
    CPU."""
    spec = SketchSpec("byte", PRIMES)
    fa = tmp_path / "one.fa"
    fa.write_text(">r\n" + "ACGT" * 10 + "\n")
    run = {"process_devices": multihost.process_devices,
           "distributed_count": lambda device=None: multihost.
           distributed_count([str(fa)], spec, K, chunk=1 << 14,
                             device=device),
           "make_mesh": lambda device=None: make_mesh(device=device)}[call]
    with pytest.raises(RuntimeError, match="CUDA"):
        run()
    assert run(device="cpu") is not None


@pytest.mark.parametrize("backend,error", [(None, ValueError),
                                           ("mpi", ValueError),
                                           ("nccl", RuntimeError)])
def test_initialize_needs_a_backend_it_can_have(backend, error):
    """initialize takes its backend from the caller, and NCCL only with a
    card for every process; it raises before joining any group."""
    if backend == "nccl" and torch.cuda.device_count() >= 2:
        pytest.skip("the machine has a card for each of 2 processes")
    with pytest.raises(error, match="backend|NCCL"):
        multihost.initialize("127.0.0.1:1", 2, 0, backend)


def test_sharded_consumer_empty():
    spec = SketchSpec("byte", PRIMES)
    c = ShardedDeferredConsumer(spec, K, "2bit", mesh=make_mesh(["cpu"] * 3),
                                chunk=CHUNK)
    delta, n_unique, n_consumed, cands = c.finish()
    assert (n_unique, n_consumed, cands) == (0, 0, set())
    assert int((delta != 0).sum()) == 0


# ---------------------------------------------------------------------------
# consume_seqfile's dispatch
# ---------------------------------------------------------------------------


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))


def _random_reads(n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.choice(np.frombuffer(b"ACGT", np.uint8), length).tobytes()
            .decode() for _ in range(n)]


@pytest.fixture
def four_shards(monkeypatch):
    monkeypatch.setattr(sharded, "default_devices",
                        lambda device=None: [torch.device("cpu")] * 4)
    monkeypatch.setenv("KHMER_TPU_SHARDED", "1")


@pytest.mark.parametrize("case", ["countgraph", "polya", "nodegraph"])
def test_consume_seqfile_sharded(tmp_path, monkeypatch, four_shards, case):
    fa = str(tmp_path / "reads.fa")
    if case == "polya":
        _write_fasta(fa, ["A" * 300] * 40 + _random_reads(10, 60, 7))
    else:
        _write_fasta(fa, _random_reads(150, 90, 3) * 2)
    port_cls, jax_cls = (Nodegraph, khmer_tpu.Nodegraph) \
        if case == "nodegraph" else (Countgraph, khmer_tpu.Countgraph)
    jg = jax_cls(K, primes=list(PRIMES))
    sharded_g = port_cls(K, primes=list(PRIMES), device="cpu")
    serial_g = port_cls(K, primes=list(PRIMES), device="cpu")
    if case == "polya":
        for g in (jg, sharded_g, serial_g):
            g.set_use_bigcount(True)
    assert sharded_g._use_sharded(fa)
    want = jg.consume_seqfile(fa)
    got = sharded_g.consume_seqfile(fa, chunk=4096)
    assert sharded.LAST_CONSUME_STATS["devices"] == 4
    monkeypatch.setenv("KHMER_TPU_SHARDED", "0")
    assert not serial_g._use_sharded(fa)
    assert serial_g.consume_seqfile(fa) == got == want
    for g in (sharded_g, serial_g):
        assert np.array_equal(g.storage.table.numpy().view(np.uint32),
                              np.asarray(jg.storage.table))
        assert g.n_unique_kmers() == jg.n_unique_kmers()
        assert np.array_equal(g.storage.raw_bytes(),
                              np.asarray(jg.storage.raw_bytes()))
    if case == "polya":
        assert sharded_g.get("A" * K) > 255
        assert sharded_g.storage.resolved_bigcounts() == \
            jg.storage.resolved_bigcounts() == \
            serial_g.storage.resolved_bigcounts()
    # a second consume counts against the table as it now is
    monkeypatch.setenv("KHMER_TPU_SHARDED", "1")
    more = str(tmp_path / "more.fa")
    _write_fasta(more, _random_reads(100, 80, 11))
    jg.consume_seqfile(more)
    sharded_g.consume_seqfile(more, chunk=4096)
    assert sharded_g.n_unique_kmers() == jg.n_unique_kmers()
    assert np.array_equal(sharded_g.storage.table.numpy().view(np.uint32),
                          np.asarray(jg.storage.table))


def test_use_sharded_rule(tmp_path, monkeypatch):
    fa = str(tmp_path / "reads.fa")
    _write_fasta(fa, _random_reads(5, 50, 1))
    g = Countgraph(K, primes=list(PRIMES), device="cpu")
    monkeypatch.setenv("KHMER_TPU_SHARDED", "1")
    assert not g._use_sharded(fa)  # one CPU device
    monkeypatch.setattr(sharded, "default_devices",
                        lambda device=None: [torch.device("cpu")] * 2)
    assert g._use_sharded(fa)
    monkeypatch.setenv("KHMER_TPU_SHARDED", "auto")
    assert not g._use_sharded(fa)
    monkeypatch.setenv("KHMER_TPU_SHARD_MIN_MB", "0")
    assert g._use_sharded(fa) and not g._use_sharded(iter([]))
    monkeypatch.setenv("KHMER_TPU_SHARDED", "off")
    assert not g._use_sharded(fa)


# ---------------------------------------------------------------------------
# sharded CC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,e,seed", [(1, 1, 0), (100, 50, 2),
                                      (1000, 5000, 4), (2048, 0, 1)])
def test_sharded_cc_matches_khmer_tpu(n, e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.uint32)
    dst = rng.integers(0, n, e).astype(np.uint32)
    if n == 2048:  # a path: many rounds
        src = np.arange(n - 1, dtype=np.uint32)
        dst = src + 1
    from jax.sharding import Mesh

    want = np.asarray(jax_cc_sharded(Mesh(np.array(jax.devices()[:4]),
                                          ("d",)), n, src, dst))
    stats = {}
    got = connected_components_sharded(make_mesh(["cpu"] * 4), n, src, dst,
                                       stats=stats)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert stats["calls"] >= 1


def test_cc_split_equals_cc_rounds():
    """One relax and one jump a round over one shard are cc_rounds'."""
    rng = np.random.default_rng(3)
    n = 500
    src = torch.from_numpy(rng.integers(0, n, 800).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, 800).astype(np.int32))
    lab = torch.arange(n, dtype=torch.int32)
    want, w_changed = kernels.cc_rounds(lab, src, dst, 3)
    changed = torch.zeros(1, dtype=torch.int32)
    for _ in range(3):
        lab = kernels.cc_jump(kernels.cc_relax(lab, src, dst), lab, changed)
    assert torch.equal(lab, want)
    assert bool(changed) == bool(w_changed)


def test_do_partition_device_mesh_matches_khmer_tpu(tmp_path):
    fa = str(tmp_path / "reads.fa")
    write_metagenome(fa, seed=5, n_reads=200)
    j = khmer_tpu.Nodegraph(K, 20011, 4)
    j.consume_seqfile_and_tag(fa)
    p = convert.graph_from_numpy(
        Nodegraph, K, j.hashsizes(), np.asarray(j.storage.table),
        tags=j.all_tags, tag_density=j.tag_density, device="cpu")
    from jax.sharding import Mesh

    js = JaxSubsetPartition(j)
    js.do_partition_device(mesh=Mesh(np.array(jax.devices()[:4]), ("d",)))
    js.save_partitionmap(str(tmp_path / "jax.pmap"))
    ps = SubsetPartition(p)
    ps.do_partition_device(mesh=make_mesh(["cpu"] * 4, data=2))
    ps.save_partitionmap(str(tmp_path / "port.pmap"))
    with open(str(tmp_path / "jax.pmap"), "rb") as a, \
            open(str(tmp_path / "port.pmap"), "rb") as b:
        assert a.read() == b.read()
    assert ps.device_stats["edges"] > 0

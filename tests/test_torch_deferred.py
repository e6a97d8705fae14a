"""Port parity of the deferred counter and its claim-rule flush
(khmer_tpu_torch.ops.deferred) with khmer_tpu/ops/deferred.py, on the
CPU (the kernels K16, K18 and K19 as their plain versions).

* flush_table_ops against khmer_tpu's flush_table_ops and
  flush_table_ops_dense called directly, on distinct lanes that collide
  in every table (dead keys, zero totals, first positions past 2**31),
  into a virgin and a preloaded table, with and without bigcount
  tracking, into a flat table and into 3 pieces of a bin-sharded one:
  the table, n_new and the bigcount candidates as a set.
* _sort_by_first against khmer_tpu's.
* DeferredCounter consumes with a small MERGE_EVERY, flush window,
  claim window and candidate buffer, so that cycles, ledger overflows,
  windowed flushes, claim windows and the candidates' recovery all run,
  into whole and 3-piece tables (a Countgraph whose counts pass 255,
  with bigcount, and a Nodegraph), against khmer_tpu's consume_seqfile:
  return, table, n_unique and the saved file's bytes.

One table geometry on khmer_tpu's side (4 x ~20,000 bins) at k = 20, and
the flushes' small one (3 x ~100 bins).  Integer data: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import khmer_tpu
from khmer_tpu.ops import deferred as jax_dfr
from khmer_tpu.ops.sketch_ops import SketchSpec as JaxSpec
from khmer_tpu_torch import Countgraph, Nodegraph, _u64
from khmer_tpu_torch.ops import deferred as dfr
from khmer_tpu_torch.parallel import make_mesh
from khmer_tpu_torch.storage import ByteStorage

K = 20
SIZE, N_TABLES = 20011, 4
FLUSH_SIZES = (101, 103, 107)
U32 = (1 << 32) - 1


def _lanes(seed, n=400):
    """Distinct (uint64 key, uint32 total, uint32 first) lanes: a tenth
    dead (SENTINEL key or total 0), totals up to 400, first positions
    distinct and spread over all 32 bits."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(np.unique(rng.integers(
        0, 2 ** 64 - 1, 2 * n, dtype=np.uint64)))[:n]
    totals = rng.integers(1, 400, n).astype(np.uint32)
    firsts = rng.permutation(np.unique(rng.integers(
        0, U32, 2 * n, dtype=np.uint64)))[:n].astype(np.uint32)
    keys[rng.random(n) < 0.05] = np.uint64(2 ** 64 - 1)
    totals[rng.random(n) < 0.05] = 0
    return keys, totals, firsts


def _preload(seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 300, sum(FLUSH_SIZES) + 1).astype(np.uint32)
    t[rng.random(t.size) < 0.6] = 0
    t[-1] = 0
    return t


@pytest.mark.parametrize("pieces", [0, 3])
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("virgin", [True, False])
def test_flush_matches_khmer_tpu(virgin, track, pieces):
    keys, totals, firsts = _lanes(7)
    pre = np.zeros(sum(FLUSH_SIZES) + 1, np.uint32) if virgin \
        else _preload(8)
    jspec = JaxSpec("byte", FLUSH_SIZES, use_bigcount=track)
    outs = [fn(jspec, jnp.asarray(pre), jnp.asarray(keys),
               jnp.asarray(totals), jnp.asarray(firsts), virgin, track)
            for fn in (jax_dfr.flush_table_ops,
                       jax_dfr.flush_table_ops_dense)]
    st = ByteStorage(FLUSH_SIZES, device="cpu")
    if not virgin:
        st.replace_table(torch.from_numpy(pre.view(np.int32)))
    if pieces:
        st.shard_table(make_mesh(["cpu"] * pieces))
    out = dfr.flush_table_ops(
        st.spec, st.flush_target(), _u64.as_tensor(keys, "cpu"),
        torch.from_numpy(totals.view(np.int32)),
        torch.from_numpy(firsts.view(np.int32)), virgin, track)
    table = st.host_table() if pieces else \
        out[0].numpy().view(np.uint32)
    for jout in outs:
        assert np.array_equal(np.asarray(jout[0]), table)
        assert int(jout[1]) == int(out[1])
        if track:
            n_cross = int(jout[3])
            assert n_cross == out[3] > 0
            assert set(np.asarray(jout[2])[:n_cross].tolist()) == \
                set(_u64.to_numpy(out[2]).tolist())
    assert int(out[1]) > 0


def test_sort_by_first_matches_khmer_tpu():
    keys, totals, firsts = _lanes(3, n=1000)
    got = dfr._sort_by_first(_u64.as_tensor(keys, "cpu"),
                             torch.from_numpy(totals.view(np.int32)),
                             torch.from_numpy(firsts.view(np.int32)))
    want = jax_dfr._sort_by_first(jnp.asarray(keys), jnp.asarray(totals),
                                  jnp.asarray(firsts))
    assert np.array_equal(_u64.to_numpy(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))


def _write_reads(path, seed, n_reads=400, repeats=300):
    """Random 100-base reads, one of them repeated past 255."""
    rng = np.random.default_rng(seed)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 100))
            for _ in range(n_reads)]
    seqs += [seqs[4]] * repeats
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("deferred") / "reads.fa")
    _write_reads(path, seed=9)
    return path


@pytest.fixture(scope="module")
def jax_results(reads, tmp_path_factory):
    """khmer_tpu's consume of the reads: (return, table, n_unique, saved
    bytes) by kind."""
    out = {}
    d = tmp_path_factory.mktemp("jax")
    for name, cls in (("count", khmer_tpu.Countgraph),
                      ("node", khmer_tpu.Nodegraph)):
        g = cls(K, SIZE, N_TABLES)
        if name == "count":
            g.set_use_bigcount(True)
        ret = g.consume_seqfile(reads)
        path = str(d / name)
        g.save(path)
        with open(path, "rb") as f:
            out[name] = (tuple(ret), np.asarray(g.storage.table),
                         g.n_unique_kmers(), f.read())
    return out


@pytest.mark.parametrize("pieces", [0, 3])
@pytest.mark.parametrize("kind", ["count", "node"])
def test_deferred_counter_consume(reads, jax_results, tmp_path,
                                  monkeypatch, kind, pieces):
    """Small cycles (MERGE_EVERY 2**10, as khmer_tpu's
    tests/test_hashtable.py:268-283 sets it), flush windows of 2**10
    lanes, claim windows of 5,000 bins and 16 candidates a piece: the
    counter flushes its ledger several times, each flush in windows, and
    recovers the candidates of the windows that overflow."""
    monkeypatch.setattr(dfr.DeferredCounter, "MERGE_EVERY", 1 << 10)
    monkeypatch.setattr(dfr, "flush_slice", lambda device: 1 << 10)
    monkeypatch.setattr(dfr, "CLAIM_WINDOW", 5000)
    monkeypatch.setattr(dfr, "CAND_LANES", 16)
    calls = {"_cycle": 0, "_ledger_overflow": 0, "_flush_windows": 0,
             "_sort_by_first": 0}
    for name in calls:
        owner = dfr if name == "_sort_by_first" else dfr.DeferredCounter
        fn = getattr(owner, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(owner, name, counted)
    g = (Countgraph if kind == "count" else Nodegraph)(K, SIZE, N_TABLES,
                                                       device="cpu")
    if kind == "count":
        g.set_use_bigcount(True)
    if pieces:
        g.storage.shard_table(make_mesh(["cpu"] * pieces))
    ret = g._consume_deferred(reads, chunk=1 << 10)
    want_ret, want_table, want_unique, want_bytes = jax_results[kind]
    assert ret == want_ret
    assert np.array_equal(g.storage.host_table(), want_table)
    assert g.n_unique_kmers() == want_unique
    path = str(tmp_path / kind)
    g.save(path)
    with open(path, "rb") as f:
        assert f.read() == want_bytes
    assert calls["_cycle"] > 10 and calls["_ledger_overflow"] >= 2
    assert calls["_flush_windows"] >= 3 and calls["_sort_by_first"] >= 3

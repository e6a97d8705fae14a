"""Port parity of normalize-by-median's batch step, kernel K6
(diginorm_chain) and the single-K2 flush: khmer_tpu_torch against
khmer_tpu on the same generated read bundles.

Three consecutive batches of 64 bundles (pairs, some unpaired reads, a
read shorter than k, and bundles that repeat the bundle before them,
whose decision reads the tally the earlier one just added) go through
Countgraph.diginorm_batch on both packages, from an empty table of
4 x 20011 bins (many in-batch bin collisions; one table size keeps
khmer_tpu's CPU compile to one).  Keep
flags, table bins and n_unique are equal after each batch.  The flush
alone is held to khmer_tpu's _windowed_claim_flush on random input.
Integer data: exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import khmer_tpu
from khmer_tpu.hashtable import _windowed_claim_flush
from khmer_tpu.ops import sketch_ops as jsk
from khmer_tpu.ops.deferred import IDX_SENTINEL
from khmer_tpu_torch import Countgraph, _u64
from khmer_tpu_torch.hashtable import TOTAL_CLAMP

from .test_torch_rows import _with_errors

K = 20
BATCH = 64


def make_bundles(seed, n_batches=3, genome_len=3000, readlen=100):
    """n_batches x BATCH read bundles over a small random genome (about
    13x read coverage a batch, so later bundles reach coverage), a third
    of them with 1% errors; every 7th bundle repeats the one before it,
    every 11th is unpaired, and one has a mate shorter than k."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    n = n_batches * BATCH
    starts = rng.integers(0, genome_len - readlen, 2 * n)
    reads = [genome[s:s + readlen] for s in starts]
    noisy = _with_errors(reads, 0.01, seed)
    reads = [noisy[i] if i % 3 == 0 else r for i, r in enumerate(reads)]
    pairs = []
    for i in range(n):
        if i % 7 == 6:
            pairs.append(pairs[-1])
        elif i % 11 == 10:
            pairs.append((reads[2 * i], None))
        else:
            pairs.append((reads[2 * i], reads[2 * i + 1]))
    pairs[5] = (pairs[5][0], pairs[5][1][:K - 3])
    return [pairs[b * BATCH:(b + 1) * BATCH] for b in range(n_batches)]


def port_table(p):
    """The port's bins as the uint32 numpy array khmer_tpu holds."""
    return p.storage.table.numpy().view(np.uint32)


@pytest.mark.parametrize("size,C", [(20011, 5), (20011, 1), (20011, 10)])
def test_diginorm_batches_match(size, C):
    j = khmer_tpu.Countgraph(K, size, 4)
    p = Countgraph(K, size, 4, device="cpu")
    kept = 0
    for batch in make_bundles(size + C):
        jk = np.asarray(j.diginorm_batch(batch, C))
        pk = p.diginorm_batch(batch, C).numpy()
        assert np.array_equal(pk, jk.astype(np.uint8))
        assert np.array_equal(port_table(p), np.asarray(j.storage.table))
        assert p.n_unique_kmers() == j.n_unique_kmers()
        kept += int(pk.sum())
    # the decisions are not all alike: some bundles are dropped
    assert 0 < kept < 3 * BATCH


@pytest.mark.parametrize("virgin", [True, False])
def test_flush_matches_windowed_claim_flush(virgin):
    """_flush_tally (one K2 call over the tallied k-mers in order of
    first occurrence, totals clamped at TOTAL_CLAMP) against
    khmer_tpu's _windowed_claim_flush on the same distinct keys, totals
    and first positions: table bins and n_unique equal.  One total is
    above TOTAL_CLAMP; about half the keys are not tallied."""
    rng = np.random.default_rng(9)
    sizes = tuple(khmer_tpu.primes.get_n_primes_near_x(4, 1009))
    n_keys, B2, nw = 3000, 64, 81
    keys = np.unique(rng.integers(0, 2 ** 64, n_keys, dtype=np.uint64))
    ids = rng.integers(0, keys.size, (B2, nw)).astype(np.int32)
    valid = rng.random((B2, nw)) < 0.9
    taken = rng.random(B2 // 2) < 0.5
    lanes = valid & np.repeat(taken, 2)[:, None]
    tally = np.bincount(ids[lanes], minlength=keys.size).astype(np.int64)
    tally[ids[lanes][0]] += 3 * TOTAL_CLAMP  # clamped at TOTAL_CLAMP
    table = np.zeros(sum(sizes) + 1, np.uint32)
    if not virgin:
        table[rng.integers(0, table.size - 1, 2000)] = 7

    firsts = np.full(keys.size, IDX_SENTINEL, np.uint32)
    pos = np.flatnonzero(lanes.reshape(-1))
    np.minimum.at(firsts, ids.reshape(-1)[pos], pos.astype(np.uint32))
    totals = np.minimum(tally, TOTAL_CLAMP).astype(np.uint32)
    spec = jsk.SketchSpec("byte", sizes)
    jt, n_new = jax.jit(
        lambda t, k, tt, f: _windowed_claim_flush(spec, t, k, tt, f))(
        jnp.asarray(table), jnp.asarray(keys), jnp.asarray(totals),
        jnp.asarray(firsts))

    p = Countgraph(K, 1, 1, primes=sizes, device="cpu")
    p.storage.table = torch.from_numpy(table.view(np.int32).copy())
    p._flush_tally(_u64.as_tensor(keys, "cpu"), torch.from_numpy(ids),
                   torch.from_numpy(valid.astype(np.uint8)),
                   torch.from_numpy(taken),
                   torch.from_numpy(tally.astype(np.int32)))
    assert np.array_equal(port_table(p), np.asarray(jt))
    assert p.n_unique_kmers() == int(n_new) > 0

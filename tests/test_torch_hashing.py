"""Port parity: 2-bit k-mer hashing (kernel K1 and its callers) against
khmer_tpu on the same inputs.  Integer data: the tolerance is exact
equality.  The k values cover the edge cases of the 64-bit layout: k=1,
2k=32, k=20, and k=31/32, where a hash can be >= 2**63 (unsigned
compare and modulo on int64 bit patterns)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from khmer_tpu import hashtable as jax_hashtable
from khmer_tpu.ops import hashing as jax_hashing
from khmer_tpu_torch import _u64
from khmer_tpu_torch.kernels import plain
from khmer_tpu_torch.ops import hashing
from khmer_tpu_torch.ops.encode import encode_sequence

KS = (1, 16, 20, 31, 32)


@pytest.mark.parametrize("k", KS)
def test_kmer_hashes_2bit_match(k):
    rng = np.random.default_rng(100 + k)
    codes = rng.integers(0, 4, (5, 70), dtype=np.uint8)
    lengths = np.array([70, 69, 40, k, max(k - 1, 1)], np.int32)
    want_h, want_v = jax_hashing.kmer_hashes_2bit(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    got_h, got_v = hashing.kmer_hashes_2bit(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    np.testing.assert_array_equal(_u64.to_numpy(got_h), np.asarray(want_h))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    if k == 32:
        # the unsigned paths are exercised, not just present
        assert (np.asarray(want_h) >= np.uint64(1 << 63)).any()


@pytest.mark.parametrize("k", KS)
def test_chunk_lanes_match(k):
    """(hash, weight) lanes of a flat chunk equal khmer_tpu's
    _chunk_hashes_weights after ordering its phase-major lanes by
    stream position."""
    payload, rows = 64, 6
    n = payload * rows
    rng = np.random.default_rng(200 + k)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    mask = (rng.random(n) < 0.9).astype(np.uint8)
    h, w, pos = jax_hashtable._chunk_hashes_weights(
        jnp.asarray(codes), jnp.asarray(mask, jnp.uint32), k, "2bit",
        payload)
    h, w, pos = np.asarray(h), np.asarray(w), np.asarray(pos)
    # lane (phase, row, j) sits at row offset 16 j + phase; offsets past
    # the row payload are padding that overlaps the next row
    P = 16
    nw = h.size // (P * rows)
    off = (np.arange(nw)[None, None, :] * P +
           np.arange(P)[:, None, None]) + np.zeros((1, rows, 1), int)
    keep = off.reshape(-1) < payload
    order = np.argsort(pos[keep], kind="stable")
    assert np.array_equal(pos[keep][order], np.arange(n))
    got_h, got_w = hashing.chunk_hashes(
        torch.from_numpy(codes), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(_u64.to_numpy(got_h), h[keep][order])
    np.testing.assert_array_equal(got_w.numpy(), w[keep][order])


@pytest.mark.parametrize("k", KS)
def test_scalar_hash_matches_lanes(k):
    """The host scalar forward_hash agrees with the batched lanes."""
    rng = np.random.default_rng(300 + k)
    seq = "".join(rng.choice(list("ACGT"), 80))
    h, w = plain.hash2bit_canonical(
        torch.from_numpy(encode_sequence(seq)),
        torch.ones(80, dtype=torch.uint8), k)
    want = [jax_hashing.forward_hash(seq[i:i + k], k)
            for i in range(80 - k + 1)]
    assert [int(x) for x in _u64.to_numpy(h[: 80 - k + 1])] == want
    assert [hashing.forward_hash(seq[i:i + k], k)
            for i in range(80 - k + 1)] == want
    assert int(w.sum()) == 80 - k + 1
    assert hashing.reverse_hash(want[0], k) in (
        seq[:k], hashing.reverse_complement(seq[:k]))

"""Port parity of kernel K8 (murmur_hashes) and the scalar murmur hashes:
khmer_tpu_torch against khmer_tpu on the same numpy inputs.

K8's plain version is held to kmer_hashes_murmur_bytes, both forms (the
full complement table and the bulk-consume assume_acgt), at k = 1, 9,
16, 17, 20, 33 and 51, on padded batches whose rows have lengths 0,
< k, k and > 64, with lowercase, N and IUPAC bytes, and with even-k
palindromes (a window equal to its own reverse complement hashes to h1
alone); the scalar hash_murmur3 / hash_no_rc_murmur3 to khmer_tpu's.
Every hash is compared, valid or not; the plain murmur's logical shifts
and wrapping multiplies are exercised by hashes with the top bit set.
Exact equality."""

import numpy as np
import pytest
import torch

import khmer_tpu
from khmer_tpu.ops.hashing import kmer_hashes_murmur_bytes
import khmer_tpu_torch
from khmer_tpu_torch import _u64, kernels
from khmer_tpu_torch.ops.hashing import (murmurhash3_x64_128,
                                         reverse_complement)

KS = (1, 9, 16, 17, 20, 33, 51)
ALPHABET = np.frombuffer(b"ACGTacgtNnRYKMSWBDHVU.-", np.uint8)


def _palindrome(rng, k):
    half = "".join(rng.choice(list("ACGT"), k // 2))
    return half + reverse_complement(half)


def _batch(k, seed):
    """uint8 rows [5, L] and lengths: 0, k - 1, k, L (> 64) and 64 + k;
    row 3 mixes in other bytes, row 4 holds even-k palindromes."""
    rng = np.random.default_rng(seed)
    L = 70 + k
    byts = rng.choice(np.frombuffer(b"ACGT", np.uint8), (5, L))
    mixed = rng.random(L) < 0.3
    byts[3, mixed] = rng.choice(ALPHABET, int(mixed.sum()))
    if k % 2 == 0:
        for j in range(0, L - k + 1, k + 3):
            byts[4, j:j + k] = np.frombuffer(
                _palindrome(rng, k).encode(), np.uint8)
    lengths = np.array([0, k - 1, k, L, 64 + k], np.int32)
    return byts, lengths


@pytest.mark.parametrize("assume_acgt", [False, True],
                         ids=["full", "acgt"])
@pytest.mark.parametrize("k", KS)
def test_murmur_hashes_match_kmer_hashes_murmur_bytes(k, assume_acgt):
    byts, lengths = _batch(k, k)
    want, want_valid = kmer_hashes_murmur_bytes(byts, lengths, k,
                                                assume_acgt=assume_acgt)
    got, valid = kernels.murmur_hashes(torch.from_numpy(byts),
                                       torch.from_numpy(lengths), k,
                                       assume_acgt)
    assert np.array_equal(_u64.to_numpy(got), np.asarray(want))
    assert np.array_equal(valid.numpy(), np.asarray(want_valid))
    assert (_u64.to_numpy(got) >= 1 << 63).any()
    if k % 2 == 0 and k > 1:
        # the palindromes hash to h1 alone: h(fwd) ^ h(rc) would be 0
        pal = byts[4, :k].tobytes().decode()
        assert reverse_complement(pal) == pal
        assert int(_u64.to_numpy(got)[4, 0]) == \
            murmurhash3_x64_128(pal.encode())[0]


def test_murmur_hashes_one_flat_row():
    """The flat form of two rows (one row of both) hashes every window
    that lies inside one of them as the padded rows do."""
    byts, lengths = _batch(20, 3)
    L = byts.shape[1]
    W = L - 20 + 1
    rows, _ = kernels.murmur_hashes(torch.from_numpy(byts),
                                    torch.from_numpy(lengths), 20, True)
    flat = torch.from_numpy(byts[2:4].reshape(1, -1).copy())
    got, valid = kernels.murmur_hashes(
        flat, torch.tensor([2 * L], dtype=torch.int32), 20, True)
    assert got.shape == (1, 2 * L - 20 + 1) and bool(valid.all())
    assert torch.equal(got[0, :W], rows[2]) and \
        torch.equal(got[0, L:L + W], rows[3])


def test_murmur_hashes_refuse_bad_shapes():
    byts = torch.zeros((2, 10), dtype=torch.uint8)
    lengths = torch.zeros(2, dtype=torch.int32)
    for k in (0, 11, 256):
        with pytest.raises(ValueError):
            kernels.murmur_hashes(byts, lengths, k)
    with pytest.raises(TypeError):
        kernels.murmur_hashes(byts.to(torch.int32), lengths, 5)


@pytest.mark.parametrize("k", [1, 7, 8, 15, 16, 17, 31, 32, 33, 51, 255])
def test_scalar_murmur_hashes(k):
    rng = np.random.default_rng(k)
    kmers = ["".join(rng.choice(list("ACGTacgtNRY"), k)) for _ in range(8)]
    if k % 2 == 0:
        kmers.append(_palindrome(rng, k))
    for s in kmers:
        assert khmer_tpu_torch.hash_murmur3(s) == khmer_tpu.hash_murmur3(s)
        assert khmer_tpu_torch.hash_no_rc_murmur3(s) == \
            khmer_tpu.hash_no_rc_murmur3(s)
        assert reverse_complement(s) == khmer_tpu.reverse_complement(s)

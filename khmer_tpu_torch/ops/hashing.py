"""k-mer hash functions: host scalars and the batched 2-bit kernel.

Parity targets (semantics reconstructed from the reference, cited per
function):

* exact 2-bit hash, k <= 32: reference src/oxli/kmer_hash.cc:64-99
  (``_hash``), canonical form = min(forward, reverse-complement)
  (``uniqify_rc``, include/oxli/kmer_hash.hh:93).
* invertible ``_revhash``: src/oxli/kmer_hash.cc:139-155.
* MurmurHash3_x64_128-based hash for unbounded k: src/oxli/kmer_hash.cc:
  191-227 -- ``h(fwd) ^ h(revcomp)`` with a self-complement special case.

The scalar functions are copies of khmer_tpu/ops/hashing.py.  The
batched 2-bit hash is kernel K1 (kernels/csrc/hash2bit.cu), which emits
the windows of a flat code chunk in stream order; the TPU kernel's
u32-pair arithmetic and phase-major lane order are not ported.  The
batched murmur hash is kernel K8 (kernels/csrc/murmur.cu), over padded
ASCII rows or one flat chunk, and the batched cyclic hash
(ops/rollinghash.py) kernel K11 (kernels/csrc/cyclic.cu), over the same
two shapes.  Kernel K5 (kernels/csrc/rows.cu) hashes padded rows with
any of the three hashes and reads their counts in the same pass.
"""

import numpy as np
import torch

from khmer_tpu_torch import kernels
from khmer_tpu_torch.ops.encode import COMP_LUT

_TWOBIT = {"A": 0, "T": 1, "C": 2, "G": 3}
_REVTWOBIT = "ATCG"


def reverse_complement(seq: str) -> str:
    """Reverse complement using khmer's `tbl` (kmer_hash.cc:51-54,157-166)."""
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return COMP_LUT[arr][::-1].tobytes().decode("ascii")


def _check_k(kmer, k):
    if k > 32:
        raise ValueError("k-mer size must be <= 32 for the 2-bit hash")
    if len(kmer) < k:
        raise ValueError(
            "Supplied kmer string doesn't match the underlying k-size.")


def hash_2bit_scalar(kmer: str, k: int):
    """Return (canonical, fwd, rev) 2-bit hashes of `kmer[:k]` (host ints)."""
    _check_k(kmer, k)
    # strict twobit_repr parity: no case folding, unknown chars -> 3
    h = 0
    r = 0
    for i in range(k):
        h = (h << 2) | _TWOBIT.get(kmer[i], 3)
        r = (r << 2) | (_TWOBIT.get(kmer[k - 1 - i], 3) ^ 1)
    h &= (1 << 64) - 1
    r &= (1 << 64) - 1
    return (min(h, r), h, r)


def forward_hash(kmer: str, k: int) -> int:
    """Canonical (strand-neutral) 2-bit hash; khmer ``forward_hash``."""
    return hash_2bit_scalar(kmer, k)[0]


def forward_hash_no_rc(kmer: str, k: int) -> int:
    """Forward-strand-only 2-bit hash; khmer ``forward_hash_no_rc``."""
    return hash_2bit_scalar(kmer, k)[1]


def reverse_hash(khash: int, k: int) -> str:
    """Invert a forward 2-bit hash back into its k-mer string."""
    if isinstance(khash, str):
        raise TypeError("Hash value must be an int")
    if k > 32:
        raise ValueError("k-mer size must be <= 32 for the 2-bit hash")
    out = []
    h = int(khash)
    for _ in range(k):
        out.append(_REVTWOBIT[h & 3])
        h >>= 2
    return "".join(reversed(out))


# --- MurmurHash3_x64_128 (public algorithm, Austin Appleby, public domain) --

_MASK64 = (1 << 64) - 1


def _rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _fmix64(k):
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _MASK64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _MASK64
    k ^= k >> 33
    return k


_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def murmurhash3_x64_128(data: bytes, seed: int = 0):
    """Pure-python MurmurHash3_x64_128; returns (out0, out1)."""
    length = len(data)
    h1 = h2 = seed & _MASK64
    nblocks = length // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16: i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8: i * 16 + 16], "little")
        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _MASK64
        h1 = (h1 * 5 + 0x52DCE729) & _MASK64
        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _MASK64
        h2 = (h2 * 5 + 0x38495AB5) & _MASK64
    tail = data[nblocks * 16:]
    k1 = k2 = 0
    for i in range(len(tail) - 1, 7, -1):
        k2 |= tail[i] << (8 * (i - 8))
    for i in range(min(len(tail), 8) - 1, -1, -1):
        k1 |= tail[i] << (8 * i)
    if len(tail) > 8:
        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
    if len(tail) > 0:
        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    return h1, h2


def hash_murmur3_scalar(kmer: str):
    """Canonical murmur k-mer hash: ``h(fwd) ^ h(revcomp)``, or ``h`` for a
    self-complementary k-mer (reference kmer_hash.cc:199-227)."""
    h = murmurhash3_x64_128(kmer.encode("ascii"))[0]
    rev = reverse_complement(kmer)
    if rev == kmer:
        return h
    r = murmurhash3_x64_128(rev.encode("ascii"))[0]
    return h ^ r


def hash_no_rc_murmur3_scalar(kmer: str):
    return murmurhash3_x64_128(kmer.encode("ascii"))[0]


def compute_band_interval(num_bands: int, band: int):
    """Hash-space band [min, max) of a banded consume.

    Parity: reference kmer_hash.cc:290-304 (band_size = U64_MAX / num_bands;
    note integer division, so the top sliver of hash space belongs to no
    band -- the reference's semantics, preserved here).
    """
    if band >= num_bands or band < 0:
        raise ValueError(
            "'band' must be in the interval [0, 'num_bands'), %d not in [0, %d)"
            % (band, num_bands)
        )
    band_size = ((1 << 64) - 1) // num_bands
    return band_size * band, band_size * (band + 1)


def murmur_window_hashes(byts, k: int, assume_acgt=False):
    """Canonical murmur hashes of every window of one flat uint8 tensor of
    ASCII bytes, int64 [n - k + 1] (empty when n < k), in one K8 call:
    khmer_tpu/ops/hashing.py:kmer_hashes_murmur_bytes over a single row,
    both forms (assume_acgt: the bulk-consume complement)."""
    n = byts.numel()
    if n < k:
        return torch.zeros(0, dtype=torch.int64, device=byts.device)
    lengths = torch.full((1,), n, dtype=torch.int32, device=byts.device)
    return kernels.murmur_hashes(byts[None, :], lengths, k, assume_acgt)[0][0]


def cyclic_window_hashes(byts, k: int):
    """Canonical cyclic hashes of every window of one flat uint8 tensor of
    ASCII bytes, int64 [n - k + 1] (empty when n < k), in one K11 call:
    khmer_tpu/ops/rollinghash.py:kmer_hashes_cyclic_bytes over a single
    row."""
    n = byts.numel()
    if n < k:
        return torch.zeros(0, dtype=torch.int64, device=byts.device)
    lengths = torch.full((1,), n, dtype=torch.int32, device=byts.device)
    return kernels.cyclic_hashes(byts[None, :], lengths, k)[0][0]


def chunk_hashes(codes, mask, k: int):
    """Canonical hashes and weights of every window start of a flat
    chunk (uint8 codes and loader mask, one tensor each): the port of
    khmer_tpu/hashtable.py:_chunk_hashes_weights, in stream order, so
    lane i is the window at position i.  Returns (int64 [n], int32 [n])."""
    if k > 32:
        raise ValueError("k must be <= 32 for the 2-bit hash")
    return kernels.hash2bit_canonical(codes, mask, k)


def kmer_hashes_2bit(codes, lengths, k: int):
    """All k-mer hashes of a padded [B, L] uint8 code tensor.

    Returns (hashes, valid): int64 [B, L-k+1] canonical hashes and a
    bool [B, L-k+1] mask of the windows inside each row's length --
    khmer_tpu/ops/hashing.py:kmer_hashes_2bit.  The rows run through K1
    as one flat chunk; window j of a row reads codes j..j+k-1 of that
    row only, so no window crosses into the next row."""
    if k > 32:
        raise ValueError("k must be <= 32 for the 2-bit hash")
    B, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError("padded width shorter than k")
    lengths = torch.as_tensor(lengths, device=codes.device)
    col = torch.arange(L, device=codes.device)
    valid = col[None, :] + k <= lengths[:, None]
    h, _ = kernels.hash2bit_canonical(
        codes.contiguous().reshape(-1),
        valid.to(torch.uint8).reshape(-1), k)
    return h.reshape(B, L)[:, :W], valid[:, :W]


def row_hashes_counts(codes, lengths, k: int, geom, table, cap,
                      want_hashes=False, hash_kind="2bit"):
    """Counts (and on request hashes) of every window of a padded [B, L]
    uint8 tensor (2-bit codes, or ASCII bytes for hash_kind "murmur" and
    "cyclic") with int32 lengths[B], read from a sketch (flat table and
    its geometry) capped at cap, in one pass of kernel K5: the port of
    khmer_tpu/hashtable.py:_make_row_hashes_counts_fn and
    _make_row_counts_fn.  Returns (uint16 counts [B, W], int64 hashes
    [B, W] or None, bool valid [B, W]), W = L - k + 1; a count is 0
    where the window is not valid."""
    if hash_kind == "2bit" and k > 32:
        raise ValueError("k must be <= 32 for the 2-bit hash")
    counts, hashes = kernels.row_counts(codes, lengths, k, table, *geom, cap,
                                        want_hashes, hash_kind)
    col = torch.arange(counts.shape[1], device=codes.device)
    return counts, hashes, col[None, :] + k <= lengths[:, None]

"""k-mer hash functions: host scalars and the batched 2-bit kernel.

Parity targets (semantics reconstructed from the reference, cited per
function):

* exact 2-bit hash, k <= 32: reference src/oxli/kmer_hash.cc:64-99
  (``_hash``), canonical form = min(forward, reverse-complement)
  (``uniqify_rc``, include/oxli/kmer_hash.hh:93).
* invertible ``_revhash``: src/oxli/kmer_hash.cc:139-155.

The scalar functions are copies of khmer_tpu/ops/hashing.py.  The
batched hash is kernel K1 (kernels/csrc/hash2bit.cu), which emits the
windows of a flat code chunk in stream order; the TPU kernel's u32-pair
arithmetic and phase-major lane order are not ported.  Kernel K5
(kernels/csrc/rows.cu) hashes padded rows and reads their counts in the
same pass.
"""

import numpy as np
import torch

from khmer_tpu_torch import kernels

_TWOBIT = {"A": 0, "T": 1, "C": 2, "G": 3}
_REVTWOBIT = "ATCG"

# khmer's IUPAC complement table, reproduced character-for-character from
# the `tbl` macro at reference kmer_hash.cc:51-54: 64 spaces, then the
# segment below indexed by (char - 64), repeated for lowercase input
# (lowercase complements to UPPERCASE).  Characters outside the table
# complement to ' ', as in the reference.
_TBL_SEGMENT = " TVGH FCD  M KN   YSAABW R"
_COMP_LUT = np.full(256, ord(" "), dtype=np.uint8)
for _j, _c in enumerate(_TBL_SEGMENT):
    _COMP_LUT[64 + _j] = ord(_c)
    _COMP_LUT[96 + _j] = ord(_c)


def reverse_complement(seq: str) -> str:
    """Reverse complement using khmer's `tbl` (kmer_hash.cc:51-54,157-166)."""
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _COMP_LUT[arr][::-1].tobytes().decode("ascii")


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
                      want_hashes=False):
    """Counts (and on request hashes) of every window of a padded [B, L]
    uint8 code tensor with int32 lengths[B], read from a sketch (flat
    table and its geometry) capped at cap, in one pass of kernel K5: the
    port of khmer_tpu/hashtable.py:_make_row_hashes_counts_fn and
    _make_row_counts_fn.  Returns (uint16 counts [B, W], int64 hashes
    [B, W] or None, bool valid [B, W]), W = L - k + 1; a count is 0
    where the window is not valid."""
    if k > 32:
        raise ValueError("k must be <= 32 for the 2-bit hash")
    counts, hashes = kernels.row_counts(codes, lengths, k, table, *geom, cap,
                                        want_hashes)
    col = torch.arange(counts.shape[1], device=codes.device)
    return counts, hashes, col[None, :] + k <= lengths[:, None]

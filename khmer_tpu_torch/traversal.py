"""de Bruijn graph neighbours and count probes for the partitioner.

Port of khmer_tpu/traversal.py:31-111 (the part that SubsetPartition
calls): a frontier of (kmer_f, kmer_r) pairs, int64 bit patterns on the
graph's device, is expanded 8 ways with 2-bit shift arithmetic, and
which candidates exist is read with one count probe of the whole batch
(Storage.get_lanes, kernel K3 on the card).  khmer_tpu does the
arithmetic in host numpy and pads each probe to a width bucket to bound
XLA recompiles; here the frontier stays on the device and every width
runs as it is.
"""

import numpy as np
import torch

from khmer_tpu_torch import _u64

_MASK64 = (1 << 64) - 1


def _consts(k):
    bitmask = (1 << (2 * k)) - 1
    rc_shift = 2 * k - 2
    return bitmask, rc_shift


def fr_from_hash(h, k):
    """(kmer_f, kmer_r) of a canonical hash, following the reference's
    decode-then-rehash (hashgraph.cc:1155-1158): the canonical value is
    decoded as the forward strand."""
    f = int(h)
    r = 0
    x = f
    for _ in range(k):
        r = ((r << 2) | ((x & 3) ^ 1)) & _MASK64
        x >>= 2
    return f, r


def fr_from_hashes(hashes, k):
    """fr_from_hash of every uint64 hash of a numpy array: (f, r)
    uint64 arrays."""
    f = np.asarray(hashes, np.uint64)
    r = np.zeros_like(f)
    x = f.copy()
    for _ in range(k):
        r = (r << np.uint64(2)) | ((x & np.uint64(3)) ^ np.uint64(1))
        x >>= np.uint64(2)
    return f, r


# neighbour arithmetic (reference traversal.cc:88-113) on int64 bit
# patterns of uint64; codes are khmer 2-bit (A=0 T=1 C=2 G=3),
# complement = code ^ 1
def right_neighbors_fr(f, r, k):
    """[N] -> ([N,4] f, [N,4] r) appending each base on the right."""
    bitmask, rc_shift = _consts(k)
    codes = torch.arange(4, dtype=torch.int64, device=f.device)
    nf = ((f[:, None] << 2) & _u64.i64(bitmask)) | codes[None, :]
    nr = _u64.lsr(r[:, None], 2) | ((codes[None, :] ^ 1) << rc_shift)
    return nf, nr


def left_neighbors_fr(f, r, k):
    """[N] -> ([N,4] f, [N,4] r) prepending each base on the left."""
    bitmask, rc_shift = _consts(k)
    codes = torch.arange(4, dtype=torch.int64, device=f.device)
    nf = _u64.lsr(f[:, None], 2) | (codes[None, :] << rc_shift)
    nr = ((r[:, None] << 2) & _u64.i64(bitmask)) | (codes[None, :] ^ 1)
    return nf, nr


def counts_of(graph, hashes):
    """Counts of a batch of uint64 hashes (numpy), capped at the table's
    read cap and without a loaded bigcount overlay (khmer_tpu's
    storage.get_batch_device): one K3 call on the card.  The partitioner
    probes through _expand; this is the API khmer_tpu's callers use."""
    hashes = np.asarray(hashes, np.uint64).reshape(-1)
    if hashes.size == 0:
        return np.zeros(0, np.uint16)
    st = graph.storage
    return st.get_lanes(_u64.as_tensor(hashes, st.device)).cpu().numpy()


def _expand(graph, f, r, k):
    """All existing neighbours of frontier nodes (int64 tensors f, r on
    the graph's device), probed in one K3 call.

    Returns (nf, nr, ncanon, src_idx) flattened over existing
    candidates; src_idx maps each neighbour to its frontier row."""
    rf, rr = right_neighbors_fr(f, r, k)
    lf, lr = left_neighbors_fr(f, r, k)
    nf = torch.cat([rf, lf], dim=1)
    nr = torch.cat([rr, lr], dim=1)
    canon = _u64.umin(nf, nr)
    exists = graph.storage.get_lanes(canon.reshape(-1)).reshape(
        canon.shape).to(torch.int32) > 0
    src = torch.arange(f.numel(), device=f.device)[:, None].expand(
        canon.shape)
    return nf[exists], nr[exists], canon[exists], src[exists]

"""Plain PyTorch versions of the CUDA kernels in csrc/.

Each function computes exactly what its kernel computes, with the same
arguments and the same in-place effects, from ordinary tensor ops.  The
dispatching wrappers in khmer_tpu_torch.kernels call these for tensors
on the CPU; tests and chip_smoke.py hold each kernel against them.
They work on any device, but no CUDA path of the package calls them.
"""

import torch

from khmer_tpu_torch import _u64
from khmer_tpu_torch._config import MAX_KCOUNT


def hash2bit_canonical(codes, mask, k):
    """Canonical 2-bit hash of the window at every lane of a flat code
    chunk, and its weight (1 where the mask is set and the window ends
    inside the chunk).  Returns (int64 hashes [n], int32 weights [n])."""
    n = codes.numel()
    c = torch.cat([codes.to(torch.int64) & 3,
                   torch.zeros(k - 1, dtype=torch.int64,
                               device=codes.device)])
    f = torch.zeros(n, dtype=torch.int64, device=codes.device)
    r = torch.zeros_like(f)
    for j in range(k):
        cj = c[j: j + n]
        f = (f << 2) | cj
        r = r | ((cj ^ 1) << (2 * j))
    lane = torch.arange(n, device=codes.device)
    w = (mask != 0) & (lane <= n - k)
    return _u64.umin(f, r), w.to(torch.int32)


def _bins(hashes, sizes, offsets):
    """[T, n] global bin indices of hashes in every table."""
    return _u64.umod(hashes[None, :], sizes[:, None]) + offsets[:, None]


def sketch_update(table, hashes, weights, sizes, offsets, recips, n_unique,
                  cand=None, cand_count=None):
    """Add weighted hashes to the sketch with the exact claim rule.

    Updates table, n_unique (int64 [1]) and, when cand is given, writes
    the hashes of the lanes whose table-0 bin now exceeds 255 into cand
    (as many as fit) and their number into cand_count.  The claimant of
    a bin is its smallest lane, found over the batch's distinct bins.
    recips is unused (the plain modulo needs none).  Returns is_new, a
    bool [n]."""
    n = hashes.numel()
    T = sizes.numel()
    lane = torch.nonzero(weights != 0).squeeze(1)
    h = hashes[lane]
    pos = lane.to(torch.int32).repeat(T)
    idx = _bins(h, sizes, offsets)
    flat = idx.reshape(-1)
    pre_zero = table[idx] == 0
    uniq, inv = torch.unique(flat, return_inverse=True)
    first = torch.full((uniq.numel(),), n, dtype=torch.int32,
                       device=hashes.device)
    first.scatter_reduce_(0, inv, pos, "amin")
    own = (first[inv] == pos).reshape(idx.shape)
    new = (pre_zero & own).any(0)
    table.index_add_(0, flat, weights[lane].repeat(T))
    is_new = torch.zeros(n, dtype=torch.bool, device=hashes.device)
    is_new[lane] = new
    n_unique += new.sum()
    if cand is not None:
        crossed = h[_u64.u32(table[idx[0]]) > MAX_KCOUNT]
        m = min(crossed.numel(), cand.numel())
        cand[:m] = crossed[:m]
        cand_count.fill_(crossed.numel())
    return is_new


def sketch_get(table, hashes, sizes, offsets, recips, cap):
    """Min over tables of the bin totals, capped at cap; uint16 [n]
    (recips unused)."""
    tot = _u64.u32(table[_bins(hashes, sizes, offsets)]).amin(0)
    return tot.clamp(max=cap).to(torch.uint16)


def abund_hist(keys, table, sizes, offsets, recips, track, t_sizes,
               t_offsets, t_recips, cap, hist):
    """hist[min(count, cap)] += 1 for every lane that starts a run of
    equal keys and is absent from the tracking sketch (min over its
    tables 0); returns those lanes' int32 flags."""
    new = torch.ones_like(keys, dtype=torch.bool)
    new[1:] = keys[1:] != keys[:-1]
    new &= sketch_get(track, keys, t_sizes, t_offsets, t_recips, 1) == 0
    counts = sketch_get(table, keys[new], sizes, offsets, recips, cap)
    counts = counts.to(torch.int64)
    hist.index_add_(0, counts, torch.ones_like(counts))
    return new.to(torch.int32)


def bin_scatter_add(table, idx, vals):
    """table[idx] += vals (u32 wrap-around), any idx inside the table;
    IndexError (and no update) for a bin outside it."""
    if idx.numel():
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= table.numel():
            raise IndexError("bin_scatter_add: bin index out of range")
    table.index_add_(0, idx, vals)

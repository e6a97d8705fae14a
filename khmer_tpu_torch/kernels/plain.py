"""Plain PyTorch versions of the CUDA kernels in csrc/.

Each function computes exactly what its kernel computes, with the same
arguments and the same in-place effects, from ordinary tensor ops (the
two chains, which are sequential, as a host loop over numpy arrays).  The
dispatching wrappers in khmer_tpu_torch.kernels call these for tensors
on the CPU; tests and chip_smoke.py hold each kernel against them.
They work on any device, but no CUDA path of the package calls them.
"""

import numpy as np
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


def row_counts(codes, lengths, k, table, sizes, offsets, recips, cap,
               want_hashes=False):
    """Canonical hash and count (capped at cap) of every window of a
    padded [B, L] batch of codes with lengths[B]: (uint16 counts [B, W],
    0 where the window runs past its row's length, and int64 hashes
    [B, W] or None), W = L - k + 1.  The batch hashes as one flat stream,
    so every window reads the codes the kernel reads."""
    B, L = codes.shape
    W = L - k + 1
    col = torch.arange(L, device=codes.device)
    valid = (col[None, :] + k <= lengths[:, None].to(torch.int64)) & \
        (col[None, :] < W)
    h, _ = hash2bit_canonical(codes.reshape(-1),
                              valid.to(torch.uint8).reshape(-1), k)
    h = h.reshape(B, L)[:, :W].contiguous()
    valid = valid[:, :W]
    counts = torch.zeros((B, W), dtype=torch.int32, device=codes.device)
    counts[valid] = sketch_get(table, h[valid], sizes, offsets, recips,
                               cap).to(torch.int32)
    return counts.to(torch.uint16), h if want_hashes else None


def _bundle_rows(ids, valid, pre):
    """Host arrays of a chain's input: per row r, the valid windows'
    columns cols[off[r]:off[r + 1]] and ids idv[off[r]:off[r + 1]] in
    column order, and pre as int64."""
    B2, nw = ids.shape
    lanes = np.flatnonzero(valid.cpu().numpy().reshape(-1))
    off = np.searchsorted(lanes, np.arange(B2 + 1) * nw)
    idv = ids.cpu().numpy().reshape(-1)[lanes].astype(np.int64)
    return off, lanes % nw, idv, pre.cpu().numpy().astype(np.int64)


def diginorm_chain(ids, valid, real, pre, C):
    """The keep decision of B = B2 // 2 bundles of two rows, in order
    (csrc/chain.cu): cnt = pre[id] + tally[id] per valid window, a bundle
    is kept iff a real row has no valid window or fewer than (n + 1) // 2
    of its n windows with cnt >= C, and a kept bundle's valid windows add
    one to tally.  Returns (uint8 keep [B], int32 tally [len(pre)]).  A
    host loop over the bundles."""
    dev = ids.device
    off, _, idv, pre = _bundle_rows(ids, valid, pre)
    tally = np.zeros(pre.size, np.int64)
    rl = real.cpu().numpy() != 0
    B = ids.shape[0] // 2
    keep = np.zeros(B, np.uint8)
    for b in range(B):
        for r in (2 * b, 2 * b + 1):
            if not rl[r]:
                continue
            x = idv[off[r]: off[r + 1]]
            hits = np.count_nonzero(pre[x] + tally[x] >= C)
            if x.size == 0 or hits < (x.size + 1) // 2:
                keep[b] = 1
                break
        if keep[b]:
            np.add.at(tally, idv[off[2 * b]: off[2 * b + 2]], 1)
    return (torch.from_numpy(keep).to(dev),
            torch.from_numpy(tally.astype(np.uint32).view(np.int32)).to(dev))


def trim_chain(ids, valid, real, pre, trim_at, dn_cov, cutoff):
    """trim-low-abund's pass-1 branch of B = B2 // 2 bundles, in order
    (csrc/chain.cu): a row's median is >= T iff at least n - n // 2 of
    its n valid windows have cnt = pre[id] + tally[id] >= T; branch 0
    when dn_cov is not None and every real row's median is >= dn_cov,
    else 1 when every real row's is >= trim_at, else 2, and only branch-2
    bundles add to tally.  first_bad is each row's first valid window
    with cnt < cutoff before the bundle's own adds (nw if none).  Returns
    (uint8 branch [B], int32 first_bad [B2], int32 tally [len(pre)])."""
    dev = ids.device
    B2, nw = ids.shape
    off, cols, idv, pre = _bundle_rows(ids, valid, pre)
    tally = np.zeros(pre.size, np.int64)
    rl = real.cpu().numpy() != 0
    branch = np.zeros(B2 // 2, np.uint8)
    first_bad = np.full(B2, nw, np.int32)
    for b in range(B2 // 2):
        ok_trim = ok_dn = True
        for r in (2 * b, 2 * b + 1):
            x = idv[off[r]: off[r + 1]]
            cnt = pre[x] + tally[x]
            bad = np.flatnonzero(cnt < cutoff)
            if bad.size:
                first_bad[r] = cols[off[r] + bad[0]]
            if rl[r]:
                need = x.size - x.size // 2
                ok_trim &= np.count_nonzero(cnt >= trim_at) >= need
                if dn_cov is not None:
                    ok_dn &= np.count_nonzero(cnt >= dn_cov) >= need
        branch[b] = 0 if dn_cov is not None and ok_dn else \
            1 if ok_trim else 2
        if branch[b] == 2:
            np.add.at(tally, idv[off[2 * b]: off[2 * b + 2]], 1)
    return (torch.from_numpy(branch).to(dev),
            torch.from_numpy(first_bad).to(dev),
            torch.from_numpy(tally.astype(np.uint32).view(np.int32)).to(dev))

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
from khmer_tpu_torch.ops.encode import COMP_LUT
from khmer_tpu_torch.ops.rollinghash import _COMP_TABLE, _CYCLIC_TABLE


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


def band_mask_weights(hashes, weights, total, band=None, table=None,
                      sizes=None, offsets=None, recips=None, cap=0,
                      threshold=0, consume_masked=False):
    """The weights with every lane zeroed whose hash lies outside band =
    (bmin, bmax) (unsigned) or whose capped mask count fails the threshold
    (<=, or >= with consume_masked); adds their sum (as uint32) to total
    (int64 [1]) and returns them, int32 [n]."""
    keep = torch.ones_like(weights, dtype=torch.bool)
    if band is not None:
        key = _u64.sort_key(hashes)
        keep &= (key >= band[0] + _u64.SIGN) & (key < band[1] + _u64.SIGN)
    if table is not None:
        c = sketch_get(table, hashes, sizes, offsets, recips, cap)
        c = c.to(torch.int64)
        keep &= (c >= threshold) if consume_masked else (c <= threshold)
    out = torch.where(keep, weights, 0)
    total += _u64.u32(out).sum()
    return out


def bin_scatter_add(table, idx, vals):
    """table[idx] += vals (u32 wrap-around), any idx inside the table;
    IndexError (and no update) for a bin outside it."""
    if idx.numel():
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= table.numel():
            raise IndexError("bin_scatter_add: bin index out of range")
    table.index_add_(0, idx, vals)


def row_counts(codes, lengths, k, table, sizes, offsets, recips, cap,
               want_hashes=False, hash_kind="2bit"):
    """Canonical hash and count (capped at cap) of every window of a
    padded [B, L] batch of codes (2-bit codes, or ASCII bytes for
    hash_kind "murmur" and "cyclic") with lengths[B]: (uint16 counts
    [B, W], 0 where the window runs past its row's length, and int64
    hashes [B, W] or None), W = L - k + 1.  The 2-bit batch hashes as
    one flat stream, so every window reads the codes the kernel reads."""
    B, L = codes.shape
    W = L - k + 1
    if hash_kind == "murmur":
        h, valid = murmur_hashes(codes, lengths, k)
    elif hash_kind == "cyclic":
        h, valid = cyclic_hashes(codes, lengths, k)
    else:
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


# MurmurHash3_x64_128's constants, as int64 bit patterns
_C1 = _u64.i64(0x87C37B91114253D5)
_C2 = _u64.i64(0x4CF5AD432745937F)
_F1 = _u64.i64(0xFF51AFD7ED558CCD)
_F2 = _u64.i64(0xC4CEB9FE1A85EC53)

# the bulk-consume complement: only A, C, G and T (khmer's full table is
# ops/encode.py:COMP_LUT)
_COMP_ACGT = np.full(256, ord(" "), np.uint8)
for _a, _b in ("AT", "TA", "CG", "GC"):
    _COMP_ACGT[ord(_a)] = ord(_b)


def _fmix(x):
    x = x ^ _u64.lsr(x, 33)
    x = x * _F1
    x = x ^ _u64.lsr(x, 33)
    x = x * _F2
    return x ^ _u64.lsr(x, 33)


def _murmur_windows(b, W, k):
    """MurmurHash3_x64_128 (h1, h2) of every k-byte window of int64 bytes
    [B, L], columns 0..W-1; each block word is built from eight shifted
    column slices (khmer_tpu/ops/hashing.py:_murmur_windows)."""
    h1 = torch.zeros((b.shape[0], W), dtype=torch.int64, device=b.device)
    h2 = torch.zeros_like(h1)

    def word(off, nbytes=8):
        acc = b[:, off:off + W]
        for i in range(1, nbytes):
            acc = acc | (b[:, off + i:off + i + W] << (8 * i))
        return acc

    for i in range(k // 16):
        k1 = _u64.rotl(word(16 * i) * _C1, 31) * _C2
        h1 = (_u64.rotl(h1 ^ k1, 27) + h2) * 5 + 0x52DCE729
        k2 = _u64.rotl(word(16 * i + 8) * _C2, 33) * _C1
        h2 = (_u64.rotl(h2 ^ k2, 31) + h1) * 5 + 0x38495AB5
    tail, toff = k & 15, k - (k & 15)
    if tail > 8:
        h2 = h2 ^ (_u64.rotl(word(toff + 8, tail - 8) * _C2, 33) * _C1)
    if tail:
        h1 = h1 ^ (_u64.rotl(word(toff, min(tail, 8)) * _C1, 31) * _C2)
    h1 = h1 ^ k
    h2 = h2 ^ k
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    h1 = h1 + h2
    return h1, h2 + h1


def window_valid(lengths, W, k):
    """bool [B, W]: window j of row b ends inside lengths[b]."""
    col = torch.arange(W, device=lengths.device)
    return col[None, :] + k <= lengths[:, None]


def murmur_hashes(byts, lengths, k, assume_acgt=False):
    """Canonical murmur hash of every window of ASCII rows [B, L]: h1 of
    the window xor h1 of its reverse complement (the complemented row,
    reversed, hashed and flipped back), or h1 alone where the two 128-bit
    hashes are equal.  Returns (int64 [B, W], bool valid [B, W])."""
    W = byts.shape[1] - k + 1
    lut = torch.from_numpy(_COMP_ACGT if assume_acgt else COMP_LUT).to(
        byts.device)
    f1, f2 = _murmur_windows(byts.to(torch.int64), W, k)
    crev = lut[byts.to(torch.int64)].to(torch.int64).flip(1)
    r1, r2 = _murmur_windows(crev, W, k)
    r1, r2 = r1.flip(1), r2.flip(1)
    same = (f1 == r1) & (f2 == r2)
    return (torch.where(same, f1, f1 ^ r1).contiguous(),
            window_valid(lengths, W, k))


# the cyclic hash's character table T and its complement C[c] =
# T[comp(c)], as int64 bit patterns
_CYCLIC_T = torch.from_numpy(_CYCLIC_TABLE.view(np.int64))
_CYCLIC_C = torch.from_numpy(_COMP_TABLE.view(np.int64))


def _rotl_mod64(x, r):
    """x rotated left by r mod 64 bits (r = 0 leaves it)."""
    r %= 64
    return _u64.rotl(x, r) if r else x


def cyclic_hashes(byts, lengths, k):
    """Canonical cyclic hash of every window of ASCII rows [B, L]:
    XOR_j rotl(T[s[j]], k - 1 - j) plus XOR_j rotl(C[s[j]], j), wrapping
    mod 2**64 (the int64 add wraps as uint64's does).  Returns (int64
    [B, W], bool valid [B, W])."""
    W = byts.shape[1] - k + 1
    idx = byts.to(torch.int64)
    tf = _CYCLIC_T.to(byts.device)[idx]
    tr = _CYCLIC_C.to(byts.device)[idx]
    h = torch.zeros((byts.shape[0], W), dtype=torch.int64,
                    device=byts.device)
    r = torch.zeros_like(h)
    for j in range(k):
        h ^= _rotl_mod64(tf[:, j:j + W], k - 1 - j)
        r ^= _rotl_mod64(tr[:, j:j + W], j)
    return h + r, window_valid(lengths, W, k)


def hll_update(byts, weights, k, p, m, registers):
    """registers[h & (m - 1)] = max(itself, clz(h >> p) - p + 1) for
    the assume_acgt murmur hash h of every window start i <= n - k of a
    flat chunk whose weight is not 0 (uint8 registers, in place)."""
    n = byts.numel()
    if n < k:
        return
    lengths = torch.full((1,), n, dtype=torch.int32, device=byts.device)
    h = murmur_hashes(byts[None, :], lengths, k, True)[0][0]
    h = h[weights[:n - k + 1] != 0]
    rho = _u64.clz(_u64.lsr(h, p)) - p + 1
    regs = registers.to(torch.int64)
    regs.scatter_reduce_(0, h & (m - 1), rho, "amax")
    registers.copy_(regs.to(torch.uint8))


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


def cc_rounds(labels, src, dst, rounds):
    """`rounds` Jacobi rounds of min-label propagation with pointer
    jumping (khmer_tpu/partition_device.py:42-65) over int32 labels [T]
    and edges src, dst [E] (uint32 bit patterns): each round
    m = lab.at[dst].min(lab[src]); m = m.at[src].min(m[dst]); m = m[m];
    m = m[m].  As in JAX, a gather clamps its index into [0, T) and a
    scatter drops a target outside it.  Returns (int32 labels [T], a bool
    tensor: some round's output differs from its input)."""
    T = labels.numel()
    lab = _u64.u32(labels)
    s, d = _u64.u32(src), _u64.u32(dst)
    s_in, d_in = s < T, d < T
    s_at, d_at = s.clamp(max=T - 1), d.clamp(max=T - 1)
    changed = torch.zeros((), dtype=torch.bool, device=labels.device)
    for _ in range(rounds):
        m = lab.clone()
        m.scatter_reduce_(0, d[d_in], lab[s_at][d_in], "amin")
        m2 = m.clone()
        m2.scatter_reduce_(0, s[s_in], m[d_at][s_in], "amin")
        m2 = m2[m2.clamp(max=T - 1)]
        m2 = m2[m2.clamp(max=T - 1)]
        changed |= (m2 != lab).any()
        lab = m2
    return lab.to(torch.int32), changed


def count_nonzero(table, begin, end):
    """The nonzero bins of table[begin:end], an int64 [1] tensor."""
    return (table[begin:end] != 0).sum().reshape(1)


def pack_oxli_bytes(table, kind, sizes, offsets, bytes_per_table):
    """The OXLI byte stream of every table (csrc/save.cu), uint8 on the
    table's device."""
    cap = {"byte": MAX_KCOUNT, "nibble": 15, "bit": 1}[kind]
    dev = table.device
    outs = []
    for size, off, nb in zip(sizes.tolist(), offsets.tolist(),
                             bytes_per_table):
        t = _u64.u32(table[off: off + size]).clamp(max=cap)
        if kind == "byte":
            outs.append(t.to(torch.uint8))
            continue
        per = 2 if kind == "nibble" else 8
        padded = torch.zeros(nb * per, dtype=torch.int64, device=dev)
        padded[:size] = t
        padded = padded.view(nb, per)
        if kind == "nibble":
            # even bin -> high nibble, odd -> low (storage.hh:268-276)
            outs.append(((padded[:, 0] << 4) | padded[:, 1]).to(torch.uint8))
        else:
            shifts = torch.arange(8, dtype=torch.int64, device=dev)
            outs.append((padded << shifts).sum(1).to(torch.uint8))
    return torch.cat(outs)


# the dead-lane patterns of the sharded consume (khmer_tpu/ops/deferred.py:
# SENTINEL, IDX_SENTINEL and TOTAL_CLAMP) as int64 and int32 bit patterns
SENTINEL = -1
IDX_SENTINEL = -1
TOTAL_CLAMP = 1 << 20
_FLIP32 = -(1 << 31)  # x ^ _FLIP32 orders int32 patterns as uint32


def i32(x):
    """int64 values in [0, 2**32) -> their int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _udiv(x, d):
    """Unsigned x // d for int64 patterns x and a Python int 0 < d < 2**63:
    with x = hi + 2**63 * top and 2**63 = a * d + b, the quotient is
    hi // d + top * (a + (hi % d >= d - b))."""
    top = x < 0
    hi = x & ((1 << 63) - 1)
    q = torch.div(hi, d, rounding_mode="floor")
    a, b = divmod(1 << 63, d)
    carry = (hi - q * d) >= d - b
    return q + top * (a + carry)


def band_owner(hashes, n_shards):
    """Owner shard of every hash (int64 [n]): min(fmix64(h) // ((2**64 -
    1) // n_shards), n_shards - 1)."""
    if n_shards == 1:
        return torch.zeros_like(hashes)
    q = _udiv(_fmix(hashes), ((1 << 64) - 1) // n_shards)
    return q.clamp(max=n_shards - 1)


def band_route(hashes, weights, firsts, n_shards, cap):
    """(hash, weight, first) lanes into [n_shards, cap] send buffers by
    owner, lanes with weight 0 owned by none, in a stable sort's order;
    the owned lanes past cap compacted into leftover buffers [n].
    Unfilled slots are (SENTINEL, 0, IDX_SENTINEL).  Returns (send_h,
    send_w, send_f, left_h, left_w, left_f, int64 n_left [1])."""
    n, dev = hashes.numel(), hashes.device
    owner = torch.where(weights != 0, band_owner(hashes, n_shards),
                        n_shards)
    o_s, order = torch.sort(owner, stable=True)
    h_s, w_s, f_s = hashes[order], weights[order], firsts[order]
    counts = torch.bincount(o_s, minlength=n_shards + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - starts[o_s]
    real = o_s < n_shards
    ok = real & (pos < cap)
    left = real & ~ok
    slot = (o_s * cap + pos)[ok]
    send = []
    for src, fill in ((h_s, SENTINEL), (w_s, 0), (f_s, IDX_SENTINEL)):
        buf = torch.full((n_shards * cap,), fill, dtype=src.dtype,
                         device=dev)
        buf[slot] = src[ok]
        send.append(buf.view(n_shards, cap))
    n_left = left.sum().reshape(1)
    lefts = []
    for src, fill in ((h_s, SENTINEL), (w_s, 0), (f_s, IDX_SENTINEL)):
        buf = torch.full((n,), fill, dtype=src.dtype, device=dev)
        kept = src[left]
        buf[:kept.numel()] = kept
        lefts.append(buf)
    return (*send, *lefts, n_left)


def combine_lanes(keys, wgts, firsts):
    """The distinct live keys (not SENTINEL) of a lane buffer, in
    ascending unsigned order, compacted to the front: each with its total
    min(sum of min(w, 2**20) mod 2**32, 2**20) and its least first
    position (u32); the other slots (SENTINEL, 0, IDX_SENTINEL).  Returns
    (keys, wgts, firsts, int64 n_valid [1])."""
    n, dev = keys.numel(), keys.device
    _, order = torch.sort(_u64.sort_key(keys), stable=True)
    k = keys[order]
    w = _u64.u32(wgts[order]).clamp(max=TOTAL_CLAMP)
    f = _u64.u32(firsts[order])
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = k[1:] != k[:-1]
    rid = torch.cumsum(head, 0) - 1
    runs = k[head]
    tot = torch.zeros(runs.numel(), dtype=torch.int64, device=dev)
    tot.index_add_(0, rid, w)
    tot = (tot & 0xFFFFFFFF).clamp(max=TOTAL_CLAMP)
    first = torch.full((runs.numel(),), (1 << 32) - 1, dtype=torch.int64,
                       device=dev)
    first.scatter_reduce_(0, rid, f, "amin")
    live = runs != SENTINEL
    nv = int(live.sum())
    out_k = torch.full((n,), SENTINEL, dtype=torch.int64, device=dev)
    out_w = torch.zeros(n, dtype=torch.int32, device=dev)
    out_f = torch.full((n,), IDX_SENTINEL, dtype=torch.int32, device=dev)
    out_k[:nv] = runs[live]
    out_w[:nv] = i32(tot[live])
    out_f[:nv] = i32(first[live])
    return out_k, out_w, out_f, torch.full((1,), nv, dtype=torch.int64,
                                           device=dev)


def _live_lanes(keys, wgts, firsts):
    live = (keys != SENTINEL) & (wgts != 0)
    return keys[live], firsts[live]


def claim_scatter(keys, wgts, firsts, sizes, offsets, recips, claim):
    """claim[bin_t(h)] = min(itself, first) (u32) for every table and
    every live lane (key not SENTINEL, weight not 0), in place (recips
    unused)."""
    h, f = _live_lanes(keys, wgts, firsts)
    idx = _bins(h, sizes, offsets).reshape(-1)
    c = claim ^ _FLIP32
    c.scatter_reduce_(0, idx, (f ^ _FLIP32).repeat(sizes.numel()), "amin")
    claim.copy_(c ^ _FLIP32)


def claim_count(keys, wgts, firsts, sizes, offsets, recips, claim, base,
                n_new):
    """n_new (int64 [1]) += the live lanes that hold some table's claim
    (claim[bin_t] == first) where base (None: a virgin table) is 0."""
    h, f = _live_lanes(keys, wgts, firsts)
    idx = _bins(h, sizes, offsets)
    win = claim[idx] == f[None, :]
    if base is not None:
        win &= base[idx] == 0
    n_new += win.any(0).sum()


def sketch_get_tables(table, hashes, sizes, offsets, recips):
    """Every table's bin of every hash, int32 [T, n] (recips unused)."""
    return table[_bins(hashes, sizes, offsets)]


def _owned(hashes, piece, lo, sizes, offsets):
    """([T, n] bins of hashes less lo, [T, n] bool: the piece owns them),
    the bins of the others clamped into the piece."""
    b = _bins(hashes, sizes, offsets) - lo
    own = (b >= 0) & (b < piece.numel())
    return b.clamp(0, max(piece.numel() - 1, 0)), own


def owned_claims(keys, wgts, firsts, piece, lo, sizes, offsets, recips,
                 flags, virgin, cand=None, cand_count=None):
    """K18 on the piece holding bins [lo, lo + piece.numel()): flags[i] =
    1 (int32 [n], in place) where for some owned table t the live lane i
    holds the least first position (u32) of all live lanes in its bin
    and, unless virgin, the bin is 0; with cand, the keys of the live
    lanes whose table-0 bin is owned and whose (virgin ? total : bin +
    total) exceeds 255 (u32) go into cand in lane order, as many as fit,
    and cand_count (int32 [1]) gains their number (recips unused)."""
    live = (keys != SENTINEL) & (wgts != 0)
    if not piece.numel():
        return
    b, own = _owned(keys, piece, lo, sizes, offsets)
    own &= live[None, :]
    f = firsts.expand_as(b)
    claim = torch.full((piece.numel(),), -1, dtype=torch.int32,
                       device=piece.device) ^ _FLIP32
    claim.scatter_reduce_(0, b[own], f[own] ^ _FLIP32, "amin")
    claim ^= _FLIP32
    pre = piece[b]
    win = own & (claim[b] == f)
    if not virgin:
        win &= pre == 0
    flags[win.any(0)] = 1
    if cand is not None:
        base = _u64.u32(wgts) if virgin else \
            (_u64.u32(pre[0]) + _u64.u32(wgts)) & 0xFFFFFFFF
        crossed = keys[own[0] & (base > MAX_KCOUNT)]
        m = min(crossed.numel(), cand.numel())
        cand[:m] = crossed[:m]
        cand_count += crossed.numel()


def owned_add(keys, wgts, piece, lo, sizes, offsets, recips):
    """K19: piece[g - lo] += total (mod 2**32) for every live lane (key
    not SENTINEL, weight not 0) and every table whose bin g the piece
    owns (recips unused)."""
    if not piece.numel():
        return
    b, own = _owned(keys, piece, lo, sizes, offsets)
    own &= ((keys != SENTINEL) & (wgts != 0))[None, :]
    piece.index_add_(0, b[own], wgts.expand_as(b)[own])


def owned_get(keys, piece, lo, sizes, offsets, recips):
    """K20: the unsigned min over the tables whose bin the piece owns of
    piece[g - lo], 2**32 - 1 where it owns none; int32 [n] (recips
    unused)."""
    out = torch.full((keys.numel(),), -1, dtype=torch.int32,
                     device=keys.device)
    if not piece.numel():
        return out
    b, own = _owned(keys, piece, lo, sizes, offsets)
    vals = torch.where(own, piece[b] ^ _FLIP32, (-1) ^ _FLIP32)
    return vals.amin(0) ^ _FLIP32


def _cc_at(x, T):
    return x.clamp(max=T - 1)


def cc_relax(labels, src, dst):
    """One round's relaxes of cc_rounds: m = lab.at[dst].min(lab[src]);
    m.at[src].min(m[dst]) (int32 [T], uint32 bit patterns)."""
    T = labels.numel()
    lab = _u64.u32(labels)
    s, d = _u64.u32(src), _u64.u32(dst)
    s_in, d_in = s < T, d < T
    m = lab.clone()
    m.scatter_reduce_(0, d[d_in], lab[_cc_at(s, T)][d_in], "amin")
    m2 = m.clone()
    m2.scatter_reduce_(0, s[s_in], m[_cc_at(d, T)][s_in], "amin")
    return m2.to(torch.int32)


def cc_jump(m, labels, changed):
    """One round's jumps of cc_rounds: m[m] taken twice (int32 [T]);
    changed (int32 [1]) |= 1 where it differs from labels, the round's
    input."""
    T = m.numel()
    x = _u64.u32(m)
    x = x[_cc_at(x, T)]
    x = x[_cc_at(x, T)]
    changed |= (x != _u64.u32(labels)).any().to(torch.int32)
    return x.to(torch.int32)

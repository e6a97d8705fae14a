"""The port's kernels: one wrapper per kernel, dispatched by device.

For a CUDA tensor a wrapper launches its hand-written kernel (csrc/,
built at first use by _build) on the current stream and adds the
number of kernels it launched to LAUNCHES[name] (KERNELS_PER_CALL: ten
for sketch_update, four a round for cc_rounds, one for the others); for
a CPU tensor it calls the plain PyTorch version in plain.py.  A failed
build or launch raises; nothing falls back.

Tensor conventions: hashes are int64 bit patterns of uint64 (murmur
hashes use all 64 bits); sketch tables are int32 bit patterns of uint32
bins (sum(sizes) + 1 bins);
`sizes`, `offsets` and `recips` (the Barrett reciprocals of the sizes,
ops/sketch_ops.py:barrett_recips, as int64 bit patterns) are int64 [T]
tensors on the table's device.
"""

import ctypes

import torch

from khmer_tpu_torch.kernels import _build, plain

KERNELS = ("hash2bit_canonical", "sketch_update", "sketch_get",
           "abund_hist", "bin_scatter_add", "row_counts", "diginorm_chain",
           "trim_chain", "murmur_hashes", "hll_update", "cc_rounds",
           "cyclic_hashes", "band_mask_weights", "count_nonzero",
           "pack_oxli_bytes", "band_route", "combine_lanes",
           "claim_scatter", "claim_count", "sketch_get_tables", "cc_relax",
           "cc_jump", "owned_claims", "owned_add", "owned_get")
LAUNCHES = dict.fromkeys(KERNELS, 0)
# row_counts' launches by hash kind (its 2-bit, murmur and cyclic variants)
ROW_COUNTS_BY_HASH = {"2bit": 0, "murmur": 0, "cyclic": 0}
MURMUR_MAX_K = 255  # csrc/murmur.cuh kMaxK
CYCLIC_MAX_K = 255  # csrc/cyclic.cuh kMaxK
# sketch_update is the partitioned update of csrc/sketch.cu: count,
# bucket scan, bucket, partition count, two scan launches, place, apply,
# hot and finish; cc_rounds launches CC_KERNELS_PER_ROUND a round;
# band_route counts, scans and places; combine_lanes inserts and
# compacts; cc_relax relaxes twice and cc_jump jumps twice; K17
# (claim_news) is claim_scatter and claim_count, a launch each; K18
# (owned_claims) claims, then flags
KERNELS_PER_CALL = dict(dict.fromkeys(KERNELS, 1), sketch_update=10,
                        band_route=3, combine_lanes=2, cc_relax=2,
                        cc_jump=2, owned_claims=2)
CC_KERNELS_PER_ROUND = 4  # csrc/cc.cu: two relaxes, two pointer jumps
CC_BLOCK = 8  # rounds a call of connected_components (khmer_tpu's block)
MAX_CC = (1 << 31) - 1  # nodes and edges: K10 indexes labels as int32
MAX_TABLES = 32               # khmer's -N; tested at 1, 3, 4 and 32
MAX_RECORDS = (1 << 31) - 1   # records (lanes x tables) carry int32 offsets
MAX_BINS = 1 << 33            # K2's bucket pass keeps a counter per bucket
                              # in shared memory
# what the last diginorm_chain / trim_chain call on the card took: name ->
# int32 [2] on the device, (rounds, bundles walked), written by the kernel
# (read it after the call; the wrapper does not synchronise)
CHAIN_ROUNDS = {}
CHAIN_WALK_BELOW = 32    # csrc/chain.cu kWalkBelow
CHAIN_WALK_FIRST = 1024  # csrc/chain.cu kWalkFirst
CHAIN_MAX_ROUNDS = 63  # csrc/chain.cu kMaxRounds: a tag is round << 26 | ~b
MAX_CHAIN_BUNDLES = (1 << 26) - 1
_META_WORDS = 8               # csrc/sketch.cu kMetaWords
MAX_SHARDS = 256              # csrc/route.cu kMaxShards
MAX_LANES = (1 << 31) - 1     # K15 and K16 rank lanes as int32


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0
    for kind in ROW_COUNTS_BY_HASH:
        ROW_COUNTS_BY_HASH[kind] = 0


def _check(name, t, dtype, device):
    if t.dtype != dtype:
        raise TypeError("{}: expected {}, got {}".format(name, dtype,
                                                         t.dtype))
    if t.device != device:
        raise ValueError("{}: tensor on {}, expected {}".format(
            name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("{}: tensor is not contiguous".format(name))


def _check_geometry(table, sizes, offsets, recips):
    dev = table.device
    _check("table", table, torch.int32, dev)
    for name, t in (("sizes", sizes), ("offsets", offsets),
                    ("recips", recips)):
        _check(name, t, torch.int64, dev)
    if not 0 < sizes.numel() <= MAX_TABLES or \
            offsets.numel() != sizes.numel() or \
            recips.numel() != sizes.numel():
        raise ValueError("need 1..{} tables with one offset and one "
                         "reciprocal each".format(MAX_TABLES))


def _partition_work(n_records, nbins, dev):
    """Scratch and zeroed meta words of one sketch_update call."""
    if n_records > MAX_RECORDS:
        raise ValueError("{} records exceed {}".format(n_records,
                                                       MAX_RECORDS))
    nbytes = _build.function("khmer_partition_scratch_bytes")(n_records,
                                                              nbins)
    return (torch.empty(nbytes, dtype=torch.uint8, device=dev),
            torch.zeros(_META_WORDS, dtype=torch.int32, device=dev))


def _launch(name, dev, *args, entry=None, count=None):
    """Call the C entry point of kernel `name` on dev's current stream,
    with dev as the current device (the kernels launch on the calling
    thread's current device, which may be another card than dev's)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.function(entry or "khmer_" + name)(
            *args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("{} launch failed with CUDA error {}".format(
            name, err))
    LAUNCHES[name] += KERNELS_PER_CALL[name] if count is None else count


def hash2bit_canonical(codes, mask, k):
    """K1: canonical 2-bit hash and weight of every window start of a
    flat chunk of 2-bit codes (uint8 [n]) with the loader's window mask
    (uint8 [n]).  Returns (int64 hashes [n], int32 weights [n]) in
    stream order; see csrc/hash2bit.cu."""
    dev = codes.device
    _check("codes", codes, torch.uint8, dev)
    _check("mask", mask, torch.uint8, dev)
    if mask.numel() != codes.numel() or not 1 <= k <= 32:
        raise ValueError("hash2bit_canonical: bad mask length or k")
    if dev.type != "cuda":
        return plain.hash2bit_canonical(codes, mask, k)
    n = codes.numel()
    hashes = torch.empty(n, dtype=torch.int64, device=dev)
    weights = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("hash2bit_canonical", dev, codes.data_ptr(), mask.data_ptr(),
                n, k, hashes.data_ptr(), weights.data_ptr())
    return hashes, weights


def sketch_update(table, hashes, weights, sizes, offsets, recips, n_unique,
                  cand=None, cand_count=None):
    """K2: add weighted hashes to the sketch with the exact sequential
    claim rule (lane order is insertion order).  Adds the new lanes to
    n_unique (int64 [1]); with cand (int64 [cap]) and cand_count (int32
    [1], zeroed by the caller) it records the lanes whose table-0 bin
    now exceeds 255.  Returns is_new, bool [n].  On the card the update
    allocates a per-call scratch of about 21 bytes per record (lanes x
    tables), never one as large as the table."""
    dev = table.device
    _check_geometry(table, sizes, offsets, recips)
    _check("hashes", hashes, torch.int64, dev)
    _check("weights", weights, torch.int32, dev)
    _check("n_unique", n_unique, torch.int64, dev)
    if weights.numel() != hashes.numel():
        raise ValueError("sketch_update: mismatched lengths")
    if table.numel() > MAX_BINS:
        raise ValueError("sketch_update: more than {} bins".format(MAX_BINS))
    if cand is not None:
        _check("cand", cand, torch.int64, dev)
        _check("cand_count", cand_count, torch.int32, dev)
    if dev.type != "cuda":
        return plain.sketch_update(table, hashes, weights, sizes, offsets,
                                   recips, n_unique, cand, cand_count)
    n = hashes.numel()
    is_new = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        scratch, meta = _partition_work(n * sizes.numel(), table.numel(),
                                        dev)
        _launch("sketch_update", dev, table.data_ptr(), table.numel(),
                hashes.data_ptr(), weights.data_ptr(), n, sizes.numel(),
                sizes.data_ptr(), offsets.data_ptr(), recips.data_ptr(),
                scratch.data_ptr(), meta.data_ptr(), is_new.data_ptr(),
                n_unique.data_ptr(),
                cand.data_ptr() if cand is not None else None,
                cand.numel() if cand is not None else 0,
                cand_count.data_ptr() if cand is not None else None)
    return is_new


def sketch_get(table, hashes, sizes, offsets, recips, cap):
    """K3: min over tables of the bin totals, capped at cap (255, 65535
    or 1); uint16 [n]."""
    dev = table.device
    _check_geometry(table, sizes, offsets, recips)
    _check("hashes", hashes, torch.int64, dev)
    if dev.type != "cuda":
        return plain.sketch_get(table, hashes, sizes, offsets, recips, cap)
    n = hashes.numel()
    out = torch.empty(n, dtype=torch.uint16, device=dev)
    if n:
        _launch("sketch_get", dev, table.data_ptr(), hashes.data_ptr(), n,
                sizes.numel(), sizes.data_ptr(), offsets.data_ptr(),
                recips.data_ptr(), int(cap), out.data_ptr())
    return out


def abund_hist(keys, table, sizes, offsets, recips, track, t_sizes,
               t_offsets, t_recips, cap, hist):
    """K4: one membership window of abundance-dist.  Lane i of keys
    (int64 [n]) counts iff it starts a run of equal keys (i == 0 or
    keys[i-1] != keys[i]) and its min over the tracking sketch's tables
    is 0; each counted lane adds one to hist[min(count, cap)], where
    count is its min over the main sketch's tables.  hist is int64
    [65536], updated in place; returns the int32 [n] flags of the
    counted lanes (the weights with which the caller adds the keys to
    tracking).  Distinct keys in any order, or sorted keys with
    duplicates."""
    dev = table.device
    _check_geometry(table, sizes, offsets, recips)
    _check_geometry(track, t_sizes, t_offsets, t_recips)
    _check("keys", keys, torch.int64, dev)
    _check("hist", hist, torch.int64, dev)
    _check("track", track, torch.int32, dev)
    if hist.numel() <= cap:
        raise ValueError("abund_hist: histogram shorter than cap + 1")
    if dev.type != "cuda":
        return plain.abund_hist(keys, table, sizes, offsets, recips, track,
                                t_sizes, t_offsets, t_recips, cap, hist)
    n = keys.numel()
    new = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("abund_hist", dev, keys.data_ptr(), n, table.data_ptr(),
                sizes.numel(), sizes.data_ptr(), offsets.data_ptr(),
                recips.data_ptr(), track.data_ptr(), t_sizes.numel(),
                t_sizes.data_ptr(), t_offsets.data_ptr(), t_recips.data_ptr(),
                int(cap), hist.data_ptr(), new.data_ptr())
    return new


def band_mask_weights(hashes, weights, total, band=None, table=None,
                      sizes=None, offsets=None, recips=None, cap=0,
                      threshold=0, consume_masked=False):
    """K12: the band and mask filters of a consume.  Lane i keeps its
    weight (int32 [n], a uint32 bit pattern) when its hash (int64 [n])
    lies in band = (bmin, bmax), bmin <= h < bmax unsigned, and, with a
    mask sketch (table, sizes, offsets, recips: its own geometry), when
    the hash's count there, capped at cap, is <= threshold (>= threshold
    with consume_masked); else its weight becomes 0.  At least one of band
    and table is given.  Adds the sum of the new weights (as uint32) to
    total (int64 [1], a uint64 bit pattern), in place, and returns the
    new weights, int32 [n]; see csrc/filter.cu."""
    dev = hashes.device
    _check("hashes", hashes, torch.int64, dev)
    _check("weights", weights, torch.int32, dev)
    _check("total", total, torch.int64, dev)
    if hashes.dim() != 1 or weights.shape != hashes.shape or \
            total.numel() != 1:
        raise ValueError("band_mask_weights: need hashes and weights [n] "
                         "and total [1]")
    if band is None and table is None:
        raise ValueError("band_mask_weights: need a band, a mask or both")
    if band is not None and not 0 <= band[0] <= band[1] < 1 << 64:
        raise ValueError("band_mask_weights: need 0 <= bmin <= bmax < 2**64")
    if table is not None:
        _check_geometry(table, sizes, offsets, recips)
        if table.device != dev:
            raise ValueError("band_mask_weights: mask on {}, hashes on "
                             "{}".format(table.device, dev))
        if not 0 <= threshold < 1 << 32:
            raise ValueError("band_mask_weights: threshold must be in "
                             "[0, 2**32)")
    if dev.type != "cuda":
        return plain.band_mask_weights(hashes, weights, total, band, table,
                                       sizes, offsets, recips, cap,
                                       threshold, consume_masked)
    n = hashes.numel()
    out = torch.empty_like(weights)
    if n:
        bmin, bmax = (0, 0) if band is None else band
        masked = table is not None
        _launch("band_mask_weights", dev, hashes.data_ptr(),
                weights.data_ptr(), n, band is not None, int(bmin), int(bmax),
                table.data_ptr() if masked else None,
                sizes.numel() if masked else 0,
                sizes.data_ptr() if masked else None,
                offsets.data_ptr() if masked else None,
                recips.data_ptr() if masked else None, int(cap),
                int(threshold), bool(consume_masked), out.data_ptr(),
                total.data_ptr())
    return out


def bin_scatter_add(table, idx, vals):
    """table[idx] += vals for int32 (uint32 bit pattern) table and vals
    and int64 idx; any bins, duplicates summed.  A bin outside
    [0, table.numel()) raises IndexError; on the card the other lanes
    have then been added already (the table is partly updated, as with
    index_add_), because the kernel counts and skips such lanes and the
    wrapper reads that count once after the launch."""
    dev = table.device
    _check("table", table, torch.int32, dev)
    _check("idx", idx, torch.int64, dev)
    _check("vals", vals, torch.int32, dev)
    if idx.numel() != vals.numel():
        raise ValueError("bin_scatter_add: mismatched lengths")
    if dev.type != "cuda":
        return plain.bin_scatter_add(table, idx, vals)
    n = idx.numel()
    if n:
        bad = torch.empty(1, dtype=torch.int32, device=dev)
        _launch("bin_scatter_add", dev, table.data_ptr(), table.numel(),
                idx.data_ptr(), vals.data_ptr(), n, bad.data_ptr())
        if int(bad):
            raise IndexError("bin_scatter_add: bin index out of range")


def row_counts(codes, lengths, k, table, sizes, offsets, recips, cap,
               want_hashes=False, hash_kind="2bit"):
    """K5: canonical hash and count of every window of a padded batch of
    rows, uint8 [B, L] with lengths int32 [B] (each <= L): 2-bit codes and
    1 <= k <= 32 for hash_kind "2bit", ASCII bytes and 1 <= k <= 255 for
    "murmur" (the hash of murmur_hashes with khmer's full complement
    table) and "cyclic" (K5c, the hash of cyclic_hashes).  Returns
    (uint16 counts [B, W], capped at cap, 0 for a window that runs past
    its row's length; int64 hashes [B, W] when want_hashes, else None),
    W = L - k + 1; see csrc/rows.cu."""
    dev = table.device
    _check_geometry(table, sizes, offsets, recips)
    _check("codes", codes, torch.uint8, dev)
    _check("lengths", lengths, torch.int32, dev)
    kmax = {"2bit": 32, "murmur": MURMUR_MAX_K,
            "cyclic": CYCLIC_MAX_K}.get(hash_kind)
    if kmax is None:
        raise ValueError("row_counts: unknown hash kind {!r}".format(
            hash_kind))
    if codes.dim() != 2 or lengths.shape != codes.shape[:1] or \
            not 1 <= k <= kmax or codes.shape[1] < k:
        raise ValueError("row_counts: need codes [B, L >= k], lengths [B] "
                         "and 1 <= k <= {}".format(kmax))
    if dev.type != "cuda":
        return plain.row_counts(codes, lengths, k, table, sizes, offsets,
                                recips, cap, want_hashes, hash_kind)
    B, L = codes.shape
    W = L - k + 1
    counts = torch.empty((B, W), dtype=torch.uint16, device=dev)
    hashes = torch.empty((B, W), dtype=torch.int64, device=dev) \
        if want_hashes else None
    if B:
        _launch("row_counts", dev, codes.data_ptr(), lengths.data_ptr(), B, L,
                k, table.data_ptr(), sizes.numel(), sizes.data_ptr(),
                offsets.data_ptr(), recips.data_ptr(), int(cap),
                counts.data_ptr(), hashes.data_ptr() if want_hashes else None,
                entry="khmer_row_counts" + ("" if hash_kind == "2bit" else
                                            "_" + hash_kind))
        ROW_COUNTS_BY_HASH[hash_kind] += 1
    return counts, hashes


def murmur_hashes(byts, lengths, k, assume_acgt=False):
    """K8: canonical murmur hash (MurmurHash3_x64_128's h1 of the window
    xor that of its reverse complement, or h1 alone where the two 128-bit
    hashes are equal) of every window of a padded batch of ASCII rows,
    byts uint8 [B, L] with lengths int32 [B], 1 <= k <= 255.  With
    assume_acgt the complement maps A, C, G, T and everything else to
    ' ' (bulk consume); otherwise khmer's full IUPAC table.  Returns
    (int64 hashes [B, W], bool valid [B, W]: the window ends inside its
    row's length), W = L - k + 1; a window that is not valid still hashes
    the bytes it covers.  See csrc/murmur.cu."""
    dev = byts.device
    _check("byts", byts, torch.uint8, dev)
    _check("lengths", lengths, torch.int32, dev)
    if byts.dim() != 2 or lengths.shape != byts.shape[:1] or \
            not 1 <= k <= MURMUR_MAX_K or byts.shape[1] < k:
        raise ValueError("murmur_hashes: need byts [B, L >= k], lengths [B] "
                         "and 1 <= k <= {}".format(MURMUR_MAX_K))
    if dev.type != "cuda":
        return plain.murmur_hashes(byts, lengths, k, assume_acgt)
    B, L = byts.shape
    W = L - k + 1
    hashes = torch.empty((B, W), dtype=torch.int64, device=dev)
    if B:
        _launch("murmur_hashes", dev, byts.data_ptr(), B, L, k,
                int(assume_acgt), hashes.data_ptr())
    return hashes, plain.window_valid(lengths, W, k)


def cyclic_hashes(byts, lengths, k):
    """K11: canonical cyclic hash (khmer_tpu/ops/rollinghash.py: the XOR
    of the window's rotated table entries plus that of its reverse
    strand, mod 2**64) of every window of a padded batch of ASCII rows,
    byts uint8 [B, L] with lengths int32 [B], 1 <= k <= 255.  Every byte
    has its own table entry; only A, C, G and T (either case) are
    complemented.  Returns (int64 hashes [B, W], bool valid [B, W]: the
    window ends inside its row's length), W = L - k + 1; a window that is
    not valid still hashes the bytes it covers.  See csrc/cyclic.cu."""
    dev = byts.device
    _check("byts", byts, torch.uint8, dev)
    _check("lengths", lengths, torch.int32, dev)
    if byts.dim() != 2 or lengths.shape != byts.shape[:1] or \
            not 1 <= k <= CYCLIC_MAX_K or byts.shape[1] < k:
        raise ValueError("cyclic_hashes: need byts [B, L >= k], lengths [B] "
                         "and 1 <= k <= {}".format(CYCLIC_MAX_K))
    if dev.type != "cuda":
        return plain.cyclic_hashes(byts, lengths, k)
    B, L = byts.shape
    W = L - k + 1
    hashes = torch.empty((B, W), dtype=torch.int64, device=dev)
    if B:
        _launch("cyclic_hashes", dev, byts.data_ptr(), B, L, k,
                hashes.data_ptr())
    return hashes, plain.window_valid(lengths, W, k)


def hll_update(byts, weights, k, p, m, registers):
    """K9: HyperLogLog update of a flat chunk of ASCII bytes (uint8 [n])
    with window weights (uint8 [n]): every window start i <= n - k whose
    weight is not 0 raises registers[h & (m - 1)] to rho = clz(h >> p) -
    p + 1, h its assume_acgt murmur hash.  registers is uint8 [>= m],
    a multiple of 4 bytes, updated in place; 4 <= p <= 16 and
    2**p <= m < 2**(p + 1) (m = 2**p but for an explicit register
    count).  See csrc/hll.cu."""
    dev = registers.device
    _check("byts", byts, torch.uint8, dev)
    _check("weights", weights, torch.uint8, dev)
    _check("registers", registers, torch.uint8, dev)
    if byts.dim() != 1 or weights.shape != byts.shape or \
            not 4 <= p <= 16 or not 1 << p <= m < 2 << p or \
            registers.numel() < m or registers.numel() % 4 or \
            not 1 <= k <= MURMUR_MAX_K:
        raise ValueError("hll_update: need byts and weights [n], 1 <= k <= "
                         "{}, 4 <= p <= 16, 2**p <= m < 2**(p + 1) and m "
                         "registers, padded to 4 bytes".format(MURMUR_MAX_K))
    if dev.type != "cuda":
        return plain.hll_update(byts, weights, k, p, m, registers)
    n = byts.numel()
    if n >= k:
        _launch("hll_update", dev, byts.data_ptr(), weights.data_ptr(), n, k,
                p, m, registers.data_ptr())


def _check_chain(ids, valid, real, pre):
    dev = ids.device
    _check("ids", ids, torch.int32, dev)
    _check("valid", valid, torch.uint8, dev)
    _check("real", real, torch.uint8, dev)
    _check("pre", pre, torch.uint16, dev)
    if ids.dim() != 2 or ids.shape[0] % 2 or valid.shape != ids.shape or \
            real.shape != ids.shape[:1]:
        raise ValueError("chain: need ids and valid [2B, nw], real [2B]")
    return dev, ids.shape[0] // 2, ids.shape[1]


def _chain_scratch(name, B, n_distinct, dev):
    """The tally and the zeroed scratch (csrc/chain.cu: state, tags for
    two rounds, a byte per bundle) of one K6 / K7 call on the card."""
    if B > MAX_CHAIN_BUNDLES:
        raise ValueError("{}: {} bundles exceed {}".format(
            name, B, MAX_CHAIN_BUNDLES))
    # the kernel writes every tally entry; with no bundle it launches none
    tally = (torch.empty if B else torch.zeros)(
        n_distinct, dtype=torch.int32, device=dev)
    scratch = torch.zeros(
        _build.function("khmer_chain_scratch_bytes")(B, n_distinct),
        dtype=torch.uint8, device=dev)
    return tally, scratch


def _keep_rounds(name, scratch):
    """CHAIN_ROUNDS[name]: a copy of the scratch's first two int32, the
    rounds the call took and the bundles it walked (a copy, so that the
    scratch is freed when the call returns)."""
    CHAIN_ROUNDS[name] = scratch[:8].view(torch.int32).clone()


def diginorm_chain(ids, valid, real, pre, C):
    """K6: normalize-by-median's keep decision over B bundles of two rows
    (ids int32 [2B, nw]: each valid window's rank among the batch's
    distinct k-mers; valid uint8 [2B, nw]; real uint8 [2B]; pre uint16
    [n_distinct]: each distinct k-mer's count before the batch), in
    bundle order.  Returns (uint8 keep [B], int32 tally [n_distinct]: the
    kept bundles' valid windows per k-mer); see csrc/chain.cu."""
    dev, B, nw = _check_chain(ids, valid, real, pre)
    if dev.type != "cuda":
        return plain.diginorm_chain(ids, valid, real, pre, C)
    tally, scratch = _chain_scratch("diginorm_chain", B, pre.numel(), dev)
    keep = torch.empty(B, dtype=torch.uint8, device=dev)
    if B:
        _launch("diginorm_chain", dev, ids.data_ptr(), valid.data_ptr(),
                real.data_ptr(), pre.data_ptr(), B, nw, int(C),
                tally.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
                pre.numel())
    _keep_rounds("diginorm_chain", scratch)
    return keep, tally


def trim_chain(ids, valid, real, pre, trim_at, dn_cov, cutoff):
    """K7: trim-low-abund's pass-1 branch over B bundles (inputs as
    diginorm_chain): 0 skip (only when dn_cov is not None), 1 trim now, 2
    save; only saved bundles add to tally.  Returns (uint8 branch [B],
    int32 first_bad [2B]: each row's first valid window whose count is
    below cutoff, nw if none; int32 tally [n_distinct]); see
    csrc/chain.cu."""
    dev, B, nw = _check_chain(ids, valid, real, pre)
    if dev.type != "cuda":
        return plain.trim_chain(ids, valid, real, pre, trim_at, dn_cov,
                                cutoff)
    tally, scratch = _chain_scratch("trim_chain", B, pre.numel(), dev)
    branch = torch.empty(B, dtype=torch.uint8, device=dev)
    first_bad = torch.empty(2 * B, dtype=torch.int32, device=dev)
    if B:
        _launch("trim_chain", dev, ids.data_ptr(), valid.data_ptr(),
                real.data_ptr(), pre.data_ptr(), B, nw, int(trim_at),
                0 if dn_cov is None else int(dn_cov), dn_cov is not None,
                int(cutoff), tally.data_ptr(), branch.data_ptr(),
                first_bad.data_ptr(), scratch.data_ptr(), pre.numel())
    _keep_rounds("trim_chain", scratch)
    return branch, first_bad, tally


def check_cc_sizes(n_nodes, n_edges):
    """Raise ValueError unless K10 can index n_nodes labels and n_edges
    edges (each below 2**31: labels are int32 bit patterns)."""
    if not 0 <= n_nodes <= MAX_CC or not 0 <= n_edges <= MAX_CC:
        raise ValueError("cc_rounds: {} nodes and {} edges; each must be "
                         "below 2**31".format(n_nodes, n_edges))


def cc_rounds(labels, src, dst, rounds=8):
    """K10: `rounds` rounds of min-label propagation with pointer jumping
    over int32 labels [T] (uint32 bit patterns, normally node indices)
    and edges src, dst int32 [E] (padding edges (0, 0) relax nothing),
    as khmer_tpu/partition_device.py:cc_rounds computes them: each round
    relaxes every edge towards dst from the round's labels, then towards
    src from that result, then jumps m = m[m] twice.  Returns (new int32
    labels [T], in a new tensor; a bool tensor on the device: some
    round changed a label), without synchronising.  See csrc/cc.cu."""
    dev = labels.device
    for name, t in (("labels", labels), ("src", src), ("dst", dst)):
        _check(name, t, torch.int32, dev)
        if t.dim() != 1:
            raise ValueError("cc_rounds: {} must be 1-D".format(name))
    if src.shape != dst.shape or rounds < 1:
        raise ValueError("cc_rounds: need src and dst of one length and "
                         "rounds >= 1")
    T, E = labels.numel(), src.numel()
    check_cc_sizes(T, E)
    if T == 0:
        return labels.clone(), torch.zeros((), dtype=torch.bool,
                                           device=dev)
    if dev.type != "cuda":
        return plain.cc_rounds(labels, src, dst, rounds)
    out = torch.empty_like(labels)
    scratch = torch.empty(2 * T, dtype=torch.int32, device=dev)
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    _launch("cc_rounds", dev, labels.data_ptr(), src.data_ptr(),
            dst.data_ptr(), T, E, rounds, out.data_ptr(), scratch.data_ptr(),
            changed.data_ptr(), count=CC_KERNELS_PER_ROUND * rounds)
    return out, changed[0] != 0


def count_nonzero(table, begin, end):
    """K13: the number of nonzero bins of table[begin:end] (int32 bit
    patterns of u32 bins) as an int64 [1] tensor on the table's device,
    without synchronising; see csrc/save.cu."""
    dev = table.device
    _check("table", table, torch.int32, dev)
    if not 0 <= begin <= end <= table.numel():
        raise ValueError("count_nonzero: need 0 <= begin <= end <= "
                         "{}".format(table.numel()))
    if dev.type != "cuda":
        return plain.count_nonzero(table, begin, end)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    if end > begin:
        _launch("count_nonzero", dev, table.data_ptr(), begin, end,
                total.data_ptr())
    return total


PACK_KINDS = ("byte", "nibble", "bit")  # csrc/save.cu kKindByte, ...


def pack_oxli_bytes(table, kind, sizes, offsets, bytes_per_table):
    """K14: the OXLI byte stream of every table of a sketch ('byte':
    min(bin, 255); 'nibble': two bins a byte, the even one high, capped at
    15, with a pad nibble; 'bit': eight bins a byte, least significant
    first), uint8 [sum(bytes_per_table)] on the table's device; sizes
    and offsets as the geometry's int64 [T] tensors, bytes_per_table the
    stream bytes of each table (SketchSpec.bytes_per_table).  Bins compare
    unsigned, so bins >= 2**31 saturate.  See csrc/save.cu."""
    dev = table.device
    _check("table", table, torch.int32, dev)
    _check("sizes", sizes, torch.int64, dev)
    _check("offsets", offsets, torch.int64, dev)
    if kind not in PACK_KINDS:
        raise ValueError("pack_oxli_bytes: unknown kind {!r}".format(kind))
    T = sizes.numel()
    if not 0 < T <= MAX_TABLES or offsets.numel() != T or \
            len(bytes_per_table) != T:
        raise ValueError("pack_oxli_bytes: need 1..{} tables with one "
                         "offset and one byte count each".format(MAX_TABLES))
    if dev.type != "cuda":
        return plain.pack_oxli_bytes(table, kind, sizes, offsets,
                                     bytes_per_table)
    starts = [0]
    for nb in bytes_per_table[:-1]:
        starts.append(starts[-1] + int(nb))
    n_out = starts[-1] + int(bytes_per_table[-1])
    out_offs = torch.tensor(starts, dtype=torch.int64, device=dev)
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    _launch("pack_oxli_bytes", dev, table.data_ptr(), PACK_KINDS.index(kind),
            T, sizes.data_ptr(), offsets.data_ptr(), out_offs.data_ptr(),
            n_out, out.data_ptr())
    return out


def _check_lanes(name, keys, wgts, firsts):
    """The (int64 key, int32 weight, int32 first) lanes of one buffer."""
    dev = keys.device
    _check("keys", keys, torch.int64, dev)
    _check("weights", wgts, torch.int32, dev)
    _check("firsts", firsts, torch.int32, dev)
    if keys.dim() != 1 or wgts.shape != keys.shape or \
            firsts.shape != keys.shape:
        raise ValueError("{}: need keys, weights and firsts [n]".format(name))
    if keys.numel() > MAX_LANES:
        raise ValueError("{}: {} lanes exceed {}".format(
            name, keys.numel(), MAX_LANES))
    return dev, keys.numel()


def _dead_lanes(shape, dev):
    """(SENTINEL keys, zero weights, IDX_SENTINEL firsts) of a shape."""
    return (torch.full(shape, plain.SENTINEL, dtype=torch.int64, device=dev),
            torch.zeros(shape, dtype=torch.int32, device=dev),
            torch.full(shape, plain.IDX_SENTINEL, dtype=torch.int32,
                       device=dev))


def band_route(hashes, weights, firsts, n_shards, cap):
    """K15: route (hash int64, weight int32, first int32) lanes [n] to
    their hash-band owners (plain.band_owner; a lane with weight 0 has
    none): lane i goes to slot pos of its owner's row of the [n_shards,
    cap] send buffers when pos, its rank among that owner's lanes in lane
    order, is below cap; the owned lanes past cap are compacted into the
    leftover buffers [n] in (owner, lane) order.  Unfilled slots are
    (2**64 - 1, 0, 2**32 - 1).  Returns (send_h, send_w, send_f, left_h,
    left_w, left_f, int64 n_left [1]) without synchronising; see
    csrc/route.cu."""
    dev, n = _check_lanes("band_route", hashes, weights, firsts)
    if not 1 <= n_shards <= MAX_SHARDS or cap < 1:
        raise ValueError("band_route: need 1 <= n_shards <= {} and cap >= "
                         "1".format(MAX_SHARDS))
    if dev.type != "cuda":
        return plain.band_route(hashes, weights, firsts, n_shards, cap)
    send = _dead_lanes((n_shards, cap), dev) if n == 0 else (
        torch.empty((n_shards, cap), dtype=torch.int64, device=dev),
        torch.empty((n_shards, cap), dtype=torch.int32, device=dev),
        torch.empty((n_shards, cap), dtype=torch.int32, device=dev))
    left = (torch.empty(n, dtype=torch.int64, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    n_left = torch.zeros(1, dtype=torch.int64, device=dev)
    if n:
        words = _build.function("khmer_route_scratch_words")(n, n_shards)
        counts = torch.empty(words, dtype=torch.int32, device=dev)
        total = torch.empty(n_shards + 1, dtype=torch.int64, device=dev)
        _launch("band_route", dev, hashes.data_ptr(), weights.data_ptr(),
                firsts.data_ptr(), n, n_shards, int(cap),
                *(t.data_ptr() for t in send), *(t.data_ptr() for t in left),
                n_left.data_ptr(), counts.data_ptr(), total.data_ptr())
    return (*send, *left, n_left)


def combine_lanes(keys, wgts, firsts):
    """K16: combine the duplicate keys of a lane buffer (int64 keys, int32
    weights and first positions, [n]; keys 2**64 - 1 are dead): the
    distinct live keys compacted to the front, each with its total
    min(sum of min(w, 2**20) mod 2**32, 2**20) and its least first
    position (unsigned), the other slots (2**64 - 1, 0, 2**32 - 1).
    Returns (keys, wgts, firsts, int64 n_valid [1]) without
    synchronising.  The order of the distinct keys is unspecified (the
    plain version sorts them); see csrc/combine.cu."""
    dev, n = _check_lanes("combine_lanes", keys, wgts, firsts)
    if dev.type != "cuda":
        return plain.combine_lanes(keys, wgts, firsts)
    out = _dead_lanes((n,), dev) if n == 0 else (
        torch.empty(n, dtype=torch.int64, device=dev),
        torch.empty(n, dtype=torch.int32, device=dev),
        torch.empty(n, dtype=torch.int32, device=dev))
    n_valid = torch.zeros(1, dtype=torch.int64, device=dev)
    if n:
        S = max(64, 1 << (2 * n - 1).bit_length())
        slots = torch.empty(2 * S, dtype=torch.int64, device=dev)
        _launch("combine_lanes", dev, keys.data_ptr(), wgts.data_ptr(),
                firsts.data_ptr(), n, *(t.data_ptr() for t in out),
                n_valid.data_ptr(), slots.data_ptr(), S)
    return (*out, n_valid)


def _check_claims(keys, wgts, firsts, sizes, offsets, recips, claim):
    dev, n = _check_lanes("claim_news", keys, wgts, firsts)
    _check_geometry(claim, sizes, offsets, recips)
    if claim.device != dev:
        raise ValueError("claim_news: claims on {}, lanes on {}".format(
            claim.device, dev))
    return dev, n


def claim_scatter(keys, wgts, firsts, sizes, offsets, recips, claim):
    """K17 (a): claim[off_t + h % p_t] = min(itself, first), unsigned, for
    every table t and every live lane (key not 2**64 - 1, weight not 0),
    in place; claim is int32 [total bins (+1)], uint32 bit patterns, set
    to 2**32 - 1 before the first call.  See csrc/claims.cu."""
    dev, n = _check_claims(keys, wgts, firsts, sizes, offsets, recips,
                           claim)
    if dev.type != "cuda":
        return plain.claim_scatter(keys, wgts, firsts, sizes, offsets,
                                   recips, claim)
    if n:
        _launch("claim_scatter", dev, keys.data_ptr(), wgts.data_ptr(),
                firsts.data_ptr(), n, sizes.numel(), sizes.data_ptr(),
                offsets.data_ptr(), recips.data_ptr(), claim.data_ptr())


def claim_count(keys, wgts, firsts, sizes, offsets, recips, claim, base,
                n_new):
    """K17 (b): n_new (int64 [1]) += the live lanes new to the table: for
    some table t, claim[off_t + h % p_t] == first (the lane's hash is the
    bin's first claimant over the whole mesh) and base (the pre-consume
    table, or None when it is known all-zero) is 0 there.  See
    csrc/claims.cu."""
    dev, n = _check_claims(keys, wgts, firsts, sizes, offsets, recips,
                           claim)
    _check("n_new", n_new, torch.int64, dev)
    if base is not None:
        _check("base", base, torch.int32, dev)
        if base.shape != claim.shape:
            raise ValueError("claim_count: base and claim differ in shape")
    if dev.type != "cuda":
        return plain.claim_count(keys, wgts, firsts, sizes, offsets, recips,
                                 claim, base, n_new)
    if n:
        _launch("claim_count", dev, keys.data_ptr(), wgts.data_ptr(),
                firsts.data_ptr(), n, sizes.numel(), sizes.data_ptr(),
                offsets.data_ptr(), recips.data_ptr(), claim.data_ptr(),
                base.data_ptr() if base is not None else None,
                n_new.data_ptr())


def sketch_get_tables(table, hashes, sizes, offsets, recips):
    """K3t: every table's bin of every hash, int32 [T, n] (uint32 bit
    patterns): K3's gather without the min over tables or the cap, for
    the sharded query, which sums them over the mesh first."""
    dev = table.device
    _check_geometry(table, sizes, offsets, recips)
    _check("hashes", hashes, torch.int64, dev)
    if dev.type != "cuda":
        return plain.sketch_get_tables(table, hashes, sizes, offsets, recips)
    n = hashes.numel()
    out = torch.empty((sizes.numel(), n), dtype=torch.int32, device=dev)
    if n:
        _launch("sketch_get_tables", dev, table.data_ptr(), hashes.data_ptr(),
                n, sizes.numel(), sizes.data_ptr(), offsets.data_ptr(),
                recips.data_ptr(), out.data_ptr())
    return out


def _check_piece(name, keys, piece, lo, sizes, offsets, recips):
    """A piece of a bin-sharded table (int32 [len], bins [lo, lo + len))
    with the whole table's geometry, on the keys' device."""
    _check_geometry(piece, sizes, offsets, recips)
    if piece.dim() != 1 or lo < 0:
        raise ValueError("{}: need a 1-D piece and lo >= 0".format(name))
    if piece.device != keys.device:
        raise ValueError("{}: piece on {}, lanes on {}".format(
            name, piece.device, keys.device))


def owned_claims(keys, wgts, firsts, piece, lo, sizes, offsets, recips,
                 flags, virgin, cand=None, cand_count=None):
    """K18: the claim-rule flags of (int64 key, int32 total, int32 first)
    lanes [n] on the piece of a bin-sharded table that holds bins [lo, lo
    + piece.numel()) (int32 bit patterns of u32; sizes, offsets and
    recips the whole table's).  flags (int32 [n]) is set to 1, in place,
    where for some table t whose bin g = off_t + h % p_t the piece owns,
    the live lane (key not 2**64 - 1, total not 0) holds the least first
    position (u32) of the live lanes in that bin and, unless virgin (the
    piece known all zero), piece[g - lo] is 0; it is never cleared.
    With cand (int64 [cap]) and cand_count (int32 [1]) the keys of the
    live lanes whose table-0 bin is owned and whose (virgin ? total :
    bin + total) exceeds 255 (u32) are appended, in no specified order,
    and cand_count gains their number (it may pass cap).  Reads the piece
    and leaves it as it was.  See csrc/binshard.cu."""
    dev, n = _check_lanes("owned_claims", keys, wgts, firsts)
    _check_piece("owned_claims", keys, piece, lo, sizes, offsets, recips)
    _check("flags", flags, torch.int32, dev)
    if flags.shape != keys.shape:
        raise ValueError("owned_claims: need flags [n]")
    if cand is not None:
        _check("cand", cand, torch.int64, dev)
        _check("cand_count", cand_count, torch.int32, dev)
    if dev.type != "cuda":
        return plain.owned_claims(keys, wgts, firsts, piece, lo, sizes,
                                  offsets, recips, flags, virgin, cand,
                                  cand_count)
    if n and piece.numel():
        claim = torch.full_like(piece, -1)
        _launch("owned_claims", dev, keys.data_ptr(), wgts.data_ptr(),
                firsts.data_ptr(), n, sizes.numel(), sizes.data_ptr(),
                offsets.data_ptr(), recips.data_ptr(), piece.data_ptr(),
                int(lo), piece.numel(), claim.data_ptr(), flags.data_ptr(),
                int(bool(virgin)),
                cand.data_ptr() if cand is not None else None,
                cand.numel() if cand is not None else 0,
                cand_count.data_ptr() if cand is not None else None)


def owned_add(keys, wgts, piece, lo, sizes, offsets, recips):
    """K19: piece[g - lo] += total (mod 2**32), in place, for every live
    lane (int64 key not 2**64 - 1, int32 total not 0) and every table
    whose bin g the piece (bins [lo, lo + piece.numel())) owns.  See
    csrc/binshard.cu."""
    dev = keys.device
    _check("keys", keys, torch.int64, dev)
    _check("weights", wgts, torch.int32, dev)
    if keys.dim() != 1 or wgts.shape != keys.shape:
        raise ValueError("owned_add: need keys and weights [n]")
    _check_piece("owned_add", keys, piece, lo, sizes, offsets, recips)
    if dev.type != "cuda":
        return plain.owned_add(keys, wgts, piece, lo, sizes, offsets, recips)
    if keys.numel() and piece.numel():
        _launch("owned_add", dev, keys.data_ptr(), wgts.data_ptr(),
                keys.numel(), sizes.numel(), sizes.data_ptr(),
                offsets.data_ptr(), recips.data_ptr(), piece.data_ptr(),
                int(lo), piece.numel())


def owned_get(keys, piece, lo, sizes, offsets, recips):
    """K20: for every int64 key [n], the unsigned min over the tables
    whose bin g the piece (bins [lo, lo + piece.numel())) owns of
    piece[g - lo], or 2**32 - 1 where it owns none: int32 [n] (u32
    patterns), without the read cap; the mesh's unsigned min of every
    piece's gives the whole table's min.  See csrc/binshard.cu."""
    dev = keys.device
    _check("keys", keys, torch.int64, dev)
    if keys.dim() != 1:
        raise ValueError("owned_get: need keys [n]")
    _check_piece("owned_get", keys, piece, lo, sizes, offsets, recips)
    if dev.type != "cuda":
        return plain.owned_get(keys, piece, lo, sizes, offsets, recips)
    out = torch.empty(keys.numel(), dtype=torch.int32, device=dev)
    if keys.numel():
        _launch("owned_get", dev, keys.data_ptr(), keys.numel(),
                sizes.numel(), sizes.data_ptr(), offsets.data_ptr(),
                recips.data_ptr(), piece.data_ptr(), int(lo), piece.numel(),
                out.data_ptr())
    return out


def _check_cc(labels, *edges):
    dev = labels.device
    _check("labels", labels, torch.int32, dev)
    for t in edges:
        _check("edges", t, torch.int32, dev)
        if t.dim() != 1:
            raise ValueError("cc: edges must be 1-D")
    if labels.dim() != 1:
        raise ValueError("cc: labels must be 1-D")
    return dev


def cc_relax(labels, src, dst):
    """K10's relaxes of one round, for the sharded round: m =
    lab.at[dst].min(lab[src]), then m.at[src].min(m[dst]), over int32
    labels [T] and edges [E] as cc_rounds takes them.  Returns new int32
    labels [T]; see csrc/cc.cu."""
    dev = _check_cc(labels, src, dst)
    if src.shape != dst.shape:
        raise ValueError("cc_relax: src and dst differ in length")
    check_cc_sizes(labels.numel(), src.numel())
    if labels.numel() == 0:
        return labels.clone()
    if dev.type != "cuda":
        return plain.cc_relax(labels, src, dst)
    out = torch.empty_like(labels)
    scratch = torch.empty_like(labels)
    _launch("cc_relax", dev, labels.data_ptr(), src.data_ptr(), dst.data_ptr(),
            labels.numel(), src.numel(), out.data_ptr(), scratch.data_ptr())
    return out


def cc_jump(m, labels, changed):
    """K10's jumps of one round: m[m] taken twice (int32 [T]), and
    changed (int32 [1], zeroed by the caller) set to 1 where the result
    differs from labels, the round's input.  Returns the new labels."""
    dev = _check_cc(m, labels.reshape(-1))
    _check("changed", changed, torch.int32, dev)
    if labels.shape != m.shape or changed.numel() != 1:
        raise ValueError("cc_jump: need m and labels [T], changed [1]")
    check_cc_sizes(m.numel(), 0)
    if m.numel() == 0:
        return m.clone()
    if dev.type != "cuda":
        return plain.cc_jump(m, labels, changed)
    out = torch.empty_like(m)
    scratch = torch.empty_like(m)
    _launch("cc_jump", dev, m.data_ptr(), m.numel(), labels.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), changed.data_ptr())
    return out

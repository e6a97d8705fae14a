"""The port's kernels: one wrapper per kernel, dispatched by device.

For a CUDA tensor a wrapper launches its hand-written kernel (csrc/,
built at first use by _build) on the current stream and adds the
number of kernels it launched to LAUNCHES[name] (KERNELS_PER_CALL: three
for sketch_update, one for the others); for a CPU tensor it calls the
plain PyTorch version in plain.py.  A failed build or launch raises;
nothing falls back.

Tensor conventions: hashes are int64 bit patterns of uint64; sketch
tables are int32 bit patterns of uint32 bins (sum(sizes) + 1 bins);
`sizes` and `offsets` are int64 [T] tensors on the table's device.
"""

import ctypes

import torch

from khmer_tpu_torch.kernels import _build, plain

KERNELS = ("hash2bit_canonical", "sketch_update", "sketch_get",
           "abund_hist", "bin_scatter_add")
LAUNCHES = dict.fromkeys(KERNELS, 0)
# sketch_update is three launches: claim, add, release (csrc/sketch.cu)
KERNELS_PER_CALL = dict(dict.fromkeys(KERNELS, 1), sketch_update=3)
MAX_TABLES = 32   # the claim launch keeps one bit per table
MAX_LANES = (1 << 31) - 1   # lane indices are int32 claims


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0


def _check(name, t, dtype, device):
    if t.dtype != dtype:
        raise TypeError("{}: expected {}, got {}".format(name, dtype,
                                                         t.dtype))
    if t.device != device:
        raise ValueError("{}: tensor on {}, expected {}".format(
            name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("{}: tensor is not contiguous".format(name))


def _check_geometry(table, sizes, offsets):
    dev = table.device
    _check("table", table, torch.int32, dev)
    _check("sizes", sizes, torch.int64, dev)
    _check("offsets", offsets, torch.int64, dev)
    if not 0 < sizes.numel() <= MAX_TABLES or \
            offsets.numel() != sizes.numel():
        raise ValueError("need 1..{} tables with one offset each".format(
            MAX_TABLES))


def _launch(name, *args):
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.function("khmer_" + name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("{} launch failed with CUDA error {}".format(
            name, err))
    LAUNCHES[name] += KERNELS_PER_CALL[name]


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
        _launch("hash2bit_canonical", codes.data_ptr(), mask.data_ptr(), n,
                k, hashes.data_ptr(), weights.data_ptr())
    return hashes, weights


def sketch_update(table, claim, hashes, weights, sizes, offsets, n_unique,
                  cand=None, cand_count=None):
    """K2: add weighted hashes to the sketch with the exact sequential
    claim rule (lane order is insertion order).  claim is an int32
    scratch as long as table, all CLAIM_FREE, and is left so.  Adds the
    new lanes to n_unique (int64 [1]); with cand (int64 [cap]) and
    cand_count (int32 [1], zeroed by the caller) it records the lanes
    whose table-0 bin now exceeds 255.  Returns is_new, bool [n]."""
    dev = table.device
    _check_geometry(table, sizes, offsets)
    _check("claim", claim, torch.int32, dev)
    _check("hashes", hashes, torch.int64, dev)
    _check("weights", weights, torch.int32, dev)
    _check("n_unique", n_unique, torch.int64, dev)
    if claim.numel() != table.numel() or weights.numel() != hashes.numel() \
            or hashes.numel() > MAX_LANES:
        raise ValueError("sketch_update: mismatched lengths")
    if cand is not None:
        _check("cand", cand, torch.int64, dev)
        _check("cand_count", cand_count, torch.int32, dev)
    if dev.type != "cuda":
        return plain.sketch_update(table, claim, hashes, weights, sizes,
                                   offsets, n_unique, cand, cand_count)
    n = hashes.numel()
    is_new = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        zero_mask = torch.empty(n, dtype=torch.int32, device=dev)
        _launch("sketch_update", table.data_ptr(), claim.data_ptr(),
                hashes.data_ptr(), weights.data_ptr(), n, sizes.numel(),
                sizes.data_ptr(), offsets.data_ptr(), zero_mask.data_ptr(),
                is_new.data_ptr(), n_unique.data_ptr(),
                cand.data_ptr() if cand is not None else None,
                cand.numel() if cand is not None else 0,
                cand_count.data_ptr() if cand is not None else None)
    return is_new


def sketch_get(table, hashes, sizes, offsets, cap):
    """K3: min over tables of the bin totals, capped at cap (255, 65535
    or 1); uint16 [n]."""
    dev = table.device
    _check_geometry(table, sizes, offsets)
    _check("hashes", hashes, torch.int64, dev)
    if dev.type != "cuda":
        return plain.sketch_get(table, hashes, sizes, offsets, cap)
    n = hashes.numel()
    out = torch.empty(n, dtype=torch.uint16, device=dev)
    if n:
        _launch("sketch_get", table.data_ptr(), hashes.data_ptr(), n,
                sizes.numel(), sizes.data_ptr(), offsets.data_ptr(),
                int(cap), out.data_ptr())
    return out


def abund_hist(keys, table, sizes, offsets, cap, hist):
    """K4: for the first lane of every run of equal hashes in the sorted
    keys (int64 [n]), hist[min(count, cap)] += 1, where count is the
    sketch's min over tables.  hist is int64 [65536], updated in place."""
    dev = table.device
    _check_geometry(table, sizes, offsets)
    _check("keys", keys, torch.int64, dev)
    _check("hist", hist, torch.int64, dev)
    if hist.numel() <= cap:
        raise ValueError("abund_hist: histogram shorter than cap + 1")
    if dev.type != "cuda":
        return plain.abund_hist(keys, table, sizes, offsets, cap, hist)
    n = keys.numel()
    if n:
        _launch("abund_hist", keys.data_ptr(), n, table.data_ptr(),
                sizes.numel(), sizes.data_ptr(), offsets.data_ptr(),
                int(cap), hist.data_ptr())


def bin_scatter_add(table, idx, vals):
    """table[idx] += vals for int32 (uint32 bit pattern) table and vals
    and int64 idx; any bins, duplicates included."""
    dev = table.device
    _check("table", table, torch.int32, dev)
    _check("idx", idx, torch.int64, dev)
    _check("vals", vals, torch.int32, dev)
    if idx.numel() != vals.numel():
        raise ValueError("bin_scatter_add: mismatched lengths")
    n = idx.numel()
    if n:
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= table.numel():
            raise IndexError("bin_scatter_add: bin index out of range")
    if dev.type != "cuda":
        return plain.bin_scatter_add(table, idx, vals)
    if n:
        _launch("bin_scatter_add", table.data_ptr(), idx.data_ptr(),
                vals.data_ptr(), n)

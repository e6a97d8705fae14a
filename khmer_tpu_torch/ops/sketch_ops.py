"""Sketch update/query primitives over a flat uint32 working table.

As in khmer_tpu/ops/sketch_ops.py, every storage kind keeps ONE flat
uint32 counter per bin and applies its saturation only when reading:

    reference cell value  ==  min(cap, total increments)

because saturating increments commute.  The update is then a plain
wrap-free add, and reads, saves and merges stay bit-exact with the
reference (ByteStorage::add, reference include/oxli/storage.hh:575-628;
NibbleStorage::add, storage.hh:324-363; BitStorage::test_and_set_bits,
storage.hh:176-203).

The device work is kernels K2 (sketch_update) and K3 (sketch_get).  A
save packs the OXLI stream (one byte a bin; two bins a byte for nibble,
eight for bit) on the device with K14 (pack_oxli_bytes), so only the
stream crosses to the host; its bytes equal both of khmer_tpu's routes
(the dense pack and the sparse fetch of storage.py:300-313).  K13
(count_nonzero) counts occupied bins.  A load widens the raw bytes on
the device through bin_scatter_add; host_pack_oxli_bytes is the host
numpy mirror of khmer_tpu's (:290-312).
"""

from dataclasses import dataclass

import numpy as np
import torch

from khmer_tpu_torch import _u64, kernels
from khmer_tpu_torch._config import BIN_DTYPE

BIGCOUNT_CAP = 65535
NIBBLE_CAP = 15  # the nibble kind's read cap (reference storage.hh:258)
# per-batch candidate budget for bigcount tracking; a batch that
# overflows it is recovered exactly from the batch (storage.py)
BIGCOUNT_LANES = 1 << 16


@dataclass(frozen=True)
class SketchSpec:
    """Static geometry of a sketch."""

    kind: str  # 'byte' | 'nibble' | 'bit'
    tablesizes: tuple  # bins per table

    @property
    def n_tables(self):
        return len(self.tablesizes)

    @property
    def bin_offsets(self):
        offs = []
        o = 0
        for s in self.tablesizes:
            offs.append(o)
            o += int(s)
        return tuple(offs)

    @property
    def total_bins(self):
        return sum(int(s) for s in self.tablesizes)

    @property
    def bytes_per_table(self):
        """OXLI on-disk bytes per table (reference storage.cc layouts)."""
        if self.kind == "byte":
            return tuple(int(s) for s in self.tablesizes)
        if self.kind == "nibble":
            return tuple(int(s) // 2 + 1 for s in self.tablesizes)
        if self.kind == "bit":
            return tuple(int(s) // 8 + 1 for s in self.tablesizes)
        raise ValueError(self.kind)

    @property
    def total_bytes(self):
        return sum(self.bytes_per_table)

    def geometry(self, device):
        """(sizes, offsets, recips): int64 [T] tensors the kernels index
        with; recips holds barrett_recips as int64 bit patterns."""
        recips = np.array(barrett_recips(self.tablesizes), np.uint64)
        return (torch.tensor(self.tablesizes, dtype=torch.int64,
                             device=device),
                torch.tensor(self.bin_offsets, dtype=torch.int64,
                             device=device),
                torch.from_numpy(recips.view(np.int64)).to(device))


def barrett_recips(tablesizes):
    """floor((2**64 - 1) / p) for every table size p: the reciprocals
    with which the kernels compute h % p (csrc/common.cuh:mod_barrett)."""
    return [((1 << 64) - 1) // int(p) for p in tablesizes]


def alloc_table(spec, device):
    """Fresh flat uint32 working table (+1 spare bin, as in khmer_tpu)."""
    return torch.zeros(spec.total_bins + 1, dtype=BIN_DTYPE, device=device)


def sketch_update(geom, table, n_unique, hashes, weights,
                  track_bigcount=False):
    """Add a batch (int64 hashes, int32 weights; lane order = insertion
    order) with the exact claim rule.  Returns (is_new, candidates,
    overflowed): candidates is a uint64 numpy array of the distinct
    hashes whose table-0 bin now exceeds 255 (None unless
    track_bigcount), and overflowed says that more lanes crossed than
    BIGCOUNT_LANES, so the list is incomplete."""
    cand = cand_count = None
    if track_bigcount:
        cand = torch.empty(BIGCOUNT_LANES, dtype=torch.int64,
                           device=table.device)
        cand_count = torch.zeros(1, dtype=torch.int32, device=table.device)
    is_new = kernels.sketch_update(table, hashes, weights, *geom, n_unique,
                                   cand, cand_count)
    if not track_bigcount:
        return is_new, None, False
    n_cross = int(cand_count.item())
    found = np.unique(_u64.to_numpy(cand[:min(n_cross, BIGCOUNT_LANES)]))
    return is_new, found, n_cross > BIGCOUNT_LANES


def sketch_get(geom, table, hashes, cap):
    """Batched count read: min over tables, capped at cap; uint16."""
    return kernels.sketch_get(table, hashes, *geom, cap)


def occupied_bins(spec, table):
    """n_occupied: nonzero bins of table 0 (exact; K13)."""
    return int(kernels.count_nonzero(table, 0, spec.tablesizes[0]).item())


# ---------------------------------------------------------------------------
# OXLI byte-layout packing (save/load)
# ---------------------------------------------------------------------------


def pack_oxli_bytes(spec, table):
    """Working table -> OXLI on-disk byte stream (host numpy), packed on
    the table's device by K14, so only the stream's bytes cross to the
    host."""
    sizes, offsets, _ = spec.geometry(table.device)
    return kernels.pack_oxli_bytes(table, spec.kind, sizes, offsets,
                                   spec.bytes_per_table).cpu().numpy()


def host_pack_oxli_bytes(spec, table):
    """Numpy mirror of khmer_tpu's pack_oxli_bytes (byte-identical)."""
    outs = []
    for t in range(spec.n_tables):
        size = int(spec.tablesizes[t])
        off = spec.bin_offsets[t]
        vals = table[off: off + size]
        if spec.kind == "byte":
            outs.append(np.minimum(vals, 255).astype(np.uint8))
        elif spec.kind == "nibble":
            nb = size // 2 + 1
            padded = np.zeros(nb * 2, np.uint32)
            padded[:size] = np.minimum(vals, NIBBLE_CAP)
            pair = padded.reshape(nb, 2)
            outs.append((pair[:, 1] | (pair[:, 0] << 4)).astype(np.uint8))
        else:  # bit
            nb = size // 8 + 1
            padded = np.zeros(nb * 8, np.uint8)
            padded[:size] = (vals > 0)
            outs.append(np.packbits(padded.reshape(nb, 8), axis=1,
                                    bitorder="little").reshape(-1))
    return np.concatenate(outs)


def unpack_oxli_bytes(spec, data, device):
    """OXLI byte stream (host numpy) -> working table on device.

    Only the raw bytes cross to the device.  There the occupied bins are
    found (a nonzero byte, or a set bit for the bit kind) and added into
    a zeroed table with bin_scatter_add, which widens them to u32 (for
    the nibble kind, each byte's two nibbles, the high one first)."""
    data = np.ascontiguousarray(data, np.uint8)
    if not data.flags.writeable:  # torch.from_numpy wants a writable array
        data = data.copy()
    raw = torch.from_numpy(data).to(device)
    if spec.kind == "byte":
        # byte t of the stream is bin t: the tables lie back to back
        idx = torch.nonzero(raw).squeeze(1)
        vals = raw[idx].to(torch.int32)
    elif spec.kind == "nibble":
        parts = []
        boff = 0
        for size, off, nb in zip(spec.tablesizes, spec.bin_offsets,
                                 spec.bytes_per_table):
            b = raw[boff: boff + nb]
            bins = torch.stack([b >> 4, b & 15], 1).reshape(-1)[:size]
            parts.append(bins)
            boff += nb
        bins = torch.cat(parts)
        idx = torch.nonzero(bins).squeeze(1)
        vals = bins[idx].to(torch.int32)
    else:  # bit
        shifts = torch.arange(8, dtype=torch.uint8, device=device)
        parts = []
        boff = 0
        for size, off, nb in zip(spec.tablesizes, spec.bin_offsets,
                                 spec.bytes_per_table):
            bits = (raw[boff: boff + nb, None] >> shifts) & 1
            parts.append(torch.nonzero(bits.reshape(-1)[:size]).squeeze(1)
                         + off)
            boff += nb
        idx = torch.cat(parts)
        vals = torch.ones(idx.numel(), dtype=torch.int32, device=device)
    table = alloc_table(spec, device)
    kernels.bin_scatter_add(table, idx, vals)
    return table

"""Storage layer: device-resident sketches with khmer Storage semantics.

Port of khmer_tpu/storage.py:42-353 (ByteStorage, NibbleStorage and
BitStorage).  Each storage is ONE flat uint32 working array on its
device, updated by kernel K2 per batch (add_lanes) or by the deferred
counter's flush (ops/deferred.py, the bulk consumes); each kind's
saturation cap is applied at read time, which equals the reference's
saturating increments (see ops/sketch_ops.py).

bigcount: counts past 255 need no side structure at runtime (the
uint32 total is simply capped at 65535 on reads).  The OXLI file
format's sparse bigcount section is reconstructed at save time from a
host-side set of candidate hashes whose table-0 bin crossed 255; a
bigcount map loaded *from* a file overlays saturated reads exactly as
the reference does (storage.hh:631-653).

QFStorage (the counting quotient filter) is khmer_tpu's host-exact
sorted (key, count) dictionary, copied as it is: its tables hash on the
device, and the filter lives on the host.

Every write to a table goes through its Storage and counts in
`Storage.writes`, which keeps the host count snapshot (host_counts)
coherent: the port writes tables in place, so the snapshot cannot tell a
new table by its identity, as khmer_tpu's does.

Storage.shard_table (khmer_tpu/storage.py:245-271) cuts the flat bin
array into contiguous pieces, one on each shard of an in-process mesh
(BinShards).  khmer_tpu then runs its kernels unchanged and XLA inserts
the collectives; here every piece sees every lane and routes by bin
owner with three kernels: a read is K20 (owned_get) on each piece and
the mesh's unsigned min, an add the deferred counter's claim-rule flush
(K18 owned_claims, then K19 owned_add; ops/deferred.py) with each
lane's index as its first position, which gives K2's per-lane was-new
flags.  The occupied count (K13), the save (K14) and the host snapshot
go piece by piece, and no operation assembles the whole table on one
device: what is not ported to the layout yet raises NotImplementedError
(ROADMAP Queue 2 item 4).
"""

import math
import os

import numpy as np
import torch

from khmer_tpu_torch import _u64, kernels
from khmer_tpu_torch._config import MAX_BIGCOUNT, MAX_KCOUNT, resolve_device
from khmer_tpu_torch.ops.sketch_ops import (
    BIGCOUNT_CAP,
    NIBBLE_CAP,
    SketchSpec,
    alloc_table,
    occupied_bins,
    pack_oxli_bytes,
    sketch_get,
    sketch_update,
    unpack_oxli_bytes,
)

# every inner piece edge of a bin-sharded table is a bin of a table whose
# index in that table is a multiple of PIECE_ALIGN, or the table's end, so
# that no byte of the OXLI stream (two bins a byte for the nibble kind,
# eight for the bit kind, from each table's first bin) spans two pieces
PIECE_ALIGN = 8
# what raises on a bin-sharded table, and where the port queues it
NOT_ON_SHARDS = "{} on a bin-sharded table is not ported yet (ROADMAP " \
    "Queue 2 item 4)"


def piece_bounds(spec, n_bins, n_pieces):
    """[lo, hi) of n_pieces contiguous pieces of a flat table of n_bins
    bins (spec's tables, then its spare bin): piece s ends near s + 1
    n_pieces-ths of the bins, at the next PIECE_ALIGN edge of the table
    that holds that bin.  A piece may be empty."""
    cuts = [0]
    for s in range(1, n_pieces):
        g = max(cuts[-1], s * n_bins // n_pieces)
        for size, off in zip(spec.tablesizes, spec.bin_offsets):
            if off <= g < off + size:
                g = min(off + -(-(g - off) // PIECE_ALIGN) * PIECE_ALIGN,
                        off + size)
                break
        cuts.append(g)
    cuts.append(n_bins)
    return tuple(zip(cuts[:-1], cuts[1:]))


class BinShards:
    """The layout of a bin-sharded table (Storage.shard_table): its
    n_bins flat bins cut into one contiguous piece for each shard of an
    in-process parallel.comm.Mesh, in rank order (piece_bounds): piece s
    holds bins bounds[s] = [lo, hi) on devices[s].  Shards may share a
    device."""

    def __init__(self, mesh, pieces, bounds, spec):
        self.mesh = mesh
        self.devices = mesh.devices
        self.pieces = pieces
        self.bounds = tuple(bounds)
        self.n_bins = self.bounds[-1][1]
        by_dev = {d: spec.geometry(d) for d in set(self.devices)}
        self.geoms = [by_dev[d] for d in self.devices]

    def parts(self):
        """(piece, lo, geometry on the piece's device) of every piece."""
        return [(p, lo, g) for p, (lo, _), g in zip(self.pieces, self.bounds,
                                                    self.geoms)]

    def __repr__(self):
        return "BinShards({} bins in {} pieces: {})".format(
            self.n_bins, len(self.pieces), ", ".join(
                "{}: [{}, {})".format(d, lo, hi)
                for d, (lo, hi) in zip(self.devices, self.bounds)))

    def get(self, hashes, cap, tables=None):
        """Counts of int64 hashes (on any device; returned there), the min
        over the tables (only those of the slice `tables` when given) of
        the bins, capped at cap: K20 on every piece and the mesh's
        unsigned min; uint16."""
        sel = slice(None) if tables is None else tables
        mins = [kernels.owned_get(h, p, lo, *(x[sel] for x in g))
                for h, (p, lo, g) in zip(self.mesh.replicate(hashes),
                                         self.parts())]
        m = self.mesh.all_reduce(mins, "umin32")[0].to(hashes.device)
        return _u64.u32(m).clamp(max=cap).to(torch.uint16)


class Storage:
    """Base class for device sketches."""

    kind = None
    supports_bigcount = False
    # the layout of a bin-sharded table (shard_table), None when whole
    shards = None

    def __init__(self, tablesizes, use_bigcount=False, device=None):
        tablesizes = tuple(int(t) for t in tablesizes)
        if not tablesizes:
            raise ValueError(
                "tablesizes needs to be one or more numbers")
        self.device = resolve_device(device)
        self._use_bigcount = bool(use_bigcount) and self.supports_bigcount
        self.spec = SketchSpec(kind=self.kind, tablesizes=tablesizes)
        self.table = alloc_table(self.spec, self.device)
        self._geom = self.spec.geometry(self.device)
        self._n_unique = torch.zeros(1, dtype=torch.int64,
                                     device=self.device)
        self._loaded_occupied = None
        # hashes that may exceed 255 (superset; resolved at save time)
        self.bigcount_candidates = set()
        # bigcount map loaded from an OXLI file (overlays capped reads)
        self.bigcounts = {}
        # writes to the table so far, and the host snapshot of it
        # (host_counts) with the write count it holds
        self.writes = 0
        self._host_table = None
        self._host_writes = None
        self._host_geom = (
            np.asarray(self.spec.tablesizes, np.uint64)[:, None],
            np.asarray(self.spec.bin_offsets, np.int64)[:, None])

    # -- geometry ---------------------------------------------------------

    def get_tablesizes(self):
        return list(self.spec.tablesizes)

    @property
    def table(self):
        """The flat table (int32 bit patterns of the u32 bins) on this
        storage's device; a bin-sharded table has none."""
        if self.shards is not None:
            raise NotImplementedError(NOT_ON_SHARDS.format(
                "reading the whole table on one device"))
        return self._table

    @table.setter
    def table(self, bins):
        self._table = bins

    def refuse_shards(self, what):
        """Raise NotImplementedError naming `what` when the table is
        bin-sharded."""
        if self.shards is not None:
            raise NotImplementedError(NOT_ON_SHARDS.format(what))

    def is_virgin(self):
        """True while the table is known to be all zero: nothing has been
        written or loaded since it was made."""
        return self.writes == 0

    def shard_table(self, mesh=None, axis="shard"):
        """Cut the flat bin array into contiguous pieces over an
        in-process mesh's shards (khmer_tpu/storage.py:245-271): piece s
        goes to shard s's device and the whole-table tensor is dropped,
        so each device holds about 1/S of the table.  mesh=None is
        parallel.sharded.make_mesh(device=self.device): every CUDA
        device, or the one CPU.  `axis` is khmer_tpu's and names no axis
        here: the pieces follow the mesh's ranks.  Returns the layout
        (BinShards: the devices and each piece's [lo, hi)).  Every result
        equals the whole table's; what is not ported to the layout raises
        NotImplementedError.  A mesh over a torch.distributed group
        raises too: khmer_tpu's shard_table is one process's."""
        del axis
        from khmer_tpu_torch.parallel.sharded import make_mesh

        if self.shards is not None:
            raise ValueError("the table is bin-sharded already")
        if mesh is None:
            mesh = make_mesh(device=self.device)
        if mesh.group is not None:
            raise NotImplementedError(NOT_ON_SHARDS.format(
                "a mesh over a process group"))
        bounds = piece_bounds(self.spec, self._table.numel(),
                              len(mesh.devices))
        whole = self._table
        self._table = None
        if self.is_virgin():
            whole = None  # all zero: make the pieces, copy nothing
        pieces = []
        for dev, (lo, hi) in zip(mesh.devices, bounds):
            piece = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
            if whole is not None:
                piece.copy_(whole[lo:hi])
            pieces.append(piece)
        del whole
        self.shards = BinShards(mesh, pieces, bounds, self.spec)
        return self.shards

    def flush_target(self):
        """What ops.deferred.flush_table_ops flushes into: the layout of
        a bin-sharded table, or the flat table."""
        return self._table if self.shards is None else self.shards

    def n_occupied(self):
        if self._loaded_occupied is not None:
            return self._loaded_occupied
        if self.shards is None:
            return occupied_bins(self.spec, self._table)
        # table 0's nonzero bins, K13 a piece
        size0 = self.spec.tablesizes[0]
        total = 0
        for piece, lo, _ in self.shards.parts():
            end = min(piece.numel(), size0 - lo)
            if end > 0:
                total += int(kernels.count_nonzero(piece, 0, end).item())
        return total

    def n_unique_kmers(self):
        return int(self._n_unique.item())

    # -- bigcount ---------------------------------------------------------

    def set_use_bigcount(self, b):
        if b and not self.supports_bigcount:
            raise ValueError("bigcount is not supported for this storage type")
        self._use_bigcount = bool(b)

    def get_use_bigcount(self):
        return self._use_bigcount

    def read_cap(self):
        """Read cap under the current bigcount toggle: 65535 or 255 for
        byte counts (reference MAX_KCOUNT, oxli.hh:81), 15 for nibble
        counts (storage.hh:258), 1 for presence."""
        if self.kind == "byte":
            return BIGCOUNT_CAP if self._use_bigcount else MAX_KCOUNT
        return NIBBLE_CAP if self.kind == "nibble" else 1

    def _counts_over_kcount(self, hashes):
        """The hashes (int64 tensor) whose uncapped count exceeds 255."""
        counts = self.get_lanes(hashes, BIGCOUNT_CAP)
        return _u64.to_numpy(hashes[counts.to(torch.int32) > MAX_KCOUNT])

    def resolved_bigcounts(self):
        """Exact {hash: count} for counts in (255, 65535] -- the OXLI
        bigcount section.  Merges live candidates with any map loaded
        from disk."""
        out = dict(self.bigcounts)
        if self.bigcount_candidates:
            cand = np.fromiter(self.bigcount_candidates, np.uint64,
                               len(self.bigcount_candidates))
            counts = self.get_lanes(_u64.as_tensor(cand, self.device),
                                    BIGCOUNT_CAP).cpu().numpy()
            for h, c in zip(cand, counts):
                if c > MAX_KCOUNT:
                    out[int(h)] = min(int(c), MAX_BIGCOUNT)
        return out

    def overlay_bigcounts(self, counts, hashes):
        """Overlay a *loaded* bigcount map onto capped reads (numpy)."""
        if not self._use_bigcount or not self.bigcounts:
            return counts
        counts = np.array(counts, copy=True)
        hs = np.asarray(hashes, dtype=np.uint64).reshape(-1)
        for i in np.nonzero(counts == MAX_KCOUNT)[0]:
            v = self.bigcounts.get(int(hs[i]))
            if v is not None:
                counts[i] = v
        return counts

    # -- update/query -----------------------------------------------------

    def add_lanes(self, hashes, weights, track_bigcount=True):
        """Add a batch of device lanes (int64 hashes, int32 weights, lane
        order = insertion order); returns the per-lane was-new flags with
        the reference's exact sequential semantics (storage.hh:176-203).
        track_bigcount=False leaves the bigcount candidates as they are
        (khmer_tpu's batch-step flush tracks none)."""
        track = self.kind == "byte" and self._use_bigcount and \
            track_bigcount
        if self.shards is None:
            is_new, found, overflowed = sketch_update(
                self._geom, self._table, self._n_unique, hashes,
                weights, track_bigcount=track)
        else:
            is_new = self._add_to_shards(hashes, weights)
            found, overflowed = (), True
        self._loaded_occupied = None
        self._mirror_host_add(hashes, weights)
        if track:
            self.bigcount_candidates.update(int(x) for x in found)
            if overflowed:
                # more crossing lanes than the candidate buffer holds:
                # recover EXACTLY from the batch itself -- bins hold true
                # totals, so every live hash now above 255 is a
                # candidate.  The OXLI bigcount section must be complete.
                live = torch.unique(hashes[weights != 0])
                self.bigcount_candidates.update(
                    int(x) for x in self._counts_over_kcount(live))
        return is_new

    def _add_to_shards(self, hashes, weights):
        """add_lanes on a bin-sharded table: the deferred counter's flush
        (K18, K19 on every piece) with each lane's index as its first
        position, whose per-lane flags are K2's was-new flags.  Its
        bigcount candidates are those of the flush's distinct-lane rule,
        so add_lanes takes them from the batch instead."""
        from khmer_tpu_torch.ops.deferred import flush_lanes

        n = hashes.numel()
        firsts = torch.arange(n, dtype=torch.int32, device=hashes.device)
        won, _, _ = flush_lanes(self.shards, self.spec, hashes, weights,
                                firsts, self.is_virgin(), False)
        self._n_unique += won.sum()
        return won

    def add_batch(self, hashes, weights=None):
        """add_lanes for host uint64 hashes (and optional uint32
        weights); returns was-new as a numpy bool array."""
        h = _u64.as_tensor(hashes, self.device).reshape(-1)
        if weights is None:
            w = torch.ones(h.numel(), dtype=torch.int32, device=self.device)
        else:
            w = torch.from_numpy(np.asarray(weights, np.uint32).reshape(-1)
                                 .view(np.int32)).to(self.device)
        return self.add_lanes(h, w).cpu().numpy()

    def add(self, khash):
        """Single-hash add; returns True when the k-mer was unseen."""
        return bool(self.add_batch([khash])[0])

    def get_lanes(self, hashes, cap=None, tables=None):
        """Counts of device hashes, capped at the read cap (uint16): the
        min over the tables, or over the slice `tables` of them (one
        table's bins: slice(t, t + 1)).  K3, or on a bin-sharded table
        K20 on every piece and the mesh's min."""
        cap = self.read_cap() if cap is None else cap
        if self.shards is not None:
            return self.shards.get(hashes, cap, tables)
        geom = self._geom if tables is None else \
            tuple(g[tables] for g in self._geom)
        return sketch_get(geom, self._table, hashes, cap)

    def get_batch(self, hashes):
        """Counts for host hashes (numpy), with the loaded-map overlay."""
        hashes = np.asarray(hashes, dtype=np.uint64).reshape(-1)
        counts = self.get_lanes(_u64.as_tensor(hashes, self.device))
        counts = counts.cpu().numpy()
        if self.kind == "byte":
            counts = self.overlay_bigcounts(counts, hashes)
        return counts

    def get(self, khash):
        return int(self.get_batch([khash])[0])

    # -- host count snapshot (for pointer-chasing algorithms) -------------

    def _wrote(self):
        """Count a write that the snapshot does not follow, and drop it."""
        self.writes += 1
        self._host_table = None

    def _take_snapshot(self):
        """The table's u32 bins as a host numpy copy (piece by piece for a
        bin-sharded table)."""
        if self.shards is None:
            return self._table.to("cpu", copy=True).numpy().view(np.uint32)
        out = np.empty(self.shards.n_bins, np.uint32)
        for piece, (lo, hi) in zip(self.shards.pieces, self.shards.bounds):
            out[lo:hi] = piece.cpu().numpy().view(np.uint32)
        return out

    def _bins_of(self, hashes):
        """[T, n] global bin indices (numpy int64) of uint64 hashes."""
        sizes, offs = self._host_geom
        return (hashes[None, :] % sizes).astype(np.int64) + offs

    def host_counts(self, hashes):
        """Counts of uint64 hashes against a host snapshot of the table
        (khmer_tpu/storage.py:282-296): the min over tables of the bins,
        capped at the read cap, with no loaded bigcount overlay; for
        searches that make many tiny lookups (the ReadAligner's), where a
        device round trip each would dominate.  The snapshot is taken
        again after any write that add_lanes did not apply to it."""
        h = np.asarray(hashes, np.uint64).reshape(-1)
        tot = self.host_table()[self._bins_of(h)].min(axis=0)
        return np.minimum(tot, self.read_cap())

    def host_table(self):
        """The host snapshot of the table's u32 bins (numpy), taken again
        when a write has made it stale."""
        if self._host_table is None or self._host_writes != self.writes:
            self._host_table = self._take_snapshot()
            self._host_writes = self.writes
        return self._host_table

    def _mirror_host_add(self, hashes, weights):
        """Count add_lanes' write; while a current snapshot exists, apply
        the same u32 adds to it, as khmer_tpu's _mirror_host_add
        (storage.py:201-214) does, instead of copying the table again."""
        current = self._host_table is not None and \
            self._host_writes == self.writes
        self.writes += 1
        if not current:
            self._host_table = None
            return
        w = weights.to(torch.int32).cpu().numpy().view(np.uint32)
        live = w != 0
        idx = self._bins_of(_u64.to_numpy(hashes)[live])
        np.add.at(self._host_table, idx.reshape(-1),
                  np.tile(w[live], idx.shape[0]))
        self._host_writes = self.writes

    # -- host access ------------------------------------------------------

    def raw_bytes(self):
        """All table bytes in OXLI on-disk layout, host numpy, packed on
        the device (K14).  khmer_tpu (storage.py:300-313) fetches a
        sparse table's nonzero (bin, value) pairs instead, for a slow
        link; the bytes are the same, and over this card's PCIe the
        dense stream saves faster (PERF.md).  A bin-sharded table packs
        each piece's part of each table in the table's kind on the
        piece's device (K14; no byte spans two pieces, see PIECE_ALIGN)
        and moves its bytes to the host a piece at a time."""
        if self.shards is None:
            return pack_oxli_bytes(self.spec, self._table)
        spec = self.spec
        per = {"byte": 1, "nibble": 2, "bit": 8}[self.kind]
        nbytes = spec.bytes_per_table
        starts = np.cumsum((0,) + nbytes[:-1])
        out = np.empty(spec.total_bytes, np.uint8)
        for piece, (lo, hi) in zip(self.shards.pieces, self.shards.bounds):
            # (bins, first bin in the piece, bytes) of each table's part
            parts, first = [], None
            for t, (size, off) in enumerate(zip(spec.tablesizes,
                                                spec.bin_offsets)):
                a, b = max(lo, off), min(hi, off + size)
                if a >= b:
                    continue
                k = (a - off) // per  # the part's first byte in table t
                parts.append((b - a, a - lo, nbytes[t] - k
                              if b == off + size else (b - a) // per))
                if first is None:
                    first = starts[t] + k
            if not parts:
                continue
            sizes, offs, nb = (list(c) for c in zip(*parts))
            packed = kernels.pack_oxli_bytes(
                piece, self.kind,
                torch.tensor(sizes, dtype=torch.int64, device=piece.device),
                torch.tensor(offs, dtype=torch.int64, device=piece.device),
                nb)
            out[first:first + packed.numel()] = packed.cpu().numpy()
        return out

    def replace_table(self, bins):
        """Take `bins` (int32 bit patterns of the u32 bins, on this
        storage's device) as the table."""
        self.refuse_shards("replacing the table")
        if bins.shape != self.table.shape:
            raise ValueError("expected {} bins, got {}".format(
                self.table.numel(), tuple(bins.shape)))
        self.table = bins
        self._loaded_occupied = None
        self._wrote()

    def set_raw_bytes(self, data, n_occupied=0):
        self.refuse_shards("loading bytes into the table")
        data = np.asarray(data, dtype=np.uint8)
        if data.size != self.spec.total_bytes:
            raise ValueError("raw byte size mismatch")
        self.table = unpack_oxli_bytes(self.spec, data, self.device)
        self._wrote()
        self._n_unique.zero_()
        self._loaded_occupied = int(n_occupied)
        self.bigcount_candidates = set()


class BitStorage(Storage):
    """Bloom filter (reference storage.hh:99-233)."""

    kind = "bit"

    def update_from(self, other):
        """Union of two same-geometry Bloom filters (reference
        src/oxli/storage.cc:63-96): the elementwise unsigned max of the
        u32 tables, in place on the device; n_unique is left as it was
        (reference behavior)."""
        if self.spec.tablesizes != other.spec.tablesizes:
            raise ValueError("both nodegraphs must have same table sizes")
        self.refuse_shards("update")
        other.refuse_shards("update")
        # unsigned order: flip the sign bit on both sides of a signed max
        flip = -(1 << 31)
        self.table.bitwise_xor_(flip)
        torch.maximum(self.table, other.table ^ flip, out=self.table)
        self.table.bitwise_xor_(flip)
        self._loaded_occupied = None
        self._wrote()


class ByteStorage(Storage):
    """Count-Min sketch with 8-bit counters + bigcount (storage.hh:485-664)."""

    kind = "byte"
    supports_bigcount = True


class NibbleStorage(Storage):
    """Count-Min sketch with 4-bit counters (storage.hh:249-409), over
    the same u32 working table as ByteStorage, read at cap 15; no
    bigcount."""

    kind = "nibble"


# storage class of each kind
BY_KIND = {cls.kind: cls for cls in (ByteStorage, NibbleStorage,
                                     BitStorage)}


class QFStorage:
    """Counting-quotient-filter storage with the reference's counting
    semantics (storage.hh:417-462 over third-party/cqf/gqf.c): a copy of
    khmer_tpu/storage.py:355-574.

    The CQF stores the full key (quotient + remainder), so it behaves as
    an EXACT multiset over the key space `khash % range`, range = nslots
    * 2**bits_per_slot (qf_init, gqf.c:1367-1398; 8 remainder bits for
    khmer's key_bits = q + 8).  The slot-shifting insert is inherently
    sequential, so the filter is a sorted (key, count) dictionary on the
    host: batches are deduplicated with a sort and segment sum and merged
    into the sorted arrays, and queries are a binary search.  Counts are
    exact for every key, bit-identical to qf_count_key_value, and reads
    narrow them to uint16 as the reference's BoundedCounterType return
    does.  `device` is where its tables' hashes and device reads live."""

    kind = "qf"
    supports_bigcount = False
    MIN_FLUSH = 1 << 18

    def __init__(self, size, slot_size=None, on_disk=None, device=None):
        size = int(size)
        if size <= 0 or size & (size - 1):
            raise ValueError("QF size must be a power of two")
        self.device = resolve_device(device)
        self.nslots = size
        # onDiskMQF analogue (third-party/MQF/onDiskMQF.h): with a spill
        # directory, the sorted arrays live in disk-backed memmaps
        self.on_disk = on_disk
        self._gen = 0
        # key space per qf_init: range = nslots << key_remainder_bits; the
        # classic CQF constructor uses key_bits = q + 8 (storage.hh:428),
        # the fork's MQF constructor the slot size it is given
        self.rem_bits = int(slot_size) if slot_size else 8
        self.range = np.uint64(size) << np.uint64(self.rem_bits)
        # xnslots = nslots + 10 * sqrt(nslots) (gqf.c:1372)
        self.xnslots = size + int(10 * math.sqrt(size))
        self.slot_size = slot_size
        self._keys = np.zeros(0, np.uint64)
        self._counts = np.zeros(0, np.uint64)
        self._pending = []
        self._pending_n = 0

    # -- geometry ---------------------------------------------------------

    def get_tablesizes(self):
        # the reference's get_tablesizes returns {xnslots}
        return [self.xnslots]

    @property
    def n_tables(self):
        return 1

    def n_occupied(self):
        # the reference's noccupied_slots, by its dominant term: one slot
        # a distinct key
        self._flush()
        return int(self._keys.shape[0])

    def n_unique_kmers(self):
        # the reference's ndistinct_elts, exact here
        self._flush()
        return int(self._keys.shape[0])

    def set_use_bigcount(self, b):
        if b:
            raise ValueError("bigcount is not supported for this storage "
                             "type")

    def get_use_bigcount(self):
        return False

    # -- update/query -----------------------------------------------------

    @staticmethod
    def _reduce(keys, weights):
        """Sort and segment-sum a raw (keys, weights) batch."""
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        weights = weights[order]
        uniq, first = np.unique(keys, return_index=True)
        sums = np.add.reduceat(weights, first) if keys.size else weights
        return uniq, sums.astype(np.uint64)

    def _flush(self):
        if not self._pending:
            return
        keys = np.concatenate([k for k, _ in self._pending])
        ws = np.concatenate([w for _, w in self._pending])
        self._pending = []
        self._pending_n = 0
        uk, us = self._reduce(keys, ws)
        if self._keys.shape[0] == 0:
            self._adopt(uk, us)
            return
        self._adopt(*self._reduce(np.concatenate([self._keys, uk]),
                                  np.concatenate([self._counts, us])))

    def _adopt(self, keys, counts):
        """Adopt merged sorted arrays; in on-disk mode they spill to
        alternating-generation memmap files, so the resident set stays
        page-cache-managed (the stxxl / onDiskMQF role)."""
        if self.on_disk is None:
            self._keys, self._counts = keys, counts
            return
        os.makedirs(self.on_disk, exist_ok=True)
        self._gen ^= 1
        n = keys.shape[0]
        kp = os.path.join(self.on_disk, "qf_keys.%d.bin" % self._gen)
        cp = os.path.join(self.on_disk, "qf_counts.%d.bin" % self._gen)
        mk = np.memmap(kp, np.uint64, "w+", shape=(max(n, 1),))
        mc = np.memmap(cp, np.uint64, "w+", shape=(max(n, 1),))
        mk[:n] = keys
        mc[:n] = counts
        mk.flush()
        mc.flush()
        self._keys = np.memmap(kp, np.uint64, "r", shape=(n,))
        self._counts = np.memmap(cp, np.uint64, "r", shape=(n,))

    def lookup_keys(self, keys):
        """Exact uint64 counts of already-reduced keys (numpy)."""
        self._flush()
        if self._keys.shape[0] == 0:
            return np.zeros(keys.shape, np.uint64)
        idx = np.searchsorted(self._keys, keys)
        idx = np.minimum(idx, self._keys.shape[0] - 1)
        found = self._keys[idx] == keys
        return np.where(found, self._counts[idx], np.uint64(0))

    def add_keys(self, keys, weights):
        """Queue already-reduced uint64 keys with uint64 weights > 0; the
        queue is merged once it holds half the table's keys."""
        self._pending.append((keys, weights))
        self._pending_n += keys.shape[0]
        if self._pending_n >= max(self.MIN_FLUSH,
                                  self._keys.shape[0] // 2):
            self._flush()

    def _live(self, hashes, weights):
        """(keys, uint64 weights) of the lanes of weight > 0."""
        keys = np.asarray(hashes, np.uint64).reshape(-1) % self.range
        if weights is None:
            return keys, np.ones(keys.shape, np.uint64)
        weights = np.asarray(weights, np.uint64).reshape(-1)
        keep = weights > 0
        if not keep.all():
            keys, weights = keys[keep], weights[keep]
        return keys, weights

    def add_batch(self, hashes, weights=None):
        """Add a batch of uint64 hashes; returns the per-lane was-new
        flags (the reference's add: get_count() == 0 before the insert),
        for the lanes of weight > 0."""
        keys, weights = self._live(hashes, weights)
        present = self.lookup_keys(keys) > 0
        # new: absent from the filter and the key's first lane in the batch
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        fmask = np.ones(sk.shape, bool)
        fmask[1:] = sk[1:] != sk[:-1]
        first_lane = np.zeros(keys.shape, bool)
        first_lane[order] = fmask
        self.add_keys(keys, weights)
        return (~present) & first_lane

    def add_batch_fast(self, hashes, weights=None):
        """Bulk add without the was-new flags (the consume path)."""
        self.add_keys(*self._live(hashes, weights))

    def add_lanes(self, hashes, weights, track_bigcount=True):
        """add_batch_fast for device lanes (int64 hashes, int32 weights as
        uint32 bit patterns): they cross to the host."""
        del track_bigcount
        self.add_batch_fast(_u64.to_numpy(hashes),
                            weights.cpu().numpy().view(np.uint32))

    def add(self, khash):
        return bool(self.add_batch(np.asarray([khash], np.uint64))[0])

    def test_and_set_bits(self, khash):
        return 1 if self.add(khash) else 0

    def get_batch(self, hashes, with_bigcount=True):
        """Counts of uint64 hashes, narrowed to uint16 (BoundedCounterType)."""
        del with_bigcount
        hashes = np.asarray(hashes, np.uint64).reshape(-1)
        counts = self.lookup_keys(hashes % self.range)
        return (counts & np.uint64(0xFFFF)).astype(np.uint16)

    def get_batch_device(self, hashes):
        """get_batch of host hashes as a uint16 tensor on the device."""
        return torch.from_numpy(self.get_batch(np.asarray(hashes))).to(
            self.device)

    def get(self, khash):
        return int(self.get_batch(np.asarray([khash], np.uint64))[0])

    get_count = get

    def host_counts(self, hashes):
        return self.get_batch(hashes)

    # -- save/load payload ------------------------------------------------

    def state_arrays(self):
        self._flush()
        return self._keys, self._counts

    def set_state_arrays(self, keys, counts):
        self._keys = np.asarray(keys, np.uint64)
        self._counts = np.asarray(counts, np.uint64)
        self._pending = []
        self._pending_n = 0


def storage_for_filetype(ht_type):
    """The storage class of an OXLI table file type."""
    from khmer_tpu_torch.io import oxli_format as f

    return {
        f.SAVED_COUNTING_HT: ByteStorage,
        f.SAVED_HASHBITS: BitStorage,
        f.SAVED_SMALLCOUNT: NibbleStorage,
        f.SAVED_QFCOUNT: QFStorage,
    }[ht_type]

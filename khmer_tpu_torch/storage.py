"""Storage layer: device-resident sketches with khmer Storage semantics.

Port of khmer_tpu/storage.py:42-353 (ByteStorage, NibbleStorage and
BitStorage).  Each
storage is ONE flat uint32 working array on its device, updated by
kernel K2 per batch; each kind's saturation cap is applied at read
time, which equals the reference's saturating increments (see
ops/sketch_ops.py).

bigcount: counts past 255 need no side structure at runtime (the
uint32 total is simply capped at 65535 on reads).  The OXLI file
format's sparse bigcount section is reconstructed at save time from a
host-side set of candidate hashes whose table-0 bin crossed 255; a
bigcount map loaded *from* a file overlays saturated reads exactly as
the reference does (storage.hh:631-653).

Every write to a table goes through its Storage and counts in
`Storage.writes`, which keeps the host count snapshot (host_counts)
coherent: the port writes tables in place, so the snapshot cannot tell a
new table by its identity, as khmer_tpu's does.
"""

import numpy as np
import torch

from khmer_tpu_torch import _u64
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


class Storage:
    """Base class for device sketches."""

    kind = None
    supports_bigcount = False

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

    def n_occupied(self):
        if self._loaded_occupied is not None:
            return self._loaded_occupied
        return occupied_bins(self.spec, self.table)

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
        counts = sketch_get(self._geom, self.table, hashes, BIGCOUNT_CAP)
        return _u64.to_numpy(hashes[counts.to(torch.int32) > MAX_KCOUNT])

    def resolved_bigcounts(self):
        """Exact {hash: count} for counts in (255, 65535] -- the OXLI
        bigcount section.  Merges live candidates with any map loaded
        from disk."""
        out = dict(self.bigcounts)
        if self.bigcount_candidates:
            cand = np.fromiter(self.bigcount_candidates, np.uint64,
                               len(self.bigcount_candidates))
            counts = sketch_get(self._geom, self.table,
                                _u64.as_tensor(cand, self.device),
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
        is_new, found, overflowed = sketch_update(
            self._geom, self.table, self._n_unique, hashes,
            weights, track_bigcount=track)
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

    def get_lanes(self, hashes, cap=None):
        """Counts of device hashes, capped at the read cap (uint16)."""
        return sketch_get(self._geom, self.table, hashes,
                          self.read_cap() if cap is None else cap)

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
        """The table's u32 bins as a host numpy copy."""
        return self.table.to("cpu", copy=True).numpy().view(np.uint32)

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
        """All table bytes in OXLI on-disk layout, host numpy."""
        return pack_oxli_bytes(self.spec, self.table)

    def replace_table(self, bins):
        """Take `bins` (int32 bit patterns of the u32 bins, on this
        storage's device) as the table."""
        if bins.shape != self.table.shape:
            raise ValueError("expected {} bins, got {}".format(
                self.table.numel(), tuple(bins.shape)))
        self.table = bins
        self._loaded_occupied = None
        self._wrote()

    def set_raw_bytes(self, data, n_occupied=0):
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

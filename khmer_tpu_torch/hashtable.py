"""k-mer table layer: the subset of khmer_tpu/hashtable.py that
load-into-counting and abundance-dist(-single) use.

Device dataflow: the native loader (or the Python _FlatBatcher) cuts the
cleaned 2-bit code stream into flat chunks with a per-window mask; per
chunk, kernel K1 hashes every window in stream order and kernel K2 adds
the lanes to the sketch with the exact claim rule.  One K2 update per
chunk, in stream order, is exact (each chunk's pre-gather sees the adds
of every earlier chunk), so the deferred sort-and-combine counter of
khmer_tpu/ops/deferred.py is not needed for the counts.  Its cycle and
ledger bookkeeping does decide abundance_distribution's membership
windows, so _DeferSchedule mirrors it there.
"""

import numpy as np
import torch

from khmer_tpu_torch import _u64, kernels
from khmer_tpu_torch._config import KSIZE_MAX, MAX_BIGCOUNT, MAX_KCOUNT
from khmer_tpu_torch.io import oxli_format
from khmer_tpu_torch.ops import encode as enc
from khmer_tpu_torch.ops.hashing import chunk_hashes, forward_hash
from khmer_tpu_torch.primes import get_n_primes_near_x

# bases per device chunk; any size gives the same table, counts and
# histogram
CHUNK = 1 << 23
# bases per tracking-membership chunk of abundance_distribution on a
# table loaded with a bigcount map (khmer_tpu/hashtable.py:53 CHUNK)
OVERLAY_CHUNK = 1 << 20
# the unsigned sort key of 2**64 - 1, which marks dead lanes
_DEAD = (1 << 63) - 1
# khmer_tpu's deferred counter in its own units: a chunk is cut into rows
# of ROW_PAYLOAD bases (khmer_tpu/hashtable.py:54), and no buffer or
# bucket is smaller than MIN_BUCKET lanes (ops/deferred.py:113)
ROW_PAYLOAD = 1 << 14
MIN_BUCKET = 1 << 14


def _pow2(n):
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _lane_count(k, bases):
    """Lanes of khmer_tpu's phase-major hash of a chunk of `bases`
    (hashtable.py:_chunk_lane_count): 16 phases x rows x the words of a
    row of ROW_PAYLOAD + k - 1 codes."""
    return 16 * (bases // ROW_PAYLOAD) * -(-(ROW_PAYLOAD + k - 1) // 16)


def _first_of_runs(keys, pos=None):
    """Stable-sort keys and keep the first lane of each run of equal
    keys: (distinct keys ascending, the pos of each, or its index in
    keys when pos is None)."""
    keys, order = torch.sort(keys, stable=True)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    order = order[first]
    return keys[first], order if pos is None else pos[order]


class _Ledger:
    """Distinct keys with their first stream positions, held as pieces
    in stream order.  The pieces are combined (a stable sort that keeps
    each key's earliest entry) whenever they hold twice the entries of
    the last combine, so the ledger stays within a few times its
    distinct count and each entry is sorted a bounded number of times
    on average."""

    def __init__(self):
        self.keys, self.firsts = [], []
        self.held = self.kept = 0

    def add(self, keys, firsts):
        self.keys.append(keys)
        self.firsts.append(firsts)
        self.held += keys.numel()
        if len(self.keys) > 1 and self.held > 2 * self.kept:
            self._combine()
            self.held = self.kept = self.keys[0].numel()

    def _combine(self):
        k, f = torch.cat(self.keys), torch.cat(self.firsts)
        self.keys.clear()
        self.firsts.clear()
        k, f = _first_of_runs(k, f)
        self.keys.append(k)
        self.firsts.append(f)

    def take(self):
        """(unsigned sort keys ascending, first positions), or None when
        empty; the ledger is left empty."""
        if not self.keys:
            return None
        if len(self.keys) > 1:
            self._combine()
        out = self.keys[0], self.firsts[0]
        self.__init__()
        return out


class _DeferSchedule:
    """The bookkeeping of khmer_tpu's DeferredCounter
    (ops/deferred.py:591-721) without its buffers: which chunks close a
    cycle of the append buffer, and when a cycle's distinct lanes would
    push the ledger past its budget, so that the ledger is flushed as a
    segment first (_ledger_overflow).  Lanes are khmer_tpu's
    (_lane_count)."""

    def __init__(self, chunk_lanes, max_cap):
        self.max_cap = _pow2(max(int(max_cap), 2 * chunk_lanes))
        self.max_ledger = 4 * self.max_cap
        self.cap = self.fill = self.ledger = 0

    def append(self, lanes):
        """Account one chunk of `lanes` (_make_room).  Returns the merge
        bucket of the cycle that the chunks before it close, or 0."""
        if self.cap == 0:
            self.cap = max(min(max(4 * _pow2(lanes), MIN_BUCKET),
                               self.max_cap), _pow2(lanes))
        bucket = 0
        if self.fill + lanes > self.cap:
            if self.cap < self.max_cap:
                self.cap = max(self.cap, min(max(2 * self.cap,
                                                 _pow2(self.fill + lanes)),
                                             self.max_cap))
            if self.fill + lanes > self.cap:
                bucket = self.finish()
        self.fill += lanes
        return bucket

    def finish(self):
        """Close the open cycle (_cycle); returns its bucket, or 0."""
        bucket = 0
        if self.fill:
            bucket = min(max(_pow2(self.fill), MIN_BUCKET), self.cap)
        self.fill = 0
        return bucket

    def overflows(self, n, bucket):
        """Account a closed cycle's n distinct lanes (_resolve_cycle):
        True when its pow2 block would pass the ledger's budget, so the
        ledger is flushed before the block starts a new one."""
        if n == 0:
            return False
        block = min(_pow2(n), bucket)
        over = self.ledger + block > self.max_ledger
        if over:
            self.ledger = 0
        self.ledger += block
        return over


class _FlatBatcher:
    """Accumulate encoded reads into flat chunks + window masks
    (khmer_tpu/hashtable.py:_FlatBatcher, without the tail padding)."""

    def __init__(self, k, chunk):
        self.k = k
        self.chunk = chunk
        self.parts = []
        self.masks = []
        self.filled = 0

    def add(self, codes):
        """Queue one encoded read; yields (codes, mask) filled chunks.

        Windows near a chunk boundary cannot be hashed in that chunk, so
        after a flush the read continues with a k-1 base overlap and those
        windows are re-emitted (and re-masked) in the next chunk; no
        window is counted twice, because a window that runs past the end
        of a chunk gets weight 0 there (kernel K1).
        """
        k = self.k
        n = codes.shape[0]
        start = 0
        while True:
            space = self.chunk - self.filled
            take = min(n - start, space)
            if take > 0:
                m = np.zeros(take, np.uint8)
                nvalid = (n - start) - k + 1  # windows fully inside the read
                if nvalid > 0:
                    m[: min(nvalid, take)] = 1
                self.parts.append(codes[start: start + take])
                self.masks.append(m)
                self.filled += take
            if self.filled == self.chunk:
                yield self._flush()
                # first window not evaluated in the flushed chunk
                start = max(0, start + take - (k - 1))
                if n - start < k:
                    return
            else:
                return

    def _flush(self):
        data = np.concatenate(self.parts)
        mask = np.concatenate(self.masks)
        self.parts = []
        self.masks = []
        self.filled = 0
        return data, mask

    def drain(self):
        """The partial tail chunk, or None."""
        if self.filled == 0:
            return None
        return self._flush()


class _StreamStats:
    """Read and k-mer totals of one pass over an input."""

    n_reads = 0
    n_consumed = 0


class Hashtable:
    """Base k-mer table over the exact 2-bit hash (k <= 32)."""

    storage_class = None

    def __init__(self, ksize, starting_size=None, n_tables=None,
                 primes=None, device=None):
        ksize = int(ksize)
        if ksize > KSIZE_MAX:
            raise ValueError("k-mer size must be <= 32 for this table type")
        if ksize < 1:
            raise ValueError("k-mer size must be in [1, 255]")
        if primes is None:
            primes = get_n_primes_near_x(n_tables, starting_size)
        self._ksize = ksize
        self.storage = self.storage_class(primes, device=device)

    # -- identity/geometry --------------------------------------------------

    @property
    def device(self):
        return self.storage.device

    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return self.storage.get_tablesizes()

    def n_occupied(self):
        return self.storage.n_occupied()

    def n_unique_kmers(self):
        return self.storage.n_unique_kmers()

    def set_use_bigcount(self, b):
        self.storage.set_use_bigcount(b)

    def get_use_bigcount(self):
        return self.storage.get_use_bigcount()

    # -- hashing --------------------------------------------------------------

    def _valid_sequence(self, sequence):
        if len(sequence) < self._ksize:
            raise ValueError(
                "sequence length ({}) must >= the hashtable k-mer size "
                "({})".format(len(sequence), self._ksize))
        return sequence

    def hash(self, kmer):
        """Hash of a single k-mer (string or passthrough int)."""
        if isinstance(kmer, (int, np.integer)):
            return int(kmer)
        if len(kmer) != self._ksize:
            raise ValueError(
                "Expected k-mer length {} but got {}.".format(
                    self._ksize, len(kmer)))
        return forward_hash(kmer, self._ksize)

    def _lanes(self, sequence):
        """(hashes, weights) device lanes of every window of a raw
        sequence; the last k-1 lanes carry weight 0."""
        codes = torch.from_numpy(enc.encode_sequence(sequence)).to(
            self.device)
        return chunk_hashes(codes, torch.ones_like(codes), self._ksize)

    def _hash_array(self, sequence):
        """All k-mer hashes of a sequence as a numpy uint64 array."""
        h, _ = self._lanes(sequence)
        return _u64.to_numpy(h[: len(sequence) - self._ksize + 1])

    def get_kmer_hashes(self, sequence):
        """Ordered hashes of every k-mer in sequence."""
        self._valid_sequence(sequence)
        return [int(h) for h in self._hash_array(sequence)]

    # -- single k-mer ops -------------------------------------------------

    def add(self, kmer):
        """Increment this k-mer's count; True when previously unseen."""
        return self.storage.add(self.hash(kmer))

    def count(self, kmer):
        self.add(kmer)

    def get(self, kmer):
        """Count of a k-mer (string or int hash)."""
        if isinstance(kmer, float):
            raise TypeError("k-mer must be a string or an integer hash")
        return self.storage.get(self.hash(kmer))

    # -- bulk consume -----------------------------------------------------

    def consume(self, sequence):
        """Count every k-mer in the sequence; returns how many."""
        self._valid_sequence(sequence)
        self.storage.add_lanes(*self._lanes(sequence))
        return len(sequence) - self._ksize + 1

    def _chunks(self, parser_or_filename, chunk, stats):
        """(codes, mask) device chunks of the cleaned input stream: a file
        name goes through the native loader, a parser or any iterable of
        reads through _FlatBatcher.  Fills stats at the end."""
        if isinstance(parser_or_filename, str):
            from khmer_tpu_torch.native import NativeChunkReader

            with NativeChunkReader(parser_or_filename, self._ksize,
                                   chunk) as reader:
                yield from self._to_device(reader)
                stats.n_reads, stats.n_consumed, _ = reader.stats()
        else:
            yield from self._to_device(
                self._batched(parser_or_filename, chunk, stats))

    def _to_device(self, pieces):
        for codes, mask in pieces:
            yield (torch.from_numpy(codes).to(self.device),
                   torch.from_numpy(mask).to(self.device))

    def _batched(self, reads, chunk, stats):
        k = self._ksize
        batcher = _FlatBatcher(k, chunk)
        for read in reads:
            seq = read.cleaned_seq if hasattr(read, "cleaned_seq") \
                else str(read)
            stats.n_reads += 1
            stats.n_consumed += max(len(seq) - k + 1, 0)
            yield from batcher.add(enc.encode_sequence(seq))
        tail = batcher.drain()
        if tail is not None:
            yield tail

    def consume_seqfile(self, parser_or_filename, chunk=CHUNK):
        """Count every k-mer of every (cleaned) read of a file or parser;
        returns (n_reads, n_consumed).  Parity:
        Hashtable::consume_seqfile, src/oxli/hashtable.cc:133-158."""
        stats = _StreamStats()
        for codes, mask in self._chunks(parser_or_filename, chunk, stats):
            self.storage.add_lanes(*chunk_hashes(codes, mask, self._ksize))
        return stats.n_reads, stats.n_consumed

    # -- per-sequence statistics ------------------------------------------

    def get_kmer_counts(self, sequence):
        """Ordered counts of every k-mer in sequence."""
        self._valid_sequence(sequence)
        return [int(c) for c in
                self.storage.get_batch(self._hash_array(sequence))]

    # -- abundance distribution -------------------------------------------

    def abundance_distribution(self, parser_or_filename, tracking,
                               chunk=None, window=None, max_cap=None):
        """Histogram of k-mer counts over a file, deduplicated through the
        `tracking` filter (hashtable.cc:460-501).  Returns a list of
        MAX_BIGCOUNT+1 entries, those of khmer_tpu on either of its
        paths (khmer_tpu/hashtable.py:1708-1770):

        * common path (_abund_windows): khmer_tpu's deferred counter
          gathers the file's distinct hashes cycle by cycle into a
          ledger, which it flushes as a segment when the next cycle
          would pass its budget, and at the end; a segment's distinct
          hashes are tested against tracking once per window of `window`
          keys, in order of first occurrence within the segment.  The
          keywords are khmer_tpu's settings, each defaulting to its
          value on the device (CPU / card): `chunk`, bases per chunk, a
          multiple of 2**14 (KHMER_TPU_CHUNK; 2**20 / 2**23); `window`
          (flush_slice(); 2**23 / 2**25); `max_cap`, lanes of the append
          buffer (KHMER_TPU_DEFER_CAP; 2**23 / 2**26), raised to two
          chunks' lanes and a power of two; the ledger holds 4 x that.
          A file with fewer distinct k-mers than the ledger's budget is
          one segment, whose result does not depend on `chunk`;
        * a bigcount map loaded from disk: membership is tested per
          OVERLAY_CHUNK bases of the stream, khmer_tpu's CHUNK, and
          saturated counts are overlaid from the map (_abund_overlay).
        """
        hist = torch.zeros(MAX_BIGCOUNT + 1, dtype=torch.int64,
                           device=self.device)
        if self.storage.get_use_bigcount() and self.storage.bigcounts:
            fix = self._abund_overlay(parser_or_filename, tracking, hist)
        else:
            cpu = self.device.type == "cpu"
            self._abund_windows(
                parser_or_filename, tracking, hist,
                1 << (20 if cpu else 23) if chunk is None else chunk,
                1 << (23 if cpu else 25) if window is None else window,
                1 << (23 if cpu else 26) if max_cap is None else max_cap)
            fix = 0
        return [int(x) for x in hist.cpu().numpy() + fix]

    def _abund_windows(self, parser_or_filename, tracking, hist, chunk,
                       window, max_cap):
        """khmer_tpu's deferred abundance counter (ops/deferred.py:591-766
        with hashtable.py:_make_abund_counter).  Each chunk's distinct
        live hashes, with their first stream positions, join the open
        cycle's ledger; a closed cycle joins the open segment's, after
        the segment is flushed if the cycle would overflow it
        (_DeferSchedule); the last segment is flushed at the end.  At
        most one segment's ledger is held at a time."""
        if chunk <= 0 or chunk % ROW_PAYLOAD:
            raise ValueError("chunk must be a positive multiple of "
                             "{}".format(ROW_PAYLOAD))
        k = self._ksize
        sched = _DeferSchedule(_lane_count(k, chunk), max_cap)
        cycle, segment = _Ledger(), _Ledger()

        def close(bucket):
            keys, firsts = cycle.take()
            if sched.overflows(keys.numel(), bucket):
                self._flush_segment(segment, tracking, hist, window)
            segment.add(keys, firsts)

        # khmer_tpu pads a short last chunk: to the chunk in the native
        # loader, to a power of two from 2**14 in _FlatBatcher
        native = isinstance(parser_or_filename, str)
        base = 0
        for codes, mask in self._chunks(parser_or_filename, chunk,
                                        _StreamStats()):
            n = codes.numel()
            bases = chunk if native or n == chunk else \
                min(max(_pow2(n), ROW_PAYLOAD), chunk)
            bucket = sched.append(_lane_count(k, bases))
            if bucket:
                close(bucket)
            cycle.add(*self._chunk_firsts(codes, mask, base))
            base += n
        bucket = sched.finish()
        if bucket:
            close(bucket)
        self._flush_segment(segment, tracking, hist, window)

    def _chunk_firsts(self, codes, mask, base):
        """The distinct live hashes of one chunk as unsigned sort keys,
        ascending, each with its first stream position (base + lane)."""
        h, w = chunk_hashes(codes, mask, self._ksize)
        # dead lanes sort last under the largest key, which no canonical
        # hash takes (min(fwd, rc) < 2**64 - 1)
        k, lane = _first_of_runs(torch.where(w != 0, _u64.sort_key(h), _DEAD))
        live = k != _DEAD
        return k[live], lane[live] + base

    def _flush_segment(self, segment, tracking, hist, window):
        """Flush one segment of the ledger (ops/deferred.py:748-766,
        hashtable.py:_make_abund_flush_fn): its distinct keys, ordered by
        first occurrence when there are more than `window`, pass in
        windows of `window` keys through K4 (membership against tracking
        as it stood before the window, count, histogram) and K2 (the
        window's new keys into tracking)."""
        piece = segment.take()
        if piece is None:
            return
        keys, firsts = piece
        del piece
        if keys.numel() > window:
            keys = keys[torch.argsort(firsts)]
        del firsts
        keys = _u64.sort_key(keys)  # back to hash bit patterns
        st, ts = self.storage, tracking.storage
        cap = st.read_cap()
        for off in range(0, keys.numel(), window):
            kw = keys[off: off + window]
            new = kernels.abund_hist(kw, st.table, *st._geom, ts.table,
                                     *ts._geom, cap, hist)
            ts.add_lanes(kw, new)

    def _abund_overlay(self, parser_or_filename, tracking, hist):
        """khmer_tpu's path for a table loaded with a bigcount map
        (hashtable.py:1725-1755): per OVERLAY_CHUNK bases, K4 over the
        chunk's sorted live hashes against tracking as it stood before
        the chunk, K2 adds the new ones to tracking, and K3 finds the new
        hashes whose count is saturated, which the loaded map corrects on
        the host.  Returns the correction, an int64 numpy histogram."""
        st, ts = self.storage, tracking.storage
        cap = st.read_cap()
        fix = np.zeros(MAX_BIGCOUNT + 1, np.int64)
        for codes, mask in self._chunks(parser_or_filename, OVERLAY_CHUNK,
                                        _StreamStats()):
            h, w = chunk_hashes(codes, mask, self._ksize)
            keys = torch.sort(h[w != 0]).values
            new = kernels.abund_hist(keys, st.table, *st._geom, ts.table,
                                     *ts._geom, cap, hist)
            ts.add_lanes(keys, new)
            uniq = keys[new != 0]
            sat = st.get_lanes(uniq).to(torch.int32) == MAX_KCOUNT
            for hv in _u64.to_numpy(uniq[sat]):
                v = st.bigcounts.get(int(hv))
                if v is not None:
                    fix[MAX_KCOUNT] -= 1
                    fix[v] += 1
        return fix

    # -- save/load --------------------------------------------------------

    def save(self, file_name):
        oxli_format.save_storage(file_name, self._ksize, self.storage)

    @classmethod
    def load(cls, file_name, device=None):
        store, ksize = oxli_format.load_storage(
            file_name, cls.storage_class.kind, device=device)
        obj = cls.__new__(cls)
        obj._ksize = ksize
        obj.storage = store
        return obj

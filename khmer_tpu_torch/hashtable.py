"""k-mer table layer: the subset of khmer_tpu/hashtable.py that
load-into-counting and abundance-dist(-single) use.

Device dataflow: the native loader (or the Python _FlatBatcher) cuts the
cleaned 2-bit code stream into flat chunks with a per-window mask; per
chunk, kernel K1 hashes every window in stream order and kernel K2 adds
the lanes to the sketch with the exact claim rule.  One K2 update per
chunk, in stream order, is exact (each chunk's pre-gather sees the adds
of every earlier chunk), so the deferred sort-and-combine counter of
khmer_tpu/ops/deferred.py is not needed for parity.
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


def _first_of_runs(keys, pos=None):
    """Stable-sort keys and keep the first lane of each run of equal
    keys: (distinct keys ascending, the pos of each, or its index in
    keys when pos is None)."""
    keys, order = torch.sort(keys, stable=True)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    order = order[first]
    return keys[first], order if pos is None else pos[order]


def _combine(keys, firsts):
    """Replace the ledger's pieces (lists of distinct keys and their
    first positions, in stream order) by one piece: the earliest entry
    of each key."""
    k, f = torch.cat(keys), torch.cat(firsts)
    keys.clear()
    firsts.clear()
    k, f = _first_of_runs(k, f)
    keys.append(k)
    firsts.append(f)


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
                               chunk=CHUNK, window=None):
        """Histogram of k-mer counts over a file, deduplicated through the
        `tracking` filter (hashtable.cc:460-501).  Returns a list of
        MAX_BIGCOUNT+1 entries, those of khmer_tpu on either of its
        paths (khmer_tpu/hashtable.py:1708-1770):

        * common path: the file's distinct hashes are tested against
          tracking once per window of `window` distinct keys, in order of
          first occurrence (_abund_windows).  `window` defaults to
          khmer_tpu's flush_slice() of the device: 2**23 on the CPU,
          2**25 on the card.  The result does not depend on `chunk`;
        * a bigcount map loaded from disk: membership is tested per
          OVERLAY_CHUNK bases of the stream, khmer_tpu's CHUNK, and
          saturated counts are overlaid from the map (_abund_overlay).
        """
        hist = torch.zeros(MAX_BIGCOUNT + 1, dtype=torch.int64,
                           device=self.device)
        if self.storage.get_use_bigcount() and self.storage.bigcounts:
            fix = self._abund_overlay(parser_or_filename, tracking, hist)
        else:
            if window is None:
                window = 1 << (23 if self.device.type == "cpu" else 25)
            self._abund_windows(parser_or_filename, tracking, hist, chunk,
                                window)
            fix = 0
        return [int(x) for x in hist.cpu().numpy() + fix]

    def _first_occurrences(self, parser_or_filename, chunk):
        """The distinct live hashes of a file, each with its first stream
        position: (unsigned sort keys, int64 positions), sorted by key.

        Per chunk the live lanes are deduplicated (a stable sort keeps
        the earliest lane of each run) and appended to a ledger of
        pieces in stream order; the pieces are combined, by a stable
        sort that keeps the earliest piece's entry, whenever they hold
        twice the entries of the last combine, and at the end.  So the
        ledger stays within a few times the distinct count, and each
        entry is sorted a bounded number of times on average."""
        keys, firsts = [], []
        held = kept = 0  # entries in the pieces, and after the last combine
        base = 0
        for codes, mask in self._chunks(parser_or_filename, chunk,
                                        _StreamStats()):
            k, f = self._chunk_firsts(codes, mask)
            keys.append(k)
            firsts.append(f + base)
            base += codes.numel()
            held += k.numel()
            del k, f
            if len(keys) > 1 and held > 2 * kept:
                _combine(keys, firsts)
                held = kept = keys[0].numel()
        if not keys:
            empty = torch.empty(0, dtype=torch.int64, device=self.device)
            return empty, empty
        if len(keys) > 1:
            _combine(keys, firsts)
        return keys[0], firsts[0]

    def _chunk_firsts(self, codes, mask):
        """The distinct live hashes of one chunk as unsigned sort keys,
        ascending, each with the lane of its first occurrence."""
        h, w = chunk_hashes(codes, mask, self._ksize)
        # dead lanes sort last under the largest key, which no canonical
        # hash takes (min(fwd, rc) < 2**64 - 1)
        k, lane = _first_of_runs(torch.where(w != 0, _u64.sort_key(h), _DEAD))
        live = k != _DEAD
        return k[live], lane[live]

    def _abund_windows(self, parser_or_filename, tracking, hist, chunk,
                       window):
        """khmer_tpu's deferred abundance flush (ops/deferred.py:748-766,
        hashtable.py:_make_abund_flush_fn): the distinct keys, ordered by
        first occurrence when there are more than `window`, pass in
        windows of `window` keys through K4 (membership against tracking
        as it stood before the window, count, histogram) and K2 (the
        window's new keys into tracking)."""
        st, ts = self.storage, tracking.storage
        keys, firsts = self._first_occurrences(parser_or_filename, chunk)
        if keys.numel() > window:
            keys = keys[torch.argsort(firsts)]
        del firsts
        keys = _u64.sort_key(keys)  # back to hash bit patterns
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

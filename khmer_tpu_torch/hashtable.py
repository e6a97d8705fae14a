"""k-mer table layer: the subset of khmer_tpu/hashtable.py that
load-into-counting, abundance-dist(-single), normalize-by-median,
trim-low-abund, filter-abund(-single) and count-median use.

Device dataflow: the native loader (or the Python _FlatBatcher) cuts the
cleaned 2-bit code stream into flat chunks with a per-window mask; per
chunk, kernel K1 hashes every window in stream order.  The bulk consumes
(consume_seqfile and its band and mask filters) run khmer_tpu's deferred
counter, as khmer_tpu's do (ops/deferred.py: the chunks' lanes append,
kernel K16 combines them, and kernels K18 and K19 flush each distinct
k-mer into the table once by the exact claim rule), so that their
bigcount candidates are khmer_tpu's.  consume, tagging and the streaming
filters' tally add a batch with kernel K2 (the claim rule per batch and
sketch_update's candidates, as khmer_tpu's Storage.add_batch).  The
counter's cycle and ledger bookkeeping also decides
abundance_distribution's membership windows, so _DeferSchedule mirrors
it there.

Read-level queries pad rows as khmer_tpu does and read every window's
count with kernel K5, which hashes and reads in one pass.  The
streaming filters take a batch of read bundles per call: K1 (K8 or K11
for murmur or cyclic tables) hashes it,
the batch's distinct k-mers get ids (a sort) and K3 reads their counts
before the batch, kernel K6 (normalize-by-median) or K7 (trim-low-abund)
takes the sequential per-bundle decision in one block, and K2 adds the
taken bundles' tally to the sketch once.

Tables over the murmur hash (Counttable, Nodetable, SmallCounttable;
any k up to 255) take the same paths with kernel K8 in place of K1:
flat chunks of the cleaned stream are turned back into ASCII and hashed
with the bulk-consume complement, and rows carry the ASCII bytes of the
reads.  CyclicCounttable does the same over the cyclic hash, kernel K11
(K5's cyclic variant for the row queries); that hash has one table for
every byte, so it takes no complement form.  SmallCountgraph and
SmallCounttable (NibbleStorage) run the same kernels at read cap 15.

QFCounttable keeps khmer_tpu's design: the filter is a host-exact sorted
(key, count) dictionary (storage.QFStorage), and the device hashes its
reads with K8.  Its batch steps for the streaming filters take the
decisions with K6 / K7 over the batch's distinct filter keys, so that
they equal the reference's read-by-read loop.

A bin-sharded table (Storage.shard_table) consumes through the same
counter, its flush on every piece, and its row counts are K1 (K8, K11)
and the pieces' reads (K20).  The histogram (K4) and the streaming
filters (K6, K7) refuse it (ROADMAP Queue 2 item 4).
"""

import math
import os

import numpy as np
import torch

from khmer_tpu_torch import _u64, kernels
from khmer_tpu_torch._config import KSIZE_MAX, MAX_BIGCOUNT, MAX_KCOUNT
from khmer_tpu_torch.io import oxli_format
from khmer_tpu_torch.io.fastx import FastxReader
from khmer_tpu_torch.ops import encode as enc
from khmer_tpu_torch.ops.hashing import (chunk_hashes, compute_band_interval,
                                         cyclic_window_hashes,
                                         forward_hash, hash_murmur3_scalar,
                                         kmer_hashes_2bit,
                                         murmur_window_hashes, reverse_hash,
                                         row_hashes_counts)
from khmer_tpu_torch.ops.rollinghash import hash_cyclic_scalar
from khmer_tpu_torch.primes import get_n_primes_near_x
from khmer_tpu_torch.storage import (BitStorage, ByteStorage, NibbleStorage,
                                     QFStorage)

# bases per device chunk; any size gives the same table, counts and
# histogram
CHUNK = 1 << 23
# bases per tracking-membership chunk of abundance_distribution on a
# table loaded with a bigcount map (khmer_tpu/hashtable.py:53 CHUNK)
OVERLAY_CHUNK = 1 << 20
# the unsigned sort key of 2**64 - 1, which marks dead lanes
_DEAD = (1 << 63) - 1
# 2-bit code -> ASCII base (A=0 T=1 C=2 G=3), khmer_tpu's _decode_codes
_CODE_ASCII = torch.tensor([65, 84, 67, 71], dtype=torch.uint8)
# khmer_tpu's deferred counter in its own units: a chunk is cut into rows
# of ROW_PAYLOAD bases (khmer_tpu/hashtable.py:54), and no buffer or
# bucket is smaller than MIN_BUCKET lanes (ops/deferred.py:113)
ROW_PAYLOAD = 1 << 14
MIN_BUCKET = 1 << 14
# the most a distinct k-mer adds to its bins in one batch flush
# (khmer_tpu/ops/deferred.py:78); bins past it read as saturated anyway
TOTAL_CLAMP = 1 << 20


def _pow2(n):
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _lane_count(k, bases, hash_kind="2bit"):
    """Lanes of khmer_tpu's hash of a chunk of `bases`
    (hashtable.py:_chunk_lane_count): for the 2-bit hash, phase-major, 16
    phases x rows x the words of a row of ROW_PAYLOAD + k - 1 codes; for
    the byte hashes (murmur, cyclic), ROW_PAYLOAD lanes a row."""
    rows = bases // ROW_PAYLOAD
    if hash_kind != "2bit":
        return rows * ROW_PAYLOAD
    return 16 * rows * -(-(ROW_PAYLOAD + k - 1) // 16)


def chunk_lanes(codes, mask, k, hash_kind="2bit"):
    """(int64 hashes, int32 weights) of the windows of a flat chunk of
    cleaned 2-bit codes with the loader's window mask, lane i the window
    at position i: K1, or for murmur and cyclic K8 (with the bulk-consume
    complement) or K11 over the chunk's codes decoded to uppercase ASCII
    (khmer_tpu/hashtable.py: _decode_codes, _chunk_hashes_weights), one
    lane for each window that ends inside the chunk."""
    if hash_kind == "2bit":
        return chunk_hashes(codes, mask, k)
    ascii = _CODE_ASCII.to(codes.device)[codes.to(torch.int64)]
    if hash_kind == "cyclic":
        h = cyclic_window_hashes(ascii, k)
    else:
        h = murmur_window_hashes(ascii, k, True)
    return h, mask[:h.numel()].to(torch.int32)


def _first_of_runs(keys, pos=None):
    """Stable-sort keys and keep the first lane of each run of equal
    keys: (distinct keys ascending, the pos of each, or its index in
    keys when pos is None)."""
    keys, order = torch.sort(keys, stable=True)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    order = order[first]
    return keys[first], order if pos is None else pos[order]


def _row_width(max_len, k):
    """khmer_tpu's padded row width for rows of at most max_len codes: a
    power of two, at least 64, plus k (hashtable.py:1103-1106)."""
    return max(1 << max(max_len - 1, 1).bit_length(), 64) + k


def _ascii(seq):
    """A sequence's bytes as khmer_tpu's murmur and cyclic tables hash
    them (hashtable.py:_encode)."""
    return np.frombuffer(seq.encode("ascii"), np.uint8).copy()


def _pad_rows(seqs, k, min_rows=1, encode=enc.encode_sequence):
    """Raw sequences as khmer_tpu pads them: uint8 rows [B, L] (2-bit
    codes, or what `encode` makes of a sequence) and int32 lengths [B],
    with B the least power of two >= len(seqs) (and >= min_rows) and
    L = _row_width; rows past the sequences are empty."""
    n = len(seqs)
    lens = np.fromiter(map(len, seqs), np.int64, n)
    L = _row_width(int(lens.max()) if n else 1, k)
    B = max(_pow2(n), min_rows)
    data = np.zeros((B, L), np.uint8)
    codes = encode("".join(seqs))
    starts = np.repeat(np.arange(n, dtype=np.int64) * L - np.cumsum(lens)
                       + lens, lens)
    data.reshape(-1)[starts + np.arange(codes.size)] = codes
    lengths = np.zeros(B, np.int32)
    lengths[:n] = lens
    return data, lengths


def _batch_ids(hashes, valid):
    """Rank of every valid window's hash among the batch's distinct
    hashes (khmer_tpu/hashtable.py:794-805): (int32 ids shaped like
    hashes, 0 where not valid; the distinct hashes, ascending by their
    unsigned value)."""
    keys, inv = torch.unique(_u64.sort_key(hashes[valid]),
                             return_inverse=True)
    ids = torch.zeros(hashes.shape, dtype=torch.int32, device=hashes.device)
    ids[valid] = inv.to(torch.int32)
    return ids, _u64.sort_key(keys)


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
    """Base k-mer table over the exact 2-bit hash (k <= 32) or, for
    hash_kind "murmur" or "cyclic", the murmur or cyclic hash (k <=
    255)."""

    storage_class = None
    hash_kind = "2bit"

    def __init__(self, ksize, starting_size=None, n_tables=None,
                 primes=None, device=None):
        ksize = int(ksize)
        if self.hash_kind == "2bit" and ksize > KSIZE_MAX:
            raise ValueError("k-mer size must be <= 32 for this table type")
        if ksize < 1 or ksize > kernels.MURMUR_MAX_K:
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

    def n_tables(self):
        return self.storage.spec.n_tables

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
        if self.hash_kind == "murmur":
            return hash_murmur3_scalar(kmer)
        if self.hash_kind == "cyclic":
            return hash_cyclic_scalar(kmer, self._ksize)[0]
        return forward_hash(kmer, self._ksize)

    def reverse_hash(self, khash):
        """The k-mer of a 2-bit hash; the murmur and cyclic hashes have
        no inverse (reference hashtable.hh:468-472)."""
        if self.hash_kind != "2bit":
            raise ValueError("not implemented")
        return reverse_hash(khash, self._ksize)

    def _encode(self, sequence):
        """A raw sequence as this table's hash reads it: 2-bit codes, or
        ASCII bytes for murmur and cyclic (khmer_tpu/hashtable.py:
        999-1003)."""
        if self.hash_kind == "2bit":
            return enc.encode_sequence(sequence)
        return _ascii(sequence)

    def _lanes(self, sequence):
        """(hashes, weights) device lanes of every window of a raw
        sequence; for the 2-bit hash the last k-1 lanes carry weight 0,
        for murmur and cyclic there is one lane a window (K8 with the
        full complement table, or K11, as khmer_tpu's _hash_array)."""
        codes = torch.from_numpy(self._encode(sequence)).to(self.device)
        if self.hash_kind == "2bit":
            return chunk_hashes(codes, torch.ones_like(codes), self._ksize)
        h = self._window_hashes(codes)
        return h, torch.ones_like(h, dtype=torch.int32)

    def _window_hashes(self, byts, assume_acgt=False):
        """The byte hash (murmur or cyclic) of every window of one flat
        tensor of ASCII bytes; assume_acgt picks murmur's bulk-consume
        complement and is ignored by the cyclic hash, as in khmer_tpu."""
        if self.hash_kind == "cyclic":
            return cyclic_window_hashes(byts, self._ksize)
        return murmur_window_hashes(byts, self._ksize, assume_acgt)

    def _chunk_lanes(self, codes, mask):
        """chunk_lanes with this table's k and hash."""
        return chunk_lanes(codes, mask, self._ksize, self.hash_kind)

    def _hash_array(self, sequence):
        """All k-mer hashes of a sequence as a numpy uint64 array."""
        if len(sequence) < self._ksize:
            return np.zeros(0, np.uint64)
        h, _ = self._lanes(sequence)
        return _u64.to_numpy(h[: len(sequence) - self._ksize + 1])

    def get_kmer_hashes(self, sequence):
        """Ordered hashes of every k-mer in sequence."""
        self._valid_sequence(sequence)
        return [int(h) for h in self._hash_array(sequence)]

    def get_kmer_hashes_as_hashset(self, sequence):
        """Hashes of every k-mer in sequence as a HashSet
        (reference khmer/_oxli/graphs.pyx get_kmer_hashes_as_hashset)."""
        from khmer_tpu_torch.hashset import HashSet

        return HashSet(self._ksize, self.get_kmer_hashes(sequence))

    def get_kmers(self, sequence):
        """All k-mer substrings, in order; too-short sequences raise
        like the reference binding (graphs.pyx get_kmers)."""
        k = self._ksize
        self._valid_sequence(sequence)
        return [sequence[i: i + k] for i in range(len(sequence) - k + 1)]

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

    def _host_chunks(self, parser_or_filename, chunk, stats):
        """(codes, mask) host numpy chunks of the cleaned input stream: a
        file name goes through the native loader, a parser or any
        iterable of reads through _FlatBatcher.  Fills stats at the end."""
        if isinstance(parser_or_filename, str):
            from khmer_tpu_torch.native import NativeChunkReader

            with NativeChunkReader(parser_or_filename, self._ksize,
                                   chunk) as reader:
                yield from reader
                stats.n_reads, stats.n_consumed, _ = reader.stats()
        else:
            yield from self._batched(parser_or_filename, chunk, stats)

    def _chunks(self, parser_or_filename, chunk, stats):
        """_host_chunks on the table's device."""
        yield from self._to_device(
            self._host_chunks(parser_or_filename, chunk, stats))

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
        Hashtable::consume_seqfile, src/oxli/hashtable.cc:133-158.  With
        two or more devices for the table's device
        (parallel.sharded.default_devices) the consume runs sharded over
        them (_use_sharded, khmer_tpu's rule).  Otherwise a table of
        bins, whole or bin-sharded (Storage.shard_table), consumes through
        the deferred counter (_consume_deferred), as khmer_tpu's bulk
        consumes do (_consume_native, _run_consume); the quotient filter
        adds each chunk to its storage."""
        if self._use_sharded(parser_or_filename):
            return self._consume_sharded(parser_or_filename, chunk)
        if getattr(self.storage, "spec", None) is not None:
            return self._consume_deferred(parser_or_filename, chunk)
        stats = _StreamStats()
        for codes, mask in self._chunks(parser_or_filename, chunk, stats):
            self.storage.add_lanes(*self._chunk_lanes(codes, mask))
        return stats.n_reads, stats.n_consumed

    def _consume_deferred(self, parser_or_filename, chunk=CHUNK,
                          filters=None):
        """consume_seqfile through khmer_tpu's DeferredCounter
        (hashtable.py:1474-1482, and :1333-1338 filtered): each chunk's K1
        (K8, K11) lanes, through K12 when `filters` (band_mask_weights'
        keywords) are given, append at their stream positions; finish()
        combines them (K16) and flushes each distinct k-mer into the table
        once (K18, K19 on the whole table, or on every piece of a
        bin-sharded one).  The same table and n_unique as K2 a chunk, and
        khmer_tpu's bigcount candidates: the keys whose table-0 bin before
        the flush plus their own total passes 255, where K2 takes
        sketch_update's rule (the lanes whose bin passes 255 after the
        batch), which khmer_tpu's bulk consumes do not use.  Returns
        (n_reads, n_consumed), or with filters (n_reads, the k-mers that
        passed)."""
        from khmer_tpu_torch.ops.deferred import DeferredCounter

        counter = DeferredCounter(self.storage, chunk)
        stats = _StreamStats()
        total = torch.zeros(1, dtype=torch.int64, device=self.device)
        for codes, mask in self._chunks(parser_or_filename, chunk, stats):
            h, w = self._chunk_lanes(codes, mask)
            if filters is not None:
                w = kernels.band_mask_weights(h, w, total, **filters)
            counter.append(h, w)
        counter.finish()
        if filters is not None:
            return stats.n_reads, int(total.item())
        return stats.n_reads, stats.n_consumed

    def _use_sharded(self, parser_or_filename=None):
        """khmer_tpu's multi-device dispatch rule
        (khmer_tpu/hashtable.py:1389-1412): never with
        KHMER_TPU_SHARDED=0/off/serial/false, for a table without a
        spec (the quotient filter) or with fewer than two devices; always
        with KHMER_TPU_SHARDED=1/on/force/always/true; else (auto) for a
        file of at least KHMER_TPU_SHARD_MIN_MB (64) megabytes.  It gives
        way for a bin-sharded table, which consumes through the deferred
        counter; both give the same table and n_unique."""
        from khmer_tpu_torch.parallel import sharded

        mode = os.environ.get("KHMER_TPU_SHARDED", "auto").lower()
        if mode in ("0", "off", "serial", "false"):
            return False
        if getattr(self.storage, "spec", None) is None:
            return False
        if self.storage.shards is not None:
            return False
        if len(sharded.default_devices(self.device)) < 2:
            return False
        if mode in ("1", "on", "force", "always", "true"):
            return True
        min_mb = float(os.environ.get("KHMER_TPU_SHARD_MIN_MB", "64"))
        if not isinstance(parser_or_filename, str):
            return False
        try:
            return os.path.getsize(parser_or_filename) >= min_mb * 1e6
        except OSError:
            return False

    def _consume_sharded(self, parser_or_filename, chunk=CHUNK):
        """The multi-device consume (khmer_tpu/hashtable.py:1414-1467):
        every shard hashes and buffers its own chunks, distinct lanes go
        to their hash-band owners at the end (parallel/sharded.py), and
        the table adds the merged delta; n_unique is counted against the
        table as it was."""
        from khmer_tpu_torch.parallel.sharded import (ShardedDeferredConsumer,
                                                      make_mesh)

        st = self.storage
        consumer = ShardedDeferredConsumer(
            st.spec, self._ksize, self.hash_kind,
            mesh=make_mesh(device=self.device), chunk=chunk,
            from_codes=True,
            use_bigcount=st.kind == "byte" and st.get_use_bigcount())
        stats = _StreamStats()
        for codes, mask in self._host_chunks(parser_or_filename, chunk,
                                             stats):
            consumer.add_chunk(codes, mask)
        virgin = int(kernels.count_nonzero(st.table, 0,
                                           st.table.numel()).item()) == 0
        delta, n_unique, n_consumed, cands = consumer.finish(
            None if virgin else st.table, virgin=virgin)
        st.table.add_(delta.to(st.device))
        st._n_unique += n_unique
        st._loaded_occupied = None
        st._wrote()
        if cands and st.get_use_bigcount():
            st.bigcount_candidates.update(cands)
        return stats.n_reads, n_consumed

    def consume_fasta(self, parser_or_filename):
        """1.x name for consume_seqfile (_cpy_khmer.cc hash_consume_fasta)."""
        return self.consume_seqfile(parser_or_filename)

    def consume_fasta_with_reads_parser(self, parser):
        """1.x name for consume_seqfile on an open parser."""
        return self.consume_seqfile(parser)

    def _consume_filtered(self, parser_or_filename, chunk, num_bands=None,
                          band=None, mask=None, threshold=0,
                          consume_masked=False):
        """consume_seqfile through the band and mask filters
        (khmer_tpu/hashtable.py:_run_consume): per chunk, K1 (K8, K11)
        lanes, kernel K12 zeroes the weights of the lanes outside the band
        or failing the mask test and adds the rest to a total on the
        device, and the deferred counter takes the lanes (a weight-0 lane
        is dead: it claims no bin and is no bigcount candidate) and
        flushes them at the end, into the whole table or every piece of a
        bin-sharded one.  The mask is read with this table's hashes, at
        its storage kind's cap and without a loaded bigcount map, as
        khmer_tpu reads it; a bin-sharded mask raises.  Returns (n_reads,
        the k-mers that passed the filters; hashtable.cc:181-191), the
        total read once at the end."""
        if isinstance(parser_or_filename, str):
            # khmer_tpu opens the input before it checks the band
            open(parser_or_filename, "rb").close()
        filters = {}
        if num_bands is not None:
            filters["band"] = compute_band_interval(num_bands, band)
        if mask is not None:
            ms = mask.storage
            ms.refuse_shards("a mask")
            filters.update(zip(("table", "sizes", "offsets", "recips"),
                               (ms.table, *ms._geom)))
            filters.update(cap=ms.read_cap(), threshold=_as_u32(threshold),
                           consume_masked=consume_masked)
        n_reads, passed = self._consume_deferred(parser_or_filename, chunk,
                                                 filters)
        self._refuse_empty(parser_or_filename, n_reads)
        return n_reads, passed

    @staticmethod
    def _refuse_empty(parser_or_filename, n_reads):
        if isinstance(parser_or_filename, str) and not n_reads:
            # khmer_tpu reads these through its parser, which refuses a
            # file without a record (read_parsers.cc:258)
            raise OSError("{} does not contain any sequences!".format(
                parser_or_filename))

    def consume_seqfile_with_mask(self, parser_or_filename, mask,
                                  threshold=0, consume_masked=False,
                                  chunk=CHUNK):
        """Count the k-mers whose count in `mask` is <= threshold (or >=
        threshold with consume_masked=True; hashtable.cc:160-198).
        Returns (n_reads, the k-mers counted)."""
        return self._consume_filtered(parser_or_filename, chunk, mask=mask,
                                      threshold=threshold,
                                      consume_masked=consume_masked)

    def consume_seqfile_banding(self, parser_or_filename, num_bands, band,
                                chunk=CHUNK):
        """Count only the k-mers whose hash falls in band `band` of
        `num_bands` (hashtable.hh:302-344).  Returns (n_reads, the k-mers
        counted)."""
        return self._consume_filtered(parser_or_filename, chunk,
                                      num_bands=num_bands, band=band)

    def consume_seqfile_banding_with_mask(self, parser_or_filename,
                                          num_bands, band, mask,
                                          threshold=0,
                                          consume_masked=False,
                                          chunk=CHUNK):
        """Both filters of consume_seqfile_banding and
        consume_seqfile_with_mask."""
        return self._consume_filtered(parser_or_filename, chunk, num_bands,
                                      band, mask, threshold, consume_masked)

    # -- per-sequence statistics ------------------------------------------

    def get_kmer_counts(self, sequence):
        """Ordered counts of every k-mer in sequence."""
        self._valid_sequence(sequence)
        return [int(c) for c in
                self.storage.get_batch(self._hash_array(sequence))]

    def _upload(self, arr):
        """A host numpy array on the table's device, through pinned memory
        on the card."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _row_counts(self, sequences, want_hashes=False):
        """K5 over the sequences padded as khmer_tpu pads them: (uint16
        counts [B, W], int64 hashes [B, W] or None, bool valid [B, W]) on
        the device, read without the loaded bigcount overlay, as
        khmer_tpu's row functions read them (_read_spec).  A bin-sharded
        table reads K1's (K8's, K11's) hashes of the rows from its pieces
        (K20)."""
        codes, lengths = _pad_rows(sequences, self._ksize,
                                   encode=self._encode)
        st = self.storage
        if st.shards is not None:
            h, valid = self._row_hasher()(self._upload(codes),
                                          self._upload(lengths), self._ksize)
            counts = st.get_lanes(h.reshape(-1)).reshape(h.shape)
            counts = (counts.to(torch.int32) * valid).to(torch.uint16)
            return counts, h if want_hashes else None, valid
        return row_hashes_counts(self._upload(codes), self._upload(lengths),
                                 self._ksize, st._geom, st.table,
                                 st.read_cap(), want_hashes, self.hash_kind)

    def _hash_count_rows(self, sequences):
        """Per-sequence (uint64 hashes, uint16 counts) numpy pairs for a
        batch of sequences, in one K5 call."""
        if not sequences:
            return []
        counts, hashes, _ = self._row_counts(sequences, want_hashes=True)
        counts = counts.cpu().numpy()
        hashes = _u64.to_numpy(hashes)
        out = []
        for i, s in enumerate(sequences):
            w = max(len(s) - self._ksize + 1, 0)
            out.append((hashes[i, :w], counts[i, :w]))
        return out

    def count_rows(self, sequences):
        """Per-sequence uint16 count arrays in one K5 call, which fetches
        counts only (2 B per k-mer)."""
        if not sequences:
            return []
        counts = self._row_counts(sequences)[0].cpu().numpy()
        return [counts[i, :max(len(s) - self._ksize + 1, 0)]
                for i, s in enumerate(sequences)]

    def get_min_count(self, sequence):
        # reference quirk: the running minimum starts at MAX_KCOUNT, so the
        # result never exceeds 255 even with bigcounts (hashtable.cc:425-443)
        return min(MAX_KCOUNT, min(self.get_kmer_counts(sequence)))

    def get_max_count(self, sequence):
        return max(self.get_kmer_counts(sequence))

    def get_median_count(self, sequence):
        """(median, average, stddev) of k-mer counts
        (hashtable.cc:307-339; median = sorted[n/2], population stddev)."""
        counts = np.asarray(self.get_kmer_counts(sequence), np.float64)
        if counts.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        return _median_avg_std(counts)

    def get_median_count_batch(self, sequences):
        """get_median_count for a batch of sequences in one K5 call:
        a list of (median, average, stddev); (0, 0.0, 0.0) for a
        sequence shorter than k."""
        out = []
        for _, counts in self._hash_count_rows(sequences):
            counts = np.asarray(counts, np.float64)
            out.append(_median_avg_std(counts) if counts.size
                       else (0, 0.0, 0.0))
        return out

    def median_at_least(self, sequence, cutoff):
        """True when >= half the k-mers have count >= cutoff
        (hashtable.cc:341-370)."""
        self._valid_sequence(sequence)
        counts = self.storage.get_batch(self._hash_array(sequence))
        min_req = int(0.5 + counts.size / 2.0)
        return bool((counts >= cutoff).sum() >= min_req)

    def median_at_least_batch(self, sequences, cutoff):
        """median_at_least for a batch of sequences in one K5 call and
        one row reduction (khmer_tpu/hashtable.py:_make_median_at_least_fn):
        a bool numpy array, False for a sequence shorter than k."""
        if not sequences:
            return np.zeros(0, bool)
        counts, _, valid = self._row_counts(sequences)
        hits = ((counts.to(torch.int32) >= cutoff) & valid).sum(1)
        n = valid.sum(1)
        out = (hits >= (n + 1) // 2) & (n > 0)
        return out.cpu().numpy()[:len(sequences)]

    def _trim_where(self, sequence, bad_mask):
        """Shared trim logic (hashtable.cc:503-570), including the
        reference quirk that a single-k-mer sequence always trims to 0."""
        n = bad_mask.size
        if n == 1:
            return "", 0
        bad = np.nonzero(bad_mask)[0]
        if bad.size == 0:
            return sequence, len(sequence)
        first = int(bad[0])
        if first == 0:
            return "", 0
        trim_at = first + self._ksize - 1
        return sequence[:trim_at], trim_at

    def trim_on_abundance(self, sequence, abundance):
        """Trim at the first k-mer with count below `abundance`."""
        self._valid_sequence(sequence)
        counts = self.storage.get_batch(self._hash_array(sequence))
        return self._trim_where(sequence, counts < abundance)

    def trim_below_abundance(self, sequence, abundance):
        """Trim at the first k-mer with count above `abundance`."""
        self._valid_sequence(sequence)
        counts = self.storage.get_batch(self._hash_array(sequence))
        return self._trim_where(sequence, counts > abundance)

    def find_spectral_error_positions(self, sequence, max_count):
        """Positions of low-abundance k-mer stretches
        (hashtable.cc:572-625)."""
        self._valid_sequence(sequence)
        counts = self.storage.get_batch(self._hash_array(sequence))
        n = counts.size
        posns = []
        i = 0
        while i < n and counts[i] <= max_count:
            i += 1
        if i == n:
            return posns
        if i > 0:
            posns.append(i - 1)
        j = i + 1
        while j < n:
            if counts[j] <= max_count:
                posns.append(j + self._ksize - 1)
                j += 1
                while j < n and counts[j] <= max_count:
                    j += 1
            j += 1
        return posns

    # -- streaming filters: one batch of read bundles per call ------------

    def _bundle_hashes(self, seq_pairs):
        """The hashes of a batch of bundles' rows (pairs, a missing mate
        an empty row that is not real) padded as khmer_tpu pads them: K1
        (K8, K11) hashes [R, W] with their valid windows, and the rows'
        real flags (uint8 [R]) on the device."""
        rows, real = [], np.zeros(2 * len(seq_pairs), np.uint8)
        for i, (s0, s1) in enumerate(seq_pairs):
            rows += [s0, s1 if s1 is not None else ""]
            real[2 * i] = 1
            real[2 * i + 1] = s1 is not None
        codes, lengths = _pad_rows(rows, self._ksize, min_rows=2,
                                   encode=self._encode)
        realarr = np.zeros(codes.shape[0], np.uint8)
        realarr[:real.size] = real
        h, valid = self._row_hasher()(self._upload(codes),
                                      self._upload(lengths), self._ksize)
        return h, valid, self._upload(realarr)

    def _row_hasher(self):
        """The hash of padded rows for this table's hash: K1 (through
        kmer_hashes_2bit), K8 or K11, each returning (hashes, valid)."""
        return {"murmur": kernels.murmur_hashes,
                "cyclic": kernels.cyclic_hashes}.get(self.hash_kind,
                                                     kmer_hashes_2bit)

    def _chain_batch(self, seq_pairs, chain):
        """One batch step of normalize-by-median or trim-low-abund
        (khmer_tpu/hashtable.py:_make_diginorm_fn, _make_trim_pass1_fn):
        the bundles' hashes (_bundle_hashes), in-batch ids (_batch_ids),
        K3 reads the distinct k-mers' counts before the batch, and
        `chain(ids, valid, real, pre)` (K6 or K7) returns the bundles'
        flags, a bool [B] of the bundles whose k-mers it tallied, and the
        tally.  The tally then goes into the sketch in one K2 call
        (_flush_tally).  Returns what chain returned."""
        self.storage.refuse_shards("the streaming filters' batch step")
        h, valid, real = self._bundle_hashes(seq_pairs)
        ids, keys = _batch_ids(h, valid)
        del h
        valid = valid.to(torch.uint8)
        out = chain(ids, valid, real, self.storage.get_lanes(keys))
        self._flush_tally(keys, ids, valid, *out[-2:])
        return out[:-2]

    def _flush_tally(self, keys, ids, valid, taken, tally):
        """Add the tallied bundles' k-mers to the sketch with the exact
        claim rule (khmer_tpu/hashtable.py:_windowed_claim_flush): each
        distinct k-mer once, weighted by its tally clamped at TOTAL_CLAMP,
        in order of its first window in a tallied bundle, in one K2 call.
        As in khmer_tpu, this flush tracks no bigcount candidates."""
        lanes = valid.bool() & taken.repeat_interleave(2)[:, None]
        pos = torch.nonzero(lanes.reshape(-1)).squeeze(1)
        first = torch.full((keys.numel(),), pos.numel(), dtype=torch.int64,
                           device=keys.device)
        first.scatter_reduce_(0, ids.reshape(-1)[pos].to(torch.int64),
                              torch.arange(pos.numel(), device=pos.device),
                              "amin")
        order = torch.argsort(first)[:int((first < pos.numel()).sum())]
        weights = tally[order].clamp(max=TOTAL_CLAMP)
        self.storage.add_lanes(keys[order], weights, track_bigcount=False)

    def diginorm_batch(self, seq_pairs, desired_coverage):
        """normalize-by-median over one batch of read bundles
        (khmer_tpu/hashtable.py:1128-1180): K6 decides keep or drop per
        bundle with the reference's sequential semantics, and the kept
        reads' k-mers go into the sketch (exact n_unique claim rule).
        Returns the uint8 keep flags [len(seq_pairs)] on the device.

        seq_pairs: list of (seq0, seq1_or_None) cleaned sequences."""
        def chain(ids, valid, real, pre):
            keep, tally = kernels.diginorm_chain(ids, valid, real, pre,
                                                 desired_coverage)
            return keep, keep != 0, tally

        return self._chain_batch(seq_pairs, chain)[0][:len(seq_pairs)]

    def trim_pass1_batch(self, seq_pairs, trim_at_coverage,
                         diginorm_coverage=None, cutoff=2):
        """trim-low-abund's first pass over one batch of read bundles
        (khmer_tpu/hashtable.py:1182-1240): K7 gives each bundle's branch
        (0 skip / 1 trim now / 2 saved, whose k-mers go into the sketch)
        and each row's first window whose count at its turn is below
        cutoff (nw when none).  Returns (uint8 branch
        [len(seq_pairs)], int32 first_bad [B2]) on the device.  A real
        read shorter than k raises ValueError before any upload."""
        k = self._ksize
        for pair in seq_pairs:
            for s in pair:
                if s is not None and len(s) < k:
                    raise ValueError("no k-mer counts; read too short?")

        def chain(ids, valid, real, pre):
            branch, first_bad, tally = kernels.trim_chain(
                ids, valid, real, pre, trim_at_coverage, diginorm_coverage,
                cutoff)
            return branch, first_bad, branch == 2, tally

        branch, first_bad = self._chain_batch(seq_pairs, chain)
        return branch[:len(seq_pairs)], first_bad

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
        self.storage.refuse_shards("the abundance histogram")
        tracking.storage.refuse_shards("the abundance histogram")
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
        sched = _DeferSchedule(_lane_count(k, chunk, self.hash_kind),
                               max_cap)
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
            bucket = sched.append(_lane_count(k, bases, self.hash_kind))
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
        h, w = self._chunk_lanes(codes, mask)
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
            h, w = self._chunk_lanes(codes, mask)
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

    abundance_distribution_with_reads_parser = abundance_distribution

    # -- khmer 1.x/2.x per-read dumps (legacy.py) -------------------------

    def output_fasta_kmer_pos_freq(self, inputfile, outputfile):
        """Per-read window-count dump (lib/counting.cc)."""
        from khmer_tpu_torch import legacy

        return legacy.output_fasta_kmer_pos_freq(self, inputfile, outputfile)

    def fasta_count_kmers_by_position(self, inputfile, max_read_len,
                                      limit_by_count=0):
        """Positional window-count tallies (lib/counting.cc)."""
        from khmer_tpu_torch import legacy

        return legacy.fasta_count_kmers_by_position(
            self, inputfile, max_read_len, limit_by_count)

    # -- save/load --------------------------------------------------------

    def get_raw_tables(self):
        """Per-table byte buffers in the OXLI on-disk layout
        (graphs.pyx:508,966): snapshots of the device table, not live
        views; call again after updates."""
        raw = self.storage.raw_bytes()
        out = []
        off = 0
        for nb in self.storage.spec.bytes_per_table:
            out.append(memoryview(raw[off: off + nb]))
            off += nb
        return out

    def save(self, file_name):
        oxli_format.save_storage(file_name, self._ksize, self.storage)

    @classmethod
    def load(cls, file_name, device=None):
        store, ksize = oxli_format.load_storage(
            file_name, (cls.storage_class.kind,), device=device)
        obj = cls.__new__(cls)
        obj._ksize = ksize
        obj.storage = store
        obj._post_load()
        return obj

    def _post_load(self):
        """Set what a subclass keeps beside the table, for a table made
        without __init__ (a load, convert.table_from_numpy)."""


def _as_u32(value):
    """A mask threshold as khmer_tpu passes it to the device, a uint32
    (jnp.asarray(threshold, U32), hashtable.py:1331): a Python integer
    outside [0, 2**32) is refused before the input is read, and a float
    is cut toward zero (1.5 -> 1)."""
    if isinstance(value, int) and not 0 <= value < 1 << 32:
        raise OverflowError(
            "Python integer {} out of bounds for uint32".format(value))
    return int(value)


def _median_avg_std(counts):
    """(median = sorted[n // 2], average, population stddev) of a float64
    array of counts (hashtable.cc:307-339)."""
    avg = float(counts.mean())
    stddev = float(math.sqrt(((counts - avg) ** 2).mean()))
    return int(np.sort(counts)[counts.size // 2]), avg, stddev


class Counttable(Hashtable):
    """Count-Min sketch over the murmur hash (graphs.pyx:454; k <= 255):
    khmer_tpu/hashtable.py:1853."""

    storage_class = ByteStorage
    hash_kind = "murmur"


class CyclicCounttable(Hashtable):
    """Count-Min sketch over the cyclic (rolling) hash (graphs.pyx:477-491;
    k <= 255): khmer_tpu/hashtable.py:1860.  Its hashes equal the
    reference's CyclicHash<uint64>-based `_hash_cyclic`; every window is
    computed in closed form (ops/rollinghash.py, kernel K11)."""

    storage_class = ByteStorage
    hash_kind = "cyclic"


class SmallCounttable(Hashtable):
    """4-bit Count-Min sketch over the murmur hash (counts read at cap
    15): khmer_tpu/hashtable.py:2084."""

    storage_class = NibbleStorage
    hash_kind = "murmur"


class Nodetable(Hashtable):
    """Bloom filter over the murmur hash: khmer_tpu/hashtable.py:2091."""

    storage_class = BitStorage
    hash_kind = "murmur"


class QFCounttable(Hashtable):
    """Counting-quotient-filter counttable (graphs.pyx:413-452):
    khmer_tpu/hashtable.py:1872-2009.

    Counts are EXACT per key over the CQF key space `khash % (nslots *
    2**slot bits)` and equal qf_count_key_value's (storage.QFStorage);
    the slot-shifting insert of gqf.c is a sorted-dictionary merge on the
    host, and the reads are hashed on the device with K8 (MurmurHash3, k
    up to 255).  Saved as SAVED_QFCOUNT, the reference's raw MQF dump."""

    storage_class = QFStorage
    hash_kind = "murmur"

    def __init__(self, k, size, slot_size=None, on_disk=None, device=None):
        k = int(k)
        if k < 1 or k > kernels.MURMUR_MAX_K:
            raise ValueError("k-mer size must be in [1, 255]")
        size = int(size)
        if size & (size - 1):
            # the reference rounds the slots up to a power of two
            size = 1 << (size - 1).bit_length()
        self.slot_size = slot_size  # MQF remainder width
        self._ksize = k
        self.storage = QFStorage(size, slot_size, on_disk=on_disk,
                                 device=device)

    def n_tables(self):
        return self.storage.n_tables

    def _consume_filtered(self, parser_or_filename, chunk, num_bands=None,
                          band=None, mask=None, threshold=0,
                          consume_masked=False):
        """khmer_tpu's QF consume with its filters (hashtable.py:
        1906-1933): per chunk, K8 lanes cross to the host, where the band
        and the mask (read with its own get_batch, so any table type, with
        a loaded bigcount map) zero the weights of the lanes they drop."""
        if isinstance(parser_or_filename, str):
            open(parser_or_filename, "rb").close()
        bmin = bmax = None
        if num_bands is not None:
            bmin, bmax = compute_band_interval(num_bands, band)
        stats = _StreamStats()
        n_consumed = 0
        for codes, m in self._chunks(parser_or_filename, chunk, stats):
            h, w = self._chunk_lanes(codes, m)
            hashes = _u64.to_numpy(h)
            w = w.cpu().numpy().astype(np.uint64)
            if bmin is not None:
                w = w * ((hashes >= bmin) & (hashes < bmax))
            if mask is not None:
                mc = np.asarray(mask.storage.get_batch(hashes))
                w = w * (mc >= threshold if consume_masked
                         else mc <= threshold)
            n_consumed += int(w.sum())
            self.storage.add_batch_fast(hashes, w)
        if isinstance(parser_or_filename, str) and not stats.n_reads:
            raise OSError("{} does not contain any sequences!".format(
                parser_or_filename))
        return stats.n_reads, n_consumed

    def _hash_rows(self, sequences):
        """Per-sequence uint64 hash arrays of a batch of sequences, from
        one K8 call over the rows padded as khmer_tpu pads them."""
        if not sequences:
            return []
        codes, lengths = _pad_rows(sequences, self._ksize,
                                   encode=self._encode)
        h, _ = kernels.murmur_hashes(self._upload(codes),
                                     self._upload(lengths), self._ksize)
        h = _u64.to_numpy(h)
        return [h[i, :max(len(s) - self._ksize + 1, 0)]
                for i, s in enumerate(sequences)]

    def _hash_count_rows(self, sequences):
        rows = self._hash_rows(sequences)
        if not rows:
            return []
        counts = self.storage.get_batch(np.concatenate(rows))
        out = []
        off = 0
        for r in rows:
            out.append((r, counts[off: off + r.shape[0]]))
            off += r.shape[0]
        return out

    def count_rows(self, sequences):
        return [c for _, c in self._hash_count_rows(sequences)]

    def median_at_least_batch(self, sequences, cutoff):
        out = np.zeros(len(sequences), bool)
        for i, (_, counts) in enumerate(self._hash_count_rows(sequences)):
            n = counts.size
            if n:
                out[i] = (counts >= cutoff).sum() >= int(0.5 + n / 2.0)
        return out

    def _chain_batch(self, seq_pairs, chain):
        """The streaming filters' batch step over the filter's keys: K8
        hashes the bundles' rows (_bundle_hashes), the windows get ids
        among the batch's distinct keys, `chain` (K6 or K7) takes the
        decisions from each key's count before the batch (read from the
        filter, narrowed to uint16) plus its tally, and the tally goes
        into the filter.  A
        read's count is then what the reference's loop reads, except where
        a key's narrowed count plus its windows in the batch pass 65535,
        so that the narrowed count wraps within the batch: such a batch is
        taken as two halves, and a single bundle never wraps (its own adds
        come after its decision)."""
        st = self.storage
        h, valid, real = self._bundle_hashes(seq_pairs)
        # the filter's keys: its range is a power of two
        ids, keys = _batch_ids(h & _u64.i64(int(st.range) - 1), valid)
        del h
        keys = _u64.to_numpy(keys)
        pre = st.lookup_keys(keys) & np.uint64(0xFFFF)
        windows = torch.bincount(ids[valid].to(torch.int64),
                                 minlength=keys.size).cpu().numpy()
        if len(seq_pairs) > 1 and \
                (pre.astype(np.int64) + windows > 0xFFFF).any():
            half = len(seq_pairs) // 2
            a = self._chain_batch(seq_pairs[:half], chain)
            b = self._chain_batch(seq_pairs[half:], chain)
            return tuple(torch.cat([x[:half * (x.numel() // a[0].numel())],
                                    y]) for x, y in zip(a, b))
        out = chain(ids, valid.to(torch.uint8), real,
                    torch.from_numpy(pre.astype(np.uint16)).to(self.device))
        tally = out[-1].cpu().numpy().view(np.uint32)
        live = tally != 0
        st.add_keys(keys[live], tally[live].astype(np.uint64))
        return out[:-2]

    def abundance_distribution(self, parser_or_filename, tracking=None):
        """Histogram of k-mer abundances with exact dedup
        (khmer_tpu/hashtable.py:1963-1995): the filter's exact counts
        need no tracking filter."""
        dist = np.zeros(MAX_BIGCOUNT + 1, np.uint64)
        seen = set()
        batch = []

        def drain():
            for hashes, counts in self._hash_count_rows(batch):
                for h, c in zip(hashes, counts):
                    h = int(h)
                    if h not in seen:
                        seen.add(h)
                        dist[int(c)] += 1
            batch.clear()

        reads = FastxReader(parser_or_filename) \
            if isinstance(parser_or_filename, str) else parser_or_filename
        for read in reads:
            seq = read.cleaned_seq if hasattr(read, "cleaned_seq") \
                else str(read)
            if len(seq) >= self._ksize:
                batch.append(seq)
                if len(batch) >= 512:
                    drain()
        drain()
        return [int(x) for x in dist]

    abundance_distribution_with_reads_parser = abundance_distribution

    def get_raw_tables(self):
        # the reference's QFStorage::get_raw_tables returns nullptr
        raise ValueError("get_raw_tables is not supported for QF tables")

    def _post_load(self):
        self.slot_size = None


class OnDiskQFCounttable(QFCounttable):
    """Disk-backed quotient-filter counttable, the fork's onDiskMQF
    (reference third-party/MQF/onDiskMQF.h): khmer_tpu/hashtable.py:
    2012-2024.  The sorted (key, count) arrays spill to memmap files in
    `directory`, so the filter can exceed RAM; saves and loads use the
    raw MQF dump of QFCounttable."""

    def __init__(self, k, size, slot_size=None, directory=None,
                 device=None):
        if directory is None:
            raise ValueError("OnDiskQFCounttable requires a directory")
        super().__init__(k, size, slot_size, on_disk=directory,
                         device=device)


class BufferedQFCounttable(QFCounttable):
    """The fork's buffered MQF (reference third-party/MQF/bufferedMQF.h:
    35-45): khmer_tpu/hashtable.py:2027-2070.  `addToBufferQuery`
    collects read sequences, `queryBuffer` resolves every buffered k-mer's
    count in one batch (one K8 call), and per-read queries are served
    from that cache until `clearQueryBuffer`."""

    def __init__(self, k, size, slot_size=None, device=None):
        super().__init__(k, size, slot_size, device=device)
        self._query_buffer = []
        self._query_cache = {}

    def addToBufferQuery(self, sequence):
        self._query_buffer.append(sequence)

    def queryBuffer(self):
        seqs = [s for s in self._query_buffer if len(s) >= self._ksize]
        if not seqs:
            return
        flat = np.concatenate(self._hash_rows(seqs))
        counts = self.storage.get_batch(flat)
        self._query_cache.update(
            (int(h), int(c)) for h, c in zip(flat, counts))

    def clearQueryBuffer(self):
        self._query_buffer = []
        self._query_cache = {}

    def get_kmer_counts(self, sequence):
        cache = self._query_cache
        if cache:
            hashes = self._hash_array(sequence)
            if all(int(h) in cache for h in hashes):
                return [cache[int(h)] for h in hashes]
        return super().get_kmer_counts(sequence)

    def get_median_count(self, sequence):
        counts = np.asarray(self.get_kmer_counts(sequence), np.float64)
        if counts.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        return _median_avg_std(counts)

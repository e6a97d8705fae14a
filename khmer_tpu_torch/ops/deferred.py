"""The deferred counter: its constants, stage timer, combines, flush and
DeferredCounter.

Port of khmer_tpu/ops/deferred.py: the dead-lane patterns and the total
clamp (:73-78), the bucket constants (:113-115), the flush window and
buffer sizes (:97-111, :194-207), the stage timer (:141-191), the
combines of a lane buffer (:270-325, kernel K16), _sort_by_first
(:334-341), the claim-rule flush (flush_table_ops :345-428 and
flush_table_ops_dense :431-468, which give the same bits, so the port
has one: the dense strategy, run piece by piece by kernels K18 and K19),
choose_flush_ops / make_flush_fn (:471-492) and DeferredCounter
(:516-821).

Lanes are (key, weight, first): keys are int64 bit patterns of uint64
hashes (khmer_tpu_torch/_u64.py), SENTINEL marking a dead lane; weights
and first positions are int32 bit patterns of uint32.  A lane's first
position is its place in the consume's k-mer stream (reads in file
order, k-mers left to right), and a combine keeps each distinct key's
least one: the first-occurrence index of the reference's exact
sequential n_unique claim rule (khmer_tpu/ops/deferred.py docstring).
Positions are u32, so a consume of more than 2**32 k-mer occurrences
wraps, as khmer_tpu's does.

The flush takes distinct lanes into a flat table or into the pieces of
a bin-sharded one (storage.BinShards).  Every piece sees every lane: K18
claims the piece's own bins (an unsigned atomic min of first positions
into a scratch of the piece's bins, CLAIM_WINDOW at a time) and sets
the flags of the lanes that won a bin that was empty, K19 adds the
totals, and the mesh's sum of the flags gives each lane's was-new flag.
A bin belongs to one piece, so no claim crosses the mesh.

The counter is the bulk consume of every table of bins, whole or
bin-sharded (khmer_tpu_torch/hashtable.py:_consume_deferred), as in
khmer_tpu: its bigcount candidates are the keys whose table-0 bin before
the flush plus their own total passes 255, which K2 a chunk (the rule of
khmer_tpu's sketch_update) would not give.  On a bin-sharded table a
key's bins lie on several pieces, and each distinct key reaches every
piece once.
khmer_tpu's TPU workarounds are not ported: the asynchronous fetches
(_fetch_async, _FETCH_POOL), the shape buckets and the donation copies.
"""

import os
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from khmer_tpu_torch import _u64, kernels
from khmer_tpu_torch.kernels.plain import (IDX_SENTINEL, SENTINEL,
                                           TOTAL_CLAMP)

__all__ = ["SENTINEL", "IDX_SENTINEL", "TOTAL_CLAMP", "MIN_BUCKET",
           "MIN_MERGE", "flush_slice", "default_max_cap", "stage",
           "combine_lanes", "combine_unit_lanes", "flush_table_ops",
           "flush_table_ops_dense", "choose_flush_ops", "make_flush_fn",
           "DeferredCounter"]

# smallest buffer/bucket granule: one hash-kernel row of lanes
MIN_BUCKET = 1 << 14
# buffer sizing hint for the sharded consumer's per-shard cap
MIN_MERGE = 1 << 24
# the most bins of a piece that K18 claims at once: its claim scratch,
# four bytes a bin, stays at 1 GiB however large the piece
CLAIM_WINDOW = 1 << 28
# bigcount candidates a piece keeps from one flush; a flush with more is
# recovered from its lanes (DeferredCounter._account)
CAND_LANES = 1 << 20


def _on_card(device):
    return torch.device(device).type == "cuda"


def flush_slice(device):
    """The largest routing and flush window, in lanes: 2**25 on the card,
    2**23 on the CPU."""
    return 1 << (25 if _on_card(device) else 23)


def _next_pow2(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def default_max_cap(device):
    """Buffer ceiling in lanes (16 bytes a lane: key, weight, first):
    2**27 on the card, 2**23 on the CPU."""
    return 1 << (27 if _on_card(device) else 23)


# -- stage timing (KHMER_TPU_TIMING=1, or enable_timing()) ------------------

STAGE_TIMES = defaultdict(float)
STAGE_LANES = defaultdict(int)
_TIMING = [bool(os.environ.get("KHMER_TPU_TIMING"))]


def timing_enabled():
    return _TIMING[0]


def enable_timing(on=True):
    """Turn the stage timer on or off for this process."""
    _TIMING[0] = bool(on)


def reset_stage_times():
    STAGE_TIMES.clear()
    STAGE_LANES.clear()


class _StageHandle:
    __slots__ = ("sync",)

    def __init__(self, sync=None):
        self.sync = sync


@contextmanager
def stage(name, lanes=0, sync=None):
    """Add the wall time (and lanes) of the body to STAGE_TIMES[name]
    when timing is on; otherwise free.  In timing mode each stage waits
    for its own device work: the body sets `handle.sync` to a tensor
    made inside it, and the exit synchronises that tensor's device
    (every device when none is set), so the stage sums approach the
    device's wall while the untimed run keeps the host ahead."""
    if not _TIMING[0]:
        yield None
        return
    h = _StageHandle(sync)
    t0 = time.perf_counter()
    yield h
    if isinstance(h.sync, torch.Tensor):
        if h.sync.is_cuda:
            torch.cuda.synchronize(h.sync.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()
    STAGE_TIMES[name] += time.perf_counter() - t0
    STAGE_LANES[name] += int(lanes)


if _TIMING[0] and os.environ.get("KHMER_TPU_TIMING_OUT"):
    import atexit as _atexit
    import json as _json

    def _dump_stage_times(path=os.environ["KHMER_TPU_TIMING_OUT"]):
        with open(path, "w") as f:
            _json.dump({"times_s": {k: round(v, 4)
                                    for k, v in STAGE_TIMES.items()},
                        "lanes": dict(STAGE_LANES)}, f)

    _atexit.register(_dump_stage_times)


# -- combines ----------------------------------------------------------------


def combine_lanes(keys, wgts, idx):
    """Combine the duplicate keys of a weighted lane buffer (K16): totals
    add (each weight clamped at TOTAL_CLAMP, the sum mod 2**32, clamped
    again), first positions take their minimum.  Returns (keys, totals,
    firsts, n_valid): the distinct live keys compacted to the front, in
    no specified order, SENTINEL lanes after; n_valid an int64 [1]
    tensor on the buffer's device."""
    return kernels.combine_lanes(keys, wgts, idx)


def combine_unit_lanes(keys, idx):
    """combine_lanes for a unit-weight (key, position) buffer: every live
    lane weighs 1, so a key's total is its occurrences, clamped."""
    w = (keys != SENTINEL).to(torch.int32)
    return kernels.combine_lanes(keys, w, idx)


def _sort_by_first(keys, totals, firsts):
    """Order distinct lanes by first position, read unsigned: one stable
    sort (khmer_tpu's one lax.sort), so that flush windows keep the
    reference's sequence (khmer_tpu/ops/deferred.py docstring)."""
    order = torch.sort(_u64.u32(firsts), stable=True).indices
    return keys[order], totals[order], firsts[order]


# -- flush -------------------------------------------------------------------


def _flush_parts(target, spec):
    """(pieces as (piece, lo, geometry), mesh or None) of a flush target:
    a storage.BinShards, or one flat table tensor."""
    if isinstance(target, torch.Tensor):
        return [(target, 0, spec.geometry(target.device))], None
    return target.parts(), target.mesh


def flush_lanes(target, spec, keys, totals, firsts, virgin, track_bigcount):
    """Flush lanes of (key, total, first) into a flat table or the pieces
    of a bin-sharded one, in place, by the reference's claim rule: on
    every piece K18 claims and flags the lanes over the piece's own bins
    (a scratch of CLAIM_WINDOW bins at a time) and K19 adds the totals.
    A lane is new iff it holds some table's bin claim (the least first
    position of the live lanes there) and, unless virgin, the bin was 0.
    Distinct keys give khmer_tpu's flush; lanes that repeat a key with
    their lane indices as first positions give K2's was-new flags.
    Returns (bool won [n] on the keys' device, the int64 bigcount
    candidates found or None, their number, which passes the found ones'
    when a piece's buffer of CAND_LANES overflowed)."""
    parts, mesh = _flush_parts(target, spec)
    n, home = keys.numel(), keys.device
    if mesh is None:
        lanes = [(keys, totals, firsts)]
    else:
        lanes = list(zip(*(mesh.replicate(x) for x in (keys, totals,
                                                        firsts))))
    flags, cands = [], []
    for (k, w, f), (piece, lo, geom) in zip(lanes, parts):
        dev = piece.device
        fl = torch.zeros(n, dtype=torch.int32, device=dev)
        cand = cand_count = None
        if track_bigcount:
            cand = torch.empty(min(n, CAND_LANES), dtype=torch.int64,
                               device=dev)
            cand_count = torch.zeros(1, dtype=torch.int32, device=dev)
        for wlo in range(0, piece.numel(), CLAIM_WINDOW):
            kernels.owned_claims(k, w, f, piece[wlo: wlo + CLAIM_WINDOW],
                                 lo + wlo, *geom, fl, virgin, cand,
                                 cand_count)
        kernels.owned_add(k, w, piece, lo, *geom)
        flags.append(fl)
        cands.append((cand, cand_count))
    won = flags[0] if mesh is None else mesh.all_reduce(flags, "sum")[0]
    won = won.to(home) != 0
    if not track_bigcount:
        return won, None, 0
    counts = [int(c.item()) for _, c in cands]
    found = torch.cat([c[:min(m, c.numel())].to(home)
                       for (c, _), m in zip(cands, counts)])
    return won, found, sum(counts)


def flush_table_ops(spec, table, keys, totals, firsts, virgin,
                    track_bigcount):
    """Flush one window of distinct (key, total, first) lanes into the
    table (a flat table tensor, or a storage.BinShards layout), in place,
    and count n_unique by the reference's claim rule (K18, K19;
    flush_lanes).  Returns (table, n_new) or, when track_bigcount,
    (table, n_new, cand, n_cross): n_new an int64 tensor, cand the int64
    keys whose table-0 bin may now pass 255 (khmer_tpu's superset, in no
    order; resolved at save time) and n_cross their number, which is
    larger than cand's only when a piece's candidate buffer
    overflowed."""
    won, cand, n_cross = flush_lanes(table, spec, keys, totals, firsts,
                                     virgin, track_bigcount)
    if track_bigcount:
        return table, won.sum(), cand, n_cross
    return table, won.sum()


# khmer_tpu's dense strategy gives the same bits as its sort strategy;
# the port's one flush is the dense one
flush_table_ops_dense = flush_table_ops


def choose_flush_ops(spec, n_lanes):
    """khmer_tpu's strategy chooser; the port has one flush."""
    del spec, n_lanes
    return flush_table_ops


def make_flush_fn(spec, virgin, track_bigcount):
    """One-window flush fn(table, keys, totals, firsts) (choose_flush_ops'
    strategy with these settings)."""
    def fn(table, keys, totals, firsts):
        return flush_table_ops(spec, table, keys, totals, firsts, virgin,
                               track_bigcount)
    return fn


class DeferredCounter:
    """Deferred counting of one bulk consume into a storage (khmer_tpu's
    retain/ledger design, khmer_tpu/ops/deferred.py:516-821).

    Chunks of (key, unit weight) lanes append into a key and position
    buffer; a full buffer is a cycle, combined (K16) into its distinct
    (key, total, first) lanes, which join a ledger at the next cycle's
    boundary; finish() combines the ledger (K16) and flushes it into the
    table (flush_table_ops), each distinct key once.  A ledger that would
    pass max_ledger lanes is flushed first (_ledger_overflow), and a
    flush of more than flush_slice() lanes goes in windows of first
    positions (_sort_by_first): both stay exact, since a later flush sees
    the keys of an earlier one as present, as the reference's serial
    loop does.  Buffers are sized from the first chunk and grow up to
    max_cap lanes; the ledger holds 4 x max_cap.  Counts, n_unique and
    bigcount candidates do not depend on these sizes."""

    MERGE_EVERY = 1 << 25

    def __init__(self, storage, chunk_lanes, max_cap=None):
        chunk_lanes = int(chunk_lanes)
        self.device = storage.device
        if max_cap is None:
            max_cap = min(2 * self.MERGE_EVERY,
                          default_max_cap(self.device))
        max_cap = max(int(max_cap), 2 * chunk_lanes)
        self.max_cap = _next_pow2(max_cap)
        self.max_ledger = 4 * self.max_cap
        self.chunk_lanes = chunk_lanes
        self.storage = storage
        self.spec = storage.spec
        self.cap = 0
        self.keys = None
        self.idx = None
        self.fill = 0
        # stream position of the next appended chunk's first lane
        self.pos_base = 0
        self._track_bigcount = storage.kind == "byte" and \
            storage.get_use_bigcount()
        self.ledger_k = None
        self.ledger_w = None
        self.ledger_f = None
        self.ledger_cap = 0
        self.ledger_fill = 0
        self._pending_cycle = None  # (keys, totals, firsts, n_valid)
        self._bc_pending = []       # candidate tensors of the flushes

    # -- streaming ----------------------------------------------------------

    def append(self, keys, weights, idx=None):
        """Append one chunk of lanes (int64 keys, int32 weights; a lane
        of weight 0 is dead).  `idx` (int32) carries each lane's position
        in the consume's k-mer stream; None takes the lane order from
        pos_base on."""
        lanes = int(keys.numel())
        if idx is None:
            idx = torch.arange(self.pos_base, self.pos_base + lanes,
                               dtype=torch.int64,
                               device=keys.device).to(torch.int32)
        self._make_room(lanes)
        with stage("append", lanes=lanes) as s:
            end = self.fill + lanes
            self.keys[self.fill:end] = torch.where(weights != 0, keys,
                                                   SENTINEL)
            self.idx[self.fill:end] = idx
            if s is not None:
                s.sync = self.keys
        self.fill += lanes
        self.pos_base += lanes

    def append_chunk(self, fn, consumed, inputs, extra=(), lanes=None,
                     stream_len=None):
        """Append the lanes of fn(consumed, *inputs, *extra) -> (keys,
        weights, consumed): one chunk's hash and filter kernels.
        `stream_len` is the chunk's length in the k-mer stream (the lane
        count by default).  Returns the new consumed."""
        keys, weights, consumed = fn(consumed, *inputs, *extra)
        base = self.pos_base
        self.append(keys, weights)
        if lanes is not None and int(lanes) != keys.numel():
            raise ValueError("append_chunk: fn gave {} lanes, not {}".format(
                keys.numel(), lanes))
        self.pos_base = base + (keys.numel() if stream_len is None
                                else int(stream_len))
        return consumed

    def _make_room(self, lanes):
        if self.keys is None:
            cap = min(max(4 * _next_pow2(lanes), MIN_BUCKET), self.max_cap)
            self._alloc(max(cap, _next_pow2(lanes)))
        if self.fill + lanes <= self.cap:
            return
        if self.cap < self.max_cap:
            self._grow(self.fill + lanes)
            if self.fill + lanes <= self.cap:
                return
        self._cycle()

    def _alloc(self, cap):
        self.cap = int(cap)
        self.keys = torch.full((self.cap,), SENTINEL, dtype=torch.int64,
                               device=self.device)
        self.idx = torch.full((self.cap,), IDX_SENTINEL, dtype=torch.int32,
                              device=self.device)

    def _grow(self, need=0):
        new_cap = min(max(self.cap * 2, _next_pow2(need)), self.max_cap)
        if new_cap <= self.cap:
            return
        keys, idx = self.keys, self.idx
        self._alloc(new_cap)
        self.keys[:self.fill] = keys[:self.fill]
        self.idx[:self.fill] = idx[:self.fill]

    # -- cycle: combine the append buffer, retain in the ledger --------------

    def _cycle(self):
        """Combine the append buffer's lanes (K16) and keep the distinct
        ones pending; they join the ledger at the next boundary, so that
        the host reads their number only then."""
        if self.fill == 0:
            return
        self._resolve_cycle()
        with stage("combine", lanes=self.fill) as s:
            out = combine_unit_lanes(self.keys[:self.fill],
                                     self.idx[:self.fill])
            if s is not None:
                s.sync = out[3]
        self._pending_cycle = out
        self.fill = 0

    def _resolve_cycle(self):
        """Append the pending cycle's distinct lanes to the ledger,
        flushing the ledger first if they would pass max_ledger."""
        if self._pending_cycle is None:
            return
        ck, cw, cf, n_valid = self._pending_cycle
        self._pending_cycle = None
        n = int(n_valid.item())
        if n == 0:
            return
        if self.ledger_fill + n > self.max_ledger:
            self._ledger_overflow()
        self._ledger_room(self.ledger_fill + n)
        end = self.ledger_fill + n
        with stage("ledger", lanes=n) as s:
            self.ledger_k[self.ledger_fill:end] = ck[:n]
            self.ledger_w[self.ledger_fill:end] = cw[:n]
            self.ledger_f[self.ledger_fill:end] = cf[:n]
            if s is not None:
                s.sync = self.ledger_k
        self.ledger_fill = end

    def _ledger_room(self, need):
        need = max(_next_pow2(need), MIN_BUCKET)
        if self.ledger_k is not None and need <= self.ledger_cap:
            return
        old = (self.ledger_k, self.ledger_w, self.ledger_f)
        self.ledger_k = torch.full((need,), SENTINEL, dtype=torch.int64,
                                   device=self.device)
        self.ledger_w = torch.zeros(need, dtype=torch.int32,
                                    device=self.device)
        self.ledger_f = torch.full((need,), IDX_SENTINEL, dtype=torch.int32,
                                   device=self.device)
        self.ledger_cap = need
        if old[0] is not None:
            for new, was in zip((self.ledger_k, self.ledger_w,
                                 self.ledger_f), old):
                new[:self.ledger_fill] = was[:self.ledger_fill]

    def _ledger_overflow(self):
        """Flush what the ledger holds and empty it: still exact, as every
        key of this flush first occurred before any key of a later one."""
        mk, mw, mf, n = self._combined_ledger()
        if n:
            self._flush_distinct(mk, mw, mf, n)

    def _combined_ledger(self):
        """Combine the ledger's cross-cycle duplicates (K16) and empty it;
        returns (keys, totals, firsts, n_distinct), compacted to the
        front."""
        if self.ledger_fill == 0:
            return None, None, None, 0
        f = self.ledger_fill
        with stage("ledger-combine", lanes=f) as s:
            mk, mw, mf, nv = combine_lanes(self.ledger_k[:f],
                                           self.ledger_w[:f],
                                           self.ledger_f[:f])
            if s is not None:
                s.sync = nv
        self.ledger_k = self.ledger_w = self.ledger_f = None
        self.ledger_cap = 0
        self.ledger_fill = 0
        return mk, mw, mf, int(nv.item())

    # -- flush ---------------------------------------------------------------

    def _flush_distinct(self, mk, mw, mf, n):
        """Flush n distinct (key, total, first) lanes into the table, in
        windows of flush_slice() lanes ordered by first position when
        there are more (K16 leaves them in no order)."""
        F = flush_slice(self.device)
        mk, mw, mf = mk[:n], mw[:n], mf[:n]
        if n > F:
            with stage("order", lanes=n) as s:
                mk, mw, mf = _sort_by_first(mk, mw, mf)
                if s is not None:
                    s.sync = mk
        self._flush_windows(mk, mw, mf, n, F)

    def _flush_windows(self, mk, mw, mf, n, F):
        st = self.storage
        for off in range(0, n, F):
            virgin = st.is_virgin() and off == 0
            fn = make_flush_fn(self.spec, virgin, self._track_bigcount)
            keys = mk[off: off + F]
            with stage("flush", lanes=keys.numel() * self.spec.n_tables) \
                    as s:
                out = fn(st.flush_target(), keys, mw[off: off + F],
                         mf[off: off + F])
                if s is not None:
                    s.sync = out[1]
            st._wrote()
            self._account(st, out[1:], keys)
        st._loaded_occupied = None

    def _account(self, st, out, keys):
        """Add a window's n_new to n_unique and keep its candidates (a
        window whose candidates overflowed takes every key of its own
        whose count now passes 255)."""
        if self._track_bigcount:
            n_new, cand, n_cross = out
            if cand.numel() < n_cross:
                self._bc_pending.append(_u64.as_tensor(
                    st._counts_over_kcount(keys[keys != SENTINEL]),
                    self.device))
            else:
                self._bc_pending.append(cand)
        else:
            (n_new,) = out
        st._n_unique += n_new.to(st._n_unique.device)

    def finish(self):
        """Combine everything and flush it into the table (once, unless
        the ledger overflowed)."""
        self._cycle()
        if self.ledger_fill == 0 and self._pending_cycle is not None:
            # one cycle: its distinct lanes are the consume's
            ck, cw, cf, n_valid = self._pending_cycle
            self._pending_cycle = None
            n = int(n_valid.item())
            if n:
                self._flush_distinct(ck, cw, cf, n)
        else:
            self._resolve_cycle()
            mk, mw, mf, n = self._combined_ledger()
            if n:
                self._flush_distinct(mk, mw, mf, n)
        with stage("bigcount-fetch"):
            for cand in self._bc_pending:
                self.storage.bigcount_candidates.update(
                    int(x) for x in _u64.to_numpy(cand))
        self._bc_pending = []

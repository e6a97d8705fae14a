"""The sharded consume, count query and table merge over a Mesh.

Port of khmer_tpu/parallel/sharded.py.  Its design carries over; its
shard_map plumbing does not (parallel/comm.py holds the mesh and the
collectives):

  * the mesh is a [data, shard] grid of shards; every shard holds one
    full-geometry partial table (int32 bit patterns of u32 bins);
  * streaming needs no communication: each shard hashes its own chunks
    (K1, or K8 / K11 for murmur and cyclic tables) into a local lane
    buffer of (key, weight, first position); duplicate keys are combined
    by K16 when the buffer fills, the survivors kept;
  * at finish() the locally distinct lanes are routed to their hash-band
    owners, shard s owning [s * W, (s + 1) * W) of fmix64(hash), W =
    (2**64 - 1) // NS, the top sliver in the last shard (reference
    banding, src/oxli/kmer_hash.cc:290-304, over a mixed image of the
    hash): K15 packs each window of lanes into fixed [NS, cap] send
    buffers, an all_to_all moves them, and lanes past a destination's
    room stay behind and go again in drain rounds until none is left, so
    no lane is dropped.  Each owner combines what it received (K16) and
    adds every globally distinct key to its partial table once
    (bin_scatter_add);
  * the serial table is the sum of the partial tables: a bin's serial
    value is min(cap, total increments), and min(cap, sum_d min(cap,
    x_d)) == min(cap, sum_d x_d);
  * n_unique is exact (the reference's sequential claim rule): every lane
    carries its position in the consume's k-mer stream, chunks numbered
    in file order across the mesh ((batch * NS + rank) * span + window
    start, span khmer_tpu's lanes a chunk, so the positions are its
    own).  A key is new iff for some table its pre-consume bin is zero
    and it is the bin's first claimant over the whole mesh: K17 scatters
    the least first position of each bin into a claim array, the mesh
    all-reduces it with min, and K17 counts the owners' keys that hold a
    claim;
  * a count query sums each table's bin values over the mesh (K3t and an
    all-reduce) before the cap and the min over tables.

Results equal khmer_tpu's on the same mesh shape and input bit for bit
(delta table, n_unique, n_consumed, bigcount candidates, query counts);
only the order in which K16 leaves distinct keys differs, and nothing
depends on it.
"""

import numpy as np
import torch

from khmer_tpu_torch import _u64, kernels
from khmer_tpu_torch._config import resolve_device
from khmer_tpu_torch.hashtable import ROW_PAYLOAD, chunk_lanes
from khmer_tpu_torch.kernels import plain
from khmer_tpu_torch.ops import deferred as dfr
from khmer_tpu_torch.ops.deferred import stage
from khmer_tpu_torch.parallel.comm import Mesh

# the kind's read cap without bigcount (the query's default)
_READ_CAP = {"byte": 255, "nibble": 15, "bit": 1}

# comm/compute accounting of the most recent finish() in this process
LAST_CONSUME_STATS = {}


def default_devices(device=None):
    """The shards' devices of a mesh for tables on `device` (None: CUDA,
    which raises without a card): every CUDA device of the machine, or
    the one CPU device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(devices=None, data=None, shard=None, group=None, device=None):
    """A [data, shard] Mesh over `devices` (default_devices(device) when
    None), all on the shard axis unless data or shard is given; with a
    torch.distributed group, `devices` are this process's shards and the
    grid covers every process's."""
    if devices is None:
        devices = default_devices(device)
    n = len(devices)
    if group is not None:
        import torch.distributed as dist

        n *= dist.get_world_size(group)
    if data is None and shard is None:
        data, shard = 1, n
    elif data is None:
        data = n // shard
    elif shard is None:
        shard = n // data
    return Mesh(devices, data, shard, group)


def band_owner(hashes, n_shards):
    """Owner shard of each hash (int64 bit-pattern tensor or uint64
    numpy): min(fmix64(h) // ((2**64 - 1) // n_shards), n_shards - 1),
    int64.  The rule K15 applies when it routes."""
    if not isinstance(hashes, torch.Tensor):
        hashes = _u64.as_tensor(hashes, "cpu")
    return plain.band_owner(hashes, int(n_shards))


def _bins(hashes, sizes, offsets):
    """[T, n] global bin indices of int64 hashes."""
    return _u64.umod(hashes[None, :], sizes[:, None]) + offsets[:, None]


def _geometries(spec, mesh):
    """The spec's (sizes, offsets, recips) on each local shard's device."""
    by_dev = {d: spec.geometry(d) for d in set(mesh.devices)}
    return [by_dev[d] for d in mesh.devices]


def make_sharded_query(spec, mesh, cap=None):
    """The count query over a mesh's partial tables: query(tables,
    hashes) -> uint16 counts [N] (on the mesh's first device) with the
    serial Count-Min read, each table's u32 bin values summed over every
    shard (K3t and an all-reduce) before the cap (cap, default the kind's
    read cap without bigcount) and the min over tables."""
    cap = _READ_CAP[spec.kind] if cap is None else int(cap)
    geoms = _geometries(spec, mesh)

    def query(tables, hashes):
        if not isinstance(hashes, torch.Tensor):
            hashes = _u64.as_tensor(np.asarray(hashes, np.uint64), "cpu")
        vals = [kernels.sketch_get_tables(t, hashes.to(d), *g)
                for t, d, g in zip(tables, mesh.devices, geoms)]
        tot = mesh.all_reduce(vals, "sum")[0]
        return _u64.u32(tot).clamp(max=cap).amin(0).to(torch.uint16)

    return query


def merge_tables_saturating(tables, spec=None):
    """The sum, mod 2**32, of partial tables (a sequence of int32 tensors
    of one shape, or one tensor whose last axis is the bins): the
    serial-equal flat table (saturation applies at read time)."""
    if isinstance(tables, torch.Tensor):
        tables = tables.reshape(-1, tables.shape[-1]).unbind(0)
    home = tables[0].device
    acc = tables[0].to(home).clone()
    for t in tables[1:]:
        acc += t.to(home)  # int32 adds wrap: the sum mod 2**32
    return acc


def make_partials_reduce(mesh):
    """reduce(tables) -> the serial-equal flat table, the sum of every
    shard's partial table over the mesh, on each process (on the mesh's
    first device)."""
    def reduce(tables):
        return mesh.all_reduce(tables, "sum")[0]

    return reduce


def _span(k, hash_kind, chunk):
    """khmer_tpu's lanes of a chunk (hashtable.py:_chunk_lane_count with
    the sharded consumer's payload, min(2**14, chunk)): the stride of the
    chunks' positions in the k-mer stream."""
    payload = min(ROW_PAYLOAD, chunk)
    rows = chunk // payload
    if hash_kind != "2bit":
        return rows * payload
    return 16 * rows * -(-(payload + k - 1) // 16)


class ShardedDeferredConsumer:
    """Transient multi-shard deferred counter for ONE bulk consume.

    Created with empty partial tables; chunks stream in, one per local
    shard a dispatch, with no communication; a shard's buffer is
    combined (K16) when it would pass `cap` lanes; finish() routes,
    combines at the owners, counts n_unique against the pre-consume
    table and flushes each partial table once.  It returns (delta table,
    n_unique, n_consumed, bigcount candidates) for the consuming
    Storage to add.

    In a process group every process feeds its own shards, and every
    process must call dispatch the same number of times (pad with
    _dispatch(force=True)): the host's control flow (merges, windows,
    drain rounds) depends only on values reduced over the mesh, so every
    process runs the same collectives.

    spec: the SketchSpec; k, hash_kind ("2bit", "murmur", "cyclic");
    mesh (default make_mesh()); chunk: bases a chunk; cap: buffer lanes
    a shard before a combine; from_codes: the byte hashes' chunks are
    2-bit codes (else ASCII, cleaned as khmer_tpu's packer cleans them);
    use_bigcount: collect the bigcount candidates (byte tables)."""

    def __init__(self, spec, k, hash_kind, mesh=None, chunk=1 << 20,
                 cap=None, from_codes=False, use_bigcount=False):
        self.spec = spec
        self.mesh = mesh if mesh is not None else make_mesh()
        self.D = self.mesh.shape["data"]
        self.S = self.mesh.shape["shard"]
        self.NS = self.mesh.size
        if self.NS > kernels.MAX_SHARDS:
            raise ValueError("at most {} shards".format(kernels.MAX_SHARDS))
        self.chunk = int(chunk)
        self.k = int(k)
        self.hash_kind = hash_kind
        self.from_codes = from_codes
        self.span = _span(self.k, hash_kind, self.chunk)
        if self.span < self.chunk:
            raise ValueError("chunk must be at most 2**14 bases or a "
                             "multiple of 2**14")
        # the most lanes a chunk appends to a shard's buffer
        self.chunk_lanes = self.chunk
        dev0 = self.mesh.devices[0]
        if cap is None:
            cap = max(4 * self.chunk_lanes,
                      min(2 * dfr.MIN_MERGE, dfr.default_max_cap(dev0)))
        self.cap = dfr._next_pow2(max(int(cap), 2 * self.chunk_lanes))
        self.max_flush = min(dfr.flush_slice(dev0), self.cap)
        self._batch_rows = self.mesh.n_local
        self._geoms = _geometries(spec, self.mesh)
        self.tables = [torch.zeros(spec.total_bins + 1, dtype=torch.int32,
                                   device=d) for d in self.mesh.devices]
        self.uniq = [torch.zeros(1, dtype=torch.int64, device=d)
                     for d in self.mesh.devices]
        self.consumed = [torch.zeros(1, dtype=torch.int64, device=d)
                         for d in self.mesh.devices]
        # each local shard's lanes: pieces appended since the last
        # combine, after the survivors of that combine
        self._parts = [[] for _ in self.mesh.devices]
        self._held = 0      # a bound on any shard's lanes (mesh-wide)
        self._combined = True
        self.batch = 0      # dispatched chunk batches (global chunk order)
        self.bigcount_candidates = set()
        self._track_bigcount = bool(use_bigcount) and spec.kind == "byte"
        self._pending = []
        self.routed_bytes = self.route_rounds = self.drain_rounds = 0

    @property
    def n_dropped(self):
        """Routing drops cannot happen: lanes past a destination's room
        stay behind and drain until none is left."""
        return 0

    # -- streaming ---------------------------------------------------------

    def add_chunk(self, data, weights):
        """Queue one chunk (uint8 codes, or ASCII bytes for the byte
        hashes without from_codes, with the loader's window mask; numpy
        or tensors, at most `chunk` long); dispatches when every local
        shard has one."""
        data, weights = np.asarray(data, np.uint8), np.asarray(weights)
        if data.shape[0] > self.chunk:
            raise ValueError("chunk of {} bases, more than {}".format(
                data.shape[0], self.chunk))
        if self.hash_kind != "2bit" and not self.from_codes:
            data = _ASCII_TO_CODE[data]
        self._pending.append((torch.from_numpy(data),
                              torch.from_numpy(weights.astype(np.uint8))))
        if len(self._pending) == self._batch_rows:
            self._dispatch()

    def add_packed(self, packed):
        """Queue one chunk in the port's own form: a (codes uint8, mask
        uint8) pair of tensors, on any device."""
        self._pending.append(packed)
        if len(self._pending) == self._batch_rows:
            self._dispatch()

    def _dispatch(self, force=False):
        """Hash the pending chunks, one a local shard (empty ones for the
        shards without), and append their lanes.  In a process group
        every process calls this the same number of times."""
        if not self._pending and not force:
            return
        if self._held + self.chunk_lanes > self.cap:
            self._merge()
        pending, self._pending = self._pending, []
        for i, item in enumerate(pending):
            dev = self.mesh.devices[i]
            codes, mask = (t.to(dev) for t in item)
            with stage("shard-append", lanes=codes.numel()) as _s:
                h, w = chunk_lanes(codes, mask, self.k, self.hash_kind)
                live = w != 0
                base = (self.batch * self.NS + self.mesh.ranks[i]) * self.span
                pos = (base + torch.arange(h.numel(), device=dev)) & \
                    0xFFFFFFFF
                self._parts[i].append((torch.where(live, h, dfr.SENTINEL),
                                       live.to(torch.int32), plain.i32(pos)))
                self.consumed[i] += w.sum()
                if _s is not None:
                    _s.sync = self.consumed[i]
        self._held += self.chunk_lanes
        self._combined = False
        self.batch += 1

    def _merge(self):
        """Combine each local shard's lanes (K16); the survivors stay."""
        if self._combined:
            return
        counts = []
        for i, parts in enumerate(self._parts):
            k, w, f = (torch.cat(x) for x in zip(*parts)) if parts else \
                _dead(0, self.mesh.devices[i])
            with stage("shard-merge", lanes=k.numel()) as _s:
                k, w, f, nv = dfr.combine_lanes(k, w, f)
                if _s is not None:
                    _s.sync = nv
            n = int(nv.item())
            self._parts[i] = [(k[:n].clone(), w[:n].clone(), f[:n].clone())]
            counts.append(n)
        self._held = self.mesh.total(counts, "max")
        self._combined = True

    # -- finish ------------------------------------------------------------

    def _route(self, lanes):
        """One routing round: K15 on every local shard's lanes, the send
        buffers' all_to_all.  Returns (received lanes per local shard,
        leftover lanes per local shard, leftover counts)."""
        NS, cap_dest = self.NS, self._cap_dest
        with stage("shard-route", lanes=NS * cap_dest) as _s:
            routed = [kernels.band_route(k, w, f, NS, cap_dest)
                      for k, w, f in lanes]
            recv = [self.mesh.all_to_all([r[j] for r in routed])
                    for j in range(3)]
            if _s is not None:
                _s.sync = recv[0][0]
        got = [tuple(recv[j][i].reshape(-1) for j in range(3))
               for i in range(self.mesh.n_local)]
        return got, [r[3:6] for r in routed], [r[6] for r in routed]

    def finish(self, base_table=None, virgin=None):
        """Drain everything: the last combine, the routed collect of
        every window of lanes (with drain rounds), one owner-side
        combine, the claims and one flush per partial table, then the
        reduce.  Returns (delta table, int32 [bins + 1] on the mesh's
        first device; n_unique; n_consumed; bigcount candidates).

        base_table is the consuming Storage's pre-consume table (int32
        [bins + 1]); virgin=True (or base_table=None) says it is all
        zero, and the claims then skip it."""
        self._dispatch()
        self._merge()
        if virgin is None:
            virgin = base_table is None
        mesh, NS = self.mesh, self.NS
        n = self._held
        reduce = make_partials_reduce(mesh)
        if n == 0:
            return (reduce(self.tables), 0,
                    mesh.total(self.consumed, "sum"),
                    self.bigcount_candidates)
        # -- routed collect: windows + drain rounds -------------------------
        F = min(max(dfr._next_pow2(n), dfr.MIN_BUCKET), self.max_flush)
        # per-destination room: owners are uniform over the mixed hash, so
        # a 15% margin over the mean rarely overflows (the drain rounds
        # keep it exact when it does)
        mean = -(-F // NS)
        self._cap_dest = max(64, (mean + mean // 7 + 7) & ~7)
        block = NS * self._cap_dest
        ledger = [[] for _ in mesh.devices]
        self.routed_bytes = self.route_rounds = self.drain_rounds = 0
        survivors = [p[0] for p in self._parts]
        self._parts = [[] for _ in mesh.devices]
        for off in range(0, n, F):
            lanes = [tuple(x[off:off + F] for x in s) for s in survivors]
            first = True
            while True:
                got, lanes, n_left = self._route(lanes)
                for i, g in enumerate(got):
                    ledger[i].append(g)
                self.routed_bytes += block * 16
                self.route_rounds += 1
                self.drain_rounds += not first
                first = False
                most = mesh.total([int(x.item()) for x in n_left], "max")
                if most == 0:
                    break
                lanes = [tuple(x[:most] for x in left) for left in lanes]
        del survivors, lanes
        # -- owner-side exact combine ---------------------------------------
        owned, counts = [], []
        for i, parts in enumerate(ledger):
            k, w, f = (torch.cat(x) for x in zip(*parts))
            with stage("shard-owner-combine", lanes=k.numel()) as _s:
                k, w, f, nv = dfr.combine_lanes(k, w, f)
                if _s is not None:
                    _s.sync = nv
            m = int(nv.item())
            owned.append((k[:m], w[:m], f[:m]))
            counts.append(m)
        del ledger
        n_max = mesh.total(counts, "max")
        # -- exact n_unique claims over the owner-distinct keys -------------
        bases = [None] * mesh.n_local if virgin else \
            mesh.replicate(base_table)
        with stage("shard-claims", lanes=sum(counts)) as _s:
            claims = []
            for (k, w, f), g, d in zip(owned, self._geoms, mesh.devices):
                c = torch.full((self.spec.total_bins + 1,),
                               dfr.IDX_SENTINEL, dtype=torch.int32,
                               device=d)
                kernels.claim_scatter(k, w, f, *g, c)
                claims.append(c)
            claims = mesh.all_reduce(claims, "umin32")
            for (k, w, f), g, c, b, u in zip(owned, self._geoms, claims,
                                             bases, self.uniq):
                kernels.claim_count(k, w, f, *g, c, b, u)
            if _s is not None:
                _s.sync = self.uniq[0]
        del claims
        # -- one flush per partial table ------------------------------------
        cands = []
        T = self.spec.n_tables
        with stage("shard-flush", lanes=sum(counts) * T) as _s:
            for (k, w, _), g, table, b in zip(owned, self._geoms,
                                              self.tables, bases):
                live = w != 0
                k, w = k[live], w[live]
                idx = _bins(k, g[0], g[1])
                kernels.bin_scatter_add(table, idx.reshape(-1), w.repeat(T))
                if self._track_bigcount:
                    pre0 = 0 if virgin else _u64.u32(b[idx[0]])
                    cross = ((pre0 + _u64.u32(w)) & 0xFFFFFFFF) > 255
                    cands.append(k[cross])
            if _s is not None:
                _s.sync = self.tables[0]
        if self._track_bigcount:
            for arr in mesh.all_gather(cands):
                self.bigcount_candidates.update(
                    int(x) for x in arr.view(np.uint64))
        delta = reduce(self.tables)
        n_unique = mesh.total(self.uniq, "sum")
        n_consumed = mesh.total(self.consumed, "sum")
        LAST_CONSUME_STATS.clear()
        LAST_CONSUME_STATS.update(
            routed_bytes=self.routed_bytes,
            route_rounds=self.route_rounds,
            drain_rounds=self.drain_rounds,
            n_distinct_max=n_max,
            n_consumed=n_consumed,
            devices=NS,
        )
        return delta, n_unique, n_consumed, self.bigcount_candidates


def _dead(n, dev):
    return (torch.full((n,), dfr.SENTINEL, dtype=torch.int64, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.full((n,), dfr.IDX_SENTINEL, dtype=torch.int32,
                       device=dev))


# ASCII -> 2-bit code (A=0 T=1 C=2 G=3, anything else 0): khmer_tpu's
# packer translates ASCII chunks so (hashtable.py:_ASCII_TO_CODE), and the
# byte hashes read the codes back as uppercase ACGT
_ASCII_TO_CODE = np.zeros(256, np.uint8)
for _b, _c in ((65, 0), (84, 1), (67, 2), (71, 3)):
    _ASCII_TO_CODE[_b] = _c

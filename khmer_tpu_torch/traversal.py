"""de Bruijn graph traversal: neighbours, level searches and count probes.

Port of khmer_tpu/traversal.py (reference src/oxli/traversal.cc,
hashgraph.cc:756 calc_connected_graph_size, :1151 traverse_from_kmer,
:1085 trim_on_stoptags, :1471 extract_unique_paths): a frontier of
(kmer_f, kmer_r) pairs, int64 bit patterns on the graph's device, is
expanded 8 ways with 2-bit shift arithmetic, and which candidates exist
is read with one count probe of the whole batch (Storage.get_lanes,
kernel K3 on the card).  khmer_tpu does the arithmetic in host numpy,
pads each probe to a width bucket to bound XLA recompiles and keeps each
search's visited set in a Python set; here a level of a whole batch of
searches stays on the device (_keeper_pairs) and every width runs as it
is.
"""

import numpy as np
import torch

from khmer_tpu_torch import _u64
from khmer_tpu_torch.ops import encode as enc
from khmer_tpu_torch.ops.hashing import hash_2bit_scalar, reverse_hash

_MASK64 = (1 << 64) - 1
MAX_KEEPER_SIZE = int(1e6)  # reference hashgraph.hh:69


def _consts(k):
    bitmask = (1 << (2 * k)) - 1
    rc_shift = 2 * k - 2
    return bitmask, rc_shift


def fr_from_hash(h, k):
    """(kmer_f, kmer_r) of a canonical hash, following the reference's
    decode-then-rehash (hashgraph.cc:1155-1158): the canonical value is
    decoded as the forward strand."""
    f = int(h)
    r = 0
    x = f
    for _ in range(k):
        r = ((r << 2) | ((x & 3) ^ 1)) & _MASK64
        x >>= 2
    return f, r


def fr_from_hashes(hashes, k):
    """fr_from_hash of every uint64 hash of a numpy array: (f, r)
    uint64 arrays."""
    f = np.asarray(hashes, np.uint64)
    r = np.zeros_like(f)
    x = f.copy()
    for _ in range(k):
        r = (r << np.uint64(2)) | ((x & np.uint64(3)) ^ np.uint64(1))
        x >>= np.uint64(2)
    return f, r


def fr_from_hash_codes(codes):
    """(f, r) from a k-length slice of 2-bit codes."""
    f = 0
    r = 0
    k = len(codes)
    for i in range(k):
        f = (f << 2) | int(codes[i])
        r = (r << 2) | (int(codes[k - 1 - i]) ^ 1)
    return np.uint64(f & _MASK64), np.uint64(r & _MASK64)


def _window_fr(codes, k):
    """fr_from_hash_codes of every k-window of a 2-bit code array, as
    uint64 arrays."""
    n = codes.shape[0] - k + 1
    c = codes.astype(np.uint64)
    f = np.zeros(n, np.uint64)
    r = np.zeros(n, np.uint64)
    for j in range(k):
        f = (f << np.uint64(2)) | c[j: j + n]
        r = (r << np.uint64(2)) | (c[k - 1 - j: k - 1 - j + n] ^
                                   np.uint64(1))
    return f, r


# neighbour arithmetic (reference traversal.cc:88-113) on int64 bit
# patterns of uint64; codes are khmer 2-bit (A=0 T=1 C=2 G=3),
# complement = code ^ 1
def right_neighbors_fr(f, r, k):
    """[N] -> ([N,4] f, [N,4] r) appending each base on the right."""
    bitmask, rc_shift = _consts(k)
    codes = torch.arange(4, dtype=torch.int64, device=f.device)
    nf = ((f[:, None] << 2) & _u64.i64(bitmask)) | codes[None, :]
    nr = _u64.lsr(r[:, None], 2) | ((codes[None, :] ^ 1) << rc_shift)
    return nf, nr


def left_neighbors_fr(f, r, k):
    """[N] -> ([N,4] f, [N,4] r) prepending each base on the left."""
    bitmask, rc_shift = _consts(k)
    codes = torch.arange(4, dtype=torch.int64, device=f.device)
    nf = _u64.lsr(f[:, None], 2) | (codes[None, :] << rc_shift)
    nr = ((r[:, None] << 2) & _u64.i64(bitmask)) | (codes[None, :] ^ 1)
    return nf, nr


def neighbors_fr(f, r, k, direction="both"):
    """Every neighbour of frontier nodes: (nf, nr), [N, 4] (one
    direction) or [N, 8] (right, then left)."""
    parts = []
    if direction in ("both", "right"):
        parts.append(right_neighbors_fr(f, r, k))
    if direction in ("both", "left"):
        parts.append(left_neighbors_fr(f, r, k))
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))


def counts_of(graph, hashes):
    """Counts of a batch of uint64 hashes (numpy), capped at the table's
    read cap and without a loaded bigcount overlay (khmer_tpu's
    storage.get_batch_device): one K3 call on the card."""
    hashes = np.asarray(hashes, np.uint64).reshape(-1)
    if hashes.size == 0:
        return np.zeros(0, np.uint16)
    st = graph.storage
    return st.get_lanes(_u64.as_tensor(hashes, st.device)).cpu().numpy()


def _probe(graph, f, r, k, direction="both"):
    """Every neighbour of frontier nodes (int64 tensors f, r on the
    graph's device) and whether it exists, in one K3 call: (nf, nr,
    canon, exists), each [N, 4] (one direction) or [N, 8] (right, then
    left)."""
    nf, nr = neighbors_fr(f, r, k, direction)
    canon = _u64.umin(nf, nr)
    exists = graph.storage.get_lanes(canon.reshape(-1)).reshape(
        canon.shape).to(torch.int32) > 0
    return nf, nr, canon, exists


def _flatten(nf, nr, canon, exists):
    """The existing neighbours of a _probe, row by row: (nf, nr, ncanon,
    src_idx), src_idx mapping each to its frontier row."""
    src = torch.arange(nf.shape[0], device=nf.device)[:, None].expand(
        canon.shape)
    return nf[exists], nr[exists], canon[exists], src[exists]


def _expand(graph, f, r, k, direction="both"):
    """All existing neighbours of frontier nodes, probed in one K3 call.

    Returns (nf, nr, ncanon, src_idx) flattened over existing
    candidates; src_idx maps each neighbour to its frontier row."""
    return _flatten(*_probe(graph, f, r, k, direction))


class _Frontier:
    """Deduplicated BFS frontier of (f, r) pairs keyed by canonical."""

    __slots__ = ("f", "r", "canon")

    def __init__(self, f, r):
        self.f = f
        self.r = r
        self.canon = _u64.umin(f, r)


def _seed(graph, kmer):
    """(kmer_f, kmer_r) of a Kmer, a k-mer string or a canonical hash."""
    k = graph.ksize()
    if hasattr(kmer, "kmer_f"):  # a Kmer object carries its own f/r
        return int(kmer.kmer_f), int(kmer.kmer_r)
    if isinstance(kmer, str):
        _, f, r = hash_2bit_scalar(kmer, k)
        return f, r
    return fr_from_hash(int(kmer), k)


def _fr_tensors(device, pairs):
    """int64 (f, r) tensors on device of a list of (f, r) integers."""
    f = np.array([p[0] for p in pairs], np.uint64)
    r = np.array([p[1] for p in pairs], np.uint64)
    return _u64.as_tensor(f, device), _u64.as_tensor(r, device)


# ---------------------------------------------------------------------------
# membership and first occurrences on the device
# ---------------------------------------------------------------------------


def _member(sorted_keys, vals):
    """Which int64 hash patterns `vals` are among the hashes whose
    ascending sort keys (_u64.sort_key) are `sorted_keys` (None: none)."""
    if sorted_keys is None or not sorted_keys.numel():
        return torch.zeros(vals.numel(), dtype=torch.bool,
                           device=vals.device)
    key = _u64.sort_key(vals)
    pos = torch.searchsorted(sorted_keys, key).clamp(
        max=sorted_keys.numel() - 1)
    return sorted_keys[pos] == key


def _keys_of(values, device):
    """Ascending sort keys on `device` of a collection of uint64 ints."""
    arr = np.fromiter((int(v) for v in values), np.uint64, len(values))
    return torch.sort(_u64.sort_key(_u64.as_tensor(arr, device))).values


def stop_keys(graph):
    """graph.stop_tags as ascending sort keys on its device (None when
    there are none)."""
    if not graph.stop_tags:
        return None
    return _keys_of(graph.stop_tags, graph.device)


def _pair_runs(sids, canons):
    """A stable order of the (sid, canon) pairs by sid, then canon
    (unsigned), and a bool per position of it: the first of its pair."""
    order = torch.argsort(_u64.sort_key(canons), stable=True)
    order = order[torch.argsort(sids[order], stable=True)]
    s_o, c_o = sids[order], canons[order]
    first = torch.ones(order.numel(), dtype=torch.bool, device=sids.device)
    first[1:] = (s_o[1:] != s_o[:-1]) | (c_o[1:] != c_o[:-1])
    return order, first


def _first_new(old_s, old_c, sids, canons):
    """Indices, ascending, of the candidate pairs (sids, canons) that are
    the first of their pair among the candidates and not among the old
    pairs."""
    n_old = old_s.numel()
    order, first = _pair_runs(torch.cat([old_s, sids]),
                              torch.cat([old_c, canons]))
    return torch.sort(order[first & (order >= n_old)]).values - n_old


def _run_rank(sid, flags):
    """For lanes grouped by ascending sid, the number of flagged lanes of
    the same sid up to and including each lane."""
    cs = torch.cumsum(flags.to(torch.int64), 0)
    start = torch.searchsorted(sid, sid)
    return cs - cs[start] + flags[start].to(torch.int64)


# ---------------------------------------------------------------------------
# traverse_from_kmer, for one seed or a batch
# ---------------------------------------------------------------------------


def _keeper_pairs(graph, f, r, radius, max_count=MAX_KEEPER_SIZE,
                  stops=None):
    """traverse_from_kmer from every seed of a batch at once, on the
    graph's device: seeds (f, r) int64 [n], the stop tags as sort keys
    (stop_keys).  Returns (sid, canon), int64 tensors of every k-mer a
    seed's keeper takes, in the order it takes them: level by level, and
    within a level in the seed's frontier order.

    Each level is one count probe of the candidates of every seed.  As
    in khmer_tpu, a seed's frontier lane that is not a stop tag joins its
    keeper (the frontier holds no k-mer of the keeper), its keeper stops
    at max_count + 1 k-mers, and the next frontier is the first
    occurrence of each candidate neighbour outside the keeper.  A
    candidate can only be in the keeper if it joined at this level or the
    one before: every keeper k-mer of an older level was expanded, so a
    neighbour of it joined by the level after.  So the level's candidates
    are tested against those two levels alone, which is exact."""
    dev = f.device
    k = graph.ksize()
    n = f.numel()
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if radius < 0 or not n:
        return empty, empty
    out_s, out_c = [], []
    sid = torch.arange(n, device=dev)
    total = torch.zeros(n, dtype=torch.int64, device=dev)
    prev_s = prev_c = empty
    breadth = 0
    while f.numel():
        canon = _u64.umin(f, r)
        fresh = ~_member(stops, canon)
        # a keeper takes lanes until it holds max_count + 1 k-mers
        fresh &= total[sid] + _run_rank(sid, fresh) <= max_count + 1
        lanes = torch.nonzero(fresh).squeeze(1)
        s, c = sid[lanes], canon[lanes]
        if not s.numel():
            break
        out_s.append(s)
        out_c.append(c)
        if breadth == radius:
            break
        total += torch.bincount(s, minlength=n)
        grow = lanes[total[s] <= max_count]
        if not grow.numel():
            break
        nf, nr, ncanon, src = _expand(graph, f[grow], r[grow], k)
        nsid = sid[grow][src]
        pick = _first_new(torch.cat([prev_s, s]), torch.cat([prev_c, c]),
                          nsid, ncanon)
        f, r, sid = nf[pick], nr[pick], nsid[pick]
        prev_s, prev_c = s, c
        breadth += 1
    if not out_s:
        return empty, empty
    return torch.cat(out_s), torch.cat(out_c)


def keeper_arrays(graph, seeds, radius, max_count=MAX_KEEPER_SIZE,
                  stops=None):
    """_keeper_pairs of seeds given as (f, r) integer pairs, on the host:
    (keepers, ends), every seed's keeper (uint64) in the order it took
    its k-mers, seed i's at keepers[ends[i - 1]:ends[i]]."""
    f, r = _fr_tensors(graph.device, seeds)
    s, c = _keeper_pairs(graph, f, r, radius, max_count, stops)
    s = s.cpu().numpy()
    c = _u64.to_numpy(c)
    order = np.argsort(s, kind="stable")
    return c[order], np.cumsum(np.bincount(s, minlength=len(seeds)))


def traverse_from_kmer(graph, kmer, radius, max_count=None):
    """Level-BFS within `radius`; returns the set of canonical hashes
    reached (reference traverse_from_kmer, hashgraph.cc:1151-1244:
    stop at stop_tags, cap total at MAX_KEEPER_SIZE=1e6)."""
    if max_count is None:
        max_count = MAX_KEEPER_SIZE
    keepers, _ = keeper_arrays(graph, [_seed(graph, kmer)], radius,
                               max_count, stop_keys(graph))
    return set(keepers.tolist())


def count_kmers_within_radius(graph, kmer, radius, max_count=0):
    return len(traverse_from_kmer(graph, kmer, radius,
                                  max_count=max_count or None))


# ---------------------------------------------------------------------------
# Traverser (parity: khmer/_oxli/traversal.pyx)
# ---------------------------------------------------------------------------


class Traverser:
    def __init__(self, graph):
        self.graph = graph

    def ksize(self):
        return self.graph.ksize()

    def _neighbor_strings(self, node, direction):
        k = self.graph.ksize()
        f, r = _fr_tensors(self.graph.device, [_seed(self.graph, node)])
        _, _, canon, _ = _expand(self.graph, f, r, k, direction=direction)
        return [reverse_hash(c, k) for c in _u64.to_numpy(canon).tolist()]

    def neighbors(self, node):
        return self._neighbor_strings(node, "both")

    def right_neighbors(self, node):
        return self._neighbor_strings(node, "right")

    def left_neighbors(self, node):
        return self._neighbor_strings(node, "left")

    def degree(self, node):
        return kmer_degree(self.graph, node)

    def right_degree(self, node):
        return len(self._neighbor_strings(node, "right"))

    def left_degree(self, node):
        return len(self._neighbor_strings(node, "left"))


# ---------------------------------------------------------------------------
# Hashgraph graph queries
# ---------------------------------------------------------------------------


def kmer_degree(graph, kmer):
    """Number of existing neighbors (reference hashgraph.cc:840-897)."""
    return kmer_degree_fr(graph, *_seed(graph, kmer), graph.ksize())


def kmer_degree_fr(graph, f, r, k):
    f, r = _fr_tensors(graph.device, [(f, r)])
    return int(_probe(graph, f, r, k)[3].sum())


def neighbors(graph, kmer):
    """Existing neighbors as Kmer objects, one per found direction
    (duplicates preserved -- graphs.pyx:553-557 returns the Traverser's
    per-direction finds)."""
    from khmer_tpu_torch.kmer import Kmer

    if isinstance(kmer, bytes):
        kmer = kmer.decode("ascii")
    if not isinstance(kmer, (str, int, np.integer)):
        raise TypeError("kmer must be a string or hash")
    k = graph.ksize()
    if isinstance(kmer, str) and len(kmer) != k:
        raise ValueError("k-mer length must equal the graph k size")
    f, r = _fr_tensors(graph.device, [_seed(graph, kmer)])
    _, _, canon, _ = _expand(graph, f, r, k)
    return [Kmer.create(c, k) for c in _u64.to_numpy(canon).tolist()]


def calc_connected_graph_size(graph, kmer, max_size=0,
                              break_on_circumference=False):
    """Size of the connected component containing kmer, truncated at
    max_size (reference calc_connected_graph_size, hashgraph.cc:756).

    Level by level on the graph's device, one probe a level: the probe
    that gives a level's degrees (break_on_circumference: a k-mer with
    more than 4 neighbours joins the visited set but is neither counted
    nor expanded) also gives its neighbours.  The visited set is tested
    as in _keeper_pairs (the last two levels), plus the k-mers that were
    visited and never expanded."""
    k = graph.ksize()
    f0, r0 = _seed(graph, kmer)
    if counts_of(graph, [min(f0, r0)])[0] == 0:
        return 0
    dev = graph.device
    stops = stop_keys(graph)
    f, r = _fr_tensors(dev, [(f0, r0)])
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    prev = unexpanded = empty
    count = 0
    while f.numel():
        canon = _u64.umin(f, r)
        fresh = ~_member(stops, canon)
        f, r, canon = f[fresh], r[fresh], canon[fresh]
        if not canon.numel():
            break
        nf, nr, ncanon, exists = _probe(graph, f, r, k)
        grow = torch.ones(canon.numel(), dtype=torch.bool, device=dev)
        if break_on_circumference:
            grow = exists.sum(1) <= 4
            unexpanded = torch.cat([unexpanded, canon[~grow]])
        n_grow = int(grow.sum())
        count += n_grow
        if max_size and count >= max_size:
            return max_size
        if not n_grow:
            break
        nf, nr, ncanon, _ = _flatten(nf[grow], nr[grow], ncanon[grow],
                                     exists[grow])
        if not ncanon.numel():
            break
        old = torch.cat([prev, canon, unexpanded])
        pick = _first_new(torch.zeros_like(old), old,
                          torch.zeros_like(ncanon), ncanon)
        f, r = nf[pick], nr[pick]
        prev = canon
    return count


def find_high_degree_nodes(graph, sequence):
    """Canonical hashes of sequence k-mers with degree > 2 (semantics
    per hashgraph.hh:398 and its pyx caller); the degrees of every k-mer
    of the sequence in one probe."""
    from khmer_tpu_torch.hashset import HashSet

    k = graph.ksize()
    hdns = HashSet(k)
    hashes = graph._hash_array(sequence)
    if hashes.size == 0:
        return hdns
    f, r = _window_fr(enc.encode_sequence(sequence), k)
    dev = graph.device
    exists = _probe(graph, _u64.as_tensor(f, dev), _u64.as_tensor(r, dev),
                    k)[3]
    degs = exists.sum(1).cpu().numpy()
    for h, d in zip(hashes.tolist(), degs.tolist()):
        if d > 2:
            hdns.add(h)
    return hdns


def traverse_linear_path(graph, kmer, adjacencies, visited, stop_filter,
                         hdns=None):
    """Walk the linear path containing kmer, stopping at high-degree
    nodes (collected into `adjacencies` AND marked in the
    `stop_filter` Bloom filter) and at k-mers already in the filter.
    Visited k-mers are per-call output only -- they are NOT added to
    the filter, so the same path can be traversed again from its other
    end.  Returns the path size.  (Reconstructed from
    hashgraph.hh:401-404 / graphs.pyx:608-623.)"""
    k = graph.ksize()
    if hdns is None:
        hdns = getattr(adjacencies, "hashes", set())
    else:
        hdns = set(int(h) for h in hdns)
    f, r = _seed(graph, kmer)
    size = 0
    queue = [(f, r)]
    local_seen = set()
    while queue:
        f, r = queue.pop()
        c = min(f, r)
        if c in hdns:
            adjacencies.add(c)
            if stop_filter is not None:
                stop_filter.add(c)
            continue
        if c in local_seen or c in visited:
            continue
        if stop_filter is not None and stop_filter.get(c):
            continue
        local_seen.add(c)
        visited.add(c)
        size += 1
        ft, rt = _fr_tensors(graph.device, [(f, r)])
        nf, nr, _, _ = _expand(graph, ft, rt, k)
        queue.extend(zip(_u64.to_numpy(nf).tolist(),
                         _u64.to_numpy(nr).tolist()))
    return size


def trim_on_stoptags(graph, sequence):
    """Trim the sequence at the first stop-tagged k-mer
    (reference hashgraph.cc... trim_on_stoptags, 2.x hashtable.cc:1085)."""
    k = graph.ksize()
    if len(sequence) < k:
        return sequence[:0], 0
    stop = graph.stop_tags
    i = k - 2
    for h in graph._hash_array(sequence).tolist():
        if h in stop:
            return sequence[:i], i
        i += 1
    return sequence, len(sequence)


def extract_unique_paths(graph, seq, min_length, min_unique_f):
    """Extract maximal windows whose fraction of already-seen k-mers is
    <= 1 - min_unique_f (reference hashgraph.cc:1471-1565, ported
    branch-for-branch including the end-adjustment quirks)."""
    results = []
    if len(seq) < min_length:
        return results
    max_seen = 1.0 - min_unique_f
    k = graph.ksize()
    min_length = min_length - k + 1
    seen = (counts_of(graph, graph._hash_array(seq)) > 0).tolist()
    n_kmers = len(seen)

    i = 0
    while i < n_kmers - min_length:
        seen_counter = sum(seen[i: i + min_length])
        if seen_counter / float(min_length) <= max_seen:
            start = i
            while (start + min_length) < n_kmers:
                if seen[start]:
                    seen_counter -= 1
                if seen[start + min_length]:
                    seen_counter += 1
                start += 1
                if seen_counter / float(min_length) > max_seen:
                    break
            if start + min_length == n_kmers:
                if seen_counter / float(min_length) > max_seen:
                    start -= 1
                start -= 1
            else:
                start -= 2
            results.append(seq[i: start + min_length + k])
            i = start + min_length + 1
        else:
            i += 1
    return results

"""Tag-graph partitioning: SubsetPartition (reference src/oxli/subset.cc).

Port of khmer_tpu/partitioning.py.  Partitions are connected components
of the sparse tag graph: two tags connect when a breadth-limited search
(max breadth 2 * tag_density + 1, subset.cc:349) in k-mer space reaches
one from the other.  Every search level of a batch of seed tags is one
count probe of all its candidate neighbours (traversal._expand through
Storage.get_lanes, kernel K3 on the card); the host keeps the union of
partition ids.  do_partition_device takes the same searches' star edges
to kernel K10 (partition_device.connected_components) instead.

repartition_largest_partition, which finds the knots' stop tags, is
sequential in khmer_tpu: each tag's traversal respects the stop tags the
tags before it added, and each keeper's count walk reads and adds to a
counting table k-mer by k-mer.  _KnotWalk keeps that order exactly with a
batch of traversals and one read of the counting table a batch (see its
docstring).

Parity notes (as khmer_tpu):
  * partition ids start at 2 (subset.cc:85) and the first partition id
    found among the tagged set wins a merge (subset.cc:798-845);
  * with stop_big_traversals a seed's search is dropped once it has
    visited more than BIG_TRAVERSALS_ARE = 200 k-mers, checked at the
    start of each level (khmer_tpu's documented level granularity);
  * pmap files are byte-compatible (subset.cc:1158-1229): a record of
    (uint64 tag, uint32 partition id) for every assigned tag, with the
    header count covering the map's null entries.
"""

import struct

import numpy as np
import torch

from khmer_tpu_torch import _u64
from khmer_tpu_torch.io.oxli_format import (OxliFileError,
                                            SAVED_FORMAT_VERSION,
                                            SAVED_SIGNATURE, SAVED_SUBSET)
from khmer_tpu_torch.traversal import (MAX_KEEPER_SIZE, _expand,
                                       _first_new, _keys_of, _member,
                                       _pair_runs, _run_rank,
                                       fr_from_hash, fr_from_hashes,
                                       keeper_arrays, neighbors_fr,
                                       stop_keys)

BIG_TRAVERSALS_ARE = 200  # reference subset.cc:54
SEED_BATCH = 1 << 17  # seed tags searched together (any batch: the same)
ANNOTATE_BATCH = 16384  # reads hashed together by output_partitioned_file
KNOT_BATCH = 1024  # tags traversed together by repartition_largest_partition


class PrePartitionInfo:
    """Result of find_all_tags for one seed (legacy_partitioning.pyx:8)."""

    __slots__ = ("kmer", "tagged_kmers")

    def __init__(self, kmer, tagged_kmers):
        self.kmer = kmer
        self.tagged_kmers = tagged_kmers


def _sorted_u64(values):
    arr = np.fromiter((int(t) for t in values), np.uint64, len(values))
    arr.sort()
    return arr


class SubsetPartition:
    def __init__(self, graph):
        self.graph = graph
        self.partition_map = {}  # tag hash -> partition id (or None)
        self.next_partition_id = 2  # reference subset.cc:85
        self._rev = {}  # pid -> set of tags
        self._tags_cache = self._stops_cache = self._tag_keys_cache = None
        # do_partition_device's last run: tags, edges, cc_rounds calls
        self.device_stats = {}

    # -- the bounded searches ----------------------------------------------

    def find_all_tags(self, start_kmer, break_on_stop_tags=False,
                      stop_big_traversals=False):
        """Tags reachable from one seed (subset.cc:335-427)."""
        return self.find_all_tags_batch([start_kmer], break_on_stop_tags,
                                        stop_big_traversals)[0]

    def find_all_tags_batch(self, seeds, break_on_stop_tags=False,
                            stop_big_traversals=False, min_count=None,
                            max_count=None):
        """Per-seed PrePartitionInfo (the set of tags reached) for a batch
        of seed hashes.  With min_count/max_count, the searches stop at
        k-mers whose abundance is outside the range
        (find_all_tags_truncate_on_abundance, subset.cc:521-619)."""
        sid, canon = self._tags_reached(seeds, break_on_stop_tags,
                                        stop_big_traversals, min_count,
                                        max_count)
        out_sets = [set() for _ in seeds]
        for s, c in zip(sid.tolist(), _u64.to_numpy(canon).tolist()):
            out_sets[s].add(c)
        return [PrePartitionInfo(int(s), t) for s, t in zip(seeds, out_sets)]

    def _tags_reached(self, seeds, break_on_stop_tags=False,
                      stop_big_traversals=False, min_count=None,
                      max_count=None):
        """The bounded searches of khmer_tpu's find_all_tags_batch from
        every seed of a batch at once, on the graph's device: (seed
        index, tag) pairs as int64 tensors (the tag a uint64 bit
        pattern), one pair for each tag a seed's search reaches.

        Level by level, the frontier's candidate neighbours are probed in
        one count query; each candidate (seed, k-mer) pair that its seed
        has not visited is visited, a tag among them (from level 1 on) is
        recorded and not expanded, and the rest are expanded, until
        max_breadth levels.  A pair can only be met again if it was
        visited at one of the two levels before, or is a tag (which is
        never expanded): an expanded k-mer has every neighbour probed at
        the next level, so a neighbour of one visited two or more levels
        earlier was visited by then.  So each seed's visited set is kept
        as those two levels plus its tags, and is exact.  Which frontier
        lane stands for a pair does not matter: a k-mer and its reverse
        complement have the same canonical neighbours."""
        graph = self.graph
        dev = graph.device
        k = graph.ksize()
        max_breadth = 2 * graph.tag_density + 1
        n = len(seeds)
        tag_keys = self._tag_keys()
        stops = self._keys(self._sorted_stops_cache()) \
            if break_on_stop_tags else None
        by_count = min_count is not None or max_count is not None
        visited_total = torch.zeros(n, dtype=torch.int64, device=dev)
        aborted = torch.zeros(n, dtype=torch.bool, device=dev)
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        # the pairs visited at the last two levels, and every tag pair
        levels = [(empty, empty), (empty, empty)]
        tag_s, tag_c = [empty], [empty]
        cf, cr = (_u64.as_tensor(x, dev) for x in fr_from_hashes(
            np.asarray([int(h) for h in seeds], np.uint64), k))
        sid = torch.arange(n, dtype=torch.int64, device=dev)
        breadth = 0
        while cf.numel():
            if stop_big_traversals:
                aborted |= visited_total > BIG_TRAVERSALS_ARE
                live = ~aborted[sid]
                cf, cr, sid = cf[live], cr[live], sid[live]
                if not cf.numel():
                    break
            canon = _u64.umin(cf, cr)
            # stopped and out-of-range k-mers are not visited
            ok = ~_member(stops, canon)
            if by_count:
                counts = _counts(graph.storage, canon)
                ok &= counts >= (0 if min_count is None else min_count)
                ok &= counts <= (0xFFFF if max_count is None else max_count)
            lanes = torch.nonzero(ok).squeeze(1)
            if not lanes.numel():
                break
            # the candidates' distinct (seed, k-mer) pairs that are not
            # among the pairs of the last two levels: a stable sort puts
            # an old pair before its candidates
            n_old = levels[0][0].numel() + levels[1][0].numel()
            all_s = torch.cat([levels[0][0], levels[1][0], sid[lanes]])
            all_c = torch.cat([levels[0][1], levels[1][1], canon[lanes]])
            order, first = _pair_runs(all_s, all_c)
            pick = order[first & (order >= n_old)]
            u_sid, u_canon = all_s[pick], all_c[pick]
            rep = lanes[pick - n_old]
            tag_mask = _member(tag_keys, u_canon) if breadth > 0 else \
                torch.zeros(u_sid.numel(), dtype=torch.bool, device=dev)
            if breadth > 0:
                # a tag met at an older level is not fresh
                tags = torch.nonzero(tag_mask).squeeze(1)
                seen = _pairs_in(u_sid[tags], u_canon[tags],
                                 torch.cat(tag_s), torch.cat(tag_c))
                keep = torch.ones(u_sid.numel(), dtype=torch.bool,
                                  device=dev)
                keep[tags[seen]] = False
                u_sid, u_canon = u_sid[keep], u_canon[keep]
                rep, tag_mask = rep[keep], tag_mask[keep]
                tag_s.append(u_sid[tag_mask])
                tag_c.append(u_canon[tag_mask])
            if not u_sid.numel():
                break
            visited_total += torch.bincount(u_sid, minlength=n)
            levels = [levels[1], (u_sid, u_canon)]
            if breadth >= max_breadth:
                break
            rep = rep[~tag_mask]
            if not rep.numel():
                break
            idx = torch.sort(rep).values
            cf, cr, _, src = _expand(graph, cf[idx], cr[idx], k)
            sid = sid[idx][src]
            breadth += 1
        sid, canon = torch.cat(tag_s), torch.cat(tag_c)
        if stop_big_traversals:
            keep = ~aborted[sid]
            sid, canon = sid[keep], canon[keep]
        return sid, canon

    def _sorted_tags_cache(self):
        """graph.all_tags as a sorted uint64 array, rebuilt only when the
        tag set changes."""
        tags = self.graph.all_tags
        key = (id(tags), len(tags))
        if self._tags_cache is None or self._tags_cache[0] != key:
            self._tags_cache = (key, _sorted_u64(tags))
            self._tag_keys_cache = None
        return self._tags_cache[1]

    def _tag_keys(self):
        """The sorted tags as ascending sort keys on the graph's device."""
        tags = self._sorted_tags_cache()
        if self._tag_keys_cache is None:
            self._tag_keys_cache = self._keys(tags)
        return self._tag_keys_cache

    def _keys(self, sorted_u64):
        """Ascending sort keys (_u64.sort_key) of a sorted uint64 array, on
        the graph's device."""
        return _u64.sort_key(_u64.as_tensor(sorted_u64, self.graph.device))

    def _sorted_stops_cache(self):
        stops = self.graph.stop_tags
        key = (id(stops), len(stops))
        if self._stops_cache is None or self._stops_cache[0] != key:
            self._stops_cache = (key, _sorted_u64(stops))
        return self._stops_cache[1]

    # -- partition id bookkeeping ----------------------------------------

    def _new_pid(self):
        pid = self.next_partition_id
        self.next_partition_id += 1
        self._rev[pid] = set()
        return pid

    def _rewrite(self, winner, loser):
        """Merge partition `loser` into `winner`
        (subset.cc:_merge_two_partitions; the reference relabels the
        smaller pointer set -- ids are preserved per its choice)."""
        if winner == loser:
            return winner
        sw = self._rev.get(winner, set())
        sl = self._rev.get(loser, set())
        if len(sw) < len(sl):
            winner, loser = loser, winner
            sw, sl = sl, sw
        for tag in sl:
            self.partition_map[tag] = winner
        sw.update(sl)
        self._rev[winner] = sw
        self._rev.pop(loser, None)
        return winner

    def assign_partition_id(self, kmer, tagged_kmers=None):
        """Assign/merge partition for a seed tag and its tagged set
        (subset.cc:774-845)."""
        if isinstance(kmer, PrePartitionInfo):
            tagged_kmers = kmer.tagged_kmers
            kmer = kmer.kmer
        kmer = int(kmer)
        tagged_kmers = set(int(t) for t in (tagged_kmers or ()))
        if not tagged_kmers:
            self.partition_map.pop(kmer, None)
            return 0
        # first assigned id among the tagged set wins
        this_pid = None
        for t in sorted(tagged_kmers):
            pid = self.partition_map.get(t)
            if pid is not None:
                this_pid = pid
                break
        if this_pid is None:
            this_pid = self._new_pid()
        for t in tagged_kmers:
            pid = self.partition_map.get(t)
            if pid is None:
                self.partition_map[t] = this_pid
                self._rev[this_pid].add(t)
            elif pid != this_pid:
                this_pid = self._rewrite(this_pid, pid)
        self.partition_map[kmer] = this_pid
        self._rev[this_pid].add(kmer)
        return this_pid

    def set_partition_id(self, kmer, pid):
        kmer = int(kmer) if not isinstance(kmer, str) else \
            self.graph.hash(kmer)
        pid = int(pid)
        if pid not in self._rev:
            self._rev[pid] = set()
        old = self.partition_map.get(kmer)
        if old is not None and old in self._rev:
            self._rev[old].discard(kmer)
        self.partition_map[kmer] = pid
        self._rev[pid].add(kmer)
        if self.next_partition_id <= pid:
            self.next_partition_id = pid + 1

    def join_partitions(self, p1, p2):
        """(subset.cc:890-915)"""
        if p1 == p2:
            return p1
        if p1 == 0 or p2 == 0:
            return 0
        if p1 not in self._rev or p2 not in self._rev:
            return 0
        self._rewrite(p1, p2)
        return p1

    def get_partition_id(self, kmer):
        if isinstance(kmer, str):
            kmer = self.graph.hash(kmer)
        pid = self.partition_map.get(int(kmer))
        return 0 if pid is None else pid

    # -- driving ----------------------------------------------------------

    def _span(self, first_kmer, last_kmer):
        """The sorted tags in [first_kmer, last_kmer) (0: either end);
        a bound that is not a tag raises ValueError."""
        tags = self._sorted_tags_cache()

        def index(kmer):
            i = int(np.searchsorted(tags, np.uint64(kmer)))
            if i == tags.size or int(tags[i]) != int(kmer):
                raise ValueError("{} is not a tag".format(kmer))
            return i

        lo = index(first_kmer) if first_kmer else 0
        hi = index(last_kmer) if last_kmer else tags.size
        return tags[lo:hi]

    def do_partition(self, first_kmer=0, last_kmer=0,
                     break_on_stop_tags=False, stop_big_traversals=False):
        """Partition tags in [first_kmer, last_kmer) of the sorted tag
        set (subset.cc:623-675), SEED_BATCH seeds searched at a time; the
        seeds' partition ids are assigned in seed order, so the batch
        changes nothing."""
        span = self._span(first_kmer, last_kmer)
        for i in range(0, span.size, SEED_BATCH):
            for ppi in self.find_all_tags_batch(
                    span[i: i + SEED_BATCH].tolist(), break_on_stop_tags,
                    stop_big_traversals):
                self.assign_partition_id(ppi.kmer, ppi.tagged_kmers)

    def do_partition_with_abundance(self, first_kmer=0, last_kmer=0,
                                    min_count=0, max_count=0xFFFF,
                                    break_on_stop_tags=False,
                                    stop_big_traversals=False):
        """Streaming-partitioning variant: the searches stop at k-mers
        whose abundance is outside [min_count, max_count]
        (subset.cc:679-734)."""
        span = self._span(first_kmer, last_kmer)
        for i in range(0, span.size, SEED_BATCH):
            for ppi in self.find_all_tags_batch(
                    span[i: i + SEED_BATCH].tolist(), break_on_stop_tags,
                    stop_big_traversals, min_count=min_count,
                    max_count=max_count):
                self.assign_partition_id(ppi.kmer, ppi.tagged_kmers)

    def do_partition_device(self, break_on_stop_tags=False,
                            stop_big_traversals=False, mesh=None):
        """The device engine (khmer_tpu/partitioning.py:350-413): the
        searches give a star edge list (each seed tag to every tag its
        search reaches), and kernel K10 labels the connected components
        on the card (partition_device.connected_components) instead of
        the host union.  The same partitions AS SETS OF TAGS as
        do_partition; ids are assigned in first-seed order, so pmap BYTE
        parity stays with do_partition.  With `mesh` (a
        parallel.make_mesh Mesh) the edge list is sharded over its shards
        and the labels are min-reduced across them every round
        (partition_device.connected_components_sharded)."""
        from khmer_tpu_torch.partition_device import (
            connected_components, connected_components_sharded)

        tags = self._sorted_tags_cache()
        tag_keys = self._tag_keys()
        n = tags.size
        src, dst = [], []
        for i in range(0, n, SEED_BATCH):
            sid, canon = self._tags_reached(tags[i: i + SEED_BATCH].tolist(),
                                            break_on_stop_tags,
                                            stop_big_traversals)
            src.append(sid + i)
            dst.append(torch.searchsorted(tag_keys, _u64.sort_key(canon)))
        dev = self.graph.device
        src = torch.cat(src or [torch.zeros(0, dtype=torch.int64,
                                            device=dev)])
        dst = torch.cat(dst or [torch.zeros(0, dtype=torch.int64,
                                            device=dev)])
        seeded = torch.zeros(n, dtype=torch.bool, device=dev)
        seeded[src] = True
        seeded[dst] = True
        seeded = seeded.cpu().numpy()
        stats = {"tags": int(n), "edges": int(src.numel()), "calls": 0}
        if src.numel() and mesh is not None:
            labels = connected_components_sharded(
                mesh, n, src, dst, stats=stats).cpu().numpy().view(np.uint32)
        elif src.numel():
            labels = connected_components(
                n, src.to(torch.int32), dst.to(torch.int32), dev,
                stats=stats).cpu().numpy().view(np.uint32)
        else:
            labels = np.arange(n, dtype=np.uint32)
        self.device_stats = stats
        # label -> partition id in first-seed order (the reference
        # assigns fresh ids as seeds are processed, subset.cc:85);
        # unseeded tags stay absent, as with do_partition
        idx = np.nonzero(seeded)[0]
        roots, first, inverse = np.unique(labels[idx], return_index=True,
                                          return_inverse=True)
        rank = np.empty(roots.size, np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(roots.size)
        pids = self.next_partition_id + rank[inverse]
        for pid in range(self.next_partition_id,
                         self.next_partition_id + roots.size):
            self._rev[pid] = set()
        self.next_partition_id += roots.size
        for tag, pid in zip(tags[idx].tolist(), pids.tolist()):
            self.partition_map[tag] = pid
            self._rev[pid].add(tag)

    # -- stats ------------------------------------------------------------

    def count_partitions(self):
        """(n_partitions, n_unassigned) over the graph's tags
        (subset.cc count_partitions; the reference's operator[] inserts
        null entries for unseen tags -- size parity kept)."""
        parts = set()
        n_unassigned = 0
        for tag in self.graph.all_tags:
            pid = self.partition_map.setdefault(int(tag), None)
            if pid is not None:
                parts.add(pid)
            else:
                n_unassigned += 1
        return len(parts), n_unassigned

    def partition_sizes(self, min_size=0):
        cm = {}
        n_unassigned = 0
        for tag in self.graph.all_tags:
            pid = self.partition_map.get(int(tag))
            if pid is not None:
                cm[pid] = cm.get(pid, 0) + 1
            else:
                n_unassigned += 1
        sizes = [(p, s) for p, s in sorted(cm.items()) if s >= min_size]
        return sizes, n_unassigned

    def partition_size_distribution(self):
        sizes, n_unassigned = self.partition_sizes()
        d = {}
        for _, s in sizes:
            d[s] = d.get(s, 0) + 1
        return sorted(d.items()), n_unassigned

    def partition_average_coverages(self, counting):
        """(partition id, mean count of its tags in `counting`), the mean
        rounded down, by partition id; the tags' counts in one read."""
        items = [(t, p) for t, p in self.partition_map.items()
                 if p is not None]
        counts = counting.storage.get_batch(
            np.array([t for t, _ in items], np.uint64)).tolist()
        sums = {}
        ns = {}
        for (_, pid), c in zip(items, counts):
            sums[pid] = sums.get(pid, 0) + c
            ns[pid] = ns.get(pid, 0) + 1
        return sorted((p, sums[p] // ns[p]) for p in sums)

    def report_on_partitions(self):
        n_partitions, n_unassigned = self.count_partitions()
        print("%d tags total" % len(self.graph.all_tags))
        print("%d partitions total" % n_partitions)
        print("%d unassigned tags" % n_unassigned)

    # -- persistence (byte parity: subset.cc:1158-1229) -------------------

    def save_partitionmap(self, filename):
        tags = _sorted_u64(self.partition_map)
        pids = [self.partition_map[t] for t in tags.tolist()]
        assigned = np.array([p is not None for p in pids], bool)
        rec = np.empty(int(assigned.sum()), np.dtype([("t", "<u8"),
                                                      ("p", "<u4")]))
        rec["t"] = tags[assigned]
        rec["p"] = [p for p in pids if p is not None]
        with open(filename, "wb") as f:
            f.write(SAVED_SIGNATURE)
            f.write(struct.pack("BB", SAVED_FORMAT_VERSION, SAVED_SUBSET))
            f.write(struct.pack("<I", self.graph.ksize()))
            f.write(struct.pack("<Q", len(self.partition_map)))
            f.write(rec.tobytes())

    def load_partitionmap(self, filename):
        self.merge_from_disk(filename)

    # legacy_partitioning.pyx load()
    @staticmethod
    def load(filename, graph):
        subset = SubsetPartition(graph)
        subset.merge_from_disk(filename)
        return subset

    def _validate_partitionmap(self):
        """Sanity-check the tag->partition map (reference
        subset.cc _validate_pmap: every mapped partition id must be
        registered in the reverse map)."""
        for pid in self.partition_map.values():
            if pid is not None and pid not in self._rev:
                raise RuntimeError(
                    "invalid partition map: pid {} unregistered".format(
                        pid))

    def _validate_pmap(self):
        for pid in self.partition_map.values():
            if pid is not None and not (1 <= pid < self.next_partition_id):
                raise ValueError("invalid partition map")

    def merge_from_disk(self, filename):
        """Merge a pmap file: equal disk ids unify tags locally
        (subset.cc:1006-1157)."""
        with open(filename, "rb") as f:
            data = f.read()
        if len(data) == 18:
            raise OxliFileError(
                filename + " contains only a header and no partition IDs.")
        if len(data) < 18:
            raise OxliFileError(
                "truncated subset pmap header in " + filename)
        if data[:4] != SAVED_SIGNATURE:
            raise OxliFileError(
                "Incorrect file signature while reading subset pmap from "
                + filename)
        version, ht_type = data[4], data[5]
        if version != SAVED_FORMAT_VERSION:
            raise OxliFileError(
                "Incorrect file format version {} while reading subset "
                "pmap from {}".format(version, filename))
        if ht_type != SAVED_SUBSET:
            raise OxliFileError(
                "Incorrect file format type {} while reading subset "
                "pmap from {}".format(ht_type, filename))
        (ksize,) = struct.unpack_from("<I", data, 6)
        if ksize != self.graph.ksize():
            raise OxliFileError(
                "Incorrect k-mer size {} while reading subset pmap "
                "from {}".format(ksize, filename))
        (expected_pmap_size,) = struct.unpack_from("<Q", data, 10)
        if (len(data) - 18) // 12 != expected_pmap_size or \
                (len(data) - 18) % 12:
            # truncated payload (reference subset.cc:1150-1153)
            raise OxliFileError(
                "error loading partitionmap - invalid # of items")
        rec = np.frombuffer(data, np.dtype([("t", "<u8"), ("p", "<u4")]),
                            offset=18)
        self._merge_records(zip(rec["t"].tolist(), rec["p"].tolist()))

    def merge(self, other):
        """Merge another subset's map (subset.cc:935-1005)."""
        self._merge_records(
            (tag, other.partition_map[tag]) for tag in
            sorted(other.partition_map)
            if other.partition_map[tag] is not None)

    def _merge_records(self, records):
        """Merge (tag, partition id) records, in order: equal ids unify
        their tags here."""
        diskp_to_pid = {}
        for tag, diskp in records:
            local = diskp_to_pid.get(diskp)
            existing = self.partition_map.get(tag)
            if local is None:
                local = existing if existing is not None else \
                    self._new_pid()
                diskp_to_pid[diskp] = local
            if existing is None:
                self.partition_map[tag] = local
                self._rev.setdefault(local, set()).add(tag)
            elif existing != local:
                winner = self._rewrite(local, existing)
                if winner != local:
                    diskp_to_pid[diskp] = winner

    # -- read output ------------------------------------------------------

    def output_partitioned_file(self, infilename, outputfile,
                                output_unassigned=False):
        """Annotate reads with partition ids (subset.cc:115-334): the
        first k-mer of the read found in the partition map decides.
        Reads shorter than k are left out.  Returns the number of
        partitions seen."""
        from khmer_tpu_torch.io.fastx import FastxReader

        n_partitions = set()
        keys = self._keys(_sorted_u64(self.partition_map))
        pmap = self.partition_map
        k = self.graph.ksize()

        def flush(reads, out):
            # each read's first k-mer found in the map (K1, then a
            # search of the map's sorted keys on the device)
            seqs = [r.cleaned_seq for r in reads]
            h, valid = self.graph._row_hashes(seqs)
            hit = _member(keys, h.reshape(-1)).reshape(h.shape) & valid
            col = hit.to(torch.int8).argmax(1)
            found = hit.gather(1, col[:, None]).squeeze(1).cpu().numpy()
            first = _u64.to_numpy(h.gather(1, col[:, None]).squeeze(1))
            for i, read in enumerate(reads):
                partition_id = 0
                if found[i]:
                    pid = pmap[int(first[i])]
                    if pid is not None:
                        partition_id = pid
                        n_partitions.add(pid)
                if partition_id > 0 or output_unassigned:
                    if getattr(read, 'quality', None) is not None:
                        out.write("@%s\t%d\n%s\n+\n%s\n" % (
                            read.name, partition_id, seqs[i],
                            read.quality))
                    else:
                        out.write(">%s\t%d\n%s\n" % (
                            read.name, partition_id, seqs[i]))

        with open(outputfile, "w") as out:
            pending = []
            for read in FastxReader(infilename):
                if len(read.cleaned_seq) < k:
                    continue
                pending.append(read)
                if len(pending) >= ANNOTATE_BATCH:
                    flush(pending, out)
                    pending = []
            if pending:
                flush(pending, out)
        return len(n_partitions)

    # -- sweep (annotate arbitrary reads by neighbourhood) ------------------

    def sweep_for_tags(self, seq, range_=0, break_on_stop_tags=False,
                       stop_big_traversals=False):
        """BFS from every k-mer of the read out to nearby tags
        (subset.cc:427-520; perimeter abort at 200*len): the set of tags
        reached.  range_=0 restricts the sweep to the read's own k-mers
        (the reference's range==0 semantics); otherwise range_ bounds the
        BFS breadth.  sweep_for_tags_batch of the one read."""
        return self.sweep_for_tags_batch([seq], range_, break_on_stop_tags,
                                         stop_big_traversals)[0]

    def sweep_for_tags_batch(self, seqs, range_=0, break_on_stop_tags=False,
                             stop_big_traversals=False):
        """sweep_for_tags of every sequence of a batch, a list of sets, with
        one count probe a level for the whole batch (khmer_tpu sweeps a
        read at a time, its visited set and abort lane by lane on the
        host).  The graph and its tags must not change meanwhile.

        Every read keeps its own keeper, lanes and abort.  A level's lanes
        stay in read order and, within a read, in khmer_tpu's lane order
        (each expanded k-mer's existing neighbours, right then left), so
        the lanes each read takes are those it takes alone: the first of
        each k-mer among its lanes that is neither in its keeper nor a
        stop tag (with break_on_stop_tags), while its keeper holds at most
        200 * len(read) k-mers (with stop_big_traversals; a read whose
        keeper outgrew that ends after the level).  A tag joins the
        keeper but is not expanded, nor is anything at breadth range_.  A lane can only be in
        its read's keeper if it joined at the last level or the one
        before, or is a tag: every other keeper k-mer was expanded, so its
        neighbours joined by the level after it (as in
        traversal._keeper_pairs, where no k-mer stops the search)."""
        from khmer_tpu_torch.hashtable import _pad_rows

        graph = self.graph
        k = graph.ksize()
        dev = graph.device
        out = [set() for _ in seqs]
        rows = [i for i, q in enumerate(seqs) if len(q) >= k]
        if not rows:
            return out
        # level 0: every read's k-mers, read by read
        codes, lengths = _pad_rows([seqs[i] for i in rows], k)
        c = graph._upload(codes).to(torch.int64)
        w = c.shape[1] - k + 1
        f = torch.zeros((c.shape[0], w), dtype=torch.int64, device=dev)
        r = torch.zeros_like(f)
        for j in range(k):
            f = (f << 2) | c[:, j:j + w]
            r |= (c[:, j:j + w] ^ 1) << (2 * j)
        valid = torch.arange(w, device=dev)[None, :] < \
            graph._upload(lengths).to(torch.int64)[:, None] - k + 1
        f, r = f[valid], r[valid]
        sid = torch.nonzero(valid)[:, 0]
        n = len(rows)
        big = torch.tensor([BIG_TRAVERSALS_ARE * len(seqs[i]) for i in rows],
                           dtype=torch.int64, device=dev)
        kept = torch.zeros(n, dtype=torch.int64, device=dev)
        tags = _keys_of(graph.all_tags, dev) if graph.all_tags else None
        stops = stop_keys(graph) if break_on_stop_tags else None
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        # the keeper's pairs of the last two levels, and its tags
        last_s = last_c = before_s = before_c = tag_s = tag_c = empty
        breadth = 0
        while f.numel():
            canon = _u64.umin(f, r)
            live = ~_member(stops, canon)
            if stop_big_traversals:
                live &= kept[sid] <= big[sid]
            lanes = torch.nonzero(live).squeeze(1)
            fresh = lanes[_first_new(torch.cat([before_s, last_s, tag_s]),
                                     torch.cat([before_c, last_c, tag_c]),
                                     sid[lanes], canon[lanes])]
            s = sid[fresh]
            if stop_big_traversals:
                # the lanes taken while the keeper held at most big k-mers
                take = kept[s] + _run_rank(s, torch.ones_like(
                    s, dtype=torch.bool)) - 1 <= big[s]
                fresh, s = fresh[take], s[take]
            if not fresh.numel():
                break
            kept += torch.bincount(s, minlength=n)
            cf = canon[fresh]
            is_tag = _member(tags, cf)
            tag_s = torch.cat([tag_s, s[is_tag]])
            tag_c = torch.cat([tag_c, cf[is_tag]])
            before_s, before_c, last_s, last_c = last_s, last_c, s, cf
            if breadth >= range_:
                break
            grow = fresh[~is_tag]
            if stop_big_traversals:
                grow = grow[kept[sid[grow]] <= big[sid[grow]]]
            if not grow.numel():
                break
            f, r, _, src = _expand(graph, f[grow], r[grow], k)
            sid = sid[grow][src]
            breadth += 1
        for i, h in zip(tag_s.cpu().tolist(), _u64.to_numpy(tag_c).tolist()):
            out[rows[i]].add(h)
        return out

    # -- repartition / stop-tag generation --------------------------------

    def find_unpart(self, infilename, traverse, stop_big_traversals):
        """Consume, tag, and partition reads not yet in any partition
        (khmer_tpu's reconstruction of the reference's find_unpart,
        _cpy_khmer.cc:1831-1860): a read whose in-read tags already carry
        a partition is skipped; any other read is consumed and tagged,
        counted as a singleton, and its tags are partitioned together --
        joined with every tag its tags' searches reach when `traverse`
        is set, alone otherwise.  Returns the singleton count.  Read by
        read, as each read's consume changes what the next one sees."""
        from khmer_tpu_torch.io.fastx import FastxReader

        graph = self.graph
        n_singletons = 0
        for read in FastxReader(infilename):
            seq = read.cleaned_seq
            if len(seq) < graph.ksize():
                continue
            hashes = graph._hash_array(seq).tolist()
            read_tags = {h for h in hashes if h in graph.all_tags}
            if any(self.partition_map.get(t) is not None
                   for t in read_tags):
                continue
            graph.consume_and_tag(seq, read_tags)
            read_tags |= {h for h in hashes if h in graph.all_tags}
            n_singletons += 1
            if not read_tags:
                continue
            if traverse:
                for ppi in self.find_all_tags_batch(
                        sorted(read_tags), False, stop_big_traversals):
                    read_tags |= {int(t) for t in ppi.tagged_kmers}
            self.assign_partition_id(next(iter(read_tags)), read_tags)
        return n_singletons

    def repartition_largest_partition(self, distance, threshold, frequency,
                                      counting):
        """Find the largest partition, traverse from its tags stopping
        high-abundance k-mers into stop_tags, then re-partition
        (subset.cc:1340-1548); returns the largest partition's size
        after.  The traversals and count walk run in _KnotWalk, which
        keeps khmer_tpu's tag-by-tag order; its numbers are left in
        self.knot_stats."""
        sizes, _ = self.partition_sizes()
        if not sizes:
            return 0
        biggest = max(sizes, key=lambda ps: ps[1])[0]
        tags = [t for t, p in self.partition_map.items() if p == biggest]
        walk = _KnotWalk(self.graph, counting, distance, threshold,
                         frequency)
        walk.run(tags)
        self.knot_stats = walk.stats
        # clear this partition's assignments and re-partition its tags
        for tag in tags:
            self.partition_map.pop(tag, None)
        self._rev.pop(biggest, None)
        span = sorted(tags)
        for i in range(0, len(span), SEED_BATCH):
            for ppi in self.find_all_tags_batch(
                    span[i: i + SEED_BATCH], break_on_stop_tags=True,
                    stop_big_traversals=True):
                self.assign_partition_id(ppi.kmer, ppi.tagged_kmers)
        sizes, _ = self.partition_sizes()
        next_sizes = sorted((s for _, s in sizes), reverse=True)
        return next_sizes[0] if next_sizes else 0


class _KnotWalk:
    """repartition_largest_partition's loop over the largest partition's
    tags (khmer_tpu/partitioning.py:760-767): each tag's keeper is
    traverse_from_kmer(tag, distance) under the stop tags of that moment,
    and a keeper of at least `threshold` k-mers is walked in its set
    order: a k-mer whose count in `counting` exceeds `frequency` becomes
    a stop tag, any other has its count raised by one.

    khmer_tpu does that one tag, one level and one k-mer at a time.  Here
    KNOT_BATCH tags are traversed together on the device under the stop
    tags as the batch starts (traversal._keeper_pairs: one probe a level
    for the batch), and the counting table's bins of every k-mer of the
    keepers that reach `threshold` are read once (K3, one call a table).
    The batch is then walked on the host in khmer_tpu's order:

    * a keeper that holds a stop tag added since the batch started is
      traversed again under the stop tags of its turn.  More stop tags
      only take k-mers away (a k-mer reached within `distance` avoiding
      them was reached before), and each k-mer the new traversal expands
      was expanded by the first, so the first keeper is the set of
      existing, not stopped k-mers it can meet: the new traversal runs on
      the host over it.  A keeper cut at MAX_KEEPER_SIZE is traversed
      again on the device.  A keeper below `threshold` stays below it.
    * a count is the bins as read plus the adds made since, kept per bin,
      so that k-mers sharing a bin see each other's adds: a keeper whose
      k-mers share no bin is decided at once, any other k-mer by k-mer.
    * the batch's adds go to the counting table in one call (K2), in
      walk order, as the batch ends."""

    def __init__(self, graph, counting, distance, threshold, frequency):
        self.graph = graph
        self.store = counting.storage
        self.distance = distance
        self.threshold = threshold
        self.frequency = frequency
        self.cap = self.store.read_cap()
        spec = self.store.spec
        self.sizes = np.array(spec.tablesizes, np.uint64)
        self.offsets = np.array(spec.bin_offsets, np.uint64)
        self.stats = dict(tags=0, batches=0, walked=0, retraced=0,
                          kmers_walked=0, stop_tags_added=0, bins_read=0)

    def run(self, tags):
        k = self.graph.ksize()
        self.stats["tags"] += len(tags)
        for i in range(0, len(tags), KNOT_BATCH):
            self._batch(tags[i: i + KNOT_BATCH], k)

    def _batch(self, tags, k):
        graph = self.graph
        self.stats["batches"] += 1
        keepers, ends = keeper_arrays(
            graph, [fr_from_hash(t, k) for t in tags], self.distance,
            MAX_KEEPER_SIZE, stop_keys(graph))
        starts = np.concatenate([[0], ends[:-1]])
        walk = np.nonzero(ends - starts >= self.threshold)[0].tolist()
        if not walk:
            return
        self._reset()
        self._read_bins(np.unique(np.concatenate(
            [keepers[starts[j]:ends[j]] for j in walk])))
        added = set()
        adds = []
        for j in walk:
            seg = keepers[starts[j]:ends[j]]
            keeper = set(seg.tolist())
            if added and not added.isdisjoint(keeper):
                keeper = self._retrace(tags[j], seg, k)
                if len(keeper) < self.threshold:
                    continue
            stops, add = self._walk(keeper)
            added.update(stops)
            graph.stop_tags.update(stops)
            adds.append(add)
        h = np.concatenate(adds)
        if h.size:
            dev = self.store.device
            self.store.add_lanes(_u64.as_tensor(h, dev),
                                 torch.ones(h.size, dtype=torch.int32,
                                            device=dev))

    def _reset(self):
        """Forget the bins read: the table changes as a batch ends."""
        t = self.sizes.size
        self.kmers = np.zeros(0, np.uint64)   # sorted
        self.cid = np.zeros((t, 0), np.int64)  # their bins, compact ids
        self.gids = np.zeros(0, np.uint64)    # sorted global bin ids
        self.base = np.zeros(0, np.int64)     # bin values as read
        self.delta = np.zeros(0, np.int64)    # adds since

    def _read_bins(self, new):
        """Read the bins of the k-mers `new` (sorted, distinct, none read
        yet) in every table: K3 with the one table's geometry (K20 on a
        bin-sharded table)."""
        if not new.size:
            return
        st = self.store
        h = _u64.as_tensor(new, st.device)
        vals = np.stack([st.get_lanes(h, 0xFFFF, slice(t, t + 1)).cpu()
                         .numpy().astype(np.int64)
                         for t in range(self.sizes.size)])
        gid = new[None, :] % self.sizes[:, None] + self.offsets[:, None]
        gids = np.union1d(self.gids, gid.ravel())
        remap = np.searchsorted(gids, self.gids)
        base = np.zeros(gids.size, np.int64)
        delta = np.zeros(gids.size, np.int64)
        base[remap] = self.base
        delta[remap] = self.delta
        cid = np.searchsorted(gids, gid)
        base[cid] = vals
        kmers = np.concatenate([self.kmers, new])
        cid = np.concatenate([remap[self.cid], cid], axis=1)
        order = np.argsort(kmers, kind="stable")
        self.kmers, self.cid = kmers[order], cid[:, order]
        self.gids, self.base, self.delta = gids, base, delta
        self.stats["bins_read"] += int(new.size) * self.sizes.size

    def _retrace(self, tag, seg, k):
        """traverse_from_kmer(tag, distance) under the stop tags now,
        given its keeper `seg` under fewer stop tags."""
        graph = self.graph
        stop = graph.stop_tags
        self.stats["retraced"] += 1
        if seg.size > MAX_KEEPER_SIZE:
            keepers, _ = keeper_arrays(graph, [fr_from_hash(tag, k)],
                                       self.distance, MAX_KEEPER_SIZE,
                                       stop_keys(graph))
            return set(keepers.tolist())
        c0 = min(fr_from_hash(tag, k))
        if c0 in stop:
            return set()
        # the first keeper as a graph: each k-mer's 8 neighbours in its
        # forward orientation (kmer_f the canonical hash), as indices
        # into the sorted first keeper (-1: absent or a stop tag now) and
        # whether each is met in its own forward orientation
        nodes = np.sort(seg)
        nf, nr = neighbors_fr(*(_u64.as_tensor(x, "cpu")
                                for x in fr_from_hashes(nodes, k)), k)
        nf, canon = _u64.to_numpy(nf), _u64.to_numpy(_u64.umin(nf, nr))
        idx = np.searchsorted(nodes, canon).clip(max=nodes.size - 1)
        live = np.array([c not in stop for c in nodes.tolist()])
        idx[(nodes[idx] != canon) | ~live[idx]] = -1
        fwd = nf == canon
        # met in reverse orientation, a k-mer's right neighbour by base b
        # is its forward left neighbour by b ^ 1, reversed, and so on
        back = [5, 4, 7, 6, 1, 0, 3, 2]
        keeper = {c0}
        seen = np.zeros(nodes.size, bool)
        at = np.searchsorted(nodes, np.uint64(c0))
        seen[at] = True
        front, front_fwd = np.array([at]), np.array([True])
        for _ in range(self.distance):
            rows, rows_fwd = idx[front], fwd[front]
            rev = ~front_fwd
            rows[rev] = rows[rev][:, back]
            rows_fwd[rev] = ~rows_fwd[rev][:, back]
            rows, rows_fwd = rows.ravel(), rows_fwd.ravel()
            ok = rows >= 0
            rows, rows_fwd = rows[ok], rows_fwd[ok]
            first = np.sort(np.unique(rows, return_index=True)[1])
            new = first[~seen[rows[first]]]
            if not new.size:
                break
            front, front_fwd = rows[new], rows_fwd[new]
            seen[front] = True
            keeper.update(nodes[front].tolist())
        return keeper

    def _walk(self, keeper):
        """The count walk of one keeper in its set order: (the k-mers
        that become stop tags, in order; uint64 k-mers to add, in
        order)."""
        arr = np.fromiter(keeper, np.uint64, len(keeper))
        if not arr.size:
            return [], arr
        self.stats["walked"] += 1
        self.stats["kmers_walked"] += int(arr.size)
        pos = np.searchsorted(self.kmers, arr)
        known = pos < self.kmers.size
        known[known] = self.kmers[pos[known]] == arr[known]
        if not known.all():
            self._read_bins(np.unique(arr[~known]))
            pos = np.searchsorted(self.kmers, arr)
        cid = self.cid[:, pos]
        base, delta = self.base, self.delta
        if np.unique(cid).size == cid.size:
            count = np.minimum((base[cid] + delta[cid]).min(0), self.cap)
            stop = count > self.frequency
            delta[cid[:, ~stop]] += 1
        else:
            stop = np.zeros(arr.size, bool)
            for i in range(arr.size):
                ids = cid[:, i]
                if min(int((base[ids] + delta[ids]).min()),
                       self.cap) > self.frequency:
                    stop[i] = True
                else:
                    delta[ids] += 1
        stops = arr[stop].tolist()
        self.stats["stop_tags_added"] += len(stops)
        return stops, arr[~stop]


def _counts(st, hashes):
    """Counts of device hashes with a loaded bigcount map overlaid, as
    khmer_tpu's storage.get_batch reads them."""
    counts = st.get_lanes(hashes)
    if st.kind == "byte" and st.get_use_bigcount() and st.bigcounts:
        counts = torch.from_numpy(st.overlay_bigcounts(
            counts.cpu().numpy(), _u64.to_numpy(hashes))).to(hashes.device)
    return counts.to(torch.int32)


def _pairs_in(qs, qc, ss, sc):
    """Which query pairs (qs[i], qc[i]) are among the pairs (ss, sc);
    each list holds distinct pairs."""
    n = ss.numel()
    order, first = _pair_runs(torch.cat([ss, qs]), torch.cat([sc, qc]))
    out = torch.zeros(qs.numel(), dtype=torch.bool, device=qs.device)
    query = order >= n
    out[order[query] - n] = ~first[query]
    return out

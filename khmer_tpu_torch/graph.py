"""de Bruijn graph tables: Hashgraph, with Countgraph, SmallCountgraph
and Nodegraph.

Port of khmer_tpu/graph.py:23-619: tags and stop tags, consume-and-tag
(also around stop tags), tagset and stoptags files, the traversal
queries (khmer_tpu_torch.traversal), subset partitions, partition maps
and the knot-finding calls (khmer_tpu_torch.partitioning), the stop-tag
helpers and assemble_linear_path (khmer_tpu_torch.assembly).

Tagging takes each batch of reads through one K1 pass over their padded
rows and one Storage.add_lanes call (K2) in read and k-mer order, whose
per-lane was-new flags carry the reference's sequential semantics
whatever the batch; the sequential tag rule then runs on the host over
those flags, as in khmer_tpu.
"""

import numpy as np
import torch

from khmer_tpu_torch import _u64, traversal
from khmer_tpu_torch._config import DEFAULT_TAG_DENSITY
from khmer_tpu_torch.hashset import HashSet
from khmer_tpu_torch.hashtable import Hashtable, _pad_rows
from khmer_tpu_torch.io import oxli_format
from khmer_tpu_torch.io.fastx import FastxReader
from khmer_tpu_torch.ops.hashing import kmer_hashes_2bit
from khmer_tpu_torch.storage import BitStorage, ByteStorage, NibbleStorage

# reads per consume-and-tag batch; any batch tags the same k-mers
TAG_BATCH = 16384
# reads per filter_if_present and consume_partitioned_fasta batch
READ_BATCH = 16384


class Hashgraph(Hashtable):
    """Hashtable + tags/stop tags + partitioning entry points."""

    def __init__(self, ksize, starting_size=None, n_tables=None,
                 primes=None, device=None):
        super().__init__(ksize, starting_size, n_tables, primes=primes,
                         device=device)
        self._post_load()

    def _post_load(self):
        self.all_tags = set()
        self.stop_tags = set()
        self._tag_density = DEFAULT_TAG_DENSITY
        self._partition = None

    # -- tag management (reference hashgraph.cc:375-460) -------------------

    @property
    def tag_density(self):
        return self._tag_density

    @tag_density.setter
    def tag_density(self, d):
        self._set_tag_density(d)

    def _get_tag_density(self):
        return self._tag_density

    def _set_tag_density(self, d):
        if d % 2 != 0:
            raise ValueError("tag density must be even")
        if self.all_tags:
            raise RuntimeError("graph already has tags")
        self._tag_density = d

    @property
    def n_tags(self):
        """Count of all tags (a property, reference graphs.pyx:722)."""
        return len(self.all_tags)

    def add_tag(self, kmer):
        self.all_tags.add(self.hash(kmer) if isinstance(kmer, str)
                          else int(kmer))

    def add_stop_tag(self, kmer):
        self.stop_tags.add(self.hash(kmer) if isinstance(kmer, str)
                           else int(kmer))

    def get_tagset(self):
        return [self.reverse_hash(h) for h in sorted(self.all_tags)]

    def tags(self):
        """Yield all tagged k-mers as DNA strings (graphs.pyx:708-712)."""
        for h in self.all_tags:
            yield self.reverse_hash(h)

    def get_stop_tags(self):
        return [self.reverse_hash(h) for h in sorted(self.stop_tags)]

    def iter_stop_tags(self):
        """Yield all stop tags as DNA strings (graphs.pyx:903-907)."""
        for h in self.stop_tags:
            yield self.reverse_hash(h)

    def print_tagset(self, filename):
        """Write every tag as a DNA line (hashgraph.cc:1415-1427)."""
        with open(filename, "w") as f:
            for h in self.all_tags:
                f.write(self.reverse_hash(h) + "\n")

    def print_stop_tags(self, filename):
        """Write every stop tag as a DNA line (hashgraph.cc)."""
        with open(filename, "w") as f:
            for h in self.stop_tags:
                f.write(self.reverse_hash(h) + "\n")

    # -- consume and tag ---------------------------------------------------

    def _reads(self, parser_or_filename):
        if isinstance(parser_or_filename, str):
            return iter(FastxReader(parser_or_filename))
        return iter(parser_or_filename)

    def _row_hashes(self, sequences):
        """K1 over the sequences padded as khmer_tpu pads them: (int64
        hashes [B, W], bool valid [B, W]) on the device, B >= the number
        of sequences."""
        codes, lengths = _pad_rows(sequences, self._ksize)
        return kmer_hashes_2bit(self._upload(codes), self._upload(lengths),
                                self._ksize)

    def consume_and_tag(self, sequence, found_tags=None):
        """Consume a sequence and sprinkle tags every `tag_density`
        k-mers (reference consume_sequence_and_tag, hashgraph.cc:375-446).
        Returns the number of NEW k-mers."""
        hashes = self._hash_array(sequence)
        if hashes.size == 0:
            return 0
        isnew = self.storage.add_batch(hashes)
        self._tag_from_hashes(hashes, isnew, found_tags)
        return int(isnew.sum())

    def _tag_from_hashes(self, hashes, isnew, found_tags=None):
        """Reference tagging rule (hashgraph.cc:375-446): walk the read,
        counting k-mers since the last tag; an already-tagged k-mer
        resets the counter; at tag_density, tag and reset; finally the
        last k-mer is tagged when since >= tag_density/2 - 1."""
        all_tags = self.all_tags
        density = self._tag_density
        since = density // 2 + 1
        h = None
        for h, new in zip(hashes.tolist(), isnew.tolist()):
            if new:
                since += 1
            elif h in all_tags:
                since = 1
                if found_tags is not None:
                    found_tags.add(h)
            else:
                since += 1
            if since >= density:
                all_tags.add(h)
                if found_tags is not None:
                    found_tags.add(h)
                since = 1
        if since >= density // 2 - 1:
            all_tags.add(h)
            if found_tags is not None:
                found_tags.add(h)

    def consume_seqfile_and_tag(self, parser_or_filename):
        """Consume every (cleaned) read and tag (hashgraph.cc:432-460);
        returns (n_reads, n_consumed), n_consumed the number of new
        k-mers.  Reads shorter than k are counted and skipped."""
        n_reads = 0
        n_consumed = 0
        pending = []
        for read in self._reads(parser_or_filename):
            seq = read.cleaned_seq
            n_reads += 1
            if len(seq) < self._ksize:
                continue
            pending.append(seq)
            if len(pending) >= TAG_BATCH:
                n_consumed += self._consume_and_tag_batch(pending)
                pending = []
        if pending:
            n_consumed += self._consume_and_tag_batch(pending)
        return n_reads, n_consumed

    def _consume_and_tag_batch(self, seqs, found_tags=None, read_tags=None):
        """consume_and_tag over several reads: their k-mers go into the
        table in one add_lanes call, in read and k-mer order.  read_tags,
        when given, is a list that gets each read's found tags (a set)."""
        h, valid = self._row_hashes(seqs)
        flat = h[valid]
        if flat.numel() == 0:
            return 0
        isnew = self.storage.add_lanes(
            flat, torch.ones(flat.numel(), dtype=torch.int32,
                             device=flat.device)).cpu().numpy()
        hashes = _u64.to_numpy(flat)
        off = 0
        for s in seqs:
            n = len(s) - self._ksize + 1
            found = found_tags if read_tags is None else set()
            self._tag_from_hashes(hashes[off: off + n],
                                  isnew[off: off + n], found)
            if read_tags is not None:
                read_tags.append(found)
            off += n
        return int(isnew.sum())

    def consume_seqfile_and_tag_with_stoptags(self, parser_or_filename):
        """Consume + tag, skipping stop-tagged k-mers and joining the
        tags across those gaps (hashgraph.cc:507-609); returns (n_reads,
        n_consumed).  khmer_tpu reads each read's counts before the read
        and adds its new k-mers after it; here a batch of reads takes one
        probe (_stoptag_flags), and the tag rule runs read by read on the
        host, as in khmer_tpu."""
        n_reads = 0
        n_consumed = 0
        pending = []
        for read in self._reads(parser_or_filename):
            seq = read.cleaned_seq if hasattr(read, "cleaned_seq") \
                else str(read)
            n_reads += 1
            if len(seq) < self._ksize:
                continue
            pending.append(seq)
            if len(pending) >= TAG_BATCH:
                n_consumed += self._stoptag_batch(pending)
                pending = []
        if pending:
            n_consumed += self._stoptag_batch(pending)
        return n_reads, n_consumed

    def _stoptag_batch(self, seqs):
        """consume_seqfile_and_tag_with_stoptags over a batch of reads."""
        h, valid = self._row_hashes(seqs)
        flat = h[valid]
        stops = traversal.stop_keys(self)
        is_stop = traversal._member(stops, flat)
        is_new = self._stoptag_flags(flat, valid.nonzero()[:, 0], is_stop)
        new = flat[is_new]
        if new.numel():
            self.storage.add_lanes(new, torch.ones(
                new.numel(), dtype=torch.int32, device=new.device))
        hashes = _u64.to_numpy(flat).tolist()
        is_stop = is_stop.cpu().numpy().tolist()
        is_new = is_new.cpu().numpy().tolist()
        density = self._tag_density
        all_tags = self.all_tags
        off = 0
        for seq in seqs:
            end = off + len(seq) - self._ksize + 1
            read_tags = set()
            since = density // 2 + 1
            kmer = last_kmer = None
            for i in range(off, end):
                kmer = hashes[i]
                if not is_stop[i]:
                    if not is_new[i] and kmer in all_tags:
                        read_tags.add(kmer)
                        since = 1
                    else:
                        since += 1
                    if since >= density:
                        all_tags.add(kmer)
                        read_tags.add(kmer)
                        since = 1
                else:
                    # stop tag!  do not insert, but connect.
                    if i > off and not read_tags:
                        read_tags.add(last_kmer)
                        all_tags.add(last_kmer)
                    since = density - 1  # insert next kmer, too
                last_kmer = kmer
            if not is_stop[end - 1] and since >= density // 2 - 1:
                all_tags.add(kmer)
                read_tags.add(kmer)
            if len(read_tags) > 1:
                self.partition.assign_partition_id(next(iter(read_tags)),
                                                   read_tags)
            off = end
        return int(sum(is_new))

    def _stoptag_flags(self, flat, read_of, is_stop):
        """Which lanes (int64 hashes `flat` in read and k-mer order, the
        read of each, the stop lanes) khmer_tpu counts as new: a lane not
        a stop tag whose count before its read was 0 and which is its
        read's first of that k-mer.  Such a lane is the first of its
        k-mer in the batch (an earlier read would have added it), with a
        count of 0 before the batch (one K3 probe), and it is new unless
        every table's bin that was 0 before the batch was set by a new
        lane of an earlier read.  A bin that only one such lane touches
        stays 0 until its read, so a lane with one of those is new; the
        rest, lanes whose empty bins other lanes share, are settled in
        read order on the host."""
        st = self.storage
        dev = flat.device
        live = torch.nonzero(~is_stop).squeeze(1)
        empty = flat.new_zeros(0)
        first = live[traversal._first_new(empty, empty,
                                          torch.zeros_like(live),
                                          flat[live])]
        cand = first[st.get_lanes(flat[first]).to(torch.int32) == 0]
        is_new = torch.zeros(flat.numel(), dtype=torch.bool, device=dev)
        if not cand.numel():
            return is_new
        h = flat[cand]
        sizes, offsets, _ = st._geom
        n_t = sizes.numel()
        zero = torch.stack([st.get_lanes(h, 1, slice(t, t + 1)).to(
            torch.int32) == 0 for t in range(n_t)])
        gid = torch.stack([_u64.umod(h, sizes[t]) + offsets[t]
                           for t in range(n_t)])
        # the 0 bins two or more candidates share
        zg = gid[zero]
        uniq, counts = torch.unique(zg, return_counts=True)
        shared = uniq[counts > 1]
        contested = zero & torch.isin(gid, shared)
        sure = (zero & ~contested).any(0)
        if not contested.any():
            is_new[cand] = sure
            return is_new
        # settle the lanes that touch a shared 0 bin, in lane order
        touch = contested.any(0).cpu().numpy()
        sure = sure.cpu().numpy()
        zero_h = zero.cpu().numpy()
        gid_h = gid.cpu().numpy()
        cont_h = contested.cpu().numpy()
        reads = read_of[cand].cpu().numpy()
        new = sure.copy()
        set_by = {}
        for j in np.nonzero(touch)[0].tolist():
            rd = int(reads[j])
            if not new[j]:
                new[j] = any(set_by.get(int(g), rd) == rd
                             for g, z in zip(gid_h[:, j], zero_h[:, j]) if z)
            if new[j]:
                for g, c in zip(gid_h[:, j], cont_h[:, j]):
                    if c:
                        set_by.setdefault(int(g), rd)
        is_new[cand] = torch.from_numpy(new).to(dev)
        return is_new

    # -- tag/stoptag persistence -------------------------------------------

    def save_tagset(self, filename):
        oxli_format.save_hashset(filename, self._ksize, self.all_tags,
                                 ht_type=oxli_format.SAVED_TAGS,
                                 tag_density=self._tag_density)

    def load_tagset(self, filename, clear_tags=True):
        ksize, hashes, density = oxli_format.load_hashset(
            filename, ht_type=oxli_format.SAVED_TAGS)
        if ksize != self._ksize:
            raise oxli_format.OxliFileError(
                "tagset ksize {} does not match graph ksize {}".format(
                    ksize, self._ksize))
        if clear_tags:
            self.all_tags = set()
        self.all_tags.update(hashes.tolist())
        if density is not None:
            self._tag_density = density

    def save_stop_tags(self, filename):
        oxli_format.save_hashset(filename, self._ksize, self.stop_tags,
                                 ht_type=oxli_format.SAVED_STOPTAGS)

    def load_stop_tags(self, filename, clear_tags=True):
        ksize, hashes, _ = oxli_format.load_hashset(
            filename, ht_type=oxli_format.SAVED_STOPTAGS)
        if ksize != self._ksize:
            raise oxli_format.OxliFileError(
                "stoptags ksize {} does not match graph ksize {}".format(
                    ksize, self._ksize))
        if clear_tags:
            self.stop_tags = set()
        self.stop_tags.update(hashes.tolist())

    # -- partitioning ------------------------------------------------------

    @property
    def partition(self):
        """The graph's master SubsetPartition (graphs.pyx:546-551)."""
        if self._partition is None:
            from khmer_tpu_torch.partitioning import SubsetPartition

            self._partition = SubsetPartition(self)
        return self._partition

    @partition.setter
    def partition(self, value):
        self._partition = value

    def do_subset_partition(self, start_kmer=0, end_kmer=0,
                            break_on_stop_tags=False,
                            stop_big_traversals=False):
        from khmer_tpu_torch.partitioning import SubsetPartition

        subset = SubsetPartition(self)
        subset.do_partition(start_kmer, end_kmer, break_on_stop_tags,
                            stop_big_traversals)
        return subset

    def output_partitions(self, filename, output, output_unassigned=False):
        return self.partition.output_partitioned_file(
            filename, output, output_unassigned)

    def load_partitionmap(self, filename):
        self.partition.load_partitionmap(filename)

    def save_partitionmap(self, filename):
        self.partition.save_partitionmap(filename)

    def merge_subset_from_disk(self, filename):
        self.partition.merge_from_disk(filename)

    def count_partitions(self):
        return self.partition.count_partitions()

    def set_partition_id(self, kmer, pid):
        self.partition.set_partition_id(kmer, pid)

    def join_partitions(self, p1, p2):
        return self.partition.join_partitions(p1, p2)

    def get_partition_id(self, kmer):
        return self.partition.get_partition_id(kmer)

    def divide_tags_into_subsets(self, subset_size):
        """Every subset_size-th tag, in sorted order (hashgraph.cc:
        616-633); make-initial-stoptags passes a float."""
        return [t for i, t in enumerate(sorted(self.all_tags))
                if i % subset_size == 0]

    def do_subset_partition_with_abundance(self, min_count, max_count,
                                           start_kmer=0, end_kmer=0,
                                           break_on_stop_tags=False,
                                           stop_big_traversals=False):
        """Subset partition truncating traversal outside the count
        range (graphs.pyx:925-949; Countgraph only)."""
        from khmer_tpu_torch.partitioning import SubsetPartition

        subset = SubsetPartition(self)
        subset.do_partition_with_abundance(
            start_kmer, end_kmer, min_count, max_count,
            break_on_stop_tags, stop_big_traversals)
        return subset

    def find_all_tags(self, kmer):
        """PrePartitionInfo for one seed k-mer; the seed is then ADDED
        to the tag set -- the reference binding tags every queried seed
        (graphs.pyx:763-775, add_kmer_to_tags after the search)."""
        h = self.hash(kmer) if isinstance(kmer, str) else int(kmer)
        ppi = self.partition.find_all_tags(h)
        self.all_tags.add(h)
        return ppi

    def find_all_tags_list(self, kmer):
        """HashSet of tags connected to this k-mer, WITHOUT tagging the
        seed (graphs.pyx:658-669)."""
        h = self.hash(kmer) if isinstance(kmer, str) else int(kmer)
        hs = HashSet(self._ksize)
        hs.update(self.partition.find_all_tags(h).tagged_kmers)
        return hs

    def assign_partition_id(self, ppi):
        return self.partition.assign_partition_id(ppi)

    def _validate_partitionmap(self):
        self.partition._validate_pmap()

    def merge_subset(self, subset):
        self.partition.merge(subset)

    def repartition_largest_partition(self, counts, distance, threshold,
                                      frequency, subs=None):
        part = subs if subs is not None else self.partition
        return part.repartition_largest_partition(
            distance, threshold, frequency, counts)

    def sweep_for_tags(self, seq, range_=0, break_on_stop_tags=False,
                       stop_big_traversals=False):
        return self.partition.sweep_for_tags(
            seq, range_, break_on_stop_tags, stop_big_traversals)

    def find_unpart(self, filename, traverse, stop_big_traversals):
        return self.partition.find_unpart(
            filename, traverse, stop_big_traversals)

    def subset_count_partitions(self, subset):
        return subset.count_partitions()

    # -- graph queries (khmer_tpu_torch.traversal) -------------------------

    def kmer_degree(self, kmer):
        return traversal.kmer_degree(self, kmer)

    def neighbors(self, kmer):
        return traversal.neighbors(self, kmer)

    def calc_connected_graph_size(self, kmer, max_size=0,
                                  break_on_circumference=False):
        # khmer_tpu's wrapper does not pass break_on_circumference on
        return traversal.calc_connected_graph_size(self, kmer,
                                                   max_size=max_size)

    def traverse_from_kmer(self, kmer, radius, max_count=None):
        return traversal.traverse_from_kmer(self, kmer, radius,
                                            max_count=max_count)

    def count_kmers_within_radius(self, kmer, radius, max_count=0):
        return traversal.count_kmers_within_radius(self, kmer, radius,
                                                   max_count)

    def find_high_degree_nodes(self, sequence):
        return traversal.find_high_degree_nodes(self, sequence)

    def traverse_linear_path(self, kmer, hdns, stop_filter=None):
        """Walk the linear path from kmer, avoiding high-degree nodes;
        returns (size, adjacent-HDNs, visited) (graphs.pyx:608-622)."""
        adj = HashSet(self.ksize())
        visited = HashSet(self.ksize())
        size = traversal.traverse_linear_path(
            self, kmer, adj, visited, stop_filter, hdns=hdns)
        return size, adj, visited

    def extract_unique_paths(self, sequence, min_length, min_unique_f):
        return traversal.extract_unique_paths(self, sequence, min_length,
                                              min_unique_f)

    def assemble_linear_path(self, kmer, stop_filter=None):
        """The maximal linear path through kmer (graphs.pyx,
        khmer_tpu/graph.py:285)."""
        from khmer_tpu_torch.assembly import LinearAssembler

        return LinearAssembler(self, stop_filter).assemble(kmer)

    def get_tags_and_positions(self, sequence):
        """(pos, tag) pairs of sequence k-mers that are tags
        (graphs.pyx:638-648)."""
        return [(i + 1, h) for i, h in
                enumerate(self._hash_array(sequence).tolist())
                if h in self.all_tags]

    def get_tags_for_sequence(self, sequence):
        """HashSet of tags overlapping the sequence (graphs.pyx:650-656)."""
        hs = HashSet(self._ksize)
        for _, h in self.get_tags_and_positions(sequence):
            hs.add(h)
        return hs

    # -- stop-tag helpers --------------------------------------------------

    def trim_on_stoptags(self, sequence):
        return traversal.trim_on_stoptags(self, sequence)

    def identify_stoptags_by_position(self, sequence):
        """Positions of stop-tagged k-mers in the sequence
        (hashgraph.cc identify_stop_tags_by_position)."""
        stop = self.stop_tags
        return [i for i, h in enumerate(self._hash_array(sequence).tolist())
                if h in stop]

    def filter_if_present(self, infilename, outputfile):
        """Write reads containing NO already-present k-mer to
        outputfile (hashgraph.cc:902-949); READ_BATCH reads' counts in
        one K5 call."""
        batch = []

        def drain(out):
            for (name, seq), (_, counts) in zip(
                    batch, self._hash_count_rows([q for _, q in batch])):
                if not (counts > 0).any():
                    out.write(">{}\n{}\n".format(name, seq))
            batch.clear()

        with open(outputfile, "w") as out:
            for read in FastxReader(infilename):
                seq = read.cleaned_seq
                if len(seq) < self._ksize:
                    continue
                batch.append((read.name, seq))
                if len(batch) >= READ_BATCH:
                    drain(out)
            drain(out)

    # -- consumes of khmer's older API -------------------------------------

    def consume_seqfile_and_tag_with_reads_parser(self, parser):
        return self.consume_seqfile_and_tag(parser)

    def consume_partitioned_fasta(self, filename):
        """Load a partition-annotated FASTA (hashgraph.cc:635-690):
        reads named `...\\tPARTITION_ID`; tag the first k-mer of each
        read with its partition.  READ_BATCH reads go into the table in
        one K1 and one K2 call, in read order."""
        from khmer_tpu_torch.partitioning import SubsetPartition

        subset = SubsetPartition(self)
        n_reads = 0
        n_consumed = 0
        pending = []

        def flush():
            h, valid = self._row_hashes([q for q, _ in pending])
            flat = h[valid]
            self.storage.add_lanes(flat, torch.ones(
                flat.numel(), dtype=torch.int32, device=flat.device))
            for first, (_, pid) in zip(_u64.to_numpy(h[:len(pending), 0])
                                       .tolist(), pending):
                self.all_tags.add(first)
                if pid != 0:
                    subset.set_partition_id(first, pid)
            pending.clear()

        for read in self._reads(filename):
            n_reads += 1
            seq = read.cleaned_seq
            if len(seq) < self._ksize:
                continue
            name_parts = read.name.rsplit("\t", 1)
            try:
                if len(name_parts) != 2:
                    raise ValueError(
                        "invalid partitioned read name %r" % read.name)
                pid = int(name_parts[1])
            except ValueError:
                # the reads before this one are in, as in khmer_tpu
                if pending:
                    flush()
                raise
            pending.append((seq, pid))
            n_consumed += len(seq) - self._ksize + 1
            if len(pending) >= READ_BATCH:
                flush()
        if pending:
            flush()
        self.partition = subset
        return n_reads, n_consumed

    # -- khmer 1.x/2.x compat names ----------------------------------------

    def consume_fasta_and_tag(self, parser_or_filename):
        """1.x name for consume_seqfile_and_tag."""
        return self.consume_seqfile_and_tag(parser_or_filename)

    def consume_fasta_and_tag_with_reads_parser(self, parser):
        """1.x name for consume_seqfile_and_tag on an open parser."""
        return self.consume_seqfile_and_tag(parser)

    def consume_fasta_and_tag_with_stoptags(self, parser_or_filename):
        """1.x name for consume_seqfile_and_tag_with_stoptags."""
        return self.consume_seqfile_and_tag_with_stoptags(
            parser_or_filename)


class Countgraph(Hashgraph):
    """8-bit counting de Bruijn graph (2-bit exact hash, k <= 32)."""

    storage_class = ByteStorage


class SmallCountgraph(Hashgraph):
    """4-bit counting de Bruijn graph (khmer_tpu/graph.py:601): counts
    read at cap 15, saved two to a byte (SAVED_SMALLCOUNT)."""

    storage_class = NibbleStorage


class Nodegraph(Hashgraph):
    """Presence/absence (Bloom) de Bruijn graph."""

    storage_class = BitStorage

    def update(self, other):
        """Union with another same-shaped Nodegraph (graphs.pyx name)."""
        if self.ksize() != other.ksize():
            raise ValueError(
                "both nodegraphs must have the same k size")
        self.storage.update_from(other.storage)

    update_from = update

"""de Bruijn graph tables: Hashgraph, with Countgraph, SmallCountgraph
and Nodegraph.

Port of khmer_tpu/graph.py:23-619, the tag and partition surface that
load-graph, partition-graph, merge-partitions and annotate-partitions
use: tags and stop tags, consume-and-tag, tagset and stoptags files,
subset partitions and partition maps.  Traversal queries (degree,
neighbours, linear paths, assembly) and the stop-tag helpers come with
a later slice of the port.

Tagging takes each batch of reads through one K1 pass over their padded
rows and one Storage.add_lanes call (K2) in read and k-mer order, whose
per-lane was-new flags carry the reference's sequential semantics
whatever the batch; the sequential tag rule then runs on the host over
those flags, as in khmer_tpu.
"""

import torch

from khmer_tpu_torch import _u64
from khmer_tpu_torch._config import DEFAULT_TAG_DENSITY
from khmer_tpu_torch.hashtable import Hashtable, _pad_rows
from khmer_tpu_torch.io import oxli_format
from khmer_tpu_torch.io.fastx import FastxReader
from khmer_tpu_torch.ops.hashing import kmer_hashes_2bit
from khmer_tpu_torch.storage import BitStorage, ByteStorage, NibbleStorage

# reads per consume-and-tag batch; any batch tags the same k-mers
TAG_BATCH = 16384


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

    def _consume_and_tag_batch(self, seqs, found_tags=None):
        """consume_and_tag over several reads: their k-mers go into the
        table in one add_lanes call, in read and k-mer order."""
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
            self._tag_from_hashes(hashes[off: off + n],
                                  isnew[off: off + n], found_tags)
            off += n
        return int(isnew.sum())

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
        616-633)."""
        return sorted(self.all_tags)[::subset_size]


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

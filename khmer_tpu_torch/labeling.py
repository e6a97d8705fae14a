"""Sparse tag labeling: GraphLabels / LabelHash.

Port of khmer_tpu/labeling.py (reference src/oxli/labelhash.cc +
include/oxli/labelhash.hh, Cython facade khmer/_oxli/labeling.pyx).  Tags
(sparse waypoints every tag_density k-mers) carry multi-labels through a
tag<->label multimap; label queries sweep the tag neighborhood of a read
and union the labels found.

khmer_tpu consumes a labelled file one read at a time; here a batch of
reads goes into the table in one K1 pass and one add_lanes call (K2) in
read and k-mer order, whose was-new flags are the sequential ones, and
the tag rule then runs read by read on the host with each read's found
tags linked to its label (Hashgraph._consume_and_tag_batch).  A batch of
sweeps takes one count probe a level (SubsetPartition.sweep_for_tags_batch).
"""

import struct

from khmer_tpu_torch.hashset import HashSet
from khmer_tpu_torch.io.oxli_format import (OxliFileError,
                                            SAVED_FORMAT_VERSION,
                                            SAVED_LABELSET, SAVED_SIGNATURE)

# reads consumed together; any batch links the same tags and labels
LABEL_BATCH = 16384


class GraphLabels:
    """Tag<->label multimap over a Hashgraph (labeling.pyx:10)."""

    def __init__(self, graph):
        self.graph = graph
        self.tag_labels = {}  # tag hash -> set of labels
        self.label_tag = {}  # label -> set of tags
        self.all_labels = set()

    def _default_sweep_radius(self):
        return 2 * self.graph.tag_density + 1

    @property
    def n_labels(self):
        return len(self.all_labels)

    def labels(self):
        return list(sorted(self.all_labels))

    def add_tag(self, kmer):
        self.graph.add_tag(kmer)

    def reverse_hash(self, h):
        return self.graph.reverse_hash(h)

    def link_tag_and_label(self, tag, label):
        """(labelhash.cc:206-214; accepts a k-mer string or a hash)"""
        tag = self.graph.hash(tag) if isinstance(tag, str) else int(tag)
        label = int(label)
        self.tag_labels.setdefault(tag, set()).add(label)
        self.label_tag.setdefault(label, set()).add(tag)
        self.all_labels.add(label)

    def get_tag_labels(self, tag):
        """(labelhash.cc:332-338)"""
        tag = int(tag) if not isinstance(tag, str) else \
            self.graph.hash(tag)
        if tag not in self.graph.all_tags:
            return []
        return sorted(self.tag_labels.get(tag, ()))

    def get_tags_from_label(self, label):
        return sorted(self.label_tag.get(int(label), ()))

    # -- consuming --------------------------------------------------------

    def consume_sequence_and_tag_with_labels(self, sequence, label):
        """(labelhash.cc:216-306): the tag rule of
        consume_sequence_and_tag, with every dropped or re-seen tag
        linked to `label`."""
        found_tags = set()
        n_consumed = self.graph.consume_and_tag(
            sequence, found_tags=found_tags)
        for tag in found_tags:
            self.link_tag_and_label(tag, label)
        return n_consumed

    def _consume_labelled(self, pending):
        """Consume and tag a batch of (sequence, label) pairs, each read's
        found tags linked to its label; returns the new k-mers."""
        read_tags = []
        n_consumed = self.graph._consume_and_tag_batch(
            [seq for seq, _ in pending], read_tags=read_tags)
        for found, (_, label) in zip(read_tags, pending):
            for tag in found:
                self.link_tag_and_label(tag, label)
        pending.clear()
        return n_consumed

    def consume_seqfile_and_tag_with_labels(self, filename):
        """One label per READ sequence, counting up from 0
        (labelhash.cc:84-140); a read shorter than k takes a label too.
        Returns (n_reads, new k-mers)."""
        k = self.graph.ksize()
        n_reads = 0
        n_consumed = 0
        pending = []
        for label, read in enumerate(self.graph._reads(filename)):
            seq = read.cleaned_seq
            n_reads += 1
            if len(seq) >= k:
                pending.append((seq, label))
            if len(pending) >= LABEL_BATCH:
                n_consumed += self._consume_labelled(pending)
        if pending:
            n_consumed += self._consume_labelled(pending)
        return n_reads, n_consumed

    def consume_partitioned_fasta_and_tag_with_labels(self, filename):
        """Label = partition id parsed from the read name
        (labelhash.cc:143-204); a bad name raises once the reads before
        it are in, as in khmer_tpu.  Returns (n_reads, new k-mers)."""
        k = self.graph.ksize()
        n_reads = 0
        n_consumed = 0
        pending = []
        for read in self.graph._reads(filename):
            seq = read.cleaned_seq
            n_reads += 1
            if len(seq) < k:
                continue
            name_parts = read.name.rsplit("\t", 1)
            try:
                if len(name_parts) != 2:
                    raise ValueError(
                        "invalid partitioned read name %r" % read.name)
                label = int(name_parts[1])
            except ValueError:
                if pending:
                    self._consume_labelled(pending)
                raise
            pending.append((seq, label))
            if len(pending) >= LABEL_BATCH:
                n_consumed += self._consume_labelled(pending)
        if pending:
            n_consumed += self._consume_labelled(pending)
        return n_reads, n_consumed

    def label_across_high_degree_nodes(self, sequence, hdns, label):
        """Tag+label the HDN and both flanking k-mers
        (labelhash.cc:604-641; HDNs at sequence ends are ignored)."""
        hashes = self.graph._hash_array(sequence).tolist()
        hset = set(int(h) for h in hdns)
        for i in range(1, len(hashes) - 1):
            if hashes[i] in hset:
                for t in hashes[i - 1: i + 2]:
                    self.graph.add_tag(t)
                    self.link_tag_and_label(t, label)

    # -- sweeps -----------------------------------------------------------

    def _radius(self, radius):
        """radius=None means the default sweep radius of
        2 * tag_density + 1 (labeling.pyx:16-18)."""
        return self._default_sweep_radius() if radius is None else radius

    def sweep_tag_neighborhood(self, sequence, radius=0,
                               break_on_stoptags=False,
                               stop_big_traversals=False):
        """Tags within `radius` of the read (labeling.pyx:56-73)."""
        tags = self.graph.partition.sweep_for_tags(
            sequence, range_=self._radius(radius),
            break_on_stop_tags=break_on_stoptags,
            stop_big_traversals=stop_big_traversals)
        hs = HashSet(self.graph.ksize())
        hs.update(tags)
        return hs

    def _labels_of(self, tags):
        found = set()
        for tag in tags:
            found.update(self.tag_labels.get(int(tag), ()))
        return sorted(found)

    def sweep_label_neighborhood(self, sequence, radius=0,
                                 break_on_stoptags=False,
                                 stop_big_traversals=False):
        """Labels on tags within `radius` of the read
        (labelhash.cc:309-330; radius=None -> default sweep radius)."""
        return self._labels_of(self.sweep_tag_neighborhood(
            sequence, radius, break_on_stoptags, stop_big_traversals))

    def sweep_label_neighborhood_batch(self, sequences, radius=0,
                                       break_on_stoptags=False,
                                       stop_big_traversals=False):
        """sweep_label_neighborhood of every sequence, read for read, with
        one count probe a level for the batch."""
        found = self.graph.partition.sweep_for_tags_batch(
            sequences, self._radius(radius), break_on_stoptags,
            stop_big_traversals)
        return [self._labels_of(tags) for tags in found]

    def get_labels_for_sequence(self, sequence):
        """Labels of tags directly on the read (labelhash.cc:342-367)."""
        all_tags = self.graph.all_tags
        return self._labels_of(
            h for h in self.graph._hash_array(sequence).tolist()
            if h in all_tags)

    def assemble_labeled_path(self, seed):
        from khmer_tpu_torch.assembly import SimpleLabeledAssembler

        return SimpleLabeledAssembler(self).assemble(seed)

    # -- persistence (labelhash.cc:400-470; byte layout: OXLI header |
    # u32 ksize | u64 n_pairs | n * (u64 tag, u64 label)) ----------------

    def save_labels_and_tags(self, filename):
        with open(filename, "wb") as f:
            f.write(SAVED_SIGNATURE)
            f.write(struct.pack("BB", SAVED_FORMAT_VERSION, SAVED_LABELSET))
            f.write(struct.pack("<I", self.graph.ksize()))
            n = sum(len(s) for s in self.tag_labels.values())
            f.write(struct.pack("<Q", n))
            for tag in sorted(self.tag_labels):
                for label in sorted(self.tag_labels[tag]):
                    f.write(struct.pack("<QQ", tag, label))

    def load_labels_and_tags(self, filename):
        try:
            self._load_labels_and_tags(filename)
        except (IndexError, struct.error) as err:
            # truncated stream: any parse overrun is a file error
            # (reference labelhash.cc load throws oxli_file_exception)
            raise OSError("truncated labels/tags file {!r}: {}".format(
                filename, err))

    def _load_labels_and_tags(self, filename):
        with open(filename, "rb") as f:
            data = f.read()
        if len(data) < 6:
            raise OxliFileError(
                "truncated labels/tags header in " + filename)
        if data[:4] != SAVED_SIGNATURE:
            raise OxliFileError(
                "Incorrect file signature while reading labels/tags "
                "from " + filename)
        if data[4] != SAVED_FORMAT_VERSION:
            raise OxliFileError(
                "Incorrect file format version while reading labels/tags "
                "from " + filename)
        if data[5] != SAVED_LABELSET:
            raise OxliFileError(
                "Incorrect file format type while reading labels/tags "
                "from " + filename)
        (ksize,) = struct.unpack_from("<I", data, 6)
        if ksize != self.graph.ksize():
            raise OxliFileError(
                "Incorrect k-mer size while reading labels/tags from "
                + filename)
        (n,) = struct.unpack_from("<Q", data, 10)
        off = 18
        for _ in range(n):
            tag, label = struct.unpack_from("<QQ", data, off)
            off += 16
            self.graph.add_tag(int(tag))
            self.link_tag_and_label(tag, label)

    @staticmethod
    def load(filename, graph):
        gl = GraphLabels(graph)
        gl.load_labels_and_tags(filename)
        return gl


# reference exposes LabelHash as an alias of the graph-labels facade
LabelHash = GraphLabels


def NodeGraphLabels(k, starting_size, n_tables, primes=None, device=None):
    from khmer_tpu_torch.graph import Nodegraph

    return GraphLabels(Nodegraph(k, starting_size, n_tables, primes=primes,
                                 device=device))


def CountGraphLabels(k, starting_size, n_tables, primes=None, device=None):
    from khmer_tpu_torch.graph import Countgraph

    return GraphLabels(Countgraph(k, starting_size, n_tables, primes=primes,
                                  device=device))


# labeling.pyx exposes these as GraphLabels staticmethods
GraphLabels.NodeGraphLabels = staticmethod(NodeGraphLabels)
GraphLabels.CountGraphLabels = staticmethod(CountGraphLabels)

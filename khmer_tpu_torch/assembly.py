"""Assemblers: LinearAssembler, SimpleLabeledAssembler,
JunctionCountAssembler.

Port of khmer_tpu/assembly.py (reference src/oxli/assembler.cc +
include/oxli/assembler.hh, AssemblerTraverser::next_symbol in
src/oxli/traversal.cc, Cython facade khmer/_oxli/assembly.pyx).

The unitig walk is sequential by nature: each step reads the counts of
the cursor's four neighbours, whose (f, r) pairs are computed on the
host.  Reading them on the device would put a round trip (K3 and a copy
back) in every step; the graph does not change during an assemble, so
the walk reads its counts from the table's host snapshot
(Storage.host_counts: the min over tables capped at the read cap, as K3
reads them), which add_lanes keeps coherent; a stop filter is read the
same way.  JunctionCountAssembler.consume reads the degrees of every
k-mer of a read in one probe (K3) and adds the read's junctions in one
add_batch call (K2), not one add a junction: the adds commute and their
was-new flags are not read.
"""

import numpy as np

from khmer_tpu_torch import _u64
from khmer_tpu_torch.ops import encode as enc
from khmer_tpu_torch.ops.hashing import reverse_hash
from khmer_tpu_torch.traversal import _probe, _seed, _window_fr

_BASES = "ACGT"
# khmer twobit codes are A=0 T=1 C=2 G=3; neighbor arrays are indexed
# by code, but DNA_SIMPLE iteration order (ACGT) decides ties -- with
# the >1-found early stop the result is order-independent.
_CODE_OF = {"A": 0, "C": 2, "G": 3, "T": 1}


def _neighbor_pairs(f, r, k, direction):
    """The cursor's four neighbours in one direction, by 2-bit code, as
    (f, r) integer pairs (reference traversal.cc:88-113)."""
    bitmask = (1 << (2 * k)) - 1
    shift = 2 * k - 2
    if direction == "right":
        return [(((f << 2) & bitmask) | c, (r >> 2) | ((c ^ 1) << shift))
                for c in range(4)]
    return [((f >> 2) | (c << shift), ((r << 2) & bitmask) | (c ^ 1))
            for c in range(4)]


class _Cursor:
    """AssemblerTraverser state: (f, r) cursor + shared visited set."""

    __slots__ = ("f", "r", "visited", "filters")

    def __init__(self, f, r, visited, filters=()):
        self.f = f
        self.r = r
        self.visited = visited
        self.filters = list(filters)


class LinearAssembler:
    """Maximal linear path through the seed (assembler.cc:52-168)."""

    def __init__(self, graph, stop_filter=None):
        self.graph = graph
        self.stop_filter = stop_filter

    def set_stop_filter(self, stop_filter=None):
        self.stop_filter = stop_filter

    # -- core -------------------------------------------------------------

    def _neighbors(self, cursor, direction):
        """Existing, unvisited, unfiltered neighbors of the cursor.

        Returns list of (f, r, canon, base_char)."""
        pairs = _neighbor_pairs(cursor.f, cursor.r, self.graph.ksize(),
                                direction)
        canon = [min(p) for p in pairs]
        counts = _counts(self.graph, canon)
        if self.stop_filter is not None:
            stop_counts = _counts(self.stop_filter, canon)
        out = []
        for base in _BASES:  # DNA_SIMPLE iteration order
            code = _CODE_OF[base]
            if counts[code] == 0:
                continue
            c = canon[code]
            if c in cursor.visited:
                continue
            if self.stop_filter is not None and stop_counts[code]:
                continue
            if any(flt(c) for flt in cursor.filters):
                continue
            out.append((*pairs[code], c, base))
        return out

    def _next_symbol(self, cursor, direction):
        """One step of AssemblerTraverser::next_symbol
        (traversal.cc): stop on 0 or >1 found neighbors."""
        cursor.visited.add(min(cursor.f, cursor.r))
        found = self._neighbors(cursor, direction)
        if len(found) != 1:
            return None
        f, r, _, base = found[0]
        cursor.f, cursor.r = f, r
        return base

    def _assemble_directed(self, cursor, direction):
        bases = []
        while True:
            base = self._next_symbol(cursor, direction)
            if base is None:
                break
            bases.append(base)
        return bases

    def _contig(self, cursor, direction):
        start = reverse_hash(cursor.f, self.graph.ksize())
        bases = self._assemble_directed(cursor, direction)
        if direction == "right":
            return start + "".join(bases)
        return "".join(reversed(bases)) + start

    # -- public -----------------------------------------------------------

    def assemble(self, seed):
        f, r = _seed(self.graph, seed)
        if _counts(self.graph, [min(f, r)])[0] == 0:
            return ""
        visited = set()
        right_contig = self._contig(_Cursor(f, r, visited), "right")
        left_contig = self._contig(_Cursor(f, r, visited), "left")
        return left_contig + right_contig[self.graph.ksize():]

    def assemble_right(self, seed):
        f, r = _seed(self.graph, seed)
        return self._contig(_Cursor(f, r, set()), "right")

    def assemble_left(self, seed):
        f, r = _seed(self.graph, seed)
        return self._contig(_Cursor(f, r, set()), "left")


class _BranchingAssembler:
    """Linear assembly that goes on past a high-degree node into the
    branches its filter lets through (assembler.cc:185-533)."""

    def __init__(self, graph, stop_filter=None):
        self.graph = graph
        self.stop_filter = stop_filter
        self.linear_asm = LinearAssembler(graph, stop_filter)

    def set_stop_filter(self, stop_filter=None):
        self.stop_filter = stop_filter
        self.linear_asm.stop_filter = stop_filter

    def _branch_filter(self, cursor):
        """The filter of the branches at the cursor, a high-degree node;
        None: end the path here."""
        raise NotImplementedError

    def _assemble_directed(self, start_cursor, direction):
        la = self.linear_asm
        paths = []
        root_contig = la._contig(start_cursor, direction)
        stack = [(root_contig, start_cursor)]
        k = self.graph.ksize()
        while stack:
            segment, cursor = stack.pop()
            if _degree(self.graph, cursor) <= 1:
                paths.append(segment)
                continue
            flt = self._branch_filter(cursor)
            if flt is None:
                paths.append(segment)
                continue
            cursor.filters.append(flt)
            branch_starts = la._neighbors(cursor, direction)
            cursor.filters.pop()
            if not branch_starts:
                paths.append(segment)
                continue
            for f, r, _, _ in branch_starts:
                bc = _Cursor(f, r, cursor.visited, cursor.filters)
                branch = la._contig(bc, direction)
                if direction == "right":
                    new_segment = segment + branch[k - 1:]
                else:
                    new_segment = branch[: len(branch) - (k - 1)] + segment
                stack.append((new_segment, bc))
        return paths

    def assemble(self, seed):
        f, r = _seed(self.graph, seed)
        visited = set()
        right_paths = self._assemble_directed(
            _Cursor(f, r, visited), "right")
        left_paths = self._assemble_directed(
            _Cursor(f, r, visited), "left")
        k = self.graph.ksize()
        return [left + right[k:] for left in left_paths
                for right in right_paths]


class SimpleLabeledAssembler(_BranchingAssembler):
    """Linear assembly that hops high-degree nodes when a label spans
    them (assembler.cc:185-344)."""

    def __init__(self, labels, stop_filter=None):
        super().__init__(labels.graph, stop_filter)
        self.labels = labels

    def _label_intersect_filter(self, src_labels, min_cov=5):
        """(kmer_filters.cc get_simple_label_intersect_filter): filter
        OUT label-disjoint branches, and putative tips (dst carries
        exactly the one shared label) -- but the tip heuristic only
        fires at label coverage >= min_cov (default 5,
        kmer_filters.hh:61), so low-coverage bubbles keep both
        branches."""
        lh = self.labels
        src = set(src_labels)

        def flt(canon):
            dst = set(lh.get_tag_labels(canon))
            inter = src & dst
            if len(inter) == 1 and len(dst) == 1 and len(src) >= min_cov:
                return True  # putative tip
            if inter:
                return False
            return True

        return flt

    def _branch_filter(self, cursor):
        labels = self.labels.get_tag_labels(min(cursor.f, cursor.r))
        return self._label_intersect_filter(labels) if labels else None


class JunctionCountAssembler(_BranchingAssembler):
    """Linear assembly that crosses junctions seen often enough in the
    reads (assembler.cc:346-533)."""

    def __init__(self, graph, stop_filter=None):
        from khmer_tpu_torch.graph import Countgraph

        super().__init__(graph, stop_filter)
        self.junctions = Countgraph(graph.ksize(), primes=graph.hashsizes(),
                                    device=graph.device)

    def count_junction(self, canon_a, canon_b):
        self.junctions.storage.add(int(canon_a) ^ int(canon_b))

    def get_junction_count(self, canon_a, canon_b):
        return self.junctions.storage.get(int(canon_a) ^ int(canon_b))

    def consume(self, sequence):
        """Count junctions around high-degree nodes of the read
        (assembler.cc:359-396): the degrees of its k-mers in one probe,
        its junctions in one add_batch call.  Returns their number."""
        self.graph.consume(sequence)
        k = self.graph.ksize()
        hashes = self.graph._hash_array(sequence)
        if hashes.shape[0] < 2:
            return 0
        f, r = _window_fr(enc.encode_sequence(sequence), k)
        dev = self.graph.device
        degs = _probe(self.graph, _u64.as_tensor(f, dev),
                      _u64.as_tensor(r, dev), k)[3].sum(1).cpu().numpy()
        hi = degs > 2
        at = np.nonzero(hi[:-1] | hi[1:])[0]
        if at.size:
            self.junctions.storage.add_batch(hashes[at] ^ hashes[at + 1])
        return int(at.size)

    def _junction_filter(self, prev_canon):
        def flt(canon):
            return self.get_junction_count(prev_canon, canon) < 2

        return flt

    def _branch_filter(self, cursor):
        return self._junction_filter(min(cursor.f, cursor.r))


def _counts(graph, canon):
    """Counts of canonical hashes (ints) from the graph's host snapshot."""
    return graph.storage.host_counts(np.array(canon, np.uint64))


def _degree(graph, cursor):
    """Existing neighbours of the cursor, both directions
    (kmer_degree_fr)."""
    k = graph.ksize()
    pairs = _neighbor_pairs(cursor.f, cursor.r, k, "right") + \
        _neighbor_pairs(cursor.f, cursor.r, k, "left")
    return int((_counts(graph, [min(p) for p in pairs]) > 0).sum())

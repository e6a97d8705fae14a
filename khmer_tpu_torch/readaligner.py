"""ReadAligner: graph-guided read error correction via a 6-state
pair-HMM A* search.

Port of khmer_tpu/readaligner.py (reference src/oxli/read_aligner.cc +
include/oxli/read_aligner.hh: states MATCH/INSERT_READ/INSERT_GRAPH x
trusted/untrusted, the published transition log-probabilities at
read_aligner.hh:105-117, the best-first Subalign with its closed-map
quirks; the Cython facade khmer/_oxli/readaligner.pyx).

The search is sequential pointer-chasing.  It runs in the native core
(native/read_aligner.cc, a copy of khmer_tpu's) against the host count
snapshot of the table (Storage.host_counts), which add_lanes keeps
coherent, so an expansion costs no device round trip; the Python search
(_subalign_py) runs only when a path overflows the native core's output
arrays, as in khmer_tpu.  align_many hashes all its reads in one K1
call.
"""

import ctypes
import heapq
import math

import numpy as np

from khmer_tpu_torch import _u64
from khmer_tpu_torch.native import get_lib
from khmer_tpu_torch.ops.hashing import hash_2bit_scalar

# states (read_aligner.hh:60-62)
MATCH, INSERT_READ, INSERT_GRAPH, \
    MATCH_UNTRUSTED, INSERT_READ_UNTRUSTED, INSERT_GRAPH_UNTRUSTED = range(6)

# transitions (read_aligner.hh:65-71)
(MM, MIr, MIg, MMu, MIru, MIgu,
 IrM, IrIr, IrMu, IrIru,
 IgM, IgIg, IgMu, IgIgu,
 MuM, MuIr, MuIg, MuMu, MuIru, MuIgu,
 IruM, IruIr, IruMu, IruIru,
 IguM, IguIg, IguMu, IguIgu,
 DISALLOWED) = range(29)

_log2 = math.log2

# trained transition log-probabilities (read_aligner.hh:105-117)
TRANS_DEFAULT = [
    _log2(0.9848843), _log2(0.0000735), _log2(0.0000334),
    _log2(0.0150068), _log2(0.0000017), _log2(0.0000003),   # M_t
    _log2(0.5196194), _log2(0.4647955), _log2(0.0059060),
    _log2(0.0096792),                                       # Ir_t
    _log2(0.7611255), _log2(0.2294619), _log2(0.0072673),
    _log2(0.0021453),                                       # Ig_t
    _log2(0.0799009), _log2(0.0000262), _log2(0.0001836),
    _log2(0.9161349), _log2(0.0033370), _log2(0.0004173),   # M_u
    _log2(0.1434529), _log2(0.0036995), _log2(0.2642928),
    _log2(0.5885548),                                       # Ir_u
    _log2(0.1384551), _log2(0.0431328), _log2(0.6362921),
    _log2(0.1821200),                                       # Ig_u
]

# emission/frequency scores (read_aligner.hh:119-122)
FREQ_DEFAULT = [_log2(0.955), _log2(0.04), _log2(0.004), _log2(0.001)]

_BACKGROUND_PROB = 0.0

_NUCL = "ACGT"
_NUCL_BYTES = np.frombuffer(b"ACGT", np.uint8)
_NUCL_CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}

# transition lookup table indexed (from_state, to_state)
_TRANS_TABLE = [[DISALLOWED] * 6 for _ in range(6)]
for _row, _pairs in {
    MATCH: [(MATCH, MM), (INSERT_GRAPH, MIg), (INSERT_READ, MIr),
            (MATCH_UNTRUSTED, MMu), (INSERT_GRAPH_UNTRUSTED, MIgu),
            (INSERT_READ_UNTRUSTED, MIru)],
    INSERT_GRAPH: [(MATCH, IgM), (INSERT_GRAPH, IgIg),
                   (MATCH_UNTRUSTED, IgMu),
                   (INSERT_GRAPH_UNTRUSTED, IgIgu)],
    INSERT_READ: [(MATCH, IrM), (INSERT_READ, IrIr),
                  (MATCH_UNTRUSTED, IrMu),
                  (INSERT_READ_UNTRUSTED, IrIru)],
    MATCH_UNTRUSTED: [(MATCH, MuM), (INSERT_GRAPH, MuIg),
                      (INSERT_READ, MuIr), (MATCH_UNTRUSTED, MuMu),
                      (INSERT_GRAPH_UNTRUSTED, MuIgu),
                      (INSERT_READ_UNTRUSTED, MuIru)],
    INSERT_GRAPH_UNTRUSTED: [(MATCH, IguM), (INSERT_GRAPH, IguIg),
                             (MATCH_UNTRUSTED, IguMu),
                             (INSERT_GRAPH_UNTRUSTED, IguIgu)],
    INSERT_READ_UNTRUSTED: [(MATCH, IruM), (INSERT_READ, IruIr),
                            (MATCH_UNTRUSTED, IruMu),
                            (INSERT_READ_UNTRUSTED, IruIru)],
}.items():
    for _to, _tr in _pairs:
        _TRANS_TABLE[_row][_to] = _tr


def _get_null(length):
    """Null-model score (read_aligner.cc:103-106)."""
    return _log2(0.25) * length + _log2(1.0 / (length + 1))


class _Node:
    __slots__ = ("prev", "base", "seq_idx", "state", "trans", "fwd", "rc",
                 "score", "f_score", "h_score", "trusted", "cov",
                 "num_indels", "length")

    def __init__(self, prev, base, seq_idx, state, trans, fwd, rc, length):
        self.prev = prev
        self.base = base
        self.seq_idx = seq_idx
        self.state = state
        self.trans = trans
        self.fwd = fwd
        self.rc = rc
        self.score = 0.0
        self.f_score = 0.0
        self.h_score = 0.0
        self.trusted = False
        self.cov = 0
        self.num_indels = 0
        self.length = length


class Alignment:
    """Result record (read_aligner.hh:210-217)."""

    def __init__(self, score, graph_alignment, read_alignment, trusted="",
                 covs=None, truncated=True):
        self.score = score
        self.graph_alignment = graph_alignment
        self.read_alignment = read_alignment
        self.trusted = trusted
        self.covs = covs or []
        self.truncated = truncated


def _empty_alignment():
    return Alignment(-math.inf, "", "", truncated=True)


class ReadAligner:
    """A*-guided pair-HMM alignment of a read against a Countgraph."""

    def __init__(self, count_graph, trusted_cov_cutoff=2, bits_theta=1.0,
                 scoring_matrix=None, transitions=None,
                 transition_probabilities=None, filename=None):
        self.graph = count_graph
        self.k = count_graph.ksize()
        self.bitmask = (1 << (2 * self.k)) - 1
        self.rc_left_shift = 2 * self.k - 2
        self.trusted_cutoff = trusted_cov_cutoff
        self.bits_theta = bits_theta
        if filename is not None:
            # params-file constructor (readaligner.pyx / _cpy_khmer.cc
            # ReadAligner init with a JSON file of scoring_matrix +
            # per-state transition_probabilities)
            import json

            with open(filename) as fp:
                params = json.load(fp)
            scoring_matrix = params["scoring_matrix"]
            transition_probabilities = params["transition_probabilities"]
        if scoring_matrix is None:
            scoring_matrix = FREQ_DEFAULT
        (self.trusted_match, self.trusted_mismatch,
         self.untrusted_match, self.untrusted_mismatch) = scoring_matrix
        if transition_probabilities is not None:
            # nested per-from-state shape (M_t, Ir_t, Ig_t, M_u, Ir_u,
            # Ig_u) — the reference's public API shape
            self.tsc = [float(x) for grp in transition_probabilities
                        for x in grp]
        elif transitions is not None:
            self.tsc = list(transitions)
        else:
            self.tsc = list(TRANS_DEFAULT)
        # the native core's table geometry and transition scores, and its
        # output arrays
        self._native_args = None
        self._native_out = None

    # -- count access ------------------------------------------------------

    def _count(self, h):
        return int(self.graph.storage.host_counts([h])[0])

    def _counts4(self, hashes):
        return self.graph.storage.host_counts(hashes)

    # -- neighbor arithmetic (2.x next_f/next_r/prev_f/prev_r) -------------

    def _next(self, fwd, rc, code):
        nf = ((fwd << 2) & self.bitmask) | code
        nr = (rc >> 2) | ((code ^ 1) << self.rc_left_shift)
        return nf, nr

    def _prev(self, fwd, rc, code):
        pf = (fwd >> 2) | (code << self.rc_left_shift)
        pr = ((rc << 2) & self.bitmask) | (code ^ 1)
        return pf, pr

    # -- A* search ---------------------------------------------------------

    def _enumerate(self, open_heap, counter, curr, forward, seq):
        if forward:
            next_seq_idx = curr.seq_idx + 1
            if next_seq_idx >= len(seq):
                return
            remaining = len(seq) - next_seq_idx
        else:
            next_seq_idx = curr.seq_idx - 1
            remaining = next_seq_idx

        # 4 neighbor k-mers, coverage in one host-snapshot lookup
        cands = []
        hashes = []
        for i, nucl in enumerate(_NUCL):
            code = {"A": 0, "C": 2, "G": 3, "T": 1}[nucl]  # khmer twobit
            if forward:
                nf, nr = self._next(curr.fwd, curr.rc, code)
            else:
                nf, nr = self._prev(curr.fwd, curr.rc, code)
            cands.append((i, nucl, nf, nr))
            hashes.append(min(nf, nr))
        covs = self._counts4(hashes)

        for (i, nucl, nf, nr), cov in zip(cands, covs):
            cov = int(cov)
            if cov == 0:
                continue
            if cov < self.trusted_cutoff:
                start_state, end_state = (MATCH_UNTRUSTED,
                                          INSERT_GRAPH_UNTRUSTED)
                match_sc = self.trusted_match
                mismatch_sc = self.trusted_mismatch
            else:
                start_state, end_state = MATCH, INSERT_GRAPH
                match_sc = self.trusted_match
                mismatch_sc = self.trusted_mismatch

            for next_state in range(start_state, end_state + 1):
                trans = _TRANS_TABLE[curr.state][next_state]
                if trans == DISALLOWED:
                    continue
                hcost = self.tsc[_TRANS_TABLE[next_state][MATCH]] + \
                    (self.tsc[MM] + self.trusted_match) * \
                    (0 if remaining == 0 else remaining - 1)
                if next_state in (MATCH, MATCH_UNTRUSTED):
                    sc = match_sc if nucl == seq[next_seq_idx] \
                        else mismatch_sc
                else:
                    sc = _BACKGROUND_PROB

                if next_state in (MATCH, MATCH_UNTRUSTED):
                    nxt = _Node(curr, i, next_seq_idx, next_state, trans,
                                nf, nr, curr.length + 1)
                    nxt.num_indels = curr.num_indels
                elif next_state in (INSERT_READ, INSERT_READ_UNTRUSTED):
                    nxt = _Node(curr, i, next_seq_idx, next_state, trans,
                                curr.fwd, curr.rc, curr.length + 1)
                    nxt.num_indels = curr.num_indels + 1
                else:  # INSERT_GRAPH(_UNTRUSTED)
                    nxt = _Node(curr, i, curr.seq_idx, next_state, trans,
                                nf, nr, curr.length)
                    nxt.num_indels = curr.num_indels + 1

                nxt.score = curr.score + sc + self.tsc[trans]
                nxt.trusted = cov >= self.trusted_cutoff
                nxt.cov = cov
                nxt.h_score = hcost
                nxt.f_score = nxt.score + nxt.h_score

                if nxt.num_indels < 3 and \
                        nxt.score - _get_null(nxt.length) > \
                        nxt.length * self.bits_theta:
                    counter[0] += 1
                    heapq.heappush(open_heap, (-nxt.f_score, counter[0],
                                               nxt))

    def _subalign(self, start, seq_len, forward, seq):
        native = self._native_subalign(start, seq_len, forward, seq)
        if native is not None:
            return native
        return self._subalign_py(start, seq_len, forward, seq)

    def _native_subalign(self, start, seq_len, forward, seq):
        """Run the Subalign through the native core against the host
        snapshot of the table; None when the best path overflows the
        output arrays (khmer_tpu then runs the Python search)."""
        lib = get_lib()
        st = self.graph.storage
        table = st.host_table()
        if self._native_args is None:
            self._native_args = (
                np.ascontiguousarray(st.spec.tablesizes, np.uint64),
                np.ascontiguousarray(st.spec.bin_offsets, np.int64),
                np.ascontiguousarray(self.tsc, np.float64))
        sizes, offs, tsc = self._native_args
        cap = 4 * (seq_len + 16)
        out = self._native_out
        if out is None or out[0].size < cap:
            out = self._native_out = tuple(
                np.empty(cap, t) for t in (np.int8, np.int8, np.int32,
                                           np.uint8, np.uint32))
        o_state, o_base, o_idx, o_trust, o_cov = out
        score = ctypes.c_double()
        trunc = ctypes.c_int()
        end_idx = ctypes.c_int32()
        seqb = seq.encode("ascii")
        n = lib.ra_subalign(
            table.ctypes.data, sizes.ctypes.data, offs.ctypes.data,
            len(sizes), int(st.read_cap()), tsc.ctypes.data,
            self.trusted_match, self.trusted_mismatch, self.bits_theta,
            self.trusted_cutoff, self.k, seqb, seq_len, start.base,
            start.seq_idx, start.score, start.fwd, start.rc,
            1 if forward else 0, cap, o_state.ctypes.data,
            o_base.ctypes.data, o_idx.ctypes.data, o_trust.ctypes.data,
            o_cov.ctypes.data, ctypes.byref(score), ctypes.byref(trunc),
            ctypes.byref(end_idx))
        if n < 0:
            return None  # path overflow: khmer_tpu's Python search
        # the path comes best node first: forward alignments read it
        # backward (khmer_tpu's per-node loop, as array operations)
        order = slice(n - 1, None, -1) if forward else slice(0, n)
        state = o_state[:n][order]
        match = (state == MATCH) | (state == MATCH_UNTRUSTED)
        ins_read = (state == INSERT_READ) | (state == INSERT_READ_UNTRUSTED)
        nucl = _NUCL_BYTES[o_base[:n][order]]
        read = np.frombuffer(seqb, np.uint8)[
            np.clip(o_idx[:n][order], 0, seq_len - 1)]
        dash = np.uint8(ord("-"))
        graph_alignment = np.where(match, nucl, np.where(
            ins_read, dash, nucl | 0x20)).tobytes().decode()
        read_alignment = np.where(match, read, np.where(
            ins_read, read | 0x20, dash)).tobytes().decode()
        trusted = np.where(o_trust[:n][order] != 0, np.uint8(ord("T")),
                           np.uint8(ord("F"))).tobytes().decode()
        covs = o_cov[:n][order].tolist() if forward else []
        truncated = bool(trunc.value)
        if truncated:
            if forward:
                graph_alignment = graph_alignment + \
                    seq[end_idx.value + 1:]
            else:
                graph_alignment = seq[: start.seq_idx] + graph_alignment
        return Alignment(score.value, graph_alignment, read_alignment,
                         trusted, covs, truncated)

    def _subalign_py(self, start, seq_len, forward, seq):
        open_heap = []
        counter = [0]
        heapq.heappush(open_heap, (-start.f_score, 0, start))
        # the reference's closed std::map orders nodes by f_score, so
        # nodes with equal f_score collapse to one entry — replicated
        # by keying on the f_score value (read_aligner.cc:361-392)
        closed = {}
        best = None
        while open_heap:
            _, _, curr = heapq.heappop(open_heap)
            if best is None or (best.score - _get_null(best.length) <
                                curr.score - _get_null(curr.length)):
                best = curr
            if curr.seq_idx == seq_len - 1 or curr.seq_idx == 0:
                best = curr
                break
            key = curr.f_score
            entry = closed.get(key)
            if entry is None:
                times_closed = 0
            else:
                closed_score, times = entry
                if closed_score > curr.score or closed_score == curr.score:
                    times_closed = times
                    del closed[key]
                else:
                    continue
            if times_closed > 200:
                continue
            closed[key] = (curr.score, times_closed + 1)
            self._enumerate(open_heap, counter, curr, forward, seq)
        return self._extract(best, forward, seq)

    def _extract(self, node, forward, read):
        if node is None:
            return Alignment(0.0, "", "", "", [], True)
        read_alignment = []
        graph_alignment = []
        trusted = []
        covs = []
        ret_score = node.score
        truncated = node.seq_idx != 0 and node.seq_idx != len(read) - 1
        farthest_seq_idx = node.seq_idx
        while node is not None and node.prev is not None:
            if node.state in (MATCH, MATCH_UNTRUSTED):
                graph_base = _NUCL[node.base]
                read_base = read[node.seq_idx]
            elif node.state in (INSERT_READ, INSERT_READ_UNTRUSTED):
                graph_base = "-"
                read_base = read[node.seq_idx].lower()
            else:
                graph_base = _NUCL[node.base].lower()
                read_base = "-"
            if forward:
                graph_alignment.insert(0, graph_base)
                read_alignment.insert(0, read_base)
                trusted.insert(0, "T" if node.trusted else "F")
                covs.insert(0, node.cov)
            else:
                graph_alignment.append(graph_base)
                read_alignment.append(read_base)
                trusted.append("T" if node.trusted else "F")
            node = node.prev
        graph_alignment = "".join(graph_alignment)
        read_alignment = "".join(read_alignment)
        if truncated:
            if forward:
                graph_alignment = graph_alignment + \
                    read[farthest_seq_idx + 1:]
            else:
                graph_alignment = read[: node.seq_idx] + graph_alignment
        return Alignment(ret_score, graph_alignment, read_alignment,
                         "".join(trusted), covs, truncated)

    # -- seeding -----------------------------------------------------------

    def _start_node(self, kmer, kmer_idx, k_cov):
        k = self.k
        _, fhash, rhash = hash_2bit_scalar(kmer, k)
        e = _NUCL_CODE.get(kmer[k - 1].upper(), 0)
        node = _Node(None, e, kmer_idx + k - 1, MATCH, MM, fhash, rhash, k)
        node.f_score = 0.0
        node.h_score = 0.0
        if k_cov >= self.trusted_cutoff:
            node.score = k * self.trusted_match + k * self.tsc[MM]
        else:
            node.score = k * self.untrusted_match + k * self.tsc[MM]
        return node

    def align_many(self, sequences):
        """Batched align(): one K1 call hashes every read; seed coverage
        uses the host count snapshot and the A* searches run per read in
        the native core, with no per-read device traffic.  Returns a
        list of align() result tuples."""
        if not sequences:
            return []
        h, _ = self.graph._row_hashes(list(sequences))
        h = _u64.to_numpy(h)
        k = self.k
        return [self._align_hashed(seq, h[i, :max(len(seq) - k + 1, 0)])
                for i, seq in enumerate(sequences)]

    def align(self, sequence):
        """Bidirectional alignment from the max-coverage seed k-mer
        (read_aligner.cc Align); returns (score, graph_aln, read_aln,
        truncated) like readaligner.pyx:84-96."""
        if len(sequence) - self.k + 1 <= 0:
            raise ValueError("sequence shorter than k")
        return self._align_hashed(sequence,
                                  self.graph._hash_array(sequence))

    def _align_hashed(self, sequence, hashes):
        k = self.k
        read = sequence
        if len(read) - k + 1 <= 0:
            raise ValueError("sequence shorter than k")
        covs = self.graph.storage.host_counts(hashes)
        best_idx = int(np.argmax(covs)) if covs.size else 0
        # reference keeps the FIRST maximal (strictly greater updates)
        best_idx = int(np.flatnonzero(covs == covs.max())[0])
        k_cov = int(covs[best_idx])
        if k_cov == 0:
            aln = _empty_alignment()
            return aln.score, aln.graph_alignment, aln.read_alignment, \
                aln.truncated
        kmer = read[best_idx: best_idx + k]

        start = self._start_node(kmer, best_idx, k_cov)
        forward = self._subalign(start, len(read), True, read)
        final_length = len(forward.read_alignment) + k

        start2 = self._start_node(kmer, best_idx, k_cov)
        start2.seq_idx = best_idx
        reverse = self._subalign(start2, len(read), False, read)
        final_length += len(reverse.read_alignment)

        score = reverse.score + forward.score - start.score
        read_alignment = reverse.read_alignment + kmer + \
            forward.read_alignment
        graph_alignment = reverse.graph_alignment + kmer + \
            forward.graph_alignment
        score = score - _get_null(final_length)
        truncated = forward.truncated or reverse.truncated
        return (score, graph_alignment.upper(), read_alignment.upper(),
                truncated)

    def align_forward(self, sequence):
        """Forward-only alignment seeded at position 0
        (read_aligner.cc AlignForward); returns (score, graph_aln,
        read_aln, truncated, covs)."""
        k = self.k
        read = sequence
        if len(read) < k:
            raise ValueError("sequence shorter than k")
        kmer = read[:k]
        k_cov = self._count(min(*hash_2bit_scalar(kmer, k)[1:]))
        if k_cov == 0:
            aln = _empty_alignment()
            return aln.score, aln.graph_alignment, aln.read_alignment, \
                aln.truncated, []
        start = self._start_node(kmer, 0, k_cov)
        forward = self._subalign(start, len(read), True, read)
        final_length = len(forward.read_alignment) + k
        score = forward.score - _get_null(final_length)
        read_alignment = kmer + forward.read_alignment
        graph_alignment = kmer + forward.graph_alignment
        covs = [k_cov] + list(forward.covs) + [0] * (k - 1)
        return (score, graph_alignment.upper(), read_alignment.upper(),
                forward.truncated, covs)

    # -- introspection (readaligner.pyx:139-180) ---------------------------

    @property
    def defaultScoringMatrix(self):
        return list(FREQ_DEFAULT)

    # per-from-state group sizes of the flat transition table
    # (M_t:6, Ir_t:4, Ig_t:4, M_u:6, Ir_u:4, Ig_u:4)
    _TRANS_GROUPS = (6, 4, 4, 6, 4, 4)

    @staticmethod
    def _nest_transitions(flat):
        out = []
        i = 0
        for n in ReadAligner._TRANS_GROUPS:
            out.append(tuple(flat[i:i + n]))
            i += n
        return tuple(out)

    @property
    def defaultTransitionProbabilities(self):
        return self._nest_transitions(TRANS_DEFAULT)

    @property
    def scoring_matrix(self):
        return [self.trusted_match, self.trusted_mismatch,
                self.untrusted_match, self.untrusted_mismatch]

    @property
    def transition_probabilities(self):
        return self._nest_transitions(self.tsc)

// Native A* core of the ReadAligner (pair-HMM Subalign).
//
// A copy of khmer_tpu/native/read_aligner.cc for khmer_tpu_torch (built
// into the same library as fastx_loader.cc; khmer_tpu_torch/native).
//
// Faithful port of khmer_tpu/readaligner.py::_subalign/_enumerate —
// itself the parity port of reference src/oxli/read_aligner.cc:333-520
// — moved to C++ because the best-first search is sequential
// pointer-chasing that an interpreter executes ~100x slower.  Every
// reference quirk is preserved: the closed map KEYED BY f_score with
// its delete/reinsert/200-times logic, both trusted branches using the
// trusted match scores, heap ties broken by insertion counter, the
// indel<3 / bits_theta pruning, and the null-model formula.
//
// Count lookups run against the caller's host snapshot of the u32
// sketch table (min over tables of bins, capped) — no device traffic.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <deque>
#include <queue>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

enum State {
    MATCH = 0, INSERT_READ, INSERT_GRAPH,
    MATCH_UNTRUSTED, INSERT_READ_UNTRUSTED, INSERT_GRAPH_UNTRUSTED
};
enum Trans {
    MM = 0, MIr, MIg, MMu, MIru, MIgu,
    IrM, IrIr, IrMu, IrIru,
    IgM, IgIg, IgMu, IgIgu,
    MuM, MuIr, MuIg, MuMu, MuIru, MuIgu,
    IruM, IruIr, IruMu, IruIru,
    IguM, IguIg, IguMu, IguIgu,
    DISALLOWED
};

// mirror of readaligner.py::_TRANS_TABLE (filled by the python layer
// at build parity-check time would be nicer, but the table is small
// and static: reference read_aligner.hh:73-103)
static const int TRANS_TABLE[6][6] = {
    {MM,   MIr,  MIg,  MMu,  MIru, MIgu},
    {IrM,  IrIr, DISALLOWED, IrMu, IrIru, DISALLOWED},
    {IgM,  DISALLOWED, IgIg, IgMu, DISALLOWED, IgIgu},
    {MuM,  MuIr, MuIg, MuMu, MuIru, MuIgu},
    {IruM, IruIr, DISALLOWED, IruMu, IruIru, DISALLOWED},
    {IguM, DISALLOWED, IguIg, IguMu, DISALLOWED, IguIgu},
};

struct Node {
    Node* prev;
    int8_t base;
    int8_t state;
    int32_t seq_idx;
    int32_t length;
    int32_t num_indels;
    uint64_t fwd, rc;
    double score, f_score, h_score;
    uint32_t cov;
    bool trusted;
};

struct HeapEntry {
    double f_score;
    uint64_t counter;
    Node* node;
};
struct HeapCmp {
    // max-heap on f_score; ties -> SMALLEST counter first (python
    // heapq on (-f_score, counter))
    bool operator()(const HeapEntry& a, const HeapEntry& b) const {
        if (a.f_score != b.f_score) return a.f_score < b.f_score;
        return a.counter > b.counter;
    }
};

struct Ctx {
    const uint32_t* table;
    const uint64_t* sizes;
    const int64_t* offs;
    int n_tables;
    uint32_t read_cap;
    const double* tsc;  // 29 transition log-probs
    double trusted_match, trusted_mismatch;
    double bits_theta;
    uint32_t trusted_cutoff;
    int k;
    uint64_t bitmask;
    int rc_left_shift;
    const char* seq;
    int seq_len;
    std::deque<Node> arena;
    uint64_t counter;
};

static inline double get_null(int length) {
    return std::log2(0.25) * length + std::log2(1.0 / (length + 1));
}

static inline uint32_t count_of(const Ctx& c, uint64_t h) {
    uint32_t m = 0xFFFFFFFFu;
    for (int t = 0; t < c.n_tables; t++) {
        uint32_t v = c.table[(uint64_t)c.offs[t] + h % c.sizes[t]];
        if (v < m) m = v;
    }
    return m < c.read_cap ? m : c.read_cap;
}

typedef std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp>
    OpenHeap;

// khmer twobit code per ACGT index (readaligner.py:186)
static const int NUCL_CODE[4] = {0, 2, 3, 1};
static const char NUCL[4] = {'A', 'C', 'G', 'T'};

static void enumerate(Ctx& c, OpenHeap& open, Node* curr, bool forward) {
    int next_seq_idx, remaining;
    if (forward) {
        next_seq_idx = curr->seq_idx + 1;
        if (next_seq_idx >= c.seq_len) return;
        remaining = c.seq_len - next_seq_idx;
    } else {
        next_seq_idx = curr->seq_idx - 1;
        remaining = next_seq_idx;
    }

    uint64_t nfs[4], nrs[4];
    uint32_t covs[4];
    for (int i = 0; i < 4; i++) {
        uint64_t code = (uint64_t)NUCL_CODE[i];
        uint64_t nf, nr;
        if (forward) {
            nf = ((curr->fwd << 2) & c.bitmask) | code;
            nr = (curr->rc >> 2) | ((code ^ 1ull) << c.rc_left_shift);
        } else {
            nf = (curr->fwd >> 2) | (code << c.rc_left_shift);
            nr = ((curr->rc << 2) & c.bitmask) | (code ^ 1ull);
        }
        nfs[i] = nf;
        nrs[i] = nr;
        covs[i] = count_of(c, nf < nr ? nf : nr);
    }

    for (int i = 0; i < 4; i++) {
        uint32_t cov = covs[i];
        if (cov == 0) continue;
        int start_state, end_state;
        // NOTE: both branches use the TRUSTED scores — a preserved
        // quirk of the python/reference port (readaligner.py:199-207)
        double match_sc = c.trusted_match;
        double mismatch_sc = c.trusted_mismatch;
        if (cov < c.trusted_cutoff) {
            start_state = MATCH_UNTRUSTED;
            end_state = INSERT_GRAPH_UNTRUSTED;
        } else {
            start_state = MATCH;
            end_state = INSERT_GRAPH;
        }
        for (int next_state = start_state; next_state <= end_state;
             next_state++) {
            int trans = TRANS_TABLE[curr->state][next_state];
            if (trans == DISALLOWED) continue;
            double hcost = c.tsc[TRANS_TABLE[next_state][MATCH]] +
                (c.tsc[MM] + c.trusted_match) *
                (remaining == 0 ? 0 : remaining - 1);
            double sc;
            if (next_state == MATCH || next_state == MATCH_UNTRUSTED) {
                sc = (NUCL[i] == c.seq[next_seq_idx]) ? match_sc
                                                      : mismatch_sc;
            } else {
                sc = 0.0;  // _BACKGROUND_PROB
            }

            c.arena.emplace_back();
            Node* nxt = &c.arena.back();
            nxt->prev = curr;
            nxt->base = (int8_t)i;
            nxt->trusted = cov >= c.trusted_cutoff;
            nxt->cov = cov;
            nxt->num_indels = curr->num_indels;
            if (next_state == MATCH || next_state == MATCH_UNTRUSTED) {
                nxt->seq_idx = next_seq_idx;
                nxt->fwd = nfs[i];
                nxt->rc = nrs[i];
                nxt->length = curr->length + 1;
            } else if (next_state == INSERT_READ ||
                       next_state == INSERT_READ_UNTRUSTED) {
                nxt->seq_idx = next_seq_idx;
                nxt->fwd = curr->fwd;
                nxt->rc = curr->rc;
                nxt->length = curr->length + 1;
                nxt->num_indels++;
            } else {
                nxt->seq_idx = curr->seq_idx;
                nxt->fwd = nfs[i];
                nxt->rc = nrs[i];
                nxt->length = curr->length;
                nxt->num_indels++;
            }
            nxt->state = (int8_t)next_state;
            nxt->score = curr->score + sc + c.tsc[trans];
            nxt->h_score = hcost;
            nxt->f_score = nxt->score + hcost;

            if (nxt->num_indels < 3 &&
                nxt->score - get_null(nxt->length) >
                    nxt->length * c.bits_theta) {
                c.counter++;
                open.push(HeapEntry{nxt->f_score, c.counter, nxt});
            } else {
                c.arena.pop_back();
            }
        }
    }
}

}  // namespace

extern "C" {

// Runs one Subalign; emits the best path BACKWARD (best node first,
// stopping before the start node) into the out arrays.  Returns the
// path length, or -1 when out_cap is too small.
long ra_subalign(
    const uint32_t* table, const uint64_t* sizes, const int64_t* offs,
    int n_tables, uint32_t read_cap, const double* tsc,
    double trusted_match, double trusted_mismatch, double bits_theta,
    uint32_t trusted_cutoff, int k, const char* seq, int seq_len,
    int start_base, int start_seq_idx, double start_score,
    uint64_t start_fwd, uint64_t start_rc, int forward, long out_cap,
    int8_t* out_state, int8_t* out_base, int32_t* out_seq_idx,
    uint8_t* out_trusted, uint32_t* out_cov, double* out_score,
    int* out_truncated, int32_t* out_end_seq_idx) {
    Ctx c;
    c.table = table;
    c.sizes = sizes;
    c.offs = offs;
    c.n_tables = n_tables;
    c.read_cap = read_cap;
    c.tsc = tsc;
    c.trusted_match = trusted_match;
    c.trusted_mismatch = trusted_mismatch;
    c.bits_theta = bits_theta;
    c.trusted_cutoff = trusted_cutoff;
    c.k = k;
    c.bitmask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    c.rc_left_shift = 2 * k - 2;
    c.seq = seq;
    c.seq_len = seq_len;
    c.counter = 0;

    c.arena.emplace_back();
    Node* start = &c.arena.back();
    start->prev = nullptr;
    start->base = (int8_t)start_base;
    start->state = MATCH;
    start->seq_idx = start_seq_idx;
    start->length = k;
    start->num_indels = 0;
    start->fwd = start_fwd;
    start->rc = start_rc;
    start->score = start_score;
    start->h_score = 0.0;
    start->f_score = 0.0;
    start->cov = 0;
    start->trusted = false;

    OpenHeap open;
    open.push(HeapEntry{start->f_score, 0, start});
    // python dict keyed by the f_score double, value (score, times)
    std::unordered_map<double, std::pair<double, int>> closed;
    Node* best = nullptr;

    while (!open.empty()) {
        Node* curr = open.top().node;
        open.pop();
        if (best == nullptr ||
            best->score - get_null(best->length) <
                curr->score - get_null(curr->length)) {
            best = curr;
        }
        if (curr->seq_idx == seq_len - 1 || curr->seq_idx == 0) {
            best = curr;
            break;
        }
        double key = curr->f_score;
        int times_closed = 0;
        auto it = closed.find(key);
        if (it != closed.end()) {
            double closed_score = it->second.first;
            if (closed_score >= curr->score) {
                times_closed = it->second.second;
                closed.erase(it);
            } else {
                continue;
            }
        }
        if (times_closed > 200) continue;
        closed[key] = std::make_pair(curr->score, times_closed + 1);
        enumerate(c, open, curr, forward != 0);
    }

    if (best == nullptr) {
        *out_score = 0.0;
        *out_truncated = 1;
        *out_end_seq_idx = 0;
        return 0;
    }
    *out_score = best->score;
    *out_truncated =
        (best->seq_idx != 0 && best->seq_idx != seq_len - 1) ? 1 : 0;
    *out_end_seq_idx = best->seq_idx;
    long n = 0;
    for (Node* node = best; node != nullptr && node->prev != nullptr;
         node = node->prev) {
        if (n >= out_cap) return -1;
        out_state[n] = node->state;
        out_base[n] = node->base;
        out_seq_idx[n] = node->seq_idx;
        out_trusted[n] = node->trusted ? 1 : 0;
        out_cov[n] = node->cov;
        n++;
    }
    return n;
}

}  // extern "C"

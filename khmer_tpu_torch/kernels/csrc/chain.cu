// K6 diginorm_chain and K7 trim_chain: the sequential keep decision of a
// batch of read bundles (a read, or a pair: two rows).
//
// K6 replaces the lax.scan of khmer_tpu/hashtable.py:_make_diginorm_fn
// (:760-878), K7 that of _make_trim_pass1_fn (:499-639).  The caller has
// hashed the batch's B2 = 2 B rows of nw windows, numbered each valid
// window's k-mer by its rank among the batch's distinct k-mers (ids), and
// read every distinct k-mer's count before the batch (pre, u16, K3).  In
// bundle order, a window's count is cnt = pre[id] + tally[id], where
// tally[id] counts the k-mer's valid windows in the bundles taken earlier
// in the batch: exact, because sketch counts add up.  Per bundle b:
//   K6: keep iff a real row has no valid window or fewer than (n + 1) / 2
//       of its n valid windows with cnt >= C; a kept bundle adds one to
//       tally for each of its valid windows;
//   K7: a row's median is >= T iff at least n - n / 2 of its valid
//       windows have cnt >= T; branch 0 (skip) when diginorm is on and
//       every real row's median is >= dn_cov, else 1 (trim now) when every
//       real row's median is >= trim_at, else 2 (save); only a saved bundle
//       adds to tally.  first_bad of each row is its first valid window
//       with cnt < cutoff (nw if none), from the counts before the bundle's
//       own adds.
// The caller flushes the final tally into the sketch (K2).
//
// Design: the chain's real links are few.  Bundle b's counts depend only
// on the earlier bundles that take and hold one of its k-mers; in a batch
// of 100-bp pairs at about one genome coverage a bundle shares k-mers
// with three or four others.  So the kernel decides, round by round,
// every bundle it can prove ready, all of them at once, on the whole
// card.  A bundle's tag code is round << 26 | ~b, so of the bundles that
// stamp a k-mer's tag (atomicMax) the earliest wins.  Before round 1
// every bundle stamps its valid windows' k-mers.  Round r, one pass and
// a grid barrier: each undecided bundle reads its windows' tags and
// counts.  A tag above its own code means an undecided earlier bundle
// holds that k-mer; b is ready if there is none.  Then its counts are
// exact: every earlier bundle that holds one of its k-mers is decided
// and its adds are in the tally, and no other bundle decided in this
// round holds one (the earlier of two would be undecided when the later
// looks).  K6 also decides a bundle that is not ready but would be
// dropped: its counts can only rise as earlier bundles are kept, so it
// stays dropped, and it adds nothing.  (K7's branch only falls as counts
// rise, but its branch 0 / 1 and first_bad need exact counts.)
// A decided bundle writes its flag (and first_bad) and, if it takes, adds
// to the tally; every other bundle stamps round r + 1's tags, held apart
// from round r's by parity, so the stamps and the checks of one pass never
// meet.  The first undecided bundle is always ready, so every round
// decides at least one, but for a round after a walk, whose tags still
// name the walked bundles: it may decide none, and walks again.  A round
// that decides fewer than 32 bundles (a chain: position-sorted reads that
// overlap, or copies of one read, each taken; or the tail of a batch)
// costs more than walking 32 bundles, so block 0 then walks the next
// undecided bundles in bundle order while the other blocks wait at the
// barrier: 1,024 of them the first time, four times as many each later
// time (a chain may end, as when K6 has kept enough copies of a read to
// drop the rest at once), and all of them after round 63, the last a tag's
// 6 round bits hold.  That is exact too: no decided bundle that took is
// later than an undecided one that shares a k-mer with it.  The walk takes
// a bundle a step, a thread a window: row sums by warp reductions into
// shared memory, a barrier, one lane a warp reducing them again, the
// decision, a taken bundle's adds, a barrier.
//
// In the rounds a warp takes a bundle at a time, its lanes over the
// windows (up to 320 in flight, coalesced), row sums by warp reductions
// (__reduce_add_sync / __reduce_min_sync).  One 1024-thread block per SM,
// all co-resident (cooperative launch), so the grid barrier, a counter in
// the scratch, can spin.  The tally starts as pre, so a window's count is
// one gather, and pre is subtracted at the end.  The tally and tags are
// read with ld.global.cg (L2, where the atomics land), never through L1.
// The tally and the tags (4 B each, two rounds' worth of tags) per
// distinct k-mer, 24 MB at 16,384 bundles of 100-bp pairs (about 2 M
// distinct k-mers), stay in the 50 MB L2 beside most of the batch's ids.
// (Deciding a step of S bundles in one block, and keeping the prefix that
// no earlier bundle of the step touched, decides about 31 of 32, but one
// SM's rate of scattered L2 requests then bounds every step; this design
// spreads them over the card.)
//
// Bound: bytes, each input read once and each output written once: 1
// (valid) a window, 4 (id) a valid window, 2 (pre) a distinct k-mer, 1
// (real) a row, 4 (tally) a distinct k-mer of the taken bundles, and the
// flags out.  The kernel reads an undecided bundle's windows, tags and
// counts each round, so its work is the sum over rounds of the undecided
// windows (about 2.3 batches' worth in 8 rounds at one genome coverage
// when every bundle takes), at the card's rate of scattered L2 requests,
// plus a grid barrier a round.  Worst case: every bundle sharing a k-mer
// with the one before it and every one taken (K6 keeps, K7 saves), or,
// for K7, sharing and not all skipped: the whole batch walked (in walks
// of 1,024, 4,096, ... bundles, a round between two), two block barriers
// and a dependent L2 round trip a bundle.  The wrapper caps B at 2^26 -
// 1, the bundles a tag's 26 low bits hold.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kChainThreads = 1024;
constexpr int kWarps = kChainThreads / 32;
constexpr int kU = 10;  // windows a lane holds in flight: 320 a bundle,
                        // the 2 x 129 of 100-bp reads at k = 20 at once
constexpr int kWalkBelow = 32;    // a round deciding fewer starts a walk
constexpr int kWalkFirst = 1024;  // bundles the first walk decides at most;
                                  // each later walk, four times as many
constexpr int kBundleBits = 26;  // a tag: round << 26 | ~bundle
constexpr unsigned kMaxRounds = (1u << (32 - kBundleBits)) - 1;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChunk = 1024;  // bundles whose done flags the walk stages
constexpr int kFields = 4;    // a row's sums in the walk: K6 hits and n;
                              // K7 ge_trim, ge_dn, n and first_bad

// the scratch's head; two tag arrays (u32 [n_distinct] each, by round
// parity) and done (u8 [B]) follow
struct ChainState {
    int rounds;   // out: rounds taken (offset 0, read by the host)
    int walked;   // out: bundles the walks decided (offset 4)
    int left[3];  // bundles a round left undecided, by round % 3
    int pad;
    u64 arrived;  // grid barrier: arrivals so far
};
constexpr long long kStateBytes = 32;
static_assert(sizeof(ChainState) <= kStateBytes, "state too large");

// All blocks are co-resident (cooperative launch); `target` counts the
// arrivals of every barrier so far, kept alike by each thread.
__device__ __forceinline__ void grid_sync(u64* arrived, u64& target) {
    __syncthreads();
    target += gridDim.x;
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(arrived, 1ULL);
        unsigned ns = 32;
        while (*(volatile u64*)arrived < target) {
            __nanosleep(ns);
            ns = min(2 * ns, 1024u);
        }
        __threadfence();
    }
    __syncthreads();
}

__device__ __forceinline__ unsigned code_of(unsigned round, int b) {
    return round << kBundleBits | ((1u << kBundleBits) - 1 - (unsigned)b);
}

// lane's windows i0 + 32 u (u < kU) of a bundle: ids and a valid bit each
__device__ __forceinline__ unsigned load_chunk(const int* bid,
                                               const uint8_t* bval, int i0,
                                               int lanes, int (&id)[kU]) {
    unsigned v = 0;
#pragma unroll
    for (int u = 0; u < kU; u++) {
        const int i = i0 + 32 * u;
        const bool in = i < lanes;
        id[u] = in ? __ldg(bid + i) : 0;
        if (in && __ldg(bval + i)) v |= 1u << u;
    }
    return v;
}

// f(id) for each valid window of a bundle, the warp's lanes over them
template <typename F>
__device__ __forceinline__ void each_valid(const int* bid,
                                           const uint8_t* bval, int lanes,
                                           F f) {
    for (int i0 = threadIdx.x & 31; i0 < lanes; i0 += 32 * kU) {
        int id[kU];
        const unsigned v = load_chunk(bid, bval, i0, lanes, id);
#pragma unroll
        for (int u = 0; u < kU; u++)
            if (v >> u & 1) f(id[u]);
    }
}

struct Params {
    const int* ids;
    const uint8_t* valid;
    const uint8_t* real;
    const uint16_t* pre;
    int B, nw;
    unsigned C, dn_cov, cutoff;
    bool do_norm;
    unsigned* cnt;  // the tally: pre + adds while the kernel runs
    uint8_t* flag;
    int* first_bad;
};

// bundle b's two real flags, row 0's in the low byte
__device__ __forceinline__ unsigned reals(const Params& p, int b) {
    return __ldg(p.real + 2LL * b) | (unsigned)__ldg(p.real + 2LL * b + 1)
                                         << 8;
}

// A bundle's decision from its real flags and its rows' sums (a: cnt >=
// C; d: cnt >= dn_cov; n: valid windows): K6 keep, K7 branch; *take:
// adds to the tally.
template <bool kTrim>
__device__ __forceinline__ int decide(const Params& p, unsigned real,
                                      int a0, int a1, int d0, int d1, int n0,
                                      int n1, bool* take) {
    const bool real0 = (real & 0xFF) != 0, real1 = real >> 8 != 0;
    if (kTrim) {
        const int need0 = n0 - n0 / 2, need1 = n1 - n1 / 2;
        const bool ok_trim =
            (!real0 || a0 >= need0) && (!real1 || a1 >= need1);
        const bool ok_dn = (!real0 || d0 >= need0) && (!real1 || d1 >= need1);
        const int out = p.do_norm && ok_dn ? 0 : ok_trim ? 1 : 2;
        *take = out == 2;
        return out;
    }
    const int out = (real0 && (n0 == 0 || a0 < (n0 + 1) / 2)) ||
                    (real1 && (n1 == 0 || a1 < (n1 + 1) / 2));
    *take = out == 1;
    return out;
}

struct Verdict {
    int out;     // K6 keep, K7 branch
    bool take;   // adds to the tally
    bool first;  // no undecided earlier bundle holds one of its k-mers
    int f0, f1;
};

// One warp: bundle b's counts as they stand and what its windows' tags
// say of the earlier undecided bundles (the tags at most `code`, b's
// own: none of them holds a k-mer of b); row sums by warp reductions (K6
// hits (cnt >= C) and n; K7 ge_trim, ge_dn, n and first_bad); the
// decision.
template <bool kTrim>
__device__ __forceinline__ Verdict evaluate(const Params& p, int b,
                                            const unsigned* tag,
                                            unsigned code) {
    const int lanes = 2 * p.nw;
    const int* bid = p.ids + (long long)b * lanes;
    const uint8_t* bval = p.valid + (long long)b * lanes;
    bool first = true;
    int a0 = 0, a1 = 0, d0 = 0, d1 = 0, n0 = 0, n1 = 0;
    int f0 = p.nw, f1 = p.nw;
    for (int i0 = threadIdx.x & 31; i0 < lanes; i0 += 32 * kU) {
        int id[kU];
        const unsigned v = load_chunk(bid, bval, i0, lanes, id);
        unsigned cnt[kU];
#pragma unroll
        for (int u = 0; u < kU; u++) {
            cnt[u] = 0;
            if (v >> u & 1) {
                first &= __ldcg(tag + id[u]) <= code;
                cnt[u] = __ldcg(p.cnt + id[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < kU; u++) {
            if (!(v >> u & 1)) continue;
            const int i = i0 + 32 * u;
            const bool r = i >= p.nw;
            const int ge = cnt[u] >= p.C;
            a0 += r ? 0 : ge;
            a1 += r ? ge : 0;
            n0 += !r;
            n1 += r;
            if (kTrim) {
                const int dn = cnt[u] >= p.dn_cov;
                d0 += r ? 0 : dn;
                d1 += r ? dn : 0;
                if (cnt[u] < p.cutoff) {
                    if (r)
                        f1 = min(f1, i - p.nw);
                    else
                        f0 = min(f0, i);
                }
            }
        }
    }
    Verdict v;
    v.first = __all_sync(kFull, first);
    a0 = __reduce_add_sync(kFull, a0);
    a1 = __reduce_add_sync(kFull, a1);
    n0 = __reduce_add_sync(kFull, n0);
    n1 = __reduce_add_sync(kFull, n1);
    if (kTrim) {
        d0 = __reduce_add_sync(kFull, d0);
        d1 = __reduce_add_sync(kFull, d1);
        f0 = __reduce_min_sync(kFull, f0);
        f1 = __reduce_min_sync(kFull, f1);
    }
    v.f0 = f0;
    v.f1 = f1;
    v.out = decide<kTrim>(p, reals(p, b), a0, a1, d0, d1, n0, n1, &v.take);
    return v;
}

// One warp: write bundle b's flag (and first_bad) and add a taken
// bundle's windows to the tally.
template <bool kTrim>
__device__ __forceinline__ void commit(const Params& p, int b,
                                       const Verdict& v) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) p.flag[b] = (uint8_t)v.out;
    if (kTrim && lane < 2) p.first_bad[2LL * b + lane] = lane ? v.f1 : v.f0;
    if (v.take) {
        const long long base = (long long)b * 2 * p.nw;
        each_valid(p.ids + base, p.valid + base, 2 * p.nw,
                   [&](int id) { atomicAdd(p.cnt + id, 1u); });
    }
}

// bar.sync 1 over the walk's n threads (whole warps, the first of block
// 0): orders their shared and global accesses as __syncthreads does,
// while the block's other threads wait at barrier 0.  (A load of the
// next bundle's window issued before it made the walk slower on the
// card, not faster.)
__device__ __forceinline__ void walk_sync(int n) {
    asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// the first set bit of todo at or after j, kChunk if none
__device__ __forceinline__ int next_todo(const unsigned* todo, int j) {
    for (int w = j >> 5; w < kChunk / 32; w++) {
        const unsigned m = todo[w] & (~0u << (j & 31));
        if (m) return (w << 5) + __ffs(m) - 1;
        j = (w + 1) << 5;
    }
    return kChunk;
}

// A walk: block 0's first n threads, a thread a window (and every n-th
// after it), decide the first `count` undecided bundles in bundle order
// and mark them done.  Each warp's row sums go to shared memory; after
// the barrier, every warp reduces them again, a lane a warp.
template <bool kTrim>
__device__ void walk(const Params& p, uint8_t* done, int n, int count) {
    __shared__ unsigned todo[kChunk / 32];  // undecided, a bit a bundle
    __shared__ int part[kWarps][2][kFields];  // [warp][row][field]
    const int t = threadIdx.x, lane = t & 31, lanes = 2 * p.nw;
    constexpr int F = kTrim ? kFields : 2;
    for (int c0 = 0; c0 < p.B && count > 0; c0 += kChunk) {
        for (int i = t; i < kChunk; i += n) {
            const int b = c0 + i;
            const unsigned m =
                __ballot_sync(kFull, b < p.B && !__ldcg(done + b));
            if (lane == 0) todo[i >> 5] = m;
        }
        walk_sync(n);
        for (int j = next_todo(todo, 0); j < kChunk && count > 0;
             j = next_todo(todo, j + 1), count--) {
            const int b = c0 + j;
            const long long base = (long long)b * lanes;
            const unsigned real = reals(p, b);
            // window t's id and valid bit, kept for the adds
            const bool v0 = t < lanes && __ldg(p.valid + base + t);
            const int id0 = t < lanes ? __ldg(p.ids + base + t) : 0;
            int s[2][kFields] = {{0, 0, 0, p.nw}, {0, 0, 0, p.nw}};
            for (int i = t; i < lanes; i += n) {
                const bool v = i == t ? v0 : __ldg(p.valid + base + i) != 0;
                if (!v) continue;
                const int r = i >= p.nw;
                const unsigned cnt =
                    __ldcg(p.cnt + (i == t ? id0 : __ldg(p.ids + base + i)));
                s[r][0] += cnt >= p.C;
                if (kTrim) {
                    s[r][1] += cnt >= p.dn_cov;
                    s[r][2] += 1;
                    if (cnt < p.cutoff) s[r][3] = min(s[r][3], i - r * p.nw);
                } else {
                    s[r][1] += 1;
                }
            }
#pragma unroll
            for (int r = 0; r < 2; r++) {
#pragma unroll
                for (int f = 0; f < F; f++) {
                    const unsigned x = (unsigned)s[r][f];
                    const int y = (int)(kTrim && f == 3
                                            ? __reduce_min_sync(kFull, x)
                                            : __reduce_add_sync(kFull, x));
                    if (lane == 0) part[t >> 5][r][f] = y;
                }
            }
            walk_sync(n);
            int q[2][kFields];
#pragma unroll
            for (int r = 0; r < 2; r++) {
#pragma unroll
                for (int f = 0; f < F; f++) {
                    const bool m = kTrim && f == 3;
                    const unsigned x = lane < n >> 5 ? part[lane][r][f]
                                       : m           ? p.nw
                                                     : 0;
                    q[r][f] = (int)(m ? __reduce_min_sync(kFull, x)
                                      : __reduce_add_sync(kFull, x));
                }
            }
            bool take;
            const int out =
                kTrim ? decide<true>(p, real, q[0][0], q[1][0], q[0][1],
                                     q[1][1], q[0][2], q[1][2], &take)
                      : decide<false>(p, real, q[0][0], q[1][0], 0, 0,
                                      q[0][1], q[1][1], &take);
            if (t == 0) {
                p.flag[b] = (uint8_t)out;
                done[b] = 1;
            }
            if (kTrim && t < 2) p.first_bad[2LL * b + t] = q[t][3];
            if (take) {
                if (v0) atomicAdd(p.cnt + id0, 1u);
                for (int i = t + n; i < lanes; i += n)
                    if (__ldg(p.valid + base + i))
                        atomicAdd(p.cnt + __ldg(p.ids + base + i), 1u);
            }
            // the adds before the next bundle's reads, and the reads of
            // part before its writes
            walk_sync(n);
        }
        walk_sync(n);  // todo's reads before the next chunk's writes
    }
}

template <bool kTrim>
__global__ void __launch_bounds__(kChainThreads, 1)
chain_kernel(Params p, ChainState* st, unsigned* tags, long long n_distinct,
             uint8_t* done) {
    const int lane = threadIdx.x & 31;
    const long long thread = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long threads = (long long)gridDim.x * blockDim.x;
    const int warp = (int)(thread >> 5);
    const int nwarps = (int)(gridDim.x * kWarps);
    const int lanes = 2 * p.nw;
    const bool lead = thread == 0;
    u64 target = 0;
    // the tally starts at the counts before the batch; round 1's tags:
    // every bundle stamps
    for (long long id = thread; id < n_distinct; id += threads)
        p.cnt[id] = __ldg(p.pre + id);
    for (int b = warp; b < p.B; b += nwarps) {
        const long long base = (long long)b * lanes;
        const unsigned code = code_of(1, b);
        unsigned* round1 = tags + n_distinct;
        each_valid(p.ids + base, p.valid + base, lanes,
                   [&](int id) { atomicMax(round1 + id, code); });
    }
    grid_sync(&st->arrived, target);
    int before = p.B, walked = 0, limit = kWalkFirst;
    for (unsigned round = 1;; round++) {
        const unsigned* now = tags + (round & 1) * n_distinct;
        unsigned* next = tags + ((round + 1) & 1) * n_distinct;
        int* left = st->left;
        // round + 1's counter: its last reads came before the barrier
        // that ended round - 1
        if (lead) left[(round + 1) % 3] = 0;
        for (int b = warp; b < p.B; b += nwarps) {
            if (__ldcg(done + b)) continue;
            const Verdict v = evaluate<kTrim>(p, b, now, code_of(round, b));
            // K6 decides a bundle it would drop at once
            if (!(v.first || (!kTrim && !v.take))) {
                // undecided: stamp round + 1's tags
                const long long base = (long long)b * lanes;
                const unsigned code = code_of(round + 1, b);
                each_valid(p.ids + base, p.valid + base, lanes,
                           [&](int id) { atomicMax(next + id, code); });
                if (lane == 0) atomicAdd(left + round % 3, 1);
                continue;
            }
            if (lane == 0) done[b] = 1;
            commit<kTrim>(p, b, v);
        }
        grid_sync(&st->arrived, target);
        int after = *(volatile int*)(left + round % 3);
        if (after && (round == kMaxRounds || before - after < kWalkBelow)) {
            // a chain: block 0 decides the next undecided bundles in
            // bundle order (all of them after the last round), while the
            // other blocks wait at the barrier.  Exact: no decided bundle
            // that took is later than an undecided one that shares a
            // k-mer with it.  The next round's tags still name the walked
            // bundles, which only delays the bundles after them.
            const int count = round == kMaxRounds ? after : min(after, limit);
            const int n = min(kChainThreads, (lanes + 31) / 32 * 32);
            if (blockIdx.x == 0 && (int)threadIdx.x < n)
                walk<kTrim>(p, done, n, count);
            grid_sync(&st->arrived, target);
            walked += count;
            after -= count;
            limit = min(4 * limit, 1 << 28);
        }
        if (after == 0) {
            if (lead) {
                st->rounds = (int)round;
                st->walked = walked;
            }
            break;
        }
        before = after;
    }
    // the tally out: the adds alone
    for (long long id = thread; id < n_distinct; id += threads)
        p.cnt[id] = __ldcg(p.cnt + id) - __ldg(p.pre + id);
}

template <bool kTrim>
int launch(const Params& p, void* scratch, long long n_distinct,
           void* stream) {
    if (p.B <= 0) return 0;
    if (p.nw < 1 || p.B >= (1 << kBundleBits))
        return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, chain_kernel<kTrim>, kChainThreads, 0);
    if (e != cudaSuccess) return (int)e;
    // a warp a bundle: no more blocks than the bundles fill
    const long long fill = (p.B + kWarps - 1) / kWarps;
    const long long blocks = std::min(fill, (long long)sms * per_sm);
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
    char* s = (char*)scratch;
    ChainState* state = (ChainState*)s;
    unsigned* tags = (unsigned*)(s + kStateBytes);
    uint8_t* done = (uint8_t*)(s + kStateBytes + 8LL * n_distinct);
    Params args_p = p;
    void* args[] = {&args_p, &state, &tags, &n_distinct, &done};
    e = cudaLaunchCooperativeKernel((const void*)chain_kernel<kTrim>,
                                    dim3((unsigned)blocks),
                                    dim3(kChainThreads), args, 0,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the zeroed scratch a K6 or K7 call takes: the state (int32 0
// and 1 receive the rounds taken and the bundles walked), the tags (two
// rounds' worth, u32 [2, n_distinct]) and a byte per bundle.
extern "C" long long khmer_chain_scratch_bytes(long long B,
                                               long long n_distinct) {
    return kStateBytes + 8LL * n_distinct + B;
}

// ids [2B, nw] i32 (ranks into pre; any value where not valid), valid
// [2B, nw] u8, real [2B] u8, pre [n_distinct] u16; tally [n_distinct] u32
// out; scratch (khmer_chain_scratch_bytes) zeroed by the caller; keep [B]
// u8 out; B < 2^26.
extern "C" int khmer_diginorm_chain(const void* ids, const void* valid,
                                    const void* real, const void* pre, int B,
                                    int nw, unsigned C, void* tally,
                                    void* keep, void* scratch,
                                    long long n_distinct, void* stream) {
    const Params p = {(const int*)ids, (const uint8_t*)valid,
                      (const uint8_t*)real, (const uint16_t*)pre, B, nw, C,
                      0, 0, false, (unsigned*)tally, (uint8_t*)keep,
                      nullptr};
    return launch<false>(p, scratch, n_distinct, stream);
}

// As khmer_diginorm_chain, with branch [B] u8 and first_bad [2B] i32 out;
// dn_cov is used only when do_norm.
extern "C" int khmer_trim_chain(const void* ids, const void* valid,
                                const void* real, const void* pre, int B,
                                int nw, unsigned trim_at, unsigned dn_cov,
                                int do_norm, unsigned cutoff, void* tally,
                                void* branch, void* first_bad, void* scratch,
                                long long n_distinct, void* stream) {
    const Params p = {(const int*)ids, (const uint8_t*)valid,
                      (const uint8_t*)real, (const uint16_t*)pre, B, nw,
                      trim_at, dn_cov, cutoff, do_norm != 0,
                      (unsigned*)tally, (uint8_t*)branch, (int*)first_bad};
    return launch<true>(p, scratch, n_distinct, stream);
}

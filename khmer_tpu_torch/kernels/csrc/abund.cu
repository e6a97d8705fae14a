// K4: one membership window of abundance-dist, fused: the tracking test,
// the main count and the histogram in one pass over the window's keys.
//
// Replaces the body of khmer_tpu/hashtable.py:_make_abund_flush_fn
// (:372-382) less its sketch_update (the caller adds the window's keys to
// tracking with K2, weighted by the flags this kernel writes), and the
// membership + histogram part of _make_abund_dist_fn (:414-456).  Lane i
// counts iff it starts a run of equal keys (i == 0 or keys[i-1] !=
// keys[i]) and its tracking min over tables is 0; a counted lane adds one
// to hist[min(main count, cap)] (u64[65536]) and writes new[i] = 1, every
// other lane new[i] = 0.  Distinct keys in any order (a window) and
// sorted keys with duplicates (a chunk of the overlay path) both fit.
//
// Bound: bytes.  Per lane the key (8 B, coalesced) and its flag (4 B); per
// run start the tracking bins up to the first zero and, for a new key,
// the T main bins: each a random 32-byte sector of a table far larger
// than L2, so the card's rate of random sectors, not its HBM rate, is
// what a key costs.  PR 1's K4 (an atomicAdd per lane into global hist,
// a separate K3 pass over every lane for membership, a compaction
// between them) spent its time on one L2 address: most keys share a
// count, and an all-zero input serialised 8 M atomics on hist[0].
//
// Design:
//  * privatised histogram: each block keeps bins [0, kSharedBins) as u32
//    in shared memory; a warp whose counted lanes agree on a bin adds
//    them with one shared atomic; counts above the shared range go to
//    global atomics.  A persistent grid (a few blocks per SM, grid-
//    stride) flushes each block's non-zero bins once at the end;
//  * loads in flight: each thread takes kKeysPerThread keys; the tracking
//    test reads table t of every key still undecided before it looks at
//    any of them and stops at a key's first zero bin (min == 0 iff some
//    bin is 0); a member's main count is never read; the main bins of
//    the new keys are all issued before the min (common.cuh's
//    min_over_tables, which K3 shares);
//  * the geometry of both sketches sits in shared memory.

#include "common.cuh"

namespace {

constexpr int kSharedBins = 4096;
constexpr int kAbundThreads = 256;

__device__ __forceinline__ void hist_add(unsigned* sh, u64* hist, unsigned b,
                                         unsigned n) {
    if (b < kSharedBins)
        atomicAdd(sh + b, n);
    else
        atomicAdd(hist + b, (u64)n);
}

template <int TM>
__global__ void __launch_bounds__(kAbundThreads)
abund_hist_kernel(const u64* __restrict__ keys, long long n,
                  const unsigned* __restrict__ table, int T,
                  const long long* __restrict__ sizes,
                  const long long* __restrict__ offs,
                  const u64* __restrict__ recips,
                  const unsigned* __restrict__ track, int TT,
                  const long long* __restrict__ t_sizes,
                  const long long* __restrict__ t_offs,
                  const u64* __restrict__ t_recips, unsigned cap,
                  u64* __restrict__ hist, int* __restrict__ new_flag) {
    __shared__ unsigned sh[kSharedBins];
    __shared__ Geometry gm, gt;
    for (int b = threadIdx.x; b < kSharedBins; b += blockDim.x) sh[b] = 0;
    load_geometry(gm, T, sizes, offs, recips);
    load_geometry(gt, TT, t_sizes, t_offs, t_recips);
    __syncthreads();

    const unsigned lane = threadIdx.x & 31;
    const long long span = (long long)blockDim.x * kKeysPerThread;
    for (long long base = blockIdx.x * span; base < n;
         base += (long long)gridDim.x * span) {
        u64 h[kKeysPerThread];
        bool live[kKeysPerThread], open[kKeysPerThread];
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++) {
            const long long i = base + j * blockDim.x + threadIdx.x;
            live[j] = i < n;
            h[j] = live[j] ? keys[i] : 0;
            // a run start is a candidate until a zero tracking bin makes
            // it new, or all bins are non-zero (a member)
            open[j] = live[j] && (i == 0 || keys[i - 1] != h[j]);
        }
        bool fresh[kKeysPerThread] = {};
        for (int t = 0; t < TT; t++) {
            unsigned v[kKeysPerThread];
#pragma unroll
            for (int j = 0; j < kKeysPerThread; j++)
                v[j] = open[j] ? __ldg(track + bin_in(gt, h[j], t)) : 1u;
            bool any = false;
#pragma unroll
            for (int j = 0; j < kKeysPerThread; j++) {
                if (v[j] == 0) {
                    fresh[j] = true;
                    open[j] = false;
                }
                any |= open[j];
            }
            if (!any) break;
        }
        unsigned c[kKeysPerThread];
        min_over_tables<TM>(table, gm, T, h, fresh, c);
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++) {
            const unsigned b = min(c[j], cap);
            const unsigned want = __ballot_sync(0xFFFFFFFFu, fresh[j]);
            if (want) {
                const int leader = __ffs(want) - 1;
                const unsigned b0 = __shfl_sync(0xFFFFFFFFu, b, leader);
                const unsigned same =
                    __ballot_sync(0xFFFFFFFFu, fresh[j] && b == b0);
                if (same == want) {
                    if ((int)lane == leader)
                        hist_add(sh, hist, b0, __popc(want));
                } else if (fresh[j]) {
                    hist_add(sh, hist, b, 1);
                }
            }
            if (live[j])
                new_flag[base + j * blockDim.x + threadIdx.x] = fresh[j];
        }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < kSharedBins; b += blockDim.x)
        if (sh[b]) atomicAdd(hist + b, (u64)sh[b]);
}

template <int TM>
int launch(const void* keys, long long n, const void* table, int T,
           const void* sizes, const void* offs, const void* recips,
           const void* track, int TT, const void* t_sizes,
           const void* t_offs, const void* t_recips, unsigned cap,
           void* hist, void* new_flag, cudaStream_t stream) {
    // once per process and instance: all the blocks that fit on the card
    static long long resident = 0;
    if (resident == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, abund_hist_kernel<TM>, kAbundThreads, 0);
        const int err = (int)cudaGetLastError();
        if (err) return err;
        resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    }
    const long long span = (long long)kAbundThreads * kKeysPerThread;
    long long blocks = (n + span - 1) / span;
    if (blocks > resident) blocks = resident;
    abund_hist_kernel<TM><<<(unsigned)blocks, kAbundThreads, 0, stream>>>(
        (const u64*)keys, n, (const unsigned*)table, T,
        (const long long*)sizes, (const long long*)offs, (const u64*)recips,
        (const unsigned*)track, TT, (const long long*)t_sizes,
        (const long long*)t_offs, (const u64*)t_recips, cap, (u64*)hist,
        (int*)new_flag);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int khmer_abund_hist(const void* keys, long long n,
                                const void* table, int T, const void* sizes,
                                const void* offs, const void* recips,
                                const void* track, int TT,
                                const void* t_sizes, const void* t_offs,
                                const void* t_recips, unsigned cap,
                                void* hist, void* new_flag, void* stream) {
    if (T < 1 || T > kMaxTables || TT < 1 || TT > kMaxTables)
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    auto s = (cudaStream_t)stream;
    switch (T) {
    case 1: return launch<1>(keys, n, table, T, sizes, offs, recips, track,
                             TT, t_sizes, t_offs, t_recips, cap, hist,
                             new_flag, s);
    case 2: return launch<2>(keys, n, table, T, sizes, offs, recips, track,
                             TT, t_sizes, t_offs, t_recips, cap, hist,
                             new_flag, s);
    case 3: return launch<3>(keys, n, table, T, sizes, offs, recips, track,
                             TT, t_sizes, t_offs, t_recips, cap, hist,
                             new_flag, s);
    case 4: return launch<4>(keys, n, table, T, sizes, offs, recips, track,
                             TT, t_sizes, t_offs, t_recips, cap, hist,
                             new_flag, s);
    default: return launch<0>(keys, n, table, T, sizes, offs, recips, track,
                              TT, t_sizes, t_offs, t_recips, cap, hist,
                              new_flag, s);
    }
}

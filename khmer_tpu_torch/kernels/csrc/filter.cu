// K12 band_mask_weights: the band and mask filters of a consume.
//
// Replaces the filter lines of khmer_tpu/hashtable.py:_make_consume_fn
// (:141-176, filters :155-167) and _make_append_fn (:303-346): per lane,
//   w' = w * [bmin <= h < bmax] * [min_t mask[h % p_t], capped, <= thr]
// (>= thr with consume_masked), all compares unsigned, and the sum of w'
// (the k-mers that passed, hashtable.cc:181-191) added to a u64 total on
// the card.  The mask is any sketch (its own sizes, offsets and Barrett
// reciprocals), read at its storage kind's cap with no bigcount overlay,
// as khmer_tpu reads it (sketch_get with the mask's read spec).  Three
// variants, chosen on the host: band only, mask only, both.
//
// Bound: bytes, counted in chip_smoke.py with each byte once: per lane 8
// (hash) + 4 (weight) read and 4 (w') written, plus, with a mask, the T
// 4-byte bins of every distinct hash that reaches the gather.  As in K3,
// each bin is a random 32-byte sector of a table far larger than L2, so
// with a mask the card's rate of random sectors sets the time.
//
// Design: K3's gather as it is (four keys a thread, the hashes read as
// two 16-byte streaming loads, common.cuh's min_over_tables with every
// table's load of every key issued before any min for T <= 4).  A lane
// whose weight is 0, or that lies outside the band, reads no bin.  The
// band test and the threshold run in registers; the four w' leave as one
// 16-byte streaming store.  The sum of w' is reduced by warp shuffles and
// one atomicAdd(unsigned long long) a block, and is never read back here.

#include "common.cuh"

namespace {

constexpr int kFilterThreads = 256;

// TM < 0: no mask; TM = 0: a mask of any T (the loop over tables);
// 1 <= TM <= 4: a mask of TM tables.
template <bool kBand, int TM>
__global__ void __launch_bounds__(kFilterThreads)
band_mask_kernel(const u64* __restrict__ hashes,
                 const unsigned* __restrict__ weights, long long n, u64 bmin,
                 u64 bmax, const unsigned* __restrict__ table, int T,
                 const long long* __restrict__ sizes,
                 const long long* __restrict__ offs,
                 const u64* __restrict__ recips, unsigned cap,
                 unsigned threshold, bool consume_masked, bool vec,
                 unsigned* __restrict__ out,
                 unsigned long long* __restrict__ total) {
    __shared__ Geometry g;
    __shared__ u64 warp_sum[kFilterThreads / 32];
    if constexpr (TM >= 0) {
        load_geometry(g, T, sizes, offs, recips);
        __syncthreads();
    }
    const long long i =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kKeysPerThread;
    u64 sum = 0;
    if (i < n) {
        const bool whole = i + kKeysPerThread <= n;
        u64 h[kKeysPerThread];
        unsigned w[kKeysPerThread];
        if (whole && vec) {
            const ulonglong2 a = __ldcs((const ulonglong2*)(hashes + i));
            const ulonglong2 b = __ldcs((const ulonglong2*)(hashes + i + 2));
            const uint4 v = __ldcs((const uint4*)(weights + i));
            h[0] = a.x, h[1] = a.y, h[2] = b.x, h[3] = b.y;
            w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
        } else {
#pragma unroll
            for (int j = 0; j < kKeysPerThread; j++) {
                h[j] = i + j < n ? __ldcs(hashes + i + j) : 0;
                w[j] = i + j < n ? __ldcs(weights + i + j) : 0u;
            }
        }
        bool keep[kKeysPerThread];
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++)
            keep[j] = w[j] != 0 && (!kBand || (h[j] >= bmin && h[j] < bmax));
        if constexpr (TM >= 0) {
            unsigned c[kKeysPerThread];
            min_over_tables<TM>(table, g, T, h, keep, c);
#pragma unroll
            for (int j = 0; j < kKeysPerThread; j++) {
                const unsigned m = min(c[j], cap);
                keep[j] = keep[j] &&
                          (consume_masked ? m >= threshold : m <= threshold);
            }
        }
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++) {
            w[j] = keep[j] ? w[j] : 0u;
            sum += w[j];
        }
        if (whole && vec) {
            __stcs((uint4*)(out + i), make_uint4(w[0], w[1], w[2], w[3]));
        } else {
#pragma unroll
            for (int j = 0; j < kKeysPerThread; j++)
                if (i + j < n) out[i + j] = w[j];
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_down_sync(0xFFFFFFFFu, sum, o);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
        u64 s = 0;
        for (int k = 0; k < (int)(blockDim.x >> 5); k++) s += warp_sum[k];
        if (s) atomicAdd(total, (unsigned long long)s);
    }
}

struct Args {
    const u64* hashes;
    const unsigned* weights;
    long long n;
    u64 bmin, bmax;
    const unsigned* table;
    int T;
    const long long* sizes;
    const long long* offs;
    const u64* recips;
    unsigned cap, threshold;
    bool consume_masked, vec;
    unsigned* out;
    unsigned long long* total;
};

template <bool kBand, int TM>
int launch(const Args& a, long long blocks, int threads, cudaStream_t s) {
    band_mask_kernel<kBand, TM><<<(unsigned)blocks, threads, 0, s>>>(
        a.hashes, a.weights, a.n, a.bmin, a.bmax, a.table, a.T, a.sizes,
        a.offs, a.recips, a.cap, a.threshold, a.consume_masked, a.vec, a.out,
        a.total);
    return (int)cudaGetLastError();
}

template <bool kBand>
int launch_masked(const Args& a, long long blocks, int threads,
                  cudaStream_t s) {
    switch (a.T) {
    case 1: return launch<kBand, 1>(a, blocks, threads, s);
    case 2: return launch<kBand, 2>(a, blocks, threads, s);
    case 3: return launch<kBand, 3>(a, blocks, threads, s);
    case 4: return launch<kBand, 4>(a, blocks, threads, s);
    default: return launch<kBand, 0>(a, blocks, threads, s);
    }
}

}  // namespace

// T = 0: no mask (table, sizes, offs and recips unused).  out is a fresh
// allocation; hashes and weights may be views, and take the vector loads
// only when both they and out are 16-byte aligned.  *total (u64) is added
// to, never read.
extern "C" int khmer_band_mask_weights(
        const void* hashes, const void* weights, long long n, int banded,
        unsigned long long bmin, unsigned long long bmax, const void* table,
        int T, const void* sizes, const void* offs, const void* recips,
        unsigned cap, unsigned threshold, int consume_masked, void* out,
        void* total, void* stream) {
    if (T < 0 || T > kMaxTables || (!banded && T == 0))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    // a thread for every four lanes, in blocks small enough that a short
    // batch still reaches every SM (K3's launch)
    const int sms = sm_count();
    const long long quads = (n + kKeysPerThread - 1) / kKeysPerThread;
    int threads = kFilterThreads;
    while (threads > 32 && quads < (long long)threads * sms) threads /= 2;
    const long long blocks = (quads + threads - 1) / threads;
    const Args a = {(const u64*)hashes, (const unsigned*)weights, n, bmin,
                    bmax, (const unsigned*)table, T,
                    (const long long*)sizes, (const long long*)offs,
                    (const u64*)recips, cap, threshold, consume_masked != 0,
                    (uintptr_t)hashes % 16 == 0 &&
                        (uintptr_t)weights % 16 == 0 &&
                        (uintptr_t)out % 16 == 0,
                    (unsigned*)out, (unsigned long long*)total};
    const cudaStream_t s = (cudaStream_t)stream;
    if (T == 0) return launch<true, -1>(a, blocks, threads, s);
    return banded ? launch_masked<true>(a, blocks, threads, s)
                  : launch_masked<false>(a, blocks, threads, s);
}

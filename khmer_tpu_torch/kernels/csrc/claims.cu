// K17 claim_news: the exact n_unique of the sharded consume.
//
// Replaces the claim arrays of khmer_tpu/parallel/sharded.py:
// make_claims_step (:359-383).  A distinct hash h of the consume, with
// first position f in the consume's k-mer stream, is new iff for some
// table t the bin of h was 0 before the consume (always, on a virgin
// table) and no hash of the consume with an earlier first position maps
// to that bin: the reference's sequential claim rule
// (khmer_tpu/ops/deferred.py docstring).  Two entry points, with the
// mesh's all-reduce min of the claim array between them:
//   (a) khmer_claim_scatter: claim[off_t + h % p_t] = min(itself, f) for
//       every table and every live lane (key not 2^64 - 1, weight not 0),
//       by atomicMin into one u32 array of the sketch's total bins;
//   (b) khmer_claim_count: a live lane is new iff claim[bin_t] == f and
//       (virgin, or base[bin_t] == 0) for some t; the new lanes are counted
//       with a warp and block reduction and added to *n_new.
// h % p by the Barrett reciprocals of common.cuh.
// Bound: bytes, the lanes (16 bytes) read once by each pass, the T claim
// bins of each live lane written (a) and read (b), and the T base bins
// read in (b); each bin is a random 32-byte sector of an array far larger
// than L2.

#include "common.cuh"

namespace {

constexpr u64 kSentinel = ~0ULL;
constexpr unsigned kMaxBlocks = 132 * 16;

inline unsigned grid_for(long long n) {
    const long long b = (n + kThreads - 1) / kThreads;
    return (unsigned)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

__global__ void __launch_bounds__(kThreads)
claim_scatter_kernel(const u64* __restrict__ keys,
                     const unsigned* __restrict__ wgts,
                     const unsigned* __restrict__ firsts, long long n, int T,
                     const long long* __restrict__ sizes,
                     const long long* __restrict__ offs,
                     const u64* __restrict__ recips,
                     unsigned* __restrict__ claim) {
    __shared__ Geometry g;
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const u64 h = __ldcs(keys + i);
        if (h == kSentinel || __ldcs(wgts + i) == 0u) continue;
        const unsigned f = __ldcs(firsts + i);
        for (int t = 0; t < T; t++) {
            unsigned* c = claim + bin_in(g, h, t);
            if (f < __ldcg(c)) atomicMin(c, f);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
claim_count_kernel(const u64* __restrict__ keys,
                   const unsigned* __restrict__ wgts,
                   const unsigned* __restrict__ firsts, long long n, int T,
                   const long long* __restrict__ sizes,
                   const long long* __restrict__ offs,
                   const u64* __restrict__ recips,
                   const unsigned* __restrict__ claim,
                   const unsigned* __restrict__ base,
                   unsigned long long* __restrict__ n_new) {
    __shared__ Geometry g;
    __shared__ unsigned warp_sums[kThreads / 32];
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    unsigned c = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const u64 h = __ldcs(keys + i);
        if (h == kSentinel || __ldcs(wgts + i) == 0u) continue;
        const unsigned f = __ldcs(firsts + i);
        bool fresh = false;
        for (int t = 0; t < T && !fresh; t++) {
            const long long b = bin_in(g, h, t);
            fresh = __ldg(claim + b) == f && (!base || __ldg(base + b) == 0u);
        }
        c += fresh;
    }
    c = __reduce_add_sync(0xFFFFFFFFu, c);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned s = 0;
        for (int w = 0; w < kThreads / 32; w++) s += warp_sums[w];
        if (s) atomicAdd(n_new, (unsigned long long)s);
    }
}

}  // namespace

// keys, wgts, firsts [n] (u64, u32, u32); claim: u32 [total bins (+1)],
// set to 2^32 - 1 by the caller; 1 <= T <= kMaxTables.
extern "C" int khmer_claim_scatter(const void* keys, const void* wgts,
                                   const void* firsts, long long n, int T,
                                   const void* sizes, const void* offs,
                                   const void* recips, void* claim,
                                   void* stream) {
    if (T < 1 || T > kMaxTables || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    claim_scatter_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const u64*)keys, (const unsigned*)wgts, (const unsigned*)firsts, n,
        T, (const long long*)sizes, (const long long*)offs,
        (const u64*)recips, (unsigned*)claim);
    return (int)cudaGetLastError();
}

// as khmer_claim_scatter, with the mesh's claim array, the pre-consume
// table base (u32 [total bins (+1)], or NULL for a virgin table) and
// n_new (int64 [1]), added to
extern "C" int khmer_claim_count(const void* keys, const void* wgts,
                                 const void* firsts, long long n, int T,
                                 const void* sizes, const void* offs,
                                 const void* recips, const void* claim,
                                 const void* base, void* n_new,
                                 void* stream) {
    if (T < 1 || T > kMaxTables || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    claim_count_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const u64*)keys, (const unsigned*)wgts, (const unsigned*)firsts, n,
        T, (const long long*)sizes, (const long long*)offs,
        (const u64*)recips, (const unsigned*)claim, (const unsigned*)base,
        (unsigned long long*)n_new);
    return (int)cudaGetLastError();
}

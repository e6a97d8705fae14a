// K4: abundance histogram over a chunk's new, sorted k-mer hashes.
//
// Replaces khmer_tpu/hashtable.py:_make_abund_dist_fn (:414-456) and
// _make_abund_flush_fn (:357-384).  The caller has already dropped the
// lanes that are masked or already in the tracking filter and sorted the
// rest (torch.sort, as the JAX path sorts with an XLA sort outside any
// kernel).  Each lane that starts a run of equal hashes reads its count
// -- the min over tables of the main sketch, capped at the read cap --
// and adds one to hist[count] (a u64[65536] histogram).
//
// Bound: bytes, 8 + 4 T read per lane plus the histogram; hot
// histogram bins see many atomics (most k-mers share a few counts).

#include "common.cuh"

__global__ void abund_hist_kernel(const u64* __restrict__ keys, long long n,
                                  const unsigned* __restrict__ table, int T,
                                  const long long* __restrict__ sizes,
                                  const long long* __restrict__ offs,
                                  const u64* __restrict__ recips,
                                  unsigned cap, u64* __restrict__ hist) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const u64 h = keys[i];
    if (i > 0 && keys[i - 1] == h) return;
    unsigned m = 0xFFFFFFFFu;
    for (int t = 0; t < T; t++)
        m = min(m, table[bin_of(h, t, sizes, offs, recips)]);
    atomicAdd(hist + min(m, cap), 1ULL);
}

extern "C" int khmer_abund_hist(const void* keys, long long n,
                                const void* table, int T, const void* sizes,
                                const void* offs, const void* recips,
                                unsigned cap, void* hist, void* stream) {
    abund_hist_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const u64*)keys, n, (const unsigned*)table, T,
        (const long long*)sizes, (const long long*)offs, (const u64*)recips,
        cap, (u64*)hist);
    return (int)cudaGetLastError();
}

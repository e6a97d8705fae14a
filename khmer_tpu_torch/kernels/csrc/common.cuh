// Shared helpers for the khmer_tpu_torch CUDA kernels (sm_90a).
//
// Conventions of every kernel in this directory:
//  * hashes are uint64 (the host holds them in int64 tensors);
//  * a sketch is ONE flat uint32 array of sum(sizes) + 1 bins; table t
//    owns bins [offs[t], offs[t] + sizes[t]) and a hash lands in bin
//    h % sizes[t] + offs[t] (ops/sketch_ops.py:_bin_idx in khmer_tpu);
//  * kernels launch on the caller's stream, allocate nothing and never
//    synchronise; each extern "C" entry returns cudaGetLastError().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

// h % p by a reciprocal (Barrett) multiply: m = floor((2^64 - 1) / p) is
// computed on the host (ops/sketch_ops.py:barrett_recips).  q = the high
// word of h * m is at most two below floor(h / p), so at most two
// subtractions finish the remainder; the Python mirror of these lines is
// tested against % for p = 1, 2, 3, the bench primes and a p > 2^32.
__device__ __forceinline__ u64 mod_barrett(u64 h, u64 p, u64 m) {
    u64 r = h - __umul64hi(h, m) * p;
    if (r >= p) r -= p;
    if (r >= p) r -= p;
    return r;
}

__device__ __forceinline__ long long bin_of(u64 h, int t,
                                            const long long* sizes,
                                            const long long* offs,
                                            const u64* recips) {
    return (long long)mod_barrett(h, (u64)__ldg(sizes + t),
                                  __ldg(recips + t)) + __ldg(offs + t);
}

// murmur's 64-bit finalizer, a bijection of u64: it spreads the 2-bit
// hashes (raw k-mer values below 4^k) over all 64 bits before a band or a
// hash slot is taken from them (khmer_tpu/ops/hashing.py:_fmix64_v)
__device__ __forceinline__ u64 mix64(u64 x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

// ---- the gather of K3 and K4 -----------------------------------------------

constexpr int kMaxTables = 32;
constexpr int kKeysPerThread = 4;

// A sketch's geometry, staged in shared memory by each block.
struct Geometry {
    u64 size[kMaxTables];
    u64 recip[kMaxTables];
    long long off[kMaxTables];
};

__device__ __forceinline__ long long bin_in(const Geometry& g, u64 h,
                                            int t) {
    return (long long)mod_barrett(h, g.size[t], g.recip[t]) + g.off[t];
}

// The caller synchronises the block before the geometry is read.
__device__ __forceinline__ void load_geometry(Geometry& g, int T,
                                              const long long* sizes,
                                              const long long* offs,
                                              const u64* recips) {
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        g.size[t] = (u64)sizes[t];
        g.recip[t] = recips[t];
        g.off[t] = offs[t];
    }
}

// c[j] = min over the T tables of table[bin of h[j]] for every key with
// want[j] (0 for the others), read through the read-only path.  For
// T <= 4 (the template argument) every table's load of every key is
// issued before any min, kKeysPerThread * T loads in flight; T = 0 is
// the loop over the runtime T, which issues each table's loads together.
template <int T>
__device__ __forceinline__ void min_over_tables(
        const unsigned* __restrict__ table, const Geometry& g, int,
        const u64 (&h)[kKeysPerThread], const bool (&want)[kKeysPerThread],
        unsigned (&c)[kKeysPerThread]) {
    unsigned v[kKeysPerThread][T];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; j++)
#pragma unroll
        for (int t = 0; t < T; t++)
            v[j][t] = want[j] ? __ldg(table + bin_in(g, h[j], t)) : 0u;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; j++) {
        unsigned m = v[j][0];
#pragma unroll
        for (int t = 1; t < T; t++) m = min(m, v[j][t]);
        c[j] = m;
    }
}

template <>
__device__ __forceinline__ void min_over_tables<0>(
        const unsigned* __restrict__ table, const Geometry& g, int T,
        const u64 (&h)[kKeysPerThread], const bool (&want)[kKeysPerThread],
        unsigned (&c)[kKeysPerThread]) {
#pragma unroll
    for (int j = 0; j < kKeysPerThread; j++) c[j] = 0xFFFFFFFFu;
    for (int t = 0; t < T; t++) {
        unsigned v[kKeysPerThread];
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++)
            v[j] = want[j] ? __ldg(table + bin_in(g, h[j], t)) : 0u;
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++) c[j] = min(c[j], v[j]);
    }
}

// ---- the gather of K3t and K20 ---------------------------------------------

constexpr unsigned kNoBin = 0xFFFFFFFFu;  // what a bin not gathered reads

// The SMs of the calling thread's device, read once a process (the
// process's cards are of one kind).
static inline int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return sms;
}

// Threads a block for a kernel of kKeysPerThread keys a thread: kThreads,
// halved down to a warp while `quads` threads would not fill a block on
// every one of `sms` SMs, so that a short call still reaches them all.
inline int quad_threads(long long quads, int sms) {
    int threads = kThreads;
    while (threads > 32 && quads < (long long)threads * sms) threads /= 2;
    return threads;
}

// The keys i .. i + kKeysPerThread - 1 of hashes [n], i < n: as two
// 16-byte streaming loads when `vec` (hashes 16-byte aligned) and all
// four lie below n, else one by one; live[j] = i + j < n (0 past n).
__device__ __forceinline__ void load_keys(const u64* __restrict__ hashes,
                                          long long i, long long n,
                                          bool vec, u64 (&h)[kKeysPerThread],
                                          bool (&live)[kKeysPerThread]) {
    if (vec && i + kKeysPerThread <= n) {
        const ulonglong2 a = __ldcs((const ulonglong2*)(hashes + i));
        const ulonglong2 b = __ldcs((const ulonglong2*)(hashes + i + 2));
        h[0] = a.x, h[1] = a.y, h[2] = b.x, h[3] = b.y;
    } else {
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++)
            h[j] = i + j < n ? __ldcs(hashes + i + j) : 0;
    }
#pragma unroll
    for (int j = 0; j < kKeysPerThread; j++) live[j] = i + j < n;
}

// Bit t set where table t's bins [off_t, off_t + p_t) meet the bins
// [lo, lo + len) of a piece; the caller synchronises the geometry first.
__device__ __forceinline__ unsigned tables_meeting(const Geometry& g, int T,
                                                   long long lo,
                                                   long long len) {
    unsigned m = 0u;
    for (int t = 0; t < T; t++)
        if (g.off[t] < lo + len && g.off[t] + (long long)g.size[t] > lo)
            m |= 1u << t;
    return m;
}

// the len of a piece that is the whole table (with lo = 0)
constexpr long long kAllBins = 0x7FFFFFFFFFFFFFFFLL;

// v[j] = piece[b - lo] for table t's bin b of each live key h[j] where
// lo <= b < lo + len, else kNoBin: the kKeysPerThread loads go out
// together through the read-only path.
__device__ __forceinline__ void gather_table(
        const unsigned* __restrict__ piece, const Geometry& g, int t,
        long long lo, long long len, const u64 (&h)[kKeysPerThread],
        const bool (&live)[kKeysPerThread], unsigned (&v)[kKeysPerThread]) {
#pragma unroll
    for (int j = 0; j < kKeysPerThread; j++) {
        const long long b = bin_in(g, h[j], t) - lo;
        v[j] = live[j] && b >= 0 && b < len ? __ldg(piece + b) : kNoBin;
    }
}

// gather_table for each table t < T (the template argument) whose bit is
// set in `tables`, kNoBin for the others: every load of every key is
// issued before the caller reads any, T * kKeysPerThread in flight, and
// no bin is computed for a table the mask leaves out.
template <int T>
__device__ __forceinline__ void gather_tables(
        const unsigned* __restrict__ piece, const Geometry& g,
        unsigned tables, long long lo, long long len,
        const u64 (&h)[kKeysPerThread], const bool (&live)[kKeysPerThread],
        unsigned (&v)[T][kKeysPerThread]) {
#pragma unroll
    for (int t = 0; t < T; t++) {
        if ((tables >> t) & 1u) {
            gather_table(piece, g, t, lo, len, h, live, v[t]);
        } else {
#pragma unroll
            for (int j = 0; j < kKeysPerThread; j++) v[t][j] = kNoBin;
        }
    }
}

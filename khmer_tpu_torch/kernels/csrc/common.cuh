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

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

// The 64-bit modulo is emulated in software on the card (tens of
// instructions); it is the bulk of each sketch kernel's arithmetic.
__device__ __forceinline__ long long bin_of(u64 h, int t,
                                            const long long* sizes,
                                            const long long* offs) {
    return (long long)(h % (u64)__ldg(sizes + t)) + __ldg(offs + t);
}

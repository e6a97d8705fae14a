// K10 cc_rounds: rounds of min-label propagation with pointer jumping.
//
// Replaces khmer_tpu/partition_device.py:cc_rounds (:42-65), the device
// engine of SubsetPartition.do_partition_device.  Over u32 labels [T]
// (node indices) and an undirected edge list src, dst [E] (padding edges
// (0, 0)), each round is JAX's Jacobi step, exactly:
//   m = lab.at[dst].min(lab[src]);  m = m.at[src].min(m[dst]);
//   m = m[m];  m = m[m];
// and the call reports whether any round's output differed from its
// input.  As in JAX, a gather clamps its index into [0, T) and a scatter
// drops a target outside it.
//
// Design: four plain launches a round over three label buffers (the
// output A and two scratch buffers X, Y), so that every launch reads
// only buffers that no thread of it writes.  A relax gives each thread
// edges and atomicMins the gathered label into the target's buffer,
// which holds a copy of the round's labels beforehand; a minimum does
// not depend on the order of the atomics, so the result is JAX's bit for
// bit on any input.  A thread reads the target first and skips the
// atomic when it would not lower it (labels only fall).  The round:
//   relax(src -> dst, read A, into X = copy of A); copy Y = X;
//   relax(dst -> src, read X, into Y); jump X = Y[Y];
//   jump A = Y' = X[X], flagging a label that differs from A's;
// then X and Y swap roles, Y' being the next round's copy of A.  The
// flag is an int32 set by one atomicOr a block (__syncthreads_or).
//
// The sharded round (khmer_tpu/partition_device.py:make_sharded_cc_round,
// :80-110) puts an all-reduce min of the labels between the relaxes and
// the jumps, so the same kernels also run as two entry points:
// khmer_cc_relax (the two relaxes of one round over a shard's edges,
// labels in, relaxed labels out) and khmer_cc_jump (the two jumps, and
// the flag of a label that differs from the round's input).
//
// Bound: bytes, per round the edges (8 bytes each) read twice with a
// random 4-byte gather and atomic each, and the labels read and written
// about six times; chip_smoke.py (phase 3d) states the call's bound as
// the edges and labels read once and the labels written once.  On an
// NVIDIA H100 80GB HBM3 at 700 W see PERF.md for the measured times.

#include "common.cuh"

namespace {

constexpr unsigned kMaxBlocks = 132 * 8;

inline unsigned cc_blocks(long long n) {
    const long long b = (n + kThreads - 1) / kThreads;
    return (unsigned)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

__device__ __forceinline__ unsigned at(unsigned i, unsigned T) {
    return i < T ? i : T - 1;
}

// out[to[e]] = min(out[to[e]], in[from[e]]) for every edge
__global__ void __launch_bounds__(kThreads)
relax_kernel(const unsigned* __restrict__ from,
             const unsigned* __restrict__ to, long long E, unsigned T,
             const unsigned* __restrict__ in, unsigned* out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < E; e += stride) {
        const unsigned t = __ldg(to + e);
        if (t >= T) continue;
        const unsigned v = __ldg(in + at(__ldg(from + e), T));
        if (v < __ldcg(out + t)) atomicMin(out + t, v);
    }
}

// out[i] = in[in[i]]
__global__ void __launch_bounds__(kThreads)
jump_kernel(const unsigned* __restrict__ in, unsigned T,
            unsigned* __restrict__ out) {
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < T;
         i += gridDim.x * blockDim.x)
        out[i] = __ldg(in + at(__ldg(in + i), T));
}

// v = in[in[i]]; lab[i] = copy[i] = v; *changed |= any v != lab[i]
__global__ void __launch_bounds__(kThreads)
jump_last_kernel(const unsigned* __restrict__ in, unsigned T,
                 unsigned* __restrict__ lab, unsigned* __restrict__ copy,
                 int* changed) {
    int differs = 0;
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < T;
         i += gridDim.x * blockDim.x) {
        const unsigned v = __ldg(in + at(__ldg(in + i), T));
        differs |= v != lab[i];
        lab[i] = v;
        copy[i] = v;
    }
    if (__syncthreads_or(differs) && threadIdx.x == 0) atomicOr(changed, 1);
}

// v = in[in[i]]; out[i] = v; *changed |= any v != lab[i]
__global__ void __launch_bounds__(kThreads)
jump_cmp_kernel(const unsigned* __restrict__ in, unsigned T,
                const unsigned* __restrict__ lab, unsigned* __restrict__ out,
                int* changed) {
    int differs = 0;
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < T;
         i += gridDim.x * blockDim.x) {
        const unsigned v = __ldg(in + at(__ldg(in + i), T));
        differs |= v != __ldg(lab + i);
        out[i] = v;
    }
    if (__syncthreads_or(differs) && threadIdx.x == 0) atomicOr(changed, 1);
}

}  // namespace

// One round's relaxes over a shard's edges: X = labels, relaxed towards
// dst; out = X relaxed towards src.  labels, out and scratch hold T u32.
extern "C" int khmer_cc_relax(const void* labels, const void* src,
                              const void* dst, long long T, long long E,
                              void* out, void* scratch, void* stream) {
    if (T < 1 || T > 0x7FFFFFFFLL || E < 0 || E > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const size_t bytes = (size_t)T * sizeof(unsigned);
    const unsigned* A = (const unsigned*)labels;
    unsigned* X = (unsigned*)scratch;
    unsigned* Y = (unsigned*)out;
    const unsigned* S = (const unsigned*)src;
    const unsigned* D = (const unsigned*)dst;
    cudaError_t err;
    if ((err = cudaMemcpyAsync(X, A, bytes, cudaMemcpyDeviceToDevice, s)))
        return (int)err;
    relax_kernel<<<cc_blocks(E), kThreads, 0, s>>>(S, D, E, (unsigned)T, A,
                                                   X);
    if ((err = cudaMemcpyAsync(Y, X, bytes, cudaMemcpyDeviceToDevice, s)))
        return (int)err;
    relax_kernel<<<cc_blocks(E), kThreads, 0, s>>>(D, S, E, (unsigned)T, X,
                                                   Y);
    return (int)cudaGetLastError();
}

// One round's jumps: out = m[m] taken twice (scratch holds the first);
// *changed |= some out[i] != labels[i] (the round's input labels); the
// caller zeroes changed.  m, labels, out and scratch hold T u32.
extern "C" int khmer_cc_jump(const void* m, long long T, const void* labels,
                             void* out, void* scratch, void* changed,
                             void* stream) {
    if (T < 1 || T > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned t = (unsigned)T;
    jump_kernel<<<cc_blocks(T), kThreads, 0, s>>>((const unsigned*)m, t,
                                                  (unsigned*)scratch);
    jump_cmp_kernel<<<cc_blocks(T), kThreads, 0, s>>>(
        (const unsigned*)scratch, t, (const unsigned*)labels,
        (unsigned*)out, (int*)changed);
    return (int)cudaGetLastError();
}

// labels_in [T] is read only; labels_out [T] gets the result; scratch
// holds 2 * T u32; changed (one int32) is set to 0 or 1.  T and E are
// below 2^31, T >= 1, rounds >= 1.
extern "C" int khmer_cc_rounds(const void* labels_in, const void* src,
                               const void* dst, long long T, long long E,
                               int rounds, void* labels_out, void* scratch,
                               void* changed, void* stream) {
    if (T < 1 || T > 0x7FFFFFFFLL || E < 0 || E > 0x7FFFFFFFLL ||
            rounds < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const size_t bytes = (size_t)T * sizeof(unsigned);
    unsigned* A = (unsigned*)labels_out;
    unsigned* X = (unsigned*)scratch;
    unsigned* Y = X + T;
    const unsigned* S = (const unsigned*)src;
    const unsigned* D = (const unsigned*)dst;
    const unsigned t = (unsigned)T;
    cudaError_t err;
    if ((err = cudaMemsetAsync(changed, 0, sizeof(int), s)) ||
            (err = cudaMemcpyAsync(A, labels_in, bytes,
                                   cudaMemcpyDeviceToDevice, s)) ||
            (err = cudaMemcpyAsync(X, A, bytes, cudaMemcpyDeviceToDevice,
                                   s)))
        return (int)err;
    for (int r = 0; r < rounds; r++) {
        relax_kernel<<<cc_blocks(E), kThreads, 0, s>>>(S, D, E, t, A, X);
        if ((err = cudaMemcpyAsync(Y, X, bytes, cudaMemcpyDeviceToDevice,
                                   s)))
            return (int)err;
        relax_kernel<<<cc_blocks(E), kThreads, 0, s>>>(D, S, E, t, X, Y);
        jump_kernel<<<cc_blocks(T), kThreads, 0, s>>>(Y, t, X);
        jump_last_kernel<<<cc_blocks(T), kThreads, 0, s>>>(X, t, A, Y,
                                                           (int*)changed);
        unsigned* tmp = X;
        X = Y;
        Y = tmp;
        if ((err = cudaGetLastError())) return (int)err;
    }
    return (int)cudaGetLastError();
}

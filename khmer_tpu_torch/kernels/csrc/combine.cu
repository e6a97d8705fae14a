// K16 combine_lanes: duplicate hashes of a lane buffer combined.
//
// Replaces the sorts of khmer_tpu/ops/deferred.py:combine_unit_lanes
// (:270-294) and combine_lanes (:297-325), which the sharded consume runs
// on every shard's buffer and on every owner's received lanes
// (khmer_tpu/parallel/sharded.py:241-281).  Every lane whose key is not
// 2^64 - 1 is live; the distinct live keys come out compacted to the
// front, each with its total and its first position:
//   total = min(sum of min(w, 2^20) over its lanes mod 2^32, 2^20),
//   first = min of its lanes' positions (u32),
// the other slots (2^64 - 1, 0, 2^32 - 1), and n_valid the number of
// distinct keys.  The TPU sorted because its scatter was slow; the order of
// the output is unspecified here (the slots' order), and nothing that reads
// it depends on order (routing, claims, the scatter-add and the bigcount
// candidates are sets).
//
// Design: a hash aggregate in device memory, two launches after three
// memsets.  The table has S >= 2n slots, a power of two, of (u64 key, u32
// sum, u32 first), keys set to 2^64 - 1 (empty) and firsts to 2^32 - 1 by
// memset.
//   insert:  lanes a warp at a time; __match_any_sync finds the lanes of
//            one key in the warp, whose leader adds their clamped weights
//            and takes their least position (skipped when the warp's keys
//            are all distinct); the leader probes linearly from
//            mix64(key) & (S - 1), claims an empty slot with atomicCAS on
//            the key, then atomicAdd's the sum (wrapping mod 2^32, as the
//            TPU's cumulative sum does) and atomicMin's the first;
//   compact: a thread a slot; a warp ballot and one atomicAdd a warp give
//            each live slot its output place.
// A hot key (poly-A) keeps its probe chain at one slot, and the warp's
// aggregation cuts its atomics 32-fold.
// Bound: bytes, the n lanes read once and the n output slots written once
// (16 bytes each); the design also writes and reads the 16-byte slots.

#include "common.cuh"

namespace {

constexpr u64 kEmpty = ~0ULL;
constexpr unsigned kIdxSentinel = 0xFFFFFFFFu;
constexpr unsigned kClamp = 1u << 20;
constexpr unsigned kMaxBlocks = 132 * 16;

inline unsigned grid_for(long long n) {
    const long long b = (n + kThreads - 1) / kThreads;
    return (unsigned)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

__global__ void __launch_bounds__(kThreads)
combine_insert_kernel(const u64* __restrict__ keys,
                      const unsigned* __restrict__ wgts,
                      const unsigned* __restrict__ firsts, long long n,
                      u64* slot_k, unsigned* slot_w, unsigned* slot_f,
                      u64 mask) {
    const int lane = threadIdx.x & 31;
    // every lane of a warp runs the same number of iterations
    const long long n_pad = (n + 31) & ~31LL;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_pad; i += stride) {
        u64 k = kEmpty;
        unsigned w = 0u, f = kIdxSentinel;
        if (i < n) {
            k = __ldg(keys + i);
            w = min(__ldg(wgts + i), kClamp);
            f = __ldg(firsts + i);
        }
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, k);
        if (!__all_sync(0xFFFFFFFFu, peers == (1u << lane))) {
            unsigned ws = 0u, fm = kIdxSentinel;
            for (int j = 0; j < 32; j++) {
                const unsigned x = __shfl_sync(0xFFFFFFFFu, w, j);
                const unsigned y = __shfl_sync(0xFFFFFFFFu, f, j);
                if (peers >> j & 1u) {
                    ws += x;
                    fm = min(fm, y);
                }
            }
            w = ws;
            f = fm;
        }
        if (k == kEmpty || (peers & ((1u << lane) - 1u))) continue;
        u64 s = mix64(k) & mask;
        while (true) {
            const u64 cur = __ldcg(slot_k + s);
            if (cur == k) break;
            if (cur == kEmpty) {
                const u64 old = atomicCAS(
                    (unsigned long long*)(slot_k + s), kEmpty, k);
                if (old == kEmpty || old == k) break;
            }
            s = (s + 1) & mask;
        }
        atomicAdd(slot_w + s, w);
        atomicMin(slot_f + s, f);
    }
}

__global__ void __launch_bounds__(kThreads)
combine_compact_kernel(const u64* __restrict__ slot_k,
                       const unsigned* __restrict__ slot_w,
                       const unsigned* __restrict__ slot_f, long long S,
                       u64* __restrict__ out_k, unsigned* __restrict__ out_w,
                       unsigned* __restrict__ out_f,
                       unsigned long long* __restrict__ n_valid) {
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;
    // S is a power of two >= 64, so every warp runs whole iterations
    for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         s < S; s += stride) {
        const u64 k = slot_k[s];
        const bool live = k != kEmpty;
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
        if (!ballot) continue;
        unsigned long long at = 0;
        if (lane == 0) at = atomicAdd(n_valid, (unsigned long long)
                                      __popc(ballot));
        at = __shfl_sync(0xFFFFFFFFu, at, 0);
        if (live) {
            const long long o = (long long)at +
                                __popc(ballot & ((1u << lane) - 1u));
            out_k[o] = k;
            out_w[o] = min(slot_w[s], kClamp);
            out_f[o] = slot_f[s];
        }
    }
}

}  // namespace

// keys, wgts, firsts [n]; out_k, out_w, out_f [n]; slots: S * 16 bytes
// (S a power of two, S >= 2n, S >= 64): S u64 keys, S u32 sums, S u32
// firsts; n_valid int64 [1].  0 < n < 2^31.
extern "C" int khmer_combine_lanes(const void* keys, const void* wgts,
                                   const void* firsts, long long n,
                                   void* out_k, void* out_w, void* out_f,
                                   void* n_valid, void* slots, long long S,
                                   void* stream) {
    if (n < 1 || n > 0x7FFFFFFFLL || S < 2 * n || S < 64 || (S & (S - 1)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    u64* slot_k = (u64*)slots;
    unsigned* slot_w = (unsigned*)(slot_k + S);
    unsigned* slot_f = slot_w + S;
    cudaError_t err;
    if ((err = cudaMemsetAsync(slot_k, 0xFF, (size_t)S * 8, s)) ||
            (err = cudaMemsetAsync(slot_w, 0, (size_t)S * 4, s)) ||
            (err = cudaMemsetAsync(slot_f, 0xFF, (size_t)S * 4, s)) ||
            (err = cudaMemsetAsync(out_k, 0xFF, (size_t)n * 8, s)) ||
            (err = cudaMemsetAsync(out_w, 0, (size_t)n * 4, s)) ||
            (err = cudaMemsetAsync(out_f, 0xFF, (size_t)n * 4, s)) ||
            (err = cudaMemsetAsync(n_valid, 0, 8, s)))
        return (int)err;
    combine_insert_kernel<<<grid_for(n), kThreads, 0, s>>>(
        (const u64*)keys, (const unsigned*)wgts, (const unsigned*)firsts, n,
        slot_k, slot_w, slot_f, (u64)(S - 1));
    if ((err = cudaGetLastError())) return (int)err;
    combine_compact_kernel<<<grid_for(S), kThreads, 0, s>>>(
        slot_k, slot_w, slot_f, S, (u64*)out_k, (unsigned*)out_w,
        (unsigned*)out_f, (unsigned long long*)n_valid);
    return (int)cudaGetLastError();
}

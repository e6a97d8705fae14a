// K13 count_nonzero and K14 pack_oxli_bytes: the OXLI save of a sketch on
// the card.
//
// K13 replaces khmer_tpu/ops/sketch_ops.py:occupied_bins (:234-237): the
// number of nonzero bins of table[begin, end), each block counting a tile
// of kTile bins (kItems loads a thread, coalesced) and adding its sum to
// one u64.  A bin is nonzero when its u32 is not 0, so bins >= 2^31
// (negative int32 patterns) count.
//
// K14 replaces khmer_tpu/ops/sketch_ops.py:pack_oxli_bytes (:246-275) and,
// as the save's one route, _sparse_extract (:278-287) with the sparse
// assembly (:315-336): the OXLI byte stream of every table, one thread an
// output byte, so that only the stream crosses to the host.  Byte kind:
// min(bin, 255); nibble: the even bin in the high nibble and the odd one
// in the low, each capped at 15, with a trailing pad nibble
// (storage.hh:268-276), size / 2 + 1 bytes a table; bit: eight bins a
// byte, least-significant bit first, size / 8 + 1 bytes a table.  Caps
// compare unsigned, so bins >= 2^31 saturate.
//
// Bounds: K13 reads the range once; K14 reads the table once and writes
// the stream once.  Both over 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int kItems = 16;                   // loads a thread in K13
constexpr int kWarps = kThreads / 32;
constexpr long long kTile = (long long)kThreads * kItems;

// *total += the nonzero bins of table[0, n), a tile of kTile bins a block.
__global__ void __launch_bounds__(kThreads)
count_nonzero_kernel(const unsigned* __restrict__ table, long long n,
                     unsigned long long* __restrict__ total) {
    __shared__ unsigned warp_sums[kWarps];
    const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < kItems; j++) {
        const long long i = base + (long long)j * kThreads;
        c += (i < n && __ldg(table + i) != 0u);
    }
    c = __reduce_add_sync(0xFFFFFFFFu, c);
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; w++) s += warp_sums[w];
        if (s) atomicAdd(total, (unsigned long long)s);
    }
}

constexpr int kKindByte = 0, kKindNibble = 1, kKindBit = 2;

__global__ void __launch_bounds__(kThreads)
pack_oxli_kernel(const unsigned* __restrict__ table, int kind, int T,
                 const long long* __restrict__ sizes,
                 const long long* __restrict__ offs,
                 const long long* __restrict__ out_offs, long long n_out,
                 uint8_t* __restrict__ out) {
    __shared__ long long s_size[kMaxTables], s_off[kMaxTables],
        s_out[kMaxTables];
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        s_size[t] = sizes[t];
        s_off[t] = offs[t];
        s_out[t] = out_offs[t];
    }
    __syncthreads();
    const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (o >= n_out) return;
    // the table that holds output byte o: the last t with s_out[t] <= o
    int t = 0;
    for (int step = kMaxTables / 2; step > 0; step /= 2)
        if (t + step < T && s_out[t + step] <= o) t += step;
    const long long b = o - s_out[t], size = s_size[t];
    const unsigned* bins = table + s_off[t];
    unsigned byte;
    if (kind == kKindByte) {
        byte = min(__ldg(bins + b), 255u);
    } else if (kind == kKindNibble) {
        const long long i = 2 * b;
        const unsigned hi = i < size ? min(__ldg(bins + i), 15u) : 0u;
        const unsigned lo = i + 1 < size ? min(__ldg(bins + i + 1), 15u) : 0u;
        byte = hi << 4 | lo;
    } else {
        byte = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            const long long i = 8 * b + j;
            if (i < size && __ldg(bins + i) != 0u) byte |= 1u << j;
        }
    }
    out[o] = (uint8_t)byte;
}

}  // namespace

// K13: total (one u64, zeroed by the caller) += the nonzero bins of
// table[begin, end).
extern "C" int khmer_count_nonzero(const void* table, long long begin,
                                   long long end, void* total, void* stream) {
    if (begin < 0 || end < begin) return (int)cudaErrorInvalidValue;
    const long long n = end - begin;
    if (n == 0) return 0;
    count_nonzero_kernel<<<(unsigned)((n + kTile - 1) / kTile), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const unsigned*)table + begin, n, (unsigned long long*)total);
    return (int)cudaGetLastError();
}

// K14: kind 0 byte, 1 nibble, 2 bit; table t's bins start at offs[t] and
// its bytes at out_offs[t] (ascending) of out [n_out].
extern "C" int khmer_pack_oxli_bytes(const void* table, int kind, int T,
                                     const void* sizes, const void* offs,
                                     const void* out_offs, long long n_out,
                                     void* out, void* stream) {
    if (kind < kKindByte || kind > kKindBit || T < 1 || T > kMaxTables)
        return (int)cudaErrorInvalidValue;
    if (n_out == 0) return 0;
    pack_oxli_kernel<<<blocks_for(n_out), kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)table, kind, T, (const long long*)sizes,
        (const long long*)offs, (const long long*)out_offs, n_out,
        (uint8_t*)out);
    return (int)cudaGetLastError();
}

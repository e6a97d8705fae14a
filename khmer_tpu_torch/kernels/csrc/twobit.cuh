// The packed 2-bit tile that K1 (hash2bit.cu) and K5 (rows.cu) hash from:
// a block stages its codes 16 to a u32 word (the first code in the high
// bits), and a window's canonical hash is then O(1) (see hash2bit.cu).
#pragma once

#include "common.cuh"

namespace twobit {

constexpr u64 kComp = 0x5555555555555555ULL;

// 4 codes, one a byte (byte 0 first), to 8 bits, the first code highest
__device__ __forceinline__ unsigned pack4(unsigned b) {
    b &= 0x03030303u;
    return (b << 6 & 0xC0u) | (b >> 4 & 0x30u) | (b >> 14 & 0x0Cu) |
           (b >> 24);
}

// 16 bytes from p + g, those past n as 0: one 16-byte load when aligned
__device__ __forceinline__ uint4 load16(const uint8_t* p, long long g,
                                        long long n, bool vec) {
    if (vec && g + 16 <= n) return __ldcs((const uint4*)(p + g));
    u64 lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        if (g + j < n) lo |= (u64)p[g + j] << (8 * j);
        if (g + 8 + j < n) hi |= (u64)p[g + 8 + j] << (8 * j);
    }
    return make_uint4((unsigned)lo, (unsigned)(lo >> 32), (unsigned)hi,
                      (unsigned)(hi >> 32));
}

// 16 codes, one a byte, to one word, the first code highest
__device__ __forceinline__ unsigned pack16(uint4 v) {
    return pack4(v.x) << 24 | pack4(v.y) << 16 | pack4(v.z) << 8 |
           pack4(v.w);
}

// canonical hash of the window at code offset o of the packed tile
__device__ __forceinline__ u64 canonical(const unsigned* w, int o, int drop) {
    const int q = o >> 4, s = 2 * (o & 15);
    const unsigned a = w[q], b = w[q + 1], c = w[q + 2];
    const u64 x =
        (u64)__funnelshift_l(b, a, s) << 32 | __funnelshift_l(c, b, s);
    const u64 f = x >> drop;
    u64 r = __brevll(f ^ kComp);
    r = (r >> 1 & kComp) | (r & kComp) << 1;
    r >>= drop;
    return f < r ? f : r;
}

}  // namespace twobit

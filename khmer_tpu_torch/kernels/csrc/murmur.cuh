// The murmur tile that K8 (murmur.cu), K5's murmur variant (rows.cu) and
// K9 (hll.cu) hash from: a block stages its bytes, and the complement of
// each byte, in shared memory, and a window's canonical hash is
// MurmurHash3_x64_128's h1 of the window xor that of its reverse
// complement, or h1 alone when the two 128-bit hashes are equal (the
// palindrome rule of khmer_tpu/ops/hashing.py:kmer_hashes_murmur_bytes,
// :542; khmer's kmer_hash.cc:199-227).
//
// Layout: tile byte kPad + j holds flat byte base + j of the block, for
// j in [-kPad, lanes + k - 1 + kSlack); bytes outside the input read as 0.
// An 8-byte little-endian word at any byte offset is two funnel shifts
// over three aligned u32 loads.  The reverse complement is read backwards
// from the complemented tile: its word at offset off is the complemented
// word that ends at byte x + k - 1 - off, byte-reversed.  No window reads
// past its own k bytes: tail words are masked to the bytes they hold.
#pragma once

#include "common.cuh"

namespace murmur {

constexpr u64 kC1 = 0x87c37b91114253d5ULL;
constexpr u64 kC2 = 0x4cf5ad432745937fULL;
constexpr int kMaxK = 255;
constexpr int kPad = 8;     // an rc tail word starts up to 7 bytes early
constexpr int kSlack = 16;  // a tail word and its third u32 read late

// bytes of a tile of `lanes` window starts, a multiple of 16
constexpr int tile_bytes(int lanes) {
    return (kPad + lanes + kMaxK - 1 + kSlack + 15) / 16 * 16;
}

// khmer's `tbl` (kmer_hash.cc:51-54): 64..127 index " TVGH FCD  M KN
// YSAABW R" by (c & 31), lowercase complementing to uppercase, the rest
// ' '; with acgt, only A, C, G and T complement and the rest is ' ' (the
// bulk-consume form, hashing.py:525-532)
__device__ __forceinline__ uint8_t complement(unsigned c, bool acgt) {
    if (acgt)
        return c == 'A' ? 'T' : c == 'T' ? 'A' : c == 'C' ? 'G'
               : c == 'G' ? 'C' : ' ';
    if (c < 64 || c >= 128) return ' ';
    switch (c & 31) {
    case 1: return 'T';
    case 2: return 'V';
    case 3: return 'G';
    case 4: return 'H';
    case 6: return 'F';
    case 7: return 'C';
    case 8: return 'D';
    case 11: return 'M';
    case 13: return 'K';
    case 14: return 'N';
    case 18: return 'Y';
    case 19: return 'S';
    case 20: return 'A';
    case 21: return 'A';
    case 22: return 'B';
    case 23: return 'W';
    case 25: return 'R';
    default: return ' ';
    }
}

// Stage bytes [base - kPad, base - kPad + nbytes) of src (n bytes) and
// their complements; lut is a 256-byte shared table the caller gives.
// Ends with a block barrier.
__device__ __forceinline__ void stage(const uint8_t* __restrict__ src,
                                      long long n, long long base,
                                      int nbytes, bool acgt, uint8_t* lut,
                                      uint8_t* fwd, uint8_t* comp) {
    for (int c = threadIdx.x; c < 256; c += blockDim.x)
        lut[c] = complement(c, acgt);
    __syncthreads();
    for (int j = threadIdx.x; j < nbytes; j += blockDim.x) {
        const long long g = base - kPad + j;
        const uint8_t b = g >= 0 && g < n ? __ldg(src + g) : 0;
        fwd[j] = b;
        comp[j] = lut[b];
    }
    __syncthreads();
}

__device__ __forceinline__ u64 rotl(u64 x, int r) {
    return x << r | x >> (64 - r);
}

__device__ __forceinline__ u64 fmix(u64 x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

// the low n bytes of a word (n in 1..8)
__device__ __forceinline__ u64 low_bytes(u64 v, int n) {
    return n >= 8 ? v : v & ((1ULL << (8 * n)) - 1);
}

// the 8 bytes of s at offset a, little endian (s 4-byte aligned)
__device__ __forceinline__ u64 word8(const uint8_t* s, int a) {
    const unsigned* w = (const unsigned*)s + (a >> 2);
    const int sh = 8 * (a & 3);
    const unsigned w0 = w[0], w1 = w[1], w2 = w[2];
    return (u64)__funnelshift_r(w1, w2, sh) << 32 |
           __funnelshift_r(w0, w1, sh);
}

__device__ __forceinline__ u64 reverse_bytes(u64 v) {
    return (u64)__byte_perm((unsigned)v, 0, 0x0123) << 32 |
           __byte_perm((unsigned)(v >> 32), 0, 0x0123);
}

// word of the window at tile offset x, from its byte off
struct Forward {
    const uint8_t* s;
    int x;
    __device__ __forceinline__ u64 operator()(int off) const {
        return word8(s, x + off);
    }
};

// word of the reverse complement of the window at x (k bytes), from its
// byte off: complemented bytes x + k - 1 - off down to x + k - 8 - off
struct Reverse {
    const uint8_t* s;
    int x, k;
    __device__ __forceinline__ u64 operator()(int off) const {
        return reverse_bytes(word8(s, x + k - 8 - off));
    }
};

// MurmurHash3_x64_128 with seed 0 of k bytes given word by word:
// hashing.py:murmurhash3_x64_128 (:130-180)
template <class Word>
__device__ __forceinline__ void hash128(const Word& word, int k, u64& h1,
                                        u64& h2) {
    h1 = h2 = 0;
    const int nblocks = k >> 4;
    for (int i = 0; i < nblocks; i++) {
        u64 k1 = word(16 * i), k2 = word(16 * i + 8);
        k1 = rotl(k1 * kC1, 31) * kC2;
        h1 ^= k1;
        h1 = (rotl(h1, 27) + h2) * 5 + 0x52dce729;
        k2 = rotl(k2 * kC2, 33) * kC1;
        h2 ^= k2;
        h2 = (rotl(h2, 31) + h1) * 5 + 0x38495ab5;
    }
    const int tail = k & 15, toff = 16 * nblocks;
    if (tail > 8) {
        const u64 k2 = rotl(low_bytes(word(toff + 8), tail - 8) * kC2, 33);
        h2 ^= k2 * kC1;
    }
    if (tail > 0) {
        const u64 k1 = rotl(low_bytes(word(toff), tail) * kC1, 31);
        h1 ^= k1 * kC2;
    }
    h1 ^= (u64)k;
    h2 ^= (u64)k;
    h1 += h2;
    h2 += h1;
    h1 = fmix(h1);
    h2 = fmix(h2);
    h1 += h2;
    h2 += h1;
}

// canonical hash of the window at tile offset x
__device__ __forceinline__ u64 canonical(const uint8_t* fwd,
                                         const uint8_t* comp, int x, int k) {
    u64 f1, f2, r1, r2;
    hash128(Forward{fwd, x}, k, f1, f2);
    hash128(Reverse{comp, x, k}, k, r1, r2);
    return f1 == r1 && f2 == r2 ? f1 : f1 ^ r1;
}

}  // namespace murmur

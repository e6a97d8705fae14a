// K1: canonical 2-bit k-mer hashes of a flat code chunk, in stream order.
//
// Replaces khmer_tpu/ops/hashing.py:kmer_hashes_2bit_pm_u32 together with
// khmer_tpu/hashtable.py:_chunk_hashes_weights.  The TPU kernel packs the
// codes into u32 words and emits windows phase-major so that every lane
// shift is a constant.  Here lanes stay in stream order (lane i is the
// window that starts at code i, which is also the insertion order the
// claim rule of K2 needs), and each window costs O(1), not O(k):
//  * a block stages its tile of kLanes codes, plus the k-1 <= 31 that
//    follow, as a packed 2-bit stream in shared memory: 16 codes to a u32
//    word, the first code in the high bits, each word from one 16-byte
//    load.  The mask is staged the same way, as bytes;
//  * a window's forward value is the 2k bits at its offset: two funnel
//    shifts over three consecutive words give the 64 bits that start
//    there, and a right shift by 64 - 2k keeps the window;
//  * its reverse complement comes from the forward value without a loop:
//    complement every code (xor 0x55..55; A=0 T=1 C=2 G=3), reverse all
//    64 bits (__brevll), swap the two bits of each code back, and shift
//    right by 64 - 2k (the complemented zero codes above the window land
//    below bit 64 - 2k and drop out);
//  * each thread takes two neighbouring windows per round, so its 16-byte
//    hash store and 8-byte weight store are contiguous across the warp;
//    both are streaming stores, as nothing reads them from L2 before K2.
// The first version built both values with a k-step loop over bytes,
// O(k) 64-bit shifts a lane: at k=20 it was bound by instruction issue.
//
// Bound: bytes.  Per lane it reads 2 bytes (code + mask) and writes 12
// (u64 hash + u32 weight); the k-1 halo codes of a tile are read again by
// the next block, 2 words of 66.  Per lane the hashing loop issues 58
// SASS instructions whatever k is (cuobjdump -sass of the sm_90a build:
// 116 on the path that hashes and stores a pair of lanes): about 1.5e7
// warp instructions for a 2^23-lane chunk, under half of what 132 SMs
// issue in the time its 117 MB take at 3.35 TB/s.
//
// Codes past the end of the chunk read as 0 (A), as the TPU kernel's zero
// padding does, so even the masked tail lanes carry the same hash values.
// The weight is 1 when the loader's mask is set and the window ends
// inside the chunk (the `limit` of hashtable.py:112-114), else 0.

#include "twobit.cuh"

namespace {

using namespace twobit;

constexpr int kHashThreads = 256;
constexpr int kLanes = 1024;               // window starts per block
constexpr int kWords = kLanes / 16 + 2;    // packed codes, with the halo

__global__ void __launch_bounds__(kHashThreads)
hash2bit_canonical_kernel(const uint8_t* __restrict__ codes,
                          const uint8_t* __restrict__ mask, long long n,
                          int k, bool codes_vec, bool mask_vec,
                          u64* __restrict__ out_hash,
                          int* __restrict__ out_w) {
    __shared__ unsigned word[kWords];
    __shared__ uint4 msk4[kLanes / 16];
    const uint8_t* msk = (const uint8_t*)msk4;
    const long long base = (long long)blockIdx.x * kLanes;
    const int t = threadIdx.x;
    if (t < kWords)
        word[t] = pack16(load16(codes, base + 16 * t, n, codes_vec));
    else if (t >= 128 && t < 128 + kLanes / 16)
        msk4[t - 128] = load16(mask, base + 16 * (t - 128), n, mask_vec);
    __syncthreads();
    const int drop = 64 - 2 * k;
#pragma unroll
    for (int r = 0; r < kLanes / (2 * kHashThreads); r++) {
        const int o = 2 * (r * kHashThreads + t);
        const long long i = base + o;
        if (i >= n) break;
        const u64 h0 = canonical(word, o, drop);
        const u64 h1 = canonical(word, o + 1, drop);
        const int w0 = msk[o] != 0 && i + k <= n;
        const int w1 = msk[o + 1] != 0 && i + 1 + k <= n;
        if (i + 1 < n) {
            __stcs((ulonglong2*)(out_hash + i), make_ulonglong2(h0, h1));
            __stcs((int2*)(out_w + i), make_int2(w0, w1));
        } else {
            out_hash[i] = h0;
            out_w[i] = w0;
        }
    }
}

}  // namespace

// out_hash and out_w are fresh allocations (16-byte aligned); codes and
// mask may be views, and take the vector loads only when aligned.
extern "C" int khmer_hash2bit_canonical(const void* codes, const void* mask,
                                        long long n, int k, void* out_hash,
                                        void* out_w, void* stream) {
    if (k < 1 || k > 32) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + kLanes - 1) / kLanes);
    hash2bit_canonical_kernel<<<blocks, kHashThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)mask, n, k,
        (uintptr_t)codes % 16 == 0, (uintptr_t)mask % 16 == 0,
        (u64*)out_hash, (int*)out_w);
    return (int)cudaGetLastError();
}

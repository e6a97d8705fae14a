// K1: canonical 2-bit k-mer hashes of a flat code chunk, in stream order.
//
// Replaces khmer_tpu/ops/hashing.py:kmer_hashes_2bit_pm_u32 together with
// khmer_tpu/hashtable.py:_chunk_hashes_weights.  The TPU kernel packs the
// codes into u32 words and emits windows phase-major so that every lane
// shift is a constant; Hopper has native 64-bit shifts, so here one
// thread builds the forward value and the reverse complement of the
// window that starts at its lane directly, and lanes stay in stream
// order (lane i is window start i, which is also the insertion order the
// claim rule of K2 needs).
//
// Bound: bytes.  Per lane it reads 2 bytes (code + mask) and writes 12
// (u64 hash + u32 weight).  A block stages its codes plus the k-1 that
// follow in shared memory, so each code is read from device memory once.
//
// Codes: A=0 T=1 C=2 G=3 (complement = code ^ 1).  Codes past the end of
// the chunk read as 0 (A), as the TPU kernel's zero padding does, so even
// the masked tail lanes carry the same hash values.  The weight is 1 when
// the loader's mask is set and the window ends inside the chunk (the
// `limit` of hashtable.py:112-114), else 0.

#include "common.cuh"

__global__ void hash2bit_canonical_kernel(const uint8_t* __restrict__ codes,
                                          const uint8_t* __restrict__ mask,
                                          long long n, int k,
                                          u64* __restrict__ out_hash,
                                          int* __restrict__ out_w) {
    extern __shared__ uint8_t tile[];
    const long long base = (long long)blockIdx.x * blockDim.x;
    for (int j = threadIdx.x; j < (int)blockDim.x + k - 1; j += blockDim.x) {
        long long g = base + j;
        tile[j] = g < n ? (codes[g] & 3) : 0;
    }
    __syncthreads();
    const long long i = base + threadIdx.x;
    if (i >= n) return;
    u64 f = 0, r = 0;
    for (int j = 0; j < k; j++) {
        u64 c = tile[threadIdx.x + j];
        f = (f << 2) | c;
        r |= (c ^ 1ULL) << (2 * j);
    }
    out_hash[i] = f < r ? f : r;
    out_w[i] = (mask[i] != 0 && i + k <= n) ? 1 : 0;
}

extern "C" int khmer_hash2bit_canonical(const void* codes, const void* mask,
                                        long long n, int k, void* out_hash,
                                        void* out_w, void* stream) {
    size_t smem = kThreads + k - 1;
    hash2bit_canonical_kernel<<<blocks_for(n), kThreads, smem,
                                (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)mask, n, k, (u64*)out_hash,
        (int*)out_w);
    return (int)cudaGetLastError();
}

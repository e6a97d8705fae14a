// K8 murmur_hashes: the canonical murmur hash of every window of a padded
// batch of ASCII rows.
//
// Replaces khmer_tpu/ops/hashing.py:kmer_hashes_murmur_bytes (:507-546,
// with _murmur_windows :454, _fmix64_v :445 and _rotl64_v :441): bytes
// [B, L] u8 -> hashes [B, W] u64, W = L - k + 1, 1 <= k <= 255; the window
// at column j reads bytes j..j+k-1 of its row, whatever the row's length
// (the wrapper derives the valid mask from the lengths).  With acgt the
// complement is the bulk-consume form (A, C, G, T, else ' '), otherwise
// khmer's full IUPAC table.  The flat form of a chunk is one row.
//
// Design: one thread a window.  The batch is read as one flat stream of
// B * L bytes; a block stages its kLanes bytes plus the k - 1 that follow
// (and 8 before) in shared memory, once as they are and once complemented
// (murmur.cuh), and each thread hashes the window that starts at its lane
// forwards from the first copy and its reverse complement backwards from
// the second.  A lane in a column >= W is staged and not hashed.
//
// Bound: operations.  Per window it reads 1 byte and writes 8, but it
// runs two MurmurHash3_x64_128s of k bytes: ceil(k / 16) block rounds of
// four 64-bit multiplies each, plus the finalisers, every one a few
// 32-bit IMADs.  At k = 51 that is several hundred instructions a window
// against the 9 bytes; chip_smoke.py states the bytes bound beside the
// time.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3c) the
// 16,384 x 179 rows at k = 51 take about 0.10 ms, 15x their bytes bound,
// and a 2^23-base chunk at k = 20 about 0.32 ms.

#include "murmur.cuh"

namespace {

constexpr int kThreads8 = 256;
constexpr int kLanes = kThreads8;  // one window start a thread
constexpr int kTile = murmur::tile_bytes(kLanes);

__global__ void __launch_bounds__(kThreads8)
murmur_hashes_kernel(const uint8_t* __restrict__ byts, long long n, int L,
                     int k, bool acgt, u64* __restrict__ out) {
    __shared__ uint8_t lut[256];
    __shared__ __align__(16) uint8_t fwd[kTile];
    __shared__ __align__(16) uint8_t comp[kTile];
    const long long base = (long long)blockIdx.x * kLanes;
    murmur::stage(byts, n, base, kLanes + k - 1 + murmur::kPad +
                  murmur::kSlack, acgt, lut, fwd, comp);
    const long long i = base + threadIdx.x;
    if (i >= n) return;
    const long long row = i / L;
    const int col = (int)(i - row * L);
    const int W = L - k + 1;
    if (col >= W) return;
    out[row * W + col] =
        murmur::canonical(fwd, comp, murmur::kPad + threadIdx.x, k);
}

}  // namespace

// byts is [B, L] u8; out ([B, L - k + 1] u64) is a fresh allocation.
extern "C" int khmer_murmur_hashes(const void* byts, long long B, int L,
                                   int k, int acgt, void* out,
                                   void* stream) {
    if (k < 1 || k > murmur::kMaxK || L < k || B < 0)
        return (int)cudaErrorInvalidValue;
    const long long n = B * (long long)L;
    if (n == 0) return 0;
    const unsigned blocks = (unsigned)((n + kLanes - 1) / kLanes);
    murmur_hashes_kernel<<<blocks, kThreads8, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)byts, n, L, k, acgt != 0, (u64*)out);
    return (int)cudaGetLastError();
}

// K11 cyclic_hashes: the canonical cyclic hash of every window of a
// padded batch of ASCII rows.
//
// Replaces khmer_tpu/ops/rollinghash.py:kmer_hashes_cyclic_bytes (:155):
// bytes [B, L] u8 -> hashes [B, W] u64, W = L - k + 1, 1 <= k <= 255; the
// window at column j reads bytes j..j+k-1 of its row, whatever the row's
// length (the wrapper derives the valid mask from the lengths).  There is
// one table for every byte, so no complement form is chosen (khmer_tpu
// ignores assume_acgt here).  The flat form of a chunk is one row.
//
// Design: one thread a window, in closed form.  The batch is read as one
// flat stream of B * L bytes; a block stages T and C and then, for its
// kLanes bytes plus the k - 1 that follow, each byte's two table entries
// in shared memory (cyclic.cuh), and each thread XORs the k rotated
// entries of the window that starts at its lane.  A lane in a column >= W
// is staged and not hashed.
//
// Bound: operations.  Per window it reads 1 byte and writes 8, but it runs
// 2k shared loads, rotations and XORs (k = 20: about 200 instructions a
// window).  chip_smoke.py states the bytes bound beside the time.

#include "cyclic.cuh"

namespace {

constexpr int kThreads11 = 256;
constexpr int kLanes = kThreads11;  // one window start a thread
constexpr int kTile = kLanes + cyclic::kMaxK - 1;

__global__ void __launch_bounds__(kThreads11)
cyclic_hashes_kernel(const uint8_t* __restrict__ byts, long long n, int L,
                     int k, u64* __restrict__ out) {
    __shared__ u64 tab[2][256];
    __shared__ u64 fwd[kTile];
    __shared__ u64 rev[kTile];
    const long long base = (long long)blockIdx.x * kLanes;
    cyclic::stage(byts, n, base, kLanes + k - 1, tab, fwd, rev);
    const long long i = base + threadIdx.x;
    if (i >= n) return;
    const long long row = i / L;
    const int col = (int)(i - row * L);
    const int W = L - k + 1;
    if (col >= W) return;
    out[row * W + col] = cyclic::window(fwd, rev, threadIdx.x, k);
}

}  // namespace

// byts is [B, L] u8; out ([B, L - k + 1] u64) is a fresh allocation.
extern "C" int khmer_cyclic_hashes(const void* byts, long long B, int L,
                                   int k, void* out, void* stream) {
    if (k < 1 || k > cyclic::kMaxK || L < k || B < 0)
        return (int)cudaErrorInvalidValue;
    const long long n = B * (long long)L;
    if (n == 0) return 0;
    const unsigned blocks = (unsigned)((n + kLanes - 1) / kLanes);
    cyclic_hashes_kernel<<<blocks, kThreads11, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)byts, n, L, k, (u64*)out);
    return (int)cudaGetLastError();
}

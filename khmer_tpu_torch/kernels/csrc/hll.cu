// K9 hll_update: the HyperLogLog register update of a flat chunk of bases.
//
// Replaces khmer_tpu/hllcounter.py:_make_update_fn (:62-79): for every
// window start i <= n - k of a flat chunk of u8 ASCII bytes whose u8
// weight is not 0, h = K8's bulk-consume (acgt) hash of the window,
// idx = h & (m - 1) and rho = clz(h >> p) - p + 1 (64 - p + 1 when
// h >> p == 0, which __clzll gives as well), and registers[idx] =
// max(registers[idx], rho), over u8 registers [m], m = 2^p from an error
// rate (4 <= p <= 16), or any m with p = floor(log2 m) for an explicit
// register count as khmer_tpu allows.
//
// Design: K8's tile and hash, one thread a window; a lane of weight 0 is
// neither hashed nor stored.  CUDA has no 8-bit atomic max, so the byte
// is raised with a compare-and-swap of the aligned u32 word that holds
// it, after a plain read of that word: registers only rise, so a stale
// read is never above the true value, and once a register holds its
// maximum every later lane that maps to it stops at the read.  Registers
// are a max, so the result does not depend on the order of the lanes.
//
// Bound: operations, as K8 (two MurmurHash3_x64_128s a window); the bytes
// are 2 read a lane and the m register bytes written once.  On an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 3c) a 2^23-base chunk at
// k = 20 takes about 0.15 ms at p = 14 and at p = 16.

#include "murmur.cuh"

namespace {

constexpr int kThreads9 = 256;
constexpr int kLanes = kThreads9;
constexpr int kTile = murmur::tile_bytes(kLanes);

__device__ __forceinline__ void byte_max(uint8_t* regs, unsigned idx,
                                         unsigned rho) {
    unsigned* word = (unsigned*)(regs + (idx & ~3u));
    const int sh = 8 * (idx & 3);
    unsigned old = *(volatile unsigned*)word;
    while ((old >> sh & 0xFFu) < rho) {
        const unsigned prev =
            atomicCAS(word, old, (old & ~(0xFFu << sh)) | rho << sh);
        if (prev == old) break;
        old = prev;
    }
}

__global__ void __launch_bounds__(kThreads9)
hll_update_kernel(const uint8_t* __restrict__ byts,
                  const uint8_t* __restrict__ weights, long long n, int k,
                  int p, unsigned m, uint8_t* __restrict__ regs) {
    __shared__ uint8_t lut[256];
    __shared__ __align__(16) uint8_t fwd[kTile];
    __shared__ __align__(16) uint8_t comp[kTile];
    const long long base = (long long)blockIdx.x * kLanes;
    murmur::stage(byts, n, base, kLanes + k - 1 + murmur::kPad +
                  murmur::kSlack, true, lut, fwd, comp);
    const long long i = base + threadIdx.x;
    if (i > n - k || __ldg(weights + i) == 0) return;
    const u64 h = murmur::canonical(fwd, comp, murmur::kPad + threadIdx.x,
                                    k);
    const unsigned idx = (unsigned)h & (m - 1);
    const unsigned rho = (unsigned)(__clzll((long long)(h >> p)) - p + 1);
    byte_max(regs, idx, rho);
}

}  // namespace

// byts and weights are [n] u8; regs (m u8 registers, 4-byte aligned and
// readable up to the next multiple of 4) is updated in place.
extern "C" int khmer_hll_update(const void* byts, const void* weights,
                                long long n, int k, int p, unsigned m,
                                void* regs, void* stream) {
    if (k < 1 || k > murmur::kMaxK || p < 4 || p > 16 || m < (1u << p) ||
            m >= (2u << p) || (uintptr_t)regs % 4)
        return (int)cudaErrorInvalidValue;
    if (n < k) return 0;
    const unsigned blocks = (unsigned)((n - k + kLanes) / kLanes);
    hll_update_kernel<<<blocks, kThreads9, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)byts, (const uint8_t*)weights, n, k, p, m,
        (uint8_t*)regs);
    return (int)cudaGetLastError();
}

// K5 row_counts: the canonical hash and the count of every window of a
// padded batch of rows.
//
// Replaces khmer_tpu/hashtable.py:_make_row_hashes_counts_fn (:472),
// _make_row_counts_fn (:484) and the hash + count part of
// _make_median_at_least_fn (:643): kmer_hashes_2bit over a [B, L] u8 batch
// of 2-bit codes with lengths[B], then sketch_get of every window.  Output:
// counts[B, W] u16 (W = L - k + 1), 0 for a window that is not valid (one
// that runs past its row's length), and on request hashes[B, W] u64.
//
// Design: K1's packed tile and K3's gather in one pass, so the hashes
// never go through device memory when only counts are wanted.  The batch
// is read as one flat stream of B * L codes.  A block stages kRowLanes of
// them, plus the k - 1 <= 31 that follow, 16 to a u32 word in shared
// memory (twobit.cuh), and each thread hashes kKeysPerThread neighbouring
// window starts in O(1) each.  The window at flat lane i is column
// i % L of row i / L; it is valid iff its column + k <= that row's length,
// so a valid window never reads into the next row, whatever L is (L is
// not a multiple of the tile: 148 for 100-bp reads).  Lanes in columns
// >= W are hashed and dropped: (L - W) / L of the work (13% at L = 148).
// Then common.cuh's min_over_tables issues every table's load of the
// thread's valid windows before any min, and the counts (and hashes) are
// stored at [row, column] of the [B, W] outputs.
//
// The murmur variant (khmer_tpu's same functions with hash_kind "murmur",
// rows of ASCII bytes, 1 <= k <= 255) is the same kernel over murmur.cuh's
// tile: the block stages its bytes and their complements (khmer's full
// table) instead of packed codes, and each window costs two
// MurmurHash3_x64_128s of k bytes instead of O(1); the gather and the
// stores are the same.
//
// The cyclic variant K5c (hash_kind "cyclic", khmer_tpu's same functions
// over kmer_hashes_cyclic_bytes, ASCII rows, 1 <= k <= 255) fuses K11's
// hash (cyclic.cuh) with the same gather: the block stages each byte's two
// table entries, and each window costs 2k shared loads, rotations and
// XORs.
//
// Bound: the larger of its bytes and its random sectors.  Bytes: per lane
// 1 (code) read and 2 (count) written, 8 more with hashes, 4 (length) a
// row; and the T 4-byte bins of each valid window, each a random 32-byte
// sector of a table far larger than L2.  chip_smoke.py counts the bytes
// with each bin read once.

#include "cyclic.cuh"
#include "murmur.cuh"
#include "twobit.cuh"

namespace {

using namespace twobit;

constexpr int kRowThreads = 256;
constexpr int kRowLanes = kRowThreads * kKeysPerThread;  // lanes per block

// The exact 2-bit hash from packed codes (twobit.cuh)
struct TwoBitTile {
    static constexpr int kWords = kRowLanes / 16 + 2;  // with the halo
    unsigned word[kWords];

    // ends with the caller's block barrier
    __device__ __forceinline__ void stage(const uint8_t* codes, long long n,
                                          long long base, int, bool vec) {
        if (threadIdx.x < kWords)
            word[threadIdx.x] =
                pack16(load16(codes, base + 16 * threadIdx.x, n, vec));
    }
    __device__ __forceinline__ u64 hash(int o, int k) const {
        return canonical(word, o, 64 - 2 * k);
    }
};

// The murmur hash from ASCII bytes and their complements (murmur.cuh)
struct MurmurTile {
    static constexpr int kBytes = murmur::tile_bytes(kRowLanes);
    uint8_t lut[256];
    __align__(16) uint8_t fwd[kBytes];
    __align__(16) uint8_t comp[kBytes];

    __device__ __forceinline__ void stage(const uint8_t* byts, long long n,
                                          long long base, int k, bool) {
        murmur::stage(byts, n, base, kRowLanes + k - 1 + murmur::kPad +
                      murmur::kSlack, false, lut, fwd, comp);
    }
    __device__ __forceinline__ u64 hash(int o, int k) const {
        return murmur::canonical(fwd, comp, murmur::kPad + o, k);
    }
};

// The cyclic hash from each byte's staged table entries (cyclic.cuh)
struct CyclicTile {
    static constexpr int kPos = kRowLanes + cyclic::kMaxK - 1;
    u64 tab[2][256];
    u64 fwd[kPos];
    u64 rev[kPos];

    __device__ __forceinline__ void stage(const uint8_t* byts, long long n,
                                          long long base, int k, bool) {
        cyclic::stage(byts, n, base, kRowLanes + k - 1, tab, fwd, rev);
    }
    __device__ __forceinline__ u64 hash(int o, int k) const {
        return cyclic::window(fwd, rev, o, k);
    }
};

template <int TM, class Tile>
__global__ void __launch_bounds__(kRowThreads)
row_counts_kernel(const uint8_t* __restrict__ codes,
                  const int* __restrict__ lengths, long long n, int L,
                  int k, bool vec, const unsigned* __restrict__ table, int T,
                  const long long* __restrict__ sizes,
                  const long long* __restrict__ offs,
                  const u64* __restrict__ recips, unsigned cap,
                  uint16_t* __restrict__ counts, u64* __restrict__ hashes) {
    __shared__ Tile tile;
    __shared__ Geometry g;
    const long long base = (long long)blockIdx.x * kRowLanes;
    const int t = threadIdx.x;
    tile.stage(codes, n, base, k, vec);
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    const int W = L - k + 1;
    const int o = kKeysPerThread * t;
    const long long i0 = base + o;
    if (i0 >= n) return;
    long long row = i0 / L;
    int col = (int)(i0 - row * L);
    u64 h[kKeysPerThread];
    bool want[kKeysPerThread];
    long long at[kKeysPerThread];  // flat index in [B, W], or -1
#pragma unroll
    for (int j = 0; j < kKeysPerThread; j++) {
        if (j > 0 && ++col == L) {
            col = 0;
            row++;
        }
        want[j] = false;
        at[j] = -1;
        h[j] = 0;
        if (i0 + j < n) {
            h[j] = tile.hash(o + j, k);
            if (col < W) {
                at[j] = row * W + col;
                want[j] = col + k <= __ldg(lengths + row);
            }
        }
    }
    unsigned c[kKeysPerThread];
    min_over_tables<TM>(table, g, T, h, want, c);
#pragma unroll
    for (int j = 0; j < kKeysPerThread; j++) {
        if (at[j] < 0) continue;
        counts[at[j]] = want[j] ? (uint16_t)min(c[j], cap) : (uint16_t)0;
        if (hashes != nullptr) hashes[at[j]] = h[j];
    }
}

template <int TM, class Tile>
int launch(const void* codes, const void* lengths, long long n, int L, int k,
           const void* table, int T, const void* sizes, const void* offs,
           const void* recips, unsigned cap, void* counts, void* hashes,
           cudaStream_t s) {
    const unsigned blocks = (unsigned)((n + kRowLanes - 1) / kRowLanes);
    row_counts_kernel<TM, Tile><<<blocks, kRowThreads, 0, s>>>(
        (const uint8_t*)codes, (const int*)lengths, n, L, k,
        (uintptr_t)codes % 16 == 0, (const unsigned*)table, T,
        (const long long*)sizes, (const long long*)offs, (const u64*)recips,
        cap, (uint16_t*)counts, (u64*)hashes);
    return (int)cudaGetLastError();
}

template <class Tile>
int dispatch(const void* codes, const void* lengths, long long B, int L,
             int k, int kmax, const void* table, int T, const void* sizes,
             const void* offs, const void* recips, unsigned cap,
             void* counts, void* hashes, void* stream) {
    if (k < 1 || k > kmax || L < k || T < 1 || T > kMaxTables)
        return (int)cudaErrorInvalidValue;
    const long long n = B * (long long)L;
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (T) {
    case 1: return launch<1, Tile>(codes, lengths, n, L, k, table, T, sizes,
                                   offs, recips, cap, counts, hashes, s);
    case 2: return launch<2, Tile>(codes, lengths, n, L, k, table, T, sizes,
                                   offs, recips, cap, counts, hashes, s);
    case 3: return launch<3, Tile>(codes, lengths, n, L, k, table, T, sizes,
                                   offs, recips, cap, counts, hashes, s);
    case 4: return launch<4, Tile>(codes, lengths, n, L, k, table, T, sizes,
                                   offs, recips, cap, counts, hashes, s);
    default: return launch<0, Tile>(codes, lengths, n, L, k, table, T, sizes,
                                    offs, recips, cap, counts, hashes, s);
    }
}

}  // namespace

// codes is [B, L] u8 (2-bit codes) and lengths [B] i32; counts ([B, W]
// u16) and hashes ([B, W] u64, or null) are fresh allocations.
extern "C" int khmer_row_counts(const void* codes, const void* lengths,
                                long long B, int L, int k, const void* table,
                                int T, const void* sizes, const void* offs,
                                const void* recips, unsigned cap,
                                void* counts, void* hashes, void* stream) {
    return dispatch<TwoBitTile>(codes, lengths, B, L, k, 32, table, T, sizes,
                                offs, recips, cap, counts, hashes, stream);
}

// the murmur variant: byts is [B, L] u8 ASCII, 1 <= k <= 255
extern "C" int khmer_row_counts_murmur(const void* byts, const void* lengths,
                                       long long B, int L, int k,
                                       const void* table, int T,
                                       const void* sizes, const void* offs,
                                       const void* recips, unsigned cap,
                                       void* counts, void* hashes,
                                       void* stream) {
    return dispatch<MurmurTile>(byts, lengths, B, L, k, murmur::kMaxK, table,
                                T, sizes, offs, recips, cap, counts, hashes,
                                stream);
}

// the cyclic variant: byts is [B, L] u8 ASCII, 1 <= k <= 255
extern "C" int khmer_row_counts_cyclic(const void* byts, const void* lengths,
                                       long long B, int L, int k,
                                       const void* table, int T,
                                       const void* sizes, const void* offs,
                                       const void* recips, unsigned cap,
                                       void* counts, void* hashes,
                                       void* stream) {
    return dispatch<CyclicTile>(byts, lengths, B, L, k, cyclic::kMaxK, table,
                                T, sizes, offs, recips, cap, counts, hashes,
                                stream);
}

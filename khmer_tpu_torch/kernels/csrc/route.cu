// K15 band_route: the routing of the sharded consume's distinct lanes to
// their hash-band owners.
//
// Replaces khmer_tpu/parallel/sharded.py:band_owner (:85-100) and
// _route_with_leftover (:143-176), which sort the lanes by owner and place
// them.  Lane i of (hash, weight, first) is owned, when its weight is not
// 0, by shard min(mix64(h) / ((2^64 - 1) / NS), NS - 1) (the top sliver
// of the bands folded into the last shard); it goes to slot pos of its
// owner's send buffer [NS, cap] when its rank pos among the owned lanes of
// that owner (in lane order) is below cap, and otherwise to the leftover
// buffers [n], compacted in (owner, lane) order.  Unfilled slots hold
// (2^64 - 1, 0, 2^32 - 1); n_left gets the number of leftovers.  The
// order is that of a stable sort by owner, so the kernel equals the plain
// version bit for bit.
//
// Design: a histogram, an exclusive scan and a scatter, three launches.
//   count: a tile of kTile lanes a block, its owners counted in shared
//          memory into counts[owner][tile];
//   scan:  a block an owner, the exclusive scan of its counts over the
//          tiles in place, and the owner's total;
//   place: each block walks its tile again a blockDim of lanes at a time;
//          within a warp __match_any_sync gives a lane its rank among the
//          warp's lanes of its owner, the warps' counts are scanned in
//          shared memory, so every lane has its stable rank within its
//          owner without a sort.  The same launch fills the unfilled
//          slots of the send and leftover buffers.
// Bound: bytes, each lane read once (16 bytes) and written once (to a send
// slot or a leftover slot), and the unfilled slots written; the count pass
// reads the hashes and weights a second time.

#include "common.cuh"

namespace {

constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kChunks = 8;                              // blockDims a tile
constexpr long long kTile = (long long)kRouteThreads * kChunks;
constexpr int kMaxShards = 256;
constexpr int kScanThreads = 1024;
constexpr u64 kSentinel = ~0ULL;
constexpr unsigned kIdxSentinel = 0xFFFFFFFFu;

__device__ __forceinline__ int owner_of(u64 h, unsigned w, int ns, u64 band) {
    if (w == 0u) return ns;
    if (ns == 1) return 0;
    const u64 q = mix64(h) / band;
    return q < (u64)(ns - 1) ? (int)q : ns - 1;
}

// counts[o * tiles + b] = lanes of tile b owned by o (o = ns: no owner)
__global__ void __launch_bounds__(kRouteThreads)
route_count_kernel(const u64* __restrict__ h, const unsigned* __restrict__ w,
                   long long n, int ns, u64 band, long long tiles,
                   int* __restrict__ counts) {
    __shared__ int cnt[kMaxShards + 1];
    for (int o = threadIdx.x; o <= ns; o += blockDim.x) cnt[o] = 0;
    __syncthreads();
    const long long base = (long long)blockIdx.x * kTile;
    for (int c = 0; c < kChunks; c++) {
        const long long i = base + (long long)c * kRouteThreads + threadIdx.x;
        if (i < n) atomicAdd(&cnt[owner_of(__ldg(h + i), __ldg(w + i), ns,
                                           band)], 1);
    }
    __syncthreads();
    for (int o = threadIdx.x; o <= ns; o += blockDim.x)
        counts[(long long)o * tiles + blockIdx.x] = cnt[o];
}

// block o: exclusive scan of counts[o * tiles ...] in place, and total[o]
__global__ void __launch_bounds__(kScanThreads)
route_scan_kernel(int* __restrict__ counts, long long tiles,
                  long long* __restrict__ total) {
    __shared__ int warp_sums[kScanThreads / 32];
    __shared__ long long carry;
    int* c = counts + (long long)blockIdx.x * tiles;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (long long s = 0; s < tiles; s += kScanThreads) {
        const long long i = s + threadIdx.x;
        const int v = i < tiles ? c[i] : 0;
        int x = v;  // inclusive scan within the warp
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) warp_sums[warp] = x;
        __syncthreads();
        if (warp == 0) {
            int ws = warp_sums[lane];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xFFFFFFFFu, ws, d);
                if (lane >= d) ws += y;
            }
            warp_sums[lane] = ws;  // inclusive over the warps
        }
        __syncthreads();
        const long long before = carry + (warp ? warp_sums[warp - 1] : 0);
        if (i < tiles) c[i] = (int)(before + x - v);
        __syncthreads();
        if (threadIdx.x == 0) carry += warp_sums[kScanThreads / 32 - 1];
        __syncthreads();
    }
    if (threadIdx.x == 0) total[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kRouteThreads)
route_place_kernel(const u64* __restrict__ h, const unsigned* __restrict__ w,
                   const unsigned* __restrict__ f, long long n, int ns,
                   u64 band, long long tiles, long long cap,
                   const int* __restrict__ counts,
                   const long long* __restrict__ total,
                   u64* __restrict__ send_h, unsigned* __restrict__ send_w,
                   unsigned* __restrict__ send_f, u64* __restrict__ left_h,
                   unsigned* __restrict__ left_w,
                   unsigned* __restrict__ left_f,
                   long long* __restrict__ n_left) {
    __shared__ int run[kMaxShards + 1];  // next rank of each owner
    __shared__ long long left_base[kMaxShards + 1];
    __shared__ long long filled[kMaxShards + 1];  // min(total, cap)
    __shared__ int wcnt[kRouteWarps][kMaxShards + 1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = threadIdx.x; o <= ns; o += blockDim.x) {
        run[o] = counts[(long long)o * tiles + blockIdx.x];
        filled[o] = total[o] < cap ? total[o] : cap;
    }
    if (threadIdx.x == 0) {
        long long acc = 0;
        for (int o = 0; o < ns; o++) {
            left_base[o] = acc;
            acc += total[o] > cap ? total[o] - cap : 0;
        }
        left_base[ns] = acc;
        if (blockIdx.x == 0) *n_left = acc;
    }
    const long long base = (long long)blockIdx.x * kTile;
    const unsigned lt = (1u << lane) - 1u;
    for (int c = 0; c < kChunks; c++) {
        for (int j = threadIdx.x; j < kRouteWarps * (ns + 1);
             j += blockDim.x)
            wcnt[j / (ns + 1)][j % (ns + 1)] = 0;
        __syncthreads();
        const long long i = base + (long long)c * kRouteThreads + threadIdx.x;
        u64 hv = kSentinel;
        unsigned wv = 0u, fv = kIdxSentinel;
        int o = ns;
        if (i < n) {
            hv = __ldg(h + i);
            wv = __ldg(w + i);
            fv = __ldg(f + i);
            o = owner_of(hv, wv, ns, band);
        }
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, o);
        const int rank = __popc(peers & lt);
        if (rank == 0) wcnt[warp][o] = __popc(peers);
        __syncthreads();
        // each warp's first rank of every owner, warps in lane order
        for (int t = threadIdx.x; t <= ns; t += blockDim.x) {
            int r = run[t];
            for (int v = 0; v < kRouteWarps; v++) {
                const int x = wcnt[v][t];
                wcnt[v][t] = r;
                r += x;
            }
            run[t] = r;
        }
        __syncthreads();
        if (o < ns) {
            const long long pos = (long long)wcnt[warp][o] + rank;
            if (pos < cap) {
                const long long s = (long long)o * cap + pos;
                send_h[s] = hv;
                send_w[s] = wv;
                send_f[s] = fv;
            } else {
                const long long s = left_base[o] + pos - cap;
                left_h[s] = hv;
                left_w[s] = wv;
                left_f[s] = fv;
            }
        }
        __syncthreads();
    }
    // the slots no lane took
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long s = first; s < (long long)ns * cap; s += stride) {
        if (s % cap < filled[s / cap]) continue;
        send_h[s] = kSentinel;
        send_w[s] = 0u;
        send_f[s] = kIdxSentinel;
    }
    for (long long s = left_base[ns] + first; s < n; s += stride) {
        left_h[s] = kSentinel;
        left_w[s] = 0u;
        left_f[s] = kIdxSentinel;
    }
}

}  // namespace

extern "C" long long khmer_route_scratch_words(long long n, int ns) {
    return (long long)(ns + 1) * ((n + kTile - 1) / kTile);
}

// hashes, weights, firsts [n] (u64, u32, u32); send buffers [ns, cap],
// leftover buffers [n]; counts int32 [khmer_route_scratch_words(n, ns)],
// total int64 [ns + 1], n_left int64 [1].  1 <= ns <= kMaxShards,
// 0 < n < 2^31, cap >= 1.
extern "C" int khmer_band_route(const void* hashes, const void* weights,
                                const void* firsts, long long n, int ns,
                                long long cap, void* send_h, void* send_w,
                                void* send_f, void* left_h, void* left_w,
                                void* left_f, void* n_left, void* counts,
                                void* total, void* stream) {
    if (ns < 1 || ns > kMaxShards || n < 1 || n > 0x7FFFFFFFLL || cap < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const u64 band = ~0ULL / (u64)ns;
    const long long tiles = (n + kTile - 1) / kTile;
    const u64* h = (const u64*)hashes;
    const unsigned* w = (const unsigned*)weights;
    route_count_kernel<<<(unsigned)tiles, kRouteThreads, 0, s>>>(
        h, w, n, ns, band, tiles, (int*)counts);
    int err = (int)cudaGetLastError();
    if (err) return err;
    route_scan_kernel<<<(unsigned)(ns + 1), kScanThreads, 0, s>>>(
        (int*)counts, tiles, (long long*)total);
    if ((err = (int)cudaGetLastError())) return err;
    route_place_kernel<<<(unsigned)tiles, kRouteThreads, 0, s>>>(
        h, w, (const unsigned*)firsts, n, ns, band, tiles, cap,
        (const int*)counts, (const long long*)total, (u64*)send_h,
        (unsigned*)send_w, (unsigned*)send_f, (u64*)left_h,
        (unsigned*)left_w, (unsigned*)left_f, (long long*)n_left);
    return (int)cudaGetLastError();
}

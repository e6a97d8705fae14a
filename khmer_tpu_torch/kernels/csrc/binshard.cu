// K18 owned_claims, K19 owned_add, K20 owned_get: the bin-sharded table.
//
// Replace the dense claim-rule flush of the deferred counter,
// khmer_tpu/ops/deferred.py:flush_table_ops_dense (:431-468; its sort
// form flush_table_ops, :345-428, gives the same bits), run piece by
// piece over the layout of khmer_tpu/storage.py:Storage.shard_table
// (:245-271), and the reads and adds that XLA ran unchanged on that
// sharded array (sketch_get, sketch_update).  A piece holds bins
// [lo, lo + len) of the flat table.  A lane's bin in table t is
// g = off_t + h % p_t (h % p by the Barrett reciprocals of common.cuh),
// and the piece owns g iff lo <= g < lo + len.  Every piece sees every
// lane, because a key's T bins may lie on T pieces; the caller reduces
// the pieces' flags and minima over the mesh.  A live lane has key
// != 2^64 - 1 and weight (total) != 0.
//   K18 khmer_owned_claims, two launches:
//     (a) claim[g - lo] = min(itself, first), unsigned, by atomicMin, for
//         every live lane and owned (t, g);
//     (b) flags[i] = 1 where for some owned t claim[g - lo] == first and
//         (virgin, or piece[g - lo] == 0): the lane is the bin's first
//         claimant and the bin was empty before the flush.  Where table
//         0's bin is owned and (virgin ? total : piece + total) > 255
//         (u32), the key is appended to cand (khmer_tpu's candidate
//         superset, deferred.py:460-464).  The piece is read only here,
//         before K19 adds to it.
//   K19 khmer_owned_add: piece[g - lo] += total (mod 2^32) for every live
//     lane and owned (t, g).
//   K20 khmer_owned_get: out[i] = the min over owned t of piece[g - lo],
//     or 2^32 - 1 where the piece owns none of the key's bins.
// K18 is K17 (claims.cu) with an owner range and per-lane flags in place
// of a count.
// Bound: bytes.  K18 reads the lanes (16 bytes) twice and each owned
// claim and piece bin at random; K19 the lanes (12 bytes) and T random
// atomic adds; K20 the keys (8 bytes), T random reads and 4 bytes out.
// Each random bin is a 32-byte sector of an array far larger than L2.
// K18 and K19 are simple grid-stride loops, a lane a thread, the geometry
// in shared memory: right first, fast later.  K20 takes K3t's shape
// (common.cuh's gather_tables): a thread takes kKeysPerThread keys by two
// 16-byte streaming loads, issues the owned loads of all of them in every
// table before any min (T <= 4 a template argument), and writes its four
// minima as one 16-byte streaming store; each block decides once from the
// geometry which tables meet the piece, so that no lane computes a bin in
// a table the piece does not hold, and the blocks shrink for short calls
// so that every SM takes part.

#include "common.cuh"

namespace {

constexpr u64 kSentinel = ~0ULL;
constexpr unsigned kMaxBlocks = 132 * 16;

inline unsigned grid_for(long long n) {
    const long long b = (n + kThreads - 1) / kThreads;
    return (unsigned)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

// g - lo when the piece owns table t's bin of h, else -1
__device__ __forceinline__ long long owned_bin(const Geometry& g, u64 h,
                                               int t, long long lo,
                                               long long len) {
    const long long b = bin_in(g, h, t) - lo;
    return (b >= 0 && b < len) ? b : -1;
}

__global__ void __launch_bounds__(kThreads)
owned_claim_kernel(const u64* __restrict__ keys,
                   const unsigned* __restrict__ wgts,
                   const unsigned* __restrict__ firsts, long long n, int T,
                   const long long* __restrict__ sizes,
                   const long long* __restrict__ offs,
                   const u64* __restrict__ recips, long long lo,
                   long long len, unsigned* __restrict__ claim) {
    __shared__ Geometry g;
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const u64 h = keys[i];
        if (h == kSentinel || wgts[i] == 0u) continue;
        const unsigned f = firsts[i];
        for (int t = 0; t < T; t++) {
            const long long b = owned_bin(g, h, t, lo, len);
            if (b < 0) continue;
            unsigned* c = claim + b;
            if (f < __ldcg(c)) atomicMin(c, f);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
owned_flag_kernel(const u64* __restrict__ keys,
                  const unsigned* __restrict__ wgts,
                  const unsigned* __restrict__ firsts, long long n, int T,
                  const long long* __restrict__ sizes,
                  const long long* __restrict__ offs,
                  const u64* __restrict__ recips, long long lo,
                  long long len, const unsigned* __restrict__ claim,
                  const unsigned* __restrict__ piece, int virgin,
                  int* __restrict__ flags, u64* __restrict__ cand,
                  long long cand_cap, int* __restrict__ cand_count) {
    __shared__ Geometry g;
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const u64 h = __ldcs(keys + i);
        const unsigned tot = __ldcs(wgts + i);
        if (h == kSentinel || tot == 0u) continue;
        const unsigned f = __ldcs(firsts + i);
        bool won = false;
        for (int t = 0; t < T; t++) {
            const long long b = owned_bin(g, h, t, lo, len);
            if (b < 0) continue;
            const bool track0 = t == 0 && cand != nullptr;
            const bool mine = !won && __ldg(claim + b) == f;
            unsigned pre = 0u;
            if (!virgin && (track0 || mine)) pre = __ldg(piece + b);
            if (mine && pre == 0u) won = true;
            if (track0 && pre + tot > 255u) {
                const int slot = atomicAdd(cand_count, 1);
                if (slot < cand_cap) cand[slot] = h;
            }
        }
        if (won) flags[i] = 1;
    }
}

__global__ void __launch_bounds__(kThreads)
owned_add_kernel(const u64* __restrict__ keys,
                 const unsigned* __restrict__ wgts, long long n, int T,
                 const long long* __restrict__ sizes,
                 const long long* __restrict__ offs,
                 const u64* __restrict__ recips, long long lo, long long len,
                 unsigned* __restrict__ piece) {
    __shared__ Geometry g;
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const u64 h = __ldcs(keys + i);
        const unsigned w = __ldcs(wgts + i);
        if (h == kSentinel || w == 0u) continue;
        for (int t = 0; t < T; t++) {
            const long long b = owned_bin(g, h, t, lo, len);
            if (b >= 0) atomicAdd(piece + b, w);
        }
    }
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
owned_get_kernel(const u64* __restrict__ keys, long long n, int T,
                 const long long* __restrict__ sizes,
                 const long long* __restrict__ offs,
                 const u64* __restrict__ recips, long long lo, long long len,
                 const unsigned* __restrict__ piece, bool vec,
                 unsigned* __restrict__ out) {
    __shared__ Geometry g;
    __shared__ unsigned meet;
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    if (threadIdx.x == 0) meet = tables_meeting(g, T, lo, len);
    __syncthreads();
    const long long i =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kKeysPerThread;
    if (i >= n) return;
    const unsigned tables = meet;
    u64 h[kKeysPerThread];
    bool live[kKeysPerThread];
    load_keys(keys, i, n, vec, h, live);
    unsigned m[kKeysPerThread];
    if constexpr (TM > 0) {
        unsigned v[TM][kKeysPerThread];
        gather_tables<TM>(piece, g, tables, lo, len, h, live, v);
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++) {
            m[j] = v[0][j];
#pragma unroll
            for (int t = 1; t < TM; t++) m[j] = min(m[j], v[t][j]);
        }
    } else {
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++) m[j] = kNoBin;
        for (int t = 0; t < T; t++) {
            if (!((tables >> t) & 1u)) continue;
            unsigned v[kKeysPerThread];
            gather_table(piece, g, t, lo, len, h, live, v);
#pragma unroll
            for (int j = 0; j < kKeysPerThread; j++) m[j] = min(m[j], v[j]);
        }
    }
    if (i + kKeysPerThread <= n) {
        __stcs((uint4*)(out + i), make_uint4(m[0], m[1], m[2], m[3]));
    } else {
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++)
            if (live[j]) __stcs(out + i + j, m[j]);
    }
}

template <int TM>
int get_launch(const void* keys, long long n, int T, const void* sizes,
               const void* offs, const void* recips, const void* piece,
               long long lo, long long len, bool vec, void* out,
               long long blocks, int threads, void* stream) {
    owned_get_kernel<TM><<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const u64*)keys, n, T, (const long long*)sizes,
        (const long long*)offs, (const u64*)recips, lo, len,
        (const unsigned*)piece, vec, (unsigned*)out);
    return (int)cudaGetLastError();
}

inline bool bad_args(long long n, int T, long long lo, long long len) {
    return T < 1 || T > kMaxTables || n < 0 || lo < 0 || len < 0;
}

}  // namespace

// keys, wgts, firsts [n] (u64, u32, u32); the piece: u32 [len] holding
// bins [lo, lo + len); claim: u32 [len] scratch, set to 2^32 - 1 by the
// caller; flags: int32 [n], set to 1 where a lane wins (never cleared);
// cand: u64 [cand_cap] and cand_count: int32 [1], or NULL for no
// candidate tracking; virgin: the piece is known to be all zero.
extern "C" int khmer_owned_claims(const void* keys, const void* wgts,
                                  const void* firsts, long long n, int T,
                                  const void* sizes, const void* offs,
                                  const void* recips, const void* piece,
                                  long long lo, long long len, void* claim,
                                  void* flags, int virgin, void* cand,
                                  long long cand_cap, void* cand_count,
                                  void* stream) {
    if (bad_args(n, T, lo, len) || (cand != nullptr && cand_count == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0 || len == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    owned_claim_kernel<<<grid_for(n), kThreads, 0, s>>>(
        (const u64*)keys, (const unsigned*)wgts, (const unsigned*)firsts, n,
        T, (const long long*)sizes, (const long long*)offs,
        (const u64*)recips, lo, len, (unsigned*)claim);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    owned_flag_kernel<<<grid_for(n), kThreads, 0, s>>>(
        (const u64*)keys, (const unsigned*)wgts, (const unsigned*)firsts, n,
        T, (const long long*)sizes, (const long long*)offs,
        (const u64*)recips, lo, len, (const unsigned*)claim,
        (const unsigned*)piece, virgin, (int*)flags, (u64*)cand, cand_cap,
        (int*)cand_count);
    return (int)cudaGetLastError();
}

// keys, wgts [n] (u64, u32); the piece as in khmer_owned_claims, added to
extern "C" int khmer_owned_add(const void* keys, const void* wgts,
                               long long n, int T, const void* sizes,
                               const void* offs, const void* recips,
                               void* piece, long long lo, long long len,
                               void* stream) {
    if (bad_args(n, T, lo, len)) return (int)cudaErrorInvalidValue;
    if (n == 0 || len == 0) return 0;
    owned_add_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const u64*)keys, (const unsigned*)wgts, n, T,
        (const long long*)sizes, (const long long*)offs, (const u64*)recips,
        lo, len, (unsigned*)piece);
    return (int)cudaGetLastError();
}

// keys [n] (u64), a view that takes the vector loads only when 16-byte
// aligned; the piece as in khmer_owned_claims; out: u32 [n], a fresh
// allocation (16-byte aligned)
extern "C" int khmer_owned_get(const void* keys, long long n, int T,
                               const void* sizes, const void* offs,
                               const void* recips, const void* piece,
                               long long lo, long long len, void* out,
                               void* stream) {
    if (bad_args(n, T, lo, len) || (uintptr_t)out % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const long long quads = (n + kKeysPerThread - 1) / kKeysPerThread;
    const int threads = quad_threads(quads, sm_count());
    const long long blocks = (quads + threads - 1) / threads;
    const bool vec = (uintptr_t)keys % 16 == 0;
    switch (T) {
    case 1: return get_launch<1>(keys, n, T, sizes, offs, recips, piece, lo,
                                 len, vec, out, blocks, threads, stream);
    case 2: return get_launch<2>(keys, n, T, sizes, offs, recips, piece, lo,
                                 len, vec, out, blocks, threads, stream);
    case 3: return get_launch<3>(keys, n, T, sizes, offs, recips, piece, lo,
                                 len, vec, out, blocks, threads, stream);
    case 4: return get_launch<4>(keys, n, T, sizes, offs, recips, piece, lo,
                                 len, vec, out, blocks, threads, stream);
    default: return get_launch<0>(keys, n, T, sizes, offs, recips, piece, lo,
                                  len, vec, out, blocks, threads, stream);
    }
}

// K2 sketch_update, K3 sketch_get and the bin scatter-add.
//
// K2 replaces khmer_tpu/ops/sketch_ops.py:sketch_update (:127-219).  It
// adds a batch of weighted hashes to T prime-sized tables and counts,
// with the reference's exact sequential rule, the lanes that were new:
// a lane is new iff in some table its bin was zero before the batch AND
// it is that bin's first claimant (smallest lane = earliest stream
// position) within the batch (sketch_ops.py:140-146).  The TPU version
// resolves claims with a (bin, position) sort per table; here claims are
// an atomicMin into a bin-sized scratch array, in three launches:
//   1. claim:   gather the pre-batch bins, atomicMin(claim[bin], lane);
//   2. add:     own = claim[bin] == lane, is_new = any_t(pre==0 && own),
//               the bin scatter-add step table[bin] += w (scatter_add_step,
//               below), warp-reduced n_unique count;
//   3. release: put every touched claim back to CLAIM_FREE (a lane that
//               reset its bin inside launch 2 would race a lane of the
//               same bin that has not compared yet), and append the lanes
//               whose table-0 bin now exceeds 255 to the bigcount buffer.
// The scratch is reset by revisiting the lanes, never by a table-sized
// memset, so a batch costs O(lanes) whatever the table size.
//
// Bound: bytes, as random 4-byte accesses to a table far larger than L2:
// per live lane 8 (hash) + 4 (weight) + T * (4 read + 4 written) + 1
// (is_new) bytes at the least; each random access really moves a 32-byte
// sector.  The 64-bit `h % size` is emulated (3 T of them per lane).
//
// K3 replaces sketch_ops.py:sketch_get (:222-230): min over tables of the
// bin totals, capped at the storage kind's read cap, u16 out.  Bound:
// bytes, 8 + 4 T read and 2 written per lane.
//
// bin_scatter_add launches alone the scatter-add step of K2's add launch,
// the step that benchmarks/explore_pallas_scatter.py:_make_pallas_scatter
// (:59-132) prototypes for the TPU: table[idx] += val.  That prototype
// needs sorted unique bins because a TPU vector store cannot add; here an
// atomicAdd per lane takes any bins.  The `.ct` load widens the occupied
// bins of a file into a zeroed table with it.  Bound: bytes, 8 (index) +
// 4 (value) + 4 read + 4 written per lane.

#include "common.cuh"

constexpr int kClaimFree = 0x7FFFFFFF;  // larger than any lane index
constexpr unsigned kMaxKCount = 255;    // MAX_KCOUNT, oxli.hh:81

// The bin scatter-add step of K2's add launch and of bin_scatter_add:
// one lane adds its value into its bin, with u32 wrap-around.
__device__ __forceinline__ void scatter_add_step(unsigned* table,
                                                 long long bin, unsigned v) {
    atomicAdd(table + bin, v);
}

__global__ void sketch_claim_kernel(const unsigned* __restrict__ table,
                                    int* __restrict__ claim,
                                    const u64* __restrict__ hashes,
                                    const int* __restrict__ weights,
                                    long long n, int T,
                                    const long long* __restrict__ sizes,
                                    const long long* __restrict__ offs,
                                    unsigned* __restrict__ zero_mask) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    unsigned zm = 0;
    if (weights[i] != 0) {
        const u64 h = hashes[i];
        for (int t = 0; t < T; t++) {
            long long b = bin_of(h, t, sizes, offs);
            if (table[b] == 0) zm |= 1u << t;
            atomicMin(claim + b, (int)i);
        }
    }
    zero_mask[i] = zm;
}

__global__ void sketch_add_kernel(unsigned* __restrict__ table,
                                  const int* __restrict__ claim,
                                  const u64* __restrict__ hashes,
                                  const int* __restrict__ weights,
                                  long long n, int T,
                                  const long long* __restrict__ sizes,
                                  const long long* __restrict__ offs,
                                  const unsigned* __restrict__ zero_mask,
                                  uint8_t* __restrict__ is_new,
                                  u64* __restrict__ n_unique) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    bool fresh = false;
    if (i < n) {
        const int w = weights[i];
        if (w != 0) {
            const u64 h = hashes[i];
            const unsigned zm = zero_mask[i];
            for (int t = 0; t < T; t++) {
                long long b = bin_of(h, t, sizes, offs);
                if (((zm >> t) & 1u) && claim[b] == (int)i) fresh = true;
                scatter_add_step(table, b, (unsigned)w);
            }
        }
        is_new[i] = fresh;
    }
    // every thread of the warp reaches the ballot (no early return)
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, fresh);
    if ((threadIdx.x & 31) == 0 && ballot)
        atomicAdd(n_unique, (u64)__popc(ballot));
}

__global__ void sketch_release_kernel(const unsigned* __restrict__ table,
                                      int* __restrict__ claim,
                                      const u64* __restrict__ hashes,
                                      const int* __restrict__ weights,
                                      long long n, int T,
                                      const long long* __restrict__ sizes,
                                      const long long* __restrict__ offs,
                                      u64* __restrict__ cand, int cand_cap,
                                      int* __restrict__ cand_count) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || weights[i] == 0) return;
    const u64 h = hashes[i];
    for (int t = 0; t < T; t++)
        claim[bin_of(h, t, sizes, offs)] = kClaimFree;
    if (cand != nullptr && table[bin_of(h, 0, sizes, offs)] > kMaxKCount) {
        int slot = atomicAdd(cand_count, 1);
        if (slot < cand_cap) cand[slot] = h;
    }
}

__global__ void sketch_get_kernel(const unsigned* __restrict__ table,
                                  const u64* __restrict__ hashes,
                                  long long n, int T,
                                  const long long* __restrict__ sizes,
                                  const long long* __restrict__ offs,
                                  unsigned cap, uint16_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const u64 h = hashes[i];
    unsigned m = 0xFFFFFFFFu;
    for (int t = 0; t < T; t++)
        m = min(m, table[bin_of(h, t, sizes, offs)]);
    out[i] = (uint16_t)min(m, cap);
}

__global__ void bin_scatter_add_kernel(unsigned* __restrict__ table,
                                       const long long* __restrict__ idx,
                                       const unsigned* __restrict__ vals,
                                       long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) scatter_add_step(table, idx[i], vals[i]);
}

extern "C" int khmer_sketch_update(void* table, void* claim,
                                   const void* hashes, const void* weights,
                                   long long n, int T, const void* sizes,
                                   const void* offs, void* zero_mask,
                                   void* is_new, void* n_unique, void* cand,
                                   int cand_cap, void* cand_count,
                                   void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned g = blocks_for(n);
    const long long* sz = (const long long*)sizes;
    const long long* of = (const long long*)offs;
    sketch_claim_kernel<<<g, kThreads, 0, s>>>(
        (const unsigned*)table, (int*)claim, (const u64*)hashes,
        (const int*)weights, n, T, sz, of, (unsigned*)zero_mask);
    int err = (int)cudaGetLastError();
    if (err) return err;
    sketch_add_kernel<<<g, kThreads, 0, s>>>(
        (unsigned*)table, (const int*)claim, (const u64*)hashes,
        (const int*)weights, n, T, sz, of, (const unsigned*)zero_mask,
        (uint8_t*)is_new, (u64*)n_unique);
    err = (int)cudaGetLastError();
    if (err) return err;
    sketch_release_kernel<<<g, kThreads, 0, s>>>(
        (const unsigned*)table, (int*)claim, (const u64*)hashes,
        (const int*)weights, n, T, sz, of, (u64*)cand, cand_cap,
        (int*)cand_count);
    return (int)cudaGetLastError();
}

extern "C" int khmer_sketch_get(const void* table, const void* hashes,
                                long long n, int T, const void* sizes,
                                const void* offs, unsigned cap, void* out,
                                void* stream) {
    sketch_get_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)table, (const u64*)hashes, n, T,
        (const long long*)sizes, (const long long*)offs, cap,
        (uint16_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int khmer_bin_scatter_add(void* table, const void* idx,
                                     const void* vals, long long n,
                                     void* stream) {
    bin_scatter_add_kernel<<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (unsigned*)table, (const long long*)idx, (const unsigned*)vals, n);
    return (int)cudaGetLastError();
}

// K6 diginorm_chain and K7 trim_chain: the sequential keep decision of a
// batch of read bundles (a read, or a pair: two rows).
//
// K6 replaces the lax.scan of khmer_tpu/hashtable.py:_make_diginorm_fn
// (:760-878), K7 that of _make_trim_pass1_fn (:499-639).  The caller has
// hashed the batch's B2 = 2 B rows of nw windows, numbered each valid
// window's k-mer by its rank among the batch's distinct k-mers (ids), and
// read every distinct k-mer's count before the batch (pre, u16, K3).  In
// bundle order, a window's count is cnt = pre[id] + tally[id], where
// tally[id] counts the k-mer's valid windows in the bundles taken earlier
// in the batch: exact, because sketch counts add up.  Per bundle b:
//   K6: keep iff a real row has no valid window or fewer than (n + 1) / 2
//       of its n valid windows with cnt >= C; a kept bundle adds one to
//       tally for each of its valid windows;
//   K7: a row's median is >= T iff at least n - n / 2 of its valid
//       windows have cnt >= T; branch 0 (skip) when diginorm is on and
//       every real row's median is >= dn_cov, else 1 (trim now) when every
//       real row's median is >= trim_at, else 2 (save); only a saved bundle
//       adds to tally.  first_bad of each row is its first valid window
//       with cnt < cutoff (nw if none), from the counts before the bundle's
//       own adds.
// The caller flushes the final tally into the sketch (K2).
//
// Design: the decisions are a chain (bundle b reads what b - 1 added), so
// one block walks the bundles in order, its threads over the bundle's
// 2 nw windows: each thread reads its windows' counts, the warps reduce
// the per-row sums (__reduce_add_sync / __reduce_min_sync) into shared
// counters, one barrier, every thread takes the same decision from them,
// a kept bundle's threads add to tally (global atomics: up to 2 B nw u32,
// 10.6 MB for 16384 bundles of 100-bp pairs, too large for shared
// memory), and a second barrier orders those adds before the next
// bundle's reads.  tally is read with ld.global.cg (L2), never through
// L1, so no read can see a line cached before another thread's atomic.
// Shared counters are double-buffered by bundle parity: the buffer of
// b + 1 is zeroed after the first barrier of b, when all reads of it
// (bundle b - 1) are done.
//
// Bound: bytes, each input read once and each output written once: 1
// (valid) a window, 4 (id) a valid window, 2 (pre) a distinct k-mer, 1
// (real) a row, 4 (tally) a distinct k-mer of the taken bundles, and the
// flags out.  The chain is latency-bound instead: two barriers and a
// dependent L2 round trip per bundle, on one SM.  Deciding several bundles
// a step is later work (khmer_tpu's K-bundle overlap matrix is not ported).

#include "common.cuh"

namespace {

constexpr int kChainThreads = 1024;

// per-row sums of one bundle: for K6 hits (cnt >= C) and n; for K7
// ge_trim, ge_dn, n and first_bad
constexpr int kFields = 4;

template <bool kTrim>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const int* __restrict__ ids, const uint8_t* __restrict__ valid,
             const uint8_t* __restrict__ real,
             const uint16_t* __restrict__ pre, int B, int nw, unsigned C,
             unsigned dn_cov, bool do_norm, unsigned cutoff,
             unsigned* __restrict__ tally, uint8_t* __restrict__ flag,
             int* __restrict__ first_bad) {
    __shared__ int acc[2][2][kFields];  // [parity][row][field]
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int lanes = 2 * nw;
    if (t < 2 * 2 * kFields) {
        const int f = t % kFields;
        (&acc[0][0][0])[t] = kTrim && f == 3 ? nw : 0;
    }
    __syncthreads();
    for (int b = 0; b < B; b++) {
        const int par = b & 1;
        const long long base = (long long)b * lanes;
        int s[2][kFields] = {{0, 0, 0, nw}, {0, 0, 0, nw}};
        for (int i = t; i < lanes; i += blockDim.x) {
            if (!__ldg(valid + base + i)) continue;
            const int r = i >= nw;
            const int id = __ldg(ids + base + i);
            const unsigned cnt =
                (unsigned)__ldg(pre + id) + __ldcg(tally + id);
            if (kTrim) {
                s[r][0] += cnt >= C;
                s[r][1] += cnt >= dn_cov;
                s[r][2] += 1;
                if (cnt < cutoff) s[r][3] = min(s[r][3], i - r * nw);
            } else {
                s[r][0] += cnt >= C;
                s[r][1] += 1;
            }
        }
#pragma unroll
        for (int r = 0; r < 2; r++) {
#pragma unroll
            for (int f = 0; f < kFields; f++) {
                if (!kTrim && f >= 2) continue;
                const int v = kTrim && f == 3
                                  ? (int)__reduce_min_sync(0xFFFFFFFFu,
                                                           (unsigned)s[r][f])
                                  : (int)__reduce_add_sync(0xFFFFFFFFu,
                                                           (unsigned)s[r][f]);
                if (lane == 0) {
                    if (kTrim && f == 3)
                        atomicMin(&acc[par][r][f], v);
                    else if (v)
                        atomicAdd(&acc[par][r][f], v);
                }
            }
        }
        __syncthreads();
        bool take;
        int n[2], f3[2];
        bool is_real[2];
#pragma unroll
        for (int r = 0; r < 2; r++) {
            is_real[r] = __ldg(real + 2LL * b + r) != 0;
            f3[r] = acc[par][r][3];
        }
        if (kTrim) {
            bool ok_trim = true, ok_dn = true;
#pragma unroll
            for (int r = 0; r < 2; r++) {
                n[r] = acc[par][r][2];
                const int need = n[r] - n[r] / 2;
                if (is_real[r]) {
                    ok_trim &= acc[par][r][0] >= need;
                    ok_dn &= acc[par][r][1] >= need;
                }
            }
            const int branch = do_norm && ok_dn ? 0 : ok_trim ? 1 : 2;
            take = branch == 2;
            if (t == 0) flag[b] = (uint8_t)branch;
            if (t < 2) first_bad[2LL * b + t] = f3[t];
        } else {
            take = false;
#pragma unroll
            for (int r = 0; r < 2; r++) {
                n[r] = acc[par][r][1];
                if (is_real[r] &&
                    (n[r] == 0 || acc[par][r][0] < (n[r] + 1) / 2))
                    take = true;
            }
            if (t == 0) flag[b] = take;
        }
        if (t < 2 * kFields) {
            const int f = t % kFields;
            acc[par ^ 1][t / kFields][f] = kTrim && f == 3 ? nw : 0;
        }
        if (take) {
            for (int i = t; i < lanes; i += blockDim.x)
                if (__ldg(valid + base + i))
                    atomicAdd(tally + __ldg(ids + base + i), 1u);
        }
        __syncthreads();
    }
}

template <bool kTrim>
int launch(const void* ids, const void* valid, const void* real,
           const void* pre, int B, int nw, unsigned C, unsigned dn_cov,
           bool do_norm, unsigned cutoff, void* tally, void* flag,
           void* first_bad, void* stream) {
    if (B <= 0) return 0;
    if (nw < 1) return (int)cudaErrorInvalidValue;
    // a thread a window up to kChainThreads, in whole warps
    long long threads = ((2LL * nw + 31) / 32) * 32;
    if (threads > kChainThreads) threads = kChainThreads;
    chain_kernel<kTrim><<<1, (unsigned)threads, 0, (cudaStream_t)stream>>>(
        (const int*)ids, (const uint8_t*)valid, (const uint8_t*)real,
        (const uint16_t*)pre, B, nw, C, dn_cov, do_norm, cutoff,
        (unsigned*)tally, (uint8_t*)flag, (int*)first_bad);
    return (int)cudaGetLastError();
}

}  // namespace

// ids [2B, nw] i32 (ranks into pre; any value where not valid), valid
// [2B, nw] u8, real [2B] u8, pre [n_distinct] u16; tally [n_distinct] u32
// zeroed by the caller; keep [B] u8 out.
extern "C" int khmer_diginorm_chain(const void* ids, const void* valid,
                                    const void* real, const void* pre, int B,
                                    int nw, unsigned C, void* tally,
                                    void* keep, void* stream) {
    return launch<false>(ids, valid, real, pre, B, nw, C, 0, false, 0, tally,
                         keep, nullptr, stream);
}

// As khmer_diginorm_chain, with branch [B] u8 and first_bad [2B] i32 out;
// dn_cov is used only when do_norm.
extern "C" int khmer_trim_chain(const void* ids, const void* valid,
                                const void* real, const void* pre, int B,
                                int nw, unsigned trim_at, unsigned dn_cov,
                                int do_norm, unsigned cutoff, void* tally,
                                void* branch, void* first_bad, void* stream) {
    return launch<true>(ids, valid, real, pre, B, nw, trim_at, dn_cov,
                        do_norm != 0, cutoff, tally, branch, first_bad,
                        stream);
}

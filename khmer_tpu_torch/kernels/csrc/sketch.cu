// K2 sketch_update, K3 sketch_get and the bin scatter-add.
//
// K2 replaces khmer_tpu/ops/sketch_ops.py:sketch_update (:127-219).  It
// adds a batch of weighted hashes to T prime-sized tables and counts,
// with the reference's exact sequential rule, the lanes that were new:
// a lane is new iff in some table its bin was zero before the batch AND
// it is that bin's first claimant (smallest lane = earliest stream
// position) within the batch (sketch_ops.py:140-146).
//
// Design: a bin-partitioned update whose claims and sums live in shared
// memory.  Partition = global bin >> kPartShift (2048 bins, so a
// partition's claim and sum words take 16 KB of shared memory and
// thirteen blocks share an SM).  Every record of a bin falls in one
// partition, so the claimant found inside a partition is the global one,
// and no bin-sized claim array exists.  A record is (lane, weight, low bin
// bits) in one u64.  Records are grouped by partition in two steps,
// through buckets of kBucketParts partitions, and every count is taken
// in shared memory first, so that no pass makes one global atomic or one
// lone 8-byte store per record: both are far slower on this card than
// shared atomics and runs of stores.
//   1. count:   per live lane and table, the bin (Barrett modulo) and +1
//               on its bucket, in a shared histogram per block;
//   2. buckets: one block turns the bucket counts into offsets;
//   3. bucket:  the bins again; a block sorts a tile of records by bucket
//               in shared memory and writes each bucket's run to tmp;
//   4. parts:   per tile of tmp, a shared histogram of its partitions,
//               added to the global partition counts;
//   5. scan:    two launches (tile sums, then the tiles' prefix sums) turn
//               the partition counts into record offsets and two lists of
//               work items (a partition, or a kItemCap-record chunk of a
//               hot one; hot chunks first, so they start first);
//   6. place:   a block sorts a tile of tmp by partition in shared memory
//               and writes each partition's run to rec;
//   7. apply:   persistent blocks take items in a fixed order; shared
//               atomicMin gives each bin's claimant, shared atomicAdd its
//               batch total; then the claimant record alone reads and
//               writes its bin (pre + total; no global atomic) and marks
//               its lane new when pre == 0; the new total stays in shared
//               memory, where table-0 records read it for the bigcount
//               candidates (total > 255);
//   8. hot:     a partition with more records than one item holds is
//               split; its chunks combine their claims and totals through
//               global atomicMin/atomicAdd into a per-call scratch of that
//               partition only, which this launch then applies, bin by bin;
//   9. finish:  n_unique = warp-reduced count of the new lanes, and the
//               candidates of table-0 records that lie in hot partitions.
// A warp whose lanes all bump one shared counter (a hot hash) adds to it
// once.  Pass 7 prefetches the bins its claimants will read and the next
// item's records into L2.
//
// Bound: bytes, counted in chip_smoke.py as the same work whatever
// implements it: per live lane 8 (hash) + 4 (weight) + 1 (is_new), and
// the 4-byte bins of each distinct live hash, read and written.  This
// design reads the hashes and weights twice, writes and reads 8 + 4
// bytes per record in tmp and 8 in rec, and each distinct bin still
// costs a 32-byte sector.
//
// K3 replaces sketch_ops.py:sketch_get (:222-230): min over tables of the
// bin totals, capped at the storage kind's read cap, u16 out.  Bound:
// bytes, counted in chip_smoke.py with each input byte once: per lane 8
// (hash) read and 2 (count) written, and the T 4-byte bins of each
// distinct hash.  Each bin is in fact a random 32-byte sector of a table
// far larger than L2, so the card's rate of random sectors is what a key
// costs.  Design: four keys a thread, read as two 16-byte streaming loads
// (__ldcs) and their four counts written as one 8-byte streaming store
// (__stcs), so the key and count streams do not push table sectors out of
// L2; the gather is K4's (common.cuh min_over_tables: all 4 T read-only
// loads of a thread issued before any min, T <= 4); a thread for every
// four keys, in blocks small enough that a short batch still reaches
// every SM.  The first K3 took one key a thread and looped over tables with
// a runtime bound.
//
// bin_scatter_add replaces the step that
// benchmarks/explore_pallas_scatter.py:_make_pallas_scatter (:59-132)
// prototypes for the TPU: table[idx] += val.  That prototype needs sorted
// unique bins because a TPU vector store cannot add.  Here each lane's
// add is a reduction performed in L2 (an atomicAdd whose result is not
// used compiles to RED: the SM sends it and does not wait), so any bins
// are taken and duplicates are summed; a bin outside the table is counted
// into *bad and skipped, in the same single pass.  It needs no claimant:
// the claim step of K2's apply exists only for is_new.  Bound: bytes, 8
// (index) + 4 (value) + 4 read + 4 written per lane.

#include "common.cuh"

constexpr int kClaimFree = 0x7FFFFFFF;  // larger than any lane index
constexpr unsigned kMaxKCount = 255;    // MAX_KCOUNT, oxli.hh:81
constexpr int kPartShift = 11;
constexpr int kPartBins = 1 << kPartShift;
constexpr long long kPartMask = kPartBins - 1;
constexpr int kItemCap = 16384;         // records one apply item takes
constexpr int kApplyThreads = 128;
constexpr int kApplySmem = kPartBins * 8;  // claims + totals
constexpr int kScanThreads = 1024;
constexpr int kScanTile = 4 * kScanThreads;  // partitions a scan block takes
constexpr int kBucketShift = 9;
constexpr int kBucketParts = 1 << kBucketShift;
constexpr int kTileRecs = 8192;  // records a pass-3 or pass-6 tile sorts
constexpr int kWindow = 2048;    // partitions a pass-4 or pass-6 tile ranks
constexpr int kSortThreads = 1024;
constexpr int kPer = kTileRecs / kSortThreads;  // records a thread holds
constexpr int kMaxBuckets = 8192;  // kernels/__init__.py MAX_BINS / 2^20
// a record is one u64: lane << 32 | weight field << kPartShift | low
// bits; a weight of kWeightEsc or more is read from the lane instead
constexpr unsigned kWeightEsc = (1u << (32 - kPartShift)) - 1;
constexpr int kAddUnroll = 4;  // lanes a bin_scatter_add thread takes

// meta: int32 [kMetaWords], zeroed by the caller
enum { kMetaItems, kMetaHotItems, kMetaHot, kMetaRecords,
       kMetaWords = 8 };

// K2's per-call scratch, carved from one buffer (partition_layout).  An
// apply item is an int4: partition, first and end record, hot slot or -1.
struct Parts {
    int* count;          // [P4] records per partition (padded to 4)
    int* bucket_count;   // [buckets] records per bucket
    int* cursor;         // [P] next free record of a partition (pass 6)
    int* slot_of;        // [P] hot slot of a partition, or -1
    int4* items;         // [min(P, R)] the partitions that fit one item
    int4* hot_items;     // [2 R / kItemCap + 1] chunks of hot partitions
    int* hot_part;       // [max_slots] partition of each hot slot
    int* gclaim;         // [max_slots << kPartShift] hot claims
    unsigned* gsum;      // [max_slots << kPartShift] hot totals
    u64* rec;            // [R] records, grouped by partition
    int4* tile_sum;      // [P4 / kScanTile] per-tile sums of the scan
    int* bucket_cursor;  // [buckets] next free record of a bucket (pass 3)
    u64* tmp;            // [R] records grouped by bucket
    unsigned* tmp_part;  // [R] their partitions
    int* meta;
};

constexpr int kArrays = 14;

struct Layout {
    long long P, P4, max_slots, buckets;
    size_t off[kArrays], total;
};

static Layout partition_layout(long long n_records, long long nbins) {
    Layout L;
    L.P = (nbins + kPartBins - 1) >> kPartShift;
    L.P4 = (L.P + 3) & ~3LL;
    L.max_slots = n_records / (kItemCap + 1);
    if (L.max_slots > L.P) L.max_slots = L.P;
    const long long gwords = L.max_slots << kPartShift;
    L.buckets = (L.P + kBucketParts - 1) >> kBucketShift;
    const long long R = n_records;
    const long long sizes[kArrays] = {
        4 * L.P4, 4 * L.buckets, 4 * L.P, 4 * L.P, 16 * (L.P < R ? L.P : R),
        16 * (2 * R / kItemCap + 1), 4 * L.max_slots, 4 * gwords,
        4 * gwords, 8 * R, 16 * ((L.P4 + kScanTile - 1) / kScanTile),
        4 * L.buckets, 8 * R, 4 * R};
    size_t at = 0;
    for (int k = 0; k < kArrays; k++) {
        L.off[k] = at;
        at += ((size_t)sizes[k] + 255) & ~(size_t)255;
    }
    L.total = at;
    return L;
}

static Parts carve(const Layout& L, void* scratch, void* meta) {
    char* b = (char*)scratch;
    Parts q;
    q.count = (int*)(b + L.off[0]);
    q.bucket_count = (int*)(b + L.off[1]);
    q.cursor = (int*)(b + L.off[2]);
    q.slot_of = (int*)(b + L.off[3]);
    q.items = (int4*)(b + L.off[4]);
    q.hot_items = (int4*)(b + L.off[5]);
    q.hot_part = (int*)(b + L.off[6]);
    q.gclaim = (int*)(b + L.off[7]);
    q.gsum = (unsigned*)(b + L.off[8]);
    q.rec = (u64*)(b + L.off[9]);
    q.tile_sum = (int4*)(b + L.off[10]);
    q.bucket_cursor = (int*)(b + L.off[11]);
    q.tmp = (u64*)(b + L.off[12]);
    q.tmp_part = (unsigned*)(b + L.off[13]);
    q.meta = (int*)meta;
    return q;
}

// What K2's apply and finish passes read and write besides the table.
struct SketchOut {
    uint8_t* is_new;
    const u64* hashes;
    const unsigned* weights;  // an escaped record weight is read here
    const long long* sizes;   // sizes[0]: the bins of table 0
    u64* cand;                // null: no bigcount tracking
    int cand_cap;
    int* cand_count;
};

__device__ __forceinline__ unsigned rec_lane(u64 v) {
    return (unsigned)(v >> 32);
}

__device__ __forceinline__ unsigned rec_low(u64 v) {
    return (unsigned)(v & kPartMask);
}

__device__ __forceinline__ unsigned rec_weight(u64 v, const SketchOut& o) {
    const unsigned w = (unsigned)(v >> kPartShift) & kWeightEsc;
    return w == kWeightEsc ? __ldg(o.weights + rec_lane(v)) : w;
}

__device__ __forceinline__ u64 make_record(long long gb, unsigned lane,
                                           unsigned w) {
    return (u64)lane << 32 |
           (u64)(w < kWeightEsc ? w : kWeightEsc) << kPartShift |
           (u64)(gb & kPartMask);
}

// Appends h to the candidates where `want`, with one atomicAdd per warp
// (a hot hash crosses 255 on millions of lanes).  Every lane of the warp
// calls it.
__device__ __forceinline__ void append_cands(const SketchOut& o, bool want,
                                             u64 h) {
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, want);
    if (ballot == 0) return;
    const int lane = threadIdx.x & 31, leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(o.cand_count, __popc(ballot));
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    const int slot = base + __popc(ballot & ((1u << lane) - 1));
    if (want && slot < o.cand_cap) o.cand[slot] = h;
}

// counter[p] += 1 for every lane of the warp with p >= 0: one atomicAdd
// when all lanes name the same p (a hot hash), else one per lane.
// (__match_any_sync would merge every repeat, but on this card it costs
// more than the shared atomics it saves.)  Every lane of the warp calls
// it.
__device__ __forceinline__ void warp_count(int* counter, int p) {
    const int p0 = __shfl_sync(0xFFFFFFFFu, p, 0);
    if (__all_sync(0xFFFFFFFFu, p == p0)) {
        if ((threadIdx.x & 31) == 0 && p0 >= 0) atomicAdd(counter + p0, 32);
    } else if (p >= 0) {
        atomicAdd(counter + p, 1);
    }
}

// ---- scans -----------------------------------------------------------------

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
    return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ int4 sub4(int4 a, int4 b) {
    return make_int4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ int4 warp_inclusive_scan4(int4 x) {
    const int lane = threadIdx.x & 31;
    for (int o = 1; o < 32; o <<= 1) {
        const int4 y = make_int4(__shfl_up_sync(0xFFFFFFFFu, x.x, o),
                                 __shfl_up_sync(0xFFFFFFFFu, x.y, o),
                                 __shfl_up_sync(0xFFFFFFFFu, x.z, o),
                                 __shfl_up_sync(0xFFFFFFFFu, x.w, o));
        if (lane >= o) x = add4(x, y);
    }
    return x;
}

// Exclusive prefix sums of four counters over the block (blockDim.x a
// multiple of 32); *total gets the block's sums.
__device__ int4 block_exclusive_scan4(int4 v, int4* total) {
    __shared__ int4 warp_sums[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int4 x = warp_inclusive_scan4(v);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0)
        warp_sums[lane] = warp_inclusive_scan4(
            lane < nwarps ? warp_sums[lane] : make_int4(0, 0, 0, 0));
    __syncthreads();
    int4 excl = sub4(x, v);
    if (warp > 0) excl = add4(excl, warp_sums[warp - 1]);
    *total = warp_sums[nwarps - 1];
    __syncthreads();
    return excl;
}

// off[k] = a[0] + ... + a[k - 1] for k < m; returns the sum of all m.
// Every thread of the block calls it.
__device__ int block_scan(const int* a, int* off, int m) {
    int carry = 0;
    for (int base = 0; base < m; base += 4 * blockDim.x) {
        const int k0 = base + 4 * threadIdx.x;
        int v[4], sum = 0;
        for (int j = 0; j < 4; j++) {
            v[j] = k0 + j < m ? a[k0 + j] : 0;
            sum += v[j];
        }
        int4 tot;
        int at = block_exclusive_scan4(make_int4(sum, 0, 0, 0), &tot).x +
                 carry;
        for (int j = 0; j < 4 && k0 + j < m; j++) {
            off[k0 + j] = at;
            at += v[j];
        }
        carry += tot.x;
    }
    __syncthreads();
    return carry;
}

// The scan's counters of four partitions: records, hot items, items
// (partitions that fit one item), hot slots.
__device__ __forceinline__ int4 scan_terms(const int c[4]) {
    int4 m = make_int4(0, 0, 0, 0);
    for (int k = 0; k < 4; k++) {
        m.x += c[k];
        if (c[k] > kItemCap) {
            m.y += (c[k] + kItemCap - 1) / kItemCap;
            m.w++;
        } else if (c[k] > 0) {
            m.z++;
        }
    }
    return m;
}

__device__ __forceinline__ void load_counts(const Parts& q, long long p0,
                                            long long P, int c[4]) {
    const int4 v = p0 < P ? *(const int4*)(q.count + p0)
                          : make_int4(0, 0, 0, 0);
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
}

// ---- K2 passes -------------------------------------------------------------

// Pass 1.  A grid-stride loop over whole warps (warp_count is warp-wide).
__global__ void __launch_bounds__(kSortThreads)
sketch_count_kernel(const u64* __restrict__ hashes,
                    const int* __restrict__ weights, long long n, int T,
                    const long long* __restrict__ sizes,
                    const long long* __restrict__ offs,
                    const u64* __restrict__ recips, Parts q, int buckets,
                    uint8_t* __restrict__ is_new) {
    extern __shared__ int hist[];
    for (int k = threadIdx.x; k < buckets; k += blockDim.x) hist[k] = 0;
    __syncthreads();
    const long long step = (long long)gridDim.x * blockDim.x;
    const long long n32 = (n + 31) & ~31LL;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n32; i += step) {
        const bool live = i < n && weights[i] != 0;
        if (i < n) is_new[i] = 0;
        const u64 h = live ? hashes[i] : 0;
        for (int t = 0; t < T; t++)
            warp_count(hist, live ? (int)(bin_of(h, t, sizes, offs, recips)
                                          >> (kPartShift + kBucketShift))
                                  : -1);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < buckets; k += blockDim.x)
        if (hist[k]) atomicAdd(q.bucket_count + k, hist[k]);
}

// Pass 2: one block.
__global__ void __launch_bounds__(kScanThreads)
bucket_scan_kernel(Parts q, int buckets) {
    const int total = block_scan(q.bucket_count, q.bucket_cursor, buckets);
    if (threadIdx.x == 0) q.meta[kMetaRecords] = total;
}

// Pass 3: a block takes kTileRecs / T lanes at a time, ranks their
// records within their buckets (shared atomics), reserves each bucket's
// run in tmp with one atomicAdd and writes the runs out in bucket order.
__global__ void __launch_bounds__(kSortThreads)
sketch_bucket_kernel(const u64* __restrict__ hashes,
                     const int* __restrict__ weights, long long n, int T,
                     const long long* __restrict__ sizes,
                     const long long* __restrict__ offs,
                     const u64* __restrict__ recips, Parts q, int buckets) {
    extern __shared__ __align__(16) unsigned char sm[];
    u64* srec = (u64*)sm;
    unsigned* spart = (unsigned*)(srec + kTileRecs);
    int* hist = (int*)(spart + kTileRecs);
    int* off = hist + buckets;
    int* gbase = off + buckets;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lanes = kTileRecs / T;
    for (long long l0 = (long long)blockIdx.x * lanes; l0 < n;
         l0 += (long long)gridDim.x * lanes) {
        const int ml = (int)(n - l0 < lanes ? n - l0 : lanes);
        for (int k = tid; k < buckets; k += nt) hist[k] = 0;
        __syncthreads();
        u64 rec[kPer];
        unsigned part[kPer];
        int rank[kPer];
#pragma unroll
        for (int j = 0; j < kPer; j++) {
            const int r = tid + j * nt;  // record r: table r / ml, lane r % ml
            part[j] = 0xFFFFFFFFu;
            if (r >= ml * T) continue;
            const int t = r / ml;
            const long long i = l0 + (r - t * ml);
            const unsigned w = (unsigned)weights[i];
            if (w == 0) continue;
            const long long gb = bin_of(hashes[i], t, sizes, offs, recips);
            part[j] = (unsigned)(gb >> kPartShift);
            rec[j] = make_record(gb, (unsigned)i, w);
            rank[j] = atomicAdd(hist + (part[j] >> kBucketShift), 1);
        }
        __syncthreads();
        const int total = block_scan(hist, off, buckets);
        for (int k = tid; k < buckets; k += nt)
            if (hist[k]) gbase[k] = atomicAdd(q.bucket_cursor + k, hist[k]);
#pragma unroll
        for (int j = 0; j < kPer; j++) {
            if (part[j] == 0xFFFFFFFFu) continue;
            const int at = off[part[j] >> kBucketShift] + rank[j];
            srec[at] = rec[j];
            spart[at] = part[j];
        }
        __syncthreads();
        for (int j = tid; j < total; j += nt) {
            const int b = (int)(spart[j] >> kBucketShift);
            const int dst = gbase[b] + (j - off[b]);
            q.tmp[dst] = srec[j];
            q.tmp_part[dst] = spart[j];
        }
        __syncthreads();
    }
}

// The first partition of the bucket that a tile of tmp starts in.  A
// tile's records come bucket by bucket, so a window of kWindow partitions
// from there holds them all unless the batch is sparse; a record past the
// window takes its own global atomic.
__device__ __forceinline__ unsigned window_of(const Parts& q, long long at) {
    return q.tmp_part[at] >> kBucketShift << kBucketShift;
}

// Pass 4.  Every thread takes the same number of turns (warp_count).
__global__ void __launch_bounds__(kSortThreads)
sketch_part_count_kernel(Parts q) {
    __shared__ int hist[kWindow];
    const int tid = threadIdx.x, nt = blockDim.x;
    const int nrec = q.meta[kMetaRecords];
    for (long long base = (long long)blockIdx.x * kTileRecs; base < nrec;
         base += (long long)gridDim.x * kTileRecs) {
        const int m = (int)(nrec - base < kTileRecs ? nrec - base
                                                     : kTileRecs);
        const unsigned w0 = window_of(q, base);
        for (int k = tid; k < kWindow; k += nt) hist[k] = 0;
        __syncthreads();
        for (int r = tid; r < kTileRecs; r += nt) {
            const unsigned p = r < m ? q.tmp_part[base + r] : 0xFFFFFFFFu;
            const bool in = p - w0 < kWindow;
            warp_count(hist, in ? (int)(p - w0) : -1);
            if (r < m && !in) atomicAdd(q.count + p, 1);
        }
        __syncthreads();
        for (int k = tid; k < kWindow; k += nt)
            if (hist[k]) atomicAdd(q.count + w0 + k, hist[k]);
        __syncthreads();
    }
}

// Pass 5, first launch: the sums of each tile of kScanTile partitions.
__global__ void __launch_bounds__(kScanThreads)
partition_tile_kernel(Parts q, long long P) {
    int c[4];
    load_counts(q, (long long)blockIdx.x * kScanTile + 4 * threadIdx.x, P,
                c);
    int4 tile;
    block_exclusive_scan4(scan_terms(c), &tile);
    if (threadIdx.x == 0) q.tile_sum[blockIdx.x] = tile;
}

// Pass 5, second launch: each block adds up the tiles before its own,
// then writes its partitions' record offsets (the cursors), hot slots
// and item-list entries.
__global__ void __launch_bounds__(kScanThreads)
partition_scan_kernel(Parts q, long long P) {
    int4 before = make_int4(0, 0, 0, 0), carry;
    for (int t = threadIdx.x; t < (int)blockIdx.x; t += blockDim.x)
        before = add4(before, q.tile_sum[t]);
    block_exclusive_scan4(before, &carry);
    const long long p0 = (long long)blockIdx.x * kScanTile + 4 * threadIdx.x;
    int c[4];
    load_counts(q, p0, P, c);
    int4 tile;
    int4 at = add4(block_exclusive_scan4(scan_terms(c), &tile), carry);
    for (int k = 0; k < 4 && p0 + k < P; k++) {
        const int p = (int)(p0 + k);
        q.cursor[p] = at.x;
        if (c[k] > kItemCap) {
            q.slot_of[p] = at.w;
            q.hot_part[at.w] = p;
            for (int r = 0; r < c[k]; r += kItemCap)
                q.hot_items[at.y++] = make_int4(
                    p, at.x + r, at.x + min(c[k], r + kItemCap), at.w);
            at.w++;
        } else {
            q.slot_of[p] = -1;
            if (c[k] > 0)
                q.items[at.z++] = make_int4(p, at.x, at.x + c[k], -1);
        }
        at.x += c[k];
    }
    if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1) {
        const int4 all = add4(carry, tile);
        q.meta[kMetaItems] = all.z;
        q.meta[kMetaHotItems] = all.y;
        q.meta[kMetaHot] = all.w;
    }
}

// Pass 6: a block takes kTileRecs records of tmp, ranks them within their
// partitions, reserves each partition's run with one atomicAdd on its
// cursor and writes the runs out.  It also frees the hot slots that the
// scan assigned.
__global__ void __launch_bounds__(kSortThreads)
sketch_place_kernel(Parts q) {
    extern __shared__ __align__(16) unsigned char sm[];
    u64* srec = (u64*)sm;
    uint16_t* skey = (uint16_t*)(srec + kTileRecs);
    int* hist = (int*)(skey + kTileRecs);
    int* off = hist + kWindow;
    int* gbase = off + kWindow;
    const int tid = threadIdx.x, nt = blockDim.x;
    const long long words = (long long)q.meta[kMetaHot] << kPartShift;
    for (long long j = (long long)blockIdx.x * nt + tid; j < words;
         j += (long long)gridDim.x * nt) {
        q.gclaim[j] = kClaimFree;
        q.gsum[j] = 0;
    }
    const int nrec = q.meta[kMetaRecords];
    for (long long base = (long long)blockIdx.x * kTileRecs; base < nrec;
         base += (long long)gridDim.x * kTileRecs) {
        const int m = (int)(nrec - base < kTileRecs ? nrec - base
                                                     : kTileRecs);
        const unsigned w0 = window_of(q, base);
        for (int k = tid; k < kWindow; k += nt) hist[k] = 0;
        __syncthreads();
        u64 rec[kPer];
        unsigned part[kPer];
        int rank[kPer];
#pragma unroll
        for (int j = 0; j < kPer; j++) {
            const int r = tid + j * nt;
            part[j] = 0xFFFFFFFFu;
            if (r >= m) continue;
            rec[j] = q.tmp[base + r];
            part[j] = q.tmp_part[base + r];
            rank[j] = part[j] - w0 < kWindow
                          ? atomicAdd(hist + (part[j] - w0), 1) : -1;
        }
        __syncthreads();
        const int total = block_scan(hist, off, kWindow);
        for (int k = tid; k < kWindow; k += nt)
            if (hist[k]) gbase[k] = atomicAdd(q.cursor + w0 + k, hist[k]);
#pragma unroll
        for (int j = 0; j < kPer; j++) {
            if (part[j] == 0xFFFFFFFFu) continue;
            if (rank[j] < 0) {
                q.rec[atomicAdd(q.cursor + part[j], 1)] = rec[j];
                continue;
            }
            const int k = (int)(part[j] - w0);
            const int at = off[k] + rank[j];
            srec[at] = rec[j];
            skey[at] = (uint16_t)k;
        }
        __syncthreads();
        for (int j = tid; j < total; j += nt) {
            const int k = skey[j];
            q.rec[gbase[k] + (j - off[k])] = srec[j];
        }
        __syncthreads();
    }
}

// Apply item j of the list hot chunks, then partitions; partition -1
// past its end.
__device__ __forceinline__ int4 item_at(const Parts& q, int j, int n_hot,
                                        int n_all) {
    if (j < n_hot) return q.hot_items[j];
    if (j < n_all) return q.items[j - n_hot];
    return make_int4(-1, 0, 0, 0);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Pass 7.  Block b takes items b, b + grid, ... (hot chunks first, so
// they start first): a shared work counter would put one contended
// global atomic on the path of every item.
__global__ void __launch_bounds__(kApplyThreads)
partition_apply_kernel(unsigned* __restrict__ table, Parts q, SketchOut o) {
    extern __shared__ unsigned smem[];
    int* sclaim = (int*)smem;
    unsigned* ssum = smem + kPartBins;
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int j = tid; j < kPartBins; j += nt) {
        sclaim[j] = kClaimFree;
        ssum[j] = 0;
    }
    const long long size0 = __ldg(o.sizes);
    const int n_hot = q.meta[kMetaHotItems];
    const int n_all = n_hot + q.meta[kMetaItems];
    int4 it = item_at(q, blockIdx.x, n_hot, n_all);
    for (int j = blockIdx.x;; j += gridDim.x) {
        __syncthreads();  // shared words free again
        if (it.x < 0) break;
        // loaded now, first needed at the end of this item
        const int4 nx = item_at(q, j + gridDim.x, n_hot, n_all);
        const long long pbase = (long long)it.x << kPartShift;
        const bool hot = it.w >= 0;
        // claims and totals of this item's records; the claimants will
        // read their bins next
        for (int r = it.y + tid; r < it.z; r += nt) {
            const u64 v = __ldg(q.rec + r);
            atomicMin(sclaim + rec_low(v), (int)rec_lane(v));
            atomicAdd(ssum + rec_low(v), rec_weight(v, o));
            if (!hot) prefetch_l2(table + pbase + rec_low(v));
        }
        __syncthreads();
        // the claimant record of a bin, and it alone, applies the bin; a
        // chunk of a hot partition merges its claim and total instead
        const long long g = hot ? (long long)it.w << kPartShift : 0;
        for (int r = it.y + tid; r < it.z; r += nt) {
            const u64 v = __ldg(q.rec + r);
            const unsigned low = rec_low(v);
            const int lane = (int)rec_lane(v);
            if (sclaim[low] != lane) continue;
            if (hot) {
                atomicMin(q.gclaim + g + low, lane);
                atomicAdd(q.gsum + g + low, ssum[low]);
            } else {
                const unsigned pre = table[pbase + low];
                const unsigned post = pre + ssum[low];
                table[pbase + low] = post;
                ssum[low] = post;
                if (pre == 0) o.is_new[lane] = 1;
            }
        }
        if (!hot && o.cand != nullptr && pbase < size0) {
            __syncthreads();
            // every thread takes the same number of turns: the append is
            // warp-wide
            for (int rb = it.y; rb < it.z; rb += nt) {
                bool want = false;
                unsigned lane = 0;
                if (rb + tid < it.z) {
                    const u64 v = __ldg(q.rec + rb + tid);
                    want = pbase + rec_low(v) < size0 &&
                           ssum[rec_low(v)] > kMaxKCount;
                    lane = rec_lane(v);
                }
                append_cands(o, want, want ? __ldg(o.hashes + lane) : 0);
            }
        }
        __syncthreads();
        for (int r = nx.y + 16 * tid; nx.x >= 0 && r < nx.z; r += 16 * nt)
            prefetch_l2(q.rec + r);
        // free the words this item used
        for (int r = it.y + tid; r < it.z; r += nt) {
            const unsigned low = rec_low(__ldg(q.rec + r));
            sclaim[low] = kClaimFree;
            ssum[low] = 0;
        }
        it = nx;
    }
}

// Pass 8.
__global__ void partition_hot_kernel(unsigned* __restrict__ table, Parts q,
                                     uint8_t* __restrict__ is_new) {
    const int n_hot = q.meta[kMetaHot];
    for (int s = blockIdx.x; s < n_hot; s += gridDim.x) {
        const long long g = (long long)s << kPartShift;
        const long long pbase = (long long)q.hot_part[s] << kPartShift;
        for (int j = threadIdx.x; j < kPartBins; j += blockDim.x) {
            const int lane = q.gclaim[g + j];
            if (lane == kClaimFree) continue;
            const unsigned pre = table[pbase + j];
            table[pbase + j] = pre + q.gsum[g + j];
            if (pre == 0) is_new[lane] = 1;
        }
    }
}

// Pass 9.  One lane per thread; no thread returns before the warp-wide
// calls.
__global__ void sketch_finish_kernel(const unsigned* __restrict__ table,
                                     const u64* __restrict__ hashes,
                                     const int* __restrict__ weights,
                                     long long n,
                                     const long long* __restrict__ sizes,
                                     const long long* __restrict__ offs,
                                     const u64* __restrict__ recips, Parts q,
                                     SketchOut o, u64* __restrict__ n_unique) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool fresh = i < n && o.is_new[i] != 0;
    // the table-0 records of hot partitions read their new total here
    if (o.cand != nullptr && q.meta[kMetaHot] > 0) {
        bool want = false;
        u64 h = 0;
        if (i < n && weights[i] != 0) {
            h = hashes[i];
            const long long gb = bin_of(h, 0, sizes, offs, recips);
            want = q.slot_of[gb >> kPartShift] >= 0 &&
                   table[gb] > kMaxKCount;
        }
        append_cands(o, want, h);
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, fresh);
    if ((threadIdx.x & 31) == 0 && ballot)
        atomicAdd(n_unique, (u64)__popc(ballot));
}

// ---- K3 --------------------------------------------------------------------

template <int TM>
__global__ void __launch_bounds__(kThreads)
sketch_get_kernel(const unsigned* __restrict__ table,
                  const u64* __restrict__ hashes, long long n, int T,
                  const long long* __restrict__ sizes,
                  const long long* __restrict__ offs,
                  const u64* __restrict__ recips, unsigned cap, bool vec,
                  uint16_t* __restrict__ out) {
    __shared__ Geometry g;
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    const long long i =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kKeysPerThread;
    if (i >= n) return;
    const bool whole = i + kKeysPerThread <= n;
    u64 h[kKeysPerThread];
    bool live[kKeysPerThread];
    load_keys(hashes, i, n, vec, h, live);
    unsigned c[kKeysPerThread];
    min_over_tables<TM>(table, g, T, h, live, c);
    if (whole) {
        __stcs((uint2*)(out + i),
               make_uint2(min(c[0], cap) | min(c[1], cap) << 16,
                          min(c[2], cap) | min(c[3], cap) << 16));
    } else {
#pragma unroll
        for (int j = 0; j < kKeysPerThread; j++)
            if (i + j < n) out[i + j] = (uint16_t)min(c[j], cap);
    }
}

// ---- K3t -------------------------------------------------------------------

// out[t * n + i] = table[bin of hashes[i] in table t]: K3's gather without
// the min over tables, for the sharded query, which sums each table's bins
// over the mesh before the cap and the min (khmer_tpu/parallel/
// sharded.py:make_sharded_query, :114-119).  K3's shape: a thread takes
// kKeysPerThread keys (two 16-byte streaming loads), issues all T * 4 of
// their table loads before any store (common.cuh's gather_tables, T <= 4 a
// template argument; TM = 0 is the loop over a runtime T, a table's four
// loads at a time), and writes each table's four values as one 16-byte
// streaming store when the rows are 16-byte aligned (n % 4 == 0), so that
// the key and output streams do not evict table sectors from L2.
template <int TM>
__global__ void __launch_bounds__(kThreads)
sketch_get_tables_kernel(const unsigned* __restrict__ table,
                         const u64* __restrict__ hashes, long long n, int T,
                         const long long* __restrict__ sizes,
                         const long long* __restrict__ offs,
                         const u64* __restrict__ recips, bool vec_in,
                         bool vec_out, unsigned* __restrict__ out) {
    __shared__ Geometry g;
    load_geometry(g, T, sizes, offs, recips);
    __syncthreads();
    const long long i =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kKeysPerThread;
    if (i >= n) return;
    u64 h[kKeysPerThread];
    bool live[kKeysPerThread];
    load_keys(hashes, i, n, vec_in, h, live);
    const bool vec = vec_out && i + kKeysPerThread <= n;
    auto store = [&](int t, const unsigned (&v)[kKeysPerThread]) {
        unsigned* row = out + (long long)t * n + i;
        if (vec) {
            __stcs((uint4*)row, make_uint4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
            for (int j = 0; j < kKeysPerThread; j++)
                if (live[j]) __stcs(row + j, v[j]);
        }
    };
    if constexpr (TM > 0) {
        unsigned v[TM][kKeysPerThread];
        gather_tables<TM>(table, g, (1u << TM) - 1u, 0, kAllBins, h, live,
                          v);
#pragma unroll
        for (int t = 0; t < TM; t++) store(t, v[t]);
    } else {
        for (int t = 0; t < T; t++) {
            unsigned v[kKeysPerThread];
            gather_table(table, g, t, 0, kAllBins, h, live, v);
            store(t, v);
        }
    }
}

// ---- bin_scatter_add -------------------------------------------------------

// kAddUnroll lanes a thread, all loads first; no thread returns before
// the warp-wide count of bad lanes.
__global__ void bin_scatter_add_kernel(unsigned* __restrict__ table,
                                       long long nbins,
                                       const long long* __restrict__ idx,
                                       const unsigned* __restrict__ vals,
                                       long long n, int* __restrict__ bad) {
    const long long i0 =
        (long long)blockIdx.x * kAddUnroll * blockDim.x + threadIdx.x;
    long long b[kAddUnroll];
    unsigned v[kAddUnroll];
#pragma unroll
    for (int u = 0; u < kAddUnroll; u++) {
        const long long i = i0 + (long long)u * blockDim.x;
        b[u] = i < n ? __ldg(idx + i) : 0;
        v[u] = i < n ? __ldg(vals + i) : 0;
    }
    int n_bad = 0;
#pragma unroll
    for (int u = 0; u < kAddUnroll; u++) {
        if (i0 + (long long)u * blockDim.x >= n) continue;
        if (b[u] < 0 || b[u] >= nbins)
            n_bad++;
        else
            atomicAdd(table + b[u], v[u]);
    }
    n_bad = __reduce_add_sync(0xFFFFFFFFu, n_bad);
    if ((threadIdx.x & 31) == 0 && n_bad) atomicAdd(bad, n_bad);
}

// ---- C entry points --------------------------------------------------------

// The dynamic shared memory of passes 3 and 6 (at most kMaxBuckets).
constexpr int bucket_smem(long long buckets) {
    return (int)(kTileRecs * 12 + 12 * buckets);
}
constexpr int kPlaceSmem = kTileRecs * 10 + 12 * kWindow;

// Once per process: the shared-memory limits above 48 KB, and the grid
// of persistent apply blocks (all that fit on the card).
static int apply_grid(int* grid) {
    static int g = 0;
    if (g == 0) {
        cudaFuncSetAttribute(sketch_bucket_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bucket_smem(kMaxBuckets));
        cudaFuncSetAttribute(sketch_place_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPlaceSmem);
        cudaFuncSetAttribute(partition_apply_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kApplySmem);
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, partition_apply_kernel, kApplyThreads, kApplySmem);
        const int err = (int)cudaGetLastError();
        if (err) return err;
        g = sm_count() * (per_sm > 0 ? per_sm : 1);
    }
    *grid = g;
    return 0;
}

extern "C" long long khmer_partition_scratch_bytes(long long n_records,
                                                   long long nbins) {
    return (long long)partition_layout(n_records, nbins).total;
}

#define LAUNCHED()                                   \
    do {                                             \
        const int e = (int)cudaGetLastError();       \
        if (e) return e;                             \
    } while (0)

extern "C" int khmer_sketch_update(void* table, long long nbins,
                                   const void* hashes, const void* weights,
                                   long long n, int T, const void* sizes,
                                   const void* offs, const void* recips,
                                   void* scratch, void* meta, void* is_new,
                                   void* n_unique, void* cand, int cand_cap,
                                   void* cand_count, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const Layout L = partition_layout(n * T, nbins);
    const Parts q = carve(L, scratch, meta);
    const u64* h = (const u64*)hashes;
    const int* w = (const int*)weights;
    const long long* sz = (const long long*)sizes;
    const long long* of = (const long long*)offs;
    const u64* m = (const u64*)recips;
    const SketchOut o = {(uint8_t*)is_new, h, (const unsigned*)weights, sz,
                         (u64*)cand, cand_cap, (int*)cand_count};
    const int buckets = (int)L.buckets;
    int grid;
    int err = apply_grid(&grid);
    if (err) return err;
    // the partition and bucket counts are the first two arrays
    if ((err = (int)cudaMemsetAsync(q.count, 0, L.off[2], s))) return err;
    const long long blocks = (n + kSortThreads - 1) / kSortThreads;
    const int sms = sm_count();
    sketch_count_kernel<<<(unsigned)(blocks < 2 * sms ? blocks : 2 * sms),
                          kSortThreads, 4 * buckets, s>>>(
        h, w, n, T, sz, of, m, q, buckets, o.is_new);
    LAUNCHED();
    bucket_scan_kernel<<<1, kScanThreads, 0, s>>>(q, buckets);
    LAUNCHED();
    const int lanes = kTileRecs / T;
    sketch_bucket_kernel<<<(unsigned)((n + lanes - 1) / lanes), kSortThreads,
                           bucket_smem(buckets), s>>>(h, w, n, T, sz, of, m,
                                                      q, buckets);
    LAUNCHED();
    const unsigned tiles = (unsigned)((n * T + kTileRecs - 1) / kTileRecs);
    sketch_part_count_kernel<<<tiles, kSortThreads, 0, s>>>(q);
    LAUNCHED();
    const unsigned scan_tiles = (unsigned)((L.P + kScanTile - 1) / kScanTile);
    partition_tile_kernel<<<scan_tiles, kScanThreads, 0, s>>>(q, L.P);
    LAUNCHED();
    partition_scan_kernel<<<scan_tiles, kScanThreads, 0, s>>>(q, L.P);
    LAUNCHED();
    sketch_place_kernel<<<tiles, kSortThreads, kPlaceSmem, s>>>(q);
    LAUNCHED();
    partition_apply_kernel<<<grid, kApplyThreads, kApplySmem, s>>>(
        (unsigned*)table, q, o);
    LAUNCHED();
    const long long hot = L.max_slots < 1024 ? L.max_slots : 1024;
    partition_hot_kernel<<<(unsigned)(hot > 0 ? hot : 1), kThreads, 0, s>>>(
        (unsigned*)table, q, o.is_new);
    LAUNCHED();
    sketch_finish_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        (const unsigned*)table, h, w, n, sz, of, m, q, o, (u64*)n_unique);
    LAUNCHED();
    return 0;
}

template <int TM>
static int get_launch(const void* table, const void* hashes, long long n,
                      int T, const void* sizes, const void* offs,
                      const void* recips, unsigned cap, bool vec, void* out,
                      long long blocks, int threads, void* stream) {
    sketch_get_kernel<TM><<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const unsigned*)table, (const u64*)hashes, n, T,
        (const long long*)sizes, (const long long*)offs, (const u64*)recips,
        cap, vec, (uint16_t*)out);
    return (int)cudaGetLastError();
}

// out is a fresh allocation (8-byte aligned); hashes may be a view, and
// take the vector loads only when 16-byte aligned.
extern "C" int khmer_sketch_get(const void* table, const void* hashes,
                                long long n, int T, const void* sizes,
                                const void* offs, const void* recips,
                                unsigned cap, void* out, void* stream) {
    if (T < 1 || T > kMaxTables) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    // a thread for every four keys, in blocks small enough that a short
    // batch still reaches every SM
    const long long quads = (n + kKeysPerThread - 1) / kKeysPerThread;
    const int threads = quad_threads(quads, sm_count());
    const long long blocks = (quads + threads - 1) / threads;
    const bool vec = (uintptr_t)hashes % 16 == 0;
    switch (T) {
    case 1: return get_launch<1>(table, hashes, n, T, sizes, offs, recips,
                                 cap, vec, out, blocks, threads, stream);
    case 2: return get_launch<2>(table, hashes, n, T, sizes, offs, recips,
                                 cap, vec, out, blocks, threads, stream);
    case 3: return get_launch<3>(table, hashes, n, T, sizes, offs, recips,
                                 cap, vec, out, blocks, threads, stream);
    case 4: return get_launch<4>(table, hashes, n, T, sizes, offs, recips,
                                 cap, vec, out, blocks, threads, stream);
    default: return get_launch<0>(table, hashes, n, T, sizes, offs, recips,
                                  cap, vec, out, blocks, threads, stream);
    }
}

template <int TM>
static int get_tables_launch(const void* table, const void* hashes,
                             long long n, int T, const void* sizes,
                             const void* offs, const void* recips,
                             bool vec_in, bool vec_out, void* out,
                             long long blocks, int threads, void* stream) {
    sketch_get_tables_kernel<TM><<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
        (const unsigned*)table, (const u64*)hashes, n, T,
        (const long long*)sizes, (const long long*)offs, (const u64*)recips,
        vec_in, vec_out, (unsigned*)out);
    return (int)cudaGetLastError();
}

// out: u32 [T, n]; hashes may be a view, and take the vector loads only
// when 16-byte aligned; the rows take vector stores when n % 4 == 0.
extern "C" int khmer_sketch_get_tables(const void* table, const void* hashes,
                                       long long n, int T, const void* sizes,
                                       const void* offs, const void* recips,
                                       void* out, void* stream) {
    if (T < 1 || T > kMaxTables) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const long long quads = (n + kKeysPerThread - 1) / kKeysPerThread;
    const int threads = quad_threads(quads, sm_count());
    const long long blocks = (quads + threads - 1) / threads;
    const bool vec_in = (uintptr_t)hashes % 16 == 0;
    const bool vec_out = n % kKeysPerThread == 0 && (uintptr_t)out % 16 == 0;
    switch (T) {
    case 1: return get_tables_launch<1>(table, hashes, n, T, sizes, offs,
                                        recips, vec_in, vec_out, out, blocks,
                                        threads, stream);
    case 2: return get_tables_launch<2>(table, hashes, n, T, sizes, offs,
                                        recips, vec_in, vec_out, out, blocks,
                                        threads, stream);
    case 3: return get_tables_launch<3>(table, hashes, n, T, sizes, offs,
                                        recips, vec_in, vec_out, out, blocks,
                                        threads, stream);
    case 4: return get_tables_launch<4>(table, hashes, n, T, sizes, offs,
                                        recips, vec_in, vec_out, out, blocks,
                                        threads, stream);
    default: return get_tables_launch<0>(table, hashes, n, T, sizes, offs,
                                         recips, vec_in, vec_out, out, blocks,
                                         threads, stream);
    }
}

extern "C" int khmer_bin_scatter_add(void* table, long long nbins,
                                     const void* idx, const void* vals,
                                     long long n, void* bad, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int err = (int)cudaMemsetAsync(bad, 0, sizeof(int), s);
    if (err) return err;
    const long long per_block = (long long)kAddUnroll * kThreads;
    bin_scatter_add_kernel<<<(unsigned)((n + per_block - 1) / per_block),
                             kThreads, 0, s>>>(
        (unsigned*)table, nbins, (const long long*)idx,
        (const unsigned*)vals, n, (int*)bad);
    return (int)cudaGetLastError();
}

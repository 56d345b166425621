// The segment folds for Hopper (sm_90a) with shared-memory partials:
// K3's, K2's and K1's design where a block's partial fits shared memory
// (the rule of repro_torch/kernels/segment_aggregate.py, splitk_design;
// the rest keeps seg_agg_block_table_splitk, seg_agg_block_table and
// seg_agg_flat of segment_aggregate.cu).
//
//   seg_agg_splitk_smem  replaces segment_aggregate_block_table_splitk_pallas
//                        (repro/kernels/segment_aggregate.py,
//                        _bt_splitk_kernel): table rows [0, R) cut into
//                        chunks of chunk_rows; row r's events fold into
//                        partial r / chunk_rows; event e of row r reads
//                        arena[table[r], e, :w_out] into composite segment
//                        slots[r] * S + ids[r, e].
//
// What bounds it: bytes. Each event's valid byte, each valid event's id
// and w_out value floats, the table and slot of each row, the outputs
// written once (2.3 MB, 0.7 us, for the stock fold's 262,144 events).
//
// Design. The Pallas kernel keeps each chunk's partial resident in VMEM
// across the chunk's rows; here each block keeps a private partial
// [S_total(, w_out)] per requested stat in shared memory (4 KB for the
// stock fold: 2 slots x 128 keys x sum, count, min, max), initialised to
// the identities 0 / 0 / +inf / -inf by the block itself.
// - A chunk is cut into blocks of events_per_block consecutive events
//   (rows x cap flattened), so a few chunks still fill the SMs; rows >= R
//   are never read (no padding rows), and the composite id is computed
//   here from the row's slot and the event's key.
// - Consecutive lanes take consecutive events, kBatch of them a lane at a
//   time: the flags, rows, slots and keys of all of them are loaded before
//   any is folded, then their values, so a block waits for two round trips
//   to memory per batch instead of three per event. Lanes of a warp with
//   equal composite ids are grouped with __match_any_sync and reduced in
//   a log-depth tree over the group (sum: add; min / max: a compare that
//   keeps NaN), so each group issues one shared-memory atomic per stat
//   and column: atomicAdd for sum and count, a compare-and-swap loop for
//   min and max that lets a NaN win, as jnp.minimum / jnp.maximum do.
// - Each block writes its whole partial once to fp32 scratch
//   [blocks][words] and counts itself done on its chunk's counter. The
//   last block of a chunk folds the chunk's partials in block order: into
//   the raw [k, ...] output (merge = 0), or into a chunk partial, after
//   which the last chunk to finish folds the chunk partials in chunk order
//   into the merged output (merge = 1). The merge's orders are fixed
//   (the sums inside a block's partial come from atomics, in no fixed
//   order), and every output entry is written (no identity fill before
//   the launch). One launch: on this fold the host's cost of a launch is
//   most of the wrapper's time.
//
//   seg_agg_block_table_smem  K2's design where a block's partial fits
//                        shared memory (the same rule): replaces
//                        segment_aggregate_block_table_pallas (_bt_kernel),
//                        the fold of every table row into one result. The
//                        events are cut into blocks as above, each folding
//                        into its own shared-memory partial, but no block
//                        waits for the others: each flushes its partial
//                        straight into the output with one global atomic
//                        per touched word (segment, stat and column), so no
//                        block folds every block's partial alone. The
//                        output starts as zero (one memset in the same C
//                        call), which is the identity of sum and count;
//                        min and max travel as order-preserving unsigned
//                        keys (atomicMax, in shared memory too: no
//                        compare-and-swap loop), in which 0 is the identity
//                        and a NaN is the largest key, so a NaN wins as in
//                        jnp.minimum / jnp.maximum; the last block to
//                        finish turns the keys back into floats (+inf /
//                        -inf where nothing landed).
//
//   seg_agg_flat_smem    K1's design by the same rule: replaces
//                        segment_aggregate_pallas (_kernel / _acc_tile),
//                        reached flat (values [N, W], ids already the
//                        segments) and stacked (segment_aggregate_batched:
//                        values [B, N, W], ids [B, N], window slots [B]).
//                        The same fold and flush as K2's (flush_kernel is
//                        one template over how event e finds its values:
//                        TableRows for K2, StridedRows for K1, at values +
//                        e * ld, the composite id slots[e / N] * S + id
//                        made here); no composite id, identity or mask is
//                        built before the launch. On Linear Road's fold
//                        (rows of [speed, stopped], 256 segments a slot:
//                        3 KB of partial a slot) it takes 13 B an event.
//
// The entry points zero the counters (and K2's output) and launch the
// kernel on the caller's stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;                // events a lane loads at once
constexpr int kMergeBatch = 16;          // partials a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

// bits of the stats argument, in ALL_STATS order (sum, count, min, max)
constexpr int kSum = 1, kCount = 2, kMin = 4, kMax = 8;

__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

struct Add { __device__ float operator()(float a, float b) const {
    return a + b; } };
struct Min { __device__ float operator()(float a, float b) const {
    return min_nan(a, b); } };
struct Max { __device__ float operator()(float a, float b) const {
    return max_nan(a, b); } };

// The fold of x over the lanes of `peers` (this lane's group), left in the
// group's lowest lane: each round a lane adds the next remaining peer
// above it, and every second lane by rank drops out. All 32 lanes call it.
template <typename Op>
__device__ __forceinline__ float reduce_peers(unsigned peers, float x,
                                              int lane, Op op) {
    unsigned rank = __popc(peers & ((1u << lane) - 1u));
    peers &= 0xfffffffeu << lane;            // peers above this lane
    while (__any_sync(kFull, peers)) {
        const int next = __ffs(peers);
        const float t = __shfl_sync(kFull, x, (next - 1) & 31);
        if (next) x = op(x, t);
        peers &= __ballot_sync(kFull, !(rank & 1u));
        rank >>= 1;
    }
    return x;
}

// reduce_peers over unsigned keys, for the larger key.
__device__ __forceinline__ unsigned reduce_peers_max(unsigned peers,
                                                     unsigned x, int lane) {
    unsigned rank = __popc(peers & ((1u << lane) - 1u));
    peers &= 0xfffffffeu << lane;
    while (__any_sync(kFull, peers)) {
        const int next = __ffs(peers);
        const unsigned t = __shfl_sync(kFull, x, (next - 1) & 31);
        if (next) x = max(x, t);
        peers &= __ballot_sync(kFull, !(rank & 1u));
        rank >>= 1;
    }
    return x;
}

// Order-preserving keys of K2's min and max: 0 is the identity (no float
// maps to it), every NaN maps to the largest key, and a larger key is a
// smaller float (min) or a larger one (max).
__device__ __forceinline__ unsigned ordered(float x) {
    const unsigned u = __float_as_uint(x);
    return u & 0x80000000u ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ unsigned min_key(float x) {
    return x != x ? 0xffffffffu : ~ordered(x);
}
__device__ __forceinline__ unsigned max_key(float x) {
    return x != x ? 0xffffffffu : ordered(x);
}
// key -> float; q 2 min, 3 max
__device__ __forceinline__ float from_key(int q, unsigned k) {
    if (k == 0u) return q == 2 ? CUDART_INF_F : -CUDART_INF_F;
    if (k == 0xffffffffu) return CUDART_NAN_F;
    const unsigned o = q == 2 ? ~k : k;
    return __uint_as_float(o & 0x80000000u ? o & 0x7fffffffu : ~o);
}

// NaN-propagating minimum / maximum on shared (or global) memory.
__device__ __forceinline__ void atomic_min_nan(float* addr, float v) {
    int* a = reinterpret_cast<int*>(addr);
    int old = *reinterpret_cast<volatile int*>(a);
    while (true) {
        const float cur = __int_as_float(old);
        if (cur != cur) return;                  // already NaN
        if (!(v != v) && !(v < cur)) return;     // no change
        const int assumed = old;
        old = atomicCAS(a, assumed, __float_as_int(v));
        if (old == assumed) return;
    }
}
__device__ __forceinline__ void atomic_max_nan(float* addr, float v) {
    int* a = reinterpret_cast<int*>(addr);
    int old = *reinterpret_cast<volatile int*>(a);
    while (true) {
        const float cur = __int_as_float(old);
        if (cur != cur) return;
        if (!(v != v) && !(v > cur)) return;
        const int assumed = old;
        old = atomicCAS(a, assumed, __float_as_int(v));
        if (old == assumed) return;
    }
}

// Where each stat's words sit in a partial (-1: not requested), in
// ALL_STATS order, and the partial's length.
struct Words {
    int sum, count, min, max, total;
    __host__ __device__ Words(int stats, int s_total, int w_out) {
        int at = 0;
        sum = stats & kSum ? at : -1;
        at += stats & kSum ? s_total * w_out : 0;
        count = stats & kCount ? at : -1;
        at += stats & kCount ? s_total : 0;
        min = stats & kMin ? at : -1;
        at += stats & kMin ? s_total * w_out : 0;
        max = stats & kMax ? at : -1;
        at += stats & kMax ? s_total * w_out : 0;
        total = at;
    }
    // the stat of word i: 0 sum, 1 count, 2 min, 3 max
    __device__ int stat(int i) const {
        return max >= 0 && i >= max ? 3 : min >= 0 && i >= min ? 2
            : count >= 0 && i >= count ? 1 : 0;
    }
    __device__ int start(int q) const {
        return q == 0 ? sum : q == 1 ? count : q == 2 ? min : max;
    }
    __device__ float identity(int i) const {
        if (min >= 0 && i >= min && i < (max >= 0 ? max : total))
            return CUDART_INF_F;
        if (max >= 0 && i >= max) return -CUDART_INF_F;
        return 0.f;
    }
};

__device__ __forceinline__ float fold(int q, float acc, float x) {
    return q == 2 ? min_nan(acc, x) : q == 3 ? max_nan(acc, x) : acc + x;
}

// Every word of dst (one output row per stat q: out_q + row * size_q, or
// a partial of `words` floats) as the fold of n partials at src,
// src + stride, ... in order; a thread loads kMergeBatch of them at once.
__device__ void fold_partials(const float* src, long long stride, int n,
                              const Words& words, int s_total, int w_out,
                              float* sum, float* cnt, float* mn, float* mx,
                              long long row, float* partial) {
    for (int i = threadIdx.x; i < words.total; i += kThreads) {
        const int q = words.stat(i);
        float acc = words.identity(i);
        for (int b0 = 0; b0 < n; b0 += kMergeBatch) {
            float x[kMergeBatch];
#pragma unroll
            for (int j = 0; j < kMergeBatch; ++j)
                if (b0 + j < n) x[j] = __ldcg(src + (b0 + j) * stride + i);
#pragma unroll
            for (int j = 0; j < kMergeBatch; ++j)
                if (b0 + j < n) acc = fold(q, acc, x[j]);
        }
        if (partial) {
            partial[i] = acc;
        } else {
            float* out = q == 0 ? sum : q == 1 ? cnt : q == 2 ? mn : mx;
            const int size = q == 1 ? s_total : s_total * w_out;
            out[row * size + i - words.start(q)] = acc;
        }
    }
}

// Whether this block is the last of `n` to arrive at *counter, after its
// writes are visible to the one that is.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n) {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n - 1;
    __syncthreads();
    if (last) __threadfence();
    return last;
}

__global__ void __launch_bounds__(kThreads) fold_kernel(
        const float* __restrict__ arena, int pool_slots, int cap, int w,
        int w_out, const int* __restrict__ table, int R,
        const int* __restrict__ ids, const int* __restrict__ slots,
        const uint8_t* __restrict__ valid, int S, int s_total,
        int chunk_rows, int k, int blocks_per_chunk, int events_per_block,
        int stats, int merge, float* scratch, float* chunks, int* counters,
        float* sum, float* cnt, float* mn, float* mx) {
    extern __shared__ float part[];
    const Words words(stats, s_total, w_out);
    for (int i = threadIdx.x; i < words.total; i += kThreads)
        part[i] = words.identity(i);
    __syncthreads();

    const int c = blockIdx.x / blocks_per_chunk;
    const int j = blockIdx.x - c * blocks_per_chunk;
    // event indices fit an int: the entry point checks k * chunk_rows * cap
    const int chunk_end = min((c + 1) * chunk_rows, R) * cap;
    const int e0 = c * chunk_rows * cap + j * events_per_block;
    const int e1 = min(e0 + events_per_block, chunk_end);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool values = (stats & (kSum | kMin | kMax)) != 0;
    for (int base = e0 + warp * 32 * kBatch; base < e1;
         base += kWarps * 32 * kBatch) {     // warp-uniform trip count
        int key[kBatch];
        bool ok[kBatch];
        const float* row[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int e = base + u * 32 + lane;
            ok[u] = e < e1;
            key[u] = -1 - lane;              // a group of its own
            row[u] = arena;
            if (ok[u]) {
                const int r = e / cap;
                const bool live = valid == nullptr || valid[e] != 0;
                const int p = table[r];
                const int comp = slots[r] * S + ids[e];
                ok[u] = live && comp >= 0 && comp < s_total && p >= 0
                    && p < pool_slots;
                if (ok[u]) {
                    key[u] = comp;
                    row[u] = arena + ((long long)p * cap + (e - r * cap)) * w;
                }
            }
        }
        unsigned peers[kBatch];
        bool leader[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            peers[u] = __match_any_sync(kFull, key[u]);
            leader[u] = ok[u] && __ffs(peers[u]) - 1 == lane;
            if (words.count >= 0 && leader[u])
                atomicAdd(part + words.count + key[u],
                          (float)__popc(peers[u]));
        }
        if (!values) continue;
        for (int col = 0; col < w_out; ++col) {
            float v[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
                v[u] = ok[u] ? __ldg(row[u] + col) : 0.f;
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int at = key[u] * w_out + col;
                if (words.sum >= 0) {
                    const float t = reduce_peers(peers[u], v[u], lane, Add());
                    if (leader[u]) atomicAdd(part + words.sum + at, t);
                }
                if (words.min >= 0) {
                    const float t = reduce_peers(peers[u], v[u], lane, Min());
                    if (leader[u]) atomic_min_nan(part + words.min + at, t);
                }
                if (words.max >= 0) {
                    const float t = reduce_peers(peers[u], v[u], lane, Max());
                    if (leader[u]) atomic_max_nan(part + words.max + at, t);
                }
            }
        }
    }
    __syncthreads();
    float* dst = scratch + (long long)blockIdx.x * words.total;
    for (int i = threadIdx.x; i < words.total; i += kThreads)
        dst[i] = part[i];

    if (!last_to_arrive(counters + c, blocks_per_chunk)) return;
    fold_partials(scratch + (long long)c * blocks_per_chunk * words.total,
                  words.total, blocks_per_chunk, words, s_total, w_out, sum,
                  cnt, mn, mx, c,
                  merge ? chunks + (long long)c * words.total : nullptr);
    if (!merge || !last_to_arrive(counters + k, k)) return;
    fold_partials(chunks, words.total, k, words, s_total, w_out, sum, cnt,
                  mn, mx, 0, nullptr);
}

// How event e of a flush fold finds its composite segment and its values;
// event(e, comp, row) is false where the event matches no segment (or,
// for a table row, names a pool slot past the arena). Both read every
// index of the event before either result is used, so the loads of a
// batch are in flight together.
//
// K2: row r = e / cap of the block table, values at
// arena[table[r], e mod cap, :w_out].
struct TableRows {
    const float* arena;
    int pool_slots, cap, w;
    const int* table;
    const int* ids;
    const int* slots;
    int S, s_total;
    __device__ __forceinline__ bool event(int e, int& comp,
                                          const float*& row) const {
        const int r = e / cap;
        const int p = __ldg(table + r);
        comp = __ldg(slots + r) * S + __ldg(ids + e);
        row = arena + ((long long)p * cap + (e - r * cap)) * w;
        return comp >= 0 && comp < s_total && p >= 0 && p < pool_slots;
    }
};

// K1: values at values + e * ld (rows of n events, one window slot each:
// slots[e / n]); with slots null the ids are already composite.
struct StridedRows {
    const float* values;
    long long ld;
    int n;
    const int* ids;
    const int* slots;
    int S, s_total;
    __device__ __forceinline__ bool event(int e, int& comp,
                                          const float*& row) const {
        const int id = __ldg(ids + e);
        comp = slots ? __ldg(slots + e / n) * S + id : id;
        row = values + e * ld;
        return comp >= 0 && comp < s_total;
    }
};

// K2 and K1: block j folds events [j * events_per_block, ...) of the
// `events` in the order of Rows into its shared-memory partial (sum and
// count as floats, min and max as keys, all starting at 0), then adds it
// into `out` (the same layout, zeroed) with one atomic per touched word;
// where min or max is requested, the last block turns out's keys into
// floats.
template <typename Rows>
__global__ void __launch_bounds__(kThreads) flush_kernel(
        Rows rows, int events, int w_out, const uint8_t* __restrict__ valid,
        int s_total, int events_per_block, int stats, float* out,
        int* counter) {
    extern __shared__ float part[];
    unsigned* keys = reinterpret_cast<unsigned*>(part);
    const Words words(stats, s_total, w_out);
    for (int i = threadIdx.x; i < words.total; i += kThreads) keys[i] = 0u;
    __syncthreads();

    const int e0 = blockIdx.x * events_per_block;
    const int e1 = min(e0 + events_per_block, events);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool values = (stats & (kSum | kMin | kMax)) != 0;
    for (int base = e0 + warp * 32 * kBatch; base < e1;
         base += kWarps * 32 * kBatch) {     // warp-uniform trip count
        int key[kBatch];
        bool ok[kBatch];
        const float* row[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int e = base + u * 32 + lane;
            ok[u] = e < e1;
            key[u] = -1 - lane;              // a group of its own
            row[u] = nullptr;
            if (ok[u]) {
                const bool live = valid == nullptr || valid[e] != 0;
                int comp;
                const float* at;
                const bool in = rows.event(e, comp, at);
                ok[u] = live && in;
                if (ok[u]) {
                    key[u] = comp;
                    row[u] = at;
                }
            }
        }
        unsigned peers[kBatch];
        bool leader[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            peers[u] = __match_any_sync(kFull, key[u]);
            leader[u] = ok[u] && __ffs(peers[u]) - 1 == lane;
            if (words.count >= 0 && leader[u])
                atomicAdd(part + words.count + key[u],
                          (float)__popc(peers[u]));
        }
        if (!values) continue;
        for (int col = 0; col < w_out; ++col) {
            float v[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
                v[u] = ok[u] ? __ldg(row[u] + col) : 0.f;
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int at = key[u] * w_out + col;
                if (words.sum >= 0) {
                    const float t = reduce_peers(peers[u], v[u], lane, Add());
                    if (leader[u]) atomicAdd(part + words.sum + at, t);
                }
                if (words.min >= 0) {
                    const unsigned t = reduce_peers_max(peers[u],
                                                        min_key(v[u]), lane);
                    if (leader[u]) atomicMax(keys + words.min + at, t);
                }
                if (words.max >= 0) {
                    const unsigned t = reduce_peers_max(peers[u],
                                                        max_key(v[u]), lane);
                    if (leader[u]) atomicMax(keys + words.max + at, t);
                }
            }
        }
    }
    __syncthreads();
    unsigned* out_keys = reinterpret_cast<unsigned*>(out);
    for (int i = threadIdx.x; i < words.total; i += kThreads) {
        const unsigned k = keys[i];
        if (k == 0u) continue;                   // untouched
        if (words.stat(i) < 2) atomicAdd(out + i, part[i]);
        else atomicMax(out_keys + i, k);
    }

    const int first = words.min >= 0 ? words.min : words.max;
    if (first < 0 || !last_to_arrive(counter, gridDim.x)) return;
    for (int i = first + threadIdx.x; i < words.total; i += kThreads)
        out[i] = from_key(words.stat(i), __ldcg(out_keys + i));
}

// One flush launch over `events` events: checks, the memset of out and
// its counter, the kernel; returns cudaGetLastError().
template <typename Rows>
int launch_flush(const Rows& rows, long long events, int w_out,
                 const uint8_t* valid, int s_total, int events_per_block,
                 int stats, float* out, cudaStream_t s) {
    const Words words(stats, s_total, w_out);
    const size_t smem = (size_t)words.total * sizeof(float);
    // event indices fit an int, with a batch of headroom past the end
    if (words.total <= 0 || w_out <= 0 || events <= 0
        || events_per_block <= 0 || smem > 48 * 1024
        || events > 0x7fffffffLL - kThreads * kBatch)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (events + events_per_block - 1)
        / events_per_block;
    int* counter = reinterpret_cast<int*>(out + words.total);
    cudaError_t e = cudaMemsetAsync(out, 0,
                                    (words.total + 1) * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
    flush_kernel<Rows><<<(unsigned)blocks, kThreads, smem, s>>>(
        rows, (int)events, w_out, valid, s_total, events_per_block, stats,
        out, counter);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch: float32 [k * blocks_per_chunk * words], then [k * words] of
// chunk partials, then k + 1 int counters; sum / cnt / mn / mx:
// [k_out, S_total(, w_out)] (k_out = 1 with merge), null where the stat is
// not requested (stats: bits 1 sum, 2 count, 4 min, 8 max).
int seg_agg_splitk_smem(const float* arena, int pool_slots, int cap, int w,
                        int w_out, const int* table, int r, const int* ids,
                        const int* slots, const uint8_t* valid, int S,
                        int s_total, int chunk_rows, int k,
                        int blocks_per_chunk, int events_per_block,
                        int stats, int merge, float* scratch, float* sum,
                        float* cnt, float* mn, float* mx, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const Words words(stats, s_total, w_out);
    const long long blocks = (long long)k * blocks_per_chunk;
    const size_t smem = (size_t)words.total * sizeof(float);
    if (words.total == 0 || blocks <= 0 || smem > 48 * 1024
        || (long long)k * chunk_rows * cap
           > 0x7fffffffLL - kThreads * kBatch)
        return (int)cudaErrorInvalidValue;
    float* chunks = scratch + blocks * words.total;
    int* counters = reinterpret_cast<int*>(chunks + (long long)k
                                           * words.total);
    cudaError_t e = cudaMemsetAsync(counters, 0, (k + 1) * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
    fold_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
        arena, pool_slots, cap, w, w_out, table, r, ids, slots, valid, S,
        s_total, chunk_rows, k, blocks_per_chunk, events_per_block, stats,
        merge, scratch, chunks, counters, sum, cnt, mn, mx);
    return (int)cudaGetLastError();
}

// out: float32 [words] in the layout of a partial (sum [S_total, w_out],
// count [S_total], min, max; each present where requested), then one int
// counter; the entry point zeroes both. stats: bits 1 sum, 2 count, 4 min,
// 8 max.
int seg_agg_block_table_smem(const float* arena, int pool_slots, int cap,
                             int w, int w_out, const int* table, int r,
                             const int* ids, const int* slots,
                             const uint8_t* valid, int S, int s_total,
                             int events_per_block, int stats, float* out,
                             void* stream) {
    const TableRows rows{arena, pool_slots, cap, w, table, ids, slots, S,
                         s_total};
    return launch_flush(rows, (long long)r * cap, w_out, valid, s_total,
                        events_per_block, stats, out, (cudaStream_t)stream);
}

// K1: values [rows, n, w_out] at values + (r * n + i) * ld (columns
// contiguous), ids and valid (may be null) [rows, n], slots [rows] or
// null (the ids are composite); out as seg_agg_block_table_smem's.
int seg_agg_flat_smem(const float* values, long long ld, int n, int rows,
                      int w_out, const int* ids, const int* slots,
                      const uint8_t* valid, int S, int s_total,
                      int events_per_block, int stats, float* out,
                      void* stream) {
    if (ld < w_out) return (int)cudaErrorInvalidValue;
    const StridedRows src{values, ld, n, ids, slots, S, s_total};
    return launch_flush(src, (long long)rows * n, w_out, valid, s_total,
                        events_per_block, stats, out, (cudaStream_t)stream);
}

}  // extern "C"

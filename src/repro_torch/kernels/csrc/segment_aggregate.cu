// Segment aggregation (reduce-by-key) for Hopper (sm_90a): the three folds
// of Aion's late-event loop, in their global-atomic design. Where a block's
// partial fits shared memory, the wrappers take the designs of
// segment_splitk.cu instead (splitk_design); these kernels keep the rest.
//
//   seg_agg_flat              replaces segment_aggregate_pallas
//                             (repro/kernels/segment_aggregate.py, _kernel /
//                             _acc_tile): values [N, W] (row stride ld),
//                             ids [N], valid [N] -> per-segment stats.
//   seg_agg_block_table       replaces segment_aggregate_block_table_pallas
//                             (_bt_kernel): row r's event tile is read
//                             straight out of arena[table[r]], keeping the
//                             first num_cols value columns.
//   seg_agg_block_table_splitk replaces
//                             segment_aggregate_block_table_splitk_pallas
//                             (_bt_splitk_kernel): as the block-table fold,
//                             but row r accumulates into partial
//                             r / chunk_rows of a [k, S(, num_cols)] buffer.
//
// Outputs (each may be null = stat not requested, never touched):
//   sum [S, w_out], count [S], min [S, w_out], max [S, w_out], float32,
//   initialised by the caller to the fold identities 0 / 0 / +inf / -inf.
//
// What bounds it: bytes. Every valid event is read once (its valid flag,
// its composite id and num_cols value floats) and costs a handful of
// atomics, so the least time is the input bytes over the 3.35 TB/s of HBM3;
// there is no arithmetic worth counting and no matrix product (the TPU
// kernel's one-hot MXU matmul is not carried over, so TF32 never enters).
// The design is the simple one: one thread per event, global atomics into
// the outputs. sum and count use atomicAdd; min and max use a
// compare-and-swap loop so that a NaN wins, as jnp.minimum / jnp.maximum
// do (fminf / fmaxf would drop it). Shared-memory privatisation of the
// accumulators, coalesced column loads and TMA are left for later work.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// NaN-propagating atomic minimum: the stored value becomes NaN if either
// operand is NaN, else the smaller one (jnp.minimum semantics).
__device__ __forceinline__ void atomic_min_nan(float* addr, float v) {
    int* a = reinterpret_cast<int*>(addr);
    int old = *reinterpret_cast<volatile int*>(a);
    while (true) {
        float cur = __int_as_float(old);
        if (cur != cur) return;                  // already NaN
        if (!(v != v) && !(v < cur)) return;     // no change
        int assumed = old;
        old = atomicCAS(a, assumed, __float_as_int(v));
        if (old == assumed) return;
    }
}

// NaN-propagating atomic maximum (jnp.maximum semantics).
__device__ __forceinline__ void atomic_max_nan(float* addr, float v) {
    int* a = reinterpret_cast<int*>(addr);
    int old = *reinterpret_cast<volatile int*>(a);
    while (true) {
        float cur = __int_as_float(old);
        if (cur != cur) return;
        if (!(v != v) && !(v > cur)) return;
        int assumed = old;
        old = atomicCAS(a, assumed, __float_as_int(v));
        if (old == assumed) return;
    }
}

// Fold one event (its first w_out value columns at `row`) into segment s.
__device__ __forceinline__ void accumulate(
        const float* __restrict__ row, int w_out, long long s,
        float* sum, float* cnt, float* mn, float* mx) {
    if (cnt) atomicAdd(cnt + s, 1.0f);
    float* srow = sum ? sum + s * w_out : nullptr;
    float* nrow = mn ? mn + s * w_out : nullptr;
    float* xrow = mx ? mx + s * w_out : nullptr;
    for (int c = 0; c < w_out; ++c) {
        float v = __ldg(row + c);
        if (srow) atomicAdd(srow + c, v);
        if (nrow) atomic_min_nan(nrow + c, v);
        if (xrow) atomic_max_nan(xrow + c, v);
    }
}

__global__ void __launch_bounds__(kThreads) flat_kernel(
        const float* __restrict__ vals, long long ld, int w,
        const int* __restrict__ ids, const uint8_t* __restrict__ valid,
        long long n, int num_seg,
        float* sum, float* cnt, float* mn, float* mx) {
    long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
    if (i >= n || !valid[i]) return;
    int s = ids[i];
    if (s < 0 || s >= num_seg) return;           // matches no segment
    accumulate(vals + i * ld, w, s, sum, cnt, mn, mx);
}

// grid (R, ceil(cap / kThreads)); event e of table row r. Row r's partial
// is r / chunk_rows (chunk_rows = R: one partial, the block-table fold).
__global__ void __launch_bounds__(kThreads) block_table_kernel(
        const float* __restrict__ arena, int pool_slots, int cap, int w,
        int num_cols, const int* __restrict__ table,
        const int* __restrict__ ids, const uint8_t* __restrict__ valid,
        int num_seg, int chunk_rows,
        float* sum, float* cnt, float* mn, float* mx) {
    int r = blockIdx.x;
    int e = blockIdx.y * kThreads + threadIdx.x;
    if (e >= cap) return;
    long long ev = (long long)r * cap + e;
    if (!valid[ev]) return;
    int s = ids[ev];
    int p = table[r];
    if (s < 0 || s >= num_seg || p < 0 || p >= pool_slots) return;
    long long part = r / chunk_rows;
    long long seg = part * num_seg + s;
    const float* row = arena + ((long long)p * cap + e) * w;
    accumulate(row, num_cols, seg, sum, cnt, mn, mx);
}

int launch_block_table(const float* arena, int pool_slots, int cap, int w,
                       int num_cols, const int* table, int r,
                       const int* ids, const uint8_t* valid, int num_seg,
                       int chunk_rows, float* sum, float* cnt, float* mn,
                       float* mx, cudaStream_t stream) {
    dim3 grid(r, (cap + kThreads - 1) / kThreads);
    block_table_kernel<<<grid, kThreads, 0, stream>>>(
        arena, pool_slots, cap, w, num_cols, table, ids, valid, num_seg,
        chunk_rows, sum, cnt, mn, mx);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int seg_agg_flat(const float* vals, long long ld, int w, const int* ids,
                 const uint8_t* valid, long long n, int num_seg,
                 float* sum, float* cnt, float* mn, float* mx,
                 void* stream) {
    long long blocks = (n + kThreads - 1) / kThreads;
    flat_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        vals, ld, w, ids, valid, n, num_seg, sum, cnt, mn, mx);
    return (int)cudaGetLastError();
}

int seg_agg_block_table(const float* arena, int pool_slots, int cap, int w,
                        int num_cols, const int* table, int r,
                        const int* ids, const uint8_t* valid, int num_seg,
                        float* sum, float* cnt, float* mn, float* mx,
                        void* stream) {
    return launch_block_table(arena, pool_slots, cap, w, num_cols, table, r,
                              ids, valid, num_seg, r, sum, cnt, mn, mx,
                              (cudaStream_t)stream);
}

int seg_agg_block_table_splitk(const float* arena, int pool_slots, int cap,
                               int w, int num_cols, const int* table, int r,
                               const int* ids, const uint8_t* valid,
                               int num_seg, int chunk_rows, float* sum,
                               float* cnt, float* mn, float* mx,
                               void* stream) {
    return launch_block_table(arena, pool_slots, cap, w, num_cols, table, r,
                              ids, valid, num_seg, chunk_rows, sum, cnt, mn,
                              mx, (cudaStream_t)stream);
}

}  // extern "C"

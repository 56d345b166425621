// Mamba-2 SSD chunk scan for Hopper (sm_90a): K7 of the SSM prefill.
//
//   ssd_scan  replaces ssd_scan_pallas (repro/kernels/ssd_scan.py, _kernel):
//             the state-space-duality scan, forward, with the carried state
//             passed in and out. K7's cuda_core design: float32, and the
//             shapes the tensor-core design (ssd_hopper.cu) does not take
//             (the table of repro_torch/kernels/ssd_scan.py, ssd_design).
//
// Layout: the model's. xdt [b, s, h, p] (x * dt), a [b, s, h] float32
// (dt * A, <= 0), B and C [b, s, n] shared by every head (n_groups = 1),
// init_state [b, h, p, n] float32 or null (zeros); y [b, s, h, p] in xdt's
// type and final_state [b, h, p, n] float32. xdt, B, C and y are float32 or
// bfloat16, one type.
//
// What it computes, for each batch row and head (the recurrence of the
// sequential oracle ref_ssd_chunk_scan):
//   h_t = exp(a_t) * h_{t-1} + xdt_t (x) B_t        ([p, n])
//   y_t = h_t . C_t                                 ([p])
// chunk by chunk: with cum the running sum of a inside a chunk and H the
// state entering it,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//           + exp(cum_i) H . C_i
//   H_out = exp(cum_last) H + sum_j exp(cum_last - cum_j) xdt_j (x) B_j
// All in float32; y is rounded once on the store. The Pallas kernel keeps
// the state in VMEM scratch and returns y only; here the state enters from
// init_state and leaves in final_state, so a streaming prefill continues
// a sequence chunk after chunk.
//
// Never exponentiate a positive number: the Pallas kernel computes
// exp(cum_i - cum_j) for every pair, where for j > i the exponent is
// positive and can reach inf, and then selects 0 there with jnp.where, so
// no inf enters a product and no NaN arises. Here the decay is computed
// for j <= i only, as a select, so no inf arises at all. Every other
// exponent (cum_i, cum_last - cum_j, cum_last) is <= 0 because a is.
//
// What bounds it: bytes. The chunked algorithm at the model's chunk of 256
// does 2 Q n flops a token for the scores (shared by the heads), Q h p for
// the causal half of the intra-chunk product and 4 h p n for the
// inter-chunk term and the state update: at mamba2-780m's widths (h 48,
// p 64, n 128) 2.4 Mflop a token against 12.7 KB moved (xdt and y in
// bf16, a, B and C), 190 flops a byte, below the 295 at which the bf16
// tensor cores would be the limit. This kernel computes on the CUDA cores
// in float32 (67 TFLOP/s), so it is far from that bound.
//
// Design (simple first): one block per (slice of 16 rows of p, head, batch
// row), 256 threads, walking the sequence in chunks of 64 tokens (its own
// chunk: at the model's 256, float32 B and C tiles alone would need 256 KB
// of shared memory). The block's [16, n] slice of the state stays in shared
// memory the whole way; the p rows of the state are independent, so the
// slices need nothing from each other, and slicing p gives 192 blocks for
// a single batch row at mamba2's widths instead of 48. Per chunk: a, B, C
// and the xdt slice are staged as float32; the score tile C.B^T [64, 64]
// (recomputed by every block of the row: a later design shares it) is
// decayed and masked into shared memory, skipping the register tiles that
// lie above the diagonal; y takes the intra- and inter-chunk terms; then
// the state is updated. A ragged last chunk is padded with a = 0 and zero
// xdt, B and C, which leaves the state and the valid rows unchanged. The
// products run on the CUDA cores (ssd_hopper.cu puts bf16 inputs on the
// tensor cores, with a score tile shared by a block's heads). Shared memory: (2 * 64 + 16) (n + 1) + 64 * 65 +
// 64 * 17 + 3 * 64 floats, 96 KB at n 128 and 168 KB at n 256 (the most
// it takes).
//
// The entry point allocates nothing and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);   // round to nearest even, as torch
}

constexpr int kQ = 64;          // tokens per chunk
constexpr int kPT = 16;         // rows of p per block
constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxN = 256;      // the widest state the shared memory holds

size_t smem_bytes(int n) {
    const size_t ld = (size_t)n + 1;
    return sizeof(float) * (2 * kQ * ld + kQ * (kQ + 1) + kQ * (kPT + 1)
                            + kPT * ld + 3 * kQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ a,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ init_state, T* __restrict__ y,
                float* __restrict__ final_state, int S, int H, int P,
                int N) {
    extern __shared__ float smem[];
    const int ld = N + 1;                 // odd for even n: no bank conflict
    float* sB = smem;                     // [kQ][ld]
    float* sC = sB + kQ * ld;             // [kQ][ld]
    float* sS = sC + kQ * ld;             // [kQ][kQ + 1] decayed scores
    float* sX = sS + kQ * (kQ + 1);       // [kQ][kPT + 1]
    float* sH = sX + kQ * (kPT + 1);      // [kPT][ld] the state slice
    float* sCum = sH + kPT * ld;          // [kQ] cum
    float* sW = sCum + kQ;                // [kQ] exp(cum_last - cum_j)
    float* sE = sW + kQ;                  // [kQ] exp(cum_i)

    const int p0 = blockIdx.x * kPT;
    const int hh = blockIdx.y;
    const int bb = blockIdx.z;
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    const int np = min(kPT, P - p0);
    const long long head_state = ((long long)bb * H + hh) * P;

    for (int i = tid; i < kPT * N; i += kThreads) {
        const int pr = i / N;
        const int nn = i - pr * N;
        float v = 0.f;
        if (init_state != nullptr && pr < np)
            v = init_state[(head_state + p0 + pr) * N + nn];
        sH[pr * ld + nn] = v;
    }

    for (int t0 = 0; t0 < S; t0 += kQ) {
        const int q = min(kQ, S - t0);
        __syncthreads();   // the last chunk's state update is done with B, X
        for (int i = tid; i < kQ * N; i += kThreads) {
            const int r = i / N;
            const int nn = i - r * N;
            float bv = 0.f, cv = 0.f;
            if (r < q) {
                const long long off = ((long long)bb * S + t0 + r) * N + nn;
                bv = to_f32(Bm[off]);
                cv = to_f32(Cm[off]);
            }
            sB[r * ld + nn] = bv;
            sC[r * ld + nn] = cv;
        }
        for (int i = tid; i < kQ * kPT; i += kThreads) {
            const int r = i / kPT;
            const int pr = i - r * kPT;
            float xv = 0.f;
            if (r < q && pr < np)
                xv = to_f32(xdt[(((long long)bb * S + t0 + r) * H + hh) * P
                                + p0 + pr]);
            sX[r * (kPT + 1) + pr] = xv;
        }
        if (tid < kQ)
            sCum[tid] = tid < q
                ? a[((long long)bb * S + t0 + tid) * H + hh] : 0.f;
        __syncthreads();
        if (tid == 0) {
            float c = 0.f;
            for (int r = 0; r < kQ; ++r) {
                c += sCum[r];
                sCum[r] = c;
            }
        }
        __syncthreads();
        const float total = sCum[kQ - 1];
        if (tid < kQ) {
            sW[tid] = expf(total - sCum[tid]);
            sE[tid] = expf(sCum[tid]);
        }

        // scores: rows ty + 16 r, columns tx + 16 c; the tiles c > r lie
        // wholly above the diagonal and are skipped
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        for (int nn = 0; nn < N; ++nn) {
            float cv[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ld + nn];
#pragma unroll
            for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * ld + nn];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c <= r; ++c)
                    acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = ty + 16 * r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = tx + 16 * c;
                sS[i * (kQ + 1) + j] =
                    j <= i ? acc[r][c] * expf(sCum[i] - sCum[j]) : 0.f;
            }
        }
        __syncthreads();

        // y: p row tx, token rows ty + 16 r
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = ty + 16 * r;
            float intra = 0.f;
            for (int j = 0; j <= i; ++j)
                intra = fmaf(sS[i * (kQ + 1) + j], sX[j * (kPT + 1) + tx],
                             intra);
            float inter = 0.f;
            for (int nn = 0; nn < N; ++nn)
                inter = fmaf(sC[i * ld + nn], sH[tx * ld + nn], inter);
            if (i < q && tx < np)
                y[(((long long)bb * S + t0 + i) * H + hh) * P + p0 + tx] =
                    from_f32<T>(intra + sE[i] * inter);
        }
        __syncthreads();

        // state update
        const float decay = expf(total);
        for (int i = tid; i < kPT * N; i += kThreads) {
            const int pr = i / N;
            const int nn = i - pr * N;
            float upd = 0.f;
            for (int j = 0; j < q; ++j)
                upd = fmaf(sW[j] * sX[j * (kPT + 1) + pr], sB[j * ld + nn],
                           upd);
            sH[pr * ld + nn] = fmaf(decay, sH[pr * ld + nn], upd);
        }
    }
    __syncthreads();
    for (int i = tid; i < kPT * N; i += kThreads) {
        const int pr = i / N;
        const int nn = i - pr * N;
        if (pr < np) final_state[(head_state + p0 + pr) * N + nn] =
            sH[pr * ld + nn];
    }
}

template <typename T>
cudaError_t launch_scan(const void* xdt, const float* a, const void* B,
                        const void* C, const float* init_state, void* y,
                        float* final_state, int b, int s, int h, int p,
                        int n, cudaStream_t stream) {
    const size_t smem = smem_bytes(n);
    auto kern = ssd_scan_kernel<T>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3((p + kPT - 1) / kPT, h, b), kThreads, smem, stream>>>(
        static_cast<const T*>(xdt), a, static_cast<const T*>(B),
        static_cast<const T*>(C), init_state, static_cast<T*>(y),
        final_state, s, h, p, n);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xdt, B, C and y). init_state may be
// null (a zero state).
extern "C" int ssd_scan(const void* xdt, const void* a, const void* B,
                        const void* C, const void* init_state, void* y,
                        void* final_state, int b, int s, int h, int p, int n,
                        int dtype, void* stream) {
    if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || n > kMaxN
            || b > 65535 || h > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* af = static_cast<const float*>(a);
    const float* h0 = static_cast<const float*>(init_state);
    float* hf = static_cast<float*>(final_state);
    if (dtype == 0)
        return (int)launch_scan<float>(xdt, af, B, C, h0, y, hf, b, s, h, p,
                                       n, st);
    if (dtype == 1)
        return (int)launch_scan<__nv_bfloat16>(xdt, af, B, C, h0, y, hf, b,
                                               s, h, p, n, st);
    return (int)cudaErrorInvalidValue;
}

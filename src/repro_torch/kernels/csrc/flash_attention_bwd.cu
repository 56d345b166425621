// Flash attention backward for Hopper (sm_90a): K6 of the LM training path.
//
//   flash_attention_bwd  replaces flash_attention_bwd_pallas
//                        (repro/kernels/flash_attention_bwd.py, _dq_kernel
//                        and _dkv_kernel): the FlashAttention-2 backward,
//                        recomputing the probabilities from the forward's
//                        log-sum-exp instead of saving them.
//
// Layout: the model's, with GQA native. q, o, dO, dq [B, Sq, H, D]; k, v,
// dk, dv [B, Sk, Hkv, D]; lse [B*H, Sq] float32 in (b, hkv, g) order, as
// flash_attention_fwd (attention.cu) writes it; delta, scratch of the same
// shape. Positions count from 0 for q and for k, so Sq != Sk works as in
// the forward; causal keeps k <= q, window > 0 keeps q - k < window.
//
// What it computes, for each query row i, key j in the mask, and head h
// of KV head hk (scale = 1 / sqrt(D)):
//   p    = exp(scale * q_i.k_j - lse_i)
//   D_i  = rowsum(dO_i * o_i)
//   ds   = p * (dO_i.v_j - D_i)
//   dq_i = scale * sum_j ds * k_j
//   dk_j = scale * sum_{i, h in hk's group} ds * q_i
//   dv_j =         sum_{i, h in hk's group} p * dO_i
// All in float32, written once in the inputs' type. The JAX wrapper
// repeats K and V over the group (9x their bytes at starcoder2-7b) and sums
// dK and dV per group after rounding each head to the input type; here the
// dk/dv pass reads the shared KV head and sums the group in float32, so
// the result follows the float32 oracle (autograd through
// ref_flash_attention). A key or query outside the mask contributes
// nothing: a row with nothing to attend to (its lse -inf, its o NaN) gets
// dq = 0 and adds nothing to dk or dv, as the plain version defines it.
// An optional per-row key length (kv_len [B] int32, null for Sk, clamped
// to [0, Sk]) masks the keys j >= kv_len[b], as the forward does: the dq
// pass ends a block's key tiles at the length, and a dk/dv block of keys
// wholly past it walks no query tile and writes its zeros.
//
// What bounds it: operations. 10 * D flops per attended (q, k) pair and
// head (the recomputed scores, dP, dV, dQ and dK) at the 989 TFLOP/s bf16
// dense tensor-core peak: 7.7e11 flops, about 0.78 ms, for starcoder2-7b's
// training shape (B 2, S 4,096, causal, 36 heads of 128).
//
// Design (simple first, as K5): three launches on the caller's stream.
//   delta  one warp per (b, i, h) row: D_i = rowsum(dO * o) in float32.
//   dq     one block per (b * h, tile of 64 query rows), 256 threads of 4
//          rows x 4 keys of the score tile and 4 rows x D / 16 columns of
//          dq. The query and dO tiles stay in shared memory; for each key
//          tile of the band, V is staged (dP = dO.V^T), then K in the same
//          buffer (S = Q.K^T, then ds, then dq += ds.K).
//   dk/dv  one block per (b * hkv, tile of 64 keys), K and V staged once;
//          it walks the g query heads of the group and the query tiles of
//          the band, staging Q (S), dO (dP, then dv += p.dO) and Q again
//          (dk += ds.Q) in one buffer, with lse and D of the tile. dk and
//          dv stay in registers in float32 and are written once: no
//          atomics, so the result is deterministic.
// Tiles that the mask empties are skipped (the Pallas kernel computes them
// masked), which halves the causal work and changes no result. The
// products run in float32 on the CUDA cores, as K5's; wgmma, TMA and warp
// specialisation are later work. Shared memory: three [64][D + 1] float
// tiles and one [64][65], 116 KB at D 128 and 214 KB at D 256.
//
// The entry point allocates nothing and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
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

constexpr int kBQ = 64;              // query rows per tile
constexpr int kBK = 64;              // key positions per tile
constexpr int kThreads = 256;        // 16 x 16: 4 rows x 4 columns each
constexpr int kDeltaWarps = 8;

template <int D>
constexpr size_t bwd_smem_bytes() {
    // three [64][D + 1] tiles, one [64][65] tile of p or ds, and the lse
    // and D of a query tile
    return sizeof(float) * (size_t)(3 * kBQ * (D + 1) + kBQ * (kBK + 1)
                                    + 2 * kBQ);
}

// rows [r0, r0 + 64) of a [rows, D] slice with position stride `stride`,
// as floats into tile [64][D + 1]; rows past `rows` are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* __restrict__ tile,
                                      const T* __restrict__ base, int r0,
                                      int rows, long long stride) {
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
        const int r = i / D;
        const int d = i - r * D;
        tile[r * (D + 1) + d] =
            r0 + r < rows ? to_f32(base[(long long)(r0 + r) * stride + d])
                          : 0.f;
    }
}

// the row's keys end at len (Sk, or the row's clamped kv_len)
__device__ __forceinline__ bool attends(int qi, int kj, int Sq, int len,
                                        int causal, int window) {
    bool ok = qi < Sq && kj < len;
    if (causal) ok = ok && qi >= kj;
    if (window > 0) ok = ok && qi - kj < window;
    return ok;
}

template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                 float* __restrict__ delta, long long rows, int Sq, int H,
                 int D) {
    const long long row =
        (long long)blockIdx.x * kDeltaWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const T* a = o + row * D;
    const T* b = dO + row * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(to_f32(a[d]), to_f32(b[d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
        // row = (b * Sq + i) * H + h  ->  delta[(b * H + h) * Sq + i]
        const long long bi = row / H;
        const int h = (int)(row - bi * H);
        const long long b_ = bi / Sq;
        const int i = (int)(bi - b_ * Sq);
        delta[(b_ * H + h) * Sq + i] = s;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, const int* __restrict__ kv_len, int Sq,
              int Sk, int H, int Hkv, int causal, int window, float scale) {
    constexpr int NJ = D / 16;        // dq columns per thread
    constexpr int LD = D + 1;         // padded rows: conflict-free columns
    constexpr int LDP = kBK + 1;
    extern __shared__ float smem[];
    float* q_s = smem;                // [kBQ][LD]
    float* do_s = q_s + kBQ * LD;     // [kBQ][LD]
    float* kv_s = do_s + kBQ * LD;    // [kBK][LD]: V, then K, of a tile
    float* ds_s = kv_s + kBK * LD;    // [kBQ][LDP]

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int hk = h / (H / Hkv);
    const int q0 = blockIdx.x * kBQ;
    const int tid = threadIdx.x;
    const int ty = tid >> 4;          // rows ty + 16 r
    const int tx = tid & 15;          // keys / columns tx + 16 c
    const long long q_pos = (long long)H * D;
    const long long kv_pos = (long long)Hkv * D;
    const long long q_off = (long long)b * Sq * q_pos + (long long)h * D;
    const T* kb = k + (long long)b * Sk * kv_pos + (long long)hk * D;
    const T* vb = v + (long long)b * Sk * kv_pos + (long long)hk * D;

    stage<T, D>(q_s, q + q_off, q0, Sq, q_pos);
    stage<T, D>(do_s, dO + q_off, q0, Sq, q_pos);
    float lse_r[4], dl_r[4], acc[4][NJ];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int qi = q0 + ty + 16 * r;
        lse_r[r] = qi < Sq ? lse[(long long)bh * Sq + qi] : 0.f;
        dl_r[r] = qi < Sq ? delta[(long long)bh * Sq + qi] : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
    }

    // this row's keys end at its length (Sk without kv_len); the keys
    // some row of this tile may attend to: [k_lo, k_hi)
    const int len = kv_len == nullptr ? Sk : min(max(kv_len[b], 0), Sk);
    const int q_last = min(q0 + kBQ, Sq) - 1;
    const int k_hi = causal ? min(len, q_last + 1) : len;
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int t_lo = k_lo / kBK;
    const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;

    for (int t = t_lo; t < t_hi; ++t) {
        const int k0 = t * kBK;
        __syncthreads();              // the last tile's dq products are done
        stage<T, D>(kv_s, vb, k0, len, kv_pos);
        __syncthreads();
        float dp[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) dp[r][c] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float a[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = do_s[(ty + 16 * r) * LD + d];
#pragma unroll
            for (int c = 0; c < 4; ++c) bv[c] = kv_s[(tx + 16 * c) * LD + d];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    dp[r][c] = fmaf(a[r], bv[c], dp[r][c]);
        }
        __syncthreads();              // V is read
        stage<T, D>(kv_s, kb, k0, len, kv_pos);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float a[4], bk[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = q_s[(ty + 16 * r) * LD + d];
#pragma unroll
            for (int c = 0; c < 4; ++c) bk[c] = kv_s[(tx + 16 * c) * LD + d];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    s[r][c] = fmaf(a[r], bk[c], s[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int qi = q0 + ty + 16 * r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int kj = k0 + tx + 16 * c;
                float ds = 0.f;       // outside the mask: nothing, even
                                      // where lse is -inf or D is NaN
                if (attends(qi, kj, Sq, len, causal, window)) {
                    const float p = expf(s[r][c] * scale - lse_r[r]);
                    ds = p * (dp[r][c] - dl_r[r]);
                }
                ds_s[(ty + 16 * r) * LDP + tx + 16 * c] = ds;
            }
        }
        __syncthreads();              // ds is written, K stays staged
#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
            float dsv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) dsv[r] = ds_s[(ty + 16 * r) * LDP + kk];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float kv = kv_s[kk * LD + tx + 16 * j];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    acc[r][j] = fmaf(dsv[r], kv, acc[r][j]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int qi = q0 + ty + 16 * r;
        if (qi >= Sq) continue;
        T* row = dq + q_off + (long long)qi * q_pos;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            row[tx + 16 * j] = from_f32<T>(acc[r][j] * scale);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dO,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, const int* __restrict__ kv_len, int Sq,
               int Sk, int H, int Hkv, int causal, int window, float scale) {
    constexpr int NJ = D / 16;        // dk / dv columns per thread
    constexpr int LD = D + 1;
    constexpr int LDQ = kBQ + 1;
    extern __shared__ float smem[];
    float* k_s = smem;                // [kBK][LD]
    float* v_s = k_s + kBK * LD;      // [kBK][LD]
    float* t_s = v_s + kBK * LD;      // [kBQ][LD]: Q, dO, Q of a tile
    float* p_s = t_s + kBQ * LD;      // [kBK][LDQ]: p, then ds
    float* lse_s = p_s + kBK * LDQ;   // [kBQ]
    float* dl_s = lse_s + kBQ;        // [kBQ]

    const int bhk = blockIdx.y;
    const int b = bhk / Hkv;
    const int hk = bhk - b * Hkv;
    const int G = H / Hkv;
    const int k0 = blockIdx.x * kBK;
    const int tid = threadIdx.x;
    const int ty = tid >> 4;          // keys ty + 16 r
    const int tx = tid & 15;          // queries / columns tx + 16 c
    const long long q_pos = (long long)H * D;
    const long long kv_pos = (long long)Hkv * D;
    const long long kv_off = (long long)b * Sk * kv_pos + (long long)hk * D;

    // this row's keys end at its length (Sk without kv_len)
    const int len = kv_len == nullptr ? Sk : min(max(kv_len[b], 0), Sk);
    stage<T, D>(k_s, k + kv_off, k0, len, kv_pos);
    stage<T, D>(v_s, v + kv_off, k0, len, kv_pos);
    float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            dk_acc[r][j] = 0.f;
            dv_acc[r][j] = 0.f;
        }

    // the queries that may attend some key of this tile: [q_lo, q_hi);
    // none where the tile lies wholly past the length (its zeros written)
    const int k_last = min(k0 + kBK, Sk) - 1;
    const int q_lo = causal ? k0 : 0;
    const int q_hi = k0 >= len ? q_lo
        : window > 0 ? min(Sq, k_last + window) : Sq;
    const int t_lo = q_lo / kBQ;
    const int t_hi = q_hi > q_lo ? (q_hi + kBQ - 1) / kBQ : t_lo;

    for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        const long long bh = (long long)b * H + h;
        const long long q_off = (long long)b * Sq * q_pos + (long long)h * D;
        for (int t = t_lo; t < t_hi; ++t) {
            const int q0 = t * kBQ;
            __syncthreads();          // the last tile's dk products are done
            stage<T, D>(t_s, q + q_off, q0, Sq, q_pos);
            for (int i = tid; i < kBQ; i += kThreads) {
                const bool in = q0 + i < Sq;
                lse_s[i] = in ? lse[bh * Sq + q0 + i] : 0.f;
                dl_s[i] = in ? delta[bh * Sq + q0 + i] : 0.f;
            }
            __syncthreads();
            float p[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) p[r][c] = 0.f;
#pragma unroll 4
            for (int d = 0; d < D; ++d) {
                float a[4], bq[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) a[r] = k_s[(ty + 16 * r) * LD + d];
#pragma unroll
                for (int c = 0; c < 4; ++c) bq[c] = t_s[(tx + 16 * c) * LD + d];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        p[r][c] = fmaf(a[r], bq[c], p[r][c]);
            }
            bool ok[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int kj = k0 + ty + 16 * r;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int qi = q0 + tx + 16 * c;
                    ok[r][c] = attends(qi, kj, Sq, len, causal, window);
                    p[r][c] = ok[r][c]
                        ? expf(p[r][c] * scale - lse_s[tx + 16 * c]) : 0.f;
                }
            }
            __syncthreads();          // Q is read
            stage<T, D>(t_s, dO + q_off, q0, Sq, q_pos);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    p_s[(ty + 16 * r) * LDQ + tx + 16 * c] = p[r][c];
            __syncthreads();
            float dp[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) dp[r][c] = 0.f;
#pragma unroll 4
            for (int d = 0; d < D; ++d) {
                float a[4], bq[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) a[r] = v_s[(ty + 16 * r) * LD + d];
#pragma unroll
                for (int c = 0; c < 4; ++c) bq[c] = t_s[(tx + 16 * c) * LD + d];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        dp[r][c] = fmaf(a[r], bq[c], dp[r][c]);
            }
#pragma unroll 4
            for (int qq = 0; qq < kBQ; ++qq) {
                float pv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) pv[r] = p_s[(ty + 16 * r) * LDQ + qq];
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const float dov = t_s[qq * LD + tx + 16 * j];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        dv_acc[r][j] = fmaf(pv[r], dov, dv_acc[r][j]);
                }
            }
            __syncthreads();          // dO and p are read
            stage<T, D>(t_s, q + q_off, q0, Sq, q_pos);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    p_s[(ty + 16 * r) * LDQ + tx + 16 * c] = ok[r][c]
                        ? p[r][c] * (dp[r][c] - dl_s[tx + 16 * c]) : 0.f;
            __syncthreads();
#pragma unroll 4
            for (int qq = 0; qq < kBQ; ++qq) {
                float dsv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) dsv[r] = p_s[(ty + 16 * r) * LDQ + qq];
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const float qv = t_s[qq * LD + tx + 16 * j];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        dk_acc[r][j] = fmaf(dsv[r], qv, dk_acc[r][j]);
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int kj = k0 + ty + 16 * r;
        if (kj >= Sk) continue;
        T* krow = dk + kv_off + (long long)kj * kv_pos;
        T* vrow = dv + kv_off + (long long)kj * kv_pos;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            krow[tx + 16 * j] = from_f32<T>(dk_acc[r][j] * scale);
            vrow[tx + 16 * j] = from_f32<T>(dv_acc[r][j]);
        }
    }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dO, const float* lse,
                       const int* kv_len, float* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int H, int Hkv,
                       int causal, int window, cudaStream_t stream) {
    const long long rows = (long long)B * Sq * H;
    const unsigned delta_blocks =
        (unsigned)((rows + kDeltaWarps - 1) / kDeltaWarps);
    bwd_delta_kernel<T><<<delta_blocks, kDeltaWarps * 32, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dO), delta, rows, Sq,
        H, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;

    constexpr size_t smem = bwd_smem_bytes<D>();
    const float scale = 1.0f / sqrtf((float)D);
    auto dq_kern = bwd_dq_kernel<T, D>;
    if ((e = allow_smem(dq_kern, smem)) != cudaSuccess) return e;
    dq_kern<<<dim3((Sq + kBQ - 1) / kBQ, B * H), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
        static_cast<T*>(dq), kv_len, Sq, Sk, H, Hkv, causal, window, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;

    auto dkv_kern = bwd_dkv_kernel<T, D>;
    if ((e = allow_smem(dkv_kern, smem)) != cudaSuccess) return e;
    dkv_kern<<<dim3((Sk + kBK - 1) / kBK, B * Hkv), kThreads, smem,
               stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), kv_len, Sq, Sk, H, Hkv,
        causal, window, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_by_dim(int D, const void* q, const void* k, const void* v,
                       const void* o, const void* dO, const float* lse,
                       const int* n, float* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int H, int Hkv,
                       int causal, int window, cudaStream_t stream) {
    switch (D) {
        case 32: return launch_bwd<T, 32>(q, k, v, o, dO, lse, n, delta, dq,
                                          dk, dv, B, Sq, Sk, H, Hkv, causal,
                                          window, stream);
        case 64: return launch_bwd<T, 64>(q, k, v, o, dO, lse, n, delta, dq,
                                          dk, dv, B, Sq, Sk, H, Hkv, causal,
                                          window, stream);
        case 128: return launch_bwd<T, 128>(q, k, v, o, dO, lse, n, delta,
                                            dq, dk, dv, B, Sq, Sk, H, Hkv,
                                            causal, window, stream);
        case 256: return launch_bwd<T, 256>(q, k, v, o, dO, lse, n, delta,
                                            dq, dk, dv, B, Sq, Sk, H, Hkv,
                                            causal, window, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len: int32 [B] or null.
extern "C" int flash_attention_bwd(
        const void* q, const void* k, const void* v, const void* o,
        const void* dO, const void* lse, const void* kv_len, void* delta,
        void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv,
        int D, int causal, int window, int dtype, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    const int* n = static_cast<const int*>(kv_len);
    float* dl = static_cast<float*>(delta);
    if (dtype == 0)
        return (int)bwd_by_dim<float>(D, q, k, v, o, dO, l, n, dl, dq, dk, dv,
                                      B, Sq, Sk, H, Hkv, causal, window, s);
    if (dtype == 1)
        return (int)bwd_by_dim<__nv_bfloat16>(D, q, k, v, o, dO, l, n, dl, dq,
                                              dk, dv, B, Sq, Sk, H, Hkv,
                                              causal, window, s);
    return (int)cudaErrorInvalidValue;
}

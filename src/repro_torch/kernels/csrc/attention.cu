// Attention for Hopper (sm_90a): the two kernels of the LM serving path.
//
//   decode_attention_paged  replaces decode_attention_paged_pallas
//                           (repro/kernels/decode_attention.py, _kernel):
//                           paged decode attention with GQA. q [B, H, D],
//                           k/v pages [P, page, Hkv, D], block table
//                           [B, pages_per_seq] int32 (-1 = not resident),
//                           seq_lens [B] int32 -> out [B, H, D].
//   flash_attention_fwd     replaces flash_attention_pallas
//                           (repro/kernels/flash_attention.py, _kernel):
//                           causal / sliding-window attention forward with
//                           GQA. q [B, Sq, H, D], k/v [B, Sk, Hkv, D] ->
//                           o [B, Sq, H, D] and lse [B*H, Sq] float32.
//
// Both take float32 or bfloat16 (q, k and v of one type), do every product
// and the softmax in float32 on the CUDA cores (no tensor cores, so no TF32
// and no bf16 rounding of the probabilities), and write q's type.
//
// Masking follows repro/kernels/ref.py, not the Pallas wrapper: a -1 page
// and every position >= seq_len contribute nothing (the Pallas wrapper
// clamps the table to >= 0 and reads such a page as page 0), and a row
// with no position to attend to (seq_len == 0, or only -1 pages) is NaN,
// as a softmax over nothing is in the oracle. Pages outside [0, P) are
// skipped as -1 pages are.
//
// decode_attention_paged. What bounds it: bytes. Every resident position
// of a sequence is read once per KV head, K and V, so the least time is
// sum_b seq_len_b * Hkv * D * 2 (K and V) * sizeof(T) over the 3.35 TB/s of
// HBM3 (about 167 MB, 50 us, for 16 sequences of 5,100 tokens at
// starcoder2-7b's 4 KV heads of 128). The arithmetic is 4 * G * D flops
// per position and head, far below the memory line. Design: one block per
// (batch row, KV head, chunk of up to 16 query heads of the group); the
// group's query rows sit in shared memory (G = 9 for starcoder2, 5 for
// hymba: no power of two is assumed). The block dereferences the table on
// the device and walks only the ceil(seq_len / page) pages of its sequence;
// its 8 warps take pages in turn, each lane holding D / 32 channels of a
// position's K and V (one coalesced row read per warp), with a warp
// shuffle reduction per query row and an fp32 online softmax
// (m, l, acc[G][D]) per warp, merged across warps in shared memory at the
// end. With B * Hkv = 64 blocks, half of the 132 SMs stay idle; splitting
// the KV range of a sequence across blocks (flash-decoding) is the next
// step, as is reading K and V through TMA.
//
// flash_attention_fwd. What bounds it: operations. 4 * B * H * Sq * Sk * D
// flops (halved when causal) at the 989 TFLOP/s bf16 dense tensor-core
// peak: 618 GFLOP, about 0.63 ms, for an 8,192-token causal prefill at
// starcoder2-7b's 36 heads of 128. Design: one block per (b * h, tile of
// 64 query rows); key and value tiles of 64 positions of the group's KV
// head are staged in shared memory in turn (K for the scores, then V for
// the products, in one buffer); 256 threads each own 4 query rows x 4 keys
// of the score tile and 4 rows x D / 16 columns of the output. An fp32
// online softmax keeps (m, l) per row; causal and window masks apply per
// element, and key tiles that every row of the tile masks are skipped. An
// optional per-row key length (kv_len [B] int32, clamped to [0, Sk]) ends
// a row's keys there: the key-tile loop stops at its tile, and the keys
// past it are masked (a row with none left is NaN, lse -inf). This runs
// on the fp32 CUDA cores, so it sits far below the tensor-core bound;
// wgmma, TMA and warp specialisation are later work.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>
#include <type_traits>

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

// One 32-bit word of T values as floats: a float, or two bfloat16 (the
// lower address in the low half; a bfloat16 is the top half of a float).
template <typename T>
__device__ __forceinline__ void word_to_f32(unsigned w, float* out) {
    if constexpr (std::is_same<T, float>::value) {
        out[0] = __uint_as_float(w);
    } else {
        out[0] = __uint_as_float(w << 16);
        out[1] = __uint_as_float(w & 0xffff0000u);
    }
}

// N contiguous T values at p (aligned to their size, up to 16 bytes) as
// floats, in as few vector loads as their bytes allow.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&out)[N]) {
    constexpr int kBytes = N * (int)sizeof(T);
    if constexpr (kBytes < 4) {
        out[0] = to_f32(p[0]);
    } else {
        constexpr int kWords = kBytes / 4;
        constexpr int kPer = 4 / (int)sizeof(T);
        const unsigned* w = reinterpret_cast<const unsigned*>(p);
        unsigned buf[kWords];
        if constexpr (kWords % 4 == 0) {
#pragma unroll
            for (int i = 0; i < kWords / 4; ++i) {
                const uint4 r = __ldg(reinterpret_cast<const uint4*>(w) + i);
                buf[4 * i] = r.x;
                buf[4 * i + 1] = r.y;
                buf[4 * i + 2] = r.z;
                buf[4 * i + 3] = r.w;
            }
        } else if constexpr (kWords % 2 == 0) {
#pragma unroll
            for (int i = 0; i < kWords / 2; ++i) {
                const uint2 r = __ldg(reinterpret_cast<const uint2*>(w) + i);
                buf[2 * i] = r.x;
                buf[2 * i + 1] = r.y;
            }
        } else {
#pragma unroll
            for (int i = 0; i < kWords; ++i) buf[i] = __ldg(w + i);
        }
#pragma unroll
        for (int i = 0; i < kWords; ++i) word_to_f32<T>(buf[i], out + i * kPer);
    }
}

// ------------------------------------------------------------------ K4
constexpr int kDecodeWarps = 8;

template <int DPL, int GC>
constexpr size_t decode_smem_bytes() {
    // q rows [GC][D], then per warp m [GC], l [GC] and acc [GC][D]
    return sizeof(float) * (size_t)(GC * 32 * DPL + 2 * kDecodeWarps * GC
                                    + kDecodeWarps * GC * 32 * DPL);
}

// DPL channels per lane (D = 32 * DPL); GC query heads per block.
template <typename T, int DPL, int GC>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lens, T* __restrict__ out,
                    int H, int Hkv, int P, int page, int pps, float scale) {
    constexpr int D = 32 * DPL;
    const int hk = blockIdx.x;
    const int b = blockIdx.y;
    const int G = H / Hkv;
    const int g0 = blockIdx.z * GC;
    const int gn = min(GC, G - g0);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    extern __shared__ float smem[];
    float* q_s = smem;                            // [GC][D]
    float* m_s = q_s + GC * D;                    // [warps][GC]
    float* l_s = m_s + kDecodeWarps * GC;         // [warps][GC]
    float* a_s = l_s + kDecodeWarps * GC;         // [warps][GC][D]

    const long long head0 = (long long)b * H + (long long)hk * G + g0;
    for (int i = threadIdx.x; i < GC * D; i += blockDim.x) {
        const int g = i / D;
        // rows past the group stay zero: their scores are computed and
        // never written
        q_s[i] = g < gn ? to_f32(q[(head0 + g) * D + (i - g * D)]) : 0.f;
    }
    __syncthreads();

    float m[GC], l[GC], acc[GC][DPL];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
        m[g] = -CUDART_INF_F;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
    }

    const int n = lens[b];
    const int npg = n > 0 ? min((n + page - 1) / page, pps) : 0;
    const long long pos_stride = (long long)Hkv * D;
    for (int j = warp; j < npg; j += kDecodeWarps) {
        const int pg = table[(long long)b * pps + j];
        if (pg < 0 || pg >= P) continue;          // not resident: masked
        const int tn = min(page, n - j * page);
        const long long base =
            ((long long)pg * page * Hkv + hk) * D + lane * DPL;
        for (int t = 0; t < tn; ++t) {
            float kf[DPL], vf[DPL];
            load_f32<T, DPL>(kp + base + t * pos_stride, kf);
            load_f32<T, DPL>(vp + base + t * pos_stride, vf);
            float s[GC];
#pragma unroll
            for (int g = 0; g < GC; ++g) {
                float d = 0.f;
#pragma unroll
                for (int i = 0; i < DPL; ++i)
                    d = fmaf(q_s[g * D + lane * DPL + i], kf[i], d);
                s[g] = d;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
                for (int g = 0; g < GC; ++g)
                    s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
            }
#pragma unroll
            for (int g = 0; g < GC; ++g) {
                const float sg = s[g] * scale;
                const float mn = fmaxf(m[g], sg);
                const float c = expf(m[g] - mn);  // 0 while m is -inf
                const float p = expf(sg - mn);
                l[g] = fmaf(l[g], c, p);
#pragma unroll
                for (int i = 0; i < DPL; ++i)
                    acc[g][i] = fmaf(p, vf[i], acc[g][i] * c);
                m[g] = mn;
            }
        }
    }

    if (lane == 0) {
#pragma unroll
        for (int g = 0; g < GC; ++g) {
            m_s[warp * GC + g] = m[g];
            l_s[warp * GC + g] = l[g];
        }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int i = 0; i < DPL; ++i)
            a_s[(warp * GC + g) * D + lane * DPL + i] = acc[g][i];
    }
    __syncthreads();

    for (int i = threadIdx.x; i < gn * D; i += blockDim.x) {
        const int g = i / D;
        const int d = i - g * D;
        float M = -CUDART_INF_F;
#pragma unroll
        for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, m_s[w * GC + g]);
        float o = CUDART_NAN_F;                   // nothing to attend to
        if (M != -CUDART_INF_F) {
            float L = 0.f, A = 0.f;
#pragma unroll
            for (int w = 0; w < kDecodeWarps; ++w) {
                const float c = expf(m_s[w * GC + g] - M);
                L = fmaf(l_s[w * GC + g], c, L);
                A = fmaf(a_s[(w * GC + g) * D + d], c, A);
            }
            o = A / L;
        }
        out[(head0 + g) * D + d] = from_f32<T>(o);
    }
}

template <typename T, int DPL, int GC>
cudaError_t launch_decode(const void* q, const void* kp, const void* vp,
                          const int* table, const int* lens, void* out,
                          int B, int H, int Hkv, int P, int page, int pps,
                          cudaStream_t stream) {
    auto kern = decode_paged_kernel<T, DPL, GC>;
    constexpr size_t smem = decode_smem_bytes<DPL, GC>();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const int G = H / Hkv;
    const dim3 grid(Hkv, B, (G + GC - 1) / GC);
    const float scale = 1.0f / sqrtf((float)(32 * DPL));
    kern<<<grid, kDecodeWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), table, lens, static_cast<T*>(out), H, Hkv,
        P, page, pps, scale);
    return cudaGetLastError();
}

template <typename T, int DPL>
cudaError_t decode_by_group(int G, const void* q, const void* kp,
                            const void* vp, const int* table, const int* lens,
                            void* out, int B, int H, int Hkv, int P, int page,
                            int pps, cudaStream_t stream) {
    if (G <= 8)
        return launch_decode<T, DPL, 8>(q, kp, vp, table, lens, out, B, H,
                                        Hkv, P, page, pps, stream);
    return launch_decode<T, DPL, 16>(q, kp, vp, table, lens, out, B, H, Hkv,
                                     P, page, pps, stream);
}

template <typename T>
cudaError_t decode_by_dim(int D, int G, const void* q, const void* kp,
                          const void* vp, const int* table, const int* lens,
                          void* out, int B, int H, int Hkv, int P, int page,
                          int pps, cudaStream_t stream) {
    switch (D) {
        case 32: return decode_by_group<T, 1>(G, q, kp, vp, table, lens, out,
                                              B, H, Hkv, P, page, pps, stream);
        case 64: return decode_by_group<T, 2>(G, q, kp, vp, table, lens, out,
                                              B, H, Hkv, P, page, pps, stream);
        case 128: return decode_by_group<T, 4>(G, q, kp, vp, table, lens,
                                               out, B, H, Hkv, P, page, pps,
                                               stream);
        case 256: return decode_by_group<T, 8>(G, q, kp, vp, table, lens,
                                               out, B, H, Hkv, P, page, pps,
                                               stream);
        default: return cudaErrorInvalidValue;
    }
}

// ------------------------------------------------------------------ K5
constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // key positions per tile
constexpr int kFlashThreads = 256;   // 16 x 16: 4 rows x 4 keys each

template <int D>
constexpr size_t flash_smem_bytes() {
    // q tile [kBQ][D + 1], K-then-V tile [kBK][D + 1], p [kBQ][kBK + 1]
    return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1)
                                    + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_len,
                 int Sq, int Sk, int H, int Hkv, int causal, int window,
                 float scale) {
    constexpr int NJ = D / 16;        // output columns per thread
    constexpr int LD = D + 1;         // padded rows: conflict-free columns
    constexpr int LDP = kBK + 1;
    extern __shared__ float smem[];
    float* q_s = smem;                // [kBQ][LD]
    float* kv_s = q_s + kBQ * LD;     // [kBK][LD]: K, then V, of a tile
    float* p_s = kv_s + kBK * LD;     // [kBQ][LDP]

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int hk = h / (H / Hkv);
    const int q0 = blockIdx.x * kBQ;
    const int tid = threadIdx.x;
    const int ty = tid >> 4;          // rows ty + 16 r
    const int tx = tid & 15;          // keys / columns tx + 16 c
    const long long q_pos = (long long)H * D;     // stride between positions
    const long long kv_pos = (long long)Hkv * D;
    const T* qb = q + (long long)b * Sq * q_pos + (long long)h * D;
    const T* kb = k + (long long)b * Sk * kv_pos + (long long)hk * D;
    const T* vb = v + (long long)b * Sk * kv_pos + (long long)hk * D;

    for (int i = tid; i < kBQ * D; i += kFlashThreads) {
        const int r = i / D;
        const int d = i - r * D;
        q_s[r * LD + d] =
            q0 + r < Sq ? to_f32(qb[(long long)(q0 + r) * q_pos + d]) : 0.f;
    }

    float m[4], l[4], acc[4][NJ];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = -CUDART_INF_F;
        l[r] = 0.f;
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
        __syncthreads();              // the last tile's products are done
        for (int i = tid; i < kBK * D; i += kFlashThreads) {
            const int r = i / D;
            const int d = i - r * D;
            kv_s[r * LD + d] =
                k0 + r < len ? to_f32(kb[(long long)(k0 + r) * kv_pos + d])
                             : 0.f;
        }
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
            float mx = -CUDART_INF_F;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int kj = k0 + tx + 16 * c;
                bool ok = kj < len && qi < Sq;
                if (causal) ok = ok && qi >= kj;
                if (window > 0) ok = ok && qi - kj < window;
                s[r][c] = ok ? s[r][c] * scale : -CUDART_INF_F;
                mx = fmaxf(mx, s[r][c]);
            }
            // the row's 16 threads are one half warp (same ty)
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float mn = fmaxf(m[r], mx);
            const float mu = mn == -CUDART_INF_F ? 0.f : mn;  // all masked
            const float corr = expf(m[r] - mu);
            float rs = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float p = expf(s[r][c] - mu);
                p_s[(ty + 16 * r) * LDP + tx + 16 * c] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[r] = fmaf(l[r], corr, rs);
            m[r] = mn;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[r][j] *= corr;
        }
        __syncthreads();              // K is read, p is written

        for (int i = tid; i < kBK * D; i += kFlashThreads) {
            const int r = i / D;
            const int d = i - r * D;
            kv_s[r * LD + d] =
                k0 + r < len ? to_f32(vb[(long long)(k0 + r) * kv_pos + d])
                             : 0.f;
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
            float p[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) p[r] = p_s[(ty + 16 * r) * LDP + kk];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float vv = kv_s[kk * LD + tx + 16 * j];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    acc[r][j] = fmaf(p[r], vv, acc[r][j]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int qi = q0 + ty + 16 * r;
        if (qi >= Sq) continue;
        T* orow = o + (long long)b * Sq * q_pos + (long long)qi * q_pos
                  + (long long)h * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            orow[tx + 16 * j] = from_f32<T>(acc[r][j] / l[r]);  // l = 0: NaN
        if (lse != nullptr && tx == 0)
            lse[(long long)bh * Sq + qi] = m[r] + logf(l[r]);
    }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* o, float* lse, const int* kv_len, int B,
                         int Sq, int Sk, int H, int Hkv, int causal,
                         int window, cudaStream_t stream) {
    auto kern = flash_fwd_kernel<T, D>;
    constexpr size_t smem = flash_smem_bytes<D>();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
    const float scale = 1.0f / sqrtf((float)D);
    kern<<<grid, kFlashThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, kv_len, Sq, Sk,
        H, Hkv, causal, window, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t flash_by_dim(int D, const void* q, const void* k, const void* v,
                         void* o, float* lse, const int* n, int B, int Sq,
                         int Sk, int H, int Hkv, int causal, int window,
                         cudaStream_t stream) {
    switch (D) {
        case 32: return launch_flash<T, 32>(q, k, v, o, lse, n, B, Sq, Sk, H,
                                            Hkv, causal, window, stream);
        case 64: return launch_flash<T, 64>(q, k, v, o, lse, n, B, Sq, Sk, H,
                                            Hkv, causal, window, stream);
        case 128: return launch_flash<T, 128>(q, k, v, o, lse, n, B, Sq, Sk,
                                              H, Hkv, causal, window, stream);
        case 256: return launch_flash<T, 256>(q, k, v, o, lse, n, B, Sq, Sk,
                                              H, Hkv, causal, window, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int decode_attention_paged(
        const void* q, const void* k_pages, const void* v_pages,
        const int* table, const int* lens, void* out, int B, int H, int Hkv,
        int D, int P, int page, int pps, int dtype, void* stream) {
    if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 || pps <= 0)
        return (int)cudaErrorInvalidValue;
    const int G = H / Hkv;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)decode_by_dim<float>(D, G, q, k_pages, v_pages, table,
                                         lens, out, B, H, Hkv, P, page, pps,
                                         s);
    if (dtype == 1)
        return (int)decode_by_dim<__nv_bfloat16>(D, G, q, k_pages, v_pages,
                                                 table, lens, out, B, H, Hkv,
                                                 P, page, pps, s);
    return (int)cudaErrorInvalidValue;
}

// kv_len: int32 [B] (each row's count of valid keys, clamped to [0, Sk])
// or null for Sk.
extern "C" int flash_attention_fwd(
        const void* q, const void* k, const void* v, void* o, void* lse,
        const void* kv_len, int B, int Sq, int Sk, int H, int Hkv, int D,
        int causal, int window, int dtype, void* stream) {
    if (B <= 0 || Sq <= 0 || Hkv <= 0 || H % Hkv != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    const int* n = static_cast<const int*>(kv_len);
    if (dtype == 0)
        return (int)flash_by_dim<float>(D, q, k, v, o, l, n, B, Sq, Sk, H,
                                        Hkv, causal, window, s);
    if (dtype == 1)
        return (int)flash_by_dim<__nv_bfloat16>(D, q, k, v, o, l, n, B, Sq,
                                                Sk, H, Hkv, causal, window,
                                                s);
    return (int)cudaErrorInvalidValue;
}

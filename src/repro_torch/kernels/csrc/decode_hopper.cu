// Paged decode attention for Hopper (sm_90a), split-KV: K4's design for
// bf16 q/k/v at head dims 64 and 128 with at most 16 query heads per KV
// head (the table of repro_torch/kernels/decode_attention.py; float32 and
// the other head dims keep decode_attention_paged of attention.cu).
//
//   decode_split_kv   replaces decode_attention_paged_pallas
//                     (repro/kernels/decode_attention.py, _kernel): q
//                     [B, H, D], k/v pages [P, page, Hkv, D], block table
//                     [B, pages_per_seq] int32 (-1 = not resident),
//                     seq_lens [B] int32 -> out [B, H, D], all bf16 but
//                     the table and the lengths.
//
// What bounds it: bytes. Each resident position of a sequence is read
// once per KV head, K and V: sum_b seq_len_b * Hkv * D * 2 * 2 bytes over
// the 3.35 TB/s of HBM3 (165 MB, 49 us, for 16 sequences of 5,034 tokens
// at starcoder2-7b's 4 KV heads of 128). The products are 4 * G * D flops
// per position and KV head, far below the memory line.
//
// Design (flash-decoding):
// - Split-KV. The grid is (n_split, Hkv, B): block (s, hk, b) takes the
//   run of pages_per_split pages of split s of sequence b, so a serving
//   batch of 16 x 4 KV heads fills the 132 SMs. n_split comes from the
//   table's width, never from the lengths on the host; a block whose run
//   starts at or past seq_len exits at once.
// - A shared-memory ring. Tiles of 64 positions of K and V (16 per warp)
//   are copied with cp.async, 16 bytes a thread, into a ring of 3 stages,
//   so each SM keeps two tiles of each of its blocks in flight. Rows are
//   padded by 16 bytes, so the ldmatrix reads below hit 8 distinct bank
//   groups. Positions that are masked (past seq_len, past the split, on a
//   -1 page or a page outside [0, P)) are zero-filled and scored -inf.
// - Q.K^T on mma.sync.m16n8k16 (bf16 in, fp32 accumulate): the group's G
//   query rows padded to 16 sit in registers as A fragments for the whole
//   block; bf16 products are exact in the fp32 sum. One max and one
//   rescale per warp tile of 16 positions, in the log2 domain.
// - P.V keeps fp32 accuracy: P is split into a bf16 high part and a bf16
//   low part (P - hi), and both go through the tensor cores (2 products),
//   so P carries 16 bits of mantissa and the output stays within one bf16
//   ulp of the fp32 plain version.
// - Each block merges its 4 warps' (m, l, acc) in shared memory and writes
//   one fp32 partial (m, l, acc[G][D]) per split; a second launch combines
//   the splits of each (b, head) in split order (deterministic) and writes
//   bf16 once. Splits with m = -inf add nothing; a row with no split
//   that attends anything (seq_len 0, only -1 pages) is NaN, as the
//   oracle's softmax over nothing.
//
// The entry point launches both kernels on the caller's stream, allocates
// nothing (the wrapper passes the fp32 scratch) and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;       // positions of one staged tile
constexpr int kStages = 3;
constexpr int kRows = 16;                // query rows of one mma (G padded)
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
    static constexpr int kRow = D + 8;                    // bf16, padded
    static constexpr int kTileElems = kTile * kRow;
    static constexpr int kRingBytes = kStages * 2 * kTileElems * 2;
    static constexpr int kOkOffset = kRingBytes;          // int [stages][tile]
    static constexpr int kPagesOffset = kOkOffset + kStages * kTile * 4;
    // after the loop the ring holds each warp's acc [16][D], m and l
    static_assert(kWarps * kRows * (D + 2) * 4 <= kRingBytes,
                  "merge area exceeds the ring");
    static size_t bytes(int pages_per_split) {
        return (size_t)kPagesOffset + (size_t)pages_per_split * 4;
    }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// d += a . b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// Two floats as bf16x2, x in the low half (the lower column).
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
split_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ kp,
             const __nv_bfloat16* __restrict__ vp,
             const int* __restrict__ table, const int* __restrict__ lens,
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             int H, int Hkv, int P, int page, int pps, int pages_per_split,
             float scale_log2) {
    using L = Smem<D>;
    constexpr int kChunks = D / 8;       // 16-byte chunks of a row
    constexpr int kSteps = D / 16;       // k steps of Q.K^T, n pairs of P.V
    const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int n_split = gridDim.x;
    const int G = H / Hkv;
    const int len = min(lens[b], pps * page);
    const int split_tokens = pages_per_split * page;
    const int start = split * split_tokens;
    if (start >= len) return;            // the combine reads no partial
    const int end = min(start + split_tokens, len);
    const int ntiles = (end - start + kTile - 1) / kTile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
    int* ok_s = reinterpret_cast<int*>(smem + L::kOkOffset);
    int* pg_s = reinterpret_cast<int*>(smem + L::kPagesOffset);

    const int pg0 = split * pages_per_split;
    for (int i = threadIdx.x; i < min(pages_per_split, pps - pg0);
         i += kThreads) {
        const int pg = table[(long long)b * pps + pg0 + i];
        pg_s[i] = pg >= 0 && pg < P ? pg : -1;
    }
    __syncthreads();

    const long long pos_stride = (long long)Hkv * D;
    auto load_tile = [&](int t, int st) {
        __nv_bfloat16* ks = ring + st * 2 * L::kTileElems;
        __nv_bfloat16* vs = ks + L::kTileElems;
        const int p0 = start + t * kTile;
#pragma unroll 4
        for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
            const int row = c / kChunks, ch = c % kChunks;
            const int pos = p0 + row;
            const int pg = pos < end ? pg_s[(pos - start) / page] : -1;
            const bool ok = pg >= 0;
            const long long off = ok
                ? ((long long)pg * page + pos % page) * pos_stride
                  + (long long)hk * D + ch * 8
                : 0;
            cp_async16(ks + row * L::kRow + ch * 8, kp + off, ok ? 16 : 0);
            cp_async16(vs + row * L::kRow + ch * 8, vp + off, ok ? 16 : 0);
            if (ch == 0) ok_s[st * kTile + row] = ok;
        }
    };

    // the group's query rows as A fragments, rows >= G zero
    unsigned qa[kSteps][4];
    {
        const int g_lo = lane >> 2, g_hi = g_lo + 8;
        const long long head0 = (long long)b * H + (long long)hk * G;
        const unsigned* q_lo = reinterpret_cast<const unsigned*>(
            q + (head0 + g_lo) * D);
        const unsigned* q_hi = reinterpret_cast<const unsigned*>(
            q + (head0 + g_hi) * D);
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
            const int w0 = (kk * 16 + (lane & 3) * 2) >> 1;   // word index
            qa[kk][0] = g_lo < G ? __ldg(q_lo + w0) : 0u;
            qa[kk][1] = g_hi < G ? __ldg(q_hi + w0) : 0u;
            qa[kk][2] = g_lo < G ? __ldg(q_lo + w0 + 4) : 0u;
            qa[kk][3] = g_hi < G ? __ldg(q_hi + w0 + 4) : 0u;
        }
    }

    float acc[2 * kSteps][4];
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;   // rows lane/4, +8
    float l_lo = 0.f, l_hi = 0.f;                       // this lane's part

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < ntiles) load_tile(s, s);
        cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
        if (t + kStages - 1 < ntiles)
            load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();
        const int st = t % kStages;
        const __nv_bfloat16* ks = ring + st * 2 * L::kTileElems;
        const __nv_bfloat16* vs = ks + L::kTileElems;
        const int* ok = ok_s + st * kTile + warp * 16;

        // S = Q.K^T for this warp's 16 positions: two n tiles of 8
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        {
            const int mat = lane >> 3;
            const __nv_bfloat16* kr = ks
                + (warp * 16 + (mat >> 1) * 8 + (lane & 7)) * L::kRow
                + (mat & 1) * 8;
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk) {
                unsigned kb[4];
                ldmatrix_x4(kb, kr + kk * 16);
                mma16816(sc[0], qa[kk], kb[0], kb[1]);
                mma16816(sc[1], qa[kk], kb[2], kb[3]);
            }
        }
        // mask, one max and one rescale per row for the 16 positions
        float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int pos = n * 8 + (lane & 3) * 2 + (i & 1);
                sc[n][i] = ok[pos] ? sc[n][i] * scale_log2 : -CUDART_INF_F;
            }
            mx_lo = fmaxf(mx_lo, fmaxf(sc[n][0], sc[n][1]));
            mx_hi = fmaxf(mx_hi, fmaxf(sc[n][2], sc[n][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        // a row with nothing so far keeps -inf; exponents stay finite
        const float u_lo = mn_lo == -CUDART_INF_F ? 0.f : mn_lo;
        const float u_hi = mn_hi == -CUDART_INF_F ? 0.f : mn_hi;
        const float c_lo = exp2f(m_lo - u_lo), c_hi = exp2f(m_hi - u_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float p[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            p[n][0] = exp2f(sc[n][0] - u_lo);
            p[n][1] = exp2f(sc[n][1] - u_lo);
            p[n][2] = exp2f(sc[n][2] - u_hi);
            p[n][3] = exp2f(sc[n][3] - u_hi);
        }
        l_lo = fmaf(l_lo, c_lo, p[0][0] + p[0][1] + p[1][0] + p[1][1]);
        l_hi = fmaf(l_hi, c_hi, p[0][2] + p[0][3] + p[1][2] + p[1][3]);
#pragma unroll
        for (int n = 0; n < 2 * kSteps; ++n) {
            acc[n][0] *= c_lo;
            acc[n][1] *= c_lo;
            acc[n][2] *= c_hi;
            acc[n][3] *= c_hi;
        }
        // P as A fragments (16 rows x 16 positions), high and low parts
        unsigned ph[4], pl[4];
        ph[0] = pack_bf16(p[0][0], p[0][1]);
        ph[1] = pack_bf16(p[0][2], p[0][3]);
        ph[2] = pack_bf16(p[1][0], p[1][1]);
        ph[3] = pack_bf16(p[1][2], p[1][3]);
        pl[0] = pack_bf16(p[0][0] - bf16_round(p[0][0]),
                          p[0][1] - bf16_round(p[0][1]));
        pl[1] = pack_bf16(p[0][2] - bf16_round(p[0][2]),
                          p[0][3] - bf16_round(p[0][3]));
        pl[2] = pack_bf16(p[1][0] - bf16_round(p[1][0]),
                          p[1][1] - bf16_round(p[1][1]));
        pl[3] = pack_bf16(p[1][2] - bf16_round(p[1][2]),
                          p[1][3] - bf16_round(p[1][3]));
        {
            const int mat = lane >> 3;
            const __nv_bfloat16* vr = vs
                + (warp * 16 + (mat & 1) * 8 + (lane & 7)) * L::kRow
                + (mat >> 1) * 8;
#pragma unroll
            for (int dn = 0; dn < kSteps; ++dn) {
                unsigned vb[4];
                ldmatrix_x4_trans(vb, vr + dn * 16);
                mma16816(acc[2 * dn], ph, vb[0], vb[1]);
                mma16816(acc[2 * dn], pl, vb[0], vb[1]);
                mma16816(acc[2 * dn + 1], ph, vb[2], vb[3]);
                mma16816(acc[2 * dn + 1], pl, vb[2], vb[3]);
            }
        }
        __syncthreads();                 // the stage is loaded again next
    }
    cp_async_wait<0>();
    __syncthreads();

    // merge the warps: acc [warps][16][D], then m and l [warps][16]
    float* red = reinterpret_cast<float*>(smem);
    float* red_m = red + kWarps * kRows * D;
    float* red_l = red_m + kWarps * kRows;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const int r_lo = warp * kRows + (lane >> 2), r_hi = r_lo + 8;
    if ((lane & 3) == 0) {
        red_m[r_lo] = m_lo;
        red_m[r_hi] = m_hi;
        red_l[r_lo] = l_lo;
        red_l[r_hi] = l_hi;
    }
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n) {
        const int col = n * 8 + (lane & 3) * 2;
        red[r_lo * D + col] = acc[n][0];
        red[r_lo * D + col + 1] = acc[n][1];
        red[r_hi * D + col] = acc[n][2];
        red[r_hi * D + col + 1] = acc[n][3];
    }
    __syncthreads();
    const long long part0 =
        (((long long)b * Hkv + hk) * n_split + split) * G;
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
        const int g = i / D, d = i - g * D;
        float M = -CUDART_INF_F;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * kRows + g]);
        float A = 0.f, Lsum = 0.f;
        if (M != -CUDART_INF_F) {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                const float c = exp2f(red_m[w * kRows + g] - M);
                A = fmaf(red[(w * kRows + g) * D + d], c, A);
                Lsum = fmaf(red_l[w * kRows + g], c, Lsum);
            }
        }
        part_acc[(part0 + g) * D + d] = A;
        if (d == 0) {
            part_ml[(part0 + g) * 2] = M;
            part_ml[(part0 + g) * 2 + 1] = Lsum;
        }
    }
}

// One block per (head, batch row), one thread per channel: the splits of
// the row, in split order.
template <int D>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml,
               const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
               int H, int Hkv, int pps, int page, int pages_per_split,
               int n_split) {
    const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
    const int G = H / Hkv;
    const int hk = h / G, g = h - hk * G;
    const int len = min(lens[b], pps * page);
    const int split_tokens = pages_per_split * page;
    const int used = len > 0 ? (len + split_tokens - 1) / split_tokens : 0;
    const long long part0 = ((long long)b * Hkv + hk) * n_split * G + g;
    float M = -CUDART_INF_F;
    for (int s = 0; s < used; ++s)
        M = fmaxf(M, part_ml[(part0 + (long long)s * G) * 2]);
    float o = CUDART_NAN_F;              // nothing to attend to
    if (M != -CUDART_INF_F) {
        float A = 0.f, Lsum = 0.f;
        for (int s = 0; s < used; ++s) {
            const long long i = part0 + (long long)s * G;
            const float m = part_ml[i * 2];
            if (m == -CUDART_INF_F) continue;
            const float c = exp2f(m - M);
            Lsum = fmaf(part_ml[i * 2 + 1], c, Lsum);
            A = fmaf(part_acc[i * D + d], c, A);
        }
        o = A / Lsum;
    }
    out[((long long)b * H + h) * D + d] = __float2bfloat16(o);
}

template <int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lens, float* scratch,
                   void* out, int B, int H, int Hkv, int P, int page,
                   int pps, int pages_per_split, int n_split,
                   cudaStream_t stream) {
    auto split = split_kernel<D>;
    const size_t smem = Smem<D>::bytes(pages_per_split);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const int G = H / Hkv;
    float* part_acc = scratch;
    float* part_ml = scratch + (size_t)B * Hkv * n_split * G * D;
    const float scale_log2 = kLog2e / sqrtf((float)D);
    split<<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), table, lens, part_acc,
        part_ml, H, Hkv, P, page, pps, pages_per_split, scale_log2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    combine_kernel<D><<<dim3(H, B), D, 0, stream>>>(
        part_acc, part_ml, lens, static_cast<__nv_bfloat16*>(out), H, Hkv,
        pps, page, pages_per_split, n_split);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch: float32 [B * Hkv * n_split * G * (D + 2)]: acc, then (m, l).
int decode_split_kv(const void* q, const void* kp, const void* vp,
                    const int* table, const int* lens, float* scratch,
                    void* out, int B, int H, int Hkv, int D, int P,
                    int page, int pps, int pages_per_split, int n_split,
                    void* stream) {
    if (Hkv <= 0 || H % Hkv || H / Hkv > kRows || pages_per_split <= 0
        || (long long)n_split * pages_per_split < pps || B > 65535
        || Hkv > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (D) {
        case 64:
            return (int)launch<64>(q, kp, vp, table, lens, scratch, out, B,
                                   H, Hkv, P, page, pps, pages_per_split,
                                   n_split, s);
        case 128:
            return (int)launch<128>(q, kp, vp, table, lens, scratch, out, B,
                                    H, Hkv, P, page, pps, pages_per_split,
                                    n_split, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"

// Mamba-2 SSD chunk scan for Hopper (sm_90a) on the tensor cores: K7's
// design for bf16 xdt / B / C at head dim 64 and state 16 or 128 (the
// table of repro_torch/kernels/ssd_scan.py, ssd_design; float32 and the
// other shapes keep ssd_scan of ssd_scan.cu).
//
//   ssd_tensor  replaces ssd_scan_pallas (repro/kernels/ssd_scan.py,
//               _kernel): the state-space-duality scan, forward, with the
//               carried state passed in and out. Layouts as ssd_scan.cu:
//               xdt [b, s, h, 64] bf16, a [b, s, h] float32 (<= 0), B and
//               C [b, s, n] bf16, init_state [b, h, 64, n] float32 or
//               null; y [b, s, h, 64] bf16 and final_state [b, h, 64, n]
//               float32.
//
// What it computes is the function of ssd_scan.cu, in the order of the
// SSD algorithm of the Mamba-2 paper (arXiv:2405.21060, section 6), in
// which only an elementwise recurrence over chunks stays sequential. With
// Q tokens a chunk, cum the running sum of a inside a chunk and w_j =
// exp(cum_last - cum_j):
//   1. chunk pass   (grid: chunk, group of 4 heads, batch row)
//        S_c = sum_j (w_j xdt_j) (x) B_j      [64, n] per head, fp32
//        written to the workspace, and total_c = cum_last beside it;
//   2. state pass   (grid: slice of 64 n, head, batch row)
//        H_c = exp(total_c) H_{c-1} + S_c, in chunk order from init_state
//        (or zero); the state entering chunk c overwrites S_c, the last
//        one goes to final_state. The only sequential part: nc dependent
//        FMAs per element;
//   3. output pass  (grid: chunk, group of heads, batch row)
//        y_i = exp(cum_i) C_i . H_c + sum_{j <= i} (C_i . B_j)
//              exp(cum_i - cum_j) xdt_j,
//        rounded to bf16 once on the store.
//
// Every product runs on mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
// mma.sync rather than wgmma: the per-chunk products are small (16-row
// tiles of a [Q, Q] triangle, K of 16 to 128), each warp owns its own
// rows, and the fragments of one product feed the next in registers.
// - C . B^T on bf16 inputs is exact in the fp32 accumulator.
// - A float32 operand (w xdt in pass 1, the state in C . H, the decayed
//   scores in pass 3) is split into bf16 parts, hi = bf16(x), then the
//   rest of x - hi, and each part goes through the tensor cores: kParts
//   = 3 products. Three parts carry the 24 bits of fp32's mantissa, two
//   only 16: y must stay within one bf16 ulp of the fp32 plain version
//   where it cancels to near zero, and with two parts it does not (on an
//   H100 80GB HBM3 at 700 W, 1.25 ulps on mamba2-780m's 4 x 32,768-token
//   launch).
// - Decays are computed only where j <= i and clamped at 0 before the
//   exponent (a select, never exp of a positive number). The running sums
//   cum are taken left to right in fp32, one thread a head, as
//   torch.cumsum takes them in the plain version: a scan in another order
//   rounds cum (tens to hundreds over a chunk) differently, and that moves
//   the decays by 1e-5, more than one bf16 ulp of a y that cancels.
//
// Pass 3 computes the score tile C . B^T once per block: each warp owns 16
// rows i of the chunk and keeps its lower-triangle 16 x 16 tiles (in
// fragment order, conflict-free) in shared memory while the block walks
// its heads; the scores of a tile are also the A fragment of the product
// with xdt, so only the decay and the split touch them. The state
// entering the chunk is split into its bf16 parts once per head, while
// it is staged, into one shared-memory plane per part, from which every
// warp loads its B fragments with ldmatrix: split in each warp, the
// state's parts cost more instructions than the products (on an H100
// 80GB HBM3 at 700 W a design that did so read 5.86 ms on mamba2-780m's
// 4 x 32,768-token launch, and 5.50 with a third fewer products: the
// instruction stream, not the tensor cores, bound it).
//
// What bounds it: bytes. The workspace [b, nc, h, 64, n] fp32
// (b s h 64 n 4 / Q bytes) is written by pass 1, read and written by
// pass 2 and read by pass 3: at Q 128 and n 128 as many bytes as xdt and
// y together each time, so the passes move about five times the bytes
// the function needs.
//
// Shared memory (bytes), pass 1: Q (n + 8) 2 + Q 264 2 + 16 (Q + 3);
// pass 3: T (T + 1) / 2 1024 (T = Q / 16) + max(Q (n + 8) 2, Q 72 2 +
// 3 64 (n + 8) 2) + 32 (Q + 2). At Q 128 and n 128: 102 KB and 109 KB
// (two pass-3 blocks an SM). Chunks of 64 and 128 are built (Q 256 would
// take 231 KB in pass 3, past a block's 227 KB).
//
// The entry point launches the three kernels on the caller's stream,
// allocates nothing (the wrapper passes the workspace) and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;             // head dim the design takes
constexpr int kGroup = 4;          // heads of a pass-1 block
constexpr int kMaxHeads = 8;       // heads of a pass-3 block, at most
constexpr int kParts = 3;          // bf16 parts of a float32 operand
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled where ok is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// d += a . b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// The next bf16 part of the pair (x, y), packed with x in the low half
// (the lower column); x and y keep what is left (exact in fp32).
__device__ __forceinline__ unsigned take_part(float& x, float& y) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(v);
    x -= f.x;
    y -= f.y;
    return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack(unsigned u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// exp(d) for d <= 0; a positive d (a rounding of a sum of a <= 0) counts
// as 0
__device__ __forceinline__ float decay(float d) {
    return exp2f(fminf(d, 0.f) * kLog2e);
}

// v[0..q) <- its inclusive running sum, left to right in fp32 by one
// thread: the order of torch.cumsum along a non-innermost dimension (one
// thread a column), which the plain version takes, so that both see the
// same decays; a block's heads run it in parallel, one thread each. The
// loads are independent of the sums, so unrolled they are all in flight.
__device__ __forceinline__ void running_sum(float* v, int q) {
    float run = 0.f;
#pragma unroll 16
    for (int j = 0; j < q; ++j) {
        run = __fadd_rn(run, v[j]);
        v[j] = run;
    }
}

// --------------------------------------------------------------- pass 1
template <int Q, int N>
struct ChunkPass {
    static constexpr int kThreads = 32 * 4 * kGroup;   // 4 warps a head
    static constexpr int kBRow = N + 8;                // bf16
    static constexpr int kXRow = kGroup * kP + 8;      // bf16
    static constexpr size_t kBBytes = (size_t)Q * kBRow * 2;
    static constexpr size_t kXBytes = (size_t)Q * kXRow * 2;
    static constexpr int kWRow = Q + 2;                // fp32, even
    static constexpr size_t kBytes = kBBytes + kXBytes
        + (size_t)kGroup * (kWRow + 1) * 4;
};

// Block (chunk c, heads h0 .. h0 + 3, batch row b); warp w takes head
// w / 4 and rows 16 (w % 4) .. + 15 of p: S[p, n] = (w xdt)^T [p, Q] .
// B [Q, n], the first operand split into parts.
template <int Q, int N>
__global__ void __launch_bounds__(ChunkPass<Q, N>::kThreads, 1)
chunk_state_kernel(const __nv_bfloat16* __restrict__ xdt,
                   const float* __restrict__ a,
                   const __nv_bfloat16* __restrict__ Bm,
                   float* __restrict__ ws, float* __restrict__ totals,
                   int S, int H, int nc) {
    using L = ChunkPass<Q, N>;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L::kBBytes);
    float* Ws = reinterpret_cast<float*>(smem + L::kBBytes + L::kXBytes);
    const int c = blockIdx.x, h0 = blockIdx.y * kGroup, b = blockIdx.z;
    const int t0 = c * Q;
    const int nh = min(kGroup, H - h0);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    constexpr int kBChunks = N / 8;
    for (int i = tid; i < Q * kBChunks; i += L::kThreads) {
        const int r = i / kBChunks, ch = i - r * kBChunks;
        const bool ok = t0 + r < S;
        cp_async16(Bs + r * L::kBRow + ch * 8,
                   Bm + (ok ? ((long long)b * S + t0 + r) * N + ch * 8 : 0),
                   ok);
    }
    constexpr int kXChunks = kGroup * kP / 8;
    for (int i = tid; i < Q * kXChunks; i += L::kThreads) {
        const int r = i / kXChunks, ch = i - r * kXChunks;
        const bool ok = t0 + r < S && ch < nh * (kP / 8);
        cp_async16(Xs + r * L::kXRow + ch * 8,
                   xdt + (ok ? (((long long)b * S + t0 + r) * H + h0) * kP
                                   + ch * 8 : 0), ok);
    }
    float* tot = Ws + kGroup * L::kWRow;
    for (int i = tid; i < Q * kGroup; i += L::kThreads) {
        const int r = i / kGroup, hh = i - r * kGroup;
        Ws[hh * L::kWRow + r] = t0 + r < S && hh < nh
            ? a[((long long)b * S + t0 + r) * H + h0 + hh] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (tid < kGroup) {
        running_sum(Ws + tid * L::kWRow, Q);
        tot[tid] = Ws[tid * L::kWRow + Q - 1];
        if (tid < nh)
            totals[((long long)b * nc + c) * H + h0 + tid] = tot[tid];
    }
    __syncthreads();
    // w_j = exp(cum_last - cum_j) in the place of cum
    for (int i = tid; i < Q * kGroup; i += L::kThreads) {
        const int hh = i / Q, j = i - hh * Q;
        float* v = Ws + hh * L::kWRow + j;
        *v = decay(tot[hh] - *v);
    }
    __syncthreads();
    const int hh = warp >> 2, pt = warp & 3;
    if (hh >= nh) return;

    const int mi = lane >> 3, r8 = lane & 7;
    const int g = lane >> 2, tq = lane & 3;
    const float* w = Ws + hh * L::kWRow;
    float acc[N / 8][4];
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < Q / 16; ++ks) {
        // A = (w xdt)^T: rows p, columns the chunk's tokens
        unsigned xa[4];
        ldmatrix_x4_trans(xa, Xs + (16 * ks + r8 + 8 * (mi >> 1)) * L::kXRow
                              + hh * kP + 16 * pt + 8 * (mi & 1));
        const float2 w0 = *reinterpret_cast<const float2*>(
            w + 16 * ks + 2 * tq);
        const float2 w8 = *reinterpret_cast<const float2*>(
            w + 16 * ks + 2 * tq + 8);
        float v[8];
        {
            const float2 x0 = unpack(xa[0]), x1 = unpack(xa[1]);
            const float2 x2 = unpack(xa[2]), x3 = unpack(xa[3]);
            v[0] = x0.x * w0.x; v[1] = x0.y * w0.y;
            v[2] = x1.x * w0.x; v[3] = x1.y * w0.y;
            v[4] = x2.x * w8.x; v[5] = x2.y * w8.y;
            v[6] = x3.x * w8.x; v[7] = x3.y * w8.y;
        }
        unsigned af[kParts][4];
#pragma unroll
        for (int part = 0; part < kParts; ++part)
#pragma unroll
            for (int k = 0; k < 4; ++k)
                af[part][k] = take_part(v[2 * k], v[2 * k + 1]);
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
            unsigned bb[4];
            ldmatrix_x4_trans(bb, Bs + (16 * ks + r8 + 8 * (mi & 1))
                                  * L::kBRow + 16 * np + 8 * (mi >> 1));
#pragma unroll
            for (int part = 0; part < kParts; ++part) {
                mma16816(acc[2 * np], af[part], bb[0], bb[1]);
                mma16816(acc[2 * np + 1], af[part], bb[2], bb[3]);
            }
        }
    }
    float* dst = ws + (((long long)b * nc + c) * H + h0 + hh) * kP * N;
    const int p0 = 16 * pt + g;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
        *reinterpret_cast<float2*>(dst + p0 * N + 8 * nt + 2 * tq) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(dst + (p0 + 8) * N + 8 * nt + 2 * tq) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
}

// --------------------------------------------------------------- pass 2
constexpr int kStateThreads = 256;
constexpr int kStateBatch = 4;       // chunks whose loads are in flight

// Block (slice of 1,024 state elements, head, batch row); a thread walks
// 4 consecutive elements through the chunks.
__global__ void __launch_bounds__(kStateThreads)
state_pass_kernel(float* ws, const float* __restrict__ totals,
                  const float* __restrict__ init_state,
                  float* __restrict__ final_state, int H, int nc, int pn) {
    const int e = (blockIdx.x * kStateThreads + threadIdx.x) * 4;
    const int h = blockIdx.y, b = blockIdx.z;
    if (e >= pn) return;
    const long long head = (long long)b * H + h;
    float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
    if (init_state != nullptr)
        st = *reinterpret_cast<const float4*>(init_state + head * pn + e);
    float* base = ws + ((long long)b * nc * H + h) * pn + e;
    const long long step = (long long)H * pn;
    const float* tot = totals + (long long)b * nc * H + h;
    for (int c0 = 0; c0 < nc; c0 += kStateBatch) {
        float4 s[kStateBatch];
        float d[kStateBatch];
#pragma unroll
        for (int k = 0; k < kStateBatch; ++k) {
            if (c0 + k < nc) {
                s[k] = __ldcg(reinterpret_cast<const float4*>(
                    base + (c0 + k) * step));
                d[k] = expf(tot[(long long)(c0 + k) * H]);
            }
        }
#pragma unroll
        for (int k = 0; k < kStateBatch; ++k) {
            if (c0 + k < nc) {
                __stcg(reinterpret_cast<float4*>(base + (c0 + k) * step), st);
                // rounded after the product and after the sum, as the
                // plain version's two elementwise ops
                st.x = __fadd_rn(__fmul_rn(d[k], st.x), s[k].x);
                st.y = __fadd_rn(__fmul_rn(d[k], st.y), s[k].y);
                st.z = __fadd_rn(__fmul_rn(d[k], st.z), s[k].z);
                st.w = __fadd_rn(__fmul_rn(d[k], st.w), s[k].w);
            }
        }
    }
    *reinterpret_cast<float4*>(final_state + head * pn + e) = st;
}

// --------------------------------------------------------------- pass 3
template <int Q, int N>
struct OutPass {
    static constexpr int kTiles = Q / 16;              // row tiles = warps
    static constexpr int kThreads = 32 * kTiles;
    static constexpr int kBRow = N + 8;                // bf16
    static constexpr int kXRow = kP + 8;               // bf16
    static constexpr int kHRow = N + 8;                // bf16
    static constexpr size_t kScoreBytes =
        (size_t)kTiles * (kTiles + 1) / 2 * 256 * 4;
    static constexpr size_t kXBytes = (size_t)Q * kXRow * 2;
    static constexpr size_t kPlaneBytes = (size_t)kP * kHRow * 2;
    static constexpr size_t kHBytes = kParts * kPlaneBytes;
    static constexpr size_t kBBytes = (size_t)Q * kBRow * 2;
    static constexpr size_t kStageBytes =
        kBBytes > kXBytes + kHBytes ? kBBytes : kXBytes + kHBytes;
    static constexpr int kCumRow = Q + 2;              // fp32, even
    static constexpr size_t kBytes = kScoreBytes + kStageBytes
        + (size_t)kMaxHeads * kCumRow * 4;
};

// Block (chunk c, heads h0 .. h0 + nh - 1, batch row b); warp it owns rows
// 16 it .. 16 it + 15 of the chunk.
template <int Q, int N>
__global__ void __launch_bounds__(OutPass<Q, N>::kThreads,
                                  512 / OutPass<Q, N>::kThreads)
output_kernel(const __nv_bfloat16* __restrict__ xdt,
              const float* __restrict__ a,
              const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm,
              const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
              int S, int H, int nc, int heads) {
    using L = OutPass<Q, N>;
    extern __shared__ __align__(16) unsigned char smem[];
    float* scores = reinterpret_cast<float*>(smem);
    unsigned char* stage = smem + L::kScoreBytes;
    __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(stage);
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(stage);
    // the state entering the chunk as bf16 parts, plane k the k-th part
    __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(stage + L::kXBytes);
    float* cum = reinterpret_cast<float*>(stage + L::kStageBytes);
    const int c = blockIdx.x, h0 = blockIdx.y * heads, b = blockIdx.z;
    const int t0 = c * Q;
    const int nh = min(heads, H - h0);
    const int tid = threadIdx.x, it = tid >> 5, lane = tid & 31;
    const int mi = lane >> 3, r8 = lane & 7;
    const int g = lane >> 2, tq = lane & 3;

    constexpr int kBChunks = N / 8;
    for (int i = tid; i < Q * kBChunks; i += L::kThreads) {
        const int r = i / kBChunks, ch = i - r * kBChunks;
        const bool ok = t0 + r < S;
        cp_async16(Bs + r * L::kBRow + ch * 8,
                   Bm + (ok ? ((long long)b * S + t0 + r) * N + ch * 8 : 0),
                   ok);
    }
    for (int i = tid; i < Q * nh; i += L::kThreads) {
        const int r = i / nh, hh = i - r * nh;
        cum[hh * L::kCumRow + r] = t0 + r < S
            ? a[((long long)b * S + t0 + r) * H + h0 + hh] : 0.f;
    }
    // this warp's rows of C as A fragments (rows i0, i1 = i0 + 8), kept
    // for every head
    const int i0 = 16 * it + g, i1 = i0 + 8;
    unsigned cf[N / 16][4];
    {
        const bool ok0 = t0 + i0 < S, ok1 = t0 + i1 < S;
        const unsigned* c0 = reinterpret_cast<const unsigned*>(
            Cm + ((long long)b * S + (ok0 ? t0 + i0 : 0)) * N);
        const unsigned* c1 = reinterpret_cast<const unsigned*>(
            Cm + ((long long)b * S + (ok1 ? t0 + i1 : 0)) * N);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
            const int w = 8 * kk + tq;          // word of column 16 kk + 2 tq
            cf[kk][0] = ok0 ? __ldg(c0 + w) : 0u;
            cf[kk][1] = ok1 ? __ldg(c1 + w) : 0u;
            cf[kk][2] = ok0 ? __ldg(c0 + w + 4) : 0u;
            cf[kk][3] = ok1 ? __ldg(c1 + w + 4) : 0u;
        }
    }
    cp_async_wait_all();
    __syncthreads();
    // the heads' running sums (threads of warp 0) beside the score tiles
    if (tid < nh) running_sum(cum + tid * L::kCumRow, Q);
    // the score tiles (it, jt <= it), in fragment order: the first 16 x 8
    // half's four values of each lane, then the second's
    float* my_tiles = scores + (size_t)it * (it + 1) / 2 * 256;
    for (int jt = 0; jt <= it; ++jt) {
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
            unsigned bb[4];
            ldmatrix_x4(bb, Bs + (16 * jt + r8 + 8 * (mi >> 1)) * L::kBRow
                            + 16 * kk + 8 * (mi & 1));
            mma16816(s0, cf[kk], bb[0], bb[1]);
            mma16816(s1, cf[kk], bb[2], bb[3]);
        }
        float4* tile = reinterpret_cast<float4*>(my_tiles + jt * 256);
        tile[lane] = make_float4(s0[0], s0[1], s0[2], s0[3]);
        tile[32 + lane] = make_float4(s1[0], s1[1], s1[2], s1[3]);
    }
    __syncthreads();              // B's tile is done with; cum is written

#pragma unroll 1
    for (int hh = 0; hh < nh; ++hh) {
        const int h = h0 + hh;
        for (int i = tid; i < Q * (kP / 8); i += L::kThreads) {
            const int r = i >> 3, ch = i & 7;
            const bool ok = t0 + r < S;
            cp_async16(Xs + r * L::kXRow + ch * 8,
                       xdt + (ok ? (((long long)b * S + t0 + r) * H + h) * kP
                                       + ch * 8 : 0), ok);
        }
        // the state, split once here into its bf16 parts for every warp
        const float4* src = reinterpret_cast<const float4*>(
            ws + (((long long)b * nc + c) * H + h) * kP * N);
#pragma unroll 4
        for (int i = tid; i < kP * N / 4; i += L::kThreads) {
            const int pr = i / (N / 4), q4 = i - pr * (N / 4);
            const float4 v = __ldcg(src + i);
            float r0 = v.x, r1 = v.y, r2 = v.z, r3 = v.w;
            __nv_bfloat16* dst = Hs + pr * L::kHRow + 4 * q4;
#pragma unroll
            for (int part = 0; part < kParts; ++part) {
                const unsigned lo = take_part(r0, r1);
                const unsigned hi = take_part(r2, r3);
                *reinterpret_cast<uint2*>(dst + part * (L::kPlaneBytes / 2))
                    = make_uint2(lo, hi);
            }
        }
        cp_async_wait_all();
        __syncthreads();

        const float* cm = cum + hh * L::kCumRow;
        const float ci0 = cm[i0], ci1 = cm[i1];
        float acc[kP / 8][4];
#pragma unroll
        for (int pn = 0; pn < kP / 8; ++pn)
            acc[pn][0] = acc[pn][1] = acc[pn][2] = acc[pn][3] = 0.f;
        // inter-chunk term: C . H^T, a product for each part of the state
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
            for (int part = 0; part < kParts; ++part) {
                const __nv_bfloat16* plane =
                    Hs + part * (L::kPlaneBytes / 2);
#pragma unroll
                for (int pp = 0; pp < kP / 16; ++pp) {
                    unsigned hb[4];
                    ldmatrix_x4(hb, plane + (16 * pp + r8 + 8 * (mi >> 1))
                                    * L::kHRow + 16 * kk + 8 * (mi & 1));
                    mma16816(acc[2 * pp], cf[kk], hb[0], hb[1]);
                    mma16816(acc[2 * pp + 1], cf[kk], hb[2], hb[3]);
                }
            }
        }
        const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
        for (int pn = 0; pn < kP / 8; ++pn) {
            acc[pn][0] *= e0; acc[pn][1] *= e0;
            acc[pn][2] *= e1; acc[pn][3] *= e1;
        }
        // intra-chunk term: (scores o decay) . xdt over the tiles j <= i
        for (int jt = 0; jt <= it; ++jt) {
            const float4* tile =
                reinterpret_cast<const float4*>(my_tiles + jt * 256);
            const float4 sa = tile[lane], sb = tile[32 + lane];
            const float2 cj0 = *reinterpret_cast<const float2*>(
                cm + 16 * jt + 2 * tq);
            const float2 cj8 = *reinterpret_cast<const float2*>(
                cm + 16 * jt + 2 * tq + 8);
            // element k: row i0 (k = 0, 1, 4, 5) or i1, column 2 tq
            // (+ 1, + 8, + 9) of tile jt
            float v[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
            const float ci[8] = {ci0, ci0, ci1, ci1, ci0, ci0, ci1, ci1};
            const float cj[8] = {cj0.x, cj0.y, cj0.x, cj0.y,
                                 cj8.x, cj8.y, cj8.x, cj8.y};
            const int jl[8] = {2 * tq, 2 * tq + 1, 2 * tq, 2 * tq + 1,
                               2 * tq + 8, 2 * tq + 9, 2 * tq + 8,
                               2 * tq + 9};
            const int il[8] = {g, g, g + 8, g + 8, g, g, g + 8, g + 8};
#pragma unroll
            for (int k = 0; k < 8; ++k)
                v[k] = jt < it || jl[k] <= il[k]
                    ? v[k] * decay(ci[k] - cj[k]) : 0.f;
            unsigned xb[kP / 16][4];
#pragma unroll
            for (int pp = 0; pp < kP / 16; ++pp)
                ldmatrix_x4_trans(xb[pp], Xs + (16 * jt + r8 + 8 * (mi & 1))
                                          * L::kXRow + 16 * pp
                                          + 8 * (mi >> 1));
#pragma unroll
            for (int part = 0; part < kParts; ++part) {
                unsigned af[4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    af[k] = take_part(v[2 * k], v[2 * k + 1]);
#pragma unroll
                for (int pp = 0; pp < kP / 16; ++pp) {
                    mma16816(acc[2 * pp], af, xb[pp][0], xb[pp][1]);
                    mma16816(acc[2 * pp + 1], af, xb[pp][2], xb[pp][3]);
                }
            }
        }
        __nv_bfloat16* y0 = y + (((long long)b * S + t0 + i0) * H + h) * kP;
        __nv_bfloat16* y1 = y + (((long long)b * S + t0 + i1) * H + h) * kP;
#pragma unroll
        for (int pn = 0; pn < kP / 8; ++pn) {
            if (t0 + i0 < S)
                *reinterpret_cast<__nv_bfloat162*>(y0 + 8 * pn + 2 * tq) =
                    __floats2bfloat162_rn(acc[pn][0], acc[pn][1]);
            if (t0 + i1 < S)
                *reinterpret_cast<__nv_bfloat162*>(y1 + 8 * pn + 2 * tq) =
                    __floats2bfloat162_rn(acc[pn][2], acc[pn][3]);
        }
        __syncthreads();          // X and H are restaged for the next head
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int Q, int N>
cudaError_t launch(const __nv_bfloat16* xdt, const float* a,
                   const __nv_bfloat16* B, const __nv_bfloat16* C,
                   const float* init_state, __nv_bfloat16* y,
                   float* final_state, float* ws, int b, int s, int h,
                   int heads, cudaStream_t st) {
    const int nc = (s + Q - 1) / Q;
    const int pn = kP * N;
    float* totals = ws + (long long)b * nc * h * pn;
    using P1 = ChunkPass<Q, N>;
    using P3 = OutPass<Q, N>;
    cudaError_t e = allow_smem(chunk_state_kernel<Q, N>, P1::kBytes);
    if (e != cudaSuccess) return e;
    e = allow_smem(output_kernel<Q, N>, P3::kBytes);
    if (e != cudaSuccess) return e;
    chunk_state_kernel<Q, N><<<dim3(nc, (h + kGroup - 1) / kGroup, b),
                               P1::kThreads, P1::kBytes, st>>>(
        xdt, a, B, ws, totals, s, h, nc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    state_pass_kernel<<<dim3((pn / 4 + kStateThreads - 1) / kStateThreads,
                             h, b), kStateThreads, 0, st>>>(
        ws, totals, init_state, final_state, h, nc, pn);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    output_kernel<Q, N><<<dim3(nc, (h + heads - 1) / heads, b),
                          P3::kThreads, P3::kBytes, st>>>(
        xdt, a, B, C, ws, y, s, h, nc, heads);
    return cudaGetLastError();
}

template <int Q>
cudaError_t launch_q(int n, const __nv_bfloat16* xdt, const float* a,
                     const __nv_bfloat16* B, const __nv_bfloat16* C,
                     const float* init_state, __nv_bfloat16* y,
                     float* final_state, float* ws, int b, int s, int h,
                     int heads, cudaStream_t st) {
    if (n == 16)
        return launch<Q, 16>(xdt, a, B, C, init_state, y, final_state, ws,
                             b, s, h, heads, st);
    if (n == 128)
        return launch<Q, 128>(xdt, a, B, C, init_state, y, final_state, ws,
                              b, s, h, heads, st);
    return cudaErrorInvalidValue;
}

}  // namespace

// ws: float32, [b, nc, h, 64, n] states then [b, nc, h] chunk totals
// (nc = ceil(s / q)). q: the chunk, 64 or 128; heads: a pass-3
// block's heads, 1..8.
extern "C" int ssd_tensor(const void* xdt, const void* a, const void* B,
                          const void* C, const void* init_state, void* y,
                          void* final_state, void* ws, int b, int s, int h,
                          int p, int n, int q, int heads, void* stream) {
    if (b <= 0 || s <= 0 || h <= 0 || p != kP || b > 65535 || h > 65535
            || heads < 1 || heads > kMaxHeads)
        return (int)cudaErrorInvalidValue;
    auto* x = static_cast<const __nv_bfloat16*>(xdt);
    auto* af = static_cast<const float*>(a);
    auto* Bp = static_cast<const __nv_bfloat16*>(B);
    auto* Cp = static_cast<const __nv_bfloat16*>(C);
    auto* h0 = static_cast<const float*>(init_state);
    auto* yp = static_cast<__nv_bfloat16*>(y);
    auto* hf = static_cast<float*>(final_state);
    auto* w = static_cast<float*>(ws);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (q == 64)
        return (int)launch_q<64>(n, x, af, Bp, Cp, h0, yp, hf, w, b, s, h,
                                 heads, st);
    if (q == 128)
        return (int)launch_q<128>(n, x, af, Bp, Cp, h0, yp, hf, w, b, s, h,
                                  heads, st);
    return (int)cudaErrorInvalidValue;
}

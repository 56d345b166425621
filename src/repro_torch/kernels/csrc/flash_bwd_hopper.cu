// Flash attention backward on Hopper's tensor cores (sm_90a): K6 for bf16
// inputs at head dims 64 and 128.
//
//   flash_bwd_wgmma  replaces flash_attention_bwd_pallas
//                    (repro/kernels/flash_attention_bwd.py, _dq_kernel and
//                    _dkv_kernel) for those inputs; the PR 13 CUDA-core
//                    kernel (flash_attention_bwd.cu) keeps float32 and bf16
//                    at D 32 and 256. q, o, dO, dq [B, Sq, H, D]; k, v, dk,
//                    dv [B, Sk, Hkv, D]; lse [B*H, Sq] float32 in
//                    (b, hkv, g) order, as K5 writes it. GQA native.
//
// What it computes is the Pallas kernels' function with their rounding
// (scale = 1 / sqrt(D)):
//   p  = exp(scale * q.k - lse)           fp32, under the mask
//   D  = rowsum(dO * o)                   fp32
//   ds = p * (dO.v - D)                   fp32, under the mask
//   dq = scale * bf16(ds).k;  dk = scale * sum bf16(ds)^T.q;
//   dv = sum bf16(p)^T.dO
// p and ds are rounded to bf16 before their products, as the Pallas
// kernels round them to the input type (`p.astype(do.dtype)`,
// `ds.astype(q.dtype)`, `ds.astype(k.dtype)`); every product accumulates
// in fp32 and each output is rounded once. dk and dv sum the G query heads
// of their KV head in the same fp32 accumulators (the JAX wrapper rounds
// each head to bf16 before its sum). A row with nothing to attend to (lse
// -inf, o NaN) gets dq = 0 and adds nothing to dk or dv: every masked
// product is a select.
//
// What bounds it: operations. 10 * D flops per attended (q, k) pair and
// head (S, dP, dV, dQ, dK): 0.78 ms for starcoder2-7b's training shape
// (B 2, S 4,096, causal, 36 heads of 128) at 989 TFLOP/s.
//
// Design: three launches on the caller's stream, no atomics, so the
// result is deterministic.
//   prep  one warp per row of lse and D, padded to a multiple of 128
//         rows: D = rowsum(dO * o) and lse * log2(e), with padded rows 0
//         and +inf so that a query past Sq contributes exactly nothing.
//   dq    one block per (b * h, tile of 128 query rows), as K5's forward:
//         a producer warpgroup streams 64-key tiles of K and V through a
//         two-stage TMA ring; each consumer warpgroup (64 rows) runs
//         S = Q.K^T and dP = dO.V^T as wgmma from shared memory, forms ds
//         in registers, packs it to bf16 A fragments and runs
//         dQ += dS.K with K as the MN-major B operand.
//   dk/dv one block per (b * hkv, tile of 128 keys): K and V loaded once,
//         then the producer streams (Q, dO, lse, D) tiles of 64 queries of
//         each of the G heads of the group. Each consumer (64 keys)
//         computes S^T = K.Q^T and dP^T = V.dO^T, so that P^T and dS^T come
//         out in the accumulator layout that is already the A fragment of
//         dV += P^T.dO and dK += dS^T.Q (dO and Q as MN-major B operands).
// Both passes walk a host-built schedule, longest first: under the causal
// mask the key tile at position 0 walks every query tile of G heads and
// the last one a single tile, and at starcoder2's shape the dk/dv pass has
// only 2 x 4 x 32 = 256 blocks for 132 SMs, so the long blocks start
// first and the short ones fill the tail (a deterministic split of the
// long blocks' query range, summed in a second pass, is the alternative
// not taken: it needs fp32 partials in device memory and one more
// launch). Masks apply only to the tiles that cross a mask edge, and a
// consumer skips the tiles its own 64 rows cannot see.
// Shared memory at D 128: dq 128 KB, dk/dv 129 KB.
//
// The entry point builds the tensor maps on the host, allocates nothing
// (the wrapper passes the prep pass's scratch) and returns
// cudaGetLastError() (or a hopper::kEncodeFailed code) so the Python
// wrapper can raise.

#include "hopper_mma.cuh"

#include <math_constants.h>

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kPad = 128;         // lse / D rows padded to a multiple
constexpr int kStages = 2;
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = 384;     // and the producer warpgroup
constexpr int kQ_BQ = 128;        // dq pass: query rows per block
constexpr int kQ_BK = 64;         //          keys per tile
constexpr int kK_BK = 128;        // dk/dv pass: keys per block
constexpr int kK_BQ = 64;         //             query rows per tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool attends(int qi, int kj, int Sq, int Sk,
                                        int causal, int window) {
    bool ok = qi < Sq && kj < Sk;
    if (causal) ok = ok && qi >= kj;
    if (window > 0) ok = ok && qi - kj < window;
    return ok;
}

__global__ void __launch_bounds__(256)
bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                const float* __restrict__ lse, float* __restrict__ delta,
                float* __restrict__ lse2, long long rows, int Sq, int Sqp,
                int H, int D) {
    const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    const long long bh = row / Sqp;
    const int i = (int)(row - bh * Sqp);
    if (i >= Sq) {
        if (lane == 0) {
            delta[row] = 0.f;
            lse2[row] = CUDART_INF_F;
        }
        return;
    }
    const long long b = bh / H;
    const long long off = ((b * Sq + i) * H + (bh - b * H)) * D;
    float s = 0.f;
    for (int d = 2 * lane; d < D; d += 64) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + off + d));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dO + off + d));
        s = fmaf(x.x, y.x, s);
        s = fmaf(x.y, y.y, s);
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) s += __shfl_xor_sync(0xffffffffu, s, k);
    if (lane == 0) {
        delta[row] = s;
        lse2[row] = lse[bh * Sq + i] * kLog2e;
    }
}

// ------------------------------------------------------------- dq pass
template <int D>
struct DqSmem {
    static constexpr int kAtoms = D / 64;
    static constexpr int kQAtom = kQ_BQ * 128;
    static constexpr int kKAtom = kQ_BK * 128;
    static constexpr int kTile = kAtoms * kKAtom;
    static constexpr int q = 0;
    static constexpr int dO = q + kAtoms * kQAtom;
    static constexpr int k = dO + kAtoms * kQAtom;     // + stage * kTile
    static constexpr int v = k + kStages * kTile;
    static constexpr int bars = v + kStages * kTile;   // q, full[], empty[]
    static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    const int* __restrict__ sched, int Sq, int Sqp, int Sk,
                    int H, int Hkv, int causal, int window, float scale_log2,
                    float scale) {
    using L = DqSmem<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + kStages;

    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh - b * H;
    const int hk = h / (H / Hkv);
    const int q0 = sched[3 * blockIdx.y] * kQ_BQ;
    const int t_lo = sched[3 * blockIdx.y + 1];
    const int t_hi = sched[3 * blockIdx.y + 2];

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumers) {
        // ---------------------------------------------------- producer
        setmaxnreg_dec<24>();
        if (threadIdx.x == kConsumers) {
            tma_prefetch(&tq);
            tma_prefetch(&tdo);
            tma_prefetch(&tk);
            tma_prefetch(&tv);
            mbar_expect_tx(q_full, 2 * L::kAtoms * L::kQAtom);
            for (int a = 0; a < L::kAtoms; ++a) {
                tma_load_4d(smem + L::q + a * L::kQAtom, &tq, q_full, a * 64,
                            h, q0, b);
                tma_load_4d(smem + L::dO + a * L::kQAtom, &tdo, q_full,
                            a * 64, h, q0, b);
            }
            for (int t = t_lo; t < t_hi; ++t) {
                const int it = t - t_lo;
                const int s = it % kStages;
                if (it >= kStages)
                    mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
                mbar_expect_tx(&full[s], 2 * L::kTile);
                for (int a = 0; a < L::kAtoms; ++a) {
                    tma_load_4d(smem + L::k + s * L::kTile + a * L::kKAtom,
                                &tk, &full[s], a * 64, hk, t * kQ_BK, b);
                    tma_load_4d(smem + L::v + s * L::kTile + a * L::kKAtom,
                                &tv, &full[s], a * 64, hk, t * kQ_BK, b);
                }
            }
        }
    } else {
        // --------------------------------------------------- consumers
        setmaxnreg_inc<240>();
        const int wg = threadIdx.x / 128;
        const int tid = threadIdx.x % 128;
        const int lane = tid % 32;
        const int qw = q0 + 64 * wg;
        const int r0 = qw + 16 * (tid / 32) + lane / 4;   // and r0 + 8
        const int c0 = 2 * (lane % 4);
        float lr[2], dl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            lr[r] = lse2[(long long)bh * Sqp + r0 + 8 * r];
            dl[r] = delta[(long long)bh * Sqp + r0 + 8 * r];
        }
        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

        mbar_wait(q_full, 0);
        for (int t = t_lo; t < t_hi; ++t) {
            const int it = t - t_lo;
            const int s = it % kStages;
            mbar_wait(&full[s], (it / kStages) & 1);
            const int k0 = t * kQ_BK;
            const bool none = (causal && k0 > qw + 63)
                || (window > 0 && qw - (k0 + kQ_BK - 1) >= window);
            if (none) {
                mbar_arrive(&empty[s]);
                continue;
            }
            const bool edge = k0 + kQ_BK > Sk
                || (causal && k0 + kQ_BK - 1 > qw)
                || (window > 0 && qw + 63 - k0 >= window);
            const uint8_t* ks = smem + L::k + s * L::kTile;
            const uint8_t* vs = smem + L::v + s * L::kTile;

            float sc[kQ_BK / 2], dp[kQ_BK / 2];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int qa = (kk / 4) * L::kQAtom + 64 * wg * 128
                    + (kk % 4) * 32;
                const int ka = (kk / 4) * L::kKAtom + (kk % 4) * 32;
                wgmma_ss<kQ_BK, 0>(sc, desc_sw128(smem + L::q + qa, 16, 1024),
                                   desc_sw128(ks + ka, 16, 1024), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int qa = (kk / 4) * L::kQAtom + 64 * wg * 128
                    + (kk % 4) * 32;
                const int ka = (kk / 4) * L::kKAtom + (kk % 4) * 32;
                wgmma_ss<kQ_BK, 0>(dp, desc_sw128(smem + L::dO + qa, 16, 1024),
                                   desc_sw128(vs + ka, 16, 1024), kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            fence_regs(dp);

            uint32_t da[kQ_BK / 4];
#pragma unroll
            for (int i = 0; i < kQ_BK / 2; i += 2) {
                const int hi = (i / 2) % 2;
                float x[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p = exp2_approx(
                        fmaf(sc[i + e], scale_log2, -lr[hi]));
                    x[e] = p * (dp[i + e] - dl[hi]);
                    if (edge && !attends(r0 + 8 * hi,
                                         k0 + 8 * (i / 4) + c0 + e, Sq, Sk,
                                         causal, window))
                        x[e] = 0.f;
                }
                da[i / 2] = pack_bf16(x[0], x[1]);
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kQ_BK / 16; ++kk)
                wgmma_rs<D, 1>(acc, da + 4 * kk,
                               desc_sw128(ks + kk * 16 * 128, L::kKAtom,
                                          1024), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            mbar_arrive(&empty[s]);
        }

        const long long q_pos = (long long)H * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int qi = r0 + 8 * r;
            if (qi >= Sq) continue;
            bf16* row = dq + ((long long)b * Sq + qi) * q_pos
                        + (long long)h * D;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                          acc[4 * j + 2 * r + 1] * scale);
        }
    }
}

// ---------------------------------------------------------- dk/dv pass
template <int D>
struct DkvSmem {
    static constexpr int kAtoms = D / 64;
    static constexpr int kKAtom = kK_BK * 128;
    static constexpr int kQAtom = kK_BQ * 128;
    static constexpr int kTile = kAtoms * kQAtom;
    static constexpr int kRow = kK_BQ * 4;             // lse or D of a tile
    static constexpr int k = 0;
    static constexpr int v = k + kAtoms * kKAtom;
    static constexpr int q = v + kAtoms * kKAtom;      // + stage * kTile
    static constexpr int dO = q + kStages * kTile;
    static constexpr int lse = dO + kStages * kTile;   // + stage * kRow
    static constexpr int dl = lse + kStages * kRow;
    static constexpr int bars = dl + kStages * kRow;   // kv, full[], empty[]
    static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ sched,
                     int Sq, int Sqp, int Sk, int H, int Hkv, int causal,
                     int window, float scale_log2, float scale) {
    using L = DkvSmem<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* full = kv_full + 1;
    uint64_t* empty = full + kStages;

    const int bhk = blockIdx.x;
    const int b = bhk / Hkv;
    const int hk = bhk - b * Hkv;
    const int G = H / Hkv;
    const int k0 = sched[3 * blockIdx.y] * kK_BK;
    const int t_lo = sched[3 * blockIdx.y + 1];
    const int n_t = sched[3 * blockIdx.y + 2] - t_lo;
    const int steps = G * n_t;          // (head of the group, query tile)

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumers) {
        // ---------------------------------------------------- producer
        setmaxnreg_dec<24>();
        if (threadIdx.x == kConsumers) {
            tma_prefetch(&tk);
            tma_prefetch(&tv);
            tma_prefetch(&tq);
            tma_prefetch(&tdo);
            mbar_expect_tx(kv_full, 2 * L::kAtoms * L::kKAtom);
            for (int a = 0; a < L::kAtoms; ++a) {
                tma_load_4d(smem + L::k + a * L::kKAtom, &tk, kv_full, a * 64,
                            hk, k0, b);
                tma_load_4d(smem + L::v + a * L::kKAtom, &tv, kv_full, a * 64,
                            hk, k0, b);
            }
            for (int it = 0; it < steps; ++it) {
                const int h = hk * G + it / n_t;
                const int qt0 = (t_lo + it % n_t) * kK_BQ;
                const int s = it % kStages;
                if (it >= kStages)
                    mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
                mbar_expect_tx(&full[s], 2 * L::kTile + 2 * L::kRow);
                for (int a = 0; a < L::kAtoms; ++a) {
                    tma_load_4d(smem + L::q + s * L::kTile + a * L::kQAtom,
                                &tq, &full[s], a * 64, h, qt0, b);
                    tma_load_4d(smem + L::dO + s * L::kTile + a * L::kQAtom,
                                &tdo, &full[s], a * 64, h, qt0, b);
                }
                const long long row = ((long long)b * H + h) * Sqp + qt0;
                bulk_load(smem + L::lse + s * L::kRow, lse2 + row, L::kRow,
                          &full[s]);
                bulk_load(smem + L::dl + s * L::kRow, delta + row, L::kRow,
                          &full[s]);
            }
        }
    } else {
        // --------------------------------------------------- consumers
        setmaxnreg_inc<240>();
        const int wg = threadIdx.x / 128;
        const int tid = threadIdx.x % 128;
        const int lane = tid % 32;
        const int kw = k0 + 64 * wg;                   // this warpgroup's keys
        const int r0 = kw + 16 * (tid / 32) + lane / 4;   // and r0 + 8
        const int c0 = 2 * (lane % 4);
        float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
            dk_acc[i] = 0.f;
            dv_acc[i] = 0.f;
        }

        mbar_wait(kv_full, 0);
        for (int it = 0; it < steps; ++it) {
            const int qt0 = (t_lo + it % n_t) * kK_BQ;
            const int s = it % kStages;
            mbar_wait(&full[s], (it / kStages) & 1);
            const bool none = kw >= Sk
                || (causal && qt0 + kK_BQ - 1 < kw)
                || (window > 0 && qt0 - (kw + 63) >= window);
            if (none) {
                mbar_arrive(&empty[s]);
                continue;
            }
            const bool edge = kw + 64 > Sk || qt0 + kK_BQ > Sq
                || (causal && qt0 < kw + 63)
                || (window > 0 && qt0 + kK_BQ - 1 - kw >= window);
            const uint8_t* qs = smem + L::q + s * L::kTile;
            const uint8_t* dos = smem + L::dO + s * L::kTile;
            const float* ls =
                reinterpret_cast<const float*>(smem + L::lse + s * L::kRow);
            const float* dls =
                reinterpret_cast<const float*>(smem + L::dl + s * L::kRow);

            float st[kK_BQ / 2], dpt[kK_BQ / 2];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int ka = (kk / 4) * L::kKAtom + 64 * wg * 128
                    + (kk % 4) * 32;
                const int qa = (kk / 4) * L::kQAtom + (kk % 4) * 32;
                wgmma_ss<kK_BQ, 0>(st, desc_sw128(smem + L::k + ka, 16, 1024),
                                   desc_sw128(qs + qa, 16, 1024), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int ka = (kk / 4) * L::kKAtom + 64 * wg * 128
                    + (kk % 4) * 32;
                const int qa = (kk / 4) * L::kQAtom + (kk % 4) * 32;
                wgmma_ss<kK_BQ, 0>(dpt, desc_sw128(smem + L::v + ka, 16, 1024),
                                   desc_sw128(dos + qa, 16, 1024), kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);

            uint32_t pa[kK_BQ / 4], sa[kK_BQ / 4];
#pragma unroll
            for (int i = 0; i < kK_BQ / 2; i += 2) {
                const int key = r0 + 8 * ((i / 2) % 2);
                const int c = 8 * (i / 4) + c0;   // query columns c, c + 1
                const float2 lq = *reinterpret_cast<const float2*>(ls + c);
                const float2 dq2 = *reinterpret_cast<const float2*>(dls + c);
                float p[2], x[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    p[e] = exp2_approx(fmaf(st[i + e], scale_log2,
                                            -(e ? lq.y : lq.x)));
                    x[e] = p[e] * (dpt[i + e] - (e ? dq2.y : dq2.x));
                    if (edge && !attends(qt0 + c + e, key, Sq, Sk, causal,
                                         window)) {
                        p[e] = 0.f;
                        x[e] = 0.f;
                    }
                }
                pa[i / 2] = pack_bf16(p[0], p[1]);
                sa[i / 2] = pack_bf16(x[0], x[1]);
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kK_BQ / 16; ++kk) {
                wgmma_rs<D, 1>(dv_acc, pa + 4 * kk,
                               desc_sw128(dos + kk * 16 * 128, L::kQAtom,
                                          1024), 1);
                wgmma_rs<D, 1>(dk_acc, sa + 4 * kk,
                               desc_sw128(qs + kk * 16 * 128, L::kQAtom,
                                          1024), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dk_acc);
            fence_regs(dv_acc);
            mbar_arrive(&empty[s]);
        }

        const long long kv_pos = (long long)Hkv * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int kj = r0 + 8 * r;
            if (kj >= Sk) continue;
            const long long off = ((long long)b * Sk + kj) * kv_pos
                                  + (long long)hk * D;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + c0) =
                    __floats2bfloat162_rn(dk_acc[4 * j + 2 * r] * scale,
                                          dk_acc[4 * j + 2 * r + 1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + c0) =
                    __floats2bfloat162_rn(dv_acc[4 * j + 2 * r],
                                          dv_acc[4 * j + 2 * r + 1]);
            }
        }
    }
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, float* scratch, void* dq,
           void* dk, void* dv, const int* sched_q, int n_q,
           const int* sched_k, int n_k, int B, int Sq, int Sk, int H,
           int Hkv, int causal, int window, cudaStream_t stream) {
    const int Sqp = (Sq + kPad - 1) / kPad * kPad;
    const long long rows = (long long)B * H * Sqp;
    float* delta = scratch;
    float* lse2 = scratch + rows;
    CUtensorMap q128, do128, k64, v64, q64, do64, k128, v128;
    int e;
    if ((e = make_map(&q128, q, B, Sq, H, D, kQ_BQ)) != 0
        || (e = make_map(&do128, dO, B, Sq, H, D, kQ_BQ)) != 0
        || (e = make_map(&k64, k, B, Sk, Hkv, D, kQ_BK)) != 0
        || (e = make_map(&v64, v, B, Sk, Hkv, D, kQ_BK)) != 0
        || (e = make_map(&q64, q, B, Sq, H, D, kK_BQ)) != 0
        || (e = make_map(&do64, dO, B, Sq, H, D, kK_BQ)) != 0
        || (e = make_map(&k128, k, B, Sk, Hkv, D, kK_BK)) != 0
        || (e = make_map(&v128, v, B, Sk, Hkv, D, kK_BK)) != 0)
        return e;

    bwd_prep_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dO), lse, delta,
        lse2, rows, Sq, Sqp, H, D);
    cudaError_t c = cudaGetLastError();
    if (c != cudaSuccess) return (int)c;

    const float scale = 1.0f / sqrtf((float)D);
    const float scale_log2 = scale * kLog2e;
    auto dq_kern = bwd_dq_wgmma_kernel<D>;
    if ((c = allow_smem(dq_kern, DqSmem<D>::bytes)) != cudaSuccess)
        return (int)c;
    dq_kern<<<dim3(B * H, n_q), kThreads, DqSmem<D>::bytes, stream>>>(
        q128, do128, k64, v64, lse2, delta, static_cast<bf16*>(dq), sched_q,
        Sq, Sqp, Sk, H, Hkv, causal, window, scale_log2, scale);
    if ((c = cudaGetLastError()) != cudaSuccess) return (int)c;

    auto dkv_kern = bwd_dkv_wgmma_kernel<D>;
    if ((c = allow_smem(dkv_kern, DkvSmem<D>::bytes)) != cudaSuccess)
        return (int)c;
    dkv_kern<<<dim3(B * Hkv, n_k), kThreads, DkvSmem<D>::bytes, stream>>>(
        k128, v128, q64, do64, lse2, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), sched_k, Sq, Sqp, Sk, H, Hkv, causal, window,
        scale_log2, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// scratch: float32 [2, B * H * Sqp] with Sqp = Sq rounded up to 128 (D,
// then lse * log2(e)). sched_q: int32 [n_q, 3] (query tile of 128, first
// and end key tile of 64), every query tile once; sched_k: int32
// [n_k, 3] (key tile of 128, first and end query tile of 64), every key
// tile once.
extern "C" int flash_bwd_wgmma(const void* q, const void* k, const void* v,
                               const void* o, const void* dO,
                               const void* lse, void* scratch, void* dq,
                               void* dk, void* dv, const void* sched_q,
                               int n_q, const void* sched_k, int n_k, int B,
                               int Sq, int Sk, int H, int Hkv, int D,
                               int causal, int window, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0
        || n_q != (Sq + kQ_BQ - 1) / kQ_BQ
        || n_k != (Sk + kK_BK - 1) / kK_BK)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    float* w = static_cast<float*>(scratch);
    const int* sq = static_cast<const int*>(sched_q);
    const int* sk = static_cast<const int*>(sched_k);
    if (D == 64)
        return launch<64>(q, k, v, o, dO, l, w, dq, dk, dv, sq, n_q, sk, n_k,
                          B, Sq, Sk, H, Hkv, causal, window, s);
    if (D == 128)
        return launch<128>(q, k, v, o, dO, l, w, dq, dk, dv, sq, n_q, sk,
                           n_k, B, Sq, Sk, H, Hkv, causal, window, s);
    return (int)cudaErrorInvalidValue;
}

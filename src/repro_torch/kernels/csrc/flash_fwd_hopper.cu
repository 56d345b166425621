// Flash attention forward on Hopper's tensor cores (sm_90a): K5 for bf16
// inputs at head dims 64 and 128.
//
//   flash_fwd_wgmma  replaces flash_attention_pallas
//                    (repro/kernels/flash_attention.py, _kernel) for those
//                    inputs; the PR 12 CUDA-core kernel (attention.cu,
//                    flash_attention_fwd) keeps float32 and bf16 at D 32 and
//                    256. q [B, Sq, H, D], k/v [B, Sk, Hkv, D] bf16 ->
//                    o [B, Sq, H, D] bf16 and, where asked, lse [B*H, Sq]
//                    float32 in (b, hkv, g) order.
//
// What it computes is the Pallas kernel's function with its rounding: the
// scores and the online softmax in fp32, p rounded to bf16 before P.V (as
// `p.astype(v.dtype)`), the row sum l over the unrounded p, o = acc / l
// rounded once. Masks count q and k positions from 0 (so Sq != Sk);
// causal keeps k <= q, window > 0 keeps q - k < window; a key past Sk is
// masked (the TMA load fills it with zeros, which would score 0). An
// optional per-row key length (kv_len [B] int32, null for Sk, clamped to
// [0, Sk] here) masks the keys j >= kv_len[b] as well: the key-tile loop
// of a block ends at the length's tile, so the tiles past it are never
// loaded, and the tile that crosses it is masked as an edge. A row with
// nothing to attend to is NaN with lse -inf, as the float32 oracle.
//
// What bounds it: operations. 4 * D flops per attended (q, k) pair and
// head at the 989 TFLOP/s bf16 dense rate: 0.61 ms for an 8,192-token
// causal prefill at starcoder2-7b's 36 heads of 128.
//
// Design. One block per (b * h, tile of 128 query rows), in the order of
// a host-built schedule (`sched`: per entry the query tile and the range
// of key tiles the masks leave, longest first), so that the causal
// diagonal's short tiles fill the tail. Three warpgroups: warpgroup 2 is
// the producer (one thread issues TMA loads; setmaxnreg drops it to 24
// registers), warpgroups 0 and 1 the consumers of 64 query rows each (240
// registers). Q is loaded once; tiles of 128 keys of K and V of the
// group's KV head stream through a two-stage ring of mbarriers (full:
// the producer's expected bytes; empty: all 256 consumer threads). Per
// tile each consumer runs S = Q.K^T as wgmma m64n128k16 from shared
// memory, masks only the tiles that cross a mask edge, keeps (m, l) per
// row with exp2 on prescaled scores, packs P into bf16 A fragments in
// registers and runs O += P.V with V as the MN-major B operand (the
// descriptor's transpose bit). A consumer skips the tiles its own 64 rows
// cannot see. Shared memory: Q 16 KB per 64 channels, each stage K and V
// 32 KB per 64 channels: 160 KB at D 128.
//
// The entry point builds the tensor maps on the host, launches on the
// caller's stream, allocates nothing and returns cudaGetLastError() (or a
// hopper::kEncodeFailed code) so the Python wrapper can raise.

#include "hopper_mma.cuh"

#include <math_constants.h>

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;          // query rows per block
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = 384;     // and the producer warpgroup

template <int D>
struct FwdSmem {
    static constexpr int kAtoms = D / 64;
    static constexpr int kQAtom = kBQ * 128;           // bytes of an atom
    static constexpr int kKVAtom = kBK * 128;
    static constexpr int kTile = kAtoms * kKVAtom;     // one K or V tile
    static constexpr int q = 0;
    static constexpr int k = q + kAtoms * kQAtom;      // + stage * kTile
    static constexpr int v = k + kStages * kTile;
    static constexpr int bars = v + kStages * kTile;   // q, full[], empty[]
    static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

// the row's keys end at len (Sk, or the row's clamped kv_len)
__device__ __forceinline__ bool attends(int qi, int kj, int len, int causal,
                                        int window) {
    bool ok = kj < len;
    if (causal) ok = ok && qi >= kj;
    if (window > 0) ok = ok && qi - kj < window;
    return ok;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ sched, int Sq, int Sk, int H,
                       int Hkv, int causal, int window, float scale_log2) {
    using L = FwdSmem<D>;
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
    const int q0 = sched[3 * blockIdx.y] * kBQ;
    const int t_lo = sched[3 * blockIdx.y + 1];
    // this row's keys end at its length: the masks' tile range cut there
    const int len = kv_len == nullptr ? Sk : min(max(kv_len[b], 0), Sk);
    const int t_hi = min(sched[3 * blockIdx.y + 2], (len + kBK - 1) / kBK);

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
            tma_prefetch(&tk);
            tma_prefetch(&tv);
            mbar_expect_tx(q_full, L::kAtoms * L::kQAtom);
            for (int a = 0; a < L::kAtoms; ++a)
                tma_load_4d(smem + L::q + a * L::kQAtom, &tq, q_full, a * 64,
                            h, q0, b);
            for (int t = t_lo; t < t_hi; ++t) {
                const int it = t - t_lo;
                const int s = it % kStages;
                if (it >= kStages)
                    mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
                mbar_expect_tx(&full[s], 2 * L::kTile);
                for (int a = 0; a < L::kAtoms; ++a) {
                    tma_load_4d(smem + L::k + s * L::kTile + a * L::kKVAtom,
                                &tk, &full[s], a * 64, hk, t * kBK, b);
                    tma_load_4d(smem + L::v + s * L::kTile + a * L::kKVAtom,
                                &tv, &full[s], a * 64, hk, t * kBK, b);
                }
            }
        }
    } else {
        // --------------------------------------------------- consumers
        setmaxnreg_inc<240>();
        const int wg = threadIdx.x / 128;
        const int tid = threadIdx.x % 128;
        const int lane = tid % 32;
        const int qw = q0 + 64 * wg;                  // this warpgroup's rows
        const int r0 = qw + 16 * (tid / 32) + lane / 4;   // and r0 + 8
        const int c0 = 2 * (lane % 4);                 // columns c0, c0 + 1

        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
        float l[2] = {0.f, 0.f};

        mbar_wait(q_full, 0);
        for (int t = t_lo; t < t_hi; ++t) {
            const int it = t - t_lo;
            const int s = it % kStages;
            mbar_wait(&full[s], (it / kStages) & 1);
            const int k0 = t * kBK;
            // nothing of this tile is visible to this warpgroup's rows
            const bool none = (causal && k0 > qw + 63)
                || (window > 0 && qw - (k0 + kBK - 1) >= window);
            if (none) {
                mbar_arrive(&empty[s]);
                continue;
            }
            const bool edge = k0 + kBK > len
                || (causal && k0 + kBK - 1 > qw)
                || (window > 0 && qw + 63 - k0 >= window);

            float sc[kBK / 2];
            const uint8_t* ks = smem + L::k + s * L::kTile;
            const uint8_t* vs = smem + L::v + s * L::kTile;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int off = (kk / 4) * L::kQAtom + (kk % 4) * 32;
                const uint64_t da = desc_sw128(
                    smem + L::q + 64 * wg * 128 + off, 16, 1024);
                const uint64_t db = desc_sw128(
                    ks + (kk / 4) * L::kKVAtom + (kk % 4) * 32, 16, 1024);
                wgmma_ss<kBK, 0>(sc, da, db, kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);

            float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
            for (int i = 0; i < kBK / 2; ++i) {
                const int hi = (i / 2) % 2;
                float x = sc[i] * scale_log2;
                const int kj = k0 + 8 * (i / 4) + c0 + i % 2;
                if (edge && !attends(r0 + 8 * hi, kj, len, causal, window))
                    x = -CUDART_INF_F;
                sc[i] = x;
                mx[hi] = fmaxf(mx[hi], x);
            }
            float corr[2], mu[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float mn = fmaxf(m[r], mx[r]);
                mu[r] = mn == -CUDART_INF_F ? 0.f : mn;   // all masked so far
                corr[r] = exp2_approx(m[r] - mu[r]);
                m[r] = mn;
            }
            float rs[2] = {0.f, 0.f};
            uint32_t pa[kBK / 4];
#pragma unroll
            for (int i = 0; i < kBK / 2; i += 2) {
                const int hi = (i / 2) % 2;
                const float p0 = exp2_approx(sc[i] - mu[hi]);
                const float p1 = exp2_approx(sc[i + 1] - mu[hi]);
                rs[hi] += p0 + p1;
                pa[i / 2] = pack_bf16(p0, p1);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
                rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
                l[r] = fmaf(l[r], corr[r], rs[r]);
            }
#pragma unroll
            for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];

            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk) {
                const uint64_t db = desc_sw128(vs + kk * 16 * 128, L::kKVAtom,
                                               1024);
                wgmma_rs<D, 1>(acc, pa + 4 * kk, db, 1);
            }
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
            bf16* row = o + ((long long)b * Sq + qi) * q_pos
                        + (long long)h * D;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                // l = 0 (nothing attended): 0 / 0 is NaN, as the oracle
                const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                    acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
                *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) = v2;
            }
            if (lse != nullptr && lane % 4 == 0)
                lse[(long long)bh * Sq + qi] =
                    (m[r] + log2f(l[r])) * 0.6931471805599453f;
        }
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* kv_len, const int* sched, int n_sched, int B, int Sq,
           int Sk, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    int e;
    if ((e = make_map(&tq, q, B, Sq, H, D, kBQ)) != 0) return e;
    if ((e = make_map(&tk, k, B, Sk, Hkv, D, kBK)) != 0) return e;
    if ((e = make_map(&tv, v, B, Sk, Hkv, D, kBK)) != 0) return e;
    auto kern = flash_fwd_wgmma_kernel<D>;
    constexpr int smem = FwdSmem<D>::bytes;
    cudaError_t c = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (c != cudaSuccess) return (int)c;
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
    kern<<<dim3(B * H, n_sched), kThreads, smem, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), lse, kv_len, sched, Sq, Sk, H,
        Hkv, causal, window, scale_log2);
    return (int)cudaGetLastError();
}

}  // namespace

// sched: int32 [n_sched, 3] (query tile, first key tile, end key tile),
// every query tile of ceil(Sq / 128) once. kv_len: int32 [B] or null.
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v,
                               void* o, void* lse, const void* kv_len,
                               const void* sched, int n_sched, int B, int Sq,
                               int Sk, int H, int Hkv, int D, int causal,
                               int window, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0
        || n_sched != (Sq + kBQ - 1) / kBQ)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    const int* t = static_cast<const int*>(sched);
    const int* n = static_cast<const int*>(kv_len);
    if (D == 64)
        return launch<64>(q, k, v, o, l, n, t, n_sched, B, Sq, Sk, H, Hkv,
                          causal, window, s);
    if (D == 128)
        return launch<128>(q, k, v, o, l, n, t, n_sched, B, Sq, Sk, H, Hkv,
                           causal, window, s);
    return (int)cudaErrorInvalidValue;
}

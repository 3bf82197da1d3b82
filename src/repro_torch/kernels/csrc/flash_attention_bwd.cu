// Causal / sliding-window GQA attention, backward: dq, dk, dv of
// csrc/flash_attention.cu's forward for the output's gradient do.  f32
// statistics and accumulation, each gradient in its input's dtype (bf16 or
// f32).
//
//   q, do, dq    (B, Hq, S, D)   by strides, last dim contiguous
//   k, v, dk, dv (B, Hkv, Sk, D) by strides, last dim contiguous
// Visibility as the forward's: key j is seen by query i when j < Sk, j <= i
// (causal) and i - j < window (window > 0); a row with no visible key has
// no gradient.
//
// What it stands for: the TPU kernel (repro/kernels/flash_attention.py:118)
// has no VJP; the reference trains through jnp attention (_sdpa_chunked,
// repro/models/layers.py) under jax.grad, whose gradient is
// kernels/ref.py::attention_bwd: with P the masked softmax of s = q k^T /
// sqrt(D), dv = P^T do, dP = do v^T, dS = P (dP - rowsum(P dP)), dq = dS k /
// sqrt(D), dk = dS^T q / sqrt(D); dk and dv of a kv head summed over its G
// query heads.
//
// Four variants; kernels/flash_attention.py::bwd_variant picks one from
// (S, Sk, D, dtype).  All keep the same split and order: the dq kernel
// first, then the dkv kernel, which reads each row's L (log-sum-exp) and
// Dd = rowsum(P dP) from two f32 workspaces.  simt and wgmma (the forward's
// rule) write them in a first pass of their dq kernel, recomputing m and l
// with rowsum(P dP) online beside them, so the forward keeps nothing.
// stats (bf16, D 64, 96 or 128, Sk >= STATS_MIN_SK: cross-attention over
// 6,404 image tokens) reads L2 as the wgmma forward wrote it under autograd
// and takes Dd = rowsum(dO o) from that forward's f32 output in a prologue
// kernel of the same call (flash_bwd_dd_kernel): FlashAttention-2's way,
// but from the f32 output, since Dd from the bf16 one moves dq, dk and dv
// 14-39x past the check's limit (tests/test_torch_flash_bwd.py).  Its dq
// kernel walks K/V once (4 products a tile pair, not 6: 10 a pair in all,
// not 12), and both grids run in kv-head order, a kv head's blocks
// consecutive, so the K/V (dq) or Q/dO (dkv) they stream stays in L2.  Two
// consumer warpgroups a block (384 threads with setmaxnreg, or 288) spilled
// both grids: ptxas allocates for the launch bound, 168 registers a thread
// at either size, against the 191-255 these consumers hold.  No atomics:
// every sum runs in a fixed order, so the bits do not vary between runs.
//
// * wgmma (bf16, D = 64, 96 or 128; the training path).  What bounds it on an
//   H100: at the training shape (B = 4, 32 q heads over 8 kv heads of 128,
//   S = 1024, causal) the 12 products below are ~206 GFLOP (0.21 ms at 989
//   TFLOP/s) on ~0.1 GB of inputs and outputs (0.03 ms): operations.  So
//   every product is on the tensor cores, in one of the forward's two
//   wgmma forms (flash_wgmma.cuh): qk_issue (A B^T, both K-major from
//   shared memory) and pv_issue (a score fragment from registers, times a
//   tile read MN-major by the transpose bit):
//     dq  (a block a (b, q head, 64-row q tile), the forward's tile_plan
//         walk, longest walks first):
//           pass 1  S = Q K^T, dP = dO V^T (qk_issue); online m, l and
//                   rowsum(P dP) as the forward's softmax;
//           pass 2  S, dP again (qk_issue); P = 2^(s sl2 - L2), dS = P (dP -
//                   Dd); dQ += dS K (pv_issue, K read MN-major), the next
//                   tile's S and dP issued with it, as the forward does.
//     dkv (a block a (b, kv head, 64-key tile); it walks the kv head's G
//         query heads in order, then the q tiles bwd_q_plan gives):
//           S^T = K Q^T, dP^T = V dO^T (qk_issue); P^T and dS^T from each
//           q row's L2 and Dd; dV += P^T dO, dK += dS^T Q (pv_issue, dO and
//           Q read MN-major).
//   12 products a tile pair (dq 2 + 2 + 2 split, dkv 2 + 2 + 2 x 2 split).
//   P and dS enter their products exact to ~2^-16 as two bf16 halves, hi +
//   lo: P rounded once to bf16 moves near-zero gradients by ~1e-4, the
//   check's atol (the forward found the same for P V).  Q, K, V and dO are
//   bf16 inputs, exact as they are.  A producer warp feeds each block by
//   TMA (128-byte swizzle, 4-D tensor maps over the model's strided views,
//   rows past S or Sk as zeros) into a 2-stage ring behind mbarriers: the
//   dq kernel's K and V tiles, walked twice; the dkv kernel's Q and dO
//   tiles with their 64 L2 and Dd (a 512-byte bulk copy from workspaces
//   whose rows are padded to 64).  One consumer warpgroup holds the
//   accumulators in registers: dq's 64 x D, dkv's dK and dV (D f32 a
//   thread at D = 128) beside S^T and dP^T, so the dkv block takes its next
//   tile's products only after this tile's, and leans on the other blocks
//   of the SM, where registers allow two, to fill the tensor cores.  ptxas
//   (-Xptxas -v, printed by chip_smoke.py phase 2) reports no spills and no
//   wgmma serialisation: dq 191 / 160 registers at D = 128 / 64 (two blocks
//   an SM), dkv 255 / 200 (one block an SM at D = 128, two at 64), 100,392
//   bytes of shared memory a block at D = 128.  D = 96 (phi3-mini) takes
//   D = 128's tiles, products and registers (flash_wgmma.cuh): rows
//   loaded as two boxes whose columns past 96 TMA fills with zeros, S, dP
//   and their transposes over the 6 k16 steps that hold data, dQ, dK and
//   dV at n128 with zero columns past 96 that store_rows leaves unwritten;
//   the scales are 1/sqrt(96)'s.  Only tiles that cross the diagonal, S's
//   or Sk's edge or the window's edge are masked.  A causal
//   dkv grid is lopsided (the first key tile sees every q row of G heads,
//   the last one tile), so the key tiles are numbered heavy first along
//   blockIdx.y and the scheduler fills the 132 SMs with them (no
//   persistent walk); the dq grid runs its longest walks first.  L2
//   is L in log2 units (m sl2 + log2 l), so P is one FFMA and one
//   ex2.approx a score (~2^-22 from the reference's exp).
// * tf32x3 (f32, D = 64, 96 or 128, aligned; the f32 training path at real
//   width).  What bounds it on an H100: at (4, 32/8 heads, 1024, 128)
//   causal the five products are 86 GFLOP, 1.28 ms on the CUDA cores and
//   0.52 ms as three TF32 products on the tensor cores: operations.  So
//   every product is TF32 on the tensor cores, each operand split into hi
//   = TF32(x) and lo = x - hi (read as TF32) and each product taken as lo hi + hi lo
//   + hi hi (flash_wgmma.cuh), within ATTN_BWD_TOL[f32] where one TF32
//   product is ~20x past it.  TF32 wgmma reads both operands K-major from
//   shared memory, split: the dkv block would hold K and V hi and lo (128
//   KB at D = 128) and, a q tile, Q, dO and their transposes hi and lo (8
//   tiles), which does not fit 227 KB at any useful tile.  So the grids
//   are simt's (the same blocks, walks, passes and workspaces, L2 in log2
//   units) on mma.sync m16n8k8 TF32, four warps of 16 rows (dq) or keys
//   (dkv), rows padded by 4 in shared memory so that every fragment load
//   reads 32 banks once, each fragment split as it is read, but for the
//   dkv grid's streamed 16-row tiles of Q and dO, which the block splits
//   once as it loads them (load_split) and its warps read as hi and lo
//   (the dkv grid 1.92 -> 1.78 ms at row 3h; the dq grid's 32-key K and V
//   tiles split so would leave two blocks an SM only at 16 keys, which
//   read 2.08 -> 2.30-2.38 ms: chip_smoke.py --only f32 in turns with the
//   tree before, PERF.md); S and dP, and S^T and dP^T, from A B^T fragments, a tile's
//   two in one loop (abt2_tf32); dQ, dV and dK with the score fragment as
//   A as it lies, its B rows taken in the order 0 2 4 6 1 3 5 7 (pv_tf32);
//   dq 32-key tiles, dkv 16-row q tiles; two blocks an SM (101,376 and
//   101,504 bytes at D = 128); each tile sum
//   of dQ, dV and dK added to the accumulators by f32 adds (pv_tf32: the
//   tensor core's accumulation alone moved dV past the limit over the
//   4,096 rows a key takes at the training shape).  The row 3h reading
//   and the splits it was chosen over (an earlier testing/flash_probe.py) are
//   in PERF.md.
// * simt (f32 and bf16 at D = 16 and 32, and what the tensor-core kernels
//   do not take: unaligned views): the first port's kernels, unchanged but for the
//   D = 96 instances (f32 phi3-mini: 12 accumulator columns a thread; the
//   dkv block takes 91,648 bytes of shared memory).  CUDA-core f32 FMAs;
//   32-key tiles staged through shared memory in f32; a thread holds a
//   4 x 4 block of scores and 4 rows of D / 8 accumulator columns (128
//   threads, 16 rows by 8 columns).
//     flash_bwd_dq_kernel   one block a (b, q head, 64-row q tile): a first
//                           pass of m, l and rowsum(P dP), a second of dq
//                           += dS k, the key tiles in order;
//     flash_bwd_dkv_kernel  one block a (b, kv head, 64-key tile), the G
//                           query heads in order, then their 32-row q
//                           tiles: dv += P^T do, dk += dS^T q.
//   Its workspaces hold L in natural log units, rows of S.

#include "flash_wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// simt: f32 or bf16, D = 16, 32, 64, 96 or 128
// ---------------------------------------------------------------------------

constexpr int NT = 128;                  // 16 thread rows x 8 thread columns
constexpr int TR = 16, TC = 8;
constexpr int BQ = 64, BK = 32;          // dq kernel: q rows, keys of a tile
constexpr int BKV = 64, BQ2 = 32;        // dkv kernel: keys, q rows of a tile
#define POS_INF __int_as_float(0x7f800000)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);         // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ void unpack(const uint4& r, float* dst, float) {
    const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = f[i];
}
__device__ __forceinline__ void unpack(const uint4& r, float* dst, __nv_bfloat16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
    }
}

// rows x D values from global memory (row stride `rs`) into shared memory
// (row stride `ld`), converted to f32; rows at or past `valid` read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long rs,
                                          int rows, int valid) {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int RC = D / EPC;                    // 16-byte chunks a row
    for (int c = threadIdx.x; c < rows * RC; c += NT) {
        const int r = c / RC, d = (c % RC) * EPC;
        float* o = dst + r * ld + d;
        if (r < valid) {
            const uint4 u = *reinterpret_cast<const uint4*>(src + r * rs + d);
            float f[EPC];
            unpack(u, f, T{});
#pragma unroll
            for (int i = 0; i < EPC; ++i) o[i] = f[i];
        } else {
#pragma unroll
            for (int i = 0; i < EPC; ++i) o[i] = 0.f;
        }
    }
}

__device__ __forceinline__ bool visible(int i, int j, int S, int Sk, int causal, int window) {
    return i < S && j < Sk && (!causal || i >= j) && (window <= 0 || i - j < window);
}

// a[r][c] = sum_d X[xr_r][d] Y[yr_c][d] for the thread's 4 x 4 block: rows
// x0 + r * TR of X, rows y0 + c * TC of Y (both padded to ld = D + 1)
template <int D>
__device__ __forceinline__ void dots(float (&a)[4][4], const float* X, int x0, const float* Y,
                                     int y0) {
    constexpr int LD = D + 1;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
        float x[4], y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = X[(x0 + r * TR) * LD + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = Y[(y0 + c * TC) * LD + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) a[r][c] = fmaf(x[r], y[c], a[r][c]);
    }
}

// the sum over the TC threads of a row: neighbouring lanes of one warp
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
    for (int o = 1; o < TC; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
    for (int o = 1; o < TC; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

struct Strides {
    long long q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ lse,
                    float* __restrict__ dd, int Hq, int Hkv, int S, int Sk, int causal,
                    int window, const Strides st, float scale) {
    constexpr int LD = D + 1, LP = BK + 1, DJ = D / TC;
    extern __shared__ float smem[];
    float* Qs = smem;                              // [BQ][LD]
    float* Os = Qs + BQ * LD;                      // [BQ][LD]  do
    float* Ks = Os + BQ * LD;                      // [BK][LD]
    float* Vs = Ks + BK * LD;                      // [BK][LD]
    float* Ps = Vs + BK * LD;                      // [BQ][LP]  dS

    const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
    const int q0 = blockIdx.y * BQ;
    const int tid = threadIdx.x, tx = tid % TC, ty = tid / TC;
    const T* kb = k + b * st.k[0] + hk * st.k[1];
    const T* vb = v + b * st.v[0] + hk * st.v[1];
    load_tile<T, D>(Qs, LD, q + b * st.q[0] + h * st.q[1] + q0 * st.q[2], st.q[2], BQ, S - q0);
    load_tile<T, D>(Os, LD, dout + b * st.dout[0] + h * st.dout[1] + q0 * st.dout[2],
                    st.dout[2], BQ, S - q0);

    int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;

    // pass 1: m, l and rowsum(P dP) of each row, online over the key tiles
    float m[4], l[4], pd[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
        pd[r] = 0.f;
    }
    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        __syncthreads();                           // the previous tile is consumed
        load_tile<T, D>(Ks, LD, kb + k0 * st.k[2], st.k[2], BK, Sk - k0);
        load_tile<T, D>(Vs, LD, vb + k0 * st.v[2], st.v[2], BK, Sk - k0);
        __syncthreads();
        float s[4][4], dp[4][4];
        dots<D>(s, Qs, ty, Ks, tx);
        dots<D>(dp, Os, ty, Vs, tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = q0 + ty + r * TR;
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const bool vis = visible(i, k0 + tx + c * TC, S, Sk, causal, window);
                s[r][c] = vis ? s[r][c] * scale : NEG_INF;
                mx = fmaxf(mx, s[r][c]);
            }
            const float m_new = fmaxf(m[r], row_max(mx));
            float sum = 0.f, sum_pd = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float p = s[r][c] > 0.5f * NEG_INF ? expf(s[r][c] - m_new) : 0.f;
                sum += p;
                sum_pd = fmaf(p, dp[r][c], sum_pd);
            }
            const float alpha = expf(m[r] - m_new);
            l[r] = l[r] * alpha + row_sum(sum);
            pd[r] = pd[r] * alpha + row_sum(sum_pd);
            m[r] = m_new;
        }
    }
    float L[4], Dd[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        L[r] = l[r] > 0.f ? m[r] + logf(l[r]) : POS_INF;
        Dd[r] = l[r] > 0.f ? pd[r] / l[r] : 0.f;
        const int i = q0 + ty + r * TR;
        if (tx == 0 && i < S) {
            const long long row = static_cast<long long>(bh) * S + i;
            lse[row] = L[r];
            dd[row] = Dd[r];
        }
    }

    // pass 2: dq = sum over key tiles of dS k, in tile order
    float acc[4][DJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DJ; ++c) acc[r][c] = 0.f;
    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        __syncthreads();
        load_tile<T, D>(Ks, LD, kb + k0 * st.k[2], st.k[2], BK, Sk - k0);
        load_tile<T, D>(Vs, LD, vb + k0 * st.v[2], st.v[2], BK, Sk - k0);
        __syncthreads();
        float s[4][4], dp[4][4];
        dots<D>(s, Qs, ty, Ks, tx);
        dots<D>(dp, Os, ty, Vs, tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = q0 + ty + r * TR;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const bool vis = visible(i, k0 + tx + c * TC, S, Sk, causal, window);
                const float p = vis ? expf(s[r][c] * scale - L[r]) : 0.f;
                Ps[(ty + r * TR) * LP + tx + c * TC] = p * (dp[r][c] - Dd[r]);
            }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            float ds[4], kk[DJ];
#pragma unroll
            for (int r = 0; r < 4; ++r) ds[r] = Ps[(ty + r * TR) * LP + j];
#pragma unroll
            for (int c = 0; c < DJ; ++c) kk[c] = Ks[j * LD + tx + c * TC];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < DJ; ++c) acc[r][c] = fmaf(ds[r], kk[c], acc[r][c]);
        }
    }
    T* ob = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + r * TR;
        if (i >= S) continue;
#pragma unroll
        for (int c = 0; c < DJ; ++c) ob[i * st.dq[2] + tx + c * TC] = from_f32<T>(acc[r][c] * scale);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                     const float* __restrict__ lse, const float* __restrict__ dd, int Hq,
                     int Hkv, int S, int Sk, int causal, int window, const Strides st,
                     float scale) {
    constexpr int LD = D + 1, LP = BQ2 + 1, DJ = D / TC;
    extern __shared__ float smem[];
    float* Ks = smem;                              // [BKV][LD]
    float* Vs = Ks + BKV * LD;                     // [BKV][LD]
    float* Qs = Vs + BKV * LD;                     // [BQ2][LD]
    float* Os = Qs + BQ2 * LD;                     // [BQ2][LD]  do
    float* Pt = Os + BQ2 * LD;                     // [BKV][LP]  P^T
    float* St = Pt + BKV * LP;                     // [BKV][LP]  dS^T
    float* Ls = St + BKV * LP;                     // [BQ2]
    float* Ds = Ls + BQ2;                          // [BQ2]

    const int bh = blockIdx.x, b = bh / Hkv, hk = bh % Hkv, G = Hq / Hkv;
    const int k0 = blockIdx.y * BKV;
    const int tid = threadIdx.x, tx = tid % TC, ty = tid / TC;
    load_tile<T, D>(Ks, LD, k + b * st.k[0] + hk * st.k[1] + k0 * st.k[2], st.k[2], BKV, Sk - k0);
    load_tile<T, D>(Vs, LD, v + b * st.v[0] + hk * st.v[1] + k0 * st.v[2], st.v[2], BKV, Sk - k0);

    // the q rows that see a key of this tile: from the diagonal (causal) to
    // the window's far edge
    const int q_lo = causal ? (k0 / BQ2) * BQ2 : 0;
    const int q_hi = window > 0 ? min(S, k0 + BKV - 1 + window) : S;

    float gk[4][DJ], gv[4][DJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DJ; ++c) {
            gk[r][c] = 0.f;
            gv[r][c] = 0.f;
        }
    for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        const T* qb = q + b * st.q[0] + h * st.q[1];
        const T* ob = dout + b * st.dout[0] + h * st.dout[1];
        const long long rows = static_cast<long long>(b * Hq + h) * S;
        for (int q0 = q_lo; q0 < q_hi; q0 += BQ2) {
            __syncthreads();                       // the previous tile is consumed
            load_tile<T, D>(Qs, LD, qb + q0 * st.q[2], st.q[2], BQ2, S - q0);
            load_tile<T, D>(Os, LD, ob + q0 * st.dout[2], st.dout[2], BQ2, S - q0);
            if (tid < BQ2) {
                const bool in = q0 + tid < S;
                Ls[tid] = in ? lse[rows + q0 + tid] : POS_INF;
                Ds[tid] = in ? dd[rows + q0 + tid] : 0.f;
            }
            __syncthreads();
            float s[4][4], dp[4][4];
            dots<D>(s, Ks, ty, Qs, tx);            // s[r][c]: key ty + 16 r, row tx + 8 c
            dots<D>(dp, Vs, ty, Os, tx);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int j = k0 + ty + r * TR;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int ii = tx + c * TC;
                    const bool vis = visible(q0 + ii, j, S, Sk, causal, window);
                    const float p = vis ? expf(s[r][c] * scale - Ls[ii]) : 0.f;
                    Pt[(ty + r * TR) * LP + ii] = p;
                    St[(ty + r * TR) * LP + ii] = p * (dp[r][c] - Ds[ii]);
                }
            }
            __syncthreads();
#pragma unroll 4
            for (int i = 0; i < BQ2; ++i) {
                float p[4], ds[4], qq[DJ], oo[DJ];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    p[r] = Pt[(ty + r * TR) * LP + i];
                    ds[r] = St[(ty + r * TR) * LP + i];
                }
#pragma unroll
                for (int c = 0; c < DJ; ++c) {
                    qq[c] = Qs[i * LD + tx + c * TC];
                    oo[c] = Os[i * LD + tx + c * TC];
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < DJ; ++c) {
                        gv[r][c] = fmaf(p[r], oo[c], gv[r][c]);
                        gk[r][c] = fmaf(ds[r], qq[c], gk[r][c]);
                    }
            }
        }
    }
    T* kout = dk + b * st.dk[0] + hk * st.dk[1];
    T* vout = dv + b * st.dv[0] + hk * st.dv[1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int j = k0 + ty + r * TR;
        if (j >= Sk) continue;
#pragma unroll
        for (int c = 0; c < DJ; ++c) {
            kout[j * st.dk[2] + tx + c * TC] = from_f32<T>(gk[r][c] * scale);
            vout[j * st.dv[2] + tx + c * TC] = from_f32<T>(gv[r][c]);
        }
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* lse, float* dd, int B, int Hq, int Hkv, int S, int Sk, int causal,
           int window, const Strides& st, cudaStream_t s) {
    constexpr int LD = D + 1;
    constexpr size_t smem_dq = sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * (BK + 1));
    constexpr size_t smem_dkv =
        sizeof(float) * (2 * BKV * LD + 2 * BQ2 * LD + 2 * BKV * (BQ2 + 1) + 2 * BQ2);
    static bool opted_in[64] = {};             // above 48 KB only after this, per device
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
        return static_cast<int>(cudaErrorInvalidDevice);
    if (!opted_in[dev]) {
        cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem_dq));
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem_dkv));
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in[dev] = true;
    }
    const float scale = 1.0f / sqrtf(static_cast<float>(D));
    const T* pq = static_cast<const T*>(q);
    const T* pk = static_cast<const T*>(k);
    const T* pv = static_cast<const T*>(v);
    const T* po = static_cast<const T*>(dout);
    flash_bwd_dq_kernel<T, D><<<dim3(B * Hq, (S + BQ - 1) / BQ), NT, smem_dq, s>>>(
        pq, pk, pv, po, static_cast<T*>(dq), lse, dd, Hq, Hkv, S, Sk, causal, window, st, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkv_kernel<T, D><<<dim3(B * Hkv, (Sk + BKV - 1) / BKV), NT, smem_dkv, s>>>(
        pq, pk, pv, po, static_cast<T*>(dk), static_cast<T*>(dv), lse, dd, Hq, Hkv, S, Sk,
        causal, window, st, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, float* lse, float* dd, int B, int Hq, int Hkv, int S, int Sk, int D,
             int causal, int window, const Strides& st, cudaStream_t s) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, dout, dq, dk, dv, lse, dd, B, Hq, Hkv, S, Sk,
                                      causal, window, st, s);
        case 32: return launch<T, 32>(q, k, v, dout, dq, dk, dv, lse, dd, B, Hq, Hkv, S, Sk,
                                      causal, window, st, s);
        case 64: return launch<T, 64>(q, k, v, dout, dq, dk, dv, lse, dd, B, Hq, Hkv, S, Sk,
                                      causal, window, st, s);
        case 96: return launch<T, 96>(q, k, v, dout, dq, dk, dv, lse, dd, B, Hq, Hkv, S, Sk,
                                      causal, window, st, s);
        case 128: return launch<T, 128>(q, k, v, dout, dq, dk, dv, lse, dd, B, Hq, Hkv, S, Sk,
                                        causal, window, st, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// wgmma: bf16, D = 64, 96 or 128 (the products and PTX helpers:
// flash_wgmma.cuh)
// ---------------------------------------------------------------------------

namespace bw {
constexpr int BQ = 64, BK = 64;        // q rows and keys of a tile
constexpr int STAGES = 2;
constexpr int THREADS = 160;           // a consumer warpgroup and a producer warp
template <int D> struct Smem {
    static constexpr int TILE = ROW_BOXES<D> * wg::BOX;   // 64 rows of D bf16
    // dq: Q and dO; dkv: K and V; loaded once
    static constexpr int FIXED = 2 * TILE;
    // dq: K and V; dkv: Q and dO
    static constexpr int STAGE = 2 * TILE;
    // dkv: a stage's 64 L2 and 64 Dd (f32), after the stages
    static constexpr int ROWS = 2 * BQ * 4;
    static constexpr int BYTES = FIXED + STAGES * (STAGE + ROWS) + (2 * STAGES + 1) * 8 + 1024;
};
}  // namespace bw

// pass 2 of the dq kernel on a tile's S (sc) and dP fragments: P = 2^(s sl2
// - L2) (0 where masked, and on a row with no visible key, whose L2 is +inf),
// and dS = P (dP - Dd) left in sc
template <int N>
__device__ __forceinline__ void ds_rows(float (&sc)[N], const float (&dp)[N],
                                        const float (&L2)[2], const float (&Dd)[2], bool masked,
                                        int r0, int kc, int Sk, int causal, int window,
                                        float sl2) {
    if (masked) mask_scores(sc, r0, kc, Sk, causal, window);
#pragma unroll
    for (int x = 0; x < N; ++x) {
        const int r = (x >> 1) & 1;
        sc[x] = ex2(fmaf(sc[x], sl2, -L2[r])) * (dp[x] - Dd[r]);
    }
}

// The dkv kernel's S^T fragment with every pair the masks hide set to
// NEG_INF: st[4i + e] pairs key j0 + 8 (e >> 1) with q row qc + 8 i + (e &
// 1) (qc = q0 + 2 tig); the row is seen when it is < S, >= the key
// (causal) and < key + window, and the key when it is < Sk.
template <int N>
__device__ __forceinline__ void mask_pairs_t(float (&st)[N], int j0, int qc, int S, int Sk,
                                             int causal, int window) {
    // key r is seen by q rows qc + lo[r] .. qc + hi[r]
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int j = j0 + 8 * r;
        lo[r] = causal ? j - qc : -qc;
        hi[r] = S - 1 - qc;
        if (window > 0) hi[r] = min(hi[r], j + window - 1 - qc);
        if (j >= Sk) hi[r] = lo[r] - 1;
    }
#pragma unroll
    for (int x = 0; x < N; ++x) {
        const int c = 8 * (x >> 2) + (x & 1), r = (x >> 1) & 1;
        if (c < lo[r] || c > hi[r]) st[x] = NEG_INF;
    }
}

// Shared memory of a block (both kernels): the fixed tiles, the ring's
// stages, the stages' rows, the barriers; TMA's 128-byte swizzle wants each
// box 1024-byte aligned
struct Ring {
    unsigned char* fixed;
    unsigned char* ring;
    float* rows;
    uint64_t* full;
    uint64_t* empty;
    uint64_t* fixed_bar;
};

template <int D> __device__ __forceinline__ Ring carve(unsigned char* raw) {
    using L = bw::Smem<D>;
    Ring r;
    r.fixed = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    r.ring = r.fixed + L::FIXED;
    r.rows = reinterpret_cast<float*>(r.ring + bw::STAGES * L::STAGE);
    r.full = reinterpret_cast<uint64_t*>(r.ring + bw::STAGES * (L::STAGE + L::ROWS));
    r.empty = r.full + bw::STAGES;
    r.fixed_bar = r.empty + bw::STAGES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < bw::STAGES; ++s) {
            mbar_init(&r.full[s], 1);      // the producer's expect_tx
            mbar_init(&r.empty[s], 4);     // each consumer warp, once the stage is read
        }
        mbar_init(r.fixed_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    return r;
}

// the 64 x D f32 fragment acc (o[4i + e]: row r0 + 8 (e >> 1), column 8 i +
// 2 tig + (e & 1)) times `scale` into rows r0 and r0 + 8 of a bf16 (rows, D)
// tile by row stride `rs`, rows at or past `valid` skipped; zeros where
// nothing was accumulated.  Only D columns: the fragment's columns past D
// (D = 96: 96-127, zero) would land on the next head's in the model's
// (B, S, H, D) layout
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long rs,
                                           const float (&acc)[ROW_COLS<D> / 2],
                                           int r0, int valid, int tig, float scale, bool any) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= valid) continue;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            const float x0 = any ? acc[4 * i + 2 * r] * scale : 0.f;
            const float x1 = any ? acc[4 * i + 2 * r + 1] * scale : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(out + row * rs + 8 * i + 2 * tig) =
                __floats2bfloat162_rn(x0, x1);
        }
    }
}

// Cycle stamps of the stats grids' consumers (thread 0 of each block, 32
// slots a block: the dq grid's from 0, the dkv grid's from 1 << 20), read
// by repro_flash_cycles; compiled only with -DFLASH_CYCLES
// (testing/flash_probe.py --cross), so the library the port loads has none
#ifdef FLASH_CYCLES
__device__ long long flash_cycles[1 << 21];
#define BSTAMP(grid, slot)                                                                    \
    if (STATS && threadIdx.x == 0)                                                           \
        flash_cycles[(grid) * (1 << 20) +                                                    \
                     (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * 32 +    \
                     (slot)] = clock64()
#else
#define BSTAMP(grid, slot)
#endif

// pos: where each tensor map keeps its h, s and b dims (encode_bhsd), of q,
// k, v and do in turn
struct MapPos {
    int q, k, v, o;
};

// STATS (the stats backward): L2 and Dd come in through lse and dd (the
// wgmma forward's L2, written under autograd; Dd from flash_bwd_dd_kernel), so the K/V tiles are walked
// once (4 products a tile pair, not 6), and the blocks run in kv-head order
// (the forward's ws_block_order at 64-row tiles: a kv head's blocks
// consecutive, so the K/V set they stream stays in L2)
template <bool STATS, int D>
__global__ void __launch_bounds__(bw::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, bf16* __restrict__ dq,
                          long long dq_sb, long long dq_sh, long long dq_ss,
                          float* __restrict__ lse, float* __restrict__ dd, int Sp, int Hq,
                          int Hkv, int S, int Sk, int causal, int window, float sl2,
                          float scale, const MapPos pos) {
    constexpr int BQ = bw::BQ, BK = bw::BK, STAGES = bw::STAGES, BOX = wg::BOX;
    using L = bw::Smem<D>;
    extern __shared__ unsigned char raw[];
    const Ring sm = carve<D>(raw);

    int b, h, q0;                         // the longest walks first
    if (STATS) {
        const int G = Hq / Hkv, T = Sp / BQ;
        const int bhk = blockIdx.x / (G * T), inner = blockIdx.x % (G * T);
        b = bhk / Hkv;
        h = (bhk % Hkv) * G + inner / T;
        q0 = (T - 1 - inner % T) * BQ;
    } else {
        b = blockIdx.x / Hq;
        h = blockIdx.x % Hq;
        q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    }
    const int bh = b * Hq + h, hk = h / (Hq / Hkv);
    // the forward's walk (kernels/flash_attention.py::tile_plan)
    int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
    const int tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

    if (threadIdx.x >= 128) {             // the producer warp: Q and dO, then
        if (threadIdx.x == 128 && tiles > 0) {   // the K/V tiles twice (STATS: once)
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
            mbar_expect_tx(sm.fixed_bar, L::FIXED);
            for (int x = 0; x < ROW_BOXES<D>; ++x) {
                tma_rows(sm.fixed + x * BOX, &tq, pos.q, 64 * x, h, q0, b, sm.fixed_bar);
                tma_rows(sm.fixed + L::TILE + x * BOX, &tdo, pos.o, 64 * x, h, q0, b,
                         sm.fixed_bar);
            }
            for (int n = 0; n < (STATS ? 1 : 2) * tiles; ++n) {
                const int s = n % STAGES, k0 = k_lo + (n % tiles) * BK;
                if (n >= STAGES) mbar_wait(&sm.empty[s], ((n / STAGES) - 1) & 1);
                unsigned char* st = sm.ring + s * L::STAGE;
                mbar_expect_tx(&sm.full[s], L::STAGE);   // zero-filled bytes count too
                for (int x = 0; x < ROW_BOXES<D>; ++x) {
                    tma_rows(st + x * BOX, &tk, pos.k, 64 * x, hk, k0, b, &sm.full[s]);
                    tma_rows(st + L::TILE + x * BOX, &tv, pos.v, 64 * x, hk, k0, b,
                             &sm.full[s]);
                }
            }
        }
        return;
    }

    // the consumer warpgroup: thread (warp, g, tig) holds rows r0 and r0 + 8
    const int lt = threadIdx.x, g = (lt & 31) >> 2, tig = lt & 3;
    const int r0 = q0 + (lt / 32) * 16 + g;
    const uint32_t qs = smem_u32(sm.fixed), os = qs + L::TILE, rs = smem_u32(sm.ring);
    auto needs_mask = [&](int k0) {
        return k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
               (window > 0 && k0 < q0 + BQ - window);
    };
    float sc[32], dp[32], acc[ROW_COLS<D> / 2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f}, alpha[2];
    uint32_t hi[4][4], lo[4][4];
    if (tiles > 0) mbar_wait(sm.fixed_bar, 0);
    float L2[2], Dd[2];
    const int first = STATS ? 0 : tiles;  // the ring index of pass 2's first tile

    // pass 1: m, l and rowsum(P dP) of each row, online over the key tiles
    for (int j = 0; j < (STATS ? 0 : tiles); ++j) {
        const int s = j % STAGES, k0 = k_lo + j * BK;
        mbar_wait(&sm.full[s], (j / STAGES) & 1);
        qk_issue<D>(sc, qs, rs + s * L::STAGE);
        qk_issue<D>(dp, os, rs + s * L::STAGE + L::TILE);
        wgmma_wait<0>();
        fence_operands(sc);
        fence_operands(dp);
        if ((lt & 31) == 0) mbar_arrive(&sm.empty[s]);
        online_softmax(sc, m, l, alpha, needs_mask(k0), r0, k0 + 2 * tig, Sk, causal, window,
                       sl2);
        float t[2] = {0.f, 0.f};
#pragma unroll
        for (int x = 0; x < 32; ++x) t[(x >> 1) & 1] = fmaf(sc[x], dp[x], t[(x >> 1) & 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) pd[r] = pd[r] * alpha[r] + t[r];
    }
    // each row's L2 = L log2(e) and Dd = rowsum(P dP), from its 4 threads;
    // rows past S (the workspace's padding) read as no row: L2 = +inf, Dd = 0
    // (STATS: read as the forward and the prologue wrote them)
#pragma unroll
    for (int r = 0; r < 2 && STATS; ++r) {
        const long long row = static_cast<long long>(bh) * Sp + r0 + 8 * r;
        L2[r] = lse[row];
        Dd[r] = dd[row];
    }
#pragma unroll
    for (int r = 0; r < 2 && !STATS; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
        const int qi = r0 + 8 * r;
        L2[r] = l[r] > 0.f && qi < S ? m[r] * sl2 + log2f(l[r]) : POS_INF;
        Dd[r] = l[r] > 0.f && qi < S ? pd[r] / l[r] : 0.f;
        if (tig == 0) {
            const long long row = static_cast<long long>(bh) * Sp + qi;
            lse[row] = L2[r];
            dd[row] = Dd[r];
        }
    }

    // pass 2: dQ = sum over the key tiles of dS K, in tile order; the next
    // tile's S and dP issued with this tile's dS K, so the tensor cores run
    // them back to back, and both waited for before dS is formed (a read of
    // S while dS K is in flight makes ptxas serialise every wgmma, C7514)
    if (tiles > 0) {
        const int s = first % STAGES;
        mbar_wait(&sm.full[s], (first / STAGES) & 1);
        qk_issue<D>(sc, qs, rs + s * L::STAGE);
        qk_issue<D>(dp, os, rs + s * L::STAGE + L::TILE);
        wgmma_wait<0>();
        fence_operands(sc);
        fence_operands(dp);
        ds_rows(sc, dp, L2, Dd, needs_mask(k_lo), r0, k_lo + 2 * tig, Sk, causal, window, sl2);
        split_p(sc, hi, lo);
    }
    BSTAMP(0, 0);
    for (int j = 0; j < tiles; ++j) {
        const int n = first + j, s = n % STAGES;
        const bool next = j + 1 < tiles;
        if (next) {
            const int sn = (n + 1) % STAGES;
            mbar_wait(&sm.full[sn], ((n + 1) / STAGES) & 1);
            BSTAMP(0, 1 + 3 * min(j, 9));
            qk_issue<D>(sc, qs, rs + sn * L::STAGE);
            qk_issue<D>(dp, os, rs + sn * L::STAGE + L::TILE);
        }
        pv_issue<D>(acc, hi, lo, rs + s * L::STAGE, j == 0);     // K read MN-major
        wgmma_wait<0>();                  // this tile's dS K is done: free its stage
        BSTAMP(0, 2 + 3 * min(j, 9));
        fence_operands(sc);
        fence_operands(dp);
        fence_operands(acc);
        fence_operands(hi);
        fence_operands(lo);
        if ((lt & 31) == 0) mbar_arrive(&sm.empty[s]);
        if (next) {
            const int k0 = k_lo + (j + 1) * BK;
            ds_rows(sc, dp, L2, Dd, needs_mask(k0), r0, k0 + 2 * tig, Sk, causal, window, sl2);
            split_p(sc, hi, lo);
        }
        BSTAMP(0, 3 + 3 * min(j, 9));
    }
    store_rows<D>(dq + b * dq_sb + h * dq_sh, dq_ss, acc, r0, S, tig, scale, tiles > 0);
    BSTAMP(0, 31);
}

// STATS (the stats backward): the blocks in kv-head order, a kv head's key
// tiles consecutive, so the Q and dO of its G query heads stay in L2.  One
// block an SM at D = 128 (255 registers): bound to two blocks (204
// registers) it spilled, and a call at rows 3f/3g's shape took 9.5 ms
// against 4.3 (testing/flash_probe.py --cross)
template <bool STATS, int D>
__global__ void __launch_bounds__(bw::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, bf16* __restrict__ dk,
                           long long dk_sb, long long dk_sh, long long dk_ss,
                           bf16* __restrict__ dv, long long dv_sb, long long dv_sh,
                           long long dv_ss, const float* __restrict__ lse,
                           const float* __restrict__ dd, int Sp, int Hq, int Hkv, int S, int Sk,
                           int causal, int window, float sl2, float scale, const MapPos pos) {
    constexpr int BQ = bw::BQ, BK = bw::BK, STAGES = bw::STAGES, BOX = wg::BOX;
    using L = bw::Smem<D>;
    extern __shared__ unsigned char raw[];
    const Ring sm = carve<D>(raw);

    const int KT = (Sk + BK - 1) / BK, G = Hq / Hkv;
    const int bh = STATS ? blockIdx.x / KT : blockIdx.x, b = bh / Hkv, hk = bh % Hkv;
    // causal: the first keys, the heaviest, first
    const int k0 = (STATS ? blockIdx.x % KT : blockIdx.y) * BK;
    // the q tiles that see a key of this tile, from the diagonal (causal) to
    // the window's far edge (kernels/flash_attention.py::bwd_q_plan), for
    // each of the G query heads in turn
    const int q_lo = causal ? (k0 / BQ) * BQ : 0;
    const int q_hi = window > 0 ? min(S, k0 + BK - 1 + window) : S;
    const int per = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
    const int tiles = G * per;

    if (threadIdx.x >= 128) {             // the producer warp: K and V, then
        if (threadIdx.x == 128 && tiles > 0) {   // each q tile's Q, dO, L2, Dd
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&tdo)) : "memory");
            mbar_expect_tx(sm.fixed_bar, L::FIXED);
            for (int x = 0; x < ROW_BOXES<D>; ++x) {
                tma_rows(sm.fixed + x * BOX, &tk, pos.k, 64 * x, hk, k0, b, sm.fixed_bar);
                tma_rows(sm.fixed + L::TILE + x * BOX, &tv, pos.v, 64 * x, hk, k0, b,
                         sm.fixed_bar);
            }
            for (int n = 0; n < tiles; ++n) {
                const int s = n % STAGES, h = hk * G + n / per, q0 = q_lo + (n % per) * BQ;
                if (n >= STAGES) mbar_wait(&sm.empty[s], ((n / STAGES) - 1) & 1);
                unsigned char* st = sm.ring + s * L::STAGE;
                float* rows = sm.rows + s * 2 * BQ;
                mbar_expect_tx(&sm.full[s], L::STAGE + L::ROWS);
                for (int x = 0; x < ROW_BOXES<D>; ++x) {
                    tma_rows(st + x * BOX, &tq, pos.q, 64 * x, h, q0, b, &sm.full[s]);
                    tma_rows(st + L::TILE + x * BOX, &tdo, pos.o, 64 * x, h, q0, b,
                             &sm.full[s]);
                }
                const long long row = static_cast<long long>(b * Hq + h) * Sp + q0;
                bulk_load(rows, lse + row, BQ * 4, &sm.full[s]);
                bulk_load(rows + BQ, dd + row, BQ * 4, &sm.full[s]);
            }
        }
        return;
    }

    // the consumer warpgroup: thread (warp, g, tig) holds keys j0 and j0 + 8
    const int lt = threadIdx.x, g = (lt & 31) >> 2, tig = lt & 3;
    const int j0 = k0 + (lt / 32) * 16 + g;
    const uint32_t ks = smem_u32(sm.fixed), vs = ks + L::TILE, rs = smem_u32(sm.ring);
    float st[32], dpt[32], gk[ROW_COLS<D> / 2], gv[ROW_COLS<D> / 2];
    uint32_t hp[4][4], lp[4][4], hs[4][4], ls[4][4];
    if (tiles > 0) mbar_wait(sm.fixed_bar, 0);
    BSTAMP(1, 0);
    for (int n = 0; n < tiles; ++n) {
        const int s = n % STAGES, q0 = q_lo + (n % per) * BQ;
        mbar_wait(&sm.full[s], (n / STAGES) & 1);
        BSTAMP(1, 1 + 4 * min(n, 6));
        const uint32_t qs = rs + s * L::STAGE, os = qs + L::TILE;
        qk_issue<D>(st, ks, qs);          // S^T = K Q^T
        qk_issue<D>(dpt, vs, os);         // dP^T = V dO^T
        wgmma_wait<0>();
        BSTAMP(1, 2 + 4 * min(n, 6));
        fence_operands(st);
        fence_operands(dpt);
        if (q0 + BQ > S || k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
            (window > 0 && k0 < q0 + BQ - window))
            mask_pairs_t(st, j0, q0 + 2 * tig, S, Sk, causal, window);
        // P^T and dS^T: column 8 i + 2 tig + e of the fragment is q row q0 + it
        const float* Ls = sm.rows + s * 2 * BQ;
        const float* Ds = Ls + BQ;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float2 l2 = *reinterpret_cast<const float2*>(Ls + 8 * i + 2 * tig);
            const float2 d2 = *reinterpret_cast<const float2*>(Ds + 8 * i + 2 * tig);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int x = 4 * i + e;
                const float p = ex2(fmaf(st[x], sl2, -((e & 1) ? l2.y : l2.x)));
                dpt[x] = p * (dpt[x] - ((e & 1) ? d2.y : d2.x));
                st[x] = p;
            }
        }
        split_p(st, hp, lp);
        split_p(dpt, hs, ls);
        BSTAMP(1, 3 + 4 * min(n, 6));
        pv_issue<D>(gv, hp, lp, os, n == 0);     // dV += P^T dO, dO read MN-major
        pv_issue<D>(gk, hs, ls, qs, n == 0);     // dK += dS^T Q, Q read MN-major
        wgmma_wait<0>();                  // both done: free the stage
        BSTAMP(1, 4 + 4 * min(n, 6));
        fence_operands(gv);
        fence_operands(gk);
        fence_operands(hp);
        fence_operands(lp);
        fence_operands(hs);
        fence_operands(ls);
        if ((lt & 31) == 0) mbar_arrive(&sm.empty[s]);
    }
    store_rows<D>(dk + b * dk_sb + hk * dk_sh, dk_ss, gk, j0, Sk, tig, scale, tiles > 0);
    store_rows<D>(dv + b * dv_sb + hk * dv_sh, dv_ss, gv, j0, Sk, tig, 1.f, tiles > 0);
    BSTAMP(1, 31);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout, void* dq,
                 void* dk, void* dv, float* lse, float* dd, int B, int Hq, int Hkv, int S,
                 int Sk, int causal, int window, const Strides& st, cudaStream_t s) {
    static bool done_dq[64] = {}, done_dkv[64] = {};
    alignas(64) CUtensorMap tq, tk, tv, tdo;
    MapPos pos;
    pos.q = encode_bhsd(&tq, q, B, Hq, S, D, st.q[0], st.q[1], st.q[2], bw::BQ);
    pos.k = encode_bhsd(&tk, k, B, Hkv, Sk, D, st.k[0], st.k[1], st.k[2], bw::BK);
    pos.v = encode_bhsd(&tv, v, B, Hkv, Sk, D, st.v[0], st.v[1], st.v[2], bw::BK);
    pos.o = encode_bhsd(&tdo, dout, B, Hq, S, D, st.dout[0], st.dout[1], st.dout[2], bw::BQ);
    if (pos.q < 0 || pos.k < 0 || pos.v < 0 || pos.o < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    constexpr int bytes = bw::Smem<D>::BYTES;
    if (!allow_smem(reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<false, D>), bytes,
                    done_dq) ||
        !allow_smem(reinterpret_cast<const void*>(flash_bwd_dkv_wgmma_kernel<false, D>), bytes,
                    done_dkv))
        return static_cast<int>(cudaErrorInvalidValue);
    const int Sp = (S + bw::BQ - 1) / bw::BQ * bw::BQ;
    // the scales of the real D (96, not the 128 columns its tiles hold)
    const float sl2 = wg::LOG2E / sqrtf(static_cast<float>(D));
    const float scale = 1.0f / sqrtf(static_cast<float>(D));
    flash_bwd_dq_wgmma_kernel<false, D><<<dim3(B * Hq, Sp / bw::BQ), bw::THREADS, bytes, s>>>(
        tq, tk, tv, tdo, static_cast<bf16*>(dq), st.dq[0], st.dq[1], st.dq[2], lse, dd, Sp, Hq,
        Hkv, S, Sk, causal, window, sl2, scale, pos);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkv_wgmma_kernel<false, D><<<dim3(B * Hkv, (Sk + bw::BK - 1) / bw::BK), bw::THREADS,
                                    bytes, s>>>(
        tq, tk, tv, tdo, static_cast<bf16*>(dk), st.dk[0], st.dk[1], st.dk[2],
        static_cast<bf16*>(dv), st.dv[0], st.dv[1], st.dv[2], lse, dd, Sp, Hq, Hkv, S, Sk,
        causal, window, sl2, scale, pos);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// stats: bf16, D = 64, 96 or 128, the long key walks (bwd_variant's rule):
// L2 from the wgmma forward, Dd from its f32 output (flash_bwd_dd_kernel),
// then the wgmma kernels with STATS: one walk of the dq grid, both grids in
// kv-head order
// ---------------------------------------------------------------------------

// Dd = rowsum(dO o) of each row from the forward's f32 output o32 (B, Hq,
// S, D): a warp a row of the (B, Hq, Sp) workspace, each lane's columns in
// order, then a butterfly over the lanes (a fixed order); rows past S 0
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dd_kernel(const bf16* __restrict__ dout, long long sb, long long sh, long long ss,
                    const float* __restrict__ o32, float* __restrict__ dd, int Hq, int S,
                    int Sp, long long rows) {
    const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
    if (row >= rows) return;
    const int lane = threadIdx.x & 31, i = static_cast<int>(row % Sp);
    const long long bh = row / Sp;
    float acc = 0.f;
    if (i < S) {
        const bf16* d = dout + (bh / Hq) * sb + (bh % Hq) * sh + i * ss;
        const float* o = o32 + (bh * S + i) * D;
        for (int c = 2 * lane; c < D; c += 64) {
            const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
            const float2 ov = *reinterpret_cast<const float2*>(o + c);
            acc = fmaf(dv.x, ov.x, acc);
            acc = fmaf(dv.y, ov.y, acc);
        }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) dd[row] = acc;
}

template <int D>
int launch_stats(const void* q, const void* k, const void* v, const void* dout, void* dq,
              void* dk, void* dv, const float* lse, float* dd, const float* o32, int B, int Hq,
              int Hkv, int S, int Sk, int causal, int window, const Strides& st,
              cudaStream_t s) {
    static bool done_dq[64] = {}, done_dkv[64] = {};
    alignas(64) CUtensorMap tq, tk, tv, tdo;
    MapPos pos;
    pos.q = encode_bhsd(&tq, q, B, Hq, S, D, st.q[0], st.q[1], st.q[2], bw::BQ);
    pos.k = encode_bhsd(&tk, k, B, Hkv, Sk, D, st.k[0], st.k[1], st.k[2], bw::BK);
    pos.v = encode_bhsd(&tv, v, B, Hkv, Sk, D, st.v[0], st.v[1], st.v[2], bw::BK);
    pos.o = encode_bhsd(&tdo, dout, B, Hq, S, D, st.dout[0], st.dout[1], st.dout[2], bw::BQ);
    if (pos.q < 0 || pos.k < 0 || pos.v < 0 || pos.o < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    constexpr int bytes = bw::Smem<D>::BYTES;
    if (!allow_smem(reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<true, D>), bytes,
                    done_dq) ||
        !allow_smem(reinterpret_cast<const void*>(flash_bwd_dkv_wgmma_kernel<true, D>), bytes,
                    done_dkv))
        return static_cast<int>(cudaErrorInvalidValue);
    const int Sp = (S + bw::BQ - 1) / bw::BQ * bw::BQ;
    const long long rows = static_cast<long long>(B) * Hq * Sp;
    const long long dq_blocks = rows / bw::BQ;
    const long long dkv_blocks = static_cast<long long>(B) * Hkv * ((Sk + bw::BK - 1) / bw::BK);
    if ((rows + 7) / 8 >= (1LL << 31) || dq_blocks >= (1LL << 31) || dkv_blocks >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const float sl2 = wg::LOG2E / sqrtf(static_cast<float>(D));
    const float scale = 1.0f / sqrtf(static_cast<float>(D));
    flash_bwd_dd_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
        static_cast<const bf16*>(dout), st.dout[0], st.dout[1], st.dout[2], o32, dd, Hq, S, Sp,
        rows);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq_wgmma_kernel<true, D><<<static_cast<unsigned>(dq_blocks), bw::THREADS, bytes,
                                         s>>>(
        tq, tk, tv, tdo, static_cast<bf16*>(dq), st.dq[0], st.dq[1], st.dq[2],
        const_cast<float*>(lse), dd, Sp, Hq, Hkv, S, Sk, causal, window, sl2, scale, pos);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkv_wgmma_kernel<true, D><<<static_cast<unsigned>(dkv_blocks), bw::THREADS,
                                          bytes, s>>>(
        tq, tk, tv, tdo, static_cast<bf16*>(dk), st.dk[0], st.dk[1], st.dk[2],
        static_cast<bf16*>(dv), st.dv[0], st.dv[1], st.dv[2], lse, dd, Sp, Hq, Hkv, S, Sk,
        causal, window, sl2, scale, pos);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// tf32x3: f32, D = 64, 96 or 128 (the split and mma_tf32: flash_wgmma.cuh)
// ---------------------------------------------------------------------------

namespace t3 {
constexpr int NT = 128;                // four warps of 16 rows (dq) or keys (dkv)
constexpr int BQ = 64, BK = 32;        // dq kernel: q rows, keys of a tile
constexpr int BKV = 64, BQ2 = 16;      // dkv kernel: keys, q rows of a tile
// a row of D f32 in shared memory, padded by 4: each fragment load below
// reads 32 banks once
template <int D> constexpr int LD = D + 4;
// dq: Q and dO, each key tile's K and V, raw; dkv: K and V raw, each q
// tile's Q and dO hi and lo, its L2 and Dd
template <int D> constexpr int SMEM_DQ = 4 * LD<D> * (2 * BQ + 2 * BK);
template <int D> constexpr int SMEM_DKV = 4 * (LD<D> * (2 * BKV + 4 * BQ2) + 2 * BQ2);
}  // namespace t3

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// B elements y[0] and y[next] of a fragment as TF32 hi and lo: split here
// from raw f32, or (SPLIT) read as load_split left them, lo `lo` floats
// past hi
template <bool SPLIT>
__device__ __forceinline__ void b_pair(const float* y, int next, int lo, uint32_t& h0,
                                       uint32_t& h1, uint32_t& l0, uint32_t& l1) {
    if (SPLIT) {
        h0 = bits(y[0]);
        h1 = bits(y[next]);
        l0 = bits(y[lo]);
        l1 = bits(y[lo + next]);
    } else {
        split_tf32(y[0], h0, l0);
        split_tf32(y[next], h1, l1);
    }
}

// rows x D f32 from global memory (row stride `rs`) into shared memory as
// their TF32 halves (split_tf32), hi at `hi`, lo at `lo`, rows of LD<D>;
// rows at or past `valid` zeros.  The tile's B fragments are then read
// split: a block splits each element once, not each warp that reads it
template <int D>
__device__ __forceinline__ void load_split(float* hi, float* lo, const float* src, long long rs,
                                           int rows, int valid) {
    constexpr int LDs = t3::LD<D>;
    for (int c = threadIdx.x; c < rows * (D / 4); c += t3::NT) {
        const int r = c / (D / 4), d = (c % (D / 4)) * 4;
        const float4 x = r < valid ? *reinterpret_cast<const float4*>(src + r * rs + d)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        uint4 h, l;
        split_tf32(x.x, h.x, l.x);
        split_tf32(x.y, h.y, l.y);
        split_tf32(x.z, h.z, l.z);
        split_tf32(x.w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + r * LDs + d) = h;
        *reinterpret_cast<uint4*>(lo + r * LDs + d) = l;
    }
}

// a warp's 16 x 8 TF32 A fragment (rows g and g + 8, columns tig and tig +
// 4 of k8 step kk) of 16 rows of D f32 at stride LD<D> from x, hi and lo
template <int D>
__device__ __forceinline__ void a_frag(const float* x, int kk, int g, int tig, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
    constexpr int LDs = t3::LD<D>;
    const float* p = x + g * LDs + 8 * kk + tig;
    split_tf32(p[0], ah[0], al[0]);
    split_tf32(p[8 * LDs], ah[1], al[1]);
    split_tf32(p[4], ah[2], al[2]);
    split_tf32(p[8 * LDs + 4], ah[3], al[3]);
}

// a[4 nb + e] = X1 Y1^T and b[4 nb + e] = X2 Y2^T of a warp's 16 rows of
// X1, X2 (raw f32) and 8 NB rows of Y1, Y2 (raw, or SPLIT: hi at Y, lo `lo`
// floats on), all rows of D at stride LD<D>, over D in k8 steps, as
// accumulator fragments (row g + 8 (e >> 1), column 8 nb + 2 tig
// + (e & 1)): the two products of a tile (S and dP, or S^T and dP^T) in one
// loop, so that 2 NB chains of dependent mma.sync run side by side
template <int D, int NB, bool SPLIT>
__device__ __forceinline__ void abt2_tf32(float (&a)[4 * NB], const float* X1, const float* Y1,
                                          float (&b)[4 * NB], const float* X2, const float* Y2,
                                          int lo, int g, int tig) {
    constexpr int LDs = t3::LD<D>;
#pragma unroll
    for (int x = 0; x < 4 * NB; ++x) {
        a[x] = 0.f;
        b[x] = 0.f;
    }
    // two k steps in flight where the B halves are split here (the dq
    // grid); one where they are read split (the dkv grid, whose dK and dV
    // fragments leave no room for a second step's A fragments: 8 bytes of
    // spill at D = 128 with two)
#pragma unroll(SPLIT ? 1 : 2)
    for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t h1[4], l1[4], h2[4], l2[4];
        a_frag<D>(X1, kk, g, tig, h1, l1);
        a_frag<D>(X2, kk, g, tig, h2, l2);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            const int at = (8 * nb + g) * LDs + 8 * kk + tig;
            uint32_t bh0, bh1, bl0, bl1;
            b_pair<SPLIT>(Y1 + at, 4, lo, bh0, bh1, bl0, bl1);
            mma3_tf32(a + 4 * nb, h1, l1, bh0, bh1, bl0, bl1);
            b_pair<SPLIT>(Y2 + at, 4, lo, bh0, bh1, bl0, bl1);
            mma3_tf32(b + 4 * nb, h2, l2, bh0, bh1, bl0, bl1);
        }
    }
}

// acc += P Y: P a warp's 16 x 8 KB accumulator fragment (p[4 kb + e]: row
// g + 8 (e >> 1), column 8 kb + 2 tig + (e & 1)), Y 8 KB rows of D at
// stride LD<D> (raw, or SPLIT: hi at Y, lo `lo` floats on);
// acc[4 nd + e] row g + 8 (e >> 1), column 8 nd + 2 tig + (e & 1).  A k8 step's columns in the order 0 2 4 6 1 3 5 7, so that p's
// entries are the A fragment as they lie: B's rows 2 tig and 2 tig + 1.
// Each 8-column block's tile sum is taken in a fresh fragment and added to
// acc by an f32 add: the tensor core's own accumulation loses low bits
// at every product, which over the dkv grid's 4,096 rows a key (G x S at
// the training shape) moved dV past ATTN_BWD_TOL[f32] (limit use 1.08)
template <int D, int KB, bool SPLIT>
__device__ __forceinline__ void pv_tf32(float (&acc)[D / 2], const float (&p)[4 * KB],
                                        const float* Y, int lo, int g, int tig) {
    constexpr int LDs = t3::LD<D>;
    uint32_t ah[KB][4], al[KB][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
        split_tf32(p[4 * kb], ah[kb][0], al[kb][0]);
        split_tf32(p[4 * kb + 2], ah[kb][1], al[kb][1]);
        split_tf32(p[4 * kb + 1], ah[kb][2], al[kb][2]);
        split_tf32(p[4 * kb + 3], ah[kb][3], al[kb][3]);
    }
    const float* y = Y + 2 * tig * LDs + g;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
            uint32_t bh0, bh1, bl0, bl1;
            b_pair<SPLIT>(y + 8 * kb * LDs + 8 * nd, LDs, lo, bh0, bh1, bl0, bl1);
            mma3_tf32(t, ah[kb], al[kb], bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * nd + e] += t[e];
    }
}

// the 16 rows r0, r0 + 8 of a warp's fragment acc (D / 2 f32) times `scale`
// into a f32 (rows, D) output by row stride rs, rows at or past `valid`
// skipped
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out, long long rs, const float (&acc)[D / 2],
                                               int r0, int valid, int tig, float scale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= valid) continue;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
            *reinterpret_cast<float2*>(out + row * rs + 8 * i + 2 * tig) =
                make_float2(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
    }
}

// One block a (b, q head, 64-row q tile), the longest walks first; a warp
// its 16 rows.  Pass 1: S = Q K^T, dP = dO V^T, online m, l and rowsum(P
// dP) as the wgmma kernel's; pass 2: S, dP again, dS = P (dP - Dd), dQ +=
// dS K.  K and V tiles of 32 keys staged through shared memory by the
// block's threads (two blocks an SM: one's loads beside the other's
// products); L2 and Dd written to the workspaces (rows of S, log2 units)
template <int D>
__global__ void __launch_bounds__(t3::NT, 2)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ lse, float* __restrict__ dd,
                         int Hq, int Hkv, int S, int Sk, int causal, int window,
                         const Strides st, float sl2, float scale) {
    constexpr int LDs = t3::LD<D>, BQ = t3::BQ, BK = t3::BK, NB = t3::BK / 8;
    extern __shared__ float smem[];
    float* Qs = smem;                              // [BQ][LDs]
    float* Os = Qs + BQ * LDs;                     // [BQ][LDs]  do
    float* Ks = Os + BQ * LDs;                     // [BK][LDs]
    float* Vs = Ks + BK * LDs;                     // [BK][LDs]

    const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
    const int r0 = q0 + 16 * warp + g;
    const float* kb = k + b * st.k[0] + hk * st.k[1];
    const float* vb = v + b * st.v[0] + hk * st.v[1];
    load_tile<float, D>(Qs, LDs, q + b * st.q[0] + h * st.q[1] + q0 * st.q[2], st.q[2], BQ,
                        S - q0);
    load_tile<float, D>(Os, LDs, dout + b * st.dout[0] + h * st.dout[1] + q0 * st.dout[2],
                        st.dout[2], BQ, S - q0);
    const float* Qw = Qs + 16 * warp * LDs;
    const float* Ow = Os + 16 * warp * LDs;

    int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
    auto needs_mask = [&](int k0) {
        return k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
               (window > 0 && k0 < q0 + BQ - window);
    };

    // pass 1: m, l and rowsum(P dP) of each row, online over the key tiles
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f}, alpha[2];
    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        __syncthreads();                           // the previous tile is consumed
        load_tile<float, D>(Ks, LDs, kb + k0 * st.k[2], st.k[2], BK, Sk - k0);
        load_tile<float, D>(Vs, LDs, vb + k0 * st.v[2], st.v[2], BK, Sk - k0);
        __syncthreads();
        float s[4 * NB], dp[4 * NB];
        abt2_tf32<D, NB, false>(s, Qw, Ks, dp, Ow, Vs, 0, g, tig);
        online_softmax(s, m, l, alpha, needs_mask(k0), r0, k0 + 2 * tig, Sk, causal, window,
                       sl2);
        float t[2] = {0.f, 0.f};
#pragma unroll
        for (int x = 0; x < 4 * NB; ++x) t[(x >> 1) & 1] = fmaf(s[x], dp[x], t[(x >> 1) & 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) pd[r] = pd[r] * alpha[r] + t[r];
    }
    // each row's L2 and Dd from its 4 threads; rows past S: L2 = +inf, Dd = 0
    float L2[2], Dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
        const int qi = r0 + 8 * r;
        L2[r] = l[r] > 0.f && qi < S ? m[r] * sl2 + log2f(l[r]) : POS_INF;
        Dd[r] = l[r] > 0.f && qi < S ? pd[r] / l[r] : 0.f;
        if (tig == 0 && qi < S) {
            const long long row = static_cast<long long>(bh) * S + qi;
            lse[row] = L2[r];
            dd[row] = Dd[r];
        }
    }

    // pass 2: dQ = sum over the key tiles of dS K, in tile order
    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        __syncthreads();
        load_tile<float, D>(Ks, LDs, kb + k0 * st.k[2], st.k[2], BK, Sk - k0);
        load_tile<float, D>(Vs, LDs, vb + k0 * st.v[2], st.v[2], BK, Sk - k0);
        __syncthreads();
        float s[4 * NB], dp[4 * NB];
        abt2_tf32<D, NB, false>(s, Qw, Ks, dp, Ow, Vs, 0, g, tig);
        ds_rows(s, dp, L2, Dd, needs_mask(k0), r0, k0 + 2 * tig, Sk, causal, window, sl2);
        pv_tf32<D, NB, false>(acc, s, Ks, 0, g, tig);
    }
    store_rows_f32<D>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], acc, r0, S, tig, scale);
}

// One block a (b, kv head, 64-key tile), the first keys (causal: the
// heaviest) first; a warp its 16 keys.  For each of the G query heads in
// turn, the q tiles bwd_q_plan gives (in tiles of 16 rows, so that the dV
// and dK fragments, the split P^T and dS^T and a tile sum fit 255
// registers beside each other): S^T = K Q^T,
// dP^T = V dO^T, P^T and dS^T from each row's L2 and Dd, dV += P^T dO, dK +=
// dS^T Q
template <int D>
__global__ void __launch_bounds__(t3::NT, 2)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const float* __restrict__ lse, const float* __restrict__ dd, int Hq,
                          int Hkv, int S, int Sk, int causal, int window, const Strides st,
                          float sl2, float scale) {
    constexpr int LDs = t3::LD<D>, BKV = t3::BKV, BQ2 = t3::BQ2, NB = t3::BQ2 / 8;
    extern __shared__ float smem[];
    float* Ks = smem;                              // [BKV][LDs]
    float* Vs = Ks + BKV * LDs;                    // [BKV][LDs]
    float* Qs = Vs + BKV * LDs;                    // [BQ2][LDs]  hi, then lo
    float* Os = Qs + 2 * BQ2 * LDs;                // [BQ2][LDs]  do hi, then lo
    float* Ls = Os + 2 * BQ2 * LDs;                // [BQ2]
    float* Ds = Ls + BQ2;                          // [BQ2]
    constexpr int LO = BQ2 * LDs;                  // a tile's lo past its hi

    const int bh = blockIdx.x, b = bh / Hkv, hk = bh % Hkv, G = Hq / Hkv;
    const int k0 = blockIdx.y * BKV;
    const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
    const int j0 = k0 + 16 * warp + g;
    load_tile<float, D>(Ks, LDs, k + b * st.k[0] + hk * st.k[1] + k0 * st.k[2], st.k[2], BKV,
                        Sk - k0);
    load_tile<float, D>(Vs, LDs, v + b * st.v[0] + hk * st.v[1] + k0 * st.v[2], st.v[2], BKV,
                        Sk - k0);
    const float* Kw = Ks + 16 * warp * LDs;
    const float* Vw = Vs + 16 * warp * LDs;

    const int q_lo = causal ? (k0 / BQ2) * BQ2 : 0;
    const int q_hi = window > 0 ? min(S, k0 + BKV - 1 + window) : S;
    float gk[D / 2], gv[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) {
        gk[x] = 0.f;
        gv[x] = 0.f;
    }
    for (int gh = 0; gh < G; ++gh) {
        const int h = hk * G + gh;
        const float* qb = q + b * st.q[0] + h * st.q[1];
        const float* ob = dout + b * st.dout[0] + h * st.dout[1];
        const long long rows = static_cast<long long>(b * Hq + h) * S;
        for (int q0 = q_lo; q0 < q_hi; q0 += BQ2) {
            __syncthreads();                       // the previous tile is consumed
            load_split<D>(Qs, Qs + LO, qb + q0 * st.q[2], st.q[2], BQ2, S - q0);
            load_split<D>(Os, Os + LO, ob + q0 * st.dout[2], st.dout[2], BQ2, S - q0);
            if (threadIdx.x < BQ2) {
                const bool in = q0 + threadIdx.x < S;
                Ls[threadIdx.x] = in ? lse[rows + q0 + threadIdx.x] : POS_INF;
                Ds[threadIdx.x] = in ? dd[rows + q0 + threadIdx.x] : 0.f;
            }
            __syncthreads();
            // s[4 nb + e]: key j0 + 8 (e >> 1), q row q0 + 8 nb + 2 tig + (e & 1)
            float s[4 * NB], dpt[4 * NB];
            abt2_tf32<D, NB, true>(s, Kw, Qs, dpt, Vw, Os, LO, g, tig);
            if (q0 + BQ2 > S || k0 + BKV > Sk || (causal && k0 + BKV - 1 > q0) ||
                (window > 0 && k0 < q0 + BQ2 - window))
                mask_pairs_t(s, j0, q0 + 2 * tig, S, Sk, causal, window);
#pragma unroll
            for (int x = 0; x < 4 * NB; ++x) {
                const int c = 8 * (x >> 2) + 2 * tig + (x & 1);
                const float p = ex2(fmaf(s[x], sl2, -Ls[c]));
                dpt[x] = p * (dpt[x] - Ds[c]);
                s[x] = p;
            }
            pv_tf32<D, NB, true>(gv, s, Os, LO, g, tig);     // dV += P^T dO
            pv_tf32<D, NB, true>(gk, dpt, Qs, LO, g, tig);   // dK += dS^T Q
        }
    }
    store_rows_f32<D>(dk + b * st.dk[0] + hk * st.dk[1], st.dk[2], gk, j0, Sk, tig, scale);
    store_rows_f32<D>(dv + b * st.dv[0] + hk * st.dv[1], st.dv[2], gv, j0, Sk, tig, 1.f);
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, float* lse, float* dd, int B, int Hq, int Hkv, int S,
                int Sk, int causal, int window, const Strides& st, cudaStream_t s) {
    static bool done_dq[64] = {}, done_dkv[64] = {};
    if (!allow_smem(reinterpret_cast<const void*>(flash_bwd_dq_tf32_kernel<D>),
                    t3::SMEM_DQ<D>, done_dq) ||
        !allow_smem(reinterpret_cast<const void*>(flash_bwd_dkv_tf32_kernel<D>),
                    t3::SMEM_DKV<D>, done_dkv))
        return static_cast<int>(cudaErrorInvalidValue);
    const float sl2 = wg::LOG2E / sqrtf(static_cast<float>(D));
    const float scale = 1.0f / sqrtf(static_cast<float>(D));
    const float* pq = static_cast<const float*>(q);
    const float* pk = static_cast<const float*>(k);
    const float* pv = static_cast<const float*>(v);
    const float* po = static_cast<const float*>(dout);
    flash_bwd_dq_tf32_kernel<D><<<dim3(B * Hq, (S + t3::BQ - 1) / t3::BQ), t3::NT,
                                  t3::SMEM_DQ<D>, s>>>(
        pq, pk, pv, po, static_cast<float*>(dq), lse, dd, Hq, Hkv, S, Sk, causal, window, st,
        sl2, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkv_tf32_kernel<D><<<dim3(B * Hkv, (Sk + t3::BKV - 1) / t3::BKV), t3::NT,
                                   t3::SMEM_DKV<D>, s>>>(
        pq, pk, pv, po, static_cast<float*>(dk), static_cast<float*>(dv), lse, dd, Hq, Hkv, S,
        Sk, causal, window, st, sl2, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq (B, Hq, S, D), dk and dv (B, Hkv, Sk, D) of the forward on q, k, v for the
// output's gradient dout; lse and dd are f32 workspaces of each row's
// log-sum-exp and rowsum(P dP): B * Hq * S floats for variants 0 and 3
// (simt: natural log; tf32x3: log2 units), B * Hq * Sp for variants 1 and 2
// (wgmma, stats; log2 units, rows padded to Sp = S rounded up to 64).
// Variants 0, 1 and 3 write both (their dq kernel's first pass) and read
// them in their dkv kernel; variant
// 2 reads lse as the wgmma forward wrote it under autograd and computes dd
// from o32, that forward's f32 output (B, Hq, S, D, contiguous; null for
// the others).  strides: 21 element strides, (batch, head, row) of q, k, v,
// dout, dq, dk, dv in turn; every row 16-byte aligned with a contiguous
// last dim.  dtype 0 = float32, 1 = bfloat16; variant 0 = simt (D in {16,
// 32, 64, 96, 128}), 1 = wgmma, 2 = stats (bf16, D 64, 96 or 128), 3 =
// tf32x3 (f32, D 64, 96 or 128); window 0 = none.  Two launches (stats:
// three) on `stream`, no synchronisation.
// Returns the first launch error (0 = success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* lse, void* dd, int B, int Hq, int Hkv, int S,
                                         int Sk, int D, int causal, int window,
                                         const long long* strides, int dtype, int variant,
                                         const void* o32, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (B <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || Sk <= 0 || window < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Strides st;
    for (int i = 0; i < 3; ++i) {
        st.q[i] = strides[i];
        st.k[i] = strides[3 + i];
        st.v[i] = strides[6 + i];
        st.dout[i] = strides[9 + i];
        st.dq[i] = strides[12 + i];
        st.dk[i] = strides[15 + i];
        st.dv[i] = strides[18 + i];
    }
    float* pl = static_cast<float*>(lse);
    float* pd = static_cast<float*>(dd);
    if (variant == 2) {
        if (dtype != 1 || o32 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const float* po = static_cast<const float*>(o32);
        switch (D) {
            case 64: return launch_stats<64>(q, k, v, dout, dq, dk, dv, pl, pd, po, B, Hq, Hkv, S,
                                          Sk, causal, window, st, s);
            case 96: return launch_stats<96>(q, k, v, dout, dq, dk, dv, pl, pd, po, B, Hq, Hkv, S,
                                          Sk, causal, window, st, s);
            case 128: return launch_stats<128>(q, k, v, dout, dq, dk, dv, pl, pd, po, B, Hq, Hkv,
                                            S, Sk, causal, window, st, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (o32 != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (variant == 3) {
        if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
        switch (D) {
            case 64: return launch_tf32<64>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv, S,
                                            Sk, causal, window, st, s);
            case 96: return launch_tf32<96>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv, S,
                                            Sk, causal, window, st, s);
            case 128: return launch_tf32<128>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv,
                                              S, Sk, causal, window, st, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (variant == 1) {
        if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
        switch (D) {
            case 64: return launch_wgmma<64>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv, S,
                                             Sk, causal, window, st, s);
            case 96: return launch_wgmma<96>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv, S,
                                             Sk, causal, window, st, s);
            case 128: return launch_wgmma<128>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv,
                                               S, Sk, causal, window, st, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
        return dispatch<float>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv, S, Sk, D, causal,
                               window, st, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv, S, Sk, D,
                                       causal, window, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef FLASH_CYCLES
// the first n stamps of the last call of the cycle-stamped build, from
// slot `at` (the dkv grid's at 1 << 20)
extern "C" int repro_flash_cycles(long long* host, int n, int at) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, flash_cycles, n * sizeof(long long),
                                                 at * sizeof(long long)));
}
#endif

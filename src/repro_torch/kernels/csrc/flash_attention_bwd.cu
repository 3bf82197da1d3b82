// Causal / sliding-window GQA attention, backward: dq, dk, dv of
// csrc/flash_attention.cu's forward for the output's gradient do.  f32 math,
// each gradient in its input's dtype (bf16 or f32).
//
//   q, do, dq    (B, Hq, S, D)   by strides, last dim contiguous
//   k, v, dk, dv (B, Hkv, Sk, D) by strides, last dim contiguous
// Visibility as the forward's: key j is seen by query i when j < Sk, j <= i
// (causal) and i - j < window (window > 0); a row with no visible key has
// no gradient.
//
// The TPU kernel (repro/kernels/flash_attention.py:118) has no VJP: the
// reference trains through jnp attention (_sdpa_chunked) under jax.grad,
// whose gradient is kernels/ref.py::attention_bwd: with P the masked
// softmax of s = q k^T / sqrt(D), dv = P^T do, dP = do v^T, dS = P (dP -
// rowsum(P dP)), dq = dS k / sqrt(D), dk = dS^T q / sqrt(D); dk and dv of a
// kv head summed over its G query heads.
//
// What bounds it on an H100: at the training shapes (B = 4, 32 q heads over
// 8 kv heads of 128, S = 1024, causal) the products are ~2.2 GFLOP each and
// the bytes ~0.1 GB, so operations, far above the ridge.  This is the
// simple kernel that is right (CUDA-core f32 FMAs, FlashAttention-2's
// two-kernel split); the tensor-core (wgmma) form is later work.  It keeps
// no P or dS of a whole row in memory, and no atomics: every sum runs in a
// fixed order, so the bits do not vary between runs.
//
// * flash_bwd_dq_kernel: one block a (b, q head, 64-row q tile), over the
//   32-key tiles the forward's walk visits.  A first pass over them
//   recomputes the rows' softmax statistics online -- the max m, the sum l
//   and rowsum(P dP) (the forward keeps m and l in registers, so nothing is
//   saved from it) -- and writes L = m + log l and Dd = rowsum(P dP) for the
//   second kernel; a second pass forms P = exp(s - L), dS = P (dP - Dd) and
//   dq += dS k, the key tiles in order.  rowsum(P dP) costs one more product
//   than FlashAttention-2's rowsum(do o), and takes no rounded o.
// * flash_bwd_dkv_kernel: one block a (b, kv head, 64-key tile); it walks
//   the kv head's G query heads in order and, for each, the 32-row q tiles
//   that see the tile, forming P^T and dS^T from L and Dd and adding P^T do
//   into dv and dS^T q into dk in registers.  The GQA sum is this loop: no
//   copy of k or v per query head and no atomics.
// Thread layout of both, as the forward simt kernel: 128 threads, 16 rows
// by 8 columns; a thread holds a 4 x 4 block of scores and 4 rows of D / 8
// accumulator columns; tiles staged through shared memory in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 128;                  // 16 thread rows x 8 thread columns
constexpr int TR = 16, TC = 8;
constexpr int BQ = 64, BK = 32;          // dq kernel: q rows, keys of a tile
constexpr int BKV = 64, BQ2 = 32;        // dkv kernel: keys, q rows of a tile
constexpr float NEG_INF = -1e30f;
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
        case 128: return launch<T, 128>(q, k, v, dout, dq, dk, dv, lse, dd, B, Hq, Hkv, S, Sk,
                                        causal, window, st, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dq (B, Hq, S, D), dk and dv (B, Hkv, Sk, D) of the forward on q, k, v for the
// output's gradient dout; lse and dd are f32 workspaces of B * Hq * S floats
// (each row's log-sum-exp and rowsum(P dP), written by the first kernel and
// read by the second).  strides: 21 element strides, (batch, head, row) of
// q, k, v, dout, dq, dk, dv in turn; every row 16-byte aligned with a
// contiguous last dim.  dtype 0 = float32, 1 = bfloat16; D in {16, 32, 64,
// 128}; window 0 = none.  Two launches on `stream`, no synchronisation.
// Returns the first launch error (0 = success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* lse, void* dd, int B, int Hq, int Hkv, int S,
                                         int Sk, int D, int causal, int window,
                                         const long long* strides, int dtype, void* stream) {
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
    if (dtype == 0)
        return dispatch<float>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv, S, Sk, D, causal,
                               window, st, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, pl, pd, B, Hq, Hkv, S, Sk, D,
                                       causal, window, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Paged decode attention: out[b, h] = softmax(q[b, h] K_b^T / sqrt(D)) V_b, where
// K_b and V_b are the first lens[b] tokens of the pool blocks that tables[b]
// lists.  f32 math, output in q's dtype (bf16 or f32).
//
//   q      (B, Hkv, G, D)    one query token per sequence, G = Hq / Hkv rows
//   kpool  (Hkv, NB, bt, D)  the shared block pool (block 0 = zeros), by strides
//   vpool  (Hkv, NB, bt, D)  same strides as kpool
//   tables (B, nblk) int32   block ids per sequence, 0 = unallocated
//   lens   (B,) int32        tokens each sequence attends over
//   out    (B, Hkv, G, D)    contiguous
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (_paged_kernel): a (B, Hkv, nblk) grid whose innermost, sequential block
// axis carries the online softmax's m, l and acc in VMEM scratch while
// scalar-prefetched tables steer each step's DMA to pool block tables[b, j].
//
// Here blocks of threads run in no order, so nothing can be carried from one
// to the next: one block per (sequence, kv head) walks that sequence's table
// itself, in rounds of 64 tokens (64 / bt pool blocks), and stops at
// ceil(lens[b] / 64) rounds, which is exact because masked tokens add
// nothing.  The G query rows of a kv head share each K/V tile.  The pool is
// read in place through its strides: the model keeps it as (NB, bt, Hkv, D)
// per layer and passes a permuted view, never a copy.  Scores past lens[b]
// are masked and their p set to 0 explicitly, so a row with lens[b] == 0
// keeps l == 0 and writes zeros.
//
// What bounds it on an H100 (3.35 TB/s): each K and V element is read once
// and used for 2*G operations, so it is bound by bytes:
// sum(lens) * Hkv * D * 2 * itemsize for K and V (llama3-8b, batch 8 at
// ~225 tokens each: 7.4 MB a layer, ~2.2 us).  What the design does about
// it: cp.async copies the next round's K and V (16 bytes a thread a copy)
// into the second of two shared-memory tiles while the current round is
// computed, and every phase of a round runs without serial chains: a thread
// forms whole dot products of one token against its query rows, one warp
// per row takes the softmax, and a thread accumulates four output columns.
// It does not split a long sequence over several blocks (flash-decoding): at
// decode only B * Hkv blocks run (64 for batch 8), too few to keep enough
// bytes in flight for the card's bandwidth.  That split, and tensor-core
// math, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 128;                  // threads per block: 4 warps
constexpr int NW = NT / 32;
constexpr int TOK = 64;                  // tokens of a round
constexpr int NG = NT / TOK;             // threads per token in the score phase
constexpr int MAX_G = 32;                // query rows per kv head, at most
constexpr int GK = MAX_G / NG;           // score accumulators per thread
constexpr int MAX_QD = 4096;             // G * D, at most
constexpr int ACC4 = MAX_QD / 4 / NT;    // 4-column accumulators per thread
constexpr int SMEM_MAX = 232448;         // the H100's dynamic shared memory per block
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);         // round to nearest even, as torch's .to(bfloat16)
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of T values from shared memory, as f32
__device__ __forceinline__ void load16(const float* p, float* dst) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
    }
}
// 4 consecutive T values from shared memory, as f32
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    return make_float4(a.x, a.y, b.x, b.y);
}

// 16 bytes global -> shared, asynchronously; zeros instead when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

template <typename T>
__global__ void __launch_bounds__(NT)
paged_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
             const T* __restrict__ vpool, const int* __restrict__ tables,
             const int* __restrict__ lens, T* __restrict__ out,
             int Hkv, int G, int D, int bt, int nblk,
             long long q_sb, long long q_sh, long long q_sg,
             long long p_sh, long long p_sn, long long p_st, float scale) {
    constexpr int EPC = 16 / sizeof(T);            // elements per 16-byte copy
    const int LD = D + EPC;                        // staged row stride: 16 bytes of pad
    extern __shared__ __align__(16) unsigned char smem[];
    T* Ks = reinterpret_cast<T*>(smem);            // [2][TOK][LD] K tiles, raw
    T* Vs = Ks + 2 * TOK * LD;                     // [2][TOK][LD] V tiles, raw
    float* Qs = reinterpret_cast<float*>(Vs + 2 * TOK * LD);   // [G][D]
    float* Ps = Qs + G * D;                        // [G][TOK]: scores, then p
    float* Ms = Ps + G * TOK;                      // [G] running max
    float* Ls = Ms + G;                            // [G] running sum
    float* As = Ls + G;                            // [G] this round's rescale
    int* ids = reinterpret_cast<int*>(As + G);     // [nblk] this sequence's table

    const int b = blockIdx.x, h = blockIdx.y;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int len = min(lens[b], nblk * bt);       // the table holds nblk * bt tokens
    const int nb = (len + bt - 1) / bt;            // blocks that hold a visible token
    const int rounds = (len + TOK - 1) / TOK;
    const int GD = G * D, D4 = D / 4;

    for (int j = tid; j < nb; j += NT) ids[j] = tables[(long long)b * nblk + j];
    const T* qb = q + b * q_sb + h * q_sh;
    for (int e = tid; e < GD; e += NT) Qs[e] = to_f32(qb[(e / D) * q_sg + e % D]);
    if (tid < G) {
        Ms[tid] = NEG_INF;
        Ls[tid] = 0.f;
    }
    float4 acc[ACC4];
#pragma unroll
    for (int k = 0; k < ACC4; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    // round r's K and V into tile `st`; tokens of blocks past nb read zeros
    const int row_chunks = D / EPC;
    auto stage = [&](int r, int st) {
        for (int c = tid; c < TOK * row_chunks; c += NT) {
            const int t = c / row_chunks, d = (c % row_chunks) * EPC;
            const int tok = r * TOK + t, j = tok / bt;
            const bool in = j < nb;
            const long long off =
                in ? (long long)ids[j] * p_sn + h * p_sh + (tok % bt) * p_st + d : 0;
            cp_async16(Ks + (st * TOK + t) * LD + d, kpool + off, in);
            cp_async16(Vs + (st * TOK + t) * LD + d, vpool + off, in);
        }
        cp_async_commit();
    };

    if (rounds > 0) stage(0, 0);
    for (int r = 0; r < rounds; ++r) {
        const int st = r & 1;
        if (r + 1 < rounds) {
            stage(r + 1, st ^ 1);
            cp_async_wait<1>();                    // round r's copies have landed
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* Kr = Ks + st * TOK * LD;
        const T* Vr = Vs + st * TOK * LD;
        const int t0 = r * TOK;

        // scores: thread (t, gh) forms token t's dot products with rows
        // g = gh, gh + NG, ...
        {
            const int t = tid % TOK, gh = tid / TOK;
            float s[GK];
#pragma unroll
            for (int k = 0; k < GK; ++k) s[k] = 0.f;
            for (int d = 0; d < D; d += EPC) {
                float kf[EPC];
                load16(Kr + t * LD + d, kf);
#pragma unroll
                for (int k = 0; k < GK; ++k) {
                    const int g = gh + k * NG;
                    if (g < G) {
#pragma unroll
                        for (int i = 0; i < EPC; i += 4) {
                            const float4 qv = load4(Qs + g * D + d + i);
                            s[k] = fmaf(qv.x, kf[i], s[k]);
                            s[k] = fmaf(qv.y, kf[i + 1], s[k]);
                            s[k] = fmaf(qv.z, kf[i + 2], s[k]);
                            s[k] = fmaf(qv.w, kf[i + 3], s[k]);
                        }
                    }
                }
            }
            const bool vis = t0 + t < len;
#pragma unroll
            for (int k = 0; k < GK; ++k) {
                const int g = gh + k * NG;
                if (g < G) Ps[g * TOK + t] = vis ? s[k] * scale : NEG_INF;
            }
        }
        __syncthreads();

        // online softmax: one warp per row, two tokens a lane
        for (int g = warp; g < G; g += NW) {
            float* pr = Ps + g * TOK;
            const float x0 = pr[lane], x1 = pr[lane + 32];
            const float m_prev = Ms[g], m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
            // masked explicitly: exp(NEG_INF - m_new) is 1, not 0, when every
            // score so far is masked
            const float p0 = (t0 + lane < len) ? expf(x0 - m_new) : 0.f;
            const float p1 = (t0 + lane + 32 < len) ? expf(x1 - m_new) : 0.f;
            pr[lane] = p0;
            pr[lane + 32] = p1;
            const float sum = warp_sum(p0 + p1);
            if (lane == 0) {
                const float a = expf(m_prev - m_new);
                As[g] = a;
                Ls[g] = Ls[g] * a + sum;
                Ms[g] = m_new;
            }
        }
        __syncthreads();

        // acc[g][d..d+3] = acc * alpha + sum_t p[g][t] * V[t][d..d+3]
#pragma unroll
        for (int k = 0; k < ACC4; ++k) {
            const int e = tid + k * NT;
            if (e < G * D4) {
                const int g = e / D4, d = (e % D4) * 4;
                const float a = As[g];
                float4 o = make_float4(acc[k].x * a, acc[k].y * a, acc[k].z * a, acc[k].w * a);
                const float* pr = Ps + g * TOK;
#pragma unroll 8
                for (int t = 0; t < TOK; ++t) {
                    const float p = pr[t];
                    const float4 v = load4(Vr + t * LD + d);
                    o.x = fmaf(p, v.x, o.x);
                    o.y = fmaf(p, v.y, o.y);
                    o.z = fmaf(p, v.z, o.z);
                    o.w = fmaf(p, v.w, o.w);
                }
                acc[k] = o;
            }
        }
        __syncthreads();                 // the next round's copies overwrite this tile
    }

    T* ob = out + ((long long)b * Hkv + h) * GD;
#pragma unroll
    for (int k = 0; k < ACC4; ++k) {
        const int e = tid + k * NT;
        if (e < G * D4) {
            const int g = e / D4, d = (e % D4) * 4;
            const float l = Ls[g], inv = l == 0.f ? 0.f : 1.f / l;
            ob[g * D + d] = from_f32<T>(acc[k].x * inv);
            ob[g * D + d + 1] = from_f32<T>(acc[k].y * inv);
            ob[g * D + d + 2] = from_f32<T>(acc[k].z * inv);
            ob[g * D + d + 3] = from_f32<T>(acc[k].w * inv);
        }
    }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lens, void* out, int B, int Hkv, int G, int D, int bt, int nblk,
           long long q_sb, long long q_sh, long long q_sg, long long p_sh,
           long long p_sn, long long p_st, cudaStream_t s) {
    static bool opted_in = false;              // above 48 KB only after this
    if (!opted_in) {
        const cudaError_t e = cudaFuncSetAttribute(
            paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in = true;
    }
    const size_t LD = D + 16 / sizeof(T);
    const size_t smem = 4 * TOK * LD * sizeof(T)
        + sizeof(float) * ((size_t)G * D + (size_t)G * TOK + 3 * G) + sizeof(int) * nblk;
    const dim3 grid(B, Hkv);
    paged_kernel<T><<<grid, NT, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
        tables, lens, static_cast<T*>(out), Hkv, G, D, bt, nblk, q_sb, q_sh, q_sg,
        p_sh, p_sn, p_st, 1.0f / sqrtf((float)D));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim of
// q and of the pools is contiguous, and out is contiguous.  The caller checks
// the limits (bt divides 64, G <= 32, G * D <= 4096, D a multiple of 8 up to
// 128, 16-byte alignment, shared memory within the card's 227 KB).  The
// launch goes on `stream` and does not synchronise.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int repro_paged_attention(const void* q, const void* kpool, const void* vpool,
                                     const void* tables, const void* lens, void* out,
                                     int B, int Hkv, int G, int D, int bt, int nblk,
                                     long long q_sb, long long q_sh, long long q_sg,
                                     long long p_sh, long long p_sn, long long p_st,
                                     int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* t = static_cast<const int*>(tables);
    const int* l = static_cast<const int*>(lens);
    if (dtype == 0)
        return launch<float>(q, kpool, vpool, t, l, out, B, Hkv, G, D, bt, nblk,
                             q_sb, q_sh, q_sg, p_sh, p_sn, p_st, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, kpool, vpool, t, l, out, B, Hkv, G, D, bt, nblk,
                                     q_sb, q_sh, q_sg, p_sh, p_sn, p_st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

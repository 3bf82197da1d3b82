// Causal / sliding-window GQA attention, forward: out[b, h] = softmax(q[b, h]
// k[b, h / (Hq / Hkv)]^T / sqrt(D) + mask) v[b, h / (Hq / Hkv)].  f32 math,
// output in q's dtype (bf16 or f32).
//
//   q    (B, Hq, S, D)   by strides, last dim contiguous
//   k, v (B, Hkv, Sk, D) by strides, last dim contiguous
//   out  (B, Hq, S, D)   by strides, last dim contiguous
// Query i and key j are both counted from 0; key j is visible to query i when
// j < Sk, j <= i (causal) and i - j < window (window > 0).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel): a (B*Hq, S/bq, Sk/bk) grid whose innermost, sequential kv
// axis carries the online softmax's m, l and acc in VMEM scratch, with the
// GQA head mapping h // (Hq / Hkv) in the index maps.
//
// Here one block of threads owns one (b, h, 64-row q tile) and loops over
// the 32-key k tiles itself, from the window's lower edge up to the causal
// limit: tiles that the masks hide entirely are never loaded.  q, k, v and
// out are read and written through their strides, so the model's (B, S, H, D)
// activations are passed as transposed views, and the kv heads are never
// repeated up to Hq.  Masked scores get p = 0 explicitly, so a row with no
// visible key keeps l == 0 and writes zeros (the TPU kernel's flush assumes
// l == 0 on such rows, which holds only with that mask).
//
// What bounds it on an H100: at prefill lengths each K/V element is used by
// up to 64 query rows of a tile and 4*D operations a (q, k) pair, so it is
// bound by operations (causal S = 512, Hq = 32, D = 128: 2.2 GFLOP a layer,
// 2.2 us at the bf16 tensor-core rate of 989 TFLOP/s).  This first design
// computes on CUDA cores in f32 (67 TFLOP/s at most): each thread holds a
// 4 x 4 block of scores and a 4 x (D/8) block of the output in registers,
// with the q, k, v and p tiles staged in shared memory.  mma.sync/wgmma
// tensor-core tiles and a TMA pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BQ = 64, BK = 32;          // q rows and keys of a tile
constexpr int NT = 128;                  // 16 thread rows x 8 thread columns
constexpr int TR = 16, TC = 8;
constexpr int RI = BQ / TR;              // score and output rows per thread (4)
constexpr int CJ = BK / TC;              // score columns per thread (4)
constexpr float NEG_INF = -1e30f;

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
                                          int rows, int valid, int tid) {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int RC = D / EPC;                    // chunks per row
    for (int c = tid; c < rows * RC; c += NT) {
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Hq, int Hkv, int S, int Sk, int causal, int window,
             long long q_sb, long long q_sh, long long q_ss,
             long long k_sb, long long k_sh, long long k_ss,
             long long v_sb, long long v_sh, long long v_ss,
             long long o_sb, long long o_sh, long long o_ss, float scale) {
    constexpr int DJ = D / TC;                     // output columns per thread
    constexpr int LQ = D + 1, LK = D + 1, LP = BK + 1;   // padded: no bank conflicts
    extern __shared__ float smem[];
    float* Qs = smem;                              // [BQ][LQ]
    float* Ks = Qs + BQ * LQ;                      // [BK][LK]
    float* Vs = Ks + BK * LK;                      // [BK][D]
    float* Ps = Vs + BK * D;                       // [BQ][LP]

    const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
    const int q0 = blockIdx.y * BQ;
    const int tid = threadIdx.x, tx = tid % TC, ty = tid / TC;

    const T* kb = k + b * k_sb + hk * k_sh;
    const T* vb = v + b * v_sb + hk * v_sh;
    load_tile<T, D>(Qs, LQ, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss, BQ, S - q0, tid);

    float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    }

    // keys this tile can see: from the lowest row's window edge to the
    // highest row's causal limit
    int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;

    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        __syncthreads();                           // the previous tile is consumed
        load_tile<T, D>(Ks, LK, kb + k0 * k_ss, k_ss, BK, Sk - k0, tid);
        load_tile<T, D>(Vs, D, vb + k0 * v_ss, v_ss, BK, Sk - k0, tid);
        __syncthreads();

        float s[RI][CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            float a[RI], bb[CJ];
#pragma unroll
            for (int i = 0; i < RI; ++i) a[i] = Qs[(ty + i * TR) * LQ + d];
#pragma unroll
            for (int j = 0; j < CJ; ++j) bb[j] = Ks[(tx + j * TC) * LK + d];
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RI; ++i) {
            const int qi = q0 + ty + i * TR;
            bool vis[CJ];
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const int kj = k0 + tx + j * TC;
                vis[j] = kj < Sk && (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
                s[i][j] = vis[j] ? s[i][j] * scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
            // the TC threads of a row are neighbouring lanes of one warp
#pragma unroll
            for (int o = 1; o < TC; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const float pr = vis[j] ? expf(s[i][j] - m_new) : 0.f;
                Ps[(ty + i * TR) * LP + tx + j * TC] = pr;
                sum += pr;
            }
#pragma unroll
            for (int o = 1; o < TC; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float p[RI], vv[DJ];
#pragma unroll
            for (int i = 0; i < RI; ++i) p[i] = Ps[(ty + i * TR) * LP + kk];
#pragma unroll
            for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + j * TC];
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
        }
    }

    T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int qi = q0 + ty + i * TR;
        if (qi >= S) continue;
        const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) ob[qi * o_ss + tx + j * TC] = from_f32<T>(acc[i][j] * inv);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
           int S, int Sk, int causal, int window, const long long* st, cudaStream_t s) {
    constexpr size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
    static bool opted_in = false;              // above 48 KB only after this
    if (!opted_in) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in = true;
    }
    const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
    flash_kernel<T, D><<<grid, NT, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Hq, Hkv, S, Sk, causal, window, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], 1.0f / sqrtf((float)D));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
             int S, int Sk, int D, int causal, int window, const long long* st,
             cudaStream_t s) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, Sk, causal, window, st, s);
        case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, Sk, causal, window, st, s);
        case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, Sk, causal, window, st, s);
        case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, Sk, causal, window, st, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D is 16, 32, 64 or 128.  `strides` holds
// 12 element strides: (batch, head, seq) of q, k, v and out, in that order;
// the last dim of each is contiguous and every pointer and stride is 16-byte
// aligned (the caller checks).  window <= 0 means no window.  The launch goes
// on `stream` and does not synchronise.  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int Hq, int Hkv, int S, int Sk, int D,
                                     int causal, int window, const long long* strides,
                                     int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch<float>(q, k, v, out, B, Hq, Hkv, S, Sk, D, causal, window, strides, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, Sk, D, causal, window,
                                       strides, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

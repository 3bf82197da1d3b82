// The paper's Table I reductions: dot product, exp, row softmax.
//
// Replaces the TPU kernels of repro/kernels/reduction.py:
//  * dotprod (_dot_kernel): sum(a*b) in f32 over an (8, n/8) layout, the
//    per-row partials carried in VMEM over a sequential grid, then summed;
//  * expv (_exp_poly, _exp_kernel): exp(x) = 2^k * P(r), the input clipped
//    to +-80, k = round(x / ln2), r = x - k*ln2, a degree-6 Horner P;
//  * softmax_rows (_softmax_kernel): row softmax with the whole row resident
//    (max, exp(x - m), sum, e / d).
//
// All three are bound by bytes on an H100 (3.35 TB/s): each reads its
// inputs once and writes its output once, doing a few operations (dot: 2,
// exp: ~20, softmax: ~5) per 4-byte element against the card's ~20 f32
// operations per byte.  So each streams: coalesced loads, 16-byte vectors
// where the pointers allow it (dot and exp), enough bytes in flight to
// cover the memory's latency, 64-bit sizes and indices throughout, the
// ragged edge masked in the kernel.  At the paper's sizes (4096 elements) a
// call is a few microseconds of device time, so there the cost is the
// launch: no work a launch does not need.
//
// dot: a grid has no order on the card, so nothing carries over between
// blocks.  Each thread keeps an f32 partial over a grid-stride loop (fused
// multiply-adds, in element order), loading DOT_UNROLL 16-byte vectors of
// each operand past L1 before it multiplies them; the block reduces its
// threads' partials (warp shuffles, then shared memory, in a fixed tree).
// A segment of one block (every dotprod up to 4096 elements) writes that
// sum and is done.  In a segment of more blocks each writes its partial and
// the last block to finish (an atomic ticket) sums the block partials in a
// fixed order.  Partial sums are never added atomically, so a result is the
// same from run to run.  The grid is at most DOT_MIN_BLOCKS blocks on each
// of 132 SMs, which __launch_bounds__ makes resident at once (one wave).
// One launch a call.  A launch reduces `nseg` contiguous segments of
// `seg_len` elements at once (blockIdx.y is the segment; elements past n
// count as zeros): dotprod is one segment, dotprod_hier's C*L lanes are C*L
// segments.
//
// exp: the TPU kernel's polynomial, not expf, with its roundings made
// explicit: the clip keeps a NaN (as jnp.clip), k = rintf(x * (1/ln2)) with
// the reciprocal rounded to f32 (XLA compiles the reference's x / ln2 so)
// and round-half-even (jnp.round), r = fmaf(-k, ln2, x), six Horner fmaf
// steps on f32 coefficients, k added to the exponent (exact, ldexpf's
// bits), one rounding to the output dtype.  Never built with
// --use_fast_math.  Loads and stores are 16-byte vectors and streaming
// (evict first: the data passes through L2 once), one vector a thread and
// a block for each EXP_THREADS vectors, which the block scheduler hands
// out in address order.  On the H100 this streamed 2^28 elements faster
// than a grid of only the resident blocks walking the vectors by grid
// stride with four vectors a thread in flight.
//
// softmax: one block a row.  A row of up to RESIDENT_MAX elements is read
// once into shared memory (f32) and kept there: max, exp(x - m), sum, e / d
// as a true division, one write.  A longer row streams twice: an online
// (max, sum) pass, each thread rescaling its sum when its max grows, the
// threads' pairs merged, then a pass that reads the row again and writes
// exp(x - m) / d.  That branch moves 3 bytes for every 2 the bound counts.
// Masked (-inf) elements give 0 in both branches, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int DOT_THREADS = 256;
constexpr int DOT_MIN_BLOCKS = 8;      // blocks an SM holds: 32 registers a thread at most
constexpr int DOT_UNROLL = 2;          // 16-byte vectors of each operand a thread has in flight
constexpr int DOT_MAX_SEGS = 65535;    // segments a launch takes (gridDim.y)
constexpr int EXP_THREADS = 256;
constexpr int SOFTMAX_THREADS_RESIDENT = 512;
constexpr int SOFTMAX_THREADS_STREAM = 1024;
constexpr int64_t RESIDENT_MAX = 32768;      // f32 row elements: 128 KB of shared memory
constexpr float LN2 = 0x1.62e430p-1f;      // ln 2 rounded to f32
constexpr float INV_LN2 = 0x1.715476p+0f;  // 1 / LN2 rounded to f32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// A 16-byte vector: 4 f32 or 8 bf16 values, moved by one 128-bit access.
template <typename T> struct alignas(16) Vec16 {
    static constexpr int N = 16 / sizeof(T);
    T v[N];
};

// Reduce v over the block (blockDim.x a multiple of 32, at most 1024) and
// give every thread the result.  The tree is fixed: xor shuffles within a
// warp (commutative, so every lane holds the same value), then the warps'
// values in warp order, so the result does not depend on timing.  red
// holds 33 floats; the function ends with a barrier, so it may be reused.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v, o);
        v = MAX ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < nw ? red[lane] : (MAX ? -INFINITY : 0.f);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float w = __shfl_xor_sync(0xffffffffu, v, o);
            v = MAX ? fmaxf(v, w) : v + w;
        }
        if (lane == 0) red[32] = v;
    }
    __syncthreads();
    v = red[32];
    __syncthreads();
    return v;
}

// ---------------------------------------------------------------------------
// dot product over nseg segments
// ---------------------------------------------------------------------------

// 16 bytes of a read-only input, past L1 (each byte is read once)
__device__ __forceinline__ uint4 load16_nc(const void* p) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
}

template <typename T>
__device__ __forceinline__ Vec16<T> load16_dot(const T* p) {  // p is 16-byte aligned
    Vec16<T> v;
    *reinterpret_cast<uint4*>(&v) = load16_nc(p);
    return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(DOT_THREADS, DOT_MIN_BLOCKS)
dot_kernel(const T* __restrict__ a, const T* __restrict__ b, int64_t n, int64_t seg_len,
           unsigned int* __restrict__ tickets, float* __restrict__ block_part,
           float* __restrict__ out) {
    __shared__ float red[33];
    __shared__ bool last;
    const int64_t seg = blockIdx.y;
    const int64_t lo = seg * seg_len;
    const int64_t hi = lo + seg_len < n ? lo + seg_len : n;   // hi <= lo: all padding
    const int bps = gridDim.x;
    const int64_t stride = static_cast<int64_t>(bps) * DOT_THREADS;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * DOT_THREADS + threadIdx.x;
    float acc = 0.f;
    if (VEC) {
        // lo is a multiple of the vector width (the wrapper's segments are)
        constexpr int V = Vec16<T>::N;
        const int64_t nvec = hi > lo ? (hi - lo) / V : 0;
        const T* pa = a + lo;
        const T* pb = b + lo;
        int64_t i = first;
        // DOT_UNROLL vectors of each operand in flight, then their products
        // in element order: the thread's chain is the same as one at a time
        for (; i + (DOT_UNROLL - 1) * stride < nvec; i += DOT_UNROLL * stride) {
            Vec16<T> x[DOT_UNROLL], y[DOT_UNROLL];
#pragma unroll
            for (int u = 0; u < DOT_UNROLL; ++u) {
                x[u] = load16_dot(pa + (i + u * stride) * V);
                y[u] = load16_dot(pb + (i + u * stride) * V);
            }
#pragma unroll
            for (int u = 0; u < DOT_UNROLL; ++u)
#pragma unroll
                for (int k = 0; k < V; ++k) acc = fmaf(to_f32(x[u].v[k]), to_f32(y[u].v[k]), acc);
        }
        for (; i < nvec; i += stride) {
            const Vec16<T> x = load16_dot(pa + i * V), y = load16_dot(pb + i * V);
#pragma unroll
            for (int k = 0; k < V; ++k) acc = fmaf(to_f32(x.v[k]), to_f32(y.v[k]), acc);
        }
        const int64_t t = lo + nvec * V + first;   // the < V elements of the tail
        if (t < hi) acc = fmaf(to_f32(a[t]), to_f32(b[t]), acc);
    } else {
        for (int64_t i = lo + first; i < hi; i += stride)
            acc = fmaf(to_f32(a[i]), to_f32(b[i]), acc);
    }
    acc = block_reduce<false>(acc, red);
    if (bps == 1) {                                // the block's sum is the segment's
        if (threadIdx.x == 0) out[seg] = acc;
        return;
    }
    if (threadIdx.x == 0) {
        block_part[seg * bps + blockIdx.x] = acc;
        __threadfence();                           // the partial is visible before the ticket
        last = atomicAdd(&tickets[seg], 1u) == static_cast<unsigned>(bps - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the segment's last block: its bps partials in a fixed order (read past L1)
    float s = 0.f;
    for (int i = threadIdx.x; i < bps; i += DOT_THREADS) s += __ldcg(&block_part[seg * bps + i]);
    s = block_reduce<false>(s, red);
    if (threadIdx.x == 0) {
        out[seg] = s;
        tickets[seg] = 0;
    }
}

template <typename T>
void launch_dot(const void* a, const void* b, int64_t n, int64_t seg_len, int nseg, int bps,
                void* work, void* out, cudaStream_t s) {
    auto* tickets = static_cast<unsigned int*>(work);
    float* part = reinterpret_cast<float*>(tickets + DOT_MAX_SEGS);
    const dim3 grid(bps, nseg);
    const T* pa = static_cast<const T*>(a);
    const T* pb = static_cast<const T*>(b);
    float* po = static_cast<float*>(out);
    const bool vec = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0
                     && seg_len % Vec16<T>::N == 0;
    if (vec)
        dot_kernel<T, true><<<grid, DOT_THREADS, 0, s>>>(pa, pb, n, seg_len, tickets, part, po);
    else
        dot_kernel<T, false><<<grid, DOT_THREADS, 0, s>>>(pa, pb, n, seg_len, tickets, part, po);
}

// ---------------------------------------------------------------------------
// exp
// ---------------------------------------------------------------------------

__device__ __forceinline__ float exp_poly(float x) {
    x = x < -80.f ? -80.f : (x > 80.f ? 80.f : x);   // a NaN stays a NaN
    // x / ln2 as XLA computes it: the product by the f32 reciprocal, rounded
    // once; then round half to even
    const float k = rintf(x * INV_LN2);
    const float r = fmaf(-k, LN2, x);
    // 1/720, 1/120, 1/24, 1/6, 1/2, 1, 1 rounded to f32
    float p = 0x1.6c16c2p-10f;
    p = fmaf(p, r, 0x1.111112p-7f);
    p = fmaf(p, r, 0x1.555556p-5f);
    p = fmaf(p, r, 0x1.555556p-3f);
    p = fmaf(p, r, 0.5f);
    p = fmaf(p, r, 1.f);
    p = fmaf(p, r, 1.f);
    // 2^k * p by adding k to p's exponent: p lies in [0.7, 1.5) and |k| <=
    // 116, so the result is a normal f32 and the sum exact (ldexpf's bits);
    // a NaN's k converts to 0 and leaves the NaN
    return __int_as_float(__float_as_int(p) + __float2int_rz(k) * (1 << 23));
}

// 16 bytes loaded and stored streaming (evict first); p is 16-byte aligned
template <typename T>
__device__ __forceinline__ Vec16<T> load16_cs(const T* p) {
    Vec16<T> v;
    *reinterpret_cast<float4*>(&v) = __ldcs(reinterpret_cast<const float4*>(p));
    return v;
}

template <typename T>
__device__ __forceinline__ void store16_cs(T* p, const Vec16<T>& v) {
    __stcs(reinterpret_cast<float4*>(p), *reinterpret_cast<const float4*>(&v));
}

// One 16-byte vector a thread, neighbouring threads on neighbouring
// vectors, a block for each EXP_THREADS of them; the grid walks on by grid
// stride only past the grid's limit.
template <typename T, bool VEC>
__global__ void __launch_bounds__(EXP_THREADS)
expv_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * EXP_THREADS;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * EXP_THREADS + threadIdx.x;
    if (VEC) {
        constexpr int V = Vec16<T>::N;
        const int64_t nvec = n / V;
        for (int64_t c = first; c < nvec; c += stride) {
            Vec16<T> v = load16_cs(x + c * V);
#pragma unroll
            for (int k = 0; k < V; ++k) v.v[k] = from_f32<T>(exp_poly(to_f32(v.v[k])));
            store16_cs(y + c * V, v);
        }
        // the < V elements past the last whole vector, in block 0
        const int64_t t = nvec * V + threadIdx.x;
        if (blockIdx.x == 0 && t < n) y[t] = from_f32<T>(exp_poly(to_f32(x[t])));
    } else {
        for (int64_t i = first; i < n; i += stride) y[i] = from_f32<T>(exp_poly(to_f32(x[i])));
    }
}

template <typename T, bool VEC>
void launch_expv_as(const T* x, T* y, int64_t n, cudaStream_t s) {
    const int64_t per_block = VEC ? static_cast<int64_t>(EXP_THREADS) * Vec16<T>::N : EXP_THREADS;
    int64_t blocks = (n + per_block - 1) / per_block;
    if (blocks > (1LL << 31) - 1) blocks = (1LL << 31) - 1;   // the grid's limit
    expv_kernel<T, VEC><<<static_cast<unsigned>(blocks), EXP_THREADS, 0, s>>>(x, y, n);
}

template <typename T>
void launch_expv(const void* x, void* y, int64_t n, cudaStream_t s) {
    const T* px = static_cast<const T*>(x);
    T* py = static_cast<T*>(y);
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0)
        launch_expv_as<T, true>(px, py, n, s);
    else
        launch_expv_as<T, false>(px, py, n, s);
}

// ---------------------------------------------------------------------------
// row softmax
// ---------------------------------------------------------------------------

template <typename T>
__global__ void softmax_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t W,
                               int resident) {
    extern __shared__ float row[];               // W floats when resident
    __shared__ float red[33];
    const T* xr = x + static_cast<int64_t>(blockIdx.x) * W;
    T* yr = y + static_cast<int64_t>(blockIdx.x) * W;
    const int64_t tid = threadIdx.x, nt = blockDim.x;
    if (resident) {
        float m = -INFINITY;
        for (int64_t j = tid; j < W; j += nt) {
            const float v = to_f32(xr[j]);
            row[j] = v;
            m = fmaxf(m, v);
        }
        m = block_reduce<true>(m, red);
        float d = 0.f;
        for (int64_t j = tid; j < W; j += nt) {   // each thread its own elements
            const float e = expf(row[j] - m);
            row[j] = e;
            d += e;
        }
        d = block_reduce<false>(d, red);
        for (int64_t j = tid; j < W; j += nt) yr[j] = from_f32<T>(row[j] / d);
    } else {
        float m = -INFINITY, d = 0.f;
        for (int64_t j = tid; j < W; j += nt) {
            const float v = to_f32(xr[j]);
            if (v > m) {
                d = d * expf(m - v) + 1.f;
                m = v;
            } else if (v != -INFINITY) {  // a masked element adds 0, also while m is -inf
                d += expf(v - m);
            }
        }
        const float mr = block_reduce<true>(m, red);
        d = m == -INFINITY ? 0.f : d * expf(m - mr);   // a thread with no element adds 0
        d = block_reduce<false>(d, red);
        for (int64_t j = tid; j < W; j += nt) yr[j] = from_f32<T>(expf(to_f32(xr[j]) - mr) / d);
    }
}

template <typename T>
int launch_softmax(const void* x, void* y, int64_t R, int64_t W, cudaStream_t s) {
    const int resident = W <= RESIDENT_MAX;
    const size_t smem = resident ? static_cast<size_t>(W) * sizeof(float) : 0;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            softmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int threads = resident ? SOFTMAX_THREADS_RESIDENT : SOFTMAX_THREADS_STREAM;
    softmax_kernel<T><<<static_cast<unsigned>(R), threads, smem, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), W, resident);
    return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers to
// contiguous tensors; each launch goes on `stream` and does not synchronise.
// Each returns cudaGetLastError() after the launch (0 = success).

// out[s] = sum of a[i]*b[i] over i in [s*seg_len, (s+1)*seg_len) and i < n,
// for s < nseg, in f32; seg_len a multiple of 8.  bps blocks a segment.
// work holds DOT_MAX_SEGS zeroed uint32 tickets, which the launch leaves at
// zero again, then room for DOT_MAX_SEGS floats (nseg*bps block partials).
// 16-byte vectors where a and b are 16-byte aligned.
extern "C" int repro_dot(const void* a, const void* b, int64_t n, int64_t seg_len, int nseg,
                         int bps, void* work, void* out, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (nseg <= 0 || bps <= 0 || nseg > DOT_MAX_SEGS ||
        (bps > 1 && static_cast<int64_t>(nseg) * bps > DOT_MAX_SEGS))
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
        launch_dot<float>(a, b, n, seg_len, nseg, bps, work, out, s);
    else if (dtype == 1)
        launch_dot<__nv_bfloat16>(a, b, n, seg_len, nseg, bps, work, out, s);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

// y = the TPU kernel's exp of x, n elements; 16-byte vectors where x and y
// are 16-byte aligned.
extern "C" int repro_expv(const void* x, void* y, int64_t n, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n > 0) {
        if (dtype == 0)
            launch_expv<float>(x, y, n, s);
        else if (dtype == 1)
            launch_expv<__nv_bfloat16>(x, y, n, s);
        else
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// y (R, W) = softmax of each row of x (R, W), f32 math.
extern "C" int repro_softmax_rows(const void* x, void* y, int64_t R, int64_t W, int dtype,
                                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (R > 0 && W > 0) {
        int err = 0;
        if (dtype == 0)
            err = launch_softmax<float>(x, y, R, W, s);
        else if (dtype == 1)
            err = launch_softmax<__nv_bfloat16>(x, y, R, W, s);
        else
            return static_cast<int>(cudaErrorInvalidValue);
        if (err) return err;
    }
    return static_cast<int>(cudaGetLastError());
}

// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * gamma, row by row.
//
// Replaces the TPU kernel of repro/kernels/rmsnorm.py (_rms_kernel): x (R,
// D) in f32 or bf16, gamma (D,) in f32 even when x is bf16, f32 math, the
// output in x's dtype.
//
// Bound by bytes on an H100: each row is read once and written once (2 D
// itemsize bytes) for ~4 operations an element.  At decode R is the batch
// (1 to 8), so a call is one round trip to memory plus the launch: every
// load of a row is issued before any is used, and nothing else waits.
//
// One block a row.  A thread holds up to RMS_VECS 16-byte vectors of the
// row in registers (neighbouring threads on neighbouring vectors), loaded
// at once with gamma's f32 vectors beside them (read-only, shared by every
// row, so it stays in cache): one round trip to memory before the sum.  The
// sum of squares runs in a fixed order: each thread's elements in order,
// xor shuffles within a warp, then the warps' sums in warp order, read by
// every thread; so a row's scale, and the result, are the same on every
// run.  The products are taken in the reference's order, (x * r) * g, and
// each vector leaves by one 16-byte store.  A row that is not whole
// 16-byte vectors (D not a multiple of the vector, an unaligned view, or a
// row longer than the registers hold) takes the scalar path: the same
// order of operations, element by element, the row read a second time for
// the store (from L1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int RMS_VECS = 2;             // 16-byte vectors of x a thread holds
constexpr int RMS_MAX_THREADS = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T> struct alignas(16) Vec16 {
    static constexpr int N = 16 / sizeof(T);
    T v[N];
};

// component i of w; i is a constant once the loops are unrolled
__device__ __forceinline__ float lane4(const float4& w, int i) {
    return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// The block's sum of v in a fixed order, given to every thread.  red holds
// 32 floats and is written once a launch.
__device__ __forceinline__ float block_sum(float v, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
    const int nw = blockDim.x >> 5;
    for (int w = 0; w < nw; ++w) s += red[w];
    return s;
}

template <typename T>
__global__ void __launch_bounds__(RMS_MAX_THREADS)
rms_vec_kernel(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
               int D, float eps) {
    constexpr int V = Vec16<T>::N;
    __shared__ float red[32];
    const int64_t row = blockIdx.x;
    const int nvec = D / V;
    const Vec16<T>* xr = reinterpret_cast<const Vec16<T>*>(x + row * D);
    Vec16<T>* yr = reinterpret_cast<Vec16<T>*>(y + row * D);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int t = threadIdx.x, nt = blockDim.x;
    // every load of the row and of gamma issued before any is used: one
    // round trip to memory
    Vec16<T> v[RMS_VECS];
    float4 gv[RMS_VECS][V / 4];
#pragma unroll
    for (int k = 0; k < RMS_VECS; ++k)
        if (t + k * nt < nvec) {
            v[k] = xr[t + k * nt];
#pragma unroll
            for (int q = 0; q < V / 4; ++q) gv[k][q] = __ldg(&g4[(t + k * nt) * (V / 4) + q]);
        }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < RMS_VECS; ++k)
        if (t + k * nt < nvec)
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float f = to_f32(v[k].v[j]);
                ss = fmaf(f, f, ss);
            }
    ss = block_sum(ss, red);
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
#pragma unroll
    for (int k = 0; k < RMS_VECS; ++k) {
        if (t + k * nt >= nvec) continue;
        Vec16<T> o;
#pragma unroll
        for (int j = 0; j < V; ++j)
            o.v[j] = from_f32<T>(to_f32(v[k].v[j]) * r * lane4(gv[k][j / 4], j % 4));
        yr[t + k * nt] = o;
    }
}

template <typename T>
__global__ void __launch_bounds__(RMS_MAX_THREADS)
rms_scalar_kernel(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
                  int D, float eps) {
    __shared__ float red[32];
    const T* xr = x + static_cast<int64_t>(blockIdx.x) * D;
    T* yr = y + static_cast<int64_t>(blockIdx.x) * D;
    float ss = 0.f;
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
        const float f = to_f32(xr[j]);
        ss = fmaf(f, f, ss);
    }
    ss = block_sum(ss, red);
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    for (int j = threadIdx.x; j < D; j += blockDim.x)
        yr[j] = from_f32<T>(to_f32(xr[j]) * r * g[j]);
}

// Threads for a row of nvec whole vectors: enough that each holds at most
// RMS_VECS, a whole number of warps, at least one.
int vec_threads(int nvec) {
    const int want = (nvec + RMS_VECS - 1) / RMS_VECS;
    return ((want + 31) / 32) * 32;
}

template <typename T>
void launch_rms(const void* x, const void* g, void* y, int R, int D, float eps,
                cudaStream_t s) {
    constexpr int V = Vec16<T>::N;
    const T* px = static_cast<const T*>(x);
    T* py = static_cast<T*>(y);
    const float* pg = static_cast<const float*>(g);
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)
                           | reinterpret_cast<uintptr_t>(g)) % 16 == 0) && D % V == 0;
    if (aligned && vec_threads(D / V) <= RMS_MAX_THREADS) {
        rms_vec_kernel<T><<<R, vec_threads(D / V), 0, s>>>(px, pg, py, D, eps);
    } else {
        const int threads = D >= 1024 ? 1024 : ((D + 31) / 32) * 32;
        rms_scalar_kernel<T><<<R, threads, 0, s>>>(px, pg, py, D, eps);
    }
}

// ---------------------------------------------------------------------------
// Backward: dx = r (gy - xh c) and dgamma = sum over rows of dy xh, with r =
// rsqrt(mean(x^2) + eps), xh = x r, gy = dy gamma, c = mean(gy xh).
//
// What it stands for: the TPU kernel has no backward; the reference trains
// by jax.grad of kops.rmsnorm's jnp path, whose gradient is the formula of
// kernels/ref.py::rmsnorm_bwd.
//
// Bound by bytes on an H100: x and dy read and dx written once (3 R D
// itemsize bytes; 0.030 ms at the training shape (4096, 4096) bf16) for ~10
// operations an element.  Two grids: P blocks (rmsnorm.py::bwd_blocks), block
// p taking rows p, p + P, ..., then one thread a column summing the P
// dgamma partials in block order, so the bits do not vary between runs (no
// atomics).
//
// * rms_bwd_vec_kernel, rows of whole 16-byte vectors that the registers
//   hold (BWD_VECS vectors of x and of dy a thread): a thread owns the same
//   vectors of every row, so it loads their gamma once a block and keeps
//   their dgamma partial in registers, one f32 a column, written once when
//   the block's rows are done (P D floats in all).  Each row is read once,
//   as 16-byte vectors kept in registers across the two row sums and the dx
//   store, and the next row's loads are issued before this row's sums, so
//   a block has a row in flight while it reduces the last.
// * rms_bwd_kernel, the scalar path (a row that is not whole vectors, an
//   unaligned view, or one wider than the registers hold): element by
//   element, each row read twice, the block's partial in device memory.
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;        // the scalar path's and the dgamma sum's
constexpr int BWD_VECS = 2;             // 16-byte vectors of x (and of dy) a thread holds
// the vector path's most threads: 128 registers a thread, so x, dy, the next
// row's x and dy, gamma and the dgamma partial stay in registers (a bound
// of 1024 would cap them at 64 and spill); rows of up to 1024 vectors
constexpr int BWD_VEC_MAX_THREADS = 512;

// Two sums of the block in the fixed order of block_sum, given to every
// thread; red holds 64 floats.  The caller syncs before a second call.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
        red[2 * warp] = a;
        red[2 * warp + 1] = b;
    }
    __syncthreads();
    float sa = 0.f, sb = 0.f;
    const int nw = blockDim.x >> 5;
    for (int w = 0; w < nw; ++w) {
        sa += red[2 * w];
        sb += red[2 * w + 1];
    }
    return make_float2(sa, sb);
}

// the thread's vectors t + k nt (k < BWD_VECS, those < nvec) of row `row`
// of x and dy
template <typename T>
__device__ __forceinline__ void load_row(Vec16<T> (&xv)[BWD_VECS], Vec16<T> (&dv)[BWD_VECS],
                                         const T* x, const T* dy, int64_t row, int D, int t,
                                         int nt, int nvec) {
    const Vec16<T>* xr = reinterpret_cast<const Vec16<T>*>(x + row * D);
    const Vec16<T>* dr = reinterpret_cast<const Vec16<T>*>(dy + row * D);
#pragma unroll
    for (int k = 0; k < BWD_VECS; ++k)
        if (t + k * nt < nvec) {
            xv[k] = xr[t + k * nt];
            dv[k] = dr[t + k * nt];
        }
}

template <typename T>
__global__ void __launch_bounds__(BWD_VEC_MAX_THREADS)
rms_bwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part, int R,
                   int D, float eps) {
    constexpr int V = Vec16<T>::N;
    __shared__ float red[64];
    const int t = threadIdx.x, nt = blockDim.x, P = gridDim.x;
    const int nvec = D / V;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    // this thread's columns: their gamma, and dgamma's partial over the
    // block's rows
    float4 gv[BWD_VECS][V / 4];
    float acc[BWD_VECS][V];
#pragma unroll
    for (int k = 0; k < BWD_VECS; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
        if (t + k * nt < nvec)
#pragma unroll
            for (int q = 0; q < V / 4; ++q) gv[k][q] = __ldg(&g4[(t + k * nt) * (V / 4) + q]);
    }
    Vec16<T> xv[BWD_VECS], dv[BWD_VECS];
    int64_t row = blockIdx.x;
    if (row < R) load_row(xv, dv, x, dy, row, D, t, nt, nvec);
    for (; row < R; row += P) {
        Vec16<T> xn[BWD_VECS], dn[BWD_VECS];
        if (row + P < R) load_row(xn, dn, x, dy, row + P, D, t, nt, nvec);
        float ss = 0.f, dot = 0.f;
#pragma unroll
        for (int k = 0; k < BWD_VECS; ++k)
            if (t + k * nt < nvec)
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    const float f = to_f32(xv[k].v[j]);
                    ss = fmaf(f, f, ss);
                    dot = fmaf(to_f32(dv[k].v[j]) * lane4(gv[k][j / 4], j % 4), f, dot);
                }
        __syncthreads();                  // every thread has read the last row's sums
        const float2 s = block_sum2(ss, dot, red);
        const float r = rsqrtf(s.x / static_cast<float>(D) + eps);
        const float c = r * s.y / static_cast<float>(D);   // mean(gy xh)
        Vec16<T>* out = reinterpret_cast<Vec16<T>*>(dx + row * D);
#pragma unroll
        for (int k = 0; k < BWD_VECS; ++k) {
            if (t + k * nt >= nvec) continue;
            Vec16<T> o;
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float d = to_f32(dv[k].v[j]);
                const float xh = to_f32(xv[k].v[j]) * r;
                o.v[j] = from_f32<T>(r * (d * lane4(gv[k][j / 4], j % 4) - xh * c));
                acc[k][j] = fmaf(d, xh, acc[k][j]);
            }
            out[t + k * nt] = o;
        }
#pragma unroll
        for (int k = 0; k < BWD_VECS; ++k) {
            xv[k] = xn[k];
            dv[k] = dn[k];
        }
    }
    float4* mine = reinterpret_cast<float4*>(part + static_cast<int64_t>(blockIdx.x) * D);
#pragma unroll
    for (int k = 0; k < BWD_VECS; ++k)
        if (t + k * nt < nvec)
#pragma unroll
            for (int q = 0; q < V / 4; ++q)
                mine[(t + k * nt) * (V / 4) + q] =
                    make_float4(acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2],
                                acc[k][4 * q + 3]);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
rms_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
               T* __restrict__ dx, float* __restrict__ part, int R, int D, float eps) {
    __shared__ float red[64];
    const int t = threadIdx.x, nt = blockDim.x;
    const int P = gridDim.x;
    float* mine = part + static_cast<int64_t>(blockIdx.x) * D;
    for (int j = t; j < D; j += nt) mine[j] = 0.f;       // each thread its own columns
    for (int64_t row = blockIdx.x; row < R; row += P) {
        const T* xr = x + row * D;
        const T* dr = dy + row * D;
        float ss = 0.f, dot = 0.f;
        for (int j = t; j < D; j += nt) {
            const float f = to_f32(xr[j]);
            ss = fmaf(f, f, ss);
            dot = fmaf(to_f32(dr[j]) * __ldg(&g[j]), f, dot);
        }
        __syncthreads();                  // every thread has read the last row's sums
        const float2 s = block_sum2(ss, dot, red);
        const float r = rsqrtf(s.x / static_cast<float>(D) + eps);
        const float c = r * s.y / static_cast<float>(D);   // mean(gy xh)
        T* out = dx + row * D;
        for (int j = t; j < D; j += nt) {
            const float d = to_f32(dr[j]);
            const float xh = to_f32(xr[j]) * r;
            out[j] = from_f32<T>(r * (d * __ldg(&g[j]) - xh * c));
            mine[j] = fmaf(d, xh, mine[j]);
        }
    }
}

// dgamma[j] = the P partials of column j summed in block order
__global__ void __launch_bounds__(BWD_THREADS)
rms_dgamma_kernel(const float* __restrict__ part, float* __restrict__ dgamma, int P, int D) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= D) return;
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[static_cast<int64_t>(p) * D + j];
    dgamma[j] = s;
}

// Threads of the backward's vector path for a row of nvec whole vectors:
// enough that each holds at most BWD_VECS, a whole number of warps
int bwd_vec_threads(int nvec) {
    const int want = (nvec + BWD_VECS - 1) / BWD_VECS;
    return ((want + 31) / 32) * 32;
}

template <typename T>
int launch_rms_bwd(const void* x, const void* g, const void* dy, void* dx, void* dgamma,
                   void* part, int R, int D, int P, float eps, int vec, cudaStream_t s) {
    constexpr int V = Vec16<T>::N;
    const T* px = static_cast<const T*>(x);
    const T* pdy = static_cast<const T*>(dy);
    const float* pg = static_cast<const float*>(g);
    T* pdx = static_cast<T*>(dx);
    float* pp = static_cast<float*>(part);
    if (vec) {
        const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)
                               | reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(g)
                               | reinterpret_cast<uintptr_t>(part)) % 16 == 0) && D % V == 0;
        if (!aligned || bwd_vec_threads(D / V) > BWD_VEC_MAX_THREADS)
            return static_cast<int>(cudaErrorInvalidValue);
        rms_bwd_vec_kernel<T><<<P, bwd_vec_threads(D / V), 0, s>>>(px, pg, pdy, pdx, pp, R, D,
                                                                   eps);
    } else {
        rms_bwd_kernel<T><<<P, BWD_THREADS, 0, s>>>(px, pg, pdy, pdx, pp, R, D, eps);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rms_dgamma_kernel<<<(D + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(dgamma), P, D);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (R, D) = x * rsqrt(mean(x^2) + eps) * gamma for each row of x (R, D);
// dtype 0 = float32, 1 = bfloat16 (x and y); gamma f32 (D,).  Pointers are
// device pointers to contiguous tensors; the launch goes on `stream` and
// does not synchronise.  Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int repro_rmsnorm(const void* x, const void* gamma, void* y, int R, int D,
                             float eps, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (R < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (R > 0 && D > 0) {
        if (dtype == 0)
            launch_rms<float>(x, gamma, y, R, D, eps, s);
        else if (dtype == 1)
            launch_rms<__nv_bfloat16>(x, gamma, y, R, D, eps, s);
        else
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// The backward of repro_rmsnorm for the output's gradient dy (R, D): dx (R, D)
// in x's dtype (dtype as above) and dgamma (D,) f32, through `part`, a
// workspace of P * D floats (P, 1 <= P <= R, the blocks of the first grid).
// vec 1 takes rms_bwd_vec_kernel (refused where the rows are not whole
// aligned vectors that fit), 0 the scalar rms_bwd_kernel.  Contiguous device
// tensors; the launches go on `stream` and do not synchronise.  Returns the
// first launch error (0 = success).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                 void* dgamma, void* part, int R, int D, int P, float eps,
                                 int dtype, int vec, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (R <= 0 || D <= 0 || P < 1 || P > R) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
        return launch_rms_bwd<float>(x, gamma, dy, dx, dgamma, part, R, D, P, eps, vec, s);
    if (dtype == 1)
        return launch_rms_bwd<__nv_bfloat16>(x, gamma, dy, dx, dgamma, part, R, D, P, eps, vec,
                                             s);
    return static_cast<int>(cudaErrorInvalidValue);
}

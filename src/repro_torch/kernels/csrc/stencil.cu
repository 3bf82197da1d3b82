// The paper's Table I stencils: a 5-point Jacobi sweep and a small 2-D
// convolution.
//
// Replaces the TPU kernels of repro/kernels/stencil.py:
//  * jacobi2d (_jacobi_kernel): 0.25 * (N + S + W + E) on the interior of
//    an (H+2, W+2) input that the wrapper padded with zeros, in the input
//    dtype, over (bh+2, bw+2) halo blocks;
//  * fconv2d (_conv_kernel): a valid 2-D cross-correlation (the filter is
//    not flipped) of an (H+fr-1, W+fc-1) input with an (fr, fc) filter, the
//    taps unrolled r outer, c inner, accumulated in f32, over
//    (bh+fr-1, bw+fc-1) halo blocks.
//
// What bounds them on an H100: jacobi2d reads and writes each element once
// for 4 operations, so bytes (0.64 ms for a 16384^2 f32 grid at 3.35 TB/s).
// fconv2d does 2*fr*fc operations an element, 98 at 7x7: its 8192^2 case
// needs 6.6 GFLOP (0.098 ms at 67 TFLOP/s f32) against 0.54 GB (0.16 ms),
// so bytes too, but only by 1.6x: the taps must not cost more than the
// loads.
//
// Each block owns a BH x BW output tile and stages its input tile with the
// halo (one element around it for jacobi2d, fr-1 rows and fc-1 columns for
// fconv2d) in shared memory as f32, read once from global memory with
// neighbouring threads on neighbouring addresses; elements outside the
// input are zeros, which is jacobi2d's zero boundary, so the wrapper pads
// nothing.  Each thread computes BH/2 outputs of one column.
//  * jacobi2d sums ((N + S) + W) + E in f32, then * 0.25: in f32 this is the
//    TPU kernel's arithmetic to the bit.  For bf16 the TPU kernel rounds to
//    bf16 after each add; here the sum is f32 and rounds once.
//  * fconv2d keeps the filter in shared memory (any fr, fc <= MAX_TAPS)
//    and walks the taps r outer, c inner, each one fmaf into f32
//    accumulators; a tap's filter value is read once for the thread's
//    BH/2 outputs.
// What this gives up: the taps loop is not unrolled for a fixed filter,
// and every tap reads shared memory, which limits fconv2d below its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BH = 16, BW = 128;           // output tile
constexpr int THREADS = 256;               // BW columns x 2 row groups
constexpr int ROWS_PER_THREAD = BH / (THREADS / BW);
constexpr int MAX_TAPS = 16;               // fr, fc <= 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// tile[TH][TW] = x[r0 + i][c0 + j] as f32, zero outside the (H, W) input
template <typename T>
__device__ __forceinline__ void stage(float* tile, int TH, int TW, const T* __restrict__ x,
                                      int64_t H, int64_t W, int64_t r0, int64_t c0) {
    for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
        const int64_t r = r0 + i / TW, c = c0 + i % TW;
        tile[i] = (r >= 0 && r < H && c >= 0 && c < W) ? to_f32(x[r * W + c]) : 0.f;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
jacobi_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t H, int64_t W) {
    constexpr int TW = BW + 2;
    __shared__ float tile[(BH + 2) * TW];
    const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BH;
    const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BW;
    stage(tile, BH + 2, TW, x, H, W, row0 - 1, col0 - 1);
    __syncthreads();
    const int c = threadIdx.x % BW, g = threadIdx.x / BW;
    if (col0 + c >= W) return;
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        const int r = g + k * (THREADS / BW);    // output row in the tile; centre at tile row r+1
        if (row0 + r >= H) break;
        const float n = tile[r * TW + c + 1], s = tile[(r + 2) * TW + c + 1];
        const float w = tile[(r + 1) * TW + c], e = tile[(r + 1) * TW + c + 2];
        y[(row0 + r) * W + col0 + c] = from_f32<T>(0.25f * (((n + s) + w) + e));
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const T* __restrict__ x, const float* __restrict__ filt, T* __restrict__ y,
            int64_t H, int64_t W, int fr, int fc) {
    extern __shared__ float smem[];           // fr*fc filter taps, then the input tile
    const int TW = BW + fc - 1, TH = BH + fr - 1;
    float* f = smem;
    float* tile = smem + fr * fc;
    const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BH;
    const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BW;
    for (int i = threadIdx.x; i < fr * fc; i += THREADS) f[i] = filt[i];
    stage(tile, TH, TW, x, H + fr - 1, W + fc - 1, row0, col0);
    __syncthreads();
    const int c = threadIdx.x % BW, g = threadIdx.x / BW;
    float acc[ROWS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) acc[k] = 0.f;
    for (int r = 0; r < fr; ++r) {
        for (int q = 0; q < fc; ++q) {
            const float fv = f[r * fc + q];
            const float* t = tile + (g + r) * TW + c + q;
#pragma unroll
            for (int k = 0; k < ROWS_PER_THREAD; ++k)
                acc[k] = fmaf(fv, t[k * (THREADS / BW) * TW], acc[k]);
        }
    }
    if (col0 + c >= W) return;
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        const int64_t r = row0 + g + k * (THREADS / BW);
        if (r < H) y[r * W + col0 + c] = from_f32<T>(acc[k]);
    }
}

inline dim3 tiles(int64_t H, int64_t W) {
    return dim3(static_cast<unsigned>((W + BW - 1) / BW), static_cast<unsigned>((H + BH - 1) / BH));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers to
// contiguous row-major tensors; each launch goes on `stream` and does not
// synchronise.  Each returns cudaGetLastError() after the launch (0 =
// success).  The grid's rows are tiles of BH rows: H <= 65535 * 16.

// y (H, W) = one Jacobi sweep of x (H, W) with a zero boundary.
extern "C" int repro_jacobi2d(const void* x, void* y, int64_t H, int64_t W, int dtype,
                              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (H > 0 && W > 0) {
        if (dtype == 0)
            jacobi_kernel<float><<<tiles(H, W), THREADS, 0, s>>>(
                static_cast<const float*>(x), static_cast<float*>(y), H, W);
        else if (dtype == 1)
            jacobi_kernel<__nv_bfloat16><<<tiles(H, W), THREADS, 0, s>>>(
                static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), H, W);
        else
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// y (H, W) = valid cross-correlation of x (H+fr-1, W+fc-1) with the f32
// filter filt (fr, fc), fr and fc in [1, MAX_TAPS].
extern "C" int repro_fconv2d(const void* x, const void* filt, void* y, int64_t H, int64_t W,
                             int fr, int fc, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fr < 1 || fc < 1 || fr > MAX_TAPS || fc > MAX_TAPS)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * (fr * fc + (BH + fr - 1) * (BW + fc - 1));
    const float* f = static_cast<const float*>(filt);
    if (H > 0 && W > 0) {
        if (dtype == 0)
            conv_kernel<float><<<tiles(H, W), THREADS, smem, s>>>(
                static_cast<const float*>(x), f, static_cast<float*>(y), H, W, fr, fc);
        else if (dtype == 1)
            conv_kernel<__nv_bfloat16><<<tiles(H, W), THREADS, smem, s>>>(
                static_cast<const __nv_bfloat16*>(x), f, static_cast<__nv_bfloat16*>(y), H, W,
                fr, fc);
        else
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

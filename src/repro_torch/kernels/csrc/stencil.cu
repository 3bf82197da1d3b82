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
// jacobi2d: each block owns a BH x BW output tile and stages its input
// tile with a one-element halo in shared memory as f32, read once from
// global memory with neighbouring threads on neighbouring addresses;
// elements outside the input are zeros, which is the zero boundary, so the
// wrapper pads nothing.  Each thread computes BH/2 outputs of one column,
// ((N + S) + W) + E in f32, then * 0.25: in f32 the TPU kernel's arithmetic
// to the bit.  For bf16 the TPU kernel rounds to bf16 after each add; here
// the sum is f32 and rounds once.
//
// fconv2d: the taps cost registers, not shared memory.
//  * A thread computes 8 rows x 4 columns of outputs (a block of 4 warps a
//    32 x 128 tile).  It walks the 8 + fr - 1 input rows of its window, and
//    each staged row is read from shared memory once (16- or 8-byte loads,
//    conflict-free) into registers, where it meets every tap row of every
//    output row it feeds: 28 fused multiply-adds a value at 7x7.  The taps
//    run r outer, c inner for each output, as the TPU kernel's.
//  * The square 3, 5 and 7 filters are template arguments, held in
//    registers and fully unrolled; any other filter up to 16 x 16 takes a
//    generic loop with the filter in shared memory
//    (kernels/stencil.py::conv_plan picks; a filter past 16 raises).
//  * Persistent blocks, as many as fit an SM (four), walk the tiles
//    blockIdx.x, + grid, ...  Each stages the next tile's input by cp.async
//    into a second buffer while the taps of this one run: a warp a row, a
//    lane a copy (no division an element), each row in the widest copy its
//    start's alignment allows (16 bytes for aligned rows; 8,198-wide rows
//    take 16 and 8 bytes in turn in f32, 16, 4, 8, 4 in bf16).
//  * The outputs leave from registers in the widest store the row allows.
// What this gives up: the card's f32 rate bounds the taps at ~0.1 ms for
// 8192^2 x 49, so the loads and the taps must overlap to reach the byte
// bound; they overlap in part (on the H100, 8198^2 at 7x7: taps alone
// 0.16 ms, loads and stores alone 0.20, both 0.24 in f32), and less where
// rows take 4-byte copies (bf16: 0.16, 0.12, 0.26).  Staging every row in
// 16-byte copies from the boundary below it, the taps shifting each row
// in registers, made the loads cheaper and the taps dearer: slower.

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

// -- fconv2d ------------------------------------------------------------------

constexpr int CONV_THREADS = 128;          // 32 lanes across, 4 warps down
constexpr int CONV_WARPS = CONV_THREADS / 32;
constexpr int TR = 8, TC = 4;              // a thread's outputs: TR rows x TC columns
constexpr int CBH = CONV_WARPS * TR;       // 32 output rows a tile
constexpr int CBW = 32 * TC;               // 128 output columns a tile
constexpr int CONV_MIN_BLOCKS = 4;         // resident blocks an SM (<= 128 registers)
// Builds for testing/conv_probe.py only, to time each half alone: with
// -DCONV_NO_TAPS the taps are skipped (zeros are stored), with
// -DCONV_NO_LOADS the input copies (the taps read stale shared memory)
#ifdef CONV_NO_TAPS
constexpr bool CONV_TAPS = false;
#else
constexpr bool CONV_TAPS = true;
#endif
#ifdef CONV_NO_LOADS
constexpr bool CONV_LOADS = false;
#else
constexpr bool CONV_LOADS = true;
#endif

// `bytes` (16, 8 or 4) global -> shared, asynchronously: 16-byte copies
// through L2 only, the narrower ones through L1; two-byte copies have no
// cp.async and are plain loads and stores
__device__ __forceinline__ void copy_in(void* dst, const void* src, int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
    else if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
    else if (bytes == 4)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
    else
        *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r][e] = x[row0 + r][col0 + e] for the tile's th rows and tw columns; a
// warp a row, a lane a copy, each row in the widest copies its first
// element's address allows (16 bytes where the row is aligned; 8198-wide
// f32 rows alternate 16 and 8).  A row's copies end with the one that holds
// its last needed element (the last may reach past it, never past the
// aligned 16 bytes that hold it), and rows past the input are skipped: only
// outputs that are not stored read what is not staged.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int sw, const T* __restrict__ x,
                                           int64_t Hx, int64_t Wx, int64_t row0,
                                           int64_t col0, int th, int tw) {
    if (!CONV_LOADS) return;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int64_t rows = min(static_cast<int64_t>(th), Hx - row0);
    const int need = static_cast<int>(min(static_cast<int64_t>(tw), Wx - col0)) *
                     static_cast<int>(sizeof(T));            // bytes a row needs
    for (int r = warp; r < rows; r += CONV_WARPS) {
        const char* src = reinterpret_cast<const char*>(x + (row0 + r) * Wx + col0);
        const int a = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
        const int bytes = a == 0 ? 16 : a & -a;              // the row's alignment
        char* d = reinterpret_cast<char*>(dst + r * sw);
        for (int k = lane * bytes; k < need; k += 32 * bytes) copy_in(d + k, src + k, bytes);
    }
}

// n consecutive staged values from shared memory as f32 (n a multiple of 4;
// p 16-byte aligned for f32, 8-byte for bf16)
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&w)[N]) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + j);
        w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
    }
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&w)[N]) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(p + j);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
        w[j] = a.x; w[j + 1] = a.y; w[j + 2] = b.x; w[j + 3] = b.y;
    }
}

// TC consecutive outputs of one row at element offset e of y: one 16- or
// 8-byte store where e allows, else pairs or single values
__device__ __forceinline__ void store_out(float* y, int64_t e, const float (&a)[TC], int n) {
    float* p = y + e;
    if (n == TC && e % 4 == 0) {
        *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    } else if (n == TC && e % 2 == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
        *reinterpret_cast<float2*>(p + 2) = make_float2(a[2], a[3]);
    } else {
#pragma unroll
        for (int c = 0; c < TC; ++c)                     // unrolled: a stays in registers
            if (c < n) p[c] = a[c];
    }
}
__device__ __forceinline__ void store_out(__nv_bfloat16* y, int64_t e, const float (&a)[TC],
                                          int n) {
    __nv_bfloat16* p = y + e;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
    if (n == TC && e % 4 == 0) {
        uint2 v;
        *reinterpret_cast<__nv_bfloat162*>(&v.x) = lo;
        *reinterpret_cast<__nv_bfloat162*>(&v.y) = hi;
        *reinterpret_cast<uint2*>(p) = v;
    } else if (n == TC && e % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) = lo;
        *reinterpret_cast<__nv_bfloat162*>(p + 2) = hi;
    } else {
#pragma unroll
        for (int c = 0; c < TC; ++c)
            if (c < n) p[c] = __float2bfloat16(a[c]);
    }
}

// FR_ x FC_ taps fixed at compile time (the filter in registers, every loop
// unrolled), or FR_ = FC_ = 0: any fr, fc <= MAX_TAPS (the filter in shared
// memory, a loop over the input rows, the columns unrolled to MAX_TAPS).
template <typename T, int FR_, int FC_>
__global__ void __launch_bounds__(CONV_THREADS, CONV_MIN_BLOCKS)
conv_kernel(const T* __restrict__ x, const float* __restrict__ filt, T* __restrict__ y,
            int64_t H, int64_t W, int fr, int fc, int tiles_x, int tiles) {
    constexpr bool FIXED = FR_ > 0;
    constexpr int FCM = FIXED ? FC_ : MAX_TAPS;           // taps a row, at most
    constexpr int WIN = (TC + FCM - 1 + 3) / 4 * 4;       // a thread's staged row window
    constexpr int SW = (CBW + FCM - 1 + 7) / 8 * 8;       // staged row stride
    if (FIXED) {
        fr = FR_;
        fc = FC_;
    }
    const int th = CBH + fr - 1, tw = CBW + fc - 1;
    const int64_t Hx = H + fr - 1, Wx = W + fc - 1;
    extern __shared__ __align__(16) unsigned char smem[];
    float* fs = reinterpret_cast<float*>(smem);          // generic: [MAX_TAPS][MAX_TAPS]
    T* const buf0 = reinterpret_cast<T*>(smem + (FIXED ? 0 : sizeof(float) * MAX_TAPS * MAX_TAPS));
    const int buf_len = th * SW;                         // two buffers of th staged rows

    float freg[FIXED ? FR_ : 1][FIXED ? FC_ : 1];
    if constexpr (FIXED) {
#pragma unroll
        for (int r = 0; r < FR_; ++r)
#pragma unroll
            for (int q = 0; q < FC_; ++q) freg[r][q] = __ldg(filt + r * FC_ + q);
    } else {
        for (int i = threadIdx.x; i < MAX_TAPS * MAX_TAPS; i += CONV_THREADS) {
            const int r = i / MAX_TAPS, q = i % MAX_TAPS;
            fs[i] = (r < fr && q < fc) ? filt[r * fc + q] : 0.f;
        }
    }
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

    int tile = blockIdx.x, b = 0;
    if (tile < tiles)
        stage_tile(buf0, SW, x, Hx, Wx, static_cast<int64_t>(tile / tiles_x) * CBH,
                   static_cast<int64_t>(tile % tiles_x) * CBW, th, tw);
    cp_commit();
    for (; tile < tiles; tile += gridDim.x, b ^= 1) {
        // the next tile's copies fly while this one's taps run
        const int next = tile + gridDim.x;
        if (next < tiles)
            stage_tile(buf0 + (b ^ 1) * buf_len, SW, x, Hx, Wx,
                       static_cast<int64_t>(next / tiles_x) * CBH,
                       static_cast<int64_t>(next % tiles_x) * CBW, th, tw);
        cp_commit();
        cp_wait<1>();                                    // this tile's copies have landed
        __syncthreads();

        const int64_t row0 = static_cast<int64_t>(tile / tiles_x) * CBH;
        const int64_t col0 = static_cast<int64_t>(tile % tiles_x) * CBW;
        float acc[TR][TC];
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
        // input row i of the thread's window feeds output rows r = i - tap
        // row; each staged value is read once per thread row, the taps
        // walk r outer, c inner per output, as the TPU kernel's
        const T* win = buf0 + b * buf_len + warp * TR * SW + lane * TC;
        if constexpr (FIXED) {
#pragma unroll
            for (int i = 0; i < (CONV_TAPS ? TR + FR_ - 1 : 0); ++i) {
                float w[WIN];
                load_row(win + i * SW, w);
#pragma unroll
                for (int r = 0; r < TR; ++r) {
                    const int fi = i - r;
                    if (fi < 0 || fi >= FR_) continue;
#pragma unroll
                    for (int q = 0; q < FC_; ++q)
#pragma unroll
                        for (int c = 0; c < TC; ++c)
                            acc[r][c] = fmaf(freg[fi][q], w[c + q], acc[r][c]);
                }
            }
        } else {
#pragma unroll 1
            for (int i = 0; i < (CONV_TAPS ? TR + fr - 1 : 0); ++i) {
                float w[WIN];
                load_row(win + i * SW, w);
#pragma unroll
                for (int r = 0; r < TR; ++r) {
                    const int fi = i - r;
                    if (fi < 0 || fi >= fr) continue;
                    const float* f = fs + fi * MAX_TAPS;
#pragma unroll
                    for (int q = 0; q < MAX_TAPS; ++q) {
                        if (q >= fc) break;
                        const float fv = f[q];
#pragma unroll
                        for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(fv, w[c + q], acc[r][c]);
                    }
                }
            }
        }
        const int64_t orow = row0 + warp * TR;
        const int64_t ocol = col0 + lane * TC;
        const int n = static_cast<int>(min(static_cast<int64_t>(TC), W - ocol));
        if (n > 0) {
#pragma unroll
            for (int r = 0; r < TR; ++r)
                if (orow + r < H) store_out(y, (orow + r) * W + ocol, acc[r], n);
        }
        __syncthreads();                                 // the next copies overwrite this buffer
    }
    cp_wait<0>();
}

inline dim3 tiles(int64_t H, int64_t W) {
    return dim3(static_cast<unsigned>((W + BW - 1) / BW), static_cast<unsigned>((H + BH - 1) / BH));
}

template <typename T, int FR_, int FC_>
int launch_conv(const void* x, const float* filt, void* y, int64_t H, int64_t W, int fr,
                int fc, int grid, cudaStream_t s) {
    constexpr bool FIXED = FR_ > 0;
    constexpr int SW = (CBW + (FIXED ? FC_ : MAX_TAPS) - 1 + 7) / 8 * 8;
    const size_t smem = (FIXED ? 0 : sizeof(float) * MAX_TAPS * MAX_TAPS)
                        + 2 * sizeof(T) * (CBH + fr - 1) * SW;
    static bool opted_in = false;              // above 48 KB only after this
    if (smem > 48 * 1024 && !opted_in) {
        const cudaError_t e = cudaFuncSetAttribute(
            conv_kernel<T, FR_, FC_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(2 * sizeof(T) * (CBH + MAX_TAPS - 1) * SW
                             + sizeof(float) * MAX_TAPS * MAX_TAPS));
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in = true;
    }
    const int tiles_x = static_cast<int>((W + CBW - 1) / CBW);
    const int tiles = tiles_x * static_cast<int>((H + CBH - 1) / CBH);
    conv_kernel<T, FR_, FC_><<<grid, CONV_THREADS, smem, s>>>(
        static_cast<const T*>(x), filt, static_cast<T*>(y), H, W, fr, fc, tiles_x, tiles);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_conv(const void* x, const float* filt, void* y, int64_t H, int64_t W, int fr,
                int fc, int variant, int grid, cudaStream_t s) {
    switch (variant) {
        case 3: return launch_conv<T, 3, 3>(x, filt, y, H, W, 3, 3, grid, s);
        case 5: return launch_conv<T, 5, 5>(x, filt, y, H, W, 5, 5, grid, s);
        case 7: return launch_conv<T, 7, 7>(x, filt, y, H, W, 7, 7, grid, s);
        case 0: return launch_conv<T, 0, 0>(x, filt, y, H, W, fr, fc, grid, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers to
// contiguous row-major tensors; each launch goes on `stream` and does not
// synchronise.  Each returns cudaGetLastError() after the launch (0 =
// success).

// y (H, W) = one Jacobi sweep of x (H, W) with a zero boundary; the grid's
// rows are tiles of BH rows: H <= 65535 * 16.
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
// filter filt (fr, fc), fr and fc in [1, MAX_TAPS], as kernels/stencil.py's
// conv_plan gives it: `variant` 3, 5 or 7 for that square filter unrolled,
// 0 for any other; `grid` persistent blocks, each walking the
// (32 x 128)-output tiles blockIdx.x, + grid, ...  x needs no alignment
// beyond its dtype's.
extern "C" int repro_fconv2d(const void* x, const void* filt, void* y, int64_t H, int64_t W,
                             int fr, int fc, int dtype, int variant, int grid, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fr < 1 || fc < 1 || fr > MAX_TAPS || fc > MAX_TAPS || grid < 1
        || (variant != 0 && (fr != variant || fc != variant)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
    const float* f = static_cast<const float*>(filt);
    if (dtype == 0) return launch_conv<float>(x, f, y, H, W, fr, fc, variant, grid, s);
    if (dtype == 1) return launch_conv<__nv_bfloat16>(x, f, y, H, W, fr, fc, variant, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// C[M,N] = A[M,K] @ B[K,N]: f32 accumulation, output in A's dtype (bf16 or f32).
//
// Replaces the TPU kernel repro/kernels/matmul.py::matmul (_mm_kernel): an
// output-stationary product whose f32 accumulator tile stays in VMEM while
// (bm, bk) x (bk, bn) operand tiles stream through the MXU, K innermost.
//
// Here one block owns one BM x BN output tile, keeps its f32 accumulators in
// registers (TM x TN per thread) and walks K in BK-deep tiles staged through
// shared memory (converted to f32 on the way in).  B is the model's row-major
// (K, N) weight, read as it is: no transposed copy.  Ragged M, N and K edges
// are masked in the loads and the store, so the caller never pads.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16):
//  * decode (M = max_batch <= 8) moves ~K*N*2 weight bytes for 2*M*K*N
//    operations, a few FLOP per byte: it is bound by the weight bytes
//    (4096 -> 14336 at M=4: 117 MB, 35 us);
//  * prefill at M ~ 256 does ~237 FLOP per byte, near the card's ridge of
//    ~295, so it is bound by the tensor cores as much as by the bytes.
// The one latency measure taken: each thread fetches the next K tile into
// registers while the current one is computed, so a K step costs about one
// load latency, not one per element.
// What this simple design gives up: it uses no tensor cores (CUDA-core FMAs
// only, so prefill runs far under the bf16 rate), no cp.async/TMA pipeline
// deeper than that one tile (decode keeps only a few KB in flight per SM,
// well short of what hides HBM latency at full bandwidth), scalar rather
// than 16-byte loads, and no split-K (a small-N decode projection fills only
// N/BN blocks of 132 SMs).  wgmma, TMA and a pipelined, persistent design
// are later work.
//
// Two tile shapes, picked from M: a 64x64 tile for prefill, and for decode
// (M <= 8, the engine's max_batch) an 8x32 tile with a 128-deep K step,
// whose narrow N tile puts more blocks on the card and whose short M side
// wastes few FMAs on the masked rows of a 4-row batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
              int M, int N, int K) {
    constexpr int TX = BN / TN;            // threads along N
    constexpr int TY = BM / TM;            // threads along M
    constexpr int NT = TX * TY;
    static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile loads must split evenly");
    // A tile stored k-major (As[k][m]) so the inner loop reads a column of
    // A as a broadcast; +1 padding keeps the transposing store conflict-free.
    __shared__ float As[BK][BM + 1];
    __shared__ float Bs[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    // One tile ahead in registers: the global loads of tile k0 + BK are in
    // flight while the FMAs of tile k0 run.  Raw values, converted only when
    // stored to shared memory, so nothing waits on a load until then; a
    // masked element keeps the zero it was given.
    constexpr int LA = (BM * BK) / NT, LB = (BK * BN) / NT;
    T ra[LA], rb[LB];
    auto fetch = [&](int k0) {
        // consecutive threads read consecutive addresses of A's rows and B's rows
#pragma unroll
        for (int s = 0; s < LA; ++s) {
            const int i = tid + s * NT;
            const int gr = row0 + i / BK, gc = k0 + i % BK;
            ra[s] = from_f32<T>(0.f);
            if (gr < M && gc < K) ra[s] = A[(size_t)gr * K + gc];
        }
#pragma unroll
        for (int s = 0; s < LB; ++s) {
            const int i = tid + s * NT;
            const int gr = k0 + i / BN, gc = col0 + i % BN;
            rb[s] = from_f32<T>(0.f);
            if (gr < K && gc < N) rb[s] = B[(size_t)gr * N + gc];
        }
    };

    fetch(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int s = 0; s < LA; ++s) {
            const int i = tid + s * NT;
            As[i % BK][i / BK] = to_f32(ra[s]);
        }
#pragma unroll
        for (int s = 0; s < LB; ++s) {
            const int i = tid + s * NT;
            Bs[i / BN][i % BN] = to_f32(rb[s]);
        }
        __syncthreads();
        if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty + i * TY;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = col0 + tx + j * TX;
            if (c < N) C[(size_t)r * N + c] = from_f32<T>(acc[i][j]);
        }
    }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const dim3 block((BM / TM) * (BN / TN));
    matmul_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), M, N, K);
}

template <typename T>
void dispatch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
    if (M <= 8)
        launch<T, 8, 32, 128, 1, 1>(a, b, c, M, N, K, s);   // decode: 256 threads
    else
        launch<T, 64, 64, 16, 4, 4>(a, b, c, M, N, K, s);   // prefill: 256 threads
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers to
// contiguous row-major tensors; the launch goes on `stream` and does not
// synchronise.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                            int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (M > 0 && N > 0) {
        if (dtype == 0)
            dispatch<float>(a, b, c, M, N, K, s);
        else if (dtype == 1)
            dispatch<__nv_bfloat16>(a, b, c, M, N, K, s);
        else
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

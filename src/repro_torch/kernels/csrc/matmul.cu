// C[M,N] = A[M,K] @ B[K,N]: f32 accumulation, output in A's dtype (bf16 or f32).
//
// Replaces the TPU kernel repro/kernels/matmul.py:84 (matmul, _mm_kernel):
// an output-stationary product whose f32 accumulator tile stays in VMEM
// while (bm, bk) x (bk, bn) operand tiles stream through the MXU, K
// innermost.  B is the model's row-major (K, N) weight, read in place: no
// transposed copy.  Ragged M, N and K edges are masked (or zero-filled) in
// the kernels, so the caller never pads.  Each call is one launch, and the
// same inputs give the same bits on every run.
//
// Three variants (four kernels); kernels/matmul.py::variant picks one from
// (M, K, N, dtype, trans):
//
// * decode (bf16, M <= 8, K and N multiples of 8).  Bound on an H100 by the
//   weight bytes: 2*M*K*N operations on K*N*2 bytes is <= 8 FLOP a byte,
//   far under the card's ridge of ~295; 4096 -> 14336 moves 117 MB, 35 us
//   at 3.35 TB/s.  To stream at that rate every SM must keep ~25 KB of B in
//   flight, so:
//     - split-K: a block owns a 128-column tile of one K slice (the plan,
//       kernels/matmul.py::split_plan, aims at 4 blocks an SM over all 132
//       SMs with at most 16 slices, so 4096 x 4096 runs as 32 column tiles
//       x 16 slices and 4096 x 1024 as 8 x 16);
//     - 16-byte cp.async copies (a warp covers two whole 128-byte lines of
//       a B row) into a 4-stage ring of 32 x 128 tiles in shared memory:
//       with 4 blocks an SM, ~96 KB of B in flight an SM;
//     - A's rows of the slice are copied to shared memory once per block;
//     - the products run on the tensor cores (mma.sync.m16n8k16) with the
//       operands swapped, C^T = B^T A^T: a 16 x 16 tile of B^T comes from
//       shared memory by ldmatrix.trans, and A^T is the mma's 16 x 8 B
//       operand, so M <= 8 fills its 8 columns and the rows past M are
//       zeros in registers (copied as zero-fills), not in memory.  On CUDA
//       cores the 8 FMAs an element at M = 8 and the bf16 -> f32
//       conversions would take ~14-20 us of the 35; on the tensor cores
//       they cost next to nothing and no conversion is made;
//     - the slices' f32 partials reduce in the same launch in a fixed
//       order: each block writes its partial, takes an atomic ticket for
//       its column tile, and the last block of the tile sums the partials
//       in slice order (as csrc/reduction.cu's dot kernel does; 16-byte
//       loads, eight slices in flight, so the sum is a short tail), leaves
//       the ticket at zero and rounds once to bf16.  No float atomics, so
//       the bits do not vary.  The tickets and partials are a workspace
//       kept per (device, stream) by the wrapper.
//
// * wgmma (bf16, M > 8, K and N multiples of 8): prefill.  At M = 333,
//   K = 4096, N = 14336 the bound is ~39.5 us of operations against ~38.6
//   us of bytes: near the ridge, so the tensor cores at their full rate,
//   which only wgmma reaches, and the bytes streamed behind them:
//     - a 128 x 128 output tile a block, K in 64-deep steps; warpgroup 0 is
//       the producer: one thread issues TMA copies (128-byte swizzle) of
//       the A tile (128 x 64, K-major) and of B's two 64 x 64 halves (B is
//       MN-major: the descriptors set wgmma's transpose bit for B, which
//       bf16 allows) into a 4-stage ring, each stage's arrival counted on
//       an mbarrier;
//     - warpgroups 1 and 2 each run wgmma.m64n128k16 over 64 rows of the
//       tile from shared memory, keep one wgmma group in flight, and free
//       a stage to the producer (a second mbarrier) once its group is
//       done;
//     - where the tiles leave SMs idle (a 128-row prefill chunk, a short
//       prompt, a narrow projection: 4096 -> 1024 at M = 128 is 8 tiles),
//       K is split as in decode (kernels/matmul.py::wgmma_plan: tiles x
//       slices within one wave, at most 4 slices, the count from a cost
//       measured on the H100), each slice's f32 partial out and the tile's
//       last block summing them in slice order, reading whole rows so that
//       a warp's loads are contiguous;
//     - ragged M, N and K edges come from TMA's zero fill, and the store
//       is masked; B's tensor map is cached per (address, K, N) on the
//       host, since weights do not move; A's is encoded per call.
//
// * wgmma, the backward's two products (bf16, the training step): dX = dY
//   W^T (trans 1: A K-major, W read as B^T, K-major) and dW = X^T dY
//   (trans 2: X read as A^T and dY as B, both MN-major), on the operands
//   as they lie, no transposed copy.  At the training shapes (4,096 tokens
//   of llama3-8b) each product is 34-481 GFLOP on 42-160 MB: operations
//   bound, 0.04-0.49 ms at 989 TFLOP/s.  The forward's walk (a 128 x 128
//   tile a block, blockIdx.x along M), which these products took at
//   first, reads one whole operand from HBM for every 128-column strip
//   where that operand outgrows L2: dW of the MLP's down projection reads
//   its 117 MB X once for each of dY's 32 strips, 3.76 GB, 1.12 ms of
//   bytes for 0.49 ms of operations.  So matmul_bwd_kernel (the
//   forward keeps matmul_wgmma_kernel and its walk):
//     - is persistent: one block an SM (the grid is min(SMs, tiles x
//       slices)), each walking the output tiles t = blockIdx.x, + gridDim.x,
//       ... of a grouped order: GROUP_M M-tiles by every N-tile, M fastest
//       (kernels/matmul.py::bwd_walk, its twin).  The 132 tiles in flight
//       are 16 M-tiles by ~8 N-tiles: 2,048 rows of A and ~2,300 columns
//       of B, 18-26 MB over a 2,048-deep stretch of K, so each strip is
//       read from HBM about once a wave and reused from L2 by the wave's
//       other tiles (dW at mlp.wo: the strips its waves of 132 tiles read
//       come to 0.58 GB, where the forward's walk's, counted so, come to
//       3.25 GB);
//     - runs its producer ahead across tile boundaries: one TMA ring of
//       4 stages walks (tile, K step) without a break, so the next tile's
//       stages load while the consumers store this tile's outputs, and no
//       tile starts from an empty ring;
//     - takes 128 x 256 tiles: each consumer warpgroup holds 64 x 256 f32
//       accumulators (128 registers a thread; with a producer warp, not a
//       warpgroup, a block is 288 threads and each may hold 224) and runs
//       wgmma.m64n256k16, which reads 10 KB of shared memory for 512 K FLOP
//       where two m64n128k16 read 12 KB: the tensor cores, not shared
//       memory, set the pace.  MN-major operands come as 64 x 64 boxes (two
//       for A^T, four for B), K-major ones as one box (128 or 256 rows of
//       128 bytes);
//     - stores its outputs through shared memory: each consumer writes its
//       64 x 256 bf16 a 64 x 64 box at a time into one of two buffers and
//       one thread stores the box by TMA, so the next tile's products start
//       while the stores drain (stored from registers, as the forward
//       does, the products took 1.05-1.44x torch.matmul's time at the
//       training shapes on an H100, against 1.00-1.10x this way);
//     - keeps the forward's rules: TMA's zero fill for ragged edges and a
//       masked store, and split-K (kernels/matmul.py::wgmma_plan with
//       trans) where the tiles are too few for the SMs, each slice's f32
//       partial out and the tile's last slice summing them in slice order:
//       no float atomics, the same bits on every run.
//
// * simt: f32 (the tensor cores have no full-f32 product, and TF32 would
//   break the f32 tolerance) and bf16 shapes whose rows are not 16-byte
//   aligned.  The kernel of the first port, unchanged: a BM x BN tile a
//   block, f32 accumulators in registers, BK-deep tiles staged through
//   shared memory as f32 with one tile prefetched in registers; an 8 x 32
//   tile with a 128-deep K step for M <= 8, 64 x 64 x 16 otherwise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <array>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

namespace {

// ---------------------------------------------------------------------------
// simt: the first port's kernel (f32, and unaligned bf16)
// ---------------------------------------------------------------------------

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
              int M, int N, int K, long long sam, long long sak, long long sbk,
              long long sbn) {
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
    // element i of a thread's share of the A tile is (row, k) = a_rc(i), of
    // the B tile (k, column) = b_rc(i): consecutive threads on consecutive
    // addresses, along the operand's unit stride (a transposed operand of
    // the backward's products walks the other way)
    const bool a_rows = sak == 1, b_rows = sbn == 1;
    auto a_rc = [&](int i) { return a_rows ? make_int2(i / BK, i % BK) : make_int2(i % BM, i / BM); };
    auto b_rc = [&](int i) { return b_rows ? make_int2(i / BN, i % BN) : make_int2(i % BK, i / BK); };
    auto fetch = [&](int k0) {
#pragma unroll
        for (int s = 0; s < LA; ++s) {
            const int2 rc = a_rc(tid + s * NT);
            const int gr = row0 + rc.x, gc = k0 + rc.y;
            ra[s] = from_f32<T>(0.f);
            if (gr < M && gc < K) ra[s] = A[(size_t)gr * sam + (size_t)gc * sak];
        }
#pragma unroll
        for (int s = 0; s < LB; ++s) {
            const int2 rc = b_rc(tid + s * NT);
            const int gr = k0 + rc.x, gc = col0 + rc.y;
            rb[s] = from_f32<T>(0.f);
            if (gr < K && gc < N) rb[s] = B[(size_t)gr * sbk + (size_t)gc * sbn];
        }
    };

    fetch(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int s = 0; s < LA; ++s) {
            const int2 rc = a_rc(tid + s * NT);
            As[rc.y][rc.x] = to_f32(ra[s]);
        }
#pragma unroll
        for (int s = 0; s < LB; ++s) {
            const int2 rc = b_rc(tid + s * NT);
            Bs[rc.x][rc.y] = to_f32(rb[s]);
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

// element strides of A (sam along M, sak along K) and B (sbk, sbn): (K, 1,
// N, 1) for the forward's row-major operands; the backward's products pass
// a transposed operand's strides
template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch_simt(const void* a, const void* b, void* c, int M, int N, int K,
                 const long long* st, cudaStream_t s) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const dim3 block((BM / TM) * (BN / TN));
    matmul_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), M, N, K,
        st[0], st[1], st[2], st[3]);
}

template <typename T>
void dispatch_simt(const void* a, const void* b, void* c, int M, int N, int K,
                   const long long* st, cudaStream_t s) {
    if (M <= 8)
        launch_simt<T, 8, 32, 128, 1, 1>(a, b, c, M, N, K, st, s);   // decode: 256 threads
    else
        launch_simt<T, 64, 64, 16, 4, 4>(a, b, c, M, N, K, st, s);   // prefill: 256 threads
}

// ---------------------------------------------------------------------------
// PTX helpers (sm_90a)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, past L1, with L2 fetching the whole 128-byte
// line; src_bytes 0 writes 16 zeros (the masked edge)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices, transposed: lanes 8q..8q+7 give matrix q's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}
// A wait that never ends would hang the card; a stage arrives in microseconds,
// so after ~4M tries the kernel traps and the launch reports an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done;
    for (uint32_t tries = 0;; ++tries) {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        if (tries == (1u << 22)) __trap();
    }
}

// a 2-D box of a tensor map -> shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%3, %4}], [%2];\n"
                 :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
                    "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// a 2-D box of shared memory -> a tensor map's box in global memory (the
// edges past the tensor are not written), counted in this thread's bulk
// group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
                 : "memory");
}
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups are still reading shared memory
template <int N> __device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// this thread's shared-memory writes, made visible to the TMA unit
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// decode: split-K, cp.async ring, mma.sync on B^T A^T
// ---------------------------------------------------------------------------

namespace dec {
constexpr int BN = 128;          // columns of a block's tile
constexpr int BK = 32;           // rows of B a stage
constexpr int STAGES = 4;
constexpr int THREADS = 128;     // 4 warps
constexpr int WN = BN / (THREADS / 32);   // columns of a warp
constexpr int NJ = WN / 16;               // its 16-column mma tiles
constexpr int MMAX = 8;          // the mma's 8 columns: A's rows
constexpr int PITCH = BN + 8;    // a B row in shared memory, 16 bytes of pad (ldmatrix
                                 // rows 272 bytes apart fall in 8 distinct bank groups)
constexpr int TILE = BK * PITCH;
constexpr int SLICE_MAX = 1024;  // the longest K slice (kernels/matmul.py's plan)
constexpr int RING_BYTES = STAGES * TILE * 2;
constexpr int smem_bytes(int slice) { return RING_BYTES + MMAX * (slice + 8) * 2; }
}  // namespace dec

__global__ void __launch_bounds__(dec::THREADS)
matmul_decode_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     bf16* __restrict__ C, int M, int N, int K, int slice,
                     float* __restrict__ part, unsigned* __restrict__ tickets) {
    using namespace dec;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ bool last;
    bf16* Bs = reinterpret_cast<bf16*>(smem);             // STAGES tiles of BK x PITCH
    bf16* As = Bs + STAGES * TILE;                        // MMAX rows of slice + 8
    const int apitch = slice + 8;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tig = lane & 3;
    const int n0 = blockIdx.x * BN;
    const int split = blockIdx.y, splits = gridDim.y;
    const int k_lo = split * slice;
    const int k_hi = min(k_lo + slice, K);
    const int tiles = (k_hi - k_lo + BK - 1) / BK;

    // A's MMAX rows of this slice, zeros past M and K (K % 8 == 0: a 16-byte
    // chunk is all inside or all outside)
    const int chunks = slice / 8;
    for (int i = tid; i < MMAX * chunks; i += THREADS) {
        const int m = i / chunks, c = (i % chunks) * 8, k = k_lo + c;
        const bool in = m < M && k < K;
        cp_async16(smem_u32(As + m * apitch + c), in ? A + (size_t)m * K + k : A, in ? 16 : 0);
    }
    auto load_tile = [&](int t, int s) {
        bf16* dst = Bs + s * TILE;
        const int kt = k_lo + t * BK;
#pragma unroll
        for (int j = 0; j < BK * BN / 8 / THREADS; ++j) {
            const int i = tid + j * THREADS;
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;   // BN / 8 threads a row
            const int k = kt + r, n = n0 + c;
            const bool in = k < k_hi && n < N;
            cp_async16(smem_u32(dst + r * PITCH + c), in ? B + (size_t)k * N + n : B,
                       in ? 16 : 0);
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {     // A joins the first group
        if (s < tiles) load_tile(s, s);
        cp_async_commit();
    }

    float acc[NJ][4] = {};
    const int q = lane >> 3, r8 = lane & 7;     // ldmatrix: matrix q, row r8
    for (int t = 0; t < tiles; ++t) {
        cp_async_wait<STAGES - 2>();            // tile t (and A) has landed
        __syncthreads();                        // ... for every thread; stage t-1 is free
        const int nt = t + STAGES - 1;
        if (nt < tiles) load_tile(nt, nt % STAGES);
        cp_async_commit();
        const bf16* bs = Bs + (t % STAGES) * TILE;
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
            // the mma's B operand: A^T (k x m), k = 2 tig (+8), m = g
            const uint32_t* arow = reinterpret_cast<const uint32_t*>(
                As + g * apitch + t * BK + ks * 16);
            const uint32_t b0 = arow[tig], b1 = arow[tig + 4];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                // its A operand: B^T (n x k) of 16 columns; matrix q holds
                // k rows (q >> 1) * 8.. and n columns (q & 1) * 8..
                uint32_t a[4];
                ldmatrix_x4_trans(a, smem_u32(bs + (ks * 16 + (q >> 1) * 8 + r8) * PITCH
                                              + warp * WN + j * 16 + (q & 1) * 8));
                mma_16816(acc[j], a, b0, b1);
            }
        }
    }
    cp_async_wait<0>();

    // acc[j][e]: n = n0 + WN warp + 16 j + g + 8 (e >> 1), m = 2 tig + (e & 1)
    float* out = splits == 1 ? nullptr : part + (size_t)split * M * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int n = n0 + warp * WN + j * 16 + g + 8 * (e >> 1), m = 2 * tig + (e & 1);
            if (m < M && n < N) {
                if (out)
                    out[(size_t)m * N + n] = acc[j][e];
                else
                    C[(size_t)m * N + n] = __float2bfloat16(acc[j][e]);
            }
        }
    if (!out) return;
    __threadfence();                            // the partial is visible before the ticket
    __syncthreads();
    if (tid == 0) last = atomicAdd(&tickets[blockIdx.x], 1u) == static_cast<unsigned>(splits - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the tile's last block: the splits' partials in slice order (read past
    // L1), four columns of a row a thread (16-byte loads), eight slices'
    // loads in flight at once
    for (int i = tid; i < M * (BN / 4); i += THREADS) {
        const int m = i / (BN / 4), n = n0 + (i % (BN / 4)) * 4;
        if (n >= N) continue;                 // N % 8 == 0: four columns all in or out
        const float* p = part + (size_t)m * N + n;
        const size_t slab = (size_t)M * N;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int sp = 0; sp < splits; sp += 8) {
            float4 v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (sp + u < splits)
                    v[u] = __ldcg(reinterpret_cast<const float4*>(p + (sp + u) * slab));
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (sp + u < splits) {
                    s.x += v[u].x; s.y += v[u].y; s.z += v[u].z; s.w += v[u].w;
                }
        }
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(C + (size_t)m * N + n);
        o[0] = __floats2bfloat162_rn(s.x, s.y);
        o[1] = __floats2bfloat162_rn(s.z, s.w);
    }
    if (tid == 0) tickets[blockIdx.x] = 0;
}

// ---------------------------------------------------------------------------
// wgmma: TMA ring, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;              // 16 KB, K-major, 128-byte rows
constexpr int B_HALF = BK * 64 * 2;               // 8 KB: 64 k rows of 64 columns
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;   // + barriers, align
}  // namespace wg

// a wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 128 f32 of the warpgroup) = A (64 x 16) * B (16 x 128) + (scale_d ?
// d : 0); TA, TB the transpose bits: A K-major (0) or MN-major (1), B
// MN-major (1, the forward's row-major weight) or K-major (0)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// pins the accumulators: no other instruction touching d moves across the
// wgmma fence or a wait
template <int R> __device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void consumers_sync() {   // the two consumer warpgroups only
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {   // a named barrier
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// the forward, C = A B: A K-major, B (the row-major weight) MN-major
__global__ void __launch_bounds__(wg::THREADS, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                    bf16* __restrict__ C, int M, int N, int K, int slice,
                    float* __restrict__ part, unsigned* __restrict__ tickets) {
    using namespace wg;
    extern __shared__ unsigned char raw[];
    __shared__ bool last;
    // TMA's 128-byte swizzle wants each tile 1024-byte aligned
    unsigned char* buf = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(buf + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    const int group = threadIdx.x / 128, lt = threadIdx.x % 128;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    // this block's K steps: slice `split` of the plan (all of K unsplit)
    const int split = blockIdx.z, splits = gridDim.z;
    const int kt0 = split * (slice / BK);
    const int steps = min(kt0 + slice / BK, (K + BK - 1) / BK) - kt0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);       // the producer's expect_tx
            mbar_init(&empty[s], 8);      // each consumer warp, once its wgmma is done
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (group == 0) {                     // producer
        if (lt == 0) {
            for (int j = 0; j < steps; ++j) {
                const int s = j % STAGES, k = (kt0 + j) * BK;
                if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
                unsigned char* a = buf + s * STAGE_BYTES;
                mbar_expect_tx(&full[s], STAGE_BYTES);   // zero-filled bytes count too
                tma_load_2d(a, &ta, k, m0, &full[s]);
                tma_load_2d(a + A_BYTES, &tb, n0, k, &full[s]);
                tma_load_2d(a + A_BYTES + B_HALF, &tb, n0 + 64, k, &full[s]);
            }
        }
        return;
    }

    const int cw = group - 1;             // consumer: rows 64 cw .. of the tile
    // no zeroing: the tile's first wgmma starts d (scale-d 0).  Zeros written
    // by other instructions would sit inside the wgmma pipeline, and ptxas
    // answers that by serialising every wgmma (warning C7515)
    float d[64];
    for (int j = 0; j < steps; ++j) {
        const int s = j % STAGES;
        mbar_wait(&full[s], (j / STAGES) & 1);
        // this warpgroup's 64 rows of A: 64 K-major rows of 128 bytes
        const uint32_t a = smem_u32(buf + s * STAGE_BYTES) + cw * 64 * 128;
        const uint32_t b = smem_u32(buf + s * STAGE_BYTES + A_BYTES);
        fence_operands(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            // K-major A: 8-row groups 1024 bytes apart, k16 = 32 bytes on;
            // MN-major B: 8-row k groups 1024 bytes apart, the next 64
            // columns 8 KB on (LBO), k16 = 16 rows of 128 bytes on
            wgmma_m64n128k16<0, 1>(d, gmma_desc(a + kk * 32, 16, 1024),
                                   gmma_desc(b + kk * 2048, B_HALF, 1024), j > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();                  // step j - 1's products are done
        fence_operands(d);
        if (j > 0 && (lt & 31) == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_operands(d);

    // d[4i + e]: row 16 warp + g + 8 (e >> 1), column 8 i + 2 tig + (e & 1)
    const int warp = lt / 32, g = (lt & 31) >> 2, tig = lt & 3;
    const int row = m0 + cw * 64 + warp * 16 + g;
    if (splits > 1) {
        // split-K: the f32 partial out, a ticket for the tile, and the tile's
        // last block sums the partials in slice order, as the decode kernel
        float* mine = part + (size_t)split * M * N;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int col = n0 + 8 * i + 2 * tig;
            if (col >= N) continue;
            if (row < M)
                *reinterpret_cast<float2*>(mine + (size_t)row * N + col) =
                    make_float2(d[4 * i], d[4 * i + 1]);
            if (row + 8 < M)
                *reinterpret_cast<float2*>(mine + (size_t)(row + 8) * N + col) =
                    make_float2(d[4 * i + 2], d[4 * i + 3]);
        }
        __threadfence();                  // the partial is visible before the ticket
        consumers_sync();
        const int tile = blockIdx.y * gridDim.x + blockIdx.x;
        if (threadIdx.x == 128)
            last = atomicAdd(&tickets[tile], 1u) == static_cast<unsigned>(splits - 1);
        consumers_sync();
        if (!last) return;
        __threadfence();
        // the sum in rows: element (r, 4 q .. 4 q + 3) of the tile for
        // r * 32 + q = 256 u + t, so a warp reads 512 contiguous bytes of a
        // row and a thread keeps 16 loads in flight; d holds the sums
        const int t = threadIdx.x - 128;
        for (int z = 0; z < splits; ++z) {
            const float* p = part + (size_t)z * M * N;
#pragma unroll
            for (int u = 0; u < 16; ++u) {
                const int r = m0 + (u * 256 + t) / 32, c = n0 + ((u * 256 + t) % 32) * 4;
                if (r < M && c < N) {      // N % 4 == 0: four columns all in or all out
                    const float4 v = __ldcg(reinterpret_cast<const float4*>(
                        p + (size_t)r * N + c));
                    d[4 * u] = z ? d[4 * u] + v.x : v.x;
                    d[4 * u + 1] = z ? d[4 * u + 1] + v.y : v.y;
                    d[4 * u + 2] = z ? d[4 * u + 2] + v.z : v.z;
                    d[4 * u + 3] = z ? d[4 * u + 3] + v.w : v.w;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            const int r = m0 + (u * 256 + t) / 32, c = n0 + ((u * 256 + t) % 32) * 4;
            if (r < M && c < N) {
                __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(C + (size_t)r * N + c);
                o[0] = __floats2bfloat162_rn(d[4 * u], d[4 * u + 1]);
                o[1] = __floats2bfloat162_rn(d[4 * u + 2], d[4 * u + 3]);
            }
        }
        if (threadIdx.x == 128) tickets[tile] = 0;
        return;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const int col = n0 + 8 * i + 2 * tig;   // N even: col + 1 < N with col
        if (col >= N) continue;
        if (row < M)
            *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
                __floats2bfloat162_rn(d[4 * i], d[4 * i + 1]);
        if (row + 8 < M)
            *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + col) =
                __floats2bfloat162_rn(d[4 * i + 2], d[4 * i + 3]);
    }
}

// ---------------------------------------------------------------------------
// the backward's products: a persistent walk of 128 x 256 tiles
// ---------------------------------------------------------------------------

namespace pw {
constexpr int BM = 128, BN = 256, BK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 288;                      // two consumer warpgroups and a producer warp
constexpr int GROUP_M = 16;                       // M-tiles of a group of the walk
constexpr int A_BYTES = BM * BK * 2;              // 16 KB
constexpr int B_BYTES = BN * BK * 2;              // 32 KB
constexpr int BOX = 64 * BK * 2;                  // 8 KB: an MN-major box, 64 k rows of 64
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the epilogue: each consumer's 64 x 256 outputs leave in four 64 x 64
// boxes, through two 8 KB buffers of its own
constexpr int OUT_BOX = 64 * 64 * 2;
constexpr int OUT_BYTES = 2 * 2 * OUT_BOX;
constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + 2 * STAGES * 8 + 1024;   // + barriers, align
}  // namespace pw

// d (64 x 256 f32 of the warpgroup) = A (64 x 16) * B (16 x 256) + (scale_d ?
// d : 0); TA, TB the transpose bits, as wgmma_m64n128k16's
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// unit u of the walk: output tile u / splits in the grouped order (GROUP_M
// M-tiles by every N-tile, M fastest; kernels/matmul.py::bwd_walk), K slice
// u % splits; its first K step and its count
struct Unit {
    int tile, split, m0, n0, kt0, steps;
};
__device__ __forceinline__ Unit unit_at(int u, int tiles_m, int tiles_n, int splits, int per,
                                        int k_steps) {
    Unit w;
    w.tile = u / splits;
    w.split = u % splits;
    const int group = pw::GROUP_M * tiles_n;
    const int first = w.tile / group * pw::GROUP_M;
    const int rows = min(tiles_m - first, pw::GROUP_M);
    const int in = w.tile % group;
    w.m0 = (first + in % rows) * pw::BM;
    w.n0 = (in / rows) * pw::BN;
    w.kt0 = w.split * per;
    w.steps = min(w.kt0 + per, k_steps) - w.kt0;
    return w;
}

// TA == 0: A row-major (M, K), one 128 x 64 box a stage, K-major; TA == 1:
// A given as A^T, row-major (K, M) (dW = X^T dY: the activations X as they
// lie), two 64 x 64 boxes read MN-major, one a consumer warpgroup.  TB ==
// 0: B given as B^T, row-major (N, K) (dX = dY W^T: the weight W as it
// lies), one 256 x 64 box, K-major; TB == 1: B row-major (K, N), four 64 x
// 64 boxes, MN-major.  Neither is copied.
// tc: C's map, 64 x 64 boxes, 128-byte swizzle, for the epilogue's stores
// (a split-K sum writes C itself).
template <int TA, int TB>
__global__ void __launch_bounds__(pw::THREADS, 1)
matmul_bwd_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, bf16* __restrict__ C, int M, int N,
                  int K, int splits, int slice, float* __restrict__ part,
                  unsigned* __restrict__ tickets) {
    using namespace pw;
    extern __shared__ unsigned char raw[];
    __shared__ bool last;
    // TMA's 128-byte swizzle wants each tile 1024-byte aligned
    unsigned char* buf = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    unsigned char* out = buf + STAGES * STAGE_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(out + OUT_BYTES);
    uint64_t* empty = full + STAGES;
    const int group = threadIdx.x / 128, lt = threadIdx.x % 128;
    const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
    const int units = tiles_m * tiles_n * splits;
    const int k_steps = (K + BK - 1) / BK, per = slice / BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);       // the producer's expect_tx
            mbar_init(&empty[s], 8);      // each consumer warp, once its wgmma is done
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (group == 2) {                     // producer: one ring over every unit's K steps
        if (lt == 0) {
            int it = 0;
            for (int u = blockIdx.x; u < units; u += gridDim.x) {
                const Unit w = unit_at(u, tiles_m, tiles_n, splits, per, k_steps);
                for (int j = 0; j < w.steps; ++j, ++it) {
                    const int s = it % STAGES, k = (w.kt0 + j) * BK;
                    if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
                    unsigned char* a = buf + s * STAGE_BYTES;
                    unsigned char* b = a + A_BYTES;
                    mbar_expect_tx(&full[s], STAGE_BYTES);   // zero-filled bytes count too
                    if (TA) {
                        tma_load_2d(a, &ta, w.m0, k, &full[s]);
                        tma_load_2d(a + BOX, &ta, w.m0 + 64, k, &full[s]);
                    } else {
                        tma_load_2d(a, &ta, k, w.m0, &full[s]);
                    }
                    if (TB) {
#pragma unroll
                        for (int q = 0; q < BN / 64; ++q)
                            tma_load_2d(b + q * BOX, &tb, w.n0 + 64 * q, k, &full[s]);
                    } else {
                        tma_load_2d(b, &tb, k, w.n0, &full[s]);
                    }
                }
            }
        }
        return;
    }

    const int cw = group;                 // consumer: rows 64 cw .. of each tile
    const int warp = lt / 32, g = (lt & 31) >> 2, tig = lt & 3;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_at(u, tiles_m, tiles_n, splits, per, k_steps);
        // no zeroing: the unit's first wgmma starts d (scale-d 0), and no
        // other instruction writes d (ptxas would serialise the wgmmas)
        float d[128];
        for (int j = 0; j < w.steps; ++j, ++it) {
            const int s = it % STAGES;
            mbar_wait(&full[s], (it / STAGES) & 1);
            // this warpgroup's 64 rows of A: 64 K-major rows of 128 bytes,
            // or (TA) one of the two 64 x 64 MN-major boxes
            const uint32_t a = smem_u32(buf + s * STAGE_BYTES) + cw * BOX;
            const uint32_t b = smem_u32(buf + s * STAGE_BYTES + A_BYTES);
            fence_operands(d);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                // K-major: 8-row groups 1024 bytes apart, k16 = 32 bytes on;
                // MN-major: 8-row k groups 1024 bytes apart, the next 64
                // columns one box on (LBO), k16 = 16 rows of 128 bytes on
                wgmma_m64n256k16<TA, TB>(
                    d, TA ? gmma_desc(a + kk * 2048, BOX, 1024) : gmma_desc(a + kk * 32, 16, 1024),
                    TB ? gmma_desc(b + kk * 2048, BOX, 1024) : gmma_desc(b + kk * 32, 16, 1024),
                    j > 0 || kk > 0);
            wgmma_commit();
            wgmma_wait<1>();              // step j - 1's products are done
            fence_operands(d);
            if (j > 0 && (lt & 31) == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
        wgmma_wait<0>();
        fence_operands(d);
        if ((lt & 31) == 0) mbar_arrive(&empty[(it - 1) % STAGES]);   // the unit's last stage

        // d[4i + e]: row 16 warp + g + 8 (e >> 1), column 8 i + 2 tig + (e & 1)
        const int row = w.m0 + cw * 64 + warp * 16 + g;
        if (splits == 1) {
            // the outputs in bf16 through shared memory, a 64 x 64 box at a
            // time into this warpgroup's two buffers, each box stored by TMA
            // (which drops what lies past M and N) while the next tile's
            // products run.  A box's rows are 128 bytes, their 16-byte chunks
            // swizzled by the row (chunk i ^ row % 8, as TMA's 128-byte
            // swizzle reads them): the 8 rows a warp writes at once fall in
            // 8 chunks, so the writes take every bank once
#pragma unroll
            for (int q = 0; q < BN / 64; ++q) {
                unsigned char* box = out + (cw * 2 + (q & 1)) * OUT_BOX;
                if (lt == 0) bulk_wait_read<1>();   // this buffer's last store has read it
                bar_sync(2 + cw, 128);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float* e = d + 4 * (8 * q + i);
                    const int r = warp * 16 + g, off = ((i ^ g) << 4) + 4 * tig;
                    *reinterpret_cast<__nv_bfloat162*>(box + r * 128 + off) =
                        __floats2bfloat162_rn(e[0], e[1]);
                    *reinterpret_cast<__nv_bfloat162*>(box + (r + 8) * 128 + off) =
                        __floats2bfloat162_rn(e[2], e[3]);
                }
                fence_async_smem();
                bar_sync(2 + cw, 128);
                if (lt == 0) {
                    tma_store_2d(&tc, box, w.n0 + 64 * q, w.m0 + cw * 64);
                    bulk_commit();
                }
            }
            continue;
        }
        // split-K: the f32 partial out, a ticket for the tile, and the tile's
        // last slice to finish sums the partials in slice order
        float* mine = part + (size_t)w.split * M * N;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
            const int col = w.n0 + 8 * i + 2 * tig;
            if (col >= N) continue;
            if (row < M)
                *reinterpret_cast<float2*>(mine + (size_t)row * N + col) =
                    make_float2(d[4 * i], d[4 * i + 1]);
            if (row + 8 < M)
                *reinterpret_cast<float2*>(mine + (size_t)(row + 8) * N + col) =
                    make_float2(d[4 * i + 2], d[4 * i + 3]);
        }
        __threadfence();                  // the partial is visible before the ticket
        consumers_sync();
        if (threadIdx.x == 0)
            last = atomicAdd(&tickets[w.tile], 1u) == static_cast<unsigned>(splits - 1);
        consumers_sync();
        if (!last) continue;
        __threadfence();
        // the sum in rows, four columns a thread: element (r, 4 q .. 4 q + 3)
        // of the tile for r * 64 + q = 256 v + t, so a warp reads 512
        // contiguous bytes of a row; four such sums in flight (d is left
        // to the wgmmas)
        const int t = threadIdx.x;
#pragma unroll 4
        for (int v = 0; v < BM * BN / 4 / 256; ++v) {
            const int r = w.m0 + (v * 256 + t) / (BN / 4), c = w.n0 + ((v * 256 + t) % (BN / 4)) * 4;
            if (r >= M || c >= N) continue;   // N % 4 == 0: four columns all in or all out
            const float* p = part + (size_t)r * N + c;
            float4 sum = __ldcg(reinterpret_cast<const float4*>(p));
            for (int z = 1; z < splits; ++z) {
                const float4 x = __ldcg(reinterpret_cast<const float4*>(p + (size_t)z * M * N));
                sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
            }
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(C + (size_t)r * N + c);
            o[0] = __floats2bfloat162_rn(sum.x, sum.y);
            o[1] = __floats2bfloat162_rn(sum.z, sum.w);
        }
        if (threadIdx.x == 0) tickets[w.tile] = 0;
    }
    if (lt == 0) bulk_wait_read<0>();    // shared memory outlives the stores' reads
}

// ---------------------------------------------------------------------------
// host: tensor maps (cuTensorMapEncodeTiled from libcuda.so.1, found at run
// time, so nothing links against libcuda) and B's map cache
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
    static EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
        return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
                   : nullptr;
    }();
    return fn;
}

// a row-major (rows, cols) bf16 matrix, boxes of (box_rows, box_cols), 128-byte
// swizzle, zeros outside
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int box_cols) {
    const EncodeTiled fn = encode_fn();
    if (!fn) return false;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t estr[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
              box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// B's map by (address, rows, cols, box rows): a weight's map is encoded
// once (the forward's (K, N) in 64 x 64 boxes, the backward's W as B^T in
// 128 x 64 boxes).  The key fixes every field of the map, so an entry is
// never stale, even for a new tensor at a freed one's address.
bool weight_map(CUtensorMap* map, const void* b, int rows, int cols, int box_rows) {
    using Key = std::tuple<uintptr_t, int, int, int>;
    using Raw = std::array<unsigned char, sizeof(CUtensorMap)>;
    static std::mutex mu;
    static std::map<Key, Raw> cache;
    const Key key{reinterpret_cast<uintptr_t>(b), rows, cols, box_rows};
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it == cache.end()) {
        if (!encode(map, b, rows, cols, box_rows, 64)) return false;
        if (cache.size() >= 4096) cache.clear();
        Raw bytes;
        std::memcpy(bytes.data(), map, sizeof(CUtensorMap));
        cache.emplace(key, bytes);
        return true;
    }
    std::memcpy(map, it->second.data(), sizeof(CUtensorMap));
    return true;
}

// the dynamic shared memory a kernel may take, raised once per device
bool allow_smem(const void* kernel, int bytes, bool* done) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return false;
    if (!done[dev]) {
        if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
            != cudaSuccess)
            return false;
        done[dev] = true;
    }
    return true;
}

// a plan of `splits` slices of `slice` (a multiple of `step`) covers K, none
// empty, and has a workspace if it splits
bool plan_ok(int K, int splits, int slice, int step, const void* tickets,
             const void* partials) {
    return splits >= 1 && slice >= step && slice % step == 0 &&
           static_cast<long long>(splits - 1) * slice < K &&
           static_cast<long long>(splits) * slice >= K &&
           (splits == 1 || (tickets && partials));
}

int launch_decode(const void* a, const void* b, void* c, int M, int N, int K, int splits,
                  int slice, void* tickets, void* partials, cudaStream_t s) {
    static bool done[64] = {};
    if (M > dec::MMAX || slice > dec::SLICE_MAX ||
        !plan_ok(K, splits, slice, dec::BK, tickets, partials))
        return static_cast<int>(cudaErrorInvalidValue);
    if (!allow_smem(reinterpret_cast<const void*>(matmul_decode_kernel),
                    dec::smem_bytes(dec::SLICE_MAX), done))
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + dec::BN - 1) / dec::BN, splits);
    matmul_decode_kernel<<<grid, dec::THREADS, dec::smem_bytes(slice), s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c),
        M, N, K, slice, static_cast<float*>(partials), static_cast<unsigned*>(tickets));
    return static_cast<int>(cudaGetLastError());
}

// the device's SMs, read once per device: the persistent grid's size
int sm_count() {
    static int count[64] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (!count[dev] &&
        cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        count[dev] = 0;
    return count[dev];
}

// the backward's products: trans 1, C = A B^T with b the row-major (N, K)
// B^T; trans 2, C = A^T B with a the row-major (K, M) A^T
template <int TA, int TB>
int launch_bwd(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc, void* c,
               int M, int N, int K, int splits, int slice, void* tickets, void* partials,
               cudaStream_t s) {
    static bool done[64] = {};
    if (!allow_smem(reinterpret_cast<const void*>(matmul_bwd_kernel<TA, TB>), pw::SMEM, done))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long units = static_cast<long long>((M + pw::BM - 1) / pw::BM) *
                            ((N + pw::BN - 1) / pw::BN) * splits;
    const int sms = sm_count();
    if (sms <= 0 || units >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
    matmul_bwd_kernel<TA, TB><<<static_cast<int>(units < sms ? units : sms), pw::THREADS,
                                pw::SMEM, s>>>(
        ta, tb, tc, static_cast<bf16*>(c), M, N, K, splits, slice,
        static_cast<float*>(partials), static_cast<unsigned*>(tickets));
    return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K, int trans,
                 int splits, int slice, void* tickets, void* partials, cudaStream_t s) {
    if (!plan_ok(K, splits, slice, wg::BK, tickets, partials))
        return static_cast<int>(cudaErrorInvalidValue);
    alignas(64) CUtensorMap ta, tb;
    if (trans == 0) {                     // the forward: a block a tile
        static bool done[64] = {};
        // b is the weight, whose map is cached
        if (!encode(&ta, a, M, K, wg::BM, wg::BK) || !weight_map(&tb, b, K, N, wg::BK) ||
            !allow_smem(reinterpret_cast<const void*>(matmul_wgmma_kernel), wg::SMEM, done))
            return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid((M + wg::BM - 1) / wg::BM, (N + wg::BN - 1) / wg::BN, splits);
        matmul_wgmma_kernel<<<grid, wg::THREADS, wg::SMEM, s>>>(
            ta, tb, static_cast<bf16*>(c), M, N, K, slice, static_cast<float*>(partials),
            static_cast<unsigned*>(tickets));
        return static_cast<int>(cudaGetLastError());
    }
    // trans 1: a = dC as A (M, K), b = the weight as B^T (N, K), cached;
    // trans 2: a = the activations as A^T (K, M), b = dC (K, N), new on
    // every call, encoded as A's map is; C's map for the epilogue's stores
    alignas(64) CUtensorMap tc;
    const bool ok = (trans == 1
        ? encode(&ta, a, M, K, pw::BM, pw::BK) && weight_map(&tb, b, N, K, pw::BN)
        : encode(&ta, a, K, M, 64, 64) && encode(&tb, b, K, N, pw::BK, 64))
        && encode(&tc, c, M, N, 64, 64);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    return trans == 1
        ? launch_bwd<0, 0>(ta, tb, tc, c, M, N, K, splits, slice, tickets, partials, s)
        : launch_bwd<1, 1>(ta, tb, tc, c, M, N, K, splits, slice, tickets, partials, s);
}

}  // namespace

// C (M, N) = op(A) op(B), K the contraction; trans names the product, on
// the operands as they lie (no transposed copy): 0, the forward C = A B
// with a (M, K) and b (K, N); 1, the backward's dA = dC B^T, passed as a =
// dC (M, K) and b = B, the row-major (N, K) B^T; 2, its dB = A^T dC, passed
// as a = A, the row-major (K, M) A^T, and b = dC (K, N).
// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = simt (any dtype, any
// trans), 1 = decode (bf16, trans 0, M <= 8), 2 = wgmma (bf16); decode and
// wgmma need K > 0, K and N multiples of 8 (M too for trans 2) and 16-byte
// aligned operands, and take a split-K plan (splits slices of slice
// elements of K) and, for splits > 1, the workspace: tickets (one per
// output tile: 128 columns for decode, 128 x 128 for the forward's wgmma,
// 128 x 256 for the backward's; zero, and left zero) and splits * M * N
// f32 partials.  wgmma takes matmul_wgmma_kernel for trans 0 and
// matmul_bwd_kernel, persistent, for trans 1 and 2.
// Pointers are device pointers to contiguous row-major tensors; the launch
// goes on `stream` and does not synchronise.  Returns cudaGetLastError()
// after the launch (0 = success), or cudaErrorInvalidValue for arguments
// the variant does not take.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                            int trans, int dtype, int variant, int splits, int slice,
                            void* tickets, void* partials, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (trans < 0 || trans > 2) return static_cast<int>(cudaErrorInvalidValue);
    if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
    if (variant == 0) {
        // element strides: A (M, K) or A^T's (K, M); B (K, N) or B^T's (N, K)
        const long long st[4] = {trans == 2 ? 1 : K, trans == 2 ? M : 1,
                                 trans == 1 ? 1 : N, trans == 1 ? K : 1};
        if (dtype == 0)
            dispatch_simt<float>(a, b, c, M, N, K, st, s);
        else if (dtype == 1)
            dispatch_simt<bf16>(a, b, c, M, N, K, st, s);
        else
            return static_cast<int>(cudaErrorInvalidValue);
        return static_cast<int>(cudaGetLastError());
    }
    const bool aligned = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)
                          | reinterpret_cast<uintptr_t>(c)) % 16 == 0;
    if (dtype != 1 || K <= 0 || K % 8 || N % 8 || (trans == 2 && M % 8) || !aligned)
        return static_cast<int>(cudaErrorInvalidValue);
    if (variant == 1 && trans == 0)
        return launch_decode(a, b, c, M, N, K, splits, slice, tickets, partials, s);
    if (variant == 2)
        return launch_wgmma(a, b, c, M, N, K, trans, splits, slice, tickets, partials, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

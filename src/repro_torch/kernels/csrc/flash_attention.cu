// Causal / sliding-window GQA attention, forward: out[b, h] = softmax(q[b, h]
// k[b, h / (Hq / Hkv)]^T / sqrt(D) + mask) v[b, h / (Hq / Hkv)].  f32
// statistics and accumulation, output in q's dtype (bf16 or f32).
//
//   q    (B, Hq, S, D)   by strides, last dim contiguous
//   k, v (B, Hkv, Sk, D) by strides, last dim contiguous
//   out  (B, Hq, S, D)   by strides, last dim contiguous
// Query i and key j are both counted from 0; key j is visible to query i when
// j < Sk, j <= i (causal) and i - j < window (window > 0).  A row with no
// visible key writes zeros.  Each call is one launch, and the same inputs
// give the same bits on every run (no atomics).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:118
// (flash_attention, _attn_kernel at :50-90): a (B*Hq, S/bq, Sk/bk) grid whose
// innermost, sequential kv axis carries the online softmax's m, l and acc in
// VMEM scratch, with the GQA head mapping h // (Hq / Hkv) in the index maps.
//
// Two kernels; kernels/flash_attention.py::variant picks one from (S, Sk, D,
// dtype):
//
// * wgmma (bf16, D = 64, 96 or 128, Sk > 0): the serving path's prefills
//   (llama3-8b: B = 1, 32 q heads over 8 kv heads of 128, S = 35-445;
//   phi3-mini: 32 over 32 of 96).
//   What bounds it on an H100: causal S = 512 is 2.2 GFLOP of Q K^T and P V
//   (2.2 us at 989 TFLOP/s; 3.3 us with the split P V below) on ~10 MB of
//   q, k, v and out (3.1 us at 3.35 TB/s): near the ridge, and at these
//   lengths a block walks at most 8 key tiles, so latency -- TMA round
//   trips, the softmax between two products, and a wave of blocks that does
//   not fill 132 SMs -- bounds it as much as bytes or operations.  So:
//     - one block a (b, q head, 64-row q tile): 4 x 32 = 128 blocks at
//       S = 223 on 132 SMs (128-row tiles, or one block for the four q heads
//       of a kv head, would give 64 or 32); the four blocks of a kv head
//       read its K/V through L2 (0.9 MB at S = 223).  The q tiles run
//       longest first (the causal walk is longest for the last rows);
//     - a producer warp issues TMA copies (128-byte swizzle, the 256-byte
//       rows of D = 128 as two 64-column boxes, D = 96's 192-byte rows as
//       two boxes whose last 32 columns TMA fills with zeros) of the Q
//       tile once and of 64-key K and V tiles into a 2-stage ring behind
//       mbarriers; tensor maps are 4-D (D, then H, S and B in the order of
//       their strides), so the model's transposed (B, S, H, D) views are
//       read in place, and rows past S or Sk come in as zeros;
//     - one consumer warpgroup computes S = Q K^T by wgmma.m64n64k16 from
//       shared memory (K is K-major: no transpose) into f32 registers, and
//       runs the online softmax on the accumulator fragment: each thread
//       holds 2 rows x 16 keys, row max and row sum across the 4 lanes of a
//       row, one FFMA and one ex2.approx a score with the scale folded in
//       (~2^-22 from the reference's exp).  Only the tiles that cross the
//       diagonal, Sk or the window's edge are masked (p = 0 exactly); tiles
//       above the diagonal or below the window are never loaded;
//     - O += P V by wgmma.m64n{64|128}k16 with A from registers (the S
//       fragment is the A fragment: no shuffles) and V read MN-major
//       (transpose bit).
//       P rounded to bf16 moves near-zero outputs by ~1e-4, 10-200x the
//       check's atol, so P = P_hi + P_lo, two bf16 halves, and O += P_hi V +
//       P_lo V: 1.5x the operations, within ~2^-16 of f32 P;
//     - the next tile's Q K^T is issued with this tile's P V, so the tensor
//       cores run them back to back.  The softmax does not overlap them: a
//       read of S while P V is in flight (wait_group 1) makes ptxas
//       serialise every wgmma (C7514), which cost more than the overlap
//       gave; with two blocks an SM (from S = 512), one block's softmax runs
//       beside the other's products;
//     - the rows are scaled by 1 / (their f32 sum) once, at the store,
//       through out's strides; under autograd, where the backward is its
//       stats variant (flash_attention_bwd.cu), the store also writes each
//       row's L2 = m sl2 + log2 l and the f32 output (lse, o32; null on the
//       serving path, which writes nothing more).
//   The cross-attention shape (4, 32/8 heads, 1,024 rows, 6,404 keys, 128;
//   testing/flash_probe.py --cross) spends ~1,200 of a key tile's ~2,800
//   cycles in the softmax and split, ~950 in the products and ~700 before
//   them, which is not the loads (a build without them, -DFLASH_NO_KV_LOADS,
//   takes 1.31 ms a call against 1.34); two blocks an SM overlap one's
//   softmax with the other's products.  A warp-specialised redesign (two consumer warpgroups of 64
//   rows sharing a 6-stage K/V ring, ping-pong on named barriers,
//   setmaxnreg, blocks in kv-head order) was right on the card but slower
//   at every shape (1.34-1.60 ms at that shape against 1.24-1.26): the
//   softmax, not the tensor cores or the bytes, bounds it, and one
//   warpgroup's softmax at a time hides less latency than two blocks do.
//   ptxas (-Xptxas -v, printed by chip_smoke.py phase 2) reports no spills
//   and no wgmma serialisation: 159 registers at D = 128, 82,984 bytes of
//   shared memory a block.  D = 96 (phi3-mini) runs D = 128's products on
//   tiles padded to 128 columns (flash_wgmma.cuh): Q K^T over its 6 k16
//   steps, P V at n128 with zero columns past 96, which are neither
//   rescaled nor stored (in the model's (B, S, H, D) layout they would be
//   the next head's); 1/sqrt(96) scales the scores.
//
// * simt (f32, and any head dim or input the wgmma kernel does not take:
//   D = 16, 32, unaligned views): the first port's kernel, unchanged.  One
//   block of threads owns one (b, h, 64-row q tile) and loops over the
//   32-key k tiles itself, from the window's lower edge up to the causal
//   limit; CUDA-core f32 math (each thread a 4 x 4 block of scores and a
//   4 x (D/8) block of the output), tiles staged through shared memory.
//   Masked scores get p = 0 explicitly, so a row with no visible key keeps
//   l == 0 and writes zeros (the TPU kernel's flush assumes l == 0 on such
//   rows, which holds only with that mask).  Head dims 16, 32, 64, 96 and
//   128: at D = 96 (phi3-mini) a thread holds 12 output columns, a row is
//   12 (bf16) or 24 (f32) 16-byte loads, and a block takes 57,984 bytes of
//   shared memory.

#include "flash_wgmma.cuh"

namespace {

constexpr int BQ = 64, BK = 32;          // q rows and keys of a tile
constexpr int NT = 128;                  // 16 thread rows x 8 thread columns
constexpr int TR = 16, TC = 8;
constexpr int RI = BQ / TR;              // score and output rows per thread (4)
constexpr int CJ = BK / TC;              // score columns per thread (4)

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
        case 96: return launch<T, 96>(q, k, v, o, B, Hq, Hkv, S, Sk, causal, window, st, s);
        case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, Sk, causal, window, st, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// wgmma: bf16, D = 64, 96 or 128 (its PTX helpers and products:
// flash_wgmma.cuh)
// ---------------------------------------------------------------------------

namespace fw {
constexpr int BQ = 64, BK = 64;        // q rows of a block, keys of a ring stage
constexpr int STAGES = 2;
constexpr int THREADS = 160;           // a consumer warpgroup and a producer warp
constexpr int BOX = wg::BOX;
constexpr float LOG2E = wg::LOG2E;
template <int D> struct Smem {
    static constexpr int BOXES = ROW_BOXES<D>;    // 64-column boxes of a row
    static constexpr int TILE = BOXES * BOX;      // Q, or K or V of a stage
    static constexpr int STAGE = 2 * TILE;
    static constexpr int BYTES = TILE + STAGES * STAGE + (2 * STAGES + 1) * 8 + 1024;
};
}  // namespace fw

// Cycle stamps of the consumer's phases (thread 0 of each block, 32 slots a
// block), read by repro_flash_cycles; compiled only with -DFLASH_CYCLES
// (testing/flash_probe.py), so the library the port loads has none
#ifdef FLASH_CYCLES
__device__ long long flash_cycles[1 << 20];
#define STAMP(slot) \
    if (lt == 0) flash_cycles[(blockIdx.y * gridDim.x + blockIdx.x) * 32 + (slot)] = clock64()
#else
#define STAMP(slot)
#endif

#define POS_INF __int_as_float(0x7f800000)

// STATS: the instance autograd's forward takes for a stats backward, which
// also writes lse and o32; the serving path's instance has no such code
template <int D, bool STATS>
__global__ void __launch_bounds__(fw::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                   long long o_sb, long long o_sh, long long o_ss, float* __restrict__ lse,
                   float* __restrict__ o32, int Sp, int Hq, int Hkv, int S, int Sk, int causal,
                   int window, float sl2, int qpos, int kpos, int vpos) {
    // the names of fw, not the simt kernel's BQ and BK
    constexpr int BQ = fw::BQ, BK = fw::BK, STAGES = fw::STAGES, BOX = fw::BOX;
    using L = fw::Smem<D>;
    extern __shared__ unsigned char raw[];
    // TMA's 128-byte swizzle wants each box 1024-byte aligned
    unsigned char* buf = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    unsigned char* ring = buf + L::TILE;                 // Q first, then the stages
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE);
    uint64_t* empty = full + STAGES;
    uint64_t* qbar = empty + STAGES;

    const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;    // the longest walks first
    // the keys this tile can see: from the lowest row's window edge to the
    // highest row's causal limit (kernels/flash_attention.py::tile_plan)
    int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
    const int tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);       // the producer's expect_tx
            mbar_init(&empty[s], 4);      // each consumer warp, once P V is done
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 128) {             // the producer warp
        if (threadIdx.x == 128 && tiles > 0) {
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
            mbar_expect_tx(qbar, L::TILE);
            for (int x = 0; x < L::BOXES; ++x)
                tma_rows(buf + x * BOX, &tq, qpos, 64 * x, h, q0, b, qbar);
            for (int j = 0; j < tiles; ++j) {
                const int s = j % STAGES, k0 = k_lo + j * BK;
                if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
#ifdef FLASH_NO_KV_LOADS
                // testing/flash_probe.py --cross: the stages' first tiles
                // again, no load (wrong results; the time without the loads)
                if (j >= STAGES) {
                    mbar_arrive(&full[s]);
                    continue;
                }
#endif
                unsigned char* st = ring + s * L::STAGE;
                mbar_expect_tx(&full[s], L::STAGE);   // zero-filled bytes count too
                for (int x = 0; x < L::BOXES; ++x) {
                    tma_rows(st + x * BOX, &tk, kpos, 64 * x, hk, k0, b, &full[s]);
                    tma_rows(st + L::TILE + x * BOX, &tv, vpos, 64 * x, hk, k0, b, &full[s]);
                }
            }
        }
        return;
    }

    // the consumer warpgroup: thread (warp, g, tig) holds rows r0 and r0 + 8
    const int lt = threadIdx.x, warp = lt / 32, g = (lt & 31) >> 2, tig = lt & 3;
    const int r0 = q0 + warp * 16 + g;
    STAMP(0);
    const uint32_t qs = smem_u32(buf), rs = smem_u32(ring);
    auto needs_mask = [&](int k0) {
        return k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
               (window > 0 && k0 < q0 + BQ - window);
    };
    // no zeroing: O's first wgmma starts it (scale-d 0), and S's each tile;
    // O's columns past D (D = 96: 96-127) come out zero and are never read
    float o[ROW_COLS<D> / 2], sc[32];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t hi[4][4], lo[4][4];
    if (tiles > 0) {
        mbar_wait(qbar, 0);
        mbar_wait(&full[0], 0);
        STAMP(1);
        qk_issue<D>(sc, qs, rs);
        wgmma_wait<0>();
        fence_operands(sc);
        online_softmax(sc, m, l, alpha, needs_mask(k_lo), r0, k_lo + 2 * tig, Sk, causal,
                       window, sl2);
        split_p(sc, hi, lo);
        STAMP(2);
    }
    for (int j = 0; j < tiles; ++j) {
        const int s = j % STAGES;
        const bool next = j + 1 < tiles;
        // the next tile's S and this tile's P V in one go, so the tensor cores
        // run them back to back.  Both are waited for before the softmax: a
        // read of S while P V is in flight (wait_group 1) makes ptxas
        // serialise every wgmma (C7514)
        if (next) {
            const int sn = (j + 1) % STAGES;
            mbar_wait(&full[sn], ((j + 1) / STAGES) & 1);
            qk_issue<D>(sc, qs, rs + sn * L::STAGE);
        }
        STAMP(3 + 3 * min(j, 8));
        pv_issue<D>(o, hi, lo, rs + s * L::STAGE + L::TILE, j == 0);
        wgmma_wait<0>();                  // this tile's P V is done: free its stage
        STAMP(4 + 3 * min(j, 8));
        fence_operands(sc);
        fence_operands(o);
        fence_operands(hi);
        fence_operands(lo);
        if ((lt & 31) == 0) mbar_arrive(&empty[s]);
        if (next) {
            const int k0 = k_lo + (j + 1) * BK;
            online_softmax(sc, m, l, alpha, needs_mask(k0), r0, k0 + 2 * tig, Sk, causal,
                           window, sl2);
            // the columns past D are zero and stay so
#pragma unroll
            for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
            split_p(sc, hi, lo);
            STAMP(5 + 3 * min(j, 8));
        }
    }
    STAMP(30);

    // o[4i + e]: row r0 + 8 (e >> 1), column 8 i + 2 tig + (e & 1); the rows'
    // sums from their 4 threads; a row with no visible key writes zeros.
    // Only the D columns of a row are stored: in the model's (B, S, H, D)
    // layout the next ones are the next head's.  STATS (autograd's forward
    // for the stats backward) also writes each row's L2 = m sl2 + log2 l
    // (+inf past S or with no visible key) in rows padded to Sp, and the f32
    // output (B, Hq, S, D)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    bf16* ob = out + b * o_sb + h * o_sh;
    const long long row0 = static_cast<long long>(bh) * Sp;    // bh = b Hq + h
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = r0 + 8 * r;
        if (STATS && tig == 0 && qi < Sp)
            lse[row0 + qi] = l[r] > 0.f && qi < S ? m[r] * sl2 + log2f(l[r]) : POS_INF;
        if (qi >= S) continue;
        float* of = STATS ? o32 + (static_cast<long long>(bh) * S + qi) * D : nullptr;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            // o is never read where no tile ran (l == 0)
            const float x0 = l[r] > 0.f ? o[4 * i + 2 * r] * inv[r] : 0.f;
            const float x1 = l[r] > 0.f ? o[4 * i + 2 * r + 1] * inv[r] : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(ob + qi * o_ss + 8 * i + 2 * tig) =
                __floats2bfloat162_rn(x0, x1);
            if (STATS)
                *reinterpret_cast<float2*>(of + 8 * i + 2 * tig) = make_float2(x0, x1);
        }
    }
    STAMP(31);
}

// ---------------------------------------------------------------------------
// host (tensor maps and the shared-memory opt-in: flash_wgmma.cuh)
// ---------------------------------------------------------------------------

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, float* o32,
                 int B, int Hq, int Hkv, int S, int Sk, int causal, int window,
                 const long long* st, cudaStream_t s) {
    static bool done[2][64] = {};
    alignas(64) CUtensorMap tq, tk, tv;
    const int pq = encode_bhsd(&tq, q, B, Hq, S, D, st[0], st[1], st[2], fw::BQ);
    const int pk = encode_bhsd(&tk, k, B, Hkv, Sk, D, st[3], st[4], st[5], fw::BK);
    const int pv = encode_bhsd(&tv, v, B, Hkv, Sk, D, st[6], st[7], st[8], fw::BK);
    if (pq < 0 || pk < 0 || pv < 0) return static_cast<int>(cudaErrorInvalidValue);
    const bool stats = lse != nullptr;
    const void* kernel = stats ? reinterpret_cast<const void*>(flash_wgmma_kernel<D, true>)
                               : reinterpret_cast<const void*>(flash_wgmma_kernel<D, false>);
    if (!allow_smem(kernel, fw::Smem<D>::BYTES, done[stats]))
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(B * Hq, (S + fw::BQ - 1) / fw::BQ);
    const int Sp = (S + fw::BQ - 1) / fw::BQ * fw::BQ;
    // the scale of the real D (96, not the 128 columns its tiles hold)
    const float sl2 = fw::LOG2E / sqrtf(static_cast<float>(D));
    if (stats)
        flash_wgmma_kernel<D, true><<<grid, fw::THREADS, fw::Smem<D>::BYTES, s>>>(
            tq, tk, tv, static_cast<bf16*>(o), st[9], st[10], st[11], lse, o32, Sp, Hq, Hkv,
            S, Sk, causal, window, sl2, pq, pk, pv);
    else
        flash_wgmma_kernel<D, false><<<grid, fw::THREADS, fw::Smem<D>::BYTES, s>>>(
            tq, tk, tv, static_cast<bf16*>(o), st[9], st[10], st[11], nullptr, nullptr, Sp,
            Hq, Hkv, S, Sk, causal, window, sl2, pq, pk, pv);
    return static_cast<int>(cudaGetLastError());
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, float* o32,
                   int B, int Hq, int Hkv, int S, int Sk, int D, int causal, int window,
                   const long long* st, cudaStream_t s) {
    if (Sk <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
        case 64: return launch_wgmma<64>(q, k, v, o, lse, o32, B, Hq, Hkv, S, Sk, causal,
                                         window, st, s);
        case 96: return launch_wgmma<96>(q, k, v, o, lse, o32, B, Hq, Hkv, S, Sk, causal,
                                         window, st, s);
        case 128: return launch_wgmma<128>(q, k, v, o, lse, o32, B, Hq, Hkv, S, Sk, causal,
                                           window, st, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = simt (D 16, 32, 64, 96
// or 128), 1 = wgmma (bf16, D 64, 96 or 128, S and Sk > 0).  `strides` holds
// 12 element strides: (batch, head, seq) of q, k, v and out, in that order;
// the last dim of each is contiguous and every pointer and stride is
// 16-byte aligned (the caller checks).  window <= 0 means no window.  lse
// and o32 (wgmma only; both null on the serving path) take each row's L2
// (f32, B * Hq * Sp with Sp = S rounded up to 64) and the f32 output (B,
// Hq, S, D, contiguous) for the stats backward.  The launch goes on
// `stream` and does not synchronise.  Returns cudaGetLastError() after the
// launch (0 = success), or cudaErrorInvalidValue for arguments the variant
// does not take.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int Hq, int Hkv, int S, int Sk, int D,
                                     int causal, int window, const long long* strides,
                                     int dtype, int variant, void* lse, void* o32,
                                     void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if ((lse == nullptr) != (o32 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    if (variant == 1) {
        if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
        return dispatch_wgmma(q, k, v, out, static_cast<float*>(lse), static_cast<float*>(o32),
                              B, Hq, Hkv, S, Sk, D, causal, window, strides, s);
    }
    if (lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
        return dispatch<float>(q, k, v, out, B, Hq, Hkv, S, Sk, D, causal, window, strides, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, Sk, D, causal, window,
                                       strides, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef FLASH_CYCLES
// the first n stamps of the last launch of the cycle-stamped build
extern "C" int repro_flash_cycles(long long* host, int n) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, flash_cycles, n * sizeof(long long)));
}
#endif

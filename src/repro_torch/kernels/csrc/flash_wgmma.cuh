// The Hopper pieces of the flash-attention kernels, shared by the forward
// (flash_attention.cu: flash_wgmma_kernel, flash_tf32_kernel) and the
// backward (flash_attention_bwd.cu: flash_bwd_dq_wgmma_kernel,
// flash_bwd_dkv_wgmma_kernel and the tf32x3 pair): mbarriers, TMA loads of
// (B, H, S, D) tensors through 4-D tensor maps, bulk copies, the online
// softmax on an accumulator fragment, the f32 kernels' TF32 split and their
// wgmma and mma.sync forms (below, "TF32 in three products"), and the two
// bf16 wgmma forms every product of the bf16 kernels is one of:
//
//   qk_issue   C (64 x 64 f32) = A B^T, A and B 64-row tiles of D columns,
//              both K-major in shared memory (m64n64k16, D / 16 steps);
//   pv_issue   C (64 x ROW_COLS<D> f32) += X Y with X a 64 x 64 f32
//              fragment in registers, split by split_p into two bf16 halves
//              (X_hi + X_lo, within ~2^-16 of X), and Y a 64-row tile read
//              MN-major (transpose bit; m64n{ROW_COLS<D>}k16, 4 steps, each
//              hi then lo).
//
// A tile is 64 rows of D bf16 as ROW_BOXES<D> boxes of 64 rows x 128
// bytes, with TMA's 128-byte swizzle, each box 1024-byte aligned.  D = 96
// (phi3-mini) takes two: the tensor map's extent stays 96, so TMA fills
// columns 96-127 of the second box with zeros; Q K^T runs over the 6 k16
// steps that hold data, P V over all ROW_COLS<96> = 128 columns (the last
// 32 come out zero and are never stored).  So D = 96 takes D = 128's
// instruction forms, at 4/3 the N-side products an exact width would
// need.  An m64n64 f32 accumulator fragment is, as it lies, the A fragment
// of the next product: thread (warp w, group g, tig) holds rows 16 w + g
// and + 8, columns 8 i + 2 tig and + 1 (i = 0..7).
//
// Included once by each source, inside nothing: every name is local to
// the translation unit (an anonymous namespace).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;

namespace wg {
constexpr int BOX = 64 * 64 * 2;       // 8 KB: 64 rows of 64 bf16 (128 bytes)
constexpr float LOG2E = 1.4426950408889634f;
}  // namespace wg

// the 64-column boxes a row of D takes, and the columns they hold
// (kernels/flash_attention.py::box_plan mirrors both)
template <int D> constexpr int ROW_BOXES = (D + 63) / 64;
template <int D> constexpr int ROW_COLS = 64 * ROW_BOXES<D>;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// A wait that never ends would hang the card; a tile arrives in microseconds,
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

// a 4-D box of a tensor map -> shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
                 :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
                    "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// a box of 64 D columns from column d and the rows from s of head h of batch
// b; `pos` holds where the map keeps the h, s and b dims (encode_bhsd)
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, int pos, int d,
                                         int h, int s, int b, uint64_t* bar) {
    const int ph = pos & 3, ps = (pos >> 2) & 3;
    auto at = [&](int p) { return ph == p ? h : ps == p ? s : b; };
    tma_load_4d(dst, map, d, at(1), at(2), at(3), bar);
}

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

// pins registers: no instruction touching them moves across a wgmma fence or
// wait, and their values stay live until here
template <int N> __device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_operands(uint32_t (&a)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// d (64 x 64 f32) = A (64 x 16, K-major, shared) * B (16 x 64, K-major,
// shared) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major:
// trans-b 1); scale_d 0 starts d
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the same with 128 output columns (D = 128)
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// C (64 x 64) = A B^T, both K-major in boxes of 64 columns: 8-row groups
// 1024 bytes apart, a k16 step 32 bytes on within a box; the D / 16 steps
// that hold data (a zero-filled column adds nothing)
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[32], uint32_t q, uint32_t k) {
    fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * wg::BOX + (kk % 4) * 32;
        wgmma_m64n64k16_ss(sc, gmma_desc(q + off, 16, 1024), gmma_desc(k + off, 16, 1024),
                           kk > 0);
    }
    wgmma_commit();
}

// O (64 x ROW_COLS<D>) += P_hi V + P_lo V: V MN-major, a k16 step 16 rows
// (2048 bytes) on, the second 64 columns one box on (LBO); `start` begins O
template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[ROW_COLS<D> / 2], uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4], uint32_t v, bool start) {
    fence_operands(o);
    fence_operands(hi);
    fence_operands(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = gmma_desc(v + kk * 2048, wg::BOX, 1024);
        wgmma_pv(o, hi[kk], dv, !(start && kk == 0));
        wgmma_pv(o, lo[kk], dv, 1);
    }
    wgmma_commit();
}

// 2^x on the special function unit (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The scores of a tile that crosses the diagonal, Sk's edge or the window's
// edge, with every key its row must not see set to NEG_INF: sc[4i + e] is q.k
// of row r0 + 8 (e >> 1) and key kc + 8 i + (e & 1) (kc = k0 + 2 tig); N / 4
// groups of 8 keys (the bf16 kernels' 64-key tiles, the tf32x3 ones' 32).
// An mma.sync m16n8k8 accumulator tile nb is the same fragment, sc[4 nb + e].
template <int N>
__device__ __forceinline__ void mask_scores(float (&sc)[N], int r0, int kc, int Sk, int causal,
                                            int window) {
    // row r sees keys kc + lo[r] .. kc + hi[r]
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = r0 + 8 * r;
        hi[r] = (causal ? min(Sk - 1, qi) : Sk - 1) - kc;
        lo[r] = window > 0 ? qi - window + 1 - kc : -kc;
    }
#pragma unroll
    for (int x = 0; x < N; ++x) {
        const int c = 8 * (x >> 2) + (x & 1), r = (x >> 1) & 1;
        if (c < lo[r] || c > hi[r]) sc[x] = NEG_INF;
    }
}

// The online softmax on S's fragment (layout as mask_scores).  Leaves p in
// sc, updates the row max m (in q.k's units) and this thread's share of the
// row sum l, and gives the factor the rows' earlier output is to be scaled
// by.  Only a masked tile tests each key; a masked key's p is 2^(-1e30 sl2 -
// ...) = 0, and a row that has seen no visible key yet (m = NEG_INF) takes
// its p against 0, so they are 0 too.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool masked, int r0, int kc,
                                               int Sk, int causal, int window, float sl2) {
    if (masked) mask_scores(sc, r0, kc, Sk, causal, window);
    float mx[2] = {m[0], m[1]}, msl[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < N; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        // the 4 threads of a row are lanes 4g .. 4g + 3
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        msl[r] = (mx[r] == NEG_INF ? 0.f : mx[r]) * sl2;
    }
#pragma unroll
    for (int x = 0; x < N; ++x) {
        const float p = ex2(fmaf(sc[x], sl2, -msl[(x >> 1) & 1]));
        sc[x] = p;
        sum[(x >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// An m64n64 f32 fragment as wgmma's A fragment, in two bf16 halves:
// register r of k16 step kk holds columns 16 kk + 2 tig (+ 8 for r >= 2) of
// row g (+ 8 for odd r), which are sc[8 kk + 2 r] and sc[8 kk + 2 r + 1]
__device__ __forceinline__ void split_p(const float (&sc)[32], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
            const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
            const float2 hf = __bfloat1622float2(h);
            const __nv_bfloat162 w = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
            hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
            lo[kk][r] = *reinterpret_cast<const uint32_t*>(&w);
        }
}

// ---------------------------------------------------------------------------
// TF32 in three products: the f32 kernels (tf32x3).  Each f32 operand x is
// split into hi = TF32(x), rounded to nearest (cvt.rna's rounding: ties
// away from zero), and lo = x - hi, exact in f32 and passed raw: the tensor
// core reads a TF32 operand's top 19 bits, so it takes lo truncated, and x
// - hi - TF32(lo) is below 2^-21 |x|; a product x y is taken as lo_x hi_y +
// hi_x lo_y + hi_x hi_y, each TF32 product accumulated in f32 (the lo lo
// term, below 2^-22 |x y|, is dropped).  CUTLASS's fast f32 GEMMs split so.
// One TF32 product alone moves attention's output ~60x past ATTN_TOL[f32]
// (tests/test_torch_flash_f32.py emulates both).  TF32 wgmma has no
// transpose bits: A and B are K-major in shared memory, so a product that
// contracts over keys (P V) reads V^T; and its A fragment in registers,
// thread (warp w, g, tig) holding rows 16 w + g and + 8, columns tig and
// tig + 4 of a k8 step, is not an m64nN accumulator's (columns 2 tig, 2 tig
// + 1).  The kernels take the step's columns in the order 0 2 4 6 1 3 5 7
// instead: the accumulator's entries are then the A fragment as they lie
// (split_p_tf32), and the B operand's keys are stored in that order.
// ---------------------------------------------------------------------------

// TF32(x) rounded to nearest, ties away from zero: cvt.rna.tf32.f32's
// result for every finite x, by two integer ops (2^12 added to the bit
// pattern's magnitude, the low 13 bits cleared), where the cvt compiles to
// four or five with its NaN and Inf cases.  The operands are finite:
// inputs, scores and probabilities.  PERF.md has the readings of the two
// splits this one was chosen over (both halves by cvt.rna; hi truncated)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// the byte offset of 16-byte chunk `chunk` (0-7) of row `row` in a block of
// 128-byte rows under the 128-byte swizzle (TMA's and wgmma's: the chunk
// index XORed with the row's index in its 1,024-byte group)
__device__ __forceinline__ int swz128(int row, int chunk) {
    return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// four f32 values split and stored as hi (at dst) and lo (at dst + lo_off)
__device__ __forceinline__ void store_split4(unsigned char* dst, int lo_off, float4 x) {
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(dst) = h;
    *reinterpret_cast<uint4*>(dst + lo_off) = l;
}

// d (64 x 32 f32) (+)= A (64 x 8 tf32, K-major, shared) * B (8 x 32, K-major,
// shared); scale_d 0 starts d.  TF32 has no transpose bits: both K-major
__device__ __forceinline__ void wgmma_tf32_m64n32k8_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                      int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) (+)= A (64 x 8 tf32, registers) * B (8 x 64, K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 96 f32) (+)= A (64 x 8 tf32, registers) * B (8 x 96, K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) (+)= A (64 x 8 tf32, registers) * B (8 x 128, K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

namespace tf {
constexpr int QBOX = 64 * 128;         // 64 rows of 32 f32: a box of the q tile
constexpr int KBOX = 32 * 128;         // 32 rows of 32 f32: a box of a key tile
}  // namespace tf

// S (64 x 32 f32) = Q K^T over D in k8 steps: Q (64 rows) and K (32 keys)
// K-major in boxes of 32 columns, hi and lo each; the three products of a
// step small first
template <int D>
__device__ __forceinline__ void qk_issue_tf32(float (&sc)[16], uint32_t qhi, uint32_t qlo,
                                              uint32_t khi, uint32_t klo) {
    fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t oq = (kk / 4) * tf::QBOX + (kk % 4) * 32;
        const uint32_t ok = (kk / 4) * tf::KBOX + (kk % 4) * 32;
        wgmma_tf32_m64n32k8_ss(sc, gmma_desc(qlo + oq, 16, 1024), gmma_desc(khi + ok, 16, 1024),
                               kk > 0);
        wgmma_tf32_m64n32k8_ss(sc, gmma_desc(qhi + oq, 16, 1024), gmma_desc(klo + ok, 16, 1024),
                               1);
        wgmma_tf32_m64n32k8_ss(sc, gmma_desc(qhi + oq, 16, 1024), gmma_desc(khi + ok, 16, 1024),
                               1);
    }
    wgmma_commit();
}

// O (64 x D) += P V over the tile's 32 keys in k8 steps: P as split_p_tf32
// gives it, V^T (D rows of 128 bytes, the keys of a step in split_p_tf32's
// order) hi and lo; `start` begins O
template <int D>
__device__ __forceinline__ void pv_issue_tf32(float (&o)[D / 2], uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4], uint32_t vhi, uint32_t vlo,
                                              bool start) {
    fence_operands(o);
    fence_operands(hi);
    fence_operands(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = gmma_desc(vhi + kk * 32, 16, 1024);
        wgmma_tf32_rs(o, lo[kk], dh, !(start && kk == 0));
        wgmma_tf32_rs(o, hi[kk], gmma_desc(vlo + kk * 32, 16, 1024), 1);
        wgmma_tf32_rs(o, hi[kk], dh, 1);
    }
    wgmma_commit();
}

// An m64n32 f32 fragment (sc[4i + e]: row 16 w + g + 8 (e >> 1), key 8 i +
// 2 tig + (e & 1)) as four k8 steps' TF32 A fragments, hi and lo: step kk's
// registers (rows g, g + 8, g, g + 8; columns tig, tig, tig + 4, tig + 4)
// are keys 8 kk + 2 tig, 2 tig, 2 tig + 1, 2 tig + 1, which is the order
// 0 2 4 6 1 3 5 7 of the step's columns
__device__ __forceinline__ void split_p_tf32(const float (&sc)[16], uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        split_tf32(sc[4 * kk], hi[kk][0], lo[kk][0]);
        split_tf32(sc[4 * kk + 2], hi[kk][1], lo[kk][1]);
        split_tf32(sc[4 * kk + 1], hi[kk][2], lo[kk][2]);
        split_tf32(sc[4 * kk + 3], hi[kk][3], lo[kk][3]);
    }
}

// `bytes` (a multiple of 16) from global memory to shared, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// mma.sync m16n8k8, TF32 in, f32 accumulated in c: A (16 x 8: rows g and g +
// 8, columns tig and tig + 4), B (8 x 8: rows tig and tig + 4, column g), C
// as an m64nN accumulator's rows of one warp (rows g, g + 8; columns 2 tig,
// 2 tig + 1); the three products of the split, small first
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma3_tf32(float* c, const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, ah, bh0, bh1);
}

// ---------------------------------------------------------------------------
// host: tensor maps (cuTensorMapEncodeTiled from libcuda.so.1, found at run
// time, so nothing links against libcuda)
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

// A bf16 (B, H, S, D) tensor by element strides (sb, sh, ss), D contiguous,
// as a 4-D tensor map: D innermost, then H, S and B in the order of their
// strides (a dim of size 1 last, its stride made up), boxes of 64 D columns
// by `rows` rows of S, 128-byte swizzle, zeros outside (columns past D too:
// in the model's (B, S, H, D) layout the next ones are the next head's).
// Returns where the map keeps the h, s and b dims (h | s << 2 | b << 4,
// each 1-3), or -1.
int encode_bhsd(CUtensorMap* map, const void* ptr, int B, int H, int S, int D, long long sb,
                long long sh, long long ss, int rows) {
    const EncodeTiled fn = encode_fn();
    if (!fn) return -1;
    struct Dim { long long size, stride; int which; };   // which: 0 h, 1 s, 2 b
    Dim dims[3] = {{H, sh, 0}, {S, ss, 1}, {B, sb, 2}};
    std::sort(dims, dims + 3, [](const Dim& x, const Dim& y) {
        if ((x.size == 1) != (y.size == 1)) return y.size == 1;
        return x.stride < y.stride;
    });
    cuuint64_t size[4] = {static_cast<cuuint64_t>(D)}, stride[3];
    cuuint32_t box[4] = {64}, estr[4] = {1, 1, 1, 1};
    long long span = 2LL * D;             // bytes a step of the last dim covers
    int pos = 0;
    for (int i = 0; i < 3; ++i) {
        const long long st = dims[i].size == 1 ? span : 2 * dims[i].stride;
        size[i + 1] = static_cast<cuuint64_t>(dims[i].size);
        stride[i] = static_cast<cuuint64_t>(st);
        box[i + 1] = dims[i].which == 1 ? rows : 1;
        span = st * dims[i].size;
        pos |= (i + 1) << (2 * dims[i].which);
    }
    const bool ok = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), size,
                       stride, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
    return ok ? pos : -1;
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

}  // namespace

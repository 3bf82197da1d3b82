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
// What bounds it on an H100 (3.35 TB/s): each K and V element is read once
// and used for 2*G operations, so bytes: sum(lens) * Hkv * D * 2 * itemsize
// for K and V (llama3-8b, batch 8 at 1,836 tokens: 7.5 MB a layer, 2.3 us).
// A decode step has few sequences, so the grid must not be one block a
// (sequence, kv head): 64 blocks at batch 8 leave half the card idle and
// walk each sequence serially.  The design (flash-decoding):
//
//  * Each sequence's token range is split into `splits` slices of
//    `split_tokens` (a multiple of the 64-token tile), from shapes only
//    (kernels/paged_attention.py::plan: about 8 blocks an SM over the
//    card, at most 16 slices; one slice when the (sequence, kv head)
//    pairs alone fill the card, as a 128-row prefill chunk's do).  lens
//    stays on the card: a block whose slice starts at or past lens[b]
//    exits at once, writing nothing.  A block takes 4 query rows of a kv
//    head (G > 4 takes several row groups).
//  * Inside a block, a warp owns one query row: its lanes form the scores
//    of two tokens each over the whole head (no dead accumulators, no
//    shared scores), its softmax is warp shuffles, and its P.V takes p
//    from the lanes by shuffle while each lane accumulates four columns.
//    So the warps meet only where a tile of K or V lands: two barriers a
//    tile.  K and V arrive by 16-byte cp.async in separate groups, so the
//    scores run while V is in flight; a slice of several tiles prefetches
//    the next tile's K and V into a second buffer.  The pool is read in
//    place through its strides (the model's (NB, bt, Hkv, D) pool is passed
//    as a permuted view); rows past the slice or lens[b] are zero-filled
//    copies, masked with p = 0.
//  * A sequence of one slice writes its rows directly.  Otherwise each
//    slice writes its (m, l, acc) partial to a workspace, takes an atomic
//    ticket for its (sequence, kv head, row group), and the last to arrive
//    merges the partials in slice order (so two calls give the same bits),
//    then leaves the ticket at zero.  One launch a call; no float atomics.
//    The tickets and partials are kept per (device, stream) by the wrapper.
//  * A sequence with lens[b] == 0 gives zeros: its first slice writes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 128;                  // threads per block: 4 warps
constexpr int ROWS = NT / 32;            // query rows a block: one a warp
constexpr int TOK = 64;                  // tokens of a tile
constexpr float NEG_INF = -1e30f;

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
// 4 f32 values to 4 consecutive T in global memory (bf16 rounded to nearest
// even, as torch's .to(bfloat16))
__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    uint2 r;
    *reinterpret_cast<__nv_bfloat162*>(&r.x) = __floats2bfloat162_rn(v.x, v.y);
    *reinterpret_cast<__nv_bfloat162*>(&r.y) = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = r;
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

// Cycle stamps of a block's phases (thread 0; slot 0 the count, then
// (phase, clock64) pairs, phase -1 the start), read by repro_paged_cycles;
// compiled only with -DPAGED_CYCLES (testing/paged_probe.py), so the
// library the port loads has none.  Phases: 0 prologue, 1 staging wait,
// 2 scores, 3 softmax, 4 P.V, 5 epilogue (output or partial), 6 merge.
#ifdef PAGED_CYCLES
constexpr int STAMP_SLOTS = 128;
__device__ long long paged_cycles[1 << 20];
#define STAMP(phase)                                                                   \
    if (tid == 0 && 2 * n_stamps + 2 < STAMP_SLOTS) {                                  \
        long long* st_ = paged_cycles + (long long)(blockIdx.x + gridDim.x *           \
                         (blockIdx.y + gridDim.y * blockIdx.z)) * STAMP_SLOTS;          \
        st_[1 + 2 * n_stamps] = (phase);                                               \
        st_[2 + 2 * n_stamps] = clock64();                                             \
        st_[0] = ++n_stamps;                                                           \
    }
#define STAMP_DECL int n_stamps = 0
#else
#define STAMP(phase)
#define STAMP_DECL
#endif

struct Args {
    const void* q;
    const void* kpool;
    const void* vpool;
    const int* tables;
    const int* lens;
    void* out;
    unsigned* tickets;                  // [B * Hkv * row groups], zero between launches
    float* part;                        // [pairs][splits][ROWS][D] acc, then [..][ROWS][2] (m, l)
    int Hkv, G, bt_log2, nblk, splits, split_tokens;
    long long q_sb, q_sh, q_sg, p_sh, p_sn, p_st;
    float scale;
};

// grid (splits, Hkv * row groups, B); block (slice, kv head and row group,
// sequence).  STAGES 2 where a slice has more than one tile.
template <typename T, int D, int STAGES>
__global__ void __launch_bounds__(NT)
paged_kernel(const Args a) {
    constexpr int EPC = 16 / sizeof(T);            // elements per 16-byte copy
    constexpr int LD = D + EPC;                    // staged row stride: 16 bytes of pad
    constexpr int CPR = D / EPC;                   // 16-byte copies a row
    constexpr int RPP = NT / CPR;                  // rows a pass of the block
    constexpr int PASSES = (TOK + RPP - 1) / RPP;
    constexpr int DL = D / 4;                      // lanes that hold output columns
    extern __shared__ __align__(16) unsigned char smem[];
    T* Ks = reinterpret_cast<T*>(smem);            // [STAGES][TOK][LD]
    T* Vs = Ks + STAGES * TOK * LD;                // [STAGES][TOK][LD]
    float* Qs = reinterpret_cast<float*>(Vs + STAGES * TOK * LD);   // [ROWS][D]
    __shared__ bool last;

    const int split = blockIdx.x, b = blockIdx.z;
    const int groups = (a.G + ROWS - 1) / ROWS;
    const int h = blockIdx.y / groups, rg = blockIdx.y % groups;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = rg * ROWS + warp;                // this warp's query row
    const bool row_live = g < a.G;
    STAMP_DECL;
    STAMP(-1);

    // lens[b], this warp's query row and the first tile's table entries
    // are independent loads: all in flight at once
    const int len_in = __ldg(a.lens + b);
    const int start = split * a.split_tokens;
    const int* tab = a.tables + (long long)b * a.nblk;
    // a thread's copies: 16 bytes `col` of rows r0 + p RPP (threads past
    // RPP whole rows copy nothing)
    const int col = tid % CPR, r0 = tid < RPP * CPR ? tid / CPR : TOK;
    int ids[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
        const int j = (start + r0 + p * RPP) >> a.bt_log2;
        ids[p] = r0 + p * RPP < TOK && j < a.nblk ? __ldg(tab + j) : 0;
    }
    float qv[(D + 31) / 32];
    if (row_live) {
        const T* qr = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + g * a.q_sg;
#pragma unroll
        for (int k = 0; k < (D + 31) / 32; ++k)
            qv[k] = lane + 32 * k < D ? to_f32(qr[lane + 32 * k]) : 0.f;
    }

    const int len = max(0, min(len_in, a.nblk << a.bt_log2));   // the table holds nblk * bt
    const int n_act = (len + a.split_tokens - 1) / a.split_tokens;   // slices with tokens
    T* out = static_cast<T*>(a.out);
    const long long orow = ((long long)b * a.Hkv + h) * a.G + g;
    if (start >= len) {
        // an empty slice writes nothing; an empty sequence's first writes zeros
        if (len == 0 && split == 0 && row_live && lane < DL)
            store4(out + orow * D + lane * 4, make_float4(0.f, 0.f, 0.f, 0.f));
        return;
    }
    const int end = min(start + a.split_tokens, len);
    const int tiles = (end - start + TOK - 1) / TOK;

    const T* kbase = static_cast<const T*>(a.kpool) + h * a.p_sh + col * EPC;
    const T* vbase = static_cast<const T*>(a.vpool) + h * a.p_sh + col * EPC;
    const int bt_mask = (1 << a.bt_log2) - 1;
    // tile j's K and V into buffer j % STAGES, each its own group of 16-byte
    // copies (a pass of the block RPP rows); rows past `end` read zeros.
    // The table entries of tile 0 are the ones loaded above.
    auto stage = [&](int j) {
        long long off[PASSES];
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
            const int tok = start + j * TOK + r0 + p * RPP;
            const int id = j == 0 ? ids[p] : (tok < end ? __ldg(tab + (tok >> a.bt_log2)) : 0);
            off[p] = tok < end ? (long long)id * a.p_sn + (tok & bt_mask) * a.p_st : -1;
        }
        const int o = (j % STAGES) * TOK * LD + r0 * LD + col * EPC;
#pragma unroll
        for (int p = 0; p < PASSES; ++p)
            if (r0 + p * RPP < TOK)
                cp_async16(Ks + o + p * RPP * LD, kbase + max(off[p], 0ll), off[p] >= 0);
        cp_async_commit();
#pragma unroll
        for (int p = 0; p < PASSES; ++p)
            if (r0 + p * RPP < TOK)
                cp_async16(Vs + o + p * RPP * LD, vbase + max(off[p], 0ll), off[p] >= 0);
        cp_async_commit();
    };
    stage(0);
    if (row_live) {
#pragma unroll
        for (int k = 0; k < (D + 31) / 32; ++k)
            if (lane + 32 * k < D) Qs[warp * D + lane + 32 * k] = qv[k];
    }
    STAMP(0);

    float m = NEG_INF, l = 0.f;                    // running max; this lane's share of the sum
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // columns 4 lane .. 4 lane + 3
    const float* qrow = Qs + warp * D;
    for (int j = 0; j < tiles; ++j) {
        const bool ahead = STAGES > 1 && j + 1 < tiles;
        if (ahead) {                               // its buffer was freed at the end of j - 1
            stage(j + 1);
            cp_async_wait<3>();                    // tile j's K has landed
        } else {
            cp_async_wait<1>();
        }
        __syncthreads();
        STAMP(1);
        const T* Kt = Ks + (j % STAGES) * TOK * LD;
        const T* Vt = Vs + (j % STAGES) * TOK * LD;
        const int t0 = start + j * TOK;
        float p0 = 0.f, p1 = 0.f;
        if (row_live) {
            // scores of tokens lane and lane + 32 against this warp's row
            float s0a = 0.f, s0b = 0.f, s1a = 0.f, s1b = 0.f;
            const T* k0 = Kt + lane * LD;
            const T* k1 = Kt + (lane + 32) * LD;
#pragma unroll
            for (int c = 0; c < D; c += EPC) {
                float x0[EPC], x1[EPC];
                load16(k0 + c, x0);
                load16(k1 + c, x1);
#pragma unroll
                for (int i = 0; i < EPC; i += 4) {
                    const float4 qv = *reinterpret_cast<const float4*>(qrow + c + i);
                    float& a0 = (c + i) / 4 % 2 ? s0b : s0a;    // two chains a token
                    float& a1 = (c + i) / 4 % 2 ? s1b : s1a;
                    a0 = fmaf(qv.x, x0[i], a0); a0 = fmaf(qv.y, x0[i + 1], a0);
                    a0 = fmaf(qv.z, x0[i + 2], a0); a0 = fmaf(qv.w, x0[i + 3], a0);
                    a1 = fmaf(qv.x, x1[i], a1); a1 = fmaf(qv.y, x1[i + 1], a1);
                    a1 = fmaf(qv.z, x1[i + 2], a1); a1 = fmaf(qv.w, x1[i + 3], a1);
                }
            }
            STAMP(2);
            // online softmax over the tile, in the warp; masked tokens get
            // p = 0 explicitly (exp(NEG_INF - m) is 1 while m is NEG_INF)
            const bool v0 = t0 + lane < end, v1 = t0 + lane + 32 < end;
            const float x0 = v0 ? (s0a + s0b) * a.scale : NEG_INF;
            const float x1 = v1 ? (s1a + s1b) * a.scale : NEG_INF;
            const float m_new = fmaxf(m, warp_max(fmaxf(x0, x1)));
            const float alpha = expf(m - m_new);
            p0 = v0 ? expf(x0 - m_new) : 0.f;
            p1 = v1 ? expf(x1 - m_new) : 0.f;
            l = l * alpha + (p0 + p1);
            acc = make_float4(acc.x * alpha, acc.y * alpha, acc.z * alpha, acc.w * alpha);
            m = m_new;
            STAMP(3);
        }
        if (ahead)
            cp_async_wait<2>();                    // tile j's V has landed
        else
            cp_async_wait<0>();
        __syncthreads();
        STAMP(1);
        if (row_live) {
            // acc += sum_t p_t V[t][4 lane ..]: p_t from lane t % 32, two
            // chains of sums (even and odd t); lanes past D read column 0
            // and keep nothing, so that every lane takes the shuffles
            float4 e = make_float4(0.f, 0.f, 0.f, 0.f), o = e;
            const T* vp = Vt + (lane < DL ? lane * 4 : 0);
#pragma unroll 8
            for (int t = 0; t < TOK; t += 2) {
                const float pa = __shfl_sync(0xffffffffu, t < 32 ? p0 : p1, t % 32);
                const float pb = __shfl_sync(0xffffffffu, t < 32 ? p0 : p1, (t + 1) % 32);
                const float4 va = load4(vp + t * LD), vb = load4(vp + (t + 1) * LD);
                e.x = fmaf(pa, va.x, e.x); e.y = fmaf(pa, va.y, e.y);
                e.z = fmaf(pa, va.z, e.z); e.w = fmaf(pa, va.w, e.w);
                o.x = fmaf(pb, vb.x, o.x); o.y = fmaf(pb, vb.y, o.y);
                o.z = fmaf(pb, vb.z, o.z); o.w = fmaf(pb, vb.w, o.w);
            }
            acc = make_float4(acc.x + (e.x + o.x), acc.y + (e.y + o.y),
                              acc.z + (e.z + o.z), acc.w + (e.w + o.w));
        }
        if (STAGES > 1 && j + 2 < tiles)
            __syncthreads();                       // tile j + 2's copies reuse this buffer
        STAMP(4);
    }
    l = warp_sum(l);

    if (n_act == 1) {                              // the sequence's only slice
        if (row_live && lane < DL) {
            const float inv = 1.f / l;             // l >= 1: the slice holds a visible token
            store4(out + orow * D + lane * 4,
                   make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
        }
        STAMP(5);
        return;
    }
    // this slice's partial, then a ticket; the last slice to arrive merges
    const long long pair = (long long)b * gridDim.y + blockIdx.y;
    float* pacc = a.part + pair * a.splits * ROWS * D;          // [splits][ROWS][D]
    float* pml = a.part + gridDim.z * (long long)gridDim.y * a.splits * ROWS * D
                 + pair * a.splits * ROWS * 2;                  // [splits][ROWS][2]
    if (row_live) {
        if (lane < DL) *reinterpret_cast<float4*>(pacc + (split * ROWS + warp) * D + lane * 4) = acc;
        if (lane == 0) {
            pml[(split * ROWS + warp) * 2] = m;
            pml[(split * ROWS + warp) * 2 + 1] = l;
        }
    }
    __threadfence();                               // the partial is visible before the ticket
    __syncthreads();
    STAMP(5);
    if (tid == 0) last = atomicAdd(a.tickets + pair, 1u) == static_cast<unsigned>(n_act - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (row_live) {
        // lane s holds slice s's (m, l) for this warp's row; the weights and
        // sums in a fixed order (a shuffle tree, then the slices in order)
        const float* ml = pml + (lane * ROWS + warp) * 2;
        const float ms = lane < n_act ? __ldcg(ml) : NEG_INF;
        const float ls = lane < n_act ? __ldcg(ml + 1) : 0.f;
        const float mx = warp_max(ms);
        const float ws = lane < n_act ? expf(ms - mx) : 0.f;
        const float L = warp_sum(ws * ls);
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        const float* pa = pacc + warp * D + (lane < DL ? lane * 4 : 0);
        for (int s0 = 0; s0 < n_act; s0 += 4) {
            float4 v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (s0 + u < n_act)
                    v[u] = __ldcg(reinterpret_cast<const float4*>(pa + (s0 + u) * ROWS * D));
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float w = __shfl_sync(0xffffffffu, ws, (s0 + u) % 32);
                if (s0 + u < n_act)
                    o = make_float4(fmaf(w, v[u].x, o.x), fmaf(w, v[u].y, o.y),
                                    fmaf(w, v[u].z, o.z), fmaf(w, v[u].w, o.w));
            }
        }
        if (lane < DL) {
            const float inv = 1.f / L;
            store4(out + orow * D + lane * 4,
                   make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
        }
    }
    if (tid == 0) a.tickets[pair] = 0;             // ready for the next launch
    STAMP(6);
}

template <typename T, int D, int STAGES>
int launch(const Args& a, int B, int groups, cudaStream_t s) {
    constexpr size_t LD = D + 16 / sizeof(T);
    constexpr size_t smem = 2 * STAGES * TOK * LD * sizeof(T) + sizeof(float) * ROWS * D;
    static bool opted_in = false;              // above 48 KB only after this
    if (smem > 48 * 1024 && !opted_in) {
        const cudaError_t e = cudaFuncSetAttribute(
            paged_kernel<T, D, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in = true;
    }
    paged_kernel<T, D, STAGES><<<dim3(a.splits, a.Hkv * groups, B), NT, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int STAGES>
int launch(const Args& a, int B, int D, int groups, cudaStream_t s) {
    switch (D) {
        case 16: return launch<T, 16, STAGES>(a, B, groups, s);
        case 32: return launch<T, 32, STAGES>(a, B, groups, s);
        case 64: return launch<T, 64, STAGES>(a, B, groups, s);
        case 96: return launch<T, 96, STAGES>(a, B, groups, s);
        case 128: return launch<T, 128, STAGES>(a, B, groups, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim of
// q and of the pools is contiguous, and out is contiguous.  The caller checks
// the limits and passes the plan (kernels/paged_attention.py: D in {16, 32,
// 64, 96, 128}, bt = 2**bt_log2 dividing 64, 16-byte alignment; `splits` slices
// of `split_tokens`, a multiple of 64, at most 32 (a warp merges them);
// `stages` 2 where a slice has several tiles).  With splits > 1, `tickets`
// holds B * Hkv * ceil(G / 4) zeros and `part` B * Hkv * ceil(G / 4) *
// splits * 4 * (D + 2) floats, both used by no other launch in flight.  The launch goes on `stream` and does not
// synchronise.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_paged_attention(const void* q, const void* kpool, const void* vpool,
                                     const void* tables, const void* lens, void* out,
                                     int B, int Hkv, int G, int D, int bt_log2, int nblk,
                                     long long q_sb, long long q_sh, long long q_sg,
                                     long long p_sh, long long p_sn, long long p_st,
                                     int splits, int split_tokens, int stages,
                                     void* tickets, void* part, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (B < 1 || Hkv < 1 || G < 1 || splits < 1 || split_tokens % TOK || bt_log2 < 0
        || bt_log2 > 6 || (stages != 1 && stages != 2) || splits > 32
        || (splits > 1 && (tickets == nullptr || part == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, kpool, vpool, static_cast<const int*>(tables),
                 static_cast<const int*>(lens), out, static_cast<unsigned*>(tickets),
                 static_cast<float*>(part), Hkv, G, bt_log2, nblk, splits, split_tokens,
                 q_sb, q_sh, q_sg, p_sh, p_sn, p_st, 1.0f / sqrtf(static_cast<float>(D))};
    const int groups = (G + ROWS - 1) / ROWS;
    if (dtype == 0)
        return stages == 1 ? launch<float, 1>(a, B, D, groups, s)
                           : launch<float, 2>(a, B, D, groups, s);
    if (dtype == 1)
        return stages == 1 ? launch<__nv_bfloat16, 1>(a, B, D, groups, s)
                           : launch<__nv_bfloat16, 2>(a, B, D, groups, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef PAGED_CYCLES
// the first n stamps of the cycle-stamped build's launches since the last
// clear (clear != 0 zeroes them first and copies nothing)
extern "C" int repro_paged_cycles(long long* host, int n, int clear) {
    if (clear) {
        void* p = nullptr;
        cudaError_t e = cudaGetSymbolAddress(&p, paged_cycles);
        if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(long long) << 20);
        return static_cast<int>(e);
    }
    return static_cast<int>(cudaMemcpyFromSymbol(host, paged_cycles, n * sizeof(long long)));
}
#endif

// A measurement probe, not a kernel of the port: the f32 flash forward
// (causal / sliding-window GQA, D = 64, 96 or 128) built on the tf32x3
// backward's mma.sync m16n8k8 helpers (csrc/flash_attention_bwd.cu:
// a_frag, b_pair, load_split, pv_tf32, three TF32 products a product),
// for testing/flash_probe.py --f32 to time beside the tf32x3 wgmma forward
// at kernel table row 3b.  The same walk as the backward's dq grid: one
// block a (b, q head, 64-row q tile), the longest walks first, four warps
// of 16 rows, 32-key K and V tiles staged through shared memory by the
// block's threads, S = Q K^T, the online softmax, O += P V.  split = 0:
// the K and V tiles raw, each fragment split as a warp reads it (the dq
// grid's form); split = 1: K and V split once as the block loads them,
// their fragments read as hi and lo (the dkv grid's form for Q and dO).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd_mma_probe.so flash_fwd_mma_probe.cu

#include "../../kernels/csrc/flash_attention_bwd.cu"

namespace {

// a[4 nb + e] = X Y^T of a warp's 16 rows of X (raw f32) and 8 NB rows of
// Y (raw, or SPLIT: hi at Y, lo `lo` floats on), rows of D at stride
// LD<D>, as accumulator fragments: abt2_tf32 with one product
template <int D, int NB, bool SPLIT>
__device__ __forceinline__ void abt_tf32(float (&a)[4 * NB], const float* X, const float* Y,
                                         int lo, int g, int tig) {
    constexpr int LDs = t3::LD<D>;
#pragma unroll
    for (int x = 0; x < 4 * NB; ++x) a[x] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t h[4], l[4];
        a_frag<D>(X, kk, g, tig, h, l);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            uint32_t bh0, bh1, bl0, bl1;
            b_pair<SPLIT>(Y + (8 * nb + g) * LDs + 8 * kk + tig, 4, lo, bh0, bh1, bl0, bl1);
            mma3_tf32(a + 4 * nb, h, l, bh0, bh1, bl0, bl1);
        }
    }
}

template <int D, bool SPLIT>
constexpr int SMEM_FWD = 4 * t3::LD<D> * (t3::BQ + (SPLIT ? 4 : 2) * t3::BK);

template <int D, bool SPLIT>
__global__ void __launch_bounds__(t3::NT, 2)
flash_fwd_mma_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out, int Hq, int Hkv,
                          int S, int Sk, int causal, int window, const Strides st, float sl2) {
    constexpr int LDs = t3::LD<D>, BQ = t3::BQ, BK = t3::BK, NB = t3::BK / 8;
    constexpr int LO = BK * LDs;                   // a tile's lo past its hi
    extern __shared__ float smem[];
    float* Qs = smem;                              // [BQ][LDs]
    float* Ks = Qs + BQ * LDs;                     // [BK][LDs], SPLIT: hi then lo
    float* Vs = Ks + (SPLIT ? 2 : 1) * BK * LDs;

    const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
    const int r0 = q0 + 16 * warp + g;
    const float* kb = k + b * st.k[0] + hk * st.k[1];
    const float* vb = v + b * st.v[0] + hk * st.v[1];
    load_tile<float, D>(Qs, LDs, q + b * st.q[0] + h * st.q[1] + q0 * st.q[2], st.q[2], BQ,
                        S - q0);
    const float* Qw = Qs + 16 * warp * LDs;

    int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
    auto needs_mask = [&](int k0) {
        return k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
               (window > 0 && k0 < q0 + BQ - window);
    };

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2], acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        __syncthreads();                           // the previous tile is consumed
        if (SPLIT) {
            load_split<D>(Ks, Ks + LO, kb + k0 * st.k[2], st.k[2], BK, Sk - k0);
            load_split<D>(Vs, Vs + LO, vb + k0 * st.v[2], st.v[2], BK, Sk - k0);
        } else {
            load_tile<float, D>(Ks, LDs, kb + k0 * st.k[2], st.k[2], BK, Sk - k0);
            load_tile<float, D>(Vs, LDs, vb + k0 * st.v[2], st.v[2], BK, Sk - k0);
        }
        __syncthreads();
        float s[4 * NB];
        abt_tf32<D, NB, SPLIT>(s, Qw, Ks, LO, g, tig);
        online_softmax(s, m, l, alpha, needs_mask(k0), r0, k0 + 2 * tig, Sk, causal, window,
                       sl2);
#pragma unroll
        for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];
        pv_tf32<D, NB, SPLIT>(acc, s, Vs, LO, g, tig);
    }
    // rows r0, r0 + 8: the row sum from its 4 threads, then acc / l
    float* ob = out + b * st.dq[0] + h * st.dq[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = r0 + 8 * r;
        if (row >= S) continue;
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
            *reinterpret_cast<float2*>(ob + row * st.dq[2] + 8 * i + 2 * tig) =
                make_float2(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
    }
}

template <int D, bool SPLIT>
int launch_fwd_probe(const float* q, const float* k, const float* v, float* out, int B, int Hq,
                     int Hkv, int S, int Sk, int causal, int window, const Strides& st,
                     cudaStream_t s) {
    static bool done[64] = {};
    if (!allow_smem(reinterpret_cast<const void*>(flash_fwd_mma_tf32_kernel<D, SPLIT>),
                    SMEM_FWD<D, SPLIT>, done))
        return static_cast<int>(cudaErrorInvalidValue);
    const float sl2 = wg::LOG2E / sqrtf(static_cast<float>(D));
    flash_fwd_mma_tf32_kernel<D, SPLIT><<<dim3(B * Hq, (S + t3::BQ - 1) / t3::BQ), t3::NT,
                                          SMEM_FWD<D, SPLIT>, s>>>(
        q, k, v, out, Hq, Hkv, S, Sk, causal, window, st, sl2);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_probe_d(const float* q, const float* k, const float* v, float* out, int B, int Hq,
                       int Hkv, int S, int Sk, int causal, int window, const Strides& st,
                       int split, cudaStream_t s) {
    return split ? launch_fwd_probe<D, true>(q, k, v, out, B, Hq, Hkv, S, Sk, causal, window,
                                             st, s)
                 : launch_fwd_probe<D, false>(q, k, v, out, B, Hq, Hkv, S, Sk, causal, window,
                                              st, s);
}

}  // namespace

// out (B, Hq, S, D) f32 of attention on q (B, Hq, S, D), k and v (B, Hkv, Sk,
// D), all f32, through their 12 element strides ((batch, head, row) of q,
// k, v, out); D 64, 96 or 128; window 0 = none; split as in the header.
// One launch on `stream`; returns its error (0 = success).
extern "C" int repro_flash_fwd_mma_probe(const void* q, const void* k, const void* v, void* out,
                                         int B, int Hq, int Hkv, int S, int Sk, int D,
                                         int causal, int window, const long long* strides,
                                         int split, void* stream) {
    if (B <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || Sk <= 0 || window < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Strides st{};
    for (int i = 0; i < 3; ++i) {
        st.q[i] = strides[i];
        st.k[i] = strides[3 + i];
        st.v[i] = strides[6 + i];
        st.dq[i] = strides[9 + i];
    }
    const float* pq = static_cast<const float*>(q);
    const float* pk = static_cast<const float*>(k);
    const float* pv = static_cast<const float*>(v);
    float* po = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64: return launch_fwd_probe_d<64>(pq, pk, pv, po, B, Hq, Hkv, S, Sk, causal, window,
                                             st, split, s);
        case 96: return launch_fwd_probe_d<96>(pq, pk, pv, po, B, Hq, Hkv, S, Sk, causal, window,
                                             st, split, s);
        case 128: return launch_fwd_probe_d<128>(pq, pk, pv, po, B, Hq, Hkv, S, Sk, causal,
                                               window, st, split, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

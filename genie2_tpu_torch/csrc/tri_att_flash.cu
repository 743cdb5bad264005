// tri_att_flash: the attention core of triangle attention (AF2 Algorithms
// 13/14) with an online softmax, so the [B, I, H, J, J] logits are never
// written. Per sample b, triangle row i, head h and query position j:
//
//   s[k]   = (q[b,i,j,h,:] . k[b,i,k,h,:]) / sqrt(c) + tb[b,h,j,k]
//            + inf (mask[b,i,k] - 1)
//   o[b,i,j,h,:] = sum_k softmax_k(s)[k] v[b,i,k,h,:]
//
// Replaces genie2_tpu/ops/tri_att_flash.py:126 flash_tri_attention (Pallas
// body _flash_kernel, :75). What is kept: float32 logits, softmax statistics
// and accumulator whatever the activation type, the probabilities kept in
// float32 for p.v, the running max starting at -1e30, the denominator
// clamped at 1e-20. What is not carried over: the sequential 4-d grid with
// scratch between grid steps, the head-major transposes around the call,
// the divisibility asserts and one sample per call.
//
// Work at the full-width shapes (B=2, I=J=256, H=4, c=32, float32):
// 4 B I J^2 H c = 17.2 GFLOP; q, k, v, o are 268 MB, tb 2 MB, the mask
// 0.5 MB. On the H100 the float32 version is bound by operations: 17.2 GFLOP
// at 67 TFLOP/s of non-tensor float32 is 0.256 ms against 0.081 ms for the
// bytes at 3.35 TB/s.
//
// Design: no shared memory and no barrier; every warp works alone. Two
// neighbouring lanes share RQ queries (RQ = 4 for c <= 32, else 2) and each
// owns one half of the head width: its halves of the RQ q rows and of the RQ
// accumulators live in registers, the running maxima and denominators in
// both lanes. A block is one warp and covers 16 RQ query positions of one
// (b, i) and head (one warp per block was the fastest of 1, 2 and 4: 0.82,
// 0.86 and 0.91 ms at the full-width shapes, and at 255 registers a thread
// it is what keeps 8 warps on an SM whatever J is). The keys go 8 at a time: the lane reads its queries' 8 triangle biases (one
// 32-byte sector per query) and the 8 mask values, then for each key its
// half of the k row straight from device memory through L1 (all lanes of a
// half read the same address), adds the two half dot products with one shuffle, rescales the
// softmax once per 8 keys, and accumulates p.v from its half of the v rows.
// Tensors are read in place in their [B, I, J, H, c] layout: one
// (position, head) is one run of c values, a half of it 64 bytes. Sharing
// queries between lanes is what the float32 rate needs: a 16-byte load of k
// or v feeds 4 RQ multiply-adds. Earlier versions of this kernel staged k,
// v and the bias tile in shared memory between barriers, one query per
// thread and then as here; both took 1.32-1.34 ms at the full-width shapes
// (NVIDIA H100 80GB HBM3, 700 W), of which the staging alone, which nothing
// overlapped, was 0.77 ms. Loads are 16 bytes wide where c is a compiled
// width (16, 32, 64) and J a multiple of 8; any other c <= 64 and any J
// take element-wise loads with the edges masked (slower, same numbers).
// A key past J has probability zero and takes no part in the maximum. A key
// masked by `mask` keeps its logit s - inf as the reference does, so a row
// whose keys are all masked attends uniformly over all J keys. wgmma, TMA
// and cp.async pipelines are left for a later version.

#include <stdint.h>

#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int THREADS = 32;         // one warp a block
constexpr int PAIRS = THREADS / 2;  // lane pairs: queries are shared two lanes at a time
constexpr int KC = 8;               // keys per softmax rescale
constexpr float NEG_INF = -1e30f;

// dst[0..8) = p[0..8) as floats. FAST: p is 16-byte aligned and all eight
// exist; else the first n (which may be <= 0) are read, the rest are zero.
template <bool FAST>
__device__ __forceinline__ void load8(const float* __restrict__ p, int n, float* dst) {
    if constexpr (FAST) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        const float4 b = *reinterpret_cast<const float4*>(p + 4);
        dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w;
        dst[4] = b.x, dst[5] = b.y, dst[6] = b.z, dst[7] = b.w;
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = e < n ? p[e] : 0.f;
    }
}

template <bool FAST>
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, int n, float* dst) {
    if constexpr (FAST) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            dst[2 * e] = __uint_as_float(w[e] << 16);
            dst[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        }
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = e < n ? __bfloat162float(p[e]) : 0.f;
    }
}

template <bool FAST>
__device__ __forceinline__ void store8(float* __restrict__ p, int n, const float* src) {
    if constexpr (FAST) {
        *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
        *reinterpret_cast<float4*>(p + 4) = make_float4(src[4], src[5], src[6], src[7]);
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
            if (e < n) p[e] = src[e];
    }
}

template <bool FAST>
__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p, int n, const float* src) {
    if constexpr (FAST) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 t = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
            w[e] = *reinterpret_cast<const uint32_t*>(&t);
        }
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
            if (e < n) p[e] = __float2bfloat16(src[e]);
    }
}

// C is the head width rounded up to a compiled size, c <= C the real one;
// RQ the queries a lane pair owns; FAST as in load8 (c == C, J % 8 == 0).
template <typename T, int C, int RQ, bool FAST>
__global__ void __launch_bounds__(THREADS)
tri_att_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ tb, const float* __restrict__ mask, T* __restrict__ out,
               int I, int J, int H, int c, float scale, float inf) {
    constexpr int TQ = PAIRS * RQ;  // queries per block
    constexpr int CH = C / 2;       // the half of the head width a lane owns
    static_assert(CH % 8 == 0, "a lane reads its half row eight values at a time");

    const int bi = blockIdx.x;  // b * I + i
    const int b = bi / I;
    const int h = blockIdx.z;
    const int j_first = blockIdx.y * TQ + (threadIdx.x >> 1) * RQ;  // this lane's queries: j_first + r
    const int c0 = (threadIdx.x & 1) * CH;       // first channel of this lane's half
    const int nc = FAST ? CH : min(CH, c - c0);  // channels of the half that exist (may be <= 0)
    const size_t row = (size_t)bi * J;           // position (b, i, 0) in units of [H, c] runs
    const size_t hc = (size_t)H * c;
    const size_t head = (size_t)h * c + c0;

    float qr[RQ][CH], acc[RQ][CH], m[RQ], l[RQ];
    int jq[RQ];  // a query past J reads the last one's inputs and stores nothing
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        jq[r] = min(j_first + r, J - 1);
#pragma unroll
        for (int c8 = 0; c8 < CH; c8 += 8) load8<FAST>(q + (row + jq[r]) * hc + head + c8, nc - c8, &qr[r][c8]);
#pragma unroll
        for (int cc = 0; cc < CH; ++cc) acc[r][cc] = 0.f;
        m[r] = NEG_INF;
        l[r] = 0.f;
    }

    const float* mask_row = mask + row;
    const T* tb_h = tb + ((size_t)b * H + h) * J * J;
    const T* k_row = k + row * hc + head;
    const T* v_row = v + row * hc + head;

    for (int key0 = 0; key0 < J; key0 += KC) {
        const int nk = FAST ? KC : min(KC, J - key0);  // keys of this chunk that exist
        // s starts as the triangle bias, mb as the mask.
        float s[RQ][KC], mb[KC];
#pragma unroll
        for (int r = 0; r < RQ; ++r) load8<FAST>(tb_h + (size_t)jq[r] * J + key0, nk, s[r]);
        load8<FAST>(mask_row + key0, nk, mb);
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            float kf[CH], d[RQ];
#pragma unroll
            for (int c8 = 0; c8 < CH; c8 += 8)
                load8<FAST>(k_row + (size_t)(key0 + kk) * hc + c8, kk < nk ? nc - c8 : 0, &kf[c8]);
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
                d[r] = 0.f;
#pragma unroll
                for (int cc = 0; cc < CH; ++cc) d[r] += qr[r][cc] * kf[cc];
            }
            const float bias = inf * (mb[kk] - 1.f);
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
                // Both halves of q.k, then the biases in the reference's order.
                float sv = (d[r] + __shfl_xor_sync(0xffffffffu, d[r], 1)) * scale + s[r][kk];
                sv += bias;
                s[r][kk] = (FAST || kk < nk) ? sv : NEG_INF;
            }
        }
        // A chunk holds at least one key that exists, so every new maximum is finite.
        float m_new[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
            float mt = s[r][0];
#pragma unroll
            for (int kk = 1; kk < KC; ++kk) mt = fmaxf(mt, s[r][kk]);
            m_new[r] = fmaxf(m[r], mt);
            const float alpha = __expf(m[r] - m_new[r]);
            l[r] *= alpha;
#pragma unroll
            for (int cc = 0; cc < CH; ++cc) acc[r][cc] *= alpha;
            m[r] = m_new[r];
        }
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            float vf[CH], p[RQ];
#pragma unroll
            for (int c8 = 0; c8 < CH; c8 += 8)
                load8<FAST>(v_row + (size_t)(key0 + kk) * hc + c8, kk < nk ? nc - c8 : 0, &vf[c8]);
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
                p[r] = (FAST || kk < nk) ? __expf(s[r][kk] - m_new[r]) : 0.f;
                l[r] += p[r];
#pragma unroll
                for (int cc = 0; cc < CH; ++cc) acc[r][cc] += p[r] * vf[cc];
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        if (j_first + r >= J) continue;
        const float norm = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
        for (int cc = 0; cc < CH; ++cc) acc[r][cc] *= norm;
#pragma unroll
        for (int c8 = 0; c8 < CH; c8 += 8)
            store8<FAST>(out + (row + j_first + r) * hc + head + c8, nc - c8, &acc[r][c8]);
    }
}

template <typename T, int C, int RQ>
int launch_c(const T* q, const T* k, const T* v, const T* tb, const float* mask, T* out,
             int B, int I, int J, int H, int c, float scale, float inf, cudaStream_t stream) {
    constexpr int TQ = PAIRS * RQ;
    const dim3 grid(B * I, (J + TQ - 1) / TQ, H);
    if (c == C && J % 8 == 0)
        tri_att_kernel<T, C, RQ, true><<<grid, THREADS, 0, stream>>>(q, k, v, tb, mask, out, I, J, H, c, scale, inf);
    else
        tri_att_kernel<T, C, RQ, false><<<grid, THREADS, 0, stream>>>(q, k, v, tb, mask, out, I, J, H, c, scale, inf);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tb, const void* mask, void* out,
           int B, int I, int J, int H, int c, float scale, float inf, cudaStream_t stream) {
    const T* pq = static_cast<const T*>(q);
    const T* pk = static_cast<const T*>(k);
    const T* pv = static_cast<const T*>(v);
    const T* pt = static_cast<const T*>(tb);
    const float* pm = static_cast<const float*>(mask);
    T* po = static_cast<T*>(out);
    // Four queries a lane pair where the registers allow it, else two.
    if (c <= 16) return launch_c<T, 16, 4>(pq, pk, pv, pt, pm, po, B, I, J, H, c, scale, inf, stream);
    if (c <= 32) return launch_c<T, 32, 4>(pq, pk, pv, pt, pm, po, B, I, J, H, c, scale, inf, stream);
    return launch_c<T, 64, 2>(pq, pk, pv, pt, pm, po, B, I, J, H, c, scale, inf, stream);
}

}  // namespace

// q, k, v, out: [B, I, J, H, c]; tb: [B, H, J, J], all of dtype 0 = float32
// or 1 = bfloat16; mask: [B, I, J] float32. c <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tri_att_flash(const void* q, const void* k, const void* v, const void* tb, const void* mask,
                             void* out, int B, int I, int J, int H, int c, float scale, float inf, int dtype,
                             void* stream) {
    if (B < 1 || I < 1 || J < 1 || H < 1 || H > 65535 || c < 1 || c > 64) return (int)cudaErrorInvalidValue;
    if (J > 65535 * 2 * PAIRS) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(q, k, v, tb, mask, out, B, I, J, H, c, scale, inf, st);
    if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, tb, mask, out, B, I, J, H, c, scale, inf, st);
    return (int)cudaErrorInvalidValue;
}

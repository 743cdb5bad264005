// ipa_attention: the attention core of invariant point attention, fused.
//
// Replaces genie2_tpu/ops/ipa_fused.py:188 fused_ipa_attention (Pallas
// kernel _ipa_kernel, :90), batched over samples. Per sample b, query row
// i, head h and key j:
//   s[h,i,j] = sqrt(1/(3C)) q[i,h,:].k[j,h,:] + sqrt(1/3) bias[i,j,h]
//              - 0.5 sum_p |qp[i,h,p] - kp[j,h,p]|^2 + inf (mask[j] - 1)
//   p        = softmax_j s          (online: running max and sum, float32)
//   o[i,h,:]      = sum_j p v[j,h,:]
//   o_pt[i,h,:]   = sum_j p vp[j,h,:]
//   o_pair[i,h,:] = sum_j p z[i,j,:]
// The points arrive already multiplied by sqrt(softplus(w_h) s_pt), so the
// squared distance carries the head weight. Only the key side is masked.
// In bfloat16 the probabilities are rounded to bfloat16 before they
// multiply z (not before v and vp), all sums are float32.
//
// The wrapper hands over the rows concatenated, qc = [q | qp], kc = [k | kp]
// ([B,N,H,D1], D1 = C + 3 Pq) and vc = [v | vp] ([B,N,H,DV], DV = C + 3 Pv),
// and takes oc = [o | o_pt] back: a tile of keys is then one contiguous
// run of device memory.
//
// Work at the main path's shape (B=2, N=256, H=12, C=16, Pq=4, Pv=8,
// Cz=128, float32): 0.62 GFLOP against 75 MB (z 67 MB read once, bias
// 6.3 MB): the card is bound by bytes, 22 us at 3.35 TB/s.
//
// Design: nothing of size N x N is written. One block of 256 threads owns
// TI (<= 2) query rows of one sample and walks the keys TJ at a time:
//   stage    the kc rows of the tile into shared memory, a linear copy
//            (row stride padded to odd, so lanes on consecutive (j, h)
//            rows hit distinct banks);
//   logits   one (row, key, head) each into P[row][key][head];
//   stats    one thread per (row, head): new running max, rescale factor;
//   exps     P <- exp(P - max);
//   sums     o_pair: a thread owns (row, channel) for all heads, so each z
//            value is loaded from device memory exactly once, straight into
//            a register, lanes along the channel axis, and is used for H
//            multiply-adds with P read as float4 broadcasts;
//            o, o_pt and the softmax denominator: a thread owns (head,
//            column) for all rows, the column of ones being the last.
// Index arithmetic in the loops divides by compile-time constants only.
// Any N: keys past N get a logit of -1e30, rows past N are computed on a
// clamped index and not stored. wgmma, TMA and a pipelined z stream are
// left for a later version.

#include <stdint.h>

#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int THREADS = 256;
constexpr int TJ = 32;      // keys per tile
constexpr int TI_MAX = 2;   // query rows per block, at most
constexpr int ITEMS = 2;    // accumulator items per thread, at most
constexpr int MAX_HEADS = 16;
constexpr float NEG_BIG = -1e30f;
constexpr int MAX_SMEM = 232448;

struct Dims {
    int B, N, H, C, PQ3, PV3, CZ, TI;
    float inf;
};

__host__ __device__ inline int odd(int n) { return n | 1; }

// Copies `total` consecutive elements of src, rows of D1, into dst with
// row stride D1P; elements from `valid` on are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int valid, int total, int D1,
                                           int D1P, float* dst) {
    const int step_row = THREADS / D1, step_dd = THREADS % D1;
    int row = threadIdx.x / D1, dd = threadIdx.x % D1;
    constexpr int U = 4;  // loads in flight per thread
    for (int e0 = threadIdx.x; e0 < total; e0 += U * THREADS) {
        float val[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * THREADS;
            val[u] = e < valid ? load_f(src + e) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (e0 + u * THREADS >= total) break;
            dst[row * D1P + dd] = val[u];
            row += step_row;
            dd += step_dd;
            if (dd >= D1) {
                dd -= D1;
                ++row;
            }
        }
    }
}

template <typename T, int HB>
__global__ void __launch_bounds__(THREADS)
ipa_kernel(const T* __restrict__ qc, const T* __restrict__ kc, const T* __restrict__ vc,
           const T* __restrict__ bias, const T* __restrict__ z, const float* __restrict__ mask,
           T* __restrict__ oc, T* __restrict__ opair, Dims d) {
    extern __shared__ __align__(16) float smem[];
    const int N = d.N, H = d.H, C = d.C, CZ = d.CZ, TI = d.TI;
    const int D1 = C + d.PQ3, D1P = odd(D1), DV = C + d.PV3, D2 = DV + 1;
    float* P = smem;                        // [TI_MAX][TJ][HB]
    float* m_s = P + TI_MAX * TJ * HB;      // [TI_MAX][HB] running max
    float* alpha_s = m_s + TI_MAX * HB;     // [TI_MAX][HB] rescale of this tile
    float* l_s = alpha_s + TI_MAX * HB;     // [TI_MAX][HB] softmax denominators
    float* q_s = l_s + TI_MAX * HB;         // [TI][H][D1P]
    float* k_s = q_s + TI * H * D1P;        // [TJ][H][D1P]

    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int i0 = blockIdx.x * TI;
    const size_t bN = (size_t)b * N;
    const float sqk = sqrtf(1.f / (3.f * C)), sb = sqrtf(1.f / 3.f);

    stage_rows(qc + (bN + i0) * H * D1, min(TI, N - i0) * H * D1, TI * H * D1, D1, D1P, q_s);
    for (int e = tid; e < TI_MAX * TJ * HB; e += THREADS) P[e] = 0.f;
    for (int e = tid; e < TI_MAX * HB; e += THREADS) {
        m_s[e] = NEG_BIG;
        alpha_s[e] = 1.f;  // rows past TI keep these, their sums are never stored
        l_s[e] = 1.f;
    }

    // o_pair items: (row, channel), all heads.
    bool pair_on[ITEMS];
    int pair_r[ITEMS], pair_c[ITEMS];
    const T* z_row[ITEMS];
    float acc_p[ITEMS][HB];
    // o / o_pt / denominator items: (head, column), all rows.
    bool od_on[ITEMS];
    int od_h[ITEMS], od_d[ITEMS];
    const T* od_src[ITEMS];  // null: the column of ones
    float acc_o[ITEMS][TI_MAX];
#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
        const int w = tid + m * THREADS;
        pair_on[m] = w < TI * CZ;
        pair_r[m] = pair_on[m] ? w / CZ : 0;
        pair_c[m] = pair_on[m] ? w % CZ : 0;
        z_row[m] = z + (bN + min(i0 + pair_r[m], N - 1)) * N * CZ + pair_c[m];
#pragma unroll
        for (int h = 0; h < HB; ++h) acc_p[m][h] = 0.f;

        od_on[m] = w < H * D2;
        od_h[m] = od_on[m] ? w / D2 : 0;
        od_d[m] = od_on[m] ? w % D2 : 0;
        od_src[m] = od_d[m] < DV ? vc + (bN * H + od_h[m]) * DV + od_d[m] : nullptr;
#pragma unroll
        for (int r = 0; r < TI_MAX; ++r) acc_o[m][r] = 0.f;
    }
    const size_t v_stride = (size_t)H * DV;

    for (int j0 = 0; j0 < N; j0 += TJ) {
        const int n_keys = min(TJ, N - j0);
        stage_rows(kc + (bN + j0) * H * D1, n_keys * H * D1, TJ * H * D1, D1, D1P, k_s);
        __syncthreads();

        for (int e = tid; e < TI * TJ * HB; e += THREADS) {
            const int h = e % HB, jj = (e / HB) % TJ, r = e / (HB * TJ);
            if (h >= H) continue;
            float s = NEG_BIG;
            if (jj < n_keys) {
                const float* qr = q_s + (r * H + h) * D1P;
                const float* kr = k_s + (jj * H + h) * D1P;
                float dot = 0.f, dist = 0.f;
#pragma unroll 4
                for (int dd = 0; dd < C; ++dd) dot += qr[dd] * kr[dd];
#pragma unroll 4
                for (int dd = C; dd < D1; ++dd) {
                    const float df = qr[dd] - kr[dd];
                    dist += df * df;
                }
                const size_t ij = (bN + min(i0 + r, N - 1)) * N + j0 + jj;
                s = sqk * dot + sb * load_f(bias + ij * H + h) - 0.5f * dist
                    + d.inf * (mask[bN + j0 + jj] - 1.f);
            }
            P[e] = s;
        }
        __syncthreads();

        if (tid < TI * HB && tid % HB < H) {
            const int r = tid / HB, h = tid % HB;
            const float m_old = m_s[tid];
            float m_new = m_old;
#pragma unroll
            for (int jj = 0; jj < TJ; ++jj) m_new = fmaxf(m_new, P[(r * TJ + jj) * HB + h]);
            m_s[tid] = m_new;
            alpha_s[tid] = expf(m_old - m_new);
        }
        __syncthreads();

        for (int e = tid; e < TI * TJ * HB; e += THREADS) {
            const int h = e % HB, r = e / (HB * TJ);
            if (h < H) P[e] = expf(P[e] - m_s[r * HB + h]);
        }
        __syncthreads();

#pragma unroll
        for (int m = 0; m < ITEMS; ++m) {
            if (pair_on[m]) {
                const int r = pair_r[m];
#pragma unroll
                for (int h = 0; h < HB; ++h) acc_p[m][h] *= alpha_s[r * HB + h];
#pragma unroll 8
                for (int jj = 0; jj < TJ; ++jj) {  // P is 0 for keys past N
                    const float zv = jj < n_keys ? load_f(z_row[m] + (size_t)(j0 + jj) * CZ) : 0.f;
                    const float4* p4 = reinterpret_cast<const float4*>(P + (r * TJ + jj) * HB);
#pragma unroll
                    for (int h4 = 0; h4 < HB / 4; ++h4) {
                        const float4 pv = p4[h4];
                        acc_p[m][4 * h4 + 0] += round_to<T>(pv.x) * zv;
                        acc_p[m][4 * h4 + 1] += round_to<T>(pv.y) * zv;
                        acc_p[m][4 * h4 + 2] += round_to<T>(pv.z) * zv;
                        acc_p[m][4 * h4 + 3] += round_to<T>(pv.w) * zv;
                    }
                }
            }
            if (od_on[m]) {
                const int h = od_h[m];
#pragma unroll
                for (int r = 0; r < TI_MAX; ++r) acc_o[m][r] *= alpha_s[r * HB + h];
#pragma unroll 8
                for (int jj = 0; jj < TJ; ++jj) {
                    const float val =
                        jj >= n_keys ? 0.f : (od_src[m] ? load_f(od_src[m] + (j0 + jj) * v_stride) : 1.f);
#pragma unroll
                    for (int r = 0; r < TI_MAX; ++r) acc_o[m][r] += P[(r * TJ + jj) * HB + h] * val;
                }
            }
        }
        // The next tile's staging touches k_s only; its first barrier
        // orders these reads of P and alpha_s before they are rewritten.
    }

#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
        if (od_on[m] && od_src[m] == nullptr) {
#pragma unroll
            for (int r = 0; r < TI_MAX; ++r) l_s[r * HB + od_h[m]] = acc_o[m][r];
        }
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
        if (od_on[m] && od_src[m] != nullptr) {
            const int h = od_h[m];
#pragma unroll
            for (int r = 0; r < TI_MAX; ++r) {
                const int i = i0 + r;
                if (r >= TI || i >= N) continue;
                const float val = acc_o[m][r] / fmaxf(l_s[r * HB + h], 1e-20f);
                oc[((bN + i) * H + h) * DV + od_d[m]] = Cvt<T>::from_f(val);
            }
        }
        if (pair_on[m] && i0 + pair_r[m] < N) {
            const int r = pair_r[m];
            const size_t ih = (bN + i0 + r) * H;
#pragma unroll
            for (int h = 0; h < HB; ++h) {
                if (h < H)
                    opair[(ih + h) * CZ + pair_c[m]] =
                        Cvt<T>::from_f(acc_p[m][h] / fmaxf(l_s[r * HB + h], 1e-20f));
            }
        }
    }
}

template <typename T, int HB>
int launch_hb(const void* const* in, void* const* out, const float* mask, const Dims& d,
              cudaStream_t stream) {
    const int d1p = odd(d.C + d.PQ3);
    const size_t smem =
        sizeof(float) * ((size_t)TI_MAX * TJ * HB + 3 * TI_MAX * HB + (size_t)(d.TI + TJ) * d.H * d1p);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    auto kernel = ipa_kernel<T, HB>;
    if (smem > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((d.N + d.TI - 1) / d.TI, d.B);
    auto p = [&](int n) { return static_cast<const T*>(in[n]); };
    auto po = [&](int n) { return static_cast<T*>(out[n]); };
    kernel<<<grid, THREADS, smem, stream>>>(p(0), p(1), p(2), p(3), p(4), mask, po(0), po(1), d);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* in, void* const* out, const float* mask, const Dims& d,
           cudaStream_t stream) {
    if (d.H <= 4) return launch_hb<T, 4>(in, out, mask, d, stream);
    if (d.H <= 8) return launch_hb<T, 8>(in, out, mask, d, stream);
    if (d.H <= 12) return launch_hb<T, 12>(in, out, mask, d, stream);
    return launch_hb<T, 16>(in, out, mask, d, stream);
}

}  // namespace

// qc, kc [B,N,H,C+3*PQ] (q | scaled q points, k | scaled k points); vc
// [B,N,H,C+3*PV] (v | v points); bias [B,N,N,H]; z [B,N,N,CZ]; oc like vc
// (o | o_pt); opair [B,N,H,CZ]: all of dtype 0 = float32 or 1 = bfloat16.
// mask [B,N] float32. TI query rows per block. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ipa_attention(const void* qc, const void* kc, const void* vc, const void* bias,
                             const void* z, const void* mask, void* oc, void* opair, int B, int N,
                             int H, int C, int PQ, int PV, int CZ, int TI, float inf, int dtype,
                             void* stream) {
    if (B < 1 || B > 65535 || N < 1 || H < 1 || H > MAX_HEADS || C < 1 || PQ < 1 || PV < 1 || CZ < 1
        || TI < 1 || TI > TI_MAX || TI * CZ > ITEMS * THREADS
        || H * (C + 3 * PV + 1) > ITEMS * THREADS)
        return (int)cudaErrorInvalidValue;
    const Dims d{B, N, H, C, 3 * PQ, 3 * PV, CZ, TI, inf};
    const void* in[5] = {qc, kc, vc, bias, z};
    void* out[2] = {oc, opair};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* m = static_cast<const float*>(mask);
    if (dtype == 0) return launch<float>(in, out, m, d, s);
    if (dtype == 1) return launch<__nv_bfloat16>(in, out, m, d, s);
    return (int)cudaErrorInvalidValue;
}

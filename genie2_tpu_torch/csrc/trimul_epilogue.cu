// trimul_epilogue: LN_out + linear_z folded into one product, times the
// sigmoid output gate, written row-major for the residual.
//
// Replaces genie2_tpu/ops/trimul_fused.py:263 epilogue_cm (Pallas kernel
// _epilogue_kernel, :228). For x [B,H,N,N] channel-major and z [B,N,N,C]:
//   mu, var = mean and variance of x[b,:,i,j] over H (float32)
//   r = rsqrt(var + 1e-6)
//   lin[d] = r * (x . ws)[d] - r * mu * u[d] + vb[d]
//   g[d] = (LN_in(z) . W_g)[d] + b_g[d], LN_in recomputed from z
//   out[b,i,j,d] = lin[d] * sigmoid(g[d])
// where ws = scale_out * W_z, u = sum_h ws and vb = W_z . bias_out + b_z
// are computed by the wrapper.
//
// Work at the main path's shapes (B=1, N=256, C=H=128): 4.3 GFLOP; reads
// 67 MB of x and z, writes 33.5 MB in float32. On the H100 the float32
// version is bound by operations: 4.3 GFLOP at 67 TFLOP/s of non-tensor
// float32 is 64 us against 30 us for the bytes at 3.35 TB/s.
//
// Design: one block of 256 threads per (b, i, 64 consecutive j). The block
// stages the [H x 64] x tile (coalesced rows of the channel-major x) and
// the LayerNorm of its 64 z rows in shared memory, takes the LN_out
// statistics per column, then walks the output channels 32 at a time: each
// thread owns one output channel (lane) and 8 consecutive j (warp), so the
// operand reads are shared-memory broadcasts and every store is a
// coalesced run of 32 channels of one output row. Any N, C, H <= 256 and any
// output width; edges are masked.

#include <stdint.h>

#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int TJ = 64;         // j values per block
constexpr int DC = 32;         // output channels per staged weight chunk
constexpr int THREADS = 256;   // 8 warps: lane -> output channel, warp -> 8 j
constexpr int ZS_LD = TJ + 4;  // float4-aligned rows

__host__ __device__ constexpr size_t smem_floats(int C, int H) {
    return (size_t)H * TJ + (size_t)C * ZS_LD + (size_t)H * DC + (size_t)C * DC;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
epilogue_kernel(const T* __restrict__ x, const T* __restrict__ z,
                const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                const float* __restrict__ ws_t, const float* __restrict__ u,
                const float* __restrict__ vb, const float* __restrict__ wg_t,
                const float* __restrict__ bg, T* __restrict__ out, int N, int C, int H, int D) {
    extern __shared__ __align__(16) float smem[];
    float* xs = smem;             // [H][TJ]    x tile
    float* zs = xs + H * TJ;      // [C][ZS_LD] LN_in(z) tile
    float* wzs = zs + C * ZS_LD;  // [H][DC]    folded linear_z chunk
    float* wgs = wzs + H * DC;    // [C][DC]    gate weight chunk
    __shared__ float mu_s[TJ], r_s[TJ];

    const int j0 = blockIdx.x * TJ, i = blockIdx.y, bb = blockIdx.z;
    const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
    const int n_valid = min(TJ, N - j0);

    for (int idx = tid; idx < H * TJ; idx += THREADS) {
        const int h = idx / TJ, jj = idx % TJ;
        xs[idx] = (jj < n_valid) ? load_f(x + (((size_t)bb * H + h) * N + i) * N + j0 + jj) : 0.f;
    }
    layer_norm_rows<T, TJ>(z + (((size_t)bb * N + i) * N + j0) * C, n_valid, C, ln_s, ln_b, zs, ZS_LD);
    __syncthreads();
    if (tid < TJ) {
        float s = 0.f, s2 = 0.f;
        for (int h = 0; h < H; ++h) {
            const float v = xs[h * TJ + tid];
            s += v;
            s2 += v * v;
        }
        const float mu = s / H;
        mu_s[tid] = mu;
        r_s[tid] = rsqrtf(s2 / H - mu * mu + LN_EPS);
    }

    for (int d0 = 0; d0 < D; d0 += DC) {
        __syncthreads();  // statistics written / the previous chunk consumed
        for (int idx = tid; idx < H * DC; idx += THREADS) {
            const int d = d0 + idx % DC;
            wzs[idx] = (d < D) ? ws_t[(size_t)(idx / DC) * D + d] : 0.f;
        }
        for (int idx = tid; idx < C * DC; idx += THREADS) {
            const int d = d0 + idx % DC;
            wgs[idx] = (d < D) ? wg_t[(size_t)(idx / DC) * D + d] : 0.f;
        }
        __syncthreads();

        float am[8], ag[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) am[r] = ag[r] = 0.f;
        for (int h = 0; h < H; ++h) {
            const float w = wzs[h * DC + tx];
            const float4 x0 = *reinterpret_cast<const float4*>(&xs[h * TJ + ty * 8]);
            const float4 x1 = *reinterpret_cast<const float4*>(&xs[h * TJ + ty * 8 + 4]);
            am[0] += x0.x * w;
            am[1] += x0.y * w;
            am[2] += x0.z * w;
            am[3] += x0.w * w;
            am[4] += x1.x * w;
            am[5] += x1.y * w;
            am[6] += x1.z * w;
            am[7] += x1.w * w;
        }
        for (int c = 0; c < C; ++c) {
            const float w = wgs[c * DC + tx];
            const float4 z0 = *reinterpret_cast<const float4*>(&zs[c * ZS_LD + ty * 8]);
            const float4 z1 = *reinterpret_cast<const float4*>(&zs[c * ZS_LD + ty * 8 + 4]);
            ag[0] += z0.x * w;
            ag[1] += z0.y * w;
            ag[2] += z0.z * w;
            ag[3] += z0.w * w;
            ag[4] += z1.x * w;
            ag[5] += z1.y * w;
            ag[6] += z1.z * w;
            ag[7] += z1.w * w;
        }

        const int d = d0 + tx;
        if (d < D) {
            const float ud = u[d], vbd = vb[d], bgd = bg[d];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
                const int jj = ty * 8 + r;
                if (jj < n_valid) {
                    const float rr = r_s[jj];
                    const float lin = rr * am[r] - (rr * mu_s[jj]) * ud + vbd;
                    out[(((size_t)bb * N + i) * N + j0 + jj) * D + d] = Cvt<T>::from_f(lin * sigmoid(ag[r] + bgd));
                }
            }
        }
    }
}

template <typename T>
int launch(const void* x, const void* z, const void* ln_s, const void* ln_b, const void* ws_t,
           const void* u, const void* vb, const void* wg_t, const void* bg, void* out,
           int B, int N, int C, int H, int D, cudaStream_t stream) {
    const size_t smem = smem_floats(C, H) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(epilogue_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + TJ - 1) / TJ, N, B);
    epilogue_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(z),
        static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
        static_cast<const float*>(ws_t), static_cast<const float*>(u),
        static_cast<const float*>(vb), static_cast<const float*>(wg_t),
        static_cast<const float*>(bg), static_cast<T*>(out), N, C, H, D);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, z, out); every other pointer is float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int trimul_epilogue(const void* x, const void* z, const void* ln_s, const void* ln_b,
                               const void* ws_t, const void* u, const void* vb, const void* wg_t,
                               const void* bg, void* out, int B, int N, int C, int H, int D,
                               int dtype, void* stream) {
    if (B < 1 || B > 65535 || N < 1 || N > 65535 || C < 1 || C > MAX_CHANNELS || H < 1 ||
        H > MAX_CHANNELS || D < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(x, z, ln_s, ln_b, ws_t, u, vb, wg_t, bg, out, B, N, C, H, D, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(x, z, ln_s, ln_b, ws_t, u, vb, wg_t, bg, out, B, N, C, H, D, s);
    return (int)cudaErrorInvalidValue;
}

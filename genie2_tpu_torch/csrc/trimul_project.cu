// trimul_project: LayerNorm + the four gated projections of the triangle
// multiplicative update, written channel-major.
//
// Replaces genie2_tpu/ops/trimul_fused.py:113 project_gated_cm (Pallas
// kernel _project_kernel, :71). For z [B,N,N,C] and res_mask [B,N]:
//   zn = LN_in(z) (float32 statistics, eps 1e-6), rounded to z's type
//   a[b,h,i,j] = (zn.W_ap + b_ap)[h] * sigmoid(zn.W_ag + b_ag)[h] * m_i m_j
//   b[b,h,i,j] likewise with W_bp, W_bg
// stored as [B,H,N,N], so the contraction reads both operands without a
// transpose of [B,N,N,H].
//
// Work at the main path's shapes (B=1, N=256, C=H=128): 8.6 GFLOP; reads
// 33.5 MB of z, writes 67 MB of a and b in float32. On the H100 the float32
// version is bound by operations: 8.6 GFLOP at 67 TFLOP/s of non-tensor
// float32 is 128 us against 30 us for the bytes at 3.35 TB/s. In bfloat16
// the bytes halve and the tensor-core peak would make it bound by bytes;
// this kernel still multiplies in float32 on the CUDA cores.
//
// Design: one block of 256 threads per (b, i, 64 consecutive j). The block
// reads its 64 z rows once, normalises them into shared memory
// channel-major, then walks the hidden channels 32 at a time: the four
// [C x 32] weight slabs (packed k-major [C,4,H] by the wrapper) are staged
// in shared memory and each thread accumulates 2 j x 4 h x 4 projections in
// registers. Consecutive threads own consecutive j, so every store of a and
// b is a coalesced row segment. Any N, C <= 256 and any H; the j and h
// edges are masked.

#include <stdint.h>

#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int TJ = 64;        // z rows (j values) per block
constexpr int HC = 32;        // hidden channels per staged weight chunk
constexpr int THREADS = 256;  // 8 warps: lane -> j, warp -> 4 hidden channels
constexpr int ZS_LD = TJ + 1; // odd stride: the transposed LN store is conflict-free

__host__ __device__ constexpr int zs_floats(int C) { return (C * ZS_LD + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
project_kernel(const T* __restrict__ z, const float* __restrict__ res_mask,
               const float* __restrict__ ln_s, const float* __restrict__ ln_b,
               const float* __restrict__ w_cat, const float* __restrict__ b_cat,
               T* __restrict__ a_out, T* __restrict__ b_out, int N, int C, int H) {
    extern __shared__ __align__(16) float smem[];
    float* zs = smem;                 // [C][ZS_LD] normalised rows
    float* ws = smem + zs_floats(C);  // [C][4][HC] weight chunk
    __shared__ float maskj[TJ];

    const int j0 = blockIdx.x * TJ, i = blockIdx.y, bb = blockIdx.z;
    const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
    const int n_valid = min(TJ, N - j0);

    if (tid < TJ) {
        const int j = j0 + tid;
        maskj[tid] = (j < N) ? res_mask[(size_t)bb * N + i] * res_mask[(size_t)bb * N + j] : 0.f;
    }
    layer_norm_rows<T, TJ>(z + (((size_t)bb * N + i) * N + j0) * C, n_valid, C, ln_s, ln_b, zs, ZS_LD);

    for (int h0 = 0; h0 < H; h0 += HC) {
        __syncthreads();  // zs and maskj written / the previous chunk consumed
        for (int idx = tid; idx < C * 4 * HC; idx += THREADS) {
            const int hh = idx % HC, m = (idx / HC) & 3, c = idx / (4 * HC);
            const int h = h0 + hh;
            ws[idx] = (h < H) ? w_cat[((size_t)c * 4 + m) * H + h] : 0.f;
        }
        __syncthreads();

        float acc[4][4][2];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int hl = 0; hl < 4; ++hl) acc[m][hl][0] = acc[m][hl][1] = 0.f;

        for (int k = 0; k < C; ++k) {
            const float z0 = zs[k * ZS_LD + tx];
            const float z1 = zs[k * ZS_LD + tx + 32];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const float4 w4 = *reinterpret_cast<const float4*>(&ws[(k * 4 + m) * HC + ty * 4]);
                acc[m][0][0] += w4.x * z0;
                acc[m][0][1] += w4.x * z1;
                acc[m][1][0] += w4.y * z0;
                acc[m][1][1] += w4.y * z1;
                acc[m][2][0] += w4.z * z0;
                acc[m][2][1] += w4.z * z1;
                acc[m][3][0] += w4.w * z0;
                acc[m][3][1] += w4.w * z1;
            }
        }

#pragma unroll
        for (int hl = 0; hl < 4; ++hl) {
            const int h = h0 + ty * 4 + hl;
            if (h >= H) continue;
            const float bap = b_cat[h], bag = b_cat[H + h];
            const float bbp = b_cat[2 * H + h], bbg = b_cat[3 * H + h];
            T* a_row = a_out + (((size_t)bb * H + h) * N + i) * N + j0;
            T* b_row = b_out + (((size_t)bb * H + h) * N + i) * N + j0;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int jj = tx + 32 * q;
                if (jj < n_valid) {
                    const float mk = maskj[jj];
                    a_row[jj] = Cvt<T>::from_f((acc[0][hl][q] + bap) * sigmoid(acc[1][hl][q] + bag) * mk);
                    b_row[jj] = Cvt<T>::from_f((acc[2][hl][q] + bbp) * sigmoid(acc[3][hl][q] + bbg) * mk);
                }
            }
        }
    }
}

template <typename T>
int launch(const void* z, const void* res_mask, const void* ln_s, const void* ln_b,
           const void* w_cat, const void* b_cat, void* a_out, void* b_out,
           int B, int N, int C, int H, cudaStream_t stream) {
    const size_t smem = (size_t)(zs_floats(C) + C * 4 * HC) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + TJ - 1) / TJ, N, B);
    project_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(z), static_cast<const float*>(res_mask),
        static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
        static_cast<const float*>(w_cat), static_cast<const float*>(b_cat),
        static_cast<T*>(a_out), static_cast<T*>(b_out), N, C, H);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z, a, b); every other pointer is float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int trimul_project(const void* z, const void* res_mask, const void* ln_s, const void* ln_b,
                              const void* w_cat, const void* b_cat, void* a_out, void* b_out,
                              int B, int N, int C, int H, int dtype, void* stream) {
    if (B < 1 || N < 1 || N > 65535 || B > 65535 || C < 1 || C > MAX_CHANNELS || H < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(z, res_mask, ln_s, ln_b, w_cat, b_cat, a_out, b_out, B, N, C, H, s);
    if (dtype == 1) return launch<__nv_bfloat16>(z, res_mask, ln_s, ln_b, w_cat, b_cat, a_out, b_out, B, N, C, H, s);
    return (int)cudaErrorInvalidValue;
}

// triangle_contract: the per-channel triangle contraction over explicit
// element strides,
//   x[b,c,i,j] = sum_k A[b,c,i,k] * B[b,c,j,k],   float32 accumulation,
// where each of A, B and x is addressed as base + b*s_b + c*s_c + row*s_row
// + k*s_k (x: + i*s_i + j*s_j). One source serves three layouts:
//
//   variant 0  unit k stride in both operands (channel-major copies):
//              genie2_tpu/ops/triangle.py:61 _triangle_multiply_cm (:75);
//   variant 1  A k-contiguous, B row-contiguous (B stored k-major):
//              genie2_tpu/ops/trimul_fused.py:204 contract_cm_fullk_km (:213);
//   variant 2  unit channel stride (the model layout [B,N,N,C], read and
//              written in place, no transposed copy in device memory):
//              genie2_tpu/ops/triangle.py:98 _triangle_multiply_nlayout (:144).
//
// Work at B=2, N=256, C=128 in float32: 8.6 GFLOP against 201 MB; on the
// H100 that is bound by operations, 128 us at 67 TFLOP/s of non-tensor
// float32 (60 us for the bytes at 3.35 TB/s).
//
// Design. Variants 0 and 1 (tile_kernel): one block of 256 threads per
// 64 x 64 output tile of one (b, c), k walked 16 at a time through
// shared-memory tiles stored k-major, a 4 x 4 register tile per thread; a
// template flag per operand makes the loading threads run along whichever
// of k or the row is contiguous. Variant 2 (cfast_kernel): a transposed
// copy would cost a full extra pass over device memory, so one block takes
// 32 channels of a 16 x 16 output tile, every global read and write runs
// along the contiguous channel axis (lane = channel, 128-byte rows), and
// each warp holds a 4 x 8 register tile of its lane's channel. Any N and C:
// rows, columns, k and channels past the edge load as zero and are not
// stored. wgmma and TMA are left for a later version.

#include <stdint.h>

#include "trimul_common.cuh"

namespace {

using namespace trimul;

typedef long long stride_t;

struct Strides {
    stride_t b, c, r, k;  // batch, channel, row (i of A, j of B; i of x), k (j of x)
};

constexpr int THREADS = 256;

// ------------------------------------------------------------------ //
// Variants 0 and 1
// ------------------------------------------------------------------ //

constexpr int BM = 64, BK = 16;
constexpr int LD = BM + 4;  // float4-aligned rows

// Loads a BM x BK tile of one operand into dst[k][row]; K_FAST says that
// k is the operand's contiguous index, else the row is.
template <typename T, bool K_FAST>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, Strides s, int row0, int k0,
                                          int N, float (*dst)[LD]) {
#pragma unroll
    for (int e = 0; e < (BK * BM) / THREADS; ++e) {
        const int idx = threadIdx.x + e * THREADS;
        const int kk = K_FAST ? idx % BK : idx / BM;
        const int rr = K_FAST ? idx / BK : idx % BM;
        const int k = k0 + kk, row = row0 + rr;
        dst[kk][rr] = (k < N && row < N) ? load_f(src + row * s.r + k * s.k) : 0.f;
    }
}

template <typename T, bool A_KFAST, bool B_KFAST>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, Strides sa,
            Strides sb, Strides so, int C, int N) {
    __shared__ __align__(16) float As[BK][LD];
    __shared__ __align__(16) float Bs[BK][LD];

    const int bi = blockIdx.z / C, ci = blockIdx.z % C;
    const T* A = a + bi * sa.b + ci * sa.c;
    const T* Bm = b + bi * sb.b + ci * sb.c;
    T* X = out + bi * so.b + ci * so.c;
    const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BM;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < N; k0 += BK) {
        load_tile<T, A_KFAST>(A, sa, i0, k0, N, As);
        load_tile<T, B_KFAST>(Bm, sb, j0, k0, N, Bs);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * bv[c];
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= N) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx * 4 + c;
            if (j < N) X[i * so.r + j * so.k] = Cvt<T>::from_f(acc[r][c]);
        }
    }
}

// ------------------------------------------------------------------ //
// Variant 2
// ------------------------------------------------------------------ //

constexpr int CB = 32;  // channels per block: one per lane
constexpr int TM = 16;  // output tile is TM x TM
constexpr int CK = 8;   // k per step

template <typename T>
__device__ __forceinline__ void load_channels(const T* __restrict__ src, Strides s, int row0,
                                              int k0, int c0, int C, int N, float* dst) {
#pragma unroll
    for (int e = 0; e < (TM * CK * CB) / THREADS; ++e) {
        const int idx = threadIdx.x + e * THREADS;
        const int cc = idx % CB, kk = (idx / CB) % CK, rr = idx / (CB * CK);
        const int c = c0 + cc, k = k0 + kk, row = row0 + rr;
        dst[idx] = (c < C && k < N && row < N) ? load_f(src + row * s.r + k * s.k + c * s.c) : 0.f;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cfast_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, Strides sa,
             Strides sb, Strides so, int C, int N) {
    __shared__ float As[TM * CK * CB];  // [row][k][channel]
    __shared__ float Bs[TM * CK * CB];

    const int chunks = (C + CB - 1) / CB;
    const int bi = blockIdx.z / chunks, c0 = (blockIdx.z % chunks) * CB;
    const T* A = a + bi * sa.b;
    const T* Bm = b + bi * sb.b;
    const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TM;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int iw = (warp >> 1) * 4, jw = (warp & 1) * 8;

    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < N; k0 += CK) {
        load_channels<T>(A, sa, i0, k0, c0, C, N, As);
        load_channels<T>(Bm, sb, j0, k0, c0, C, N, Bs);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < CK; ++kk) {
            float av[4], bv[8];
#pragma unroll
            for (int r = 0; r < 4; ++r) av[r] = As[((iw + r) * CK + kk) * CB + lane];
#pragma unroll
            for (int c = 0; c < 8; ++c) bv[c] = Bs[((jw + c) * CK + kk) * CB + lane];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[r][c] += av[r] * bv[c];
        }
        __syncthreads();
    }

    const int ch = c0 + lane;
    if (ch >= C) return;
    T* X = out + bi * so.b + ch * so.c;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + iw + r;
        if (i >= N) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int j = j0 + jw + c;
            if (j < N) X[i * so.r + j * so.k] = Cvt<T>::from_f(acc[r][c]);
        }
    }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int B, int C, int N, Strides sa, Strides sb,
           Strides so, int variant, cudaStream_t stream) {
    const T* pa = static_cast<const T*>(a);
    const T* pb = static_cast<const T*>(b);
    T* po = static_cast<T*>(out);
    if (variant == 2) {
        const int tiles = (N + TM - 1) / TM, planes = B * ((C + CB - 1) / CB);
        if (planes > 65535 || tiles > 65535) return (int)cudaErrorInvalidValue;
        cfast_kernel<T><<<dim3(tiles, tiles, planes), THREADS, 0, stream>>>(pa, pb, po, sa, sb, so, C, N);
        return (int)cudaGetLastError();
    }
    const int tiles = (N + BM - 1) / BM;
    if (B * C > 65535 || tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(tiles, tiles, B * C);
    if (variant == 0)
        tile_kernel<T, true, true><<<grid, THREADS, 0, stream>>>(pa, pb, po, sa, sb, so, C, N);
    else
        tile_kernel<T, true, false><<<grid, THREADS, 0, stream>>>(pa, pb, po, sa, sb, so, C, N);
    return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: dtype 0 = float32 or 1 = bfloat16, addressed by the element
// strides s*_b (batch), s*_c (channel), s*_r (row: i of a, j of b, i of
// out) and s*_k (k of a and b, j of out). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int triangle_contract(const void* a, const void* b, void* out, int B, int C, int N,
                                 long long sa_b, long long sa_c, long long sa_r, long long sa_k,
                                 long long sb_b, long long sb_c, long long sb_r, long long sb_k,
                                 long long so_b, long long so_c, long long so_r, long long so_k,
                                 int variant, int dtype, void* stream) {
    if (B < 1 || C < 1 || N < 1 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
    const Strides sa{sa_b, sa_c, sa_r, sa_k}, sb{sb_b, sb_c, sb_r, sb_k}, so{so_b, so_c, so_r, so_k};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(a, b, out, B, C, N, sa, sb, so, variant, s);
    if (dtype == 1) return launch<__nv_bfloat16>(a, b, out, B, C, N, sa, sb, so, variant, s);
    return (int)cudaErrorInvalidValue;
}

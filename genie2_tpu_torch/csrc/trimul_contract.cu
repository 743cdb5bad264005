// trimul_contract: the per-channel triangle contraction on channel-major
// operands, a batched (B*H) N x N x N product with float32 accumulation.
//
// Replaces genie2_tpu/ops/trimul_fused.py:176 contract_cm_fullk (Pallas
// kernels _contract_kernel_out, :159, and _contract_kernel_in, :167):
//   outgoing: x[b,h,i,j] = sum_k a[b,h,i,k] b[b,h,j,k]
//   incoming: x[b,h,i,j] = sum_k a[b,h,k,i] b[b,h,k,j]
//
// Work at the main path's shapes (B=1, N=256, H=128): 4.3 GFLOP; reads
// 67 MB of a and b, writes 33.5 MB in float32. On the H100 the float32
// version is bound by operations: 4.3 GFLOP at 67 TFLOP/s of non-tensor
// float32 is 64 us against 30 us for the bytes at 3.35 TB/s.
//
// Design: the product is computed here, not by a library. One block of 256
// threads per 64 x 64 output tile of one (b, h); the k axis is walked 16 at
// a time through shared-memory tiles stored k-major (As[k][i], Bs[k][j]),
// so the inner loop reads one float4 of each operand and does 16 FMAs into
// a 4 x 4 register tile. The template flag picks which index of a and b is
// k when the tiles are loaded; loads are coalesced along the operand's
// contiguous axis either way. Any N: rows, columns and k past N load as
// zero and are not stored. wgmma and TMA are left for a later version.

#include <stdint.h>

#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int LD = BM + 4;  // float4-aligned rows, at most 2-way bank conflicts on store
constexpr int THREADS = 256;

template <typename T, bool OUTGOING>
__global__ void __launch_bounds__(THREADS)
contract_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int N) {
    __shared__ __align__(16) float As[BK][LD];
    __shared__ __align__(16) float Bs[BK][LD];

    const size_t base = (size_t)blockIdx.z * N * N;
    const T* A = a + base;
    const T* Bm = b + base;
    const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < N; k0 += BK) {
#pragma unroll
        for (int e = 0; e < (BK * BM) / THREADS; ++e) {
            const int idx = tid + e * THREADS;
            // outgoing: operand rows are contiguous in k; incoming: in i / j.
            const int kk = OUTGOING ? idx % BK : idx / BM;
            const int rr = OUTGOING ? idx / BK : idx % BM;
            const int k = k0 + kk, gi = i0 + rr, gj = j0 + rr;
            float av = 0.f, bv = 0.f;
            if (k < N) {
                if (gi < N) av = load_f(OUTGOING ? A + (size_t)gi * N + k : A + (size_t)k * N + gi);
                if (gj < N) bv = load_f(OUTGOING ? Bm + (size_t)gj * N + k : Bm + (size_t)k * N + gj);
            }
            As[kk][rr] = av;
            Bs[kk][rr] = bv;
        }
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
            if (j < N) out[base + (size_t)i * N + j] = Cvt<T>::from_f(acc[r][c]);
        }
    }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int BH, int N, int outgoing, cudaStream_t stream) {
    const dim3 grid((N + BN - 1) / BN, (N + BM - 1) / BM, BH);
    const T* pa = static_cast<const T*>(a);
    const T* pb = static_cast<const T*>(b);
    T* po = static_cast<T*>(out);
    if (outgoing)
        contract_kernel<T, true><<<grid, THREADS, 0, stream>>>(pa, pb, po, N);
    else
        contract_kernel<T, false><<<grid, THREADS, 0, stream>>>(pa, pb, po, N);
    return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: [BH, N, N] of dtype 0 = float32 or 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int trimul_contract(const void* a, const void* b, void* out, int BH, int N, int outgoing,
                               int dtype, void* stream) {
    if (BH < 1 || BH > 65535 || N < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(a, b, out, BH, N, outgoing, s);
    if (dtype == 1) return launch<__nv_bfloat16>(a, b, out, BH, N, outgoing, s);
    return (int)cudaErrorInvalidValue;
}

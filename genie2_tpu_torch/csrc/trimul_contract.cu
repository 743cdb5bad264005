// trimul_contract: the per-channel triangle contraction on channel-major
// operands, a batched (B*H) N x N x N product with float32 accumulation,
// on the tensor cores.
//
// Replaces genie2_tpu/ops/trimul_fused.py:176 contract_cm_fullk (Pallas
// kernels _contract_kernel_out, :159, and _contract_kernel_in, :167):
//   outgoing: x[b,h,i,j] = sum_k a[b,h,i,k] b[b,h,j,k]
//   incoming: x[b,h,i,j] = sum_k a[b,h,k,i] b[b,h,k,j]
//
// Work at the main path's shapes (B=2, N=256, H=128): 8.6 GFLOP; reads
// 134 MB of a and b, writes 67 MB in float32. On the H100 that is 0.060 ms
// of bytes at 3.35 TB/s against 0.052 ms for three TF32 products at 495
// TFLOP/s: bound by bytes (bf16: half the bytes, one product at 989).
//
// Design: one block of 8 warps per 128 x 128 output tile of one (b, h);
// the tiles of one (b, h) are adjacent in blockIdx.x, so a and b come from
// DRAM about once and are reused from L2. The k axis is walked 64 at a time
// through a ring of three shared-memory stages filled with 16-byte
// cp.async copies: the loads of tile k + 2 run under the products of tile
// k, one barrier per step. Tiles are staged in the operand's own layout
// (outgoing: [row][k], k contiguous; incoming: [k][row]), rows padded so
// that fragment loads hit distinct banks; one code path serves both
// directions. Each warp owns a 64 x 32 block of the output: 4 x 4 mma.sync
// tiles, m16n8k8 TF32 three times over (3xTF32) for float32, m16n8k16 once
// for bf16, fragments loaded with ldmatrix (.trans for the incoming
// direction's bf16 tiles; the incoming float32 tiles by index). Any N:
// where N is not a multiple of 16 bytes the same kernel stages element by
// element with plain loads; rows, columns and k past N are zero and nothing
// past N is stored. wgmma is left out: it takes TF32 operands only
// k-major, which the incoming direction is not.

#include <stdint.h>

#include "tensor_core.cuh"
#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int WM = 64, WN = 32;                       // one warp's output block
constexpr int WARPS_M = BM / WM;                      // 2 along M x 4 along N
constexpr int THREADS = 32 * WARPS_M * (BN / WN);     // 8 warps
constexpr int MT = WM / 16, NT = WN / 8;              // mma tiles per warp

// Shared-memory tile of one operand and one k step. Outgoing: [rows][BK + pad],
// 16 bytes of pad, so rows lie an odd multiple of 16 bytes apart and the
// eight rows of an ldmatrix matrix fall in distinct banks. Incoming:
// [BK][rows + 8]: the same for bf16's ldmatrix.trans, and banks 8 t + g
// for float32's loads by index.
template <typename T, bool OUT>
struct Layout {
    static constexpr int LD = OUT ? BK + 16 / (int)sizeof(T) : BM + 8;
    static constexpr int TILE = OUT ? BM * LD : BK * LD;
    static constexpr size_t SMEM = (size_t)STAGES * 2 * TILE * sizeof(T);
};

// An R x W block of a row-major N x N matrix at (row0, col0) into dst
// (row stride ld), zero past N. vec: 16-byte cp.async copies (N a multiple
// of 16 bytes, rows aligned); otherwise plain loads element by element.
template <typename T, int R, int W>
__device__ __forceinline__ void stage_block(T* dst, int ld, const T* src, int N, int row0, int col0, bool vec) {
    if (vec) {
        constexpr int V = 16 / sizeof(T);
        constexpr int CHUNKS = R * W / V;
#pragma unroll
        for (int e = 0; e < (CHUNKS + THREADS - 1) / THREADS; ++e) {
            const int idx = threadIdx.x + e * THREADS;
            if (CHUNKS % THREADS != 0 && idx >= CHUNKS) break;
            const int r = idx / (W / V), c = (idx % (W / V)) * V;
            const bool ok = row0 + r < N && col0 + c < N;
            const T* p = ok ? src + (size_t)(row0 + r) * N + col0 + c : src;
            tc::cp_async16(dst + r * ld + c, p, ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < R * W; idx += THREADS) {
            const int r = idx / W, c = idx % W;
            const bool ok = row0 + r < N && col0 + c < N;
            dst[r * ld + c] = ok ? src[(size_t)(row0 + r) * N + col0 + c] : Cvt<T>::from_f(0.f);
        }
    }
}

template <typename T, bool OUT>
__global__ void __launch_bounds__(THREADS)
contract_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int N, int vec) {
    using L = Layout<T, OUT>;
    using M = tc::Mma<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int tiles_n = (N + BN - 1) / BN;
    const int i0 = (blockIdx.x / tiles_n) * BM, j0 = (blockIdx.x % tiles_n) * BN;
    const size_t base = (size_t)blockIdx.y * N * N;
    const T* A = a + base;
    const T* Bm = b + base;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp % WARPS_M) * WM, wn = (warp / WARPS_M) * WN;
    const int KT = (N + BK - 1) / BK;

    auto stage = [&](int s, int kt) {
        T* As = smem + s * 2 * L::TILE;
        T* Bs = As + L::TILE;
        const int k0 = kt * BK;
        if constexpr (OUT) {
            stage_block<T, BM, BK>(As, L::LD, A, N, i0, k0, vec);
            stage_block<T, BN, BK>(Bs, L::LD, Bm, N, j0, k0, vec);
        } else {
            stage_block<T, BK, BM>(As, L::LD, A, N, k0, i0, vec);
            stage_block<T, BK, BN>(Bs, L::LD, Bm, N, k0, j0, vec);
        }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < KT) stage(s, s);
        tc::cp_async_commit();
    }

    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    for (int kt = 0; kt < KT; ++kt) {
        tc::cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
        __syncthreads();                  // ... everyone's, and tile kt - 1 is consumed
        if (kt + STAGES - 1 < KT) stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
        tc::cp_async_commit();

        const T* As = smem + (kt % STAGES) * 2 * L::TILE;
        const tc::Tile<T, OUT> ta{As, L::LD}, tb{As + L::TILE, L::LD};
#pragma unroll
        for (int kk = 0; kk < BK; kk += M::KSTEP) {
            typename M::B fb[NT];
#pragma unroll
            for (int n = 0; n < NT; ++n) M::load_b(fb[n], tb, wn + n * 8, kk, lane);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                typename M::A fa;
                M::load_a(fa, ta, wm + m * 16, kk, lane);
#pragma unroll
                for (int n = 0; n < NT; ++n) M::mma(acc[m][n], fa, fb[n]);
            }
        }
    }
    tc::cp_async_wait<0>();

    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = i0 + wm + m * 16 + g + 8 * half;
            if (i >= N) continue;
            T* row = out + base + (size_t)i * N;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int j = j0 + wn + n * 8 + 2 * t;
                const float v0 = acc[m][n][2 * half], v1 = acc[m][n][2 * half + 1];
                if (vec) {  // N even: j < N implies j + 1 < N, and the pair is aligned
                    if (j < N) tc::store_pair(row + j, v0, v1);
                } else {
                    if (j < N) row[j] = Cvt<T>::from_f(v0);
                    if (j + 1 < N) row[j + 1] = Cvt<T>::from_f(v1);
                }
            }
        }
}

template <typename T, bool OUT>
int launch_dir(const T* a, const T* b, T* out, int BH, int N, bool vec, cudaStream_t stream) {
    // The shared-memory allowance, set once per device: a host call the main
    // path would otherwise pay at every launch.
    constexpr int MAX_DEVICES = 64;
    static bool allowed[MAX_DEVICES];
    const size_t smem = Layout<T, OUT>::SMEM;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!allowed[dev]) {
        err = cudaFuncSetAttribute(contract_kernel<T, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        allowed[dev] = true;
    }
    const int tiles = ((N + BM - 1) / BM) * ((N + BN - 1) / BN);
    contract_kernel<T, OUT><<<dim3(tiles, BH), THREADS, smem, stream>>>(a, b, out, N, (int)vec);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, void* out, int BH, int N, int outgoing, cudaStream_t stream) {
    const bool aligned = ((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) % 16 == 0;
    const bool vec = aligned && (N * sizeof(T)) % 16 == 0;
    const T* pa = static_cast<const T*>(a);
    const T* pb = static_cast<const T*>(b);
    T* po = static_cast<T*>(out);
    return outgoing ? launch_dir<T, true>(pa, pb, po, BH, N, vec, stream)
                    : launch_dir<T, false>(pa, pb, po, BH, N, vec, stream);
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

// The per-channel contraction x[i,j] = sum_k A[i,k] B[j,k] of one plane on
// the tensor cores, i < I, j < J, k < K (I = J = K = N for the square
// planes; a row block of sequence parallelism has I or K < N), as a 128 x
// 128 output tile of 8 warps: the tile code
// that csrc/trimul_contract.cu (both directions) and variants 0 and 1 of
// csrc/triangle_contract.cu share.
//
// Each operand is given as a matrix with unit column stride and an explicit
// row stride, stored either way round: KM (k contiguous, the matrix is
// [row][k]) or not ([k][row]). Output element (i, j) lies at i * o_r + j *
// o_k. A plane p of the grid's y axis is (batch p / C, channel p % C), each
// with its own base stride, so the same code takes the TriMul kernels'
// dense [B*H, N, N] planes and the standalone contractions' strided ones.
//
// Design: the tiles of one plane are adjacent in blockIdx.x, so A and B
// come from DRAM about once and are reused from L2. The k axis is walked 64
// at a time through a ring of three shared-memory stages filled with
// 16-byte cp.async copies: the loads of tile k + 2 run under the products
// of tile k, one barrier per step. Tiles are staged in the operand's own
// layout, rows padded so that fragment loads hit distinct banks (KM:
// [rows][BK + 16 bytes], rows an odd multiple of 16 bytes apart; otherwise
// [BK][rows + 8]: the same for bf16's ldmatrix.trans, banks 8 t + g for
// float32's loads by index). Each warp owns a 64 x 32 block of the output:
// 4 x 4 mma.sync tiles, m16n8k8 TF32 three times over (3xTF32) for float32,
// m16n8k16 once for bf16, fragments loaded with ldmatrix (.trans for
// [k][row] bf16 tiles; [k][row] float32 tiles by index). Any I, J, K: where
// a row stride or a base is not a multiple of 16 bytes, or I, J or K is
// not, the same kernel stages element by element with plain loads (`vec`
// 0); rows past I or J and k past K are zero and nothing past I or J is
// stored.
#pragma once

#include <stdint.h>

#include "tensor_core.cuh"
#include "trimul_common.cuh"

// Internal linkage: the libraries of trimul_contract.cu and
// triangle_contract.cu both instantiate these templates and are loaded into
// one process, so neither may bind to the other's copies.
namespace {
namespace ctile {

using namespace trimul;

typedef long long stride_t;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int WM = 64, WN = 32;                    // one warp's output block
constexpr int WARPS_M = BM / WM;                   // 2 along M x 4 along N
constexpr int THREADS = 32 * WARPS_M * (BN / WN);  // 8 warps
constexpr int MT = WM / 16, NT = WN / 8;           // mma tiles per warp

// The shared-memory tile of one operand and one k step.
template <typename T, bool KM>
struct OpLayout {
    static constexpr int LD = KM ? BK + 16 / (int)sizeof(T) : BM + 8;
    static constexpr int TILE = KM ? BM * LD : BK * LD;
};

template <typename T, bool AK, bool BKM>
struct Layout {
    using LA = OpLayout<T, AK>;
    using LB = OpLayout<T, BKM>;
    static constexpr int STAGE = LA::TILE + LB::TILE;
    static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(T);
};

template <typename T>
struct Params {
    const T* a;
    const T* b;
    T* out;
    int I, J, K, C;  // output rows and columns, contraction depth; planes per batch (channels)
    stride_t a_b, a_c, a_ld;  // A: batch, channel, row stride of its stored matrix
    stride_t b_b, b_c, b_ld;
    stride_t o_b, o_c, o_r, o_k;
    int vec;  // 16-byte staging and pair stores
};

// An R x W block of a matrix (row stride ld_src, unit column stride, rows x
// cols) at (row0, col0) into dst (row stride ld), zero past its edges. vec:
// 16-byte cp.async copies; otherwise plain loads element by element.
template <typename T, int R, int W>
__device__ __forceinline__ void stage_block(T* dst, int ld, const T* src, stride_t ld_src, int rows, int cols,
                                            int row0, int col0, bool vec) {
    if (vec) {
        constexpr int V = 16 / sizeof(T);
        constexpr int CHUNKS = R * W / V;
#pragma unroll
        for (int e = 0; e < (CHUNKS + THREADS - 1) / THREADS; ++e) {
            const int idx = threadIdx.x + e * THREADS;
            if (CHUNKS % THREADS != 0 && idx >= CHUNKS) break;
            const int r = idx / (W / V), c = (idx % (W / V)) * V;
            const bool ok = row0 + r < rows && col0 + c < cols;
            const T* p = ok ? src + (row0 + r) * ld_src + col0 + c : src;
            tc::cp_async16(dst + r * ld + c, p, ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < R * W; idx += THREADS) {
            const int r = idx / W, c = idx % W;
            const bool ok = row0 + r < rows && col0 + c < cols;
            dst[r * ld + c] = ok ? src[(row0 + r) * ld_src + col0 + c] : Cvt<T>::from_f(0.f);
        }
    }
}

template <typename T, bool AK, bool BKM>
__global__ void __launch_bounds__(THREADS) contract_kernel(Params<T> p) {
    using L = Layout<T, AK, BKM>;
    using M = tc::Mma<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int I = p.I, J = p.J, K = p.K;
    const int tiles_n = (J + BN - 1) / BN;
    const int i0 = (blockIdx.x / tiles_n) * BM, j0 = (blockIdx.x % tiles_n) * BN;
    const int bi = blockIdx.y / p.C, ci = blockIdx.y % p.C;
    const T* A = p.a + bi * p.a_b + ci * p.a_c;
    const T* Bm = p.b + bi * p.b_b + ci * p.b_c;
    const bool vec = p.vec;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp % WARPS_M) * WM, wn = (warp / WARPS_M) * WN;
    const int KT = (K + BK - 1) / BK;

    auto stage = [&](int s, int kt) {
        T* As = smem + s * L::STAGE;
        T* Bs = As + L::LA::TILE;
        const int k0 = kt * BK;
        if constexpr (AK)
            stage_block<T, BM, BK>(As, L::LA::LD, A, p.a_ld, I, K, i0, k0, vec);
        else
            stage_block<T, BK, BM>(As, L::LA::LD, A, p.a_ld, K, I, k0, i0, vec);
        if constexpr (BKM)
            stage_block<T, BN, BK>(Bs, L::LB::LD, Bm, p.b_ld, J, K, j0, k0, vec);
        else
            stage_block<T, BK, BN>(Bs, L::LB::LD, Bm, p.b_ld, K, J, k0, j0, vec);
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

        const T* As = smem + (kt % STAGES) * L::STAGE;
        const tc::Tile<T, AK> ta{As, L::LA::LD};
        const tc::Tile<T, BKM> tb{As + L::LA::TILE, L::LB::LD};
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

    T* X = p.out + bi * p.o_b + ci * p.o_c;
    const bool pairs = vec && p.o_k == 1;  // J even: j < J implies j + 1 < J, and the pair is aligned
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = i0 + wm + m * 16 + g + 8 * half;
            if (i >= I) continue;
            T* row = X + i * p.o_r;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int j = j0 + wn + n * 8 + 2 * t;
                const float v0 = acc[m][n][2 * half], v1 = acc[m][n][2 * half + 1];
                if (pairs) {
                    if (j < J) tc::store_pair(row + j, v0, v1);
                } else {
                    if (j < J) row[j * p.o_k] = Cvt<T>::from_f(v0);
                    if (j + 1 < J) row[(j + 1) * p.o_k] = Cvt<T>::from_f(v1);
                }
            }
        }
}

// Launch over `planes` planes. The shared-memory allowance is set once per
// device: a host call the main path would otherwise pay at every launch.
template <typename T, bool AK, bool BKM>
int launch(const Params<T>& p, int planes, cudaStream_t stream) {
    constexpr int MAX_DEVICES = 64;
    static bool allowed[MAX_DEVICES];
    const size_t smem = Layout<T, AK, BKM>::SMEM;
    if (planes < 1 || planes > 65535) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!allowed[dev]) {
        err = cudaFuncSetAttribute(contract_kernel<T, AK, BKM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        allowed[dev] = true;
    }
    const int tiles = ((p.I + BM - 1) / BM) * ((p.J + BN - 1) / BN);
    contract_kernel<T, AK, BKM><<<dim3(tiles, planes), THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// 16-byte staging is possible: I, J, K, every row stride and base stride a
// multiple of 16 bytes and the pointers aligned.
template <typename T>
bool vec_ok(const Params<T>& p) {
    const stride_t V = 16 / sizeof(T);
    const bool aligned = ((uintptr_t)p.a | (uintptr_t)p.b | (uintptr_t)p.out) % 16 == 0;
    const stride_t strides[] = {p.I, p.J, p.K, p.a_b, p.a_c, p.a_ld, p.b_b, p.b_c, p.b_ld, p.o_b, p.o_c, p.o_r};
    bool ok = aligned;
    for (stride_t s : strides) ok = ok && s % V == 0;
    return ok;
}

}  // namespace ctile
}  // namespace

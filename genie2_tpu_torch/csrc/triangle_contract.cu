// triangle_contract: the per-channel triangle contraction over explicit
// element strides, on the tensor cores,
//   x[b,c,i,j] = sum_k A[b,c,i,k] * B[b,c,j,k],   float32 accumulation,
// where each of A, B and x is addressed as base + b*s_b + c*s_c + row*s_row
// + k*s_k (x: + i*s_i + j*s_j). One source serves three layouts:
//
//   variant 0  unit k stride in both operands (channel-major copies):
//              genie2_tpu/ops/triangle.py:61 _triangle_multiply_cm (:75);
//   variant 1  A k-contiguous, B row-contiguous (B stored k-major):
//              genie2_tpu/ops/trimul_fused.py:204 contract_cm_fullk_km (:213),
//              for any I, J, K (the TriMul contraction's backward on a row
//              block of sequence parallelism);
//   variant 2  unit channel stride (the model layout [B,N,N,C], read and
//              written in place, no transposed copy in device memory):
//              genie2_tpu/ops/triangle.py:98 _triangle_multiply_nlayout (:144).
//
// Work at B=2, N=256, C=128 in float32: 8.6 GFLOP against 201 MB: on the
// H100 bound by bytes, 60 us at 3.35 TB/s (three TF32 products at 495
// TFLOP/s: 52 us; bf16 30 us of bytes).
//
// Variants 0 and 1 are the TriMul contraction's tile kernel
// (csrc/contract_tile.cuh: 128 x 128 tiles of 8 warps, a three-stage
// cp.async ring of 64-deep k steps, mma.sync with 3xTF32 for float32),
// with one layout flag per operand: variant 1 stages A [row][k] and B
// [k][row].
//
// Variant 2 (chan_contract_kernel): the channels are the contiguous axis,
// so one block takes one 16-byte group of channels (float32 4, bf16 8) of a
// 64 x 64 (float32) or 64 x 32 (bf16) output tile of one sample. Each stage
// of a three-stage cp.async ring holds [row][k][channel group] tiles of A
// and B, one 16-byte copy per (row, k) straight from the model layout. A
// lane loads the fragment element (row, k) of all the group's channels at
// once with one 16-byte shared load; rows lie 12 (float32) or 17 (bf16)
// chunks apart, so the eight lanes of each quarter-warp phase hit distinct
// 16-byte bank groups. Each channel then runs its own mma.sync products
// (float32: m16n8k8 TF32, three times over; bf16: m16n8k16, the two k of a
// pair packed from two loads with a byte permute), and the result goes back
// along the channel axis, one 16-byte store per (i, j). Where the channels
// are not a whole number of 16-byte groups, or a stride or a pointer is not
// 16-byte aligned, the same kernel stages and stores element by element.
// Any N: rows, columns and k past N are zero and are not stored. wgmma and
// TMA are left out.

#include <stdint.h>

#include "contract_tile.cuh"

namespace {

using namespace trimul;
using ctile::stride_t;

struct Strides {
    stride_t b, c, r, k;  // batch, channel, row (i of A, j of B; i of x), k (j of x)
};

// ------------------------------------------------------------------ //
// Variant 2
// ------------------------------------------------------------------ //

template <typename T>
struct Chan;

template <>
struct Chan<float> {
    static constexpr int VEC = 4;       // channels per 16-byte group
    static constexpr int BK = 8;        // k per stage: m16n8k8 steps
    static constexpr int RS = BK + 4;   // row stride in 16-byte chunks, = 4 (mod 8)
    static constexpr int MT = 2;        // 16-row m tiles per warp
    static constexpr int WARPS_M = 2;   // 2 x 4 warps of 32 x 16
};

template <>
struct Chan<__nv_bfloat16> {
    static constexpr int VEC = 8;
    static constexpr int BK = 16;       // m16n8k16 steps
    static constexpr int RS = BK + 1;   // odd
    static constexpr int MT = 1;
    static constexpr int WARPS_M = 4;   // 4 x 2 warps of 16 x 16
};

constexpr int CH_THREADS = 256, CH_STAGES = 3, CH_NT = 2;

template <typename T>
struct ChanLayout {
    using P = Chan<T>;
    static constexpr int TM = P::WARPS_M * P::MT * 16;                          // 64
    static constexpr int TN = (CH_THREADS / 32 / P::WARPS_M) * CH_NT * 8;       // 64 or 32
    static constexpr int STAGE = (TM + TN) * P::RS;                             // chunks
    static constexpr size_t SMEM = (size_t)CH_STAGES * STAGE * 16;
};

struct ChanParams {
    const void* a;
    const void* b;
    void* out;
    int N, C, tiles_n;
    Strides sa, sb, so;
    int vec;
};

// Rows row0.. (R of them) x k0..k0 + BK of one operand's channel group c0
// into dst ([row][RS] chunks), zero past N and past C.
template <typename T, int R>
__device__ __forceinline__ void chan_stage(uint4* dst, const T* src, Strides s, int N, int C, int row0, int k0,
                                           int c0, bool vec) {
    using P = Chan<T>;
    if (vec) {
        constexpr int CHUNKS = R * P::BK;
#pragma unroll
        for (int e = 0; e < (CHUNKS + CH_THREADS - 1) / CH_THREADS; ++e) {
            const int idx = threadIdx.x + e * CH_THREADS;
            if (CHUNKS % CH_THREADS != 0 && idx >= CHUNKS) break;
            const int r = idx / P::BK, k = idx % P::BK;
            const bool ok = row0 + r < N && k0 + k < N;
            const T* p = ok ? src + (row0 + r) * s.r + (k0 + k) * s.k + c0 : src;
            tc::cp_async16(dst + r * P::RS + k, p, ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < R * P::BK * P::VEC; idx += CH_THREADS) {
            const int c = idx % P::VEC, k = (idx / P::VEC) % P::BK, r = idx / (P::VEC * P::BK);
            const bool ok = row0 + r < N && k0 + k < N && c0 + c < C;
            reinterpret_cast<T*>(dst + r * P::RS + k)[c] =
                ok ? src[(row0 + r) * s.r + (k0 + k) * s.k + (c0 + c) * s.c] : Cvt<T>::from_f(0.f);
        }
    }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
    return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// The products of one stage. acc[c][m][n][e]: channel c, m tile, n tile.
template <typename T>
__device__ __forceinline__ void chan_products(float (&acc)[Chan<T>::VEC][Chan<T>::MT][CH_NT][4], const uint4* As,
                                              const uint4* Bs, int wm, int wn, int lane);

template <>
__device__ __forceinline__ void chan_products<float>(float (&acc)[Chan<float>::VEC][Chan<float>::MT][CH_NT][4], const uint4* As,
                                                     const uint4* Bs, int wm, int wn, int lane) {
    using P = Chan<float>;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 < P::BK; k0 += 8) {
        // TF32 m16n8k8: a (g, t) (g+8, t) (g, t+4) (g+8, t+4); b (k t, n g) (k t+4, n g).
        uint4 qa[P::MT][4], qb[CH_NT][2];
#pragma unroll
        for (int m = 0; m < P::MT; ++m) {
            const uint4* r0 = As + (wm + m * 16 + g) * P::RS + k0;
            const uint4* r1 = r0 + 8 * P::RS;
            qa[m][0] = r0[t];
            qa[m][1] = r1[t];
            qa[m][2] = r0[t + 4];
            qa[m][3] = r1[t + 4];
        }
#pragma unroll
        for (int n = 0; n < CH_NT; ++n) {
            const uint4* r = Bs + (wn + n * 8 + g) * P::RS + k0;
            qb[n][0] = r[t];
            qb[n][1] = r[t + 4];
        }
#pragma unroll
        for (int c = 0; c < P::VEC; ++c) {
            tc::Mma<float>::B fb[CH_NT];
#pragma unroll
            for (int n = 0; n < CH_NT; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) tc::split_tf32(word(qb[n][e], c), fb[n].hi[e], fb[n].lo[e]);
#pragma unroll
            for (int m = 0; m < P::MT; ++m) {
                tc::Mma<float>::A fa;
#pragma unroll
                for (int e = 0; e < 4; ++e) tc::split_tf32(word(qa[m][e], c), fa.hi[e], fa.lo[e]);
#pragma unroll
                for (int n = 0; n < CH_NT; ++n) tc::Mma<float>::mma(acc[c][m][n], fa, fb[n]);
            }
        }
    }
}

template <>
__device__ __forceinline__ void chan_products<__nv_bfloat16>(float (&acc)[Chan<__nv_bfloat16>::VEC][Chan<__nv_bfloat16>::MT][CH_NT][4], const uint4* As,
                                                             const uint4* Bs, int wm, int wn, int lane) {
    using P = Chan<__nv_bfloat16>;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 < P::BK; k0 += 16) {
        // bf16 m16n8k16: a (g, 2t..) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..);
        // b (k 2t.., n g) (k 2t+8.., n g); [e][0] holds k even, [e][1] k odd.
        uint4 qa[4][2], qb[CH_NT][2][2];
        const uint4* r0 = As + (wm + g) * P::RS + k0;
        const uint4* r1 = r0 + 8 * P::RS;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            qa[0][h] = r0[2 * t + h];
            qa[1][h] = r1[2 * t + h];
            qa[2][h] = r0[2 * t + 8 + h];
            qa[3][h] = r1[2 * t + 8 + h];
        }
#pragma unroll
        for (int n = 0; n < CH_NT; ++n) {
            const uint4* r = Bs + (wn + n * 8 + g) * P::RS + k0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                qb[n][0][h] = r[2 * t + h];
                qb[n][1][h] = r[2 * t + 8 + h];
            }
        }
#pragma unroll
        for (int c = 0; c < P::VEC; ++c) {
            // Channel c is half c % 2 of word c / 2: pack (k even, k odd).
            const unsigned sel = (c & 1) ? 0x7632u : 0x5410u;
            tc::Mma<__nv_bfloat16>::A fa;
#pragma unroll
            for (int e = 0; e < 4; ++e) fa.r[e] = __byte_perm(word(qa[e][0], c >> 1), word(qa[e][1], c >> 1), sel);
#pragma unroll
            for (int n = 0; n < CH_NT; ++n) {
                tc::Mma<__nv_bfloat16>::B fb;
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    fb.r[e] = __byte_perm(word(qb[n][e][0], c >> 1), word(qb[n][e][1], c >> 1), sel);
                tc::Mma<__nv_bfloat16>::mma(acc[c][0][n], fa, fb);
            }
        }
    }
}

// The group's channels of one output element, one 16-byte store.
__device__ __forceinline__ void store_group(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_group(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162 h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    q.x = *reinterpret_cast<uint32_t*>(&h[0]);
    q.y = *reinterpret_cast<uint32_t*>(&h[1]);
    q.z = *reinterpret_cast<uint32_t*>(&h[2]);
    q.w = *reinterpret_cast<uint32_t*>(&h[3]);
    *reinterpret_cast<uint4*>(p) = q;
}

template <typename T>
__global__ void __launch_bounds__(CH_THREADS) chan_contract_kernel(ChanParams p) {
    using P = Chan<T>;
    using L = ChanLayout<T>;
    extern __shared__ __align__(16) uint4 smem[];

    const int N = p.N, C = p.C;
    const int c0 = blockIdx.x * P::VEC;
    const int i0 = (blockIdx.y / p.tiles_n) * L::TM, j0 = (blockIdx.y % p.tiles_n) * L::TN;
    const int bi = blockIdx.z;
    const T* A = static_cast<const T*>(p.a) + bi * p.sa.b;
    const T* Bm = static_cast<const T*>(p.b) + bi * p.sb.b;
    const bool vec = p.vec;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp % P::WARPS_M) * P::MT * 16, wn = (warp / P::WARPS_M) * CH_NT * 8;
    const int KT = (N + P::BK - 1) / P::BK;

    auto stage = [&](int s, int kt) {
        uint4* As = smem + s * L::STAGE;
        chan_stage<T, L::TM>(As, A, p.sa, N, C, i0, kt * P::BK, c0, vec);
        chan_stage<T, L::TN>(As + L::TM * P::RS, Bm, p.sb, N, C, j0, kt * P::BK, c0, vec);
    };

#pragma unroll
    for (int s = 0; s < CH_STAGES - 1; ++s) {
        if (s < KT) stage(s, s);
        tc::cp_async_commit();
    }

    float acc[P::VEC][P::MT][CH_NT][4];
#pragma unroll
    for (int c = 0; c < P::VEC; ++c)
#pragma unroll
        for (int m = 0; m < P::MT; ++m)
#pragma unroll
            for (int n = 0; n < CH_NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[c][m][n][e] = 0.f;

    for (int kt = 0; kt < KT; ++kt) {
        tc::cp_async_wait<CH_STAGES - 2>();
        __syncthreads();
        if (kt + CH_STAGES - 1 < KT) stage((kt + CH_STAGES - 1) % CH_STAGES, kt + CH_STAGES - 1);
        tc::cp_async_commit();
        const uint4* As = smem + (kt % CH_STAGES) * L::STAGE;
        chan_products<T>(acc, As, As + L::TM * P::RS, wm, wn, lane);
    }
    tc::cp_async_wait<0>();

    T* X = static_cast<T*>(p.out) + bi * p.so.b;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < P::MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = i0 + wm + m * 16 + g + 8 * half;
            if (i >= N) continue;
#pragma unroll
            for (int n = 0; n < CH_NT; ++n)
#pragma unroll
                for (int col = 0; col < 2; ++col) {
                    const int j = j0 + wn + n * 8 + 2 * t + col;
                    if (j >= N) continue;
                    float v[P::VEC];
#pragma unroll
                    for (int c = 0; c < P::VEC; ++c) v[c] = acc[c][m][n][2 * half + col];
                    T* q = X + i * p.so.r + j * p.so.k;
                    if (vec) {
                        store_group(q + c0, v);
                    } else {
#pragma unroll
                        for (int c = 0; c < P::VEC; ++c)
                            if (c0 + c < C) q[(c0 + c) * p.so.c] = Cvt<T>::from_f(v[c]);
                    }
                }
        }
}

template <typename T>
int launch_chan(const void* a, const void* b, void* out, int B, int C, int N, Strides sa, Strides sb, Strides so,
                cudaStream_t stream) {
    using L = ChanLayout<T>;
    constexpr stride_t V = Chan<T>::VEC;
    constexpr int MAX_DEVICES = 64;
    static bool allowed[MAX_DEVICES];
    const int groups = (C + V - 1) / V, tiles_n = (N + L::TN - 1) / L::TN;
    const int tiles = ((N + L::TM - 1) / L::TM) * tiles_n;
    if (tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
    // 16-byte groups: unit channel strides, whole groups, aligned rows.
    auto aligned = [&](const Strides& s) {
        return s.c == 1 && (B == 1 || s.b % V == 0) && s.r % V == 0 && s.k % V == 0;
    };
    const bool vec = ((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) % 16 == 0 && C % V == 0 && aligned(sa)
                     && aligned(sb) && aligned(so);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!allowed[dev]) {
        err = cudaFuncSetAttribute(chan_contract_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)L::SMEM);
        if (err != cudaSuccess) return (int)err;
        allowed[dev] = true;
    }
    const ChanParams p{a, b, out, N, C, tiles_n, sa, sb, so, (int)vec};
    chan_contract_kernel<T><<<dim3(groups, tiles, B), CH_THREADS, L::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
}

// Variants 0 and 1: A [row][k] (unit k stride), B [row][k] or [k][row].
template <typename T>
int launch_tile(const void* a, const void* b, void* out, int B, int C, int I, int J, int K, Strides sa, Strides sb,
                Strides so, int variant, cudaStream_t stream) {
    if ((long long)B * C > 65535) return (int)cudaErrorInvalidValue;
    ctile::Params<T> p{static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), I, J, K, C,
                       sa.b, sa.c, sa.r, sb.b, sb.c, variant == 0 ? sb.r : sb.k, so.b, so.c, so.r, so.k, 0};
    p.vec = ctile::vec_ok(p);
    return variant == 0 ? ctile::launch<T, true, true>(p, B * C, stream)
                        : ctile::launch<T, true, false>(p, B * C, stream);
}

template <typename T>
int launch(const void* a, const void* b, void* out, int B, int C, int I, int J, int K, Strides sa, Strides sb,
           Strides so, int variant, cudaStream_t stream) {
    if (variant == 2) {
        if (I != J || J != K) return (int)cudaErrorInvalidValue;  // square planes only
        return launch_chan<T>(a, b, out, B, C, I, sa, sb, so, stream);
    }
    // The tile kernel reads a unit k stride in A (and in B for variant 0,
    // a unit row stride for variant 1); along an axis of 1 no stride is read.
    if ((K > 1 && sa.k != 1) || (variant == 0 ? K > 1 && sb.k != 1 : J > 1 && sb.r != 1))
        return (int)cudaErrorInvalidValue;
    return launch_tile<T>(a, b, out, B, C, I, J, K, sa, sb, so, variant, stream);
}

}  // namespace

// a, b, out: dtype 0 = float32 or 1 = bfloat16, addressed by the element
// strides s*_b (batch), s*_c (channel), s*_r (row: i of a, j of b, i of
// out) and s*_k (k of a and b, j of out); i < I, j < J, k < K (variant 2:
// I = J = K). Variants 0 and 1 need a unit k stride in a, and in b a unit k
// (0) or row (1) stride. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int triangle_contract(const void* a, const void* b, void* out, int B, int C, int I, int J, int K,
                                 long long sa_b, long long sa_c, long long sa_r, long long sa_k,
                                 long long sb_b, long long sb_c, long long sb_r, long long sb_k,
                                 long long so_b, long long so_c, long long so_r, long long so_k,
                                 int variant, int dtype, void* stream) {
    if (B < 1 || C < 1 || I < 1 || J < 1 || K < 1 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
    const Strides sa{sa_b, sa_c, sa_r, sa_k}, sb{sb_b, sb_c, sb_r, sb_k}, so{so_b, so_c, so_r, so_k};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(a, b, out, B, C, I, J, K, sa, sb, so, variant, s);
    if (dtype == 1) return launch<__nv_bfloat16>(a, b, out, B, C, I, J, K, sa, sb, so, variant, s);
    return (int)cudaErrorInvalidValue;
}

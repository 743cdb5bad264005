// trimul_project: LayerNorm + the four gated projections of the triangle
// multiplicative update, written channel-major, on the tensor cores.
//
// Replaces genie2_tpu/ops/trimul_fused.py:113 project_gated_cm (Pallas
// kernel _project_kernel, :71). For z [B,I,N,C] (I rows of the pair
// representation, I = N but for a row block of sequence parallelism), the
// rows' mask r [B,I] and the columns' mask m [B,N]:
//   zn = LN_in(z) (float32 statistics, eps 1e-6), rounded to z's type
//   a[b,h,i,j] = (zn.W_ap + b_ap)[h] * sigmoid(zn.W_ag + b_ag)[h] * r_i m_j
//   b[b,h,i,j] likewise with W_bp, W_bg
// stored as [B,H,I,N], so the contraction reads both operands without a
// transpose of [B,N,N,H]. The parameters come in float32 or bfloat16 (all
// in one type), the weights in torch's Linear layout ([H, C], k
// contiguous), and are rounded to the activation type as they are staged.
//
// Work at the main path's shapes (B=2, N=256, C=H=128): one [B N N, C] x
// [C, 4H] product, 17.2 GFLOP; reads 33.5 MB of z, writes 67 MB of a and b
// in float32. On the H100 that is 0.104 ms for three TF32 products at 495
// TFLOP/s against 0.030 ms for the bytes: bound by operations (bf16: one
// product at 989 TFLOP/s, 0.017 ms, under its 0.030 ms of bytes).
//
// Design: the product is taken the other way round, W [4H, C] . zn^T, so
// that the output channels are the mma's M and the j values its N: an
// accumulator row is one (channel, i) and its columns run along j, as a and
// b lie, and each lane stores its pairs straight to their planes (a quad
// writes 32 contiguous bytes in float32) with no transpose. Both operands
// are k-major as they lie (W rows, z rows), so both take ldmatrix
// fragments. The weight rows are ordered so that an m16 tile holds the
// projections of eight hidden channels in rows 0-7 and their gates in rows
// 8-15: a lane's accumulators c0, c1 and c2, c3 are then the projection
// and the gate of the same (h, j), and the gate is applied in registers.
// Persistent blocks, one per SM, keep a chunk of HC hidden channels of the
// weights (4 HC rows) resident in shared memory, rounded and reordered once,
// and walk tiles (b, i, TJ consecutive j). Four producer warps stage each z
// tile by 16-byte cp.async copies into one of two stages, normalise its
// rows in place (LN_in) and write r_i m_j, while the consumer warps
// multiply the other stage: each warp 64 channel rows by 32 j, mma.sync
// m16n8k8 TF32 three times over (3xTF32) for float32, m16n8k16 for bf16;
// named barriers hand a stage over (READY from producers to consumers, FREE
// back). The whole float32 weight matrix at C=H=128 (256 KB) does not fit
// beside two stages in 227 KB, so float32 takes two chunks of 64 hidden
// channels (8 consumer warps, TJ = 64): half the blocks hold one chunk, half
// the other, and each z tile is read twice, the second time mostly from L2,
// and normalised twice (33.5 MB more reads, LN_in done twice, against
// streaming the weights through the ring for every tile); bf16 keeps all
// 128 channels (136 KB) and tiles of 32 rows. The tile shape of a launch is
// the one of four (channels x rows per tile) that fits with the fewest
// chunks. Any N, C <= 256 and any H: widths are padded with zeros to the k
// step, hidden channels past H are zero and not stored, rows off 16 bytes
// are staged element by element with plain loads, and nothing past N is
// stored.

#include <limits.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int WM = 64, WN = 32;  // one consumer warp's tile: channel rows x j
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int PRODUCERS = 128;   // 4 warps: loads, LN_in, the mask
constexpr int PWARPS = PRODUCERS / 32;
constexpr int STAGES = 2;
constexpr int Q = MAX_CHANNELS / 32;  // values of a weight row of at most 256 per lane
constexpr int RPW = 4;                // rows a producer warp normalises at once
// Named barriers (0 is __syncthreads): READY + s, stage s is staged and
// normalised; FREE + s, the consumers are done with stage s; the producers'.
constexpr int BAR_READY = 1, BAR_FREE = BAR_READY + STAGES, BAR_PRODUCERS = BAR_FREE + STAGES;
constexpr size_t SMEM_LIMIT = 232448;  // per block on the H100
constexpr int MAX_DEVICES = 64;        // launch attributes are cached per device below this

__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The parameters, float32 or (bf16) bfloat16: LN_in scale and bias [C];
// W_ap, W_ag, W_bp, W_bg [H, C]; b_ap, b_ag, b_bp, b_bg [H].
struct Params {
    const void *ln_s, *ln_b;
    const void* w[4];
    const void* bias[4];
    int bf16;

    __device__ __forceinline__ float at(const void* p, size_t i) const {
        return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
    }
};

// The shape of one launch: WARPS_M x WARPS_N consumer warps take a chunk of
// HC = 16 WARPS_M hidden channels (4 HC weight rows: a and b, projection and
// gate) and tiles of TJ = 32 WARPS_N rows of z.
template <typename T>
struct Plan {
    int hc, tj, cp, ldc;

    __host__ __device__ Plan(int C, int warps_m, int warps_n) : hc(16 * warps_m), tj(32 * warps_n) {
        constexpr int K = tc::Mma<T>::KSTEP;
        cp = (C + K - 1) / K * K;
        ldc = cp + 16 / (int)sizeof(T);  // an odd multiple of 16 bytes: fragment loads hit distinct banks
    }
    __host__ __device__ size_t smem() const {
        return (size_t)STAGES * tj * sizeof(float) + (size_t)(4 * hc + STAGES * tj) * ldc * sizeof(T);
    }
};

// p[which] without indexing the kernel's parameters by a runtime value
// (which would copy them to local memory).
__device__ __forceinline__ const void* pick(const void* const (&p)[4], int which) {
    return which == 0 ? p[0] : which == 1 ? p[1] : which == 2 ? p[2] : p[3];
}

// The gate, with the fast exponential and division: within a few float32
// ulps of torch.sigmoid, and 0 where exp(-x) overflows.
__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// Weight row r of the chunk starting at hidden channel h0: m16 tile mt = r /
// 16 is output mt / (HC / 8) (a, then b) and hidden channels h0 + 8 (mt %
// (HC / 8)) + 0..7, the projections in its rows 0-7, the gates in rows 8-15.
__device__ __forceinline__ void weight_row(int r, int hc, int h0, int& which, int& h) {
    const int mt = r >> 4, within = r & 15, groups = hc / 8;
    which = 2 * (mt / groups) + (within >> 3);  // 0 w_ap, 1 w_ag, 2 w_bp, 3 w_bg
    h = h0 + 8 * (mt % groups) + (within & 7);
}

// The chunk's weights (parameters of type P) into ws [4 HC][ldc], rounded to
// T and reordered (weight_row); zero past C and past H. A warp takes rows
// four at a time, a lane the channels lane + 32 q, so that 4 Q loads are in
// flight.
template <typename T, typename P, int THREADS>
__device__ __forceinline__ void stage_weights(const Params& p, T* ws, int ldc, int hc, int h0, int C, int Cp, int H) {
    const int lane = threadIdx.x & 31;
    for (int r0 = 4 * (threadIdx.x >> 5); r0 < 4 * hc; r0 += 4 * (THREADS / 32)) {
        float x[4][Q];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
            int which, h;
            weight_row(r0 + rr, hc, h0, which, h);
            const P* src = static_cast<const P*>(pick(p.w, which)) + (size_t)h * C;
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int c = lane + 32 * q;
                x[rr][q] = h < H && c < C ? Cvt<P>::to_f(src[c]) : 0.f;
            }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int c = lane + 32 * q;
                if (c < Cp) ws[(r0 + rr) * ldc + c] = Cvt<T>::from_f(x[rr][q]);
            }
    }
}

// CQ: values of a z row per producer lane, 4 (C <= 128) or 8.
template <typename T, int WARPS_M, int WARPS_N, int CQ>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N + PRODUCERS, 1)
project_kernel(const T* __restrict__ z, const float* __restrict__ row_mask, const float* __restrict__ col_mask,
               const Params p, T* __restrict__ a_out, T* __restrict__ b_out, int B, int I, int N, int C, int H,
               int vec_z, int vec_out) {
    using M = tc::Mma<T>;
    constexpr int K = M::KSTEP;
    constexpr int V = 16 / (int)sizeof(T);  // elements per 16-byte copy
    constexpr int CONSUMERS = 32 * WARPS_M * WARPS_N;
    constexpr int THREADS = CONSUMERS + PRODUCERS;
    constexpr int HC = 16 * WARPS_M, TJ = 32 * WARPS_N;
    const Plan<T> pl(C, WARPS_M, WARPS_N);
    const int Cp = pl.cp, ldc = pl.ldc;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* maskj = reinterpret_cast<float*>(smem_raw);                            // [STAGES][TJ] r_i m_j
    T* ws = reinterpret_cast<T*>(smem_raw + STAGES * TJ * sizeof(float));         // [4 HC][ldc] weight chunk
    T* stages = ws + 4 * HC * ldc;                                                 // STAGES x [TJ][ldc] z tiles

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nchunks = (H + HC - 1) / HC;
    const int chunk = blockIdx.x % nchunks, h0 = chunk * HC;
    const int G = gridDim.x / nchunks, slot = blockIdx.x / nchunks;  // blocks of this chunk, and which one
    const int JT = (N + TJ - 1) / TJ;
    const int tiles = B * I * JT;
    const int mine = (tiles - slot + G - 1) / G;  // this block's tiles: slot + k G

    if (p.bf16)
        stage_weights<T, __nv_bfloat16, THREADS>(p, ws, ldc, HC, h0, C, Cp, H);
    else
        stage_weights<T, float, THREADS>(p, ws, ldc, HC, h0, C, Cp, H);
    __syncthreads();

    if (warp >= CONSUMERS / 32) {
        // Producers: stage tile k in stage k % STAGES once the consumers are
        // done with it, write r_i m_j of its rows and normalise them in place
        // (LN_in, float32 statistics, rounded to T; channels C..Cp become 0).
        const int pt = threadIdx.x - CONSUMERS, pw = warp - CONSUMERS / 32;
        float lns[CQ], lnb[CQ];  // this lane's channels of the LN_in scale and bias, c = lane + 32 q
        const float inv_c = 1.f / C;
#pragma unroll
        for (int q = 0; q < CQ; ++q) {
            const int c = lane + 32 * q;
            lns[q] = c < C ? p.at(p.ln_s, c) : 0.f;
            lnb[q] = c < C ? p.at(p.ln_b, c) : 0.f;
        }
        for (int k = 0; k < mine; ++k) {
            const int s = k % STAGES, tile = slot + k * G;
            if (k >= STAGES) bar_sync(BAR_FREE + s, THREADS);
            T* zs = stages + s * TJ * ldc;
            const int bb = tile / (I * JT), rem = tile - bb * (I * JT), i = rem / JT, j0 = (rem - i * JT) * TJ;
            const T* zt = z + (((size_t)bb * I + i) * N + j0) * C;  // + r * C + c
            if (vec_z) {
                const int chunks = C / V;
                for (int idx = pt; idx < TJ * chunks; idx += PRODUCERS) {
                    const int r = idx / chunks, c = (idx - r * chunks) * V;
                    const bool ok = j0 + r < N;
                    tc::cp_async16(zs + r * ldc + c, ok ? zt + (size_t)r * C + c : z, ok ? 16 : 0);
                }
            } else {
                for (int idx = pt; idx < TJ * C; idx += PRODUCERS) {
                    const int r = idx / C, c = idx - r * C;
                    zs[r * ldc + c] = j0 + r < N ? zt[(size_t)r * C + c] : Cvt<T>::from_f(0.f);
                }
            }
            tc::cp_async_commit();
            const float mi = row_mask[(size_t)bb * I + i];
            for (int r = pt; r < TJ; r += PRODUCERS)
                maskj[s * TJ + r] = j0 + r < N ? mi * col_mask[(size_t)bb * N + j0 + r] : 0.f;
            tc::cp_async_wait<0>();
            bar_sync(BAR_PRODUCERS, PRODUCERS);  // the tile has landed

            for (int r0 = pw * RPW; r0 < TJ; r0 += PWARPS * RPW) {  // LN_in, two passes over registers
                T* rows = zs + r0 * ldc;
                float x[RPW][CQ], mu[RPW], rstd[RPW];
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    float sum = 0.f;
#pragma unroll
                    for (int q = 0; q < CQ; ++q) {
                        const int c = lane + 32 * q;
                        x[r][q] = c < C ? Cvt<T>::to_f(rows[r * ldc + c]) : 0.f;
                        sum += x[r][q];
                    }
                    mu[r] = warp_sum(sum) * inv_c;
                }
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    float s2 = 0.f;
#pragma unroll
                    for (int q = 0; q < CQ; ++q) {
                        const float d = lane + 32 * q < C ? x[r][q] - mu[r] : 0.f;
                        s2 += d * d;
                    }
                    rstd[r] = rsqrtf(warp_sum(s2) * inv_c + LN_EPS);
                }
#pragma unroll
                for (int r = 0; r < RPW; ++r)
#pragma unroll
                    for (int q = 0; q < CQ; ++q) {
                        const int c = lane + 32 * q;
                        if (c < Cp) rows[r * ldc + c] = Cvt<T>::from_f((x[r][q] - mu[r]) * rstd[r] * lns[q] + lnb[q]);
                    }
            }
            bar_arrive(BAR_READY + s, THREADS);
        }
        return;
    }

    // Consumers: WARPS_M along the weight rows x WARPS_N along j.
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp % WARPS_M) * WM, wn = (warp / WARPS_M) * WN;
    // Per m16 tile: the output plane, the hidden channel of rows g and g + 8
    // and its two biases.
    int outp[MT], hh[MT];
    float bp[MT], bg[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        int which;
        weight_row(wm + 16 * m + g, HC, h0, which, hh[m]);
        outp[m] = which >> 1;
        const bool ok = hh[m] < H;
        bp[m] = ok ? p.at(pick(p.bias, which), hh[m]) : 0.f;
        bg[m] = ok ? p.at(pick(p.bias, which + 1), hh[m]) : 0.f;
    }
    const tc::Tile<T, true> tw{ws, ldc};
    for (int k = 0; k < mine; ++k) {
        const int s = k % STAGES, tile = slot + k * G;
        const int bb = tile / (I * JT), rem = tile - bb * (I * JT), i = rem / JT, j0 = (rem - i * JT) * TJ;
        bar_sync(BAR_READY + s, THREADS);
        const tc::Tile<T, true> tz{stages + s * TJ * ldc, ldc};

        float acc[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < Cp; k0 += K) {
            typename M::B fb[NT];
#pragma unroll
            for (int n = 0; n < NT; ++n) M::load_b(fb[n], tz, wn + 8 * n, k0, lane);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                typename M::A fa;
                M::load_a(fa, tw, wm + 16 * m, k0, lane);
#pragma unroll
                for (int n = 0; n < NT; ++n) M::mma(acc[m][n], fa, fb[n]);
            }
        }

        // (projection + bias) * sigmoid(gate + bias) * r_i m_j, stored as pairs along j.
        float mk[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            mk[n][0] = maskj[s * TJ + wn + 8 * n + 2 * t];
            mk[n][1] = maskj[s * TJ + wn + 8 * n + 2 * t + 1];
        }
        if (k + STAGES < mine) bar_arrive(BAR_FREE + s, THREADS);  // the stage is read out
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            if (hh[m] >= H) continue;
            T* plane = (outp[m] ? b_out : a_out) + (((size_t)bb * H + hh[m]) * I + i) * N;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int j = j0 + wn + 8 * n + 2 * t;
                const float v0 = (acc[m][n][0] + bp[m]) * fast_sigmoid(acc[m][n][2] + bg[m]) * mk[n][0];
                const float v1 = (acc[m][n][1] + bp[m]) * fast_sigmoid(acc[m][n][3] + bg[m]) * mk[n][1];
                if (vec_out) {  // N even: j < N implies j + 1 < N, and the pair is aligned
                    if (j < N) tc::store_pair(plane + j, v0, v1);
                } else {
                    if (j < N) plane[j] = Cvt<T>::from_f(v0);
                    if (j + 1 < N) plane[j + 1] = Cvt<T>::from_f(v1);
                }
            }
        }
    }
}

template <typename T, int WARPS_M, int WARPS_N, int CQ>
int launch_shape(const T* z, const float* row_mask, const float* col_mask, const Params& p, T* a_out, T* b_out,
                 int B, int I, int N, int C, int H, bool vec_z, bool vec_out, cudaStream_t stream) {
    constexpr int THREADS = 32 * WARPS_M * WARPS_N + PRODUCERS;
    // The shared-memory allowance and the blocks an SM holds, set and asked
    // once per device and size: both are host calls the main path would
    // otherwise pay at every launch.
    static size_t smem_set[MAX_DEVICES];
    static int blocks[MAX_DEVICES];
    const size_t smem = Plan<T>(C, WARPS_M, WARPS_N).smem();
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    auto kernel = project_kernel<T, WARPS_M, WARPS_N, CQ>;
    if (smem_set[dev] != smem) {
        int per_sm = 0, sms = 0;
        if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
                cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)err;
        blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
        smem_set[dev] = smem;
    }
    const int HC = 16 * WARPS_M, TJ = 32 * WARPS_N;
    const long long nchunks = (H + HC - 1) / HC;
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    long long per_chunk = blocks[dev] / nchunks;
    per_chunk = per_chunk < 1 ? 1 : per_chunk > tiles ? tiles : per_chunk;
    if (tiles > INT_MAX || nchunks * per_chunk > INT_MAX) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)(nchunks * per_chunk), THREADS, smem, stream>>>(z, row_mask, col_mask, p, a_out, b_out, B, I,
                                                                       N, C, H, (int)vec_z, (int)vec_out);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* z, const void* row_mask, const void* col_mask, const Params& p, void* a_out, void* b_out,
           int B, int I, int N, int C, int H, cudaStream_t stream) {
    // The tile shape: of the four that fit in shared memory, the one with the
    // fewest chunks (each reads z and normalises it once more), then the least
    // padding of H, then the most consumer warps.
    constexpr int SHAPES[4][2] = {{8, 1}, {4, 2}, {2, 4}, {2, 1}};
    int best = -1;
    long long best_key[3] = {0, 0, 0};
    for (int e = 0; e < 4; ++e) {
        const int wm = SHAPES[e][0], wn = SHAPES[e][1];
        if (Plan<T>(C, wm, wn).smem() > SMEM_LIMIT) continue;
        const long long chunks = (H + 16 * wm - 1) / (16 * wm);
        const long long key[3] = {chunks, chunks * 16 * wm, -(long long)wm * wn};
        if (best < 0 || key[0] < best_key[0] || (key[0] == best_key[0] && key[1] < best_key[1]) ||
            (key[0] == best_key[0] && key[1] == best_key[1] && key[2] < best_key[2])) {
            best = e;
            for (int f = 0; f < 3; ++f) best_key[f] = key[f];
        }
    }
    if (best < 0) return (int)cudaErrorInvalidValue;
    const bool vec_z = (uintptr_t)z % 16 == 0 && (C * sizeof(T)) % 16 == 0;
    const bool vec_out = ((uintptr_t)a_out | (uintptr_t)b_out) % (2 * sizeof(T)) == 0 && N % 2 == 0;
    const T* pz = static_cast<const T*>(z);
    const float* pr = static_cast<const float*>(row_mask);
    const float* pc = static_cast<const float*>(col_mask);
    T* pa = static_cast<T*>(a_out);
    T* pb = static_cast<T*>(b_out);
    const int shape = 2 * best + (C > 128);
    switch (shape) {
        case 0: return launch_shape<T, 8, 1, 4>(pz, pr, pc, p, pa, pb, B, I, N, C, H, vec_z, vec_out, stream);
        case 1: return launch_shape<T, 8, 1, 8>(pz, pr, pc, p, pa, pb, B, I, N, C, H, vec_z, vec_out, stream);
        case 2: return launch_shape<T, 4, 2, 4>(pz, pr, pc, p, pa, pb, B, I, N, C, H, vec_z, vec_out, stream);
        case 3: return launch_shape<T, 4, 2, 8>(pz, pr, pc, p, pa, pb, B, I, N, C, H, vec_z, vec_out, stream);
        case 4: return launch_shape<T, 2, 4, 4>(pz, pr, pc, p, pa, pb, B, I, N, C, H, vec_z, vec_out, stream);
        case 5: return launch_shape<T, 2, 4, 8>(pz, pr, pc, p, pa, pb, B, I, N, C, H, vec_z, vec_out, stream);
        case 6: return launch_shape<T, 2, 1, 4>(pz, pr, pc, p, pa, pb, B, I, N, C, H, vec_z, vec_out, stream);
        default: return launch_shape<T, 2, 1, 8>(pz, pr, pc, p, pa, pb, B, I, N, C, H, vec_z, vec_out, stream);
    }
}

}  // namespace

// z [B,I,N,C], a_out and b_out [B,H,I,N] of dtype 0 = float32 or 1 =
// bfloat16; row_mask [B,I] and col_mask [B,N] float32; the ten parameters
// (see Params) of param_dtype 0 = float32 or 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int trimul_project(const void* z, const void* row_mask, const void* col_mask, const void* ln_in_scale,
                              const void* ln_in_bias, const void* w_ap, const void* w_ag, const void* w_bp,
                              const void* w_bg, const void* b_ap, const void* b_ag, const void* b_bp, const void* b_bg,
                              void* a_out, void* b_out, int B, int I, int N, int C, int H, int dtype, int param_dtype,
                              void* stream) {
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || (param_dtype != 0 && param_dtype != 1))
        return (int)cudaErrorInvalidValue;
    const Params p{ln_in_scale, ln_in_bias, {w_ap, w_ag, w_bp, w_bg}, {b_ap, b_ag, b_bp, b_bg}, param_dtype};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(z, row_mask, col_mask, p, a_out, b_out, B, I, N, C, H, s);
    if (dtype == 1) return launch<__nv_bfloat16>(z, row_mask, col_mask, p, a_out, b_out, B, I, N, C, H, s);
    return (int)cudaErrorInvalidValue;
}

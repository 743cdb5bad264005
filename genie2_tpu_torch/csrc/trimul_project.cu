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
//
// trimul_project_backward: the projection's gradients, float32 on the
// tensor cores. It replaces no TPU kernel: no Pallas kernel of genie2_tpu
// has a backward (autograd differentiates the XLA form of the op there).
// It was added for the training step, where the port's earlier backward,
// the plain version's gradient recomputed, took a third of the card's time. With cotangents da, db [B,H,I,N] and, per position,
// P_k = zn.W_k + b_k, s = sigmoid(P_ag), e = da r_i m_j:
//   dP_ap = e s, dP_ag = e P_ap s (1 - s), the same with db for bp, bg
//   dzn = sum_k dP_k . W_k        (one product over K = 4H)
//   dz = LN_in's backward of dzn  (x^ and rstd recomputed from z)
//   dW_k = sum over positions of dP_k^T zn, db_k = sum dP_k,
//   d ln_in_scale = sum dzn x^, d ln_in_bias = sum dzn
// Work at the training step's shapes (B=4, N=256, C=H=128): three [B N N,
// C] x [C, 4H]-sized products (the projections recomputed, dzn, dW), 103
// GFLOP, 0.63 ms as three TF32 products at 495 TFLOP/s, against 0.16 ms
// for reading z, da, db and writing dz: bound by operations.
//
// Design: the forward's tile of TJ = 64 positions (b, i, j0..) and its
// weight rows, but a chunk of 32 hidden channels (128 weight rows, 64 KB in
// float32) a block, 16 rows a warp, and the blocks of all chunks of H in
// one thread-block cluster that walks the tiles together, one block an SM.
// Each block recomputes its rows of P (W . zn^T, as the forward) and turns
// them into dP in the accumulators, which go to shared memory position-major:
// dzn = dP^T . W over the block's 128 rows takes them by ldmatrix, and
// dW += dP . zn, 32 rows x 64 channels a warp held in registers (added into
// the cluster's float32 sums every 8 tiles), by 4-byte loads in which
// positions 2t and 2t + 1 of each 8 stand for m16n8k8's k = t and t + 4
// (rows 2t, 2t + 1 fall in distinct banks). Each block's share of dzn then waits in shared memory; after a
// cluster barrier each block sums its rows of the tile over the cluster
// (distributed shared memory, in rank order), finishes LN_in's backward and
// writes dz: z, da and db are read once from device memory, dz written
// once. Latencies hide behind the products: the next tile's z and masks are
// staged by cp.async after the first product, and normalised while the
// cluster's shares are awaited; the cotangents load while P is computed. A
// tile the masks leave no row or no column of writes zeros and multiplies
// nothing. The weight and LN_in sums are per cluster (per block for LN_in)
// in a float32 scratch, summed by a second launch in a fixed order: two
// calls give the same bits. Without weight gradients (TDS's twist) dW's
// product, the scratch and the second launch are left out. H <= 256 (a
// cluster of at most 8 blocks), C <= 256 (tiles of 16 positions above 128
// channels), any N and I. At the training step's shapes 2.43-2.50 ms a call
// against 0.63 ms: the three products run at about 2.5 cycles an m16n8k8 on
// an SM, the forward's rate, and the staging, LN_in, the cluster's sums and
// dW's flushes take the rest (PERF.md section 6).

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

// ------------------------------------------------------------------ //
// The backward (float32)
// ------------------------------------------------------------------ //

namespace bwd {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int HC = 32;          // hidden channels a block: 4 HC = 128 weight rows, 16 a warp
constexpr int ROWS = 4 * HC;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size: H <= 8 HC
// dW's tensor-core accumulators take this many tiles (512 positions), then
// are added into the cluster's float32 partial sums by plain float adds: the
// tensor cores' accumulation is not rounded to nearest, and its error grows
// with the chain's length.
constexpr int FLUSH = 8;

// One block's shared memory, in floats: the weight chunk [ROWS][ldw], two
// z tiles [TJ][ldz] (this one and the next, staged and normalised
// meanwhile), ps (dP, position-major [TJ][ldp], then the block's share of
// dzn [TJ][ldz], which the cluster reads), the two tiles' column masks m_j
// [2][TJ], row masks r_i [2][4] and rows' LN_in mean and rstd [2][TJ][2].
struct Layout {
    int cp, ldw, ldz, ldp, zs, ps, mask, stat, total;

    __host__ __device__ Layout(int C, int TJ) {
        cp = (C + 7) / 8 * 8;
        ldw = cp + 8;    // dzn's B loads (rows k0 + t, channels g) fall in distinct banks
        ldz = cp + 4;    // an odd multiple of 16 bytes; dW's B loads (rows 2t, 2t + 1) in distinct banks
        ldp = ROWS + 4;  // the same for dP: ldmatrix rows for dzn, dW's A loads in distinct banks
        zs = ROWS * ldw;
        ps = zs + 2 * TJ * ldz;
        mask = ps + TJ * (ldp > ldz ? ldp : ldz);
        stat = mask + 2 * TJ + 8;
        total = stat + 4 * TJ;
    }
    __host__ __device__ size_t bytes() const { return (size_t)total * sizeof(float); }
};

// The scratch of one cluster: dW [4][H][C] and db [4][H] (ap, ag, bp, bg);
// after all clusters', LN_in's two sums [2][C] of each block.
__host__ __device__ inline long long part_stride(int C, int H) { return 4LL * H * C + 4LL * H; }

template <int CMAX, int TJ>
__global__ void __launch_bounds__(THREADS, 1)
project_backward_kernel(const float* __restrict__ z, const float* __restrict__ row_mask,
                        const float* __restrict__ col_mask, const Params p, const float* __restrict__ da,
                        const float* __restrict__ db, float* __restrict__ dz, float* __restrict__ part, int B, int I,
                        int N, int C, int H, int want_dw, int vec_z, int vec_cot) {
    using M = tc::Mma<float>;
    constexpr int NTJ = TJ / 8, CQ = CMAX / 32, NT3 = CMAX / 16, NG = CMAX > 128 ? 4 : 8, LQ = (TJ + 31) / 32;
    // dzn's warp tiles: WM2 positions x WN2 channels.
    constexpr int WM2 = TJ >= 32 ? 32 : 16, WARPS_M2 = TJ / WM2, WN2 = CMAX / (WARPS / WARPS_M2);
    constexpr int MT2 = WM2 / 16, NT2 = WN2 / 8;
    static_assert(WARPS % WARPS_M2 == 0 && NT2 >= 1 && NT3 % NG == 0 && TJ % RPW == 0 && WARPS == 8, "tiling");
    const Layout L(C, TJ);
    const int Cp = L.cp, ldw = L.ldw, ldz = L.ldz, ldp = L.ldp;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* const ws = reinterpret_cast<float*>(smem_raw);
    float* const zbuf = ws + L.zs;
    float* const ps = ws + L.ps;
    float* const cmask = ws + L.mask;
    float* const rmask = cmask + 2 * TJ;
    float* const stat = ws + L.stat;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
    const int q = tc::cluster_rank(), nch = tc::cluster_blocks(), cid = tc::cluster_index(), G = tc::cluster_count();
    const int h0 = q * HC;
    const int JT = (N + TJ - 1) / TJ, tiles = B * I * JT;
    const int mine = cid < tiles ? (tiles - cid + G - 1) / G : 0;  // this cluster's tiles: cid + k G
    // This block's rows of a tile in LN_in's backward.
    const int RB = (TJ + nch - 1) / nch, r_lo = q * RB, r_hi = r_lo + RB < TJ ? r_lo + RB : TJ;

    // The chunk's weight rows, rounded and ordered as the forward's.
    if (p.bf16 != 0)
        stage_weights<float, __nv_bfloat16, THREADS>(p, ws, ldw, HC, h0, C, Cp, H);
    else
        stage_weights<float, float, THREADS>(p, ws, ldw, HC, h0, C, Cp, H);

    // This warp's m16 tile (weight_row): lane row g is the projection of
    // hidden channel hh (a for warps 0-3, b for 4-7), row g + 8 its gate.
    int which, hh;
    weight_row(16 * warp + g, HC, h0, which, hh);
    const bool hok = hh < H;
    const float bias_p = hok ? p.at(pick(p.bias, which), hh) : 0.f;
    const float bias_g = hok ? p.at(pick(p.bias, which + 1), hh) : 0.f;
    const float* const cot = which ? db : da;

    float lns[CQ], lnb[CQ], dls[CQ], dlb[CQ];
#pragma unroll
    for (int qq = 0; qq < CQ; ++qq) {
        const int c = lane + 32 * qq;
        lns[qq] = c < C ? p.at(p.ln_s, c) : 0.f;
        lnb[qq] = c < C ? p.at(p.ln_b, c) : 0.f;
        dls[qq] = dlb[qq] = 0.f;
    }
    const float inv_c = 1.f / C;
    // dW of this warp's rows m3 + 0..31 and channels n3 + 0..CMAX / 2 - 1.
    const int m3 = (warp % 4) * 32, n3 = (warp / 4) * (CMAX / 2);
    float dw[2][NT3][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT3; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw[m][n][e] = 0.f;
    float dsum_p = 0.f, dsum_g = 0.f;  // db of rows g and g + 8, this lane's positions
    float* const pc = want_dw ? part + (size_t)cid * part_stride(C, H) : nullptr;  // the cluster's partial sums
    int held = 0;         // tiles in dW's accumulators since they were last added to pc
    bool stored = false;  // pc holds this thread's entries of dW
    // dW's accumulators added into pc (stored the first time), then zeroed;
    // each entry has one owner thread, which adds its flushes in order. A
    // row pair's old sums are all loaded, unconditionally (the scratch has
    // MAX_CHANNELS floats to spare past its end), before any is stored: one
    // round trip, not one a value.
    auto flush_dw = [&]() {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
            float* row[2];
            bool ok[2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                int wh, h;
                weight_row(m3 + 16 * m + 8 * half + g, HC, h0, wh, h);
                ok[half] = h < H;
                row[half] = pc + ((size_t)wh * H + (ok[half] ? h : 0)) * C;
            }
            float old[2][NT3][2];
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
                for (int n = 0; n < NT3; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float v = row[half][n3 + 8 * n + 2 * t + e];
                        old[half][n][e] = stored ? v : 0.f;
                    }
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
                for (int n = 0; n < NT3; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int c = n3 + 8 * n + 2 * t + e;
                        if (ok[half] && c < C) row[half][c] = old[half][n][e] + dw[m][n][2 * half + e];
                        dw[m][n][2 * half + e] = 0.f;
                    }
        }
        stored = true;
        held = 0;
    };

    auto coords = [&](int k, int& bb, int& i, int& j0) {
        const int tile = cid + k * G;
        bb = tile / (I * JT);
        const int rem = tile - bb * (I * JT);
        i = rem / JT;
        j0 = (rem - i * JT) * TJ;
    };
    // Whether the masks leave tile k a row and a column (every warp finds the same).
    auto live = [&](int k) {
        int bb, i, j0;
        coords(k, bb, i, j0);
        bool any = false;
        if (row_mask[(size_t)bb * I + i] != 0.f)
            for (int r = lane; r < TJ; r += 32) any |= j0 + r < N && col_mask[(size_t)bb * N + j0 + r] != 0.f;
        return __any_sync(0xffffffffu, any) != 0;
    };
    // The gradient of such a tile is 0: this block's rows of dz.
    auto zero_rows = [&](int k) {
        int bb, i, j0;
        coords(k, bb, i, j0);
        const int rows = (r_hi < N - j0 ? r_hi : N - j0) - r_lo;
        float* out = dz + (((size_t)bb * I + i) * N + j0 + r_lo) * C;
        for (int idx = threadIdx.x; idx < rows * C; idx += THREADS) out[idx] = 0.f;
    };
    // Tile k's z rows into stage s by 16-byte cp.async copies (rows past N
    // zero), its masks by 4-byte ones.
    auto stage = [&](int k, int s) {
        int bb, i, j0;
        coords(k, bb, i, j0);
        float* const zs = zbuf + s * TJ * ldz;
        for (int r = threadIdx.x; r < TJ; r += THREADS) {
            const bool ok = j0 + r < N;
            tc::cp_async4(cmask + s * TJ + r, ok ? col_mask + (size_t)bb * N + j0 + r : col_mask, ok ? 4 : 0);
        }
        if (threadIdx.x == 0) tc::cp_async4(rmask + 4 * s, row_mask + (size_t)bb * I + i, 4);
        const float* zt = z + (((size_t)bb * I + i) * N + j0) * C;
        if (vec_z) {
            const int chunks = C / 4;
            for (int idx = threadIdx.x; idx < TJ * chunks; idx += THREADS) {
                const int r = idx / chunks, c = (idx - r * chunks) * 4;
                const bool ok = j0 + r < N;
                tc::cp_async16(zs + r * ldz + c, ok ? zt + (size_t)r * C + c : z, ok ? 16 : 0);
            }
        } else {
            for (int idx = threadIdx.x; idx < TJ * C; idx += THREADS) {
                const int r = idx / C, c = idx - r * C;
                zs[r * ldz + c] = j0 + r < N ? zt[(size_t)r * C + c] : 0.f;
            }
        }
        tc::cp_async_commit();
    };
    // Once stage s has landed: LN_in in place, as the forward, each row's
    // mean and rstd kept.
    auto normalise = [&](int s) {
        tc::cp_async_wait<0>();
        __syncthreads();
        float* const zs = zbuf + s * TJ * ldz;
        for (int r0 = warp * RPW; r0 < TJ; r0 += WARPS * RPW) {
            float* rows = zs + r0 * ldz;
            float x[RPW][CQ], mu[RPW], rstd[RPW];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                float sum = 0.f;
#pragma unroll
                for (int qq = 0; qq < CQ; ++qq) {
                    const int c = lane + 32 * qq;
                    x[r][qq] = c < C ? rows[r * ldz + c] : 0.f;
                    sum += x[r][qq];
                }
                mu[r] = warp_sum(sum) * inv_c;
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                float s2 = 0.f;
#pragma unroll
                for (int qq = 0; qq < CQ; ++qq) {
                    const float d = lane + 32 * qq < C ? x[r][qq] - mu[r] : 0.f;
                    s2 += d * d;
                }
                rstd[r] = rsqrtf(warp_sum(s2) * inv_c + LN_EPS);
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
#pragma unroll
                for (int qq = 0; qq < CQ; ++qq) {
                    const int c = lane + 32 * qq;
                    if (c < Cp) rows[r * ldz + c] = (x[r][qq] - mu[r]) * rstd[r] * lns[qq] + lnb[qq];
                }
                if (lane == 0) {
                    stat[(s * TJ + r0 + r) * 2] = mu[r];
                    stat[(s * TJ + r0 + r) * 2 + 1] = rstd[r];
                }
            }
        }
    };

    int next = 0, buf = 0;
    while (next < mine && !live(next)) zero_rows(next++);
    if (next < mine) {
        stage(next, 0);
        normalise(0);
    }
    bool pending = false;  // this thread's arrival on the cluster barrier awaits its wait
    while (next < mine) {
        const int k = next;
        float* const zs = zbuf + buf * TJ * ldz;
        int bb, i, j0;
        coords(k, bb, i, j0);
        // This lane's cotangents of the tile, in flight while P is computed:
        // rows g and g + 8 share them, positions 8 n + 2t, + 1.
        float2 cv[NTJ];
        {
            const float* crow = cot + (((size_t)bb * H + (hok ? hh : 0)) * I + i) * N;
#pragma unroll
            for (int n = 0; n < NTJ; ++n) {
                const int j = j0 + 8 * n + 2 * t;
                cv[n] = make_float2(0.f, 0.f);
                if (!hok) continue;
                if (vec_cot) {  // N even: j < N implies j + 1 < N, and the pair is aligned
                    if (j < N) cv[n] = *reinterpret_cast<const float2*>(crow + j);
                } else {
                    if (j < N) cv[n].x = crow[j];
                    if (j + 1 < N) cv[n].y = crow[j + 1];
                }
            }
        }
        // The next tile's masks, in flight meanwhile: whether it is live.
        float next_r = 0.f, next_c[LQ] = {};
        if (k + 1 < mine) {
            int nb, ni, nj0;
            coords(k + 1, nb, ni, nj0);
            next_r = row_mask[(size_t)nb * I + ni];
#pragma unroll
            for (int u = 0; u < LQ; ++u) {
                const int r = lane + 32 * u;
                next_c[u] = r < TJ && nj0 + r < N ? col_mask[(size_t)nb * N + nj0 + r] : 0.f;
            }
        }
        __syncthreads();  // the tile is normalised

        // P of this warp's 16 rows over the tile's TJ positions, as the forward.
        float acc[NTJ][4];
#pragma unroll
        for (int n = 0; n < NTJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
        {
            const tc::Tile<float, true> tw{ws, ldw}, tz{zs, ldz};
#pragma unroll 4
            for (int k0 = 0; k0 < Cp; k0 += 8) {
                M::A fa;
                M::load_a(fa, tw, 16 * warp, k0, lane);
                M::B fb[NTJ];
#pragma unroll
                for (int n = 0; n < NTJ; ++n) M::load_b(fb[n], tz, 8 * n, k0, lane);
                tc::mma_tiles(acc, fa, fb);
            }
        }

        // The next live tile into the other stage, behind this one's products.
        next = k + 1;
        if (next < mine) {
            bool any = false;
#pragma unroll
            for (int u = 0; u < LQ; ++u) any |= next_c[u] != 0.f;
            if (!(__any_sync(0xffffffffu, any) && next_r != 0.f)) {
                zero_rows(next++);
                while (next < mine && !live(next)) zero_rows(next++);
            }
            if (next < mine) stage(next, buf ^ 1);
        }

        // dP in place of P, and into ps, position-major, once the cluster has
        // read the last tile's dzn out of it.
        if (pending) tc::cluster_wait();
        pending = false;
        const float ri = rmask[4 * buf];
#pragma unroll
        for (int n = 0; n < NTJ; ++n) {
            const int jl = 8 * n + 2 * t;
            const float e0 = cv[n].x * (ri * cmask[buf * TJ + jl]), e1 = cv[n].y * (ri * cmask[buf * TJ + jl + 1]);
            const float s0 = fast_sigmoid(acc[n][2] + bias_g), s1 = fast_sigmoid(acc[n][3] + bias_g);
            const float p0 = acc[n][0] + bias_p, p1 = acc[n][1] + bias_p;
            acc[n][0] = e0 * s0;
            acc[n][1] = e1 * s1;
            acc[n][2] = e0 * p0 * (s0 * (1.f - s0));
            acc[n][3] = e1 * p1 * (s1 * (1.f - s1));
            dsum_p += acc[n][0] + acc[n][1];
            dsum_g += acc[n][2] + acc[n][3];
            float* col = ps + jl * ldp + 16 * warp + g;
            col[0] = acc[n][0];
            col[ldp] = acc[n][1];
            col[8] = acc[n][2];
            col[ldp + 8] = acc[n][3];
        }
        __syncthreads();  // ps holds the block's dP

        // dW += dP . zn over the tile's positions, this warp's 32 rows x
        // CMAX / 2 channels. Positions 2t and 2t + 1 of each 8 stand for k = t
        // and t + 4 in both operands: A's and B's rows 2t, 2t + 1 fall in
        // distinct banks.
        if (want_dw && n3 < Cp) {
#pragma unroll 4
            for (int kk = 0; kk < NTJ; ++kk) {
                M::A fa[2];
                const float* pr = ps + (8 * kk + 2 * t) * ldp + m3 + g;
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    tc::split_tf32(__float_as_uint(pr[16 * m]), fa[m].hi[0], fa[m].lo[0]);
                    tc::split_tf32(__float_as_uint(pr[16 * m + 8]), fa[m].hi[1], fa[m].lo[1]);
                    tc::split_tf32(__float_as_uint(pr[ldp + 16 * m]), fa[m].hi[2], fa[m].lo[2]);
                    tc::split_tf32(__float_as_uint(pr[ldp + 16 * m + 8]), fa[m].hi[3], fa[m].lo[3]);
                }
                const float* zr = zs + (8 * kk + 2 * t) * ldz + n3 + g;
#pragma unroll
                for (int n0 = 0; n0 < NT3; n0 += NG) {
                    if (n3 + 8 * n0 >= Cp) continue;
                    M::B fb[NG];
#pragma unroll
                    for (int u = 0; u < NG; ++u) {
                        const int c = 8 * (n0 + u);
                        const bool in = n3 + c < Cp;
                        tc::split_tf32(in ? __float_as_uint(zr[c]) : 0u, fb[u].hi[0], fb[u].lo[0]);
                        tc::split_tf32(in ? __float_as_uint(zr[ldz + c]) : 0u, fb[u].hi[1], fb[u].lo[1]);
                    }
#pragma unroll
                    for (int m = 0; m < 2; ++m)
                        tc::mma_tiles(*reinterpret_cast<float(*)[NG][4]>(&dw[m][n0]), fa[m], fb);
                }
            }
            if (++held == FLUSH) flush_dw();
        }

        // This block's share of dzn = dP^T . W over its 128 rows.
        float acc2[MT2][NT2][4];
#pragma unroll
        for (int m = 0; m < MT2; ++m)
#pragma unroll
            for (int n = 0; n < NT2; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc2[m][n][e] = 0.f;
        const int m2 = (warp % WARPS_M2) * WM2, n2 = (warp / WARPS_M2) * WN2;
        if (n2 < Cp) {
            const tc::Tile<float, true> tp{ps, ldp};
            const tc::Tile<float, false> tw{ws, ldw};
#pragma unroll 4
            for (int k0 = 0; k0 < ROWS; k0 += 8) {
                M::B fb[NT2];
#pragma unroll
                for (int n = 0; n < NT2; ++n) {
                    if (n2 + 8 * n < Cp) {
                        M::load_b(fb[n], tw, n2 + 8 * n, k0, lane);
                    } else {
                        fb[n].hi[0] = fb[n].hi[1] = fb[n].lo[0] = fb[n].lo[1] = 0u;
                    }
                }
#pragma unroll
                for (int m = 0; m < MT2; ++m) {
                    M::A fa;
                    M::load_a(fa, tp, m2 + 16 * m, k0, lane);
                    tc::mma_tiles(acc2[m], fa, fb);
                }
            }
        }
        __syncthreads();  // every warp is done with dP
        if (n2 < Cp) {
#pragma unroll
            for (int m = 0; m < MT2; ++m)
#pragma unroll
                for (int n = 0; n < NT2; ++n) {
                    const int c = n2 + 8 * n + 2 * t;
                    if (n2 + 8 * n >= Cp) continue;
                    float* row = ps + (m2 + 16 * m + g) * ldz + c;
                    *reinterpret_cast<float2*>(row) = make_float2(acc2[m][n][0], acc2[m][n][1]);
                    *reinterpret_cast<float2*>(row + 8 * ldz) = make_float2(acc2[m][n][2], acc2[m][n][3]);
                }
        }
        // The cluster's shares are awaited while the next tile is normalised.
        tc::cluster_arrive();
        if (next < mine) normalise(buf ^ 1);
        tc::cluster_wait();  // every block's share of the tile's dzn is in place

        // This block's rows: dzn summed over the cluster in rank order, then
        // LN_in's backward, x^ from z, mean and rstd as the forward found them.
        for (int r = r_lo + warp; r < r_hi; r += WARPS) {
            const int j = j0 + r;
            if (j >= N) break;
            const size_t pos = (((size_t)bb * I + i) * N + j) * C;
            float zv[CQ], dn[CQ];
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) {
                const int c = lane + 32 * qq;
                zv[qq] = c < C ? z[pos + c] : 0.f;
                dn[qq] = 0.f;
            }
            for (int pr = 0; pr < nch; ++pr) {
                const unsigned base = tc::remote(ps + r * ldz, pr);
#pragma unroll
                for (int qq = 0; qq < CQ; ++qq) {
                    const int c = lane + 32 * qq;
                    if (c < C) dn[qq] += tc::ld_remote(base + 4u * c);
                }
            }
            const float mu = stat[(buf * TJ + r) * 2], rstd = stat[(buf * TJ + r) * 2 + 1];
            float xh[CQ], gg[CQ], s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) {
                const int c = lane + 32 * qq;
                xh[qq] = c < C ? (zv[qq] - mu) * rstd : 0.f;
                gg[qq] = dn[qq] * lns[qq];
                s1 += gg[qq];
                s2 += gg[qq] * xh[qq];
            }
            s1 = warp_sum(s1) * inv_c;
            s2 = warp_sum(s2) * inv_c;
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) {
                const int c = lane + 32 * qq;
                if (c < C) {
                    dz[pos + c] = rstd * (gg[qq] - s1 - xh[qq] * s2);
                    dls[qq] += dn[qq] * xh[qq];
                    dlb[qq] += dn[qq];
                }
            }
        }
        tc::cluster_arrive();  // done reading the cluster's ps: waited on before ps is written again
        pending = true;
        buf ^= 1;
    }
    if (pending) tc::cluster_wait();  // no block leaves while another reads its shared memory
    if (!want_dw) return;

    if (held > 0 || !stored) flush_dw();
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // over the quad's positions
        dsum_p += __shfl_xor_sync(0xffffffffu, dsum_p, off);
        dsum_g += __shfl_xor_sync(0xffffffffu, dsum_g, off);
    }
    if (hok && t == 0) {
        pc[4LL * H * C + (long long)which * H + hh] = dsum_p;
        pc[4LL * H * C + (long long)(which + 1) * H + hh] = dsum_g;
    }
    // LN_in's sums: the warps' in shared memory (the weights are done with),
    // then the block's in warp order.
    __syncthreads();
    float* const red = ws;  // [WARPS][2][Cp]
#pragma unroll
    for (int qq = 0; qq < CQ; ++qq) {
        const int c = lane + 32 * qq;
        if (c < C) {
            red[(2 * warp) * Cp + c] = dls[qq];
            red[(2 * warp + 1) * Cp + c] = dlb[qq];
        }
    }
    __syncthreads();
    float* const pl = part + (size_t)G * part_stride(C, H) + ((size_t)cid * nch + q) * 2 * C;
    for (int e = threadIdx.x; e < 2 * C; e += THREADS) {
        const int half = e / C, c = e - half * C;
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += red[(2 * w + half) * Cp + c];
        pl[e] = s;
    }
}

// out[e] = the clusters' (then, for LN_in's sums, the blocks') partial sums
// of element e, in order.
__global__ void project_backward_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int clusters,
                                            int blocks, long long stride, int c2) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float s = 0.f;
    if (e < stride) {
        for (int k = 0; k < clusters; ++k) s += part[k * stride + e];
        out[e] = s;
    } else if (e < stride + c2) {
        const float* pl = part + clusters * stride + (e - stride);
        for (int k = 0; k < blocks; ++k) s += pl[(size_t)k * c2];
        out[e] = s;
    }
}

// The clusters of a launch: as many as the card holds at once (asked once
// per device, shape and cluster size), no more than there are tiles.
template <int CMAX, int TJ>
int clusters(int C, int nch, long long tiles, int& G) {
    static size_t asked[MAX_DEVICES][MAX_CLUSTER + 1];
    static int active[MAX_DEVICES][MAX_CLUSTER + 1];
    static bool allowed[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    auto kernel = project_backward_kernel<CMAX, TJ>;
    const size_t smem = Layout(C, TJ).bytes();
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    if (!allowed[dev]) {
        if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT)) !=
            cudaSuccess)
            return (int)err;
        allowed[dev] = true;
    }
    if (asked[dev][nch] != smem) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = nch;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(nch);
        cfg.blockDim = dim3(THREADS);
        cfg.dynamicSmemBytes = smem;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int n = 0;
        if ((err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) != cudaSuccess) return (int)err;
        if (n < 1) return (int)cudaErrorInvalidConfiguration;
        active[dev][nch] = n;
        asked[dev][nch] = smem;
    }
    G = (int)(active[dev][nch] < tiles ? active[dev][nch] : tiles);
    return 0;
}

template <int CMAX, int TJ>
int launch(const float* z, const float* row_mask, const float* col_mask, const Params& p, const float* da,
           const float* db, float* dz, float* part, float* sums, int B, int I, int N, int C, int H,
           cudaStream_t stream) {
    const int nch = (H + HC - 1) / HC;
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    int G = 0, err = clusters<CMAX, TJ>(C, nch, tiles, G);
    if (err) return err;
    const bool want = part != nullptr && sums != nullptr;
    const int vec_z = (uintptr_t)z % 16 == 0 && C % 4 == 0;
    const int vec_cot = ((uintptr_t)da | (uintptr_t)db) % 8 == 0 && N % 2 == 0;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nch;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)(G * nch));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Layout(C, TJ).bytes();
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, project_backward_kernel<CMAX, TJ>, z, row_mask, col_mask, p, da, db, dz,
                                       part, B, I, N, C, H, (int)want, vec_z, vec_cot);
    if (e != cudaSuccess || !want) return (int)e;
    const long long stride = part_stride(C, H), total = stride + 2LL * C;
    project_backward_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, sums, G, G * nch,
                                                                                      stride, 2 * C);
    return (int)cudaGetLastError();
}

// The scratch a launch takes, in floats: the partial sums and MAX_CHANNELS
// to spare, which the flushes' loads past a row's end may read.
template <int CMAX, int TJ>
int scratch(long long* floats, int B, int I, int N, int C, int H) {
    const int nch = (H + HC - 1) / HC;
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    int G = 0, err = clusters<CMAX, TJ>(C, nch, tiles, G);
    if (err) return err;
    *floats = (long long)G * part_stride(C, H) + (long long)G * nch * 2 * C + MAX_CHANNELS;
    return 0;
}

}  // namespace bwd

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

// The float32 scratch of trimul_project_backward for these shapes, in
// floats, into *floats. Returns the cudaError_t (0 on success).
extern "C" int trimul_project_backward_scratch(long long* floats, int B, int I, int N, int C, int H, void* stream) {
    (void)stream;
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || H > bwd::MAX_CLUSTER * bwd::HC)
        return (int)cudaErrorInvalidValue;
    return C <= 128 ? bwd::scratch<128, 64>(floats, B, I, N, C, H) : bwd::scratch<256, 16>(floats, B, I, N, C, H);
}

// The gradients of trimul_project, float32 activations (dtype 0): z
// [B,I,N,C], the masks and the ten parameters as trimul_project takes them,
// the cotangents da, db [B,H,I,N] -> dz [B,I,N,C]; and, where part (the
// scratch above) and sums are given, sums [4 H C + 4 H + 2 C] float32: dW
// of ap, ag, bp, bg [H,C] each, their biases' [H] each, then LN_in's scale
// and bias [C] each. Returns the cudaError_t of the launches (0 on success).
extern "C" int trimul_project_backward(const void* z, const void* row_mask, const void* col_mask,
                                       const void* ln_in_scale, const void* ln_in_bias, const void* w_ap,
                                       const void* w_ag, const void* w_bp, const void* w_bg, const void* b_ap,
                                       const void* b_ag, const void* b_bp, const void* b_bg, const void* da,
                                       const void* db, void* dz, void* part, void* sums, int B, int I, int N, int C,
                                       int H, int dtype, int param_dtype, void* stream) {
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || H > bwd::MAX_CLUSTER * bwd::HC ||
        dtype != 0 || (param_dtype != 0 && param_dtype != 1))
        return (int)cudaErrorInvalidValue;
    const Params p{ln_in_scale, ln_in_bias, {w_ap, w_ag, w_bp, w_bg}, {b_ap, b_ag, b_bp, b_bg}, param_dtype};
    const float *pz = static_cast<const float*>(z), *pr = static_cast<const float*>(row_mask),
                *pc = static_cast<const float*>(col_mask), *pa = static_cast<const float*>(da),
                *pb = static_cast<const float*>(db);
    float *pd = static_cast<float*>(dz), *pp = static_cast<float*>(part), *ps = static_cast<float*>(sums);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return C <= 128 ? bwd::launch<128, 64>(pz, pr, pc, p, pa, pb, pd, pp, ps, B, I, N, C, H, s)
                    : bwd::launch<256, 16>(pz, pr, pc, p, pa, pb, pd, pp, ps, B, I, N, C, H, s);
}

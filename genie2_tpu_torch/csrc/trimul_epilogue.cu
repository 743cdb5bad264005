// trimul_epilogue: LN_out + linear_z folded into one product, times the
// sigmoid output gate, written row-major for the residual, on the tensor
// cores.
//
// Replaces genie2_tpu/ops/trimul_fused.py:263 epilogue_cm (Pallas kernel
// _epilogue_kernel, :228). For x [B,H,I,N] channel-major and z [B,I,N,C]
// (I rows of the pair representation: I = N, or a row block of sequence
// parallelism; every mode acts per position (b, i, j)):
//   mu, var = mean and variance of x[b,:,i,j] over H (float32)
//   r = rsqrt(var + 1e-6)
//   lin[d] = r * (x . ws)[d] - r * mu * u[d] + vb[d]
//   g[d] = (LN_in(z) . W_g)[d] + b_g[d], LN_in recomputed from z
//   out[b,i,j,d] = lin[d] * sigmoid(g[d])
// where ws = W_z * scale_out rounded to the activation dtype, u = sum_h ws
// and vb = W_z . bias_out + b_z: LN_out folded into linear_z, computed here
// while the weights are staged. The weights come in float32 in torch's
// Linear layout (W_z [D, H], W_g [D, C], k contiguous) and are rounded to
// the activation dtype as they are staged.
//
// Work at the main path's shapes (B=2, N=256, C=H=D=128): 8.6 GFLOP; reads
// 134 MB of x and z, writes 67 MB in float32. On the H100 that is 0.060 ms
// of bytes at 3.35 TB/s against 0.052 ms for three TF32 products at 495
// TFLOP/s: bound by bytes (bf16: half the bytes, one product at 989).
//
// Design: persistent blocks of 16 warps, one per SM, walk the tiles (b, i,
// 32 consecutive j); the 32 rows are the M of both products. What is
// resident and what streams: the two weight matrices (2 x 66 KB in float32
// at C=H=D=128, padded) stay in shared memory for every tile a block
// takes, folded, rounded and staged once; the x tile ([H][32 j], j
// contiguous as x lies) and the z tile ([32 j][C]) stream through two
// stages filled by 16-byte cp.async copies. 32 rows is what leaves room for
// two stages beside the weights (210 KB of 227 at C=H=D=128 in float32;
// 109 KB in bf16). Where the weights of all D channels do not fit (C or H
// near 256, or D above 128) the consumers walk the output channels in
// chunks of 32, 64 or 128 and restage each chunk per tile.
//
// The warps split the work by kind, so that the latency-bound per-tile work
// runs beside the products instead of between them. Eight producer warps
// stage tile k + 1 in the free stage, normalise its z rows in place (LN_in,
// float32 statistics, rounded to the activation dtype) and take the LN_out
// statistics of its 32 columns, while eight consumer warps multiply tile k:
// each warp 16 rows by DC / 4 channels, mma.sync m16n8k8 TF32 three times
// over (3xTF32) for float32, m16n8k16 for bf16, with ldmatrix fragment
// loads (ldmatrix.trans for the m-major x operand in bf16, loads by index
// for it in float32) from rows padded to distinct banks; they apply the
// LN_out fold and the gate to the accumulators in registers before the one
// store. Named barriers hand a stage over: READY from producers to
// consumers, FREE back. Any N, C and H up to 256 and any D: widths are
// padded with zeros to the k step, where a row is not a multiple of 16
// bytes the tiles are staged element by element with plain loads, and
// nothing past N or D is stored.
//
// Two more modes of the same kernel split it around an all-reduce, for the
// hidden channels of x split over the ranks of a model group (tensor
// parallelism, parallel/tensor_parallel.py): each rank holds H_r of the H
// channels and its columns of W_z.
//   partial (trimul_epilogue_partial): x [B,H_r,I,N] alone. The consumers'
//     x . ws product over this rank's channels and the producers' column
//     sums sum_h x and sum_h x^2 are written in float32 to one buffer,
//     part [B,I,N,D+2] (x . ws in channels 0..D-1, the sums in D and D+1),
//     followed by the weight sums [2, D] of this rank's channels, sum_h ws
//     and W_z . bias_out, which block 0 writes as it stages the weights;
//     no z, no LN_in, no gate, no bias.
//   finish (trimul_epilogue_finish): part summed over the ranks and z. The
//     producers take mu = sum x / H and var = sum x^2 / H - mu^2 over all H
//     channels from it, the consumers the gate product LN_in(z) . W_g as in
//     the full mode, and the output is lin[d] = r * part[d] - r * mu * u[d]
//     + vb[d] + b_z[d] times the gate, u and vb the reduced weight sums.

#include <limits.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int TJ = 32;         // rows (j) of a tile
constexpr int THREADS = 512;   // 16 warps
constexpr int CONSUMERS = 256; // warps 0-7: the products and the store
constexpr int PRODUCERS = THREADS - CONSUMERS;  // warps 8-15: loads, LN_in, LN_out statistics
constexpr int PWARPS = PRODUCERS / 32;
constexpr int STAGES = 2;      // x and z tiles: one consumed, one produced
constexpr int LDJ = TJ + 8;    // x tile row stride: fragment loads hit banks 8 t + g
constexpr int DC_MAX = 128;    // output channels of one weight chunk, at most
constexpr int Q = MAX_CHANNELS / 32;  // values of a row of at most 256 per lane
// Named barriers (0 is __syncthreads): READY + s, a tile is staged in stage
// s, normalised and its statistics written; FREE + s, the consumers are done
// with stage s; then one barrier within each role.
constexpr int BAR_READY = 1, BAR_FREE = BAR_READY + STAGES, BAR_PRODUCERS = BAR_FREE + STAGES,
              BAR_CONSUMERS = BAR_PRODUCERS + 1;
// float32 head: LN_out partial sums and sums of squares [2][PWARPS][TJ], r and
// r * mu of each stage's rows [2][STAGES][TJ], u, vb, b_g of the chunk [3][DC_MAX]
constexpr int HEAD_BYTES = (2 * PWARPS * TJ + 2 * STAGES * TJ + 3 * DC_MAX) * (int)sizeof(float);
constexpr size_t SMEM_LIMIT = 232448;  // per block on the H100
constexpr int MAX_DEVICES = 64;        // launch attributes are cached per device below this

__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The kernel's modes: one launch, or the two stages around an all-reduce.
constexpr int FULL = 0, PARTIAL = 1, FINISH = 2;

// The float32 parameters: LN_in scale and bias [C], W_z [D, H], LN_out
// scale and bias [H], b_z [D], W_g [D, C], b_g [D]; in the finish mode u and
// vb [D] of all H channels in place of W_z and the LN_out ones; in the
// partial mode `sums`, where it writes its weight sums [2, D]. A mode reads
// only its own (the others may be null).
struct Params {
    const float *ln_s, *ln_b, *w_z, *lo_s, *lo_b, *b_z, *w_g, *b_g, *u, *vb;
    float* sums;
};

// Padded widths and the shared-memory plan of one launch; C and H are the
// widths staged (0 for the tile a mode does not read).
template <typename T>
struct Plan {
    int Hp, Cp, ldh, ldc, DC;

    __host__ __device__ Plan(int C, int H, int dc) : DC(dc) {
        constexpr int K = tc::Mma<T>::KSTEP;
        constexpr int PAD = 16 / (int)sizeof(T);  // 16 bytes: fragment loads hit 32 distinct banks
        Hp = (H + K - 1) / K * K;
        Cp = (C + K - 1) / K * K;
        ldh = Hp + PAD;
        ldc = Cp + PAD;
    }
    __host__ __device__ int weight_elems() const { return DC * (ldh + ldc); }
    __host__ __device__ int stage_elems() const { return Hp * LDJ + TJ * ldc; }
    __host__ __device__ size_t smem() const {
        return HEAD_BYTES + (size_t)(weight_elems() + STAGES * stage_elems()) * sizeof(T);
    }
};

// Channels d0 .. d0 + DC of the weights into shared memory, zero past D, H
// and C: W_z folded with the LN_out scale and W_g, both rounded to T, and u,
// vb and b_g (the mode's own: the given u and vb plus b_z in the finish
// mode; in the partial one u and W_z . bias_out go to p.sums from block 0).
// Warps w0, w0 + nw, ... take one channel each, its whole row in registers
// first. Plain stores: visible after the caller's next barrier.
template <typename T, int MODE>
__device__ void load_weights(const Params& p, int d0, int DC, int D, int H, int C, int Hp, int Cp, int ldh,
                             int ldc, T* wzs, T* wgs, float* us, float* vbs, float* bgs, int w0, int nw) {
    const int lane = threadIdx.x & 31;
    for (int d = w0; d < DC; d += nw) {
        const bool ok = d0 + d < D;
        float a[Q], b[Q], s[Q], o[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int k = lane + 32 * q;
            a[q] = ok && k < H ? p.w_z[(size_t)(d0 + d) * H + k] : 0.f;
            s[q] = k < H ? p.lo_s[k] : 0.f;
            o[q] = k < H ? p.lo_b[k] : 0.f;
            b[q] = ok && k < C ? p.w_g[(size_t)(d0 + d) * C + k] : 0.f;
        }
        float su = 0.f, sv = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int k = lane + 32 * q;
            const T ws = Cvt<T>::from_f(a[q] * s[q]);
            su += Cvt<T>::to_f(ws);
            sv += a[q] * o[q];
            if (k < Hp) wzs[d * ldh + k] = ws;
            if (k < Cp) wgs[d * ldc + k] = Cvt<T>::from_f(b[q]);
        }
        su = warp_sum(su);
        sv = warp_sum(sv);
        if (lane == 0) {
            if (MODE == PARTIAL && ok && blockIdx.x == 0) {
                p.sums[d0 + d] = su;
                p.sums[D + d0 + d] = sv;
            }
            if (MODE == FINISH) {
                us[d] = ok ? p.u[d0 + d] : 0.f;
                vbs[d] = ok ? p.vb[d0 + d] + p.b_z[d0 + d] : 0.f;
            } else {
                us[d] = su;
                vbs[d] = ok && MODE == FULL ? sv + p.b_z[d0 + d] : 0.f;
            }
            bgs[d] = ok && MODE != PARTIAL ? p.b_g[d0 + d] : 0.f;
        }
    }
}

// DC: output channels of a weight chunk, 32, 64 or 128. C and H: the widths
// staged (z's and x's channels; 0 for a tile the mode does not read), Hn the
// channel count of the LN_out statistics (H, or all ranks' in the finish
// mode). part: the partial mode's output, the finish mode's input.
template <typename T, int DC, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
epilogue_kernel(const T* __restrict__ x, const T* __restrict__ z, const Params p, T* __restrict__ out,
                float* __restrict__ part, int B, int I, int N, int C, int H, int Hn, int D, int vec_x, int vec_z,
                int vec_out) {
    using M = tc::Mma<T>;
    constexpr int K = M::KSTEP;
    constexpr int V = 16 / (int)sizeof(T);  // elements per 16-byte copy
    constexpr int NT = DC / 32;             // mma tiles of 8 channels per consumer warp (4 groups)
    constexpr int RPW = TJ / PWARPS;        // z rows each producer warp normalises
    const Plan<T> pl(C, H, DC);
    const int Hp = pl.Hp, Cp = pl.Cp, ldh = pl.ldh, ldc = pl.ldc;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* red = reinterpret_cast<float*>(smem_raw);  // [2][PWARPS][TJ]
    float* rrs = red + 2 * PWARPS * TJ;               // [STAGES][TJ] r
    float* rmus = rrs + STAGES * TJ;                  // [STAGES][TJ] r * mu
    float* us = rmus + STAGES * TJ;                   // [DC] u of the chunk
    float* vbs = us + DC_MAX;                         // [DC] vb
    float* bgs = vbs + DC_MAX;                        // [DC] b_g
    T* wzs = reinterpret_cast<T*>(smem_raw + HEAD_BYTES);  // [DC][ldh] folded linear_z chunk
    T* wgs = wzs + DC * ldh;                               // [DC][ldc] gate weight chunk
    T* stages = wgs + DC * ldc;                            // STAGES x (x tile [Hp][LDJ], z tile [TJ][ldc])

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int JT = (N + TJ - 1) / TJ;
    const int tiles = B * I * JT;
    const int G = gridDim.x;
    const int mine = (tiles - (int)blockIdx.x + G - 1) / G;  // this block's tiles: blockIdx.x + k G
    const bool resident = D <= DC;
    const T zero = Cvt<T>::from_f(0.f);

    if (resident) load_weights<T, MODE>(p, 0, DC, D, H, C, Hp, Cp, ldh, ldc, wzs, wgs, us, vbs, bgs, warp, THREADS / 32);
    __syncthreads();

    if (warp >= CONSUMERS / 32) {
        // Producers: stage tile k in stage k % STAGES once the consumers are
        // done with it, normalise its z rows in place (LN_in, float32
        // statistics, rounded to T; channels C..Cp become 0) and take the
        // LN_out statistics of its 32 columns.
        const int pt = threadIdx.x - CONSUMERS, pw = warp - CONSUMERS / 32;
        float lns[Q], lnb[Q];  // this lane's channels of the LN_in scale and bias, c = lane + 32 q
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            lns[q] = c < C ? p.ln_s[c] : 0.f;
            lnb[q] = c < C ? p.ln_b[c] : 0.f;
        }
        for (int k = 0; k < mine; ++k) {
            const int s = k % STAGES, tile = blockIdx.x + k * G;
            if (k >= STAGES) bar_sync(BAR_FREE + s, THREADS);
            T* xs = stages + s * pl.stage_elems();
            T* zs = xs + Hp * LDJ;
            const int bb = tile / (I * JT), rem = tile % (I * JT), i = rem / JT, j0 = (rem % JT) * TJ;
            const size_t plane = (size_t)I * N;
            const T* xt = x + (size_t)bb * H * plane + (size_t)i * N + j0;  // + h * plane + j
            const T* zt = z + (((size_t)bb * I + i) * N + j0) * C;         // + r * C + c
            if constexpr (MODE != FINISH) {
                if (vec_x) {
                    for (int idx = pt; idx < Hp * (TJ / V); idx += PRODUCERS) {
                        const int h = idx / (TJ / V), c = (idx % (TJ / V)) * V;
                        const bool ok = h < H && j0 + c < N;
                        tc::cp_async16(xs + h * LDJ + c, ok ? xt + h * plane + c : x, ok ? 16 : 0);
                    }
                } else {
                    for (int idx = pt; idx < Hp * TJ; idx += PRODUCERS) {
                        const int h = idx / TJ, c = idx % TJ;
                        xs[h * LDJ + c] = (h < H && j0 + c < N) ? xt[h * plane + c] : zero;
                    }
                }
            }
            if constexpr (MODE != PARTIAL) {
                if (vec_z) {
                    const int chunks = C / V;
                    for (int idx = pt; idx < TJ * chunks; idx += PRODUCERS) {
                        const int r = idx / chunks, c = (idx % chunks) * V;
                        const bool ok = j0 + r < N;
                        tc::cp_async16(zs + r * ldc + c, ok ? zt + (size_t)r * C + c : z, ok ? 16 : 0);
                    }
                } else {
                    for (int idx = pt; idx < TJ * C; idx += PRODUCERS) {
                        const int r = idx / C, c = idx % C;
                        zs[r * ldc + c] = (j0 + r < N) ? zt[(size_t)r * C + c] : zero;
                    }
                }
            }
            tc::cp_async_commit();
            tc::cp_async_wait<0>();
            bar_sync(BAR_PRODUCERS, PRODUCERS);  // the tile has landed

            if constexpr (MODE != PARTIAL) {  // LN_in of this warp's rows, two passes over registers
                T* rows = zs + pw * RPW * ldc;
                float v[RPW][Q], mu[RPW], rstd[RPW];
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    float sum = 0.f;
#pragma unroll
                    for (int q = 0; q < Q; ++q) {
                        const int c = lane + 32 * q;
                        v[r][q] = c < C ? Cvt<T>::to_f(rows[r * ldc + c]) : 0.f;
                        sum += v[r][q];
                    }
                    mu[r] = warp_sum(sum) / C;
                }
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    float s2 = 0.f;
#pragma unroll
                    for (int q = 0; q < Q; ++q) {
                        const float d = lane + 32 * q < C ? v[r][q] - mu[r] : 0.f;
                        s2 += d * d;
                    }
                    rstd[r] = rsqrtf(warp_sum(s2) / C + LN_EPS);
                }
#pragma unroll
                for (int r = 0; r < RPW; ++r)
#pragma unroll
                    for (int q = 0; q < Q; ++q) {
                        const int c = lane + 32 * q;
                        if (c < Cp)
                            rows[r * ldc + c] = Cvt<T>::from_f((v[r][q] - mu[r]) * rstd[r] * lns[q] + lnb[q]);
                    }
            }
            if constexpr (MODE != FINISH) {  // LN_out partial sums: column j = lane, rows h = pw (mod PWARPS)
                float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
                for (int h = pw; h < H; h += PWARPS) {
                    const float v = Cvt<T>::to_f(xs[h * LDJ + lane]);
                    s1 += v;
                    s2 += v * v;
                }
                red[pw * TJ + lane] = s1;
                red[(PWARPS + pw) * TJ + lane] = s2;
            }
            bar_sync(BAR_PRODUCERS, PRODUCERS);
            if (pw == 0) {  // row j = lane: r and r * mu (the partial mode: the sums)
                const bool in = j0 + lane < N;
                float* sums = part + ((((size_t)bb * I + i) * N + j0 + lane) * (D + 2) + D);
                float s1 = 0.f, s2 = 0.f;
                if constexpr (MODE == FINISH) {
                    if (in) {
                        s1 = sums[0];
                        s2 = sums[1];
                    }
                } else {
#pragma unroll
                    for (int w = 0; w < PWARPS; ++w) {
                        s1 += red[w * TJ + lane];
                        s2 += red[(PWARPS + w) * TJ + lane];
                    }
                }
                if constexpr (MODE == PARTIAL) {
                    if (in) {
                        sums[0] = s1;
                        sums[1] = s2;
                    }
                } else {
                    const float mean = s1 / Hn, r = rsqrtf(s2 / Hn - mean * mean + LN_EPS);
                    rrs[s * TJ + lane] = r;
                    rmus[s * TJ + lane] = r * mean;
                }
            }
            bar_arrive(BAR_READY + s, THREADS);
        }
        return;
    }

    // Consumers: 2 warps along the rows x 4 groups of NT x 8 channels.
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 16, wn = (warp >> 1) * NT * 8;
    for (int k = 0; k < mine; ++k) {
        const int s = k % STAGES, tile = blockIdx.x + k * G;
        const int bb = tile / (I * JT), rem = tile % (I * JT), i = rem / JT, j0 = (rem % JT) * TJ;
        const T* xs = stages + s * pl.stage_elems();
        const T* zs = xs + Hp * LDJ;
        bar_sync(BAR_READY + s, THREADS);

        float rr[2], rmu[2];  // r and r * mu of this thread's rows wm + g and wm + g + 8
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            rr[half] = rrs[s * TJ + wm + g + 8 * half];
            rmu[half] = rmus[s * TJ + wm + g + 8 * half];
        }
        const tc::Tile<T, false> tx{xs, LDJ};
        const tc::Tile<T, true> tz{zs, ldc}, twz{wzs, ldh}, twg{wgs, ldc};
        for (int d0 = 0; d0 < D; d0 += DC) {
            if (!resident) {
                if (k > 0 || d0 > 0) bar_sync(BAR_CONSUMERS, CONSUMERS);  // the previous chunk is consumed
                load_weights<T, MODE>(p, d0, DC, D, H, C, Hp, Cp, ldh, ldc, wzs, wgs, us, vbs, bgs, warp,
                                      CONSUMERS / 32);
                bar_sync(BAR_CONSUMERS, CONSUMERS);
            }
            float am[NT][4], ag[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) am[n][e] = ag[n][e] = 0.f;

            if constexpr (MODE != FINISH) {
#pragma unroll 4
                for (int k0 = 0; k0 < Hp; k0 += K) {
                    typename M::A fa;
                    M::load_a(fa, tx, wm, k0, lane);
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        typename M::B fb;
                        M::load_b(fb, twz, wn + n * 8, k0, lane);
                        M::mma(am[n], fa, fb);
                    }
                }
            }
            if constexpr (MODE != PARTIAL) {
#pragma unroll 4
                for (int k0 = 0; k0 < Cp; k0 += K) {
                    typename M::A fa;
                    M::load_a(fa, tz, wm, k0, lane);
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        typename M::B fb;
                        M::load_b(fb, twg, wn + n * 8, k0, lane);
                        M::mma(ag[n], fa, fb);
                    }
                }
            }

#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int dd = wn + n * 8 + 2 * t, d = d0 + dd;  // channel in the chunk, in all D
                if (d >= D) continue;
                const bool two = d + 1 < D;
                const float u0 = us[dd], vb0 = vbs[dd], bg0 = bgs[dd];
                const float u1 = us[dd + 1], vb1 = vbs[dd + 1], bg1 = bgs[dd + 1];
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = wm + g + 8 * half;
                    if (j0 + row >= N) continue;
                    const size_t pos = ((size_t)bb * I + i) * N + j0 + row;
                    if constexpr (MODE == PARTIAL) {  // the raw partial product, float32
                        float* pp = part + pos * (D + 2) + d;
                        if (vec_out) {  // D even: the pair is whole and 8-byte aligned
                            tc::store_pair(pp, am[n][2 * half], am[n][2 * half + 1]);
                        } else {
                            pp[0] = am[n][2 * half];
                            if (two) pp[1] = am[n][2 * half + 1];
                        }
                        continue;
                    }
                    float m0 = am[n][2 * half], m1 = am[n][2 * half + 1];
                    if constexpr (MODE == FINISH) {  // x . ws summed over the ranks
                        const float* pp = part + pos * (D + 2) + d;
                        m0 = pp[0];
                        m1 = two ? pp[1] : 0.f;
                    }
                    const float o0 = (rr[half] * m0 - rmu[half] * u0 + vb0) * sigmoid(ag[n][2 * half] + bg0);
                    const float o1 = (rr[half] * m1 - rmu[half] * u1 + vb1) * sigmoid(ag[n][2 * half + 1] + bg1);
                    T* po = out + pos * D + d;
                    if (vec_out) {  // D even: the pair is whole and aligned
                        tc::store_pair(po, o0, o1);
                    } else {
                        po[0] = Cvt<T>::from_f(o0);
                        if (two) po[1] = Cvt<T>::from_f(o1);
                    }
                }
            }
        }
        // The stage is free for the producers' tile k + STAGES, if there is one
        // (an arrival nobody waits for would be left at exit).
        if (k + STAGES < mine) bar_arrive(BAR_FREE + s, THREADS);
    }
}

template <typename T, int DC, int MODE>
int launch_dc(const T* x, const T* z, const Params& p, T* out, float* part, int B, int I, int N, int C, int H,
              int Hn, int D, bool vec_x, bool vec_z, bool vec_out, cudaStream_t stream) {
    // The shared-memory allowance and the blocks an SM holds, set and asked
    // once per device and size: both are host calls the main path would
    // otherwise pay at every launch.
    static size_t smem_set[MAX_DEVICES];
    static int blocks[MAX_DEVICES];
    const size_t smem = Plan<T>(C, H, DC).smem();
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (smem_set[dev] != smem) {
        int per_sm = 0, sms = 0;
        if ((err = cudaFuncSetAttribute(epilogue_kernel<T, DC, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem)) != cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epilogue_kernel<T, DC, MODE>, THREADS,
                                                                 smem)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)err;
        blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
        smem_set[dev] = smem;
    }
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    const int grid = (int)(tiles < blocks[dev] ? tiles : blocks[dev]);
    epilogue_kernel<T, DC, MODE><<<grid, THREADS, smem, stream>>>(x, z, p, out, part, B, I, N, C, H, Hn, D,
                                                                  (int)vec_x, (int)vec_z, (int)vec_out);
    return (int)cudaGetLastError();
}

// C and H: the widths staged (0 for the tile the mode does not read).
template <typename T, int MODE>
int launch(const void* x, const void* z, const Params& p, void* out, float* part, int B, int I, int N, int C,
           int H, int Hn, int D, cudaStream_t stream) {
    // The output chunk: all D channels where they fit (the weights then stay
    // for every tile), else the widest of 128, 64 and 32 channels that does.
    int dc = 0;
    for (int c = 32; c <= DC_MAX; c *= 2) {
        if (Plan<T>(C, H, c).smem() > SMEM_LIMIT) break;
        dc = c;
        if (c >= D) break;
    }
    if (dc == 0 || (long long)B * I * ((N + TJ - 1) / TJ) > INT_MAX) return (int)cudaErrorInvalidValue;
    const bool vec_x = (uintptr_t)x % 16 == 0 && (N * sizeof(T)) % 16 == 0;
    const bool vec_z = (uintptr_t)z % 16 == 0 && (C * sizeof(T)) % 16 == 0;
    const bool vec_out = D % 2 == 0 && (MODE == PARTIAL ? (uintptr_t)part % 8 == 0 : (uintptr_t)out % 16 == 0);
    const T* px = static_cast<const T*>(x);
    const T* pz = static_cast<const T*>(z);
    T* po = static_cast<T*>(out);
    if (dc == 32) return launch_dc<T, 32, MODE>(px, pz, p, po, part, B, I, N, C, H, Hn, D, vec_x, vec_z, vec_out,
                                                   stream);
    if (dc == 64) return launch_dc<T, 64, MODE>(px, pz, p, po, part, B, I, N, C, H, Hn, D, vec_x, vec_z, vec_out,
                                                   stream);
    return launch_dc<T, 128, MODE>(px, pz, p, po, part, B, I, N, C, H, Hn, D, vec_x, vec_z, vec_out,
                                                   stream);
}

}  // namespace

// x [B,H,I,N], z [B,I,N,C] and out [B,I,N,D] of dtype 0 = float32 or 1 =
// bfloat16; the eight parameters are float32 (see Params).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int trimul_epilogue(const void* x, const void* z, const void* ln_in_scale, const void* ln_in_bias,
                               const void* w_z, const void* ln_out_scale, const void* ln_out_bias,
                               const void* b_z, const void* w_g, const void* b_g, void* out, int B, int I,
                               int N, int C, int H, int D, int dtype, void* stream) {
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || H > MAX_CHANNELS || D < 1)
        return (int)cudaErrorInvalidValue;
    const Params p{static_cast<const float*>(ln_in_scale), static_cast<const float*>(ln_in_bias),
                   static_cast<const float*>(w_z),         static_cast<const float*>(ln_out_scale),
                   static_cast<const float*>(ln_out_bias), static_cast<const float*>(b_z),
                   static_cast<const float*>(w_g),         static_cast<const float*>(b_g),
                   nullptr,                                nullptr,
                   nullptr};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float, FULL>(x, z, p, out, nullptr, B, I, N, C, H, H, D, s);
    if (dtype == 1) return launch<__nv_bfloat16, FULL>(x, z, p, out, nullptr, B, I, N, C, H, H, D, s);
    return (int)cudaErrorInvalidValue;
}

// The partial mode: x [B,H,I,N] (this rank's H channels, dtype as above),
// W_z [D, H] (its columns) and the LN_out scale and bias [H] (its
// channels), float32 -> part, float32: [B,I,N,D+2] then [2, D].
extern "C" int trimul_epilogue_partial(const void* x, const void* w_z, const void* ln_out_scale,
                                       const void* ln_out_bias, void* part, int B, int I, int N, int H, int D,
                                       int dtype, void* stream) {
    if (B < 1 || I < 1 || N < 1 || H < 1 || H > MAX_CHANNELS || D < 1) return (int)cudaErrorInvalidValue;
    float* pp = static_cast<float*>(part);
    const Params p{nullptr, nullptr, static_cast<const float*>(w_z), static_cast<const float*>(ln_out_scale),
                   static_cast<const float*>(ln_out_bias), nullptr, nullptr, nullptr, nullptr, nullptr,
                   pp + (size_t)B * I * N * (D + 2)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float, PARTIAL>(x, nullptr, p, nullptr, pp, B, I, N, 0, H, H, D, s);
    if (dtype == 1) return launch<__nv_bfloat16, PARTIAL>(x, nullptr, p, nullptr, pp, B, I, N, 0, H, H, D, s);
    return (int)cudaErrorInvalidValue;
}

// The finish mode: part [B,I,N,D+2] float32 summed over the ranks, z
// [B,I,N,C] and out [B,I,N,D] of dtype as above; H the channel count of all
// ranks; LN_in scale and bias [C], u and vb [D] (sum_h ws and W_z . bias_out
// over all H, the tail of part), b_z [D], W_g [D, C] and b_g [D], float32.
extern "C" int trimul_epilogue_finish(const void* part, const void* z, const void* ln_in_scale,
                                      const void* ln_in_bias, const void* u, const void* vb, const void* b_z,
                                      const void* w_g, const void* b_g, void* out, int B, int I, int N, int C, int H,
                                      int D, int dtype, void* stream) {
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
    const Params p{static_cast<const float*>(ln_in_scale), static_cast<const float*>(ln_in_bias), nullptr,
                   nullptr, nullptr, static_cast<const float*>(b_z), static_cast<const float*>(w_g),
                   static_cast<const float*>(b_g), static_cast<const float*>(u), static_cast<const float*>(vb),
                   nullptr};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* pp = const_cast<float*>(static_cast<const float*>(part));
    if (dtype == 0) return launch<float, FINISH>(nullptr, z, p, out, pp, B, I, N, C, 0, H, D, s);
    if (dtype == 1) return launch<__nv_bfloat16, FINISH>(nullptr, z, p, out, pp, B, I, N, C, 0, H, D, s);
    return (int)cudaErrorInvalidValue;
}

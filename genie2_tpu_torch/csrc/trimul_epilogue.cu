// trimul_epilogue: LN_out + linear_z folded into one product, times the
// sigmoid output gate, written row-major for the residual, on the tensor
// cores.
//
// Replaces genie2_tpu/ops/trimul_fused.py:263 epilogue_cm (Pallas kernel
// _epilogue_kernel, :228). For x [B,H,I,N] channel-major and z [B,I,N,C]
// (I rows of the pair representation: I = N, or a row block of sequence
// parallelism; every kernel acts per position (b, i, j)):
//   mu, var = mean and variance of x[b,:,i,j] over H (float32)
//   r = rsqrt(var + 1e-6)
//   lin[d] = r * (x . ws)[d] - r * mu * u[d] + vb[d]
//   g[d] = (LN_in(z) . W_g)[d] + b_g[d], LN_in recomputed from z
//   out[b,i,j,d] = lin[d] * sigmoid(g[d])
// where ws = W_z * scale_out rounded to the activation dtype, u = sum_h ws
// and vb = W_z . bias_out + b_z: LN_out folded into linear_z, computed here
// while the weights are staged. The weights come in torch's Linear layout
// (W_z [D, H], W_g [D, C], k contiguous), all in float32 or all in
// bfloat16, and are rounded to the activation dtype as they are staged (a
// bfloat16 weight widens to float32 exactly, so both give the same bits).
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
// Two more kernels split the epilogue around an all-reduce, for the hidden
// channels of x split over the ranks of a model group (tensor parallelism,
// parallel/tensor_parallel.py): each rank holds H_r of the H channels and
// its columns of W_z. Both move one float32 buffer, part [B,I,N,D+2] (x .
// ws in channels 0..D-1, sum_h x and sum_h x^2 in D and D+1) followed by
// the weight sums [2, D] (sum_h ws and W_z . bias_out). The positions of a
// tile are consecutive rows of part, so a tile's part is one contiguous span
// of rows (D + 2) floats (16,640 bytes for 32 rows at D=128), moved whole by
// one bulk copy of the tensor memory accelerator: one instruction of one
// lane, where lane-wise copies or stores at a stride of (D + 2) floats cost
// every thread instructions and leave 8 of every 32 bytes of a sector run
// astride two sectors. A span whose start or length is not a multiple of 16
// bytes (an odd first position at D=128, an odd tail of N % 32 rows) goes by
// 8- or 4-byte copies (the finish) or plain coalesced stores (the partial)
// instead. Where span tiles do not fit in shared memory beside the resident
// weights and the ring (wide C, H or D; choose_plan), the consumers read or
// write the spans of part in place instead. Both keep the copies of two
// tiles in flight ahead of the one their producers take, in a ring of up to
// four stages; both run their 3xTF32 products with the three terms issued
// across the tiles (tc::mma_tiles), so that consecutive mma.sync are
// independent.
//   partial (epilogue_partial_kernel): x [B,H_r,I,N] -> part. Bound by the
//     68 MB it writes at B=2, N=256, D=128 (33.5 MB of x at H_r = 64 in
//     float32): 0.030 ms. Two blocks an SM (at the main path's shapes the
//     plan fits in half of its shared memory), each of 8 consumer warps, 4
//     x producer warps and one storer warp. The producers stage x tiles and
//     take their column sums; the consumers compute the transposed product
//     ws . x (M = the output channels, N = the 32 positions: the folded W_z
//     is the operand staged once) and write the accumulators and the column
//     sums into a float32 output tile laid out as the span, then each warp
//     arrives on the tile's mbarrier and moves on; the storer stores a tile
//     once every consumer warp has arrived, by one bulk store, and frees it
//     for tile k + 2 on a second mbarrier once the store has read it. Two
//     output tiles alternate, so tile k's store runs beside tile k + 1's
//     product. The weight rows are staged in an order (channel_of_row)
//     that puts each store instruction's 32 values in 32 distinct banks.
//     Block 0 writes the weight sums as it stages the weights.
//   finish (epilogue_finish_kernel): part summed over the ranks, and z ->
//     out. Bound by the 68 MB of part and 67 MB of z it reads and 67 MB it
//     writes: 0.060 ms. The full kernel's warps, tiles and gate product, in
//     a ring of up to four stages (the finish
//     stages no x tile and no W_z): lane 0 of the producers stages each
//     tile's part span by one bulk copy on the stage's mbarrier while the
//     producers stage and normalise its z rows; the consumers run the gate
//     product, wait for the span, take r and r * mu from its sums, fold x .
//     ws from it in their accumulator layout, and compute all of a warp's
//     values before its stores, so that its sigmoids run side by side (the
//     gate's sigmoid is the fast one, as the projection's). A tile's 16-row
//     halves are staged as 4 x 4 transposes of their rows (row_of_slot), so
//     that a warp's reads of the span at its stride of D + 2 = 130 floats
//     fall in distinct banks.
//
// trimul_epilogue_backward: the epilogue's gradients, float32 on the tensor
// cores. It replaces no TPU kernel: no Pallas kernel of genie2_tpu has a
// backward (autograd differentiates the XLA form of the op there). It was
// added for the training step, where the port's earlier backward, the plain
// version's gradient recomputed, took a third of the card's time. With the
// cotangent dout [B,I,N,D] and, per position, x^ = r (x - mu) over H (LN_out
// without its affine), lin = x^ . ws + vb, zn = LN_in(z), g = zn . W_g + b_g,
// s = sigmoid(g):
//   dlin = dout s, dg = dout lin s (1 - s)
//   dx^ = dlin . ws, dx = r (dx^ - mean dx^ - x^ mean(dx^ x^))  (LN_out)
//   dzn = dg . W_g,  dz = LN_in's backward of dzn
//   d ws = sum over positions of dlin^T x^, d vb = sum dlin,
//   d W_g = sum dg^T zn, d b_g = sum dg, d ln_in_scale = sum dzn z^,
//   d ln_in_bias = sum dzn
// and the wrapper (ops/trimul.py) turns d ws and d vb into the gradients of
// W_z, LN_out's scale and bias and b_z. Work at the training step's shapes
// (B=4, N=256, C=H=D=128): six [B N N, 128] x [128, 128] products, 51.5
// GFLOP, 0.31 ms as three TF32 products at 495 TFLOP/s, against 0.20 ms for
// reading x, z, dout and writing dx, dz: bound by operations.
//
// Design: the projection's backward's (csrc/trimul_project.cu): a cluster of
// blocks walks tiles of TJ positions (b, i, j0..) together, each block a
// chunk of DC output channels (64 at C, H <= 128; else 32 in tiles of 16
// positions), so that its rows of ws and W_g stay in shared memory and its
// weight sums in registers, and D <= 256 takes at most 8 blocks. Each block
// stages the tile's x columns and z rows by cp.async (the next tile's
// behind this one's products), normalises them in place (x^, zn, with the
// statistics as the forward takes them), and runs P1: main = x^ . ws^T and
// g = zn . W_g^T of its channels (mma.sync m16n8k8, 3xTF32), with dout read
// while P1 runs; one elementwise pass turns them into dlin and dg in shared
// memory, position-major. P3 adds dlin^T . x^ and dg^T . zn into the
// weight sums held in registers (added into the cluster's float32 partial
// sums every 512 positions), and P2 takes the block's shares of dx^ and dzn
// (K = its DC channels). Both take positions (P3) or channels (P2) 2t and
// 2t + 1 of each 8 for m16n8k8's k = t and t + 4, so that the row strides of
// bwd::Layout put their loads in distinct banks. After a cluster barrier
// each block sums its rows of the tile's shares over the cluster
// (distributed shared memory, in rank order) and finishes both LayerNorms'
// backward, z re-read from device memory and x^ from a transposed copy of
// its rows (an odd row stride), and writes dz row by row and dx
// channel-major from that copy. The bias, LN_in and cluster sums are summed
// by a second launch in a fixed order: two calls give the same bits.
// Without weight gradients (TDS's twist) P3, the scratch and the second
// launch are left out.

#include <limits.h>
#include <stdint.h>

#include <initializer_list>

#include "tensor_core.cuh"
#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int TJ = 32;         // rows (j) of a tile
constexpr int THREADS = 512;   // the full and finish kernels: 16 warps
constexpr int CONSUMERS = 256; // warps 0-7: the products and the store
constexpr int PRODUCERS = THREADS - CONSUMERS;  // warps 8-15: loads, LN_in, LN_out statistics
constexpr int PWARPS = PRODUCERS / 32;
constexpr int P_PRODUCERS = 128;  // the partial kernel: 4 x producer warps beside the 8 consumer ones
constexpr int P_THREADS = CONSUMERS + P_PRODUCERS + 32;  // and its storer warp
constexpr int P_PWARPS = P_PRODUCERS / 32;
constexpr int STAGES = 2;      // the full kernel's x and z tiles: one consumed, one produced
constexpr int MAX_STAGES = 4;  // the split kernels' rings, at most
constexpr int LDJ = TJ + 8;    // x tile row stride: fragment loads hit banks 8 t + g
constexpr int DC_MAX = 128;    // output channels of one weight chunk, at most
constexpr int Q = MAX_CHANNELS / 32;  // values of a row of at most 256 per lane
// Named barriers (0 is __syncthreads): READY + s, a tile is staged in stage
// s, normalised and its statistics written; FREE + s, the consumers are done
// with stage s; then one barrier within each role.
constexpr int BAR_READY = 1, BAR_FREE = BAR_READY + MAX_STAGES, BAR_PRODUCERS = BAR_FREE + MAX_STAGES,
              BAR_CONSUMERS = BAR_PRODUCERS + 1;
// The full kernel's float32 head: LN_out partial sums and sums of squares
// [2][PWARPS][TJ], r and r * mu of each stage's rows [2][STAGES][TJ], u, vb,
// b_g of the chunk [3][DC_MAX]
constexpr int HEAD_BYTES = (2 * PWARPS * TJ + 2 * STAGES * TJ + 3 * DC_MAX) * (int)sizeof(float);
constexpr size_t SMEM_LIMIT = 232448;        // per block on the H100
constexpr size_t SMEM_HALF = 233472 / 2 - 1024;  // per block, for two blocks an SM (1 KB each reserved)
constexpr int MAX_DEVICES = 64;              // launch attributes are cached per device below this

// The gate, with the fast exponential and division (as the projection's,
// csrc/trimul_project.cu): within a few float32 ulps of torch.sigmoid, and 0
// where exp(-x) overflows.
__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// What load_weights stages: the full epilogue's weights, the partial's, the
// finish's.
constexpr int FULL = 0, PARTIAL = 1, FINISH = 2;

// The parameters, all float32 or all (bf16) bfloat16: LN_in scale and bias
// [C], W_z [D, H], LN_out scale and bias [H], b_z [D], W_g [D, C], b_g [D];
// the finish reads u and vb [D] of all H channels (float32, the tail of
// part) in place of W_z and the LN_out ones; the partial writes its weight
// sums [2, D] to `sums`. A kernel reads only its own (the others may be
// null).
struct Params {
    const void *ln_s, *ln_b, *w_z, *lo_s, *lo_b, *b_z, *w_g, *b_g;
    const float *u, *vb;
    float* sums;
    int bf16;

    __device__ __forceinline__ float at(const void* q, size_t i) const {
        return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]) : static_cast<const float*>(q)[i];
    }
};

// The partial kernel's channel order: weight row r = 32 G + 16 u + 8 h +
// 4 a + b holds channel 32 G + 16 a + 8 h + 4 u + b (bits 2 and 4 swapped,
// its own inverse). Accumulator rows g = 4 a + b and g + 8 of the consumer
// warp with m16 tile u then write a row of the output tile at channels whose
// banks, 16 a + b + 4 t (+ const) at the span's stride of 130 floats, are
// distinct across the warp's lanes.
__host__ __device__ constexpr int channel_of_row(int r) {
    return (r & ~0x14) | ((r >> 2 & 1) << 4) | ((r >> 4 & 1) << 2);
}

// The finish kernel's row order: mma row m of a 16-row half holds the
// tile's row 4 (m % 4) + m / 4 of that half (a 4 x 4 transpose, its own
// inverse), so that the rows g = 0..3 a warp's first 16 lanes read at the
// span's stride of 130 floats are 4 rows apart and their 8-byte reads fall
// in distinct banks.
__host__ __device__ constexpr int row_of_slot(int m) { return (m & ~15) | ((m & 3) << 2) | ((m >> 2) & 3); }

// Padded widths and the shared-memory plan of one launch of the full kernel;
// C and H are the widths staged.
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

// The shared-memory plan of one launch of a split kernel, made on the host:
// `stages` in the ring, DW weight rows staged (all D channels rounded up to
// the chunk where they fit, `resident`; else one chunk, restaged per tile),
// whether part's spans go through
// shared memory (`staged`; else the consumers read or write part in place,
// where a span tile is too wide to stage beside the rest),
// the padded width K (H_r for the partial, C for the finish) and its row
// stride, the floats of one span tile, and the byte offsets of the regions.
struct SplitPlan {
    int stages, resident, staged, DW, Kp, ldk, tile_ld;
    int off_tiles, off_w, off_stages;
    size_t smem;
};

// The partial: head (the producers' column sums [2][P_PWARPS][TJ], each
// stage's sums [MAX_STAGES][2][TJ], the output tiles' mbarriers [2][2]), two
// output tiles (where staged), the weights [DW][ldk]
// and the x stages [stages][Kp][LDJ]. The finish: head (the stages'
// mbarriers, then u, vb and b_g [DW] each), the stages' part tiles (where
// staged), the weights [DW][ldk] and the z stages [stages][TJ][ldk].
template <typename T, int MODE>
SplitPlan split_plan(int K, int D, int DC, int stages, bool resident, bool staged) {
    constexpr int STEP = tc::Mma<T>::KSTEP;
    SplitPlan pl{};
    pl.stages = stages;
    pl.resident = resident;
    pl.staged = staged;
    pl.DW = resident ? (D + DC - 1) / DC * DC : DC;
    pl.Kp = (K + STEP - 1) / STEP * STEP;
    pl.ldk = pl.Kp + 16 / (int)sizeof(T);
    pl.tile_ld = (TJ * (D + 2) + 3) / 4 * 4;
    size_t off = MODE == PARTIAL ? (size_t)(2 * P_PWARPS + 2 * MAX_STAGES) * TJ * sizeof(float) + 4 * sizeof(uint64_t)
                                 : MAX_STAGES * sizeof(uint64_t) + (size_t)3 * pl.DW * sizeof(float);
    pl.off_tiles = (int)off;
    if (staged) off += (size_t)(MODE == PARTIAL ? 2 : stages) * pl.tile_ld * sizeof(float);
    pl.off_w = (int)off;
    off += (size_t)pl.DW * pl.ldk * sizeof(T);
    pl.off_stages = (int)off;
    off += (size_t)stages * (MODE == PARTIAL ? pl.Kp * LDJ : TJ * pl.ldk) * sizeof(T);
    pl.smem = off;
    return pl;
}

// Weight rows 0 .. rows - 1 of channels from d0 into shared memory, zero past
// D, H and C: W_z folded with the LN_out scale and W_g, both rounded to T,
// and u, vb and b_g (the full kernel's: sum_h ws, W_z . bias_out + b_z; the
// finish's: the given u and vb plus b_z). The partial's rows hold channels
// in channel_of_row order, and block 0 writes its sum_h ws and W_z .
// bias_out to p.sums instead. P: the parameters' type. Warps w0, w0 + nw, ... take one row each, its whole row in
// registers first. Plain stores: visible after the caller's next barrier.
template <typename T, typename P, int MODE>
__device__ void stage_weight_rows(const Params& p, int d0, int rows, int D, int H, int C, int Hp, int Cp, int ldh,
                                  int ldc, T* wzs, T* wgs, float* us, float* vbs, float* bgs, int w0, int nw) {
    const int lane = threadIdx.x & 31;
    const P *w_z = static_cast<const P*>(p.w_z), *w_g = static_cast<const P*>(p.w_g);
    const P *lo_s = static_cast<const P*>(p.lo_s), *lo_b = static_cast<const P*>(p.lo_b);
    float s[Q], o[Q];  // the LN_out scale and bias of this lane's channels k = lane + 32 q
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int k = lane + 32 * q;
        s[q] = k < H ? Cvt<P>::to_f(lo_s[k]) : 0.f;
        o[q] = k < H ? Cvt<P>::to_f(lo_b[k]) : 0.f;
    }
    for (int d = w0; d < rows; d += nw) {
        const int ch = d0 + (MODE == PARTIAL ? channel_of_row(d) : d);
        const bool ok = ch < D;
        float a[Q], b[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int k = lane + 32 * q;
            a[q] = ok && k < H ? Cvt<P>::to_f(w_z[(size_t)ch * H + k]) : 0.f;
            b[q] = ok && k < C ? Cvt<P>::to_f(w_g[(size_t)ch * C + k]) : 0.f;
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
        if (MODE == FULL || (MODE == PARTIAL && blockIdx.x == 0)) {  // the sums someone reads
            su = warp_sum(su);
            sv = warp_sum(sv);
        }
        if (lane == 0) {
            if (MODE == PARTIAL) {
                if (ok && blockIdx.x == 0) {
                    p.sums[ch] = su;
                    p.sums[D + ch] = sv;
                }
            } else {
                const P *b_z = static_cast<const P*>(p.b_z), *b_g = static_cast<const P*>(p.b_g);
                us[d] = ok ? (MODE == FINISH ? p.u[ch] : su) : 0.f;
                vbs[d] = ok ? (MODE == FINISH ? p.vb[ch] : sv) + Cvt<P>::to_f(b_z[ch]) : 0.f;
                bgs[d] = ok ? Cvt<P>::to_f(b_g[ch]) : 0.f;
            }
        }
    }
}

// stage_weight_rows for the launch's parameter type, chosen once.
template <typename T, int MODE>
__device__ __forceinline__ void load_weights(const Params& p, int d0, int rows, int D, int H, int C, int Hp, int Cp,
                                             int ldh, int ldc, T* wzs, T* wgs, float* us, float* vbs, float* bgs,
                                             int w0, int nw) {
    if (p.bf16)
        stage_weight_rows<T, __nv_bfloat16, MODE>(p, d0, rows, D, H, C, Hp, Cp, ldh, ldc, wzs, wgs, us, vbs, bgs, w0,
                                                  nw);
    else
        stage_weight_rows<T, float, MODE>(p, d0, rows, D, H, C, Hp, Cp, ldh, ldc, wzs, wgs, us, vbs, bgs, w0, nw);
}

// This lane's channels c = lane + 32 q of the LN_in scale and bias.
__device__ __forceinline__ void ln_in_params(const Params& p, int C, float (&lns)[Q], float (&lnb)[Q]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        lns[q] = c < C ? p.at(p.ln_s, c) : 0.f;
        lnb[q] = c < C ? p.at(p.ln_b, c) : 0.f;
    }
}

// The z rows (b, i, j0 + r) of a tile into rows slot(r) of zs [TJ][ldc]:
// 16-byte cp.async copies (vec) or element loads by threads pt, pt + nt,
// ...; rows past N zero.
template <typename T, bool PERMUTED>
__device__ __forceinline__ void stage_z(T* zs, const T* z, const T* zt, int ldc, int C, int n_rows, int vec_z, int pt,
                                        int nt) {
    constexpr int V = 16 / (int)sizeof(T);  // elements per 16-byte copy
    if (vec_z) {
        const int chunks = C / V;
        for (int idx = pt; idx < TJ * chunks; idx += nt) {
            const int r = idx / chunks, c = (idx % chunks) * V;
            const bool ok = r < n_rows;
            tc::cp_async16(zs + (PERMUTED ? row_of_slot(r) : r) * ldc + c, ok ? zt + (size_t)r * C + c : z,
                           ok ? 16 : 0);
        }
    } else {
        for (int idx = pt; idx < TJ * C; idx += nt) {
            const int r = idx / C, c = idx % C;
            zs[(PERMUTED ? row_of_slot(r) : r) * ldc + c] = r < n_rows ? zt[(size_t)r * C + c] : Cvt<T>::from_f(0.f);
        }
    }
}

// LN_in of RPW rows in place, two passes over registers: float32 statistics,
// rounded to T; channels C..Cp become 0.
template <typename T, int RPW>
__device__ __forceinline__ void ln_in_rows(T* rows, int ldc, int C, int Cp, const float (&lns)[Q],
                                           const float (&lnb)[Q]) {
    const int lane = threadIdx.x & 31;
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
            if (c < Cp) rows[r * ldc + c] = Cvt<T>::from_f((v[r][q] - mu[r]) * rstd[r] * lns[q] + lnb[q]);
        }
}

// The x tile [Hp][LDJ] (columns j0 .. j0 + 31 of H planes) by threads pt,
// pt + nt, ...: 16-byte cp.async copies (vec) or element loads; zero past
// H and N.
template <typename T>
__device__ __forceinline__ void stage_x(T* xs, const T* x, const T* xt, size_t plane, int H, int Hp, int n_cols,
                                        int vec_x, int pt, int nt) {
    constexpr int V = 16 / (int)sizeof(T);
    if (vec_x) {
        for (int idx = pt; idx < Hp * (TJ / V); idx += nt) {
            const int h = idx / (TJ / V), c = (idx % (TJ / V)) * V;
            const bool ok = h < H && c < n_cols;
            tc::cp_async16(xs + h * LDJ + c, ok ? xt + h * plane + c : x, ok ? 16 : 0);
        }
    } else {
        for (int idx = pt; idx < Hp * TJ; idx += nt) {
            const int h = idx / TJ, c = idx % TJ;
            xs[h * LDJ + c] = (h < H && c < n_cols) ? xt[h * plane + c] : Cvt<T>::from_f(0.f);
        }
    }
}

// The tile's position (b, i, j0) and the rows it holds (fewer than TJ at
// the end of a row of N).
struct TilePos {
    size_t pos0;  // ((b I + i) N + j0): the tile's first row of part / out
    int bb, i, j0, rows;

    __device__ __forceinline__ TilePos(int tile, int I, int N) {
        const int JT = (N + TJ - 1) / TJ;
        bb = tile / (I * JT);
        const int rem = tile % (I * JT);
        i = rem / JT;
        j0 = (rem % JT) * TJ;
        rows = min(TJ, N - j0);
        pos0 = ((size_t)bb * I + i) * N + j0;
    }
};

// DC: output channels of a weight chunk, 32, 64 or 128.
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS, 1)
epilogue_kernel(const T* __restrict__ x, const T* __restrict__ z, const Params p, T* __restrict__ out, int B, int I,
                int N, int C, int H, int D, int vec_x, int vec_z, int vec_out) {
    using M = tc::Mma<T>;
    constexpr int K = M::KSTEP;
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
    const int tiles = B * I * ((N + TJ - 1) / TJ);
    const int G = gridDim.x;
    const int mine = (tiles - (int)blockIdx.x + G - 1) / G;  // this block's tiles: blockIdx.x + k G
    const bool resident = D <= DC;

    if (resident)
        load_weights<T, FULL>(p, 0, DC, D, H, C, Hp, Cp, ldh, ldc, wzs, wgs, us, vbs, bgs, warp, THREADS / 32);
    __syncthreads();

    if (warp >= CONSUMERS / 32) {
        // Producers: stage tile k in stage k % STAGES once the consumers are
        // done with it, normalise its z rows in place and take the LN_out
        // statistics of its 32 columns.
        const int pt = threadIdx.x - CONSUMERS, pw = warp - CONSUMERS / 32;
        float lns[Q], lnb[Q];
        ln_in_params(p, C, lns, lnb);
        for (int k = 0; k < mine; ++k) {
            const int s = k % STAGES;
            const TilePos tp(blockIdx.x + k * G, I, N);
            if (k >= STAGES) bar_sync(BAR_FREE + s, THREADS);
            T* xs = stages + s * pl.stage_elems();
            T* zs = xs + Hp * LDJ;
            const size_t plane = (size_t)I * N;
            stage_x(xs, x, x + (size_t)tp.bb * H * plane + (size_t)tp.i * N + tp.j0, plane, H, Hp, tp.rows, vec_x, pt,
                    PRODUCERS);
            stage_z<T, false>(zs, z, z + tp.pos0 * C, ldc, C, tp.rows, vec_z, pt, PRODUCERS);
            tc::cp_async_commit();
            tc::cp_async_wait<0>();
            bar_sync(BAR_PRODUCERS, PRODUCERS);  // the tile has landed

            ln_in_rows<T, RPW>(zs + pw * RPW * ldc, ldc, C, Cp, lns, lnb);
            {  // LN_out partial sums: column j = lane, rows h = pw (mod PWARPS)
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
            if (pw == 0) {  // row j = lane: r and r * mu
                float s1 = 0.f, s2 = 0.f;
#pragma unroll
                for (int w = 0; w < PWARPS; ++w) {
                    s1 += red[w * TJ + lane];
                    s2 += red[(PWARPS + w) * TJ + lane];
                }
                const float mean = s1 / H, r = rsqrtf(s2 / H - mean * mean + LN_EPS);
                rrs[s * TJ + lane] = r;
                rmus[s * TJ + lane] = r * mean;
            }
            bar_arrive(BAR_READY + s, THREADS);
        }
        return;
    }

    // Consumers: 2 warps along the rows x 4 groups of NT x 8 channels.
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 16, wn = (warp >> 1) * NT * 8;
    for (int k = 0; k < mine; ++k) {
        const int s = k % STAGES;
        const TilePos tp(blockIdx.x + k * G, I, N);
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
                load_weights<T, FULL>(p, d0, DC, D, H, C, Hp, Cp, ldh, ldc, wzs, wgs, us, vbs, bgs, warp,
                                      CONSUMERS / 32);
                bar_sync(BAR_CONSUMERS, CONSUMERS);
            }
            float am[NT][4], ag[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) am[n][e] = ag[n][e] = 0.f;

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
                    if (row >= tp.rows) continue;
                    const float o0 =
                        (rr[half] * am[n][2 * half] - rmu[half] * u0 + vb0) * sigmoid(ag[n][2 * half] + bg0);
                    const float o1 =
                        (rr[half] * am[n][2 * half + 1] - rmu[half] * u1 + vb1) * sigmoid(ag[n][2 * half + 1] + bg1);
                    T* po = out + (tp.pos0 + row) * D + d;
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

// The partial kernel. DC: output channels of a weight chunk, 32, 64 or 128:
// DC / 16 m16 tiles of channels, each taken by 128 / DC consumer warps with
// DC / 32 n8 tiles of the 32 positions each. Warps: the consumers, the x
// producers, and one warp that stores the output tiles (the storer).
template <typename T, int DC>
__global__ void __launch_bounds__(P_THREADS, 2)
epilogue_partial_kernel(const T* __restrict__ x, const Params p, float* __restrict__ part, const SplitPlan pl, int B,
                        int I, int N, int H, int D, int vec_x) {
    using M = tc::Mma<T>;
    constexpr int K = M::KSTEP;
    constexpr int MT = DC / 16;                     // m16 tiles of channels in a chunk
    constexpr int NT = DC / 32;                     // n8 tiles of positions per consumer warp
    constexpr int STAGE_THREADS = CONSUMERS + P_PRODUCERS;  // READY and FREE: the consumers and the x producers
    const int S = pl.stages, Hp = pl.Kp, ldh = pl.ldk, LD = D + 2;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* red = reinterpret_cast<float*>(smem_raw);  // [2][P_PWARPS][TJ] the producers' column sums
    float* sums = red + 2 * P_PWARPS * TJ;            // [MAX_STAGES][2][TJ] each stage's sum x, sum x^2
    uint64_t* written = reinterpret_cast<uint64_t*>(sums + 2 * MAX_STAGES * TJ);  // [2] an output tile is whole
    uint64_t* freed = written + 2;                    // [2] ... and its store has read it
    float* tiles = reinterpret_cast<float*>(smem_raw + pl.off_tiles);  // [2][tile_ld] output tiles
    T* wzs = reinterpret_cast<T*>(smem_raw + pl.off_w);                 // [DW][ldh] folded W_z, channel_of_row order
    T* xst = reinterpret_cast<T*>(smem_raw + pl.off_stages);            // [S][Hp][LDJ] x tiles

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tiles_all = B * I * ((N + TJ - 1) / TJ);
    const int G = gridDim.x;
    const int mine = (tiles_all - (int)blockIdx.x + G - 1) / G;
    const int pt = threadIdx.x - CONSUMERS;  // an x producer's thread index (the storer's from P_PRODUCERS)
    const size_t plane = (size_t)I * N;

    // Tile k's x into stage k % S, once the consumers are done with it
    // (x producers only), as one cp.async group (empty past the last tile).
    auto issue = [&](int k) {
        if (k < mine) {
            const int s = k % S;
            const TilePos tp(blockIdx.x + k * G, I, N);
            if (k >= S) bar_sync(BAR_FREE + s, STAGE_THREADS);
            stage_x(xst + (size_t)s * Hp * LDJ, x, x + (size_t)tp.bb * H * plane + (size_t)tp.i * N + tp.j0, plane, H,
                    Hp, tp.rows, vec_x, pt, P_PRODUCERS);
        }
        tc::cp_async_commit();
    };

    if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b) {
            tc::mbar_init(&written[b], CONSUMERS / 32);
            tc::mbar_init(&freed[b], 1);
        }
        tc::mbar_init_fence();
    }
    // Tiles of copies in flight ahead of the one the producers take: the
    // ring less the tile the consumers take and one for them to move on to.
    const int L = S > 3 ? S - 2 : 1;
    if (pt >= 0 && pt < P_PRODUCERS)
        for (int k = 0; k < L; ++k) issue(k);  // in flight while the weights are staged
    if (pl.resident)
        load_weights<T, PARTIAL>(p, 0, pl.DW, D, H, 0, Hp, 0, ldh, 0, wzs, nullptr, nullptr, nullptr, nullptr, warp,
                                 P_THREADS / 32);
    __syncthreads();

    if (pt >= P_PRODUCERS) {
        // The storer: output tile k, once every consumer warp has written it,
        // by one bulk store, or where its span is not 16-byte aligned, by
        // plain coalesced stores of its floats; then the tile is free for
        // tile k + 2. Nothing to store where the consumers write part.
        for (int k = 0; k < (pl.staged ? mine : 0); ++k) {
            const int b = k & 1;
            const TilePos tp(blockIdx.x + k * G, I, N);
            const float* o = tiles + b * pl.tile_ld;
            float* dst = part + tp.pos0 * LD;
            const int n = tp.rows * LD;
            tc::mbar_wait(&written[b], (k >> 1) & 1);
            if ((uintptr_t)dst % 16 == 0 && n % 4 == 0) {
                if (lane == 0) {
                    tc::bulk_store(dst, o, n * (int)sizeof(float));
                    tc::bulk_commit();
                    tc::bulk_wait<0, true>();  // the store has read the tile
                }
            } else {
                for (int e = lane; e < n; e += 32) dst[e] = o[e];
            }
            __syncwarp();
            if (lane == 0) tc::mbar_arrive(&freed[b]);
        }
        if (lane == 0) tc::bulk_wait<0, false>();
        return;
    }

    if (pt >= 0) {
        // x producers: the copies of tiles k + 1 .. k + L in flight while
        // tile k's column sums are taken.
        const int pw = pt >> 5;
        for (int k = 0; k < mine; ++k) {
            const int s = k % S;
            const T* xs = xst + (size_t)s * Hp * LDJ;
            issue(k + L);
            if (L == 2)
                tc::cp_async_wait<2>();
            else
                tc::cp_async_wait<1>();
            bar_sync(BAR_PRODUCERS, P_PRODUCERS);  // the tile has landed
            float s1 = 0.f, s2 = 0.f;  // column j = lane, rows h = pw (mod P_PWARPS)
#pragma unroll 4
            for (int h = pw; h < H; h += P_PWARPS) {
                const float v = Cvt<T>::to_f(xs[h * LDJ + lane]);
                s1 += v;
                s2 += v * v;
            }
            red[pw * TJ + lane] = s1;
            red[(P_PWARPS + pw) * TJ + lane] = s2;
            bar_sync(BAR_PRODUCERS, P_PRODUCERS);
            if (pw == 0) {
                s1 = s2 = 0.f;
#pragma unroll
                for (int w = 0; w < P_PWARPS; ++w) {
                    s1 += red[w * TJ + lane];
                    s2 += red[(P_PWARPS + w) * TJ + lane];
                }
                sums[(2 * s) * TJ + lane] = s1;
                sums[(2 * s + 1) * TJ + lane] = s2;
            }
            bar_arrive(BAR_READY + s, STAGE_THREADS);
        }
        return;
    }

    // Consumers: warp w takes m16 tile w % MT of the chunk's channels and
    // positions (w / MT) NT 8 .. + NT 8; thread (g, t) holds channels
    // channel_of_row(16 mt + g + 8 h) of positions 8 n + 2 t + e. They
    // write output tile b, or where it is not staged, the tile's span of
    // part in place, its rows up to `rows`.
    const int g = lane >> 2, t = lane & 3;
    const int mt = warp % MT, wj = (warp / MT) * NT * 8;
    for (int k = 0; k < mine; ++k) {
        const int s = k % S, b = k & 1;
        const TilePos tp(blockIdx.x + k * G, I, N);
        float* o = pl.staged ? tiles + b * pl.tile_ld : part + tp.pos0 * LD;
        const int rows = pl.staged ? TJ : tp.rows;
        bar_sync(BAR_READY + s, STAGE_THREADS);
        const tc::Tile<T, false> tx{xst + (size_t)s * Hp * LDJ, LDJ};
        for (int d0 = 0; d0 < D; d0 += DC) {
            if (!pl.resident) {
                if (k > 0 || d0 > 0) bar_sync(BAR_CONSUMERS, CONSUMERS);  // the previous chunk is consumed
                load_weights<T, PARTIAL>(p, d0, DC, D, H, 0, Hp, 0, ldh, 0, wzs, nullptr, nullptr, nullptr, nullptr,
                                         warp, CONSUMERS / 32);
                bar_sync(BAR_CONSUMERS, CONSUMERS);
            }
            const tc::Tile<T, true> tw{wzs + (size_t)(pl.resident ? d0 : 0) * ldh, ldh};
            float acc[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
            for (int k0 = 0; k0 < Hp; k0 += K) {
                typename M::A fa;
                typename M::B fb[NT];
                M::load_a(fa, tw, 16 * mt, k0, lane);
#pragma unroll
                for (int n = 0; n < NT; ++n) M::load_b(fb[n], tx, wj + n * 8, k0, lane);
                tc::mma_tiles<NT>(acc, fa, fb);
            }
            // Output tile b is free once tile k - 2's store has read it.
            if (pl.staged && d0 == 0 && k >= 2) tc::mbar_wait(&freed[b], ((k >> 1) - 1) & 1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int ch = d0 + channel_of_row(16 * mt + g + 8 * h);
                if (ch >= D) continue;
#pragma unroll
                for (int n = 0; n < NT; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int j = wj + 8 * n + 2 * t + e;
                        if (j < rows) o[j * LD + ch] = acc[n][2 * h + e];
                    }
            }
        }
        if (threadIdx.x < rows) {
            o[threadIdx.x * LD + D] = sums[(2 * s) * TJ + threadIdx.x];
            o[threadIdx.x * LD + D + 1] = sums[(2 * s + 1) * TJ + threadIdx.x];
        }
        // The stage's x tile and sums are read: the producers may refill it.
        if (k + S < mine) bar_arrive(BAR_FREE + s, STAGE_THREADS);
        // This warp's part of the output tile is written: the storer may
        // store it once every consumer warp's is.
        if (pl.staged) {
            tc::fence_proxy_async();
            __syncwarp();
            if (lane == 0) tc::mbar_arrive(&written[b]);
        }
    }
}

// The finish kernel. DC: output channels of a weight chunk, 32, 64 or 128.
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS, 1)
epilogue_finish_kernel(const float* __restrict__ part, const T* __restrict__ z, const Params p, T* __restrict__ out,
                       const SplitPlan pl, int B, int I, int N, int C, int Hn, int D, int vec_z, int vec_out) {
    using M = tc::Mma<T>;
    constexpr int K = M::KSTEP;
    constexpr int NT = DC / 32;             // mma tiles of 8 channels per consumer warp (4 groups)
    constexpr int RPW = TJ / PWARPS;        // z rows each producer warp normalises
    const int S = pl.stages, Cp = pl.Kp, ldc = pl.ldk, LD = D + 2;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [MAX_STAGES] a stage's part span has landed
    float* us = reinterpret_cast<float*>(full + MAX_STAGES);  // [DW] u
    float* vbs = us + pl.DW;                                  // [DW] vb + b_z
    float* bgs = vbs + pl.DW;                                 // [DW] b_g
    float* tiles = reinterpret_cast<float*>(smem_raw + pl.off_tiles);  // [S][tile_ld] part spans
    T* wgs = reinterpret_cast<T*>(smem_raw + pl.off_w);                 // [DW][ldc] gate weights
    T* zst = reinterpret_cast<T*>(smem_raw + pl.off_stages);            // [S][TJ][ldc] z tiles, row_of_slot order

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tiles_all = B * I * ((N + TJ - 1) / TJ);
    const int G = gridDim.x;
    const int mine = (tiles_all - (int)blockIdx.x + G - 1) / G;
    const int pt = threadIdx.x - CONSUMERS;  // a producer's thread index

    // Tile k's copies into stage k % S, once the consumers are done with it
    // (producers only): the span's bulk copy on the stage's mbarrier, or its
    // 8- / 4-byte copies (none where the consumers read part in place), and
    // the z rows, as one cp.async group (empty past the last tile).
    auto issue = [&](int k) {
        if (k < mine) {
            const int s = k % S;
            const TilePos tp(blockIdx.x + k * G, I, N);
            if (k >= S) bar_sync(BAR_FREE + s, THREADS);
            float* ps = tiles + (size_t)s * pl.tile_ld;
            const float* src = part + tp.pos0 * LD;
            const int n = tp.rows * LD;
            const bool bulk = pl.staged && (uintptr_t)src % 16 == 0 && n % 4 == 0;
            if (pt == 0) {  // the arrival; bytes 0 where the copies below stage the span
                tc::mbar_expect_tx(&full[s], bulk ? n * (int)sizeof(float) : 0);
                if (bulk) tc::bulk_copy(ps, src, n * (int)sizeof(float), &full[s]);
            }
            if (pl.staged && !bulk) {
                if ((uintptr_t)src % 8 == 0) {
                    for (int e = 2 * pt; e < n; e += 2 * PRODUCERS) {
                        if (e + 1 < n)
                            tc::cp_async8(ps + e, src + e, 8);
                        else
                            tc::cp_async4(ps + e, src + e, 4);
                    }
                } else {
                    for (int e = pt; e < n; e += PRODUCERS) tc::cp_async4(ps + e, src + e, 4);
                }
            }
            stage_z<T, true>(zst + (size_t)s * TJ * ldc, z, z + tp.pos0 * C, ldc, C, tp.rows, vec_z, pt, PRODUCERS);
        }
        tc::cp_async_commit();
    };

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) tc::mbar_init(&full[s], 1);
        tc::mbar_init_fence();
    }
    __syncthreads();  // the barriers, before the first bulk copy
    // Tiles of copies in flight ahead of the one the producers take: the
    // ring less the tile the consumers take and one for them to move on to.
    const int L = S > 3 ? S - 2 : 1;
    if (pt >= 0)
        for (int k = 0; k < L; ++k) issue(k);  // in flight while the weights are staged
    if (pl.resident)
        load_weights<T, FINISH>(p, 0, pl.DW, D, 0, C, 0, Cp, 0, ldc, nullptr, wgs, us, vbs, bgs, warp, THREADS / 32);
    __syncthreads();

    if (pt >= 0) {
        // Producers: the copies of tiles k + 1 .. k + L in flight while tile
        // k's z rows are normalised in place.
        const int pw = pt >> 5;
        float lns[Q], lnb[Q];
        ln_in_params(p, C, lns, lnb);
        for (int k = 0; k < mine; ++k) {
            const int s = k % S;
            T* zs = zst + (size_t)s * TJ * ldc;
            issue(k + L);
            if (L == 2)
                tc::cp_async_wait<2>();
            else
                tc::cp_async_wait<1>();
            bar_sync(BAR_PRODUCERS, PRODUCERS);  // the z rows (and copied spans) have landed
            ln_in_rows<T, RPW>(zs + pw * RPW * ldc, ldc, C, Cp, lns, lnb);
            bar_arrive(BAR_READY + s, THREADS);
        }
        return;
    }

    // Consumers: 2 warps along the rows x 4 groups of NT x 8 channels; mma
    // row m of the warp's half is the tile's row wm + row_of_slot(m). They
    // read the staged span, or the tile's span of part in place; there the
    // rows read stop at the tile's last (a staged tile's rows past it hold
    // values that are not stored).
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 16, wn = (warp >> 1) * NT * 8;
    const int rows[2] = {wm + row_of_slot(g), wm + row_of_slot(g + 8)};
    // The span's pairs (2 t, 2 t + 1) are 8-byte aligned.
    const bool vec = D % 2 == 0 && (pl.staged || (uintptr_t)part % 8 == 0);
    for (int k = 0; k < mine; ++k) {
        const int s = k % S;
        const TilePos tp(blockIdx.x + k * G, I, N);
        const float* ps = pl.staged ? tiles + (size_t)s * pl.tile_ld : part + tp.pos0 * LD;
        const int rd[2] = {pl.staged ? rows[0] : min(rows[0], tp.rows - 1),
                           pl.staged ? rows[1] : min(rows[1], tp.rows - 1)};
        const tc::Tile<T, true> tz{zst + (size_t)s * TJ * ldc, ldc};
        bar_sync(BAR_READY + s, THREADS);
        float rr[2], rmu[2];  // r and r * mu of this thread's rows
        for (int d0 = 0; d0 < D; d0 += DC) {
            if (!pl.resident) {
                if (k > 0 || d0 > 0) bar_sync(BAR_CONSUMERS, CONSUMERS);  // the previous chunk is consumed
                load_weights<T, FINISH>(p, d0, DC, D, 0, C, 0, Cp, 0, ldc, nullptr, wgs, us, vbs, bgs, warp,
                                        CONSUMERS / 32);
                bar_sync(BAR_CONSUMERS, CONSUMERS);
            }
            const int w0 = pl.resident ? d0 : 0;  // the chunk's first row of the staged weights
            const tc::Tile<T, true> twg{wgs + (size_t)w0 * ldc, ldc};
            float ag[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) ag[n][e] = 0.f;
#pragma unroll 2
            for (int k0 = 0; k0 < Cp; k0 += K) {
                typename M::A fa;
                typename M::B fb[NT];
                M::load_a(fa, tz, wm, k0, lane);
#pragma unroll
                for (int n = 0; n < NT; ++n) M::load_b(fb[n], twg, wn + n * 8, k0, lane);
                tc::mma_tiles<NT>(ag, fa, fb);
            }
            if (d0 == 0) {  // the span has landed: r and r * mu from its sums over all H channels
                tc::mbar_wait(&full[s], (k / S) & 1);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float* sp = ps + rd[h] * LD + D;
                    float s1, s2;
                    if (vec) {
                        const float2 v = *reinterpret_cast<const float2*>(sp);
                        s1 = v.x;
                        s2 = v.y;
                    } else {
                        s1 = sp[0];
                        s2 = sp[1];
                    }
                    const float mean = s1 / Hn;
                    rr[h] = rsqrtf(s2 / Hn - mean * mean + LN_EPS);
                    rmu[h] = rr[h] * mean;
                }
            }
            // The fold and the gate of all 4 NT values first, then the stores:
            // the 4 NT chains of sigmoids are independent, and no branch
            // stands between them. Values of rows past N or channels past D
            // are computed from what the tiles hold there and not stored.
            float o[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int dd = w0 + wn + n * 8 + 2 * t;  // row of the staged weights' vectors
                const int d = d0 + wn + n * 8 + 2 * t, col = d < D ? d : 0;  // a column of the span past D
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float* pp = ps + rd[h] * LD + col;  // x . ws summed over the ranks
                    float m0, m1;
                    if (vec) {
                        const float2 v = *reinterpret_cast<const float2*>(pp);
                        m0 = v.x;
                        m1 = v.y;
                    } else {
                        m0 = pp[0];
                        m1 = pp[1];
                    }
                    o[n][2 * h] = (rr[h] * m0 - rmu[h] * us[dd] + vbs[dd]) * fast_sigmoid(ag[n][2 * h] + bgs[dd]);
                    o[n][2 * h + 1] = (rr[h] * m1 - rmu[h] * us[dd + 1] + vbs[dd + 1]) *
                                      fast_sigmoid(ag[n][2 * h + 1] + bgs[dd + 1]);
                }
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int d = d0 + wn + n * 8 + 2 * t;  // channel in all D
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (d >= D || rows[h] >= tp.rows) continue;
                    T* po = out + (tp.pos0 + rows[h]) * D + d;
                    if (vec_out) {  // D even: the pair is whole and aligned
                        tc::store_pair(po, o[n][2 * h], o[n][2 * h + 1]);
                    } else {
                        po[0] = Cvt<T>::from_f(o[n][2 * h]);
                        if (d + 1 < D) po[1] = Cvt<T>::from_f(o[n][2 * h + 1]);
                    }
                }
            }
        }
        // The stage is free for the producers' tile k + S, if there is one.
        if (k + S < mine) bar_arrive(BAR_FREE + s, THREADS);
    }
}

// The shared-memory allowance and the blocks an SM holds of `kernel`, set
// and asked once per device and size: both are host calls the main path
// would otherwise pay at every launch. Returns the cudaError_t.
template <typename Kernel>
int blocks_for(Kernel kernel, int threads, size_t smem, size_t (&smem_set)[MAX_DEVICES], int (&blocks)[MAX_DEVICES],
               int& out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (smem_set[dev] != smem) {
        int per_sm = 0, sms = 0;
        if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
                cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)err;
        blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
        smem_set[dev] = smem;
    }
    out = blocks[dev];
    return 0;
}

// The grid: one block per tile up to the blocks the card holds at once.
int grid_of(long long tiles, int blocks) { return (int)(tiles < blocks ? tiles : blocks); }

template <typename T, int DC>
int launch_dc(const T* x, const T* z, const Params& p, T* out, int B, int I, int N, int C, int H, int D, bool vec_x,
              bool vec_z, bool vec_out, cudaStream_t stream) {
    static size_t smem_set[MAX_DEVICES];
    static int blocks[MAX_DEVICES];
    const size_t smem = Plan<T>(C, H, DC).smem();
    int nb = 0;
    if (int err = blocks_for(epilogue_kernel<T, DC>, THREADS, smem, smem_set, blocks, nb)) return err;
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    epilogue_kernel<T, DC><<<grid_of(tiles, nb), THREADS, smem, stream>>>(x, z, p, out, B, I, N, C, H, D, (int)vec_x,
                                                                          (int)vec_z, (int)vec_out);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* z, const Params& p, void* out, int B, int I, int N, int C, int H, int D,
           cudaStream_t stream) {
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
    const bool vec_out = D % 2 == 0 && (uintptr_t)out % 16 == 0;
    const T* px = static_cast<const T*>(x);
    const T* pz = static_cast<const T*>(z);
    T* po = static_cast<T*>(out);
    if (dc == 32) return launch_dc<T, 32>(px, pz, p, po, B, I, N, C, H, D, vec_x, vec_z, vec_out, stream);
    if (dc == 64) return launch_dc<T, 64>(px, pz, p, po, B, I, N, C, H, D, vec_x, vec_z, vec_out, stream);
    return launch_dc<T, 128>(px, pz, p, po, B, I, N, C, H, D, vec_x, vec_z, vec_out, stream);
}

// A split kernel's plan: the first that fits of, in this order, the weights
// of all D channels resident, then one chunk restaged per tile (which costs
// every tile all of W's rows); part's spans staged, then read or written in
// place; for the partial half an SM (two blocks on it), then a whole block;
// the chunk of 128, 64 or 32 channels from the narrowest that holds all D
// down; and the deepest ring. dc = 0 where nothing fits (never for C, H <=
// MAX_CHANNELS: in place, with one chunk of 32 rows, a plan holds the
// weights and two stages of x or z alone).
template <typename T, int MODE>
SplitPlan choose_plan(int K, int D, int& dc) {
    int widest = 32;
    while (widest < DC_MAX && widest < D) widest *= 2;
    for (const bool resident : {true, false})
        for (const bool staged : {true, false})
            for (const size_t limit : {MODE == PARTIAL ? SMEM_HALF : SMEM_LIMIT, SMEM_LIMIT})
                for (dc = widest; dc >= 32; dc /= 2)
                    for (int stages = MAX_STAGES; stages >= 2; --stages) {
                        const SplitPlan pl = split_plan<T, MODE>(K, D, dc, stages, resident, staged);
                        if (pl.smem <= limit) return pl;
                    }
    dc = 0;
    return SplitPlan{};
}

template <typename T, int DC>
int launch_partial_dc(const T* x, const Params& p, float* part, const SplitPlan& pl, int B, int I, int N, int H, int D,
                      bool vec_x, cudaStream_t stream) {
    static size_t smem_set[MAX_DEVICES];
    static int blocks[MAX_DEVICES];
    int nb = 0;
    if (int err = blocks_for(epilogue_partial_kernel<T, DC>, P_THREADS, pl.smem, smem_set, blocks, nb)) return err;
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    epilogue_partial_kernel<T, DC><<<grid_of(tiles, nb), P_THREADS, pl.smem, stream>>>(x, p, part, pl, B, I, N, H, D,
                                                                                       (int)vec_x);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_partial(const void* x, const Params& p, float* part, int B, int I, int N, int H, int D,
                   cudaStream_t stream) {
    int dc = 0;
    const SplitPlan pl = choose_plan<T, PARTIAL>(H, D, dc);
    if (dc == 0 || (long long)B * I * ((N + TJ - 1) / TJ) > INT_MAX) return (int)cudaErrorInvalidValue;
    const bool vec_x = (uintptr_t)x % 16 == 0 && (N * sizeof(T)) % 16 == 0;
    const T* px = static_cast<const T*>(x);
    if (dc == 32) return launch_partial_dc<T, 32>(px, p, part, pl, B, I, N, H, D, vec_x, stream);
    if (dc == 64) return launch_partial_dc<T, 64>(px, p, part, pl, B, I, N, H, D, vec_x, stream);
    return launch_partial_dc<T, 128>(px, p, part, pl, B, I, N, H, D, vec_x, stream);
}

template <typename T, int DC>
int launch_finish_dc(const float* part, const T* z, const Params& p, T* out, const SplitPlan& pl, int B, int I, int N,
                     int C, int Hn, int D, bool vec_z, bool vec_out, cudaStream_t stream) {
    static size_t smem_set[MAX_DEVICES];
    static int blocks[MAX_DEVICES];
    int nb = 0;
    if (int err = blocks_for(epilogue_finish_kernel<T, DC>, THREADS, pl.smem, smem_set, blocks, nb)) return err;
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    epilogue_finish_kernel<T, DC><<<grid_of(tiles, nb), THREADS, pl.smem, stream>>>(
        part, z, p, out, pl, B, I, N, C, Hn, D, (int)vec_z, (int)vec_out);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(const float* part, const void* z, const Params& p, void* out, int B, int I, int N, int C, int Hn,
                  int D, cudaStream_t stream) {
    int dc = 0;
    const SplitPlan pl = choose_plan<T, FINISH>(C, D, dc);
    if (dc == 0 || (long long)B * I * ((N + TJ - 1) / TJ) > INT_MAX) return (int)cudaErrorInvalidValue;
    const bool vec_z = (uintptr_t)z % 16 == 0 && (C * sizeof(T)) % 16 == 0;
    const bool vec_out = D % 2 == 0 && (uintptr_t)out % 16 == 0;
    const T* pz = static_cast<const T*>(z);
    T* po = static_cast<T*>(out);
    if (dc == 32) return launch_finish_dc<T, 32>(part, pz, p, po, pl, B, I, N, C, Hn, D, vec_z, vec_out, stream);
    if (dc == 64) return launch_finish_dc<T, 64>(part, pz, p, po, pl, B, I, N, C, Hn, D, vec_z, vec_out, stream);
    return launch_finish_dc<T, 128>(part, pz, p, po, pl, B, I, N, C, Hn, D, vec_z, vec_out, stream);
}

// ------------------------------------------------------------------ //
// The backward (float32)
// ------------------------------------------------------------------ //

namespace bwd {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MAX_OUT = 256;    // D at most: 8 blocks of 32 output channels, or 4 of 64
// The weight gradients' tensor-core accumulators take at most this many
// positions, then are added into the cluster's float32 partial sums by
// plain float adds: the tensor cores' accumulation is not rounded to
// nearest, and its error grows with the chain's length.
constexpr int FLUSH_POSITIONS = 512;

// One block's shared memory, in floats: its chunk of DC output channels of
// ws [DC][ldw] and W_g [DC][ldg], two stages of the x tile [Hp][ldx] (x^
// once normalised) and the z tile [TJ][ldz] (zn), dlin and dg [TJ][ldd]
// (first main and g), this block's shares of dx^ [TJ][ldsx] and dzn
// [TJ][ldsz], which the cluster reads, x^ of the block's rows [TJ][ldt]
// (then their dx), vb and b_g of the chunk, each stage's r of its x
// columns [2][TJ] and mean and rstd of its z rows [2][TJ][2], and the x
// columns' partial sums [2][THREADS].
struct Layout {
    int hp, cp, ldw, ldg, ldx, ldz, ldd, ldsx, ldsz, ldt;
    int wg, xs, zs, dl, dg, sx, sz, xt, vb, bg, rstat, zstat, red, total;

    __host__ __device__ Layout(int C, int H, int TJ, int DC) {
        hp = (H + 7) / 8 * 8;
        cp = (C + 7) / 8 * 8;
        ldw = hp + 4;                    // P1's ldmatrix rows and P2's pair loads (k rows 2t, 2t + 1) in distinct banks
        ldg = cp + 4;
        ldx = TJ + 8;                    // P1's A loads (k rows t) and P3's pair loads in distinct banks
        ldz = cp + 4;                    // P1's ldmatrix rows and P3's pair loads in distinct banks
        ldd = DC + 8;                    // P2's pair loads and P1's pair stores in distinct banks
        ldsx = (hp + 15) / 16 * 16 + 8;  // 8 mod 16: P2's pair stores in distinct banks
        ldsz = (cp + 15) / 16 * 16 + 8;
        ldt = hp + 1;                    // odd: rows and columns both in distinct banks
        int o = DC * ldw;
        wg = o, o += DC * ldg;
        xs = o, o += 2 * hp * ldx;
        zs = o, o += 2 * TJ * ldz;
        dl = o, o += TJ * ldd;
        dg = o, o += TJ * ldd;
        sx = o, o += TJ * ldsx;
        sz = o, o += TJ * ldsz;
        xt = o, o += (TJ * ldt + 3) / 4 * 4;
        vb = o, o += DC;
        bg = o, o += DC;
        rstat = o, o += 2 * TJ;
        zstat = o, o += 4 * TJ;
        red = o, o += 2 * THREADS;
        total = o;
    }
    __host__ __device__ size_t bytes() const { return (size_t)total * sizeof(float); }
};

// The scratch of one cluster: d ws [D][H], d W_g [D][C], d vb [D], d b_g
// [D]; after all clusters', LN_in's two sums [2][C] of each block.
__host__ __device__ inline long long part_stride(int C, int H, int D) {
    return (long long)D * H + (long long)D * C + 2LL * D;
}

// The block's rows of ws = W_z * scale_out and of W_g (zero past D, H and
// C, up to Hp and Cp), vb = W_z . bias_out + b_z and b_g; P: the
// parameters' type.
template <typename P>
__device__ void stage_rows(const Params& p, int d0, int DC, int D, int H, int C, int Hp, int Cp, int ldw, int ldg,
                           float* ws, float* wg, float* vbs, float* bgs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const P *w_z = static_cast<const P*>(p.w_z), *w_g = static_cast<const P*>(p.w_g);
    const P *lo_s = static_cast<const P*>(p.lo_s), *lo_b = static_cast<const P*>(p.lo_b);
    const P *b_z = static_cast<const P*>(p.b_z), *b_g = static_cast<const P*>(p.b_g);
    for (int d = warp; d < DC; d += WARPS) {
        const int ch = d0 + d;
        const bool ok = ch < D;
        float sv = 0.f;
        for (int k = lane; k < Hp; k += 32) {
            const bool in = ok && k < H;
            const float a = in ? Cvt<P>::to_f(w_z[(size_t)ch * H + k]) : 0.f;
            ws[d * ldw + k] = in ? a * Cvt<P>::to_f(lo_s[k]) : 0.f;
            sv += in ? a * Cvt<P>::to_f(lo_b[k]) : 0.f;
        }
        for (int k = lane; k < Cp; k += 32) wg[d * ldg + k] = ok && k < C ? Cvt<P>::to_f(w_g[(size_t)ch * C + k]) : 0.f;
        sv = warp_sum(sv);
        if (lane == 0) {
            vbs[d] = ok ? sv + Cvt<P>::to_f(b_z[ch]) : 0.f;
            bgs[d] = ok ? Cvt<P>::to_f(b_g[ch]) : 0.f;
        }
    }
}

// CMAX: H and C at most (128 or 256); TJ: positions a tile (32 or 16); DC:
// output channels a block (64 or 32).
template <int CMAX, int TJ, int DC>
__global__ void __launch_bounds__(THREADS, 1)
epilogue_backward_kernel(const float* __restrict__ x, const float* __restrict__ z, const Params p,
                         const float* __restrict__ dout, float* __restrict__ dx, float* __restrict__ dz,
                         float* __restrict__ part, int B, int I, int N, int C, int H, int D, int want_dw, int vec_x,
                         int vec_z) {
    using M = tc::Mma<float>;
    constexpr int MT = TJ / 16;         // m16 tiles of a tile's positions
    constexpr int MD = DC / 16;         // m16 tiles of the block's channels (P3)
    constexpr int NP1 = DC * MT / 32;   // P1: n8 tiles of a warp
    constexpr int NP = CMAX / 32;       // P2, P3: n8 tiles of a warp, a quarter of CMAX
    constexpr int CQ = CMAX / 32;       // channels a lane in the row work
    constexpr int EJ = THREADS / DC;    // the elementwise pass: threads a channel
    constexpr int OJ = TJ / EJ;         // ... and rows a thread
    constexpr int TPC = THREADS / TJ;   // threads a column in LN_out's statistics
    constexpr int XQ = CMAX / TPC;      // ... and values a thread
    constexpr int MAXR = MAX_OUT / DC;  // blocks a cluster, at most
    constexpr int RPW = TJ / WARPS;     // z rows a warp normalises at once; the finishing's rows a warp, at most
    constexpr int FLUSH = FLUSH_POSITIONS / TJ;
    static_assert(NP1 >= 1 && (DC / 8) % NP1 == 0 && (2 * DC / 8 / NP1) * MT == WARPS && OJ >= 1 && RPW >= 1,
                  "tiling");
    const Layout L(C, H, TJ, DC);
    const int Hp = L.hp, Cp = L.cp, ldw = L.ldw, ldg = L.ldg, ldx = L.ldx, ldz = L.ldz, ldd = L.ldd,
              ldsx = L.ldsx, ldsz = L.ldsz, ldt = L.ldt;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* const sm = reinterpret_cast<float*>(smem_raw);
    float* const ws = sm;
    float* const wg = sm + L.wg;
    float* const xbuf = sm + L.xs;
    float* const zbuf = sm + L.zs;
    float* const dlt = sm + L.dl;  // main, then dlin
    float* const dgt = sm + L.dg;  // g, then dg
    float* const sx = sm + L.sx;
    float* const sz = sm + L.sz;
    float* const xt = sm + L.xt;
    float* const vbs = sm + L.vb;
    float* const bgs = sm + L.bg;
    float* const rstat = sm + L.rstat;
    float* const zstat = sm + L.zstat;
    float* const red = sm + L.red;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
    const int q = tc::cluster_rank(), nch = tc::cluster_blocks(), cid = tc::cluster_index(), G = tc::cluster_count();
    const int d0 = q * DC;
    const int JT = (N + TJ - 1) / TJ, tiles = B * I * JT;
    const int mine = cid < tiles ? (tiles - cid + G - 1) / G : 0;  // this cluster's tiles: cid + k G
    // This block's rows of a tile in the LayerNorms' backward.
    const int RB = (TJ + nch - 1) / nch, r_lo = min(q * RB, TJ), r_hi = min(r_lo + RB, TJ);
    const size_t plane = (size_t)I * N;
    const bool zside = warp >= 4;         // P2, P3: warps 0-3 the x side (H), 4-7 the z side (C)
    const int n0w = 8 * NP * (warp & 3);  // P2, P3: this warp's first column
    const int Kw = zside ? Cp : Hp;       // ... and the side's width

    if (p.bf16 != 0)
        stage_rows<__nv_bfloat16>(p, d0, DC, D, H, C, Hp, Cp, ldw, ldg, ws, wg, vbs, bgs);
    else
        stage_rows<float>(p, d0, DC, D, H, C, Hp, Cp, ldw, ldg, ws, wg, vbs, bgs);

    float lns[CQ], lnb[CQ], dls[CQ], dlb[CQ];
#pragma unroll
    for (int qq = 0; qq < CQ; ++qq) {
        const int c = lane + 32 * qq;
        lns[qq] = c < C ? p.at(p.ln_s, c) : 0.f;
        lnb[qq] = c < C ? p.at(p.ln_b, c) : 0.f;
        dls[qq] = dlb[qq] = 0.f;
    }
    // d ws (x side) or d W_g (z side) of this warp: the chunk's rows 0..DC -
    // 1, columns n0w + 0 .. 8 NP - 1.
    float dw[MD][NP][4];
#pragma unroll
    for (int m = 0; m < MD; ++m)
#pragma unroll
        for (int n = 0; n < NP; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw[m][n][e] = 0.f;
    float sum_vb = 0.f, sum_bg = 0.f;  // d vb and d b_g of channel ed, over this thread's rows
    float* const pc = want_dw ? part + (size_t)cid * part_stride(C, H, D) : nullptr;  // the cluster's partial sums
    int held = 0;         // tiles in dw since it was last added to pc
    bool stored = false;  // pc holds this thread's entries of dw

    // dw added into pc (stored the first time), then zeroed; each entry has
    // one owner thread, which adds its flushes in order. An m16 tile's old
    // sums are all loaded before any is stored: one round trip, not one a
    // value.
    auto flush_dw = [&]() {
        const int W = zside ? C : H;
        float* const base = pc + (zside ? (size_t)D * H : 0);
#pragma unroll
        for (int m = 0; m < MD; ++m) {
            float old[2][NP][2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int d = d0 + 16 * m + 8 * half + g;
#pragma unroll
                for (int n = 0; n < NP; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int c = n0w + 8 * n + 2 * t + e;
                        old[half][n][e] = stored && d < D && c < W ? base[(size_t)d * W + c] : 0.f;
                    }
            }
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int d = d0 + 16 * m + 8 * half + g;
#pragma unroll
                for (int n = 0; n < NP; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int c = n0w + 8 * n + 2 * t + e;
                        if (d < D && c < W) base[(size_t)d * W + c] = old[half][n][e] + dw[m][n][2 * half + e];
                        dw[m][n][2 * half + e] = 0.f;
                    }
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
    // Tile k's x columns and z rows into stage s: 16-byte cp.async copies
    // (zero past H and N) where aligned, else element by element.
    auto stage = [&](int k, int s) {
        int bb, i, j0;
        coords(k, bb, i, j0);
        float* const xs = xbuf + s * Hp * ldx;
        float* const zs = zbuf + s * TJ * ldz;
        const float* xtile = x + (size_t)bb * H * plane + (size_t)i * N + j0;
        if (vec_x) {
            constexpr int V = TJ / 4;
            for (int idx = threadIdx.x; idx < Hp * V; idx += THREADS) {
                const int h = idx / V, c = (idx - h * V) * 4;
                const bool ok = h < H && j0 + c < N;
                tc::cp_async16(xs + h * ldx + c, ok ? xtile + h * plane + c : x, ok ? 16 : 0);
            }
        } else {
            for (int idx = threadIdx.x; idx < Hp * TJ; idx += THREADS) {
                const int h = idx / TJ, c = idx - h * TJ;
                xs[h * ldx + c] = h < H && j0 + c < N ? xtile[h * plane + c] : 0.f;
            }
        }
        const float* ztile = z + (((size_t)bb * I + i) * N + j0) * C;
        for (int r = warp; r < TJ; r += WARPS) {
            const bool ok = j0 + r < N;
            if (vec_z) {
                for (int c = 4 * lane; c < C; c += 128)
                    tc::cp_async16(zs + r * ldz + c, ok ? ztile + (size_t)r * C + c : z, ok ? 16 : 0);
            } else {
                for (int c = lane; c < C; c += 32) zs[r * ldz + c] = ok ? ztile[(size_t)r * C + c] : 0.f;
            }
        }
        tc::cp_async_commit();
    };
    // Once stage s has landed: LN_in of its z rows in place (each row's
    // mean and rstd kept), and x^ of its x columns in place (each column's r
    // kept), the statistics as the forward takes them.
    auto normalise = [&](int s) {
        tc::cp_async_wait<0>();
        __syncthreads();
        float* const xs = xbuf + s * Hp * ldx;
        float* const zs = zbuf + s * TJ * ldz;
        {
            const int r0 = warp * RPW;
            float v[RPW][CQ], mu[RPW], rstd[RPW];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                float sum = 0.f;
#pragma unroll
                for (int qq = 0; qq < CQ; ++qq) {
                    const int c = lane + 32 * qq;
                    v[r][qq] = c < C ? zs[(r0 + r) * ldz + c] : 0.f;
                    sum += v[r][qq];
                }
                mu[r] = warp_sum(sum) / C;
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                float s2 = 0.f;
#pragma unroll
                for (int qq = 0; qq < CQ; ++qq) {
                    const float dv = lane + 32 * qq < C ? v[r][qq] - mu[r] : 0.f;
                    s2 += dv * dv;
                }
                rstd[r] = rsqrtf(warp_sum(s2) / C + LN_EPS);
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
#pragma unroll
                for (int qq = 0; qq < CQ; ++qq) {
                    const int c = lane + 32 * qq;
                    if (c < Cp) zs[(r0 + r) * ldz + c] = (v[r][qq] - mu[r]) * rstd[r] * lns[qq] + lnb[qq];
                }
                if (lane == 0) {
                    zstat[(s * TJ + r0 + r) * 2] = mu[r];
                    zstat[(s * TJ + r0 + r) * 2 + 1] = rstd[r];
                }
            }
        }
        {
            const int j = threadIdx.x % TJ, pt = threadIdx.x / TJ;
            float v[XQ], s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int u = 0; u < XQ; ++u) {
                const int h = pt + TPC * u;
                v[u] = h < H ? xs[h * ldx + j] : 0.f;
                s1 += v[u];
                s2 += v[u] * v[u];
            }
            red[pt * TJ + j] = s1;
            red[THREADS + pt * TJ + j] = s2;
            __syncthreads();
            s1 = s2 = 0.f;
#pragma unroll
            for (int w = 0; w < TPC; ++w) {
                s1 += red[w * TJ + j];
                s2 += red[THREADS + w * TJ + j];
            }
            const float mean = s1 / H, r = rsqrtf(s2 / H - mean * mean + LN_EPS);
#pragma unroll
            for (int u = 0; u < XQ; ++u) {
                const int h = pt + TPC * u;
                if (h < H) xs[h * ldx + j] = (v[u] - mean) * r;
            }
            if (pt == 0) rstat[s * TJ + j] = r;
        }
    };

    int buf = 0;
    if (mine > 0) {
        stage(0, 0);
        normalise(0);
    }
    bool pending = false;  // this thread's arrival on the cluster barrier awaits its wait
    const int ed = threadIdx.x % DC, ej = threadIdx.x / DC;  // the elementwise pass: channel, first row
    for (int k = 0; k < mine; ++k) {
        int bb, i, j0;
        coords(k, bb, i, j0);
        const int rows = min(TJ, N - j0);
        const int r_end = min(r_hi, rows);
        const size_t pos0 = ((size_t)bb * I + i) * N + j0;
        float* const xs = xbuf + buf * Hp * ldx;
        float* const zs = zbuf + buf * TJ * ldz;
        // The cotangents of the elementwise pass, in flight during P1.
        float ov[OJ];
#pragma unroll
        for (int u = 0; u < OJ; ++u) {
            const int j = ej + EJ * u;
            ov[u] = j < rows && d0 + ed < D ? dout[(pos0 + j) * D + d0 + ed] : 0.f;
        }
        __syncthreads();  // the tile is normalised; the last tile's dlin, dg and dx are read

        // P1: main = x^ . ws^T and g = zn . W_g^T of the chunk, into dlt and
        // dgt: warp w takes m16 tile w % MT and NP1 n8 tiles of the 2 DC
        // channels (main's, then g's).
        {
            const int m0 = 16 * (warp % MT), nb = (warp / MT) * NP1;
            const bool gate = nb >= DC / 8;
            float acc[NP1][4];
#pragma unroll
            for (int n = 0; n < NP1; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
            if (!gate) {
                const tc::Tile<float, false> ta{xs, ldx};
                const tc::Tile<float, true> tb{ws, ldw};
#pragma unroll 4
                for (int k0 = 0; k0 < Hp; k0 += 8) {
                    M::A fa;
                    M::load_a(fa, ta, m0, k0, lane);
                    M::B fb[NP1];
#pragma unroll
                    for (int n = 0; n < NP1; ++n) M::load_b(fb[n], tb, 8 * (nb + n), k0, lane);
                    tc::mma_tiles(acc, fa, fb);
                }
            } else {
                const tc::Tile<float, true> ta{zs, ldz}, tb{wg, ldg};
#pragma unroll 4
                for (int k0 = 0; k0 < Cp; k0 += 8) {
                    M::A fa;
                    M::load_a(fa, ta, m0, k0, lane);
                    M::B fb[NP1];
#pragma unroll
                    for (int n = 0; n < NP1; ++n) M::load_b(fb[n], tb, 8 * (nb - DC / 8 + n), k0, lane);
                    tc::mma_tiles(acc, fa, fb);
                }
            }
            float* const out = gate ? dgt : dlt;
#pragma unroll
            for (int n = 0; n < NP1; ++n) {
                const int col = 8 * (nb % (DC / 8) + n) + 2 * t;
                tc::store_pair(out + (m0 + g) * ldd + col, acc[n][0], acc[n][1]);
                tc::store_pair(out + (m0 + g + 8) * ldd + col, acc[n][2], acc[n][3]);
            }
        }
        // The next tile into the other stage, behind this one's work.
        if (k + 1 < mine) stage(k + 1, buf ^ 1);
        __syncthreads();  // dlt, dgt hold main and g

        // dlin = dout sigmoid(g), dg = dout lin sigmoid'(g), lin = main + vb.
        {
            const float vb = vbs[ed], bg = bgs[ed];
#pragma unroll
            for (int u = 0; u < OJ; ++u) {
                const int j = ej + EJ * u;
                const float lin = dlt[j * ldd + ed] + vb, s = fast_sigmoid(dgt[j * ldd + ed] + bg);
                const float a = ov[u] * s, b = ov[u] * lin * (s * (1.f - s));
                dlt[j * ldd + ed] = a;
                dgt[j * ldd + ed] = b;
                sum_vb += a;
                sum_bg += b;
            }
        }
        __syncthreads();  // dlt, dgt hold dlin and dg

        // P3: d ws += dlin^T . x^ and d W_g += dg^T . zn over the tile's
        // positions. Positions 2t and 2t + 1 of each 8 stand for k = t and
        // t + 4 in both operands.
        const float* const A = zside ? dgt : dlt;
        if (want_dw) {
            if (n0w < Kw) {
#pragma unroll 2
                for (int k0 = 0; k0 < TJ; k0 += 8) {
                    M::B fb[NP];
#pragma unroll
                    for (int n = 0; n < NP; ++n) {
                        const int c = n0w + 8 * n;
                        float b0 = 0.f, b1 = 0.f;
                        if (!zside && c < Hp) {
                            const float2 v = *reinterpret_cast<const float2*>(xs + (c + g) * ldx + k0 + 2 * t);
                            b0 = v.x;
                            b1 = v.y;
                        } else if (zside && c < Cp) {
                            b0 = zs[(k0 + 2 * t) * ldz + c + g];
                            b1 = zs[(k0 + 2 * t + 1) * ldz + c + g];
                        }
                        tc::split_tf32(__float_as_uint(b0), fb[n].hi[0], fb[n].lo[0]);
                        tc::split_tf32(__float_as_uint(b1), fb[n].hi[1], fb[n].lo[1]);
                    }
                    const float* pa = A + (k0 + 2 * t) * ldd + g;
#pragma unroll
                    for (int m = 0; m < MD; ++m) {
                        M::A fa;
                        tc::split_tf32(__float_as_uint(pa[16 * m]), fa.hi[0], fa.lo[0]);
                        tc::split_tf32(__float_as_uint(pa[16 * m + 8]), fa.hi[1], fa.lo[1]);
                        tc::split_tf32(__float_as_uint(pa[ldd + 16 * m]), fa.hi[2], fa.lo[2]);
                        tc::split_tf32(__float_as_uint(pa[ldd + 16 * m + 8]), fa.hi[3], fa.lo[3]);
                        tc::mma_tiles(dw[m], fa, fb);
                    }
                }
            }
            if (++held == FLUSH) flush_dw();
        }

        // P2: this block's shares of dx^ = dlin . ws and dzn = dg . W_g (K =
        // its DC channels). Channels 2t and 2t + 1 of each 8 stand for k = t
        // and t + 4 in both operands.
        float acc2[MT][NP][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NP; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc2[m][n][e] = 0.f;
        if (n0w < Kw) {
            const float* const W = zside ? wg : ws;
            const int ldW = zside ? ldg : ldw;
#pragma unroll 4
            for (int k0 = 0; k0 < DC; k0 += 8) {
                M::B fb[NP];
#pragma unroll
                for (int n = 0; n < NP; ++n) {
                    const int c = n0w + 8 * n;
                    const bool in = c < Kw;
                    tc::split_tf32(in ? __float_as_uint(W[(k0 + 2 * t) * ldW + c + g]) : 0u, fb[n].hi[0], fb[n].lo[0]);
                    tc::split_tf32(in ? __float_as_uint(W[(k0 + 2 * t + 1) * ldW + c + g]) : 0u, fb[n].hi[1],
                                   fb[n].lo[1]);
                }
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    M::A fa;
                    const float2 r0 = *reinterpret_cast<const float2*>(A + (16 * m + g) * ldd + k0 + 2 * t);
                    const float2 r1 = *reinterpret_cast<const float2*>(A + (16 * m + g + 8) * ldd + k0 + 2 * t);
                    tc::split_tf32(__float_as_uint(r0.x), fa.hi[0], fa.lo[0]);
                    tc::split_tf32(__float_as_uint(r1.x), fa.hi[1], fa.lo[1]);
                    tc::split_tf32(__float_as_uint(r0.y), fa.hi[2], fa.lo[2]);
                    tc::split_tf32(__float_as_uint(r1.y), fa.hi[3], fa.lo[3]);
                    tc::mma_tiles(acc2[m], fa, fb);
                }
            }
        }
        // The shares into sx, sz, once the cluster has read the last tile's.
        if (pending) tc::cluster_wait();
        pending = false;
        if (n0w < Kw) {
            float* const S = zside ? sz : sx;
            const int ldS = zside ? ldsz : ldsx;
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int n = 0; n < NP; ++n) {
                    if (n0w + 8 * n >= Kw) continue;
                    const int c = n0w + 8 * n + 2 * t;
                    tc::store_pair(S + (16 * m + g) * ldS + c, acc2[m][n][0], acc2[m][n][1]);
                    tc::store_pair(S + (16 * m + g + 8) * ldS + c, acc2[m][n][2], acc2[m][n][3]);
                }
        }
        tc::cluster_arrive();
        // While the cluster's shares are awaited: x^ of this block's rows
        // into xt, row by row (from the tile's columns), the z of this
        // warp's rows into registers, and the next tile normalised.
        if (lane < r_end - r_lo)
            for (int h = warp; h < Hp; h += WARPS) xt[lane * ldt + h] = xs[h * ldx + r_lo + lane];
        float zv[RPW][CQ];
#pragma unroll
        for (int u = 0; u < RPW; ++u) {
            const int r = r_lo + warp + WARPS * u;
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) {
                const int c = lane + 32 * qq;
                zv[u][qq] = r < r_end && c < C ? z[(pos0 + r) * C + c] : 0.f;
            }
        }
        if (k + 1 < mine) normalise(buf ^ 1);
        __syncthreads();  // xt holds x^ of the block's rows
        tc::cluster_wait();  // every block's shares of the tile are in place

        // This block's rows, warp w rows r_lo + w + 8 u: the shares summed
        // over the cluster in rank order, then LN_out's backward (dx into
        // xt, over x^) and LN_in's backward (dz, x^ of z from z, mean and
        // rstd as found). The cluster's loads of all of a warp's rows first.
        float sxv[RPW][CQ], szv[RPW][CQ];
#pragma unroll
        for (int u = 0; u < RPW; ++u)
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) sxv[u][qq] = szv[u][qq] = 0.f;
#pragma unroll
        for (int pr = 0; pr < MAXR; ++pr) {
            if (pr >= nch) break;
#pragma unroll
            for (int u = 0; u < RPW; ++u) {
                const int r = r_lo + warp + WARPS * u;
                if (r >= r_end) continue;
                const unsigned bx = tc::remote(sx + r * ldsx, pr), bz = tc::remote(sz + r * ldsz, pr);
#pragma unroll
                for (int qq = 0; qq < CQ; ++qq) {
                    const int c = lane + 32 * qq;
                    if (c < H) sxv[u][qq] += tc::ld_remote(bx + 4u * c);
                    if (c < C) szv[u][qq] += tc::ld_remote(bz + 4u * c);
                }
            }
        }
#pragma unroll
        for (int u = 0; u < RPW; ++u) {
            const int r = r_lo + warp + WARPS * u;
            if (r >= r_end) continue;
            float* const xr = xt + (r - r_lo) * ldt;
            float hv[CQ], s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) {
                const int h = lane + 32 * qq;
                hv[qq] = h < H ? xr[h] : 0.f;
                s1 += sxv[u][qq];
                s2 += sxv[u][qq] * hv[qq];
            }
            s1 = warp_sum(s1) / H;
            s2 = warp_sum(s2) / H;
            const float rr = rstat[buf * TJ + r];
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) {
                const int h = lane + 32 * qq;
                if (h < H) xr[h] = rr * (sxv[u][qq] - s1 - hv[qq] * s2);
            }

            const float mu = zstat[(buf * TJ + r) * 2], rstd = zstat[(buf * TJ + r) * 2 + 1];
            float gg[CQ];
            s1 = s2 = 0.f;
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) {
                const int c = lane + 32 * qq;
                hv[qq] = c < C ? (zv[u][qq] - mu) * rstd : 0.f;
                gg[qq] = szv[u][qq] * lns[qq];
                s1 += gg[qq];
                s2 += gg[qq] * hv[qq];
            }
            s1 = warp_sum(s1) / C;
            s2 = warp_sum(s2) / C;
            float* const dzr = dz + (pos0 + r) * C;
#pragma unroll
            for (int qq = 0; qq < CQ; ++qq) {
                const int c = lane + 32 * qq;
                if (c < C) {
                    dzr[c] = rstd * (gg[qq] - s1 - hv[qq] * s2);
                    dls[qq] += szv[u][qq] * hv[qq];
                    dlb[qq] += szv[u][qq];
                }
            }
        }
        tc::cluster_arrive();  // done reading the cluster's shares: waited on before they are written again
        pending = true;
        __syncthreads();  // xt holds dx of the block's rows
        if (lane < r_end - r_lo) {
            float* const out = dx + (size_t)bb * H * plane + (size_t)i * N + j0 + r_lo + lane;
            for (int h = warp; h < H; h += WARPS) out[h * plane] = xt[lane * ldt + h];
        }
        buf ^= 1;
    }
    if (pending) tc::cluster_wait();  // no block leaves while another reads its shared memory
    if (!want_dw) return;

    if (held > 0 || !stored) flush_dw();
    // The bias sums (thread (ed, ej) holds channel ed over rows ej mod EJ)
    // and LN_in's sums of the warps in shared memory (the tiles are done
    // with), then the block's in order.
    __syncthreads();
    float* const fin = xbuf;  // [2][THREADS], then [WARPS][2][Cp]
    fin[threadIdx.x] = sum_vb;
    fin[THREADS + threadIdx.x] = sum_bg;
    float* const lnred = fin + 2 * THREADS;
#pragma unroll
    for (int qq = 0; qq < CQ; ++qq) {
        const int c = lane + 32 * qq;
        if (c < C) {
            lnred[(2 * warp) * Cp + c] = dls[qq];
            lnred[(2 * warp + 1) * Cp + c] = dlb[qq];
        }
    }
    __syncthreads();
    if (threadIdx.x < 2 * DC) {
        const int half = threadIdx.x / DC, d = threadIdx.x - half * DC;
        float s = 0.f;
        for (int e = 0; e < EJ; ++e) s += fin[half * THREADS + DC * e + d];
        if (d0 + d < D) pc[(size_t)D * H + (size_t)D * C + (size_t)half * D + d0 + d] = s;
    }
    float* const pl = part + (size_t)G * part_stride(C, H, D) + ((size_t)cid * nch + q) * 2 * C;
    for (int e = threadIdx.x; e < 2 * C; e += THREADS) {
        const int half = e / C, c = e - half * C;
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += lnred[(2 * w + half) * Cp + c];
        pl[e] = s;
    }
}

// out[e] = the clusters' (then, for LN_in's sums, the blocks') partial sums
// of element e, in order.
__global__ void epilogue_backward_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int clusters,
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
template <int CMAX, int TJ, int DC>
int clusters(int C, int H, int nch, long long tiles, int& G) {
    static size_t asked[MAX_DEVICES][MAX_CLUSTER + 1];
    static int active[MAX_DEVICES][MAX_CLUSTER + 1];
    static bool allowed[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    auto kernel = epilogue_backward_kernel<CMAX, TJ, DC>;
    const size_t smem = Layout(C, H, TJ, DC).bytes();
    if (smem > SMEM_LIMIT || nch > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
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

template <int CMAX, int TJ, int DC>
int launch(const float* x, const float* z, const Params& p, const float* dout, float* dx, float* dz, float* part,
           float* sums, int B, int I, int N, int C, int H, int D, cudaStream_t stream) {
    const int nch = (D + DC - 1) / DC;
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    int G = 0, err = clusters<CMAX, TJ, DC>(C, H, nch, tiles, G);
    if (err) return err;
    const bool want = part != nullptr && sums != nullptr;
    const int vec_x = (uintptr_t)x % 16 == 0 && N % 4 == 0;
    const int vec_z = (uintptr_t)z % 16 == 0 && C % 4 == 0;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nch;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)(G * nch));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Layout(C, H, TJ, DC).bytes();
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, epilogue_backward_kernel<CMAX, TJ, DC>, x, z, p, dout, dx, dz, part, B, I,
                                       N, C, H, D, (int)want, vec_x, vec_z);
    if (e != cudaSuccess || !want) return (int)e;
    const long long stride = part_stride(C, H, D), total = stride + 2LL * C;
    epilogue_backward_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, sums, G, G * nch, stride,
                                                                                       2 * C);
    return (int)cudaGetLastError();
}

template <int CMAX, int TJ, int DC>
int scratch(long long* floats, int B, int I, int N, int C, int H, int D) {
    const int nch = (D + DC - 1) / DC;
    const long long tiles = (long long)B * I * ((N + TJ - 1) / TJ);
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    int G = 0, err = clusters<CMAX, TJ, DC>(C, H, nch, tiles, G);
    if (err) return err;
    *floats = (long long)G * part_stride(C, H, D) + (long long)G * nch * 2 * C;
    return 0;
}

}  // namespace bwd

}  // namespace

// x [B,H,I,N], z [B,I,N,C] and out [B,I,N,D] of dtype 0 = float32 or 1 =
// bfloat16; the eight parameters (see Params) of param_dtype 0 = float32 or
// 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int trimul_epilogue(const void* x, const void* z, const void* ln_in_scale, const void* ln_in_bias,
                               const void* w_z, const void* ln_out_scale, const void* ln_out_bias,
                               const void* b_z, const void* w_g, const void* b_g, void* out, int B, int I,
                               int N, int C, int H, int D, int dtype, int param_dtype, void* stream) {
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || H > MAX_CHANNELS || D < 1 ||
        (param_dtype != 0 && param_dtype != 1))
        return (int)cudaErrorInvalidValue;
    const Params p{ln_in_scale, ln_in_bias, w_z, ln_out_scale, ln_out_bias, b_z, w_g, b_g, nullptr, nullptr, nullptr,
                   param_dtype};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(x, z, p, out, B, I, N, C, H, D, s);
    if (dtype == 1) return launch<__nv_bfloat16>(x, z, p, out, B, I, N, C, H, D, s);
    return (int)cudaErrorInvalidValue;
}

// The partial kernel: x [B,H,I,N] (this rank's H channels, dtype as above),
// W_z [D, H] (its columns) and the LN_out scale and bias [H] (its channels),
// of param_dtype as above -> part, float32: [B,I,N,D+2] then [2, D].
extern "C" int trimul_epilogue_partial(const void* x, const void* w_z, const void* ln_out_scale,
                                       const void* ln_out_bias, void* part, int B, int I, int N, int H, int D,
                                       int dtype, int param_dtype, void* stream) {
    if (B < 1 || I < 1 || N < 1 || H < 1 || H > MAX_CHANNELS || D < 1 || (param_dtype != 0 && param_dtype != 1))
        return (int)cudaErrorInvalidValue;
    float* pp = static_cast<float*>(part);
    const Params p{nullptr, nullptr, w_z, ln_out_scale, ln_out_bias, nullptr, nullptr, nullptr, nullptr, nullptr,
                   pp + (size_t)B * I * N * (D + 2), param_dtype};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_partial<float>(x, p, pp, B, I, N, H, D, s);
    if (dtype == 1) return launch_partial<__nv_bfloat16>(x, p, pp, B, I, N, H, D, s);
    return (int)cudaErrorInvalidValue;
}

// The finish kernel: part [B,I,N,D+2] float32 summed over the ranks, z
// [B,I,N,C] and out [B,I,N,D] of dtype as above; H the channel count of all
// ranks; u and vb [D] (sum_h ws and W_z . bias_out over all H, the tail of
// part), float32; LN_in scale and bias [C], b_z [D], W_g [D, C] and b_g
// [D] of param_dtype as above.
extern "C" int trimul_epilogue_finish(const void* part, const void* z, const void* ln_in_scale,
                                      const void* ln_in_bias, const void* u, const void* vb, const void* b_z,
                                      const void* w_g, const void* b_g, void* out, int B, int I, int N, int C, int H,
                                      int D, int dtype, int param_dtype, void* stream) {
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || D < 1 ||
        (param_dtype != 0 && param_dtype != 1))
        return (int)cudaErrorInvalidValue;
    const Params p{ln_in_scale, ln_in_bias, nullptr, nullptr, nullptr, b_z, w_g, b_g,
                   static_cast<const float*>(u), static_cast<const float*>(vb), nullptr, param_dtype};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* pp = static_cast<const float*>(part);
    if (dtype == 0) return launch_finish<float>(pp, z, p, out, B, I, N, C, H, D, s);
    if (dtype == 1) return launch_finish<__nv_bfloat16>(pp, z, p, out, B, I, N, C, H, D, s);
    return (int)cudaErrorInvalidValue;
}

// The float32 scratch of trimul_epilogue_backward for these shapes, in
// floats, into *floats. Returns the cudaError_t (0 on success).
extern "C" int trimul_epilogue_backward_scratch(long long* floats, int B, int I, int N, int C, int H, int D,
                                                void* stream) {
    (void)stream;
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || H > MAX_CHANNELS || D < 1 ||
        D > bwd::MAX_OUT)
        return (int)cudaErrorInvalidValue;
    return C <= 128 && H <= 128 ? bwd::scratch<128, 32, 64>(floats, B, I, N, C, H, D)
                                : bwd::scratch<256, 16, 32>(floats, B, I, N, C, H, D);
}

// The gradients of trimul_epilogue, float32 activations (dtype 0): x
// [B,H,I,N], z [B,I,N,C] and the eight parameters as trimul_epilogue takes
// them, the cotangent dout [B,I,N,D] -> dx [B,H,I,N] and dz [B,I,N,C];
// and, where part (the scratch above) and sums are given, sums [D H + D C +
// 2 D + 2 C] float32: the gradients of ws = W_z * scale_out [D,H], of W_g
// [D,C], of vb = W_z . bias_out + b_z [D] and of b_g [D], then LN_in's scale
// and bias [C] each. Returns the cudaError_t of the launches (0 on success).
extern "C" int trimul_epilogue_backward(const void* x, const void* z, const void* ln_in_scale, const void* ln_in_bias,
                                        const void* w_z, const void* ln_out_scale, const void* ln_out_bias,
                                        const void* b_z, const void* w_g, const void* b_g, const void* dout, void* dx,
                                        void* dz, void* part, void* sums, int B, int I, int N, int C, int H, int D,
                                        int dtype, int param_dtype, void* stream) {
    if (B < 1 || I < 1 || N < 1 || C < 1 || C > MAX_CHANNELS || H < 1 || H > MAX_CHANNELS || D < 1 ||
        D > bwd::MAX_OUT || dtype != 0 || (param_dtype != 0 && param_dtype != 1))
        return (int)cudaErrorInvalidValue;
    const Params p{ln_in_scale, ln_in_bias, w_z, ln_out_scale, ln_out_bias, b_z, w_g, b_g, nullptr, nullptr, nullptr,
                   param_dtype};
    const float *px = static_cast<const float*>(x), *pz = static_cast<const float*>(z),
                *po = static_cast<const float*>(dout);
    float *pdx = static_cast<float*>(dx), *pdz = static_cast<float*>(dz), *pp = static_cast<float*>(part),
          *ps = static_cast<float*>(sums);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return C <= 128 && H <= 128 ? bwd::launch<128, 32, 64>(px, pz, p, po, pdx, pdz, pp, ps, B, I, N, C, H, D, s)
                                : bwd::launch<256, 16, 32>(px, pz, p, po, pdx, pdz, pp, ps, B, I, N, C, H, D, s);
}

// tri_att_flash: the attention core of triangle attention (AF2 Algorithms
// 13/14) with an online softmax, so the [B, I, H, J, J] logits are never
// written, on the tensor cores. Per sample b, triangle row i, head h and
// query position j:
//
//   s[k]   = (q[b,i,j,h,:] . k[b,i,k,h,:]) / sqrt(c) + tb[b,h,j,k]
//            + inf (mask[b,i,k] - 1)
//   o[b,i,j,h,:] = sum_k softmax_k(s)[k] v[b,i,k,h,:]
//
// with JQ query positions j and JK keys k a row: JQ = JK = J, but for the
// ending node under sequence parallelism, whose queries are this rank's
// JQ = J / n_seq residues against all JK = J keys.
//
// Replaces genie2_tpu/ops/tri_att_flash.py:126 flash_tri_attention (Pallas
// body _flash_kernel, :75). What is kept: float32 logits, softmax statistics
// and accumulator whatever the activation type, the running max starting
// at -1e30, the denominator clamped at 1e-20, p kept in float32 for p.v in
// float32. What is not carried over: the sequential 4-d grid with scratch
// between grid steps, the head-major transposes around the call, the
// divisibility asserts and one sample per call; in bf16 p goes to the
// tensor cores rounded to bf16 (one term: tests/test_torch_tri_att.py
// emulates it within 1e-3 of max |o| at J=256, the bf16 tolerance is 3e-2).
//
// Work at the full-width shapes (B=2, I=J=256, H=4, c=32): 4 B I J^2 H c =
// 17.2 GFLOP; q, k, v, o are 268 MB in float32, tb 2 MB, the mask 0.5 MB.
// On the H100 the float32 version is bound by operations: 17.2 GFLOP as
// three TF32 products at 495 TFLOP/s is 0.104 ms against 0.081 ms for the
// bytes at 3.35 TB/s; bf16 (one product at 989 TFLOP/s) is bound by its
// 134 MB of bytes, 0.040 ms.
//
// Design: persistent blocks of 4 warps walk units of one (b, i, h) and 64
// queries, 16 rows a warp, in key tiles of 64 (two blocks an SM in
// float32, four in bf16); a block takes a contiguous
// run of units ordered with i fastest, so the blocks at work together share
// their bias tiles and k / v rows in L2. Each step (unit, key tile) moves
// the k and v tiles ([64 keys][c], a key's head a run of c values at
// stride H c in place), the bias tile tb[b, h, 64 queries, 64 keys], the
// mask of the 64 keys and, with a unit's first key tile, its q tile into
// one of two shared-memory stages by cp.async copies, issued one step
// ahead under the products of the other stage; tile rows are padded so
// that fragment loads hit distinct banks. At a unit's first key tile each
// warp loads its q rows as mma A fragments (ldmatrix; float32 split into
// TF32 hi and lo once) and keeps them in registers. q.k is mma.sync m16n8k8
// TF32 three times over (3xTF32) for float32, m16n8k16 for bf16, with
// ldmatrix fragments of k. The online softmax runs on the accumulators:
// row maxima and sums over the four lanes of a quad. p.v takes p from the
// accumulators without a trip through shared memory: in float32 a lane's
// accumulator columns (2t, 2t+1) serve as the TF32 A fragment's k columns
// (t, t+4), which holds because the sum over keys is order-free and the B
// fragment reads v rows 2t and 2t+1 to match (loads by index), three TF32
// products again; in bf16 two adjacent n8 accumulator tiles pack into the
// m16n8k16 A fragment, v fragments through ldmatrix.trans. One TF32
// product for either q.k or p.v errs by 3-6e-4 of max |o| at J=256 and
// fails the 1e-4 float32 tolerance (tests/test_torch_tri_att.py emulates
// each scheme). A key past J has probability zero and takes no part in the
// maximum; a key masked by `mask` keeps its logit s - inf as the reference
// does, so a row whose keys are all masked attends uniformly over all J
// keys. Any JQ, JK and c <= 64: c is padded with zeros to 16, 32 or 64;
// where a row of q, k, v or tb is not a multiple of 16 bytes it is staged
// element by element with plain loads; queries past JQ store nothing.

#include <stdint.h>

#include "tensor_core.cuh"
#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TQ = 16 * WARPS;  // queries per block
constexpr int TK = 64;          // keys per tile
constexpr int NT = TK / 8;      // n8 tiles of s per key tile
constexpr int STAGES = 2;
// Blocks an SM should hold: the register budget of a thread follows
// (float32 keeps its q fragments split in hi and lo).
template <typename T>
constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 2 : 4;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

// One stage of the ring in shared memory: the q tile [TQ queries][LD] (used
// by the first key tile of a unit), the k and v tiles [TK keys][LD] (c
// contiguous), the triangle bias tile [TQ queries][LDT] and the mask of the
// TK keys. LD * size is an odd multiple of 16 bytes (ldmatrix rows in
// distinct banks); LDT = TK + 8 puts a quad's pair loads of eight rows in
// distinct banks.
template <typename T, int CP>
struct Layout {
    static constexpr int LD = CP + 16 / (int)sizeof(T);
    static constexpr int LDT = TK + 8;
    static constexpr int QTILE = TQ * LD, TILE = TK * LD;  // elements of the q tile, of one of k, v
    static constexpr size_t TB = (size_t)(QTILE + 2 * TILE) * sizeof(T);  // byte offsets within a stage
    static constexpr size_t MASK = TB + (size_t)TQ * LDT * sizeof(T);
    static constexpr size_t STAGE = MASK + TK * sizeof(float);
    static constexpr size_t SMEM = STAGES * STAGE;
};

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// Two bf16 values packed as an mma operand register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The pair p[0], p[1] in shared memory (aligned to the pair) as floats.
__device__ __forceinline__ float2 pair_f(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Positions row0 .. row0 + ROWS of one head of q, k or v (rows at stride hc
// from src, J of them) into dst[ROWS][LD], channels below c; rows past J
// are zero.
// mode 2: 16-byte cp.async copies with c == CP; 1: 16-byte copies (c * size
// a multiple of 16, src aligned); 0: plain loads.
template <typename T, int LD, int ROWS, int CP>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0, int J, int c, size_t hc, int mode) {
    constexpr int V = 16 / (int)sizeof(T);
    if (mode == 2) {
        constexpr int CHUNKS = CP / V, COPIES = ROWS * CHUNKS;
#pragma unroll
        for (int e = 0; e < (COPIES + THREADS - 1) / THREADS; ++e) {
            const int idx = threadIdx.x + e * THREADS;
            if (COPIES % THREADS != 0 && idx >= COPIES) break;
            const int r = idx / CHUNKS, col = (idx % CHUNKS) * V;
            const bool ok = row0 + r < J;
            tc::cp_async16(dst + r * LD + col, ok ? src + (size_t)(row0 + r) * hc + col : src, ok ? 16 : 0);
        }
    } else if (mode == 1) {
        const int chunks = c / V;
        for (int idx = threadIdx.x; idx < ROWS * chunks; idx += THREADS) {
            const int r = idx / chunks, col = (idx - r * chunks) * V;
            const bool ok = row0 + r < J;
            tc::cp_async16(dst + r * LD + col, ok ? src + (size_t)(row0 + r) * hc + col : src, ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < ROWS * c; idx += THREADS) {
            const int r = idx / c, col = idx - r * c;
            dst[r * LD + col] = row0 + r < J ? src[(size_t)(row0 + r) * hc + col] : Cvt<T>::from_f(0.f);
        }
    }
}

// The triangle bias tb[q0 .. q0 + TQ, key0 .. key0 + TK] of one (b, h),
// [JQ][JK], into dst[TQ][LDT], zero past its edges. vec: 16-byte copies
// (JK * size a multiple of 16, tb aligned); else plain loads.
template <typename T, int LDT>
__device__ __forceinline__ void stage_bias(T* dst, const T* tb_bh, int q0, int key0, int JQ, int JK, bool vec) {
    if (vec) {
        constexpr int V = 16 / (int)sizeof(T), CHUNKS = TK / V;
#pragma unroll
        for (int e = 0; e < TQ * CHUNKS / THREADS; ++e) {
            const int idx = threadIdx.x + e * THREADS;
            const int r = idx / CHUNKS, col = (idx % CHUNKS) * V;
            const bool ok = q0 + r < JQ && key0 + col < JK;
            tc::cp_async16(dst + r * LDT + col, ok ? tb_bh + (size_t)(q0 + r) * JK + key0 + col : tb_bh, ok ? 16 : 0);
        }
    } else {
        for (int idx = threadIdx.x; idx < TQ * TK; idx += THREADS) {
            const int r = idx / TK, col = idx % TK;
            const bool ok = q0 + r < JQ && key0 + col < JK;
            dst[r * LDT + col] = ok ? tb_bh[(size_t)(q0 + r) * JK + key0 + col] : Cvt<T>::from_f(0.f);
        }
    }
}

// CP: the head width padded to the k step, 16, 32 or 64; c <= CP the real one.
// SQUARE: JQ = JK, the queries are the keys (one head offset for q, k and
// v, as on one card); the ending node's row block under sequence
// parallelism takes the general case.
// A unit is one (b, i, h) and TQ queries; U units in all, ordered (b, h,
// query tile, i) with i fastest, and each block takes a contiguous run of
// them: the blocks at work at one time read the bias tiles of few (b, h)
// and the k and v rows of few (b, i), while L2 holds them.
template <typename T, int CP, bool SQUARE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<T>)
tri_att_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ tb, const float* __restrict__ mask, T* __restrict__ out,
               int I, int JQ_, int JK, int H, int c, int U, float scale, float inf, int mode, int vec_tb) {
    const int JQ = SQUARE ? JK : JQ_;
    using L = Layout<T, CP>;
    using M = tc::Mma<T>;
    constexpr bool F32 = sizeof(T) == 4;
    constexpr int KS = M::KSTEP;
    constexpr int QK = CP / KS;  // k steps of q.k
    constexpr int CT = CP / 8;   // n8 tiles of o
    extern __shared__ __align__(16) unsigned char smem_raw[];

    const int QT = (JQ + TQ - 1) / TQ;
    const int KT = (JK + TK - 1) / TK;
    const int u0 = (int)((long long)blockIdx.x * U / gridDim.x);
    const int steps = ((int)((long long)(blockIdx.x + 1) * U / gridDim.x) - u0) * KT;  // (unit u0 + n, key tile kt): step n KT + kt
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wr = warp * 16;  // the warp's first row in the unit's queries
    const size_t hc = (size_t)H * c;

    // Where the block's unit n starts: q (and o) and k, v at (b, i, 0, h,
    // 0), tb at (b, h), the mask at (b, i); its first query.
    struct Unit {
        size_t head, khead;
        const T* tb_bh;
        const float* mrow;
        int q0;
    };
    auto unit = [&](int n) {
        const int u = u0 + n, group = u / I, i = u - group * I;
        const int bh = group / QT, h = bh % H, b = bh / H, bi = b * I + i;
        const size_t head = (size_t)bi * JQ * hc + (size_t)h * c;
        return Unit{head, SQUARE ? head : (size_t)bi * JK * hc + (size_t)h * c,
                    tb + ((size_t)b * H + h) * JQ * JK, mask + (size_t)bi * JK, (group - bh * QT) * TQ};
    };

    // Channels c .. CP of every q, k and v tile are zero for good; the
    // copies never write them.
    constexpr int ROWS = TQ + 2 * TK;  // rows of the q, k and v tiles of a stage
    if (c < CP)
        for (int idx = threadIdx.x; idx < STAGES * ROWS * (CP - c); idx += THREADS) {
            const int r = idx / (CP - c), st = r / ROWS;
            T* tile = reinterpret_cast<T*>(smem_raw + st * L::STAGE) + (r - st * ROWS) * L::LD;
            tile[c + idx - r * (CP - c)] = Cvt<T>::from_f(0.f);
        }

    // Step st into stage s: its key tile of k, v, tb and the mask, and the
    // unit's q tile with its first key tile.
    auto stage = [&](int s, int st) {
        const int n = st / KT, kt = st - n * KT, key0 = kt * TK;
        const Unit un = unit(n);
        unsigned char* base = smem_raw + s * L::STAGE;
        T* qs = reinterpret_cast<T*>(base);
        if (kt == 0) stage_rows<T, L::LD, TQ, CP>(qs, q + un.head, un.q0, JQ, c, hc, mode);
        stage_rows<T, L::LD, TK, CP>(qs + L::QTILE, k + un.khead, key0, JK, c, hc, mode);
        stage_rows<T, L::LD, TK, CP>(qs + L::QTILE + L::TILE, v + un.khead, key0, JK, c, hc, mode);
        stage_bias<T, L::LDT>(reinterpret_cast<T*>(base + L::TB), un.tb_bh, un.q0, key0, JQ, JK, vec_tb);
        if (threadIdx.x < TK) {
            const bool ok = key0 + (int)threadIdx.x < JK;
            tc::cp_async4(reinterpret_cast<float*>(base + L::MASK) + threadIdx.x,
                          ok ? un.mrow + key0 + threadIdx.x : un.mrow, ok ? 4 : 0);
        }
    };
    if (steps > 0) stage(0, 0);
    tc::cp_async_commit();

    typename M::A qa[QK];
    float o[CT][4], m_run[2], l_run[2];
    Unit un{};
    for (int st = 0, nu = 0, kt = 0; st < steps; ++st) {
        const int key0 = kt * TK;
        tc::cp_async_wait<0>();  // step st has landed (this thread's copies)
        __syncthreads();         // ... everyone's, and step st - 1 is consumed
        if (st + 1 < steps) stage((st + 1) % STAGES, st + 1);
        tc::cp_async_commit();
        const unsigned char* base = smem_raw + (st % STAGES) * L::STAGE;
        const T* qs = reinterpret_cast<const T*>(base);
        const T* ks = qs + L::QTILE;
        const T* vs = ks + L::TILE;
        const T* tbs = reinterpret_cast<const T*>(base + L::TB) + (wr + g) * L::LDT;
        const float* ms = reinterpret_cast<const float*>(base + L::MASK);

        if (kt == 0) {  // a new unit: its q fragments (float32: split once), a fresh softmax
            un = unit(nu);
            const tc::Tile<T, true> tq{qs, L::LD};
#pragma unroll
            for (int kk = 0; kk < QK; ++kk) M::load_a(qa[kk], tq, wr, kk * KS, lane);
#pragma unroll
            for (int nn = 0; nn < CT; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;
            m_run[0] = m_run[1] = NEG_INF;
            l_run[0] = l_run[1] = 0.f;
        }

        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
            const tc::Tile<T, true> tk{ks, L::LD};
#pragma unroll
            for (int kk = 0; kk < QK; ++kk) {
                typename M::B fb;
                M::load_b(fb, tk, 8 * n, kk * KS, lane);
                M::mma(s[n], qa[kk], fb);
            }
        }

        // The logits in the reference's order (q.k / sqrt(c) + tb + inf (mask
        // - 1); -1e30 past JK), then the online softmax over the quad that
        // holds each row.
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int col = 8 * n + 2 * t;
            const float2 b0 = pair_f(tbs + col), b1 = pair_f(tbs + 8 * L::LDT + col), mk = pair_f(ms + col);
            const float mb0 = key0 + col < JK ? inf * (mk.x - 1.f) : NEG_INF;
            const float mb1 = key0 + col + 1 < JK ? inf * (mk.y - 1.f) : NEG_INF;
            s[n][0] = (s[n][0] * scale + b0.x) + mb0;
            s[n][1] = (s[n][1] * scale + b0.y) + mb1;
            s[n][2] = (s[n][2] * scale + b1.x) + mb0;
            s[n][3] = (s[n][3] * scale + b1.y) + mb1;
            mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = __expf(m_run[r] - mx[r]);
            m_run[r] = mx[r];
            l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < CT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[n][e] = __expf(s[n][e] - mx[e >> 1]);
                l_run[e >> 1] += s[n][e];
            }

        if constexpr (F32) {
            // Key step kk is s tile kk: accumulator columns (2t, 2t + 1) are the
            // A fragment's k columns (t, t + 4), v rows 2t and 2t + 1 the B
            // fragment's.
#pragma unroll
            for (int kk = 0; kk < NT; ++kk) {
                typename M::A pa;
                const float pf[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
                for (int e = 0; e < 4; ++e) tc::split_tf32(bits(pf[e]), pa.hi[e], pa.lo[e]);
                const T* v0 = vs + (8 * kk + 2 * t) * L::LD + g;
#pragma unroll
                for (int n = 0; n < CT; ++n) {
                    typename M::B fb;
                    tc::split_tf32(bits(v0[8 * n]), fb.hi[0], fb.lo[0]);
                    tc::split_tf32(bits(v0[L::LD + 8 * n]), fb.hi[1], fb.lo[1]);
                    M::mma(o[n], pa, fb);
                }
            }
        } else {
            const tc::Tile<T, false> tv{vs, L::LD};
#pragma unroll
            for (int kk = 0; kk < TK / 16; ++kk) {
                typename M::A pa;
                pa.r[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
                pa.r[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
                pa.r[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
                pa.r[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
                for (int n = 0; n < CT; ++n) {
                    typename M::B fb;
                    M::load_b(fb, tv, 8 * n, 16 * kk, lane);
                    M::mma(o[n], pa, fb);
                }
            }
        }
        if (kt + 1 < KT) {
            ++kt;
            continue;
        }
        // The unit's last key tile: normalise and store its queries.
        float norm[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
            l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
            norm[r] = 1.f / fmaxf(l_run[r], 1e-20f);
        }
        const bool pair_out = (c & 1) == 0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = un.q0 + wr + g + 8 * half;
            if (row >= JQ) continue;
            T* po = out + un.head + (size_t)row * hc;
#pragma unroll
            for (int nn = 0; nn < CT; ++nn) {
                const int col = 8 * nn + 2 * t;
                const float x0 = o[nn][2 * half] * norm[half], x1 = o[nn][2 * half + 1] * norm[half];
                if (pair_out) {  // c even: the pair is whole and aligned
                    if (col < c) tc::store_pair(po + col, x0, x1);
                } else {
                    if (col < c) po[col] = Cvt<T>::from_f(x0);
                    if (col + 1 < c) po[col + 1] = Cvt<T>::from_f(x1);
                }
            }
        }
        kt = 0;
        ++nu;
    }
    tc::cp_async_wait<0>();
}

template <typename T, int CP, bool SQUARE>
int launch_c(const T* q, const T* k, const T* v, const T* tb, const float* mask, T* out, int B, int I, int JQ,
             int JK, int H, int c, float scale, float inf, cudaStream_t stream) {
    // The shared-memory allowance and the blocks an SM holds, set and asked
    // once per device: host calls the main path would otherwise pay at every
    // launch.
    static int blocks[MAX_DEVICES];
    auto kernel = tri_att_kernel<T, CP, SQUARE>;
    const size_t smem = Layout<T, CP>::SMEM;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!blocks[dev]) {
        int per_sm = 0, sms = 0;
        if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
                cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)err;
        blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const long long units = (long long)B * I * H * ((JQ + TQ - 1) / TQ);
    if (units * ((JK + TK - 1) / TK) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = (int)(units < blocks[dev] ? units : blocks[dev]);
    const bool vec = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0 && (c * sizeof(T)) % 16 == 0;
    const int mode = vec ? (c == CP ? 2 : 1) : 0;
    const bool vec_tb = (uintptr_t)tb % 16 == 0 && (JK * sizeof(T)) % 16 == 0;
    kernel<<<grid, THREADS, smem, stream>>>(q, k, v, tb, mask, out, I, JQ, JK, H, c, (int)units, scale, inf, mode,
                                            (int)vec_tb);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tb, const void* mask, void* out, int B, int I,
           int JQ, int JK, int H, int c, float scale, float inf, cudaStream_t stream) {
    const T* pq = static_cast<const T*>(q);
    const T* pk = static_cast<const T*>(k);
    const T* pv = static_cast<const T*>(v);
    const T* pt = static_cast<const T*>(tb);
    const float* pm = static_cast<const float*>(mask);
    T* po = static_cast<T*>(out);
    if (JQ == JK) {
        if (c <= 16) return launch_c<T, 16, true>(pq, pk, pv, pt, pm, po, B, I, JQ, JK, H, c, scale, inf, stream);
        if (c <= 32) return launch_c<T, 32, true>(pq, pk, pv, pt, pm, po, B, I, JQ, JK, H, c, scale, inf, stream);
        return launch_c<T, 64, true>(pq, pk, pv, pt, pm, po, B, I, JQ, JK, H, c, scale, inf, stream);
    }
    if (c <= 16) return launch_c<T, 16, false>(pq, pk, pv, pt, pm, po, B, I, JQ, JK, H, c, scale, inf, stream);
    if (c <= 32) return launch_c<T, 32, false>(pq, pk, pv, pt, pm, po, B, I, JQ, JK, H, c, scale, inf, stream);
    return launch_c<T, 64, false>(pq, pk, pv, pt, pm, po, B, I, JQ, JK, H, c, scale, inf, stream);
}

}  // namespace

// q, out: [B, I, JQ, H, c]; k, v: [B, I, JK, H, c]; tb: [B, H, JQ, JK], all
// of dtype 0 = float32 or 1 = bfloat16; mask: [B, I, JK] float32. c <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tri_att_flash(const void* q, const void* k, const void* v, const void* tb, const void* mask,
                             void* out, int B, int I, int JQ, int JK, int H, int c, float scale, float inf, int dtype,
                             void* stream) {
    if (B < 1 || I < 1 || JQ < 1 || JK < 1 || H < 1 || c < 1 || c > 64) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(q, k, v, tb, mask, out, B, I, JQ, JK, H, c, scale, inf, st);
    if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, tb, mask, out, B, I, JQ, JK, H, c, scale, inf, st);
    return (int)cudaErrorInvalidValue;
}

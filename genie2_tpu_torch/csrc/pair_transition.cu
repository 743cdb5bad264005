// The pair transition (AF2 Algorithm 15) as one kernel, float32:
//
//     out[r] = mask[r] (relu(LN(z[r]) W1^T + b1) W2^T + b2)
//
// over the rows r of the pair representation flattened to [rows, C], with
// C = 128 channels and a hidden width H, a multiple of 64 (n C with n = 2
// or 4 in the configurations). A row block of sequence parallelism is rows
// like any other.
//
// It replaces no TPU kernel: genie2_tpu leaves the transition to XLA
// (nn/pair_stack.py PairTransition). It exists because cuBLAS has no
// float32 tensor-core path: torch's two float32 products run as SIMT FFMA
// GEMMs at about 45 TFLOP/s, and the [rows, H] hidden goes through device
// memory four times (linear_1's write, the ReLU's read and write,
// linear_2's read), beside an unfused LayerNorm and the mask's multiply.
//
// Bound: operations. 2 x rows x C x H multiply-adds a product, two
// products, each as three TF32 products (3xTF32: x = hi + lo, x.w = lo.hi +
// hi.lo + hi.hi, tensor_core.cuh): 0.42 ms at rows = 262,144 and H = 512
// against 495 / 3 TFLOP/s; its bytes (z and the mask in, out out) 0.08 ms.
//
// Design. Hopper's warpgroup products (wgmma), its one way to the tensor
// cores' full rate, take every operand k-major here: z's rows, W1 [H, C]
// and W2 [C, H] as they are stored. 0.60 ms a call at 262,144 rows
// (PERF.md section 6, row 9).
//   - Persistent blocks, one an SM, walk tiles of 128 rows. Two consumer
//     warpgroups own 64 rows each; one thread of a producer warpgroup
//     streams the weights.
//   - A consumer warpgroup normalises its rows in float32 (statistics from
//     one read, 16-byte loads) and stages them in shared memory as TF32 hi
//     and lo images, k-major (64 KB).
//   - The hidden width goes by in chunks of 64. The chunk's x.W1^T
//     (m64n64k8, A and B from shared memory, three products) lands in 32
//     float32 accumulators a thread; b1 and the ReLU are applied there,
//     and each value is split into hi and lo in registers, which are the A
//     operand of the chunk's h.W2^T (m64n128k8, A from registers) into the
//     tile's 64 output accumulators. The accumulator's columns 2t, 2t + 1
//     of an 8-column block are the A fragment's k slots t, t + 4, so W2's
//     hidden columns are permuted that way in its image. Nothing of size
//     rows x H leaves the SM.
//   - The weights' hi / lo split is made once a call (prep_kernel) into
//     images laid out as the products read them (8 x 16-byte core
//     matrices, no swizzle): 8 pieces of 16 KB a chunk, W1 by quarters of
//     C and W2 by quarters of the chunk, 1 MB in all at H = 512, resident
//     in L2. The producer copies each piece with one bulk copy (TMA) into a
//     ring of six slots that both warpgroups read; each warp releases a
//     slot once its products on it have completed.
//   - A warpgroup issues the next chunk's x.W1^T behind this chunk's
//     h.W2^T and keeps up to three pieces' products in flight; the other
//     warpgroup's products fill the tensor cores while one applies its
//     bias, ReLU and split, normalises its next rows or stores.
//   - b2 and the mask are applied to the accumulators and each thread
//     stores its pairs of columns straight to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int C = 128;                       // channels
constexpr int HC = 64;                       // hidden channels a chunk
constexpr int WG_ROWS = 64;                  // rows of a consumer warpgroup (wgmma's M)
constexpr int CONSUMERS = 2;                 // consumer warpgroups
constexpr int TILE = WG_ROWS * CONSUMERS;    // rows a tile
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer warpgroup
// Registers a thread after setmaxnreg: 384 threads start at 168 (65,536
// over 384, in steps of 8); the producer's give the consumers 64 more.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int PIECES = 8;                    // weight pieces a chunk: W1 by C quarters, W2 by chunk quarters
constexpr int PIECE_FLOATS = 4096;           // a piece: a hi image of 2048 floats, then its lo image
constexpr int PIECE_BYTES = PIECE_FLOATS * 4;
constexpr int SLOTS = 6;                     // the ring of pieces
constexpr int LAG = 3;                       // pieces a warpgroup keeps in flight

// Strides of the k-major core-matrix layouts, in bytes: core matrices of 8
// rows x 16 bytes (4 TF32 values), 128 bytes each; LBO steps along k, SBO
// along 8-row groups. A k step of 8 values is two core matrices, 256 bytes.
constexpr int LBO = 128;
constexpr int X_SBO = (C / 4) * 128;         // normalised rows [64, C]
constexpr int W1_SBO = (C / 4 / 4) * 128;    // a W1 piece [64 hidden, C / 4]
constexpr int W2_SBO = (HC / 4 / 4) * 128;   // a W2 piece [C outputs, 16 hidden]
constexpr int KSTEP_BYTES = 256;

struct Smem {
    float x[CONSUMERS][2][WG_ROWS * C];      // per warpgroup: hi, lo
    float ring[SLOTS][PIECE_FLOATS];
    float ln_w[C], ln_b[C];
    uint64_t full[SLOTS], empty[SLOTS];
};

// ------------------------------------------------------------------ //
// wgmma
// ------------------------------------------------------------------ //

// A shared-memory matrix descriptor: k-major, no swizzle.
__device__ __forceinline__ uint64_t descriptor(const void* p, int sbo) {
    return (uint64_t)((tc::smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)(LBO >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps reads and writes of an accumulator on their side of a wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, 32 a thread) = a.b (+ d where accumulate), a and b from shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
        "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, 64 a thread) += a.b, a from registers (the m16n8k8 TF32 A
// fragment of each warp's 16 rows), b from shared memory.
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
        "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// One arrival on `bar` where `pred`, as a predicated instruction: no branch
// between a warpgroup's products.
__device__ __forceinline__ void arrive_if(uint64_t* bar, bool pred) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
            tc::smem_addr(bar)),
        "r"((int)pred)
        : "memory");
}

__device__ __forceinline__ void named_barrier(int id) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ------------------------------------------------------------------ //
// The weights' images
// ------------------------------------------------------------------ //

// Piece p = 8 c + k of chunk c: k < 4 is W1[c 64 + n, 32 k + j] (n < 64, j
// < 32), k >= 4 is W2[o, c 64 + 16 (k - 4) + perm(s)] (o < 128, s < 16):
// the k slot s of the A fragment holds hidden column 8 (s / 8) + 2 (s % 4)
// + (s % 8) / 4 of the quarter, where the chunk's accumulators hold it.
// Element (row, k) of an image sits at float (row / 8) SBO + (k / 4) 32 +
// (row % 8) 4 + k % 4, SBO in floats; hi first, lo 2048 floats on.
__global__ void prep_kernel(const float* __restrict__ w1, const float* __restrict__ w2, float* __restrict__ images,
                            int H) {
    const int total = (H / HC) * PIECES * (PIECE_FLOATS / 2);
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += gridDim.x * blockDim.x) {
        const int p = idx / (PIECE_FLOATS / 2), e = idx % (PIECE_FLOATS / 2);
        const int c = p / PIECES, k = p % PIECES;
        float v;
        if (k < 4) {
            const int sbo = W1_SBO / 4;
            const int n = (e / sbo) * 8 + (e % 32) / 4, j = ((e % sbo) / 32) * 4 + e % 4;
            v = w1[(size_t)(c * HC + n) * C + k * (C / 4) + j];
        } else {
            const int sbo = W2_SBO / 4;
            const int o = (e / sbo) * 8 + (e % 32) / 4, s = ((e % sbo) / 32) * 4 + e % 4;
            const int col = 8 * (s / 8) + 2 * (s % 4) + (s % 8) / 4;
            v = w2[(size_t)o * H + c * HC + (k - 4) * 16 + col];
        }
        uint32_t hi, lo;
        tc::split_tf32(__float_as_uint(v), hi, lo);
        images[(size_t)p * PIECE_FLOATS + e] = __uint_as_float(hi);
        images[(size_t)p * PIECE_FLOATS + PIECE_FLOATS / 2 + e] = __uint_as_float(lo);
    }
}

// ------------------------------------------------------------------ //
// The transition
// ------------------------------------------------------------------ //

struct Args {
    const float* z;
    const float* mask;
    const float* ln_w;
    const float* ln_b;
    const float* images;
    const float* b1;
    const float* b2;
    float* out;
    int rows, H;
    float eps;
};

// Normalise rows [row0, row0 + 64) into the warpgroup's hi / lo images:
// warp w of the warpgroup takes the 8-row groups 2w and 2w + 1; lane l row
// l % 8 of a group and the 16-byte channel groups l / 8 + 4 i, so eight
// lanes of a store write one core matrix row each (no bank conflict) and a
// load reads 64 contiguous bytes of each of 8 rows. Rows past the end read
// as zero and are never stored.
__device__ __forceinline__ void layer_norm_rows(const Args& a, const Smem& sm, float* xh, float* xl, int row0,
                                                int warp, int lane) {
    const int r8 = lane & 7, cq = lane >> 3;
    float4 v[2][8];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
        const int row = row0 + (2 * warp + g) * 8 + r8;
        const float4* src = reinterpret_cast<const float4*>(a.z + (size_t)row * C);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[g][i] = row < a.rows ? __ldg(src + cq + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += (v[g][i].x + v[g][i].y) + (v[g][i].z + v[g][i].w);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        const float mean = s * (1.f / C);
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float dx = v[g][i].x - mean, dy = v[g][i].y - mean, dz = v[g][i].z - mean, dw = v[g][i].w - mean;
            q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
        }
        q += __shfl_xor_sync(0xffffffffu, q, 8);
        q += __shfl_xor_sync(0xffffffffu, q, 16);
        const float rstd = rsqrtf(q * (1.f / C) + a.eps);
        const int base = (2 * warp + g) * (X_SBO / 4) + r8 * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int cg = cq + 4 * i;
            const float4 w = *reinterpret_cast<const float4*>(sm.ln_w + 4 * cg);
            const float4 b = *reinterpret_cast<const float4*>(sm.ln_b + 4 * cg);
            const float y[4] = {(v[g][i].x - mean) * rstd * w.x + b.x, (v[g][i].y - mean) * rstd * w.y + b.y,
                                (v[g][i].z - mean) * rstd * w.z + b.z, (v[g][i].w - mean) * rstd * w.w + b.w};
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) tc::split_tf32(__float_as_uint(y[e]), hi[e], lo[e]);
            *reinterpret_cast<uint4*>(xh + base + cg * 32) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(xl + base + cg * 32) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
    }
}

__global__ void __launch_bounds__(THREADS, 1) transition_kernel(const Args a) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int tiles = (a.rows + TILE - 1) / TILE, chunks = a.H / HC;

    if (tid < C) {
        sm.ln_w[tid] = a.ln_w[tid];
        sm.ln_b[tid] = a.ln_b[tid];
    }
    if (tid == 0) {
        for (int s = 0; s < SLOTS; ++s) {
            tc::mbar_init(&sm.full[s], 1);
            tc::mbar_init(&sm.empty[s], CONSUMERS * 4);  // one arrival a consumer warp
        }
        tc::mbar_init_fence();
    }
    __syncthreads();

    if (warp >= CONSUMERS * 4) {
        // The producer warpgroup gives its registers to the consumers; one
        // thread streams the pieces, the same ones in the same order a tile.
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (warp == CONSUMERS * 4 && lane == 0) {
            uint32_t k = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int next = tile + gridDim.x;
                if (next < tiles) {  // the next tile's rows into L2 while this one runs
                    const int n = min(TILE, a.rows - next * TILE);
                    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(a.z + (size_t)next * TILE * C),
                                 "r"(n * C * 4)
                                 : "memory");
                }
                for (int p = 0; p < chunks * PIECES; ++p, ++k) {
                    const int slot = k % SLOTS;
                    tc::mbar_wait(&sm.empty[slot], ((k / SLOTS) & 1) ^ 1);
                    tc::mbar_expect_tx(&sm.full[slot], PIECE_BYTES);
                    tc::bulk_copy(sm.ring[slot], a.images + (size_t)p * PIECE_FLOATS, PIECE_BYTES, &sm.full[slot]);
                }
            }
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

    // A consumer warpgroup. Branches between products are warp-uniform;
    // a slot's release is one predicated arrival of each warp's lane 0.
    const int wg = warp / 4, wwarp = warp % 4, g = lane / 4, t = lane % 4;
    float* xh = sm.x[wg][0];
    float* xl = sm.x[wg][1];
    const uint64_t xh_desc = descriptor(xh, X_SBO), xl_desc = descriptor(xl, X_SBO);
    float acc1[32], acc2[64];
    uint32_t hhi[32], hlo[32];  // the chunk's h as A fragments: k step j at [4 j, 4 j + 4)
    uint32_t k = 0;             // pieces consumed

    auto wait_full = [&]() { tc::mbar_wait(&sm.full[k % SLOTS], (k / SLOTS) & 1); };
    // After a piece's products are committed: at most LAG pieces in flight,
    // and the piece before them released if this step issued it (from k0).
    auto retire = [&](uint32_t k0) {
        wg_wait<LAG>();
        const uint32_t done = k - 1 - LAG;
        arrive_if(&sm.empty[done % SLOTS], lane == 0 && k - k0 > LAG);
    };
    // The end of a step: every product complete, its last pieces released.
    auto finish = [&](uint32_t k0) {
        wg_wait<0>();
        fence_operands(acc1);
        fence_operands(acc2);
#pragma unroll
        for (int r = 0; r < LAG; ++r) {
            const uint32_t done = k - LAG + r;
            arrive_if(&sm.empty[done % SLOTS], lane == 0 && k - k0 >= (uint32_t)(LAG - r));
        }
    };
    // Chunk c's h.W2^T into acc2, from four pieces (two k steps each).
    auto issue_w2 = [&](uint32_t k0, bool first) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            wait_full();
            const float* piece = sm.ring[k % SLOTS];
            const uint64_t bh = descriptor(piece, W2_SBO), bl = descriptor(piece + PIECE_FLOATS / 2, W2_SBO);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * q + jj;
                const uint64_t step = (jj * KSTEP_BYTES) >> 4;
                wgmma_n128_rs(acc2, hlo[4 * j], hlo[4 * j + 1], hlo[4 * j + 2], hlo[4 * j + 3], bh + step,
                              !first || j > 0);
                wgmma_n128_rs(acc2, hhi[4 * j], hhi[4 * j + 1], hhi[4 * j + 2], hhi[4 * j + 3], bl + step, 1);
                wgmma_n128_rs(acc2, hhi[4 * j], hhi[4 * j + 1], hhi[4 * j + 2], hhi[4 * j + 3], bh + step, 1);
            }
            wg_commit();
            ++k;
            retire(k0);
        }
    };
    // A chunk's x.W1^T into acc1, from four pieces (a quarter of C each).
    auto issue_w1 = [&](uint32_t k0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            wait_full();
            const float* piece = sm.ring[k % SLOTS];
            const uint64_t bh = descriptor(piece, W1_SBO), bl = descriptor(piece + PIECE_FLOATS / 2, W1_SBO);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint64_t xs = ((4 * q + j) * KSTEP_BYTES) >> 4, ws = (j * KSTEP_BYTES) >> 4;
                wgmma_n64(acc1, xl_desc + xs, bh + ws, q > 0 || j > 0);
                wgmma_n64(acc1, xh_desc + xs, bl + ws, 1);
                wgmma_n64(acc1, xh_desc + xs, bh + ws, 1);
            }
            wg_commit();
            ++k;
            retire(k0);
        }
    };
    // b1 and the ReLU on chunk c; the accumulator's (g, 8j + 2t), (g, 8j +
    // 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1) become the A
    // fragment's (g, t), (g, t + 4), (g + 8, t), (g + 8, t + 4) of k step j.
    auto hidden = [&](int c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b1 + c * HC + 8 * j + 2 * t));
            const float v0 = fmaxf(acc1[4 * j] + bb.x, 0.f), v1 = fmaxf(acc1[4 * j + 1] + bb.y, 0.f);
            const float v2 = fmaxf(acc1[4 * j + 2] + bb.x, 0.f), v3 = fmaxf(acc1[4 * j + 3] + bb.y, 0.f);
            tc::split_tf32(__float_as_uint(v0), hhi[4 * j + 0], hlo[4 * j + 0]);
            tc::split_tf32(__float_as_uint(v2), hhi[4 * j + 1], hlo[4 * j + 1]);
            tc::split_tf32(__float_as_uint(v1), hhi[4 * j + 2], hlo[4 * j + 2]);
            tc::split_tf32(__float_as_uint(v3), hhi[4 * j + 3], hlo[4 * j + 3]);
        }
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile * TILE + wg * WG_ROWS;
        named_barrier(1 + wg);  // every warp's products on the last tile's rows have completed
        layer_norm_rows(a, sm, xh, xl, row0, wwarp, lane);
        tc::fence_proxy_async();  // the images, written by the threads, are read by wgmma
        named_barrier(1 + wg);

        // Step c: chunk c - 1's h.W2^T, then chunk c's x.W1^T.
        uint32_t k0 = k;
        wg_fence();
        issue_w1(k0);
        finish(k0);
        hidden(0);
        for (int c = 1; c < chunks; ++c) {
            k0 = k;
            wg_fence();
            issue_w2(k0, c == 1);
            issue_w1(k0);
            finish(k0);
            hidden(c);
        }
        k0 = k;
        wg_fence();
        issue_w2(k0, chunks == 1);
        finish(k0);

        // b2, the mask, and the store: rows g and g + 8 of this warp's 16.
        const int ra = row0 + 16 * wwarp + g, rb = ra + 8;
        const float ma = ra < a.rows ? __ldg(a.mask + ra) : 0.f, mb = rb < a.rows ? __ldg(a.mask + rb) : 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int col = 8 * i + 2 * t;
            const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + col));
            if (ra < a.rows) tc::store_pair(a.out + (size_t)ra * C + col, (acc2[4 * i] + bb.x) * ma,
                                            (acc2[4 * i + 1] + bb.y) * ma);
            if (rb < a.rows) tc::store_pair(a.out + (size_t)rb * C + col, (acc2[4 * i + 2] + bb.x) * mb,
                                            (acc2[4 * i + 3] + bb.y) * mb);
        }
    }
}

}  // namespace

// z [rows, 128], mask [rows], ln_w, ln_b [128], w1 [H, 128], b1 [H], w2
// [128, H], b2 [128], all float32 and contiguous; images: scratch of H x 512
// floats (the weights' hi / lo images, written here); out [rows, 128]. H a
// positive multiple of 64. z, out and images 16-byte aligned, b1 and b2
// 8-byte aligned. Returns the cudaError_t of the launches (0 on success).
extern "C" int pair_transition(const float* z, const float* mask, const float* ln_w, const float* ln_b,
                               const float* w1, const float* b1, const float* w2, const float* b2, float* images,
                               float* out, int rows, int H, float eps, void* stream) {
    if (rows < 0 || H < HC || H % HC != 0) return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    // The shared-memory allowance and the SM count, set and asked once per
    // device: host calls the main path would otherwise pay at every launch.
    constexpr int MAX_DEVICES = 64;
    static int sms[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!sms[dev]) {
        int n = 0;
        if ((err = cudaFuncSetAttribute(transition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)sizeof(Smem))) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)err;
        sms[dev] = n;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int total = (H / HC) * PIECES * (PIECE_FLOATS / 2);
    prep_kernel<<<(total + 255) / 256, 256, 0, s>>>(w1, w2, images, H);
    const int tiles = (rows + TILE - 1) / TILE;
    const Args a{z, mask, ln_w, ln_b, images, b1, b2, out, rows, H, eps};
    transition_kernel<<<tiles < sms[dev] ? tiles : sms[dev], THREADS, sizeof(Smem), s>>>(a);
    return (int)cudaGetLastError();
}

// ipa_attention: the attention core of invariant point attention, fused.
//
// Replaces genie2_tpu/ops/ipa_fused.py:188 fused_ipa_attention (Pallas
// kernel _ipa_kernel, :90), batched over samples. Per sample b, query row
// i, head h and key j:
//   s[h,i,j] = sqrt(1/(3C)) q[i,h,:].k[j,h,:] + sqrt(1/3) bias[i,j,h]
//              - 0.5 sum_p |qp[i,h,p] - kp[j,h,p]|^2 + inf (mask[j] - 1)
//   p        = softmax_j s          (online: running max and sum, float32)
//   o[i,h,:]      = sum_j p v[j,h,:]
//   o_pt[i,h,:]   = sum_j p vp[j,h,:]
//   o_pair[i,h,:] = sum_j p z[i,j,:]
// for NI query rows i against N keys j: NI = N, or under sequence
// parallelism this rank's residues as the queries (q, q points, bias and z
// [B,NI,..]) against every residue as the keys (k, v, their points and
// the mask [B,N,..]).
// where qp and kp are the points multiplied by f_h = sqrt(w_h s_pt) in
// float32 and rounded to the activation dtype (genie2_tpu's hm(), and
// ops/ipa.py:scale_points), so the squared distance carries the head
// weight. Only the key side is masked. In bfloat16 the probabilities are
// rounded to bfloat16 before they multiply z (not before v and vp); all
// sums are float32.
//
// The kernel takes the caller's tensors as they are: q, k, v, the three
// point sets, bias, z and the mask through their strides (k and v are
// strided halves of one projection in nn/structure.py, the points views),
// and writes o, o_pt and o_pair to their own outputs, so one wrapper call
// is one launch.
//
// Work at the main path's shape (B=2, N=256, H=12, C=16, Pq=4, Pv=8,
// Cz=128, float32): 0.62 GFLOP against 75 MB (z 67 MB read once, bias
// 6.3 MB): the card is bound by bytes, 22 us at 3.35 TB/s. Each block also
// reads the key rows of its sample whole (0.84 MB in float32 at N=256).
//
// Design: nothing of size N x N is written. One block of 512 threads owns
// TI (at most TI_MAX, fewer where Cz or shared memory ask for it) query
// rows of one sample and walks the keys TJ = 16 at a time through a ring
// of two shared-memory stages. Warp 15, the producer, fills the stages;
// warps 0-14, the consumers, compute; a stage is handed over by two
// mbarriers (full: the tile has landed; empty: every consumer warp has
// read it). Where the layouts allow it (the main path's do) the producer
// fills a stage by bulk copies of the tensor memory accelerator
// (cp.async.bulk, completing on the full barrier): per key one contiguous
// span of the k / v projection and one of the point sets, per query row
// one span of z over the tile's keys and one of the bias. A copy is one
// instruction of one lane; copies issued lane by lane (cp.async, 16 bytes
// a lane) stall the issuing warp on the memory system and are about eight
// times slower (the ipa_slot_copies variant); they are the fallback for
// other layouts (16, 8 or 4 bytes, or element by element). Per tile, on the
// consumers:
//   logits   one (row, key, head) a thread, TJ lanes a (row, head); the
//            key points scaled and rounded as they are read; the tile's max
//            by shuffles, then the exponentials (the softmax);
//   sums     o_pair on the tensor cores: each consumer warp owns tiles of
//            (a query row, 8 channels) x 16 heads (those past H zero), p
//            (heads x keys) times z (keys x channels) by m16n8k8 mma.sync,
//            3xTF32 in float32, bf16 p (rounded as the plain version does)
//            and z in bf16; o, o_pt and the softmax denominator in SIMT: a
//            thread owns (head, column) items for all rows, p read as
//            float4 over rows, the column of ones being the last.
// Two consumer barriers a tile. Any N and NI: keys past N get a logit of
// -1e30, rows past NI are computed on a clamped index and not stored. wgmma, TMA
// tensor maps and cluster multicast are left out.

#include <stdint.h>

#include <initializer_list>

#include "tensor_core.cuh"
#include "trimul_common.cuh"

namespace {

using namespace trimul;

constexpr int THREADS = 512;
constexpr int CONSUMERS = THREADS - 32;  // warps 0-14; warp 15 stages the tiles
constexpr int TJ = 16;       // keys per tile, a multiple of 8 (the o_pair mma's k)
constexpr int STAGES = 2;
constexpr int TI_MAX = 4;    // query rows per block, at most (a multiple of 4: float4 rows of p)
constexpr int ITEMS = 2;     // o / o_pt items per thread, at most
constexpr int UNITS = 8;     // o_pair mma tiles (a row, 8 channels) per consumer warp, at most
constexpr int PAS = 24;      // floats a (row, key) of p for the mma: 16 heads, rows 8 banks apart
constexpr int MAX_HEADS = 16;
constexpr float NEG_BIG = -1e30f;
constexpr int MAX_SMEM = 232448;
static_assert(TI_MAX % 4 == 0, "p is read as float4 over query rows");

// A run of elements of one tensor: element e of run (a0, a1, a2) lies at
// p + a0 s0 + a1 s1 + a2 s2 + e es (bytes for the s*, elements for es).
// w: the cp.async width in bytes (16, 8 or 4) or 0 for element copies.
struct Run {
    const char* p;
    long long s0, s1, s2;
    int es, n, w;
};

enum { Q, K, V, QP, KP, VP, BIAS, Z, RUNS };
// The runs of a key, in the order of its parts: k, k points, v, v points.
__host__ __device__ constexpr int kv_run(int part) { return part == 0 ? K : part == 1 ? KP : part == 2 ? V : VP; }

// A contiguous span a key of up to two runs of one tensor (bulk copies).
struct Span {
    const char* p;
    long long s0, s1;
    int bytes, dst;  // its length and its place in the key's block
};

struct Dims {
    int B, N, H, C, PQ3, PV3, CZ, TI, HB;
    int NI;  // query rows (N: the keys)
    int CP, QP, VP, KVS, CQ, QS;  // padded widths in elements (CQ, QS: floats)
    // Key data: element e of part p (k, k points, v, v points) of head h and
    // key jj of a tile lies at byte jj JS + h HS[p] + OFF[p] + e sizeof(T)
    // of the stage's key area; VW[p] is the width of its vector loads.
    int JS, HS[4], OFF[4], VW[4];
    // Slot copies: the parts' slots end at kv_end[], start at kv_dst[] bytes.
    int kv_end[4], kv_dst[4];
    int z_slots, bias_slots;
    // Bulk copies: spans a key (0 where the key rows go by slots), z and
    // bias rows by one copy each.
    int spans, bulk_z, bulk_bias;
    Span span[4];
    float inf, s_pt;
    int mask_dtype, hw_dtype;
};

template <typename T>
struct Args {
    Run run[RUNS];
    const void* hw;  // softplus of the head weights, [H], float32 or bfloat16
    const void* mask;
    long long mask_sb, mask_sn;  // elements
    T* o;
    T* o_pt;
    T* o_pair;
};

// ------------------------------------------------------------------ //
// Copies
// ------------------------------------------------------------------ //

// Slot `slot` of run r of row (a0, a1, a2) into the row at dst: a w-byte
// cp.async, or for w = 0 one element read through the run's stride.
template <typename T>
__device__ __forceinline__ void copy_slot(unsigned char* dst, const Run& r, long long a0, long long a1, long long a2,
                                          int slot) {
    const char* src = r.p + a0 * r.s0 + a1 * r.s1 + a2 * r.s2;
    if (r.w) {
        const unsigned s = tc::smem_addr(dst + slot * r.w);
        src += slot * r.w;
        if (r.w == 16)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
        else if (r.w == 8)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
        else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
    } else {
        reinterpret_cast<T*>(dst)[slot] = reinterpret_cast<const T*>(src)[(long long)slot * r.es];
    }
}

template <typename T>
__device__ __forceinline__ float load_run(const Run& r, long long a0, long long a1, long long a2, int e) {
    return load_f(reinterpret_cast<const T*>(r.p + a0 * r.s0 + a1 * r.s1 + a2 * r.s2) + (long long)e * r.es);
}

// One value of a float32 / bfloat16 / int32 / int64 / bool tensor as a float.
__device__ __forceinline__ float load_any(const void* m, long long off, int dtype) {
    switch (dtype) {
        case 0: return static_cast<const float*>(m)[off];
        case 1: return __bfloat162float(static_cast<const __nv_bfloat16*>(m)[off]);
        case 2: return (float)static_cast<const int*>(m)[off];
        case 3: return (float)static_cast<const long long*>(m)[off];
        default: return (float)static_cast<const unsigned char*>(m)[off];
    }
}

// The vw / sizeof(T) values at p (vw-byte aligned) as floats, one load.
__device__ __forceinline__ void load_vec(const float* p, int vw, float (&v)[8]) {
    if (vw == 16) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else if (vw == 8) {
        const float2 a = *reinterpret_cast<const float2*>(p);
        v[0] = a.x; v[1] = a.y;
    } else {
        v[0] = *p;
    }
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, int vw, float (&v)[8]) {
    uint32_t w[4] = {0, 0, 0, 0};
    if (vw == 16) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if (vw == 8) {
        const uint2 q = *reinterpret_cast<const uint2*>(p);
        w[0] = q.x; w[1] = q.y;
    } else if (vw == 4) {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
        v[0] = __bfloat162float(*p);
        return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
        v[2 * e] = __low2float(h);
        v[2 * e + 1] = __high2float(h);
    }
}

// acc (a 16 x 8 tile: heads x channels, m16n8k8 accumulator layout) +=
// p[heads][8 keys] . z[8 keys][channels], lane (g, t): pa holds p of one
// query row as [key][PAS], z points at channel c of key 0 (z rows CZ apart),
// ok says c < Cz. float32: three TF32 products (3xTF32); bf16: p (already
// rounded to bf16) and z as they are, one bf16 product.
template <typename T>
__device__ __forceinline__ void pair_product(float (&acc)[4], const float* pa, const T* z, bool ok, int CZ, int g,
                                             int t);

template <>
__device__ __forceinline__ void pair_product<float>(float (&acc)[4], const float* pa, const float* z, bool ok,
                                                    int CZ, int g, int t) {
    // a (head g, key t) (g+8, t) (g, t+4) (g+8, t+4); b (key t, channel g) (t+4, g)
    const float av[4] = {pa[t * PAS + g], pa[t * PAS + g + 8], pa[(t + 4) * PAS + g], pa[(t + 4) * PAS + g + 8]};
    const float bv[2] = {ok ? z[t * CZ] : 0.f, ok ? z[(t + 4) * CZ] : 0.f};
    tc::Mma<float>::A fa;
    tc::Mma<float>::B fb;
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split_tf32(__float_as_uint(av[e]), fa.hi[e], fa.lo[e]);
#pragma unroll
    for (int e = 0; e < 2; ++e) tc::split_tf32(__float_as_uint(bv[e]), fb.hi[e], fb.lo[e]);
    tc::Mma<float>::mma(acc, fa, fb);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
__device__ __forceinline__ void pair_product<__nv_bfloat16>(float (&acc)[4], const float* pa,
                                                            const __nv_bfloat16* z, bool ok, int CZ, int g, int t) {
    // bf16 m16n8k8: a (head g, keys 2t, 2t+1) (g+8, ..); b (keys 2t, 2t+1, channel g)
    const uint32_t a0 = pack_bf16(pa[2 * t * PAS + g], pa[(2 * t + 1) * PAS + g]);
    const uint32_t a1 = pack_bf16(pa[2 * t * PAS + g + 8], pa[(2 * t + 1) * PAS + g + 8]);
    uint32_t b0 = 0;
    if (ok) {
        const unsigned short lo = __bfloat16_as_ushort(z[2 * t * CZ]), hi = __bfloat16_as_ushort(z[(2 * t + 1) * CZ]);
        b0 = (uint32_t)lo | ((uint32_t)hi << 16);
    }
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

// q.k and the squared point distance of one (row, key, head), k read NK
// and the key points NP values a load (C and 3 Pq multiples of them).
template <typename T, int NK, int NP>
__device__ __forceinline__ void logit_terms(const T* kr, const T* kpr, const float* qr, int C, int PQ3, int CQ,
                                            float f, float& dot, float& dist) {
    for (int dd = 0; dd < C; dd += NK) {
        float kf[8];
        load_vec(kr + dd, NK * (int)sizeof(T), kf);
#pragma unroll
        for (int u = 0; u < NK; ++u) dot += qr[dd + u] * kf[u];
    }
    for (int dd = 0; dd < PQ3; dd += NP) {
        float kf[8];
        load_vec(kpr + dd, NP * (int)sizeof(T), kf);
#pragma unroll
        for (int u = 0; u < NP; ++u) {
            const float df = qr[CQ + dd + u] - round_to<T>(kf[u] * f);
            dist += df * df;
        }
    }
}

template <typename T>
struct Smem {
    // Offsets in bytes of the block's shared-memory areas.
    int kv, z, bias, stage, q, PO, PA, m, alpha, f, bar, mask, total;
    __host__ __device__ Smem(const Dims& d, int TI) {
        const int es = sizeof(T);
        // A key's room: its slot rows, or its bulk block (16 bytes more at most).
        const int kvb = TJ * (d.H * d.KVS * es + 16), zb = TI * TJ * d.CZ * es, bb = TI * TJ * d.H * es;
        kv = 0;
        z = (kvb + 15) / 16 * 16;
        bias = (z + zb + 15) / 16 * 16;
        stage = (bias + bb + 15) / 16 * 16;
        q = STAGES * stage;
        PO = q + TI * d.H * d.QS * 4;
        PA = PO + d.HB * TJ * TI_MAX * 4;
        m = PA + TI * TJ * PAS * 4;
        alpha = m + TI * d.HB * 4;
        f = alpha + TI * d.HB * 4;
        bar = (f + d.HB * 4 + 7) / 8 * 8;
        mask = bar + 2 * STAGES * 8;
        total = mask + (d.N + 3) / 4 * 16;
    }
};

// ------------------------------------------------------------------ //
// The kernel
// ------------------------------------------------------------------ //

template <typename T, int HB>
__global__ void __launch_bounds__(THREADS, 1) ipa_kernel(const __grid_constant__ Args<T> a, const __grid_constant__ Dims d) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = d.N, NI = d.NI, H = d.H, C = d.C, CZ = d.CZ, TI = d.TI;
    const int es = sizeof(T);
    const Smem<T> L(d, TI);
    float* q_s = reinterpret_cast<float*>(smem + L.q);      // [TI][H][QS]: q, then points at CQ
    float* PO = reinterpret_cast<float*>(smem + L.PO);      // [HB][TJ][TI_MAX] p, for o and o_pt
    float* PA = reinterpret_cast<float*>(smem + L.PA);      // [TI][TJ][PAS] p rounded to T, for o_pair
    float* m_s = reinterpret_cast<float*>(smem + L.m);      // [TI][HB] running max
    float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);
    float* f_s = reinterpret_cast<float*>(smem + L.f);      // [H] point scale sqrt(w_h s_pt)
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // [STAGES] a tile has landed
    uint64_t* empty = full + STAGES;                              // [STAGES] ... and been read
    float* mask_s = reinterpret_cast<float*>(smem + L.mask);  // [N]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y;
    const int i0 = blockIdx.x * TI;
    const float sqk = sqrtf(1.f / (3.f * C)), sbias = sqrtf(1.f / 3.f);
    // Zero the stages: keys past N are never copied, and their (finite)
    // values meet p = 0. The fence orders these stores before the bulk
    // copies' writes.
    for (int e = tid; e < STAGES * L.stage / 16; e += THREADS) reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
    tc::fence_proxy_async();
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            tc::mbar_init(&full[s], 1);
            tc::mbar_init(&empty[s], CONSUMERS / 32);
        }
        tc::mbar_init_fence();
    }
    for (int j = tid; j < N; j += THREADS) mask_s[j] = load_any(a.mask, b * a.mask_sb + j * a.mask_sn, d.mask_dtype);
    for (int h = tid; h < H; h += THREADS) f_s[h] = sqrtf(load_any(a.hw, h, d.hw_dtype) * d.s_pt);
    __syncthreads();  // f_s, the barriers
    for (int e = tid; e < TI * H * d.QS; e += THREADS) {
        const int dd = e % d.QS, h = (e / d.QS) % H, r = e / (d.QS * H);
        const int i = min(i0 + r, NI - 1);
        float val = 0.f;
        if (dd < C)
            val = load_run<T>(a.run[Q], b, i, h, dd);
        else if (dd >= d.CQ && dd < d.CQ + d.PQ3)
            val = round_to<T>(load_run<T>(a.run[QP], b, i, h, dd - d.CQ) * f_s[h]);
        q_s[e] = val;
    }
    for (int e = tid; e < TI * HB; e += THREADS) {
        m_s[e] = NEG_BIG;
        alpha_s[e] = 1.f;
    }
    for (int e = tid; e < TI * TJ * PAS; e += THREADS) PA[e] = 0.f;  // heads past H stay 0

    __syncthreads();  // q_s, the statistics

    const int KT = (N + TJ - 1) / TJ;
    if (warp == CONSUMERS / 32) {
        // The producer warp: tile t into stage t % STAGES once the consumers
        // have read what it held. Bulk copies where the layouts allow them,
        // lane by lane, on the stage's full barrier; the rest by cp.async
        // slots, waited for here; then lane 0 arrives with the bulk bytes.
        for (int t = 0; t < KT; ++t) {
            const int s = t % STAGES;
            if (t >= STAGES) tc::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
            unsigned char* base = smem + s * L.stage;
            const int j0 = t * TJ, n_keys = min(TJ, N - j0);
            int bytes = 0;
            const int kv_jobs = d.spans * TJ;
            // A partial last tile's bias rows may not be whole 16-byte chunks.
            const bool bias_bulk = d.bulk_bias && (n_keys * H * es) % 16 == 0;
            for (int job = lane; job < kv_jobs + 2 * TI; job += 32) {
                if (job < kv_jobs) {
                    const int jj = job / d.spans, g = job % d.spans;
                    const Span& sp = d.span[g];
                    if (jj < n_keys)
                        tc::bulk_copy(base + L.kv + jj * d.JS + sp.dst, sp.p + b * sp.s0 + (j0 + jj) * sp.s1,
                                      sp.bytes, &full[s]);
                } else {
                    const int r = (job - kv_jobs) % TI, which = (job - kv_jobs) / TI;  // 0 z, 1 bias
                    const int i = min(i0 + r, NI - 1);
                    const Run& rr = a.run[which ? BIAS : Z];
                    if (which ? bias_bulk : d.bulk_z)
                        tc::bulk_copy(base + (which ? L.bias + r * TJ * H * es : L.z + r * TJ * CZ * es),
                                      rr.p + b * rr.s0 + i * rr.s1 + j0 * rr.s2, n_keys * (which ? H : CZ) * es,
                                      &full[s]);
                }
            }
            for (int g = 0; g < d.spans; ++g) bytes += n_keys * d.span[g].bytes;
            if (d.bulk_z) bytes += TI * n_keys * CZ * es;
            if (bias_bulk) bytes += TI * n_keys * H * es;
            if (!d.spans) {
                for (int row = 0; row < TJ * H; ++row) {
                    const int jj = row % TJ, h = row / TJ;
                    if (jj >= n_keys) continue;
                    unsigned char* dst = base + L.kv + row * d.KVS * es;
                    for (int slot = lane; slot < d.kv_end[3]; slot += 32) {
                        const int part = slot < d.kv_end[0] ? 0 : slot < d.kv_end[1] ? 1 : slot < d.kv_end[2] ? 2 : 3;
                        const int first = part ? d.kv_end[part - 1] : 0;
                        copy_slot<T>(dst + d.kv_dst[part], a.run[kv_run(part)], b, j0 + jj, h, slot - first);
                    }
                }
            }
            if (!d.bulk_z || !bias_bulk) {
                for (int row = 0; row < TI * TJ; ++row) {
                    const int jj = row % TJ, i = min(i0 + row / TJ, NI - 1);
                    if (jj >= n_keys) continue;
                    if (!d.bulk_z)
                        for (int slot = lane; slot < d.z_slots; slot += 32)
                            copy_slot<T>(base + L.z + row * CZ * es, a.run[Z], b, i, j0 + jj, slot);
                    if (!bias_bulk)
                        for (int slot = lane; slot < d.bias_slots; slot += 32)
                            copy_slot<T>(base + L.bias + row * H * es, a.run[BIAS], b, i, j0 + jj, slot);
                }
            }
            tc::cp_async_commit();
            tc::cp_async_wait<0>();
            __syncwarp();
            if (lane == 0) tc::mbar_expect_tx(&full[s], bytes);  // the arrival; bytes may be 0
        }
        return;
    }

    // o_pair on the tensor cores: a consumer warp owns units u = warp + 15 k
    // (a query row r, 8 channels c0..), each one m16n8k8 tile: heads (16,
    // those past H zero) x channels, summed over the 8 keys of a tile.
    const int NTZ = (CZ + 7) / 8, units = TI * NTZ;
    const int g = lane >> 2, tq = lane & 3;
    float acc_z[UNITS][4];
#pragma unroll
    for (int k = 0; k < UNITS; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_z[k][e] = 0.f;
    // o / o_pt / denominator items: (head, column), all rows.
    // o / o_pt / denominator: (head, column), all rows; column DV is ones.
    const int DV = C + d.PV3;
    bool od_on[ITEMS];
    int od_h[ITEMS], od_d[ITEMS], od_off[ITEMS];
    float acc_o[ITEMS][TI_MAX];
    // Items past the first CONSUMERS go to the last warp, which owns the
    // fewest o_pair tiles.
    const int od_first = (tid + 32) % CONSUMERS;
#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
        const int w = od_first + m * CONSUMERS;
        od_on[m] = w < H * (DV + 1);
        od_h[m] = od_on[m] ? w / (DV + 1) : 0;
        od_d[m] = od_on[m] ? w % (DV + 1) : 0;
        // Its byte in a key's block: part v (2) or v points (3).
        const int part = od_d[m] < C ? 2 : 3, e = od_d[m] < C ? od_d[m] : od_d[m] - C;
        od_off[m] = od_h[m] * d.HS[part] + d.OFF[part] + e * es;
#pragma unroll
        for (int r = 0; r < TI_MAX; ++r) acc_o[m][r] = 0.f;
    }

    // The consumer warps. Their own barrier (1) orders the reads of PO, PA
    // and alpha_s of one tile before the next tile's logits rewrite them.
    auto consumers_sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory"); };
    for (int t = 0; t < KT; ++t) {
        tc::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
        consumers_sync();

        const unsigned char* base = smem + (t % STAGES) * L.stage;
        const unsigned char* kv = base + L.kv;
        const T* zs = reinterpret_cast<const T*>(base + L.z);
        const T* bs = reinterpret_cast<const T*>(base + L.bias);
        const int j0 = t * TJ, n_keys = min(TJ, N - j0);

        // Logits and softmax: TJ lanes a (row, head), one key each; the
        // tile's max by shuffles, then the exponentials.
        for (int e = tid; e < TI * HB * TJ; e += CONSUMERS) {
            const int jj = e % TJ, h = (e / TJ) % HB, r = e / (TJ * HB);
            float s = NEG_BIG;
            if (h < H && jj < n_keys) {
                const float* qr = q_s + (r * H + h) * d.QS;
                const T* kr = reinterpret_cast<const T*>(kv + jj * d.JS + h * d.HS[0] + d.OFF[0]);
                const T* kpr = reinterpret_cast<const T*>(kv + jj * d.JS + h * d.HS[1] + d.OFF[1]);
                const float f = f_s[h];
                float dot = 0.f, dist = 0.f;
                const int nk = d.VW[0] / es, np = d.VW[1] / es;
                if (nk == 16 / es && np == 4) {  // the main path's widths: loads of fixed size
                    logit_terms<T, 16 / (int)sizeof(T), 4>(kr, kpr, qr, C, d.PQ3, d.CQ, f, dot, dist);
                } else {
                for (int dd = 0; dd < C; dd += nk) {
                    float kf[8];
                    load_vec(kr + dd, d.VW[0], kf);
#pragma unroll
                    for (int u = 0; u < 8; ++u)
                        if (u < nk) dot += qr[dd + u] * kf[u];
                }
                for (int dd = 0; dd < d.PQ3; dd += np) {
                    float kf[8];
                    load_vec(kpr + dd, d.VW[1], kf);
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        if (u < np) {
                            const float df = qr[d.CQ + dd + u] - round_to<T>(kf[u] * f);
                            dist += df * df;
                        }
                    }
                }
                }
                s = sqk * dot + sbias * load_f(bs + (r * TJ + jj) * H + h) - 0.5f * dist
                    + d.inf * (mask_s[j0 + jj] - 1.f);
            }
            const float m_old = h < H ? m_s[r * HB + h] : NEG_BIG;
            float m_tile = s;
#pragma unroll
            for (int off = 1; off < TJ; off <<= 1) m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
            __syncwarp();  // every lane has read m_old before it is rewritten
            if (h < H) {
                const float m_new = fmaxf(m_old, m_tile);
                const float p = expf(s - m_new);
                PO[(h * TJ + jj) * TI_MAX + r] = p;
                PA[(r * TJ + jj) * PAS + h] = round_to<T>(p);
                if (jj == 0) {
                    m_s[r * HB + h] = m_new;
                    alpha_s[r * HB + h] = expf(m_old - m_new);
                }
            }
        }
        consumers_sync();

        // Sums.
        // o_pair: each unit's tile rescaled, then p (heads x keys) times z
        // (keys x channels). p is 0 for keys past N, and so are z's
        // channels past Cz here.
#pragma unroll
        for (int k = 0; k < UNITS; ++k) {
            const int u = warp + k * (CONSUMERS / 32);
            if (u >= units) break;
            const int r = u / NTZ, c = (u % NTZ) * 8 + g;
            const float al0 = g < H ? alpha_s[r * HB + g] : 0.f, al1 = g + 8 < H ? alpha_s[r * HB + g + 8] : 0.f;
            acc_z[k][0] *= al0;
            acc_z[k][1] *= al0;
            acc_z[k][2] *= al1;
            acc_z[k][3] *= al1;
#pragma unroll
            for (int k8 = 0; k8 < TJ; k8 += 8)
                pair_product<T>(acc_z[k], PA + (r * TJ + k8) * PAS, zs + (r * TJ + k8) * CZ + c, c < CZ, CZ, g, tq);
        }
#pragma unroll
        for (int m = 0; m < ITEMS; ++m) {
            if (od_on[m]) {
                const int h = od_h[m];
                const bool ones = od_d[m] == DV;
#pragma unroll
                for (int r = 0; r < TI_MAX; ++r)
                    if (r < TI) acc_o[m][r] *= alpha_s[r * HB + h];
#pragma unroll
                for (int jj = 0; jj < TJ; ++jj) {
                    const float val = ones ? 1.f : load_f(reinterpret_cast<const T*>(kv + jj * d.JS + od_off[m]));
                    const float4* p4 = reinterpret_cast<const float4*>(PO + (h * TJ + jj) * TI_MAX);
#pragma unroll
                    for (int r4 = 0; r4 < TI_MAX / 4; ++r4) {
                        if (4 * r4 >= TI) break;
                        const float4 pv = p4[r4];
                        acc_o[m][4 * r4 + 0] += pv.x * val;
                        acc_o[m][4 * r4 + 1] += pv.y * val;
                        acc_o[m][4 * r4 + 2] += pv.z * val;
                        acc_o[m][4 * r4 + 3] += pv.w * val;
                    }
                }
            }
        }
        // The stage is read: the producer may refill it.
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(&empty[t % STAGES]);
    }

    // The denominators into PO (free now), then every output divided by them.
    consumers_sync();
    float* l_s = PO;  // [TI][HB]
#pragma unroll
    for (int m = 0; m < ITEMS; ++m)
        if (od_on[m] && od_d[m] == DV)
#pragma unroll
            for (int r = 0; r < TI_MAX; ++r)
                if (r < TI) l_s[r * HB + od_h[m]] = acc_o[m][r];
    consumers_sync();

    const size_t bN = (size_t)b * NI;  // the outputs' rows of sample b
#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
        if (od_on[m] && od_d[m] < DV) {
            const int h = od_h[m], dd = od_d[m];
#pragma unroll
            for (int r = 0; r < TI_MAX; ++r) {
                const int i = i0 + r;
                if (r >= TI || i >= NI) continue;
                const T val = Cvt<T>::from_f(acc_o[m][r] / fmaxf(l_s[r * HB + h], 1e-20f));
                const size_t ih = (bN + i) * H + h;
                if (dd < C)
                    a.o[ih * C + dd] = val;
                else
                    a.o_pt[ih * d.PV3 + dd - C] = val;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
        const int u = warp + k * (CONSUMERS / 32);
        if (u >= units) break;
        const int r = u / NTZ, c = (u % NTZ) * 8 + 2 * tq;
        if (i0 + r >= NI) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int h = g + 8 * (e >> 1), cc = c + (e & 1);
            if (h < H && cc < CZ)
                a.o_pair[((bN + i0 + r) * H + h) * CZ + cc] =
                    Cvt<T>::from_f(acc_z[k][e] / fmaxf(l_s[r * HB + h], 1e-20f));
        }
    }
}

// ------------------------------------------------------------------ //
// Host side
// ------------------------------------------------------------------ //

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The widest cp.async (16, 8, 4 bytes) that every run of `r` allows, or 0.
int copy_width(const Run& r, int esize) {
    if (r.es != 1) return 0;
    for (int w = 16; w >= 4; w /= 2) {
        const bool ok = (uintptr_t)r.p % w == 0 && (r.n * esize) % w == 0 && r.s0 % w == 0 && r.s1 % w == 0
                        && r.s2 % w == 0;
        if (ok) return w;
    }
    return 0;
}

// The widest load (16, 8, 4 bytes, or one element) that divides every
// value of `bytes`.
int load_width(std::initializer_list<long long> bytes, int esize) {
    for (int w = 16; w > esize; w /= 2) {
        bool ok = true;
        for (long long v : bytes) ok = ok && v % w == 0;
        if (ok) return w;
    }
    return esize;
}

// Key rows as bulk copies: per key one span of the k and v runs and one of
// the two point sets where each pair lies in one tensor (else a span a
// run), every span 16-byte aligned and a multiple of 16 bytes, and the
// key's block at most 16 bytes larger than the slot layout's share. Fills d.span, d.JS,
// d.HS and d.OFF; returns false where the key rows must go by slots.
bool plan_spans(const Run* run, Dims& d, int es) {
    const int pairs[2][2] = {{0, 2}, {1, 3}};  // (k, v), (k points, v points)
    const int lens[4] = {d.C, d.PQ3, d.C, d.PV3};
    int n = 0, pos = 0;
    auto add = [&](std::initializer_list<int> ps) {
        const Run& r0 = run[kv_run(*ps.begin())];
        long long lo = 0, hi = 0;
        bool first = true;
        for (int p : ps) {
            const Run& r = run[kv_run(p)];
            if (r.es != 1 || r.s0 != r0.s0 || r.s1 != r0.s1 || r.s2 != r0.s2 || r.s2 < 0) return false;
            const long long at = r.p - r0.p, end = at + (long long)lens[p] * es;
            lo = first ? at : (at < lo ? at : lo);
            hi = first ? end : (end > hi ? end : hi);
            first = false;
        }
        const long long bytes = (long long)(d.H - 1) * r0.s2 + (hi - lo);
        const char* p = r0.p + lo;
        if ((uintptr_t)p % 16 || r0.s0 % 16 || r0.s1 % 16 || bytes % 16) return false;
        d.span[n] = Span{p, r0.s0, r0.s1, (int)bytes, pos};
        for (int q : ps) {
            d.HS[q] = (int)r0.s2;
            d.OFF[q] = pos + (int)(run[kv_run(q)].p - p);
        }
        pos += (int)bytes;
        ++n;
        return true;
    };
    for (const auto& pair : pairs) {
        const Run& a0 = run[kv_run(pair[0])];
        const Run& a1 = run[kv_run(pair[1])];
        const long long gap = a1.p - a0.p;
        const bool one = a0.s2 == a1.s2 && gap > -a0.s2 && gap < a0.s2;
        if (one ? !add({pair[0], pair[1]}) : !(add({pair[0]}) && add({pair[1]}))) return false;
    }
    int js = pos;
    if ((js / 16) % 2 == 0) js += 16;  // keys an odd number of 16-byte chunks apart
    if (js > d.H * d.KVS * es + 16) return false;
    d.spans = n;
    d.JS = js;
    return true;
}

template <typename T, int HB>
int launch_hb(Args<T> a, Dims d, cudaStream_t stream) {
    // Query rows per block: the most (at most TI_MAX) that keep rows x Cz
    // within the accumulator items and the block within shared memory.
    int ti = TI_MAX;
    auto fits = [&](int t) { return t * ((d.CZ + 7) / 8) <= UNITS * (CONSUMERS / 32) && Smem<T>(d, t).total <= MAX_SMEM; };
    while (ti > 1 && !fits(ti)) ti /= 2;
    d.TI = ti;
    const int smem = Smem<T>(d, ti).total;
    if (!fits(ti)) return (int)cudaErrorInvalidValue;
    // The shared-memory allowance, set once per device: a host call the
    // main path would otherwise pay at every launch.
    constexpr int MAX_DEVICES = 64;
    static bool allowed[MAX_DEVICES];
    auto kernel = ipa_kernel<T, HB>;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!allowed[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        allowed[dev] = true;
    }
    const dim3 grid((d.NI + ti - 1) / ti, d.B);
    kernel<<<grid, THREADS, smem, stream>>>(a, d);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* ptr, const long long* st, const int* dims, float inf, float s_pt, int mask_dtype,
           int hw_dtype, cudaStream_t stream) {
    const int B = dims[0], N = dims[1], H = dims[2], C = dims[3], PQ = dims[4], PV = dims[5], CZ = dims[6];
    const int es = sizeof(T), V = 16 / es;
    // Runs: q, k, v (C values), the three point sets (3 P values), bias (H
    // values along h), z (CZ values along the channel); strides in
    // elements: (batch, row, head or j, element) per tensor.
    auto run = [&](int n, int len) {
        const long long* s = st + 4 * n;
        Run r{static_cast<const char*>(ptr[n]), s[0] * es, s[1] * es, s[2] * es, (int)s[3], len, 0};
        r.w = copy_width(r, es);
        return r;
    };
    Args<T> a;
    const int lens[RUNS] = {C, C, C, 3 * PQ, 3 * PQ, 3 * PV, H, CZ};
    for (int n = 0; n < RUNS; ++n) a.run[n] = run(n, lens[n]);
    a.hw = ptr[8];
    a.mask = ptr[9];
    a.mask_sb = st[32];
    a.mask_sn = st[33];
    a.o = static_cast<T*>(const_cast<void*>(ptr[10]));
    a.o_pt = static_cast<T*>(const_cast<void*>(ptr[11]));
    a.o_pair = static_cast<T*>(const_cast<void*>(ptr[12]));

    Dims d{};
    d.B = B; d.N = N; d.NI = dims[7]; d.H = H; d.C = C; d.PQ3 = 3 * PQ; d.PV3 = 3 * PV; d.CZ = CZ;
    d.HB = 4 * ((H + 3) / 4);
    // The slot layout: key rows [h][jj] of [k CP][k points QP][v CP][v
    // points VP], runs on 16 bytes, rows an odd number of 16-byte chunks
    // apart.
    d.CP = round_up(C, V);
    d.QP = round_up(3 * PQ, V);
    d.VP = round_up(3 * PV, V);
    d.KVS = 2 * d.CP + d.QP + d.VP;
    if ((d.KVS / V) % 2 == 0) d.KVS += V;
    d.CQ = round_up(C, 4);
    d.QS = d.CQ + round_up(3 * PQ, 4);
    auto slots = [&](const Run& r) { return r.w ? r.n * es / r.w : r.n; };
    const int dst[4] = {0, d.CP, d.CP + d.QP, 2 * d.CP + d.QP};
    for (int p = 0, end = 0; p < 4; ++p) {
        end += slots(a.run[kv_run(p)]);
        d.kv_end[p] = end;
        d.kv_dst[p] = dst[p] * es;
    }
    d.z_slots = slots(a.run[Z]);
    d.bias_slots = slots(a.run[BIAS]);
    if (!plan_spans(a.run, d, es)) {
        d.spans = 0;
        d.JS = d.KVS * es;
        for (int p = 0; p < 4; ++p) {
            d.HS[p] = TJ * d.KVS * es;
            d.OFF[p] = d.kv_dst[p];
        }
    }
    for (int p = 0; p < 4; ++p)
        d.VW[p] = load_width({d.JS, d.HS[p], d.OFF[p], (long long)(p == 1 ? 3 * PQ : C) * es}, es);
    // z and bias rows as one bulk copy each: contiguous along the keys,
    // 16-byte aligned, a tile of keys a multiple of 16 bytes.
    const Run& zr = a.run[Z];
    const Run& br = a.run[BIAS];
    d.bulk_z = zr.es == 1 && zr.s2 == (long long)CZ * es && (CZ * es) % 16 == 0 && (uintptr_t)zr.p % 16 == 0
               && zr.s0 % 16 == 0 && zr.s1 % 16 == 0;
    d.bulk_bias = br.es == 1 && br.s2 == (long long)H * es && (TJ * H * es) % 16 == 0 && (uintptr_t)br.p % 16 == 0
                  && br.s0 % 16 == 0 && br.s1 % 16 == 0;
    d.inf = inf;
    d.s_pt = s_pt;
    d.mask_dtype = mask_dtype;
    d.hw_dtype = hw_dtype;
    if (d.HB <= 4) return launch_hb<T, 4>(a, d, stream);
    if (d.HB <= 8) return launch_hb<T, 8>(a, d, stream);
    if (d.HB <= 12) return launch_hb<T, 12>(a, d, stream);
    return launch_hb<T, 16>(a, d, stream);
}

}  // namespace

// ptr: q [B,NI,H,C], k, v [B,N,H,C]; q_pts [B,NI,H,PQ,3], k_pts
// [B,N,H,PQ,3]; v_pts [B,N,H,PV,3]; bias [B,NI,N,H]; z [B,NI,N,CZ] (all of
// dtype 0 = float32 or 1 = bfloat16); head_weights [H] (softplus applied)
// of hw_dtype and mask [B,N] of mask_dtype (0 float32, 1 bfloat16, 2
// int32, 3 int64, 4 bool / uint8); then the outputs o [B,NI,H,C], o_pt
// [B,NI,H,PV,3], o_pair [B,NI,H,CZ], contiguous, of the activation dtype.
// strides: element strides, four a tensor for the first eight (q, k, v:
// batch, row, head, channel; points: batch, row, head, coordinate, the 3 P
// values of a head one run of that stride; bias: batch, i, j, head; z:
// batch, i, j, channel), then the mask's batch and row strides.
// dims: B, N, H, C, PQ, PV, CZ, NI. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int ipa_attention(const void* const* ptr, const long long* strides, const int* dims, float inf,
                             float s_pt, int dtype, int mask_dtype, int hw_dtype, void* stream) {
    const int B = dims[0], N = dims[1], H = dims[2], C = dims[3], PQ = dims[4], PV = dims[5], CZ = dims[6];
    if (B < 1 || B > 65535 || N < 1 || dims[7] < 1 || H < 1 || H > MAX_HEADS || C < 1 || PQ < 1 || PV < 1 || CZ < 1
        || (CZ + 7) / 8 > UNITS * (CONSUMERS / 32) || H * (C + 3 * PV + 1) > ITEMS * CONSUMERS || mask_dtype < 0
        || mask_dtype > 4
        || hw_dtype < 0 || hw_dtype > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(ptr, strides, dims, inf, s_pt, mask_dtype, hw_dtype, s);
    if (dtype == 1) return launch<__nv_bfloat16>(ptr, strides, dims, inf, s_pt, mask_dtype, hw_dtype, s);
    return (int)cudaErrorInvalidValue;
}

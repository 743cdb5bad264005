// Tensor-core and asynchronous-copy helpers of the product kernels: 16-, 8-
// and 4-byte cp.async copies that zero-fill what lies past an edge, bulk
// copies of the tensor memory accelerator in both directions with the
// mbarriers that complete them, the ranks, barriers and distributed shared
// memory of thread-block clusters, mma.sync tiles with float32 accumulators
// (m16n8k8 TF32, m16n8k16 bf16), and the fragment loads of both from
// shared-memory tiles stored either way round.
//
// float32 operands take three TF32 products (3xTF32): x = hi + lo with hi
// and lo both TF32 values, and a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi up
// to about 2^-20 relative. One TF32 product keeps 11 bits and over K = 256 terms
// errs by about 3e-4 of the largest result, outside the 1e-4 float32
// tolerance; three keep it near 1e-6 (tests/test_torch_trimul.py shows
// both on the CPU). bf16 operands go to the tensor cores as they are: their
// products are exact in the float32 accumulator.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

// ------------------------------------------------------------------ //
// Asynchronous copies
// ------------------------------------------------------------------ //

// 16 bytes into shared memory: the first src_bytes (0 or 16 here) from
// src, the rest zero. src must be a valid address even when nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes into shared memory, the same way (src_bytes 0 or 4).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// 8 bytes into shared memory, the same way (src_bytes 0 or 8).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ //
// Bulk copies (the tensor memory accelerator) and mbarriers
// ------------------------------------------------------------------ //

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (the bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` (0 or more) of bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT_%=;\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the tensor memory accelerator; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Orders this thread's earlier shared-memory accesses before later bulk
// copies (the async proxy): a writer of a tile that a bulk store reads
// executes it before the barrier that hands the tile over.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// `bytes` (a multiple of 16) from shared src to global dst, both 16-byte
// aligned, in this thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_addr(src)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's bulk groups are still reading their
// shared-memory sources (READ) or still writing at all.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
    if constexpr (READ)
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
    else
        asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ //
// Thread-block clusters: ranks, barriers, distributed shared memory
// ------------------------------------------------------------------ //

// This block's rank in its cluster, the cluster's blocks, the cluster's
// index in the grid and the grid's clusters.
__device__ __forceinline__ int cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ int cluster_blocks() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ int cluster_index() {
    unsigned r;
    asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ int cluster_count() {
    unsigned r;
    asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }
// The address of `p` (in this block's shared memory) in block `rank`'s, for ld_remote.
__device__ __forceinline__ unsigned remote(const void* p, int rank) {
    unsigned a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
    return a;
}
// No memory clobber: the cluster barriers, volatile too, keep these loads
// between them, and other loads may move across them.
__device__ __forceinline__ float ld_remote(unsigned addr) {
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
    return v;
}

// ------------------------------------------------------------------ //
// Tensor-core products
// ------------------------------------------------------------------ //

// x = hi + lo to 2^-20 |x|, two instructions: hi is x cut to TF32 (its
// low 13 bits cleared), so x - hi is exact and below one TF32 ulp of x; lo
// is that rest as float32, which the tensor cores, reading only the top 19
// bits of a TF32 operand, cut to TF32 in turn.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
    hi = x & 0xffffe000u;
    lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// Four 8 x 8 matrices of 16-bit values (or 8 x 4 of 32-bit) from shared
// memory: lane i gives the address of row i % 8 of matrix i / 8 (16 bytes,
// aligned); r[m] is lane l's pair (row l / 4, pair l % 4) of matrix m, or
// with .trans, the pair (rows 2 (l % 4) and 2 (l % 4) + 1, column l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}
// Two matrices: lanes 0-15 give the addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// c += a.b for a 16 x 8 tile over k = 8 (TF32) or k = 16 (bf16).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand tile in shared memory, indexed by (row, k) where the row is
// the product's M (for A) or N (for B) index. KMAJOR: k is contiguous,
// p[row * ld + k]; otherwise the row is, p[k * ld + row]. Rows (k-major) or
// k rows (m-major) start on 16 bytes, and ld * sizeof(T) is an odd multiple
// of 16 bytes, so the eight rows of an ldmatrix matrix fall in distinct banks.
template <typename T, bool KMAJOR>
struct Tile {
    const T* p;
    int ld;

    __device__ __forceinline__ const T* at(int row, int k) const { return KMAJOR ? p + row * ld + k : p + k * ld + row; }
    __device__ __forceinline__ uint32_t bits(int row, int k) const {
        return *reinterpret_cast<const uint32_t*>(at(row, k));
    }
};

// Fragments of one k step and the product. The PTX ISA's mma fragment
// layouts, with g = lane / 4 and t = lane % 4:
//   TF32 m16n8k8   a: (g, t) (g+8, t) (g, t+4) (g+8, t+4)   b: (k t, n g) (k t+4, n g)
//   bf16 m16n8k16  a: (g, 2t) (g+8, 2t) (g, 2t+8) (g+8, 2t+8), pairs along k
//                  b: (k 2t, n g) (k 2t+8, n g), pairs along k
// which are ldmatrix's (trans for m-major bf16) but for m-major float32,
// loaded by index.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
    static constexpr int KSTEP = 8;
    struct A {
        uint32_t hi[4], lo[4];
    };
    struct B {
        uint32_t hi[2], lo[2];
    };

    template <bool KM>
    static __device__ __forceinline__ void load_a(A& f, const Tile<float, KM>& v, int m0, int k0, int lane) {
        uint32_t r[4];
        if constexpr (KM) {
            const int i = lane & 7, m = lane >> 3;
            ldmatrix_x4(r, v.at(m0 + i + 8 * (m & 1), k0 + 4 * (m >> 1)));
        } else {
            const int g = lane >> 2, t = lane & 3;
            r[0] = v.bits(m0 + g, k0 + t);
            r[1] = v.bits(m0 + g + 8, k0 + t);
            r[2] = v.bits(m0 + g, k0 + t + 4);
            r[3] = v.bits(m0 + g + 8, k0 + t + 4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(r[e], f.hi[e], f.lo[e]);
    }

    static __device__ __forceinline__ void load_b(B& f, const Tile<float, true>& v, int n0, int k0, int lane) {
        uint32_t r[2];
        const int i = lane & 7, m = (lane >> 3) & 1;
        ldmatrix_x2(r, v.at(n0 + i, k0 + 4 * m));
        split_tf32(r[0], f.hi[0], f.lo[0]);
        split_tf32(r[1], f.hi[1], f.lo[1]);
    }
    static __device__ __forceinline__ void load_b(B& f, const Tile<float, false>& v, int n0, int k0, int lane) {
        const int g = lane >> 2, t = lane & 3;
        split_tf32(v.bits(n0 + g, k0 + t), f.hi[0], f.lo[0]);
        split_tf32(v.bits(n0 + g, k0 + t + 4), f.hi[1], f.lo[1]);
    }

    // The small terms first, then hi.hi.
    static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
        mma_tf32(c, a.lo, b.hi);
        mma_tf32(c, a.hi, b.lo);
        mma_tf32(c, a.hi, b.hi);
    }
};

template <>
struct Mma<__nv_bfloat16> {
    static constexpr int KSTEP = 16;
    struct A {
        uint32_t r[4];
    };
    struct B {
        uint32_t r[2];
    };

    template <bool KM>
    static __device__ __forceinline__ void load_a(A& f, const Tile<__nv_bfloat16, KM>& v, int m0, int k0, int lane) {
        const int i = lane & 7, m = lane >> 3;
        if constexpr (KM)
            ldmatrix_x4(f.r, v.at(m0 + i + 8 * (m & 1), k0 + 8 * (m >> 1)));
        else
            ldmatrix_x4_trans(f.r, v.at(m0 + 8 * (m & 1), k0 + i + 8 * (m >> 1)));
    }

    template <bool KM>
    static __device__ __forceinline__ void load_b(B& f, const Tile<__nv_bfloat16, KM>& v, int n0, int k0, int lane) {
        const int i = lane & 7, m = (lane >> 3) & 1;
        if constexpr (KM)
            ldmatrix_x2(f.r, v.at(n0 + i, k0 + 8 * m));
        else
            ldmatrix_x2_trans(f.r, v.at(n0, k0 + i + 8 * m));
    }

    static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) { mma_bf16(c, a.r, b.r); }
};

// c[n] += a . b[n] for NT tiles that share one A fragment, with consecutive
// mma.sync independent of each other: in float32 the small terms of every
// tile, then every hi.hi (each c[n] summed in Mma<float>::mma's order, so
// the result is the same), where Mma<float>::mma tile by tile waits for
// each of its three products before the next.
template <int NT>
__device__ __forceinline__ void mma_tiles(float (&c)[NT][4], const Mma<float>::A& a, const Mma<float>::B (&b)[NT]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], a.lo, b[n].hi);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], a.hi, b[n].lo);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], a.hi, b[n].hi);
}
template <int NT>
__device__ __forceinline__ void mma_tiles(float (&c)[NT][4], const Mma<__nv_bfloat16>::A& a,
                                          const Mma<__nv_bfloat16>::B (&b)[NT]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_bf16(c[n], a.r, b[n].r);
}

// Two adjacent output values (columns 2t, 2t + 1 of an accumulator row).
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace tc

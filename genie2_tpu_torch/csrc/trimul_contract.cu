// trimul_contract: the per-channel triangle contraction on channel-major
// operands, a batched (B*H) N x N x N product with float32 accumulation,
// on the tensor cores.
//
// Replaces genie2_tpu/ops/trimul_fused.py:176 contract_cm_fullk (Pallas
// kernels _contract_kernel_out, :159, and _contract_kernel_in, :167):
//   outgoing: x[b,h,i,j] = sum_k a[b,h,i,k] b[b,h,j,k]
//   incoming: x[b,h,i,j] = sum_k a[b,h,k,i] b[b,h,k,j]
//
// Work at the main path's shapes (B=2, N=256, H=128): 8.6 GFLOP; reads
// 134 MB of a and b, writes 67 MB in float32. On the H100 that is 0.060 ms
// of bytes at 3.35 TB/s against 0.052 ms for three TF32 products at 495
// TFLOP/s: bound by bytes (bf16: half the bytes, one product at 989).
//
// Design (csrc/contract_tile.cuh, shared with csrc/triangle_contract.cu):
// one block of 8 warps per 128 x 128 output tile of one (b, h), k walked 64
// at a time through a three-stage cp.async ring, mma.sync with 3xTF32 for
// float32; the operands are staged in their own layout (outgoing: [row][k],
// k contiguous; incoming: [k][row]), so one code path serves both
// directions. wgmma is left out: it takes TF32 operands only k-major, which
// the incoming direction is not.

#include "contract_tile.cuh"

// a, b, out: [BH, N, N] of dtype 0 = float32 or 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int trimul_contract(const void* a, const void* b, void* out, int BH, int N, int outgoing,
                               int dtype, void* stream) {
    if (BH < 1 || BH > 65535 || N < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long plane = (long long)N * N;
    auto run = [&](auto zero) -> int {
        using T = decltype(zero);
        ctile::Params<T> p{static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), N, 1,
                           plane, 0, N, plane, 0, N, plane, 0, N, 1, 0};
        p.vec = ctile::vec_ok(p);
        // outgoing: both operands [row][k]; incoming: both [k][row].
        return outgoing ? ctile::launch<T, true, true>(p, BH, s) : ctile::launch<T, false, false>(p, BH, s);
    };
    if (dtype == 0) return run(0.f);
    if (dtype == 1) return run(__float2bfloat16(0.f));
    return (int)cudaErrorInvalidValue;
}

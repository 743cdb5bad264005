// trimul_contract: the per-channel triangle contraction on channel-major
// operands, a batched (B*H) N x N x N product with float32 accumulation,
// on the tensor cores.
//
// Replaces genie2_tpu/ops/trimul_fused.py:176 contract_cm_fullk (Pallas
// kernels _contract_kernel_out, :159, and _contract_kernel_in, :167):
//   outgoing: x[b,h,i,j] = sum_k a[b,h,i,k] b[b,h,j,k]
//   incoming: x[b,h,i,j] = sum_k a[b,h,k,i] b[b,h,k,j]
// with i < I, j < J, k < K: I = J = K = N on one card; under sequence
// parallelism the outgoing block has I = N / n_seq rows of a against all of
// b, and the incoming partial sums K = N / n_seq rows of both.
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

// Outgoing: a [BH, I, K], b [BH, J, K]; incoming: a [BH, K, I], b [BH, K,
// J]; out [BH, I, J]; all of dtype 0 = float32 or 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int trimul_contract(const void* a, const void* b, void* out, int BH, int I, int J, int K, int outgoing,
                               int dtype, void* stream) {
    if (BH < 1 || BH > 65535 || I < 1 || J < 1 || K < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long a_plane = (long long)I * K, b_plane = (long long)J * K, o_plane = (long long)I * J;
    // The row stride of each operand as stored: outgoing [row][k], incoming [k][row].
    const int a_ld = outgoing ? K : I, b_ld = outgoing ? K : J;
    auto run = [&](auto zero) -> int {
        using T = decltype(zero);
        ctile::Params<T> p{static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), I, J, K, 1,
                           a_plane, 0, a_ld, b_plane, 0, b_ld, o_plane, 0, J, 1, 0};
        p.vec = ctile::vec_ok(p);
        // outgoing: both operands [row][k]; incoming: both [k][row].
        return outgoing ? ctile::launch<T, true, true>(p, BH, s) : ctile::launch<T, false, false>(p, BH, s);
    };
    if (dtype == 0) return run(0.f);
    if (dtype == 1) return run(__float2bfloat16(0.f));
    return (int)cudaErrorInvalidValue;
}

// Shared device helpers of the triangle multiplicative update kernels:
// float32 / bfloat16 conversion, warp sums, and the LayerNorm of a tile of
// z rows into shared memory (channel-major, rounded to the activation type).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trimul {

constexpr float LN_EPS = 1e-6f;
constexpr int MAX_CHANNELS = 256;  // rows are held 8 values per lane

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
    static __device__ __forceinline__ float to_f(float v) { return v; }
    static __device__ __forceinline__ float from_f(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
    static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
    static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
};

template <typename T>
__device__ __forceinline__ float load_f(const T* p) {
    return Cvt<T>::to_f(*p);
}

// v rounded to T's precision, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
    return Cvt<T>::to_f(Cvt<T>::from_f(v));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// LayerNorm over C channels of the rows z_rows[r * C : (r + 1) * C] for
// r < TJ, float32 statistics (two passes over registers), written to
// dst[c * ld + r] rounded to T. Rows r >= n_valid are zero. One warp per
// row; every thread of the block must call it.
template <typename T, int TJ>
__device__ void layer_norm_rows(const T* __restrict__ z_rows, int n_valid, int C,
                                const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                                float* dst, int ld) {
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    for (int r = threadIdx.x >> 5; r < TJ; r += nwarps) {
        if (r >= n_valid) {
            for (int c = lane; c < C; c += 32) dst[c * ld + r] = 0.f;
            continue;
        }
        const T* row = z_rows + (size_t)r * C;
        float v[MAX_CHANNELS / 32];
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < MAX_CHANNELS / 32; ++q) {
            const int c = lane + 32 * q;
            v[q] = (c < C) ? load_f(row + c) : 0.f;
            s += v[q];
        }
        const float mu = warp_sum(s) / C;
        float s2 = 0.f;
#pragma unroll
        for (int q = 0; q < MAX_CHANNELS / 32; ++q) {
            const int c = lane + 32 * q;
            const float d = (c < C) ? v[q] - mu : 0.f;
            s2 += d * d;
        }
        const float rstd = rsqrtf(warp_sum(s2) / C + LN_EPS);
#pragma unroll
        for (int q = 0; q < MAX_CHANNELS / 32; ++q) {
            const int c = lane + 32 * q;
            if (c < C) dst[c * ld + r] = round_to<T>((v[q] - mu) * rstd * ln_s[c] + ln_b[c]);
        }
    }
}

}  // namespace trimul

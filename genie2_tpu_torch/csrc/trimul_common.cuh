// Shared device helpers of the triangle multiplicative update kernels:
// float32 / bfloat16 conversion, the sigmoid and warp sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trimul {

constexpr float LN_EPS = 1e-6f;
constexpr int MAX_CHANNELS = 256;  // LayerNorm rows are held 8 values per lane

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

}  // namespace trimul

// Helpers shared by the Hopper kernels (mttkrp.cu, sweep.cu, multi_ttm.cu,
// ssd_intra.cu): launch shape, factor pointers, index arithmetic and
// fp32/bf16 loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CONTRACT 7
#define NWARPS 8
#define NTHREADS (NWARPS * 32)
#define XLOADS 8  // global loads each thread keeps in flight when staging a tile
#define MAX_BATCH 65535  // problems a batched launch takes: gridDim.z's limit

struct Factors {
  const void* ptr[MAX_CONTRACT];  // (C_d, R), row-major, dtype of the tensor
};

static __host__ __device__ __forceinline__ long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}
static __host__ __device__ __forceinline__ long long ceil_div(long long x, long long m) {
  return (x + m - 1) / m;
}

template <typename T> __device__ __forceinline__ T zero_val();
template <> __device__ __forceinline__ float zero_val<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_val<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Helpers shared by the Hopper kernels (mttkrp.cu, sweep.cu, multi_ttm.cu,
// ssd_intra.cu): launch shape, factor pointers, index arithmetic, fp32/bf16
// loads, and the one store every kernel writes its results through.
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

// A launch grid as the kernels' grid functions give it, (x, y, z) in dims:
// each launcher and its repro_*_grid query take it from one function.
static inline dim3 grid_dim3(const long long* dims) {
  return dim3((unsigned)dims[0], (unsigned)dims[1], (unsigned)dims[2]);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// Result stores, and the write probe
// ---------------------------------------------------------------------------
//
// Every global store of a kernel's result (an output, a split-K slab, the
// pair's P) goes through store_result: a store of one V (a float, a bf16, a
// float2, a float4 or a uint4 of packed bf16) at dst. Built as it ships, it
// is that store and nothing else. Built with -DREPRO_WRITE_PROBE (the probe
// build, never the one the wrappers load) it also counts the elements it
// writes: repro_write_probe_set registers up to REPRO_PROBE_BUFFERS buffers,
// each with an int32 count an element and one overflow slot after them, and
// each element a store covers adds one to its buffer's count; an element
// past its buffer's end counts into that buffer's overflow slot, and a store
// into no registered buffer into the first buffer's. A walk that writes an
// element twice, or never, or outside its buffer shows in the counts.
#ifdef REPRO_WRITE_PROBE
#define REPRO_PROBE_BUFFERS 2
struct ProbeBuffer {
  unsigned long long base;  // the buffer's first byte
  long long elems;          // its elements
  int itemsize;             // bytes an element
  unsigned* counts;         // elems counts, then the overflow slot
};
struct ProbeTable {
  int n;
  ProbeBuffer buf[REPRO_PROBE_BUFFERS];
};
static __device__ ProbeTable g_probe;
static ProbeTable h_probe;  // the host's copy of what is registered

__device__ __forceinline__ void probe_count(const void* dst, int bytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(dst);
  for (int k = 0; k < g_probe.n; ++k) {
    const ProbeBuffer& b = g_probe.buf[k];
    if (a < b.base || a >= b.base + (unsigned long long)(b.elems * b.itemsize)) continue;
    const long long e0 = (long long)(a - b.base) / b.itemsize;
    for (int e = 0; e < bytes / b.itemsize; ++e)
      atomicAdd(&b.counts[e0 + e < b.elems ? e0 + e : b.elems], 1u);
    return;
  }
  if (g_probe.n > 0) atomicAdd(&g_probe.buf[0].counts[g_probe.buf[0].elems], 1u);
}
#endif

template <typename V, typename E>
__device__ __forceinline__ void store_result(E* dst, V v) {
  *reinterpret_cast<V*>(dst) = v;
#ifdef REPRO_WRITE_PROBE
  probe_count(dst, (int)sizeof(V));
#endif
}

#ifdef REPRO_WRITE_PROBE
extern "C" {
// Register a buffer of elems elements of itemsize bytes at base whose
// writes count into counts (elems + 1 int32, zeroed by the caller); base
// NULL clears every registration. Waits for the device first, so no kernel
// still running sees the table change. Returns a cudaError_t.
int repro_write_probe_set(const void* base, long long elems, int itemsize, void* counts) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  if (base == nullptr) {
    h_probe.n = 0;
  } else {
    if (h_probe.n >= REPRO_PROBE_BUFFERS || elems < 1 || itemsize < 1 || counts == nullptr)
      return (int)cudaErrorInvalidValue;
    h_probe.buf[h_probe.n++] = ProbeBuffer{reinterpret_cast<unsigned long long>(base), elems,
                                           itemsize, reinterpret_cast<unsigned*>(counts)};
  }
  return (int)cudaMemcpyToSymbol(g_probe, &h_probe, sizeof(ProbeTable));
}
}  // extern "C"
#endif

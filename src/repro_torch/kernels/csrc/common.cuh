// Helpers shared by the Hopper kernels (mttkrp.cu, sweep.cu, multi_ttm.cu):
// launch shape, factor pointers, index arithmetic, fp32/bf16 loads, and the
// row product of the fused pair and the Multi-TTM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CONTRACT 7
#define NWARPS 8
#define NTHREADS (NWARPS * 32)
#define XLOADS 8  // global loads each thread keeps in flight when staging a tile

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

// Four consecutive elements as fp32; p is 16-byte (fp32) or 8-byte (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// A CTA's product of a tile of X's rows with a column block of a matrix,
// summed along X's contiguous last axis: the fused pair's P tile
// (sweep.cu) and the Multi-TTM's first contraction (multi_ttm.cu). Its
// shared memory: xs (rows8 x ldx, input dtype), as (bl4 x ldw) and
// ps (rows8 x ldw), fp32.
struct RowProduct {
  int bl, bl4;  // the chunk along the last axis, rounded up to 4
  int ldx;      // xs row stride in elements (16 bytes of bank skew)
  int rows;     // rows of the product
  int rows8;    // rows rounded up to 8 (zero rows)
  int ldw;      // columns rounded up to 4
  int units;    // 8-row x 4-column units of the product
  int n_pass;   // passes over the last axis (units per pass: NTHREADS)
  int kparts;   // threads sharing one unit, each on a slice of a chunk
  int kchunk;   // that slice, a multiple of 4
};

static __host__ __device__ RowProduct make_row_product(int tsize, int rows, int bl, int cols) {
  RowProduct l;
  l.bl = bl;
  l.bl4 = (int)round_up(bl, 4);
  l.ldx = l.bl4 + 16 / tsize;
  l.rows = rows;
  l.rows8 = (int)round_up(rows, 8);
  l.ldw = (int)round_up(cols, 4);
  l.units = (l.rows8 / 8) * (l.ldw / 4);
  l.n_pass = (int)ceil_div(l.units, NTHREADS);
  const int kgroups = l.bl4 / 4;
  const int kp = l.units >= NTHREADS ? 1 : NTHREADS / l.units;
  l.kparts = kp < kgroups ? kp : kgroups;
  l.kchunk = 4 * (int)ceil_div(kgroups, l.kparts);
  return l;
}

// ps = X(rows, c) A(c, r0 .. r0 + br) summed over c in [c_begin, c_end).
// tab[row] is X's offset of the row at c = 0 (-1: a zero row); a is a
// (C, lda) matrix, masked on C, br and lda. Chunks of bl are staged in xs
// (whose pad rows and columns the caller keeps zero) and as, each thread
// keeping XLOADS X loads in flight. A thread owns an 8-row x 4-column unit
// in fp32 registers, and one float4 of the A chunk feeds 32 FMAs. With
// fewer units than threads, threads also split each chunk and add their
// partials into ps in a fixed order; with more, the CTA makes several
// passes. Every thread of the CTA calls it; it ends with a barrier.
template <typename T>
__device__ __forceinline__ void row_product(const RowProduct& l, const T* __restrict__ x,
                                            const long long* tab, const T* __restrict__ a,
                                            int lda, int r0, int br, long long c_begin,
                                            long long c_end, T* xs, float* as, float* ps) {
  const int t = threadIdx.x, bl = l.bl, ldw = l.ldw, ncg = ldw / 4;
  const int kpart = l.kparts > 1 ? t / l.units : 0;
  const int k_begin = kpart * l.kchunk;
  const int k_end = k_begin + l.kchunk < l.bl4 ? k_begin + l.kchunk : l.bl4;
  for (int pass = 0; pass < l.n_pass; ++pass) {
    const int unit = pass * NTHREADS + (l.kparts > 1 ? t % l.units : t);
    const bool active = unit < l.units && kpart < l.kparts;
    const int rg = active ? unit / ncg : 0, cg = active ? unit % ncg : 0;
    float acc[8][4];
#pragma unroll
    for (int tt = 0; tt < 8; ++tt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[tt][j] = 0.f;

    for (long long cl = c_begin; cl < c_end; cl += bl) {
      __syncthreads();  // the previous chunk is done with xs and as (and tab is written)
      // A chunk (fp32); pad rows k >= bl are zero
      for (int e = t; e < l.bl4 * ldw; e += NTHREADS) {
        const int k = e / ldw, rr = e - (e / ldw) * ldw;
        const long long g = cl + k;
        float v = 0.f;
        if (k < bl && g < c_end && rr < br && r0 + rr < lda) v = to_float(a[g * lda + r0 + rr]);
        as[e] = v;
      }
      // X chunk, masked at c_end: XLOADS loads in flight per thread
      {
        const long long lim = c_end - cl;
        const int total = l.rows * bl;
        for (int base = 0; base < total; base += NTHREADS * XLOADS) {
          T v[XLOADS];
#pragma unroll
          for (int u = 0; u < XLOADS; ++u) {
            const int e = base + u * NTHREADS + t;
            v[u] = zero_val<T>();
            if (e < total) {
              const int row = e / bl, k = e - (e / bl) * bl;
              const long long g = tab[row];
              if (g >= 0 && k < lim) v[u] = x[g + cl + k];
            }
          }
#pragma unroll
          for (int u = 0; u < XLOADS; ++u) {
            const int e = base + u * NTHREADS + t;
            if (e < total) {
              const int row = e / bl;
              xs[row * l.ldx + (e - row * bl)] = v[u];
            }
          }
        }
      }
      __syncthreads();
      if (active) {
        const T* xrow = xs + rg * 8 * l.ldx;
        const float* acol = as + cg * 4;
        for (int k = k_begin; k < k_end; k += 4) {
          float4 w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) w[q] = *reinterpret_cast<const float4*>(acol + (k + q) * ldw);
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            const float4 xv = load4(xrow + tt * l.ldx + k);
            float* c = acc[tt];
            c[0] = fmaf(xv.x, w[0].x, c[0]);
            c[1] = fmaf(xv.x, w[0].y, c[1]);
            c[2] = fmaf(xv.x, w[0].z, c[2]);
            c[3] = fmaf(xv.x, w[0].w, c[3]);
            c[0] = fmaf(xv.y, w[1].x, c[0]);
            c[1] = fmaf(xv.y, w[1].y, c[1]);
            c[2] = fmaf(xv.y, w[1].z, c[2]);
            c[3] = fmaf(xv.y, w[1].w, c[3]);
            c[0] = fmaf(xv.z, w[2].x, c[0]);
            c[1] = fmaf(xv.z, w[2].y, c[1]);
            c[2] = fmaf(xv.z, w[2].z, c[2]);
            c[3] = fmaf(xv.z, w[2].w, c[3]);
            c[0] = fmaf(xv.w, w[3].x, c[0]);
            c[1] = fmaf(xv.w, w[3].y, c[1]);
            c[2] = fmaf(xv.w, w[3].z, c[2]);
            c[3] = fmaf(xv.w, w[3].w, c[3]);
          }
        }
      }
    }
    // the finished units into ps, the chunk slices added in kpart order
    for (int q = 0; q < l.kparts; ++q) {
      if (active && kpart == q) {
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) {
          float4* d = reinterpret_cast<float4*>(ps + (rg * 8 + tt) * ldw + cg * 4);
          float4 s = make_float4(acc[tt][0], acc[tt][1], acc[tt][2], acc[tt][3]);
          if (q > 0) {
            const float4 o = *d;
            s = make_float4(o.x + s.x, o.y + s.y, o.z + s.z, o.w + s.w);
          }
          *d = s;
        }
      }
      __syncthreads();
    }
  }
}

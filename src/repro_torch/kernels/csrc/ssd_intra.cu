// The Mamba2 intra-chunk SSD term for Hopper (sm_90a).
//
// ssd_intra_kernel<T> replaces src/repro/kernels/ssd_intra.py:
// ssd_intra_pallas (_ssd_intra_kernel). For each batch-chunk c, row i and
// head h of a chunk of q positions,
//   Y[c,i,h,:] = sum_{j<=i} (C[c,i].B[c,j]) exp(cum[c,i,h] - cum[c,j,h])
//                           dt[c,j,h] X[c,j,h,:],
// with C, B (BC, q, N), cum, dt (BC, q, H) in fp32, X (BC, q, H, P) in fp32
// or bf16, and Y (BC, q, H, P) in X's dtype, accumulated in fp32. It is the
// only kernel of the Mamba2 prefill (repro/models/ssm.py:125-147, one
// launch a layer): it keeps the (q, q) Gram and the (q, q, H) decay-weighted
// scores out of device memory.
//
// What bounds it on an H100: the causal half of the work,
// 2 BC q(q+1)/2 (N + H P) operations (2.2e10 at Mamba2-2.7b's q=256, N=128,
// H=80, P=64 and BC=64), 0.33 ms on fp32 FMAs; the operands and the output
// are 0.36 GB (0.11 ms), so on fp32 CUDA cores it is operation-bound.
//
// The TPU kernel's cell is (batch-chunk, head-block): it forms the whole
// (q, q) Gram for every head-block and the whole masked (q, q) product per
// head, half of it above the diagonal. Here a CTA owns a tile of t rows i of
// one batch-chunk and a block of heads (grid: BC x H/heads x ceil(q/t)):
//   1. for each j-tile at or below its diagonal (tiles above are skipped),
//      the Gram tile G = C[i-tile] B[j-tile]^T, summed over N in chunks of
//      NK through shared memory, is stored (transposed, G^T[j][i]) in
//      shared memory once and kept for every head of the block;
//   2. per head, per j-tile (a step): the weights W^T[j][i] = G ⊙
//      exp(cum_i - cum_j) ⊙ dt_j are built in shared memory, where j <= i is
//      selected before the exp is taken (above the diagonal cum_i - cum_j
//      can be large enough for exp to overflow, and inf * 0 is NaN), and
//      zero elsewhere; the X[j-tile, h, :] rows (stride H*P apart in device
//      memory) are staged in shared memory in fp32; each thread adds W X
//      into a 4 x 4 tile of the output (4 rows, 4 of the P columns) in fp32
//      registers, and writes it once, in X's dtype, after the head's last
//      j-tile. A step's X tile, cum_j and dt_j are loaded into registers
//      during the step before, all of a thread's loads in flight at once,
//      while that step multiplies (the Gram's chunks are loaded the same
//      way; PERF.md has the times before and after).
// fp32 FMAs throughout, no tensor cores yet. Ragged edges (rows or columns
// past q, P not a multiple of 4, N not a multiple of NK) are masked in the
// loads and stores; nothing is padded in device memory. There are no
// atomics: each output element is written by one thread, and its sum runs
// in a fixed order, so results repeat bit for bit.
#include "common.cuh"

#define NK 32   // the N chunk of the Gram
#define SPT 16  // values a thread stages: 2 t NK, t ceil(P/4) 4 and t t are <= SPT NTHREADS

struct SsdProblem {
  long long bcn;  // BC
  int q, n, h, p;
  int heads;      // heads per CTA
  int tile;       // t: rows i (and columns j) of a tile, 16, 32 or 64
};

// Shared-memory layout, computed identically on host and device (and in
// repro_torch/kernels/ssd_intra.py:kernel_smem_bytes), in floats: G^T
// (q rounded up to t, x ldt) | cum_j and dt_j of a head step's j-tile, two
// buffers (2 x 2t) | one stage, used first by the Gram's C and B chunks
// (2 x NK x ldt) and then by each head step's W^T (t x ldt) and X tile
// (t x ldx). ldt = t + 4 keeps float4 rows aligned.
struct SsdLayout {
  int ldt, p4, ldx, q_pad;
  long long cdj, stage, total;  // cdj, stage: offsets in floats; total: bytes
};

static __host__ __device__ SsdLayout make_ssd_layout(int q, int p, int t) {
  SsdLayout l;
  l.ldt = t + 4;
  l.p4 = (int)round_up(p, 4);
  l.ldx = l.p4;
  l.q_pad = (int)round_up(q, t);
  l.cdj = (long long)l.q_pad * l.ldt;
  l.stage = l.cdj + 4LL * t;
  const long long gram = 2LL * NK * l.ldt;
  const long long head = (long long)t * l.ldt + (long long)t * l.ldx;
  l.total = (l.stage + (gram > head ? gram : head)) * 4;
  return l;
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
    ssd_intra_kernel(SsdProblem pr, const float* __restrict__ cc, const float* __restrict__ bc,
                     const float* __restrict__ cum, const float* __restrict__ dt,
                     const T* __restrict__ x, T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const SsdLayout l = make_ssd_layout(pr.q, pr.p, pr.tile);
  const int t = pr.tile, ldt = l.ldt, q = pr.q, n = pr.n, nh = pr.h, np = pr.p, p4 = l.p4;
  const long long c = blockIdx.x;
  const int h0 = blockIdx.y * pr.heads;
  const int it = blockIdx.z;
  const int i0 = it * t;
  const int tid = threadIdx.x;
  float* gt = smem;
  float* stage = smem + l.stage;

  // 1. the Gram tiles G^T[j][i] = B[j] . C[i0 + i], every j-tile jt <= it
  {
    float* cs = stage;             // cs[k][i] = C[i0 + i][k0 + k]
    float* bs = stage + NK * ldt;  // bs[k][j] = B[j0 + j][k0 + k]
    const float* cb = cc + c * q * n;
    const float* bb = bc + c * q * n;
    const int tu = t / 4, chunk = t * NK;  // chunk: elements of C's (or B's) N chunk
    const bool active = tid < tu * tu;
    const int iu = tid / tu, ju = tid % tu;
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * t;
      float acc[4][4] = {};
      for (int k0 = 0; k0 < n; k0 += NK) {
        float v[SPT];  // all of this thread's loads in flight at once
#pragma unroll
        for (int u = 0; u < SPT; ++u) {
          const int e = tid + u * NTHREADS, f = e % chunk;
          const int row = (e < chunk ? i0 : j0) + f / NK, gk = k0 + f % NK;
          v[u] = (e < 2 * chunk && row < q && gk < n)
                     ? (e < chunk ? cb : bb)[(long long)row * n + gk] : 0.f;
        }
        __syncthreads();  // the previous chunk is consumed
#pragma unroll
        for (int u = 0; u < SPT; ++u) {
          const int e = tid + u * NTHREADS, f = e % chunk;
          if (e < 2 * chunk) (e < chunk ? cs : bs)[(f % NK) * ldt + f / NK] = v[u];
        }
        __syncthreads();
        if (active) {
#pragma unroll 8
          for (int k = 0; k < NK; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(cs + k * ldt + 4 * iu);
            const float4 b = *reinterpret_cast<const float4*>(bs + k * ldt + 4 * ju);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
          }
        }
      }
      if (active) {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          *reinterpret_cast<float4*>(gt + (long long)(j0 + 4 * ju + w) * ldt + 4 * iu) =
              make_float4(acc[0][w], acc[1][w], acc[2][w], acc[3][w]);
      }
    }
  }

  // 2. per head, per j-tile (one step each): W = G ⊙ exp(cum_i - cum_j) ⊙ dt_j
  //    on j <= i, out += W X. A step's X tile and its cum_j, dt_j are loaded
  //    into registers during the step before it, while that step multiplies;
  //    cum_j and dt_j pass through shared memory (cdj, two buffers).
  float* wt = stage;            // wt[j][i]
  float* xs = stage + t * ldt;  // xs[j][p]
  float* cdj = smem + l.cdj;    // cdj[b][0, t): cum_j, cdj[b][t, 2t): dt_j
  const int pu_n = p4 / 4;
  const bool active = tid < (t / 4) * pu_n;
  const int iu = tid / pu_n, pu = tid % pu_n;
  const int wi = tid % t, jstep = NTHREADS / t;  // this thread's W elements: (tid/t + u jstep, wi)
  const int gwi = i0 + wi;
  const int steps = pr.heads * (it + 1);
  T xr[SPT];
  float cv = 0.f, ci = 0.f;  // this thread's cum_j or dt_j (tid < 2t), and its row's cum_i
  auto prefetch = [&](int s) {
    const int h = h0 + s / (it + 1), j0 = (s % (it + 1)) * t;
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const int e = tid + u * NTHREADS, j = e / p4, pp = e % p4, gj = j0 + j;
      xr[u] = (j < t && gj < q && pp < np) ? x[((c * q + gj) * nh + h) * np + pp] : zero_val<T>();
    }
    const int gj = j0 + tid % t;
    cv = (tid < 2 * t && gj < q) ? (tid < t ? cum : dt)[(c * q + gj) * nh + h] : 0.f;
    ci = gwi < q ? cum[(c * q + gwi) * nh + h] : 0.f;
  };
  prefetch(0);
  if (tid < 2 * t) cdj[tid] = cv;
  float acc[4][4] = {};
  for (int s = 0; s < steps; ++s) {
    const int jt = s % (it + 1), j0 = jt * t, h = h0 + s / (it + 1);
    const float* cj = cdj + (s & 1) * 2 * t;
    __syncthreads();  // the Gram and cj are complete; the previous step's W and X are consumed
    for (int j = tid / t; j < t; j += jstep) {
      const int gj = j0 + j;
      float w = 0.f;
      if (gj <= gwi && gwi < q)  // causal: selected before the exp
        w = gt[(long long)gj * ldt + wi] * expf(ci - cj[j]) * cj[t + j];
      wt[j * ldt + wi] = w;
    }
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const int e = tid + u * NTHREADS;
      if (e < t * p4) xs[(e / p4) * l.ldx + e % p4] = to_float(xr[u]);
    }
    if (s + 1 < steps) prefetch(s + 1);
    __syncthreads();
    if (active) {
      const int jn = min(t, q - j0);
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(wt + j * ldt + 4 * iu);
        const float4 b = *reinterpret_cast<const float4*>(xs + j * l.ldx + 4 * pu);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
      }
    }
    if (tid < 2 * t) cdj[((s + 1) & 1) * 2 * t + tid] = cv;  // the next step's cum_j, dt_j
    if (jt == it) {  // the head's last (diagonal) tile: write it once, in X's dtype
      if (active) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int gi = i0 + 4 * iu + u;
          if (gi < q) {
            T* row = out + ((c * q + gi) * nh + h) * np;
#pragma unroll
            for (int w = 0; w < 4; ++w)
              if (4 * pu + w < np) store_as(row + 4 * pu + w, acc[u][w]);
          }
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;
        }
      }
    }
  }
}

template <typename T>
static int launch(const SsdProblem& p, const void* cc, const void* bc, const void* cum,
                  const void* dt, const void* x, void* out, cudaStream_t s) {
  const long long smem = make_ssd_layout(p.q, p.p, p.tile).total;
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)p.bcn, (unsigned)(p.h / p.heads), (unsigned)ceil_div(p.q, p.tile));
  ssd_intra_kernel<T><<<grid, NTHREADS, smem, s>>>(
      p, reinterpret_cast<const float*>(cc), reinterpret_cast<const float*>(bc),
      reinterpret_cast<const float*>(cum), reinterpret_cast<const float*>(dt),
      reinterpret_cast<const T*>(x), reinterpret_cast<T*>(out));
  return (int)cudaGetLastError();
}

extern "C" {

// Bytes of dynamic shared memory the kernel takes at this chunk length,
// head dimension and tile.
long long repro_ssd_intra_smem_bytes(int q, int p, int tile) {
  return make_ssd_layout(q, p, tile).total;
}

// One launch. dtype (of x and out): 0 float32, 1 bfloat16; cc, bc
// (BC, q, N), cum, dt (BC, q, H) float32; x, out (BC, q, H, P); all
// contiguous. heads divides H; tile is 16, 32 or 64, and (tile/4) x
// ceil(P/4) <= NTHREADS. Returns a cudaError_t.
int repro_ssd_intra(int dtype, long long bcn, int q, int n, int h, int p, int heads, int tile,
                    const void* cc, const void* bc, const void* cum, const void* dt,
                    const void* x, void* out, void* stream) {
  if (bcn < 1 || q < 1 || n < 1 || h < 1 || p < 1 || heads < 1 || h % heads != 0 ||
      (tile != 16 && tile != 32 && tile != 64) ||
      (tile / 4) * round_up(p, 4) / 4 > NTHREADS || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const SsdProblem pr{bcn, q, n, h, p, heads, tile};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(pr, cc, bc, cum, dt, x, out, s)
                    : launch<__nv_bfloat16>(pr, cc, bc, cum, dt, x, out, s);
}

}  // extern "C"

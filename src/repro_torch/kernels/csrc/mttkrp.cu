// Blocked mode-0 MTTKRP for Hopper (sm_90a): O(i, r) = sum_c X(i, c) W(c, r),
// W(c_1..c_n, r) = prod_d A_d(c_d, r), the Khatri-Rao block built on chip.
//
// Replaces the reference's two TPU kernels:
//   * mttkrp_tile_kernel<T, CG, 2>  <- src/repro/kernels/mttkrp3.py:_mttkrp3_kernel
//     (the 3-way specialization: two contraction dims known at compile time);
//   * mttkrp_tile_kernel<T, CG, 0>  <- src/repro/kernels/mttkrpn.py:_kernel
//     (generic N-way: the number of contraction dims is read at run time);
//   * splitk_reduce_kernel          <- the output tile the TPU kernels keep
//     resident across their sequential ("arbitrary") grid steps
//     (mttkrp3.py:67-69, mttkrpn.py:42-48).
//
// What bounds it on an H100: fp32 inputs at 1000^3, R=64 need 1.28e11 FLOP
// against 4.0e9 bytes, so fp32 arithmetic on the CUDA cores (67 TFLOP/s)
// bounds it (1.91 ms), not the 3.35 TB/s of memory (1.19 ms); bf16 inputs
// halve the bytes. The design keeps the arithmetic on fp32 FMAs fed from
// shared memory: every X element a CTA stages is reused across its br rank
// columns, and every W element across its bi output rows.
//
// Design (simple and right first; wgmma, TMA and pipelining come later):
//   * One CTA of 256 threads per (i-tile, r-tile, contraction split). The TPU
//     walks the contraction tiles as a sequential grid; here the walk is a loop
//     inside the CTA, and the outermost contraction axis is split over
//     n_splits CTAs so that enough CTAs fill the 132 SMs. Each split writes
//     its own fp32 (I, R) slab of a workspace; splitk_reduce_kernel sums the
//     slabs in a fixed order. No atomics: results repeat bit for bit.
//   * Per step: the X tile (bi x prod bc, input dtype), the factor tiles
//     (fp32) and the KRP block W (prod bc x br, fp32, last contraction index
//     fastest, matching X's C-order reshape) are staged in dynamic shared
//     memory, sized from the plan's blocks. A per-step table of the global
//     offsets of the tile's contiguous runs (one per row and leading index)
//     keeps the per-dimension index arithmetic out of the element loads, and
//     each thread keeps XLOADS global loads in flight.
//   * A warp owns register tiles of 8 output rows x 4*CG rank columns (up to
//     MAXT of them; a CTA with more tiles than its warps hold makes several
//     passes over the contraction, one group of tiles each): lane
//     (cs, cg) holds 8 x 4 fp32 accumulators for columns 4cg..4cg+3 and sums
//     every CS-th group of 4 contraction indices (CS = 32 / CG), so one
//     float4 of W feeds 32 FMAs. The CS partial sums are added by a
//     butterfly of warp shuffles once, after the last step. With fewer tiles
//     than warps, the warps also split the contraction of each step and add
//     their partials in a fixed order.
//   * Ragged edges (extents that are not multiples of the blocks) are masked
//     in the loads: the tensor is never padded in device memory.
#include "common.cuh"

#define MAXT 2  // register tiles per warp

struct Problem {
  int ncontract;                      // N - 1
  int block_i;                        // bi
  int block_r;                        // br
  int rank;                           // R
  int n_splits;                       // CTAs along the outermost contraction axis
  long long extent_i;                 // I
  long long extent_c[MAX_CONTRACT];   // C_1 .. C_{N-1}
  int block_c[MAX_CONTRACT];          // bc_1 .. bc_{N-1}
};

// Column groups of 4 per warp tile: the smallest power of two covering br,
// at most 32 (a warp tile is then 128 columns wide).
static __host__ __device__ __forceinline__ int pick_cg(int br) {
  int cg = 1;
  while (cg < 32 && 4 * cg < br) cg *= 2;
  return cg;
}

// Shared-memory layout, computed identically on host and device:
//   xs (rows x ldx, input dtype) | tab_g (n_lines x i64) | tab_s (n_lines x i32)
//   | fs (factor tiles, fp32) | ws (W, fp32; reused for cross-warp partials)
struct Layout {
  int kc;        // prod bc: contraction extent of one step
  int kc8;       // kc rounded up to 8 (zero columns, zero W rows)
  int ldx;       // X tile row stride in elements (16 bytes of bank skew)
  int rows;      // bi rounded up to 8 (zero rows)
  int tw;        // warp tile width: 4 * CG columns
  int ldw;       // W and factor-tile row stride: br rounded up to tw
  int lpr;       // contiguous runs (lines) per X tile row: kc / bc_last
  int n_lines;   // bi * lpr
  long long tab_g, tab_s, fs, ws;  // byte offsets
  long long total;
};

static __host__ __device__ Layout make_layout(int tsize, int nc, const int* bc, int bi, int br) {
  Layout l;
  l.kc = 1;
  for (int d = 0; d < nc; ++d) l.kc *= bc[d];
  l.kc8 = (int)round_up(l.kc, 8);
  l.ldx = l.kc8 + 16 / tsize;
  l.rows = (int)round_up(bi, 8);
  l.tw = 4 * pick_cg(br);
  l.ldw = (int)round_up(br, l.tw);
  l.lpr = l.kc / bc[nc - 1];
  l.n_lines = bi * l.lpr;
  long long fs_words = 0;
  for (int d = 0; d < nc; ++d) fs_words += (long long)bc[d] * l.ldw;
  l.tab_g = (long long)l.rows * l.ldx * tsize;
  l.tab_s = l.tab_g + 8LL * l.n_lines;
  l.fs = round_up(l.tab_s + 4LL * l.n_lines, 16);
  l.ws = l.fs + round_up(fs_words * 4, 16);
  const long long w = (long long)l.kc8 * l.ldw * 4;
  const long long red = (long long)NWARPS * 8 * l.tw * 4;
  l.total = l.ws + (w > red ? w : red);
  return l;
}

// NC_STATIC > 0 fixes the number of contraction dims at compile time (the
// 3-way specialization); NC_STATIC == 0 reads it from the problem (generic).
template <typename T, int CG, int NC_STATIC>
__global__ void __launch_bounds__(NTHREADS, 2)
mttkrp_tile_kernel(Problem p, const T* __restrict__ x, Factors f, float* __restrict__ out) {
  constexpr int CS = 32 / CG;  // contraction slices per warp
  const int nc = NC_STATIC > 0 ? NC_STATIC : p.ncontract;
  const int bi = p.block_i, br = p.block_r, R = p.rank;
  const Layout l = make_layout(sizeof(T), nc, p.block_c, bi, br);
  const int bl = p.block_c[nc - 1];

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  long long* tab_g = reinterpret_cast<long long*>(smem + l.tab_g);
  int* tab_s = reinterpret_cast<int*>(smem + l.tab_s);
  float* fs = reinterpret_cast<float*>(smem + l.fs);
  float* ws = reinterpret_cast<float*>(smem + l.ws);

  const int gr = (int)ceil_div(R, br);
  const int tile_r = blockIdx.x % gr;
  const long long i0 = (long long)(blockIdx.x / gr) * bi;
  const int r0 = tile_r * br;
  const int split = blockIdx.y;

  long long ntiles[MAX_CONTRACT];
  for (int d = 0; d < nc; ++d) ntiles[d] = ceil_div(p.extent_c[d], p.block_c[d]);
  long long n_inner = 1;
  for (int d = 1; d < nc; ++d) n_inner *= ntiles[d];
  const long long o_begin = split * ntiles[0] / p.n_splits;
  const long long o_end = (split + 1) * ntiles[0] / p.n_splits;

  // warp -> register tiles of 8 rows x tw columns; lane -> (cs, cg)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = lane % CG, cs = lane / CG;
  const int n_tr = l.ldw / l.tw;
  const int tasks = (l.rows / 8) * n_tr;
  const int kparts = tasks >= NWARPS ? 1 : NWARPS / tasks;
  const int n_pass = (int)ceil_div(tasks, NWARPS * MAXT);  // passes over the contraction
  const int task0 = kparts == 1 ? warp : warp % tasks;
  const int kpart = kparts == 1 ? 0 : warp / tasks;
  const bool active = kpart < kparts;
  const int kchunk = (int)round_up(ceil_div(l.kc8, kparts), 4);
  const int c_begin = kpart * kchunk;
  const int c_end = c_begin + kchunk < l.kc8 ? c_begin + kchunk : l.kc8;

  // Pad rows and columns of X and pad rows of W stay zero for the whole run.
  for (int e = threadIdx.x; e < l.rows * l.ldx; e += NTHREADS) xs[e] = zero_val<T>();
  for (int e = l.kc * l.ldw + threadIdx.x; e < l.kc8 * l.ldw; e += NTHREADS) ws[e] = 0.f;

  for (int pass = 0; pass < n_pass; ++pass) {
    const int pass0 = pass * NWARPS * MAXT;
    float acc[MAXT][8][4];
#pragma unroll
    for (int s = 0; s < MAXT; ++s)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[s][t][j] = 0.f;

    for (long long step = o_begin * n_inner; step < o_end * n_inner; ++step) {
      long long c0[MAX_CONTRACT];
      {
        long long rem = step;
        for (int d = nc - 1; d >= 1; --d) {
          c0[d] = (rem % ntiles[d]) * p.block_c[d];
          rem /= ntiles[d];
        }
        c0[0] = rem * p.block_c[0];
      }
      __syncthreads();  // the previous step is done with xs, the tables, fs and ws

      // line table: global offset of each contiguous run of the last
      // contraction dim (-1 where the row or a leading index is out of range)
      for (int line = threadIdx.x; line < l.n_lines; line += NTHREADS) {
        const int row = line / l.lpr;
        int rem = line - row * l.lpr;
        int dig[MAX_CONTRACT];
        for (int d = nc - 2; d >= 0; --d) {
          dig[d] = rem % p.block_c[d];
          rem /= p.block_c[d];
        }
        long long off = i0 + row;
        bool in = off < p.extent_i;
        for (int d = 0; d < nc - 1; ++d) {
          const long long g = c0[d] + dig[d];
          in = in && g < p.extent_c[d];
          off = off * p.extent_c[d] + g;
        }
        tab_g[line] = in ? off * p.extent_c[nc - 1] + c0[nc - 1] : -1;
        tab_s[line] = row * l.ldx + (line - row * l.lpr) * bl;
      }
      __syncthreads();
      // factor tiles (fp32), masked on C_d, br and R; their loads are issued
      // before the X tile's, so the two latencies overlap
      {
        int base = 0;
        for (int d = 0; d < nc; ++d) {
          const T* fd = reinterpret_cast<const T*>(f.ptr[d]);
          for (int cc = warp; cc < p.block_c[d]; cc += NWARPS) {
            const long long g = c0[d] + cc;
            for (int rr = lane; rr < l.ldw; rr += 32) {
              float v = 0.f;
              if (rr < br && r0 + rr < R && g < p.extent_c[d]) v = to_float(fd[g * R + r0 + rr]);
              fs[base + cc * l.ldw + rr] = v;
            }
          }
          base += p.block_c[d] * l.ldw;
        }
      }
      // X tile, masked on the last contraction dim: each thread issues XLOADS
      // global loads before it stores any, so their latencies overlap
      {
        const long long lim = p.extent_c[nc - 1] - c0[nc - 1];
        const int total = l.n_lines * bl;
        for (int base = 0; base < total; base += NTHREADS * XLOADS) {
          T v[XLOADS];
#pragma unroll
          for (int k = 0; k < XLOADS; ++k) {
            const int e = base + k * NTHREADS + threadIdx.x;
            v[k] = zero_val<T>();
            if (e < total) {
              const int line = e / bl;
              const long long g = tab_g[line];
              if (g >= 0 && e - line * bl < lim) v[k] = x[g + (e - line * bl)];
            }
          }
#pragma unroll
          for (int k = 0; k < XLOADS; ++k) {
            const int e = base + k * NTHREADS + threadIdx.x;
            if (e < total) {
              const int line = e / bl;
              xs[tab_s[line] + (e - line * bl)] = v[k];
            }
          }
        }
      }
      __syncthreads();
      // KRP block: W[q * bl + k, r] = (prod_{d < n-1} F_d[q_d, r]) * F_last[k, r],
      // one warp per prefix row q (the leading contraction indices), float4 wide
      {
        int last = 0;
        for (int d = 0; d < nc - 1; ++d) last += p.block_c[d] * l.ldw;
        const int nc4 = l.ldw / 4;                // float4 columns
        const int lc = nc4 < 32 ? nc4 : 32;       // lanes across columns (divides 32)
        const int lk = 32 / lc;                   // lanes across k
        const float4* fl = reinterpret_cast<const float4*>(fs + last);
        float4* w4 = reinterpret_cast<float4*>(ws);
        for (int q = warp; q < l.lpr; q += NWARPS) {
          int dig[MAX_CONTRACT];
          int rem = q;
          for (int d = nc - 2; d >= 0; --d) {
            dig[d] = rem % p.block_c[d];
            rem /= p.block_c[d];
          }
          for (int c4 = lane % lc; c4 < nc4; c4 += lc) {
            float4 pv = make_float4(1.f, 1.f, 1.f, 1.f);
            int base = 0;
            for (int d = 0; d < nc - 1; ++d) {
              pv = mul4(pv, reinterpret_cast<const float4*>(fs + base + dig[d] * l.ldw)[c4]);
              base += p.block_c[d] * l.ldw;
            }
            float4* wq = w4 + (long long)q * bl * nc4 + c4;
            for (int k0 = lane / lc; k0 < bl; k0 += 4 * lk) {  // four loads, then the stores
              float4 t[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int k = k0 + j * lk;
                t[j] = k < bl ? fl[k * nc4 + c4] : make_float4(0.f, 0.f, 0.f, 0.f);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int k = k0 + j * lk;
                if (k < bl) wq[k * nc4] = mul4(pv, t[j]);
              }
            }
          }
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int s = 0; s < MAXT; ++s) {
          const int task = kparts == 1 ? pass0 + task0 + s * NWARPS : (s == 0 ? task0 : tasks);
          if (task < tasks) {
            const int col = (task % n_tr) * l.tw + cg * 4;
            const T* xrow = xs + (task / n_tr) * 8 * l.ldx;
            const float* wcol = ws + col;
            for (int c = c_begin + 4 * cs; c < c_end; c += 4 * CS) {
              float4 w[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                w[q] = *reinterpret_cast<const float4*>(wcol + (c + q) * l.ldw);
#pragma unroll
              for (int t = 0; t < 8; ++t) {
                const float4 xv = load4(xrow + t * l.ldx + c);
                float* a = acc[s][t];
                a[0] = fmaf(xv.x, w[0].x, a[0]);
                a[1] = fmaf(xv.x, w[0].y, a[1]);
                a[2] = fmaf(xv.x, w[0].z, a[2]);
                a[3] = fmaf(xv.x, w[0].w, a[3]);
                a[0] = fmaf(xv.y, w[1].x, a[0]);
                a[1] = fmaf(xv.y, w[1].y, a[1]);
                a[2] = fmaf(xv.y, w[1].z, a[2]);
                a[3] = fmaf(xv.y, w[1].w, a[3]);
                a[0] = fmaf(xv.z, w[2].x, a[0]);
                a[1] = fmaf(xv.z, w[2].y, a[1]);
                a[2] = fmaf(xv.z, w[2].z, a[2]);
                a[3] = fmaf(xv.z, w[2].w, a[3]);
                a[0] = fmaf(xv.w, w[3].x, a[0]);
                a[1] = fmaf(xv.w, w[3].y, a[1]);
                a[2] = fmaf(xv.w, w[3].z, a[2]);
                a[3] = fmaf(xv.w, w[3].w, a[3]);
              }
            }
          }
        }
      }
    }

    // add the CS contraction slices of each column group (fixed butterfly order)
#pragma unroll
    for (int s = 0; s < MAXT; ++s)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int off = CG; off < 32; off *= 2)
            acc[s][t][j] += __shfl_xor_sync(0xffffffffu, acc[s][t][j], off);

    float* o = out + (long long)split * p.extent_i * R;
    if (kparts == 1) {
#pragma unroll
      for (int s = 0; s < MAXT; ++s) {
        const int task = pass0 + task0 + s * NWARPS;
        if (cs == 0 && task < tasks) {
          const int col = (task % n_tr) * l.tw + cg * 4;
          const int row0 = (task / n_tr) * 8;
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const long long gi = i0 + row0 + t;
            if (row0 + t >= bi || gi >= p.extent_i) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col + j < br && r0 + col + j < R) o[gi * R + r0 + col + j] = acc[s][t][j];
          }
        }
      }
      continue;  // the next pass, if any
    }
    // warps that split the contraction add their partials in kpart order
    __syncthreads();
    float* red = ws;
    if (active && cs == 0) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[((kpart * tasks + task0) * 8 + t) * l.tw + cg * 4 + j] = acc[0][t][j];
    }
    __syncthreads();
    if (active && kpart == 0 && cs == 0) {
      const int col = (task0 % n_tr) * l.tw + cg * 4;
      const int row0 = (task0 / n_tr) * 8;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const long long gi = i0 + row0 + t;
        if (row0 + t >= bi || gi >= p.extent_i) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = 0.f;
          for (int q = 0; q < kparts; ++q)
            v += red[((q * tasks + task0) * 8 + t) * l.tw + cg * 4 + j];
          if (col + j < br && r0 + col + j < R) o[gi * R + r0 + col + j] = v;
        }
      }
    }
  }  // pass
}

__global__ void splitk_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                     long long n, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += ws[q * n + e];
    out[e] = s;
  }
}

template <typename T, int CG, int NC>
static int launch_tile(const Problem& p, const void* x, const Factors& f, float* out,
                       long long smem, cudaStream_t stream) {
  auto kern = mttkrp_tile_kernel<T, CG, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long gi = ceil_div(p.extent_i, p.block_i);
  const long long gr = ceil_div(p.rank, p.block_r);
  dim3 grid((unsigned)(gi * gr), (unsigned)p.n_splits);
  kern<<<grid, NTHREADS, smem, stream>>>(p, reinterpret_cast<const T*>(x), f, out);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
static int dispatch_cg(const Problem& p, const void* x, const Factors& f, float* out,
                       long long smem, cudaStream_t stream) {
  switch (pick_cg(p.block_r)) {
    case 1: return launch_tile<T, 1, NC>(p, x, f, out, smem, stream);
    case 2: return launch_tile<T, 2, NC>(p, x, f, out, smem, stream);
    case 4: return launch_tile<T, 4, NC>(p, x, f, out, smem, stream);
    case 8: return launch_tile<T, 8, NC>(p, x, f, out, smem, stream);
    case 16: return launch_tile<T, 16, NC>(p, x, f, out, smem, stream);
    default: return launch_tile<T, 32, NC>(p, x, f, out, smem, stream);
  }
}

extern "C" {

// Bytes of dynamic shared memory the tile kernel takes for these blocks.
long long repro_mttkrp_smem_bytes(int tsize, int ncontract, const int* block_c, int block_i,
                                  int block_r) {
  return make_layout(tsize, ncontract, block_c, block_i, block_r).total;
}

// One launch of the tile kernel. dtype: 0 float32, 1 bfloat16.
// specialized != 0 takes the 3-way kernel (ncontract must be 2).
// extents: I, C_1..C_{N-1}; blocks: bi, bc_1..bc_{N-1}; factors: N-1 device
// pointers. out: n_splits slabs of (I, R) fp32. Returns a cudaError_t.
int repro_mttkrp_tile(int specialized, int dtype, int ncontract, const long long* extents,
                      const int* blocks, int block_r, int rank, int n_splits, const void* x,
                      const long long* factors, void* out, void* stream) {
  if (ncontract < 1 || ncontract > MAX_CONTRACT || (specialized && ncontract != 2) ||
      n_splits < 1 || block_r < 1 || rank < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.ncontract = ncontract;
  p.block_i = blocks[0];
  p.block_r = block_r;
  p.rank = rank;
  p.n_splits = n_splits;
  p.extent_i = extents[0];
  Factors f;
  for (int d = 0; d < MAX_CONTRACT; ++d) {
    p.extent_c[d] = d < ncontract ? extents[1 + d] : 1;
    p.block_c[d] = d < ncontract ? blocks[1 + d] : 1;
    f.ptr[d] = d < ncontract ? reinterpret_cast<const void*>(factors[d]) : nullptr;
  }
  if (p.block_i < 1) return (int)cudaErrorInvalidValue;
  const long long smem = repro_mttkrp_smem_bytes(dtype == 0 ? 4 : 2, ncontract, p.block_c,
                                                 p.block_i, block_r);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  if (dtype == 0) {
    return specialized ? dispatch_cg<float, 2>(p, x, f, o, smem, s)
                       : dispatch_cg<float, 0>(p, x, f, o, smem, s);
  }
  return specialized ? dispatch_cg<__nv_bfloat16, 2>(p, x, f, o, smem, s)
                     : dispatch_cg<__nv_bfloat16, 0>(p, x, f, o, smem, s);
}

// out[e] = sum_{q < splits} ws[q * n + e], in q order. Returns a cudaError_t.
int repro_splitk_reduce(const void* ws, void* out, long long n, int splits, void* stream) {
  if (n < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  long long blocks = ceil_div(n, 256);
  if (blocks > 132 * 32) blocks = 132 * 32;
  splitk_reduce_kernel<<<(unsigned)blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(ws), reinterpret_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Mode-0 MTTKRP for Hopper (sm_90a): O(i, r) = sum_c X(i, c) W(c, r),
// W(c_1..c_n, r) = prod_d A_d(c_d, r), the Khatri-Rao product of the factors,
// which never exists in device memory.
//
// Replaces the reference's two TPU kernels:
//   * mttkrp_mma_kernel<T, 2, MT, NT>  <- src/repro/kernels/mttkrp3.py:_mttkrp3_kernel
//     (the 3-way specialization: two contraction dims known at compile time);
//   * mttkrp_mma_kernel<T, 0, MT, NT>  <- src/repro/kernels/mttkrpn.py:_kernel
//     (generic N-way, the dimension tree's one-axis 2-D edge included: the
//     count is read at run time);
//   * splitk_reduce_kernel             <- the output tile the TPU kernels keep
//     resident across their sequential ("arbitrary") grid steps
//     (mttkrp3.py:67-69, mttkrpn.py:42-48).
//
// What bounds it on an H100: reading X once. At 1000^3, R=64 in fp32 that is
// 4.0e9 bytes (1.19 ms at 3.35 TB/s) against 1.28e11 FLOP, which the fp32 CUDA
// cores (67 TFLOP/s) would need 1.91 ms for but the tensor cores far less; bf16
// X halves the bytes (0.60 ms). So the design streams X once, keeps its copies
// in flight while the tensor cores multiply, and does as little else per byte
// of X as it can:
//   * X is a row-major (I, K) matrix, K = prod C_d (a contiguous mode-0 tensor
//     is exactly that), walked in order as (prefix tuple, last-axis chunk)
//     pairs: a chunk is block_k consecutive indices of the last axis (32, 64,
//     128 or 256 bytes of each row) under one tuple p of the leading indices.
//     Within a chunk W(c, r) = P_p(r) A_last(c_last, r), P_p = the product of
//     the leading factors' rows. So the chunk's products need no Khatri-Rao
//     block at all: the tensor cores multiply X by the last factor's rows, and
//     the chunk's fp32 partial sums are scaled by P_p (one multiply-add per
//     output a chunk) as they are added to the accumulators.
//   * One CTA of 256 threads owns BI = 64 MT rows and BR = 16 NT rank columns
//     (BR >= R for R <= 128, so X is read once); N changes only how P is formed.
//   * The ring's layout and its cp.async and mma.sync primitives are ring.cuh's,
//     shared with the fused pair (sweep.cu) and the Multi-TTM (multi_ttm.cu): a ring of `stages`
//     chunk buffers filled by cp.async, each holding the chunk's X columns,
//     the block_k rows of the last factor it multiplies, and one row of each
//     leading factor (P's); the zero-fill form masks the ragged edges, so X
//     is never padded. The copies of chunk s + stages - 1 are in flight while
//     chunk s is multiplied, and one barrier a chunk separates the two. fp32
//     X runs 3xTF32 mma.sync, bf16 X one bf16 mma.sync against the bf16
//     factor itself; P is applied in fp32, as the reference's fp32 W is.
//   * Accumulators are fp32 registers: 8 warps as 4 (rows) x 2 (columns), each
//     MT x NT tiles of 16 x 8. A chunk's products go to a zeroed partial,
//     which ordinary (round-to-nearest) fp32 multiply-adds fold into the
//     accumulators (the tensor cores' own adds truncate).
//   * This kernel keeps its copy and fragment loops written out in its body,
//     though ring.cuh's copy_x_chunk, copy_rows and chunk_product compute the
//     same: called from here they made ptxas schedule the kernel otherwise
//     and cost it about 5 % at 1000^3 fp32 (scripts/probe_mttkrp.py
//     --baseline, PERF.md). The pair and the Multi-TTM kernels call them.
//   * Split-K over the chunks: gridDim.y = S CTAs share a row tile, split y
//     takes chunks y, y + S, ... (so the CTAs in flight read neighbouring
//     runs of the same rows) and writes its own fp32 (I, R) slab;
//     splitk_reduce_kernel adds the slabs in slab order. No atomics: results
//     repeat bit for bit. Offsets into X are 64-bit (I K is 5.8e9 at 180^4);
//     I and K themselves stay below 2^31, so chunk indices are 32-bit.
//   * A batch of B problems of one shape (the reference vmaps its kernel,
//     which makes the batch a grid dimension): blockIdx.z = b, X and each
//     factor offset by b times their batch strides (64-bit; a factor's
//     stride 0 when the batch shares it), and split y of problem b writes
//     slab y b of an (S, B, I, R) workspace, so one splitk_reduce_kernel
//     launch adds all B I R outputs. One launch a batched call; the plan is
//     the element's (only the split count sees B's CTAs).
#include "ring.cuh"

// NC_STATIC == 2 fixes the number of contraction dims at compile time (the
// 3-way specialization); NC_STATIC == 0 reads it from the problem.
template <typename T, int NC_STATIC, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS, NT == 8 ? 1 : 2)
mttkrp_mma_kernel(TileProblem p, const T* __restrict__ x, Factors f, float* __restrict__ out) {
  constexpr int BI = 64 * MT, BR = 16 * NT, TS = (int)sizeof(T);
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NB = NT >= 2 ? 2 : 1;  // n-tiles one bf16 ldmatrix feeds
  const int nc = NC_STATIC > 0 ? NC_STATIC : p.ncontract;
  const int nlead = nc - 1;
  const int bk = p.block_k;
  const TileLayout l = make_tile_layout(TS, nc, BI, bk, BR, p.stages);
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sbase = smem_u32(smem);

  const int gr = (int)ceil_div(p.rank, BR);
  const int i0 = (int)(blockIdx.x / gr) * BI;  // I < 2^31, K < 2^31 (checked at launch)
  const int r0 = (int)(blockIdx.x % gr) * BR;
  const int rvalid = p.rank - r0 < BR ? p.rank - r0 : BR;
  // split y takes chunks y, y + S, y + 2S, ...: the CTAs in flight read
  // neighbouring chunks of the same rows (nch <= K < 2^31)
  const int nch = (int)(p.n_prefix * p.chunks_per_prefix), S = p.n_splits;
  const int cpp = (int)p.chunks_per_prefix;
  const int n_local = (int)blockIdx.y < nch ? (nch - (int)blockIdx.y + S - 1) / S : 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp >> 1, wn = warp & 1;  // 4 warps along rows, 2 along columns
  const long long bz = blockIdx.z;  // the batch element: 64-bit offsets
  x += bz * p.x_bstride;
  const T* flast = reinterpret_cast<const T*>(f.ptr[nc - 1]) + bz * p.f_bstride[nc - 1];

  // A chunk: prefix tuple pf, last-axis offset off.
  struct Cursor {
    int pf, off;
  };
  auto chunk = [&](int it) {
    const int ch = (int)blockIdx.y + it * S, pf = ch / cpp;
    return Cursor{pf, (ch - pf * cpp) * bk};
  };

  // This thread's copies of X: a fixed segment of vx bytes in rows xrow0,
  // xrow0 + xrstep, ... of every chunk (segments a row and vx are powers of two).
  const int vx = p.copy_x > 0 ? p.copy_x : TS;
  const int lsx = __ffs(bk * TS / vx) - 1;  // log2(copies a row)
  const int xseg = tid & ((1 << lsx) - 1), xrow0 = tid >> lsx, xrstep = NTHREADS >> lsx;
  const int xcol = xseg * (vx / TS);
  const T* xbase = x + (long long)(i0 + xrow0) * p.k + xcol;
  const long long xstep = (long long)xrstep * p.k;
  const unsigned xdst0 = (unsigned)(xrow0 * l.row_bytes + xseg * vx);
  const int vf = p.copy_f > 0 ? p.copy_f : TS;
  const int lsf = __ffs(BR * TS / vf) - 1;  // log2(copies a factor row)
  const int frows = bk + nlead;              // factor rows a stage holds

  // Factor row fr of the chunk at c: the last factor's row off + fr for
  // fr < bk (false past C_last), else leading factor d = fr - bk's row of the
  // chunk's prefix tuple. Sets the source row and the row's offset in a stage.
  auto frow = [&](int fr, const Cursor& c, const T*& src, int& dst) {
    if (fr < bk) {
      src = flast + (long long)(c.off + fr) * p.rank + r0;
      dst = l.fl + fr * l.frow_bytes;
      return c.off + fr < p.c_last;
    }
    const int d = fr - bk;
    const unsigned g = (unsigned)c.pf / (unsigned)p.lead_stride[d] % (unsigned)p.extent_c[d];
    src = reinterpret_cast<const T*>(f.ptr[d]) + bz * p.f_bstride[d] + (long long)g * p.rank +
          r0;
    dst = l.lead + d * BR * TS;
    return true;
  };

  // Copies of the chunk at c into ring slot.
  auto load_chunk = [&](const Cursor& c, int slot) {
    unsigned char* st = smem + slot * l.stage;
    const unsigned sst = sbase + slot * l.stage;
    const long long c0 = (long long)c.pf * p.c_last + c.off;  // the chunk's first column
    const int cleft = (int)p.c_last - c.off;  // columns of the chunk inside C_last
    if (p.copy_x == 0) {  // the last axis is not aligned for any copy width: elements
      const int n = BI * bk;
      for (int base = 0; base < n; base += NTHREADS * XLOADS) {
        T v[XLOADS];
#pragma unroll
        for (int u = 0; u < XLOADS; ++u) {
          const int e = base + u * NTHREADS + tid;
          const int row = e / bk, col = e - row * bk;
          const long long gi = (long long)i0 + row;
          v[u] = e < n && gi < p.extent_i && col < cleft ? x[gi * p.k + c0 + col]
                                                         : zero_val<T>();
        }
#pragma unroll
        for (int u = 0; u < XLOADS; ++u) {
          const int e = base + u * NTHREADS + tid;
          const int row = e / bk;
          if (e < n) *reinterpret_cast<T*>(st + row * l.row_bytes + (e - row * bk) * TS) = v[u];
        }
      }
    } else {
      // C_last * itemsize % vx == 0, so a copy is all in or all out of range
      const bool kin = xcol < cleft;
      const T* src = xbase + c0;
      unsigned dst = sst + xdst0;
      for (int row = xrow0; row < BI; row += xrstep, src += xstep, dst += xrstep * l.row_bytes) {
        const bool in = kin && i0 + row < p.extent_i;
        const void* s = in ? static_cast<const void*>(src) : static_cast<const void*>(x);
        if (vx == 16) cp_async<16>(dst, s, in ? 16 : 0);
        else if (vx == 8) cp_async<8>(dst, s, in ? 8 : 0);
        else cp_async<4>(dst, s, in ? 4 : 0);
      }
    }
    if (p.copy_f == 0) {
      for (int e = tid; e < frows * BR; e += NTHREADS) {
        const int fr = e / BR, col = e - fr * BR;
        const T* src;
        int dst;
        const bool in = frow(fr, c, src, dst) && col < rvalid;
        *reinterpret_cast<T*>(st + dst + col * TS) = in ? src[col] : zero_val<T>();
      }
    } else {
      for (int e = tid; e < frows << lsf; e += NTHREADS) {
        const int fr = e >> lsf, seg = e & ((1 << lsf) - 1), col = seg * (vf / TS);
        const T* src;
        int dst;
        const bool in = frow(fr, c, src, dst) && col < rvalid;  // R * itemsize % vf == 0
        const unsigned d = sst + dst + seg * vf;
        const void* s = in ? static_cast<const void*>(src + col) : static_cast<const void*>(x);
        if (vf == 16) cp_async<16>(d, s, in ? 16 : 0);
        else if (vf == 8) cp_async<8>(d, s, in ? 8 : 0);
        else cp_async<4>(d, s, in ? 4 : 0);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // One chunk: X (16 x 32-byte A tiles) times the last factor's rows (32-byte
  // x 8 B tiles) on the tensor cores into a zeroed partial, then
  // acc += P * partial, P the product of the chunk's leading-factor rows.
  const int g = lane >> 2, t = lane & 3;
  auto mma_chunk = [&](int slot) {
    const unsigned st = sbase + slot * l.stage;
    const unsigned fl = st + (unsigned)l.fl;
    const int ksteps = bk * TS / 32;
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
    for (int kk = 0; kk < ksteps; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(st + (wm * 16 * MT + mt * 16 + (lane & 15)) * l.row_bytes + kk * 32 +
                        (lane >> 4) * 16,
                    a[mt]);
      if constexpr (F32) {
        unsigned ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ah[mt][q] = round_tf32(a[mt][q]);
            al[mt][q] = __float_as_uint(__uint_as_float(a[mt][q]) - __uint_as_float(ah[mt][q]));
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // B(k, n) = A_last(k, n): rows kk * 8 + t and + 4, column g of the n-tile
          const float* b = reinterpret_cast<const float*>(
              smem + slot * l.stage + l.fl + (kk * 8 + t) * l.frow_bytes) +
              wn * 8 * NT + nt * 8 + g;
          const float b0 = b[0], b1 = b[l.frow_bytes];  // four rows on: frow_bytes floats
          const unsigned bh0 = round_tf32(__float_as_uint(b0));
          const unsigned bh1 = round_tf32(__float_as_uint(b1));
          const unsigned bl0 = __float_as_uint(b0 - __uint_as_float(bh0));
          const unsigned bl1 = __float_as_uint(b1 - __uint_as_float(bh1));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {  // 3xTF32, the small terms first
            mma_tf32(part[mt][nt], al[mt], bh0, bh1);
            mma_tf32(part[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(part[mt][nt], ah[mt], bh0, bh1);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; nt += NB) {
          // B from the row-major (k, n) factor rows by transposing loads
          unsigned b[4];
          if constexpr (NB == 2) {
            ldmatrix_x4_trans(fl + (kk * 16 + (lane & 15)) * l.frow_bytes +
                                  (wn * 8 * NT + nt * 8 + (lane >> 4) * 8) * 2,
                              b);
          } else {
            ldmatrix_x2_trans(fl + (kk * 16 + (lane & 15)) * l.frow_bytes + wn * 8 * NT * 2,
                              b[0], b[1]);
          }
#pragma unroll
          for (int q = 0; q < NB; ++q)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_bf16(part[mt][nt + q], a[mt], b[2 * q], b[2 * q + 1]);
        }
      }
    }
    // scale: P for this thread's columns, from the staged leading rows
    const T* lead = reinterpret_cast<const T*>(smem + slot * l.stage + l.lead);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 8 * NT + nt * 8 + 2 * t + j;
        float pv = 1.f;
        for (int d = 0; d < nlead; ++d) pv *= to_float(lead[d * BR + col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][j] = fmaf(pv, part[mt][nt][j], acc[mt][nt][j]);
          acc[mt][nt][2 + j] = fmaf(pv, part[mt][nt][2 + j], acc[mt][nt][2 + j]);
        }
      }
  };

  for (int s = 0; s < p.stages - 1; ++s) {  // fill the ring
    if (s < n_local) load_chunk(chunk(s), s);
    cp_async_commit();
  }
  for (int it = 0; it < n_local; ++it) {
    cp_async_wait(p.stages - 2);  // this thread's copies of chunk it have landed
    __syncthreads();  // everyone's have; everyone is done with chunk it - 1
    // ring copies: chunk it + stages - 1, into the slot chunk it - 1 freed
    {
      const int nxt = it + p.stages - 1;
      if (nxt < n_local) load_chunk(chunk(nxt), nxt % p.stages);
    }
    cp_async_commit();
    // MMA: chunk it's products on the tensor cores, scaled into the accumulators
    {
      mma_chunk(it % p.stages);
    }
  }
  cp_async_wait(0);

  // fragment (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of each tile
  float* o = out + ((long long)blockIdx.y * p.batch + bz) * p.extent_i * p.rank;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wn * 8 * NT + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gi = (long long)i0 + wm * 16 * MT + mt * 16 + g + 8 * h;
        if (gi >= p.extent_i) continue;
        if (col < rvalid) store_result(o + (gi * p.rank + r0 + col), acc[mt][nt][2 * h]);
        if (col + 1 < rvalid)
          store_result(o + (gi * p.rank + r0 + col + 1), acc[mt][nt][2 * h + 1]);
      }
    }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                     long long n, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += ws[q * n + e];
    store_result(out + e, s);
  }
}

// splitk_reduce_kernel's grid: 256 threads a CTA, at most 32 CTAs an SM of
// 132; the grid-stride loop takes the rest.
static inline void splitk_grid(long long n, long long* dims) {
  const long long blocks = ceil_div(n, 256);
  dims[0] = blocks > 132 * 32 ? 132 * 32 : blocks;
  dims[1] = dims[2] = 1;
}

template <typename T, int NC>
static int launch_mma(int block_i, int block_r, const TileProblem& p, const void* x,
                      const Factors& f, float* out, long long smem, cudaStream_t stream) {
  return dispatch_tiles(block_i, block_r, [&](auto mt, auto nt) {
    constexpr int MT = decltype(mt)::value, NT = decltype(nt)::value;
    auto kern = mttkrp_mma_kernel<T, NC, MT, NT>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    long long dims[3];
    tile_grid(p.extent_i, p.rank, 64 * MT, 16 * NT, p.n_splits, p.batch, dims);
    kern<<<grid_dim3(dims), NTHREADS, smem, stream>>>(p, reinterpret_cast<const T*>(x), f, out);
    return (int)cudaGetLastError();
  });
}

extern "C" {

// Bytes of dynamic shared memory the kernel takes for these blocks with
// ncontract contraction dims; -1 if the blocks are not ones it takes.
long long repro_mttkrp_smem_bytes(int tsize, int ncontract, int block_i, int block_k, int block_r,
                                  int stages) {
  if (ncontract < 1 || ncontract > MAX_CONTRACT ||
      !valid_blocks(tsize, block_i, block_k, block_r, stages))
    return -1;
  return make_tile_layout(tsize, ncontract, block_i, block_k, block_r, stages).total;
}

// One launch of the MTTKRP kernel. dtype: 0 float32, 1 bfloat16.
// specialized != 0 takes the 3-way kernel (ncontract must be 2).
// extents: I, C_1..C_{N-1}; factors: N-1 device pointers to (C_d, R) in the
// tensor's dtype. copy_x / copy_f: bytes a cp.async of X's last-axis runs /
// the factors' rows takes (16, 8 or 4; 0 for element loads), which the caller
// has checked against C_{N-1}, R, the pointers and the batch strides. batch:
// B problems of these extents (1 to MAX_BATCH), X's and each factor's
// elements from one problem to the next in x_bstride and f_bstrides (0 for a
// factor the batch shares). out: n_splits x batch slabs of (I, R) fp32, slab
// y b at (y B + b) I R. Returns a cudaError_t.
int repro_mttkrp_tile(int specialized, int dtype, int ncontract, const long long* extents,
                      int block_i, int block_k, int block_r, int stages, int rank, int n_splits,
                      int copy_x, int copy_f, int batch, long long x_bstride,
                      const long long* f_bstrides, const void* x, const long long* factors,
                      void* out, void* stream) {
  const int tsize = dtype == 0 ? 4 : 2;
  if (ncontract < 1 || ncontract > MAX_CONTRACT || (specialized && ncontract != 2) ||
      n_splits < 1 || rank < 1 || (dtype != 0 && dtype != 1) ||
      !valid_blocks(tsize, block_i, block_k, block_r, stages) || !valid_copy(copy_x) ||
      !valid_copy(copy_f) || batch < 1 || batch > MAX_BATCH || x_bstride < 0)
    return (int)cudaErrorInvalidValue;
  TileProblem p;
  Factors f;
  if (!make_tile_problem(ncontract, extents, block_k, stages, rank, n_splits, copy_x, copy_f,
                         factors, &p, &f))
    return (int)cudaErrorInvalidValue;
  p.batch = batch;
  p.x_bstride = x_bstride;
  for (int d = 0; d < ncontract; ++d) {
    if (f_bstrides[d] < 0) return (int)cudaErrorInvalidValue;
    p.f_bstride[d] = f_bstrides[d];
  }
  const long long smem =
      make_tile_layout(tsize, ncontract, block_i, block_k, block_r, stages).total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  using B16 = __nv_bfloat16;
  if (dtype == 0) {
    return specialized ? launch_mma<float, 2>(block_i, block_r, p, x, f, o, smem, s)
                       : launch_mma<float, 0>(block_i, block_r, p, x, f, o, smem, s);
  }
  return specialized ? launch_mma<B16, 2>(block_i, block_r, p, x, f, o, smem, s)
                     : launch_mma<B16, 0>(block_i, block_r, p, x, f, o, smem, s);
}

// out[e] = sum_{q < splits} ws[q * n + e], in q order. Returns a cudaError_t.
int repro_splitk_reduce(const void* ws, void* out, long long n, int splits, void* stream) {
  if (n < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  long long dims[3];
  splitk_grid(n, dims);
  splitk_reduce_kernel<<<grid_dim3(dims), 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(ws), reinterpret_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}

// The launch grid repro_mttkrp_tile takes for these extents and blocks (I,
// R, the row and rank tiles, the splits and the batch), into dims (x, y, z).
// Returns a cudaError_t.
int repro_mttkrp_grid(long long extent_i, int rank, int block_i, int block_r, int n_splits,
                      int batch, long long* dims) {
  if (extent_i < 1 || rank < 1 || (block_i != 64 && block_i != 128) ||
      (block_r != 16 && block_r != 32 && block_r != 64 && block_r != 128) || n_splits < 1 ||
      batch < 1 || batch > MAX_BATCH)
    return (int)cudaErrorInvalidValue;
  tile_grid(extent_i, rank, block_i, block_r, n_splits, batch, dims);
  return 0;
}

// The launch grid repro_splitk_reduce takes for n outputs. Returns a
// cudaError_t.
int repro_splitk_reduce_grid(long long n, long long* dims) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  splitk_grid(n, dims);
  return 0;
}

}  // extern "C"

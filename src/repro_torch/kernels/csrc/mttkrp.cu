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
//   * A ring of `stages` chunk buffers in shared memory, filled by cp.async
//     (16-byte .cg copies, or 8/4-byte .ca copies where the last axis' byte
//     length or a base pointer is not 16-byte aligned; bf16 of odd length takes
//     element loads). A chunk's buffer holds its X columns (BI rows, 16 bytes
//     of row skew), the block_k rows of the last factor it multiplies, and one
//     row of each leading factor (P's). The zero-fill form (src-size 0) masks
//     the ragged row and last-axis edges, so X is never padded. The copies of
//     chunk s + stages - 1 are in flight while chunk s is multiplied, and one
//     barrier a chunk separates the two.
//   * Tensor cores, fragments by ldmatrix (conflict-free through the skews):
//     fp32 X runs 3xTF32 on mma.sync.m16n8k8.tf32 (X_lo A_hi + X_hi A_lo +
//     X_hi A_hi), which keeps fp32-level error: the hi terms are rounded to
//     tf32 as cvt.rna.tf32.f32 rounds (by an integer add and mask, which keeps
//     the conversion unit out of the inner loop), the lo terms are the exact
//     fp32 remainders, whose low 13 bits the tensor core ignores (as CUTLASS's
//     fast 3xTF32 does): about 2^-20 of a product at most. bf16 X runs one
//     mma.sync.m16n8k16.bf16 against the bf16 factor itself, which is exact;
//     P is applied in fp32, as the reference's fp32 W is.
//   * Accumulators are fp32 registers: 8 warps as 4 (rows) x 2 (columns), each
//     MT x NT tiles of 16 x 8. The tensor cores' own fp32 adds truncate, which
//     over the ~10^4 products of a split of K biases the sum by ~1e-4 of its
//     size; a chunk's products go to a zeroed partial, which ordinary
//     (round-to-nearest) fp32 multiply-adds fold into the accumulators.
//   * Split-K over the chunks: gridDim.y = S CTAs share a row tile, split y
//     takes chunks y, y + S, ... (so the CTAs in flight read neighbouring
//     runs of the same rows) and writes its own fp32 (I, R) slab;
//     splitk_reduce_kernel adds the slabs in slab order. No atomics: results
//     repeat bit for bit. Offsets into X are 64-bit (I K is 5.8e9 at 180^4);
//     I and K themselves stay below 2^31, so chunk indices are 32-bit.
#include "common.cuh"

struct TileProblem {
  int ncontract;                         // N - 1
  int rank;                              // R
  int block_k;                           // last-axis indices a chunk
  int stages;                            // ring depth
  int n_splits;                          // CTAs along the chunks per output tile
  int copy_x;                            // bytes a copy of X: 16, 8, 4, 0 = elements
  int copy_f;                            // the same for factor rows
  long long extent_i;                    // I
  long long k;                           // K = prod C_d
  long long c_last;                      // C_{N-1}
  long long n_prefix;                    // K / C_last: leading index tuples
  long long chunks_per_prefix;           // ceil(C_last / block_k)
  long long extent_c[MAX_CONTRACT];      // C_1 .. C_{N-1}
  long long lead_stride[MAX_CONTRACT];   // stride of leading digit d in a prefix index
};

// Shared-memory layout, computed identically on host and device (and in
// repro_torch/engine/plan.py:mttkrp_kernel_smem_bytes): `stages` chunk
// buffers, each
//   X columns (BI rows of row_bytes) | block_k last-factor rows of frow_bytes
//   | N - 2 leading-factor rows of BR elements (input dtype throughout).
struct TileLayout {
  int row_bytes;    // block_k * itemsize + 16 bytes of skew
  int frow_bytes;   // BR * itemsize + skew (32 bytes fp32, 16 bf16)
  int fl;     // offset of the last-factor rows inside a stage
  int lead;   // offset of the leading-factor rows inside a stage
  int stage;  // bytes a stage
  int total;
};

static __host__ __device__ TileLayout make_tile_layout(int tsize, int nc, int bi, int bk, int br,
                                                       int stages) {
  TileLayout l;
  l.row_bytes = bk * tsize + 16;
  l.frow_bytes = br * tsize + (tsize == 4 ? 32 : 16);
  l.fl = bi * l.row_bytes;
  l.lead = l.fl + bk * l.frow_bytes;
  l.stage = l.lead + (nc - 1) * br * tsize;
  l.total = stages * l.stage;
  return l;
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One asynchronous copy of V bytes; src_bytes 0 writes V zero bytes.
template <int V>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, int src_bytes) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(V),
                 "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's copy groups are pending (n = stages
// - 2 < 3).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned addr, unsigned& r0, unsigned& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}


// An fp32 value's bits rounded to tf32 (10 mantissa bits, nearest, ties
// away from zero): what cvt.rna.tf32.f32 gives for finite values, in two
// integer operations instead of the conversion unit.
__device__ __forceinline__ unsigned round_tf32(unsigned bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// d += a b on one 16 x 8 tile: fp32 inputs as tf32 (k = 8), bf16 (k = 16).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
  const T* flast = reinterpret_cast<const T*>(f.ptr[nc - 1]);

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
    src = reinterpret_cast<const T*>(f.ptr[d]) + (long long)g * p.rank + r0;
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
  float* o = out + (long long)blockIdx.y * p.extent_i * p.rank;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wn * 8 * NT + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gi = (long long)i0 + wm * 16 * MT + mt * 16 + g + 8 * h;
        if (gi >= p.extent_i) continue;
        if (col < rvalid) o[gi * p.rank + r0 + col] = acc[mt][nt][2 * h];
        if (col + 1 < rvalid) o[gi * p.rank + r0 + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
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

template <typename T, int NC, int MT, int NT>
static int launch_mma(const TileProblem& p, const void* x, const Factors& f, float* out,
                      long long smem, cudaStream_t stream) {
  auto kern = mttkrp_mma_kernel<T, NC, MT, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long gi = ceil_div(p.extent_i, 64 * MT);
  const long long gr = ceil_div(p.rank, 16 * NT);
  dim3 grid((unsigned)(gi * gr), (unsigned)p.n_splits);
  kern<<<grid, NTHREADS, smem, stream>>>(p, reinterpret_cast<const T*>(x), f, out);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
static int dispatch_tiles(int block_i, int block_r, const TileProblem& p, const void* x,
                          const Factors& f, float* out, long long smem, cudaStream_t s) {
  const bool m2 = block_i == 128;
  switch (block_r) {
    case 16: return m2 ? launch_mma<T, NC, 2, 1>(p, x, f, out, smem, s)
                       : launch_mma<T, NC, 1, 1>(p, x, f, out, smem, s);
    case 32: return m2 ? launch_mma<T, NC, 2, 2>(p, x, f, out, smem, s)
                       : launch_mma<T, NC, 1, 2>(p, x, f, out, smem, s);
    case 64: return m2 ? launch_mma<T, NC, 2, 4>(p, x, f, out, smem, s)
                       : launch_mma<T, NC, 1, 4>(p, x, f, out, smem, s);
    default: return m2 ? launch_mma<T, NC, 2, 8>(p, x, f, out, smem, s)
                       : launch_mma<T, NC, 1, 8>(p, x, f, out, smem, s);
  }
}

static bool valid_blocks(int tsize, int block_i, int block_k, int block_r, int stages) {
  const int kb = block_k * tsize;
  return (block_i == 64 || block_i == 128) &&
         (block_r == 16 || block_r == 32 || block_r == 64 || block_r == 128) &&
         (kb == 32 || kb == 64 || kb == 128 || kb == 256) && stages >= 2 && stages <= 4;
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
// has checked against C_{N-1}, R and the pointers. out: n_splits slabs of (I, R) fp32.
// Returns a cudaError_t.
int repro_mttkrp_tile(int specialized, int dtype, int ncontract, const long long* extents,
                      int block_i, int block_k, int block_r, int stages, int rank, int n_splits,
                      int copy_x, int copy_f, const void* x, const long long* factors, void* out,
                      void* stream) {
  const int tsize = dtype == 0 ? 4 : 2;
  auto copy_ok = [&](int v) { return v == 0 || v == 4 || v == 8 || v == 16; };
  if (ncontract < 1 || ncontract > MAX_CONTRACT || (specialized && ncontract != 2) ||
      n_splits < 1 || rank < 1 || (dtype != 0 && dtype != 1) || extents[0] < 1 ||
      !valid_blocks(tsize, block_i, block_k, block_r, stages) || !copy_ok(copy_x) ||
      !copy_ok(copy_f))
    return (int)cudaErrorInvalidValue;
  TileProblem p;
  p.ncontract = ncontract;
  p.rank = rank;
  p.block_k = block_k;
  p.stages = stages;
  p.n_splits = n_splits;
  p.copy_x = copy_x;
  p.copy_f = copy_f;
  p.extent_i = extents[0];
  p.k = 1;
  Factors f;
  for (int d = 0; d < MAX_CONTRACT; ++d) {
    p.extent_c[d] = d < ncontract ? extents[1 + d] : 1;
    if (p.extent_c[d] < 1) return (int)cudaErrorInvalidValue;
    p.k *= p.extent_c[d];
    f.ptr[d] = d < ncontract ? reinterpret_cast<const void*>(factors[d]) : nullptr;
  }
  if (p.extent_i >= (1LL << 31) || p.k >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  p.c_last = p.extent_c[ncontract - 1];
  p.n_prefix = p.k / p.c_last;
  p.chunks_per_prefix = ceil_div(p.c_last, block_k);
  long long stride = 1;
  for (int d = ncontract - 2; d >= 0; --d) {
    p.lead_stride[d] = stride;
    stride *= p.extent_c[d];
  }
  for (int d = ncontract - 1; d < MAX_CONTRACT; ++d) p.lead_stride[d] = 1;
  const long long smem =
      make_tile_layout(tsize, ncontract, block_i, block_k, block_r, stages).total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  if (dtype == 0) {
    return specialized ? dispatch_tiles<float, 2>(block_i, block_r, p, x, f, o, smem, s)
                       : dispatch_tiles<float, 0>(block_i, block_r, p, x, f, o, smem, s);
  }
  using B16 = __nv_bfloat16;
  return specialized ? dispatch_tiles<B16, 2>(block_i, block_r, p, x, f, o, smem, s)
                     : dispatch_tiles<B16, 0>(block_i, block_r, p, x, f, o, smem, s);
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

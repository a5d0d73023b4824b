// The cp.async ring and the tensor-core chunk product shared by the kernels
// that stream a tensor as a row-major matrix: mttkrp.cu (the MTTKRP kernel),
// sweep.cu (the fused (B0, P) pair) and multi_ttm.cu (the kept-mode
// Multi-TTM).
//
// A CTA of 256 threads owns BI = 64 MT rows of the matrix and BR = 16 NT
// columns of the matrix it multiplies (a factor, or a Tucker matrix). The
// rows are walked in chunks of block_k consecutive columns (32, 64, 128 or
// 256 bytes of each row). A ring of `stages` chunk buffers in shared memory
// is filled by cp.async (16-byte .cg copies, or 8/4-byte .ca copies where a
// run's byte length or a base pointer is not 16-byte aligned; bf16 of odd
// length takes element loads). A buffer holds the chunk's X columns (BI rows,
// 16 bytes of row skew), the block_k rows of the matrix it multiplies, and
// `nc - 1` further rows of BR elements a kernel wants beside them (the
// leading factors' rows of the chunk's index tuple). The zero-fill form
// (src-size 0) masks the ragged row and column edges, so nothing is padded.
//
// chunk_product multiplies one chunk on the tensor cores into a zeroed fp32
// partial, with fragments by ldmatrix (conflict-free through the skews):
// fp32 X runs 3xTF32 on mma.sync.m16n8k8.tf32 (X_lo B_hi + X_hi B_lo +
// X_hi B_hi), which keeps fp32-level error: the hi terms are rounded to tf32
// as cvt.rna.tf32.f32 rounds (by an integer add and mask, which keeps the
// conversion unit out of the inner loop), the lo terms are the exact fp32
// remainders, whose low 13 bits the tensor core ignores (as CUTLASS's fast
// 3xTF32 does): about 2^-20 of a product at most. bf16 X runs one
// mma.sync.m16n8k16.bf16 against the bf16 matrix itself, which is exact.
// The tensor cores' own fp32 adds truncate; over ~10^4 products that biases
// a sum by ~1e-4 of its size, so every kernel folds each chunk's fresh
// partial into its sums with ordinary (round-to-nearest) fp32 adds.
// 8 warps split a tile as 4 (rows) x 2 (columns), each MT x NT fragments
// of 16 x 8; fragment element q of tile (mt, nt) is row
// wm 16 MT + mt 16 + g + 8 (q / 2), column wn 8 NT + nt 8 + 2 t + q % 2,
// g = lane / 4, t = lane % 4.
#pragma once

#include <type_traits>

#include "common.cuh"

// The problem of the MTTKRP and fused-pair kernels: a mode-0-canonical
// X (I, C_1..C_{N-1}) seen as an (I, K) matrix, K = prod C_d.
struct TileProblem {
  int ncontract;                         // N - 1
  int rank;                              // R
  int block_k;                           // last-axis indices a chunk
  int stages;                            // ring depth
  int n_splits;                          // CTAs along the contraction per output tile
  int copy_x;                            // bytes a copy of X: 16, 8, 4, 0 = elements
  int copy_f;                            // the same for factor rows
  long long extent_i;                    // I
  long long k;                           // K = prod C_d
  long long c_last;                      // C_{N-1}
  long long n_prefix;                    // K / C_last: leading index tuples
  long long chunks_per_prefix;           // ceil(C_last / block_k)
  long long extent_c[MAX_CONTRACT];      // C_1 .. C_{N-1}
  long long lead_stride[MAX_CONTRACT];   // stride of leading digit d in a prefix index
  int batch;                             // B problems, blockIdx.z (1 unbatched)
  long long x_bstride;                   // elements from one problem's X to the next
  long long f_bstride[MAX_CONTRACT];     // the same for each factor; 0: shared by all
};

// Shared-memory layout of the ring, computed identically on host and device
// (and in repro_torch/engine/plan.py:mttkrp_kernel_smem_bytes): `stages`
// chunk buffers, each
//   X columns (BI rows of row_bytes) | block_k matrix rows of frow_bytes
//   | nc - 1 leading-factor rows of BR elements (input dtype throughout).
struct TileLayout {
  int row_bytes;    // block_k * itemsize + 16 bytes of skew
  int frow_bytes;   // BR * itemsize + skew (32 bytes fp32, 16 bf16)
  int fl;     // offset of the matrix rows inside a stage
  int lead;   // offset of the leading-factor rows inside a stage
  int stage;  // bytes a stage
  int total;
};

static inline __host__ __device__ TileLayout make_tile_layout(int tsize, int nc, int bi, int bk,
                                                              int br, int stages) {
  TileLayout l;
  l.row_bytes = bk * tsize + 16;
  l.frow_bytes = br * tsize + (tsize == 4 ? 32 : 16);
  l.fl = bi * l.row_bytes;
  l.lead = l.fl + bk * l.frow_bytes;
  l.stage = l.lead + (nc - 1) * br * tsize;
  l.total = stages * l.stage;
  return l;
}

// Blocks the ring kernels take: 64 or 128 rows, 16 to 128 columns, chunks of
// 32 to 256 bytes, 2 to 4 stages (engine/plan.py: MTTKRP_BLOCK_I,
// MTTKRP_BLOCK_R, MTTKRP_CHUNK_BYTES).
static inline bool valid_blocks(int tsize, int block_i, int block_k, int block_r, int stages) {
  const int kb = block_k * tsize;
  return (block_i == 64 || block_i == 128) &&
         (block_r == 16 || block_r == 32 || block_r == 64 || block_r == 128) &&
         (kb == 32 || kb == 64 || kb == 128 || kb == 256) && stages >= 2 && stages <= 4;
}

static inline bool valid_copy(int v) { return v == 0 || v == 4 || v == 8 || v == 16; }

// The TileProblem of a canonical (I, C_1..C_nc) X; false where an extent is
// out of range (I and K stay below 2^31, so chunk indices are 32-bit).
static inline bool make_tile_problem(int ncontract, const long long* extents, int block_k,
                                     int stages, int rank, int n_splits, int copy_x, int copy_f,
                                     const long long* factors, TileProblem* p, Factors* f) {
  p->ncontract = ncontract;
  p->rank = rank;
  p->block_k = block_k;
  p->stages = stages;
  p->n_splits = n_splits;
  p->copy_x = copy_x;
  p->copy_f = copy_f;
  p->extent_i = extents[0];
  p->k = 1;
  for (int d = 0; d < MAX_CONTRACT; ++d) {
    p->extent_c[d] = d < ncontract ? extents[1 + d] : 1;
    if (p->extent_c[d] < 1) return false;
    p->k *= p->extent_c[d];
    f->ptr[d] = d < ncontract ? reinterpret_cast<const void*>(factors[d]) : nullptr;
  }
  if (p->extent_i < 1 || p->extent_i >= (1LL << 31) || p->k >= (1LL << 31)) return false;
  p->c_last = p->extent_c[ncontract - 1];
  p->n_prefix = p->k / p->c_last;
  p->chunks_per_prefix = ceil_div(p->c_last, block_k);
  long long stride = 1;
  for (int d = ncontract - 2; d >= 0; --d) {
    p->lead_stride[d] = stride;
    stride *= p->extent_c[d];
  }
  for (int d = ncontract - 1; d < MAX_CONTRACT; ++d) p->lead_stride[d] = 1;
  p->batch = 1;  // one problem; repro_mttkrp_tile sets a batch
  p->x_bstride = 0;
  for (int d = 0; d < MAX_CONTRACT; ++d) p->f_bstride[d] = 0;
  return true;
}

// The MTTKRP and pair kernels' launch grid: (row tiles x rank tiles, splits,
// batch); blockIdx.x / rank tiles is the row tile, % rank tiles the rank tile.
static inline void tile_grid(long long extent_i, int rank, int block_i, int block_r,
                             int n_splits, int batch, long long* dims) {
  dims[0] = ceil_div(extent_i, block_i) * ceil_div(rank, block_r);
  dims[1] = n_splits;
  dims[2] = batch;
}

// launch(MT, NT) with the tile shape as compile-time constants
// (std::integral_constant), from the block sizes the plan gives.
template <typename L>
static inline int dispatch_tiles(int block_i, int block_r, L&& launch) {
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  using I8 = std::integral_constant<int, 8>;
  const bool m2 = block_i == 128;
  switch (block_r) {
    case 16: return m2 ? launch(I2(), I1()) : launch(I1(), I1());
    case 32: return m2 ? launch(I2(), I2()) : launch(I1(), I2());
    case 64: return m2 ? launch(I2(), I4()) : launch(I1(), I4());
    default: return m2 ? launch(I2(), I8()) : launch(I1(), I8());
  }
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

// One copy of v (16, 8 or 4) bytes, zero bytes where !in.
__device__ __forceinline__ void cp_async_v(int v, unsigned dst, const void* src, bool in) {
  if (v == 16) cp_async<16>(dst, src, in ? 16 : 0);
  else if (v == 8) cp_async<8>(dst, src, in ? 8 : 0);
  else cp_async<4>(dst, src, in ? 4 : 0);
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

// ---- the ring's copies ------------------------------------------------------

// This thread's share of a chunk's X copies: a fixed segment of vx bytes in
// rows row0, row0 + rstep, ... (segments a row and vx are powers of two).
struct XCopy {
  int vx;        // bytes a copy (the element size for element loads)
  int row0, rstep;
  int col;       // the segment's first column
  unsigned dst;  // byte offset of the first copy inside a stage
};

template <typename T>
__device__ __forceinline__ XCopy make_xcopy(int copy_x, int bk, const TileLayout& l) {
  constexpr int TS = (int)sizeof(T);
  XCopy c;
  c.vx = copy_x > 0 ? copy_x : TS;
  const int ls = __ffs(bk * TS / c.vx) - 1;  // log2(copies a row)
  const int seg = threadIdx.x & ((1 << ls) - 1);
  c.row0 = threadIdx.x >> ls;
  c.rstep = NTHREADS >> ls;
  c.col = seg * (c.vx / TS);
  c.dst = (unsigned)(c.row0 * l.row_bytes + seg * c.vx);
  return c;
}

// The X columns of one chunk into the stage at st (shared address sst): BI
// rows from `rows` (row 0 at the chunk's first column, rows ld elements
// apart); rows at or past nrows and columns at or past cleft are zero. With
// copies (copy_x > 0) the caller has checked that every copy is all in or
// all out of range (cleft * itemsize % copy_x == 0). `any` is a valid
// address for the zero-fill copies.
template <typename T, int BI>
__device__ __forceinline__ void copy_x_chunk(unsigned char* st, unsigned sst, const TileLayout& l,
                                             const XCopy& c, int copy_x, const T* rows,
                                             long long ld, long long nrows, int cleft, int bk,
                                             const void* any) {
  constexpr int TS = (int)sizeof(T);
  if (copy_x == 0) {  // the runs are not aligned for any copy width: elements
    const int n = BI * bk;
    for (int base = 0; base < n; base += NTHREADS * XLOADS) {
      T v[XLOADS];
#pragma unroll
      for (int u = 0; u < XLOADS; ++u) {
        const int e = base + u * NTHREADS + threadIdx.x;
        const int row = e / bk, col = e - row * bk;
        v[u] = e < n && row < nrows && col < cleft ? rows[row * ld + col] : zero_val<T>();
      }
#pragma unroll
      for (int u = 0; u < XLOADS; ++u) {
        const int e = base + u * NTHREADS + threadIdx.x;
        const int row = e / bk;
        if (e < n) *reinterpret_cast<T*>(st + row * l.row_bytes + (e - row * bk) * TS) = v[u];
      }
    }
    return;
  }
  const bool kin = c.col < cleft;
  const T* src = rows + c.row0 * ld + c.col;
  const long long step = c.rstep * ld;
  unsigned dst = sst + c.dst;
  for (int row = c.row0; row < BI; row += c.rstep, src += step, dst += c.rstep * l.row_bytes) {
    const bool in = kin && row < nrows;
    cp_async_v(c.vx, dst, in ? static_cast<const void*>(src) : any, in);
  }
}

// The matrix rows of one chunk (and any rows beside them): `frows` rows of
// BR elements; frow(fr, src, dst) sets row fr's source and its byte offset
// in the stage and says whether it is in range; columns at or past rvalid
// are zero. copy_f: bytes a copy, checked by the caller against the row
// length and the pointers (0: element loads).
template <typename T, int BR, typename F>
__device__ __forceinline__ void copy_rows(unsigned char* st, unsigned sst, int copy_f, int frows,
                                          int rvalid, const void* any, F&& frow) {
  constexpr int TS = (int)sizeof(T);
  if (copy_f == 0) {
    for (int e = threadIdx.x; e < frows * BR; e += NTHREADS) {
      const int fr = e / BR, col = e - fr * BR;
      const T* src;
      int dst;
      const bool in = frow(fr, src, dst) && col < rvalid;
      *reinterpret_cast<T*>(st + dst + col * TS) = in ? src[col] : zero_val<T>();
    }
    return;
  }
  const int lsf = __ffs(BR * TS / copy_f) - 1;  // log2(copies a row)
  for (int e = threadIdx.x; e < frows << lsf; e += NTHREADS) {
    const int fr = e >> lsf, seg = e & ((1 << lsf) - 1), col = seg * (copy_f / TS);
    const T* src;
    int dst;
    const bool in = frow(fr, src, dst) && col < rvalid;  // rows * itemsize % copy_f == 0
    cp_async_v(copy_f, sst + dst + seg * copy_f, in ? static_cast<const void*>(src + col) : any,
               in);
  }
}

// ---- the tensor cores -------------------------------------------------------

// part = the chunk in the stage at stp (shared address st): its X columns
// (16 x 32-byte A tiles) times its block_k matrix rows (32-byte x 8 B
// tiles), this warp's MT x NT fragments, from zero.
template <typename T, int MT, int NT>
__device__ __forceinline__ void chunk_product(const unsigned char* stp, unsigned st,
                                              const TileLayout& l, int bk, int wm, int wn,
                                              int lane, float (&part)[MT][NT][4]) {
  constexpr int TS = (int)sizeof(T);
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NB = NT >= 2 ? 2 : 1;  // n-tiles one bf16 ldmatrix feeds
  const int g = lane >> 2, t = lane & 3;
  const unsigned fl = st + (unsigned)l.fl;
  const int ksteps = bk * TS / 32;
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
        // B(k, n) = the matrix row kk * 8 + t (and + 4), column g of the n-tile
        const float* b = reinterpret_cast<const float*>(stp + l.fl + (kk * 8 + t) * l.frow_bytes) +
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
        // B from the row-major (k, n) matrix rows by transposing loads
        unsigned b[4];
        if constexpr (NB == 2) {
          ldmatrix_x4_trans(fl + (kk * 16 + (lane & 15)) * l.frow_bytes +
                                (wn * 8 * NT + nt * 8 + (lane >> 4) * 8) * 2,
                            b);
        } else {
          ldmatrix_x2_trans(fl + (kk * 16 + (lane & 15)) * l.frow_bytes + wn * 8 * NT * 2, b[0],
                            b[1]);
        }
#pragma unroll
        for (int q = 0; q < NB; ++q)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(part[mt][nt + q], a[mt], b[2 * q], b[2 * q + 1]);
      }
    }
  }
}

// d += s, elementwise over a warp's fragments (round-to-nearest fp32 adds).
template <int MT, int NT>
__device__ __forceinline__ void add_fragments(float (&d)[MT][NT][4], const float (&s)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[mt][nt][q] += s[mt][nt][q];
}

template <int MT, int NT>
__device__ __forceinline__ void zero_fragments(float (&d)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[mt][nt][q] = 0.f;
}

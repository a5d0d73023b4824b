// The kept-mode Multi-TTM (the Tucker/HOOI workhorse) for Hopper (sm_90a).
//
// multi_ttm_mma_kernel<T, MT, NT> replaces src/repro/kernels/multi_ttm.py:
// multi_ttm_keep_pallas (_kernel). For a kept-mode-first X (I, C_1..C_k) and
// k matrices A_d (C_d, R_d) it computes
//   O(i, r_1..r_k) = sum_c X(i, c_1..c_k) prod_d A_d(c_d, r_d),
// an fp32 (I, prod R_d) output, columns in C order over (r_1..r_k).
//
// The TPU kernel builds the whole Kronecker weight each grid step: 2 |X|
// prod R_d operations. Here the modes are contracted one after another and
// the weight never exists, so the kernel is bound by reading X once (4.0e9 B
// at 1000^3, 1.19 ms at 3.35 TB/s). Step 1 is the bulk of the work and runs
// on ring.cuh's cp.async ring and tensor cores, as the MTTKRP kernel does:
//   * X is the row-major matrix of rows (i, c_1..c_{k-1}) by C_k. A tile is
//     BI = 64 MT (64, 128 or 192) consecutive rows that differ in c_{k-1} only (one outer
//     tuple u = (i, c_1..c_{k-2}), ragged where C_{k-1} ends), walked in
//     chunks of block_k columns; T(rows, r_k) = X_rows A_k is multiplied on
//     the tensor cores (3xTF32 for fp32, bf16 mma.sync on the exact matrix),
//     each chunk's fresh partial added to T in fp32 registers;
//   * when a tile's last chunk is done, T goes to shared memory and the
//     leading modes are folded into the output tile O(i, :) in shared memory
//     (prod R_d fp32 words: 4 KB at ranks (32, 32), 16 KB at (16, 16, 16)),
//     on the CUDA cores (a few per cent of step 1's operations):
//     V(r_{k-1}, r_k) = sum_{c_{k-1} in the tile} A_{k-1}(c_{k-1}, r_{k-1})
//     T(c_{k-1}, r_k), a thread per 4 x 4 block of V (its rows split over up
//     to 8 lanes and added by shuffles when blocks are few), then
//     O(r_1..r_{k-2}, :, :) += w(r_1..r_{k-2}) V with
//     w = prod_{d < k-1} A_d(c_d(u), r_d) (w = 1 at k = 2); each O element is
//     owned by one thread, its sum taken in tile order. The next tile's
//     A_{k-1} rows and w load while a fold updates O. The fold is a fixed
//     cost a tile: scripts/probe_ring.py times it and its steps.
// So the output never forces few rows onto the tensor cores. A CTA owns one
// i and a rank tile of r_k (X is read once for R_k <= 128) and walks its
// tiles; the tiles of one i are split over gridDim.y = S CTAs in contiguous
// ranges, each writing its own fp32 slab of an (S, I, prod R_d) workspace,
// and mttkrp.cu:splitk_reduce_kernel adds the slabs in slab order: no
// atomics, results repeat bit for bit. With one contraction axis (k = 1) a
// tile is BI consecutive i and T is the output itself (no split). Ragged
// edges are masked by the ring's zero-fill; nothing is padded. A batch of B
// problems of one shape is one launch: blockIdx.z = b, X and each matrix
// offset by b times their batch strides (64-bit; a matrix's stride 0 when
// the batch shares it), split y of problem b writing slab y b of an
// (S, B, I, prod R_d) workspace.
#include "ring.cuh"

struct TtmProblem {
  int ncontract;     // k
  int block_k;       // C_k indices a chunk
  int stages;        // ring depth
  int n_splits;      // CTAs along one i's tiles (1 when k = 1)
  int copy_x;        // bytes a copy of X: 16, 8, 4, 0 = elements
  int copy_f;        // the same for A_k's rows
  int rank_last;     // R_k
  int rank_prev;     // R_{k-1} (1 when k = 1)
  int n_w;           // prod R_1..R_{k-2}: the weights w of an outer tuple
  int mtiles;        // tiles along c_{k-1} (along i when k = 1)
  long long extent_i;        // I
  long long c_last;          // C_k
  long long m;               // C_{k-1} (I when k = 1)
  long long n_outer;         // prod C_1..C_{k-2}: outer tuples of one i
  long long extent_c[MAX_CONTRACT];
  long long outer_stride[MAX_CONTRACT];  // stride of c_d in an outer tuple index, d < k - 2
  int rank[MAX_CONTRACT];
  int batch;                             // B problems, blockIdx.z (1 unbatched)
  long long x_bstride;                   // elements from one problem's X to the next
  long long m_bstride[MAX_CONTRACT];     // the same for each matrix; 0: shared by all
};

// Shared-memory layout, computed identically on host and device (and in
// repro_torch/engine/plan.py:multi_ttm_kernel_smem_bytes): the ring (no rows
// beside A_k's) | for k >= 2, fp32: T (BI x (BR + 4)) | A_{k-1}'s tile rows
// (BI x R4, R4 = R_{k-1} rounded up to 4, zero-padded) | w (n_w, rounded up
// to 4) | V (R4 x BR) | O (n_w R_{k-1} x ocols), ocols = min(BR, R_k).
struct TtmLayout {
  TileLayout ring;
  int ldt, ocols;
  long long ts, as, ws, vs, os, total;  // byte offsets
};

static inline __host__ __device__ TtmLayout make_ttm_layout(int tsize, int k, int bi, int bk,
                                                            int br, int stages, int rank_prev,
                                                            int rank_last, int n_w) {
  TtmLayout l;
  l.ring = make_tile_layout(tsize, 1, bi, bk, br, stages);
  l.ldt = br + 4;
  l.ocols = br < rank_last ? br : rank_last;
  l.ts = l.as = l.ws = l.vs = l.os = l.total = l.ring.total;
  if (k >= 2) {
    l.as = l.ts + 4LL * bi * l.ldt;
    l.ws = l.as + 4LL * bi * round_up(rank_prev, 4);
    l.vs = l.ws + 4LL * round_up(n_w, 4);
    l.os = l.vs + 4LL * round_up(rank_prev, 4) * br;
    l.total = l.os + 4LL * n_w * rank_prev * l.ocols;
  }
  return l;
}

template <typename T, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS, NT == 8 || MT * NT > 8 ? 1 : 2)
multi_ttm_mma_kernel(TtmProblem p, const T* __restrict__ x, Factors f, float* __restrict__ out) {
  constexpr int BI = 64 * MT, BR = 16 * NT, TS = (int)sizeof(T);
  const int k = p.ncontract, bk = p.block_k, rp = p.rank_prev, rl = p.rank_last;
  const int rp4 = (int)round_up(rp, 4);  // row stride of A_{k-1}'s tile rows
  const TtmLayout lt = make_ttm_layout(TS, k, BI, bk, BR, p.stages, rp, rl, p.n_w);
  const TileLayout& l = lt.ring;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sbase = smem_u32(smem);
  float* ts = reinterpret_cast<float*>(smem + lt.ts);
  float* as = reinterpret_cast<float*>(smem + lt.as);
  float* ws = reinterpret_cast<float*>(smem + lt.ws);
  float* os = reinterpret_cast<float*>(smem + lt.os);
  float* vs = reinterpret_cast<float*>(smem + lt.vs);

  const int gr = (int)ceil_div(rl, BR);
  const int unit = (int)(blockIdx.x / gr);  // i (k >= 2) or the row tile (k = 1)
  const int r0 = (int)(blockIdx.x % gr) * BR;
  const int rvalid = rl - r0 < BR ? rl - r0 : BR;
  const int y = (int)blockIdx.y, S = p.n_splits;
  const int cpp = (int)ceil_div(p.c_last, bk);
  // this CTA's tiles [q_begin, q_end) of unit's n_outer * mtiles; tile and
  // chunk indices stay below prod C < 2^31 (checked by the caller)
  int q_begin = 0, q_end = 1;
  if (k >= 2) {
    const long long nq = p.n_outer * p.mtiles;
    q_begin = (int)(y * nq / S);
    q_end = (int)((y + 1) * nq / S);
  }
  const int n_local = (q_end - q_begin) * cpp;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp >> 1, wn = warp & 1;  // 4 warps along rows, 2 along columns
  const int g = lane >> 2, t = lane & 3;
  const long long bz = blockIdx.z;  // the batch element: 64-bit offsets
  const long long prod_r = (long long)p.n_w * rp * rl;
  x += bz * p.x_bstride;
  out += ((long long)y * p.batch + bz) * p.extent_i * prod_r;  // this split's slab of b
  const T* alast = reinterpret_cast<const T*>(f.ptr[k - 1]) + bz * p.m_bstride[k - 1];
  // A_{k-1}'s rows of element b
  const T* aprev = k >= 2 ? reinterpret_cast<const T*>(f.ptr[k - 2]) + bz * p.m_bstride[k - 2]
                          : nullptr;

  // Tile q: its first row in the (rows, C_k) matrix and its rows in range.
  struct Tile {
    long long row0, nrows, m0;  // m0: first c_{k-1}
    int uo;                     // outer tuple (c_1..c_{k-2}) of the unit
  };
  auto tile = [&](int q) {
    if (k == 1) return Tile{(long long)unit * BI, p.extent_i - (long long)unit * BI, 0, 0};
    const int uo = q / p.mtiles, m0 = (q - uo * p.mtiles) * BI;
    return Tile{((long long)unit * p.n_outer + uo) * p.m + m0, p.m - m0, m0, uo};
  };
  struct Cursor {
    Tile tl;
    int off;
  };
  auto chunk = [&](int it) {
    const int j = it / cpp;
    return Cursor{tile(q_begin + j), (it - j * cpp) * bk};
  };

  const XCopy xc = make_xcopy<T>(p.copy_x, bk, l);
  auto load_chunk = [&](const Cursor& c, int slot) {
    unsigned char* st = smem + slot * l.stage;
    const unsigned sst = sbase + slot * l.stage;
    copy_x_chunk<T, BI>(st, sst, l, xc, p.copy_x, x + c.tl.row0 * p.c_last + c.off, p.c_last,
                        c.tl.nrows, (int)(p.c_last - c.off), bk, x);
    copy_rows<T, BR>(st, sst, p.copy_f, bk, rvalid, x, [&](int fr, const T*& src, int& dst) {
      src = alast + (long long)(c.off + fr) * rl + r0;
      dst = l.fl + fr * l.frow_bytes;
      return c.off + fr < p.c_last;
    });
  };

  float tt[MT][NT][4];  // the tile's T
  // k = 1: T is this row tile's output
  auto store_rows = [&](const Tile& tl) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 16 * MT + mt * 16 + g + 8 * h;
        if (row >= tl.nrows) continue;
        float* orow = out + (tl.row0 + row) * rl + r0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = wn * 8 * NT + nt * 8 + 2 * t;
          if (col < rvalid) store_result(orow + col, tt[mt][nt][2 * h]);
          if (col + 1 < rvalid) store_result(orow + (col + 1), tt[mt][nt][2 * h + 1]);
        }
      }
  };
  // k >= 2: the fold's operands of a tile, A_{k-1}'s rows and the outer
  // weights w(r_1..r_{k-2}) = prod_{d < k-2} A_d(c_d(u), r_d). With
  // R_{k-1} <= 32 and n_w <= NTHREADS a tile's are fetched into registers
  // during the fold before it (lane c of warp w holds A_{k-1}'s rows w,
  // w + NWARPS, ... at column c; thread e holds w(e)), so their loads overlap
  // that fold's last step; otherwise the fold loads them itself.
  constexpr int AROWS = BI / NWARPS;
  const bool pre = rp4 <= 32 && p.n_w <= NTHREADS;
  float apre[AROWS];
  float wpre = 1.f;
  auto weight = [&](int e, const Tile& tl) {  // w(e), r_{k-2} fastest
    float w = 1.f;
    int rem = e;
    for (int d = k - 3; d >= 0; --d) {
      const int rd = rem % p.rank[d];
      rem /= p.rank[d];
      // prod C < 2^31 (checked by the caller): 32-bit index arithmetic
      const int cd = tl.uo / (int)p.outer_stride[d] % (int)p.extent_c[d];
      w *= to_float(reinterpret_cast<const T*>(f.ptr[d])[bz * p.m_bstride[d] +
                                                         (long long)cd * p.rank[d] + rd]);
    }
    return w;
  };
  auto fetch = [&](const Tile& tl) {  // into registers
    const int nrows = tl.nrows < BI ? (int)tl.nrows : BI;
    const T* ap = aprev + tl.m0 * rp;
#pragma unroll
    for (int u = 0; u < AROWS; ++u) {
      const int row = warp + u * NWARPS;
      apre[u] = lane < rp && row < nrows ? to_float(ap[row * rp + lane]) : 0.f;
    }
    if (tid < p.n_w) wpre = weight(tid, tl);
  };
  auto stash_rows = [&]() {  // A_{k-1}'s rows from registers to shared memory
    if (lane < rp4) {
#pragma unroll
      for (int u = 0; u < AROWS; ++u) as[(warp + u * NWARPS) * rp4 + lane] = apre[u];
    }
  };
  // fold the tile's T into O through A_{k-1} and the outer weights; `next`
  // (if any) is the CTA's next tile
  auto fold = [&](const Tile& tl, const Tile* next) {
    const int nrows = tl.nrows < BI ? (int)tl.nrows : BI;
    if (pre) {
      if (tid < p.n_w) ws[tid] = wpre;
    } else {
      // A_{k-1}'s rows (zero past C_{k-1}): a warp per row, lanes along
      // R_{k-1}, XLOADS rows in flight
      const T* ap = aprev + tl.m0 * rp;
      for (int c = lane; c < rp4; c += 32) {
        for (int row0 = warp; row0 < BI; row0 += NWARPS * XLOADS) {
          float v[XLOADS];
#pragma unroll
          for (int u = 0; u < XLOADS; ++u) {
            const int row = row0 + u * NWARPS;
            v[u] = row < nrows && c < rp ? to_float(ap[row * rp + c]) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < XLOADS; ++u) {
            const int row = row0 + u * NWARPS;
            if (row < BI) as[row * rp4 + c] = v[u];
          }
        }
      }
      for (int e = tid; e < p.n_w; e += NTHREADS) ws[e] = weight(e, tl);
    }
    // T to shared memory
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 16 * MT + mt * 16 + g + 8 * h;
          const int col = wn * 8 * NT + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(ts + row * lt.ldt + col) =
              make_float2(tt[mt][nt][2 * h], tt[mt][nt][2 * h + 1]);
        }
    __syncthreads();
    // V = A_{k-1}(tile rows)^T T by blocks of 4 r_{k-1} x 4 columns of r_k
    // (two 16-byte loads feed 16 FMAs); with few blocks each block's rows are
    // split over G groups, G neighbouring lanes of one warp, whose sums are
    // added by a butterfly of shuffles (the same tree every run)
    const int quads = (rvalid + 3) / 4, blocks = rp4 / 4 * quads;
    int G = 1;
    while (G < 8 && 2 * G * blocks <= NTHREADS) G *= 2;
    auto partial = [&](int b, int grp, float (&v)[4][4]) {
      const int rq = b / quads, c4 = (b - rq * quads) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
#pragma unroll 2
      for (int row = grp; row < nrows; row += G) {
        const float4 a = *reinterpret_cast<const float4*>(as + row * rp4 + 4 * rq);
        const float4 tv = *reinterpret_cast<const float4*>(ts + row * lt.ldt + c4);
        const float av[4] = {a.x, a.y, a.z, a.w}, tw[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = fmaf(av[i], tw[j], v[i][j]);
      }
    };
    auto store_v = [&](int b, const float (&v)[4][4]) {
      const int rq = b / quads, c4 = (b - rq * quads) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(vs + (4 * rq + i) * 4 * quads + c4) =
            make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    };
    // fold-v: V into shared memory
    {
      if (G == 1) {
        for (int b = tid; b < blocks; b += NTHREADS) {
          float v[4][4];
          partial(b, 0, v);
          store_v(b, v);
        }
      } else {  // blocks * G <= NTHREADS: one pass, every lane in the shuffles
        const int b = tid / G, grp = tid - b * G;
        float v[4][4];
        partial(b < blocks ? b : 0, b < blocks ? grp : nrows, v);  // past the blocks: zeros
        for (int m = 1; m < G; m <<= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[i][j] += __shfl_xor_sync(0xffffffffu, v[i][j], m);
        if (b < blocks && grp == 0) store_v(b, v);
      }
    }
    __syncthreads();
    // fold-fetch: A_{k-1} is read no more, the next tile's operands load meanwhile
    {
      if (pre && next) fetch(*next);
    }
    // fold-o: O(r_1..r_{k-2}, r_{k-1}, :) += w V, each element owned by one
    // thread: BR threads along a row (wq, r_{k-1}) of O, NTHREADS / BR rows
    // at once
    {
      constexpr int ROWS = NTHREADS / BR;
      const int c = tid % BR;
      if (c < rvalid) {
#pragma unroll 4
        for (int rr = tid / BR; rr < p.n_w * rp; rr += ROWS) {
          const int wq = rr / rp, r = rr - wq * rp;
          float* o = os + (long long)rr * lt.ocols + c;
          *o = fmaf(ws[wq], vs[4 * r * quads + c], *o);
        }
      }
    }
    // fold-stash: the next tile's A_{k-1} rows to shared memory
    {
      if (pre && next) stash_rows();
    }
  };

  if (k >= 2) {
    for (long long e = tid; e < (long long)p.n_w * rp * lt.ocols; e += NTHREADS) os[e] = 0.f;
    if (pre && q_begin < q_end) {  // the first tile's fold operands
      fetch(tile(q_begin));
      stash_rows();
    }
  }
  zero_fragments(tt);
  for (int s = 0; s < p.stages - 1; ++s) {  // fill the ring
    if (s < n_local) load_chunk(chunk(s), s);
    cp_async_commit();
  }
  int ci = 0;  // chunk it's index inside its tile
  for (int it = 0; it < n_local; ++it) {
    const int slot = it % p.stages;
    cp_async_wait(p.stages - 2);  // this thread's copies of chunk it have landed
    __syncthreads();  // everyone's have; everyone is done with chunk it - 1 (and the fold)
    // ring copies: chunk it + stages - 1, into the slot chunk it - 1 freed
    {
      const int nxt = it + p.stages - 1;
      if (nxt < n_local) load_chunk(chunk(nxt), nxt % p.stages);
    }
    cp_async_commit();
    // MMA: chunk it's products on the tensor cores, added to T
    {
      float part[MT][NT][4];
      chunk_product<T, MT, NT>(smem + slot * l.stage, sbase + slot * l.stage, l, bk, wm, wn,
                               lane, part);
      add_fragments(tt, part);
    }
    if (++ci == cpp) {
      ci = 0;
      const int q = q_begin + it / cpp;
      const Tile tl = tile(q);
      // fold: T into O (k >= 2), or out as the output rows (k = 1)
      {
        if (k == 1) {
          store_rows(tl);
        } else {
          const Tile next = tile(q + 1);
          fold(tl, q + 1 < q_end ? &next : nullptr);
        }
      }
      zero_fragments(tt);
    }
  }
  cp_async_wait(0);
  if (k == 1) return;
  __syncthreads();  // every thread's share of O is in
  float* o = out + (long long)unit * prod_r + r0;
  for (long long e = tid; e < (long long)p.n_w * rp * rvalid; e += NTHREADS) {
    const long long wr = e / rvalid;  // (w index, r_{k-1})
    const int c = (int)(e - wr * rvalid);
    const float v = os[wr * lt.ocols + c];  // read first, as the assignment it replaces
    store_result(o + (wr * rl + c), v);
  }
}

// The kernel's launch grid: (units x rank tiles of R_k, splits, batch), a
// unit one i (k >= 2) or a tile of block_m rows of the m = I rows (k = 1).
static inline void ttm_grid(int ncontract, long long extent_i, long long m, int rank_last,
                            int block_m, int block_r, int n_splits, int batch, long long* dims) {
  const long long units = ncontract >= 2 ? extent_i : ceil_div(m, block_m);
  dims[0] = units * ceil_div(rank_last, block_r);
  dims[1] = n_splits;
  dims[2] = batch;
}

extern "C" {

// The launch grid repro_multi_ttm takes for these extents (I, C_1..C_k),
// ranks (R_1..R_k), blocks, splits and batch, into dims (x, y, z). Returns a
// cudaError_t.
int repro_multi_ttm_grid(int ncontract, const long long* extents, const int* ranks, int block_m,
                         int block_r, int n_splits, int batch, long long* dims) {
  if (ncontract < 1 || ncontract > MAX_CONTRACT || extents[0] < 1 ||
      (block_m != 64 && block_m != 128 && block_m != 192) ||
      (block_r != 16 && block_r != 32 && block_r != 64 && block_r != 128) || n_splits < 1 ||
      (ncontract == 1 && n_splits != 1) || batch < 1 || batch > MAX_BATCH ||
      ranks[ncontract - 1] < 1)
    return (int)cudaErrorInvalidValue;
  ttm_grid(ncontract, extents[0], ncontract >= 2 ? extents[ncontract - 1] : extents[0],
           ranks[ncontract - 1], block_m, block_r, n_splits, batch, dims);
  return 0;
}

// Bytes of dynamic shared memory the kernel takes for these blocks and
// ranks (R_1..R_k); -1 if the blocks are not ones it takes.
long long repro_multi_ttm_smem_bytes(int tsize, int ncontract, const int* ranks, int block_m,
                                     int block_k, int block_r, int stages) {
  if (ncontract < 1 || ncontract > MAX_CONTRACT ||
      !valid_blocks(tsize, block_m == 192 ? 128 : block_m, block_k, block_r, stages))
    return -1;
  long long n_w = 1;
  for (int d = 0; d < ncontract - 2; ++d) n_w *= ranks[d];
  const int rp = ncontract >= 2 ? ranks[ncontract - 2] : 1;
  return make_ttm_layout(tsize, ncontract, block_m, block_k, block_r, stages, rp,
                         ranks[ncontract - 1], (int)n_w).total;
}

// One launch. dtype: 0 float32, 1 bfloat16. extents: I, C_1..C_k; ranks:
// R_1..R_k; mats: k device pointers to (C_d, R_d) matrices of the tensor's
// dtype. block_m, block_k, block_r, stages: the tile's rows (64, 128 or
// 192), the chunk, the rank tile of R_k and the ring depth. copy_x / copy_f: bytes a cp.async of
// X's last-axis runs / A_k's rows takes (16, 8, 4; 0 for element loads),
// checked by the caller with the batch strides. n_splits: CTAs along one
// i's tiles (1 when k = 1). batch: B problems of these extents (1 to
// MAX_BATCH), X's and each matrix's elements from one problem to the next in
// x_bstride and m_bstrides (0 for a matrix the batch shares). out: n_splits
// x batch slabs of (I, prod R_d) fp32, slab y b at (y B + b) I prod R_d.
// Returns a cudaError_t.
int repro_multi_ttm(int dtype, int ncontract, const long long* extents, const int* ranks,
                    int block_m, int block_k, int block_r, int stages, int n_splits, int copy_x,
                    int copy_f, int batch, long long x_bstride, const long long* m_bstrides,
                    const void* x, const long long* mats, void* out, void* stream) {
  const int tsize = dtype == 0 ? 4 : 2;
  if (ncontract < 1 || ncontract > MAX_CONTRACT || n_splits < 1 ||
      (ncontract == 1 && n_splits != 1) || (dtype != 0 && dtype != 1) ||
      !valid_blocks(tsize, block_m == 192 ? 128 : block_m, block_k, block_r, stages) ||
      !valid_copy(copy_x) || !valid_copy(copy_f) || extents[0] < 1 || batch < 1 ||
      batch > MAX_BATCH || x_bstride < 0)
    return (int)cudaErrorInvalidValue;
  TtmProblem p;
  Factors f;
  p.ncontract = ncontract;
  p.block_k = block_k;
  p.stages = stages;
  p.n_splits = n_splits;
  p.copy_x = copy_x;
  p.copy_f = copy_f;
  p.extent_i = extents[0];
  p.batch = batch;
  p.x_bstride = x_bstride;
  for (int d = 0; d < MAX_CONTRACT; ++d) {
    p.extent_c[d] = d < ncontract ? extents[1 + d] : 1;
    p.rank[d] = d < ncontract ? ranks[d] : 1;
    p.m_bstride[d] = d < ncontract ? m_bstrides[d] : 0;
    if (p.extent_c[d] < 1 || p.rank[d] < 1 || p.m_bstride[d] < 0)
      return (int)cudaErrorInvalidValue;
    f.ptr[d] = d < ncontract ? reinterpret_cast<const void*>(mats[d]) : nullptr;
  }
  p.rank_last = p.rank[ncontract - 1];
  p.rank_prev = ncontract >= 2 ? p.rank[ncontract - 2] : 1;
  p.c_last = p.extent_c[ncontract - 1];
  p.m = ncontract >= 2 ? p.extent_c[ncontract - 2] : p.extent_i;
  p.mtiles = (int)ceil_div(p.m, block_m);
  long long n_w = 1, stride = 1;
  for (int d = ncontract - 3; d >= 0; --d) {
    p.outer_stride[d] = stride;
    stride *= p.extent_c[d];
    n_w *= p.rank[d];
  }
  for (int d = ncontract - 2 > 0 ? ncontract - 2 : 0; d < MAX_CONTRACT; ++d)
    p.outer_stride[d] = 1;
  p.n_outer = stride;
  p.n_w = (int)n_w;
  const long long smem = make_ttm_layout(tsize, ncontract, block_m, block_k, block_r, stages,
                                         p.rank_prev, p.rank_last, p.n_w).total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  auto run = [&](auto tag) {
    using T = decltype(tag);
    auto launch = [&](auto mt, auto nt) {
      constexpr int MT = decltype(mt)::value, NT = decltype(nt)::value;
      auto kern = multi_ttm_mma_kernel<T, MT, NT>;
      cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      long long dims[3];
      ttm_grid(ncontract, p.extent_i, p.m, p.rank_last, 64 * MT, 16 * NT, p.n_splits, p.batch,
               dims);
      kern<<<grid_dim3(dims), NTHREADS, smem, s>>>(p, reinterpret_cast<const T*>(x), f, o);
      return (int)cudaGetLastError();
    };
    if (block_m != 192) return dispatch_tiles(block_m, block_r, launch);
    // 192-row tiles: C_{k-1} up to 192 (180 at 180^4) in one tile
    using I3 = std::integral_constant<int, 3>;
    switch (block_r) {
      case 16: return launch(I3(), std::integral_constant<int, 1>());
      case 32: return launch(I3(), std::integral_constant<int, 2>());
      case 64: return launch(I3(), std::integral_constant<int, 4>());
      default: return launch(I3(), std::integral_constant<int, 8>());
    }
  };
  return dtype == 0 ? run(float()) : run(__nv_bfloat16());
}

}  // extern "C"

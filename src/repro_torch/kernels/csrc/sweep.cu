// The fused CP-ALS sweep's two kernels for Hopper (sm_90a).
//
// fused_pair_mma_kernel<T, MT, NT> replaces src/repro/kernels/sweep.py:
// mttkrp_fused_pair_pallas (_fused_pair_kernel). One pass over a
// mode-0-canonical X (I, C_1..C_{N-1}) gives
//   P(i, p, r) = sum_{c_{N-1}} X(i, p, c_{N-1}) A_{N-1}(c_{N-1}, r)
//   B0(i, r)   = sum_p P(i, p, r) prod_d A_d(p_d, r),
// p = (c_1..c_{N-2}) a leading index tuple. On the TPU both outputs stay
// resident across a sequential grid, P zeroed when the innermost c_{N-1}
// wraps. What bounds it on an H100: the bytes. At 1000^3, R=64 (fp32) X and
// P are 4.26e9 B (1.27 ms at 3.35 TB/s), against 2|X|R = 1.28e11 products,
// which 3xTF32 runs at 0.78 ms on the tensor cores (1.91 ms on the CUDA
// cores, where the TPU-shaped first port ran them, 17.7 ms in all); at
// 180^4, R=32 the bytes are 4.95e9 (1.48 ms). So the pair is the MTTKRP
// kernel (mttkrp.cu) with two changes, on ring.cuh's cp.async ring and
// tensor cores:
//   * chunk order: X is the (I, K) matrix of mttkrp.cu, walked in chunks of
//     block_k last-axis indices under one leading tuple p; a CTA owns BI rows
//     and BR rank columns and walks each of its tuples' chunks one after
//     another, so the tuple's P tile is whole inside the CTA. The tuples are
//     split over gridDim.y = S CTAs (split y takes p = y, y + S, ...), never
//     one tuple over two CTAs;
//   * per-tuple epilogue: each chunk's fresh partial is added to the P tile
//     in fp32 registers with ordinary adds; when the tuple's last chunk is
//     done the CTA stores the (BI x BR) P tile to P[i, p, :] (P's tiles are
//     disjoint between CTAs: no atomics) and adds P_tile * prod_d A_d(p_d, :)
//     (the leading-factor rows the ring staged beside the chunk) into the B0
//     accumulators, which live in shared memory, one slot per thread and
//     fragment element (registers hold the partial and the P tile). Each split
//     writes its own fp32 B0 slab and mttkrp.cu:splitk_reduce_kernel adds the
//     slabs in slab order: results repeat bit for bit.
// Ragged edges are masked by the ring's zero-fill; nothing is padded.
//
// streaming_partial_kernel<T, V, ROWL, ROWS> replaces src/repro/kernels/mttkrpn.py:
// mttkrp_partial_pallas (_partial_kernel), the dimension tree's and the fused
// sweep's rank-augmented partial contraction
//   O(i, r) = sum_{c_1..c_k} N(i, c_1..c_k, r) prod_d A_d(c_d, r),  k >= 1.
// The node carries the rank axis, so there is no product for the tensor
// cores: each node element is read once and used once (two flops a 4-byte
// element), and the kernel is bound by the node's bytes (a (1000, 1000, 64)
// fp32 node is 2.56e8 B, 0.077 ms at 3.35 TB/s; 180^3 x 32 is 7.5e8 B,
// 0.223 ms). Running the TPU's tile schedule here (blocks from the
// reference's VMEM planner, an index table and the weight block rebuilt in
// shared memory with two barriers every step, 4-byte gathers, a canonical
// copy of the node in front) reached 27-44 % of that bound. This kernel is a
// streaming reduction shaped for the card instead:
//   * the node is read in place, as a strided view: kept axes (decoded once
//     a row) and contraction axes of any strides, the rank axis at unit
//     stride; no copy in front;
//   * 16-byte read-only loads along r (4 fp32 or 8 bf16; one element where
//     R, a stride or a pointer does not allow 16), neighbouring lanes on
//     neighbouring addresses, `loads` independent node loads in flight a
//     thread (its ROWS rows times its unrolled c steps); no shared index
//     table and no barrier inside the contraction loop;
//   * weights in registers: a thread forms W(c, r:r+V) = prod_d A_d(c_d, r:r+V)
//     from factor rows as vectors, the outer factors' product kept across a
//     run of the innermost index c_k; each weight vector serves the thread's
//     ROWS rows, so factor loads are a 1/ROWS share of the node's;
//   * the warp spans (lane axis, r-vector), where the lane axis is the one
//     that lies next to r in memory (PartialKernelPlan.layout): the
//     innermost kept axis (ROWL: each output sum stays in one thread's
//     registers), or the innermost contraction axis (each thread's sums are
//     folded across the lane axis's threads in a fixed order: a shuffle
//     butterfly in the warp, then the warps through shared memory in warp
//     order);
//   * the contraction is split over CTAs in runs of units (an outer tuple
//     (c_1..c_{k-1}) with a chunk of c_k); each split writes its own fp32
//     slab and mttkrp.cu:splitk_reduce_kernel adds the slabs in slab order:
//     no atomics, results repeat bit for bit;
//   * a batch of B nodes of one shape is one launch: blockIdx.z = b, the
//     node and each factor offset by b times their batch strides (64-bit; a
//     factor's stride 0 when the batch shares it), split y of node b writing
//     slab y b of an (S, B, I, R) workspace.
// Ragged edges (rows, c_k, R) are masked; nothing is padded.
#include "ring.cuh"

// --------------------------------------------------------------------------
// fused (B0, P) pair
// --------------------------------------------------------------------------

// Dynamic shared memory of the pair kernel: the ring (ring.cuh, with the
// N - 2 leading-factor rows beside each chunk) and the B0 accumulators, one
// fp32 word a thread and fragment element (BI x BR words) (mirrored by
// repro_torch/engine/plan.py:pair_kernel_smem_bytes).
static inline long long pair_smem_bytes(int tsize, int nc, int bi, int bk, int br, int stages) {
  return make_tile_layout(tsize, nc, bi, bk, br, stages).total + 4LL * bi * br;
}

template <typename T, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS, NT == 8 ? 1 : 2)
fused_pair_mma_kernel(TileProblem p, const T* __restrict__ x, Factors f, float* __restrict__ b0,
                      float* __restrict__ pout) {
  constexpr int BI = 64 * MT, BR = 16 * NT, TS = (int)sizeof(T);
  const int nc = p.ncontract, nlead = nc - 1;
  const int bk = p.block_k;
  const TileLayout l = make_tile_layout(TS, nc, BI, bk, BR, p.stages);
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sbase = smem_u32(smem);
  float* b0s = reinterpret_cast<float*>(smem + l.total);  // [fragment element][thread]

  const int gr = (int)ceil_div(p.rank, BR);
  const int i0 = (int)(blockIdx.x / gr) * BI;  // I < 2^31, K < 2^31 (checked at launch)
  const int r0 = (int)(blockIdx.x % gr) * BR;
  const int rvalid = p.rank - r0 < BR ? p.rank - r0 : BR;
  // split y takes the tuples y, y + S, ..., each with all its chunks
  const int npf = (int)p.n_prefix, S = p.n_splits, y = (int)blockIdx.y;
  const int cpp = (int)p.chunks_per_prefix;
  const int n_local = y < npf ? (npf - y + S - 1) / S * cpp : 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp >> 1, wn = warp & 1;  // 4 warps along rows, 2 along columns
  const int g = lane >> 2, t = lane & 3;
  const T* flast = reinterpret_cast<const T*>(f.ptr[nc - 1]);

  // A chunk: tuple pf, last-axis offset off.
  struct Cursor {
    int pf, off;
  };
  auto chunk = [&](int it) {
    const int j = it / cpp;
    return Cursor{y + j * S, (it - j * cpp) * bk};
  };

  const XCopy xc = make_xcopy<T>(p.copy_x, bk, l);
  const T* xrows = x + (long long)i0 * p.k;  // the tile's first row
  const int frows = bk + nlead;              // factor rows a stage holds

  // Factor row fr of the chunk at c, as in mttkrp.cu: the last factor's row
  // off + fr for fr < bk (false past C_last), else leading factor fr - bk's
  // row of the chunk's tuple.
  auto frow = [&](int fr, const Cursor& c, const T*& src, int& dst) {
    if (fr < bk) {
      src = flast + (long long)(c.off + fr) * p.rank + r0;
      dst = l.fl + fr * l.frow_bytes;
      return c.off + fr < p.c_last;
    }
    const int d = fr - bk;
    const unsigned gd = (unsigned)c.pf / (unsigned)p.lead_stride[d] % (unsigned)p.extent_c[d];
    src = reinterpret_cast<const T*>(f.ptr[d]) + (long long)gd * p.rank + r0;
    dst = l.lead + d * BR * TS;
    return true;
  };

  auto load_chunk = [&](const Cursor& c, int slot) {
    unsigned char* st = smem + slot * l.stage;
    const unsigned sst = sbase + slot * l.stage;
    copy_x_chunk<T, BI>(st, sst, l, xc, p.copy_x, xrows + (long long)c.pf * p.c_last + c.off,
                        p.k, p.extent_i - i0, (int)p.c_last - c.off, bk, x);
    copy_rows<T, BR>(st, sst, p.copy_f, frows, rvalid, x,
                     [&](int fr, const T*& src, int& dst) { return frow(fr, c, src, dst); });
  };

  // The tuple's P tile out, and B0 += P_tile * prod_d A_d(p_d, :) from the
  // leading rows staged beside its last chunk (in slot).
  float pt[MT][NT][4];
  auto finish_tuple = [&](int pf, int slot) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gi = (long long)i0 + wm * 16 * MT + mt * 16 + g + 8 * h;
        if (gi >= p.extent_i) continue;
        float* prow = pout + (gi * npf + pf) * p.rank + r0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = wn * 8 * NT + nt * 8 + 2 * t;
          if (col < rvalid) store_result(prow + col, pt[mt][nt][2 * h]);
          if (col + 1 < rvalid) store_result(prow + (col + 1), pt[mt][nt][2 * h + 1]);
        }
      }
    const T* lead = reinterpret_cast<const T*>(smem + slot * l.stage + l.lead);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 8 * NT + nt * 8 + 2 * t + j;
        float pv = 1.f;
        for (int d = 0; d < nlead; ++d) pv *= to_float(lead[d * BR + col]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* a = b0s + ((mt * NT + nt) * 4 + 2 * h + j) * NTHREADS + tid;
            *a = fmaf(pv, pt[mt][nt][2 * h + j], *a);
          }
      }
    zero_fragments(pt);
  };

  for (int q = 0; q < MT * NT * 4; ++q) b0s[q * NTHREADS + tid] = 0.f;
  zero_fragments(pt);
  for (int s = 0; s < p.stages - 1; ++s) {  // fill the ring
    if (s < n_local) load_chunk(chunk(s), s);
    cp_async_commit();
  }
  int ci = 0;  // chunk it's index inside its tuple
  for (int it = 0; it < n_local; ++it) {
    cp_async_wait(p.stages - 2);  // this thread's copies of chunk it have landed
    __syncthreads();  // everyone's have; everyone is done with chunk it - 1
    // ring copies: chunk it + stages - 1, into the slot chunk it - 1 freed
    {
      const int nxt = it + p.stages - 1;
      if (nxt < n_local) load_chunk(chunk(nxt), nxt % p.stages);
    }
    cp_async_commit();
    // MMA: chunk it's products on the tensor cores, added to the P tile
    {
      float part[MT][NT][4];
      chunk_product<T, MT, NT>(smem + (it % p.stages) * l.stage, sbase + (it % p.stages) * l.stage,
                               l, bk, wm, wn, lane, part);
      add_fragments(pt, part);
    }
    if (++ci == cpp) {
      ci = 0;
      finish_tuple(y + it / cpp * S, it % p.stages);
    }
  }
  cp_async_wait(0);

  // this split's B0 slab, fragment by fragment
  float* o = b0 + (long long)y * p.extent_i * p.rank;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wn * 8 * NT + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gi = (long long)i0 + wm * 16 * MT + mt * 16 + g + 8 * h;
        if (gi >= p.extent_i) continue;
        const float* a = b0s + ((mt * NT + nt) * 4 + 2 * h) * NTHREADS + tid;
        // (the shared-memory value read first, as the assignment it replaces reads it)
        if (col < rvalid) {
          const float v = a[0];
          store_result(o + (gi * p.rank + r0 + col), v);
        }
        if (col + 1 < rvalid) {
          const float v = a[NTHREADS];
          store_result(o + (gi * p.rank + r0 + col + 1), v);
        }
      }
    }
}

// --------------------------------------------------------------------------
// rank-augmented partial contraction: a streaming reduction
// --------------------------------------------------------------------------

#define PARTIAL_MAX_LOADS 8

// A node read in place: nkeep kept axes (their row-major flat index is the
// output row) and ncontract contraction axes, each with its size and element
// stride, the rank axis at unit stride; and the launch shape of its plan.
struct PartialProblem {
  int nkeep, ncontract;
  int rank, vec;                  // R; elements a load along r
  int tr, tl, rtiles;             // threads along r-vectors / along the lane axis; CTAs along r
  int block_rows, unroll;         // rows a CTA; c steps a thread unrolls
  int n_splits;
  long long rows;                 // I = prod keep_size
  long long keep_size[MAX_CONTRACT], keep_stride[MAX_CONTRACT];
  long long c_size[MAX_CONTRACT], c_stride[MAX_CONTRACT];
  long long nch;                  // chunks of the innermost contraction axis
  long long units;                // prod c_size[:-1] * nch
  int batch;                      // B nodes, blockIdx.z (1 unbatched)
  long long node_bstride;         // elements from one node to the next
  long long f_bstride[MAX_CONTRACT];  // the same for each factor; 0: shared
};

// Read-only vector loads of V elements along r, and their fp32 values.
template <typename T, int V> struct NodeVec;
template <> struct NodeVec<float, 4> {
  using raw = uint4;
  static __device__ __forceinline__ raw load(const float* q) {
    return __ldg(reinterpret_cast<const uint4*>(q));
  }
  static __device__ __forceinline__ raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void unpack(raw x, float* o) {
    o[0] = __uint_as_float(x.x);
    o[1] = __uint_as_float(x.y);
    o[2] = __uint_as_float(x.z);
    o[3] = __uint_as_float(x.w);
  }
};
template <> struct NodeVec<float, 1> {
  using raw = unsigned;
  static __device__ __forceinline__ raw load(const float* q) {
    return __ldg(reinterpret_cast<const unsigned*>(q));
  }
  static __device__ __forceinline__ raw zero() { return 0u; }
  static __device__ __forceinline__ void unpack(raw x, float* o) { o[0] = __uint_as_float(x); }
};
template <> struct NodeVec<__nv_bfloat16, 8> {  // element 2q in the low half of word q
  using raw = uint4;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* q) {
    return __ldg(reinterpret_cast<const uint4*>(q));
  }
  static __device__ __forceinline__ raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void unpack(raw x, float* o) {
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[2 * q] = __uint_as_float(w[q] << 16);
      o[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
};
template <> struct NodeVec<__nv_bfloat16, 1> {
  using raw = unsigned short;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* q) {
    return __ldg(reinterpret_cast<const unsigned short*>(q));
  }
  static __device__ __forceinline__ raw zero() { return 0; }
  static __device__ __forceinline__ void unpack(raw x, float* o) {
    o[0] = __uint_as_float((unsigned)x << 16);
  }
};

// Dynamic shared memory of the partial kernel: the "contract" layout's
// cross-warp fold, one fp32 word per warp, row and column of the CTA
// (mirrored by repro_torch/engine/plan.py:partial_kernel_smem_bytes).
static inline long long partial_smem_bytes(bool rowl, int block_rows, int tr, int vec) {
  return rowl ? 0 : 4LL * NWARPS * block_rows * tr * vec;
}

// One CTA: block_rows kept rows (rows of blockIdx.x / rtiles) by tr * V rank
// columns (tile blockIdx.x % rtiles), over the units of split blockIdx.y, of
// node blockIdx.z.
// Thread tid = tl * tr + tr_idx takes r-vector tr_idx and, along the lane
// axis, rows tl, tl + TL, ... (ROWL) or c_k = tl, tl + TL, ... of each chunk.
template <typename T, int V, bool ROWL, int ROWS>
__global__ void __launch_bounds__(NTHREADS, 2)
streaming_partial_kernel(PartialProblem p, const T* __restrict__ node, Factors f,
                         float* __restrict__ out) {
  using L = NodeVec<T, V>;
  constexpr int UMAX = PARTIAL_MAX_LOADS / ROWS;
  const int tid = threadIdx.x;
  const int tri = tid % p.tr, tl = tid / p.tr;
  const int rt = (int)(blockIdx.x % (unsigned)p.rtiles);
  const long long rb = blockIdx.x / (unsigned)p.rtiles;
  const int r0 = (rt * p.tr + tri) * V;  // this thread's first rank column
  const bool rin = r0 < p.rank;          // V > 1 only where V divides R
  const int kin = p.ncontract - 1;
  const long long cin = p.c_size[kin], cstride = p.c_stride[kin];
  const long long bz = blockIdx.z;  // the batch element: 64-bit offsets
  node += bz * p.node_bstride;
  const T* fin = reinterpret_cast<const T*>(f.ptr[kin]) + bz * p.f_bstride[kin] + r0;

  // this thread's rows, decoded once: their node offsets (with r0)
  long long roff[ROWS];
  bool rok[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const long long i = rb * p.block_rows + (ROWL ? tl + (long long)j * p.tl : j);
    rok[j] = rin && i < p.rows;
    long long rem = i, off = r0;
    for (int d = p.nkeep - 1; d >= 0; --d) {
      off += rem % p.keep_size[d] * p.keep_stride[d];
      rem /= p.keep_size[d];
    }
    roff[j] = off;
  }

  float acc[ROWS][V];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;

  const int split = (int)blockIdx.y;
  const long long u0 = split * p.units / p.n_splits;
  const long long u1 = (split + 1) * p.units / p.n_splits;
  const long long cb = ROWL ? p.unroll : (long long)p.tl * p.unroll;  // c_k indices a unit
  const long long c_lane = ROWL ? 0 : tl, c_step = ROWL ? 1 : p.tl;
  long long o = u0 / p.nch, ch = u0 % p.nch;
  long long obase = 0;  // node offset of the outer tuple o
  float wo[V];          // its weight vector: prod_{d < k-1} A_d(c_d, r0:r0+V)
  auto outer = [&]() {
    long long rem = o;
    obase = 0;
#pragma unroll
    for (int e = 0; e < V; ++e) wo[e] = 1.f;
    for (int d = kin - 1; d >= 0; --d) {
      const long long cd = rem % p.c_size[d];
      rem /= p.c_size[d];
      obase += cd * p.c_stride[d];
      if (rin) {
        float a[V];
        L::unpack(L::load(reinterpret_cast<const T*>(f.ptr[d]) + bz * p.f_bstride[d] +
                          cd * p.rank + r0),
                  a);
#pragma unroll
        for (int e = 0; e < V; ++e) wo[e] *= a[e];
      }
    }
  };
  if (u0 < u1) outer();

  for (long long u = u0; u < u1; ++u) {
    const long long c0 = ch * cb + c_lane;
    // every load of the unit first: UMAX weight vectors, ROWS x UMAX node vectors
    typename L::raw wr[UMAX], xr[UMAX][ROWS];
#pragma unroll
    for (int m = 0; m < UMAX; ++m) {
      const long long c = c0 + m * c_step;
      const bool cok = m < p.unroll && c < cin;
      wr[m] = cok && rin ? L::load(fin + c * p.rank) : L::zero();
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        xr[m][j] = cok && rok[j] ? L::load(node + roff[j] + obase + c * cstride) : L::zero();
    }
    // then the FMAs, c steps in order
#pragma unroll
    for (int m = 0; m < UMAX; ++m) {
      if (m >= p.unroll) break;
      float w[V];
      L::unpack(wr[m], w);
#pragma unroll
      for (int e = 0; e < V; ++e) w[e] *= wo[e];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        float x[V];
        L::unpack(xr[m][j], x);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j][e] = fmaf(x[e], w[e], acc[j][e]);
      }
    }
    if (++ch == p.nch) {
      ch = 0;
      ++o;
      if (u + 1 < u1) outer();
    }
  }

  float* slab = out + ((long long)split * p.batch + bz) * p.rows * p.rank;
  if constexpr (ROWL) {  // each output sum is whole in this thread
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (!rok[j]) continue;
      const long long i = rb * p.block_rows + tl + (long long)j * p.tl;
      float* dst = slab + i * p.rank + r0;
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          store_result(reinterpret_cast<float4*>(dst) + q,
                       make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                                   acc[j][4 * q + 3]));
      } else {
        store_result(dst, acc[j][0]);
      }
    }
  } else {
    // "contract": fold the lane axis's threads in a fixed order, the warp's
    // lanes by a shuffle butterfly, then the warps through shared memory in
    // warp order
    extern __shared__ __align__(16) float red[];  // [warp][row][tr * V]
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e)
        for (int off = p.tr; off < 32; off *= 2)
          acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], off);
    const int lane = tid % 32, warp = tid / 32, width = p.tr * V;
    if (lane < p.tr) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) red[(warp * ROWS + j) * width + lane * V + e] = acc[j][e];
    }
    __syncthreads();
    for (int q = tid; q < ROWS * width; q += NTHREADS) {
      const int j = q / width, col = q - j * width;
      const long long i = rb * p.block_rows + j;
      const int r = rt * width + col;
      if (i >= p.rows || r >= p.rank) continue;
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += red[(w * ROWS + j) * width + col];
      store_result(slab + (i * p.rank + r), s);
    }
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// The partial kernel's problem from the wrapper's arguments; false if the
// plan or the node is not one the kernel takes.
static bool make_partial_problem(int tsize, int layout, int block_rows, int vec, int loads,
                                 int n_splits, int nkeep, const long long* keep_sizes,
                                 const long long* keep_strides, int ncontract,
                                 const long long* c_sizes, const long long* c_strides, int rank,
                                 int batch, long long node_bstride, const long long* f_bstrides,
                                 PartialProblem* p) {
  if ((layout != 0 && layout != 1) || (vec != 1 && vec != 16 / tsize) || rank < 1 ||
      rank % vec || nkeep < 1 || nkeep > MAX_CONTRACT || ncontract < 1 ||
      ncontract > MAX_CONTRACT || n_splits < 1 || n_splits > 65535 ||
      (loads != 1 && loads != 2 && loads != 4 && loads != 8) || batch < 1 ||
      batch > MAX_BATCH || node_bstride < 0)
    return false;
  p->batch = batch;
  p->node_bstride = node_bstride;
  for (int d = 0; d < MAX_CONTRACT; ++d) {
    p->f_bstride[d] = d < ncontract ? f_bstrides[d] : 0;
    if (p->f_bstride[d] < 0) return false;
  }
  const bool rowl = layout == 0;
  p->nkeep = nkeep;
  p->ncontract = ncontract;
  p->rank = rank;
  p->vec = vec;
  const int nvec = (int)ceil_div(rank, vec);
  p->tr = 1;
  while (p->tr < nvec && p->tr < 32) p->tr *= 2;
  p->tl = NTHREADS / p->tr;
  p->rtiles = (int)ceil_div(nvec, p->tr);
  const int rows = rowl ? block_rows / p->tl : block_rows;
  if (block_rows < 1 || (rowl && block_rows % p->tl) ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 8) || loads < rows)
    return false;
  p->block_rows = block_rows;
  p->unroll = loads / rows;
  p->n_splits = n_splits;
  p->rows = 1;
  for (int d = 0; d < MAX_CONTRACT; ++d) {
    p->keep_size[d] = d < nkeep ? keep_sizes[d] : 1;
    p->keep_stride[d] = d < nkeep ? keep_strides[d] : 0;
    p->c_size[d] = d < ncontract ? c_sizes[d] : 1;
    p->c_stride[d] = d < ncontract ? c_strides[d] : 0;
    if (p->keep_size[d] < 1 || p->c_size[d] < 1 || p->keep_stride[d] < 0 || p->c_stride[d] < 0)
      return false;
    p->rows *= p->keep_size[d];
  }
  const long long cb = rowl ? p->unroll : (long long)p->tl * p->unroll;
  p->nch = ceil_div(p->c_size[ncontract - 1], cb);
  p->units = p->nch;
  for (int d = 0; d < ncontract - 1; ++d) p->units *= p->c_size[d];
  return ceil_div(p->rows, block_rows) * p->rtiles < (1LL << 31);
}

// The partial kernel's launch grid: (row blocks x rank tiles, splits, batch).
static inline void partial_grid(const PartialProblem& p, long long* dims) {
  dims[0] = ceil_div(p.rows, p.block_rows) * p.rtiles;
  dims[1] = p.n_splits;
  dims[2] = p.batch;
}

template <typename T, int V, bool ROWL, int ROWS>
static int launch_partial(const PartialProblem& p, const void* node, const Factors& f, float* out,
                          cudaStream_t s) {
  auto kern = streaming_partial_kernel<T, V, ROWL, ROWS>;
  const long long smem = partial_smem_bytes(ROWL, p.block_rows, p.tr, V);
  if (smem > 48 * 1024) {  // above the default only: the call is not a stream operation
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long dims[3];
  partial_grid(p, dims);
  kern<<<grid_dim3(dims), NTHREADS, smem, s>>>(p, reinterpret_cast<const T*>(node), f, out);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool ROWL>
static int dispatch_partial_rows(const PartialProblem& p, int rows, const void* node,
                                 const Factors& f, float* out, cudaStream_t s) {
  switch (rows) {
    case 1: return launch_partial<T, V, ROWL, 1>(p, node, f, out, s);
    case 2: return launch_partial<T, V, ROWL, 2>(p, node, f, out, s);
    case 4: return launch_partial<T, V, ROWL, 4>(p, node, f, out, s);
    default: return launch_partial<T, V, ROWL, 8>(p, node, f, out, s);
  }
}

template <typename T, int V>
static int dispatch_partial(const PartialProblem& p, bool rowl, const void* node,
                            const Factors& f, float* out, cudaStream_t s) {
  if (rowl) return dispatch_partial_rows<T, V, true>(p, p.block_rows / p.tl, node, f, out, s);
  return dispatch_partial_rows<T, V, false>(p, p.block_rows, node, f, out, s);
}

extern "C" {

// Bytes of dynamic shared memory the pair kernel takes for these blocks
// with ncontract contraction axes; -1 if the blocks are not ones it takes.
long long repro_fused_pair_smem_bytes(int tsize, int ncontract, int block_i, int block_k,
                                      int block_r, int stages) {
  if (ncontract < 2 || ncontract > MAX_CONTRACT ||
      !valid_blocks(tsize, block_i, block_k, block_r, stages))
    return -1;
  return pair_smem_bytes(tsize, ncontract, block_i, block_k, block_r, stages);
}

// Bytes of dynamic shared memory the partial kernel takes under a plan
// (layout: 0 "rows", 1 "contract") for rank R; -1 if the plan is not one
// the kernel takes.
long long repro_partial_smem_bytes(int tsize, int layout, int block_rows, int vec, int loads,
                                   int rank) {
  const long long one = 1, zero = 0;
  PartialProblem p;
  if ((tsize != 2 && tsize != 4) ||
      !make_partial_problem(tsize, layout, block_rows, vec, loads, 1, 1, &one, &one, 1, &one,
                            &one, rank, 1, 0, &zero, &p))
    return -1;
  return partial_smem_bytes(layout == 0, block_rows, p.tr, vec);
}

// The launch grid repro_fused_pair takes for these extents and blocks (I,
// R, the row and rank tiles, the splits), into dims (x, y, z). Returns a
// cudaError_t.
int repro_fused_pair_grid(long long extent_i, int rank, int block_i, int block_r, int n_splits,
                          long long* dims) {
  if (extent_i < 1 || rank < 1 || (block_i != 64 && block_i != 128) ||
      (block_r != 16 && block_r != 32 && block_r != 64 && block_r != 128) || n_splits < 1)
    return (int)cudaErrorInvalidValue;
  tile_grid(extent_i, rank, block_i, block_r, n_splits, 1, dims);
  return 0;
}

// The launch grid repro_partial takes for a node of these kept and
// contraction sizes (the strides do not enter it) under a plan, into dims
// (x, y, z). Returns a cudaError_t.
int repro_partial_grid(int tsize, int layout, int block_rows, int vec, int loads, int n_splits,
                       int nkeep, const long long* keep_sizes, int ncontract,
                       const long long* c_sizes, int rank, int batch, long long* dims) {
  const long long zeros[MAX_CONTRACT] = {0, 0, 0, 0, 0, 0, 0};
  PartialProblem p;
  if ((tsize != 2 && tsize != 4) || nkeep < 1 || nkeep > MAX_CONTRACT ||
      !make_partial_problem(tsize, layout, block_rows, vec, loads, n_splits, nkeep, keep_sizes,
                            zeros, ncontract, c_sizes, zeros, rank, batch, 0, zeros, &p))
    return (int)cudaErrorInvalidValue;
  partial_grid(p, dims);
  return 0;
}

// One launch of the pair kernel. dtype: 0 float32, 1 bfloat16.
// extents: I, C_1..C_{N-1}; factors: N-1 device pointers to (C_d, R) in the
// tensor's dtype. copy_x / copy_f: bytes a cp.async of X's last-axis runs /
// the factors' rows takes (16, 8, 4; 0 for element loads), checked by the
// caller. b0: n_splits slabs of (I, R) fp32; pout: P, (I, C_1..C_{N-2}, R)
// fp32. Returns a cudaError_t.
int repro_fused_pair(int dtype, int ncontract, const long long* extents, int block_i,
                     int block_k, int block_r, int stages, int rank, int n_splits, int copy_x,
                     int copy_f, const void* x, const long long* factors, void* b0, void* pout,
                     void* stream) {
  const int tsize = dtype == 0 ? 4 : 2;
  if (ncontract < 2 || ncontract > MAX_CONTRACT || n_splits < 1 || rank < 1 ||
      (dtype != 0 && dtype != 1) || !valid_blocks(tsize, block_i, block_k, block_r, stages) ||
      !valid_copy(copy_x) || !valid_copy(copy_f))
    return (int)cudaErrorInvalidValue;
  TileProblem p;
  Factors f;
  if (!make_tile_problem(ncontract, extents, block_k, stages, rank, n_splits, copy_x, copy_f,
                         factors, &p, &f))
    return (int)cudaErrorInvalidValue;
  const long long smem = pair_smem_bytes(tsize, ncontract, block_i, block_k, block_r, stages);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* ob = reinterpret_cast<float*>(b0);
  float* op = reinterpret_cast<float*>(pout);
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return dispatch_tiles(block_i, block_r, [&](auto mt, auto nt) {
      constexpr int MT = decltype(mt)::value, NT = decltype(nt)::value;
      auto kern = fused_pair_mma_kernel<T, MT, NT>;
      cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      long long dims[3];
      tile_grid(p.extent_i, p.rank, 64 * MT, 16 * NT, p.n_splits, 1, dims);
      kern<<<grid_dim3(dims), NTHREADS, smem, s>>>(p, reinterpret_cast<const T*>(x), f, ob, op);
      return (int)cudaGetLastError();
    });
  };
  return dtype == 0 ? run(float()) : run(__nv_bfloat16());
}

// One launch of the partial kernel. dtype: 0 float32, 1 bfloat16. The node,
// read in place: nkeep kept axes (sizes, element strides; the output row is
// their row-major flat index) and ncontract contraction axes (the innermost
// last), the rank axis at unit stride; factors: ncontract device pointers
// to (C_d, R) in the node's dtype. Plan: layout (0 "rows", 1 "contract"),
// block_rows, vec (1, or 16 bytes' worth where R, the strides, the batch
// strides and the pointers are multiples of it: checked by the caller),
// loads, n_splits. batch: B nodes of this view (1 to MAX_BATCH),
// node_bstride and f_bstrides the elements from one node's (factor's) start
// to the next (0 for a factor the batch shares). out: n_splits x batch slabs
// of (I, R) fp32, slab y b at (y B + b) I R. Returns a cudaError_t.
int repro_partial(int dtype, int layout, int block_rows, int vec, int loads, int n_splits,
                  int nkeep, const long long* keep_sizes, const long long* keep_strides,
                  int ncontract, const long long* c_sizes, const long long* c_strides, int rank,
                  int batch, long long node_bstride, const long long* f_bstrides,
                  const void* node, const long long* factors, void* out, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int tsize = dtype == 0 ? 4 : 2;
  PartialProblem p;
  if (!make_partial_problem(tsize, layout, block_rows, vec, loads, n_splits, nkeep, keep_sizes,
                            keep_strides, ncontract, c_sizes, c_strides, rank, batch,
                            node_bstride, f_bstrides, &p))
    return (int)cudaErrorInvalidValue;
  Factors f;
  for (int d = 0; d < MAX_CONTRACT; ++d)
    f.ptr[d] = d < ncontract ? reinterpret_cast<const void*>(factors[d]) : nullptr;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  const bool rowl = layout == 0;
  if (dtype == 0)
    return vec == 1 ? dispatch_partial<float, 1>(p, rowl, node, f, o, s)
                    : dispatch_partial<float, 4>(p, rowl, node, f, o, s);
  return vec == 1 ? dispatch_partial<__nv_bfloat16, 1>(p, rowl, node, f, o, s)
                  : dispatch_partial<__nv_bfloat16, 8>(p, rowl, node, f, o, s);
}

}  // extern "C"

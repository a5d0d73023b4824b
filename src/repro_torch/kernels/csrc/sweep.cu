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
// partial_kernel<T> replaces src/repro/kernels/mttkrpn.py:
// mttkrp_partial_pallas (_partial_kernel), the dimension tree's
// rank-augmented partial contraction
//   O(i, r) = sum_{c_1..c_k} N(i, c_1..c_k, r) prod_d A_d(c_d, r),  k >= 1.
// The node carries the rank axis, so there is no product for tensor cores:
// each node element is read once and used once, and the kernel is bound by
// memory bandwidth (a (1000, 1000, 64) fp32 node is 2.56e8 B, 0.076 ms).
// Threads run along r, the node's contiguous last axis, so loads coalesce;
// the contraction is a loop inside the CTA with the weight
// W(c, r) = prod_d A_d(c_d, r) built per step in shared memory (k = 1 is the
// same loop with a one-factor weight). The output is small (I x R), so the
// outermost contraction axis is split over CTAs and the slabs are added by
// splitk_reduce_kernel: no atomics, results repeat bit for bit.
#include "ring.cuh"

struct SweepProblem {
  int ncontract;                      // contraction axes of the operand
  int block_i;                        // bi
  int block_r;                        // br
  int rank;                           // R
  int n_splits;                       // CTAs along the outermost contraction axis
  long long extent_i;                 // I
  long long extent_c[MAX_CONTRACT];   // C_1 .. C_nc
  int block_c[MAX_CONTRACT];          // bc_1 .. bc_nc
};

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
          if (col < rvalid) prow[col] = pt[mt][nt][2 * h];
          if (col + 1 < rvalid) prow[col + 1] = pt[mt][nt][2 * h + 1];
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
        if (col < rvalid) o[gi * p.rank + r0 + col] = a[0];
        if (col + 1 < rvalid) o[gi * p.rank + r0 + col + 1] = a[NTHREADS];
      }
    }
}

// --------------------------------------------------------------------------
// rank-augmented partial contraction
// --------------------------------------------------------------------------

// Shared-memory layout of the partial kernel:
// tab (kc x i64) | ws (kc x ldw) | accs (cparts x bi x ldw), fp32.
struct PartialLayout {
  int kc;      // prod bc: contraction indices of one step
  int rw;      // threads along r: a power of two >= br, at most NTHREADS
  int slots;   // NTHREADS / rw thread groups
  int cparts;  // groups sharing one row, each on a slice of the step (1 if slots <= bi)
  int ldw;     // br rounded up to rw
  long long ws, accs, total;  // byte offsets
};

static __host__ __device__ PartialLayout make_partial_layout(int nc, const int* bc, int bi,
                                                             int br) {
  PartialLayout l;
  l.kc = 1;
  for (int d = 0; d < nc; ++d) l.kc *= bc[d];
  l.rw = 1;
  while (l.rw < br && l.rw < NTHREADS) l.rw *= 2;
  l.slots = NTHREADS / l.rw;
  l.cparts = l.slots > bi ? l.slots / bi : 1;
  l.ldw = (int)round_up(br, l.rw);
  l.ws = 8LL * l.kc;
  l.accs = l.ws + 4LL * l.kc * l.ldw;
  l.total = l.accs + 4LL * l.cparts * bi * l.ldw;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
partial_kernel(SweepProblem p, const T* __restrict__ node, Factors f, float* __restrict__ out) {
  const int nc = p.ncontract;
  const int bi = p.block_i, br = p.block_r, R = p.rank;
  const PartialLayout l = make_partial_layout(nc, p.block_c, bi, br);
  const int ldw = l.ldw;

  extern __shared__ __align__(16) unsigned char smem[];
  long long* tab = reinterpret_cast<long long*>(smem);
  float* ws = reinterpret_cast<float*>(smem + l.ws);
  float* accs = reinterpret_cast<float*>(smem + l.accs);

  const int gr = (int)ceil_div(R, br);
  const int r0 = (blockIdx.x % gr) * br;
  const long long i0 = (long long)(blockIdx.x / gr) * bi;
  const int split = blockIdx.y;
  const int t = threadIdx.x;

  long long ntiles[MAX_CONTRACT];
  long long c_total = 1;
  for (int d = 0; d < nc; ++d) {
    ntiles[d] = ceil_div(p.extent_c[d], p.block_c[d]);
    c_total *= p.extent_c[d];
  }
  long long n_inner = 1;
  for (int d = 1; d < nc; ++d) n_inner *= ntiles[d];
  const long long o_begin = split * ntiles[0] / p.n_splits;
  const long long o_end = (split + 1) * ntiles[0] / p.n_splits;

  // thread -> column rr (+ multiples of rw), and its group -> rows and slice
  const int rr = t % l.rw, slot = t / l.rw;
  const int cpart = l.cparts > 1 ? slot / bi : 0;
  const bool active = cpart < l.cparts;
  const int row_begin = l.cparts > 1 ? slot % bi : slot;
  const int row_step = l.cparts > 1 ? bi : l.slots;
  const int cchunk = (int)ceil_div(l.kc, l.cparts);
  const int cb = cpart * cchunk;
  const int ce = cb + cchunk < l.kc ? cb + cchunk : l.kc;

  for (int e = t; e < l.cparts * bi * ldw; e += NTHREADS) accs[e] = 0.f;

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
    __syncthreads();  // the previous step is done with tab and ws
    // flat contraction offset of each index of the step (-1 out of range)
    for (int c = t; c < l.kc; c += NTHREADS) {
      int rem = c;
      int dig[MAX_CONTRACT];
      for (int d = nc - 1; d >= 0; --d) {
        dig[d] = rem % p.block_c[d];
        rem /= p.block_c[d];
      }
      long long g = 0;
      bool in = true;
      for (int d = 0; d < nc; ++d) {
        const long long gd = c0[d] + dig[d];
        in = in && gd < p.extent_c[d];
        g = g * p.extent_c[d] + gd;
      }
      tab[c] = in ? g : -1;
    }
    // weight W(c, r) = prod_d A_d(c_d, r), masked on C_d, br and R
    for (int e = t; e < l.kc * ldw; e += NTHREADS) {
      const int c = e / ldw, col = e - (e / ldw) * ldw;
      bool in = col < br && r0 + col < R;
      float v = 1.f;
      int rem = c;
      for (int d = nc - 1; d >= 0; --d) {
        const long long g = c0[d] + rem % p.block_c[d];
        rem /= p.block_c[d];
        if (!in || g >= p.extent_c[d]) {
          in = false;
        } else {
          v *= to_float(reinterpret_cast<const T*>(f.ptr[d])[g * R + r0 + col]);
        }
      }
      ws[e] = in ? v : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int row = row_begin; row < bi; row += row_step) {
      const long long gi = i0 + row;
      if (gi >= p.extent_i) break;
      const T* nrow = node + gi * c_total * R + r0;
      for (int col = rr; col < ldw; col += l.rw) {
        if (col >= br || r0 + col >= R) break;
        float acc = 0.f;
        for (int c = cb; c < ce; c += XLOADS) {
          float v[XLOADS];
#pragma unroll
          for (int u = 0; u < XLOADS; ++u) {
            v[u] = 0.f;
            if (c + u < ce) {
              const long long g = tab[c + u];
              if (g >= 0) v[u] = to_float(nrow[g * R + col]);
            }
          }
#pragma unroll
          for (int u = 0; u < XLOADS; ++u)
            if (c + u < ce) acc = fmaf(v[u], ws[(c + u) * ldw + col], acc);
        }
        accs[((long long)cpart * bi + row) * ldw + col] += acc;
      }
    }
  }
  __syncthreads();
  float* o = out + (long long)split * p.extent_i * R;
  for (int e = t; e < bi * br; e += NTHREADS) {
    const int row = e / br, col = e - (e / br) * br;
    const long long gi = i0 + row;
    if (gi >= p.extent_i || r0 + col >= R) continue;
    float s = 0.f;
    for (int q = 0; q < l.cparts; ++q) s += accs[((long long)q * bi + row) * ldw + col];
    o[gi * R + r0 + col] = s;
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

static int make_problem(int ncontract, const long long* extents, const int* blocks, int block_r,
                        int rank, int n_splits, const long long* factors, SweepProblem* p,
                        Factors* f) {
  if (ncontract < 1 || ncontract > MAX_CONTRACT || n_splits < 1 || block_r < 1 || rank < 1 ||
      blocks[0] < 1)
    return (int)cudaErrorInvalidValue;
  p->ncontract = ncontract;
  p->block_i = blocks[0];
  p->block_r = block_r;
  p->rank = rank;
  p->n_splits = n_splits;
  p->extent_i = extents[0];
  for (int d = 0; d < MAX_CONTRACT; ++d) {
    p->extent_c[d] = d < ncontract ? extents[1 + d] : 1;
    p->block_c[d] = d < ncontract ? blocks[1 + d] : 1;
    if (p->block_c[d] < 1) return (int)cudaErrorInvalidValue;
    f->ptr[d] = d < ncontract ? reinterpret_cast<const void*>(factors[d]) : nullptr;
  }
  return 0;
}

template <typename K, typename... Args>
static int launch(K kern, const SweepProblem& p, long long smem, cudaStream_t stream,
                  Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long gi = ceil_div(p.extent_i, p.block_i);
  const long long gr = ceil_div(p.rank, p.block_r);
  dim3 grid((unsigned)(gi * gr), (unsigned)p.n_splits);
  kern<<<grid, NTHREADS, smem, stream>>>(p, args...);
  return (int)cudaGetLastError();
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

// Bytes of dynamic shared memory the partial kernel takes for these blocks.
long long repro_partial_smem_bytes(int ncontract, const int* block_c, int block_i, int block_r) {
  return make_partial_layout(ncontract, block_c, block_i, block_r).total;
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
      const long long gi = ceil_div(p.extent_i, 64 * MT);
      const long long gr = ceil_div(p.rank, 16 * NT);
      dim3 grid((unsigned)(gi * gr), (unsigned)p.n_splits);
      kern<<<grid, NTHREADS, smem, s>>>(p, reinterpret_cast<const T*>(x), f, ob, op);
      return (int)cudaGetLastError();
    });
  };
  return dtype == 0 ? run(float()) : run(__nv_bfloat16());
}

// One launch of the partial kernel. dtype: 0 float32, 1 bfloat16.
// extents: I, C_1..C_k (the node is (I, C_1..C_k, R)); blocks: bi,
// bc_1..bc_k; factors: k device pointers. out: n_splits slabs of (I, R)
// fp32. Returns a cudaError_t.
int repro_partial(int dtype, int ncontract, const long long* extents, const int* blocks,
                  int block_r, int rank, int n_splits, const void* node,
                  const long long* factors, void* out, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  SweepProblem p;
  Factors f;
  int err = make_problem(ncontract, extents, blocks, block_r, rank, n_splits, factors, &p, &f);
  if (err) return err;
  const long long smem = make_partial_layout(ncontract, p.block_c, p.block_i, block_r).total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  if (dtype == 0)
    return launch(partial_kernel<float>, p, smem, s, reinterpret_cast<const float*>(node), f, o);
  return launch(partial_kernel<__nv_bfloat16>, p, smem, s,
                reinterpret_cast<const __nv_bfloat16*>(node), f, o);
}

}  // extern "C"

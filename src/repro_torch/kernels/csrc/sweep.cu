// The fused CP-ALS sweep's two kernels for Hopper (sm_90a).
//
// fused_pair_kernel<T> replaces src/repro/kernels/sweep.py:
// mttkrp_fused_pair_pallas (_fused_pair_kernel). One pass over a
// mode-0-canonical X (I, C_1..C_{N-1}) gives
//   P(i, c_1..c_{N-2}, r) = sum_{c_{N-1}} X(i, c..) A_{N-1}(c_{N-1}, r)
//   B0(i, r)              = sum_{c_1..c_{N-2}} P(i, c.., r) prod_d A_d(c_d, r).
// On the TPU both outputs stay resident across a sequential grid, P zeroed
// when the innermost c_{N-1} wraps. Here CTAs run in parallel, so the two
// sums are taken at two levels:
//   * a CTA owns an (i-tile, r-tile) and a range of the c_1 tiles (the
//     split); for each tile of the leading axes c_1..c_{N-2} it walks all of
//     c_{N-1} inside the kernel, accumulating the P tile
//     (bi * prod bc[:-1] rows x br, fp32 registers) from X and the A_{N-1}
//     tile, then writes that finished tile: P's tiles are disjoint between
//     CTAs and need no workspace;
//   * it then contracts the finished P tile (kept in shared memory) with the
//     Khatri-Rao block of the A_1..A_{N-2} tiles into an fp32 B0 tile in
//     shared memory. Each split writes its own B0 slab and
//     mttkrp.cu:splitk_reduce_kernel adds the slabs in a fixed order.
// That is 2|X|R + 2 I prod(C[:-1]) R operations (not the 4|X|R of building
// the full W and taking both products), and each X tile is read once per
// rank tile. What bounds it on an H100: at 1000^3, R=64 (fp32) the
// 1.28e11 operations on the CUDA cores (1.91 ms at 67 TFLOP/s) outweigh the
// 4.26e9 bytes of X and P (1.27 ms at 3.35 TB/s); at 180^4, R=32 the bytes
// (4.95e9, 1.48 ms) do. The design keeps the P product on fp32 FMAs fed from
// shared memory (common.cuh:row_product: a thread owns an 8-row x 4-column
// unit of the P tile, and one float4 of the A_{N-1} tile feeds 32 FMAs).
// Ragged edges are masked in the loads; nothing is padded.
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
#include "common.cuh"

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

// Shared-memory layout of the pair kernel, computed identically on host and
// device: xs (rows8 x ldx, input dtype) | tab_g, tab_p (rows x i64)
// | as (bl4 x ldw) | ps (rows8 x ldw) | wl (L x ldw) | b0s (bi x ldw), fp32.
struct PairLayout {
  int lead;       // L = prod bc[:-1]: leading index tuples of one tile
  RowProduct p;   // the P tile: bi * L rows x br, along c_{N-1} in chunks of bc[-1]
  long long tab_g, tab_p, as, ps, wl, b0s, total;  // byte offsets
};

static __host__ __device__ PairLayout make_pair_layout(int tsize, int nc, const int* bc, int bi,
                                                       int br) {
  PairLayout l;
  l.lead = 1;
  for (int d = 0; d < nc - 1; ++d) l.lead *= bc[d];
  l.p = make_row_product(tsize, bi * l.lead, bc[nc - 1], br);
  const int ldw = l.p.ldw;
  l.tab_g = round_up((long long)l.p.rows8 * l.p.ldx * tsize, 16);
  l.tab_p = l.tab_g + 8LL * l.p.rows;
  l.as = round_up(l.tab_p + 8LL * l.p.rows, 16);
  l.ps = l.as + 4LL * l.p.bl4 * ldw;
  l.wl = l.ps + 4LL * l.p.rows8 * ldw;
  l.b0s = l.wl + 4LL * l.lead * ldw;
  l.total = l.b0s + 4LL * bi * ldw;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fused_pair_kernel(SweepProblem p, const T* __restrict__ x, Factors f, float* __restrict__ b0,
                  float* __restrict__ pout) {
  const int nc = p.ncontract, nlead = nc - 1;
  const int bi = p.block_i, br = p.block_r, R = p.rank;
  const PairLayout l = make_pair_layout(sizeof(T), nc, p.block_c, bi, br);
  const int L = l.lead, ldw = l.p.ldw, rows = l.p.rows;

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  long long* tab_g = reinterpret_cast<long long*>(smem + l.tab_g);
  long long* tab_p = reinterpret_cast<long long*>(smem + l.tab_p);
  float* as = reinterpret_cast<float*>(smem + l.as);
  float* ps = reinterpret_cast<float*>(smem + l.ps);
  float* wl = reinterpret_cast<float*>(smem + l.wl);
  float* b0s = reinterpret_cast<float*>(smem + l.b0s);

  const int gr = (int)ceil_div(R, br);
  const int r0 = (blockIdx.x % gr) * br;
  const long long i0 = (long long)(blockIdx.x / gr) * bi;
  const int split = blockIdx.y;
  const int t = threadIdx.x;

  long long ntiles[MAX_CONTRACT];
  for (int d = 0; d < nc; ++d) ntiles[d] = ceil_div(p.extent_c[d], p.block_c[d]);
  long long n_inner = 1;  // tiles of the leading axes after c_1
  for (int d = 1; d < nlead; ++d) n_inner *= ntiles[d];
  const long long o_begin = split * ntiles[0] / p.n_splits;
  const long long o_end = (split + 1) * ntiles[0] / p.n_splits;
  const long long c_last = p.extent_c[nc - 1];
  const T* fl = reinterpret_cast<const T*>(f.ptr[nc - 1]);

  // pad rows and columns of xs stay zero for the whole run
  for (int e = t; e < l.p.rows8 * l.p.ldx; e += NTHREADS) xs[e] = zero_val<T>();
  for (int e = t; e < bi * ldw; e += NTHREADS) b0s[e] = 0.f;

  for (long long step = o_begin * n_inner; step < o_end * n_inner; ++step) {
    long long c0[MAX_CONTRACT];
    {
      long long rem = step;
      for (int d = nlead - 1; d >= 1; --d) {
        c0[d] = (rem % ntiles[d]) * p.block_c[d];
        rem /= ntiles[d];
      }
      c0[0] = rem * p.block_c[0];
    }
    __syncthreads();  // the previous leading tile is done with the tables, wl and ps
    // per P-tile row (i, leading tuple): X's run at c_{N-1} = 0 and P's row,
    // -1 where the row or a leading index is out of range
    for (int row = t; row < rows; row += NTHREADS) {
      const int il = row / L;
      int rem = row - il * L;
      long long off = i0 + il;
      bool in = off < p.extent_i;
      int dig[MAX_CONTRACT];
      for (int d = nlead - 1; d >= 0; --d) {
        dig[d] = rem % p.block_c[d];
        rem /= p.block_c[d];
      }
      for (int d = 0; d < nlead; ++d) {
        const long long g = c0[d] + dig[d];
        in = in && g < p.extent_c[d];
        off = off * p.extent_c[d] + g;
      }
      tab_g[row] = in ? off * c_last : -1;
      tab_p[row] = in ? off * R : -1;
    }
    // Khatri-Rao block of the leading factor tiles, masked on C_d, br and R
    for (int e = t; e < L * ldw; e += NTHREADS) {
      const int q = e / ldw, rr = e - (e / ldw) * ldw;
      bool in = rr < br && r0 + rr < R;
      float v = 1.f;
      int rem = q;
      for (int d = nlead - 1; d >= 0; --d) {
        const long long g = c0[d] + rem % p.block_c[d];
        rem /= p.block_c[d];
        if (!in || g >= p.extent_c[d]) {
          in = false;
        } else {
          v *= to_float(reinterpret_cast<const T*>(f.ptr[d])[g * R + r0 + rr]);
        }
      }
      wl[e] = in ? v : 0.f;
    }

    // the P tile: X(rows, c_{N-1}) A_{N-1}(c_{N-1}, r0 .. r0 + br)
    row_product(l.p, x, tab_g, fl, R, r0, br, 0, c_last, xs, as, ps);

    // the finished P tile out to device memory (rows and r masked)
    for (int e = t; e < rows * br; e += NTHREADS) {
      const int row = e / br, rr = e - (e / br) * br;
      const long long g = tab_p[row];
      if (g >= 0 && r0 + rr < R) pout[g + r0 + rr] = ps[row * ldw + rr];
    }
    // B0 tile += sum over the leading tuples of P * W, each element owned by one thread
    for (int e = t; e < bi * ldw; e += NTHREADS) {
      const int il = e / ldw, rr = e - (e / ldw) * ldw;
      const float* prow = ps + (long long)il * L * ldw + rr;
      float s = b0s[e];
      for (int q = 0; q < L; ++q) s = fmaf(prow[q * ldw], wl[q * ldw + rr], s);
      b0s[e] = s;
    }
  }
  __syncthreads();
  float* o = b0 + (long long)split * p.extent_i * R;
  for (int e = t; e < bi * br; e += NTHREADS) {
    const int il = e / br, rr = e - (e / br) * br;
    const long long gi = i0 + il;
    if (gi < p.extent_i && r0 + rr < R) o[gi * R + r0 + rr] = b0s[il * ldw + rr];
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

// Bytes of dynamic shared memory the pair kernel takes for these blocks.
long long repro_fused_pair_smem_bytes(int tsize, int ncontract, const int* block_c, int block_i,
                                      int block_r) {
  return make_pair_layout(tsize, ncontract, block_c, block_i, block_r).total;
}

// Bytes of dynamic shared memory the partial kernel takes for these blocks.
long long repro_partial_smem_bytes(int ncontract, const int* block_c, int block_i, int block_r) {
  return make_partial_layout(ncontract, block_c, block_i, block_r).total;
}

// One launch of the pair kernel. dtype: 0 float32, 1 bfloat16.
// extents: I, C_1..C_{N-1}; blocks: bi, bc_1..bc_{N-1}; factors: N-1 device
// pointers. b0: n_splits slabs of (I, R) fp32; p: (I, C_1..C_{N-2}, R) fp32.
// Returns a cudaError_t.
int repro_fused_pair(int dtype, int ncontract, const long long* extents, const int* blocks,
                     int block_r, int rank, int n_splits, const void* x,
                     const long long* factors, void* b0, void* pout, void* stream) {
  if (ncontract < 2 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  SweepProblem p;
  Factors f;
  int err = make_problem(ncontract, extents, blocks, block_r, rank, n_splits, factors, &p, &f);
  if (err) return err;
  const long long smem = make_pair_layout(dtype == 0 ? 4 : 2, ncontract, p.block_c, p.block_i,
                                          block_r).total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* ob = reinterpret_cast<float*>(b0);
  float* op = reinterpret_cast<float*>(pout);
  if (dtype == 0)
    return launch(fused_pair_kernel<float>, p, smem, s, reinterpret_cast<const float*>(x), f, ob,
                  op);
  return launch(fused_pair_kernel<__nv_bfloat16>, p, smem, s,
                reinterpret_cast<const __nv_bfloat16*>(x), f, ob, op);
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

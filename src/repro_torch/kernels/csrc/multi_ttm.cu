// The kept-mode Multi-TTM (the Tucker/HOOI workhorse) for Hopper (sm_90a).
//
// multi_ttm_kernel<T> replaces src/repro/kernels/multi_ttm.py:
// multi_ttm_keep_pallas (_kernel). For a kept-mode-first X (I, C_1..C_k) and
// k matrices A_d (C_d, R_d) it computes
//   O(i, r_1..r_k) = sum_c X(i, c_1..c_k) prod_d A_d(c_d, r_d),
// an fp32 (I, prod R_d) output, columns in C order over (r_1..r_k).
//
// The TPU kernel builds the whole Kronecker weight W[(c_1..c_k), (r_1..r_k)]
// each grid step and takes one matmul against it: 2 |X| prod R_d operations
// (2.05e12 at 1000^3 with ranks (32, 32)). Here the modes are contracted one
// after another inside the CTA and W is never formed:
//   1. T(i, c_1..c_{k-1}, r_k) = sum_{c_k} X(i, c..) A_k(c_k, r_k): X is
//      streamed along its contiguous last axis c_k and multiplied with the
//      A_k chunk in shared memory on fp32 FMAs (common.cuh:row_product, the
//      fused pair kernel's P product);
//   2. the leading axes are folded, c_{k-1} first, each a small contraction
//      in shared memory, V_d(i, c_1..c_{d-1}, r_d..r_k)
//      = sum_{c_d} V_{d+1}(i, c_1..c_d, r_{d+1}..r_k) A_d(c_d, r_d), the last
//      fold (c_1) adding into the output tile O (bi x prod R_d, fp32, shared
//      memory), which stays resident across the CTA's steps.
// That is 2 |X| R_k operations for step 1 plus a few per cent for the folds
// (6.6e10 in all at 1000^3, R=32), so on an H100 the kernel is bound by
// reading X once (4.0e9 B, 1.19 ms at 3.35 TB/s), not by the 1.0 ms of fp32
// FMAs. X is read from device memory once: a CTA owns a tile of bi rows and
// a range of c_1 tiles (the split), and walks every tile of c_2..c_{k-1} and
// all of c_k for them. The output is small, so the c_1 tiles are split over
// n_splits CTAs; each writes an fp32 slab of an (n_splits, I, prod R_d)
// workspace and mttkrp.cu:splitk_reduce_kernel adds the slabs in slab order:
// no atomics, results repeat bit for bit. With one contraction axis (k = 1)
// the split runs along the c_k chunks instead. Ragged edges are masked in the
// loads (zero rows, zero matrix rows); nothing is padded.
#include "common.cuh"

struct TtmProblem {
  int ncontract;                      // k
  int block_i;                        // bi
  int n_splits;                       // CTAs along c_1 (along c_k when k = 1)
  long long extent_i;                 // I
  long long extent_c[MAX_CONTRACT];   // C_1 .. C_k
  int block_c[MAX_CONTRACT];          // bc_1 .. bc_k (bc_k: the chunk along c_k)
  int rank[MAX_CONTRACT];             // R_1 .. R_k
};

// Shared-memory layout, computed identically on host and device (and in
// repro_torch/engine/plan.py:multi_ttm_kernel_smem_bytes): the row
// product's xs (rows8 x ldx, input dtype) | tab (rows x i64) | as (bl4 x ldw)
// | ps (T, rows8 x ldw) | fa (the leading matrices' tiles, bc_d x R_d each)
// | v_d (d = 2..k-1: bi prod bc[<d] x prod R[>=d]) | os (bi x prod R), fp32.
struct TtmLayout {
  int lead;       // L = prod bc[:-1]: leading index tuples of one tile
  RowProduct p;   // T: bi * L rows x R_k, along c_k in chunks of bc[-1]
  long long prod_r;
  long long tab, as, ps, fa, v[MAX_CONTRACT], os, total;  // byte offsets
};

static __host__ __device__ TtmLayout make_ttm_layout(int tsize, int nc, const int* bc, int bi,
                                                     const int* rank) {
  TtmLayout l;
  l.lead = 1;
  for (int d = 0; d < nc - 1; ++d) l.lead *= bc[d];
  l.p = make_row_product(tsize, bi * l.lead, bc[nc - 1], rank[nc - 1]);
  l.prod_r = 1;
  for (int d = 0; d < nc; ++d) l.prod_r *= rank[d];
  l.tab = round_up((long long)l.p.rows8 * l.p.ldx * tsize, 16);
  l.as = round_up(l.tab + 8LL * l.p.rows, 16);
  l.ps = l.as + 4LL * l.p.bl4 * l.p.ldw;
  l.fa = l.ps + 4LL * l.p.rows8 * l.p.ldw;
  long long off = l.fa;
  for (int d = 0; d < nc - 1; ++d) off += 4LL * bc[d] * rank[d];
  for (int d = 0; d < MAX_CONTRACT; ++d) l.v[d] = 0;
  for (int d = 1; d < nc - 1; ++d) {  // v[d] is the fold of axis d (0-based) out
    long long rows_d = bi, cols_d = 1;
    for (int e = 0; e < d; ++e) rows_d *= bc[e];
    for (int e = d; e < nc; ++e) cols_d *= rank[e];
    l.v[d] = off;
    off += 4LL * rows_d * cols_d;
  }
  l.os = off;
  l.total = off + 4LL * bi * l.prod_r;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
multi_ttm_kernel(TtmProblem p, const T* __restrict__ x, Factors f, float* __restrict__ out) {
  const int nc = p.ncontract, nlead = nc - 1;
  const int bi = p.block_i, rl = p.rank[nc - 1];
  const TtmLayout l = make_ttm_layout(sizeof(T), nc, p.block_c, bi, p.rank);
  const int L = l.lead, bl = l.p.bl, ldw = l.p.ldw, rows = l.p.rows;
  const long long prod_r = l.prod_r;

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  long long* tab = reinterpret_cast<long long*>(smem + l.tab);
  float* as = reinterpret_cast<float*>(smem + l.as);
  float* ps = reinterpret_cast<float*>(smem + l.ps);
  float* fa = reinterpret_cast<float*>(smem + l.fa);
  float* os = reinterpret_cast<float*>(smem + l.os);

  const long long i0 = (long long)blockIdx.x * bi;
  const int split = blockIdx.y;
  const int t = threadIdx.x;
  const long long c_last = p.extent_c[nc - 1];
  const T* al = reinterpret_cast<const T*>(f.ptr[nc - 1]);

  // the CTA's leading steps (tiles of c_1..c_{k-1}; the split along c_1)
  // and its range of c_k (all of it, unless k = 1 and the split runs there)
  long long ntiles[MAX_CONTRACT];
  for (int d = 0; d < nlead; ++d) ntiles[d] = ceil_div(p.extent_c[d], p.block_c[d]);
  long long n_inner = 1;
  for (int d = 1; d < nlead; ++d) n_inner *= ntiles[d];
  long long step_begin = 0, step_end = 1, cl_begin = 0, cl_end = c_last;
  if (nlead > 0) {
    step_begin = split * ntiles[0] / p.n_splits * n_inner;
    step_end = (split + 1) * ntiles[0] / p.n_splits * n_inner;
  } else {
    const long long chunks = ceil_div(c_last, bl);
    cl_begin = split * chunks / p.n_splits * bl;
    cl_end = (split + 1) * chunks / p.n_splits * bl;
    if (cl_end > c_last) cl_end = c_last;
  }

  // pad rows and columns of xs stay zero for the whole run; O starts at zero
  for (int e = t; e < l.p.rows8 * l.p.ldx; e += NTHREADS) xs[e] = zero_val<T>();
  for (long long e = t; e < bi * prod_r; e += NTHREADS) os[e] = 0.f;

  for (long long step = step_begin; step < step_end; ++step) {
    long long c0[MAX_CONTRACT];
    {
      long long rem = step;
      for (int d = nlead - 1; d >= 1; --d) {
        c0[d] = (rem % ntiles[d]) * p.block_c[d];
        rem /= ntiles[d];
      }
      if (nlead > 0) c0[0] = rem * p.block_c[0];
    }
    __syncthreads();  // the previous step is done with tab, fa, ps and the folds
    // per T row (i, leading tuple): X's offset at c_k = 0, -1 where the row
    // or a leading index is out of range
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
      tab[row] = in ? off * c_last : -1;
    }
    // the leading matrices' tiles (fp32), rows beyond C_d zero
    {
      float* dst = fa;
      for (int d = 0; d < nlead; ++d) {
        const T* ad = reinterpret_cast<const T*>(f.ptr[d]);
        const int rd = p.rank[d];
        for (int e = t; e < p.block_c[d] * rd; e += NTHREADS) {
          const long long g = c0[d] + e / rd;
          dst[e] = g < p.extent_c[d] ? to_float(ad[g * rd + e % rd]) : 0.f;
        }
        dst += p.block_c[d] * rd;
      }
    }

    // step 1: T = X(rows, c_k) A_k, over the CTA's range of c_k
    row_product(l.p, x, tab, al, rl, 0, rl, cl_begin, cl_end, xs, as, ps);

    // step 2: fold the leading axes into O, c_{k-1} first; each output
    // element is owned by one thread, its sum over c_d taken in order
    if (nlead == 0) {
      for (long long e = t; e < (long long)bi * rl; e += NTHREADS)
        os[e] += ps[(e / rl) * ldw + e % rl];
      continue;
    }
    const float* src = ps;
    long long src_ld = ldw, src_cols = rl;
    long long a_off = 0;
    for (int d = 0; d < nlead - 1; ++d) a_off += (long long)p.block_c[d] * p.rank[d];
    for (int d = nlead - 1; d >= 0; --d) {
      const int bcd = p.block_c[d], rd = p.rank[d];
      long long rows_out = bi;
      for (int e = 0; e < d; ++e) rows_out *= p.block_c[e];
      const long long cols_out = rd * src_cols;
      float* dst = d == 0 ? os : reinterpret_cast<float*>(smem + l.v[d]);
      const float* ad = fa + a_off;
      for (long long e = t; e < rows_out * cols_out; e += NTHREADS) {
        const long long row = e / cols_out, rem = e - row * cols_out;
        const int r = (int)(rem / src_cols);
        const long long col = rem - r * src_cols;
        const float* s_in = src + row * bcd * src_ld + col;
        float s = 0.f;
        for (int c = 0; c < bcd; ++c) s = fmaf(s_in[c * src_ld], ad[c * rd + r], s);
        if (d == 0) {
          dst[e] += s;
        } else {
          dst[e] = s;
        }
      }
      __syncthreads();
      src = dst;
      src_ld = cols_out;
      src_cols = cols_out;
      if (d > 0) a_off -= (long long)p.block_c[d - 1] * p.rank[d - 1];
    }
  }
  __syncthreads();
  float* o = out + (long long)split * p.extent_i * prod_r;
  for (long long e = t; e < bi * prod_r; e += NTHREADS) {
    const long long gi = i0 + e / prod_r;
    if (gi < p.extent_i) o[gi * prod_r + e % prod_r] = os[e];
  }
}

extern "C" {

// Bytes of dynamic shared memory the kernel takes for these blocks and ranks.
long long repro_multi_ttm_smem_bytes(int tsize, int ncontract, const int* block_c, int block_i,
                                     const int* ranks) {
  return make_ttm_layout(tsize, ncontract, block_c, block_i, ranks).total;
}

// One launch. dtype: 0 float32, 1 bfloat16. extents: I, C_1..C_k; blocks:
// bi, bc_1..bc_k; ranks: R_1..R_k; mats: k device pointers to (C_d, R_d)
// matrices of the tensor's dtype. out: n_splits slabs of (I, prod R_d) fp32.
// Returns a cudaError_t.
int repro_multi_ttm(int dtype, int ncontract, const long long* extents, const int* blocks,
                    const int* ranks, int n_splits, const void* x, const long long* mats,
                    void* out, void* stream) {
  if (ncontract < 1 || ncontract > MAX_CONTRACT || n_splits < 1 || blocks[0] < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  TtmProblem p;
  Factors f;
  p.ncontract = ncontract;
  p.block_i = blocks[0];
  p.n_splits = n_splits;
  p.extent_i = extents[0];
  for (int d = 0; d < MAX_CONTRACT; ++d) {
    p.extent_c[d] = d < ncontract ? extents[1 + d] : 1;
    p.block_c[d] = d < ncontract ? blocks[1 + d] : 1;
    p.rank[d] = d < ncontract ? ranks[d] : 1;
    if (p.block_c[d] < 1 || p.rank[d] < 1) return (int)cudaErrorInvalidValue;
    f.ptr[d] = d < ncontract ? reinterpret_cast<const void*>(mats[d]) : nullptr;
  }
  const long long smem =
      make_ttm_layout(dtype == 0 ? 4 : 2, ncontract, p.block_c, p.block_i, p.rank).total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* o = reinterpret_cast<float*>(out);
  dim3 grid((unsigned)ceil_div(p.extent_i, p.block_i), (unsigned)n_splits);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(multi_ttm_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    multi_ttm_kernel<float><<<grid, NTHREADS, smem, s>>>(p, reinterpret_cast<const float*>(x),
                                                         f, o);
  } else {
    err = cudaFuncSetAttribute(multi_ttm_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    multi_ttm_kernel<__nv_bfloat16><<<grid, NTHREADS, smem, s>>>(
        p, reinterpret_cast<const __nv_bfloat16*>(x), f, o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

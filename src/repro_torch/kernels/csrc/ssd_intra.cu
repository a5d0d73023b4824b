// The Mamba2 intra-chunk SSD term for Hopper (sm_90a), on the tensor cores.
//
// ssd_intra_kernel<T> replaces src/repro/kernels/ssd_intra.py:
// ssd_intra_pallas (_ssd_intra_kernel). For each batch-chunk c, row i and
// head h of a chunk of q positions,
//   Y[c,i,h,:] = sum_{j<=i} (C[c,i].B[c,j]) exp(cum[c,i,h] - cum[c,j,h])
//                           dt[c,j,h] X[c,j,h,:],
// with C, B (BC, q, N), cum, dt (BC, q, H) in fp32, X (BC, q, H, P) in fp32
// or bf16, and Y (BC, q, H, P) in X's dtype, summed in fp32. It is the only
// kernel of the Mamba2 prefill (repro/models/ssm.py:125-147, one launch a
// layer): it keeps the (q, q) Gram and the (q, q, H) decay-weighted scores
// out of device memory.
//
// The bound on an H100: its bytes. The operands and the output are 0.36 GB
// at Mamba2-2.7b's q=256, N=128, H=80, P=64, BC=64 (0.108 ms at 3.35 TB/s,
// x bf16). The causal half of the products, 2 BC q(q+1)/2 (N + H P) = 2.2e10
// operations, takes 0.045 ms as two bf16 products and 0.13 ms as three tf32
// ones. Beside them run the weights' exps, one per (i, j <= i, h) to a
// granularity of 16: 1.8e8 on the special-function units (0.05 ms at 16 a
// clock an SM). What bounds it in practice is issue and latency: the W
// build, the products, the X copies and the Gram each cost a similar share,
// and a step's phases overlap only across warps and the two CTAs an SM
// (scripts/probe_ssd.py times the kernel with each compiled out; PERF.md
// has the shares).
//
// A CTA owns a tile of t rows i of one batch-chunk and a block of heads
// (a 1-D grid, the i-tiles with the most j-tiles first, since they take
// longest):
//   1. the Gram G[i][j] = C[i0 + i] . B[j] for every j-tile at or below the
//      diagonal (tiles above are skipped): 3xTF32 mma.sync.m16n8k8 over N in
//      chunks of GK through a two-stage cp.async ring, a fresh partial a
//      chunk folded into fp32 sums, stored in shared memory in fp32 once and
//      kept for every head of the block;
//   2. per round of HC heads (8 warps: t/16 row blocks of 16 x CW column
//      blocks of 64 of P a head, HC heads at once), per j-tile (a step):
//      the step's X tiles (t rows H*P apart in device memory), cum_j, dt_j
//      and cum_i come through a two-stage cp.async ring (16-, 8- or 4-byte
//      copies as P * itemsize and the pointer allow, element loads for bf16
//      rows of odd length), the next step's copies in flight while this
//      step multiplies. Each warp builds its own rows of the weights
//      W = G ⊙ exp(cum_i - cum_j) ⊙ dt_j in fp32 straight into its A
//      fragments (G, cum_j and dt_j kept in fragment order, so a lane reads
//      them with vector loads). In the diagonal tile j <= i is selected
//      before the exp is used (above the diagonal cum_i - cum_j can be
//      large enough for exp to overflow, and inf * 0 is NaN); below it no
//      mask is needed. For P <= 64 each W element is built by one thread
//      and used by one warp, so W never passes through shared memory and
//      needs no barrier of its own. The products: x bf16 splits W into
//      hi = bf16(W) and lo = bf16(W - hi) and runs two
//      mma.sync.m16n8k16.bf16, lo X then hi X, against the X tile, which is
//      exact in bf16 (W kept to ~2^-16 of each weight, as the fp32 weights
//      of the plain version); x fp32 runs 3xTF32 on W and X (ring.cuh). In
//      the diagonal tile a warp skips the k-steps wholly above its rows.
//      Each j-tile's products start from a fresh partial, folded into the
//      fp32 output sums with ordinary (round-to-nearest) adds: the tensor
//      cores' own adds truncate. After the round's diagonal tile the sums
//      are written once, in X's dtype, a warp store covering whole 32-byte
//      sectors of 8 rows.
// Ragged edges (rows past q, N not a multiple of GK, P not a multiple of 8)
// are masked by zero-fill copies and in the stores; nothing is padded in
// device memory, and rows past q may hold any value in registers, since a
// row of an MMA's output depends on that row of A alone and is not stored.
// There are no atomics: each output element is summed by one thread in a
// fixed order, so results repeat bit for bit. mma.sync on ring.cuh's
// primitives: a wgmma version (W from the warps' registers, each X tile
// read once by a warpgroup's tensor cores from shared memory in wgmma's
// layout) ran its products faster but the step slower at the served shape
// (PERF.md, section 6); TMA is untried.
#include "ring.cuh"

#define GK 32     // the Gram's N chunk: 128 bytes of a C or B row
#define GROW 144  // bytes a C or B row takes in the Gram's stage: 128 + 16 of skew
#define WNT 8     // n-tiles of 8 columns a warp: 64 columns of P

struct SsdProblem {
  long long bcn;  // BC
  int q, n, h, p;
  int heads;      // heads per CTA
  int tile;       // t: rows i (and columns j) of a tile, 16, 32 or 64
  int copy_cb;    // bytes a copy of C and B rows: 16, 8 or 4
  int copy_x;     // bytes a copy of X rows: 16, 8, 4, or 0 for element loads
};

// Shared-memory layout, computed identically on host and device (and in
// repro_torch/kernels/ssd_intra.py:kernel_smem_bytes), in bytes:
//   G (t rows x ldg fp32: q rounded up to t, and the skew that makes the
//   W build's vector loads conflict-free: ldg = 16 mod 32 for bf16 X, 8 mod
//   16 for fp32)
//   | two stages of cum_j, dt_j and cum_i for HC heads (3 x HC x t fp32)
//   | the ring: two stages of HC X tiles (t rows of xrow bytes: CW x 64
//   columns and 16 (bf16) or 32 (fp32) bytes of skew), which first serve as
//   the Gram's two stages of C and B chunks (2 x 2t rows of GROW bytes).
// G's columns and cum_j, dt_j are kept in fragment order (frag_pos).
struct SsdLayout {
  int rb, cw, hc;  // row blocks of 16 a head, column blocks of 64, heads at once (1, 2, 4, 8)
  int ldg;         // floats a row of G
  int xrow, xhead; // bytes an X row, and one head's X tile
  long long cd, ring, total;  // offsets of the cum/dt stages and the ring; bytes
};

static __host__ __device__ SsdLayout make_ssd_layout(int q, int p, int t, int tsize) {
  SsdLayout l;
  l.rb = t / 16;
  l.cw = (p + 63) / 64;
  l.hc = 8 / (l.rb * l.cw);
  const int q_pad = (int)round_up(q, t);
  l.ldg = tsize == 4 ? q_pad + 8 : (q_pad % 32 == 0 ? q_pad + 16 : q_pad);
  l.xrow = l.cw * 64 * tsize + (tsize == 4 ? 32 : 16);
  l.xhead = t * l.xrow;
  l.cd = (long long)t * l.ldg * 4;
  l.ring = l.cd + 2LL * 3 * l.hc * t * 4;
  const long long xring = 2LL * l.hc * l.xhead;
  const long long gram = 4LL * t * GROW;
  l.total = l.ring + (xring > gram ? xring : gram);
  return l;
}

// A plan the kernel takes: t of 16, 32 or 64, P <= 256 in at most 8 warps.
static __host__ __device__ bool valid_ssd_plan(int p, int t) {
  return (t == 16 || t == 32 || t == 64) && p >= 1 && p <= 256 && (t / 16) * ((p + 63) / 64) <= 8;
}

// Where column j of G (or of cum_j, dt_j) sits: in each k-step's group of
// columns the ones one lane reads come together, so one vector load fetches
// them: bf16 X (k-steps of 16) lane tq reads 2tq, 2tq+1, 2tq+8, 2tq+9;
// fp32 X (k-steps of 8) tq, tq+4.
__device__ __forceinline__ int frag_pos(int j, bool f32) {
  if (f32) {
    const int m = j & 7;
    return (j & ~7) | ((m & 3) << 1) | (m >> 2);
  }
  const int m = j & 15;
  return (j & ~15) | (((m & 7) >> 1) << 2) | ((m >> 3) << 1) | (m & 1);
}

__device__ __forceinline__ void store_as(float* p, float v) { store_result(p, v); }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  store_result(p, __float2bfloat16(v));
}

// x = hi + lo for 3xTF32: hi rounded to tf32, lo the exact fp32 remainder.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Two floats as a bf16 pair (round to nearest), the first in the low half
// (an A-fragment register of m16n8k16).
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two weights as the bf16 pairs hi = bf16(w) and lo = bf16(w - hi).
__device__ __forceinline__ void split_bf16(float w0, float w1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(w0, w1);
  lo = pack_bf16(w0 - __uint_as_float(hi << 16), w1 - __uint_as_float(hi & 0xffff0000u));
}

// A quad's 4 x 4 words transposed: lane k holds row k in v[0..3] before and
// column k after. Three shuffles; register indices by selects, so nothing
// goes to local memory.
__device__ __forceinline__ unsigned pick4(const unsigned (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}
__device__ __forceinline__ void quad_transpose(unsigned (&v)[4], int k) {
  unsigned o[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll
  for (int r = 1; r < 4; ++r) {  // lane k sends M[k][k ^ r], gets M[k ^ r][k]
    const unsigned got = __shfl_xor_sync(0xffffffffu, pick4(v, k ^ r), r);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = (k ^ r) == e ? got : o[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = o[e];
}

// One weight G exp(cum_i - cum_j) dt_j; in the diagonal tile (MASK) zero
// where j > i, selected before the exp is used.
template <bool MASK>
__device__ __forceinline__ float weight(int jl, int il, float g, float ci, float cj, float dj) {
  const float w = g * __expf(ci - cj) * dj;
  return MASK && jl > il ? 0.f : w;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
    ssd_intra_kernel(SsdProblem pr, const float* __restrict__ cc, const float* __restrict__ bc,
                     const float* __restrict__ cum, const float* __restrict__ dt,
                     const T* __restrict__ x, T* __restrict__ out) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int TS = (int)sizeof(T);
  constexpr int KS = F32 ? 8 : 16;  // j a k-step
  extern __shared__ __align__(16) unsigned char smem[];
  const SsdLayout l = make_ssd_layout(pr.q, pr.p, pr.tile, TS);
  const int t = pr.tile, q = pr.q, n = pr.n, nh = pr.h, np = pr.p, ldg = l.ldg;
  const int n_it = (int)ceil_div(q, t), hblocks = nh / pr.heads;
  const long long per_it = pr.bcn * hblocks;
  const int it = n_it - 1 - (int)(blockIdx.x / per_it);  // the longest CTAs first
  const long long c = (blockIdx.x % per_it) / hblocks;
  const int h0 = (int)(blockIdx.x % hblocks) * pr.heads;
  const int i0 = it * t;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int lt = __ffs(t) - 1;  // log2(t)
  float* gs = reinterpret_cast<float*>(smem);  // gs[i * ldg + frag_pos(j)] = G[i0 + i][j]
  float* cdbuf = reinterpret_cast<float*>(smem + l.cd);
  unsigned char* ring = smem + l.ring;
  const unsigned ring_s = smem_u32(ring);

  // 1. the Gram tiles G[i][j], every j-tile jt <= it
  // Gram:
  {
    const int nkc = (int)ceil_div(n, GK), nk = (it + 1) * nkc;
    const int v = pr.copy_cb, lpr = __ffs(GK * 4 / v) - 1;  // log2(copies a row)
    auto gram_copy = [&](int k) {
      const int jt = k / nkc, k0 = (k % nkc) * GK;
      const unsigned st = ring_s + (k & 1) * 2 * t * GROW;  // C rows, then B rows
      for (int e = tid; e < (2 * t) << lpr; e += NTHREADS) {
        const int r = e >> lpr, seg = e & ((1 << lpr) - 1);
        const bool is_c = r < t;
        const int row = is_c ? i0 + r : jt * t + r - t, col = k0 + seg * (v / 4);
        const bool in = row < q && col < n;
        const float* src = (is_c ? cc : bc) + (c * q + row) * n + col;
        cp_async_v(v, st + r * GROW + seg * v, in ? static_cast<const void*>(src) : cc, in);
      }
    };
    // warp units: rows 16 rbw, n-tiles (of 8 columns j) warp / rbn + u 8 / rbn
    const int rbn = t / 16, rbw = warp % rbn;
    int gnt[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) gnt[u] = warp / rbn + u * (8 / rbn);
    float acc[4][4], part[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    gram_copy(0);
    cp_async_commit();
    for (int k = 0; k < nk; ++k) {
      cp_async_wait(0);
      __syncthreads();  // chunk k is in; chunk k - 1's stage is consumed
      if (k + 1 < nk) gram_copy(k + 1);
      cp_async_commit();
      const unsigned st = ring_s + (k & 1) * 2 * t * GROW;
      const float* bs = reinterpret_cast<const float*>(ring + (k & 1) * 2 * t * GROW + t * GROW);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[u][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < GK / 8; ++kk) {
        unsigned a[4], ah[4], al[4];
        ldmatrix_x4(st + (rbw * 16 + (lane & 15)) * GROW + kk * 32 + (lane >> 4) * 16, a);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (gnt[u] >= t / 8) continue;
          // B(k, n) = B[j = 8 gnt + g][k]: rows of the B chunk, four k apart
          const float* b = bs + (gnt[u] * 8 + g) * (GROW / 4) + kk * 8 + tq;
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(b[0], bh0, bl0);
          split_tf32(b[4], bh1, bl1);
          mma_tf32(part[u], al, bh0, bh1);  // 3xTF32, the small terms first
          mma_tf32(part[u], ah, bl0, bl1);
          mma_tf32(part[u], ah, bh0, bh1);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] += part[u][e];
      if (k % nkc == nkc - 1) {  // the j-tile's last chunk: store its G tile
        const int j0 = (k / nkc) * t;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (gnt[u] < t / 8) {
            float* gr = gs + (rbw * 16 + g) * ldg;
            const int j = j0 + gnt[u] * 8 + 2 * tq;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              gr[frag_pos(j + e, F32)] = acc[u][e];
              gr[8 * ldg + frag_pos(j + e, F32)] = acc[u][2 + e];
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();  // G is complete; the ring's Gram stages are consumed

  // 2. rounds of HC heads, a j-tile a step: out += W X on the tensor cores
  const int rbn = l.rb, hc = l.hc, ht = hc * t;
  const int slot = warp / (rbn * l.cw), rbw = warp % rbn, cbw = (warp / rbn) % l.cw;
  const int rounds = (int)ceil_div(pr.heads, hc), steps = rounds * (it + 1);
  const int r0 = rbw * 16 + g;  // this lane's rows of the tile: r0 and r0 + 8
  const int lht = __ffs(ht) - 1;
  // X rows: copies a row (shifts where that is a power of two)
  const int vx = pr.copy_x, xpr = vx ? np * TS / vx : np;
  const int lxp = (xpr & (xpr - 1)) == 0 ? __ffs(xpr) - 1 : -1;
  auto head_copy = [&](int s) {
    const int round = s / (it + 1), j0 = (s % (it + 1)) * t, stg = s & 1;
    const int hbase = h0 + round * hc, hn = h0 + pr.heads - hbase;  // heads in this round
    // cum_j, dt_j (in fragment order) and cum_i: [kind][head slot][t]
    float* cd = cdbuf + stg * 3 * ht;
    for (int e = tid; e < 3 * ht; e += NTHREADS) {
      const int kind = e >> lht, hs = (e >> lt) & (hc - 1), r = e & (t - 1);
      const int row = (kind == 2 ? i0 : j0) + r;
      const bool in = hs < hn && row < q;
      const float* src = (kind == 1 ? dt : cum) + (c * q + row) * nh + hbase + hs;
      const int dst = (e & ~(t - 1)) + (kind == 2 ? r : frag_pos(r, F32));
      cp_async<4>(smem_u32(cd + dst), in ? static_cast<const void*>(src) : cum, in ? 4 : 0);
    }
    unsigned char* xs = ring + stg * hc * l.xhead;
    const T* xb = x + ((c * q + j0) * nh + hbase) * np;
    for (int e = tid; e < ht * xpr; e += NTHREADS) {
      const int row = lxp >= 0 ? e >> lxp : e / xpr, seg = e - row * xpr;
      const int hs = row >> lt, r = row & (t - 1);  // row: head slot * t + tile row
      const bool in = hs < hn && j0 + r < q;
      const T* src = xb + (r * nh + hs) * np;
      unsigned char* dst = xs + hs * l.xhead + r * l.xrow;
      if (vx == 0) {
        *reinterpret_cast<T*>(dst + seg * TS) = in ? src[seg] : zero_val<T>();
      } else {
        const void* from = reinterpret_cast<const unsigned char*>(src) + seg * vx;
        cp_async_v(vx, smem_u32(dst + seg * vx), in ? from : x, in);
      }
    }
  };

  float acc[WNT][4];
#pragma unroll
  for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  // one step's products for this warp: part = W X over the j-tile's k-steps
  // below kend; MASK in the diagonal tile
  auto products = [&](auto mask, const float* cdj, const float* g0, float ci0, float ci1,
                      const unsigned char* xs, int kend, float(&part)[WNT][4]) {
    constexpr bool MASK = decltype(mask)::value;
#pragma unroll
    for (int kk = 0; kk < 64 / KS; ++kk) {
      const int k0 = kk * KS;
      if (k0 >= kend) break;
      if constexpr (!F32) {
        unsigned ahi[4] = {}, alo[4] = {};
        // W build: rows r0, r0 + 8; columns k0 + 2 tq + {0, 1, 8, 9}
        {
          const float4 cj = *reinterpret_cast<const float4*>(cdj + k0 + 4 * tq);
          const float4 dj = *reinterpret_cast<const float4*>(cdj + ht + k0 + 4 * tq);
          const float4 ga = *reinterpret_cast<const float4*>(g0 + k0 + 4 * tq);
          const float4 gb = *reinterpret_cast<const float4*>(g0 + 8 * ldg + k0 + 4 * tq);
          const int jl = k0 + 2 * tq;
          split_bf16(weight<MASK>(jl, r0, ga.x, ci0, cj.x, dj.x),
                     weight<MASK>(jl + 1, r0, ga.y, ci0, cj.y, dj.y), ahi[0], alo[0]);
          split_bf16(weight<MASK>(jl, r0 + 8, gb.x, ci1, cj.x, dj.x),
                     weight<MASK>(jl + 1, r0 + 8, gb.y, ci1, cj.y, dj.y), ahi[1], alo[1]);
          split_bf16(weight<MASK>(jl + 8, r0, ga.z, ci0, cj.z, dj.z),
                     weight<MASK>(jl + 9, r0, ga.w, ci0, cj.w, dj.w), ahi[2], alo[2]);
          split_bf16(weight<MASK>(jl + 8, r0 + 8, gb.z, ci1, cj.z, dj.z),
                     weight<MASK>(jl + 9, r0 + 8, gb.w, ci1, cj.w, dj.w), ahi[3], alo[3]);
        }
        // MMA: lo X, then hi X, for this warp's 64 columns of P
        {
#pragma unroll
          for (int nt = 0; nt < WNT; nt += 2) {
            if (cbw * 64 + nt * 8 >= np) break;
            unsigned b[4];
            ldmatrix_x4_trans(smem_u32(xs + (k0 + (lane & 15)) * l.xrow +
                                       (cbw * 64 + nt * 8 + (lane >> 4) * 8) * 2),
                              b);
            mma_bf16(part[nt], alo, b[0], b[1]);
            mma_bf16(part[nt], ahi, b[0], b[1]);
            mma_bf16(part[nt + 1], alo, b[2], b[3]);
            mma_bf16(part[nt + 1], ahi, b[2], b[3]);
          }
        }
      } else {
        unsigned ah[4] = {}, al[4] = {};
        // W build: rows r0, r0 + 8; columns k0 + tq, k0 + tq + 4
        {
          const float2 cj = *reinterpret_cast<const float2*>(cdj + k0 + 2 * tq);
          const float2 dj = *reinterpret_cast<const float2*>(cdj + ht + k0 + 2 * tq);
          const float2 ga = *reinterpret_cast<const float2*>(g0 + k0 + 2 * tq);
          const float2 gb = *reinterpret_cast<const float2*>(g0 + 8 * ldg + k0 + 2 * tq);
          const int jl = k0 + tq;
          split_tf32(weight<MASK>(jl, r0, ga.x, ci0, cj.x, dj.x), ah[0], al[0]);
          split_tf32(weight<MASK>(jl, r0 + 8, gb.x, ci1, cj.x, dj.x), ah[1], al[1]);
          split_tf32(weight<MASK>(jl + 4, r0, ga.y, ci0, cj.y, dj.y), ah[2], al[2]);
          split_tf32(weight<MASK>(jl + 4, r0 + 8, gb.y, ci1, cj.y, dj.y), ah[3], al[3]);
        }
        // MMA: 3xTF32, the small terms first
        {
          const float* xf = reinterpret_cast<const float*>(xs);
          const int ldx = l.xrow / 4;
#pragma unroll
          for (int nt = 0; nt < WNT; ++nt) {
            if (cbw * 64 + nt * 8 >= np) break;
            // B(k, n) = X[j = k0 + tq (+4)][p = 64 cbw + 8 nt + g]
            const float* b = xf + (k0 + tq) * ldx + cbw * 64 + nt * 8 + g;
            unsigned bh0, bl0, bh1, bl1;
            split_tf32(b[0], bh0, bl0);
            split_tf32(b[4 * ldx], bh1, bl1);
            mma_tf32(part[nt], al, bh0, bh1);
            mma_tf32(part[nt], ah, bl0, bl1);
            mma_tf32(part[nt], ah, bh0, bh1);
          }
        }
      }
    }
  };

  head_copy(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait(0);
    __syncthreads();  // step s's tiles are in; step s - 1's stage is consumed
    // ring copies: step s + 1's X tiles, cum and dt
    {
      if (s + 1 < steps) head_copy(s + 1);
    }
    cp_async_commit();
    const int round = s / (it + 1), jt = s - round * (it + 1), j0 = jt * t;
    const int head = h0 + round * hc + slot;
    if (slot >= hc || head >= h0 + pr.heads) continue;  // an idle warp this round
    const float* cdj = cdbuf + (s & 1) * 3 * ht + slot * t;  // cum_j; dt_j at + ht
    const float ci0 = cdj[2 * ht + r0], ci1 = cdj[2 * ht + r0 + 8];
    const float* g0 = gs + r0 * ldg + j0;
    const unsigned char* xs = ring + (s & 1) * hc * l.xhead + slot * l.xhead;
    float part[WNT][4];
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
    if (jt == it) {  // the diagonal tile: the k-steps at or left of this warp's last row
      products(std::true_type(), cdj, g0, ci0, ci1, xs, rbw * 16 + 16, part);
    } else {
      products(std::false_type(), cdj, g0, ci0, ci1, xs, t, part);
    }
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
    if (jt != it) continue;
    // stores: after the round's last (diagonal) tile, the sums once, in X's
    // dtype, each warp store covering whole 32-byte sectors of 8 rows: for
    // bf16 with P % 8 == 0 each quad transposes its 4 x 4 (column pair,
    // n-tile) words so that a lane stores 8 columns of one n-tile (a quad 64
    // bytes of a row); for fp32 with P even a quad's column pairs are 32
    // bytes of a row already.
    {
      const int gi0 = i0 + r0;
      if (!F32 && np % 8 == 0) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          T* row = out + ((c * q + gi0 + 8 * hr) * nh + head) * np + cbw * 64;
          const bool rin = gi0 + 8 * hr < q;
#pragma unroll
          for (int u = 0; u < WNT / 4; ++u) {
            unsigned a[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              a[k] = pack_bf16(acc[4 * u + k][2 * hr], acc[4 * u + k][2 * hr + 1]);
            quad_transpose(a, tq);
            const int nt = 4 * u + tq;  // the n-tile this lane stores
            if (rin && cbw * 64 + nt * 8 < np)
              store_result(row + nt * 8, make_uint4(a[0], a[1], a[2], a[3]));
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt) {
          const int col = cbw * 64 + nt * 8 + 2 * tq;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int gi = gi0 + 8 * hr;
            if (gi < q && col < np) {
              T* o = out + ((c * q + gi) * nh + head) * np + col;
              if (F32 && np % 2 == 0) {
                store_result(o, make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]));
              } else {
                store_as(o, acc[nt][2 * hr]);
                if (col + 1 < np) store_as(o + 1, acc[nt][2 * hr + 1]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  cp_async_wait(0);
}

// The kernel's launch grid: one CTA a (row tile, batch-chunk, block of heads),
// a 1-D grid (blockIdx.x: the row tile from the last, then the chunk, then the
// head block, fastest).
static inline void ssd_grid(long long bcn, int q, int h, int heads, int tile, long long* dims) {
  dims[0] = bcn * (h / heads) * ceil_div(q, tile);
  dims[1] = dims[2] = 1;
}

template <typename T>
static int launch(const SsdProblem& p, const void* cc, const void* bc, const void* cum,
                  const void* dt, const void* x, void* out, cudaStream_t s) {
  const long long smem = make_ssd_layout(p.q, p.p, p.tile, (int)sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long dims[3];
  ssd_grid(p.bcn, p.q, p.h, p.heads, p.tile, dims);
  ssd_intra_kernel<T><<<grid_dim3(dims), NTHREADS, smem, s>>>(
      p, reinterpret_cast<const float*>(cc), reinterpret_cast<const float*>(bc),
      reinterpret_cast<const float*>(cum), reinterpret_cast<const float*>(dt),
      reinterpret_cast<const T*>(x), reinterpret_cast<T*>(out));
  return (int)cudaGetLastError();
}

extern "C" {

// Bytes of dynamic shared memory the kernel takes at this chunk length,
// head dimension, tile and X itemsize (4 fp32, 2 bf16); -1 for a tile or
// P it does not take.
long long repro_ssd_intra_smem_bytes(int q, int p, int tile, int itemsize) {
  if (q < 1 || !valid_ssd_plan(p, tile) || (itemsize != 2 && itemsize != 4)) return -1;
  return make_ssd_layout(q, p, tile, itemsize).total;
}

// The launch grid repro_ssd_intra takes for BC chunks of q rows and H heads,
// heads a CTA and rows a tile, into dims (x, y, z). Returns a cudaError_t.
int repro_ssd_intra_grid(long long bcn, int q, int h, int heads, int tile, long long* dims) {
  if (bcn < 1 || q < 1 || h < 1 || heads < 1 || h % heads != 0 ||
      (tile != 16 && tile != 32 && tile != 64))
    return (int)cudaErrorInvalidValue;
  ssd_grid(bcn, q, h, heads, tile, dims);
  return 0;
}

// One launch. dtype (of x and out): 0 float32, 1 bfloat16; cc, bc
// (BC, q, N), cum, dt (BC, q, H) float32; x, out (BC, q, H, P); all
// contiguous. heads divides H; tile is 16, 32 or 64 with
// (tile / 16) ceil(P / 64) <= 8 and P <= 256. copy_cb: bytes a cp.async of
// C's and B's rows takes (16, 8 or 4), copy_x of X's rows (16, 8, 4, or 0
// for element loads), which the caller has checked against N, P and the
// pointers. Returns a cudaError_t.
int repro_ssd_intra(int dtype, long long bcn, int q, int n, int h, int p, int heads, int tile,
                    int copy_cb, int copy_x, const void* cc, const void* bc, const void* cum,
                    const void* dt, const void* x, void* out, void* stream) {
  if (bcn < 1 || q < 1 || n < 1 || h < 1 || heads < 1 || h % heads != 0 ||
      !valid_ssd_plan(p, tile) || (dtype != 0 && dtype != 1) ||
      (copy_cb != 16 && copy_cb != 8 && copy_cb != 4) || !valid_copy(copy_x) ||
      bcn * (h / heads) * ceil_div(q, tile) >= (1LL << 31) ||
      (long long)tile * h * p >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const SsdProblem pr{bcn, q, n, h, p, heads, tile, copy_cb, copy_x};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(pr, cc, bc, cum, dt, x, out, s)
                    : launch<__nv_bfloat16>(pr, cc, bc, cum, dt, x, out, s);
}

}  // extern "C"

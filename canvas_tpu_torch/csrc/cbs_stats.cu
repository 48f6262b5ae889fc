// The CBS level's statistics for Hopper: kernels K9, K10 and K11.
//
// canvas_tpu runs a CBS level's statistics as one device program; around
// its arc-scan kernel (B4 here, csrc/arc_scan.cu) that program is XLA work,
// which these kernels replace:
//
//   K9  (arc_inputs_kernel) B4's inputs: _tmax_batch_pallas's extrema,
//       seed and lag_hi (canvas_tpu/ops/cbs_device.py:382-402) and
//       _block_d2_bound (:329-371).  Per row b of the cumsum cs f32
//       [B, npad] with n[b] real positions: the first-index argmin and
//       argmax of cs[0, n), psdiff = cs[imax] - cs[imin], the extrema
//       seed n / (r (n - r)) psdiff^2 with r = max(|imax - imin|, 1),
//       lag_hi = min(n - al0, n - 1), the seed's split (ti0, tj0) and, per
//       512-lag block k, psd2[b, k] = min(psdiff, bound_k)^2, where
//       bound_k is the largest M[c] - m[a] over the 256-position chunks
//       a, c at the chunk distances block k reaches (M, m: a chunk's max
//       and min over all its positions).  One block a row.
//   K10 (refine_kernel) the refine lax.fori_loop and the t^2 formula
//       (:408-454).  Per row whose B4 sub-block bl0 is not -1: over the
//       positions i and the lags bl0 + k, k < 32, with the lag in [al0,
//       lag_hi] and i + lag <= n - 1, the term (w d) d, d = cs[i + lag] -
//       cs[i], w = n / (lag (n - lag)); each position keeps its smallest k
//       among equal terms, and the row the first position among equal
//       maxima: ti = i + 1, tj = i + lag + 1.  A row with bl0 = -1 keeps
//       (ti0, tj0).  Every row: t2 = best / ((tssv - best) / max(n - 2, 1))
//       with tssv = best + 1 where tss <= best + 1e-4, else tss.  One
//       block a row.
//   K11 (tail_kernel) _tail_p_batch_dev with _nu_dev (:461-510): the OU
//       tail probability of b at n bins, in float64, over a grid of
//       n_grid = 100 points; at each point nu(x) takes 8,192 series terms
//       and a 129-point Simpson tail.  A cluster of 8 blocks a row and a
//       warp a grid point; the cluster's first warp sums the grid points'
//       terms from the blocks' shared memory.
//
// What bounds them on the H100.  K9 reads cs once: bytes (3.35 TB/s); its
// chunk pairs are nchunk^2 <= 65,536 a row.  K10 evaluates 32 lags at each
// position of the rows with a sub-block: about 5 f32 operations a pair,
// operations.  K11 is float64 operations: 819,200 erfc calls and 12,900 more
// a row, at the card's float64 rate, half a warp's issue a clock an SM.
//
// Exactness.  Each kernel repeats its plain version (ops/cbs_stats_cuda.py)
// operation for operation with correctly rounded intrinsics (__fadd_rn,
// __fmul_rn, __fdiv_rn and their float64 forms), so nothing is contracted
// into a fused multiply-add; maxima, minima and first indices do not depend
// on their order.  K11's sums are the plain version's adjacent-pair trees:
// each 2,048-term chunk of the series (a lane's 64 consecutive terms, then
// the lanes pairwise by shuffles), the chunks added in order, the Simpson
// points padded to 256 and the grid points padded to 128 the same way.  Its
// erfc, exp, log and sqrt are the CUDA math library's, which torch's CUDA
// operators also call.  So K9 and K10 equal their plain versions bit for
// bit on any device, and K11 on the card.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef long long i64;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRowThreads = 256;      // K9: threads a row
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRefineThreads = 512;   // K10: threads a row
constexpr int kRefineWarps = kRefineThreads / 32;
constexpr int kBChunk = 256;          // positions a chunk of the d^2 bound
constexpr int kPBlk = 512;            // lags a pruning block (B4's blk)
constexpr int kPTbl = 32;             // lags a sub-block (B4's sub)

// K11
constexpr int kTailWarps = 16;        // warps a block, a grid point each
constexpr int kTailCluster = 8;       // blocks a row: 128 grid points
constexpr int kMaxGrid = kTailWarps * kTailCluster;
constexpr int kSeriesChunks = 4;      // 4 x 2,048 = 8,192 series terms
constexpr int kSeriesChunk = 2048;
constexpr int kLaneTerms = kSeriesChunk / 32;   // 64, a lane's run
constexpr int kPanels = 128;          // Simpson panels: 129 points
constexpr int kSimpsonSlots = 256;    // the points' tree, zero-padded
constexpr int kLanePoints = kSimpsonSlots / 32; // 8
constexpr double kSqrt2 = 1.4142135623730951;      // np.sqrt(2.0)
constexpr double kSqrtTail = 90.51243008559653;    // np.sqrt(8192 + 0.5)
constexpr double kLog2 = 0.6931471805599453;       // np.log(2.0)
constexpr double kTailHi = 9.0;
constexpr double kTailConst = 2.0 * 9.973557e-2;   // as Python folds it

__device__ __forceinline__ i64 row_n(const void* n, int n64, int b) {
  return n64 ? static_cast<const i64*>(n)[b]
             : i64(static_cast<const int32_t*>(n)[b]);
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

// (value, index) with the smaller value (with `larger`, the larger one),
// the smaller index among equal values.
__device__ __forceinline__ void arg_merge(float& v, int& i, float v2, int i2,
                                          bool larger) {
  const bool take = larger ? (v2 > v || (v2 == v && i2 < i))
                           : (v2 < v || (v2 == v && i2 < i));
  if (take) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kRowThreads) arc_inputs_kernel(
    const float* __restrict__ cs, const void* n, int n64, int npad, int al0,
    float* seed, int32_t* lag_hi, int32_t* ti0, int32_t* tj0, int32_t* n32,
    float* psd2) {
  __shared__ float s_v[2][kRowWarps];
  __shared__ int s_i[2][kRowWarps];
  __shared__ float s_M[kBChunk], s_m[kBChunk], s_db[kBChunk];
  __shared__ float s_psdiff;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* row = cs + size_t(b) * npad;
  const i64 nb = row_n(n, n64, b);
  const int nv = nb < 0 ? 0 : (nb > npad ? npad : int(nb));

  // first-index argmin and argmax over the real positions (an index of
  // INT_MAX marks "none yet"; no real position leaves both at index 0)
  float vmin = INFINITY, vmax = -INFINITY;
  int imin = INT_MAX, imax = INT_MAX;
  for (int i = t; i < nv; i += kRowThreads) {
    const float v = row[i];
    if (v < vmin) { vmin = v; imin = i; }
    if (v > vmax) { vmax = v; imax = i; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    arg_merge(vmin, imin, __shfl_xor_sync(kFull, vmin, o),
              __shfl_xor_sync(kFull, imin, o), false);
    arg_merge(vmax, imax, __shfl_xor_sync(kFull, vmax, o),
              __shfl_xor_sync(kFull, imax, o), true);
  }
  if (lane == 0) {
    s_v[0][warp] = vmin; s_i[0][warp] = imin;
    s_v[1][warp] = vmax; s_i[1][warp] = imax;
  }
  // the chunks' maxima and minima over all their positions, a warp a chunk
  const int C = npad < kBChunk ? npad : kBChunk;
  const int nchunk = npad / C;
  for (int c = warp; c < nchunk; c += kRowWarps) {
    float M = -INFINITY, m = INFINITY;
    for (int j = lane; j < C; j += 32) {
      const float v = row[c * C + j];
      M = fmaxf(M, v);
      m = fminf(m, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
      m = fminf(m, __shfl_xor_sync(kFull, m, o));
    }
    if (lane == 0) {
      s_M[c] = M;
      s_m[c] = m;
    }
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kRowWarps; ++w) {
      arg_merge(vmin, imin, s_v[0][w], s_i[0][w], false);
      arg_merge(vmax, imax, s_v[1][w], s_i[1][w], true);
    }
    // no real position: torch's argmin and argmax of the row give 0
    if (imin == INT_MAX) imin = 0;
    if (imax == INT_MAX) imax = 0;
    const float cmin = row[imin], cmax = row[imax];
    const float psdiff = __fsub_rn(cmax, cmin);
    const float nf = __ll2float_rn(nb);
    const int dj = imax > imin ? imax - imin : imin - imax;
    const float rjs = __int2float_rn(dj > 1 ? dj : 1);
    seed[b] = psdiff > 0.0f
        ? __fmul_rn(__fmul_rn(__fdiv_rn(nf, __fmul_rn(rjs, __fsub_rn(nf, rjs))),
                              psdiff),
                    psdiff)
        : 0.0f;
    const i64 lh = nb - al0 < nb - 1 ? nb - al0 : nb - 1;
    lag_hi[b] = int32_t(lh);
    ti0[b] = int32_t((imin < imax ? imin : imax) + 1);
    tj0[b] = int32_t((imin > imax ? imin : imax) + 1);
    n32[b] = int32_t(nb);
    s_psdiff = psdiff;
  }
  // the largest M[c] - m[a] at each chunk distance db = |c - a|
  for (int db = t; db < nchunk; db += kRowThreads) {
    float best = -INFINITY;
    for (int a = 0; a + db < nchunk; ++a) {
      best = fmaxf(best, __fsub_rn(s_M[a + db], s_m[a]));
      best = fmaxf(best, __fsub_rn(s_M[a], s_m[a + db]));
    }
    s_db[db] = best;
  }
  __syncthreads();
  // each lag block: the largest over the chunk distances it reaches
  const int blk = npad < kPBlk ? npad : kPBlk;
  const int nblk = npad / blk;
  for (int k = t; k < nblk; k += kRowThreads) {
    const int lo = (k * blk) / C - 1, hi = (k * blk + blk - 1) / C + 1;
    const int db_lo = lo > 0 ? lo : 0;
    const int db_hi = hi < nchunk - 1 ? hi : nchunk - 1;
    float bnd = -INFINITY;
    for (int db = db_lo; db <= db_hi; ++db) bnd = fmaxf(bnd, s_db[db]);
    const float d = fminf(s_psdiff, bnd);
    psd2[size_t(b) * nblk + k] = __fmul_rn(d, d);
  }
}

// ---------------------------------------------------------------------------
// K10
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRefineThreads) refine_kernel(
    const float* __restrict__ cs, const void* n, int n64,
    const float* tss, const int32_t* lag_hi, const float* best_in,
    const int32_t* bl0, const int32_t* ti0, const int32_t* tj0, int npad,
    int al0, float* t2, int32_t* ti, int32_t* tj) {
  __shared__ float s_w[kPTbl];
  __shared__ float s_v[kRefineWarps];
  __shared__ int s_i[kRefineWarps], s_k[kRefineWarps];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* row = cs + size_t(b) * npad;
  const i64 nb = row_n(n, n64, b);
  const float nf = __ll2float_rn(nb);
  const float best = best_in[b];
  if (t == 0) {
    const float tb = tss[b];
    const float tssv = tb <= __fadd_rn(best, 1e-4f) ? __fadd_rn(best, 1.0f)
                                                    : tb;
    t2[b] = __fdiv_rn(best, __fdiv_rn(__fsub_rn(tssv, best),
                                      fmaxf(__fsub_rn(nf, 2.0f), 1.0f)));
  }
  const int b0 = bl0[b];
  if (b0 < 0) {                    // the seed was never beaten
    if (t == 0) {
      ti[b] = ti0[b];
      tj[b] = tj0[b];
    }
    return;
  }
  const int blk = npad < kPBlk ? npad : kPBlk;
  const int sub = blk < kPTbl ? blk : kPTbl;
  const i64 lh = lag_hi[b];
  if (t < sub) {
    const int lag = b0 + t;
    const float lf = __int2float_rn(lag > 1 ? lag : 1);
    s_w[t] = __fdiv_rn(nf, __fmul_rn(lf, __fsub_rn(nf, lf)));
  }
  __syncthreads();
  const int nv = nb < 0 ? 0 : (nb > npad ? npad : int(nb));
  // a position's (term, k) keeps the smallest k among equal terms; the
  // row's candidate starts as position 0's empty pair, (-1, 0, 0)
  float cv = -1.0f;
  int ci = t == 0 ? 0 : INT_MAX, ck = 0;
  for (int i = t; i < nv; i += kRefineThreads) {
    const float c = row[i];
    float val = -1.0f;
    int lk = 0;
    for (int k = 0; k < sub; ++k) {
      const int lag = b0 + k;
      if (lag >= al0 && lag <= lh && i64(i) + lag <= nb - 1) {
        const float d = __fsub_rn(row[i + lag], c);
        const float v = __fmul_rn(__fmul_rn(s_w[k], d), d);
        if (v > val) {
          val = v;
          lk = k;
        }
      }
    }
    if (val > cv) {                // ascending i: the first position wins
      cv = val;
      ci = i;
      ck = lk;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, cv, o);
    const int i2 = __shfl_xor_sync(kFull, ci, o);
    const int k2 = __shfl_xor_sync(kFull, ck, o);
    if (v2 > cv || (v2 == cv && i2 < ci)) {
      cv = v2;
      ci = i2;
      ck = k2;
    }
  }
  if (lane == 0) {
    s_v[warp] = cv;
    s_i[warp] = ci;
    s_k[warp] = ck;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kRefineWarps; ++w)
      if (s_v[w] > cv || (s_v[w] == cv && s_i[w] < ci)) {
        cv = s_v[w];
        ci = s_i[w];
        ck = s_k[w];
      }
    ti[b] = int32_t(ci + 1);
    tj[b] = int32_t(i64(ci) + b0 + ck + 1);
  }
}

// ---------------------------------------------------------------------------
// K11
// ---------------------------------------------------------------------------

// The adjacent-pair tree over the 32 lanes' values (lane l holding the sum
// of slots [l s, l s + s)): pairs of lanes, then pairs of pairs, ...; every
// lane ends with the whole sum.
__device__ __forceinline__ double lanes_tree(double v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The adjacent-pair tree over 8 consecutive slots.
__device__ __forceinline__ double tree8(const double* v) {
  return __dadd_rn(__dadd_rn(__dadd_rn(v[0], v[1]), __dadd_rn(v[2], v[3])),
                   __dadd_rn(__dadd_rn(v[4], v[5]), __dadd_rn(v[6], v[7])));
}

// Series term k of nu(x): ndtr(-x sqrt(k) / 2) (2 / k), as _nu_dev rounds.
__device__ __forceinline__ double series_term(double x, int k) {
  const double kd = double(k);
  const double z = __ddiv_rn(__ddiv_rn(__dmul_rn(x, sqrt(kd)), 2.0), kSqrt2);
  return __dmul_rn(__dmul_rn(erfc(z), 0.5), __ddiv_rn(2.0, kd));
}

// nu(x) of TailProbability.Nu as _nu_dev evaluates it, by one warp (every
// lane's value).
__device__ double nu_of(double x) {
  const int lane = threadIdx.x & 31;
  if (x <= 0.01) return exp(__dmul_rn(-0.583, x));
  double series = 0.0;
  for (int c = 0; c < kSeriesChunks; ++c) {
    // the lane's run of 64 terms as 8 groups of 8; the groups' tree by a
    // stack of partial sums (level q of it: 8 << q slots)
    const int k0 = c * kSeriesChunk + lane * kLaneTerms + 1;
    double stk[4];
    for (int q = 0; q < kLaneTerms / 8; ++q) {
      double t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = series_term(x, k0 + 8 * q + j);
      double v = tree8(t);
      int lvl = 0;
      while ((q >> lvl) & 1) {
        v = __dadd_rn(stk[lvl], v);
        ++lvl;
      }
      stk[lvl] = v;
    }
    const double s = lanes_tree(stk[3]);
    series = c == 0 ? s : __dadd_rn(series, s);
  }
  // the Simpson tail over [v0c, 9]: 129 points, weights 1, 4, 2, ..., 4, 1,
  // zero-padded to 256 slots, the lane's 8 consecutive ones
  const double v0c = fmin(__ddiv_rn(__dmul_rn(x, kSqrtTail), 2.0), kTailHi);
  const double h = __ddiv_rn(__dsub_rn(kTailHi, v0c), double(kPanels));
  double f[kLanePoints];
#pragma unroll
  for (int q = 0; q < kLanePoints; ++q) {
    const int j = lane * kLanePoints + q;
    f[q] = 0.0;
    if (j <= kPanels) {
      const double u = __dadd_rn(v0c, __dmul_rn(h, double(j)));
      const double fu = __ddiv_rn(__dmul_rn(0.5, erfc(__ddiv_rn(u, kSqrt2))),
                                  fmax(u, 1e-12));
      const double wgt = (j == 0 || j == kPanels) ? 1.0
                                                  : ((j & 1) ? 4.0 : 2.0);
      f[q] = __dmul_rn(fu, wgt);
    }
  }
  const double simpson = lanes_tree(tree8(f));
  const double tail = __dmul_rn(__dmul_rn(4.0, __ddiv_rn(h, 3.0)), simpson);
  const double lnu = __dsub_rn(
      __dsub_rn(__dsub_rn(kLog2, __dmul_rn(2.0, log(fmax(x, 1e-12)))), series),
      tail);
  return exp(lnu);
}

// f(y) of _integral_inv_t1t_sq_dev.
__device__ __forceinline__ double integral_f(double y) {
  const double y2 = __dmul_rn(2.0, y);
  const double a = __ddiv_rn(__dmul_rn(8.0, y),
                             __dsub_rn(1.0, __dmul_rn(__dmul_rn(4.0, y), y)));
  const double l = log(__ddiv_rn(__dadd_rn(1.0, y2), __dsub_rn(1.0, y2)));
  return __dadd_rn(a, __dmul_rn(2.0, l));
}

__global__ void __cluster_dims__(kTailCluster, 1, 1)
    __launch_bounds__(kTailWarps * 32) tail_kernel(
        const double* b_in, const void* n, int n64, int kmax, int n_grid,
        double* p) {
  __shared__ double s_term[kTailWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int row = blockIdx.x / kTailCluster;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = rank * kTailWarps + warp;       // this warp's grid point
  const double b = b_in[row];
  const double nf = double(row_n(n, n64, row));
  double term = 0.0;
  if (g < n_grid) {
    const double delta = fmin(fmax(__ddiv_rn(double(kmax) + 1.0, nf), 0.0),
                              0.45);
    const double dincr = __ddiv_rn(__dsub_rn(0.5, delta), double(n_grid));
    const double gi = double(g);
    const double tl = __dadd_rn(0.5, __dmul_rn(gi, dincr));
    const double ts = __dadd_rn(0.5, __dmul_rn(__dadd_rn(gi, 0.5), dincr));
    const double x = __ddiv_rn(__ddiv_rn(b, sqrt(nf)),
                               sqrt(__dmul_rn(ts, __dsub_rn(1.0, ts))));
    const double nu = nu_of(x);
    const double integ =
        __dsub_rn(integral_f(__dsub_rn(__dadd_rn(tl, dincr), 0.5)),
                  integral_f(__dsub_rn(tl, 0.5)));
    term = __dmul_rn(__dmul_rn(nu, nu), integ);
  }
  if (lane == 0) s_term[warp] = term;
  cluster.sync();
  if (rank == 0 && warp == 0) {
    // lane l sums grid slots [4 l, 4 l + 4), read from their blocks
    double e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int slot = 4 * lane + q;
      e[q] = *cluster.map_shared_rank(s_term + slot % kTailWarps,
                                      slot / kTailWarps);
    }
    const double out = lanes_tree(__dadd_rn(__dadd_rn(e[0], e[1]),
                                            __dadd_rn(e[2], e[3])));
    if (lane == 0) {
      const double bcube = __dmul_rn(__dmul_rn(b, b), b);
      const double ex = exp(__ddiv_rn(__dmul_rn(-b, b), 2.0));
      p[row] = __dmul_rn(__dmul_rn(__dmul_rn(kTailConst, bcube), ex), out);
    }
  }
  cluster.sync();      // every block's s_term lives until rank 0 has read it
}

// The math library's erfc on its own, for tests and for counting one
// call's instructions in the SASS.
__global__ void erfc_kernel(const double* x, double* out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = erfc(x[i]);
}

}  // namespace

// K9.  cs: f32 [B, npad]; n: int64 (n64 = 1) or int32 [B]; outputs seed
// f32, lag_hi, ti0, tj0 and n32 (n as int32) [B], psd2 f32 [B, nblk].
extern "C" int cbs_arc_inputs(const void* cs, const void* n, int n64,
                              void* seed, void* lag_hi, void* ti0, void* tj0,
                              void* n32, void* psd2, int B, int npad, int al0,
                              void* stream) {
  if (B <= 0) return 0;
  arc_inputs_kernel<<<unsigned(B), kRowThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cs), n, n64, npad, al0,
      static_cast<float*>(seed), static_cast<int32_t*>(lag_hi),
      static_cast<int32_t*>(ti0), static_cast<int32_t*>(tj0),
      static_cast<int32_t*>(n32), static_cast<float*>(psd2));
  return static_cast<int>(cudaGetLastError());
}

// K10.  cs f32 [B, npad], n int64 or int32, tss f32, lag_hi int32, best
// f32, bl0, ti0, tj0 int32 [B]; outputs t2 f32, ti and tj int32 [B].
extern "C" int cbs_refine(const void* cs, const void* n, int n64,
                          const void* tss, const void* lag_hi,
                          const void* best, const void* bl0, const void* ti0,
                          const void* tj0, void* t2, void* ti, void* tj,
                          int B, int npad, int al0, void* stream) {
  if (B <= 0) return 0;
  refine_kernel<<<unsigned(B), kRefineThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cs), n, n64, static_cast<const float*>(tss),
      static_cast<const int32_t*>(lag_hi), static_cast<const float*>(best),
      static_cast<const int32_t*>(bl0), static_cast<const int32_t*>(ti0),
      static_cast<const int32_t*>(tj0), npad, al0, static_cast<float*>(t2),
      static_cast<int32_t*>(ti), static_cast<int32_t*>(tj));
  return static_cast<int>(cudaGetLastError());
}

// K11.  b float64 [R], n int64 or int32 [R]; output p float64 [R];
// n_grid <= 128.
extern "C" int cbs_tail_p(const void* b, const void* n, int n64, void* p,
                          int R, int kmax, int n_grid, void* stream) {
  if (R <= 0) return 0;
  if (n_grid < 1 || n_grid > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  tail_kernel<<<unsigned(R) * kTailCluster, kTailWarps * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(b), n, n64, kmax, n_grid,
      static_cast<double*>(p));
  return static_cast<int>(cudaGetLastError());
}

// erfc of x float64 [count] into out, as K11 calls it.
extern "C" int cbs_erfc(const void* x, void* out, int count, void* stream) {
  if (count <= 0) return 0;
  erfc_kernel<<<(count + 255) / 256, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

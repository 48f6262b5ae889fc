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
//       and min over all its positions).  A block a tile of 8,192
//       positions of a row, read once with 16-byte loads issued
//       together (a row of 32,768 is 4 blocks); the row's last tile to
//       finish merges the tiles' extrema, a lane a tile, and computes the
//       rest.
//   K10 (refine_kernel) the refine lax.fori_loop and the t^2 formula
//       (:408-454).  Per row whose B4 sub-block bl0 is not -1: over the
//       positions i and the lags bl0 + k, k < 32, with the lag in [al0,
//       lag_hi] and i + lag <= n - 1, the term (w d) d, d = cs[i + lag] -
//       cs[i], w = n / (lag (n - lag)); each position keeps its smallest k
//       among equal terms, and the row the first position among equal
//       maxima: ti = i + 1, tj = i + lag + 1.  A row with bl0 = -1 keeps
//       (ti0, tj0).  Every row: t2 = best / ((tssv - best) / max(n - 2, 1))
//       with tssv = best + 1 where tss <= best + 1e-4, else tss.  A block a
//       tile of 512 positions of a row, its lag window staged in shared
//       memory; the row's winner is the largest (term, -i, -k) key, taken
//       by a 64-bit atomicMax, and the row's last tile to finish writes it.
//   K11 (tail_kernel) _tail_p_batch_dev with _nu_dev (:461-510): the OU
//       tail probability of b at n bins, in float64, over a grid of
//       n_grid = 100 points; at each point nu(x) takes 8,192 series terms
//       and a 129-point Simpson tail.  One cooperative launch of resident
//       blocks: the grid points' x and a list of the live ones (x > 0.01),
//       then a block an item, 2,048 series terms of a live point and a
//       quarter of its Simpson points, each block taking the next item as
//       it comes free, then a block a row for nu, the terms and their sum;
//       grid barriers between.  sqrt(k) and 2 / k come from a table made
//       once a device.
//
// What bounds them on the H100.  K9 reads cs once: bytes (3.35 TB/s); its
// chunk pairs are nchunk^2 <= 65,536 a row, in the row's last block a
// thread two chunk distances of nchunk + 1 pairs together.  Under 4 MB a
// level, a launch's own latency is its floor, so its tiles spread a wide
// row over the SMs rather than over one.  K10 evaluates 32 lags at each
// position of the rows with a sub-block: about 5 f32 operations a pair,
// operations, so few on a level (1.7e6) that a launch's latency is the
// floor.  K11 is float64 operations: 819,200 erfc calls and 12,900 more a
// row with live grid points, at the card's float64 rate, half a warp's
// issue a clock an SM.  Three rows of 32 are live on a typical level, so
// K11 spreads the live grid points' items over every SM, and K10 a row's
// positions over its tiles; both are sized from the shapes alone, with no
// read from the card.  K11's list keeps dead grid points (no series) from
// taking any warp's time; K10's tiles past a row's end, or of a row
// without a sub-block, exit at once.
//
// Exactness.  Each kernel repeats its plain version (ops/cbs_stats_cuda.py)
// operation for operation with correctly rounded intrinsics (__fadd_rn,
// __fmul_rn, __fdiv_rn and their float64 forms), so nothing is contracted
// into a fused multiply-add; maxima, minima and first indices do not depend
// on their order.  K11's sums are the plain version's adjacent-pair trees:
// each 2,048-term chunk of the series (a lane's 8 consecutive terms, the
// lanes pairwise by shuffles, then 8 such units of 256), the chunks added
// in order, the Simpson points padded to 256 and the grid points padded to
// 128 the same way.  An adjacent-pair tree is the pairwise sum of its
// trees over aligned power-of-two sub-ranges, so splitting it over warps
// changes no bit, and neither does the order in which points join the
// list or blocks take items.  Its table holds __dsqrt_rn(k) and __ddiv_rn(2, k),
// what torch's sqrt and division give; the plain version's division by 2
// is a multiplication by 0.5 here (the same rounded value, subnormals
// too), while its division by sqrt(2) stays a division.  Its erfc, exp,
// log and sqrt are the CUDA math library's, which torch's CUDA operators
// also call.  So K9 and K10 equal their plain versions bit for bit on any
// device, and K11 on the card.
//
// For the whole-recursion engine (ops/cbs_mega.py) K9 and K10 take a tier's
// row mask and read rows of the level's [W, Tmax] cumsum at its stride,
// and K9-K11 the engine's live flag: a row outside the mask, or every row
// where live is 0, returns at once, before any barrier or counter, and
// writes nothing.  K11 is launched with the cooperative launch attribute
// (cudaLaunchKernelExC), which a CUDA graph's capture keeps.
//
// The engine's level also runs K14, its decision rules (canvas_tpu/ops/
// cbs_mega.py:398-413, which wraps the tail probability in the same XLA
// program), inside K11's launch: tail_decide_kernel is K11's body with
// each row's b = sqrt(max(t2, 0)) taken from the level's f32 t2 in phase
// 1 (grid point 0 writing it out), and in phase 3 the thread that writes
// a row's p applies the rules to it: ostat, hybrid, trivial, needs and the
// walk limit nrejc from p rounded once to f32 (C5), with the f32
// operations of cbs_level_cuda.decide_plain, correctly rounded, in its
// order.  Launches of their own around K11 would each cost a kernel
// node's latency for 60 bytes a row.  Each kernel's grid comes from its
// own occupancy (cbs_tail_grid).
//
// K9's and K10's row counters, K10's keys and K11's two counters live in
// device memory that the wrapper zeroes once a device; each launch leaves
// them zero (K9 and K10: a row's last block), so calls on one stream reuse
// them.  K9's tile extrema and chunk extrema go through scratch there
// too; a tile's first index among equal values survives the merge
// whatever order the tiles finish in.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef long long i64;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRowThreads = 256;      // K9: threads a block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kTile = 8192;           // K9: positions a block
constexpr int kGroups = kTile / (4 * kRowThreads);  // K9: loads a thread
constexpr int kRefineThreads = 256;   // K10: threads a block
constexpr int kRefineWarps = kRefineThreads / 32;
constexpr int kRefineTile = 512;      // K10: positions a block
constexpr int kPosBits = 26;          // K10's key: positions below 2^26
constexpr unsigned kPosMask = (1u << kPosBits) - 1;
constexpr int kBChunk = 256;          // positions a chunk of the d^2 bound
constexpr int kPBlk = 512;            // lags a pruning block (B4's blk)
constexpr int kPTbl = 32;             // lags a sub-block (B4's sub)

// K11
constexpr int kTailThreads = 256;     // threads a block
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kMaxGrid = 128;         // grid points a row, the grid's tree
constexpr int kSeriesChunks = 4;      // 4 x 2,048 = 8,192 series terms
constexpr int kSeriesChunk = 2048;
constexpr int kSeriesTerms = kSeriesChunks * kSeriesChunk;
constexpr int kUnit = 256;            // series terms a warp's item
constexpr int kLaneTerms = kUnit / 32;            // 8, a lane's run
constexpr int kUnits = kSeriesTerms / kUnit;      // 32 a grid point
constexpr int kChunkUnits = kSeriesChunk / kUnit; // 8 a chunk
constexpr int kPanels = 128;          // Simpson panels: 129 points in
                                      // 256 slots, zero-padded
constexpr int kSimpsonRuns = 8;       // the slots' runs of 32
constexpr int kItems = kUnits + kSimpsonRuns;  // a live point's partial sums
constexpr double kSqrt2 = 1.4142135623730951;      // np.sqrt(2.0)
constexpr double kSqrtTail = 90.51243008559653;    // np.sqrt(8192 + 0.5)
constexpr double kLog2 = 0.6931471805599453;       // np.log(2.0)
constexpr double kTailHi = 9.0;
constexpr double kTailConst = 2.0 * 9.973557e-2;   // as Python folds it

__device__ __forceinline__ i64 row_n(const void* n, int n64, int b) {
  return n64 ? static_cast<const i64*>(n)[b]
             : i64(static_cast<const int32_t*>(n)[b]);
}

// Whether row b sits this launch out: the whole-recursion engine's run has
// ended (live, when given, is 0), or the row is outside the launch's mask
// (when given).  Every block of the row returns at once, before any
// barrier or counter.
__device__ __forceinline__ bool skip_row(const i64* live, const bool* mask,
                                         int b) {
  return (live && !*live) || (mask && !mask[b]);
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

// A tile's first-index extrema over the row's real positions in it (an
// index of INT_MAX where it holds none).
struct TileExt {
  float vmin, vmax;
  int imin, imax;
};

// Block b = row * tiles + tile reads its tile of kTile positions of the
// row once, 16 bytes a load: the tile's first-index argmin and argmax over
// the real positions, and the maxima and minima of its chunks of C =
// min(256, npad) positions over all positions.  A row of one tile goes on
// from shared memory; otherwise each block writes its tile's results to
// the scratch ext [B, tiles] and chunk [B, nchunk] (M, m), and the row's
// last block to finish (an atomic counter, left zero) merges them: the
// smaller index among equal values, so the first index wins whatever
// tile ends last.  That block computes the rest with all its threads:
// the chunk-distance bounds, psd2, the seed, lag_hi, ti0, tj0 and n32.
__global__ void __launch_bounds__(kRowThreads) arc_inputs_kernel(
    const float* __restrict__ cs, const void* n, int n64, int npad, int al0,
    int tiles, int ld, const bool* mask, const i64* live, TileExt* ext,
    float2* chunk, unsigned* count, float* seed, int32_t* lag_hi,
    int32_t* ti0, int32_t* tj0, int32_t* n32, float* psd2) {
  __shared__ float s_v[2][kRowWarps];
  __shared__ int s_i[2][kRowWarps];
  __shared__ float s_M[kBChunk], s_m[kBChunk], s_db[kBChunk];
  __shared__ float s_wM[kTile / 128], s_wm[kTile / 128];
  __shared__ TileExt s_ext;
  __shared__ bool s_last;
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  if (skip_row(live, mask, b)) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* row = cs + size_t(b) * ld;
  const i64 nb = row_n(n, n64, b);
  const int nv = nb < 0 ? 0 : (nb > npad ? npad : int(nb));
  const int T = npad < kTile ? npad : kTile;
  const int i0 = tile * T;
  const int C = npad < kBChunk ? npad : kBChunk;
  const int nchunk = npad / C;

  // one pass: a thread's 4-position groups g = t, t + 256, ..., all its
  // loads issued before any is used; a warp's 32 groups (128 positions)
  // lie in one chunk when C >= 128, and a row narrower than that is one
  // chunk
  float vmin = INFINITY, vmax = -INFINITY;
  int imin = INT_MAX, imax = INT_MAX;
  const int groups = T >= 4 ? T / 4 : 1;
  float4 w[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int g = q * kRowThreads + t;
    if (T >= 4 && g < groups)
      w[q] = __ldg(reinterpret_cast<const float4*>(row + i0) + g);
    else if (g == 0)                    // a row of 1 or 2 positions
      w[q] = make_float4(row[0], T > 1 ? row[1] : row[0], row[0], row[0]);
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    if (q * kRowThreads >= groups) break;
    const int g = q * kRowThreads + t;
    float M = -INFINITY, m = INFINITY;
    if (g < groups) {
      const float v[4] = {w[q].x, w[q].y, w[q].z, w[q].w};
      const int cnt = T >= 4 ? 4 : T;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= cnt) break;
        const int i = i0 + 4 * g + j;
        if (i < nv) {
          if (v[j] < vmin) { vmin = v[j]; imin = i; }
          if (v[j] > vmax) { vmax = v[j]; imax = i; }
        }
        M = fmaxf(M, v[j]);
        m = fminf(m, v[j]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
      m = fminf(m, __shfl_xor_sync(kFull, m, o));
    }
    const int wq = q * kRowWarps + warp;   // the tile's 128-position run
    if (lane == 0 && 32 * wq < groups) {
      s_wM[wq] = M;
      s_wm[wq] = m;
    }
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
  __syncthreads();
  // the tile's chunks from its runs, and its extrema
  const int runs = (groups + 31) / 32, per = C >= 128 ? C / 128 : runs;
  const int c0 = i0 / C;
  for (int c = t; c * per < runs; c += kRowThreads) {
    float M = s_wM[c * per], m = s_wm[c * per];
    for (int q = 1; q < per; ++q) {
      M = fmaxf(M, s_wM[c * per + q]);
      m = fminf(m, s_wm[c * per + q]);
    }
    s_M[c0 + c] = M;
    s_m[c0 + c] = m;
    if (tiles > 1) chunk[size_t(b) * nchunk + c0 + c] = make_float2(M, m);
  }
  if (t == 0) {
    for (int q = 1; q < kRowWarps; ++q) {
      arg_merge(vmin, imin, s_v[0][q], s_i[0][q], false);
      arg_merge(vmax, imax, s_v[1][q], s_i[1][q], true);
    }
    s_ext = {vmin, vmax, imin, imax};
    if (tiles > 1) ext[size_t(b) * tiles + tile] = s_ext;
  }
  if (tiles > 1) {
    __threadfence();
    __syncthreads();
    if (t == 0)
      s_last = atomicAdd(count + b, 1u) == unsigned(tiles - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int c = t; c < nchunk; c += kRowThreads) {
      const float2 Mm = __ldcg(chunk + size_t(b) * nchunk + c);
      s_M[c] = Mm.x;
      s_m[c] = Mm.y;
    }
    if (warp == 0) {            // the tiles' extrema, a lane a tile
      TileExt e = {INFINITY, -INFINITY, INT_MAX, INT_MAX};
      if (lane < tiles) {
        const TileExt* src = ext + size_t(b) * tiles + lane;
        e = {__ldcg(&src->vmin), __ldcg(&src->vmax), __ldcg(&src->imin),
             __ldcg(&src->imax)};
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        arg_merge(e.vmin, e.imin, __shfl_xor_sync(kFull, e.vmin, o),
                  __shfl_xor_sync(kFull, e.imin, o), false);
        arg_merge(e.vmax, e.imax, __shfl_xor_sync(kFull, e.vmax, o),
                  __shfl_xor_sync(kFull, e.imax, o), true);
      }
      if (lane == 0) {
        s_ext = e;
        count[b] = 0;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    // the extrema's values are cs[imin] and cs[imax]; with no real
    // position, torch's argmin and argmax of the row give 0
    const bool none = s_ext.imin == INT_MAX;
    const int jmin = none ? 0 : s_ext.imin, jmax = none ? 0 : s_ext.imax;
    const float cmin = none ? row[0] : s_ext.vmin;
    const float cmax = none ? row[0] : s_ext.vmax;
    const float psdiff = __fsub_rn(cmax, cmin);
    const float nf = __ll2float_rn(nb);
    const int dj = jmax > jmin ? jmax - jmin : jmin - jmax;
    const float rjs = __int2float_rn(dj > 1 ? dj : 1);
    seed[b] = psdiff > 0.0f
        ? __fmul_rn(__fmul_rn(__fdiv_rn(nf, __fmul_rn(rjs, __fsub_rn(nf, rjs))),
                              psdiff),
                    psdiff)
        : 0.0f;
    const i64 lh = nb - al0 < nb - 1 ? nb - al0 : nb - 1;
    lag_hi[b] = int32_t(lh);
    ti0[b] = int32_t((jmin < jmax ? jmin : jmax) + 1);
    tj0[b] = int32_t((jmin > jmax ? jmin : jmax) + 1);
    n32[b] = int32_t(nb);
    s_ext.vmin = psdiff;
  }
  // the largest M[c] - m[a] at each chunk distance db = |c - a|: a thread
  // the distances d and nchunk - 1 - d, nchunk + 1 pairs of chunks either
  // way, so every thread's share is equal
  __syncthreads();
  for (int d0 = t; 2 * d0 < nchunk; d0 += kRowThreads) {
    const int d1 = nchunk - 1 - d0;
    float b0 = -INFINITY, b1 = -INFINITY;
    for (int a = 0; a + d0 < nchunk; ++a) {
      b0 = fmaxf(b0, __fsub_rn(s_M[a + d0], s_m[a]));
      b0 = fmaxf(b0, __fsub_rn(s_M[a], s_m[a + d0]));
    }
    for (int a = 0; a + d1 < nchunk; ++a) {
      b1 = fmaxf(b1, __fsub_rn(s_M[a + d1], s_m[a]));
      b1 = fmaxf(b1, __fsub_rn(s_M[a], s_m[a + d1]));
    }
    s_db[d0] = b0;
    s_db[d1] = b1;
  }
  __syncthreads();
  // each lag block: the largest over the chunk distances it reaches
  const float psdiff = s_ext.vmin;
  const int blk = npad < kPBlk ? npad : kPBlk;
  const int nblk = npad / blk;
  for (int k = t; k < nblk; k += kRowThreads) {
    const int lo = (k * blk) / C - 1, hi = (k * blk + blk - 1) / C + 1;
    const int db_lo = lo > 0 ? lo : 0;
    const int db_hi = hi < nchunk - 1 ? hi : nchunk - 1;
    float bnd = -INFINITY;
    for (int db = db_lo; db <= db_hi; ++db) bnd = fmaxf(bnd, s_db[db]);
    const float d = fminf(psdiff, bnd);
    psd2[size_t(b) * nblk + k] = __fmul_rn(d, d);
  }
}

// ---------------------------------------------------------------------------
// K10
// ---------------------------------------------------------------------------

// A position's candidate as a key whose order is that of (term, -i, -k):
// the term's bits above (terms are +0 or more, or the -1 of a position
// without an admissible lag, below them all), then kPosMask - i and k.
__device__ __forceinline__ unsigned long long refine_key(float v, int i,
                                                         int k) {
  const unsigned hi = v > 0.0f ? __float_as_uint(v) + 1u
                               : (v == 0.0f ? 1u : 0u);
  return (static_cast<unsigned long long>(hi) << 32)
      | ((kPosMask - unsigned(i)) << 5) | unsigned(k);
}

__global__ void __launch_bounds__(kRefineThreads) refine_kernel(
    const float* __restrict__ cs, const void* n, int n64,
    const float* tss, const int32_t* lag_hi, const float* best_in,
    const int32_t* bl0, const int32_t* ti0, const int32_t* tj0, int npad,
    int al0, int tiles, int ld, const bool* mask, const i64* live,
    unsigned long long* key, unsigned* count, float* t2, int32_t* ti,
    int32_t* tj) {
  __shared__ float s_w[kPTbl];
  __shared__ float s_c[kRefineTile + kPTbl];   // cs[i0 + bl0, ...)
  __shared__ unsigned long long s_key[kRefineWarps];
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  if (skip_row(live, mask, b)) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* row = cs + size_t(b) * ld;
  const i64 nb = row_n(n, n64, b);
  const float nf = __ll2float_rn(nb);
  if (tile == 0 && t == 0) {
    const float best = best_in[b];
    const float tb = tss[b];
    const float tssv = tb <= __fadd_rn(best, 1e-4f) ? __fadd_rn(best, 1.0f)
                                                    : tb;
    t2[b] = __fdiv_rn(best, __fdiv_rn(__fsub_rn(tssv, best),
                                      fmaxf(__fsub_rn(nf, 2.0f), 1.0f)));
  }
  const int b0 = bl0[b];
  if (b0 < 0) {                    // the seed was never beaten
    if (tile == 0 && t == 0) {
      ti[b] = ti0[b];
      tj[b] = tj0[b];
    }
    return;
  }
  // an empty row's result is position 0's empty pair: its tile takes part
  const int nv = nb < 1 ? 1 : (nb > npad ? npad : int(nb));
  const int i0 = tile * kRefineTile;
  if (i0 >= nv) return;
  const int blk = npad < kPBlk ? npad : kPBlk;
  const int sub = blk < kPTbl ? blk : kPTbl;
  if (t < kPTbl) {
    const int lag = b0 + t;
    const float lf = __int2float_rn(lag > 1 ? lag : 1);
    s_w[t] = t < sub ? __fdiv_rn(nf, __fmul_rn(lf, __fsub_rn(nf, lf))) : 0.0f;
  }
  for (int j = t; j < kRefineTile + sub; j += kRefineThreads) {
    const i64 at = i64(i0) + b0 + j;
    s_c[j] = at < npad ? row[at] : 0.0f;
  }
  __syncthreads();
  // the admissible k of a position i: lag = b0 + k in [al0, lag_hi] and
  // i + lag <= n - 1, so k in [klo, min(khi_row, n - 1 - i - b0)]
  const int klo = al0 - b0 > 0 ? al0 - b0 : 0;
  const i64 lh = i64(lag_hi[b]) - b0;
  const i64 khi_row = lh < sub - 1 ? lh : sub - 1;
  float w[kPTbl];
#pragma unroll
  for (int k = 0; k < kPTbl; ++k) w[k] = s_w[k];
  // a position's (term, k) keeps the smallest k among equal terms
  unsigned long long best = 0;
  for (int p = t; p < kRefineTile && i0 + p < nv; p += kRefineThreads) {
    const int i = i0 + p;
    const float c = row[i];
    const i64 kh = nb - 1 - i - b0 < khi_row ? nb - 1 - i - b0 : khi_row;
    const int khi = kh < 0 ? -1 : int(kh);
    float val = -1.0f;
    int lk = 0;
#pragma unroll
    for (int k = 0; k < kPTbl; ++k) {
      if (k >= klo && k <= khi) {
        const float d = __fsub_rn(s_c[p + k], c);
        const float v = __fmul_rn(__fmul_rn(w[k], d), d);
        if (v > val) {
          val = v;
          lk = k;
        }
      }
    }
    const unsigned long long kv = refine_key(val, i, lk);
    best = kv > best ? kv : best;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFull, best, o);
    best = other > best ? other : best;
  }
  if (lane == 0) s_key[warp] = best;
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kRefineWarps; ++w)
      best = s_key[w] > best ? s_key[w] : best;
    atomicMax(key + b, best);
    __threadfence();
    const unsigned live = unsigned((nv + kRefineTile - 1) / kRefineTile);
    if (atomicAdd(count + b, 1u) == live - 1) {   // the row's last tile
      __threadfence();
      const unsigned long long won = atomicExch(key + b, 0ull);
      count[b] = 0;
      const int i = int(kPosMask - unsigned((won >> 5) & kPosMask));
      ti[b] = int32_t(i + 1);
      tj[b] = int32_t(i64(i) + b0 + int(won & 31) + 1);
    }
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

// The table's slot of series term k = s + 1, s = 256 u + 8 l + j: lane l
// of unit u reads its j-th term at 256 u + 32 j + l, next to its
// neighbours'.
__device__ __forceinline__ int table_slot(int s) {
  return (s & ~(kUnit - 1)) | ((s & (kLaneTerms - 1)) << 5)
      | ((s >> 3) & 31);
}

// Series term k of nu(x), ndtr(-x sqrt(k) / 2) (2 / k) as _nu_dev rounds
// it, from the table's (sqrt(k), 2 / k).
__device__ __forceinline__ double series_term(double x, double2 e) {
  const double z = __ddiv_rn(__dmul_rn(__dmul_rn(x, e.x), 0.5), kSqrt2);
  return __dmul_rn(__dmul_rn(erfc(z), 0.5), e.y);
}

struct GridPoint {
  double x, tl, dincr;
};

// Grid point g of a row at b, n bins, as _tail_p_batch_dev places it.
__device__ __forceinline__ GridPoint grid_point(double b, double nf,
                                                int kmax, int n_grid, int g) {
  const double delta = fmin(fmax(__ddiv_rn(double(kmax) + 1.0, nf), 0.0),
                            0.45);
  const double dincr = __ddiv_rn(__dsub_rn(0.5, delta), double(n_grid));
  const double gi = double(g);
  const double tl = __dadd_rn(0.5, __dmul_rn(gi, dincr));
  const double ts = __dadd_rn(0.5, __dmul_rn(__dadd_rn(gi, 0.5), dincr));
  const double x = __ddiv_rn(__ddiv_rn(b, sqrt(nf)),
                             sqrt(__dmul_rn(ts, __dsub_rn(1.0, ts))));
  return {x, tl, dincr};
}

// The Simpson tail's span [v0c, 9] at x and its panel width h.
__device__ __forceinline__ double tail_v0c(double x) {
  return fmin(__ddiv_rn(__dmul_rn(x, kSqrtTail), 2.0), kTailHi);
}
__device__ __forceinline__ double tail_h(double v0c) {
  return __ddiv_rn(__dsub_rn(kTailHi, v0c), double(kPanels));
}

// Simpson point j (weights 1, 4, 2, ..., 4, 1; 0 in the padding past 128).
__device__ __forceinline__ double simpson_point(double v0c, double h, int j) {
  if (j > kPanels) return 0.0;
  const double u = __dadd_rn(v0c, __dmul_rn(h, double(j)));
  const double fu = __ddiv_rn(__dmul_rn(0.5, erfc(__ddiv_rn(u, kSqrt2))),
                              fmax(u, 1e-12));
  const double wgt = (j == 0 || j == kPanels) ? 1.0 : ((j & 1) ? 4.0 : 2.0);
  return __dmul_rn(fu, wgt);
}

// nu(x) of TailProbability.Nu as _nu_dev evaluates it, from a live grid
// point's partial sums: its 32 units of 256 series terms, then its 8 runs
// of 32 Simpson slots.
__device__ double nu_of(double x, const double* part) {
  if (x <= 0.01) return exp(__dmul_rn(-0.583, x));
  double series = 0.0;
#pragma unroll
  for (int c = 0; c < kSeriesChunks; ++c) {
    double v[kChunkUnits];
#pragma unroll
    for (int q = 0; q < kChunkUnits; ++q)
      v[q] = __ldcg(part + c * kChunkUnits + q);
    const double s = tree8(v);           // a chunk: the tree of its units
    series = c == 0 ? s : __dadd_rn(series, s);
  }
  double r[kSimpsonRuns];
#pragma unroll
  for (int q = 0; q < kSimpsonRuns; ++q) r[q] = __ldcg(part + kUnits + q);
  const double simpson = tree8(r);
  const double h = tail_h(tail_v0c(x));
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

// The series table: (sqrt(k), 2 / k) for k = 1..8,192 at table_slot(k - 1).
__global__ void tail_table_kernel(double2* tbl) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < kSeriesTerms) {
    const double k = double(s + 1);
    tbl[table_slot(s)] = make_double2(__dsqrt_rn(k), __ddiv_rn(2.0, k));
  }
}

// K14, the whole-recursion engine's decision rules, which its level runs
// inside K11's launch (tail_decide_kernel): its inputs, the level's rows
// [R], and its outputs.  n is the rows' length (K11's is n_eff).
struct Decide {
  const float* t2;         // K10's statistic: b = sqrt(max(t2, 0))
  const int32_t* ti;
  const int32_t* tj;
  const i64* n;
  const bool* analyzable;
  const float* alpha;      // scalar
  double* b;               // K11's input, written for the checks
  float* ostat;
  bool* hybrid;
  bool* needs;
  bool* trivial;
  i64* nrejc;
  i64 n_min;
  int n_perm;
};

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min_f32(float v, float lo) {
  return v < lo ? lo : v;
}

// The statistic's square root, ostat1 of the rules; its float64 value is
// K11's b.
__device__ __forceinline__ float ostat1_of(float t2) {
  return __fsqrt_rn(clamp_min_f32(t2, 0.0f));
}

// Row r's b: K11's input b_in, or (kDecide) derived from the level's t2.
template <bool kDecide>
__device__ __forceinline__ double row_b(const double* b_in, const Decide& d,
                                        int r) {
  if constexpr (kDecide) {
    return double(ostat1_of(d.t2[r]));
  } else {
    return b_in[r];
  }
}

// K14's rules for row r from its tail probability p (float64, rounded
// once to f32: C5), in f32 with correctly rounded operations, as
// cbs_level_cuda.decide_plain computes them.
__device__ __forceinline__ void decide_row(const Decide& d, int r, double p) {
  const float t2 = d.t2[r];
  const float os1 = ostat1_of(t2);
  const float p1 = __double2float_rn(p);
  const float alpha = *d.alpha;
  const i64 ti = d.ti[r], tj = d.tj[r], n = d.n[r];
  const i64 larc = tj - ti < n - tj + ti ? tj - ti : n - tj + ti;
  const bool considered = d.analyzable[r] && os1 > 0.1f;
  const bool trivial = considered && os1 >= 7.0f && larc >= 10;
  const bool hybrid = n > d.n_min;
  const bool tail_ok = hybrid ? p1 <= alpha : true;
  const float np = float(d.n_perm);
  d.ostat[r] = __fmul_rn(t2, 0.99999f);
  d.hybrid[r] = hybrid;
  d.trivial[r] = trivial;
  d.needs[r] = considered && !trivial && tail_ok;
  d.nrejc[r] = hybrid
      ? i64(__float2int_rz(__fmul_rn(__fsub_rn(alpha, p1), np)))
      : i64(__float2int_rz(__fmul_rn(alpha, np)));
}

// One cooperative launch, every block resident, in three phases split by
// grid barriers:
//   1. a thread a grid point (R x n_grid of them): x into xs, and the live
//      points (x > 0.01) appended to `live` (their order does not matter:
//      every partial sum has its point's own slot);
//   2. a block an item (a live point and a chunk c of its 2,048 series
//      terms), taken from a counter as the block comes free (a static
//      share would leave some blocks the costlier erfc arguments of every
//      point): warp w its unit 8 c + w of 256 terms, warps 0 and 1 also
//      the Simpson slots 64 c + 32 w + lane; each tree into part[point,
//      its slot];
//   3. a block a row: a thread a grid point, its nu from its partial sums
//      (or exp(-0.583 x) where dead) and its term, and the grid's tree.
// nlive[0], the live points' count, and nlive[1], the items taken, are
// zero at the call and left zero.  With kDecide (the whole-recursion
// engine's level) the launch carries K14: phase 1 takes each row's b from
// the level's t2, grid point 0 writing it to d.b, and in phase 3 the
// thread that writes p[row] applies the rules to the row (decide_row).
template <bool kDecide>
__device__ __forceinline__ void tail_body(
    const double* b_in, const void* n, int n64, int kmax, int n_grid, int R,
    const double2* __restrict__ tbl, double* xs, int32_t* live,
    double* part, unsigned* nlive, double* p, const i64* run_live,
    const Decide& d) {
  __shared__ double s_sum[kMaxGrid / 32];
  __shared__ int s_item;
  if (run_live && !*run_live) return;    // every block: no barrier is met
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int points = R * n_grid;
  for (int i = blockIdx.x * kTailThreads + t; i < points;
       i += gridDim.x * kTailThreads) {
    const int row = i / n_grid;
    const double b = row_b<kDecide>(b_in, d, row);
    if constexpr (kDecide) {
      if (i == row * n_grid) d.b[row] = b;
    }
    const double x = grid_point(b, double(row_n(n, n64, row)), kmax,
                                n_grid, i - row * n_grid).x;
    xs[i] = x;
    if (x > 0.01) live[atomicAdd(nlive, 1u)] = i;
  }
  grid.sync();
  const int items = int(__ldcg(nlive)) * kSeriesChunks;
  for (;;) {
    if (t == 0) s_item = int(atomicAdd(nlive + 1, 1u));
    __syncthreads();
    const int item = s_item;
    __syncthreads();
    if (item >= items) break;
    const int i = __ldcg(live + item / kSeriesChunks);
    const int c = item % kSeriesChunks;
    const double x = __ldcg(xs + i);
    const int u = c * kChunkUnits + warp;
    const double2* e = tbl + u * kUnit + lane;
    double v[kLaneTerms];
#pragma unroll
    for (int j = 0; j < kLaneTerms; ++j) v[j] = series_term(x, e[32 * j]);
    const double s = lanes_tree(tree8(v));
    if (lane == 0) part[size_t(i) * kItems + u] = s;
    if (warp < 2) {
      const double v0c = tail_v0c(x);
      const double q = lanes_tree(
          simpson_point(v0c, tail_h(v0c), 64 * c + 32 * warp + lane));
      if (lane == 0) part[size_t(i) * kItems + kUnits + 2 * c + warp] = q;
    }
  }
  grid.sync();
  if (blockIdx.x == 0 && t == 0) nlive[0] = nlive[1] = 0;  // all read them
  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const double b = row_b<kDecide>(b_in, d, row);
    double term = 0.0;
    if (t < n_grid) {
      const int i = row * n_grid + t;
      const GridPoint gp = grid_point(b, double(row_n(n, n64, row)), kmax,
                                      n_grid, t);
      const double nu = nu_of(gp.x, part + size_t(i) * kItems);
      const double integ =
          __dsub_rn(integral_f(__dsub_rn(__dadd_rn(gp.tl, gp.dincr), 0.5)),
                    integral_f(__dsub_rn(gp.tl, 0.5)));
      term = __dmul_rn(__dmul_rn(nu, nu), integ);
    }
    if (warp < kMaxGrid / 32) {     // the grid's tree: 4 warps of 32 slots
      term = lanes_tree(term);
      if (lane == 0) s_sum[warp] = term;
    }
    __syncthreads();
    if (t == 0) {
      const double out = __dadd_rn(__dadd_rn(s_sum[0], s_sum[1]),
                                   __dadd_rn(s_sum[2], s_sum[3]));
      const double bcube = __dmul_rn(__dmul_rn(b, b), b);
      const double ex = exp(__ddiv_rn(__dmul_rn(-b, b), 2.0));
      const double pr =
          __dmul_rn(__dmul_rn(__dmul_rn(kTailConst, bcube), ex), out);
      p[row] = pr;
      if constexpr (kDecide) decide_row(d, row, pr);
    }
    __syncthreads();
  }
}

// K11 (the frontier engine's, and tests'): b_in given.
__global__ void __launch_bounds__(kTailThreads, 4) tail_kernel(
    const double* b_in, const void* n, int n64, int kmax, int n_grid, int R,
    const double2* __restrict__ tbl, double* xs, int32_t* live,
    double* part, unsigned* nlive, double* p, const i64* run_live) {
  tail_body<false>(b_in, n, n64, kmax, n_grid, R, tbl, xs, live, part, nlive,
                   p, run_live, Decide{});
}

// K11 carrying K14 (the whole-recursion engine's level).
__global__ void __launch_bounds__(kTailThreads, 4) tail_decide_kernel(
    const void* n, int n64, int kmax, int n_grid, int R,
    const double2* __restrict__ tbl, double* xs, int32_t* live,
    double* part, unsigned* nlive, double* p, const i64* run_live,
    Decide d) {
  tail_body<true>(nullptr, n, n64, kmax, n_grid, R, tbl, xs, live, part,
                  nlive, p, run_live, d);
}

// Series term i % 8,192 + 1 of nu(x[i]) as K11 computes it, for tests and
// for counting one term's instructions in the SASS.
__global__ void series_term_kernel(const double* x, const double2* tbl,
                                   double* out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = series_term(x[i], tbl[table_slot(i % kSeriesTerms)]);
}

// The math library's erfc on its own, for tests and for counting one
// call's instructions in the SASS.
__global__ void erfc_kernel(const double* x, double* out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = erfc(x[i]);
}

}  // namespace

// K9.  cs: f32 [B, npad] (16-byte aligned); n: int64 (n64 = 1) or int32
// [B]; outputs seed f32, lag_hi, ti0, tj0 and n32 (n as int32) [B], psd2
// f32 [B, nblk].  Scratch where a row has more than one tile: ext (16
// bytes) [B, tiles], chunk (8 bytes) [B, nchunk], and count (u32, at least
// [B]), zero and left zero.
extern "C" int cbs_arc_inputs(const void* cs, const void* n, int n64,
                              void* ext, void* chunk, void* count,
                              void* seed, void* lag_hi, void* ti0, void* tj0,
                              void* n32, void* psd2, int B, int npad, int al0,
                              int ld, const void* mask, const void* live,
                              void* stream) {
  if (B <= 0) return 0;
  if (npad < 1 || npad > 65536 || (npad & (npad - 1)) || ld < npad ||
      ld % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = npad > kTile ? npad / kTile : 1;
  arc_inputs_kernel<<<unsigned(B) * unsigned(tiles), kRowThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cs), n, n64, npad, al0, tiles, ld,
      static_cast<const bool*>(mask), static_cast<const i64*>(live),
      static_cast<TileExt*>(ext), static_cast<float2*>(chunk),
      static_cast<unsigned*>(count), static_cast<float*>(seed),
      static_cast<int32_t*>(lag_hi), static_cast<int32_t*>(ti0),
      static_cast<int32_t*>(tj0), static_cast<int32_t*>(n32),
      static_cast<float*>(psd2));
  return static_cast<int>(cudaGetLastError());
}

// K10.  cs f32 [B, npad], n int64 or int32, tss f32, lag_hi int32, best
// f32, bl0, ti0, tj0 int32 [B]; outputs t2 f32, ti and tj int32 [B].  key
// (u64) and count (u32), at least [B], are zero and are left zero.
extern "C" int cbs_refine(const void* cs, const void* n, int n64,
                          const void* tss, const void* lag_hi,
                          const void* best, const void* bl0, const void* ti0,
                          const void* tj0, void* key, void* count, void* t2,
                          void* ti, void* tj, int B, int npad, int al0,
                          int ld, const void* mask, const void* live,
                          void* stream) {
  if (B <= 0) return 0;
  if (npad < 1 || unsigned(npad) > kPosMask || ld < npad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (npad + kRefineTile - 1) / kRefineTile;
  refine_kernel<<<unsigned(B) * unsigned(tiles), kRefineThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cs), n, n64, static_cast<const float*>(tss),
      static_cast<const int32_t*>(lag_hi), static_cast<const float*>(best),
      static_cast<const int32_t*>(bl0), static_cast<const int32_t*>(ti0),
      static_cast<const int32_t*>(tj0), npad, al0, tiles, ld,
      static_cast<const bool*>(mask), static_cast<const i64*>(live),
      static_cast<unsigned long long*>(key), static_cast<unsigned*>(count),
      static_cast<float*>(t2), static_cast<int32_t*>(ti),
      static_cast<int32_t*>(tj));
  return static_cast<int>(cudaGetLastError());
}

// K11's series table, double2 [8,192].
extern "C" int cbs_tail_table(void* tbl, void* stream) {
  tail_table_kernel<<<kSeriesTerms / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<double2*>(tbl));
  return static_cast<int>(cudaGetLastError());
}

// K11's blocks on the current device, for a cooperative launch: its SMs
// times the blocks the occupancy calculator lets each hold, into *grid;
// decide = 1 for the variant that carries K14 (each variant its own).
extern "C" int cbs_tail_grid(int decide, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = decide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, tail_decide_kernel, kTailThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, tail_kernel, kTailThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = sms * per_sm;
  return per_sm > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

namespace {

int tail_args_invalid(int R, int n_grid, int grid) {
  return n_grid < 1 || n_grid > kMaxGrid || grid <= 0 ||
         static_cast<long long>(R) * n_grid * kItems > 0x7FFFFFFFll;
}

// A launch of `kernel` on grid blocks with the cooperative launch
// attribute, which a CUDA graph's stream capture keeps on the kernel node
// (the grid barriers need it on every replay).
int launch_cooperative(const void* kernel, int grid, void** args,
                       void* stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid));
  cfg.blockDim = dim3(kTailThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11.  b float64 [R], n int64 or int32 [R]; output p float64 [R];
// n_grid <= 128; grid from cbs_tail_grid(0).  tbl: the series table;
// scratch xs float64 [R n_grid], live int32 [R n_grid], part float64
// [R n_grid, 40]; nlive (u32 [2]) is zero and is left zero.
extern "C" int cbs_tail_p(const void* b, const void* n, int n64,
                          const void* tbl, void* xs, void* live, void* part,
                          void* nlive, void* p, int R, int kmax, int n_grid,
                          int grid, const void* run_live, void* stream) {
  if (R <= 0) return 0;
  if (tail_args_invalid(R, n_grid, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&b, &n, &n64, &kmax, &n_grid, &R, &tbl, &xs, &live, &part,
                  &nlive, &p, &run_live};
  return launch_cooperative(reinterpret_cast<const void*>(tail_kernel), grid,
                            args, stream);
}

// K11 carrying K14, for the whole-recursion engine's level: K11 as
// cbs_tail_p with b from t2 f32 [R] (written to b float64) and n_eff int64
// (n64 = 1) or int32 [R]; then K14's outputs ostat f32, hybrid, needs,
// trivial bool and nrejc int64 [R] from t2, ti, tj int32, n int64,
// analyzable bool [R], alpha (f32 scalar), n_min and n_perm.  grid from
// cbs_tail_grid(1).
extern "C" int cbs_tail_decide(const void* n_eff, int n64, const void* tbl,
                               void* xs, void* live, void* part, void* nlive,
                               void* p, const void* t2, const void* ti,
                               const void* tj, const void* n,
                               const void* analyzable, const void* alpha,
                               void* b, void* ostat, void* hybrid,
                               void* needs, void* trivial, void* nrejc,
                               long long n_min, int n_perm, int R, int kmax,
                               int n_grid, int grid, const void* run_live,
                               void* stream) {
  if (R <= 0) return 0;
  if (tail_args_invalid(R, n_grid, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  Decide d;
  d.t2 = static_cast<const float*>(t2);
  d.ti = static_cast<const int32_t*>(ti);
  d.tj = static_cast<const int32_t*>(tj);
  d.n = static_cast<const i64*>(n);
  d.analyzable = static_cast<const bool*>(analyzable);
  d.alpha = static_cast<const float*>(alpha);
  d.b = static_cast<double*>(b);
  d.ostat = static_cast<float*>(ostat);
  d.hybrid = static_cast<bool*>(hybrid);
  d.needs = static_cast<bool*>(needs);
  d.trivial = static_cast<bool*>(trivial);
  d.nrejc = static_cast<i64*>(nrejc);
  d.n_min = n_min;
  d.n_perm = n_perm;
  void* args[] = {&n_eff, &n64, &kmax, &n_grid, &R, &tbl, &xs, &live, &part,
                  &nlive, &p, &run_live, &d};
  return launch_cooperative(reinterpret_cast<const void*>(tail_decide_kernel),
                            grid, args, stream);
}

// Series term i % 8,192 + 1 of nu(x[i]) for x float64 [count], from the
// table, into out.
extern "C" int cbs_series_term(const void* x, const void* tbl, void* out,
                               int count, void* stream) {
  if (count <= 0) return 0;
  series_term_kernel<<<(count + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double2*>(tbl),
      static_cast<double*>(out), count);
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

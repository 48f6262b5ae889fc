// The whole-recursion CBS engine's level body for Hopper: kernels K13-K16.
//
// canvas_tpu runs a CBS level as part of one device program, the
// lax.while_loop of canvas_tpu/ops/cbs_mega.py:_mega_recurse (:301-503).
// Around its kernels (B4 and K9-K11 for the arc scan and the tail, K7 and
// K8 for the walks and edge tests) the level body is XLA glue, which these
// kernels replace:
//
//   K13 (prologue_kernel) :335-355 and the tiers of :369-386.  A block a
//       row of the level: the row's slot is the b-th of the table's slots
//       with the pending ones first, each part in slot order (a block scan
//       of the S <= 1,024 pending flags, the same in every block); the
//       window gather from the contig matrix and its centring (float64
//       sum, the mean rounded once to f32), the float64 sum of squares,
//       the constant-window test, analyzable and n_eff, each tier's row
//       mask, rows that cannot be analysed zeroed, the float64 cumsum
//       rounded to f32 at each position, and t2, ti, tj at their values
//       for a row in no tier (0, 1, 2).
//   K14 (decide_kernel) :397-413, in two launches: before K11, b = the
//       statistic's square root in float64 (K11's input); after it, ostat,
//       hybrid, trivial, needs and the walk limit nrejc from K11's
//       float64 p1 rounded to f32.
//   K15 (edge_setup_kernel, edge_keep_kernel) the edge tests' set-up,
//       _edge_tests :174-215 and :286-290 with the call's preamble and
//       epilogue :449-467.  Before K8, a block a lane of the 2W lanes:
//       accepted and test_both of its row, the lane's shifted window xw,
//       its float64 sums and the statistic's tstat, degen, quick0 and
//       active; after K8, one block: each lane's keep flag and the rows'
//       keep1 and keep2, and the level's edge chunks.
//   K16 (table_kernel) the table update :468-500, one block holding the
//       whole table of S <= 1,024 slots: split1 and split2, the exclusive
//       cumsum of the rows' children, the parents' new ends, the appends
//       (beyond S dropped), nseg, overflow, the run's tally, the level
//       count, and live: some slot pending, no overflow and the level
//       count under the engine's bound.
//
// Every kernel, and every other kernel of the level, returns at once when
// live is false, so a level after the run's end changes nothing; the host
// replays captured levels in batches and reads live and the table after
// each batch (ops/cbs_mega.py).  The table and its control words live in
// one int64 buffer: seg_c, seg_lo and seg_hi [S] each, then nseg,
// overflow, live, the level count and the tally of walks accepted and
// rejected, walk chunks and edge chunks.
//
// What bounds them on the H100.  K13 moves the level's windows: each row's
// n values gathered, x and its cumsum written, W x Tmax x 8 bytes (8 MB
// at the panel's [32, 32,768]); K15's set-up writes the 2W windows (8 MB
// there too).  Both are bytes at 3.35 TB/s, a few microseconds; with a
// block a row (lane) and three passes over the row, a block's latency
// chain is their floor.  K14, K15's keep and K16 touch a few kilobytes:
// a launch's latency is theirs.
//
// Exactness.  The plain versions (ops/cbs_level_cuda.py) are the torch
// code the kernels replace.  Every f32 and float64 operation here is the
// correctly rounded one (intrinsics, nothing contracted into a multiply-
// add), divisions by the lengths are IEEE divisions, comparisons take the
// constants in f32 as torch does, and NaN propagates through clamps as in
// torch.clamp.  The float64 sums (K13: the row's sum, sum of squares and
// cumsum; K15: the lanes' sum, partial sum and sum of f32 squares) add in
// another order than torch's reductions and scans.  A float64 sum of n
// f32 values, or a prefix of it, is exact, and so the same in any order,
// only where the values' exponents span at most 29 - log2(n) bits (every
// partial sum then fits in 53 bits); K15's f32 squares span twice their
// values' range.  K13's sum of squares is not exact in general: each
// float64 product d * d carries up to 48 significant bits, so its partial
// sums round and their order can change the float64 sum's last bit, and
// with it the f32 result where that sum lies within an ulp of an f32
// rounding boundary.  So bit-equality with the plain versions is shown
// only on the levels each kernel was held against, every level of the
// panel's and bench.py's CBS workload's runs (PERF.md section 6), not
// for every input.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>
#include <vector>

namespace {

typedef long long i64;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMinTier = 1024;     // the narrowest tier; tier t is 1024 << t

// the control words after the table
constexpr int kNseg = 0, kOverflow = 1, kLive = 2, kLevel = 3, kTally = 4;

__device__ __forceinline__ bool dead(const i64* ctl) {
  return ctl[kLive] == 0;
}

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// ---------------------------------------------------------------------------
// Block-wide helpers (blockDim.x == kThreads)
// ---------------------------------------------------------------------------

// Exclusive prefix of v over the block's threads in thread order, and the
// total.  sh holds kWarps + 1 values.  Ends with a barrier.
template <typename T>
__device__ T block_exclusive_scan(T v, T* sh, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T w = sh[lane];
    T wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    T we = __shfl_up_sync(kFull, wi, 1);
    if (lane == 0) we = T(0);
    sh[lane] = we;
    if (lane == 31) sh[kWarps] = wi;
  }
  __syncthreads();
  const T out = excl + sh[warp];
  *total = sh[kWarps];
  __syncthreads();
  return out;
}

// The block's sum of v (float64 adds, correctly rounded), on every thread.
// sh holds kWarps values.  Ends with a barrier.
__device__ double block_sum(double v, double* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double s = sh[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __dadd_rn(s, __shfl_xor_sync(kFull, s, o));
  __syncthreads();
  return s;
}

__device__ i64 block_sum_i64(i64 v, i64* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  i64 s = sh[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  __syncthreads();
  return s;
}

// The block's maximum (larger = true) or minimum of v, NaN-free inputs.
__device__ float block_extreme(float v, float* sh, bool larger) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    v = larger ? fmaxf(v, u) : fminf(v, u);
  }
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float s = sh[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, s, o);
    s = larger ? fmaxf(s, u) : fminf(s, u);
  }
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// K13
// ---------------------------------------------------------------------------

struct PrologueArgs {
  const float* contigs;    // [C, Tmax]
  const i64* tab;          // seg_c, seg_lo, seg_hi [S] each
  const bool* pending0;    // [S]
  const i64* ctl;
  i64* fsel;               // [W] outputs from here
  i64* contig;
  i64* seg_lo;
  i64* n;
  bool* pending;
  bool* analyzable;
  i64* n_eff;
  float* x;                // [W, Tmax]
  float* tss;
  float* cs;               // [W, Tmax]
  bool* in_tier;           // [T, W]
  float* t2;
  int32_t* ti;
  int32_t* tj;
  int S, W, Tmax, al0, tiers;
};

__global__ void __launch_bounds__(kThreads) prologue_kernel(PrologueArgs a) {
  __shared__ int s_scan[kWarps + 1];
  __shared__ double s_d[kWarps];
  __shared__ float s_f[kWarps];
  __shared__ int s_slot;
  if (dead(a.ctl)) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x, T = a.Tmax;
  // the row's slot: pending slots first, each part in slot order
  const int p = t < a.S && a.pending0[t] ? 1 : 0;
  int total;
  const int rank = block_exclusive_scan<int>(p, s_scan, &total);
  if (t < a.S && (p ? rank : total + (t - rank)) == b) s_slot = t;
  __syncthreads();
  const int s = s_slot;
  const i64 c = a.tab[s], lo = a.tab[a.S + s], hi = a.tab[2 * a.S + s];
  const bool pend = a.pending0[s];
  const i64 n = hi - lo;
  const i64 contig = c < 0 ? 0 : c;
  const int nv = n < 0 ? 0 : (n > T ? T : int(n));
  float* xr = a.x + size_t(b) * T;
  float* cr = a.cs + size_t(b) * T;
  const float* src = a.contigs + size_t(contig) * T + lo;
  // the window (zero past n) and its float64 sum
  double sum = 0.0;
  for (int j = t; j < T; j += kThreads) {
    const float v = j < nv ? src[j] : 0.0f;
    xr[j] = v;
    sum = __dadd_rn(sum, double(v));
  }
  sum = block_sum(sum, s_d);
  const float mean = __double2float_rn(
      __ddiv_rn(sum, double(n < 1 ? 1 : n)));
  // centred values, their float64 sum of squares and the window's range
  double sq = 0.0;
  float mx = -FLT_MAX, mn = FLT_MAX;
  int nan = 0;
  for (int j = t; j < T; j += kThreads) {
    const float v = j < nv ? __fsub_rn(xr[j], mean) : 0.0f;
    xr[j] = v;
    const double d = double(v);
    sq = __dadd_rn(sq, __dmul_rn(d, d));
    if (j < nv) {
      if (v != v) nan = 1;
      mx = fmaxf(mx, v);
      mn = fminf(mn, v);
    }
  }
  sq = block_sum(sq, s_d);
  mx = block_extreme(mx, s_f, true);
  mn = block_extreme(mn, s_f, false);
  nan = __syncthreads_or(nan);
  const bool analyzable = pend && n >= 2 * i64(a.al0) && !nan && mx > mn;
  if (!analyzable) {
    for (int j = t; j < T; j += kThreads) {
      xr[j] = 0.0f;
      cr[j] = 0.0f;
    }
  } else {
    // the float64 cumsum, a tile of kThreads positions at a time
    double carry = 0.0;
    for (int j0 = 0; j0 < T; j0 += kThreads) {
      const double v = double(xr[j0 + t]);
      double incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl = __dadd_rn(incl, u);
      }
      if (lane == 31) s_d[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        double w = s_d[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(kFull, w, o);
          if (lane >= o) w = __dadd_rn(w, u);
        }
        s_d[lane] = w;
      }
      __syncthreads();
      const double before = warp ? __dadd_rn(carry, s_d[warp - 1]) : carry;
      cr[j0 + t] = __double2float_rn(__dadd_rn(before, incl));
      carry = __dadd_rn(carry, s_d[kWarps - 1]);
      __syncthreads();
    }
  }
  if (t == 0) {
    a.fsel[b] = s;
    a.contig[b] = contig;
    a.seg_lo[b] = lo;
    a.n[b] = n;
    a.pending[b] = pend;
    a.analyzable[b] = analyzable;
    const i64 ne = analyzable ? n : 2;
    a.n_eff[b] = ne;
    a.tss[b] = analyzable ? __double2float_rn(sq) : 0.0f;
    for (int k = 0; k < a.tiers; ++k) {
      const i64 w = i64(kMinTier) << k, prev = k ? w / 2 : 0;
      a.in_tier[size_t(k) * a.W + b] = analyzable && ne <= w && ne > prev;
    }
    a.t2[b] = 0.0f;
    a.ti[b] = 1;
    a.tj[b] = 2;
  }
}

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

struct DecideArgs {
  const i64* ctl;
  const float* t2;
  const int32_t* ti;
  const int32_t* tj;
  const i64* n;
  const bool* analyzable;
  const double* p1;        // K11's, [W]
  const float* alpha;      // scalar
  double* b;               // phase 0: K11's input
  float* ostat;            // phase 1 from here
  bool* hybrid;
  bool* needs;
  bool* trivial;
  i64* nrejc;
  i64 n_min;
  int W, n_perm, phase;
};

__device__ __forceinline__ float ostat1_of(float t2) {
  return __fsqrt_rn(clamp_min(t2, 0.0f));
}

__global__ void decide_kernel(DecideArgs a) {
  if (dead(a.ctl)) return;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.W) return;
  const float t2 = a.t2[r];
  const float os1 = ostat1_of(t2);
  if (a.phase == 0) {
    a.b[r] = double(os1);
    return;
  }
  const float p1 = __double2float_rn(a.p1[r]);
  const float alpha = *a.alpha;
  const i64 ti = a.ti[r], tj = a.tj[r], n = a.n[r];
  const i64 larc = tj - ti < n - tj + ti ? tj - ti : n - tj + ti;
  const bool considered = a.analyzable[r] && os1 > 0.1f;
  const bool trivial = considered && os1 >= 7.0f && larc >= 10;
  const bool hybrid = n > a.n_min;
  const bool tail_ok = hybrid ? p1 <= alpha : true;
  const float np = float(a.n_perm);
  a.ostat[r] = __fmul_rn(t2, 0.99999f);
  a.hybrid[r] = hybrid;
  a.trivial[r] = trivial;
  a.needs[r] = considered && !trivial && tail_ok;
  a.nrejc[r] = hybrid ? i64(__float2int_rz(__fmul_rn(__fsub_rn(alpha, p1), np)))
                      : i64(__float2int_rz(__fmul_rn(alpha, np)));
}

// ---------------------------------------------------------------------------
// K15
// ---------------------------------------------------------------------------

struct EdgeSetupArgs {
  const i64* ctl;
  const float* x;          // [W, Tmax]
  const i64* n;
  const int32_t* ti;
  const int32_t* tj;
  const bool* trivial;
  const bool* walked;
  const float* alpha;
  float* xw;               // [2W, Tmax] outputs from here
  i64* wn;                 // [2W]
  i64* m1;
  float* xbar;
  float* ostat;
  bool* degen;
  bool* quick0;
  bool* active;
  bool* accepted;          // [W]
  bool* test_both;
  float* limit;            // scalar
  int W, Tmax, n_perm;
};

// Lane l = e W + r tests edge e + 1 of row r: edge 1 the split at ti
// inside x[0, tj), edge 2 the split at tj inside x[ti, n), shifted left
// by ti.
__global__ void __launch_bounds__(kThreads) edge_setup_kernel(
    EdgeSetupArgs a) {
  __shared__ double s_d[kWarps];
  if (dead(a.ctl)) return;
  const int t = threadIdx.x, l = blockIdx.x;
  const int r = l % a.W, e = l / a.W, T = a.Tmax;
  const i64 ti = a.ti[r], tj = a.tj[r], n = a.n[r];
  const i64 wn = e ? n - ti : tj;
  const i64 n1 = e ? tj - ti : ti;
  const i64 n2 = wn - n1;
  const i64 off = e ? (ti < 0 ? 0 : (ti > T ? T : ti)) : 0;
  const bool accepted = a.trivial[r] || a.walked[r];
  const bool test_both = accepted && !(tj >= n) && !(ti <= 0);
  const float* xr = a.x + size_t(r) * T;
  float* out = a.xw + size_t(l) * T;
  double s1 = 0.0, s = 0.0, q = 0.0;
  for (int j = t; j < T; j += kThreads) {
    float v = 0.0f;
    if (j < wn) {
      const i64 at = off + j;
      v = at < T ? xr[at] : 0.0f;
    }
    out[j] = v;
    const double d = double(v);
    if (j < n1) s1 = __dadd_rn(s1, d);
    s = __dadd_rn(s, d);
    q = __dadd_rn(q, double(__fmul_rn(v, v)));
  }
  s1 = block_sum(s1, s_d);
  s = block_sum(s, s_d);
  q = block_sum(q, s_d);
  if (t != 0) return;
  const float xsum1 = __double2float_rn(s1), xsum = __double2float_rn(s);
  const float wnf = __ll2float_rn(wn);
  const float xbar = __fdiv_rn(xsum, clamp_min(wnf, 1.0f));
  const float tss = __fsub_rn(__double2float_rn(q),
                              __fmul_rn(__fmul_rn(wnf, xbar), xbar));
  const i64 m1 = n1 < n2 ? n1 : n2;
  const float m1f = __ll2float_rn(m1 < 1 ? 1 : m1);
  const float mean_small =
      n1 <= n2 ? __fdiv_rn(xsum1, __ll2float_rn(n1 < 1 ? 1 : n1))
               : __fdiv_rn(__fsub_rn(xsum, xsum1),
                           __ll2float_rn(n2 < 1 ? 1 : n2));
  const float ostat = __fmul_rn(fabsf(__fsub_rn(mean_small, xbar)), 0.99999f);
  float tstat = __fdiv_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(ostat, ostat), m1f), wnf),
      clamp_min(__fsub_rn(wnf, m1f), 1.0f));
  tstat = __fdiv_rn(tstat, __fdiv_rn(clamp_min(__fsub_rn(tss, tstat), 1e-30f),
                                     clamp_min(__fsub_rn(wnf, 2.0f), 1.0f)));
  const bool degen = n1 <= 1 || n2 <= 1;
  const bool quick0 = tstat > 25.0f && m1 >= 10;
  a.wn[l] = wn;
  a.m1[l] = m1;
  a.xbar[l] = xbar;
  a.ostat[l] = ostat;
  a.degen[l] = degen;
  a.quick0[l] = quick0;
  a.active[l] = test_both && !degen && !quick0;
  if (e == 0) {
    a.accepted[r] = accepted;
    a.test_both[r] = test_both;
  }
  if (l == 0) *a.limit = __fmul_rn(*a.alpha, float(a.n_perm));
}

struct EdgeKeepArgs {
  const i64* ctl;
  const i64* count;        // K8's, [2W]
  const i64* cnt;
  const bool* degen;
  const bool* quick0;
  const bool* test_both;
  const int32_t* ti;
  const int32_t* tj;
  const i64* n;
  const float* alpha;
  bool* keep1;             // [W]
  bool* keep2;
  i64* echunks;            // scalar
  int W, n_perm;
};

__global__ void __launch_bounds__(kThreads) edge_keep_kernel(EdgeKeepArgs a) {
  __shared__ bool s_keep[kThreads];
  __shared__ i64 s_i[kWarps];
  if (dead(a.ctl)) return;
  const int t = threadIdx.x, L = 2 * a.W;
  i64 c = 0;
  if (t < L) {
    const float p = __fdiv_rn(__ll2float_rn(a.count[t]), float(a.n_perm));
    s_keep[t] = a.degen[t] ? false : (a.quick0[t] ? true : p <= *a.alpha);
    c = a.cnt[t];
  }
  c = block_sum_i64(c, s_i);      // ends with a barrier
  if (t < a.W) {
    const bool at_end = a.tj[t] >= a.n[t], at_start = a.ti[t] <= 0;
    const bool tb = a.test_both[t];
    a.keep1[t] = tb ? s_keep[t] : at_end && !at_start;
    a.keep2[t] = tb ? s_keep[a.W + t] : at_start && !at_end;
  }
  if (t == 0) *a.echunks = c;
}

// ---------------------------------------------------------------------------
// K16
// ---------------------------------------------------------------------------

struct TableArgs {
  i64* tab;                // seg_c, seg_lo, seg_hi [S] each, then ctl
  bool* pending0;          // [S]
  const i64* fsel;         // [W] the level's rows from here
  const i64* contig;
  const i64* seg_lo;
  const i64* n;
  const bool* pending;
  const bool* analyzable;
  const bool* accepted;
  const bool* keep1;
  const bool* keep2;
  const int32_t* ti;
  const int32_t* tj;
  const bool* needs;
  const bool* walked;      // K7's
  const i64* wchunks;      // K7's
  const i64* echunks;      // K15's
  int S, W, max_levels;
};

__global__ void __launch_bounds__(kThreads) table_kernel(TableArgs a) {
  __shared__ int s_scan[kWarps + 1];
  __shared__ i64 s_i[kWarps];
  i64* ctl = a.tab + 3 * a.S;
  if (dead(ctl)) return;
  const int t = threadIdx.x, S = a.S;
  const bool row = t < a.W;
  bool split1 = false, split2 = false;
  i64 lo = 0, n = 0, first_cut = 0, second_cut = 0;
  int extra = 0;
  if (row) {
    const bool acc = a.accepted[t];
    const i64 ti = a.ti[t], tj = a.tj[t];
    n = a.n[t];
    lo = a.seg_lo[t];
    split1 = acc && a.keep1[t];
    split2 = acc && a.keep2[t] && tj < n;
    first_cut = split1 ? ti : tj;
    second_cut = split1 && split2 ? tj : n;
    const int nsplits = int(split1) + int(split2);
    extra = nsplits > 0 ? 1 + (nsplits == 2) : 0;
  }
  int added;
  const int before = block_exclusive_scan<int>(extra, s_scan, &added);
  const i64 nseg = ctl[kNseg];
  // the parents first: a row with children keeps its first piece
  if (row) {
    const i64 s = a.fsel[t];
    if (extra > 0) a.tab[2 * S + s] = lo + first_cut;
    a.pending0[s] = a.pending[t] && a.analyzable[t] && extra > 0;
  }
  __syncthreads();
  // then the children, at the cursor; beyond the table they are dropped
  if (extra >= 1) {
    const i64 at = nseg + before;
    const i64 c = a.contig[t];
    if (at < S) {
      a.tab[at] = c;
      a.tab[S + at] = lo + first_cut;
      a.tab[2 * S + at] = lo + second_cut;
      a.pending0[at] = true;
    }
    if (extra == 2 && at + 1 < S) {
      a.tab[at + 1] = c;
      a.tab[S + at + 1] = lo + second_cut;
      a.tab[2 * S + at + 1] = lo + n;
      a.pending0[at + 1] = true;
    }
  }
  const bool nd = row && a.needs[t];
  const bool wk = row && a.walked[t];
  const i64 acc_n = block_sum_i64(nd && wk ? 1 : 0, s_i);
  const i64 rej_n = block_sum_i64(nd && !wk ? 1 : 0, s_i);
  const i64 wch = block_sum_i64(row ? a.wchunks[t] : 0, s_i);
  // every pending flag written above is visible after the barriers
  const int any = __syncthreads_or(t < S && a.pending0[t]);
  if (t == 0) {
    const i64 nseg1 = nseg + added;
    const bool over = ctl[kOverflow] != 0 || nseg1 > S;
    const i64 level = ctl[kLevel] + 1;
    ctl[kNseg] = nseg1;
    ctl[kOverflow] = over;
    ctl[kLevel] = level;
    ctl[kTally] += acc_n;
    ctl[kTally + 1] += rej_n;
    ctl[kTally + 2] += wch;
    ctl[kTally + 3] += *a.echunks;
    ctl[kLive] = any && !over && level < a.max_levels;
  }
}

}  // namespace

// K13.  contigs f32 [C, Tmax]; tab int64 [3 S + 8] (the table, then ctl);
// pending0 bool [S]; outputs [W] (x and cs [W, Tmax], in_tier [tiers, W]).
// S <= 1,024, W <= S, Tmax a multiple of 1,024.
extern "C" int cbs_prologue(const void* contigs, const void* tab,
                            const void* pending0, void* fsel, void* contig,
                            void* seg_lo, void* n, void* pending,
                            void* analyzable, void* n_eff, void* x, void* tss,
                            void* cs, void* in_tier, void* t2, void* ti,
                            void* tj, int S, int W, int Tmax, int al0,
                            int tiers, void* stream) {
  if (W <= 0) return 0;
  if (S > kThreads || W > S || Tmax % kThreads || tiers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PrologueArgs a;
  a.contigs = static_cast<const float*>(contigs);
  a.tab = static_cast<const i64*>(tab);
  a.pending0 = static_cast<const bool*>(pending0);
  a.ctl = a.tab + 3 * S;
  a.fsel = static_cast<i64*>(fsel);
  a.contig = static_cast<i64*>(contig);
  a.seg_lo = static_cast<i64*>(seg_lo);
  a.n = static_cast<i64*>(n);
  a.pending = static_cast<bool*>(pending);
  a.analyzable = static_cast<bool*>(analyzable);
  a.n_eff = static_cast<i64*>(n_eff);
  a.x = static_cast<float*>(x);
  a.tss = static_cast<float*>(tss);
  a.cs = static_cast<float*>(cs);
  a.in_tier = static_cast<bool*>(in_tier);
  a.t2 = static_cast<float*>(t2);
  a.ti = static_cast<int32_t*>(ti);
  a.tj = static_cast<int32_t*>(tj);
  a.S = S;
  a.W = W;
  a.Tmax = Tmax;
  a.al0 = al0;
  a.tiers = tiers;
  prologue_kernel<<<unsigned(W), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K14.  phase 0: b float64 [W] from t2; phase 1: ostat f32, hybrid,
// needs, trivial bool and nrejc int64 [W] from t2, ti, tj (int32), n,
// analyzable, K11's p1 float64 and alpha (f32 scalar).
extern "C" int cbs_decide(const void* ctl, const void* t2, const void* ti,
                          const void* tj, const void* n,
                          const void* analyzable, const void* p1,
                          const void* alpha, void* b, void* ostat,
                          void* hybrid, void* needs, void* trivial,
                          void* nrejc, long long n_min, int W, int n_perm,
                          int phase, void* stream) {
  if (W <= 0) return 0;
  DecideArgs a;
  a.ctl = static_cast<const i64*>(ctl);
  a.t2 = static_cast<const float*>(t2);
  a.ti = static_cast<const int32_t*>(ti);
  a.tj = static_cast<const int32_t*>(tj);
  a.n = static_cast<const i64*>(n);
  a.analyzable = static_cast<const bool*>(analyzable);
  a.p1 = static_cast<const double*>(p1);
  a.alpha = static_cast<const float*>(alpha);
  a.b = static_cast<double*>(b);
  a.ostat = static_cast<float*>(ostat);
  a.hybrid = static_cast<bool*>(hybrid);
  a.needs = static_cast<bool*>(needs);
  a.trivial = static_cast<bool*>(trivial);
  a.nrejc = static_cast<i64*>(nrejc);
  a.n_min = n_min;
  a.W = W;
  a.n_perm = n_perm;
  a.phase = phase;
  decide_kernel<<<unsigned((W + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K15, before K8.  x f32 [W, Tmax], n int64, ti and tj int32, trivial and
// walked bool [W], alpha f32 scalar; outputs xw f32 [2W, Tmax], wn and m1
// int64, xbar and ostat f32, degen, quick0 and active bool [2W], accepted
// and test_both bool [W], limit f32 scalar.  2 W <= 1,024.
extern "C" int cbs_edge_setup(const void* ctl, const void* x, const void* n,
                              const void* ti, const void* tj,
                              const void* trivial, const void* walked,
                              const void* alpha, void* xw, void* wn,
                              void* m1, void* xbar, void* ostat, void* degen,
                              void* quick0, void* active, void* accepted,
                              void* test_both, void* limit, int W, int Tmax,
                              int n_perm, void* stream) {
  if (W <= 0) return 0;
  if (2 * W > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  EdgeSetupArgs a;
  a.ctl = static_cast<const i64*>(ctl);
  a.x = static_cast<const float*>(x);
  a.n = static_cast<const i64*>(n);
  a.ti = static_cast<const int32_t*>(ti);
  a.tj = static_cast<const int32_t*>(tj);
  a.trivial = static_cast<const bool*>(trivial);
  a.walked = static_cast<const bool*>(walked);
  a.alpha = static_cast<const float*>(alpha);
  a.xw = static_cast<float*>(xw);
  a.wn = static_cast<i64*>(wn);
  a.m1 = static_cast<i64*>(m1);
  a.xbar = static_cast<float*>(xbar);
  a.ostat = static_cast<float*>(ostat);
  a.degen = static_cast<bool*>(degen);
  a.quick0 = static_cast<bool*>(quick0);
  a.active = static_cast<bool*>(active);
  a.accepted = static_cast<bool*>(accepted);
  a.test_both = static_cast<bool*>(test_both);
  a.limit = static_cast<float*>(limit);
  a.W = W;
  a.Tmax = Tmax;
  a.n_perm = n_perm;
  edge_setup_kernel<<<unsigned(2 * W), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K15, after K8.  count and cnt int64 [2W] (K8's), degen and quick0 bool
// [2W], test_both bool, ti and tj int32, n int64 [W], alpha f32 scalar;
// outputs keep1 and keep2 bool [W], echunks int64 scalar.
extern "C" int cbs_edge_keep(const void* ctl, const void* count,
                             const void* cnt, const void* degen,
                             const void* quick0, const void* test_both,
                             const void* ti, const void* tj, const void* n,
                             const void* alpha, void* keep1, void* keep2,
                             void* echunks, int W, int n_perm, void* stream) {
  if (W <= 0) return 0;
  if (2 * W > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  EdgeKeepArgs a;
  a.ctl = static_cast<const i64*>(ctl);
  a.count = static_cast<const i64*>(count);
  a.cnt = static_cast<const i64*>(cnt);
  a.degen = static_cast<const bool*>(degen);
  a.quick0 = static_cast<const bool*>(quick0);
  a.test_both = static_cast<const bool*>(test_both);
  a.ti = static_cast<const int32_t*>(ti);
  a.tj = static_cast<const int32_t*>(tj);
  a.n = static_cast<const i64*>(n);
  a.alpha = static_cast<const float*>(alpha);
  a.keep1 = static_cast<bool*>(keep1);
  a.keep2 = static_cast<bool*>(keep2);
  a.echunks = static_cast<i64*>(echunks);
  a.W = W;
  a.n_perm = n_perm;
  edge_keep_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K16.  tab int64 [3 S + 8] and pending0 bool [S], updated in place; the
// level's rows [W]: fsel, contig, seg_lo, n int64, pending, analyzable,
// accepted, keep1, keep2 bool, ti, tj int32, needs, walked bool, wchunks
// int64; echunks int64 scalar.  S <= 1,024.
extern "C" int cbs_table(void* tab, void* pending0, const void* fsel,
                         const void* contig, const void* seg_lo,
                         const void* n, const void* pending,
                         const void* analyzable, const void* accepted,
                         const void* keep1, const void* keep2,
                         const void* ti, const void* tj, const void* needs,
                         const void* walked, const void* wchunks,
                         const void* echunks, int S, int W, int max_levels,
                         void* stream) {
  if (S > kThreads || W > S || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TableArgs a;
  a.tab = static_cast<i64*>(tab);
  a.pending0 = static_cast<bool*>(pending0);
  a.fsel = static_cast<const i64*>(fsel);
  a.contig = static_cast<const i64*>(contig);
  a.seg_lo = static_cast<const i64*>(seg_lo);
  a.n = static_cast<const i64*>(n);
  a.pending = static_cast<const bool*>(pending);
  a.analyzable = static_cast<const bool*>(analyzable);
  a.accepted = static_cast<const bool*>(accepted);
  a.keep1 = static_cast<const bool*>(keep1);
  a.keep2 = static_cast<const bool*>(keep2);
  a.ti = static_cast<const int32_t*>(ti);
  a.tj = static_cast<const int32_t*>(tj);
  a.needs = static_cast<const bool*>(needs);
  a.walked = static_cast<const bool*>(walked);
  a.wchunks = static_cast<const i64*>(wchunks);
  a.echunks = static_cast<const i64*>(echunks);
  a.S = S;
  a.W = W;
  a.max_levels = max_levels;
  table_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The nodes of a captured CUDA graph by type: out[0] kernels, out[1]
// memsets, out[2] the others, and out[3] the kernel nodes that keep the
// cooperative launch attribute.
extern "C" int cbs_graph_nodes(void* graph, int* out) {
  size_t count = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(count);
  if (count) err = cudaGraphGetNodes(g, nodes.data(), &count);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = out[1] = out[2] = out[3] = 0;
  for (size_t i = 0; i < count; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++out[type == cudaGraphNodeTypeKernel ? 0
          : type == cudaGraphNodeTypeMemset ? 1 : 2];
    if (type == cudaGraphNodeTypeKernel) {
      cudaLaunchAttributeValue v;
      err = cudaGraphKernelNodeGetAttribute(
          nodes[i], cudaLaunchAttributeCooperative, &v);
      if (err != cudaSuccess) return static_cast<int>(err);
      out[3] += v.cooperative != 0;
    }
  }
  return 0;
}

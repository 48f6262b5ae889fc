// The whole-recursion CBS engine's level body for Hopper: kernels K13-K16.
//
// canvas_tpu runs a CBS level as part of one device program, the
// lax.while_loop of canvas_tpu/ops/cbs_mega.py:_mega_recurse (:301-503).
// Around its kernels (B4 and K9-K11 for the arc scan and the tail, K7 and
// K8 for the walks and edge tests) the level body is XLA glue, which these
// kernels replace:
//
//   K13 (prologue_*_kernel) :335-355 and the tiers of :369-386: the
//       row's slot is the b-th of the table's slots with the pending ones
//       first, each part in slot order; the window gather from the
//       contig matrix and its centring (float64 sum, the mean rounded
//       once to f32), the float64 sum of squares, the constant-window
//       test, analyzable and n_eff, each tier's row mask, rows that
//       cannot be analysed zeroed, the float64 cumsum rounded to f32 at
//       each position, and t2, ti, tj at their values for a row in no
//       tier (0, 1, 2).  Two launches: phase 0, one block, selects every
//       row's slot once (a scan of the S <= 1,024 pending flags) and
//       writes the rows' table entries, and the final flags of rows whose
//       tiles have no work (not pending, or shorter than 2 al0); phase 1
//       takes a thread block cluster a row, a block a tile of
//       tile_width(W, Tmax) positions: the tile's sum and extrema of its
//       gathered values; after a cluster barrier, the row's mean and
//       analyzable from every tile's, the centred x; after another, the
//       cumsum carried in from the earlier tiles' centred sums, and tile
//       0 the row's tss.  Tiles of rows without work, or not
//       analyzable, write zeros.
//   K14 (decision rules) :397-413: canvas_tpu computes them in the
//       program of the tail probability they wrap, and so does the port:
//       K11's launch carries them (csrc/cbs_stats.cu, tail_decide_kernel).
//   K15 (edge_setup_kernel, and keep_table_kernel's first part) the edge
//       tests' set-up, _edge_tests :174-215 and :286-290 with the call's
//       preamble and epilogue :449-467.  Before K8, a block a (lane, tile)
//       of the 2W lanes at tile_width(2 W, Tmax): the tile of the lane's
//       shifted window xw and its float64 sums; the lane's last tile to
//       arrive adds them in tile order and computes accepted and test_both
//       of its row, tstat, degen, quick0 and active.  After K8 each lane's
//       keep flag and the rows' keep1 and keep2, and the level's edge
//       chunks, in the launch of K16.
//   K16 (keep_table_kernel) the table update :468-500, in one block with
//       K15's keep flags (the lanes' flags in its shared memory, 2W <=
//       1,024), holding the whole table of S <= 1,024 slots: split1 and
//       split2, the exclusive cumsum of the rows' children, the parents'
//       new ends, the appends (beyond S dropped), nseg, overflow, the run's
//       tally, the level count, and live: some slot pending, no overflow
//       and the level count under the engine's bound.  The tally's fifth
//       word adds the level's arc pairs, n (n + 1) / 2 over its pending
//       analysable rows: the pairs an unpruned arc scan evaluates.
//
// Every kernel, and every other kernel of the level, returns at once when
// live is false, so a level after the run's end changes nothing; the host
// replays captured levels in batches and reads live and the table after
// each batch (ops/cbs_mega.py).  The table and its control words live in
// one int64 buffer: seg_c, seg_lo and seg_hi [S] each, then nseg,
// overflow, live, the level count and the tally of walks accepted and
// rejected, walk chunks, edge chunks and arc pairs (K16's), and arc terms
// (B4's, csrc/arc_scan.cu).
//
// What bounds them on the H100.  K13 moves the level's windows: each row's
// n values gathered, x and its cumsum written, W x Tmax x 8 bytes (8 MB
// at the panel's [32, 32,768], 268 MB at the largest [512, 65,536]);
// K15's set-up writes the 2W windows (as many bytes).  Both are bytes at
// 3.35 TB/s.  A block a row (lane) left both on a block's latency chain:
// W blocks, a quarter of the card on the panel, each walking its row
// three times.  So both spread a row over tiles (tile_width: at most 16 a
// row, the widest of 128 to 4,096 positions that keeps at least 264
// blocks, twice the SMs), every load of a thread's positions issued
// before any is used.  K13's steps depend on one another through the
// data: the mean needs the whole row's sum, the cumsum's carry into a
// tile the earlier tiles' centred sums, and analyzable the row's centred
// extrema.  A row's tiles form one thread block cluster, which the card
// runs at once: they exchange their sums through distributed shared
// memory between cluster barriers, in one launch after the slot
// selection, their values kept in registers; analyzable comes from the
// gathered values' extrema before any value is centred, so that no tile
// writes what another must later zero.  Before the clusters, tiles that
// published their sums through global memory and waited on flags (two
// launches), and the same in one cooperative launch with a grid-wide
// barrier, were timed (PERF.md section 6); the clusters keep the level's
// cooperative nodes K7's, K8's and K11's.  The gathered values are read
// once, x and cs written once: K13's bytes.  K15's lane needs only its
// tiles' three sums, which its last tile to arrive (an atomic counter)
// adds; clusters of a lane's tiles were slower at the largest shape,
// where a cluster of 16 holds its SMs until its last block finishes.
// K15's keep and K16 touch a few kilobytes: a kernel node's latency is
// theirs, so they share one launch, and K14's rules (a few bytes a row)
// ride in K11's, as canvas_tpu's XLA program fuses them; a launch of
// their own would cost each a node's latency.
//
// Exactness.  The plain versions (ops/cbs_level_cuda.py) are the torch
// code the kernels replace.  Every f32 and float64 operation here is the
// correctly rounded one (intrinsics, nothing contracted into a multiply-
// add), divisions by the lengths are IEEE divisions, comparisons take the
// constants in f32 as torch does, and NaN propagates through clamps as in
// torch.clamp.  The float64 sums add in a fixed order, the same on every
// run and card, that is not torch's: a thread's positions of a tile in
// order (K13's gathered sums and K15: t, t + 128, ...; K13's centred sum,
// sum of squares and cumsum: a run of tile / 128 consecutive positions),
// the warp's butterfly (sums) or Hillis-Steele scan (the centred sum and
// the cumsum), the warps in order, then the tiles in tile order.  A
// float64 sum of n f32 values, or a prefix of it, is exact, and so the
// same in any order, only where the values' exponents span at most 29 -
// log2(n) bits (every partial sum then fits in 53 bits); K15's f32 squares
// span twice their values' range.  K13's sum of squares is not exact in
// general: each float64 product d * d carries up to 48 significant bits,
// so its partial sums round and their order can change the float64 sum's
// last bit, and with it the f32 result where that sum lies within an ulp
// of an f32 rounding boundary.  So bit-equality with the plain versions is
// shown only on the levels each kernel was held against, every level of
// the panel's, bench.py's CBS workload's and the engine's largest shape's
// runs (PERF.md section 6), not for every input; chip_smoke.py counts the
// rows that differ where the values' exponents span more.

#include <cfloat>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <vector>

namespace cg = cooperative_groups;

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

__device__ __forceinline__ float nan_f32() {
  return __int_as_float(0x7FC00000);
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

// ---------------------------------------------------------------------------
// Tiles of a row (K13, K15)
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 128;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kMinTile = 128;              // a position a thread
constexpr int kMaxTile = 4096;             // 32 positions a thread
constexpr int kMaxPer = kMaxTile / kTileThreads;
constexpr int kMaxTiles = 16;              // a row's tiles (K13: a cluster)
constexpr int kTargetBlocks = 264;         // twice the H100's 132 SMs

// The tile width for a launch over `rows` rows of T positions: the widest
// power of two from the narrowest that keeps a row within kMaxTiles tiles
// (at least kMinTile) up to min(kMaxTile, T) whose grid keeps at least
// kTargetBlocks blocks, else that narrowest.  A constant of the source
// and not of the card, so the float64 sums add in one order on every
// card.  ops/cbs_level_cuda.py's tile_layout mirrors it.
__host__ __device__ inline int tile_width(int rows, int T) {
  int w = kMinTile;
  while (w < kMaxTile && T / w > kMaxTiles) w *= 2;
  while (2 * w <= kMaxTile && 2 * w <= T &&
         static_cast<i64>(rows) * (T / (2 * w)) >= kTargetBlocks)
    w *= 2;
  return w;
}

// v summed over the warp's lanes by a butterfly (xor 16, 8, 4, 2, 1),
// float64 adds: every lane ends with the same value.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// v[0] + v[1] + ... + v[n - 1], added in that order.
__device__ __forceinline__ double in_order(const double* v, int n) {
  double s = v[0];
  for (int i = 1; i < n; ++i) s = __dadd_rn(s, v[i]);
  return s;
}

// Zeroes `tile` floats at p (16-byte aligned), a block of kTileThreads.
__device__ __forceinline__ void zero_tile(float* p, int tile) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < tile / 4; i += kTileThreads)
    q[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// A tile's position j in shared memory, a word skipped every 32, so that
// the threads' runs of per = 1 to 32 positions fall in distinct banks.
__device__ __forceinline__ int skew(int j) { return j + (j >> 5); }

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
  int S, W, Tmax, al0, tiers, tile, tiles;
};

// Phase 0, one block of kThreads: row b of the level takes the b-th slot
// with the pending slots first, each part in slot order (a block scan of
// the S <= kThreads pending flags, a thread a slot).  The row's slot,
// contig, start, length and pending flag, t2, ti, tj at a row-in-no-
// tier's values, and for a row whose tiles have no work (not pending, or
// shorter than 2 al0) its final analyzable, n_eff, tss and tier flags.
__device__ void prologue_rows(const PrologueArgs& a, int* sh) {
  const int s = threadIdx.x;
  const bool pend = s < a.S && a.pending0[s];
  int total;
  const int rank = block_exclusive_scan<int>(pend ? 1 : 0, sh, &total);
  const int b = pend ? rank : total + (s - rank);
  if (s >= a.S || b >= a.W) return;
  const i64 sc = a.tab[s], lo = a.tab[a.S + s], hi = a.tab[2 * a.S + s];
  const i64 n = hi - lo;
  a.fsel[b] = s;
  a.contig[b] = sc < 0 ? 0 : sc;
  a.seg_lo[b] = lo;
  a.n[b] = n;
  a.pending[b] = pend;
  a.t2[b] = 0.0f;
  a.ti[b] = 1;
  a.tj[b] = 2;
  if (!(pend && n >= 2 * i64(a.al0))) {
    a.analyzable[b] = false;
    a.n_eff[b] = 2;
    a.tss[b] = 0.0f;
    for (int k = 0; k < a.tiers; ++k) a.in_tier[size_t(k) * a.W + b] = false;
  }
}

// Row b as phase 0 left it.
struct Row {
  const float* src;        // the row's window in the contig matrix
  i64 n;
  int nv;                  // positions gathered, n within [0, Tmax]
  bool work;               // pending and at least 2 al0 long
};

__device__ __forceinline__ Row row_of(const PrologueArgs& a, int b) {
  Row r;
  r.n = __ldcg(a.n + b);
  r.nv = r.n < 0 ? 0 : (r.n > a.Tmax ? a.Tmax : int(r.n));
  r.src = a.contigs + size_t(__ldcg(a.contig + b)) * a.Tmax +
          __ldcg(a.seg_lo + b);
  r.work = __ldcg(reinterpret_cast<const unsigned char*>(a.pending) + b) &&
           r.n >= 2 * i64(a.al0);
  return r;
}

// The tile's gathered values, position j = t + i kTileThreads of the tile
// in v[i] (zero past the row's n), every load issued before any is used.
__device__ __forceinline__ void gather(const Row& r, int j0, int lim,
                                       int per, float* v) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int j = t + i * kTileThreads;
    v[i] = i < per && j < lim ? __ldg(r.src + j0 + j) : 0.0f;
  }
}

// Phase 1's shared memory; the cluster's other blocks read the tile's
// results (sum to sq) here.
struct TileShared {
  float x[kMaxTile + kMaxTile / 32];   // the centred tile, skewed
  double w[kTileWarps];                // the warps' sums, then scan totals
  double q[kTileWarps];                // the warps' sums of squares
  float mx[kTileWarps], mn[kTileWarps];
  double d[kMaxTiles];                 // the row's tiles' values, gathered
  float2 e[kMaxTiles];
  double sum;                          // the gathered values' sum
  float2 ext;                          // their extrema (max NaN: NaN or inf)
  double csum;                         // the centred values' sum
  double sq;                           // their sum of squares
  double carry;
  float mean;
  int analyzable;
};

// Phase 1, a cluster a row with work, a block a tile of it (rank k):
//   - the tile's gathered values (zero past the row's n), kept in
//     registers: their float64 sum (a thread's positions t, t + 128, ...
//     in order, the warp's butterfly, the warps in order), their extrema
//     and whether one is NaN or infinite;
//   - after a cluster barrier, the row's mean, its tiles' sums in tile
//     order rounded once to f32, and analyzable from their extrema: a
//     centred value is fl(v - mean), non-decreasing in v, so the centred
//     window's extrema are fl(max - mean) and fl(min - mean), and a NaN or
//     an infinity among the values makes a centred value NaN (the mean is
//     then infinite or NaN), which torch's amax propagates.  Tile 0
//     writes the row's analyzable, n_eff and tier flags (tss 0 where it
//     is not analyzable), and a row that is not analyzable gets its x and
//     cs tiles zeroed;
//   - otherwise the centred values into x and shared memory; a thread's
//     run of per = tile / kTileThreads consecutive positions: its float64
//     sum and sum of squares; the warp's Hillis-Steele scan of the run
//     sums (lane l adds lane l - o's at o = 1, 2, 4, 8, 16) and butterfly
//     of the squares, the warps in order: the tile's centred sum (the
//     warps' scan totals in order) and sum of squares; after a cluster
//     barrier, the carry into the tile, the earlier tiles' centred sums
//     in tile order (tile 0: the row's tss, every tile's sum of squares
//     in tile order); the cumsum before a run is the carry, then the
//     earlier warps' totals (in order), then the earlier lanes' (each
//     only where there is one), rounded to f32 at each position.
// A row without work is a cluster whose blocks zero their x and cs tiles
// and leave.  No block leaves while another may read its shared memory.
__global__ void __launch_bounds__(kTileThreads) prologue_tile_kernel(
    PrologueArgs a) {
  __shared__ TileShared sm;
  if (dead(a.ctl)) return;               // every block: no barrier is met
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x / a.tiles, k = blockIdx.x % a.tiles;
  const int j0 = k * a.tile, per = a.tile / kTileThreads;
  const Row r = row_of(a, b);
  float* xr = a.x + size_t(b) * a.Tmax + j0;
  float* cr = a.cs + size_t(b) * a.Tmax + j0;
  if (!r.work) {                         // the whole cluster
    zero_tile(xr, a.tile);
    zero_tile(cr, a.tile);
    return;
  }
  const int lim = r.nv - j0;
  float v[kMaxPer];
  gather(r, j0, lim, per, v);
  {
    double s = 0.0;
    float mx = -FLT_MAX, mn = FLT_MAX;
    bool bad = false;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      if (i >= per) break;
      s = __dadd_rn(s, double(v[i]));
      if (t + i * kTileThreads < lim) {
        bad = bad || !isfinite(v[i]);
        mx = fmaxf(mx, v[i]);
        mn = fminf(mn, v[i]);
      }
    }
    s = warp_sum(s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    }
    bad = __any_sync(kFull, bad);
    if (lane == 0) {
      sm.w[warp] = s;
      sm.mx[warp] = bad ? nan_f32() : mx;
      sm.mn[warp] = mn;
    }
    __syncthreads();
    if (t == 0) {
      for (int w = 0; w < kTileWarps; ++w) {
        bad = bad || sm.mx[w] != sm.mx[w];
        mx = fmaxf(mx, sm.mx[w]);
        mn = fminf(mn, sm.mn[w]);
      }
      sm.sum = in_order(sm.w, kTileWarps);
      sm.ext = make_float2(bad ? nan_f32() : mx, mn);
    }
  }
  cluster.sync();
  if (warp == 0) {
    // a lane a tile: the row's tiles' sums and extrema
    for (int i = lane; i < a.tiles; i += 32) {
      sm.d[i] = *cluster.map_shared_rank(&sm.sum, i);
      sm.e[i] = *cluster.map_shared_rank(&sm.ext, i);
    }
    __syncwarp();
    if (lane == 0) {
      const float mean = __double2float_rn(__ddiv_rn(
          in_order(sm.d, a.tiles), double(r.n < 1 ? 1 : r.n)));
      bool bad = false;
      float mx = -FLT_MAX, mn = FLT_MAX;
      for (int i = 0; i < a.tiles; ++i) {
        bad = bad || sm.e[i].x != sm.e[i].x;
        mx = fmaxf(mx, sm.e[i].x);
        mn = fminf(mn, sm.e[i].y);
      }
      // the centred window's extrema, within [-FLT_MAX, FLT_MAX] as the
      // plain version's fill values bound them
      const bool an = !bad && fmaxf(__fsub_rn(mx, mean), -FLT_MAX) >
                                  fminf(__fsub_rn(mn, mean), FLT_MAX);
      sm.mean = mean;
      sm.analyzable = an;
      if (k == 0) {
        const i64 ne = an ? r.n : 2;
        a.analyzable[b] = an;
        a.n_eff[b] = ne;
        if (!an) a.tss[b] = 0.0f;
        for (int i = 0; i < a.tiers; ++i) {
          const i64 w = i64(kMinTier) << i, prev = i ? w / 2 : 0;
          a.in_tier[size_t(i) * a.W + b] = an && ne <= w && ne > prev;
        }
      }
    }
  }
  __syncthreads();
  if (!sm.analyzable) {                  // the whole cluster
    zero_tile(xr, a.tile);
    zero_tile(cr, a.tile);
    cluster.sync();
    return;
  }
  const float mean = sm.mean;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    if (i >= per) break;
    const int j = t + i * kTileThreads;
    const float u = j < lim ? __fsub_rn(v[i], mean) : 0.0f;
    xr[j] = u;
    sm.x[skew(j)] = u;
  }
  __syncthreads();
  const int base = t * per;
  double loc = double(sm.x[skew(base)]);
  double q = __dmul_rn(loc, loc);
  for (int i = 1; i < per; ++i) {
    const double d = double(sm.x[skew(base + i)]);
    loc = __dadd_rn(loc, d);
    q = __dadd_rn(q, __dmul_rn(d, d));
  }
  double inc = loc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = __dadd_rn(inc, u);
  }
  const double ex = __shfl_up_sync(kFull, inc, 1);
  q = warp_sum(q);
  if (lane == 31) {
    sm.w[warp] = inc;
    sm.q[warp] = q;
  }
  __syncthreads();
  if (t == 0) {
    sm.csum = in_order(sm.w, kTileWarps);
    sm.sq = in_order(sm.q, kTileWarps);
  }
  cluster.sync();
  if (warp == 0) {
    // a lane a tile: the earlier tiles' centred sums (tile 0: every
    // tile's sum of squares)
    const int n_read = k == 0 ? a.tiles : k;
    for (int i = lane; i < n_read; i += 32)
      sm.d[i] = k == 0 ? *cluster.map_shared_rank(&sm.sq, i)
                       : *cluster.map_shared_rank(&sm.csum, i);
    __syncwarp();
    if (lane == 0) {
      if (k == 0)
        a.tss[b] = __double2float_rn(in_order(sm.d, a.tiles));
      else
        sm.carry = in_order(sm.d, k);
    }
  }
  __syncthreads();
  bool has = k > 0;
  double pre = has ? sm.carry : 0.0;
  if (warp > 0) {
    const double wo = in_order(sm.w, warp);
    pre = has ? __dadd_rn(pre, wo) : wo;
    has = true;
  }
  if (lane > 0) {
    pre = has ? __dadd_rn(pre, ex) : ex;
    has = true;
  }
  double acc = 0.0;
  for (int i = 0; i < per; ++i) {
    const double u = double(sm.x[skew(base + i)]);
    acc = i ? __dadd_rn(acc, u) : u;
    sm.x[skew(base + i)] = __double2float_rn(has ? __dadd_rn(pre, acc) : acc);
  }
  __syncthreads();
  float4* c4 = reinterpret_cast<float4*>(cr);
  for (int i = t; i < a.tile / 4; i += kTileThreads)
    c4[i] = make_float4(sm.x[skew(4 * i)], sm.x[skew(4 * i + 1)],
                        sm.x[skew(4 * i + 2)], sm.x[skew(4 * i + 3)]);
  cluster.sync();
}

__global__ void __launch_bounds__(kThreads) prologue_rows_kernel(
    PrologueArgs a) {
  __shared__ int sh[kWarps + 1];
  if (dead(a.ctl)) return;
  prologue_rows(a, sh);
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
  double* part;            // [2W, tiles, 3] the tiles' sums
  unsigned* count;         // [2W] tiles arrived, zero between launches
  int W, Tmax, n_perm, tile, tiles;
};

// Lane l's statistics from its window's float64 sums s1 (its first n1
// positions), s and q (of the f32 squares), by one thread.
__device__ void edge_stats(const EdgeSetupArgs& a, int l, double s1,
                           double s, double q) {
  const int r = l % a.W, e = l / a.W;
  const i64 ti = a.ti[r], tj = a.tj[r], n = a.n[r];
  const i64 wn = e ? n - ti : tj;
  const i64 n1 = e ? tj - ti : ti;
  const i64 n2 = wn - n1;
  const bool accepted = a.trivial[r] || a.walked[r];
  const bool test_both = accepted && !(tj >= n) && !(ti <= 0);
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

// Lane l = e W + r tests edge e + 1 of row r: edge 1 the split at ti
// inside x[0, tj), edge 2 the split at tj inside x[ti, n), shifted left
// by ti.  A block a (lane, tile): the tile of the lane's window xw (zero
// past wn; a tile wholly past it reads nothing), and its float64 sums s1,
// s and q reduced together (a thread's positions t, t + kTileThreads, ...
// in order, the warps' butterflies, the warps in order).  The lane's last
// tile to arrive (an atomic counter, left zero) adds the lane's tile sums
// in tile order and computes its statistics.
__global__ void __launch_bounds__(kTileThreads) edge_setup_kernel(
    EdgeSetupArgs a) {
  __shared__ double sh[3 * kTileWarps];
  __shared__ double s_part[3 * kMaxTiles];
  __shared__ bool s_last;
  if (dead(a.ctl)) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int l = blockIdx.x / a.tiles, k = blockIdx.x % a.tiles;
  const int r = l % a.W, e = l / a.W, T = a.Tmax;
  const int j0 = k * a.tile, per = a.tile / kTileThreads;
  const i64 ti = a.ti[r], tj = a.tj[r], n = a.n[r];
  const i64 wn = e ? n - ti : tj;
  const i64 n1 = e ? tj - ti : ti;
  const i64 off = e ? (ti < 0 ? 0 : (ti > T ? T : ti)) : 0;
  const i64 lim = wn - j0;
  float* out = a.xw + size_t(l) * T + j0;
  double s1 = 0.0, s = 0.0, q = 0.0;
  if (lim <= 0) {
    zero_tile(out, a.tile);
  } else {
    const float* src = a.x + size_t(r) * T + off + j0;
    const i64 end = T - off - j0;      // positions left in the row
    float v[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int j = t + i * kTileThreads;
      v[i] = i < per && j < lim && j < end ? __ldg(src + j) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      if (i >= per) break;
      const int j = t + i * kTileThreads;
      out[j] = v[i];
      const double d = double(v[i]);
      if (j0 + j < n1) s1 = __dadd_rn(s1, d);
      s = __dadd_rn(s, d);
      q = __dadd_rn(q, double(__fmul_rn(v[i], v[i])));
    }
  }
  s1 = warp_sum(s1);
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) {
    sh[warp] = s1;
    sh[kTileWarps + warp] = s;
    sh[2 * kTileWarps + warp] = q;
  }
  __syncthreads();
  if (t == 0) {
    s1 = in_order(sh, kTileWarps);
    s = in_order(sh + kTileWarps, kTileWarps);
    q = in_order(sh + 2 * kTileWarps, kTileWarps);
    if (a.tiles == 1) {
      edge_stats(a, l, s1, s, q);
    } else {
      double* p = a.part + (size_t(l) * a.tiles + k) * 3;
      p[0] = s1;
      p[1] = s;
      p[2] = q;
      __threadfence();
      s_last = atomicAdd(a.count + l, 1u) == unsigned(a.tiles - 1);
    }
  }
  __syncthreads();
  if (a.tiles == 1 || !s_last) return;
  __threadfence();
  // the lane's tile sums, loaded together, then added in tile order
  const double* pl = a.part + size_t(l) * a.tiles * 3;
  for (int i = t; i < 3 * a.tiles; i += kTileThreads)
    s_part[i] = __ldcg(pl + i);
  __syncthreads();
  if (t != 0) return;
  s1 = s_part[0];
  s = s_part[1];
  q = s_part[2];
  for (int i = 1; i < a.tiles; ++i) {
    s1 = __dadd_rn(s1, s_part[3 * i]);
    s = __dadd_rn(s, s_part[3 * i + 1]);
    q = __dadd_rn(q, s_part[3 * i + 2]);
  }
  a.count[l] = 0;
  edge_stats(a, l, s1, s, q);
}

// ---------------------------------------------------------------------------
// K15's keep flags and K16, one block
// ---------------------------------------------------------------------------

struct KeepTableArgs {
  i64* tab;                // seg_c, seg_lo, seg_hi [S] each, then ctl
  bool* pending0;          // [S]
  const i64* count;        // K8's, [2W]
  const i64* cnt;
  const bool* degen;       // K15's, [2W]
  const bool* quick0;
  const float* alpha;      // scalar
  const i64* fsel;         // [W] the level's rows from here
  const i64* contig;
  const i64* seg_lo;
  const i64* n;
  const bool* pending;
  const bool* analyzable;
  const bool* accepted;
  const bool* test_both;
  const int32_t* ti;
  const int32_t* tj;
  const bool* needs;
  const bool* walked;      // K7's
  const i64* wchunks;      // K7's
  bool* keep1;             // [W] outputs, for the checks
  bool* keep2;
  i64* echunks;            // scalar
  int S, W, n_perm, max_levels;
};

// K15 after K8: each lane's keep flag (into shared memory), the rows'
// keep1 and keep2 and the level's edge chunks (written out too); then, one
// barrier later, K16 from them: split1 and split2, the children's slots by
// a block scan, the parents' new ends, the appends, nseg, overflow, the
// tally (the level's arc pairs too), the level count and live.
__global__ void __launch_bounds__(kThreads) keep_table_kernel(
    KeepTableArgs a) {
  __shared__ bool s_keep[kThreads];
  __shared__ int s_scan[kWarps + 1];
  __shared__ i64 s_i[kWarps];
  i64* ctl = a.tab + 3 * a.S;
  if (dead(ctl)) return;
  const int t = threadIdx.x, S = a.S, L = 2 * a.W;
  i64 c = 0;
  if (t < L) {
    const float p = __fdiv_rn(__ll2float_rn(a.count[t]), float(a.n_perm));
    s_keep[t] = a.degen[t] ? false : (a.quick0[t] ? true : p <= *a.alpha);
    c = a.cnt[t];
  }
  const i64 echunks = block_sum_i64(c, s_i);      // ends with a barrier
  if (t == 0) *a.echunks = echunks;
  const bool row = t < a.W;
  bool split1 = false, split2 = false;
  i64 lo = 0, n = 0, first_cut = 0, second_cut = 0;
  int extra = 0;
  if (row) {
    const i64 ti = a.ti[t], tj = a.tj[t];
    n = a.n[t];
    lo = a.seg_lo[t];
    const bool at_end = tj >= n, at_start = ti <= 0;
    const bool tb = a.test_both[t];
    const bool keep1 = tb ? s_keep[t] : at_end && !at_start;
    const bool keep2 = tb ? s_keep[a.W + t] : at_start && !at_end;
    a.keep1[t] = keep1;
    a.keep2[t] = keep2;
    const bool acc = a.accepted[t];
    split1 = acc && keep1;
    split2 = acc && keep2 && tj < n;
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
    const i64 sc = a.contig[t];
    if (at < S) {
      a.tab[at] = sc;
      a.tab[S + at] = lo + first_cut;
      a.tab[2 * S + at] = lo + second_cut;
      a.pending0[at] = true;
    }
    if (extra == 2 && at + 1 < S) {
      a.tab[at + 1] = sc;
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
  const i64 pairs = block_sum_i64(
      row && a.pending[t] && a.analyzable[t] ? n * (n + 1) / 2 : 0, s_i);
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
    ctl[kTally + 3] += echunks;
    ctl[kTally + 4] += pairs;
    ctl[kLive] = any && !over && level < a.max_levels;
  }
}

}  // namespace

// The tile width and tiles a row of a launch over `rows` rows of Tmax
// positions (K13: rows = W; K15: rows = 2 W), into out[0] and out[1].
extern "C" int cbs_level_layout(int rows, int Tmax, int* out) {
  out[0] = tile_width(rows, Tmax);
  out[1] = Tmax / out[0];
  return 0;
}

// K13, two launches.  contigs f32 [C, Tmax]; tab int64 [3 S + 9] (the
// table, then ctl); pending0 bool [S]; outputs [W] (x and cs [W, Tmax],
// in_tier [tiers, W]).  S <= 1,024, W <= S, Tmax a multiple of 1,024 of
// at most kMaxTiles tiles (cbs_level_layout(W, Tmax)).
extern "C" int cbs_prologue(const void* contigs, const void* tab,
                            const void* pending0, void* fsel, void* contig,
                            void* seg_lo, void* n, void* pending,
                            void* analyzable, void* n_eff, void* x, void* tss,
                            void* cs, void* in_tier, void* t2, void* ti,
                            void* tj, int S, int W, int Tmax, int al0,
                            int tiers, void* stream) {
  if (W <= 0) return 0;
  const int tile = tile_width(W, Tmax);
  if (S > kThreads || W > S || Tmax % kThreads || tiers < 1 ||
      Tmax / tile > kMaxTiles)
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
  a.tile = tile;
  a.tiles = Tmax / tile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  prologue_rows_kernel<<<1, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a cluster of the tiles a row (its blocks run at once and read one
  // another's shared memory); more than 8 is a non-portable size
  if (a.tiles > 8) {
    err = cudaFuncSetAttribute(prologue_tile_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = unsigned(a.tiles);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(W * a.tiles));
  cfg.blockDim = dim3(kTileThreads);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(prologue_tile_kernel), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K15, before K8.  x f32 [W, Tmax], n int64, ti and tj int32, trivial and
// walked bool [W], alpha f32 scalar; outputs xw f32 [2W, Tmax], wn and m1
// int64, xbar and ostat f32, degen, quick0 and active bool [2W], accepted
// and test_both bool [W], limit f32 scalar; scratch part float64 [2W,
// tiles, 3] (cbs_level_layout(2 W, Tmax)) and count u32 [2W], zero and
// left zero.  2 W <= 1,024.
extern "C" int cbs_edge_setup(const void* ctl, const void* x, const void* n,
                              const void* ti, const void* tj,
                              const void* trivial, const void* walked,
                              const void* alpha, void* xw, void* wn,
                              void* m1, void* xbar, void* ostat, void* degen,
                              void* quick0, void* active, void* accepted,
                              void* test_both, void* limit, void* part,
                              void* count, int W, int Tmax, int n_perm,
                              void* stream) {
  if (W <= 0) return 0;
  const int tile = tile_width(2 * W, Tmax);
  if (2 * W > kThreads || Tmax % kThreads || Tmax / tile > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.part = static_cast<double*>(part);
  a.count = static_cast<unsigned*>(count);
  a.W = W;
  a.Tmax = Tmax;
  a.n_perm = n_perm;
  a.tile = tile;
  a.tiles = Tmax / tile;
  edge_setup_kernel<<<unsigned(2 * W * a.tiles), kTileThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K15 after K8 and K16, one launch.  tab int64 [3 S + 9] and pending0
// bool [S], updated in place; K8's count and cnt int64 [2W], K15's degen
// and quick0 bool [2W], alpha f32 scalar; the level's rows [W]: fsel,
// contig, seg_lo, n int64, pending, analyzable, accepted, test_both bool,
// ti, tj int32, needs, walked bool, wchunks int64; outputs keep1 and keep2
// bool [W] and echunks int64 scalar.  2 W <= 1,024, W <= S <= 1,024.
extern "C" int cbs_keep_table(void* tab, void* pending0, const void* count,
                              const void* cnt, const void* degen,
                              const void* quick0, const void* alpha,
                              const void* fsel, const void* contig,
                              const void* seg_lo, const void* n,
                              const void* pending, const void* analyzable,
                              const void* accepted, const void* test_both,
                              const void* ti, const void* tj,
                              const void* needs, const void* walked,
                              const void* wchunks, void* keep1, void* keep2,
                              void* echunks, int S, int W, int n_perm,
                              int max_levels, void* stream) {
  if (W <= 0 || 2 * W > kThreads || W > S || S > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  KeepTableArgs a;
  a.tab = static_cast<i64*>(tab);
  a.pending0 = static_cast<bool*>(pending0);
  a.count = static_cast<const i64*>(count);
  a.cnt = static_cast<const i64*>(cnt);
  a.degen = static_cast<const bool*>(degen);
  a.quick0 = static_cast<const bool*>(quick0);
  a.alpha = static_cast<const float*>(alpha);
  a.fsel = static_cast<const i64*>(fsel);
  a.contig = static_cast<const i64*>(contig);
  a.seg_lo = static_cast<const i64*>(seg_lo);
  a.n = static_cast<const i64*>(n);
  a.pending = static_cast<const bool*>(pending);
  a.analyzable = static_cast<const bool*>(analyzable);
  a.accepted = static_cast<const bool*>(accepted);
  a.test_both = static_cast<const bool*>(test_both);
  a.ti = static_cast<const int32_t*>(ti);
  a.tj = static_cast<const int32_t*>(tj);
  a.needs = static_cast<const bool*>(needs);
  a.walked = static_cast<const bool*>(walked);
  a.wchunks = static_cast<const i64*>(wchunks);
  a.keep1 = static_cast<bool*>(keep1);
  a.keep2 = static_cast<bool*>(keep2);
  a.echunks = static_cast<i64*>(echunks);
  a.S = S;
  a.W = W;
  a.n_perm = n_perm;
  a.max_levels = max_levels;
  keep_table_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
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

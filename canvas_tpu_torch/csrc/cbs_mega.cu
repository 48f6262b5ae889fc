// The whole-recursion CBS engine's walk and edge-test kernels, K7 and K8,
// for Hopper.
//
// K7 (cbs_walk) replaces canvas_tpu/ops/cbs_mega.py:419-448, the level's
// walk lax.while_loop, with _chunk_stats (:142-167) and through it
// cbs_device.py's _device_perms (:595), _htmax_core (:608) and
// _tmax_full_core (:636), all XLA.  K8 (cbs_edge) replaces the edge-test
// lax.while_loop of _edge_tests (:217-285), XLA too.  K12 (cbs_perm)
// replaces the frontier engine's permutation chunks, cbs_device.py's
// _perm_kernel (:660-671) and _level_kernel's chunk 0 (:565-585), with K7's
// device code.  Per level the port launches K7 and K8 once, and the loops
// that canvas_tpu runs on its device run here, with nothing read back
// between:
//
//   K7, per walking row r (n bins, tier width npad = the smallest power of
//   two >= max(n, 1024)): the row's key is fold_in(fold_in(fold_in(key0,
//   c_r), lo_r), n_r) of the level key and the row's contig, start and
//   length, derived here.  Chunk c draws under fold_in(key, c) the uniform
//   u[p][j] = bits(p * npad + j) for the P = 512 permutations p and the
//   positions j < n (the padding draws 2.0 in canvas_tpu and sorts last, so
//   only real positions are drawn), orders each permutation's positions by
//   (u, j), takes the cumsum of x in that order (float64, rounded to f32 at
//   each position), the hybrid or the full max-t statistic, and then walks
//   the row's boundary over the 512 statistics in order (_walk_update),
//   until the row is decided.
//   K8, per active lane l of L = e R lanes over R rows (wn values, tier
//   width of wn, subset size m1): the lane's key is fold_in(row key,
//   7777 + l / R) of its row l % R; chunk c draws under fold_in(key, c)
//   the 32-bit keys bits(p * npad + j), j < wn, sums (float64) the values
//   of each permutation's m1 smallest keys, ties by index, and counts the
//   statistics |sum / m1 - xbar| >= ostat among the first n_perm - done
//   permutations, until the count passes limit or n_perm are done.
//
//   K12, per masked row r of S (n bins, the launch's bucket width npad,
//   which may be 8 to 65,536, and the row's given threefry key): the row's
//   P permutations of one chunk, P = 512 or 768, drawn as K7 draws them at
//   the counters p * npad + j, and their hybrid or full max-t statistics
//   (full: lags bounded by max_len, at least every full row's n); the
//   other rows' statistics are zero.  No walk: the items of the launch go
//   to the groups, and the launch is an ordinary one.  Its groups come
//   from the launch's items, counted on the card (perm_layout): a block's
//   share of the nact x P items in as few rounds as its cap allows, by the
//   fewest groups that take it in those rounds.  The cap is the groups
//   whose slices hold two buffers where those take the share in one round
//   or the width is 8,192 or more, else K7's groups of the width; a slice
//   with two buffers keeps the draws for the scatter (the cipher runs once
//   a position, not twice), and from 8,192 on the row's values are copied
//   by cp.async into the draw buffer the scatter has freed while the
//   buckets sort, so the cumsum gathers them from shared memory.  One row
//   at P 768 on 132 blocks: 6 groups of 5 warps with two buffers up to
//   4,096, 3 of 10 warps at 8,192.  Its shared memory holds no walk state
//   and no keys (2 KB before the slices, K7's 17 KB), so that 6 groups
//   hold two buffers at 4,096.
//
// A row's chunk c depends on its own key and counter alone, and every row
// still walking takes its next chunk in each iteration, so a row that walks
// in iteration c is at chunk c.
//
// Shape of a launch.  One block of 1024 threads on each SM (the grid is the
// SM count times the blocks that the occupancy calculator allows at this
// block's 227 KB of shared memory, one), all resident: a cooperative
// launch.  Each iteration:
//   1. every block lists the rows still walking from its own copy of the
//      flags, and derives each listed row's key;
//   2. the (row, permutation) items of their next chunks go to groups of
//      32 / k warps, each group with its slice of the shared memory and its
//      own named barrier (bar.sync id, size), so that no group waits on
//      another and several permutations are in flight on each SM.  K7:
//      k is set by the widest listed row's tier, for one buffer an item
//      (8 groups at tiers 1,024-4,096, 5 at 8,192, 2 at 16,384, 1 above),
//      and each group runs its items one after another with no block
//      barrier; K8's lanes with m1 <= 32 take a warp an item, with no
//      barrier at all, and several chunks of each lane at once (up to 4,
//      enough for a warp an item), its larger subsets units of k items
//      (8 groups at 1,024-4,096, 5 at 8,192, 2 at 16,384, 1 above);
//   3. one grid-wide barrier, then every block runs each listed row's
//      update (a warp a row) from the chunk's results and the row state of
//      the iteration's parity; block 0 alone writes the next parity's state
//      and the outputs.  Every block reaches the same flags, so the next
//      iteration needs no second barrier.
// The loop ends when no row walks.
//
// What bounds it.  Per item the work is the n draws of a 20-round integer
// cipher, a sort (K7, K12) or a selection (K8), and for K7 the statistic:
// (kmax - al0 + 1) * n terms, each a subtraction and a |.|-maximum.  All of
// it is integer and f32 issue slots on data in registers and shared memory;
// device memory sees only x (L2-resident, gathered once in permuted order)
// and the results, so the kernels are bound by their operations, the
// draws' integer ones first.  An item's phases end in barriers, and much
// of its time is spent waiting at them, so the design keeps many items in
// flight on each SM:
//   K7 counts its groups for one buffer of positions an item (the scatter
//   then draws each key again) and keeps a second buffer of draws only
//   where a slice has room for it: more groups beat drawing once.  The
//   widest tier, 65,536, sorts in a per-block slab of device memory.  The
//   order: u = m * 2^-23 with m the draw's top 23 bits, so the order (u, j)
//   is the order of the 39-bit words (m, j).  A counting pass over the top
//   B bits of m (B = log2(npad) - 2, 7..13, so about 4 positions a bucket)
//   places each position in its bucket, as the 32-bit word (low 23 - B
//   bits of m, j); a sort in each bucket finishes it, by a network of 19
//   compare-exchanges in registers for buckets of up to 8 words, by
//   insertion for larger ones.
//   x is gathered once over the words, 8 loads in flight a thread (from
//   shared memory where K12 stages the row), and the cumsum runs in place.
//   The statistic takes 8 lags at a time over runs of 5 positions a
//   thread, each value read once into registers; the 8
//   lags' warp maxima come from one butterfly of 9 shuffles (each step
//   halving the lags a lane holds) and go to shared memory by atomic
//   maxima, and the lag terms are computed a thread a lag and reduced
//   with a maximum.
//   K8 with m1 <= 32 streams the draws through a warp, four a lane at a
//   time: the lanes hold the m1 smallest (key, j) so far as a sorted list,
//   one a lane, and a draw below the list's last entry is inserted by one
//   ballot and one shuffle, so no key is stored.  Larger m1 keeps the keys
//   in shared memory (a slab at 65,536) and finds the m1-th smallest by
//   three digit passes of 11, 11 and 10 bits with group-local histograms,
//   then the index of the last tie by atomic minima; the subset is every
//   (key, j) up to that one.
//
// Exactness.  The draws are ops/threefry.py's bit for bit, and so are the
// keys.  The statistic takes every f32 product, quotient and difference
// with the correctly rounded intrinsics (__fmul_rn, __fdiv_rn, __fsub_rn,
// __fadd_rn), nothing contracted, in the plain version's order: w = n / (L
// (n - L)), the term (w D) D with D the maximum |d| over the lag's arcs,
// then the tss rule and best / ((tssv - best) / (n - 2)).  Maxima and
// counts do not depend on their order.  The float64 cumsum and subset sum
// add the same values as the plain version but in another association
// (per-thread runs, then a tree); float64 sums of these f32 values round
// to the same f32 unless the exact sum lies within a few float64 ulps of
// an f32 rounding boundary.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 512;               // permutations a chunk (P_CHUNK)
constexpr int kMaxRows = 1024;        // rows (lanes) a launch
constexpr int kSmemBytes = 232448;    // 227 KB, the most a block can have
constexpr int kMaxGroups = 8;         // groups a block (4 warps or more)
constexpr int kSmallM1 = 32;          // K8: subsets a warp streams
constexpr int kLagTile = 256;         // lags whose maxima are gathered at once
constexpr int kLagBlock = 8;          // lags a thread takes together
constexpr int kBatch = 8;             // K7: loads issued before their stores
constexpr int kRun = 5;               // positions a thread takes together
                                      // (odd: a warp's runs in distinct banks)
constexpr int kSlabTier = 65536;      // tiers held in device memory
constexpr int kDigitBins = 2048;      // K8's widest digit, 11 bits
constexpr int kMaxDepth = 4;          // K8: chunks a lane takes at once
constexpr uint32_t kEdgeTag = 7777u;  // edge e of a row folds in 7777 + e
constexpr unsigned kFull = 0xFFFFFFFFu;

typedef long long i64;

enum Mode { kDouble = 0, kSingle = 1, kSlab = 2 };

// ---------------------------------------------------------------------------
// Threefry-2x32 (20 rounds), as ops/threefry.py and jax.random
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2) ? 17 : 13, r1 = (i % 2) ? 29 : 15;
    const int r2 = (i % 2) ? 16 : 26, r3 = (i % 2) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
  return make_uint2(x0, x1);
}

// jax.random.fold_in(key, d): the cipher on the counter pair (0, d).
__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t d) {
  return threefry(key.x, key.y, 0u, d);
}

// The 32 bits jax.random.bits draws at flat counter c of its shape.
__device__ __forceinline__ uint32_t draw_bits(uint2 key, uint64_t c) {
  const uint2 o = threefry(key.x, key.y, uint32_t(c >> 32), uint32_t(c));
  return o.x ^ o.y;
}

// Row r's key: fold_in(fold_in(fold_in(key0, c_r), lo_r), n_r), each datum
// taken as uint32 (ops/threefry.py's fold_in).
__device__ uint2 row_key(const i64* key0, const i64* c, const i64* lo,
                         const i64* n, int r) {
  uint2 k = make_uint2(uint32_t(key0[0]), uint32_t(key0[1]));
  k = fold_in(k, uint32_t(c[r]));
  k = fold_in(k, uint32_t(lo[r]));
  return fold_in(k, uint32_t(n[r]));
}

// Lane l's edge-test key over R rows: its row's key folded with 7777 + l / R.
__device__ uint2 lane_key(const i64* key0, const i64* c, const i64* lo,
                          const i64* n, int R, int l) {
  return fold_in(row_key(key0, c, lo, n, l % R), kEdgeTag + uint32_t(l / R));
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
    const T w = lane < kWarps ? sh[lane] : T(0);
    T wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    T we = __shfl_up_sync(kFull, wi, 1);
    if (lane == 0) we = T(0);
    if (lane < kWarps) sh[lane] = we;
    if (lane == 31) sh[kWarps] = wi;
  }
  __syncthreads();
  const T out = excl + sh[warp];
  *total = sh[kWarps];
  __syncthreads();
  return out;
}

// The threads t whose `mine` is set, in index order, into list; returns
// how many.  Every block computes the same list from the same flags.
__device__ int list_where(bool mine, int* list, uint32_t* sh) {
  uint32_t total;
  const uint32_t at = block_exclusive_scan<uint32_t>(mine ? 1u : 0u, sh,
                                                     &total);
  if (mine) list[at] = threadIdx.x;
  __syncthreads();
  return int(total);
}

// The largest a < count with prefix[a] <= u (prefix strictly increasing
// from prefix[0] = 0).
__device__ int find_row(const int* prefix, int count, int u) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The block's own shared memory, before the groups' slices.
struct Fixed {
  uint2* rkey;           // kMaxRows: the listed rows' chunk keys
  int* list;             // kMaxRows: the listed rows
  int* uprefix;          // kMaxRows: each listed row's first unit
  uint32_t* red;         // kWarps + 1
  unsigned char* flags;  // kMaxRows: the rows still walking (active)
};

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }
constexpr int kFixedBytes = align16(kMaxRows * 8 + 2 * kMaxRows * 4
                                    + (kWarps + 1) * 4 + kMaxRows);
constexpr int kGroupBudget = kSmemBytes - kFixedBytes;

__device__ Fixed carve_fixed(unsigned char* raw) {
  Fixed f;
  f.rkey = reinterpret_cast<uint2*>(raw);
  f.list = reinterpret_cast<int*>(f.rkey + kMaxRows);
  f.uprefix = f.list + kMaxRows;
  f.red = reinterpret_cast<uint32_t*>(f.uprefix + kMaxRows);
  f.flags = reinterpret_cast<unsigned char*>(f.red + kWarps + 1);
  return f;
}

// ---------------------------------------------------------------------------
// Groups: 32 / k warps of a block working one item, with their own barrier
// ---------------------------------------------------------------------------

struct Group {
  int t;      // thread rank in the group
  int size;   // threads, a multiple of 32
  int bar;    // named barrier id, 1..kMaxGroups
};

__device__ __forceinline__ void gsync(const Group& g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g.bar), "r"(g.size) : "memory");
}

// Exclusive prefix of v over the group's threads, and the total.  sh holds
// kWarps + 1 values.  Ends with a group barrier.
template <typename T>
__device__ T group_exclusive_scan(const Group& g, T v, T* sh, T* total) {
  const int lane = g.t & 31, warp = g.t >> 5, nw = g.size >> 5;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) sh[warp] = incl;
  gsync(g);
  if (warp == 0) {
    const T w = lane < nw ? sh[lane] : T(0);
    T wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    T we = __shfl_up_sync(kFull, wi, 1);
    if (lane == 0) we = T(0);
    if (lane < nw) sh[lane] = we;
    if (lane == 31) sh[kWarps] = wi;
  }
  gsync(g);
  const T out = excl + sh[warp];
  *total = sh[kWarps];
  gsync(g);
  return out;
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ double operator()(double a, double b) const { return a + b; }
};

// op over the group's values, the same order in every thread.  sh holds
// kWarps values.  Ends with a group barrier.
template <typename T, typename Op>
__device__ T group_reduce(const Group& g, T v, T* sh, Op op) {
  const int lane = g.t & 31, warp = g.t >> 5, nw = g.size >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) sh[warp] = v;
  gsync(g);
  T r = sh[0];
  for (int w = 1; w < nw; ++w) r = op(r, sh[w]);
  gsync(g);
  return r;
}

__device__ __forceinline__ int log2_pow2(int v) { return 31 - __clz(v); }

__host__ __device__ inline int bucket_bits(int npad_log2) {
  const int b = npad_log2 - 2;
  return b < 7 ? 7 : (b > 13 ? 13 : b);
}

__host__ __device__ inline int ilog2(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return lg;
}

__device__ __forceinline__ int tier_of(int n) {
  int w = 1024;
  while (w < n) w <<= 1;
  return w;
}

// Groups a block of a row's tier, their buffers' mode and a group's bytes.
struct Layout {
  int k, mode, bytes;
};

// A K7 slice: red_d [kWarps + 1] double, red_u [kWarps + 1], misc [4],
// lag [kLagTile] at kHead7Lag, then hist [nb], B [npad] unless in the
// slab, A [npad] in kDouble mode.
constexpr int kHead7Lag = align16((kWarps + 1) * 8 + (kWarps + 1) * 4 + 16);
constexpr int kHead7 = kHead7Lag + kLagTile * 4;

__host__ __device__ inline Layout k7_layout(int npad) {
  const int nb = 1 << bucket_bits(ilog2(npad));
  Layout l;
  // the groups are counted for one buffer an item: more items in flight
  // beat drawing each key once (k7_mode takes two where a slice has room)
  if (npad >= kSlabTier) {
    l.mode = kSlab;
    l.bytes = align16(kHead7 + 4 * nb);
  } else {
    l.mode = kSingle;
    l.bytes = align16(kHead7 + 4 * (nb + npad));
  }
  const int k = kGroupBudget / l.bytes;
  l.k = l.mode == kSlab ? 1 : (k > kMaxGroups ? kMaxGroups : k);
  return l;
}

// The buffers of a K7 item of tier npad in a slice of `bytes`: two where
// they fit, else one, and the slab at kSlabTier (whose rows take the whole
// budget, one group a block).
__device__ int k7_mode(int npad, int bytes) {
  const int nb = 1 << bucket_bits(ilog2(npad));
  if (npad >= kSlabTier) return kSlab;
  return kHead7 + 4 * (nb + 2 * npad) <= bytes ? kDouble : kSingle;
}

// A K8 slice (large subsets): red_d, red_u, misc as K7's, then hist
// [kDigitBins] and the keys [npad] unless in the slab.
constexpr int kHead8 = kHead7Lag;

__host__ __device__ inline Layout k8_layout(int npad) {
  Layout l;
  l.mode = npad >= kSlabTier ? kSlab : kSingle;
  l.bytes = align16(kHead8 + 4 * (kDigitBins + (l.mode == kSlab ? 0 : npad)));
  const int k = kGroupBudget / l.bytes;
  l.k = l.mode == kSlab ? 1 : (k > kMaxGroups ? kMaxGroups : k);
  return l;
}

struct Slice {
  double* red_d;
  uint32_t* red_u;
  int* misc;
  float* lag;        // K7
  uint32_t* hist;
  uint32_t* B;       // K7: the sorted words, then the cumsum; K8: the keys
  uint32_t* A;       // K7 in kDouble mode: the draws
};

__device__ Slice carve7(unsigned char* p, int npad, int mode,
                        uint32_t* slab) {
  Slice s;
  s.red_d = reinterpret_cast<double*>(p);
  s.red_u = reinterpret_cast<uint32_t*>(s.red_d + kWarps + 1);
  s.misc = reinterpret_cast<int*>(s.red_u + kWarps + 1);
  s.lag = reinterpret_cast<float*>(p + kHead7Lag);
  s.hist = reinterpret_cast<uint32_t*>(p + kHead7);
  const int nb = 1 << bucket_bits(log2_pow2(npad));
  s.B = mode == kSlab ? slab : s.hist + nb;
  s.A = mode == kDouble ? s.B + npad : nullptr;
  return s;
}

__device__ Slice carve8(unsigned char* p, int mode, uint32_t* slab) {
  Slice s;
  s.red_d = reinterpret_cast<double*>(p);
  s.red_u = reinterpret_cast<uint32_t*>(s.red_d + kWarps + 1);
  s.misc = reinterpret_cast<int*>(s.red_u + kWarps + 1);
  s.lag = nullptr;
  s.hist = reinterpret_cast<uint32_t*>(p + kHead8);
  s.B = mode == kSlab ? slab : s.hist + kDigitBins;
  s.A = nullptr;
  return s;
}

// ---------------------------------------------------------------------------
// K7: one permutation's max-t statistic, by a group
// ---------------------------------------------------------------------------

// w(L) = n / (L (n - L)) and the term (w D) D, as the plain version rounds.
__device__ __forceinline__ float arc_term(float nf, int L, float D) {
  const float Lf = float(L);
  const float w = __fdiv_rn(nf, __fmul_rn(Lf, __fsub_rn(nf, Lf)));
  return __fmul_rn(__fmul_rn(w, D), D);
}

// The sz <= 8 words at w, sorted in registers by the 19 compare-exchanges
// of Batcher's network for 8 (words are distinct and below 0xFFFFFFFF,
// which pads).
__device__ __forceinline__ void sort8(uint32_t* w, int sz) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < sz ? w[i] : 0xFFFFFFFFu;
  constexpr int kNet[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2},
                               {1, 3}, {4, 6}, {5, 7}, {1, 2}, {5, 6},
                               {0, 4}, {3, 7}, {1, 5}, {2, 6}, {1, 4},
                               {3, 6}, {2, 4}, {3, 5}, {3, 4}};
#pragma unroll
  for (int c = 0; c < 19; ++c) {
    const uint32_t a = v[kNet[c][0]], b = v[kNet[c][1]];
    v[kNet[c][0]] = min(a, b);
    v[kNet[c][1]] = max(a, b);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < sz) w[i] = v[i];
}

// Copies the n values of xrow (16-byte aligned, zero-padded to a multiple
// of 4) into dst, 16 bytes a cp.async, without waiting for them.
__device__ __forceinline__ void stage_row(const Group& g, float* dst,
                                          const float* __restrict__ xrow,
                                          int n) {
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int q = g.t; 4 * q < n; q += g.size)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 ::"r"(base + 16u * unsigned(q)), "l"(xrow + 4 * q)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The positions j < n of permutation p under key, ordered by (u, j), as
// 32-bit words (low bits of m, j) in s.B[0, n).  In kDouble mode the draws
// wait in s.A for the scatter; otherwise the scatter draws them again.
// With `stage` (kDouble mode only), the row's values are copied into s.A
// once the scatter has read the draws, while the buckets sort.  A bucket
// of up to 8 words is sorted by a network of 19 compare-exchanges in
// registers, a fixed path that ends with its group's other threads; a
// larger one by insertion.
__device__ void permute(const Group& g, const Slice& s, int mode, uint2 key,
                        int n, int npad, int p,
                        const float* __restrict__ stage = nullptr) {
  const int t = g.t, G = g.size;
  const int B = bucket_bits(log2_pow2(npad));
  const int nb = 1 << B, shift = 23 - B;
  const uint32_t low = (1u << shift) - 1u;
  const uint64_t base = uint64_t(p) * uint64_t(npad);
  uint32_t* hist = s.hist;
  for (int b = t; b < nb; b += G) hist[b] = 0u;
  gsync(g);
  for (int j = t; j < n; j += G) {
    const uint32_t m = draw_bits(key, base + j) >> 9;
    if (mode == kDouble) s.A[j] = m;
    atomicAdd(&hist[m >> shift], 1u);
  }
  gsync(g);
  // bucket starts: thread t owns the buckets [t * per, t * per + per)
  const int per = (nb + G - 1) / G;
  const int b0 = min(nb, t * per), b1 = min(nb, b0 + per);
  uint32_t mine = 0u;
  for (int b = b0; b < b1; ++b) mine += hist[b];
  uint32_t total;
  uint32_t at = group_exclusive_scan<uint32_t>(g, mine, s.red_u, &total);
  for (int b = b0; b < b1; ++b) {
    const uint32_t c = hist[b];
    hist[b] = at;
    at += c;
  }
  gsync(g);
  for (int j = t; j < n; j += G) {
    uint32_t m;
    if (mode == kDouble)
      m = s.A[j];
    else
      m = draw_bits(key, base + j) >> 9;
    const uint32_t slot = atomicAdd(&hist[m >> shift], 1u);
    s.B[slot] = ((m & low) << 16) | uint32_t(j);
  }
  gsync(g);
  if (stage) stage_row(g, reinterpret_cast<float*>(s.A), stage, n);
  // hist[b] is now the end of bucket b; sort each bucket's words
  uint32_t* buf = s.B;
  for (int b = t; b < nb; b += G) {
    const int lo = b ? int(hist[b - 1]) : 0, hi = int(hist[b]);
    if (hi - lo <= 8) {
      sort8(buf + lo, hi - lo);
      continue;
    }
    for (int i = lo + 1; i < hi; ++i) {
      const uint32_t v = buf[i];
      int k = i - 1;
      while (k >= lo && buf[k] > v) {
        buf[k + 1] = buf[k];
        --k;
      }
      buf[k + 1] = v;
    }
  }
  if (stage) asm volatile("cp.async.wait_all;" ::: "memory");
  gsync(g);
}

// The f32 cumsum (float64 running sums, rounded at each position) of xrow
// in the order of the words s.B[0, n), written over them as f32 bits; x is
// read once, kBatch values loaded before they are stored.  A thread's run
// has odd length, so a warp's runs start in distinct banks.  kStaged: xrow
// is the row's copy in shared memory, else it is read from device memory.
template <bool kStaged>
__device__ void permuted_cumsum(const Group& g, const Slice& s,
                                const float* __restrict__ xrow, int n) {
  const int per = ((n + g.size - 1) / g.size) | 1;
  const int k0 = min(n, g.t * per), k1 = min(n, k0 + per);
  uint32_t* buf = s.B;
  double run = 0.0;
  for (int kb = k0; kb < k1; kb += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (kb + q < k1)
        v[q] = kStaged ? xrow[buf[kb + q] & 0xFFFFu]
                       : __ldg(xrow + (buf[kb + q] & 0xFFFFu));
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (kb + q < k1) {
        buf[kb + q] = __float_as_uint(v[q]);
        run += double(v[q]);
      }
  }
  double total;
  double acc = group_exclusive_scan<double>(g, run, s.red_d, &total);
  for (int k = k0; k < k1; ++k) {
    acc += double(__uint_as_float(buf[k]));
    buf[k] = __float_as_uint(__double2float_rn(acc));
  }
  gsync(g);
}

// The max-t statistic of the cumsum cs[0, n) (every thread's value):
// hybrid, lags al0 .. min(kmax, npad - 1) with wrap arcs; full, lags al0 ..
// min(max_lag, n - al0, n - 1) with max_lag = min(top - al0, top - 1),
// top = min(n_min, npad).  Lags above n - 1 contribute nothing.
__device__ float max_t(const Group& g, const Slice& s, const float* cs, int n,
                       int npad, float tss, bool hybrid, int al0, int kmax,
                       int n_min) {
  const int t = g.t, G = g.size, lane = t & 31;
  int lend;
  if (hybrid) {
    lend = min(min(kmax, npad - 1), n - 1);
  } else {
    const int top = min(n_min, npad);
    lend = min(min(top - al0, top - 1), min(n - al0, n - 1));
  }
  const float nf = float(n);
  float best = 0.0f;
  for (int L0 = al0; L0 <= lend; L0 += kLagTile) {
    const int nl = min(kLagTile, lend - L0 + 1);
    for (int i = t; i < nl; i += G) s.lag[i] = 0.0f;
    gsync(g);
    for (int lb = 0; lb < nl; lb += kLagBlock) {
      const int La = L0 + lb, cnt = min(kLagBlock, nl - lb);
      float m[kLagBlock];
#pragma unroll
      for (int u = 0; u < kLagBlock; ++u) m[u] = 0.0f;
      // runs of kRun positions i0 .. i0 + kRun - 1, a thread a run: the
      // run's cs and the kRun + 7 values its lags reach, read once each
      for (int i0 = t * kRun; i0 < n - La; i0 += G * kRun) {
        if (cnt == kLagBlock && i0 + kRun + La + kLagBlock - 2 <= n - 1) {
          float c[kRun], v[kRun + kLagBlock - 1];
#pragma unroll
          for (int r = 0; r < kRun; ++r) c[r] = cs[i0 + r];
#pragma unroll
          for (int q = 0; q < kRun + kLagBlock - 1; ++q) v[q] = cs[i0 + La + q];
#pragma unroll
          for (int r = 0; r < kRun; ++r)
#pragma unroll
            for (int u = 0; u < kLagBlock; ++u)
              m[u] = fmaxf(m[u], fabsf(__fsub_rn(v[r + u], c[r])));
        } else {
          for (int i = i0; i < min(i0 + kRun, n - La); ++i) {
            const float c = cs[i];
#pragma unroll
            for (int u = 0; u < kLagBlock; ++u)
              if (u < cnt && i + La + u <= n - 1)
                m[u] = fmaxf(m[u], fabsf(__fsub_rn(cs[i + La + u], c)));
          }
        }
      }
      if (hybrid) {
#pragma unroll
        for (int u = 0; u < kLagBlock; ++u)
          if (u < cnt) {
            const int L = La + u;
            for (int j = t; j < L; j += G)
              m[u] = fmaxf(m[u], fabsf(__fsub_rn(cs[n - L + j], cs[j])));
          }
      }
      // the warp's maxima of the 8 lags by a butterfly that halves the
      // lags a lane holds at each of the first three steps (4 + 2 + 1
      // shuffles, then 2 for the last lag): lane l ends with lag
      // (l >> 2) & 7's maximum
      const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
      float r4[4], r2[2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r4[q] = fmaxf(h4 ? m[q + 4] : m[q],
                      __shfl_xor_sync(kFull, h4 ? m[q] : m[q + 4], 16));
#pragma unroll
      for (int q = 0; q < 2; ++q)
        r2[q] = fmaxf(h3 ? r4[q + 2] : r4[q],
                      __shfl_xor_sync(kFull, h3 ? r4[q] : r4[q + 2], 8));
      float v = fmaxf(h2 ? r2[1] : r2[0],
                      __shfl_xor_sync(kFull, h2 ? r2[0] : r2[1], 4));
      v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
      v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
      const int u = (lane >> 2) & 7;
      // non-negative floats order as their bits
      if ((lane & 3) == 0 && u < cnt)
        atomicMax(reinterpret_cast<unsigned int*>(s.lag + lb + u),
                  __float_as_uint(v));
    }
    gsync(g);
    for (int li = t; li < nl; li += G)
      best = fmaxf(best, arc_term(nf, L0 + li, s.lag[li]));
    gsync(g);
  }
  best = group_reduce(g, best, reinterpret_cast<float*>(s.red_u), MaxOp());
  const float tssv = (tss <= __fadd_rn(best, 1e-4f)) ? __fadd_rn(best, 1.0f)
                                                     : tss;
  return __fdiv_rn(best, __fdiv_rn(__fsub_rn(tssv, best),
                                   __fsub_rn(nf, 2.0f)));
}

struct WalkArgs {
  const float* x;          // [W, Tmax]
  const i64* n;            // [W]
  const float* tss;
  const i64* key0;         // [2]
  const i64* seg_c;
  const i64* seg_lo;
  const bool* walking0;
  const bool* hybrid;
  const float* ostat;
  const i64* nrejc;
  const i64* sbdry;        // [n_sbdry]
  i64* st;                 // state [2 parities][nrej, k][W]
  float* pstats;           // [2 parities][W, kP]
  uint32_t* gbuf;          // [gridDim.x, Tmax] where Tmax >= kSlabTier
  bool* accepted;
  i64* chunks;
  float* first_stats;      // [W, kP] or null
  const i64* live;         // the engine's live flag, or null
  int W, Tmax, n_sbdry, n_perm, al0, kmax, n_min;
};

// Row r's boundary walk over its chunk `it`'s statistics (_walk_update), by
// one warp: 32 statistics at a time, the running count by ballots, the
// first reject and the first accept of each 32 by their lowest set bits.
// Returns whether the row walks on; with `write`, stores the next parity's
// state and the outputs.
__device__ bool walk_update(const WalkArgs& a, int r, int it, bool write) {
  const int lane = threadIdx.x & 31, cur = it & 1, nxt = cur ^ 1;
  const float os = a.ostat[r];
  const i64 qc = a.nrejc[r];
  const i64 np0 = i64(it) * kP;
  const i64 nrej0 = __ldcg(a.st + (2 * cur) * a.W + r);
  const i64 k0 = __ldcg(a.st + (2 * cur + 1) * a.W + r);
  const float* ps = a.pstats + (size_t(cur) * a.W + r) * kP;
  i64 before = 0;                   // exceedances before this 32
  bool decided = false, accept = false;
  for (int j0 = 0; j0 < kP && !decided; j0 += 32) {
    const int j = j0 + lane;
    const uint32_t ind = __ballot_sync(kFull, os <= __ldcg(ps + j));
    const i64 csum = before + __popc(ind & (kFull >> (31 - lane)));
    const i64 npj = np0 + j + 1;
    i64 idx = k0 + csum - 1;
    idx = idx < 0 ? 0 : (idx > a.n_sbdry - 1 ? a.n_sbdry - 1 : idx);
    const uint32_t rej = __ballot_sync(kFull, nrej0 + csum > qc);
    const uint32_t acc = __ballot_sync(
        kFull, npj >= a.sbdry[idx] || npj >= a.n_perm);
    if (rej | acc) {
      // reject is checked first: an accept wins only strictly earlier
      decided = true;
      accept = acc && (!rej || __ffs(acc) < __ffs(rej));
    }
    before += __popc(ind);
  }
  const bool exhausted = !decided && np0 + kP >= a.n_perm;
  if (write && lane == 0) {
    a.st[(2 * nxt) * a.W + r] = nrej0 + before;
    a.st[(2 * nxt + 1) * a.W + r] = k0 + before;
    a.chunks[r] = it + 1;
    if (accept || exhausted) a.accepted[r] = true;
  }
  return !decided && !exhausted;
}

__global__ void __launch_bounds__(kThreads, 1) walk_kernel(WalkArgs a) {
  if (a.live && !*a.live) return;    // every block: no barrier is met
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Fixed f = carve_fixed(smem_raw);
  unsigned char* slices = smem_raw + kFixedBytes;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = tid; r < a.W; r += kThreads) f.flags[r] = a.walking0[r];
  if (blockIdx.x == 0)
    for (int r = tid; r < a.W; r += kThreads) {
      const i64 q = a.nrejc[r];
      a.st[r] = 0;
      a.st[a.W + r] = q * (q + 1) / 2 + 1;
      a.accepted[r] = false;
      a.chunks[r] = 0;
    }
  __syncthreads();
  uint32_t* slab = a.gbuf + size_t(blockIdx.x) * size_t(a.Tmax);
  for (int it = 0;; ++it) {
    const int cur = it & 1;
    const int nact = list_where(tid < a.W && f.flags[tid], f.list, f.red);
    if (nact == 0) break;
    // the groups of this iteration: as many as the widest listed row
    // allows, each running its own items with no block barrier between
    if (tid == 0) f.uprefix[0] = 0;
    __syncthreads();
    if (tid < nact) {
      const int r = f.list[tid];
      atomicMax(f.uprefix, tier_of(int(a.n[r])));
      f.rkey[tid] = fold_in(row_key(a.key0, a.seg_c, a.seg_lo, a.n, r),
                            uint32_t(it));
    }
    __syncthreads();
    const int k = k7_layout(f.uprefix[0]).k;
    const int slice = (kGroupBudget / k) & ~15;
    const int gsize = (kWarps / k) * 32;
    const int gi = tid / gsize;
    if (gi < k) {
      const Group g{tid - gi * gsize, gsize, 1 + gi};
      const int groups = gridDim.x * k;
      for (int item = blockIdx.x + gridDim.x * gi; item < nact * kP;
           item += groups) {
        const int ai = item / kP, p = item % kP, r = f.list[ai];
        const int n = int(a.n[r]);
        const int npad = tier_of(n);
        const int mode = k7_mode(npad, slice);
        const Slice s = carve7(slices + size_t(gi) * slice, npad, mode,
                               slab);
        permute(g, s, mode, f.rkey[ai], n, npad, p);
        permuted_cumsum<false>(g, s, a.x + size_t(r) * a.Tmax, n);
        const float st = max_t(g, s, reinterpret_cast<const float*>(s.B), n,
                               npad, a.tss[r], a.hybrid[r], a.al0, a.kmax,
                               a.n_min);
        if (g.t == 0) {
          a.pstats[(size_t(cur) * a.W + r) * kP + p] = st;
          if (it == 0 && a.first_stats)
            a.first_stats[size_t(r) * kP + p] = st;
        }
        gsync(g);      // the slice is reused by the group's next item
      }
    }
    grid.sync();
    for (int ai = warp; ai < nact; ai += kWarps) {
      const int r = f.list[ai];
      const bool on = walk_update(a, r, it, blockIdx.x == 0);
      if (lane == 0) f.flags[r] = on;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K8: one permutation's subset sum
// ---------------------------------------------------------------------------

// m1 <= 32, by one warp: the m1 smallest (key, j) of the wn draws, kept as
// a sorted list with lane i holding the i-th (composite key << 32 | j), and
// the float64 sum of their values, rounded to f32 (every lane's value).
__device__ float small_subset_sum(uint2 key, const float* __restrict__ xrow,
                                  int wn, int npad, int m1, int p) {
  const int lane = threadIdx.x & 31;
  const uint64_t base = uint64_t(p) * uint64_t(npad);
  constexpr uint64_t kNone = ~0ull;
  uint64_t mine = kNone, thr = kNone;   // thr: the list's entry m1 - 1
  for (int j0 = 0; j0 < wn; j0 += 128) {
    uint64_t c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 32 * q + lane;
      // drawn past wn too, so that the four draws run side by side
      const uint32_t b = draw_bits(key, base + j);
      c[q] = j < wn ? (uint64_t(b) << 32) | uint32_t(j) : kNone;
    }
    if (!__any_sync(kFull, c[0] < thr || c[1] < thr || c[2] < thr
                               || c[3] < thr))
      continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t cand = __ballot_sync(kFull, c[q] < thr);
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1u;
        const uint64_t cc = __shfl_sync(kFull, c[q], src);
        if (cc < thr) {
          const int pos = __popc(__ballot_sync(kFull, lane < m1 && mine < cc));
          const uint64_t up = __shfl_up_sync(kFull, mine, 1);
          if (lane < m1 && lane >= pos) mine = lane == pos ? cc : up;
          thr = __shfl_sync(kFull, mine, m1 - 1);
        }
      }
    }
  }
  double v = lane < m1 ? double(__ldg(xrow + uint32_t(mine))) : 0.0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return __double2float_rn(v);
}

// The bin of hist[0, nbins) where the cumulative count reaches rank
// (1-based), and rank's remainder inside it, for every thread of the group.
__device__ void select_digit(const Group& g, const Slice& s, int nbins,
                             int& rank, uint32_t& digit) {
  const int per = (nbins + g.size - 1) / g.size;
  const int b0 = min(nbins, g.t * per), b1 = min(nbins, b0 + per);
  uint32_t mine = 0u;
  for (int b = b0; b < b1; ++b) mine += s.hist[b];
  uint32_t total;
  uint32_t before = group_exclusive_scan<uint32_t>(g, mine, s.red_u, &total);
  if (before < uint32_t(rank) && uint32_t(rank) <= before + mine)
    for (int b = b0; b < b1; ++b) {
      const uint32_t c = s.hist[b];
      if (uint32_t(rank) <= before + c) {
        s.misc[0] = b;
        s.misc[1] = rank - int(before);
        break;
      }
      before += c;
    }
  gsync(g);
  digit = uint32_t(s.misc[0]);
  rank = s.misc[1];
  gsync(g);
}

// m1 > 32, by a group: the keys in s.B, the m1-th smallest by three digit
// passes (bits 31-21, 20-10, 9-0), the index of the last tie by atomic
// minima, and the float64 sum of the values of every (key, j) up to it,
// rounded to f32 (every thread's value).
__device__ float large_subset_sum(const Group& g, const Slice& s, uint2 key,
                                  const float* __restrict__ xrow, int wn,
                                  int npad, int m1, int p) {
  const int t = g.t, G = g.size;
  const uint64_t base = uint64_t(p) * uint64_t(npad);
  uint32_t* keys = s.B;
  uint32_t* hist = s.hist;
  for (int b = t; b < kDigitBins; b += G) hist[b] = 0u;
  gsync(g);
  for (int j = t; j < wn; j += G) {
    const uint32_t u = draw_bits(key, base + j);
    keys[j] = u;
    atomicAdd(&hist[u >> 21], 1u);
  }
  gsync(g);
  int rank = m1;
  uint32_t d;
  select_digit(g, s, kDigitBins, rank, d);
  uint32_t prefix = d << 21;
  for (int b = t; b < kDigitBins; b += G) hist[b] = 0u;
  gsync(g);
  for (int j = t; j < wn; j += G) {
    const uint32_t u = keys[j];
    if ((u >> 21) == (prefix >> 21)) atomicAdd(&hist[(u >> 10) & 2047u], 1u);
  }
  gsync(g);
  select_digit(g, s, kDigitBins, rank, d);
  prefix |= d << 10;
  for (int b = t; b < 1024; b += G) hist[b] = 0u;
  gsync(g);
  for (int j = t; j < wn; j += G) {
    const uint32_t u = keys[j];
    if ((u >> 10) == (prefix >> 10)) atomicAdd(&hist[u & 1023u], 1u);
  }
  gsync(g);
  select_digit(g, s, 1024, rank, d);
  const uint32_t tau = prefix | d;
  // the subset takes the first `rank` keys equal to tau in index order
  int last = -1;
  for (int i = 0; i < rank; ++i) {
    if (t == 0) s.misc[2] = INT_MAX;
    gsync(g);
    for (int j = t; j < wn; j += G)
      if (keys[j] == tau && j > last) atomicMin(&s.misc[2], j);
    gsync(g);
    last = s.misc[2];
    gsync(g);
  }
  double sum = 0.0;
  for (int j = t; j < wn; j += G) {
    const uint32_t u = keys[j];
    if (u < tau || (u == tau && j <= last)) sum += double(__ldg(xrow + j));
  }
  return __double2float_rn(group_reduce(g, sum, s.red_d, SumOp()));
}

struct EdgeArgs {
  const float* xw;         // [L, Tmax]
  const i64* wn;
  const i64* m1;
  const float* xbar;
  const float* ostat;
  const bool* active0;
  const i64* key0;         // [2]
  const i64* seg_c;        // [R]: lane l's row is l % R
  const i64* seg_lo;
  const i64* seg_n;
  const float* limit;      // scalar
  i64* st;                 // counts [2 parities][L]
  float* sums;             // [2 parities][L, kP]
  uint32_t* gbuf;
  i64* count;
  i64* cnt;
  float* first_sums;       // [L, kP] or null
  const i64* live;         // the engine's live flag, or null
  int L, R, Tmax, n_perm;
};

__device__ __forceinline__ int clamp_m1(i64 m1, int wn) {
  return int(m1 < 1 ? 1 : (m1 > wn ? wn : m1));
}

// Lane l's count over the subset sums of its chunks c0 .. c0 + depth - 1,
// by one warp, chunk after chunk until it stops.  Returns whether the lane
// goes on; with `write`, stores the next parity's count and the outputs.
__device__ bool edge_update(const EdgeArgs& a, int l, int cur, int c0,
                            int depth, bool write) {
  const int lane = threadIdx.x & 31;
  const i64 m1 = a.m1[l];
  const float m1f = float(m1 < 1 ? 1 : m1);
  const float xb = a.xbar[l], os = a.ostat[l];
  i64 count = __ldcg(a.st + size_t(cur) * a.L + l);
  bool go = true;
  int c = c0;
  for (int q = 0; q < depth && go; ++q, ++c) {
    const i64 done = i64(c) * kP;      // an active lane has done c chunks
    const i64 take = min(i64(a.n_perm) - done, i64(kP));
    const float* su = a.sums + (size_t(cur * kMaxDepth + q) * a.L + l) * kP;
    i64 inc = 0;
    for (int p = lane; p < kP; p += 32)
      inc += p < take
             && os <= fabsf(__fsub_rn(__fdiv_rn(__ldcg(su + p), m1f), xb));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) inc += __shfl_xor_sync(kFull, inc, o);
    count += inc;
    go = __ll2float_rn(count) <= *a.limit && done + take < a.n_perm;
  }
  if (write && lane == 0) {
    a.st[size_t(cur ^ 1) * a.L + l] = count;
    a.count[l] = count;
    a.cnt[l] = c;
  }
  return go;
}

__global__ void __launch_bounds__(kThreads, 1) edge_kernel(EdgeArgs a) {
  if (a.live && !*a.live) return;    // every block: no barrier is met
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Fixed f = carve_fixed(smem_raw);
  unsigned char* slices = smem_raw + kFixedBytes;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int l = tid; l < a.L; l += kThreads) f.flags[l] = a.active0[l];
  if (blockIdx.x == 0)
    for (int l = tid; l < a.L; l += kThreads) {
      a.st[l] = 0;
      a.count[l] = 0;
      a.cnt[l] = 0;
    }
  __syncthreads();
  uint32_t* slab = a.gbuf + size_t(blockIdx.x) * size_t(a.Tmax);
  const bool small = tid < a.L
                     && clamp_m1(a.m1[tid], int(a.wn[tid])) <= kSmallM1;
  const int chunks_all = (a.n_perm + kP - 1) / kP;
  int c0 = 0;          // the chunks every active lane has done
  for (int it = 0;; ++it) {
    const int cur = it & 1;
    // the small-subset lanes, then the others
    const bool on = tid < a.L && f.flags[tid];
    const int ns = list_where(on && small, f.list, f.red);
    const int nl = list_where(on && !small, f.list + ns, f.red);
    const int nact = ns + nl;
    if (nact == 0) break;
    // chunks a lane takes this iteration: enough items for a warp each,
    // at most kMaxDepth and no more than the lanes have left
    int depth = (gridDim.x * kWarps) / (nact * kP);
    depth = max(1, min(min(depth, kMaxDepth), chunks_all - c0));
    if (tid < nact)
      f.rkey[tid] = lane_key(a.key0, a.seg_c, a.seg_lo, a.seg_n, a.R,
                             f.list[tid]);
    int upc = 0;       // units a chunk of the lane
    if (tid < nl) {
      const int k = k8_layout(tier_of(int(a.wn[f.list[ns + tid]]))).k;
      upc = (kP + k - 1) / k;
    }
    uint32_t total;
    const uint32_t first = block_exclusive_scan<uint32_t>(
        uint32_t(upc * depth), f.red, &total);
    if (tid < nl) f.uprefix[tid] = int(first);
    __syncthreads();
    // small subsets: an item a warp, items round the blocks first
    for (int i = warp * gridDim.x + blockIdx.x; i < ns * depth * kP;
         i += kWarps * gridDim.x) {
      const int ai = i / (depth * kP), q = (i / kP) % depth, p = i % kP;
      const int l = f.list[ai], wn = int(a.wn[l]);
      const float sum = small_subset_sum(
          fold_in(f.rkey[ai], uint32_t(c0 + q)), a.xw + size_t(l) * a.Tmax,
          wn, tier_of(wn), clamp_m1(a.m1[l], wn), p);
      if (lane == 0) {
        a.sums[(size_t(cur * kMaxDepth + q) * a.L + l) * kP + p] = sum;
        if (c0 + q == 0 && a.first_sums)
          a.first_sums[size_t(l) * kP + p] = sum;
      }
    }
    // large subsets: units of k items of one chunk, a group an item
    for (int u = blockIdx.x; u < int(total); u += gridDim.x) {
      const int ai = find_row(f.uprefix, nl, u);
      const int l = f.list[ns + ai];
      const int wn = int(a.wn[l]);
      const int npad = tier_of(wn);
      const Layout lay = k8_layout(npad);
      const int per_chunk = (kP + lay.k - 1) / lay.k;
      const int o = u - f.uprefix[ai], q = o / per_chunk;
      const int gsize = (kWarps / lay.k) * 32;
      const int gi = tid / gsize;
      const int p = (o % per_chunk) * lay.k + gi;
      if (gi < lay.k && p < kP) {
        const Group g{tid - gi * gsize, gsize, 1 + gi};
        const Slice s = carve8(slices + size_t(gi) * lay.bytes, lay.mode,
                               slab);
        const float sum = large_subset_sum(
            g, s, fold_in(f.rkey[ns + ai], uint32_t(c0 + q)),
            a.xw + size_t(l) * a.Tmax, wn, npad, clamp_m1(a.m1[l], wn), p);
        if (g.t == 0) {
          a.sums[(size_t(cur * kMaxDepth + q) * a.L + l) * kP + p] = sum;
          if (c0 + q == 0 && a.first_sums)
            a.first_sums[size_t(l) * kP + p] = sum;
        }
      }
      __syncthreads();
    }
    grid.sync();
    for (int ai = warp; ai < nact; ai += kWarps) {
      const int l = f.list[ai];
      const bool go = edge_update(a, l, cur, c0, depth, blockIdx.x == 0);
      if (lane == 0) f.flags[l] = go;
    }
    c0 += depth;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K12: one chunk of permutation statistics for each masked row
// ---------------------------------------------------------------------------

struct PermArgs {
  const float* x;          // [S, npad], 16-byte aligned
  const i64* n;            // [S]
  const float* tss;
  const i64* keys;         // [S, 2]: the rows' chunk keys
  const bool* mask;
  const bool* hybrid;
  uint32_t* gbuf;          // [gridDim.x, npad] where npad >= kSlabTier
  float* out;              // [S, P]
  int S, npad, P, al0, kmax, max_len;
};

// K12's own shared memory before the slices: the masked rows' list (16
// bits a row) and a scan's scratch; no walk state and no keys (an item
// reads its row's key from device memory), so that a slice of 6 groups
// holds two buffers at width 4,096.
constexpr int kPermFixedBytes = align16(kMaxRows * 2 + (kWarps + 1) * 4);
constexpr int kPermBudget = kSmemBytes - kPermFixedBytes;

// The bytes of a K7-style slice of width npad with two buffers.
__host__ __device__ inline int double_bytes(int npad) {
  return kHead7 + 4 * ((1 << bucket_bits(ilog2(npad))) + 2 * npad);
}

// Widths from which K12 keeps the draws in a second buffer even where that
// costs a block more rounds (there a row's draws outweigh a round; only
// 8,192 and 16,384 have room for two buffers), and stages the row's values
// in shared memory (below it, gathering them from device memory is the
// quicker: a narrower row's gather is short, and the copy's wait is not).
constexpr int kWideRow = 8192;

// K12's groups for a launch of `items` = masked rows x P items over `grid`
// blocks at width npad.  The cap is what two buffers a slice allow where
// they take the block's share of the items in one round (or the width is
// kWideRow or more), else K7's layout of the width (never more); the
// block's share goes in as few rounds as the cap allows, by the fewest
// groups that take it in those rounds; a slice keeps two buffers wherever
// it holds them (the draws kept; from kWideRow on, the row's values
// staged).  bytes is a group's slice.
__host__ __device__ inline Layout perm_layout(int npad, int items,
                                              int grid) {
  const int kcap = k7_layout(npad).k;
  int kd = npad >= kSlabTier ? 0 : kPermBudget / double_bytes(npad);
  kd = kd < kcap ? kd : kcap;
  int share = grid > 0 ? (items + grid - 1) / grid : items;
  share = share < 1 ? 1 : share;
  const int cap = kd >= 1 && (share <= kd || npad >= kWideRow) ? kd : kcap;
  const int rounds = (share + cap - 1) / cap;
  Layout l;
  l.k = (share + rounds - 1) / rounds;
  l.bytes = (kPermBudget / l.k) & ~15;
  l.mode = npad >= kSlabTier ? kSlab
         : (double_bytes(npad) <= l.bytes ? kDouble : kSingle);
  return l;
}

__global__ void __launch_bounds__(kThreads, 1) perm_kernel(PermArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* red = reinterpret_cast<uint32_t*>(smem_raw);
  uint16_t* list = reinterpret_cast<uint16_t*>(red + kWarps + 1);
  unsigned char* slices = smem_raw + kPermFixedBytes;
  const int tid = threadIdx.x;
  const bool mine = tid < a.S && a.mask[tid];
  uint32_t count;
  const uint32_t at = block_exclusive_scan<uint32_t>(mine ? 1u : 0u, red,
                                                     &count);
  if (mine) list[at] = uint16_t(tid);
  __syncthreads();
  const int nact = int(count);
  const size_t total = size_t(a.S) * size_t(a.P);
  for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < total;
       i += size_t(gridDim.x) * kThreads)
    if (!a.mask[i / a.P]) a.out[i] = 0.0f;
  if (nact == 0) return;
  // the groups from the launch's items, each running its items with no
  // block barrier
  const Layout l = perm_layout(a.npad, nact * a.P, gridDim.x);
  const int gsize = (kWarps / l.k) * 32;
  const int gi = tid / gsize;
  if (gi >= l.k) return;
  const Group g{tid - gi * gsize, gsize, 1 + gi};
  const Slice s = carve7(slices + size_t(gi) * l.bytes, a.npad, l.mode,
                         a.gbuf + size_t(blockIdx.x) * size_t(a.npad));
  const bool staged = l.mode == kDouble && a.npad >= kWideRow;
  for (int item = blockIdx.x + gridDim.x * gi; item < nact * a.P;
       item += gridDim.x * l.k) {
    const int p = item % a.P, r = list[item / a.P];
    const int n = int(a.n[r]);
    const float* xrow = a.x + size_t(r) * a.npad;
    const uint2 key = make_uint2(uint32_t(__ldg(a.keys + 2 * r)),
                                 uint32_t(__ldg(a.keys + 2 * r + 1)));
    permute(g, s, l.mode, key, n, a.npad, p, staged ? xrow : nullptr);
    if (staged)
      permuted_cumsum<true>(g, s, reinterpret_cast<const float*>(s.A), n);
    else
      permuted_cumsum<false>(g, s, xrow, n);
    const float st = max_t(g, s, reinterpret_cast<const float*>(s.B), n,
                           a.npad, a.tss[r], a.hybrid[r], a.al0, a.kmax,
                           a.max_len);
    if (g.t == 0) a.out[size_t(r) * a.P + p] = st;
    gsync(g);      // the slice is reused by the group's next item
  }
}

// ---------------------------------------------------------------------------
// The draws and the keys on their own, for tests
// ---------------------------------------------------------------------------

__global__ void threefry_kernel(const i64* keys, const i64* data, int K,
                                uint64_t counter0, int count, i64* folded,
                                i64* bits, float* unif) {
  const int k = blockIdx.y;
  const uint2 key = make_uint2(uint32_t(keys[2 * k]),
                               uint32_t(keys[2 * k + 1]));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const uint2 f = fold_in(key, uint32_t(data[k]));
    folded[2 * k] = i64(f.x);
    folded[2 * k + 1] = i64(f.y);
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const uint32_t b = draw_bits(key, counter0 + uint64_t(i));
    bits[size_t(k) * count + i] = i64(b);
    unif[size_t(k) * count + i] = __uint_as_float((b >> 9) | 0x3F800000u)
                                  - 1.0f;
  }
}

// The chunk keys K7 and K8 derive: rows r < R under fold_in(row key, chunk)
// into walk_keys [R, 2], lanes l < L under fold_in(lane key, chunk) into
// edge_keys [L, 2].
__global__ void keys_kernel(const i64* key0, const i64* c, const i64* lo,
                            const i64* n, int R, int L, int chunk,
                            i64* walk_keys, i64* edge_keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < R) {
    const uint2 k = fold_in(row_key(key0, c, lo, n, i), uint32_t(chunk));
    walk_keys[2 * i] = i64(k.x);
    walk_keys[2 * i + 1] = i64(k.y);
  }
  if (i < L) {
    const uint2 k = fold_in(lane_key(key0, c, lo, n, R, i), uint32_t(chunk));
    edge_keys[2 * i] = i64(k.x);
    edge_keys[2 * i + 1] = i64(k.y);
  }
}

// A cooperative launch through cudaLaunchKernelExC with the cooperative
// launch attribute, which a CUDA graph's stream capture keeps on the
// kernel node (the grid barriers need it on every replay).
int launch_cooperative(const void* kernel, int grid, void** args,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(kSmemBytes);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const void* kernel_of(int which) {
  return which == 1 ? reinterpret_cast<const void*>(edge_kernel)
       : which == 2 ? reinterpret_cast<const void*>(perm_kernel)
                    : reinterpret_cast<const void*>(walk_kernel);
}

}  // namespace

// The blocks of a K7 (which == 0), K8 (1) or K12 (2) launch on the current
// device: its SMs times the blocks of kThreads threads and kSmemBytes that
// the occupancy calculator lets each hold, into *grid.
extern "C" int cbs_grid(int which, int* grid) {
  const void* kernel = kernel_of(which);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, size_t(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = sms * per_sm;
  return per_sm > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// A row of tier npad in K7 (edge == 0; the groups of an iteration whose
// widest row has this tier) or, with a subset above 32, in K8: (groups a
// block, buffer mode: 0 two buffers in shared memory, 1 one, 2 a slab of
// device memory; a group's shared bytes) into out[3].
extern "C" int cbs_layout(int npad, int edge, int* out) {
  const Layout l = edge ? k8_layout(npad) : k7_layout(npad);
  out[0] = l.k;
  out[1] = l.mode;
  out[2] = l.bytes;
  return 0;
}

// K7.  state: int64 [2, 2, W] scratch; pstats: f32 [2, W, 512] scratch;
// slab: [grid, Tmax] 32-bit words when Tmax >= 65,536; first_stats may be
// null; live (int64 scalar, may be null): every block returns at once
// where it is 0.
extern "C" int cbs_walk(const void* x, const void* n, const void* tss,
                        const void* key0, const void* seg_c,
                        const void* seg_lo, const void* walking,
                        const void* hybrid, const void* ostat,
                        const void* nrejc, const void* sbdry, void* state,
                        void* pstats, void* slab, void* accepted,
                        void* chunks, void* first_stats, int W, int Tmax,
                        int n_sbdry, int n_perm, int al0, int kmax, int n_min,
                        int grid, const void* live, void* stream) {
  if (W <= 0) return 0;
  if (W > kMaxRows || n_sbdry <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a;
  a.x = static_cast<const float*>(x);
  a.n = static_cast<const i64*>(n);
  a.tss = static_cast<const float*>(tss);
  a.key0 = static_cast<const i64*>(key0);
  a.seg_c = static_cast<const i64*>(seg_c);
  a.seg_lo = static_cast<const i64*>(seg_lo);
  a.walking0 = static_cast<const bool*>(walking);
  a.hybrid = static_cast<const bool*>(hybrid);
  a.ostat = static_cast<const float*>(ostat);
  a.nrejc = static_cast<const i64*>(nrejc);
  a.sbdry = static_cast<const i64*>(sbdry);
  a.st = static_cast<i64*>(state);
  a.pstats = static_cast<float*>(pstats);
  a.gbuf = static_cast<uint32_t*>(slab);
  a.accepted = static_cast<bool*>(accepted);
  a.chunks = static_cast<i64*>(chunks);
  a.first_stats = static_cast<float*>(first_stats);
  a.live = static_cast<const i64*>(live);
  a.W = W;
  a.Tmax = Tmax;
  a.n_sbdry = n_sbdry;
  a.n_perm = n_perm;
  a.al0 = al0;
  a.kmax = kmax;
  a.n_min = n_min;
  void* args[] = {&a};
  return launch_cooperative(reinterpret_cast<const void*>(walk_kernel), grid,
                            args, static_cast<cudaStream_t>(stream));
}

// K8.  state: int64 [2, L] scratch; sums: f32 [2, 4, L, 512] scratch; slab as
// for K7; first_sums and live as for K7.  Lane l's key derives from row l % R.
extern "C" int cbs_edge(const void* xw, const void* wn, const void* m1,
                        const void* xbar, const void* ostat,
                        const void* active, const void* key0,
                        const void* seg_c, const void* seg_lo,
                        const void* seg_n, const void* limit, void* state,
                        void* sums, void* slab, void* count, void* cnt,
                        void* first_sums, int L, int R, int Tmax, int n_perm,
                        int grid, const void* live, void* stream) {
  if (L <= 0) return 0;
  if (L > kMaxRows || R <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  EdgeArgs a;
  a.xw = static_cast<const float*>(xw);
  a.wn = static_cast<const i64*>(wn);
  a.m1 = static_cast<const i64*>(m1);
  a.xbar = static_cast<const float*>(xbar);
  a.ostat = static_cast<const float*>(ostat);
  a.active0 = static_cast<const bool*>(active);
  a.key0 = static_cast<const i64*>(key0);
  a.seg_c = static_cast<const i64*>(seg_c);
  a.seg_lo = static_cast<const i64*>(seg_lo);
  a.seg_n = static_cast<const i64*>(seg_n);
  a.limit = static_cast<const float*>(limit);
  a.st = static_cast<i64*>(state);
  a.sums = static_cast<float*>(sums);
  a.gbuf = static_cast<uint32_t*>(slab);
  a.count = static_cast<i64*>(count);
  a.cnt = static_cast<i64*>(cnt);
  a.first_sums = static_cast<float*>(first_sums);
  a.live = static_cast<const i64*>(live);
  a.L = L;
  a.R = R;
  a.Tmax = Tmax;
  a.n_perm = n_perm;
  void* args[] = {&a};
  return launch_cooperative(reinterpret_cast<const void*>(edge_kernel), grid,
                            args, static_cast<cudaStream_t>(stream));
}

// K12's layout of a launch of `items` items over `grid` blocks at width
// npad: (groups a block, buffer mode as cbs_layout's, a group's slice
// bytes, the bytes two buffers take) into out[4].
extern "C" int cbs_perm_layout(int npad, int items, int grid, int* out) {
  const Layout l = perm_layout(npad, items, grid);
  out[0] = l.k;
  out[1] = l.mode;
  out[2] = l.bytes;
  out[3] = double_bytes(npad);
  return 0;
}

// K12.  x f32 [S, npad] (16-byte aligned), n int64, tss f32, keys int64
// [S, 2], mask and hybrid bool [S]; out f32 [S, P]; slab: [grid, npad]
// 32-bit words when npad >= 65,536; S <= 1,024.
extern "C" int cbs_perm(const void* x, const void* n, const void* tss,
                        const void* keys, const void* mask,
                        const void* hybrid, void* slab, void* out, int S,
                        int npad, int P, int al0, int kmax, int max_len,
                        int grid, void* stream) {
  if (S <= 0) return 0;
  if (S > kMaxRows || grid <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PermArgs a;
  a.x = static_cast<const float*>(x);
  a.n = static_cast<const i64*>(n);
  a.tss = static_cast<const float*>(tss);
  a.keys = static_cast<const i64*>(keys);
  a.mask = static_cast<const bool*>(mask);
  a.hybrid = static_cast<const bool*>(hybrid);
  a.gbuf = static_cast<uint32_t*>(slab);
  a.out = static_cast<float*>(out);
  a.S = S;
  a.npad = npad;
  a.P = P;
  a.al0 = al0;
  a.kmax = kmax;
  a.max_len = max_len;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(perm_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  perm_kernel<<<unsigned(grid), kThreads, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cbs_threefry(const void* keys, const void* data, int K,
                            long long counter0, int count, void* folded,
                            void* bits, void* unif, void* stream) {
  if (K <= 0 || count <= 0) return 0;
  const int blocks = (count + 255) / 256 < 64 ? (count + 255) / 256 : 64;
  threefry_kernel<<<dim3(unsigned(blocks), unsigned(K)), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(keys), static_cast<const i64*>(data), K,
      uint64_t(counter0), count, static_cast<i64*>(folded),
      static_cast<i64*>(bits), static_cast<float*>(unif));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cbs_keys(const void* key0, const void* seg_c,
                        const void* seg_lo, const void* seg_n, int R, int L,
                        int chunk, void* walk_keys, void* edge_keys,
                        void* stream) {
  const int m = R > L ? R : L;
  if (m <= 0) return 0;
  keys_kernel<<<(m + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(key0), static_cast<const i64*>(seg_c),
      static_cast<const i64*>(seg_lo), static_cast<const i64*>(seg_n), R, L,
      chunk, static_cast<i64*>(walk_keys), static_cast<i64*>(edge_keys));
  return static_cast<int>(cudaGetLastError());
}

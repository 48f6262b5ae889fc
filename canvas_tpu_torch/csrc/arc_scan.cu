// CBS arc-scan kernel B4, for Hopper.
//
// Replaces canvas_tpu/ops/cbs_device.py:_arc_scan_kernel (the TMaxO max
// phase of the frontier CBS engine).  Per segment b of a bucket, over the
// cumsum cs[b, 0:npad] of its centred values (zero past its length n):
//
//   best = max(seed, max_{al0 <= L <= lag_hi, i <= n-1-L} w(L) (cs2[i+L]-cs[i])^2)
//   w(L) = n / (L (n - L)),  cs2 = cs zero-extended to 2 npad,
//
// as a branch-and-bound over blocks of `blk` = min(512, npad) lags: block k
// is visited when it overlaps [al0, lag_hi] and w_bound * psd2[b, k] is
// greater than the running best; its lags go in sub-blocks of `sub` =
// min(32, blk), and a sub-block whose maximum is strictly greater than the
// best takes it (bl0 = the sub-block's first lag).
//
// The TPU kernel walks the blocks of a segment in sequence, carrying the
// running best; here that walk is split in two:
//   phase 1 (arc_scan_blocks): a persistent grid, the card's SMs times the
//     blocks each holds at once, whatever the launch's rows, mask and
//     width, works through a list of items (lag block k, quarter of it,
//     segment, position tile), so one segment still fills the card (the
//     panel's top level is one segment of ~20,000 bins in a 32,768
//     bucket).  An item works only when its lag block's gate passes a
//     floor under the walk's running best before that block: the seed,
//     raised by the maxima of earlier lag blocks' items that have
//     finished.  It stages cs2[i0+l0 : i0+l0+kTile+lags+kRun] and w of its
//     lags in shared memory and writes the maximum of each sub-block,
//     reduced over the warp with shuffles and over the block and the
//     position tiles with an ordered-int atomicMax, into a [B, nblk, 16]
//     scratch;
//   phase 2 (arc_scan_replay): per segment, the TPU kernel's walk over
//     that scratch: blocks in ascending order, each admitted by the same
//     f32 test against the running best, sub-blocks updating on strict >.
//     So best and bl0 are the TPU kernel's whatever order phase 1 ran in,
//     also where a rounded f32 bound would admit or skip a block
//     differently from the floor test.
//
// Phase 1's list.  The whole-recursion engine calls B4 once a tier on all
// W rows of its level, most of them outside the tier's mask, and on
// levels after the run's end; a grid of a thread block per (tile, row,
// quarter lag block) spent 0.6 ns of card time a block that returned at
// once, 2.8 million blocks a level at Tmax 65,536.  So the list holds only
// what can be live, and every block of the grid derives it on the card
// from the launch's inputs, with no read by the host:
//   * the rows under the mask (all rows without one), compacted in shared
//     memory with their n, lag_hi and seed, kMaxRows at a time;
//   * per (lag block, row), a unit, only when the block overlaps [al0,
//     lag_hi] and the seed alone admits it (gate > seed; no floor can
//     admit what the seed rejects);
//   * per unit and quarter, an item for each tile with a live position,
//     i0 <= n-1-max(l0, al0), so the dead triangle is never listed.
// Units go lag block first, then row, kChunk at a time: thread t counts
// units t, t + kThreads, ... (a psd2 load and a gate each), and a
// block-wide prefix sum in unit order gives each unit's first item, the
// same in every block.  Block i takes item i first, then items from a
// counter, one atomicAdd an item, issued when the item before it starts and
// read after that item's gate; so items go in ascending order over the
// card (lag blocks first, as the floors want) and a block that finishes
// early takes more.  A block whose next item lies in a later chunk lists
// that chunk.  An item loads its floor with its staged values, so a
// rejected item costs a round trip to memory and two barriers.  The
// counter is a scratch word, so the launch's scratch memset resets it.
// Where live is 0, every block returns at once.
//
// Phase 1's design.  A term computed naively costs a shared-memory load,
// the position predicate i <= n-1-L, a subtraction, two multiplications
// and a maximum; the function needs a subtraction and a maximum.  So:
//   * w is factored out of the maximum over positions.  fl(d * d) is
//     monotone in |d| and fl(w * x) in x for w > 0, so, bit for bit,
//       max_i fl(w * fl(d_i * d_i)) = fl(w * fl(D * D)),  D = max_i |d_i|;
//     a term is one subtraction and one maximum with an |.| operand, and a
//     lag one square, one multiply and one maximum per thread;
//   * register tiling: a thread owns kPos consecutive positions and takes
//     kRun lags at a time from a window of kPos + kRun cs2 values in
//     registers, so one shared-memory word serves 5.3 terms, not 1;
//   * no term carries the position predicate i <= n-1-L: in a run that
//     crosses i + L = n - 1 the window values past it are made NaN, which
//     fmaxf leaves out;
//   * floors cut the work that the seed alone admits (1.7-1.9 times what
//     the walk needs on the smoke's inputs): a finished item raises, with
//     atomicMax, the floor of every later lag block of its segment to its
//     maximum, which is at most the walk's running best before that block
//     (see scan_item).  Early lag blocks' items are listed first, so they
//     tend to finish first; the result does not depend on the order, only
//     the work saved does;
//   * the replay reads every block's sub-block maxima in parallel, one
//     thread a block, and walks only the blocks' maxima and gates.
// With a tally word (terms, may be null) each block adds the live (i, L)
// pair terms of the items it computed, once, as it ends.

// Bound on the H100: the function needs the pair terms of the blocks its
// walk visits against the running best (the plain version counts them),
// two f32 issue slots each (a subtraction and a maximum), none an FMA;
// phase 1 computes every block that the seed admits and no floor has
// pruned, a superset (its tally counts them).
//
// Exactness: d = cs2[i+L] - cs[i] and w = nf / (Lf * (nf - Lf)) with the
// correctly rounded intrinsics (__fsub_rn, __fmul_rn, __fdiv_rn), nothing
// contracted into a multiply-add, and the products formed as
// fl(w * fl(D * D)) after the identity above; so every sub-block maximum
// equals the plain torch version's, which forms w * (d * d) per term, bit
// for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPos = 8;                     // positions per thread
constexpr int kRun = 16;                    // lags per register window
constexpr int kThreads = 128;
constexpr int kTile = kPos * kThreads;      // positions per item
static_assert(kPos % 4 == 0 && kRun % 4 == 0, "float4 loads");
constexpr int kBlk = 512;                   // lags per pruning block (max)
constexpr int kSub = 32;                    // lags per sub-block (max)
constexpr int kMaxSub = kBlk / kSub;        // scratch stride
constexpr int kSplit = 4;                   // items (quarters) per lag block
constexpr int kPartLags = kBlk / kSplit;    // lags per item (max)
static_assert(kMaxSub % kSplit == 0 && kPartLags >= kRun, "split");
constexpr int kMaxRows = 256;               // rows listed at a time
static_assert(kMaxRows % kThreads == 0, "rows listed a thread at a time");
constexpr int kUnits = 4;                   // units a thread lists at a time
constexpr int kChunk = kUnits * kThreads;   // units listed at a time
// the item counter's value after the scratch memset (every byte 0x80)
constexpr unsigned kCounterBase = 0x80808080u;

// Order-preserving map between f32 and int32 (an involution): signed-int
// comparison of encoded values is float comparison of the values.
__device__ __forceinline__ int encode(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float decode(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7FFFFFFF);
}

// w(L) with L clipped into [1, max(n-1, 1)], as the TPU kernel's w_of.
__device__ __forceinline__ float w_of(int L, int n) {
  const int hi = max(n - 1, 1);
  const float Lf = __int2float_rn(min(max(L, 1), hi));
  const float nf = __int2float_rn(n);
  return __fdiv_rn(nf, __fmul_rn(Lf, __fsub_rn(nf, Lf)));
}

// Whether segment b sits this launch out: the whole-recursion engine's run
// has ended (live, when given, is 0), or b is outside the launch's mask
// (when given).  Every thread block of the segment returns at once.
__device__ __forceinline__ bool skip_row(const long long* live,
                                         const bool* mask, int b) {
  return (live && !*live) || (mask && !mask[b]);
}

// w_bound * psd2 of lag block k, and whether the block overlaps [al0,
// lag_hi] (else -inf).
__device__ __forceinline__ float block_gate(int k, int blk, int n, int lag_hi,
                                            int al0, float psd2) {
  const int l0 = k * blk;
  if (!(l0 <= lag_hi && l0 + blk - 1 >= al0))
    return __int_as_float(0xFF800000);
  const float w_bound = fmaxf(w_of(max(l0, al0), n),
                              w_of(min(l0 + blk - 1, lag_hi), n));
  return __fmul_rn(w_bound, psd2);
}

// Item (part, tile) of lag block k's quarter `part`: the sub-blocks
// [q_lo, q_hi) and the live lags [L_lo, L_hi] (al0, lag_hi and the block's
// end applied); tiles() is the number of position tiles holding a live
// position, i0 <= n-1-L_lo, 0 when the quarter has no sub-block or no
// live lag.
struct Part {
  int q_lo, q_hi, L_lo, L_hi;
  __device__ Part(int k, int part, int blk, int sub, int nsub, int al0,
                  int lag_hi) {
    q_lo = part * nsub / kSplit;
    q_hi = (part + 1) * nsub / kSplit;
    L_lo = max(k * blk + q_lo * sub, al0);
    L_hi = min(k * blk + q_hi * sub - 1, lag_hi);
  }
  __device__ int tiles(int n) const {
    if (q_lo == q_hi || L_lo > L_hi || L_lo > n - 1) return 0;
    return (n - 1 - L_lo) / kTile + 1;
  }
};

// sum over L in [lo, hi] of clamp(n - i0 - L, 0, kTile): the live (i, L)
// pair terms of a tile of positions i0 .. i0 + kTile - 1.
__device__ __forceinline__ long long tile_terms(int n, int i0, int lo,
                                                int hi) {
  const long long a = static_cast<long long>(n) - i0;
  // lags L <= a - kTile pair with every position of the tile
  const long long full_hi = min(static_cast<long long>(hi), a - kTile);
  long long t = full_hi >= lo ? (full_hi - lo + 1) * kTile : 0;
  // lags a - kTile < L < a pair with a - L of them
  const long long p_lo = max(static_cast<long long>(lo), a - kTile + 1);
  const long long p_hi = min(static_cast<long long>(hi), a - 1);
  if (p_hi >= p_lo) {
    const long long c = p_hi - p_lo + 1;
    t += c * a - (p_lo + p_hi) * c / 2;
  }
  return t;
}

// Exclusive prefix sum of v over the block's threads, in thread order, and
// its total, through s_warp.  Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();                          // s_warp's last readers are done
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int t = s_warp[w];
    before += w < warp ? t : 0;
    total += t;
  }
  return before + x - v;
}

// One item of phase 1: positions i0 .. i0 + kTile - 1 of a segment (row
// of cs, n bins) against the sub-blocks [P.q_lo, P.q_hi) of lag block k,
// its live lags [P.L_lo, P.L_hi], when its gate passes the floor (the
// seed, raised by finished items of earlier lag blocks): returns whether
// it did, the same in every thread.  The floor is loaded with the item's
// staged values, so a passing item waits for one round trip to memory.
// Thread tid owns the kPos consecutive positions i = i_t + p
// (i_t = i0 + kPos*tid) and walks the lags in runs of kRun.  For the run
// of lags L + u it loads the window win[j] = cs2[i_t + L + j],
// j < kPos + kRun, from shared memory into registers (four 16-byte
// loads): term (p, u) is win[p + u] - c[p], so kPos + kRun words serve
// kPos * kRun terms.  Per lag it keeps D = max |d| over its live positions
// (one subtraction and one absolute-value maximum a term), then folds
// fl(w * fl(D * D)) into the sub-block's maximum.  The sub-block maxima go
// to the segment's scratch (seg_max, [nblk, kMaxSub]) and the item's
// largest raises the later lag blocks' floors (seg_floors, [nblk]); thread
// 0 adds its live pair terms to *done.  Thread 0 writes `fetched` to *item
// once every thread has passed the gate's barrier; a passing item's last
// barrier makes it seen, a caller of a failing item makes it seen.  Every
// thread of the block calls it.  It needs no barrier before it: the last
// item's reads of s_cs and s_w end at its last barrier, and s_max is read
// and written by warp 0's lanes alone, each its own word.
__device__ __forceinline__ bool scan_item(
    const float* __restrict__ row, int n, int npad, int k, int blk,
    int sub, int nblk, const Part& P, int i0,
    int* __restrict__ seg_max, int* __restrict__ seg_floors, float gate,
    float seed, unsigned long long* done, volatile unsigned* item,
    unsigned fetched) {
  // s_cs[j] = cs2[i0 + l0 + j]; s_w[t] = w(l0 + t), -inf when not live
  __shared__ __align__(16) float s_cs[kTile + kPartLags + kRun];
  __shared__ __align__(16) float s_w[kPartLags];
  __shared__ int s_max[kMaxSub];
  const int q_lo = P.q_lo, q_hi = P.q_hi;
  // lags l0 + t, t < n_lags; a block of under kRun lags is one run
  const int l0 = k * blk + q_lo * sub;
  const int n_lags = max((q_hi - q_lo) * sub, kRun);
  const int tid = threadIdx.x;
  // other blocks raise the floor meanwhile, so the threads may read it at
  // different values: the item goes on if any of them admits it, so that
  // every thread has staged its share
  const float floor_k = fmaxf(seed, decode(__ldcg(seg_floors + k)));
  for (int j = tid; j < kTile + n_lags + kRun; j += kThreads) {
    const int g = i0 + l0 + j;
    s_cs[j] = g < npad ? row[g] : 0.0f;
  }
  for (int t = tid; t < n_lags; t += kThreads) {
    const int L = l0 + t;
    s_w[t] = (L >= P.L_lo && L <= P.L_hi) ? w_of(L, n)
                                           : __int_as_float(0xFF800000);
  }
  // s_max[q] is written and, after the scan, read by lane q of warp 0
  if (tid < q_hi - q_lo) s_max[tid] = encode(-1.0f);
  const int i_t = i0 + kPos * tid;          // this thread's first position
  float c[kPos];
#pragma unroll
  for (int p = 0; p < kPos; ++p) c[p] = i_t + p < npad ? row[i_t + p] : 0.0f;
  // the item's live pair terms, for the tally
  __shared__ unsigned long long s_terms;
  if (tid == 0) s_terms = tile_terms(n, i0, P.L_lo, P.L_hi);
  const bool go = __syncthreads_or(gate > floor_k);
  if (tid == 0) *item = fetched;
  if (!go) return false;

  const int span = max(sub, kRun);          // lags of one sub-block's runs
  for (int q = 0; q < q_hi - q_lo; ++q) {
    float m = -1.0f;
    for (int t = q * sub; t < q * sub + span; t += kRun) {
      const int L = l0 + t;                 // the run's first lag
      const int L_lo = max(L, P.L_lo);
      const int L_hi = min(L + kRun - 1, P.L_hi);
      // no live lag in the run (the same for the whole block), or no live
      // position of this thread for any of them
      if (L_lo > L_hi || i_t > n - 1 - L_lo) continue;
      float win[kPos + kRun];
      const float4* w4 = reinterpret_cast<const float4*>(s_cs + kPos * tid + t);
#pragma unroll
      for (int v = 0; v < (kPos + kRun) / 4; ++v) {
        const float4 x = w4[v];
        win[4 * v] = x.x;
        win[4 * v + 1] = x.y;
        win[4 * v + 2] = x.z;
        win[4 * v + 3] = x.w;
      }
      // a run that crosses i + L = n - 1: term (p, u) is dead when p + u >
      // lim, so window value j > lim is made a NaN, whose terms fmaxf
      // leaves out (it returns the other operand).  A lag with no live
      // position here keeps D = 0; it always pairs with position 0, whose
      // term is >= 0, so that 0 never raises a sub-block's maximum over the
      // segment.
      const int lim = n - 1 - L - i_t;
      if (lim < kPos + kRun - 2) {
#pragma unroll
        for (int j = 0; j < kPos + kRun; ++j)
          if (j > lim) win[j] = __int_as_float(0x7FFFFFFF);
      }
      float D[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) D[u] = 0.0f;
#pragma unroll
      for (int p = 0; p < kPos; ++p)
#pragma unroll
        for (int u = 0; u < kRun; ++u)
          D[u] = fmaxf(D[u], fabsf(__fsub_rn(win[p + u], c[p])));
      // max_i fl(w fl(d_i d_i)) = fl(w fl(D D)): both roundings are
      // monotone.  A lag that is not live has w = -inf: its product is
      // -inf or NaN, and fmaxf keeps m.
      const float4* s4 = reinterpret_cast<const float4*>(s_w + t);
#pragma unroll
      for (int v = 0; v < kRun / 4; ++v) {
        const float4 w = s4[v];
        m = fmaxf(m, __fmul_rn(w.x, __fmul_rn(D[4 * v], D[4 * v])));
        m = fmaxf(m, __fmul_rn(w.y, __fmul_rn(D[4 * v + 1], D[4 * v + 1])));
        m = fmaxf(m, __fmul_rn(w.z, __fmul_rn(D[4 * v + 2], D[4 * v + 2])));
        m = fmaxf(m, __fmul_rn(w.w, __fmul_rn(D[4 * v + 3], D[4 * v + 3])));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    if ((tid & 31) == 0) atomicMax(&s_max[q], encode(m));
  }
  __syncthreads();
  if (tid >= 32) return true;
  int top = encode(-1.0f);
  if (tid < q_hi - q_lo) {
    top = s_max[tid];
    atomicMax(&seg_max[k * kMaxSub + q_lo + tid], top);
  }
  // Raise the floors of the later lag blocks.  Any term of block k is at
  // most the walk's running best before a later block: the walk admits
  // block k and takes its maximum, or rejects it with a best of at least
  // its gate, which bounds every term of the block (psd2 bounds d^2, w of
  // the block's ends bounds w, and the f32 roundings are monotone).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = max(top, __shfl_xor_sync(0xFFFFFFFFu, top, off));
  if (decode(top) >= 0.0f)
    for (int kk = k + 1 + tid; kk < nblk; kk += 32)
      atomicMax(&seg_floors[kk], top);
  if (tid == 0) *done += s_terms;
  return true;
}

// The rows [r0, r0 + kMaxRows) under the mask, in order, listed in
// s_row, s_n, s_laghi and s_seed; returns how many.  Every thread of the
// block calls it; it ends with a barrier.
__device__ __forceinline__ int list_rows(
    int r0, int n_seg, const bool* __restrict__ mask,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ laghi_arr,
    const float* __restrict__ seed, int* s_row, int* s_n, int* s_laghi,
    float* s_seed, int* s_warp) {
  int R = 0;
  for (int c = 0; c < kMaxRows && r0 + c < n_seg; c += kThreads) {
    const int b = r0 + c + threadIdx.x;
    const bool on = b < n_seg;
    // the row's loads go with the mask's
    const bool in = on && (!mask || mask[b]);
    const int nb = on ? n_arr[b] : 0, lb = on ? laghi_arr[b] : 0;
    const float sb = on ? seed[b] : 0.0f;
    int listed;
    const int at = R + block_scan(in, s_warp, listed);
    if (in) {
      s_row[at] = b;
      s_n[at] = nb;
      s_laghi[at] = lb;
      s_seed[at] = sb;
    }
    R += listed;
  }
  __syncthreads();
  return R;
}

// Phase 1, a persistent grid (the note at the top: the list).  Every block
// walks the same list, rows kMaxRows at a time and units kChunk at a time,
// and computes the items it takes: first item blockIdx.x, then each from
// the counter `next`.  The walk's state is block-uniform and kept in
// shared memory.  An item's gate is its unit's, tested in scan_item.
__global__ void __launch_bounds__(kThreads) arc_scan_blocks(
    const float* __restrict__ cs, const int32_t* __restrict__ n_arr,
    const int32_t* __restrict__ laghi_arr, const float* __restrict__ seed,
    const float* __restrict__ psd2, int* __restrict__ scratch,
    int* __restrict__ floors, unsigned* __restrict__ next, int n_seg,
    int npad, int al0, int blk, int sub, int nblk, int nsub, int ld,
    const bool* __restrict__ mask, const long long* __restrict__ live,
    long long* __restrict__ terms) {
  if (live && !*live) return;
  __shared__ int s_row[kMaxRows], s_n[kMaxRows], s_laghi[kMaxRows];
  __shared__ float s_seed[kMaxRows];
  __shared__ int s_off[kChunk];             // a chunk's units: item offsets
  __shared__ float s_gate[kChunk];          // and gates
  __shared__ int s_warp[kThreads / 32];
  // the walk: rows listed from r0, R of them; the chunk of units from u0,
  // its items from base, total of them; the block's next item
  __shared__ volatile int s_r0, s_R, s_u0, s_total;
  __shared__ volatile unsigned s_base, s_item;
  __shared__ unsigned long long s_done;     // pair terms computed
  const int tid = threadIdx.x;
  {
    const int R = list_rows(0, n_seg, mask, n_arr, laghi_arr, seed, s_row,
                            s_n, s_laghi, s_seed, s_warp);
    if (tid == 0) {
      s_r0 = 0;
      s_R = R;
      s_u0 = -kChunk;
      s_base = 0;
      s_total = 0;
      s_item = blockIdx.x;
      s_done = 0;
    }
    __syncthreads();
  }
  for (;;) {
    // list chunks up to the one holding the block's next item
    while (s_item - s_base >= unsigned(s_total)) {
      const unsigned base = s_base + s_total;
      int r0 = s_r0, R = s_R, u0 = s_u0 + kChunk;
      if (u0 >= nblk * R) {                 // the next rows
        r0 += kMaxRows;
        if (r0 >= n_seg) {
          if (terms && tid == 0 && s_done)
            atomicAdd(reinterpret_cast<unsigned long long*>(terms), s_done);
          return;
        }
        R = list_rows(r0, n_seg, mask, n_arr, laghi_arr, seed, s_row, s_n,
                      s_laghi, s_seed, s_warp);
        u0 = 0;
      }
      // units u = k * R + r: (lag block k, listed row r); unit u0 + j of
      // the chunk is counted by thread j % kThreads
      float g[kUnits];
#pragma unroll
      for (int v = 0; v < kUnits; ++v) {
        const int u = u0 + v * kThreads + tid;
        g[v] = u < nblk * R ? psd2[int64_t(s_row[u % R]) * nblk + u / R]
                            : 0.0f;
      }
#pragma unroll
      for (int v = 0; v < kUnits; ++v) {
        const int u = u0 + v * kThreads + tid, k = u / max(R, 1),
                  r = u - k * R;
        int items = 0;
        if (u < nblk * R) {
          const int n = s_n[r], lag_hi = s_laghi[r];
          g[v] = block_gate(k, blk, n, lag_hi, al0, g[v]);
          if (g[v] > s_seed[r])
            for (int part = 0; part < kSplit; ++part)
              items += Part(k, part, blk, sub, nsub, al0, lag_hi).tiles(n);
        }
        s_off[v * kThreads + tid] = items;
        s_gate[v * kThreads + tid] = g[v];
      }
      __syncthreads();
      // their item offsets, in unit order: thread t sums units kUnits * t
      // .. kUnits * t + kUnits - 1
      int count[kUnits], sum = 0;
#pragma unroll
      for (int v = 0; v < kUnits; ++v) {
        count[v] = s_off[kUnits * tid + v];
        sum += count[v];
      }
      int total;
      int off = block_scan(sum, s_warp, total);   // begins with a barrier
#pragma unroll
      for (int v = 0; v < kUnits; ++v) {
        s_off[kUnits * tid + v] = off;
        off += count[v];
      }
      if (tid == 0) {
        s_r0 = r0;
        s_R = R;
        s_u0 = u0;
        s_base = base;
        s_total = total;
      }
      __syncthreads();
    }
    unsigned fetched = 0;
    if (tid == 0) fetched = atomicAdd(next, 1u) - kCounterBase + gridDim.x;
    // the unit: the last t with s_off[t] <= local (units without an item
    // share the next one's offset)
    int local = static_cast<int>(s_item - s_base), t = 0;
#pragma unroll
    for (int step = kChunk / 2; step > 0; step >>= 1)
      if (s_off[t + step] <= local) t += step;
    const int R = s_R, u = s_u0 + t, k = u / R, r = u - k * R;
    const int b = s_row[r], n = s_n[r], lag_hi = s_laghi[r];
    const float gate = s_gate[t], seed_r = s_seed[r];
    // the item's quarter and tile
    local -= s_off[t];
    int part = 0;
    Part P(k, 0, blk, sub, nsub, al0, lag_hi);
    for (int tl = P.tiles(n); local >= tl; tl = P.tiles(n)) {
      local -= tl;
      P = Part(k, ++part, blk, sub, nsub, al0, lag_hi);
    }
    const int i0 = local * kTile;
    if (!scan_item(cs + int64_t(b) * ld, n, npad, k, blk, sub, nblk, P, i0,
                   scratch + int64_t(b) * nblk * kMaxSub,
                   floors + int64_t(b) * nblk, gate, seed_r, &s_done, &s_item,
                   fetched))
      __syncthreads();                      // s_item written
  }
}

// Phase 2.  One thread block per segment.  Within a block the walk's
// updates on strict > leave best = max(best, M) and bl0 at the first
// sub-block that holds M = the block's largest sub-block maximum, when
// M > best.  So, kThreads blocks at a time, thread t loads block k0 + t's
// sub-block maxima and finds (M, its first sub-block) and the block's gate
// (w_bound * psd2, -inf when out of range); then thread 0 walks those
// blocks in ascending order through shared memory: a block is admitted
// when its gate is above the running best and updates it when M is.
__global__ void __launch_bounds__(kThreads) arc_scan_replay(
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ laghi_arr,
    const float* __restrict__ seed, const float* __restrict__ psd2,
    const int* __restrict__ scratch, float* __restrict__ best_out,
    int32_t* __restrict__ bl0_out, int al0, int blk, int sub, int nblk,
    int nsub, const bool* __restrict__ mask,
    const long long* __restrict__ live) {
  __shared__ float s_gate[kThreads];
  __shared__ float s_m[kThreads];
  __shared__ int s_q[kThreads];
  const int b = blockIdx.x;
  if (skip_row(live, mask, b)) return;
  const int tid = threadIdx.x;
  const int n = n_arr[b];
  const int lag_hi = laghi_arr[b];
  float best = seed[b];
  int bl0 = -1;
  for (int k0 = 0; k0 < nblk; k0 += kThreads) {
    const int k = k0 + tid;
    if (k < nblk) {
      s_gate[tid] = block_gate(k, blk, n, lag_hi, al0,
                               psd2[int64_t(b) * nblk + k]);
      const int* sm = scratch + (int64_t(b) * nblk + k) * kMaxSub;
      int v[kMaxSub];
#pragma unroll
      for (int q = 0; q < kMaxSub; ++q) v[q] = q < nsub ? sm[q] : v[0];
      float m = decode(v[0]);
      int qm = 0;
#pragma unroll
      for (int q = 1; q < kMaxSub; ++q) {
        if (q < nsub && decode(v[q]) > m) {
          m = decode(v[q]);
          qm = q;
        }
      }
      s_m[tid] = m;
      s_q[tid] = qm;
    }
    __syncthreads();
    if (tid == 0) {
      const int kn = min(kThreads, nblk - k0);
      for (int kk = 0; kk < kn; ++kk) {
        if (s_gate[kk] > best && s_m[kk] > best) {
          best = s_m[kk];
          bl0 = (k0 + kk) * blk + s_q[kk] * sub;
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    best_out[b] = best;
    bl0_out[b] = bl0;
  }
}

}  // namespace

// B4.  cs f32 rows of ld floats (the first npad used), n, lag_hi int32,
// seed f32 [n_seg], psd2 f32 [n_seg, nblk]; scratch int32 [1 + n_seg *
// nblk * 17]; outputs best f32 and bl0 int32 [n_seg].  Phase 1 runs on `grid`
// blocks (arc_scan_occupancy's SMs times blocks an SM).  mask (bool
// [n_seg]), live (int64 scalar) and terms (int64 scalar) may be null: a
// segment outside the mask, or every segment where live is 0, is left
// out and writes nothing; terms gains the live pair terms phase 1
// computed.
extern "C" int arc_scan(const void* cs, const void* n, const void* lag_hi,
                        const void* seed, const void* psd2, void* scratch,
                        void* best, void* bl0, int n_seg, int npad, int al0,
                        int ld, int grid, const void* mask, const void* live,
                        void* terms, void* stream) {
  if (n_seg <= 0) return 0;
  if (ld < npad || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool* m = static_cast<const bool*>(mask);
  const long long* lv = static_cast<const long long*>(live);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blk = npad < kBlk ? npad : kBlk;
  const int sub = blk < kSub ? blk : kSub;
  const int nblk = (npad + blk - 1) / blk > 0 ? (npad + blk - 1) / blk : 1;
  const int nsub = blk / sub;
  // phase 1's items, and those it fetches past the last, count in 32 bits
  if (int64_t(n_seg) * nblk * kSplit * ((npad + kTile - 1) / kTile) +
          2 * int64_t(grid) >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // scratch: phase 1's item counter, the sub-block maxima [n_seg, nblk,
  // kMaxSub], then the floors [n_seg, nblk], as encoded ints
  const int64_t n_max = int64_t(n_seg) * nblk * kMaxSub;
  const int64_t count = 1 + n_max + int64_t(n_seg) * nblk;
  auto* sc = static_cast<int*>(scratch);
  auto* next = reinterpret_cast<unsigned*>(sc);
  int* mx = sc + 1;
  // Every scratch word starts at 0x80808080, a negative int: it decodes to
  // a negative float, below every encoded sub-block maximum (>= -1) and
  // below every running best (>= seed >= 0), so a word that phase 1 never
  // raised can neither take an atomicMax nor beat the best in phase 2; the
  // counter starts at kCounterBase.
  cudaError_t err = cudaMemsetAsync(sc, 0x80, size_t(count) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  arc_scan_blocks<<<unsigned(grid), kThreads, 0, s>>>(
      static_cast<const float*>(cs), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(lag_hi), static_cast<const float*>(seed),
      static_cast<const float*>(psd2), mx, mx + n_max, next, n_seg, npad,
      al0, blk, sub, nblk, nsub, ld, m, lv, static_cast<long long*>(terms));
  arc_scan_replay<<<unsigned(n_seg), kThreads, 0, s>>>(
      static_cast<const int32_t*>(n), static_cast<const int32_t*>(lag_hi),
      static_cast<const float*>(seed), static_cast<const float*>(psd2), mx,
      static_cast<float*>(best), static_cast<int32_t*>(bl0), al0, blk, sub,
      nblk, nsub, m, lv);
  return static_cast<int>(cudaGetLastError());
}

// Phase 1's grid on the current device: its SMs, and the blocks of
// arc_scan_blocks that the occupancy calculator lets each hold at once,
// into out[2].  Read once a device by the wrapper, outside any capture.
extern "C" int arc_scan_occupancy(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], arc_scan_blocks, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return out[1] > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// The whole-recursion CBS engine's walk and edge-test kernels, K7 and K8,
// for Hopper.
//
// K7 (cbs_walk) replaces canvas_tpu/ops/cbs_mega.py:419-448, the level's
// walk lax.while_loop, with _chunk_stats (:142-167) and through it
// cbs_device.py's _device_perms (:595), _htmax_core (:608) and
// _tmax_full_core (:636), all XLA.  K8 (cbs_edge) replaces the edge-test
// lax.while_loop of _edge_tests (:217-285), XLA too.  Per level the port
// launches each once; the loops that canvas_tpu runs on its device (and
// that the port used to drive from the host, a read from the card a loop
// test) run here:
//
//   K7, per walking row r (n bins, tier width npad = the smallest power of
//   two >= max(n, 1024), key k_r): chunk c = 0, 1, ... draws under
//   fold_in(k_r, c) the uniform u[p][j] = bits(p * npad + j) for the
//   P = 512 permutations p and the positions j < n (the padding draws 2.0
//   in canvas_tpu and sorts last, so only real positions are drawn), orders
//   each permutation's positions by (u, j), takes the cumsum of x in that
//   order (float64, rounded to f32 at each position), the hybrid or the
//   full max-t statistic, and then walks the row's boundary over the 512
//   statistics in order (_walk_update), until the row is decided.
//   K8, per active lane l (wn values, tier width of wn, key e_l, subset size
//   m1): chunk c draws under fold_in(e_l, c) the 32-bit keys
//   bits(p * npad + j), j < wn, selects each permutation's m1-th smallest
//   key tau, sums (float64) the values with key < tau and the first
//   m1 - #(key < tau) with key == tau in index order, and counts the
//   statistics |sum / m1 - xbar| >= ostat among the first n_perm - done
//   permutations, until the count passes limit or n_perm are done.
//
// A row's chunk c depends on its own key and counter alone, so rows need
// not share iterations as canvas_tpu's compaction of 8 rows does: every
// walking row (active lane) takes its next chunk in each iteration of one
// loop on the card.
//
// Shape of a launch.  One thread block of 1024 threads an SM, all resident
// (a cooperative launch), looping:
//   1. the rows still walking, listed by every block from the state arrays;
//   2. the (row, permutation) items of their next chunks, spread over the
//      blocks; a block computes one item at a time with all its threads;
//   3. a grid-wide barrier, then block 0 updates each row from its 512
//      results (a warp a row) and a barrier again.
// The loop ends when no row walks; nothing returns to the host between.
//
// What bounds it.  Per item the work is the n draws of a 20-round integer
// cipher (K7 draws twice, as its bucket sort scatters from a second draw
// rather than a second buffer), a sort (K7) or a selection (K8) over
// shared memory, and for K7 the statistic: (kmax - al0 + 1) * n terms,
// each a subtraction and a |.|-maximum.  All of it is integer and f32 issue
// slots on data in shared memory; device memory sees only x (L2-resident,
// gathered in permuted order) and the results, so the kernels are bound by
// their operations.  The design keeps every permutation's positions in
// shared memory (up to 32,768 of them; the widest tier, 65,536, uses a
// per-block slab of device memory) and uses every thread of the block on
// one item, so a chunk of a single row still spreads over the whole card.
//
// The sort.  u = m * 2^-23 with m the draw's top 23 bits, so the order
// (u, j) is the order of the 39-bit words (m, j).  A counting pass over the
// top B bits of m (B = log2(npad) - 3, 7..13, so about 8 positions a
// bucket) places each position in its bucket, as the 32-bit word
// (low 23 - B bits of m, j); an insertion sort in each bucket finishes the
// order.  The selection of K8 is a radix select over 4 digits of 8 bits.
//
// Exactness.  The draws are ops/threefry.py's bit for bit.  The statistic
// takes every f32 product, quotient and difference with the correctly
// rounded intrinsics (__fmul_rn, __fdiv_rn, __fsub_rn, __fadd_rn), nothing
// contracted, in the plain version's order: w = n / (L (n - L)), the term
// (w D) D with D the maximum |d| over the lag's arcs, then the tss rule and
// best / ((tssv - best) / (n - 2)).  Maxima and counts do not depend on
// their order.  The float64 cumsum and subset sum add the same values as
// the plain version but in another association (per-thread runs, then a
// tree); float64 sums of these f32 values round to the same f32 unless the
// exact sum lies within a few float64 ulps of an f32 rounding boundary.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 512;               // permutations a chunk (P_CHUNK)
constexpr int kSmemWords = 32768;     // positions of a permutation in smem
constexpr int kLagTile = 256;         // lags whose maxima are gathered at once
constexpr int kRadix = 256;           // K8's digit

typedef long long i64;

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

// A key held as two uint32 values in int64 words.
__device__ __forceinline__ uint2 load_key(const i64* keys, int r) {
  return make_uint2(uint32_t(keys[2 * r]), uint32_t(keys[2 * r + 1]));
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
    const T t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += t;
  }
  T excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T w = sh[lane];
    T wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T t = __shfl_up_sync(0xFFFFFFFFu, wi, o);
      if (lane >= o) wi += t;
    }
    T we = __shfl_up_sync(0xFFFFFFFFu, wi, 1);
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

// The rows (lanes) r < count whose flag is set, in index order, into list;
// returns how many.  Every block computes the same list.
__device__ int list_flagged(const int32_t* flags, int count, int* list,
                            uint32_t* sh) {
  const int t = threadIdx.x;
  const uint32_t f = (t < count) ? uint32_t(__ldcg(flags + t) != 0) : 0u;
  uint32_t total;
  const uint32_t at = block_exclusive_scan<uint32_t>(f, sh, &total);
  if (f) list[at] = t;
  __syncthreads();
  return int(total);
}

// The block's shared memory: reductions, the row list, lag maxima, the
// histogram and one permutation's positions.
struct Shared {
  double* red_d;     // kWarps + 1
  uint32_t* red_u;   // kWarps + 1
  int* list;         // kThreads
  int* misc;         // 8
  float* lag_d;      // kLagTile, as uint32 bits of non-negative floats
  uint32_t* hist;    // the bucket counts
  uint32_t* buf;     // kSmemWords positions
};

__device__ Shared carve(unsigned char* raw, int hist_words) {
  Shared s;
  s.red_d = reinterpret_cast<double*>(raw);
  s.red_u = reinterpret_cast<uint32_t*>(s.red_d + kWarps + 1);
  s.list = reinterpret_cast<int*>(s.red_u + kWarps + 1);
  s.misc = s.list + kThreads;
  s.lag_d = reinterpret_cast<float*>(s.misc + 8);
  s.hist = reinterpret_cast<uint32_t*>(s.lag_d + kLagTile);
  s.buf = s.hist + hist_words;
  return s;
}

__host__ __device__ constexpr int fixed_smem_bytes() {
  return (kWarps + 1) * 8 + (kWarps + 1) * 4 + kThreads * 4 + 8 * 4
         + kLagTile * 4;
}

__device__ __forceinline__ int log2_pow2(int v) { return 31 - __clz(v); }

__host__ __device__ inline int bucket_bits(int npad_log2) {
  const int b = npad_log2 - 3;
  return b < 7 ? 7 : (b > 13 ? 13 : b);
}

// ---------------------------------------------------------------------------
// K7: one permutation's max-t statistic
// ---------------------------------------------------------------------------

__device__ __forceinline__ int tier_of(int n) {
  int w = 1024;
  while (w < n) w <<= 1;
  return w;
}

// The positions j < n of permutation p under key, ordered by (u, j), as
// 32-bit words (low bits of m, j) in buf[0, n).
__device__ void permute(uint2 key, int n, int npad, int p, uint32_t* hist,
                        uint32_t* buf, uint32_t* red_u) {
  const int tid = threadIdx.x;
  const int B = bucket_bits(log2_pow2(npad));
  const int nb = 1 << B, shift = 23 - B;
  const uint32_t low = (1u << shift) - 1u;
  const uint64_t base = uint64_t(p) * uint64_t(npad);
  for (int b = tid; b < nb; b += kThreads) hist[b] = 0u;
  __syncthreads();
  for (int j = tid; j < n; j += kThreads)
    atomicAdd(&hist[(draw_bits(key, base + j) >> 9) >> shift], 1u);
  __syncthreads();
  // bucket starts: thread t owns the buckets [t * per, t * per + per)
  const int per = (nb + kThreads - 1) / kThreads;
  const int b0 = tid * per, b1 = min(nb, b0 + per);
  uint32_t mine = 0u;
  for (int b = b0; b < b1; ++b) mine += hist[b];
  uint32_t total;
  uint32_t at = block_exclusive_scan<uint32_t>(mine, red_u, &total);
  for (int b = b0; b < b1; ++b) {
    const uint32_t c = hist[b];
    hist[b] = at;
    at += c;
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    const uint32_t m = draw_bits(key, base + j) >> 9;
    const uint32_t slot = atomicAdd(&hist[m >> shift], 1u);
    buf[slot] = ((m & low) << 16) | uint32_t(j);
  }
  __syncthreads();
  // hist[b] is now the end of bucket b; sort each bucket's words
  for (int b = tid; b < nb; b += kThreads) {
    const int lo = b ? int(hist[b - 1]) : 0, hi = int(hist[b]);
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
  __syncthreads();
}

// The f32 cumsum (float64 running sums, rounded at each position) of
// xrow in the order of buf[0, n), written over buf as f32 bits.
__device__ void permuted_cumsum(const float* __restrict__ xrow, int n,
                                uint32_t* buf, double* red_d) {
  const int tid = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int k0 = min(n, tid * per), k1 = min(n, k0 + per);
  double run = 0.0;
  for (int k = k0; k < k1; ++k) run += double(__ldg(xrow + (buf[k] & 0xFFFFu)));
  double total;
  double acc = block_exclusive_scan<double>(run, red_d, &total);
  for (int k = k0; k < k1; ++k) {
    acc += double(__ldg(xrow + (buf[k] & 0xFFFFu)));
    buf[k] = __float_as_uint(__double2float_rn(acc));
  }
  __syncthreads();
}

// w(L) = n / (L (n - L)) and the term (w D) D, as the plain version rounds.
__device__ __forceinline__ float arc_term(float nf, int L, float D) {
  const float Lf = float(L);
  const float w = __fdiv_rn(nf, __fmul_rn(Lf, __fsub_rn(nf, Lf)));
  return __fmul_rn(__fmul_rn(w, D), D);
}

// The max-t statistic of the cumsum cs[0, n) (thread 0's value): hybrid,
// lags al0 .. min(kmax, npad - 1) with wrap arcs; full, lags al0 ..
// min(max_lag, n - al0, n - 1) with max_lag = min(top - al0, top - 1),
// top = min(n_min, npad).  Lags above n - 1 contribute nothing.
__device__ float max_t(const float* cs, int n, int npad, float tss,
                       bool hybrid, int al0, int kmax, int n_min,
                       float* lag_d) {
  const int tid = threadIdx.x;
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
    for (int i = tid; i < nl; i += kThreads) lag_d[i] = 0.0f;
    __syncthreads();
    const int G = kThreads / nl;
    if (tid < G * nl) {
      const int li = tid % nl, g = tid / nl, L = L0 + li;
      float m = 0.0f;
      for (int i = g; i + L <= n - 1; i += G)
        m = fmaxf(m, fabsf(__fsub_rn(cs[i + L], cs[i])));
      if (hybrid)
        for (int j = g; j < L; j += G)
          m = fmaxf(m, fabsf(__fsub_rn(cs[n - L + j], cs[j])));
      // non-negative floats order as their bits
      atomicMax(reinterpret_cast<unsigned int*>(lag_d + li),
                __float_as_uint(m));
    }
    __syncthreads();
    if (tid == 0)
      for (int li = 0; li < nl; ++li)
        best = fmaxf(best, arc_term(nf, L0 + li, lag_d[li]));
    __syncthreads();
  }
  const float tssv = (tss <= __fadd_rn(best, 1e-4f)) ? __fadd_rn(best, 1.0f)
                                                     : tss;
  return __fdiv_rn(best, __fdiv_rn(__fsub_rn(tssv, best),
                                   __fsub_rn(nf, 2.0f)));
}

struct WalkArgs {
  const float* x;          // [W, Tmax]
  const i64* n;            // [W]
  const float* tss;
  const i64* keys;         // [W, 2]
  const bool* walking0;
  const bool* hybrid;
  const float* ostat;
  const i64* nrejc;
  const i64* sbdry;        // [n_sbdry]
  i64* st_np;              // state [4, W]: np, nrej, k, walking
  i64* st_nrej;
  i64* st_k;
  int32_t* st_walk;        // walking flags (in the 4th state row)
  float* pstats;           // [W, kP]
  uint32_t* gbuf;          // [gridDim.x, Tmax] where npad > kSmemWords
  bool* accepted;
  i64* chunks;
  float* first_stats;      // [W, kP] or null
  int W, Tmax, n_sbdry, n_perm, al0, kmax, n_min, hist_words;
};

// Row r's boundary walk over its chunk's statistics (_walk_update), by one
// warp: 32 statistics at a time, the running count by ballots, the first
// reject and the first accept of each 32 by their lowest set bits.
__device__ void walk_update(const WalkArgs& a, int r) {
  const int lane = threadIdx.x & 31;
  const float os = a.ostat[r];
  const i64 qc = a.nrejc[r];
  const i64 np0 = __ldcg(a.st_np + r);
  const i64 nrej0 = __ldcg(a.st_nrej + r);
  const i64 k0 = __ldcg(a.st_k + r);
  const float* ps = a.pstats + size_t(r) * kP;
  i64 before = 0;                   // exceedances before this 32
  bool decided = false, accept = false;
  for (int j0 = 0; j0 < kP && !decided; j0 += 32) {
    const int j = j0 + lane;
    const uint32_t ind = __ballot_sync(0xFFFFFFFFu, os <= __ldcg(ps + j));
    const i64 csum = before + __popc(ind & (0xFFFFFFFFu >> (31 - lane)));
    const i64 npj = np0 + j + 1;
    i64 idx = k0 + csum - 1;
    idx = idx < 0 ? 0 : (idx > a.n_sbdry - 1 ? a.n_sbdry - 1 : idx);
    const uint32_t rej = __ballot_sync(0xFFFFFFFFu, nrej0 + csum > qc);
    const uint32_t acc = __ballot_sync(
        0xFFFFFFFFu, npj >= a.sbdry[idx] || npj >= a.n_perm);
    if (rej | acc) {
      // reject is checked first: an accept wins only strictly earlier
      decided = true;
      accept = acc && (!rej || __ffs(acc) < __ffs(rej));
    }
    before += __popc(ind);
  }
  if (lane == 0) {
    const i64 np1 = np0 + kP;
    const bool exhausted = !decided && np1 >= a.n_perm;
    a.st_np[r] = np1;
    a.st_nrej[r] = nrej0 + before;
    a.st_k[r] = k0 + before;
    a.chunks[r] = __ldcg(a.chunks + r) + 1;
    if (accept || exhausted) a.accepted[r] = true;
    a.st_walk[r] = (!decided && !exhausted) ? 1 : 0;
  }
}

// Block 0, after a chunk: each warp updates the walking rows w, w + 32, ...
__device__ void walk_updates(const WalkArgs& a) {
  for (int r = threadIdx.x >> 5; r < a.W; r += kWarps)
    if (__ldcg(a.st_walk + r)) walk_update(a, r);
}

__global__ void __launch_bounds__(kThreads, 1) walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Shared s = carve(smem_raw, a.hist_words);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < a.W) {
    const i64 q = a.nrejc[tid];
    a.st_np[tid] = 0;
    a.st_nrej[tid] = 0;
    a.st_k[tid] = q * (q + 1) / 2 + 1;
    a.st_walk[tid] = a.walking0[tid] ? 1 : 0;
    a.accepted[tid] = false;
    a.chunks[tid] = 0;
  }
  grid.sync();
  uint32_t* gbuf = a.gbuf + size_t(blockIdx.x) * size_t(a.Tmax);
  for (int it = 0;; ++it) {
    const int nact = list_flagged(a.st_walk, a.W, s.list, s.red_u);
    if (nact == 0) break;
    for (i64 item = blockIdx.x; item < i64(nact) * kP; item += gridDim.x) {
      const int r = s.list[item / kP], p = int(item % kP);
      const int n = int(a.n[r]);
      const int npad = tier_of(n);
      uint32_t* buf = npad <= kSmemWords ? s.buf : gbuf;
      const uint2 key = fold_in(load_key(a.keys, r),
                                uint32_t(__ldcg(a.chunks + r)));
      permute(key, n, npad, p, s.hist, buf, s.red_u);
      permuted_cumsum(a.x + size_t(r) * a.Tmax, n, buf, s.red_d);
      const float st = max_t(reinterpret_cast<const float*>(buf), n, npad,
                             a.tss[r], a.hybrid[r], a.al0, a.kmax, a.n_min,
                             s.lag_d);
      if (tid == 0) {
        a.pstats[size_t(r) * kP + p] = st;
        if (it == 0 && a.first_stats) a.first_stats[size_t(r) * kP + p] = st;
      }
    }
    grid.sync();
    if (blockIdx.x == 0) walk_updates(a);
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// K8: one permutation's subset sum
// ---------------------------------------------------------------------------

// The rank-th smallest (1-based) of buf[0, wn), by 4 passes of 8-bit digits
// from the top; every thread returns it.
__device__ uint32_t radix_select(const uint32_t* buf, int wn, int rank,
                                 uint32_t* hist, int* misc) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0u, mask = 0u;
  int rem = rank;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < kRadix; b += kThreads) hist[b] = 0u;
    __syncthreads();
    for (int j = tid; j < wn; j += kThreads) {
      const uint32_t u = buf[j];
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // lane owns digits [8 lane, 8 lane + 8)
      uint32_t c[8], sum = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[8 * lane + i];
        sum += c[i];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += t;
      }
      const uint32_t excl = incl - sum;
      if (excl < uint32_t(rem) && uint32_t(rem) <= incl) {
        uint32_t before = excl;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (uint32_t(rem) <= before + c[i]) {
            misc[0] = 8 * lane + i;
            misc[1] = rem - int(before);
            break;
          }
          before += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= uint32_t(misc[0]) << shift;
    mask |= 0xFFu << shift;
    rem = misc[1];
    __syncthreads();
  }
  return prefix;
}

// The float64 sum (rounded to f32) of xrow over the m1 positions whose keys
// buf[0, wn) are the m1 smallest, ties by index (thread 0's value).
__device__ float subset_sum(const float* __restrict__ xrow, int wn, int m1,
                            uint32_t tau, const uint32_t* buf, double* red_d,
                            uint32_t* red_u) {
  const int tid = threadIdx.x;
  const int per = (wn + kThreads - 1) / kThreads;
  const int j0 = min(wn, tid * per), j1 = min(wn, j0 + per);
  uint32_t less = 0u, ties = 0u;
  for (int j = j0; j < j1; ++j) {
    const uint32_t u = buf[j];
    less += u < tau;
    ties += u == tau;
  }
  uint32_t n_less, n_ties;
  block_exclusive_scan<uint32_t>(less, red_u, &n_less);
  uint32_t rank = block_exclusive_scan<uint32_t>(ties, red_u, &n_ties);
  const uint32_t k_t = uint32_t(m1) - n_less;
  double sum = 0.0;
  for (int j = j0; j < j1; ++j) {
    const uint32_t u = buf[j];
    if (u < tau) {
      sum += double(__ldg(xrow + j));
    } else if (u == tau) {
      ++rank;
      if (rank <= k_t) sum += double(__ldg(xrow + j));
    }
  }
  double total;
  block_exclusive_scan<double>(sum, red_d, &total);
  return __double2float_rn(total);
}

struct EdgeArgs {
  const float* xw;         // [L, Tmax]
  const i64* wn;
  const i64* m1;
  const float* xbar;
  const float* ostat;
  const bool* active0;
  const i64* ekeys;        // [L, 2]
  const float* limit;      // scalar
  i64* st_done;            // state [2, L]: done, active
  int32_t* st_act;
  float* sums;             // [L, kP]
  uint32_t* gbuf;
  i64* count;
  i64* cnt;
  float* first_sums;       // [L, kP] or null
  int L, Tmax, n_perm;
};

// Lane l's count over its chunk's subset sums, by one warp.
__device__ void edge_update(const EdgeArgs& a, int l) {
  const int lane = threadIdx.x & 31;
  const i64 done = __ldcg(a.st_done + l);
  const i64 take = min(i64(a.n_perm) - done, i64(kP));
  const i64 m1 = a.m1[l];
  const float m1f = float(m1 < 1 ? 1 : m1);
  const float xb = a.xbar[l], os = a.ostat[l];
  const float* su = a.sums + size_t(l) * kP;
  i64 inc = 0;
  for (int p = lane; p < kP; p += 32)
    inc += p < take
           && os <= fabsf(__fsub_rn(__fdiv_rn(__ldcg(su + p), m1f), xb));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) inc += __shfl_xor_sync(0xFFFFFFFFu, inc, o);
  if (lane == 0) {
    const i64 count = __ldcg(a.count + l) + inc;
    a.count[l] = count;
    a.st_done[l] = done + take;
    a.cnt[l] = __ldcg(a.cnt + l) + 1;
    a.st_act[l] = (__ll2float_rn(count) <= *a.limit
                   && done + take < a.n_perm) ? 1 : 0;
  }
}

__device__ void edge_updates(const EdgeArgs& a) {
  for (int l = threadIdx.x >> 5; l < a.L; l += kWarps)
    if (__ldcg(a.st_act + l)) edge_update(a, l);
}

__global__ void __launch_bounds__(kThreads, 1) edge_kernel(EdgeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Shared s = carve(smem_raw, kRadix);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < a.L) {
    a.st_done[tid] = 0;
    a.st_act[tid] = a.active0[tid] ? 1 : 0;
    a.count[tid] = 0;
    a.cnt[tid] = 0;
  }
  grid.sync();
  uint32_t* gbuf = a.gbuf + size_t(blockIdx.x) * size_t(a.Tmax);
  for (int it = 0;; ++it) {
    const int nact = list_flagged(a.st_act, a.L, s.list, s.red_u);
    if (nact == 0) break;
    for (i64 item = blockIdx.x; item < i64(nact) * kP; item += gridDim.x) {
      const int l = s.list[item / kP], p = int(item % kP);
      const int wn = int(a.wn[l]);
      const int npad = tier_of(wn);
      uint32_t* buf = npad <= kSmemWords ? s.buf : gbuf;
      const uint2 key = fold_in(load_key(a.ekeys, l),
                                uint32_t(__ldcg(a.cnt + l)));
      const uint64_t base = uint64_t(p) * uint64_t(npad);
      for (int j = tid; j < wn; j += kThreads) buf[j] = draw_bits(key, base + j);
      __syncthreads();
      const int m1 = int(a.m1[l]);
      const uint32_t tau = radix_select(buf, wn, m1, s.hist, s.misc);
      const float sum = subset_sum(a.xw + size_t(l) * a.Tmax, wn, m1, tau,
                                   buf, s.red_d, s.red_u);
      if (tid == 0) {
        a.sums[size_t(l) * kP + p] = sum;
        if (it == 0 && a.first_sums) a.first_sums[size_t(l) * kP + p] = sum;
      }
    }
    grid.sync();
    if (blockIdx.x == 0) edge_updates(a);
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// The draws on their own, for tests
// ---------------------------------------------------------------------------

__global__ void threefry_kernel(const i64* keys, const i64* data, int K,
                                uint64_t counter0, int count, i64* folded,
                                i64* bits, float* unif) {
  const int k = blockIdx.y;
  const uint2 key = load_key(keys, k);
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

int launch_cooperative(const void* kernel, int grid, size_t smem,
                       void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchCooperativeKernel(kernel, dim3(unsigned(grid)),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory of a K7 (edge == 0) or K8 (edge != 0) launch
// at Tmax.
extern "C" int cbs_smem_bytes(int Tmax, int edge) {
  int lg = 0;
  while ((1 << lg) < Tmax) ++lg;
  const int hist = edge ? kRadix : 1 << bucket_bits(lg);
  const int words = Tmax < kSmemWords ? Tmax : kSmemWords;
  return fixed_smem_bytes() + (hist + words) * 4;
}

// K7.  state: int64 [4, W] scratch; pstats: f32 [W, 512] scratch; sortbuf:
// [grid, Tmax] 32-bit words when Tmax > 32,768; first_stats may be null.
extern "C" int cbs_walk(const void* x, const void* n, const void* tss,
                        const void* keys, const void* walking,
                        const void* hybrid, const void* ostat,
                        const void* nrejc, const void* sbdry, void* state,
                        void* pstats, void* sortbuf, void* accepted,
                        void* chunks, void* first_stats, int W, int Tmax,
                        int n_sbdry, int n_perm, int al0, int kmax, int n_min,
                        int grid, void* stream) {
  if (W <= 0) return 0;
  if (W > kThreads || n_sbdry <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a;
  a.x = static_cast<const float*>(x);
  a.n = static_cast<const i64*>(n);
  a.tss = static_cast<const float*>(tss);
  a.keys = static_cast<const i64*>(keys);
  a.walking0 = static_cast<const bool*>(walking);
  a.hybrid = static_cast<const bool*>(hybrid);
  a.ostat = static_cast<const float*>(ostat);
  a.nrejc = static_cast<const i64*>(nrejc);
  a.sbdry = static_cast<const i64*>(sbdry);
  i64* st = static_cast<i64*>(state);
  a.st_np = st;
  a.st_nrej = st + W;
  a.st_k = st + 2 * W;
  a.st_walk = reinterpret_cast<int32_t*>(st + 3 * W);
  a.pstats = static_cast<float*>(pstats);
  a.gbuf = static_cast<uint32_t*>(sortbuf);
  a.accepted = static_cast<bool*>(accepted);
  a.chunks = static_cast<i64*>(chunks);
  a.first_stats = static_cast<float*>(first_stats);
  a.W = W;
  a.Tmax = Tmax;
  a.n_sbdry = n_sbdry;
  a.n_perm = n_perm;
  a.al0 = al0;
  a.kmax = kmax;
  a.n_min = n_min;
  int lg = 0;
  while ((1 << lg) < Tmax) ++lg;
  a.hist_words = 1 << bucket_bits(lg);
  const size_t smem = size_t(cbs_smem_bytes(Tmax, 0));
  void* args[] = {&a};
  return launch_cooperative(reinterpret_cast<const void*>(walk_kernel), grid,
                            smem, args, static_cast<cudaStream_t>(stream));
}

// K8.  state: int64 [2, L] scratch; sums: f32 [L, 512] scratch; sortbuf as
// for K7; first_sums may be null.
extern "C" int cbs_edge(const void* xw, const void* wn, const void* m1,
                        const void* xbar, const void* ostat,
                        const void* active, const void* ekeys,
                        const void* limit, void* state, void* sums,
                        void* sortbuf, void* count, void* cnt,
                        void* first_sums, int L, int Tmax, int n_perm,
                        int grid, void* stream) {
  if (L <= 0) return 0;
  if (L > kThreads || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  EdgeArgs a;
  a.xw = static_cast<const float*>(xw);
  a.wn = static_cast<const i64*>(wn);
  a.m1 = static_cast<const i64*>(m1);
  a.xbar = static_cast<const float*>(xbar);
  a.ostat = static_cast<const float*>(ostat);
  a.active0 = static_cast<const bool*>(active);
  a.ekeys = static_cast<const i64*>(ekeys);
  a.limit = static_cast<const float*>(limit);
  i64* st = static_cast<i64*>(state);
  a.st_done = st;
  a.st_act = reinterpret_cast<int32_t*>(st + L);
  a.sums = static_cast<float*>(sums);
  a.gbuf = static_cast<uint32_t*>(sortbuf);
  a.count = static_cast<i64*>(count);
  a.cnt = static_cast<i64*>(cnt);
  a.first_sums = static_cast<float*>(first_sums);
  a.L = L;
  a.Tmax = Tmax;
  a.n_perm = n_perm;
  const size_t smem = size_t(cbs_smem_bytes(Tmax, 1));
  void* args[] = {&a};
  return launch_cooperative(reinterpret_cast<const void*>(edge_kernel), grid,
                            smem, args, static_cast<cudaStream_t>(stream));
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

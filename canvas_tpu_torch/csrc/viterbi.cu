// Chunked-Viterbi kernels of the PerSampleHMM partition, for Hopper.
//
// Replace the two kernels of canvas_tpu/ops/viterbi_pallas.py:
//   chunk_matrix_kernel     <- _chunk_matrix_kernel      (phase 1)
//   forward_backtrack_kernel <- _forward_backtrack_kernel (phases 3 + 4a)
// and the XLA work of the same device program (_viterbi_pallas_jit) between
// and after them, so that a decode is a fixed sequence of launches with no
// read back to the host:
//   chunk_scan_kernel  (K5) <- the associative (max,+) scan over the chunks,
//                              its max over rows and the start scores
//                              (phase 2, viterbi_pallas.py:282-290)
//   chunk_chase_kernel (K6) <- the reverse lax.scan over the chunk-end
//                              states (phase 4b, viterbi_pallas.py:314-324)
//
// K5 brackets the adds of a sequence's prefix exactly as canvas_tpu's
// jax.lax.associative_scan does, a tree of 2 floor(log2 n_chunks) levels,
// so its start scores equal canvas_tpu's bit for bit (a loop over the
// chunks would reassociate them and can flip a path).  Its bound is its
// bytes: at the production shape 7.9 MB in and out, 2.3 us at 3.35 TB/s.
// K6 composes the chunks' end-state maps by pointer doubling in shared
// memory, ceil(log2 n_chunks) rounds in place of n_chunks dependent loads.
//
// A lane is one chunk of one sequence; lanes are independent.  Emissions are
// lane-last, em[k][j][lane] (k < chunk, j < S), so neighbouring threads read
// neighbouring addresses.  Step masks are prefix masks, rebuilt from each
// lane's chunk-start time `base` and its sequence length: step k is live
// when base + k < length, and base + k == 0 resets the scores to
// log_init + e.  A masked step passes the carry through.
//
// Exactness: B2, B3 and K5 only add and take maxima in f32, in the order of
// their plain torch versions, with strictly-greater first-max ties for the
// backpointers and the best end state; K6 moves small integers.  None
// multiplies, so no multiply-add is contracted, and the results equal the
// plain versions bit for bit.
//
// Bound on the H100.  A kernel reads em only for live steps (20 bytes a
// lane-step); B3 also writes one int8 path entry per step and state.  At
// the production decode shape (32 x 524,288 x 5, chunk 256, 65,536 lanes,
// 6,176,550 of 16,777,216 lane-steps live) B3 must move 209.6 MB, 0.0626
// ms at 3.35 TB/s, and its 50 adds and maxima a live lane-step take less.
// B2 moves 130.6 MB, 0.0390 ms.  The decode's model is uniform, for which
// B2 needs 100 adds and maxima a live lane-step (below), 0.0184 ms of f32
// issue slots at 33.5 T a second, so bytes bound it; a general model needs
// 250, 0.0461 ms.
//
// chunk_matrix_kernel (B2).  At the production shape only about 24,100
// lanes' worth of steps are live, too few for one thread a lane to hide
// the memory latency of each step.  So:
//   * row i of the transfer matrix depends only on row i, so a block of 5
//     warps holds 32 lanes and warp r the row r of each: five times the
//     warps of one thread a lane, and stores of out[(i*S+j)*L + lane] stay
//     coalesced;
//   * the emissions of a block's 32 lanes reach shared memory once, not
//     once per row-warp: thread (r, l) copies e[k][r] of lane l with a
//     4-byte cp.async.  Steps go in groups of kCmGroup, one commit group
//     and one barrier a group, through a ring of kCmRing groups, so
//     (kCmRing - 2) to (kCmRing - 1) groups are in flight while one runs;
//   * a uniform model (equal diagonal `self`, equal off-diagonal `off`,
//     off < self; the decode's 0.99 / 0.0025) takes the chain of the TPU
//     kernel (canvas_tpu/ops/viterbi_pallas.py:_uniform_trans):
//       max_q(M[i][q] + lt[q][j]) = max(M[i][j] + self, rowmax_i + off),
//     bit for bit, because fl(x + c) is monotone in x (the max commutes
//     with the add) and M[i][j] + off <= M[i][j] + self.  Per row: 4 maxima
//     for the row maximum, 1 add, then 5 adds, 5 maxima and 5 adds, 20
//     operations; 100 a lane-step.  Any other model keeps the general
//     chain.  What holds B2 now is the emission stream, as for B3: with
//     the chain taken out it takes most of its time (kernel_variants.py).
//
// forward_backtrack_kernel (B3), redesigned.  The first CUDA version kept
// its backpointers in an int8 [chunk, S, lanes] scratch in device memory
// (84 MB written by the forward pass and read back through data-dependent
// addresses by the backtrack) and loaded each step's emissions just before
// the dependent chain that used them: 0.344 ms at the production shape on
// an NVIDIA H100 80GB HBM3, 700.00 W.  Now:
//   * the backpointers stay on chip, as the TPU kernel keeps them in VMEM.
//     A step's five 3-bit backpointers pack into one uint16, kept in
//     shared memory laid out [step][lane] (a warp touches 64 consecutive
//     bytes): 512 bytes a lane at chunk 256, 64 KB for a block of 128
//     lanes.  Each thread reads back only its own column, so no barrier is
//     needed, and one 16-bit load per step serves the backtrack of all S
//     end states;
//   * emissions stream kRing - 1 steps ahead of the chain through a ring
//     in shared memory, filled by cp.async with one commit group per step,
//     so a thread waits for exactly the oldest step.  (A ring of loads in
//     registers ran no faster 16 steps ahead than 4: the compiler tracks
//     outstanding loads with a handful of scoreboards, so a wait for the
//     oldest also waited for younger loads.)
// One thread per lane still: S = 5 is too small to split a lane.  What
// holds it back now is the emission stream itself, one 128-byte line per
// warp, state and step from rows 256 KB apart: with the (max,+) chain
// removed the kernel takes about as long.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int S = 5;
constexpr float kNegInf = -1e30f;
constexpr int kCmLanes = 32;           // lanes per B2 block
constexpr int kCmThreads = S * kCmLanes;   // thread (row, lane)
constexpr int kCmGroup = 8;            // B2 steps per commit group/barrier
constexpr int kCmRing = 6;             // B2 ring slots, in groups
constexpr int kFbLanes = 128;          // lanes (threads) per B3 block
constexpr int kFbBlocksPerSm = 2;      // B3 blocks an SM holds at chunk 256
constexpr int kRing = 16;              // em slots: kRing - 1 steps in flight
constexpr int kRingBytes = kRing * S * kFbLanes * 4;
constexpr int kMaxSmem = 232448;       // shared memory a block can use
static_assert((kRing & (kRing - 1)) == 0, "kRing is a power of two");
constexpr int kMaxChunk = (kMaxSmem - kRingBytes) / (kFbLanes * 2);
// backpointers of a masked or reset step: every state stays (j at 3 j)
constexpr uint32_t kStay = (1u << 3) | (2u << 6) | (3u << 9) | (4u << 12);

struct Model {
  float lt[S][S];   // log transition, lt[from][to]
  float li[S];      // log initial distribution
};

// 4-byte asynchronous copy from device to shared memory (Ampere and later),
// and the group operations that order a thread's copies
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// B2.  Block x holds lanes 32x .. 32x + 31; thread (r, l) = (warp, lane of
// the warp) carries row r of lane 32x + l's transfer matrix in registers
// and copies e[k][r] of that lane for every step k it has.  The block runs
// the steps its longest lane has; a thread skips a step past its own
// lane's prefix (the carry passes through), and a block whose lanes are
// all past their sequences writes the identity.
template <bool kUniform>
__global__ void __launch_bounds__(kCmThreads) chunk_matrix_kernel(
    const float* __restrict__ em, const int32_t* __restrict__ base,
    const int32_t* __restrict__ length, float* __restrict__ out, int chunk,
    int64_t n_lanes, Model model) {
  // ring[slot][step of the group][state][lane of the block]
  __shared__ float ring[kCmRing][kCmGroup][S][kCmLanes];
  __shared__ int s_steps;         // the most steps a lane of the block has
  const int row = threadIdx.x / kCmLanes;
  const int ln = threadIdx.x % kCmLanes;
  const int64_t lane = int64_t(blockIdx.x) * kCmLanes + ln;
  const bool valid = lane < n_lanes;
  int32_t b = 0;
  int n_live = 0;                 // steps k < n_live are live (prefix mask)
  if (valid) {
    b = base[lane];
    n_live = int(min(max(length[lane] - b, 0), chunk));
  }
  if (threadIdx.x == 0) s_steps = 0;
  __syncthreads();
  if (row == 0 && n_live > 0) atomicMax(&s_steps, n_live);
  __syncthreads();
  const int n_groups = (s_steps + kCmGroup - 1) / kCmGroup;
  const float* __restrict__ src = em + int64_t(row) * n_lanes + lane;
  const int64_t step = int64_t(S) * n_lanes;
  auto fetch = [&](int g) {
    if (g < n_groups) {
#pragma unroll
      for (int s = 0; s < kCmGroup; ++s) {
        const int k = g * kCmGroup + s;
        if (k < n_live)
          copy_async4(&ring[g % kCmRing][s][row][ln], src + k * step);
      }
    }
    commit_copies();              // one group per step group, maybe empty
  };
  float M[S];
#pragma unroll
  for (int j = 0; j < S; ++j) M[j] = j == row ? 0.0f : kNegInf;
  const float self_p = model.lt[0][0];     // used when kUniform
  const float off = model.lt[0][1];

  for (int g = 0; g < kCmRing - 1; ++g) fetch(g);
  for (int g = 0; g < n_groups; ++g) {
    wait_copies<kCmRing - 2>();   // this thread's copies of group g landed
    // every thread's copies of group g are visible, and every thread is
    // done with group g - 1, whose slot the next fetch refills
    __syncthreads();
    fetch(g + kCmRing - 1);
    const int slot = g % kCmRing;
#pragma unroll
    for (int s = 0; s < kCmGroup; ++s) {
      const int k = g * kCmGroup + s;
      if (k >= n_live) break;     // prefix mask: every later step too
      float e[S];
#pragma unroll
      for (int j = 0; j < S; ++j) e[j] = ring[slot][s][j][ln];
      if (b + k == 0) {
#pragma unroll
        for (int j = 0; j < S; ++j) M[j] = model.li[j] + e[j];
      } else if (kUniform) {
        float rowmax = M[0];
#pragma unroll
        for (int q = 1; q < S; ++q) rowmax = fmaxf(rowmax, M[q]);
        const float via_off = rowmax + off;
#pragma unroll
        for (int j = 0; j < S; ++j) M[j] = fmaxf(M[j] + self_p, via_off) + e[j];
      } else {
        float N[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          float a = M[0] + model.lt[0][j];
#pragma unroll
          for (int q = 1; q < S; ++q) a = fmaxf(a, M[q] + model.lt[q][j]);
          N[j] = a + e[j];
        }
#pragma unroll
        for (int j = 0; j < S; ++j) M[j] = N[j];
      }
    }
  }
  wait_copies<0>();               // no copy outlives the thread
  if (valid) {
#pragma unroll
    for (int j = 0; j < S; ++j)
      out[(int64_t(row) * S + j) * n_lanes + lane] = M[j];
  }
}

// Dynamic shared memory: the emission ring, f32 [kRing][S][kFbLanes], then
// the backpointers, uint16 [chunk][kFbLanes].  Each thread touches only
// its own column of both, so no barrier is needed.  Two blocks of 128
// lanes fit an SM at chunk 256; the launch bound caps registers to match.
__global__ void __launch_bounds__(kFbLanes, kFbBlocksPerSm)
    forward_backtrack_kernel(const float* __restrict__ em,
                             const int32_t* __restrict__ base,
                             const int32_t* __restrict__ length,
                             const float* __restrict__ start,
                             int8_t* __restrict__ paths,
                             int8_t* __restrict__ prev_end, int chunk,
                             int64_t n_lanes, Model model) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint16_t* bp = reinterpret_cast<uint16_t*>(smem + kRingBytes);
  const int tid = threadIdx.x;
  const int64_t lane = int64_t(blockIdx.x) * kFbLanes + tid;
  if (lane >= n_lanes) return;
  const int32_t b = base[lane];
  // steps k < n_live are live (prefix mask)
  const int n_live = int(min(max(length[lane] - b, 0), chunk));
  const float* __restrict__ em_lane = em + lane;
  const int64_t step = int64_t(S) * n_lanes;
  // step k's emissions: em_lane[k * step + j * n_lanes] -> slot(k)[j]
  auto fetch = [&](int k) {
    if (k < n_live) {
      float* slot = ring + (k & (kRing - 1)) * (S * kFbLanes) + tid;
#pragma unroll
      for (int j = 0; j < S; ++j)
        copy_async4(slot + j * kFbLanes, em_lane + k * step + j * n_lanes);
    }
    commit_copies();              // one group per step, empty past n_live
  };
  float V[S];
#pragma unroll
  for (int j = 0; j < S; ++j) V[j] = start[int64_t(j) * n_lanes + lane];

  // forward DP from the chunk-start scores.  Steps k + 1 .. k + kRing - 1
  // are in flight while step k runs; step k + kRing - 1 takes the slot of
  // step k - 1, whose values are already in registers.
  for (int k = 0; k < kRing - 1; ++k) fetch(k);
  for (int k = 0; k < n_live; ++k) {
    fetch(k + kRing - 1);
    wait_copies<kRing - 1>();     // the group of step k has landed
    const float* slot = ring + (k & (kRing - 1)) * (S * kFbLanes) + tid;
    float e[S];
#pragma unroll
    for (int j = 0; j < S; ++j) e[j] = slot[j * kFbLanes];
    uint32_t word = kStay;
    if (b + k == 0) {
#pragma unroll
      for (int j = 0; j < S; ++j) V[j] = model.li[j] + e[j];
    } else {
      float W[S];
      word = 0u;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float a = V[0] + model.lt[0][j];
        uint32_t g = 0u;
#pragma unroll
        for (int i = 1; i < S; ++i) {
          const float c = V[i] + model.lt[i][j];
          if (c > a) {
            a = c;
            g = i;
          }
        }
        W[j] = a + e[j];
        word |= g << (3 * j);
      }
#pragma unroll
      for (int j = 0; j < S; ++j) V[j] = W[j];
    }
    bp[k * kFbLanes + tid] = uint16_t(word);
  }
  wait_copies<0>();               // no copy outlives the thread

  // backtrack all S assumed chunk-end states; a masked step keeps them
  int state[S];
#pragma unroll
  for (int s = 0; s < S; ++s) state[s] = s;
  int8_t* __restrict__ p_lane = paths + lane;
  for (int k = chunk - 1; k >= 1; --k) {
    const uint32_t word = k < n_live ? bp[k * kFbLanes + tid] : kStay;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      p_lane[(int64_t(k) * S + s) * n_lanes] = int8_t(state[s]);
      state[s] = (word >> (3 * state[s])) & 7u;
    }
  }
  const uint32_t word = n_live > 0 ? bp[tid] : kStay;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    p_lane[int64_t(s) * n_lanes] = int8_t(state[s]);
    prev_end[int64_t(s) * n_lanes + lane] = int8_t((word >> (3 * state[s])) & 7u);
  }
}

// K5, phase 2: the (max,+) prefix over the chunks of each sequence,
// bracketed as canvas_tpu's decode brackets it: jax.lax.associative_scan
// of _maxplus_combine (jax/_src/lax/control_flow/loops.py, _scan).  For a
// level e of n >= 2 matrices the scan combines pairs, r[i] = e[2i] (x)
// e[2i+1], scans r, and then out[2i+1] = scan(r)[i], out[0] = e[0] and
// out[2i] = scan(r)[i-1] (x) e[2i].  Level l > 0 thus holds n_chunks >> l
// matrices.  One block per sequence runs the recursion level by level,
// with a barrier between levels: up from the chunks (level 0, read from
// mats) storing each level's r, then down, overwriting each level with its
// scan, and last the chunks' end scores, max_i out[c][i][j], from the
// scan of level 1 and the chunk matrices.  2 floor(log2 n_chunks) levels,
// 22 at the production 2,048 chunks, in place of 2,048 dependent steps.
//
// Thread (j, t) computes column j of a product, five entries of five f32
// adds and four maxima, the maxima taken in index order as the plain
// version takes them, so the result equals it bit for bit (the order
// decides only the sign of a zero where -0.0 and +0.0 tie).  A column
// per thread makes the way down safe in place: the only thread that reads
// column j of e[2i] is the one that overwrites it.  (A thread per whole
// product reads each operand once instead of five times, but it ran
// slower on the card at the production shape: its 25 entries in a row
// lengthen every level's chain, and 64 registers for 1,024 threads
// spilled.)
//
// The levels above the chunks need at most n_chunks - 1 matrices of 100
// bytes (204.7 KB at 2,048 chunks).  The smallest levels go into shared
// memory while they fit in kScanHeld bytes, a matrix's 25 entries
// together (stride 25 words: a warp's 32 matrices hit 32 banks); the rest
// go into a scratch slab of the sequence's in device memory, planar as
// mats is (entry q of matrix c at q * n + c), so that a warp's accesses
// are contiguous.  Each level's loop is compiled for the places of its
// two levels, so shared-memory offsets stay constants.
constexpr int kScanCols = 192;                  // column items a round
constexpr int kScanThreads = S * kScanCols;     // thread (j, t)
constexpr int kScanHeld = 224 * 1024;           // shared bytes for levels
constexpr int kScanMaxLevels = 32;              // n_chunks < 2^31
constexpr int kMat = S * S;

__host__ __device__ inline int floor_log2(int n) {
  int d = 0;
  while ((n >> (d + 1)) > 0) ++d;
  return d;
}

// first level held in shared memory: levels held_from.. fit in kScanHeld
inline int scan_held_from(int n_chunks) {
  int l = floor_log2(n_chunks) + 1;
  int64_t bytes = 0;
  while (l > 1) {
    const int64_t more = int64_t(n_chunks >> (l - 1)) * kMat * 4;
    if (bytes + more > kScanHeld) break;
    bytes += more;
    --l;
  }
  return l;
}

// matrices of the levels below held_from, a sequence's scratch slab
inline int64_t scan_scratch_mats(int n_chunks) {
  int64_t n = 0;
  for (int l = 1; l < scan_held_from(n_chunks); ++l) n += n_chunks >> l;
  return n;
}

// a level's matrices, entry q of matrix c: in shared memory a matrix's
// entries together; in device memory (mats and the scratch) planar
template <bool kHeld>
struct Level;
template <>
struct Level<true> {
  float* base;
  __device__ float& operator()(int c, int q) const {
    return base[c * kMat + q];
  }
};
template <>
struct Level<false> {
  float* base;
  int64_t n;                      // the matrices of a plane
  __device__ float& operator()(int c, int q) const { return base[c + q * n]; }
};

// column j of a[ca] (x) b[cb]: out[r] = max_k fl(a[r][k] + b[k][j]), k in
// order
template <class A, class B>
__device__ __forceinline__ void maxplus_column(const A& a, int ca, const B& b,
                                               int cb, int j, float out[S]) {
  float bj[S];
#pragma unroll
  for (int k = 0; k < S; ++k) bj[k] = b(cb, k * S + j);
#pragma unroll
  for (int r = 0; r < S; ++r) {
    float m = a(ca, r * S) + bj[0];
#pragma unroll
    for (int k = 1; k < S; ++k) m = fmaxf(m, a(ca, r * S + k) + bj[k]);
    out[r] = m;
  }
}

// max_r col[r], rows in order
__device__ __forceinline__ float column_max(const float col[S]) {
  float m = col[0];
#pragma unroll
  for (int r = 1; r < S; ++r) m = fmaxf(m, col[r]);
  return m;
}

// up one level: r[i] = e[2i] (x) e[2i+1], column j by thread (j, t)
template <class E, class R>
__device__ __forceinline__ void scan_up(const E e, const R r, int n_up, int j,
                                        int t) {
  float col[S];
  for (int i = t; i < n_up; i += kScanCols) {
    maxplus_column(e, 2 * i, e, 2 * i + 1, j, col);
#pragma unroll
    for (int q = 0; q < S; ++q) r(i, q * S + j) = col[q];
  }
}

// down one level, in place: e[2i+1] = o[i], e[2i] = o[i-1] (x) e[2i]
template <class E, class O>
__device__ __forceinline__ void scan_down(const E e, const O o, int n, int j,
                                          int t) {
  float col[S];
  for (int i = t; 2 * i < n; i += kScanCols) {
    if (2 * i + 1 < n) {
#pragma unroll
      for (int q = 0; q < S; ++q) e(2 * i + 1, q * S + j) = o(i, q * S + j);
    }
    if (i > 0) {
      maxplus_column(o, i - 1, e, 2 * i, j, col);
#pragma unroll
      for (int q = 0; q < S; ++q) e(2 * i, q * S + j) = col[q];
    }
  }
}

// the chunks' end scores from the chunk matrices e and the scan o of
// level 1: chunk c's start the next chunk, the last chunk's go to last
template <class O>
__device__ __forceinline__ void scan_ends(const Level<false> e, const O o,
                                          int n_chunks, float* ss,
                                          int64_t n_lanes, float* last,
                                          int j, int t) {
  float col[S];
  for (int i = t; 2 * i < n_chunks; i += kScanCols) {
    for (int c = 2 * i; c < min(2 * i + 2, n_chunks); ++c) {
      if (c == 0) {
#pragma unroll
        for (int q = 0; q < S; ++q) col[q] = e(0, q * S + j);
      } else if (c == 2 * i) {
        maxplus_column(o, i - 1, e, c, j, col);
      } else {
#pragma unroll
        for (int q = 0; q < S; ++q) col[q] = o(i, q * S + j);
      }
      const float v = column_max(col);
      if (c + 1 < n_chunks) ss[j * n_lanes + c + 1] = v;
      else last[j] = v;
    }
  }
}

__global__ void __launch_bounds__(kScanThreads, 1) chunk_scan_kernel(
    const float* __restrict__ mats, float* __restrict__ ss,
    int32_t* __restrict__ last_end, float* __restrict__ scratch,
    int n_chunks, int64_t n_lanes, int held_from, int64_t slab_mats) {
  extern __shared__ __align__(16) float held[];
  __shared__ float* base[kScanMaxLevels + 1];   // level l's matrices
  __shared__ float last_scores[S];
  const int tid = threadIdx.x;
  const int j = tid / kScanCols, t = tid % kScanCols;
  const int64_t lane0 = int64_t(blockIdx.x) * n_chunks;  // lane of chunk 0
  const int depth = floor_log2(n_chunks);
  if (tid == 0) {
    base[0] = const_cast<float*>(mats) + lane0;
    float* slab = scratch + blockIdx.x * slab_mats * kMat;
    int64_t g = 0, h = 0;
    for (int l = 1; l <= depth; ++l) {
      const int64_t size = int64_t(n_chunks >> l) * kMat;
      if (l < held_from) {
        base[l] = slab + g;
        g += size;
      } else {
        base[l] = held + h;
        h += size;
      }
    }
  }
  __syncthreads();
  // level 0 is mats (planes n_lanes apart); levels from held_from are
  // held in shared memory
#define PLANAR(l) \
  Level<false> { base[l], (l) == 0 ? n_lanes : int64_t(n_chunks >> (l)) }
#define HELD(l) Level<true> { base[l] }

  // up: level l + 1 holds the pair products of level l
  for (int l = 0; l < depth; ++l) {
    const int n_up = n_chunks >> (l + 1);
    if (l >= held_from)
      scan_up(HELD(l), HELD(l + 1), n_up, j, t);
    else if (l + 1 >= held_from)
      scan_up(PLANAR(l), HELD(l + 1), n_up, j, t);
    else
      scan_up(PLANAR(l), PLANAR(l + 1), n_up, j, t);
    __syncthreads();
  }
  // down: level l becomes its scan, from the scan of level l + 1
  for (int l = depth - 1; l >= 1; --l) {
    const int n = n_chunks >> l;
    if (l >= held_from)
      scan_down(HELD(l), HELD(l + 1), n, j, t);
    else if (l + 1 >= held_from)
      scan_down(PLANAR(l), HELD(l + 1), n, j, t);
    else
      scan_down(PLANAR(l), PLANAR(l + 1), n, j, t);
    __syncthreads();
  }
  // the chunks: chunk c's end scores start chunk c + 1
  if (depth == 0 || held_from == 1)
    scan_ends(PLANAR(0), HELD(depth > 0 ? 1 : 0), n_chunks, ss + lane0,
              n_lanes, last_scores, j, t);
  else
    scan_ends(PLANAR(0), PLANAR(1), n_chunks, ss + lane0, n_lanes,
              last_scores, j, t);
#undef PLANAR
#undef HELD
  if (t == 0) ss[j * n_lanes + lane0] = 0.0f;    // chunk 0 starts at 0
  __syncthreads();
  if (tid == 0) {                 // first maximum, as torch.argmax
    int best = 0;
#pragma unroll
    for (int s = 1; s < S; ++s)
      if (last_scores[s] > last_scores[best]) best = s;
    last_end[blockIdx.x] = best;
  }
}

// K6, phase 4b: the chunk-end states.  Chunk c - 1 ends in prev_end[s] of
// chunk c when chunk c ends in s: a map f_c on the S states, and the end
// state of chunk c is f_{c+1} o f_{c+2} o ... o f_{n-1} (last_end).  One
// block per sequence composes these suffixes by pointer doubling in
// shared memory, the plain version's algorithm: comp[c] starts as f_{c+1}
// and after the round of stride d is f_{c+1} o ... o f_{c+2d}, so
// ceil(log2 width) rounds, one barrier each, in place of a chase of
// n_chunks dependent loads.  A map packs into a word, state s's image in
// bits 4s..4s+2.  Tiles of kChaseTile chunks run right to left, each
// carrying in the end state of the first chunk of the tile to its right;
// the block writes the tile's states as the int64 lane selectors of the
// final gather, coalesced.
constexpr int kChaseTile = 4096;
constexpr int kChaseThreads = 1024;
constexpr uint32_t kIdentity = 0x43210u;

// g o h: state s goes to g(h(s))
__device__ __forceinline__ uint32_t compose(uint32_t g, uint32_t h) {
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    out |= ((g >> (4 * ((h >> (4 * s)) & 7u))) & 7u) << (4 * s);
  return out;
}

__global__ void __launch_bounds__(kChaseThreads) chunk_chase_kernel(
    const int8_t* __restrict__ prev_end, const int32_t* __restrict__ last_end,
    int64_t* __restrict__ sel, int n_chunks, int64_t n_lanes) {
  __shared__ uint32_t comp[2][kChaseTile];
  __shared__ int s_cur;
  const int tid = threadIdx.x;
  const int64_t lane0 = int64_t(blockIdx.x) * n_chunks;
  if (tid == 0) s_cur = last_end[blockIdx.x];
  for (int hi = n_chunks; hi > 0; hi -= kChaseTile) {
    const int c0 = max(hi - kChaseTile, 0);
    const int width = hi - c0;
    for (int cc = tid; cc < width; cc += kChaseThreads) {
      const int64_t next = lane0 + c0 + cc + 1;    // chunk c + 1's lane
      uint32_t f = kIdentity;                      // past the last chunk
      if (c0 + cc + 1 < n_chunks) {
        f = 0;
#pragma unroll
        for (int s = 0; s < S; ++s)
          f |= uint32_t(prev_end[s * n_lanes + next]) << (4 * s);
      }
      comp[0][cc] = f;
    }
    __syncthreads();              // and s_cur, from thread 0
    int src = 0;
    for (int d = 1; d < width; d *= 2, src ^= 1) {
      for (int cc = tid; cc < width; cc += kChaseThreads)
        comp[src ^ 1][cc] = cc + d < width
            ? compose(comp[src][cc], comp[src][cc + d]) : comp[src][cc];
      __syncthreads();
    }
    const int cur = s_cur;
    for (int cc = tid; cc < width; cc += kChaseThreads)
      sel[lane0 + c0 + cc] = (comp[src][cc] >> (4 * cur)) & 7u;
    __syncthreads();              // s_cur and comp read by every thread
    if (tid == 0) s_cur = (comp[src][0] >> (4 * cur)) & 7u;
  }
}

Model make_model(const float* log_trans, const float* log_init) {
  Model m;
  for (int i = 0; i < S; ++i) {
    for (int j = 0; j < S; ++j) m.lt[i][j] = log_trans[i * S + j];
    m.li[i] = log_init[i];
  }
  return m;
}

unsigned n_blocks(int64_t n_lanes, int per_block) {
  return unsigned((n_lanes + per_block - 1) / per_block);
}

}  // namespace

extern "C" int viterbi_n_states() { return S; }

extern "C" int viterbi_max_chunk() { return kMaxChunk; }

// em f32 [chunk, S, n_lanes]; base, length int32 [n_lanes];
// out f32 [S, S, n_lanes].  log_trans (S*S) and log_init (S) are host
// arrays.  uniform != 0 takes the uniform chain; the caller sets it only
// for a uniform log_trans (equal diagonal, equal off-diagonal, off < self).
extern "C" int viterbi_chunk_matrices(const void* em, const void* base,
                                      const void* length, void* out, int chunk,
                                      long long n_lanes, const float* log_trans,
                                      const float* log_init, int uniform,
                                      void* stream) {
  if (n_lanes == 0) return 0;
  auto kernel = uniform ? chunk_matrix_kernel<true>
                        : chunk_matrix_kernel<false>;
  kernel<<<n_blocks(n_lanes, kCmLanes), kCmThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(em), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(length), static_cast<float*>(out), chunk,
      n_lanes, make_model(log_trans, log_init));
  return int(cudaGetLastError());
}

// start f32 [S, n_lanes]; paths int8 [chunk, S, n_lanes]; prev_end int8
// [S, n_lanes]; 1 <= chunk <= viterbi_max_chunk().
extern "C" int viterbi_forward_backtrack(const void* em, const void* base,
                                         const void* length, const void* start,
                                         void* paths, void* prev_end,
                                         int chunk, long long n_lanes,
                                         const float* log_trans,
                                         const float* log_init, void* stream) {
  if (n_lanes == 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk) return int(cudaErrorInvalidValue);
  const int smem = kRingBytes + chunk * kFbLanes * int(sizeof(uint16_t));
  cudaError_t err = cudaFuncSetAttribute(
      forward_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  // as many blocks per SM as shared memory allows, not an L1 preference
  err = cudaFuncSetAttribute(forward_backtrack_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  forward_backtrack_kernel<<<n_blocks(n_lanes, kFbLanes), kFbLanes, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(em), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(length), static_cast<const float*>(start),
      static_cast<int8_t*>(paths), static_cast<int8_t*>(prev_end), chunk,
      n_lanes, make_model(log_trans, log_init));
  return int(cudaGetLastError());
}

// matrices of a sequence's scratch slab for K5 at n_chunks: the caller
// allocates n_seq slabs of S * S floats a matrix
extern "C" int viterbi_scan_scratch_mats(int n_chunks) {
  return n_chunks < 1 ? 0 : int(scan_scratch_mats(n_chunks));
}

// mats f32 [S, S, n_lanes] (B2's output), n_lanes = n_seq * n_chunks with
// lane = b * n_chunks + c; ss f32 [S, n_lanes] (B3's start scores);
// last_end int32 [n_seq]; scratch f32 [n_seq, viterbi_scan_scratch_mats,
// S, S].
extern "C" int viterbi_chunk_scan(const void* mats, void* ss, void* last_end,
                                  void* scratch, int n_seq, int n_chunks,
                                  void* stream) {
  if (n_seq == 0) return 0;
  if (n_chunks < 1) return int(cudaErrorInvalidValue);
  const int held_from = scan_held_from(n_chunks);
  int64_t held_mats = 0;
  for (int l = held_from; l <= floor_log2(n_chunks); ++l)
    held_mats += n_chunks >> l;
  const int smem = int(held_mats * kMat * 4);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  chunk_scan_kernel<<<unsigned(n_seq), kScanThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mats), static_cast<float*>(ss),
      static_cast<int32_t*>(last_end), static_cast<float*>(scratch),
      n_chunks, int64_t(n_seq) * n_chunks, held_from,
      scan_scratch_mats(n_chunks));
  return int(cudaGetLastError());
}

// prev_end int8 [S, n_lanes] (B3's output); last_end int32 [n_seq]; sel
// int64 [n_lanes], each chunk's end state.
extern "C" int viterbi_chunk_chase(const void* prev_end, const void* last_end,
                                   void* sel, int n_seq, int n_chunks,
                                   void* stream) {
  if (n_seq == 0) return 0;
  if (n_chunks < 1) return int(cudaErrorInvalidValue);
  chunk_chase_kernel<<<unsigned(n_seq), kChaseThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(prev_end),
      static_cast<const int32_t*>(last_end), static_cast<int64_t*>(sel),
      n_chunks, int64_t(n_seq) * n_chunks);
  return int(cudaGetLastError());
}

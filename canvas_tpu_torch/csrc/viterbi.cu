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
// K5 runs the chunks of a sequence in order, as the plain version's loop
// does, not as a tree: a tree reassociates the adds, which can flip a path
// against the CPU decode.  So it is held by its chain of n_chunks dependent
// (max,+) steps, not by its bytes (at the production shape 7.9 MB in and
// out, 2.3 us at 3.35 TB/s): one warp per sequence, 32 at that shape.  K6
// is a chain of dependent loads, n_chunks a sequence; it chases them in
// shared memory, where a load takes tens of cycles, not hundreds.
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

// K5, phase 2: the (max,+) prefix over the chunks of each sequence.  One
// block of one warp per sequence b.  Lane i < S carries row i of the
// running product in registers (lanes S..31 carry -inf, and what they
// compute is dropped); the chunks run in order, as the plain version's
// loop does:
//   running[i][j] <- max_k fl(running[i][k] + m[k][j]),
//   scores_end[j]  = max_i running[i][j].
// Each entry is one f32 add a term and maxima are exact (their order does
// not matter), so the result is bit-equal to the loop.  The b's chunk
// matrices come through shared memory in tiles of kScanTile chunks, the
// next tile in flight (cp.async) while one is used, each chunk's 25 values
// contiguous so that a lane reads them with 7 16-byte loads.
//
// Redesigned after its first run on the card.  The first version reduced
// scores_end with warp shuffles at every step and read the 25 values one
// by one: 0.475 ms at the production shape (32 x 2,048 chunks) on an
// NVIDIA H100 80GB HBM3, 700.00 W, some 400 cycles a step for a chain
// whose adds and maxima need about 20; this design took 0.230 ms there.
// With one warp on an SM, every instruction of a step waits on the one
// before it, so the step's instruction count is its time.  Now the chain is a
// step's 7 loads, 25 adds, 20 maxima (a tree, depth 3) and 5 stores of
// the row into shared memory; scores_end and the start scores are
// reduced from those rows once a tile, by all 32 lanes, off the chain.
constexpr int kScanTile = 64;
constexpr int kScanRow = 28;      // a chunk's S * S values, padded to 16 B

__global__ void __launch_bounds__(32) chunk_scan_kernel(
    const float* __restrict__ mats, float* __restrict__ ss,
    int32_t* __restrict__ last_end, int n_chunks, int64_t n_lanes) {
  __shared__ __align__(16) float tile[2][kScanTile][kScanRow];
  __shared__ float rows[kScanTile][S * S];   // running[i][j] after chunk
  const int ln = threadIdx.x;
  const int64_t lane0 = int64_t(blockIdx.x) * n_chunks;  // lane of chunk 0
  const int n_tiles = (n_chunks + kScanTile - 1) / kScanTile;
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      const int c0 = t * kScanTile;
      const int width = min(kScanTile, n_chunks - c0);
      for (int x = ln; x < S * S * kScanTile; x += 32) {
        const int q = x / kScanTile, cc = x % kScanTile;
        if (cc < width)
          copy_async4(&tile[t & 1][cc][q],
                      mats + int64_t(q) * n_lanes + lane0 + c0 + cc);
      }
    }
    commit_copies();
  };
  const float kMinusInf = __int_as_float(0xff800000);
  float run[S];
#pragma unroll
  for (int j = 0; j < S; ++j)
    run[j] = ln < S ? (j == ln ? 0.0f : kNegInf) : kMinusInf;
  if (ln < S) ss[int64_t(ln) * n_lanes + lane0] = 0.0f;   // chunk 0 starts at 0
  fetch(0);
  int width = 0;
  for (int t = 0; t < n_tiles; ++t) {
    fetch(t + 1);
    wait_copies<1>();             // this thread's copies of tile t landed
    __syncthreads();              // and every thread's
    const int c0 = t * kScanTile;
    width = min(kScanTile, n_chunks - c0);
#pragma unroll 4
    for (int cc = 0; cc < width; ++cc) {
      const float4* v = reinterpret_cast<const float4*>(tile[t & 1][cc]);
      float m[kScanRow];
#pragma unroll
      for (int x = 0; x < kScanRow / 4; ++x) {
        const float4 q = v[x];
        m[4 * x] = q.x;
        m[4 * x + 1] = q.y;
        m[4 * x + 2] = q.z;
        m[4 * x + 3] = q.w;
      }
      float nxt[S];
#pragma unroll
      for (int j = 0; j < S; ++j)
        nxt[j] = fmaxf(fmaxf(fmaxf(run[0] + m[j], run[1] + m[S + j]),
                             fmaxf(run[2] + m[2 * S + j],
                                   run[3] + m[3 * S + j])),
                       run[4] + m[4 * S + j]);
#pragma unroll
      for (int j = 0; j < S; ++j) run[j] = nxt[j];
      if (ln < S) {
#pragma unroll
        for (int j = 0; j < S; ++j) rows[cc][ln * S + j] = nxt[j];
      }
    }
    __syncthreads();              // rows complete; tile t & 1 free again
    // chunk c's end scores start chunk c + 1
    for (int x = ln; x < S * kScanTile; x += 32) {
      const int j = x / kScanTile, cc = x % kScanTile;
      if (cc < width && c0 + cc + 1 < n_chunks) {
        float e = rows[cc][j];
#pragma unroll
        for (int i = 1; i < S; ++i) e = fmaxf(e, rows[cc][i * S + j]);
        ss[int64_t(j) * n_lanes + lane0 + c0 + cc + 1] = e;
      }
    }
    __syncthreads();              // rows read before the next tile writes
  }
  wait_copies<0>();
  if (ln == 0) {                  // first maximum, as torch.argmax
    int best = 0;
    float top = kMinusInf;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float e = rows[width - 1][j];
#pragma unroll
      for (int i = 1; i < S; ++i) e = fmaxf(e, rows[width - 1][i * S + j]);
      if (j == 0 || e > top) {
        top = e;
        best = j;
      }
    }
    last_end[blockIdx.x] = best;
  }
}

// K6, phase 4b: the chunk-end states, chased right to left from the last
// chunk's best end state: chunk c ends in cur, and chunk c - 1 in
// prev_end[cur] of chunk c.  One block per sequence: its prev_end column
// (S bytes a chunk) goes into shared memory in tiles of kChaseTile chunks,
// one thread chases the tile there, and the block writes the tile's
// states as the int64 lane selectors of the final gather, coalesced.
constexpr int kChaseTile = 4096;
constexpr int kChaseThreads = 256;

__global__ void __launch_bounds__(kChaseThreads) chunk_chase_kernel(
    const int8_t* __restrict__ prev_end, const int32_t* __restrict__ last_end,
    int64_t* __restrict__ sel, int n_chunks, int64_t n_lanes) {
  __shared__ int8_t pe[S][kChaseTile];
  __shared__ int8_t out[kChaseTile];
  __shared__ int s_cur;
  const int tid = threadIdx.x;
  const int64_t lane0 = int64_t(blockIdx.x) * n_chunks;
  if (tid == 0) s_cur = last_end[blockIdx.x];
  for (int hi = n_chunks; hi > 0; hi -= kChaseTile) {
    const int c0 = max(hi - kChaseTile, 0);
    const int width = hi - c0;
    for (int x = tid; x < S * width; x += kChaseThreads) {
      const int s = x / width, cc = x % width;
      pe[s][cc] = prev_end[int64_t(s) * n_lanes + lane0 + c0 + cc];
    }
    __syncthreads();
    if (tid == 0) {
      int cur = s_cur;
      for (int cc = width - 1; cc >= 0; --cc) {
        out[cc] = int8_t(cur);
        cur = pe[cur][cc];
      }
      s_cur = cur;
    }
    __syncthreads();
    for (int cc = tid; cc < width; cc += kChaseThreads)
      sel[lane0 + c0 + cc] = out[cc];
    __syncthreads();              // pe and out read before the next tile
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

// mats f32 [S, S, n_lanes] (B2's output), n_lanes = n_seq * n_chunks with
// lane = b * n_chunks + c; ss f32 [S, n_lanes] (B3's start scores);
// last_end int32 [n_seq].
extern "C" int viterbi_chunk_scan(const void* mats, void* ss, void* last_end,
                                  int n_seq, int n_chunks, void* stream) {
  if (n_seq == 0) return 0;
  if (n_chunks < 1) return int(cudaErrorInvalidValue);
  chunk_scan_kernel<<<unsigned(n_seq), 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mats), static_cast<float*>(ss),
      static_cast<int32_t*>(last_end), n_chunks,
      int64_t(n_seq) * n_chunks);
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

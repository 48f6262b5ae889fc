// Chunked-Viterbi kernels of the PerSampleHMM partition, for Hopper.
//
// Replace the two kernels of canvas_tpu/ops/viterbi_pallas.py:
//   chunk_matrix_kernel     <- _chunk_matrix_kernel      (phase 1)
//   forward_backtrack_kernel <- _forward_backtrack_kernel (phases 3 + 4a)
//
// A lane is one chunk of one sequence; lanes are independent.  Emissions are
// lane-last, em[k][j][lane] (k < chunk, j < S), so neighbouring threads read
// neighbouring addresses.  Step masks are prefix masks, rebuilt from each
// lane's chunk-start time `base` and its sequence length: step k is live
// when base + k < length, and base + k == 0 resets the scores to
// log_init + e.  A masked step passes the carry through.
//
// Exactness: both kernels only add and take maxima in f32, in the order of
// the general (max,+) chain of canvas_tpu/ops/hmm.py:viterbi_decode_chunked,
// with strictly-greater first-max ties for the backpointers.  Neither
// multiplies, so no multiply-add is contracted, and the results equal the
// plain torch versions bit for bit.
//
// Bound on the H100.  A kernel reads em only for live steps (20 bytes a
// lane-step); B3 also writes one int8 path entry per step and state.  At
// the production decode shape (32 x 524,288 x 5, chunk 256, 65,536 lanes,
// 6,176,550 of 16,777,216 lane-steps live) B3 must move 209.6 MB, 0.0626
// ms at 3.35 TB/s, and its 50 adds and maxima a live lane-step take less.
// B2 moves 130.6 MB (0.0390 ms) but does 250 adds and maxima a live
// lane-step, each an f32 issue slot: 0.0461 ms at 33.5 T slots a second,
// so operations bound it.
//
// chunk_matrix_kernel (B2): one thread per lane, with the carry in
// registers (25 floats for the transfer matrix) for the whole chunk; the
// transition matrix is a kernel argument.
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
constexpr int kThreads = 128;          // chunk_matrix_kernel
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

__global__ void __launch_bounds__(kThreads) chunk_matrix_kernel(
    const float* __restrict__ em, const int32_t* __restrict__ base,
    const int32_t* __restrict__ length, float* __restrict__ out, int chunk,
    int64_t n_lanes, Model model) {
  const int64_t lane = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= n_lanes) return;
  const int32_t b = base[lane];
  const int32_t len = length[lane];
  float M[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) M[i][j] = i == j ? 0.0f : kNegInf;

  for (int k = 0; k < chunk; ++k) {
    const int32_t t = b + k;
    if (t >= len) break;             // prefix mask: every later step too
    float e[S];
#pragma unroll
    for (int j = 0; j < S; ++j) e[j] = em[(int64_t(k) * S + j) * n_lanes + lane];
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < S; ++j) M[i][j] = model.li[j] + e[j];
    } else {
      float N[S][S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          float a = M[i][0] + model.lt[0][j];
#pragma unroll
          for (int q = 1; q < S; ++q) a = fmaxf(a, M[i][q] + model.lt[q][j]);
          N[i][j] = a + e[j];
        }
      }
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < S; ++j) M[i][j] = N[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) out[(int64_t(i) * S + j) * n_lanes + lane] = M[i][j];
}

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
// out f32 [S, S, n_lanes].  log_trans (S*S) and log_init (S) are host arrays.
extern "C" int viterbi_chunk_matrices(const void* em, const void* base,
                                      const void* length, void* out, int chunk,
                                      long long n_lanes, const float* log_trans,
                                      const float* log_init, void* stream) {
  if (n_lanes == 0) return 0;
  chunk_matrix_kernel<<<n_blocks(n_lanes, kThreads), kThreads, 0,
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

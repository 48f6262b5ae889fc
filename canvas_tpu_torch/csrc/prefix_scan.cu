// Fused prefix-sum kernel of the binning stage (CanvasBin), for Hopper.
//
// Replaces canvas_tpu/ops/prefix_pallas.py:_prefix_kernel (the pallas_call
// in fused_prefix_sums_packed).  Over one contig padded to n_pos positions
// it writes three inclusive int32 prefix sums:
//
//   pcum [i] = sum_{q<=i} possible[q] & (offset <= q < real_len)
//   ocum [i] = sum_{q<=i} min(obs[q], cap) * that masked possible bit
//   gccum[i] = sum_{q<=i} is_gc[q]                       (unmasked)
//
// Inputs: possible / is_gc as bits in np.packbits order (8 consecutive
// positions per byte, the first position in the most significant bit);
// obs as one byte per position.  Sums are added in uint32 and stored as
// int32 bits: ocum passes 2^31 on chr1-sized contigs at cap 10, and the
// callers only take differences of prefixes, which are exact modulo 2^32.
// pcum is bounded by the contig length and stays monotone.
//
// Bound on the H100: device-memory traffic.  Per position the function
// reads 1.25 bytes and writes 12, so a chr1-sized contig (248,958,976
// padded positions) moves 3.30 GB: 0.985 ms at 3.35 TB/s.  The first
// CUDA version (three launches: tile totals, a one-block scan of the
// totals, a rescan) read its inputs twice, walked the 60,781 tile totals
// in one block, and stored 16 consecutive int32 per thread as four 16-byte
// vectors, so each warp store half-filled the sectors it touched: 2.718 ms
// at chr1 length on an NVIDIA H100 80GB HBM3, 700.00 W.
//
// Design: one launch of a chained scan with decoupled look-back (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA NVR-2016-002).
//   * A block takes its tile from an atomic counter, not from blockIdx, so
//     every earlier tile belongs to a block that has started: the
//     look-back waits only on running blocks and cannot deadlock.
//   * A thread owns 16 consecutive positions and keeps only their packed
//     inputs in registers (two 16-bit bit masks, four words of obs); its
//     running sums are recomputed from them when they are stored.
//   * The block reduces its tile and publishes each track's aggregate;
//     warps 0, 1 and 2 then look back, one track each, 32 predecessors at
//     a time, until they meet an inclusive prefix, and publish their own.
//     Flag and sum share one 64-bit status word per track and tile, stored
//     with st.release.gpu and read with ld.acquire.gpu, so a reader never
//     sees a flag without its sum.
//   * The outputs go through a padded stage in shared memory (one spare
//     word per 32, so neither side of the transpose has bank conflicts),
//     and each warp store writes one whole 128-byte line.
//   * Integer adds commute exactly, so the result is the same on every
//     launch whatever order the blocks run in.
// The wrapper clears the tile counter and the status words with one
// cudaMemsetAsync before the launch; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;   // positions per tile
constexpr int kStage = kTile + kTile / 32;     // one pad word per 32

// Tile status word: flag in the high half, the uint32 sum in the low half.
// 0 (the memset) means not yet published.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The 16 positions of one thread, from position pos0 (a multiple of 16).
struct Inputs {
  uint32_t p;      // live-masked possible bits, position i at bit 15 - i
  uint32_t g;      // is_gc bits, the same order
  uint32_t o[4];   // obs, position i in byte i & 3 of word i >> 2
};

__device__ __forceinline__ Inputs load_inputs(
    const uint8_t* __restrict__ p_bits, const uint8_t* __restrict__ obs,
    const uint8_t* __restrict__ gc_bits, int64_t pos0, int64_t offset,
    int64_t real_len) {
  Inputs in;
  // two bytes of each bit track; little-endian, so swap them into
  // np.packbits order (the first byte holds positions 0..7)
  const uint32_t pw = *reinterpret_cast<const uint16_t*>(p_bits + pos0 / 8);
  const uint32_t gw = *reinterpret_cast<const uint16_t*>(gc_bits + pos0 / 8);
  const int64_t lo = min(max(offset - pos0, int64_t(0)), int64_t(16));
  const int64_t hi = min(max(real_len - pos0, int64_t(0)), int64_t(16));
  // positions i in [lo, hi)
  const uint32_t live = (0xFFFFu >> lo) & ~(0xFFFFu >> hi);
  in.p = (((pw & 0xFFu) << 8) | (pw >> 8)) & live;
  in.g = ((gw & 0xFFu) << 8) | (gw >> 8);
  const uint4 ov = *reinterpret_cast<const uint4*>(obs + pos0);
  in.o[0] = ov.x;
  in.o[1] = ov.y;
  in.o[2] = ov.z;
  in.o[3] = ov.w;
  return in;
}

// Position i's count on track a (0: possible, 1: obs, 2: is_gc).
template <int A>
__device__ __forceinline__ uint32_t count(const Inputs& in, int i,
                                          uint32_t cap) {
  const uint32_t pbit = (in.p >> (15 - i)) & 1u;
  if (A == 0) return pbit;
  if (A == 2) return (in.g >> (15 - i)) & 1u;
  const uint32_t ob = (in.o[i >> 2] >> (8 * (i & 3))) & 0xFFu;
  return min(ob, cap) * pbit;
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

// Exclusive scan of three values across the block; `total` gets the block
// sums.  Ends with a barrier.
__device__ __forceinline__ void block_exclusive_scan3(uint32_t (&v)[3],
                                                      uint32_t (&total)[3]) {
  __shared__ uint32_t warp_sums[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t inc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    inc[a] = warp_inclusive_scan(v[a]);
    if (lane == 31) warp_sums[a][warp] = inc[a];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      uint32_t w = lane < kWarps ? warp_sums[a][lane] : 0u;
      w = warp_inclusive_scan(w);
      if (lane < kWarps) warp_sums[a][lane] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const uint32_t before = warp > 0 ? warp_sums[a][warp - 1] : 0u;
    total[a] = warp_sums[a][kWarps - 1];
    v[a] = before + inc[a] - v[a];
  }
  __syncthreads();
}

// One warp: the sum of all tiles before `tile` on one track, from their
// status words.  Lane l reads tile end-1-l of each window of 32; the
// window's sum runs up to the nearest tile that holds its inclusive
// prefix, or over all 32 and on to the next window.
__device__ __forceinline__ uint32_t look_back(
    const unsigned long long* __restrict__ status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  uint32_t sum = 0u;
  for (int64_t end = tile;; end -= 32) {
    const int64_t q = end - 1 - lane;
    unsigned long long w = kPrefix;            // before tile 0: empty
    if (q >= 0) {
      do {
        w = load_acquire(status + q);
      } while ((w >> 32) == 0);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    sum += __reduce_add_sync(0xffffffffu, lane <= stop ? uint32_t(w) : 0u);
    if (prefixes) return sum;
  }
}

template <int A>
__device__ __forceinline__ void store_track(
    const Inputs& in, uint32_t run, uint32_t cap, uint32_t* stage,
    int32_t* __restrict__ out) {
  const int first = threadIdx.x * kPerThread;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    run += count<A>(in, i, cap);
    const int q = first + i;
    stage[q + (q >> 5)] = run;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int q = j * kThreads + threadIdx.x;
    out[q] = int32_t(stage[q + (q >> 5)]);
  }
  __syncthreads();
}

// state: [0] the tile counter, then status[3][n_tiles].
__global__ void __launch_bounds__(kThreads) prefix_scan_kernel(
    const uint8_t* __restrict__ p_bits, const uint8_t* __restrict__ obs,
    const uint8_t* __restrict__ gc_bits, int32_t* __restrict__ pcum,
    int32_t* __restrict__ ocum, int32_t* __restrict__ gccum,
    unsigned long long* __restrict__ state, int64_t n_tiles, int64_t offset,
    int64_t real_len, uint32_t cap) {
  __shared__ uint32_t stage[kStage];
  __shared__ int64_t tile_s;
  __shared__ uint32_t tile_base[3];
  if (threadIdx.x == 0) tile_s = int64_t(atomicAdd(state, 1ull));
  __syncthreads();
  const int64_t tile = tile_s;
  const int64_t pos0 = tile * kTile + int64_t(threadIdx.x) * kPerThread;
  const Inputs in = load_inputs(p_bits, obs, gc_bits, pos0, offset, real_len);

  uint32_t v[3] = {uint32_t(__popc(in.p)), 0u, uint32_t(__popc(in.g))};
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) v[1] += count<1>(in, i, cap);
  uint32_t total[3];
  block_exclusive_scan3(v, total);

  // warp a publishes and looks back for track a; one thread of it does all
  // of that track's stores, so the prefix never precedes the aggregate
  const int warp = threadIdx.x >> 5;
  if (warp < 3) {
    const uint32_t tot = warp == 0 ? total[0] : warp == 1 ? total[1] : total[2];
    unsigned long long* status = state + 1 + warp * n_tiles;
    const bool leader = (threadIdx.x & 31) == 0;
    uint32_t before = 0u;
    if (tile > 0) {
      if (leader) store_release(status + tile, kAggregate | tot);
      before = look_back(status, tile);
    }
    if (leader) {
      store_release(status + tile, kPrefix | uint32_t(before + tot));
      tile_base[warp] = before;
    }
  }
  __syncthreads();

  const int64_t out0 = tile * kTile;
  store_track<0>(in, tile_base[0] + v[0], cap, stage, pcum + out0);
  store_track<1>(in, tile_base[1] + v[1], cap, stage, ocum + out0);
  store_track<2>(in, tile_base[2] + v[2], cap, stage, gccum + out0);
}

}  // namespace

// n_pos must be a multiple of prefix_scan_tile(); state holds
// 1 + 3 * n_pos / prefix_scan_tile() 64-bit words of scratch; obs must be
// 16-byte and the bit tracks 2-byte aligned.
extern "C" int prefix_scan_tile() { return kTile; }

extern "C" int prefix_scan(const void* p_bits, const void* obs,
                           const void* gc_bits, void* pcum, void* ocum,
                           void* gccum, void* state, long long n_pos,
                           long long offset, long long real_len, int cap,
                           void* stream) {
  const int64_t n_tiles = n_pos / kTile;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<unsigned long long*>(state);
  cudaError_t err = cudaMemsetAsync(
      st, 0, size_t(1 + 3 * n_tiles) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return int(err);
  prefix_scan_kernel<<<dim3(unsigned(n_tiles)), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(p_bits), static_cast<const uint8_t*>(obs),
      static_cast<const uint8_t*>(gc_bits), static_cast<int32_t*>(pcum),
      static_cast<int32_t*>(ocum), static_cast<int32_t*>(gccum), st, n_tiles,
      offset, real_len, uint32_t(cap));
  return int(cudaGetLastError());
}

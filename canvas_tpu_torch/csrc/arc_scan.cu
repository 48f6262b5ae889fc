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
// Bound on the H100: compute, up to npad^2/2 pair terms per segment before
// pruning (5e8 at npad 32,768), each a shared-memory load and three f32
// operations.  The TPU kernel walks the blocks of a segment in sequence,
// carrying the running best; here that walk is split in two:
//   phase 1 (arc_scan_blocks): one thread block per (position tile, lag
//     block, segment), in parallel and in no order.  A block works only
//     when its lag block passes the bound against the seed, which every
//     running best is at least.  It stages cs2[i0+l0 : i0+l0+TILE+blk] in
//     shared memory, so for one lag neighbouring threads read neighbouring
//     words; each thread keeps cs[i] of its positions in registers and the
//     maximum of each sub-block, reduced over the warp with shuffles and
//     over the block and the position tiles with an ordered-int atomicMax
//     into a [B, nblk, 16] scratch;
//   phase 2 (arc_scan_replay): one thread per segment replays the TPU
//     kernel's walk over that scratch: blocks in ascending order, each
//     admitted by the same f32 test against the running best, sub-blocks
//     updating on strict >.  So best and bl0 are the TPU kernel's whatever
//     order phase 1 ran in, also where a rounded f32 bound would admit or
//     skip a block differently from the seed test.
//
// Exactness: every term is w * (d * d) with d = cs2[i+L] - cs[i] and
// w = nf / (Lf * (nf - Lf)), all with the correctly rounded intrinsics
// (__fsub_rn, __fmul_rn, __fdiv_rn), so nothing is contracted into a
// multiply-add and the maxima equal the plain torch version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;                 // positions per thread block
constexpr int kPerThread = kTile / kThreads;
constexpr int kBlk = 512;                   // lags per pruning block (max)
constexpr int kSub = 32;                    // lags per sub-block (max)
constexpr int kMaxSub = kBlk / kSub;        // scratch stride

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

// (in_range, w_bound * psd2) of lag block k.
__device__ __forceinline__ bool block_admitted(int k, int blk, int n,
                                               int lag_hi, int al0,
                                               float psd2, float best) {
  const int l0 = k * blk;
  if (!(l0 <= lag_hi && l0 + blk - 1 >= al0)) return false;
  const float w_bound = fmaxf(w_of(max(l0, al0), n),
                              w_of(min(l0 + blk - 1, lag_hi), n));
  return __fmul_rn(w_bound, psd2) > best;
}

__global__ void __launch_bounds__(kThreads) arc_scan_blocks(
    const float* __restrict__ cs, const int32_t* __restrict__ n_arr,
    const int32_t* __restrict__ laghi_arr, const float* __restrict__ seed,
    const float* __restrict__ psd2, int* __restrict__ scratch, int npad,
    int al0, int blk, int sub, int nblk, int nsub) {
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int n = n_arr[b];
  const int lag_hi = laghi_arr[b];
  if (!block_admitted(k, blk, n, lag_hi, al0, psd2[int64_t(b) * nblk + k],
                      seed[b]))
    return;
  const int l0 = k * blk;
  const int i0 = tile * kTile;
  // no position of this tile pairs with any live lag of the block
  if (i0 > n - 1 - max(l0, al0)) return;

  __shared__ float s_cs[kTile + kBlk];      // s_cs[j] = cs2[i0 + l0 + j]
  __shared__ float s_w[kBlk];               // w(l0 + t), -1 when not live
  __shared__ int s_max[kMaxSub];
  const float* row = cs + int64_t(b) * npad;
  const int tid = threadIdx.x;
  for (int j = tid; j < kTile + blk; j += kThreads) {
    const int g = i0 + l0 + j;
    s_cs[j] = g < npad ? row[g] : 0.0f;
  }
  for (int t = tid; t < blk; t += kThreads) {
    const int L = l0 + t;
    s_w[t] = (L >= al0 && L <= lag_hi) ? w_of(L, n) : -1.0f;
  }
  if (tid < kMaxSub) s_max[tid] = encode(-1.0f);
  float ci[kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int i = i0 + tid + p * kThreads;
    ci[p] = i < npad ? row[i] : 0.0f;
  }
  __syncthreads();

  for (int q = 0; q < nsub; ++q) {
    float m = -1.0f;
    for (int t = q * sub; t < (q + 1) * sub; ++t) {
      const float w = s_w[t];
      if (w < 0.0f) continue;               // the same for the whole block
      const int lim = n - 1 - (l0 + t);     // i <= n - 1 - L
#pragma unroll
      for (int p = 0; p < kPerThread; ++p) {
        const int il = tid + p * kThreads;
        if (i0 + il <= lim) {
          const float d = __fsub_rn(s_cs[il + t], ci[p]);
          m = fmaxf(m, __fmul_rn(w, __fmul_rn(d, d)));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    if ((tid & 31) == 0) atomicMax(&s_max[q], encode(m));
  }
  __syncthreads();
  if (tid < nsub)
    atomicMax(&scratch[(int64_t(b) * nblk + k) * kMaxSub + tid], s_max[tid]);
}

__global__ void arc_scan_replay(
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ laghi_arr,
    const float* __restrict__ seed, const float* __restrict__ psd2,
    const int* __restrict__ scratch, float* __restrict__ best_out,
    int32_t* __restrict__ bl0_out, int n_seg, int al0, int blk, int sub,
    int nblk, int nsub) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_seg) return;
  const int n = n_arr[b];
  const int lag_hi = laghi_arr[b];
  float best = seed[b];
  int bl0 = -1;
  for (int k = 0; k < nblk; ++k) {
    if (!block_admitted(k, blk, n, lag_hi, al0, psd2[int64_t(b) * nblk + k],
                        best))
      continue;
    const int* sm = scratch + (int64_t(b) * nblk + k) * kMaxSub;
    for (int q = 0; q < nsub; ++q) {
      const float m = decode(sm[q]);
      if (m > best) {
        best = m;
        bl0 = k * blk + q * sub;
      }
    }
  }
  best_out[b] = best;
  bl0_out[b] = bl0;
}

}  // namespace

extern "C" int arc_scan(const void* cs, const void* n, const void* lag_hi,
                        const void* seed, const void* psd2, void* scratch,
                        void* best, void* bl0, int n_seg, int npad, int al0,
                        void* stream) {
  if (n_seg <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blk = npad < kBlk ? npad : kBlk;
  const int sub = blk < kSub ? blk : kSub;
  const int nblk = (npad + blk - 1) / blk > 0 ? (npad + blk - 1) / blk : 1;
  const int nsub = blk / sub;
  const int ntile = (npad + kTile - 1) / kTile;
  const int64_t count = int64_t(n_seg) * nblk * kMaxSub;
  auto* sc = static_cast<int*>(scratch);
  // Every scratch word starts at 0x80808080, a negative int: it decodes to
  // a negative float, below every encoded sub-block maximum (>= -1) and
  // below every running best (>= seed >= 0), so a word that phase 1 never
  // raised can neither take an atomicMax nor beat the best in phase 2.
  cudaError_t err = cudaMemsetAsync(sc, 0x80, size_t(count) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  arc_scan_blocks<<<dim3(unsigned(ntile), unsigned(nblk), unsigned(n_seg)),
                    kThreads, 0, s>>>(
      static_cast<const float*>(cs), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(lag_hi), static_cast<const float*>(seed),
      static_cast<const float*>(psd2), sc, npad, al0, blk, sub, nblk, nsub);
  arc_scan_replay<<<unsigned((n_seg + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(
      static_cast<const int32_t*>(n), static_cast<const int32_t*>(lag_hi),
      static_cast<const float*>(seed), static_cast<const float*>(psd2), sc,
      static_cast<float*>(best), static_cast<int32_t*>(bl0), n_seg, al0, blk,
      sub, nblk, nsub);
  return static_cast<int>(cudaGetLastError());
}

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
//   phase 1 (arc_scan_blocks): one thread block per (position tile,
//     segment, quarter of a lag block), in parallel and in no order, so
//     one segment still fills the card (the panel's top level is one
//     segment of ~20,000 bins in a 32,768 bucket).  A thread block works
//     only when its lag block's gate passes a floor under the walk's
//     running best before that block: the seed, raised by the maxima of
//     earlier lag blocks' thread blocks that have finished.  It stages
//     cs2[i0+l0 : i0+l0+kTile+lags+kRun] and w of its lags in shared
//     memory and writes the maximum of each sub-block, reduced over the
//     warp with shuffles and over the block and the position tiles with an
//     ordered-int atomicMax, into a [B, nblk, 16] scratch;
//   phase 2 (arc_scan_replay): per segment, the TPU kernel's walk over
//     that scratch: blocks in ascending order, each admitted by the same
//     f32 test against the running best, sub-blocks updating on strict >.
//     So best and bl0 are the TPU kernel's whatever order phase 1 ran in,
//     also where a rounded f32 bound would admit or skip a block
//     differently from the floor test.
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
//   * the position predicate is checked only in runs that cross
//     i + L = n - 1; interior runs go without it;
//   * floors cut the work that the seed alone admits (1.7-1.9 times what
//     the walk needs on the smoke's inputs): a finished thread block
//     raises, with atomicMax, the floor of every later lag block of its
//     segment to its maximum, which is at most the walk's running best
//     before that block (see the end of arc_scan_blocks).  The lag block
//     is the slowest grid index, so early blocks tend to finish first; the
//     result does not depend on the order, only the work saved does;
//   * the replay reads every block's sub-block maxima in parallel, one
//     thread a block, and walks only the blocks' maxima and gates.
//
// Bound on the H100: the function needs the pair terms of the blocks its
// walk visits against the running best (the plain version counts them),
// two f32 issue slots each (a subtraction and a maximum), none an FMA;
// phase 1 computes every block that the seed admits and no floor has
// pruned, a superset.
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
constexpr int kTile = kPos * kThreads;      // positions per thread block
static_assert(kPos % 4 == 0 && kRun % 4 == 0, "float4 loads");
constexpr int kBlk = 512;                   // lags per pruning block (max)
constexpr int kSub = 32;                    // lags per sub-block (max)
constexpr int kMaxSub = kBlk / kSub;        // scratch stride
constexpr int kSplit = 4;                   // thread blocks per lag block
constexpr int kPartLags = kBlk / kSplit;    // lags per thread block (max)
static_assert(kMaxSub % kSplit == 0 && kPartLags >= kRun, "split");

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

// Phase 1.  Thread block (tile, b, z), z = k * kSplit + part: positions
// i0 .. i0 + kTile - 1 of segment b against the sub-blocks
// [q_lo, q_hi) of lag block k, a kSplit-th of the block's, so the blocks
// the seed admits make several waves of short thread blocks on the card.
// Thread tid owns the kPos consecutive positions i = i_t + p
// (i_t = i0 + kPos*tid) and walks the lags in runs of kRun.  For the run
// of lags L + u it loads the window win[j] = cs2[i_t + L + j],
// j < kPos + kRun, from shared memory into registers (four 16-byte
// loads): term (p, u) is win[p + u] - c[p], so kPos + kRun words serve
// kPos * kRun terms.  Per lag it keeps D = max |d| over its live positions
// (one subtraction and one absolute-value maximum a term), then folds
// fl(w * fl(D * D)) into the sub-block's maximum.
__global__ void __launch_bounds__(kThreads) arc_scan_blocks(
    const float* __restrict__ cs, const int32_t* __restrict__ n_arr,
    const int32_t* __restrict__ laghi_arr, const float* __restrict__ seed,
    const float* __restrict__ psd2, int* __restrict__ scratch,
    int* __restrict__ floors, int npad, int al0, int blk, int sub, int nblk,
    int nsub, int ld, const bool* __restrict__ mask,
    const long long* __restrict__ live) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  if (skip_row(live, mask, b)) return;
  const int k = blockIdx.z / kSplit;
  const int part = blockIdx.z % kSplit;
  const int q_lo = part * nsub / kSplit;
  const int q_hi = (part + 1) * nsub / kSplit;
  if (q_lo == q_hi) return;                 // fewer sub-blocks than parts
  const int n = n_arr[b];
  const int lag_hi = laghi_arr[b];
  int* __restrict__ seg_floors = floors + int64_t(b) * nblk;
  // the running best before block k is at least the seed and at least the
  // floor that finished thread blocks of earlier lag blocks have raised.
  // Other thread blocks raise the floor meanwhile, so its threads may read
  // it at different values: the block goes on if any of them admits it, so
  // that every thread loads its share of the staged values below.
  const float floor_k = fmaxf(seed[b], decode(seg_floors[k]));
  if (!__syncthreads_or(block_admitted(k, blk, n, lag_hi, al0,
                                       psd2[int64_t(b) * nblk + k],
                                       floor_k)))
    return;
  // lags l0 + t, t_lo <= t < t_hi; a block of under kRun lags is one run
  const int l0 = k * blk + q_lo * sub;
  const int n_lags = max((q_hi - q_lo) * sub, kRun);
  const int i0 = tile * kTile;
  // no live lag here, or no position of the tile pairs with one
  if (l0 > lag_hi || l0 + n_lags - 1 < al0 ||
      i0 > n - 1 - max(l0, al0))
    return;

  // s_cs[j] = cs2[i0 + l0 + j]; s_w[t] = w(l0 + t), -inf when not live
  __shared__ __align__(16) float s_cs[kTile + kPartLags + kRun];
  __shared__ __align__(16) float s_w[kPartLags];
  __shared__ int s_max[kMaxSub];
  const float* row = cs + int64_t(b) * ld;
  const int tid = threadIdx.x;
  for (int j = tid; j < kTile + n_lags + kRun; j += kThreads) {
    const int g = i0 + l0 + j;
    s_cs[j] = g < npad ? row[g] : 0.0f;
  }
  const int blk_end = (k + 1) * blk;        // lags past the block: not live
  for (int t = tid; t < n_lags; t += kThreads) {
    const int L = l0 + t;
    s_w[t] = (L < blk_end && L >= al0 && L <= lag_hi)
                 ? w_of(L, n) : __int_as_float(0xFF800000);
  }
  if (tid < q_hi - q_lo) s_max[tid] = encode(-1.0f);
  const int i_t = i0 + kPos * tid;          // this thread's first position
  float c[kPos];
#pragma unroll
  for (int p = 0; p < kPos; ++p) c[p] = i_t + p < npad ? row[i_t + p] : 0.0f;
  __syncthreads();

  const int span = max(sub, kRun);          // lags of one sub-block's runs
  for (int q = 0; q < q_hi - q_lo; ++q) {
    float m = -1.0f;
    for (int t = q * sub; t < q * sub + span; t += kRun) {
      const int L = l0 + t;                 // the run's first lag
      const int L_lo = max(L, al0);
      const int L_hi = min(L + kRun - 1, lag_hi);
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
      float D[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) D[u] = 0.0f;
      if (i_t + kPos - 1 + L_hi <= n - 1) {
        // interior: every position of the thread is live for every lag
#pragma unroll
        for (int p = 0; p < kPos; ++p)
#pragma unroll
          for (int u = 0; u < kRun; ++u)
            D[u] = fmaxf(D[u], fabsf(__fsub_rn(win[p + u], c[p])));
      } else {
        // the run crosses i + L = n - 1: a dead term counts as d = 0.  A
        // live lag always pairs with position 0, whose term is >= 0, so a
        // 0 never raises a sub-block's maximum over the segment.
        const int lim = n - 1 - L - i_t;      // live when p + u <= lim
#pragma unroll
        for (int p = 0; p < kPos; ++p)
#pragma unroll
          for (int u = 0; u < kRun; ++u) {
            const float d = fabsf(__fsub_rn(win[p + u], c[p]));
            D[u] = fmaxf(D[u], p + u <= lim ? d : 0.0f);
          }
      }
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
  if (tid < q_hi - q_lo)
    atomicMax(&scratch[(int64_t(b) * nblk + k) * kMaxSub + q_lo + tid],
              s_max[tid]);
  // Raise the floors of the later lag blocks.  Any term of block k is at
  // most the walk's running best before a later block: the walk admits
  // block k and takes its maximum, or rejects it with a best of at least
  // its gate, which bounds every term of the block (psd2 bounds d^2, w of
  // the block's ends bounds w, and the f32 roundings are monotone).
  int top = s_max[0];
  for (int q = 1; q < q_hi - q_lo; ++q) top = max(top, s_max[q]);
  if (decode(top) >= 0.0f)
    for (int kk = k + 1 + tid; kk < nblk; kk += kThreads)
      atomicMax(&seg_floors[kk], top);
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
      const int l0 = k * blk;
      const bool in_range = l0 <= lag_hi && l0 + blk - 1 >= al0;
      const float w_bound = fmaxf(w_of(max(l0, al0), n),
                                  w_of(min(l0 + blk - 1, lag_hi), n));
      s_gate[tid] = in_range ? __fmul_rn(w_bound, psd2[int64_t(b) * nblk + k])
                             : __int_as_float(0xFF800000);
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
// seed f32 [n_seg], psd2 f32 [n_seg, nblk]; scratch int32 [n_seg, nblk,
// 17]; outputs best f32 and bl0 int32 [n_seg].  mask (bool [n_seg]) and
// live (int64 scalar) may be null: a segment outside the mask, or every
// segment where live is 0, returns at once and writes nothing.
extern "C" int arc_scan(const void* cs, const void* n, const void* lag_hi,
                        const void* seed, const void* psd2, void* scratch,
                        void* best, void* bl0, int n_seg, int npad, int al0,
                        int ld, const void* mask, const void* live,
                        void* stream) {
  if (n_seg <= 0) return 0;
  if (ld < npad) return static_cast<int>(cudaErrorInvalidValue);
  const bool* m = static_cast<const bool*>(mask);
  const long long* lv = static_cast<const long long*>(live);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blk = npad < kBlk ? npad : kBlk;
  const int sub = blk < kSub ? blk : kSub;
  const int nblk = (npad + blk - 1) / blk > 0 ? (npad + blk - 1) / blk : 1;
  const int nsub = blk / sub;
  const int ntile = (npad + kTile - 1) / kTile;
  // scratch: the sub-block maxima [n_seg, nblk, kMaxSub], then the floors
  // [n_seg, nblk], all as encoded ints
  const int64_t n_max = int64_t(n_seg) * nblk * kMaxSub;
  const int64_t count = n_max + int64_t(n_seg) * nblk;
  auto* sc = static_cast<int*>(scratch);
  // Every scratch word starts at 0x80808080, a negative int: it decodes to
  // a negative float, below every encoded sub-block maximum (>= -1) and
  // below every running best (>= seed >= 0), so a word that phase 1 never
  // raised can neither take an atomicMax nor beat the best in phase 2.
  cudaError_t err = cudaMemsetAsync(sc, 0x80, size_t(count) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the lag block is the slowest grid index, so the thread blocks of early
  // lag blocks, whose maxima raise the floors, tend to run first
  arc_scan_blocks<<<dim3(unsigned(ntile), unsigned(n_seg),
                         unsigned(nblk * kSplit)),
                    kThreads, 0, s>>>(
      static_cast<const float*>(cs), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(lag_hi), static_cast<const float*>(seed),
      static_cast<const float*>(psd2), sc, sc + n_max, npad, al0, blk, sub,
      nblk, nsub, ld, m, lv);
  arc_scan_replay<<<unsigned(n_seg), kThreads, 0, s>>>(
      static_cast<const int32_t*>(n), static_cast<const int32_t*>(lag_hi),
      static_cast<const float*>(seed), static_cast<const float*>(psd2), sc,
      static_cast<float*>(best), static_cast<int32_t*>(bl0), al0, blk, sub,
      nblk, nsub, m, lv);
  return static_cast<int>(cudaGetLastError());
}

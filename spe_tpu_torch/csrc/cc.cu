// Connected-component labels of binary masks (kernel 5 of the port).
//
// Replaces the TPU kernel spe_tpu/ops/pallas_cc.py:109
// `connected_components_pallas` (pallas_call :117, body `_cc_kernel`
// :70-105), which runs the min-label fixpoint of
// spe_tpu/ops/cam_boxes.py `_connected_components` (:78-113): every
// foreground pixel ends with the minimum linear index of its 8-connected
// component, background pixels hold 2^30.
//
// One sweep, as the TPU kernel does it:
//   1. 8-neighbour min, Jacobi: every pixel reads the OLD labels;
//   2. row run-min: each contiguous foreground run of a row takes its
//      minimum;
//   3. column run-min, likewise.
// Sweeps repeat until one changes nothing or `max_sweeps` are done. The
// run-min steps give the exact run minimum however they are computed (int32
// labels, min in any order), and the neighbour step is the same Jacobi
// step, so every sweep equals the TPU kernel's sweep and the labels and the
// sweep counts are equal even where the sweep cap binds (adversarial
// mazes), not only at convergence.
//
// What bounds it on the H100: neither device memory (each mask is read once
// and its labels written once: 64 masks of 64 x 64, the stock step's, move
// 1.3 MB, 0.4 us at 3.35 TB/s) nor arithmetic (14 integer operations a
// pixel and sweep), but the latency of a sweep's dependent steps inside a
// block, times the sweeps of the slowest mask. The design keeps a sweep to
// two barriers and no serial scan: one block of CC_NT = 1024 threads a mask
// (S <= 128), the labels in shared memory in two buffers with a padded
// stride of S + 1. A warp holds a whole line, lane l the pixels at 32 k + l
// (k < K = ceil(S / 32)), so a line's ballots are its foreground bitmask in
// order and both a row's and a column's loads hit distinct banks.
//   A. A warp per row: the 3 x 3 neighbourhood from the old labels (a
//      column's three rows from shared memory, the left and right columns
//      by shuffles), then the row run-min in registers (run_min_warp), into
//      the second buffer.
//   B. A warp per column of that buffer: the column run-min in registers,
//      each result compared with the old label and written over it; the
//      change flag is the barrier's vote (__syncthreads_or).
// run_min_warp: a segmented min-scan by __shfl_up_sync within each 32-lane
// slice, the runs' first lanes from the background ballot (__clz), a carry
// across slices, then each pixel reads its run's minimum from the lane
// that holds the run's last pixel (__ffs of the background bits past it,
// one __shfl_sync a slice). S = 64 (`cam_cc_size`, the recipe's) is
// compiled in; every other S <= 128 runs the same code with S read at run
// time, K chosen from it.
#include <stdint.h>

#include "common.cuh"

#define CC_BIG (1 << 30)

constexpr int CC_NT = 1024;   // threads a block: 32 warps
constexpr int CC_MAXS = 128;  // K = ceil(S / 32) <= 4 pixels a lane and line

struct CCParams {
  const uint8_t* masks;  // (N, S, S) contiguous, nonzero = foreground
  int* labels;           // (N, S, S) contiguous
  int* sweeps;           // (N,) sweeps run on each mask
  int N, S, max_sweeps;
};

// One line that a warp holds, lane l's v[k] at position 32 k + l (CC_BIG:
// background, and every position past the line's end), replaced by the
// minimum of its contiguous foreground run (background stays CC_BIG).
template <int K>
__device__ __forceinline__ void run_min_warp(int (&v)[K], int lane) {
  constexpr unsigned full = 0xffffffffu;
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane (all at lane 31)
  unsigned bg[K];
#pragma unroll
  for (int k = 0; k < K; ++k) bg[k] = __ballot_sync(full, v[k] == CC_BIG);
  // the prefix minimum from the run's first pixel in this slice
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned below = bg[k] & upto;
    const int first = below ? 32 - __clz(below) : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(full, v[k], d);
      if (lane - d >= first) v[k] = min(v[k], y);
    }
  }
  // a run that reaches a slice's lane 0 carries the slice before's last
  // prefix (CC_BIG where that pixel is background)
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const int carry = __shfl_sync(full, v[k - 1], 31);
    if (!(bg[k] & upto)) v[k] = min(v[k], carry);
  }
  // the run's minimum is the prefix at its last pixel: within this slice
  // the lane before the next background bit, or, for a run that goes on
  // into the next slice, that slice's lane 0 (done first)
  int head = CC_BIG;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const unsigned above = bg[k] & ~upto;
    const int last = above ? __ffs(above) - 2 : 31;
    int r = __shfl_sync(full, v[k], last);
    if (!above && k + 1 < K && !(bg[k + 1] & 1u)) r = head;
    if (bg[k] & (1u << lane)) r = CC_BIG;
    v[k] = r;
    if (k > 0) head = __shfl_sync(full, r, 0);
  }
}

// K pixels a lane and line; SC: S compiled in, or 0 (read from p.S)
template <int K, int SC>
__global__ void __launch_bounds__(CC_NT, 1) cc_kernel(CCParams p) {
  constexpr unsigned full = 0xffffffffu;
  constexpr int NW = CC_NT / 32;
  extern __shared__ int smem[];
  const int S = SC ? SC : p.S, P = S + 1;
  int* lab = smem;
  int* nxt = smem + S * P;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long base = static_cast<long long>(blockIdx.x) * S * S;
  for (int i = threadIdx.x; i < S * S; i += CC_NT) {
    const int r = i / S;
    lab[r * P + i - r * S] = p.masks[base + i] ? i : CC_BIG;
  }
  __syncthreads();

  int sweep = 0;
  while (sweep < p.max_sweeps) {
    // A. rows: 8-neighbour min of the old labels, then the row run-min
    for (int r = warp; r < S; r += NW) {
      const int* row = lab + r * P;
      int m[K], v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = 32 * k + lane;
        m[k] = v[k] = CC_BIG;
        if (c < S) {
          v[k] = row[c];
          int t = v[k];
          if (r > 0) t = min(t, row[c - P]);
          if (r + 1 < S) t = min(t, row[c + P]);
          m[k] = t;
        }
      }
      int lft[K], rgt[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lft[k] = __shfl_sync(full, m[k], (lane + 31) & 31);
        rgt[k] = __shfl_sync(full, m[k], (lane + 1) & 31);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // lane 0's left neighbour is the slice before's lane 31, lane
        // 31's right one the next slice's lane 0
        const int left = lane ? lft[k] : (k > 0 ? lft[k - 1] : CC_BIG);
        const int right = lane < 31 ? rgt[k] : (k + 1 < K ? rgt[k + 1] : CC_BIG);
        if (v[k] != CC_BIG) v[k] = min(m[k], min(left, right));
      }
      run_min_warp<K>(v, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = 32 * k + lane;
        if (c < S) nxt[r * P + c] = v[k];
      }
    }
    __syncthreads();
    // B. columns: the column run-min, compared with the old labels and
    // written over them
    int changed = 0;
    for (int c = warp; c < S; c += NW) {
      int v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = 32 * k + lane;
        v[k] = r < S ? nxt[r * P + c] : CC_BIG;
      }
      run_min_warp<K>(v, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = 32 * k + lane;
        if (r < S) {
          changed |= lab[r * P + c] != v[k];
          lab[r * P + c] = v[k];
        }
      }
    }
    ++sweep;
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < S * S; i += CC_NT) {
    const int r = i / S;
    p.labels[base + i] = lab[r * P + i - r * S];
  }
  if (threadIdx.x == 0) p.sweeps[blockIdx.x] = sweep;
}

namespace {

template <int K, int SC>
int launch_cc(const CCParams* p, cudaStream_t s) {
  const size_t smem = 2 * sizeof(int) * p->S * (p->S + 1);
  cudaError_t err = cudaFuncSetAttribute(
      cc_kernel<K, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_kernel<K, SC><<<p->N, CC_NT, smem, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spe_connected_components(const CCParams* p, void* stream) {
  if (p->N <= 0 || p->S <= 0 || p->S > CC_MAXS || p->max_sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->S == 64) return launch_cc<2, 64>(p, s);
  switch ((p->S + 31) / 32) {
    case 1: return launch_cc<1, 0>(p, s);
    case 2: return launch_cc<2, 0>(p, s);
    case 3: return launch_cc<3, 0>(p, s);
    default: return launch_cc<4, 0>(p, s);
  }
}

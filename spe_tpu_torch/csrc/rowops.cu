// Row-wise stages of the fused layers that are not products:
//   layernorm  the post-norm LayerNorms of the encoder/decoder layers
//              (spe_tpu/ops/pallas_encoder.py:163,174 and
//              spe_tpu/ops/pallas_decoder.py:247,273,284), eps 1e-5;
//   colsum     column sums of the talking-heads v (the bw term below);
//   th_mix     the talking-heads post-softmax H x H mix
//              (spe_tpu/ops/pallas_block.py:143-148). At eval there is no
//              attention dropout, so the op is linear after the softmax:
//                out_j = sum_g ww[j, g] (P_g V)_j + bw_j colsum(V_j)
//              where (P_g V) comes from the attention kernel run once per
//              pre-softmax mixed head g.
// Each reads its inputs once and writes its outputs once, so device memory
// bounds all three. At the recipe's eval shapes (B = 16 with flip, N =
// 1024, D = 192) on an H100 at 3.35 TB/s: layernorm moves 6.3-25 MB a call
// (0.002-0.008 ms), colsum reads 6.3 MB (0.0019 ms), th_mix reads 50 MB of
// f32 P_g V and writes 6.3 MB (0.017 ms).
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

struct LNParams {
  const void* x;   // (M, D) rows with stride ldx; bf16 or f32 (x_f32)
  const float* g;
  const float* b;
  float* out_f32;  // optional (M, D) contiguous
  bf16* out_bf16;  // optional (M, D) contiguous
  long long M, ldx;
  int D, x_f32;
  float eps;
};

struct ColsumParams {
  const bf16* v;   // element (b, n, c) at b*sb + n*sn + c
  float* out;      // (B, C)
  long long sb, sn;
  int B, N, C;
};

struct MixParams {
  const float* pv;     // (B*N, G, D) f32: row-major, P_g V for every mixed head g
  const float* colsum; // (B, D)
  const float* ww;     // (H, H) torch Linear layout: out head j uses ww[j*H + g]
  const float* bw;     // (H)
  bf16* out;           // (B*N, D)
  long long rows;      // B*N
  int N, H, D;
};

namespace {

__global__ void layernorm_kernel(LNParams p) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= p.M) return;
  const long long m = warp;
  auto ld = [&](int c) {
    return p.x_f32 ? static_cast<const float*>(p.x)[m * p.ldx + c]
                   : bf2f(static_cast<const bf16*>(p.x)[m * p.ldx + c]);
  };
  float s = 0.f;
  for (int c = lane; c < p.D; c += 32) s += ld(c);
  const float mean = warp_sum(s) / p.D;
  float v = 0.f;
  for (int c = lane; c < p.D; c += 32) {
    const float d = ld(c) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / p.D + p.eps);
  for (int c = lane; c < p.D; c += 32) {
    const float y = (ld(c) - mean) * rstd * p.g[c] + p.b[c];
    if (p.out_f32) p.out_f32[m * p.D + c] = y;
    if (p.out_bf16) p.out_bf16[m * p.D + c] = f2bf(y);
  }
}

// colsum_kernel replaces the `+ bw_ref[g, 0]` term of the TPU block
// kernel's _attention (spe_tpu/ops/pallas_block.py:147-148), which the
// eval form turns into bw_j colsum(V_j). What bounds it: the bytes of v,
// 6.3 MB at the recipe's (16, 1024, 192) view of qkv (row stride 576):
// 0.0019 ms at 3.35 TB/s, so a call is launch-bound. The design: one
// cluster of CS_CLUSTER blocks per (sample, strip of CS_UNITS units of W
// columns); block k of a cluster sums a contiguous run of ceil(N /
// CS_CLUSTER) rows. A thread owns one unit of W columns (W = 8: one
// 16-byte load a row where the view allows it, W = 1 otherwise) and every
// groups-th row of the run, CS_BATCH rows' loads in flight at once;
// the block's row groups are summed in order through shared memory, and
// block 0 of the cluster sums the CS_CLUSTER partial rows in order through
// distributed shared memory. No workspace, no atomics, one launch: two
// runs give the same bits. 128 blocks of CS_NT threads at the recipe's
// shape, against (C / 128) x B = 32 blocks walking all N rows before.
constexpr int CS_NT = 512;
constexpr int CS_CLUSTER = 8;
constexpr int CS_UNITS = 32;
constexpr int CS_BATCH = 8;

template <int W>
__global__ void __cluster_dims__(CS_CLUSTER, 1, 1) __launch_bounds__(CS_NT)
    colsum_kernel(ColsumParams p) {
  __shared__ float red[CS_NT * W];
  __shared__ float part[CS_UNITS * W];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CS_CLUSTER;
  const int c0 = blockIdx.y * (CS_UNITS * W);
  const int cols = min(CS_UNITS * W, p.C - c0);
  const int units = cols / W;  // W = 8 only where C % 8 == 0
  const int groups = CS_NT / units;
  const int u = threadIdx.x % units, g = threadIdx.x / units;
  const int run = (p.N + CS_CLUSTER - 1) / CS_CLUSTER;
  const int n1 = min(p.N, (rank + 1) * run);
  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
  if (g < groups) {
    const bf16* src = p.v + b * p.sb + c0 + u * W;
    // CS_BATCH rows' loads issued before any is summed, in row order
    for (int n = rank * run + g; n < n1; n += CS_BATCH * groups) {
      uint4 x[CS_BATCH];
#pragma unroll
      for (int k = 0; k < CS_BATCH; ++k) {
        const int m = n + k * groups;
        if (m >= n1) continue;
        const bf16* row = src + m * p.sn;
        if constexpr (W == 8) {
          x[k] = *reinterpret_cast<const uint4*>(row);
        } else {
          x[k].x = *reinterpret_cast<const unsigned short*>(row);
        }
      }
#pragma unroll
      for (int k = 0; k < CS_BATCH; ++k) {
        if (n + k * groups >= n1) continue;
        if constexpr (W == 8) {
          float f[8];
          unpack2(x[k].x, f[0], f[1]);
          unpack2(x[k].y, f[2], f[3]);
          unpack2(x[k].z, f[4], f[5]);
          unpack2(x[k].w, f[6], f[7]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += f[e];
        } else {
          acc[0] += __uint_as_float(x[k].x << 16);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) red[g * cols + u * W + e] = acc[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += CS_NT) {
    float s = 0.f;
    for (int r = 0; r < groups; ++r) s += red[r * cols + c];
    part[c] = s;
  }
  cluster.sync();  // every block's partial row is written
  if (rank == 0) {
    for (int c = threadIdx.x; c < cols; c += CS_NT) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < CS_CLUSTER; ++r) s += cluster.map_shared_rank(part, r)[c];
      p.out[static_cast<long long>(b) * p.C + c0 + c] = s;
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

__global__ void th_mix_kernel(MixParams p) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= p.rows * p.D) return;
  const long long row = idx / p.D;
  const int c = static_cast<int>(idx % p.D);
  const int dh = p.D / p.H;
  const int j = c / dh;
  const long long bidx = row / p.N;
  const float* pv = p.pv + row * p.H * p.D + c;
  float s = 0.f;
  for (int g = 0; g < p.H; ++g) s += p.ww[j * p.H + g] * pv[g * p.D];
  s += p.bw[j] * p.colsum[bidx * p.D + c];
  p.out[idx] = f2bf(s);
}

}  // namespace

extern "C" int spe_layernorm(const LNParams* p, void* stream) {
  if (p->M <= 0 || p->D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (p->M * 32 + threads - 1) / threads;
  layernorm_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_colsum(const ColsumParams* p, void* stream) {
  const bool vec = p->C % 8 == 0 && reinterpret_cast<uintptr_t>(p->v) % 16 == 0 &&
                   p->sb % 8 == 0 && p->sn % 8 == 0;
  const int tile = CS_UNITS * (vec ? 8 : 1);
  const long long strips = (p->C + tile - 1) / tile;
  if (p->B <= 0 || p->C <= 0 || p->N < 0 ||
      static_cast<long long>(p->B) * CS_CLUSTER > 2147483647LL || strips > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(p->B * CS_CLUSTER, static_cast<unsigned>(strips));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    colsum_kernel<8><<<grid, CS_NT, 0, s>>>(*p);
  } else {
    colsum_kernel<1><<<grid, CS_NT, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_th_mix(const MixParams* p, void* stream) {
  if (p->rows <= 0 || p->D % p->H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = p->rows * p->D;
  const int threads = 256;
  th_mix_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

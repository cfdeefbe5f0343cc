// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel in this directory takes bf16 activations and weights, keeps
// LayerNorm statistics, softmax and accumulation in f32, launches on the
// stream it is given and allocates nothing: the Python wrappers
// (spe_tpu_torch/ops/kernels.py) allocate every output with torch.empty.
// Each C entry point returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bf16 f2bf(float x) { return __float2bfloat16(x); }

// round an f32 value to the nearest bf16 and back (the `.astype(bf16)`
// points of the TPU kernels)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// tanh-form GELU, as the TPU kernels and flax nn.gelu compute it
__device__ __forceinline__ float gelu_tanh(float u) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  const float a = 0.044715f;
  return 0.5f * u * (1.0f + tanhf(c * (u + a * u * u * u)));
}

// its derivative (spe_tpu/ops/pallas_block.py:58 _gelu_grad)
__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float c = 0.7978845608028654f;
  const float a = 0.044715f;
  const float t = tanhf(c * (u + a * u * u * u));
  return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * c * (1.0f + 3.0f * a * u * u);
}

// Counter-based dropout of the fused layers' training form. A keep decision
// is a pure function of (seed, site, sample, head, row, col): a chain of
// steps h <- fmix32(h ^ v * 0x9E3779B1) (murmur3's finaliser), keep when
// (h >> 8) < thr with thr = round((1 - rate) * 2^24). DropPath stops the
// chain after the sample. spe_tpu_torch/ops/refmath.py `counter_keep` is the
// same formula in integer torch arithmetic; the two agree bit for bit. Its
// comment block lists each layer's sites and the key of each.
enum DropSite { SITE_NONE = 0, SITE_ATTN = 1, SITE_PROJ = 2, SITE_HIDDEN = 3,
                SITE_OUT = 4, SITE_PATH1 = 5, SITE_PATH2 = 6, SITE_CROSS_ATTN = 7,
                SITE_CROSS_PROJ = 8, SITE_TH_ATTN = 9, SITE_MHA_ATTN = 10 };

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned mix_step(unsigned h, unsigned v) {
  return fmix32(h ^ (v * 0x9E3779B1u));
}

// the chain up to the head: one per (sample, head) of a launch
__device__ __forceinline__ unsigned head_key(unsigned seed, int site, unsigned b,
                                             unsigned h) {
  return mix_step(mix_step(mix_step(seed, static_cast<unsigned>(site)), b), h);
}

__device__ __forceinline__ bool keep_bit(unsigned hkey, unsigned row, unsigned col,
                                         unsigned thr) {
  return (mix_step(mix_step(hkey, row), col) >> 8) < thr;
}

__device__ __forceinline__ bool path_bit(unsigned seed, int site, unsigned b,
                                         unsigned thr) {
  return (mix_step(mix_step(seed, static_cast<unsigned>(site)), b) >> 8) < thr;
}

// Deterministic block-wide sum (fixed shuffle tree, then warps in order);
// every thread of the block calls it; `red` holds blockDim.x / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = -INFINITY;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) m = fmaxf(m, red[w]);
  return m;
}

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

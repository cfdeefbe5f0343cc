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

// Tensor-core building blocks of the attention and row kernels
// (attention.cu, th_h16.cu; the product kernels' wgmma ones are in
// wgmma.cuh): mma.sync m16n8k16 on bf16 operands with f32 accumulators,
// ldmatrix fragment loads from shared memory (.trans for an operand stored
// with the other index contiguous) and cp.async copies into shared memory.
// Fragment layouts are PTX's (the "mma.m16n8k16" section of the PTX ISA):
// lane l holds rows l/4 and l/4 + 8, columns 2*(l%4) and 2*(l%4) + 1.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// two bf16 in one register -> two floats (exact)
__device__ __forceinline__ void unpack2(unsigned u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

// two f32 values -> one register of two bf16 (lo in the low half), RN
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a . b for a 16 x 16 bf16 A fragment, a 16 x 8 B fragment (b0, b1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; only
// src_bytes are read, the rest of the destination is zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a shared-memory row length (elements, a multiple of 8) padded so that
// eight consecutive rows start in eight different 16-byte bank groups:
// ldmatrix then reads without bank conflicts
__host__ __device__ constexpr int pad_ld(int x) { return (x / 8) % 2 ? x : x + 8; }

// One operand of a product kernel (grad.cu gemm_kernel, linear.cu
// linear_kernel) as the producer warpgroup's register loads see it
// (wgmma.cuh reg_fill): element (r, c) of the operand's shared tile is at
// ptr[r * rs + c * cs] for r < rows, c < cols (absolute indices; outside
// them it reads as 0). c runs along the tile's contiguous shared-memory
// rows.
struct Src {
  const void* ptr;      // at this block's batch offset
  long long rs, cs, rows, cols;
  int f32;
  int mode;             // 0 16-byte rows (bf16, cs == 1), 1 vector loads of 4
                        // (cs == 1, aligned), 2 scalar loads
};

__device__ __forceinline__ Src make_src(const void* base, int f32, long long zoff,
                                        long long rs, long long cs, long long rows,
                                        long long cols) {
  Src s;
  const int es = f32 ? 4 : 2;
  s.ptr = static_cast<const char*>(base) + zoff * es;
  s.rs = rs;
  s.cs = cs;
  s.rows = rows;
  s.cols = cols;
  s.f32 = f32;
  const unsigned long long a =
      reinterpret_cast<unsigned long long>(s.ptr) | static_cast<unsigned long long>(rs * es);
  if (!f32 && cs == 1 && a % 16 == 0) {
    s.mode = 0;
  } else if (cs == 1 && a % (4 * es) == 0) {
    s.mode = 1;
  } else {
    s.mode = 2;
  }
  return s;
}

// the card's SM count (132 on an H100 SXM if the query fails)
inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) {
      n = 132;
    }
  }
  return n;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// keep_bit in two steps, for a kernel that walks the columns of a row: the
// row's key once, then each column
__device__ __forceinline__ unsigned row_key(unsigned hkey, unsigned row) {
  return mix_step(hkey, row);
}

__device__ __forceinline__ bool keep_col(unsigned rkey, unsigned col, unsigned thr) {
  return (mix_step(rkey, col) >> 8) < thr;
}

__device__ __forceinline__ bool keep_bit(unsigned hkey, unsigned row, unsigned col,
                                         unsigned thr) {
  return keep_col(row_key(hkey, row), col, thr);
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

// LayerNorm of a row that one warp holds in 4-column chunks, lane l's
// chunk h at columns c = 4 l + 128 h, values past the row's K columns 0:
// linear_kernel's A panel (linear.cu build_panel) and layernorm_kernel
// (rowops.cu) both call these, so the two give the same bits (the
// backward's recomputed h1/h2 equal the forward panel's). The mean, then
// the centred variance, as the TPU kernels' _ln_fwd
// (spe_tpu/ops/pallas_block.py:63). Every rounding is pinned (__fadd_rn,
// __fmul_rn, __fmaf_rn), so nvcc cannot contract the two kernels' copies
// differently.
__device__ __forceinline__ float ln_inv(int K) { return 1.f / static_cast<float>(K); }

__device__ __forceinline__ float ln_chunk_sum(const float (&v)[4]) {
  return __fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3]));
}

// q plus the squared deviations of the chunk's columns inside K
__device__ __forceinline__ float ln_chunk_sq(float q, const float (&v)[4], int c, int K,
                                             float mean) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float d = c + e < K ? __fsub_rn(v[e], mean) : 0.f;
    q = __fmaf_rn(d, d, q);
  }
  return q;
}

// the warp's sums of the lanes' t (chunk sums) and q (squared deviations)
__device__ __forceinline__ float ln_mean(float t, float invK) {
  return __fmul_rn(warp_sum(t), invK);
}

__device__ __forceinline__ float ln_rstd(float q, float invK, float eps) {
  return rsqrtf(__fmaf_rn(warp_sum(q), invK, eps));
}

// mean and 1/std of a row held as NC chunks a lane (all lanes call it)
template <int NC>
__device__ __forceinline__ void ln_row_stats(const float (&v)[NC][4], int lane, int K,
                                             float invK, float eps, float& mean,
                                             float& rstd) {
  float t = 0.f;
#pragma unroll
  for (int h = 0; h < NC; ++h) t = __fadd_rn(t, ln_chunk_sum(v[h]));
  mean = ln_mean(t, invK);
  float q = 0.f;
#pragma unroll
  for (int h = 0; h < NC; ++h) q = ln_chunk_sq(q, v[h], 4 * lane + 128 * h, K, mean);
  rstd = ln_rstd(q, invK, eps);
}

// (v - mean) rstd g + b on the chunk's columns inside K
__device__ __forceinline__ void ln_apply4(float (&v)[4], int c, int K, float mean, float rstd,
                                          const float (&g)[4], const float (&b)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (c + e < K) v[e] = __fmaf_rn(__fmul_rn(__fsub_rn(v[e], mean), rstd), g[e], b[e]);
  }
}

// The backward toolkit of the fused layers' training form:
//   spe_gemm           a strided, batched product C = alpha * A . B with either
//                      operand transposed by its strides (dX = dY . W,
//                      dW = dY^T . X split over row chunks, the per-head
//                      attention products), an optional dropout mask, a
//                      GELU-derivative factor or a ReLU mask in the
//                      epilogue, column groups in the store (the halves of
//                      the decoder's head-interleaved cross-attention
//                      gradients land in two planes) and an accumulate
//                      mode (C += A . B: dX of a sum of products);
//   spe_reduce         sums Z partial arrays in a fixed order (the second
//                      pass of every parameter gradient: no float atomics,
//                      so two runs give the same bits);
//   spe_colsum_f32     per-chunk column sums of f32 rows (bias gradients);
//   spe_ln_backward    LayerNorm backward of whole rows plus a residual,
//                      with per-block dgamma/dbeta partials;
//   spe_branch_backward  the LayerScale/DropPath/dropout branch
//                      `x + dp * gamma * drop(y)`: d(y) and dgamma partials
//                      (without gamma and val: the dropout mask alone);
//   spe_dropout_mask   the counter masks themselves (common.cuh), for
//                      holding them against the torch version bit for bit.
//
// Replaces the backward products and reductions inside the TPU kernels
// spe_tpu/ops/pallas_block.py:225 _block_bwd_kernel,
// spe_tpu/ops/pallas_ca_block.py:104 _ca_bwd_kernel,
// spe_tpu/ops/pallas_encoder.py:181 _enc_bwd_kernel and
// spe_tpu/ops/pallas_decoder.py:292 _dec_bwd_kernel. The TPU kernels run the
// batch as a sequential grid and add each sample's parameter gradients into
// a resident output; Hopper blocks run in no order, so every cross-block
// sum here is written as partials and reduced by spe_reduce.
//
// What bounds it on the H100: the products (compute), run by this first
// version on the CUDA cores: a 64 x 64 tile per block, 4 x 4 outputs per
// thread, operands rounded to bf16 at the load as the TPU kernels round
// them (`.astype(in_dt)` before each dot) and summed in f32.
#include "common.cuh"

struct GemmParams {
  const void* a;          // A(m, k) at z1*a_s1 + z2*a_s2 + m*a_sm + k*a_sk
  const void* b;          // B(k, n) at z1*b_s1 + z2*b_s2 + k*b_sk + n*b_sn
  void* c;                // C(m, n) at z1*c_s1 + z2*c_s2 + m*c_sm + n*c_sn
  const float* act_aux;   // optional (M, N) f32, stride ld_aux (see act_grad)
  const unsigned* seed;   // dropout seed (drop_site != 0)
  long long a_s1, a_s2, a_sm, a_sk;
  long long b_s1, b_s2, b_sk, b_sn;
  long long c_s1, c_s2, c_sm, c_sn;
  long long ld_aux, rps, kmax;
  int M, N, K, nb1, nb2;  // batch z = z1 * nb2 + z2
  int a_f32, b_f32, c_f32;
  int split;              // z1 indexes chunks of K: depth min(K, kmax - z1*K)
  float alpha;
  int drop_site;          // mask on C keyed (sample m / rps, 0, m % rps, n)
  unsigned drop_thr;
  float drop_scale;
  int act_grad;           // with act_aux: 1 C *= gelu'(aux), 2 C = aux > 0 ? C : 0
  int cgrp;               // column n stored at (n / cgrp) * cgstride + (n % cgrp) * c_sn
  long long cgstride;
  int accumulate;         // C += the result (C read in its own dtype)
};

struct ReduceParams {
  const float* parts;  // (Z, L)
  float* out;          // (L)
  long long L;
  int Z;
  int round_bf16;      // round the sums to bf16 (the bf16-cast weights)
};

struct ColsumF32Params {
  const float* x;   // (M, C) with row stride ld
  float* parts;     // (Z, C): chunk z sums rows [z*chunk, (z+1)*chunk)
  long long M, ld, chunk;
  int C, Z;
};

struct LNBwdParams {
  const float* dy;    // (M, D) f32, stride ld_dy
  const void* x;      // (M, D) LayerNorm input (bf16 or f32), stride ld_x
  const float* g;     // (D)
  const float* res;   // optional (M, D) f32 added to dx, stride ld_res
  void* dx;           // (M, D) contiguous, bf16 or f32 (dx_f32)
  float* parts;       // (gridDim, 2, D): dgamma then dbeta per block
  long long M, ld_dy, ld_x, ld_res;
  int D, x_f32, dx_f32;
  float eps;
};

struct BranchBwdParams {
  const float* dres;    // (M, D) f32: gradient of the residual stream
  const float* val;     // optional (M, D) f32: the branch after its dropout
  const float* gamma;   // optional (D), 1 without
  const unsigned* seed;
  float* d;             // (M, D) f32: drop(dres * dp * gamma)
  float* parts;         // (gridDim, D): sum of dres * dp * val (with val)
  long long M, rps;
  int D;
  int drop_site;
  unsigned drop_thr;
  float drop_scale;
  int path_site;
  unsigned path_thr;
  float path_scale;
};

struct MaskParams {
  const unsigned* seed;
  unsigned char* out;  // (B, H, R, C) keep bits, or (B) with path
  int B, H, R, C;
  int site, path;
  unsigned thr;
};

namespace {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;
constexpr int LN_ROWS = 32;    // rows per block of the LayerNorm/branch backward

__device__ __forceinline__ float ld_any(const void* p, long long i, int f32) {
  return f32 ? static_cast<const float*>(p)[i] : bf2f(static_cast<const bf16*>(p)[i]);
}

__global__ void __launch_bounds__(NT) gemm_kernel(GemmParams p) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int z = blockIdx.z;
  const int z1 = z / p.nb2, z2 = z % p.nb2;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const long long n0 = static_cast<long long>(blockIdx.y) * BN;
  const long long aoff = z1 * p.a_s1 + z2 * p.a_s2;
  const long long boff = z1 * p.b_s1 + z2 * p.b_s2;
  long long K = p.K;
  if (p.split) K = min(static_cast<long long>(p.K), p.kmax - static_cast<long long>(z1) * p.K);
  // coalesce each operand along its unit-stride index
  const bool a_m_fast = p.a_sm == 1, b_n_fast = p.b_sn == 1;

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < (BM * BK) / NT; ++it) {
      const int e = tid + it * NT;
      const int r = a_m_fast ? e % BM : e / BK;
      const int kk = a_m_fast ? e / BM : e % BK;
      const long long m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < p.M && k < K)
                      ? round_bf16(ld_any(p.a, aoff + m * p.a_sm + k * p.a_sk, p.a_f32))
                      : 0.f;
    }
#pragma unroll
    for (int it = 0; it < (BN * BK) / NT; ++it) {
      const int e = tid + it * NT;
      const int c = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const long long n = n0 + c, k = k0 + kk;
      Bs[kk][c] = (n < p.N && k < K)
                      ? round_bf16(ld_any(p.b, boff + k * p.b_sk + n * p.b_sn, p.b_f32))
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long coff = z1 * p.c_s1 + z2 * p.c_s2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
    unsigned key = 0;
    if (p.drop_site) key = head_key(*p.seed, p.drop_site, static_cast<unsigned>(m / p.rps), 0u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n >= p.N) continue;
      float y = p.alpha * acc[i][j];
      if (p.drop_site) {
        y = keep_bit(key, static_cast<unsigned>(m % p.rps), static_cast<unsigned>(n),
                     p.drop_thr) ? y * p.drop_scale : 0.f;
      }
      if (p.act_aux) {
        const float u = p.act_aux[m * p.ld_aux + n];
        y = p.act_grad == 1 ? y * gelu_tanh_grad(u) : (u > 0.f ? y : 0.f);
      }
      const long long o = coff + m * p.c_sm + (n / p.cgrp) * p.cgstride + (n % p.cgrp) * p.c_sn;
      if (p.c_f32) {
        float* c = static_cast<float*>(p.c);
        c[o] = p.accumulate ? c[o] + y : y;
      } else {
        bf16* c = static_cast<bf16*>(p.c);
        c[o] = f2bf(p.accumulate ? bf2f(c[o]) + y : y);
      }
    }
  }
}

// one thread per output element, the Z partials in order
__global__ void reduce_thread_kernel(ReduceParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.L) return;
  float s = 0.f;
  for (int z = 0; z < p.Z; ++z) s += p.parts[static_cast<long long>(z) * p.L + i];
  p.out[i] = p.round_bf16 ? round_bf16(s) : s;
}

// one block per output element (many partials): strided thread sums, then
// the fixed block tree
__global__ void reduce_block_kernel(ReduceParams p) {
  __shared__ float red[32];
  const long long i = blockIdx.x;
  float s = 0.f;
  for (int z = threadIdx.x; z < p.Z; z += blockDim.x) s += p.parts[static_cast<long long>(z) * p.L + i];
  s = block_sum(s, red);
  if (threadIdx.x == 0) p.out[i] = p.round_bf16 ? round_bf16(s) : s;
}

__global__ void colsum_f32_kernel(ColsumF32Params p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y;
  if (c >= p.C) return;
  const long long r0 = z * p.chunk;
  const long long r1 = min(p.M, r0 + p.chunk);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += p.x[r * p.ld + c];
  p.parts[static_cast<long long>(z) * p.C + c] = s;
}

// LN_ROWS rows per block, one warp per row for the row statistics and dx;
// then the block's dgamma/dbeta partial over its rows, column by column
__global__ void __launch_bounds__(NT) ln_bwd_kernel(LNBwdParams p) {
  extern __shared__ float sm[];
  float* s_mean = sm;
  float* s_rstd = sm + LN_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = static_cast<long long>(blockIdx.x) * LN_ROWS;
  const float invD = 1.f / static_cast<float>(p.D);
  for (int rr = warp; rr < LN_ROWS; rr += NT / 32) {
    const long long m = r0 + rr;
    if (m >= p.M) break;
    const long long xo = m * p.ld_x, go = m * p.ld_dy;
    float s = 0.f;
    for (int c = lane; c < p.D; c += 32) s += ld_any(p.x, xo + c, p.x_f32);
    const float mean = warp_sum(s) * invD;
    float v = 0.f;
    for (int c = lane; c < p.D; c += 32) {
      const float d = ld_any(p.x, xo + c, p.x_f32) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) * invD + p.eps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < p.D; c += 32) {
      const float xh = (ld_any(p.x, xo + c, p.x_f32) - mean) * rstd;
      const float dxh = p.dy[go + c] * p.g[c];
      m1 += dxh;
      m2 += dxh * xh;
    }
    m1 = warp_sum(m1) * invD;
    m2 = warp_sum(m2) * invD;
    for (int c = lane; c < p.D; c += 32) {
      const float xh = (ld_any(p.x, xo + c, p.x_f32) - mean) * rstd;
      float dx = (p.dy[go + c] * p.g[c] - m1 - xh * m2) * rstd;
      if (p.res) dx += p.res[m * p.ld_res + c];
      if (p.dx_f32) {
        static_cast<float*>(p.dx)[m * p.D + c] = dx;
      } else {
        static_cast<bf16*>(p.dx)[m * p.D + c] = f2bf(dx);
      }
    }
    if (lane == 0) {
      s_mean[rr] = mean;
      s_rstd[rr] = rstd;
    }
  }
  __syncthreads();
  const int rows = static_cast<int>(min(static_cast<long long>(LN_ROWS), p.M - r0));
  for (int c = threadIdx.x; c < p.D; c += blockDim.x) {
    float dg = 0.f, db = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      const long long m = r0 + rr;
      const float dy = p.dy[m * p.ld_dy + c];
      dg += dy * (ld_any(p.x, m * p.ld_x + c, p.x_f32) - s_mean[rr]) * s_rstd[rr];
      db += dy;
    }
    p.parts[(static_cast<long long>(blockIdx.x) * 2) * p.D + c] = dg;
    p.parts[(static_cast<long long>(blockIdx.x) * 2 + 1) * p.D + c] = db;
  }
}

__global__ void branch_bwd_kernel(BranchBwdParams p) {
  const long long r0 = static_cast<long long>(blockIdx.x) * LN_ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(LN_ROWS), p.M - r0));
  for (int c = threadIdx.x; c < p.D; c += blockDim.x) {
    float dg = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      const long long m = r0 + rr;
      float dp = 1.f;
      if (p.path_site) {
        dp = path_bit(*p.seed, p.path_site, static_cast<unsigned>(m / p.rps), p.path_thr)
                 ? p.path_scale : 0.f;
      }
      const float dr = p.dres[m * p.D + c];
      if (p.val) dg += dr * dp * p.val[m * p.D + c];
      float d = dr * dp * (p.gamma ? p.gamma[c] : 1.f);
      if (p.drop_site) {
        const unsigned key = head_key(*p.seed, p.drop_site, static_cast<unsigned>(m / p.rps), 0u);
        d = keep_bit(key, static_cast<unsigned>(m % p.rps), static_cast<unsigned>(c),
                     p.drop_thr) ? d * p.drop_scale : 0.f;
      }
      p.d[m * p.D + c] = d;
    }
    if (p.val) p.parts[static_cast<long long>(blockIdx.x) * p.D + c] = dg;
  }
}

__global__ void mask_kernel(MaskParams p) {
  const long long total = p.path ? p.B : static_cast<long long>(p.B) * p.H * p.R * p.C;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (p.path) {
    p.out[i] = path_bit(*p.seed, p.site, static_cast<unsigned>(i), p.thr);
    return;
  }
  const int c = static_cast<int>(i % p.C);
  const int r = static_cast<int>((i / p.C) % p.R);
  const int h = static_cast<int>((i / (static_cast<long long>(p.C) * p.R)) % p.H);
  const int b = static_cast<int>(i / (static_cast<long long>(p.C) * p.R * p.H));
  p.out[i] = keep_bit(head_key(*p.seed, p.site, b, h), r, c, p.thr);
}

}  // namespace

extern "C" int spe_gemm(const GemmParams* p, void* stream) {
  if (p->M <= 0 || p->N <= 0 || p->K <= 0 || p->nb1 <= 0 || p->nb2 <= 0 || p->cgrp <= 0 ||
      (p->drop_site && (!p->seed || p->rps <= 0)) ||
      (p->act_aux && p->act_grad != 1 && p->act_grad != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long gm = (p->M + BM - 1) / BM, gn = (p->N + BN - 1) / BN;
  const long long gz = static_cast<long long>(p->nb1) * p->nb2;
  if (gn > 65535 || gz > 65535 || gm > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gm), static_cast<unsigned>(gn), static_cast<unsigned>(gz));
  gemm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_reduce(const ReduceParams* p, void* stream) {
  if (p->L <= 0 || p->Z <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->Z >= 256 && p->L <= 65535) {
    reduce_block_kernel<<<static_cast<unsigned>(p->L), NT, 0, s>>>(*p);
  } else {
    reduce_thread_kernel<<<static_cast<unsigned>((p->L + NT - 1) / NT), NT, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_colsum_f32(const ColsumF32Params* p, void* stream) {
  if (p->M <= 0 || p->C <= 0 || p->Z <= 0 || p->Z > 65535 || p->chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((p->C + 127) / 128, p->Z);
  colsum_f32_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_ln_backward(const LNBwdParams* p, void* stream) {
  if (p->M <= 0 || p->D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (p->M + LN_ROWS - 1) / LN_ROWS;
  ln_bwd_kernel<<<static_cast<unsigned>(blocks), NT, 2 * LN_ROWS * sizeof(float),
                  static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_branch_backward(const BranchBwdParams* p, void* stream) {
  if (p->M <= 0 || p->D <= 0 ||
      ((p->drop_site || p->path_site) && (!p->seed || p->rps <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (p->M + LN_ROWS - 1) / LN_ROWS;
  branch_bwd_kernel<<<static_cast<unsigned>(blocks), NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_dropout_mask(const MaskParams* p, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->R <= 0 || p->C <= 0 || !p->seed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = p->path ? p->B : static_cast<long long>(p->B) * p->H * p->R * p->C;
  mask_kernel<<<static_cast<unsigned>((total + NT - 1) / NT), NT, 0,
                static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

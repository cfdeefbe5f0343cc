// ln_linear: Y = epilogue(LN?(A) . W^T + bias), the product kernel of every
// fused layer of the port.
//
// Replaces the Dense products inside the TPU layer kernels:
//   spe_tpu/ops/pallas_block.py:166 _block_fwd_kernel      (qkv, proj, fc1, fc2)
//   spe_tpu/ops/pallas_ca_block.py:58 _ca_fwd_kernel       (q/k/v, proj, fc1, fc2)
//   spe_tpu/ops/pallas_encoder.py:129 _enc_fwd_kernel      (q/k/v, out, FFN)
//   spe_tpu/ops/pallas_decoder.py:206 _dec_fwd_kernel      (the 12-13 Dense layers)
// The TPU kernels keep a whole layer in VMEM; a Hopper block has 227 KB of
// shared memory, so each product is its own launch here and the elementwise
// stages around it ride along as prologue (LayerNorm of the input rows, a
// second input added before rounding) and epilogue (bias, GELU/ReLU,
// `res + gamma * y`, a head-interleaved column store).
//
// What bounds it on the H100: at the recipe's shapes (M = B*1024 rows,
// K in {192, 768, 2048}) the products are compute bound. This first version
// is a plain SIMT tile (64x64 outputs per block, 4x4 per thread, f32 FMAs on
// bf16-rounded operands), so it runs on the CUDA cores at a fraction of the
// bf16 tensor-core rate; wgmma/TMA tiles are later work.
//
// Numerics follow the TPU kernels: A is rounded to bf16 after the optional
// LayerNorm (or after the f32 sum with the second input), W is bf16, the
// products accumulate in f32, the epilogue runs in f32 and the output is
// rounded once.
//
// The training form of the CaiT block adds to the epilogue: a dropout site
// on Y (after the activation; counter masks keyed on (seed, site, sample =
// m / rows_per_sample, 0, row = m % rows_per_sample, n)), a DropPath factor
// on the residual branch (`res + dp * gamma * y`) and an f32 `aux` copy of
// Y, taken before the activation (aux_pre) or after the dropout.
#include "common.cuh"

struct LinearParams {
  const void* a;       // (M, K) rows with stride lda; bf16 or f32 (a_f32)
  const bf16* a2;      // optional (M, K) bf16 added to A before rounding
  const float* ln_g;   // optional LayerNorm weight (K); enables the prologue
  const float* ln_b;   // LayerNorm bias (K)
  const bf16* w;       // (N, K) row-major, the torch Linear layout
  const float* bias;   // optional (N)
  const void* res;     // optional (M, N) residual with stride ldr; bf16 or f32
  const float* gamma;  // optional (N) LayerScale applied as res + gamma * y
  void* out;           // (M, *) with stride ldo; bf16 or f32 (out_f32)
  long long M, N, K, lda, ldr, ldo;
  int a_f32, res_f32, out_f32;
  int act;             // 0 none, 1 tanh-GELU, 2 ReLU
  float ln_eps;
  int ogrp, ogstride;  // output column n goes to (n / ogrp) * ogstride + n % ogrp
  const unsigned* seed;  // (1) dropout seed, read on the device
  float* aux;            // optional (M, N) f32 copy of Y with stride ldaux
  long long ldaux, rps;  // rps: rows per sample (the dropout's sample index)
  int drop_site;         // DropSite on Y, 0 = none
  unsigned drop_thr;
  float drop_scale;
  int path_site;         // DropPath on the residual branch, 0 = none
  unsigned path_thr;
  float path_scale;
  int aux_pre;           // aux before the activation (1) or after dropout (0)
};

namespace {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

__device__ __forceinline__ float load_a(const LinearParams& p, long long m,
                                        long long k) {
  float v;
  if (p.a_f32) {
    v = static_cast<const float*>(p.a)[m * p.lda + k];
  } else {
    v = bf2f(static_cast<const bf16*>(p.a)[m * p.lda + k]);
  }
  if (p.a2) v += bf2f(p.a2[m * p.lda + k]);
  return v;
}

__global__ void __launch_bounds__(NT) linear_kernel(LinearParams p) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  __shared__ float s_mean[BM];
  __shared__ float s_rstd[BM];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const long long n0 = static_cast<long long>(blockIdx.y) * BN;

  if (p.ln_g) {
    // row statistics of this block's rows: one warp per row, two passes
    // (mean, then the centred variance) like the TPU kernels' _ln_fwd
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BM; r += NT / 32) {
      const long long m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < p.M) {
        float s = 0.f;
        for (long long k = lane; k < p.K; k += 32) s += load_a(p, m, k);
        mean = warp_sum(s) / static_cast<float>(p.K);
        float v = 0.f;
        for (long long k = lane; k < p.K; k += 32) {
          const float d = load_a(p, m, k) - mean;
          v += d * d;
        }
        rstd = rsqrtf(warp_sum(v) / static_cast<float>(p.K) + p.ln_eps);
      }
      if (lane == 0) {
        s_mean[r] = mean;
        s_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < p.K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < (BM * BK) / NT; ++it) {
      const int e = tid + it * NT;
      const int r = e / BK, kk = e % BK;
      const long long m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < p.M && k < p.K) {
        v = load_a(p, m, k);
        if (p.ln_g) v = (v - s_mean[r]) * s_rstd[r] * p.ln_g[k] + p.ln_b[k];
        v = round_bf16(v);
      }
      As[kk][r] = v;
    }
#pragma unroll
    for (int it = 0; it < (BN * BK) / NT; ++it) {
      const int e = tid + it * NT;
      const int c = e / BK, kk = e % BK;
      const long long n = n0 + c, k = k0 + kk;
      Ws[kk][c] = (n < p.N && k < p.K) ? bf2f(p.w[n * p.K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n >= p.N) continue;
      float y = acc[i][j] + (p.bias ? p.bias[n] : 0.f);
      if (p.aux && p.aux_pre) p.aux[m * p.ldaux + n] = y;
      if (p.act == 1) {
        y = gelu_tanh(y);
      } else if (p.act == 2) {
        y = fmaxf(y, 0.f);
      }
      if (p.drop_site) {
        const unsigned key = head_key(*p.seed, p.drop_site,
                                      static_cast<unsigned>(m / p.rps), 0u);
        y = keep_bit(key, static_cast<unsigned>(m % p.rps),
                     static_cast<unsigned>(n), p.drop_thr) ? y * p.drop_scale : 0.f;
      }
      if (p.aux && !p.aux_pre) p.aux[m * p.ldaux + n] = y;
      if (p.res) {
        const float r =
            p.res_f32 ? static_cast<const float*>(p.res)[m * p.ldr + n]
                      : bf2f(static_cast<const bf16*>(p.res)[m * p.ldr + n]);
        float dp = 1.f;
        if (p.path_site) {
          dp = path_bit(*p.seed, p.path_site, static_cast<unsigned>(m / p.rps),
                        p.path_thr) ? p.path_scale : 0.f;
        }
        y = r + dp * (p.gamma ? p.gamma[n] : 1.f) * y;
      }
      const long long oc = (n / p.ogrp) * p.ogstride + n % p.ogrp;
      if (p.out_f32) {
        static_cast<float*>(p.out)[m * p.ldo + oc] = y;
      } else {
        static_cast<bf16*>(p.out)[m * p.ldo + oc] = f2bf(y);
      }
    }
  }
}

}  // namespace

extern "C" int spe_linear(const LinearParams* p, void* stream) {
  if (p->M <= 0 || p->N <= 0 || p->K <= 0 || p->ogrp <= 0 ||
      ((p->drop_site || p->path_site) && (!p->seed || p->rps <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long gm = (p->M + BM - 1) / BM;
  const long long gn = (p->N + BN - 1) / BN;
  if (gn > 65535 || gm > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned>(gm), static_cast<unsigned>(gn));
  linear_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

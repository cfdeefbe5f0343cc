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
// All three read and write each element once: they are bound by device
// memory bandwidth (a few MB per call at the recipe's shapes).
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

__global__ void colsum_kernel(ColsumParams p) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.C) return;
  const bf16* vb = p.v + b * p.sb + c;
  float s = 0.f;
  for (int n = 0; n < p.N; ++n) s += bf2f(vb[n * p.sn]);
  p.out[static_cast<long long>(b) * p.C + c] = s;
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
  if (p->B <= 0 || p->C <= 0 || p->B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((p->C + 127) / 128, p->B);
  colsum_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(*p);
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

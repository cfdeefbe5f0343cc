// Talking-heads attention in training, and the class-attention softmax
// backward. With attention dropout after the post-softmax mix the eval
// kernel's trick (moving the mix past PV) no longer holds, so the training
// form materialises the (B, H, N, N) planes of one block call and works on
// whole rows:
//   th_fold        q~_g = bf16(q (.) row_g), the wl-fold of the pre-softmax
//                  mix into the q side (spe_tpu/ops/pallas_block.py:104);
//   th_fwd_rows    pass 1 after s_g = q~_g . k^T (spe_gemm): per row the
//                  log-sum-exp of each mixed head (saved for the backward),
//                  then pass 2: p_h = exp(s_h + bl_h - lse_h),
//                  z_g = sum_h ww[g, h] p_h + bw_g, counter dropout, written
//                  in bf16 for the product with V_g (spe_gemm);
//   th_bwd_rows    from s (recomputed), lse and dzd_g = do_g . V_g^T: zd_g
//                  (for dV = zd^T do), dz = M (.) dzd / keep,
//                  dp_h = sum_g ww[g, h] dz_g, ds_g = p_g (dp_g - rowsum(dp_g p_g))
//                  in bf16 (for dq~ = ds . K and dK = sum_g ds_g^T q~_g), and
//                  per row partials of dww, dbw and dbl;
//   th_dq          dQ = sum_g dq~_g (.) row_g and per row partials of dwl;
//   softmax_bwd    class attention: dl = p (dp + dattn - rowsum(...)), bf16.
// The math is _block_bwd_kernel's (pallas_block.py:356-451) and
// _ca_bwd_kernel's (pallas_ca_block.py:166-177).
//
// What bounds it on the H100: these row kernels read and write each plane
// element a few times (bytes); the N^2 products around them run in spe_gemm.
// One block per (sample, query row) holds the H rows of a head group in
// shared memory, so the row sums need no second launch; every per-row
// parameter partial is reduced later by spe_reduce (deterministic).
#include "common.cuh"

constexpr int MAXH = 8;

struct THFoldParams {
  const bf16* q;      // (B, N, D) rows with strides q_sb, q_sn
  const float* rows;  // (H, D)
  bf16* out;          // (B, H, N, D) contiguous
  long long q_sb, q_sn;
  int B, H, N, D;
};

struct THRowParams {
  const float* s;     // (B, H, N, N) logits without the head bias
  const float* dzd;   // (B, H, N, N) do_g . V_g^T (backward only)
  float* lse;         // (B, H, N): written by the forward, read by the backward
  const float* bl;    // (H) pre-softmax head bias
  const float* ww;    // (H, H) torch Linear layout: z_g = sum_h ww[g*H+h] p_h
  const float* bw;    // (H)
  const unsigned* seed;
  bf16* zd;           // (B, H, N, N)
  bf16* ds;           // (B, H, N, N) backward only
  float* parts;       // (B*N, H*H + 2H) backward only: dww[g,h], dbw[g], dbl[g]
  int B, H, N;
  int drop;           // attention dropout on
  unsigned thr;
  float scale;
};

struct THDqParams {
  const float* dqt;   // (B, H, N, D) dq~_g
  const bf16* q;      // (B, N, D) rows with strides q_sb, q_sn
  const float* rows;  // (H, D)
  float* dq;          // (B, N, D) rows with strides o_sb, o_sn
  float* parts;       // (B*N, H*H): dwl[g, h]
  long long q_sb, q_sn, o_sb, o_sn;
  int B, H, N, D;
  float scale;        // dh^-0.5
};

struct SoftmaxBwdParams {
  const float* p;      // (R, C) probabilities
  const float* dp;     // (R, C)
  const float* dattn;  // optional (R, C) cotangent of the probabilities
  bf16* dl;            // (R, C)
  long long R;
  int C;
};

namespace {

constexpr int NT = 256;

__global__ void th_fold_kernel(THFoldParams p) {
  const long long total = static_cast<long long>(p.B) * p.H * p.N * p.D;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % p.D);
  const int n = static_cast<int>((i / p.D) % p.N);
  const int g = static_cast<int>((i / (static_cast<long long>(p.D) * p.N)) % p.H);
  const int b = static_cast<int>(i / (static_cast<long long>(p.D) * p.N * p.H));
  p.out[i] = f2bf(bf2f(p.q[b * p.q_sb + n * p.q_sn + c]) * p.rows[g * p.D + c]);
}

__global__ void __launch_bounds__(NT) th_fwd_rows_kernel(THRowParams p) {
  extern __shared__ float sm[];          // H * N logits (+ head bias)
  __shared__ float red[32];
  __shared__ float s_lse[MAXH];
  const int b = blockIdx.x / p.N, i = blockIdx.x % p.N;
  const int H = p.H, N = p.N;
  for (int h = 0; h < H; ++h) {
    const float* srow = p.s + ((static_cast<long long>(b) * H + h) * N + i) * N;
    float mx = -INFINITY;
    for (int j = threadIdx.x; j < N; j += NT) {
      const float v = srow[j] + p.bl[h];
      sm[h * N + j] = v;
      mx = fmaxf(mx, v);
    }
    mx = block_max(mx, red);
    float l = 0.f;
    for (int j = threadIdx.x; j < N; j += NT) l += expf(sm[h * N + j] - mx);
    l = block_sum(l, red);
    if (threadIdx.x == 0) {
      s_lse[h] = mx + logf(l);
      p.lse[(static_cast<long long>(b) * H + h) * N + i] = s_lse[h];
    }
  }
  __syncthreads();
  unsigned keys[MAXH];
  for (int g = 0; g < H; ++g) keys[g] = p.drop ? head_key(*p.seed, SITE_ATTN, b, g) : 0u;
  for (int j = threadIdx.x; j < N; j += NT) {
    float pr[MAXH];
    for (int h = 0; h < H; ++h) pr[h] = expf(sm[h * N + j] - s_lse[h]);
    for (int g = 0; g < H; ++g) {
      float z = p.bw[g];
      for (int h = 0; h < H; ++h) z += p.ww[g * H + h] * pr[h];
      if (p.drop) z = keep_bit(keys[g], i, j, p.thr) ? z * p.scale : 0.f;
      p.zd[((static_cast<long long>(b) * H + g) * N + i) * N + j] = f2bf(z);
    }
  }
}

__global__ void __launch_bounds__(NT) th_bwd_rows_kernel(THRowParams p) {
  extern __shared__ float sm[];   // p_h (H*N), then dp_h (H*N)
  __shared__ float red[32];
  __shared__ float s_dsum[MAXH];
  const int b = blockIdx.x / p.N, i = blockIdx.x % p.N;
  const int H = p.H, N = p.N;
  float* sp = sm;
  float* sdp = sm + H * N;
  float lse[MAXH];
  unsigned keys[MAXH];
  for (int h = 0; h < H; ++h) {
    lse[h] = p.lse[(static_cast<long long>(b) * H + h) * N + i];
    keys[h] = p.drop ? head_key(*p.seed, SITE_ATTN, b, h) : 0u;
  }
  float a_ww[MAXH * MAXH], a_bw[MAXH], a_dsum[MAXH];
  for (int e = 0; e < H * H; ++e) a_ww[e] = 0.f;
  for (int h = 0; h < H; ++h) a_bw[h] = a_dsum[h] = 0.f;
  for (int j = threadIdx.x; j < N; j += NT) {
    float pr[MAXH], dz[MAXH];
    for (int h = 0; h < H; ++h) {
      const long long o = ((static_cast<long long>(b) * H + h) * N + i) * N + j;
      pr[h] = expf(p.s[o] + p.bl[h] - lse[h]);
      sp[h * N + j] = pr[h];
    }
    for (int g = 0; g < H; ++g) {
      const long long o = ((static_cast<long long>(b) * H + g) * N + i) * N + j;
      float z = p.bw[g];
      for (int h = 0; h < H; ++h) z += p.ww[g * H + h] * pr[h];
      const bool keep = !p.drop || keep_bit(keys[g], i, j, p.thr);
      const float sc = p.drop ? p.scale : 1.f;
      p.zd[o] = f2bf(keep ? z * sc : 0.f);
      dz[g] = keep ? p.dzd[o] * sc : 0.f;
      a_bw[g] += dz[g];
      for (int h = 0; h < H; ++h) a_ww[g * H + h] += pr[h] * dz[g];
    }
    for (int h = 0; h < H; ++h) {
      float d = 0.f;
      for (int g = 0; g < H; ++g) d += p.ww[g * H + h] * dz[g];
      sdp[h * N + j] = d;
      a_dsum[h] += d * pr[h];
    }
  }
  for (int h = 0; h < H; ++h) {
    const float t = block_sum(a_dsum[h], red);
    if (threadIdx.x == 0) s_dsum[h] = t;
  }
  __syncthreads();
  float a_bl[MAXH];
  for (int h = 0; h < H; ++h) a_bl[h] = 0.f;
  for (int j = threadIdx.x; j < N; j += NT) {
    for (int g = 0; g < H; ++g) {
      const float d = sp[g * N + j] * (sdp[g * N + j] - s_dsum[g]);
      a_bl[g] += d;
      p.ds[((static_cast<long long>(b) * H + g) * N + i) * N + j] = f2bf(d);
    }
  }
  float* part = p.parts + static_cast<long long>(blockIdx.x) * (H * H + 2 * H);
  for (int e = 0; e < H * H; ++e) {
    const float t = block_sum(a_ww[e], red);
    if (threadIdx.x == 0) part[e] = t;
  }
  for (int g = 0; g < H; ++g) {
    const float t1 = block_sum(a_bw[g], red);
    const float t2 = block_sum(a_bl[g], red);
    if (threadIdx.x == 0) {
      part[H * H + g] = t1;
      part[H * H + H + g] = t2;
    }
  }
}

__global__ void th_dq_kernel(THDqParams p) {
  extern __shared__ float sm[];   // H * D products q (.) dq~_g
  const int b = blockIdx.x / p.N, i = blockIdx.x % p.N;
  const int H = p.H, D = p.D, dh = D / H;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float q = bf2f(p.q[b * p.q_sb + static_cast<long long>(i) * p.q_sn + c]);
    float acc = 0.f;
    for (int g = 0; g < H; ++g) {
      const float d = p.dqt[((static_cast<long long>(b) * H + g) * p.N + i) * D + c];
      acc += d * p.rows[g * D + c];
      sm[g * D + c] = q * d;
    }
    p.dq[b * p.o_sb + static_cast<long long>(i) * p.o_sn + c] = acc;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < H * H) {
    const int g = threadIdx.x / H, h = threadIdx.x % H;
    float s = 0.f;
    for (int c = h * dh; c < (h + 1) * dh; ++c) s += sm[g * D + c];
    p.parts[static_cast<long long>(blockIdx.x) * H * H + threadIdx.x] = p.scale * s;
  }
}

__global__ void softmax_bwd_kernel(SoftmaxBwdParams p) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const float* pr = p.p + r * p.C;
  const float* dp = p.dp + r * p.C;
  const float* da = p.dattn ? p.dattn + r * p.C : nullptr;
  float s = 0.f;
  for (int j = threadIdx.x; j < p.C; j += blockDim.x) s += (dp[j] + (da ? da[j] : 0.f)) * pr[j];
  s = block_sum(s, red);
  for (int j = threadIdx.x; j < p.C; j += blockDim.x) {
    p.dl[r * p.C + j] = f2bf(pr[j] * ((dp[j] + (da ? da[j] : 0.f)) - s));
  }
}

}  // namespace

extern "C" int spe_th_fold(const THFoldParams* p, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->N <= 0 || p->D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(p->B) * p->H * p->N * p->D;
  th_fold_kernel<<<static_cast<unsigned>((total + NT - 1) / NT), NT, 0,
                   static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// the forward (backward == 0) or the backward (backward == 1) row pass
extern "C" int spe_th_rows(const THRowParams* p, int backward, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->H > MAXH || p->N <= 0 || (p->drop && !p->seed) ||
      2 * p->H * p->N * static_cast<int>(sizeof(float)) > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(p->B) * p->N;
  const int plane = p->H * p->N * static_cast<int>(sizeof(float));
  cudaError_t err;
  if (backward) {
    err = cudaFuncSetAttribute(th_bwd_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * plane);
    if (err != cudaSuccess) return static_cast<int>(err);
    th_bwd_rows_kernel<<<blocks, NT, 2 * plane, s>>>(*p);
  } else {
    err = cudaFuncSetAttribute(th_fwd_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, plane);
    if (err != cudaSuccess) return static_cast<int>(err);
    th_fwd_rows_kernel<<<blocks, NT, plane, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_th_dq(const THDqParams* p, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->N <= 0 || p->D % p->H != 0 || p->H * p->H > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = p->H * p->D * static_cast<int>(sizeof(float));
  th_dq_kernel<<<static_cast<unsigned>(p->B) * p->N, 256, bytes,
                 static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_softmax_backward(const SoftmaxBwdParams* p, void* stream) {
  if (p->R <= 0 || p->C <= 0 || p->R > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  softmax_bwd_kernel<<<static_cast<unsigned>(p->R), NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

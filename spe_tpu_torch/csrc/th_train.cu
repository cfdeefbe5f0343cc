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
//   th_*_rows with wl  the standalone talking-heads attention
//                  (spe_tpu/ops/pallas_attention.py:30 _kernel and
//                  pallas_attention_bwd.py:40 _bwd_kernel): s holds each
//                  head's own logits L_h = dh^-0.5 q_h . k_h^T and the row
//                  passes mix them, m_g = sum_h wl[g, h] L_h + bl_g, as the
//                  TPU kernels do in f32 (no wl-fold); the backward writes
//                  dL_h = sum_g wl[g, h] dm_g in bf16 in place of dm (for
//                  dQ_h = scale dL_h . K_h and dK_h = scale dL_h^T . Q_h) and
//                  adds per row partials of dwl[g, h] = <L_h, dm_g>;
//   softmax_bwd    class attention: dl = p (dp + dattn - rowsum(...)), bf16;
//   attn_bwd_rows  the encoder's and decoder's standard attention: from the
//                  logits s = scale q . k^T (spe_gemm), the saved row
//                  log-sum-exp and dzd = do . V^T, p = exp(s + kbias - lse),
//                  zd = M (.) p / keep (bf16, for dV = zd^T do),
//                  dp = M (.) dzd / keep, dl = p (dp - rowsum(dp p)) (bf16,
//                  for dQ = scale dl . K and dK = scale dl^T . Q).
// The math is _block_bwd_kernel's (pallas_block.py:356-451),
// _ca_bwd_kernel's (pallas_ca_block.py:166-177), the standalone
// talking-heads kernels' (pallas_attention.py:45-75,
// pallas_attention_bwd.py:245-301), _attn_bwd_loop's
// (pallas_encoder.py:97-126), and the attention backwards of
// _dec_bwd_kernel (pallas_decoder.py:82-136, 174-203).
//
// What bounds it on the H100: these row kernels read and write each plane
// element a few times (bytes); the N^2 products around them run in spe_gemm.
// One block per (sample, query row) holds the H rows of a head group in
// shared memory, so the row sums need no second launch; every per-row
// parameter partial is reduced later by spe_reduce (deterministic).
// attn_bwd_rows has no parameter partials: one warp per row, two passes
// over it (the row sum, then dl), a fixed shuffle tree for the sum.
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
  const float* s;     // (B, H, N, N) logits without the head bias (with wl:
                      // each head's own, before the pre-softmax mix)
  const float* dzd;   // (B, H, N, N) do_g . V_g^T (backward only)
  float* lse;         // (B, H, N): written by the forward, read by the backward
  const float* bl;    // (H) pre-softmax head bias
  const float* ww;    // (H, H) torch Linear layout: z_g = sum_h ww[g*H+h] p_h
  const float* bw;    // (H)
  const unsigned* seed;
  bf16* zd;           // (B, H, N, N)
  bf16* ds;           // (B, H, N, N) backward only: dm_g, or with wl dL_h
  float* parts;       // (B*N, H*H + 2H) backward only: dww[g,h], dbw[g], dbl[g];
                      // with wl (B*N, 2H*H + 2H), then dwl[g,h]
  int B, H, N;
  int drop;           // attention dropout on
  unsigned thr;
  float scale;
  const float* wl;    // optional (H, H) pre-softmax mix, torch Linear layout:
                      // m_g = sum_h wl[g*H+h] s_h + bl_g
  int site;           // the dropout site of the keys (seed, site, b, g, i, j)
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

struct AttnRowParams {
  const float* s;      // (Z, Nq, Nk) scaled logits without the key bias
  const float* dzd;    // (Z, Nq, Nk) do . V^T
  const float* lse;    // (Z, Nq) row log-sum-exp of s + kbias
  const float* kbias;  // optional (B, Nk) with batch stride kb_sb, b = z / H
  const unsigned* seed;
  bf16* zd;            // (Z, Nq, Nk)
  bf16* dl;            // (Z, Nq, Nk)
  long long kb_sb;
  int Z, H, Nq, Nk;
  int drop_site;       // keep bits keyed (seed, site, z / mask_heads, z % mask_heads, q, k)
  unsigned drop_thr;
  float drop_scale;
  int mask_heads;
};

namespace {

constexpr int NT = 256;

// the pre-softmax logit of mixed head g at one key from the H logits l_h of
// that key: sum_h wl[g, h] l_h + bl_g with wl, else l_g + bl_g
__device__ __forceinline__ float mixed_logit(const THRowParams& p, const float* l,
                                             int g) {
  if (!p.wl) return l[g] + p.bl[g];
  float m = 0.f;
  for (int h = 0; h < p.H; ++h) m += p.wl[g * p.H + h] * l[h];
  return m + p.bl[g];
}

__device__ __forceinline__ void load_logits(const THRowParams& p, int b, int i, int j,
                                            float* l) {
  for (int h = 0; h < p.H; ++h) {
    l[h] = p.s[((static_cast<long long>(b) * p.H + h) * p.N + i) * p.N + j];
  }
}

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
  extern __shared__ float sm[];          // H * N mixed logits (+ head bias)
  __shared__ float red[32];
  __shared__ float s_lse[MAXH];
  const int b = blockIdx.x / p.N, i = blockIdx.x % p.N;
  const int H = p.H, N = p.N;
  for (int j = threadIdx.x; j < N; j += NT) {
    float l[MAXH];
    load_logits(p, b, i, j, l);
    for (int g = 0; g < H; ++g) sm[g * N + j] = mixed_logit(p, l, g);
  }
  for (int h = 0; h < H; ++h) {
    float mx = -INFINITY;
    for (int j = threadIdx.x; j < N; j += NT) mx = fmaxf(mx, sm[h * N + j]);
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
  for (int g = 0; g < H; ++g) keys[g] = p.drop ? head_key(*p.seed, p.site, b, g) : 0u;
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
    keys[h] = p.drop ? head_key(*p.seed, p.site, b, h) : 0u;
  }
  float a_ww[MAXH * MAXH], a_bw[MAXH], a_dsum[MAXH];
  for (int e = 0; e < H * H; ++e) a_ww[e] = 0.f;
  for (int h = 0; h < H; ++h) a_bw[h] = a_dsum[h] = 0.f;
  for (int j = threadIdx.x; j < N; j += NT) {
    float pr[MAXH], dz[MAXH], l[MAXH];
    load_logits(p, b, i, j, l);
    for (int h = 0; h < H; ++h) {
      pr[h] = expf(mixed_logit(p, l, h) - lse[h]);
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
  float a_bl[MAXH], a_wl[MAXH * MAXH];
  for (int h = 0; h < H; ++h) a_bl[h] = 0.f;
  for (int e = 0; e < H * H; ++e) a_wl[e] = 0.f;
  for (int j = threadIdx.x; j < N; j += NT) {
    float dm[MAXH];
    for (int g = 0; g < H; ++g) {
      dm[g] = sp[g * N + j] * (sdp[g * N + j] - s_dsum[g]);
      a_bl[g] += dm[g];
    }
    if (!p.wl) {
      for (int g = 0; g < H; ++g) {
        p.ds[((static_cast<long long>(b) * H + g) * N + i) * N + j] = f2bf(dm[g]);
      }
      continue;
    }
    float l[MAXH];
    load_logits(p, b, i, j, l);
    for (int h = 0; h < H; ++h) {
      float dl = 0.f;
      for (int g = 0; g < H; ++g) {
        dl += p.wl[g * H + h] * dm[g];
        a_wl[g * H + h] += l[h] * dm[g];
      }
      p.ds[((static_cast<long long>(b) * H + h) * N + i) * N + j] = f2bf(dl);
    }
  }
  const int width = (p.wl ? 2 * H * H : H * H) + 2 * H;
  float* part = p.parts + static_cast<long long>(blockIdx.x) * width;
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
  if (p.wl) {
    for (int e = 0; e < H * H; ++e) {
      const float t = block_sum(a_wl[e], red);
      if (threadIdx.x == 0) part[H * H + 2 * H + e] = t;
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

__device__ __forceinline__ void attn_row_values(const AttnRowParams& p, long long o,
                                                const float* kb, float lse, unsigned key,
                                                unsigned i, int j, float* pr, float* dp,
                                                bool* keep) {
  *pr = expf(p.s[o + j] + (kb ? kb[j] : 0.f) - lse);
  *keep = !p.drop_site || keep_bit(key, i, static_cast<unsigned>(j), p.drop_thr);
  const float sc = p.drop_site ? p.drop_scale : 1.f;
  *dp = *keep ? p.dzd[o + j] * sc : 0.f;
}

__global__ void __launch_bounds__(NT) attn_bwd_rows_kernel(AttnRowParams p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (NT / 32) + warp;
  if (row >= static_cast<long long>(p.Z) * p.Nq) return;
  const int z = static_cast<int>(row / p.Nq);
  const unsigned i = static_cast<unsigned>(row % p.Nq);
  const long long o = row * p.Nk;
  const float* kb = p.kbias ? p.kbias + (z / p.H) * p.kb_sb : nullptr;
  const float lse = p.lse[row];
  const unsigned key =
      p.drop_site ? head_key(*p.seed, p.drop_site, z / p.mask_heads, z % p.mask_heads) : 0u;
  const float sc = p.drop_site ? p.drop_scale : 1.f;
  float acc = 0.f;
  for (int j = lane; j < p.Nk; j += 32) {
    float pr, dp;
    bool keep;
    attn_row_values(p, o, kb, lse, key, i, j, &pr, &dp, &keep);
    p.zd[o + j] = f2bf(keep ? pr * sc : 0.f);
    acc += dp * pr;
  }
  const float sum = warp_sum(acc);
  for (int j = lane; j < p.Nk; j += 32) {
    float pr, dp;
    bool keep;
    attn_row_values(p, o, kb, lse, key, i, j, &pr, &dp, &keep);
    p.dl[o + j] = f2bf(pr * (dp - sum));
  }
}

}  // namespace

extern "C" int spe_attn_bwd_rows(const AttnRowParams* p, void* stream) {
  const long long rows = static_cast<long long>(p->Z) * p->Nq;
  if (p->Z <= 0 || p->H <= 0 || p->Nq <= 0 || p->Nk <= 0 ||
      (p->drop_site && (!p->seed || p->mask_heads <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (rows + NT / 32 - 1) / (NT / 32);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_rows_kernel<<<static_cast<unsigned>(blocks), NT, 0,
                         static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spe_th_fold(const THFoldParams* p, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->N <= 0 || p->D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(p->B) * p->H * p->N * p->D;
  th_fold_kernel<<<static_cast<unsigned>((total + NT - 1) / NT), NT, 0,
                   static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// the forward (backward == 0) or the backward (backward == 1) row pass
extern "C" int spe_th_rows(const THRowParams* p, int backward, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->H > MAXH || p->N <= 0 ||
      (p->drop && (!p->seed || p->site <= 0)) ||
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

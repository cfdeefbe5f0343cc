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
// th_fwd_rows: one block per (sample, query row) holds the H rows of a head
// group in shared memory, so the row sums need no second launch.
// th_bwd_rows (the talking-heads softmax backward of _block_bwd_kernel,
// pallas_block.py:356-451, and of pallas_attention_bwd.py:245-301
// _bwd_kernel) reads s and dzd (f32) and writes zd and ds (bf16), 12 bytes
// per plane element: 0.12 ms at B=8, H=4, N=1024. Its design: H is a
// template parameter, so every per-head array stays in registers; each
// thread keeps its 4 columns of every head (p_h, dp_h and, with wl, the
// logits, read once) in registers across the one block reduction a row
// needs (rowsum(dp_h p_h), H values); 16-byte loads and 8-byte stores; a
// fixed grid of at most TH_BLOCKS blocks walks fixed runs of rows and
// accumulates the parameter partials (dww, dbw, dbl, dwl) in registers,
// reduced once per block, then across blocks by spe_reduce, so two runs
// give the same bits. attn_bwd_rows has no parameter partials: one warp per
// row, two passes over it (the row sum, then dl), a fixed shuffle tree for
// the sum.
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
  float* parts;       // (blocks, H*H + 2H) backward only: dww[g,h], dbw[g], dbl[g];
                      // with wl (blocks, 2H*H + 2H), then dwl[g,h]
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

// th_bwd_rows_kernel: TH_BLOCKS blocks (fewer for few rows) of TH_NT
// threads, each over a fixed run of rows_per_block consecutive (sample,
// query) rows; a thread keeps 4 consecutive columns of every head in
// registers (H is a template parameter, so every per-head array is indexed
// at compile time). Per row: one 16-byte load of each head's logits and
// dzd, 8-byte stores of zd and ds, one block reduction of the H values
// rowsum(dp_h p_h); the parameter partials accumulate in registers over
// the block's rows and are reduced once at its end into parts[block].
constexpr int TH_NT = 256;
constexpr int TH_BLOCKS = 1024;

// 4 f32 values of a row at column c (0 at and past n)
__device__ __forceinline__ void load_row4(const float* row, int c, int n, bool vec,
                                          float (&v)[4]) {
  if (vec && c + 4 <= n) {
    const float4 x = *reinterpret_cast<const float4*>(row + c);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < n ? row[c + e] : 0.f;
}

__device__ __forceinline__ void store_row4(bf16* row, int c, int n, bool vec,
                                           const float (&v)[4]) {
  if (vec && c + 4 <= n) {
    *reinterpret_cast<uint2*>(row + c) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (c + e < n) row[c + e] = f2bf(v[e]);
  }
}

template <int H, bool WL>
__global__ void __launch_bounds__(TH_NT) th_bwd_rows_kernel(THRowParams p, int rows_per_block) {
  constexpr int NW = TH_NT / 32;
  constexpr int WIDTH = (WL ? 2 * H * H : H * H) + 2 * H;
  __shared__ float red[2][NW][H];
  __shared__ float fin[NW][WIDTH];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int N = p.N;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(p.B * N, r0 + rows_per_block);
  const int c0 = 4 * threadIdx.x;            // this thread's 4 columns
  const bool on = c0 < N;
  const bool vec = N % 4 == 0;                // 16-byte rows
  const float sc = p.drop ? p.scale : 1.f;

  float ww[H * H], wl[WL ? H * H : 1], bl[H], bw[H];
#pragma unroll
  for (int e = 0; e < H * H; ++e) {
    ww[e] = p.ww[e];
    if constexpr (WL) wl[e] = p.wl[e];
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    bl[h] = p.bl[h];
    bw[h] = p.bw[h];
  }
  float a_ww[H * H], a_wl[WL ? H * H : 1], a_bw[H], a_bl[H];
#pragma unroll
  for (int e = 0; e < H * H; ++e) {
    a_ww[e] = 0.f;
    if constexpr (WL) a_wl[e] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < H; ++h) a_bw[h] = a_bl[h] = 0.f;

  for (int r = r0; r < r1; ++r) {
    const int b = r / N, i = r % N;
    // row (b, h, i) of a (B, H, N, N) plane starts at ((b * H + h) * N + i) * N
    const long long row0 = (static_cast<long long>(b) * H * N + i) * N;
    const long long hstride = static_cast<long long>(N) * N;
    float pr[H][4], dpv[H][4], lg[WL ? H : 1][4], dot[H];
#pragma unroll
    for (int h = 0; h < H; ++h) dot[h] = 0.f;
    if (on) {
      float l[H][4];
#pragma unroll
      for (int h = 0; h < H; ++h) load_row4(p.s + row0 + h * hstride, c0, N, vec, l[h]);
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const float lse = p.lse[(static_cast<long long>(b) * H + g) * N + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float m;
          if constexpr (WL) {
            m = 0.f;
#pragma unroll
            for (int h = 0; h < H; ++h) m += wl[g * H + h] * l[h][e];
            m += bl[g];
          } else {
            m = l[g][e] + bl[g];
          }
          pr[g][e] = c0 + e < N ? expf(m - lse) : 0.f;
        }
      }
      if constexpr (WL) {
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) lg[h][e] = l[h][e];
      }
      float dz[H][4];
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const unsigned key = p.drop ? head_key(*p.seed, p.site, b, g) : 0u;
        float d[4], zo[4];
        load_row4(p.dzd + row0 + g * hstride, c0, N, vec, d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float z = bw[g];
#pragma unroll
          for (int h = 0; h < H; ++h) z += ww[g * H + h] * pr[h][e];
          const bool keep = !p.drop || keep_bit(key, i, c0 + e, p.thr);
          zo[e] = keep ? z * sc : 0.f;
          dz[g][e] = keep ? d[e] * sc : 0.f;
          a_bw[g] += dz[g][e];
#pragma unroll
          for (int h = 0; h < H; ++h) a_ww[g * H + h] += pr[h][e] * dz[g][e];
        }
        store_row4(p.zd + row0 + g * hstride, c0, N, vec, zo);
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float d = 0.f;
#pragma unroll
          for (int g = 0; g < H; ++g) d += ww[g * H + h] * dz[g][e];
          dpv[h][e] = d;
          dot[h] += d * pr[h][e];
        }
    }
    // rowsum(dp_h p_h): a fixed shuffle tree, then the warps in order
    const int par = (r - r0) & 1;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float t = warp_sum(dot[h]);
      if (lane == 0) red[par][warp][h] = t;
    }
    __syncthreads();
    if (!on) continue;
    float S[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      S[h] = 0.f;
      for (int w = 0; w < NW; ++w) S[h] += red[par][w][h];
    }
    float dm[H][4];
#pragma unroll
    for (int g = 0; g < H; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dm[g][e] = pr[g][e] * (dpv[g][e] - S[g]);
        a_bl[g] += dm[g][e];
      }
    if constexpr (!WL) {
#pragma unroll
      for (int g = 0; g < H; ++g) store_row4(p.ds + row0 + g * hstride, c0, N, vec, dm[g]);
    } else {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float dl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dl[e] = 0.f;
#pragma unroll
        for (int g = 0; g < H; ++g) {
          dl[e] += wl[g * H + h] * dm[g][e];
          a_wl[g * H + h] += lg[h][e] * dm[g][e];
        }
      }
      store_row4(p.ds + row0 + h * hstride, c0, N, vec, dl);
    }
    }
  }
  // the block's partials: [dww (H*H) | dbw (H) | dbl (H) | dwl (H*H)]
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
    float v = 0.f;
    if (e < H * H) {
      v = a_ww[e];
    } else if (e < H * H + H) {
      v = a_bw[e - H * H];
    } else if (e < H * H + 2 * H) {
      v = a_bl[e - H * H - H];
    } else if constexpr (WL) {
      v = a_wl[e - H * H - 2 * H];
    }
    v = warp_sum(v);
    if (lane == 0) fin[warp][e] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < WIDTH; e += TH_NT) {
    float t = 0.f;
    for (int w = 0; w < NW; ++w) t += fin[w][e];
    p.parts[static_cast<long long>(blockIdx.x) * WIDTH + e] = t;
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

namespace {

template <int H>
int launch_th_bwd(const THRowParams* p, cudaStream_t s) {
  const long long rows = static_cast<long long>(p->B) * p->N;
  const long long per = (rows + TH_BLOCKS - 1) / TH_BLOCKS;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  if (p->wl) {
    th_bwd_rows_kernel<H, true><<<blocks, TH_NT, 0, s>>>(*p, static_cast<int>(per));
  } else {
    th_bwd_rows_kernel<H, false><<<blocks, TH_NT, 0, s>>>(*p, static_cast<int>(per));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the forward (backward == 0) or the backward (backward == 1) row pass.
// The backward takes N <= 4 * TH_NT (a thread's 4 columns of a row) and
// writes parts as (blocks, width): blocks = ceil(B*N / ceil(B*N /
// TH_BLOCKS)), a function of the shape alone.
extern "C" int spe_th_rows(const THRowParams* p, int backward, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->H > MAXH || p->N <= 0 ||
      static_cast<long long>(p->B) * p->N > 2147483647LL ||
      (p->drop && (!p->seed || p->site <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (backward) {
    if (p->N > 4 * TH_NT) return static_cast<int>(cudaErrorInvalidValue);
    switch (p->H) {
      case 1: return launch_th_bwd<1>(p, s);
      case 2: return launch_th_bwd<2>(p, s);
      case 3: return launch_th_bwd<3>(p, s);
      case 4: return launch_th_bwd<4>(p, s);
      case 5: return launch_th_bwd<5>(p, s);
      case 6: return launch_th_bwd<6>(p, s);
      case 7: return launch_th_bwd<7>(p, s);
      default: return launch_th_bwd<8>(p, s);
    }
  }
  const int plane = p->H * p->N * static_cast<int>(sizeof(float));
  if (2 * plane > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      th_fwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plane);
  if (err != cudaSuccess) return static_cast<int>(err);
  th_fwd_rows_kernel<<<static_cast<unsigned>(p->B) * p->N, NT, plane, s>>>(*p);
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

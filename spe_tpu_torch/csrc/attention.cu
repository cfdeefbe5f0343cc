// attention: online-softmax (flash-style) multi-head attention with separate
// q/k and v head widths, an additive per-batch key bias, an optional
// per-head q column scale rounded to bf16 (the talking-heads wl-fold and the
// class-attention pre-scale), an optional per-head logit bias, and an
// optional second pass that writes the exactly normalised f32 probabilities.
//
// The training form of the encoder and decoder attentions adds counter
// dropout on the probabilities and writes each query row's log-sum-exp
// (B, H, Nq) f32 for the backward. Their attentions have no post-softmax
// mix, so dropout commutes with the row normalisation: the tile's
// unnormalised weights e = exp(s - m) enter the running sum undropped and
// the PV sum as keep ? e / (1 - rate) : 0, and the final 1 / l gives
// drop(softmax(s)) . V with nothing of size N x N in device memory.
//
// Replaces the attention cores inside the TPU layer kernels:
//   spe_tpu/ops/pallas_block.py:119 _attention (talking heads; called per
//       output head g with q (.) row_g over all of D, k and v shared)
//   spe_tpu/ops/pallas_ca_block.py:80-88 (class attention, writes the CAM)
//   spe_tpu/ops/pallas_encoder.py:76 _attn_fwd_loop (key-padding bias)
//   spe_tpu/ops/pallas_decoder.py:82 _self_attention (per query set) and
//       :150 _cross_fwd_loop (qc.kc + sine.kpos as one 2*dh-wide dot)
// The TPU keeps (q_tile, N) logits for every head in VMEM; here a block
// holds 64 query rows of one (batch, head) and streams 64-key tiles with a
// running max and sum, so nothing of size N x N reaches device memory.
//
// What bounds it on the H100: at N = 1024 the QK^T and PV products dominate
// (compute bound); this version computes them with f32 FMAs from shared
// memory on the CUDA cores. Head widths of 24 and 48 are not wgmma tiles;
// the SIMT layout needs no padding for them (rows are padded by one float in
// shared memory against bank conflicts).
#include "common.cuh"

struct AttnParams {
  const bf16* q;        // element (b, n, h, c) at b*q_sb + n*q_sn + h*q_sh + c
  const bf16* k;
  const bf16* v;
  const float* qscale;  // optional (H, DQ): q <- bf16(q * qscale[h])
  const float* kbias;   // optional (B, Nk) additive logit bias, batch stride kb_sb
  const float* hbias;   // optional (H) additive logit bias per head
  void* out;            // bf16 or f32 (out_f32), same stride scheme
  float* probs;         // optional (B, H, Nq, Nk) f32 normalised probabilities
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  long long kb_sb;
  int B, H, Nq, Nk;
  float logit_scale;    // applied to q.k in f32, before the biases
  int out_f32;
  // training form: keep bits keyed (seed, drop_site, z / mask_heads,
  // z % mask_heads, query row, key) for the block's z = b * H + h
  const unsigned* seed;
  float* lse;           // optional (B, H, Nq) f32 row log-sum-exp of the logits
  int drop_site;        // 0 = no dropout
  unsigned drop_thr;
  float drop_scale;
  int mask_heads;
};

namespace {

constexpr int BQ = 64, BKEY = 64, NT = 256, LDS = BKEY + 1;

template <int DQ, int DV>
constexpr size_t attn_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (DQ + 1) + static_cast<size_t>(BKEY) * (DQ + 1) +
          static_cast<size_t>(BKEY) * DV + static_cast<size_t>(BQ) * LDS + 3 * BQ);
}

// S[r][c] = logit of query row r of the tile against key k0 + c
template <int DQ>
__device__ __forceinline__ void tile_scores(const AttnParams& p, const float* Qs,
                                            const float* Ks, float* Ss, int k0,
                                            const float* kbias, float hb) {
  constexpr int LDQ = DQ + 1;
  const int tid = threadIdx.x;
  const int sy = tid / 16, sx = tid % 16;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DQ; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(sy + 16 * i) * LDQ + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(sx + 16 * j) * LDQ + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = sx + 16 * j;
      const int kj = k0 + c;
      Ss[(sy + 16 * i) * LDS + c] =
          kj < p.Nk ? s[i][j] * p.logit_scale + (kbias ? kbias[kj] : 0.f) + hb
                    : -INFINITY;
    }
}

template <int DQ>
__device__ __forceinline__ void load_keys(const AttnParams& p, const bf16* kb,
                                          float* Ks, int k0) {
  constexpr int LDQ = DQ + 1;
  for (int e = threadIdx.x; e < BKEY * DQ; e += NT) {
    const int r = e / DQ, c = e % DQ;
    const int kj = k0 + r;
    Ks[r * LDQ + c] = kj < p.Nk ? bf2f(kb[kj * p.k_sn + c]) : 0.f;
  }
}

// CN output columns per thread along DV
template <int DQ, int DV, int CN>
__global__ void __launch_bounds__(NT) attn_kernel(AttnParams p) {
  constexpr int LDQ = DQ + 1;
  constexpr int TPC = DV / CN;   // threads along the output columns
  constexpr int TPR = NT / TPC;  // threads along the rows
  constexpr int RM = BQ / TPR;   // rows per thread
  static_assert(DV % CN == 0 && NT % TPC == 0 && BQ % TPR == 0, "tiling");

  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;          // BKEY x LDQ
  float* Vs = Ks + BKEY * LDQ;        // BKEY x DV
  float* Ss = Vs + BKEY * DV;         // BQ x LDS
  float* row_m = Ss + BQ * LDS;       // running max
  float* row_l = row_m + BQ;          // running sum
  float* row_a = row_l + BQ;          // rescale factor of this tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* qs = p.qscale ? p.qscale + h * DQ : nullptr;
  const float* kbias = p.kbias ? p.kbias + b * p.kb_sb : nullptr;
  const float hb = p.hbias ? p.hbias[h] : 0.f;
  const unsigned z = blockIdx.y;
  const unsigned dkey =
      p.drop_site ? head_key(*p.seed, p.drop_site, z / p.mask_heads, z % p.mask_heads) : 0u;

  for (int e = tid; e < BQ * DQ; e += NT) {
    const int r = e / DQ, c = e % DQ;
    const int qi = q0 + r;
    float x = 0.f;
    if (qi < p.Nq) {
      x = bf2f(qb[qi * p.q_sn + c]);
      if (qs) x = round_bf16(x * qs[c]);
    }
    Qs[r * LDQ + c] = x;
  }
  if (tid < BQ) {
    row_m[tid] = -1e30f;
    row_l[tid] = 0.f;
  }

  const int tr = tid / TPC, tc = tid % TPC;
  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Nk; k0 += BKEY) {
    __syncthreads();  // the previous tile's readers are done
    load_keys<DQ>(p, kb, Ks, k0);
    for (int e = tid; e < BKEY * DV; e += NT) {
      const int r = e / DV, c = e % DV;
      const int kj = k0 + r;
      Vs[r * DV + c] = kj < p.Nk ? bf2f(vb[kj * p.v_sn + c]) : 0.f;
    }
    __syncthreads();
    tile_scores<DQ>(p, Qs, Ks, Ss, k0, kbias, hb);
    __syncthreads();
    {
      // online softmax update: four lanes per row, 16 columns each
      const int r = tid / 4, part = tid % 4;
      float* srow = Ss + r * LDS + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      const unsigned qrow = static_cast<unsigned>(q0 + r);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e = __expf(srow[c] - m_new);
        sum += e;
        // dropout after the sum: the normaliser is the undropped row's
        srow[c] = !p.drop_site ? e
                  : keep_bit(dkey, qrow, static_cast<unsigned>(k0 + part * 16 + c),
                             p.drop_thr) ? e * p.drop_scale : 0.f;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = __expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float al = row_a[tr + TPR * i];
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKEY; ++kk) {
      float vv[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) vv[j] = Vs[kk * DV + tc + TPC * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float pp = Ss[(tr + TPR * i) * LDS + kk];
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(pp, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = tr + TPR * i;
    const int qi = q0 + r;
    if (qi >= p.Nq) continue;
    const float inv = 1.f / row_l[r];
    if (p.lse && tc == 0) {
      p.lse[static_cast<long long>(z) * p.Nq + qi] = row_m[r] + logf(row_l[r]);
    }
    const long long base = b * p.o_sb + static_cast<long long>(qi) * p.o_sn + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const float val = acc[i][j] * inv;
      const int c = tc + TPC * j;
      if (p.out_f32) {
        static_cast<float*>(p.out)[base + c] = val;
      } else {
        static_cast<bf16*>(p.out)[base + c] = f2bf(val);
      }
    }
  }

  if (p.probs) {
    // second pass: recompute each key tile's logits and write
    // exp(s - m) / l, the exactly normalised probabilities
    for (int k0 = 0; k0 < p.Nk; k0 += BKEY) {
      __syncthreads();
      load_keys<DQ>(p, kb, Ks, k0);
      __syncthreads();
      tile_scores<DQ>(p, Qs, Ks, Ss, k0, kbias, hb);
      __syncthreads();
      for (int e = tid; e < BQ * BKEY; e += NT) {
        const int r = e / BKEY, c = e % BKEY;
        const int qi = q0 + r, kj = k0 + c;
        if (qi < p.Nq && kj < p.Nk) {
          const long long off =
              (static_cast<long long>(b * p.H + h) * p.Nq + qi) * p.Nk + kj;
          p.probs[off] = __expf(Ss[r * LDS + c] - row_m[r]) / row_l[r];
        }
      }
    }
  }
}

template <int DQ, int DV, int CN>
int launch(const AttnParams* p, cudaStream_t stream) {
  constexpr size_t smem = attn_smem_bytes<DQ, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<DQ, DV, CN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p->Nq + BQ - 1) / BQ, p->B * p->H);
  attn_kernel<DQ, DV, CN><<<grid, NT, smem, stream>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq x dv combinations of the slice: 192x192 talking heads (wl-fold over all
// of D), 48x48 class attention, 24x24 encoder and decoder self-attention,
// 48x24 conditional cross-attention.
extern "C" int spe_attention(const AttnParams* p, int dq, int dv, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->Nq <= 0 || p->Nk <= 0 || p->B * p->H > 65535 ||
      (p->drop_site && (!p->seed || p->mask_heads <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq == 192 && dv == 192) return launch<192, 192, 12>(p, s);
  if (dq == 48 && dv == 48) return launch<48, 48, 3>(p, s);
  if (dq == 24 && dv == 24) return launch<24, 24, 3>(p, s);
  if (dq == 48 && dv == 24) return launch<48, 24, 3>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// running max and sum, so nothing of size N x N reaches device memory. B4's
// forward (spe_tpu/ops/pallas_mha.py:165 `_fwd_kernel`) is this kernel as
// it stands.
//
// What bounds it on the H100: at N = 1024 the QK^T and PV products
// (2 N^2 (dq + dv) per head: compute) and, for heads of 24, the exp of
// every logit. The design puts both products on the tensor cores:
// - mma.sync.m16n8k16 (bf16 operands, f32 accumulators). Not wgmma: a
//   warpgroup's 64-row tile would need each head's 64 query rows in one
//   warpgroup and its asynchronous accumulators around the online
//   softmax; the m16n8k16 fragments fit head widths of 24 (padded to a
//   depth of 32 with zeros), 48 and 192 with one code path.
// - Each of 4 warps owns 16 query rows; its Q fragments (bf16(q * qscale))
//   stay in registers for the whole key loop.
// - K and V tiles of 64 keys in bf16 shared memory (rows padded so that
//   ldmatrix reads without bank conflicts), filled by cp.async into a
//   2-stage ring: the next tile loads while this one is computed. The copy
//   width (16, 8 or 4 bytes; 2 by plain loads) is the widest every K/V row
//   start allows (spe_attention_copy_bytes).
// - The score tile, the running max (quad shuffles) and each thread's
//   share of the running sum live in registers; dropout falls on the
//   fragment's elements with the same keep_bit keys as before.
// - P is rounded to bf16 in registers and is PV's A operand as it stands
//   (the m16n8 accumulator layout of 16 keys is the A fragment's), as the
//   reference rounds p to v's dtype (pallas_mha.py:81); V comes in through
//   ldmatrix.trans.
// - DV = 192: a warp's 16 x 192 accumulators (96 f32 registers) stay whole
//   in the warp that owns the rows (about 250 registers and no local
//   memory, as chip_smoke.py's build phase reads them), so no two warps
//   compute the same logits.
// - The probabilities' second pass recomputes S on the tensor cores.
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

constexpr int ABQ = 64;    // query rows of a block: 4 row groups of 16
constexpr int ABK = 64;    // keys of a tile

// DQ x DV: q/k and v head widths
template <int DQ, int DV>
struct AttnCfg {
  static constexpr int DQP = (DQ + 15) / 16 * 16;   // the QK^T depth, zero-padded
  static constexpr int KS = DQP / 16;               // k16 steps of QK^T
  static constexpr int NV = DV / 8;                 // n8 tiles of PV
  static constexpr int NTH = 4 * 32;                // 4 warps of 16 rows
  static constexpr int LDK = pad_ld(DQP), LDV = pad_ld(DV);
  static constexpr int STAGE = ABK * (LDK + LDV);   // bf16 elements of one K|V stage
  // the K|V ring: two stages keep two 102 KB blocks of the 192-wide heads
  // on a SM
  static constexpr int STAGES = 2;
  static constexpr size_t SMEM = STAGES * STAGE * sizeof(bf16);
  static_assert(DQ % 8 == 0 && DV % 8 == 0, "head widths");
};

// rows [0, ABK) x cols [0, D) of a K or V tile from keys k0.. into a
// shared tile of row length LD, CW bytes per copy (16, 8 or 4 by cp.async;
// 2: plain loads); keys past Nk are zero-filled
template <int D, int LD, int NTH>
__device__ __forceinline__ void load_rows(const bf16* src, long long sn, int k0, int Nk,
                                          bf16* dst, int cw) {
  const int ce = cw / 2;              // elements per copy
  const int per_row = D / ce;
  for (int e = threadIdx.x; e < ABK * per_row; e += NTH) {
    const int r = e / per_row, c = (e % per_row) * ce;
    const int key = k0 + r;
    const bool in = key < Nk;
    const bf16* g = in ? src + key * sn + c : src;
    bf16* d = dst + r * LD + c;
    switch (cw) {
      case 16: cp_async<16>(smem_u32(d), g, in ? 16 : 0); break;
      case 8: cp_async<8>(smem_u32(d), g, in ? 8 : 0); break;
      case 4: cp_async<4>(smem_u32(d), g, in ? 4 : 0); break;
      default: *d = in ? *g : f2bf(0.f); break;
    }
  }
}

// the 16 x 64 logits of a warp's rows against the key tile at Ks: s[j] is
// the m16n8 accumulator of keys 8j..8j+7
template <int KS, int LDK>
__device__ __forceinline__ void tile_scores(const unsigned (&qf)[KS][4], const bf16* Ks,
                                            float (&s)[8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      unsigned r[4];
      ldsm_x4(r, smem_u32(Ks + (16 * jp + lane % 8 + (lane / 16) * 8) * LDK + 16 * ks +
                          ((lane / 8) % 2) * 8));
      mma_bf16(s[2 * jp], qf[ks], r[0], r[1]);
      mma_bf16(s[2 * jp + 1], qf[ks], r[2], r[3]);
    }
  }
}

// logit_scale, the key and head biases; keys past Nk at -inf
__device__ __forceinline__ void bias_scores(const AttnParams& p, const float* kbias, float hb,
                                            int k0, float (&s)[8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + (lane % 4) * 2 + e;
      const bool in = key < p.Nk;
      const float add = (in && kbias ? kbias[key] : 0.f) + hb;
      s[j][e] = in ? s[j][e] * p.logit_scale + add : -INFINITY;
      s[j][e + 2] = in ? s[j][e + 2] * p.logit_scale + add : -INFINITY;
    }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(AttnCfg<DQ, DV>::NTH)
    attn_kernel(AttnParams p, int cw) {
  using C = AttnCfg<DQ, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = warp;   // the warp's 16 rows of the block's 64
  const int q0 = blockIdx.x * ABQ;
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
  const int nkt = (p.Nk + ABK - 1) / ABK;

  // K|V tile t into its stage of the ring, as one cp.async group (empty
  // past the last tile)
  auto issue = [&](int t) {
    if (t < nkt) {
      bf16* st = smem + (t % C::STAGES) * C::STAGE;
      load_rows<DQ, C::LDK, C::NTH>(kb, p.k_sn, t * ABK, p.Nk, st, cw);
      load_rows<DV, C::LDV, C::NTH>(vb, p.v_sn, t * ABK, p.Nk, st + ABK * C::LDK, cw);
    }
    cp_async_commit();
  };
  // the first K|V tiles in flight while Q is read
#pragma unroll
  for (int t = 0; t < C::STAGES - 1; ++t) issue(t);
  // K's padded depth columns [DQ, DQP) are never loaded: zero in every stage
  if constexpr (C::DQP > DQ) {
    constexpr int PADC = C::DQP - DQ;
    for (int e = threadIdx.x; e < C::STAGES * ABK * PADC; e += C::NTH) {
      const int st = e / (ABK * PADC), rem = e % (ABK * PADC);
      smem[st * C::STAGE + (rem / PADC) * C::LDK + DQ + rem % PADC] = f2bf(0.f);
    }
  }

  // Q fragments of this warp's 16 rows, bf16(q * qscale) where given,
  // zero past Nq and past DQ; registers for the whole key loop
  const int g = lane / 4, t2 = (lane % 4) * 2;
  unsigned qf[C::KS][4];
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int qi = q0 + 16 * wr + g + 8 * (f % 2);
      const int c = 16 * ks + t2 + 8 * (f / 2);
      unsigned u = 0u;
      if (qi < p.Nq && c < DQ) {
        const bf16* src = qb + static_cast<long long>(qi) * p.q_sn + c;
        if (qs) {
          u = pack_bf16(bf2f(src[0]) * qs[c], bf2f(src[1]) * qs[c + 1]);
        } else {
          u = static_cast<unsigned>(reinterpret_cast<const unsigned short*>(src)[0]) |
              static_cast<unsigned>(reinterpret_cast<const unsigned short*>(src)[1]) << 16;
        }
      }
      qf[ks][f] = u;
    }

  float m_r[2] = {-1e30f, -1e30f};
  float l_r[2] = {0.f, 0.f};   // this thread's share of each row's sum
  float o[C::NV][4];
#pragma unroll
  for (int j = 0; j < C::NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const unsigned qrow[2] = {static_cast<unsigned>(q0 + 16 * wr + g),
                            static_cast<unsigned>(q0 + 16 * wr + g + 8)};

  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * ABK;
    issue(t + C::STAGES - 1);
    cp_async_wait<C::STAGES - 1>();   // tile t has landed
    __syncthreads();
    const bf16* Ks = smem + (t % C::STAGES) * C::STAGE;
    const bf16* Vs = Ks + ABK * C::LDK;

    float s[8][4];
    tile_scores<C::KS, C::LDK>(qf, Ks, s);
    bias_scores(p, kbias, hb, k0, s);
    // online softmax: the row max over the quad, the rescale of what was
    // summed so far
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      const float alpha = __expf(m_r[hr] - m_new);
      m_r[hr] = m_new;
      l_r[hr] *= alpha;
#pragma unroll
      for (int j = 0; j < C::NV; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }
    // e = exp(s - m) into the sum undropped; the PV operand dropped
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e / 2;
        float v = __expf(s[j][e] - m_r[hr]);
        l_r[hr] += v;
        if (p.drop_site) {
          const unsigned key = static_cast<unsigned>(k0 + 8 * j + t2 + e % 2);
          v = keep_bit(dkey, qrow[hr], key, p.drop_thr) ? v * p.drop_scale : 0.f;
        }
        s[j][e] = v;
      }
    // PV: the weights rounded to bf16 in registers are the A operand (the
    // accumulator layout of keys 16kk..16kk+15 is the A fragment's); V
    // through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = Vs + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * C::LDV;
#pragma unroll
      for (int jp = 0; jp < C::NV / 2; ++jp) {
        unsigned r[4];
        ldsm_x4_t(r, smem_u32(vrow + 16 * jp + (lane / 16) * 8));
        mma_bf16(o[2 * jp], pa, r[0], r[1]);
        mma_bf16(o[2 * jp + 1], pa, r[2], r[3]);
      }
      if (C::NV % 2) {
        unsigned r[2];
        ldsm_x2_t(r, smem_u32(Vs + (16 * kk + lane % 16) * C::LDV + 8 * (C::NV - 1)));
        mma_bf16(o[C::NV - 1], pa, r[0], r[1]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  float l_row[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[hr] = l;
    const int qi = static_cast<int>(qrow[hr]);
    if (qi >= p.Nq) continue;
    const float inv = 1.f / l;
    if (p.lse && lane % 4 == 0) {
      p.lse[static_cast<long long>(z) * p.Nq + qi] = m_r[hr] + logf(l);
    }
    const long long base = b * p.o_sb + static_cast<long long>(qi) * p.o_sn + h * p.o_sh +
                           t2;
#pragma unroll
    for (int j = 0; j < C::NV; ++j) {
      const float v0 = o[j][2 * hr] * inv, v1 = o[j][2 * hr + 1] * inv;
      if (p.out_f32) {
        float* out = static_cast<float*>(p.out) + base + 8 * j;
        out[0] = v0;
        out[1] = v1;
      } else {
        bf16* out = static_cast<bf16*>(p.out) + base + 8 * j;
        out[0] = f2bf(v0);
        out[1] = f2bf(v1);
      }
    }
  }

  if (p.probs) {
    // second pass: recompute each key tile's logits on the tensor cores and
    // write exp(s - m) / l, the exactly normalised probabilities
    for (int t = 0; t < nkt; ++t) {
      const int k0 = t * ABK;
      __syncthreads();
      load_rows<DQ, C::LDK, C::NTH>(kb, p.k_sn, k0, p.Nk, smem, cw);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float s[8][4];
      tile_scores<C::KS, C::LDK>(qf, smem, s);
      bias_scores(p, kbias, hb, k0, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e / 2;
        const int qi = static_cast<int>(qrow[hr]);
        if (qi >= p.Nq) continue;
        const long long row = (static_cast<long long>(z) * p.Nq + qi) * p.Nk;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + 8 * j + t2 + e % 2;
          if (key < p.Nk) p.probs[row + key] = __expf(s[j][e] - m_r[hr]) / l_row[hr];
        }
      }
    }
  }
}

template <int DQ, int DV>
int launch(const AttnParams* p, int cw, cudaStream_t stream) {
  using C = AttnCfg<DQ, DV>;
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<DQ, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p->Nq + ABQ - 1) / ABQ, p->B * p->H);
  attn_kernel<DQ, DV><<<grid, C::NTH, C::SMEM, stream>>>(*p, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bytes of each K and V copy into shared memory: the widest of 16, 8
// and 4 that divides both pointers and every batch, head and row stride
// (in bytes), else 2 (plain loads).
extern "C" int spe_attention_copy_bytes(const AttnParams* p) {
  const unsigned long long g =
      reinterpret_cast<unsigned long long>(p->k) | reinterpret_cast<unsigned long long>(p->v) |
      static_cast<unsigned long long>(2 * (p->k_sb | p->k_sh | p->k_sn | p->v_sb | p->v_sh |
                                           p->v_sn));
  for (int w = 16; w >= 4; w /= 2) {
    if (g % w == 0) return w;
  }
  return 2;
}

// dq x dv combinations of the slice: 192x192 talking heads (wl-fold over all
// of D), 48x48 class attention, 24x24 encoder and decoder self-attention,
// 48x24 conditional cross-attention.
extern "C" int spe_attention(const AttnParams* p, int dq, int dv, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->Nq <= 0 || p->Nk <= 0 || p->B * p->H > 65535 ||
      (p->drop_site && (!p->seed || p->mask_heads <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cw = spe_attention_copy_bytes(p);
  if (dq == 192 && dv == 192) return launch<192, 192>(p, cw, s);
  if (dq == 48 && dv == 48) return launch<48, 48>(p, cw, s);
  if (dq == 24 && dv == 24) return launch<24, 24>(p, cw, s);
  if (dq == 48 && dv == 24) return launch<48, 24>(p, cw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// What bounds it on the H100: at the recipe's shapes (M = B*1024 or
// B*600 rows, N from 192 to 2048) the K = 192 products move more bytes
// than the tensor cores need time for (A in f32 or bf16, the output and
// the residual stream: ~100 flops per byte, under the card's ~295), the
// K = 768/2048 ones (fc2, linear2) are compute bound. The design, three
// ways through K, all on mma.sync.m16n8k16 (bf16 operands, f32
// accumulators, ldmatrix fragments; wgmma/TMA not tried yet):
// - WHOLE (K <= 256: every LayerNorm, a2 and f32-A class, and the bf16
//   K = 192 ones): the block's bf16 A panel (BM = 128 rows x K) is built
//   once in shared memory, by cp.async or, for LayerNorm/a2/f32 rows,
//   through registers (16-byte loads, the row statistics from the same
//   loads, four rows of a warp in flight); W's whole-K tile of 64 columns
//   is double-buffered, so the next one loads while this one's products
//   (no barrier inside K) and epilogue run. One wave of blocks (two per
//   SM) walks several N tiles each, so the LayerNorm is computed once per
//   row and block, not per N tile.
// - STREAM (a bf16 A with K > 256): A and W k tiles through a 4-stage
//   cp.async ring (gemm_kernel's tile, grad.cu; the loaders of common.cuh).
// - PANEL (a transformed A with 256 < K <= PANEL_KMAX; no recipe class):
//   the 64-row panel, W through the ring.
// The epilogue goes through a shared f32 C tile (WHOLE: the consumed W
// buffer, in two halves), then rows of 4 columns per thread: 16-byte (f32)
// or 8-byte (bf16) coalesced stores where the column-group store and the
// alignment allow, 32-bit column indices. It takes about a third of a
// K = 192 product's time; an epilogue straight from the registers (4-byte
// stores) measured slower.

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
#include <algorithm>

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

constexpr int LBK = 32;          // depth of a k tile
constexpr int LSTAGES = 4;       // the shared ring: cp.async runs 3 k tiles ahead
constexpr int PANEL_KMAX = 1472; // the deepest A panel (BM = 64, ~190 KB)
constexpr int WHOLE_KMAX = 256;   // the deepest whole-K W tiles (BM = 128)
// the kernel's three ways through K: A and W k tiles through the ring
// (STREAM, K > WHOLE_KMAX), A built once as a panel and W k tiles through
// the ring (PANEL, a transformed A with K > WHOLE_KMAX), A's panel and
// W's whole-K tiles (WHOLE, K <= WHOLE_KMAX)
enum LinearMode { STREAM = 0, PANEL = 1, WHOLE = 2 };
constexpr int SMEM_MAX = 232448;
// resident warps per SM the register budget is cut for (as gemm_kernel)
constexpr int LIN_MIN_WARPS = 16;

__device__ __forceinline__ float load_a(const LinearParams& p, long long i) {
  float v = p.a_f32 ? static_cast<const float*>(p.a)[i]
                    : bf2f(static_cast<const bf16*>(p.a)[i]);
  if (p.a2) v += bf2f(p.a2[i]);
  return v;
}

// A (+ a2) at row offset `base`, columns c..c+3 (0 past K) as f32
__device__ __forceinline__ void load_a4(const LinearParams& p, long long base, int c, bool vec,
                                        float (&v)[4]) {
  if (vec && c + 4 <= p.K) {
    if (p.a_f32) {
      const float4 x = *reinterpret_cast<const float4*>(static_cast<const float*>(p.a) + base + c);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p.a) + base + c);
      unpack2(x.x, v[0], v[1]);
      unpack2(x.y, v[2], v[3]);
    }
    if (p.a2) {
      const uint2 x = *reinterpret_cast<const uint2*>(p.a2 + base + c);
      float t[4];
      unpack2(x.x, t[0], t[1]);
      unpack2(x.y, t[2], t[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += t[e];
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < p.K ? load_a(p, base + c + e) : 0.f;
}

// The block's A panel: rows m0..m0+BM of LN?(A [+ a2]) rounded to bf16,
// columns 0..KP (zero past K and past M), row stride LDP. One warp per row,
// 4-column chunks, 16-byte loads where aligned; the LayerNorm's statistics
// and normalisation are common.cuh's (ln_row_stats, ln_apply4), which
// layernorm_kernel calls too. For K <= 256 a lane holds its 8 values of
// PANEL_RG rows in registers, so the loads of those rows are in flight
// together and each is read once; deeper rows are read once per pass.
constexpr int PANEL_RG = 4;

__device__ __forceinline__ void panel_row_store(const LinearParams& p, bf16* dst, int c, int K,
                                                float mean, float rstd, float (&v)[4]) {
  if (p.ln_g) {
    float g[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g[e] = c + e < K ? p.ln_g[c + e] : 0.f;
      b[e] = c + e < K ? p.ln_b[c + e] : 0.f;
    }
    ln_apply4(v, c, K, mean, rstd, g, b);
  }
  *reinterpret_cast<uint2*>(dst + c) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

template <int BM, int NTH>
__device__ void build_panel(const LinearParams& p, int m0, int KP, int LDP, bf16* Ap) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int es = p.a_f32 ? 4 : 2;
  const unsigned long long al = reinterpret_cast<unsigned long long>(p.a) |
                                static_cast<unsigned long long>(p.lda * es) |
                                reinterpret_cast<unsigned long long>(p.a2);
  const bool vec = al % (4 * es) == 0;   // a2 (bf16 A only) is in `al` too
  const int K = static_cast<int>(p.K);
  const float invK = ln_inv(K);
  if (KP <= 256) {
    for (int r0 = warp * PANEL_RG; r0 < BM; r0 += (NTH / 32) * PANEL_RG) {
      float v[PANEL_RG][2][4];
#pragma unroll
      for (int g = 0; g < PANEL_RG; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r0 + g, c = 4 * lane + 128 * h;
          if (m < p.M && c < K) {
            load_a4(p, static_cast<long long>(m) * p.lda, c, vec, v[g][h]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[g][h][e] = 0.f;
          }
        }
#pragma unroll
      for (int g = 0; g < PANEL_RG; ++g) {
        float mean = 0.f, rstd = 1.f;
        if (p.ln_g) ln_row_stats<2>(v[g], lane, K, invK, p.ln_eps, mean, rstd);
        const bool live = m0 + r0 + g < p.M;
        bf16* dst = Ap + (r0 + g) * LDP;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 4 * lane + 128 * h;
          if (c >= KP) continue;
          if (live) {
            panel_row_store(p, dst, c, K, mean, rstd, v[g][h]);
          } else {
            *reinterpret_cast<uint2*>(dst + c) = make_uint2(0u, 0u);
          }
        }
      }
    }
    return;
  }
  for (int r = warp; r < BM; r += NTH / 32) {
    const int m = m0 + r;
    bf16* dst = Ap + r * LDP;
    if (m >= p.M) {
      for (int c = 4 * lane; c < KP; c += 128) *reinterpret_cast<uint2*>(dst + c) = make_uint2(0u, 0u);
      continue;
    }
    const long long base = static_cast<long long>(m) * p.lda;
    float mean = 0.f, rstd = 1.f;
    if (p.ln_g) {
      float t = 0.f;
      for (int c = 4 * lane; c < K; c += 128) {
        float v[4];
        load_a4(p, base, c, vec, v);
        t = __fadd_rn(t, ln_chunk_sum(v));
      }
      mean = ln_mean(t, invK);
      float q = 0.f;
      for (int c = 4 * lane; c < K; c += 128) {
        float v[4];
        load_a4(p, base, c, vec, v);
        q = ln_chunk_sq(q, v, c, K, mean);
      }
      rstd = ln_rstd(q, invK, p.ln_eps);
    }
    for (int c = 4 * lane; c < KP; c += 128) {
      float v[4];
      load_a4(p, base, c, vec, v);
      panel_row_store(p, dst, c, K, mean, rstd, v);
    }
  }
}

// The epilogue of 4 columns n..n+3 of row m (cnt of them inside N): bias,
// aux before the activation, GELU/ReLU, the dropout mask, aux after it,
// `res + dp * gamma * y`, the (column-group) store. vec_*: the 4-wide
// accesses are aligned (decided once per launch).
struct EpiVec {
  bool out, res, aux;
};

__device__ __forceinline__ void epilogue4(const LinearParams& p, int m, int n, int cnt,
                                          float (&y)[4], const EpiVec& vec) {
  const bool full = cnt == 4;
  if (p.bias) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] += e < cnt ? p.bias[n + e] : 0.f;
  }
  auto store_aux = [&]() {
    float* ar = p.aux + static_cast<long long>(m) * p.ldaux + n;
    if (vec.aux && full) {
      *reinterpret_cast<float4*>(ar) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      for (int e = 0; e < cnt; ++e) ar[e] = y[e];
    }
  };
  if (p.aux && p.aux_pre) store_aux();
  if (p.act == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = gelu_tanh(y[e]);
  } else if (p.act == 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = fmaxf(y[e], 0.f);
  }
  const int rps = static_cast<int>(p.rps);
  if (p.drop_site) {
    const unsigned key = head_key(*p.seed, p.drop_site, static_cast<unsigned>(m / rps), 0u);
    const unsigned row = static_cast<unsigned>(m % rps);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = keep_bit(key, row, static_cast<unsigned>(n + e), p.drop_thr) ? y[e] * p.drop_scale : 0.f;
    }
  }
  if (p.aux && !p.aux_pre) store_aux();
  if (p.res) {
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    const long long ro = static_cast<long long>(m) * p.ldr + n;
    if (vec.res && full) {
      if (p.res_f32) {
        const float4 x = *reinterpret_cast<const float4*>(static_cast<const float*>(p.res) + ro);
        r[0] = x.x;
        r[1] = x.y;
        r[2] = x.z;
        r[3] = x.w;
      } else {
        const uint2 x = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p.res) + ro);
        unpack2(x.x, r[0], r[1]);
        unpack2(x.y, r[2], r[3]);
      }
    } else {
      for (int e = 0; e < cnt; ++e) {
        r[e] = p.res_f32 ? static_cast<const float*>(p.res)[ro + e]
                         : bf2f(static_cast<const bf16*>(p.res)[ro + e]);
      }
    }
    float dp = 1.f;
    if (p.path_site) {
      dp = path_bit(*p.seed, p.path_site, static_cast<unsigned>(m / rps), p.path_thr)
               ? p.path_scale : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = r[e] + dp * (p.gamma && e < cnt ? p.gamma[n + e] : 1.f) * y[e];
    }
  }
  const long long orow = static_cast<long long>(m) * p.ldo;
  if (vec.out && full) {
    const long long oc = orow + (n / p.ogrp) * p.ogstride + n % p.ogrp;
    if (p.out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + oc) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      *reinterpret_cast<uint2*>(static_cast<bf16*>(p.out) + oc) =
          make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
    }
    return;
  }
  for (int e = 0; e < cnt; ++e) {
    const int ne = n + e;
    const long long oc = orow + (ne / p.ogrp) * p.ogstride + ne % p.ogrp;
    if (p.out_f32) {
      static_cast<float*>(p.out)[oc] = y[e];
    } else {
      static_cast<bf16*>(p.out)[oc] = f2bf(y[e]);
    }
  }
}

// the shared memory of an instantiation at panel row stride ldp: WHOLE:
// the A panel and two whole-K W tiles (the C half tiles reuse one); else
// the A panel (PANEL), then the ring of k tiles (A's too without a panel)
// and, reusing the ring, the f32 C tile of the epilogue
// W's whole-K tile buffer (bf16 elements): BN rows of ldp, or the f32 C
// half tile of the epilogue that reuses it, whichever is larger
template <int BM, int BN>
__host__ __device__ constexpr int whole_wbuf(int ldp) {
  return BN * ldp > BM / 2 * (BN + 8) * 2 ? BN * ldp : BM / 2 * (BN + 8) * 2;
}

template <int BM, int BN, int NTH, int MODE>
size_t linear_smem_bytes(int ldp) {
  if (MODE == WHOLE) return sizeof(bf16) * (BM * ldp + 2 * whole_wbuf<BM, BN>(ldp));
  constexpr bool PANEL = MODE == LinearMode::PANEL;
  const size_t ring = sizeof(bf16) * LSTAGES *
                      ((PANEL ? 0 : static_cast<size_t>(TileIO<BM, LBK, NTH>::ELEMS)) +
                       TileIO<BN, LBK, NTH>::ELEMS);
  const size_t ctile = sizeof(float) * BM * (BN + 8);
  return (PANEL ? sizeof(bf16) * BM * ldp : 0) + (ring > ctile ? ring : ctile);
}

// WHOLE: the block's A panel (bf16 by cp.async, or built through
// registers when transformed or misaligned) and, for each of its N tiles,
// W's BN x K tile in one of two buffers: the next tile's W is in flight
// while this one's products (all of K between two barriers) and epilogue
// run. The f32 C tile goes through the consumed W buffer in two halves.
template <int BM, int BN, int WM, int WN>
__device__ __forceinline__ void whole_k_body(const LinearParams& p, unsigned char* lsmem) {
  constexpr int NTH = WM * WN * 32;
  constexpr int MT = BM / WM / 16, NT8 = BN / WN / 8;
  constexpr int LDC = BN + 8;
  static_assert((BM / 2) % (BM / WM) == 0, "a warp's rows lie in one half");
  const int K = static_cast<int>(p.K), N = static_cast<int>(p.N);
  const int KP = (K + LBK - 1) / LBK * LBK;
  const int LDP = pad_ld(KP);
  const int WBUF = whole_wbuf<BM, BN>(LDP);
  bf16* Ap = reinterpret_cast<bf16*>(lsmem);
  bf16* Wb = Ap + BM * LDP;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  const int m0 = blockIdx.x * BM;
  const int ntiles = (N + BN - 1) / BN;
  const int T = (ntiles - static_cast<int>(blockIdx.y) + gridDim.y - 1) / gridDim.y;
  const int chunks = KP / 8;   // 16-byte chunks of a row
  const bool w_async = (reinterpret_cast<unsigned long long>(p.w) | (2ULL * K)) % 16 == 0;
  auto tile_n0 = [&](int j) { return (static_cast<int>(blockIdx.y) + j * gridDim.y) * BN; };
  // W's tile j (all of K, zero past N and K) into buffer j % 2, as one
  // cp.async group (empty past the last tile)
  auto load_w = [&](int j) {
    if (j < T) {
      const int n0 = tile_n0(j);
      bf16* dst = Wb + (j % 2) * WBUF;
      if (w_async) {
        for (int e = threadIdx.x; e < BN * chunks; e += NTH) {
          const int r = e / chunks, c = (e % chunks) * 8;
          const int valid = n0 + r < N ? max(0, min(8, K - c)) : 0;
          const bf16* src = valid ? p.w + static_cast<long long>(n0 + r) * K + c : p.w;
          cp_async<16>(smem_u32(dst + r * LDP + c), src, valid * 2);
        }
      } else {
        for (int e = threadIdx.x; e < BN * KP / 4; e += NTH) {
          const int r = e / (KP / 4), c = (e % (KP / 4)) * 4;
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[q] = n0 + r < N && c + q < K ? bf2f(p.w[static_cast<long long>(n0 + r) * K + c + q])
                                           : 0.f;
          }
          *reinterpret_cast<uint2*>(dst + r * LDP + c) =
              make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
        }
      }
    }
    cp_async_commit();
  };
  const bool a_async = !p.ln_g && !p.a2 && !p.a_f32 &&
                       (reinterpret_cast<unsigned long long>(p.a) | (2ULL * p.lda)) % 16 == 0;
  if (a_async) {   // in W's first group
    for (int e = threadIdx.x; e < BM * chunks; e += NTH) {
      const int r = e / chunks, c = (e % chunks) * 8;
      const int valid = m0 + r < p.M ? max(0, min(8, K - c)) : 0;
      const bf16* src = static_cast<const bf16*>(p.a);
      if (valid) src += static_cast<long long>(m0 + r) * p.lda + c;
      cp_async<16>(smem_u32(Ap + r * LDP + c), src, valid * 2);
    }
  }
  load_w(0);
  if (!a_async) build_panel<BM, NTH>(p, m0, KP, LDP, Ap);   // W's first tile in flight
  load_w(1);
  const EpiVec vec = {
      (p.ogrp >= N || (p.ogrp % 4 == 0 && p.ogstride % 4 == 0)) && p.ldo % 4 == 0 &&
          reinterpret_cast<unsigned long long>(p.out) % (p.out_f32 ? 16 : 8) == 0,
      p.res && p.ldr % 4 == 0 &&
          reinterpret_cast<unsigned long long>(p.res) % (p.res_f32 ? 16 : 8) == 0,
      p.aux && p.ldaux % 4 == 0 && reinterpret_cast<unsigned long long>(p.aux) % 16 == 0};

  for (int j = 0; j < T; ++j) {
    cp_async_wait<1>();   // W's tile j (and the panel) landed; j + 1 in flight
    __syncthreads();
    const bf16* wt = Wb + (j % 2) * WBUF;
    float acc[MT][NT8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KP; kk += 16) {
      unsigned af[MT][4], bfr[NT8][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldsm_x4(af[i], smem_u32(Ap + (wm0 + 16 * i + lane % 16) * LDP + kk + (lane / 16) * 8));
      }
#pragma unroll
      for (int jp = 0; jp < NT8 / 2; ++jp) {
        unsigned r[4];
        ldsm_x4(r, smem_u32(wt + (wn0 + 16 * jp + lane % 8 + (lane / 16) * 8) * LDP + kk +
                            ((lane / 8) % 2) * 8));
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT8; ++jn) mma_bf16(acc[i][jn], af[i], bfr[jn][0], bfr[jn][1]);
    }
    __syncthreads();   // W's buffer j % 2 is consumed: the C half tiles go there
    float* Cs = reinterpret_cast<float*>(Wb + (j % 2) * WBUF);
    const int n0 = tile_n0(j);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (wm0 / (BM / 2) == half) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jn = 0; jn < NT8; ++jn)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              *reinterpret_cast<float2*>(Cs + (wm0 - half * (BM / 2) + 16 * i + lane / 4 + 8 * hr) *
                                                  LDC + wn0 + 8 * jn + (lane % 4) * 2) =
                  make_float2(acc[i][jn][2 * hr], acc[i][jn][2 * hr + 1]);
            }
      }
      __syncthreads();
#pragma unroll 2
      for (int idx = threadIdx.x; idx < BM / 2 * BN / 4; idx += NTH) {
        const int r = idx / (BN / 4), c4 = (idx % (BN / 4)) * 4;
        const int m = m0 + half * (BM / 2) + r, n = n0 + c4;
        if (m >= p.M || n >= N) continue;
        const float4 v4 = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
        float y[4] = {v4.x, v4.y, v4.z, v4.w};
        epilogue4(p, m, n, min(4, N - n), y, vec);
      }
      __syncthreads();
    }
    load_w(j + 2);   // into the buffer just freed
  }
  cp_async_wait<0>();
}

// C tile BM x BN, WM x WN warps of (BM/WM) x (BN/WN) m16n8k16 products;
// block (x, y) owns rows x*BM.. and columns y*BN.. (WHOLE: the N tiles y,
// y + gridDim.y, ...). A's shared tile is [m][k] (the panel, or the ring),
// W's [n][k].
template <int BM, int BN, int WM, int WN, int MODE>
__global__ void __launch_bounds__(WM * WN * 32, LIN_MIN_WARPS / (WM * WN))
    linear_kernel(LinearParams p) {
  extern __shared__ __align__(16) unsigned char lsmem[];
  if constexpr (MODE == WHOLE) {
    whole_k_body<BM, BN, WM, WN>(p, lsmem);
    return;
  }
  constexpr bool PANEL = MODE == LinearMode::PANEL;
  constexpr int NTH = WM * WN * 32;
  constexpr int MT = BM / WM / 16, NT8 = BN / WN / 8;
  static_assert(MT >= 1 && NT8 % 2 == 0, "warp tile");
  using IOA = TileIO<BM, LBK, NTH>;
  using IOW = TileIO<BN, LBK, NTH>;
  const int K = static_cast<int>(p.K), N = static_cast<int>(p.N);
  const int KP = (K + LBK - 1) / LBK * LBK;
  const int LDP = pad_ld(KP);
  bf16* Ap = reinterpret_cast<bf16*>(lsmem);
  bf16* As = Ap + (PANEL ? BM * LDP : 0);                    // LSTAGES x IOA::ELEMS
  bf16* Ws = As + (PANEL ? 0 : LSTAGES * IOA::ELEMS);        // LSTAGES x IOW::ELEMS
  float* Cs = reinterpret_cast<float*>(As);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  const int m0 = blockIdx.x * BM;
  const Src a = make_src(p.a, 0, 0, p.lda, 1, p.M, K);   // without a panel: bf16
  const Src w = make_src(p.w, 0, 0, K, 1, N, K);
  const int nk = KP / LBK, n0 = blockIdx.y * BN;
  const int lda_s = PANEL ? LDP : IOA::LD;
  const bool a_reg = !PANEL && a.mode != 0;
  // the cp.async operands of k tile kt into its stage, as one group (empty
  // past the last tile)
  auto issue = [&](int kt) {
    if (kt < nk) {
      const int st = kt % LSTAGES;
      if (!PANEL && a.mode == 0) IOA::async(a, m0, kt * LBK, As + st * IOA::ELEMS);
      if (w.mode == 0) IOW::async(w, n0, kt * LBK, Ws + st * IOW::ELEMS);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < LSTAGES - 1; ++s) issue(s);
  if (PANEL) build_panel<BM, NTH>(p, m0, KP, LDP, Ap);   // W's first tiles in flight
  unsigned ra[IOA::UNITS][4], rw[IOW::UNITS][4];
  if (a_reg) {
    IOA::fetch(a, m0, 0, ra);
    IOA::store(0, ra, As);
  }
  if (w.mode != 0) {
    IOW::fetch(w, n0, 0, rw);
    IOW::store(0, rw, Ws);
  }
  const EpiVec vec = {
      (p.ogrp >= N || (p.ogrp % 4 == 0 && p.ogstride % 4 == 0)) && p.ldo % 4 == 0 &&
          reinterpret_cast<unsigned long long>(p.out) % (p.out_f32 ? 16 : 8) == 0,
      p.res && p.ldr % 4 == 0 &&
          reinterpret_cast<unsigned long long>(p.res) % (p.res_f32 ? 16 : 8) == 0,
      p.aux && p.ldaux % 4 == 0 && reinterpret_cast<unsigned long long>(p.aux) % 16 == 0};

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    issue(kt + LSTAGES - 1);
    // the register operands of the next tile, stored after this one's products
    if (more) {
      if (a_reg) IOA::fetch(a, m0, (kt + 1) * LBK, ra);
      if (w.mode != 0) IOW::fetch(w, n0, (kt + 1) * LBK, rw);
    }
    cp_async_wait<LSTAGES - 1>();   // this tile's group has landed
    __syncthreads();                // (and, at kt = 0, the panel is built)
    const bf16* at = PANEL ? Ap + kt * LBK : As + (kt % LSTAGES) * IOA::ELEMS;
    const bf16* wt = Ws + (kt % LSTAGES) * IOW::ELEMS;
#pragma unroll
    for (int kk = 0; kk < LBK; kk += 16) {
      unsigned af[MT][4], bfr[NT8][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldsm_x4(af[i], smem_u32(at + (wm0 + 16 * i + lane % 16) * lda_s + kk + (lane / 16) * 8));
      }
#pragma unroll
      for (int jp = 0; jp < NT8 / 2; ++jp) {
        unsigned r[4];
        ldsm_x4(r, smem_u32(wt + (wn0 + 16 * jp + lane % 8 + (lane / 16) * 8) * IOW::LD + kk +
                            ((lane / 8) % 2) * 8));
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT8; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    if (more) {
      const int st = (kt + 1) % LSTAGES;
      if (a_reg) IOA::store(0, ra, As + st * IOA::ELEMS);
      if (w.mode != 0) IOW::store(0, rw, Ws + st * IOW::ELEMS);
    }
    __syncthreads();
  }

  cp_async_wait<0>();

  // the accumulators through the shared f32 C tile (over the ring, whose
  // last group has landed), then rows of 4 columns per thread, coalesced
  // along n
  constexpr int LDC = BN + 8;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        *reinterpret_cast<float2*>(Cs + (wm0 + 16 * i + lane / 4 + 8 * hr) * LDC + wn0 + 8 * j +
                                   (lane % 4) * 2) =
            make_float2(acc[i][j][2 * hr], acc[i][j][2 * hr + 1]);
      }
  __syncthreads();
#pragma unroll 2
  for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NTH) {
    const int r = idx / (BN / 4), c4 = (idx % (BN / 4)) * 4;
    const int m = m0 + r, n = n0 + c4;
    if (m >= p.M || n >= N) continue;
    const float4 v4 = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
    float y[4] = {v4.x, v4.y, v4.z, v4.w};
    epilogue4(p, m, n, min(4, N - n), y, vec);
  }
}

template <int BM, int BN, int WM, int WN, int MODE>
int launch_linear(const LinearParams* p, cudaStream_t s) {
  constexpr int NTH = WM * WN * 32;
  const int KP = static_cast<int>((p->K + LBK - 1) / LBK * LBK);
  const size_t smem = linear_smem_bytes<BM, BN, NTH, MODE>(pad_ld(KP));
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static size_t sized = 0;   // the shared-memory limit, raised as needed
  if (smem > sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(linear_kernel<BM, BN, WM, WN, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = smem;
  }
  const long long gm = (p->M + BM - 1) / BM, nt = (p->N + BN - 1) / BN;
  // WHOLE: a block takes several N tiles, so the panel (and its LayerNorm)
  // is built once per block: as many blocks as fit on the card at two per
  // SM (one wave), or one per row block
  long long gy = nt;
  if (MODE == WHOLE) gy = std::min(nt, std::max(1LL, 2LL * sm_count() / gm));
  if (gy > 65535 || gm > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gm), static_cast<unsigned>(gy));
  linear_kernel<BM, BN, WM, WN, MODE><<<grid, NTH, smem, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile: a transformed A (LayerNorm, a2, f32 rows) goes through the
// panel: 128 x 64 (8 warps of 32 x 32) for K <= 256, 64 x 64 (4 warps)
// up to PANEL_KMAX. A plain bf16 A streams: 128 x 128 (8 warps of 64 x
// 32) where both dimensions exceed 64 and the grid fills every SM, else
// 64 x 64.
extern "C" int spe_linear(const LinearParams* p, void* stream) {
  if (p->M <= 0 || p->N <= 0 || p->K <= 0 || p->ogrp <= 0 || p->M > 2147483647LL ||
      p->N > 2147483647LL || p->K > 2147483647LL ||
      ((p->drop_site || p->path_site) && (!p->seed || p->rps <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->K <= WHOLE_KMAX) return launch_linear<128, 64, 4, 2, WHOLE>(p, s);
  if (p->ln_g || p->a2 || p->a_f32) {
    if (p->K <= PANEL_KMAX) return launch_linear<64, 64, 2, 2, PANEL>(p, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long large = ((p->M + 127) / 128) * ((p->N + 127) / 128);
  if (p->M > 64 && p->N > 64 && large >= sm_count()) {
    return launch_linear<128, 128, 2, 4, STREAM>(p, s);
  }
  return launch_linear<64, 64, 2, 2, STREAM>(p, s);
}

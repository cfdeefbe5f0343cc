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
// B*600 rows, N from 192 to 3072) the K = 192 products move more bytes
// than the tensor cores need time for (A in f32 or bf16, the output and
// the residual stream: ~100 flops per byte, under the card's ~295), the
// K = 768/2048/3072 ones (fc2, linear2, M48's layers) are compute bound.
// The design: wgmma.mma_async m64nNk16 (bf16 operands, f32 accumulators in
// registers) fed by the ring of wgmma.cuh (64-deep 128-byte-swizzled k
// tiles, a producer warpgroup's TMA loads completing on mbarriers, one or
// two consumer warpgroups), two ways through K:
// - PANEL (every LayerNorm, a2 and f32-A class, and any A with K <= 256):
//   the block's bf16 A panel (BM rows x K, zero to a multiple of 64) is
//   built once in shared memory, straight into the swizzled layout wgmma
//   reads: by TMA for a plain aligned bf16 A, else by the consumer
//   warpgroups through registers (16-byte loads, the row statistics from
//   the same loads, four rows of a warp in flight, the LayerNorm's weights
//   staged in shared memory), while the producer streams W's K-major k
//   tiles through the ring. A block walks several N tiles, the W ring
//   running on across them, so the LayerNorm is computed once per row
//   block; the N tiles are split over the blocks for the least makespan.
//   Tiles: for K <= 256, 64 x 64 (one consumer warpgroup, two blocks a SM)
//   for N <= 384 or M <= 1024, else 128 x 128 (two); deeper panels 64
//   rows, 128 columns up to K = 1024 (M48's qkv and fc1 at K = 768), 64
//   past it (up to PANEL_KMAX, the panel ~184 KB).
// - STREAM (a plain bf16 A with K > 256): the shared mainloop with A and W
//   k tiles both through the ring; 128 x 128 where the grid fills every
//   SM, else 64 x 64.
// Operands TMA cannot read (a misaligned A, W rows that are not 16-byte
// multiples) go through the producer warpgroup's registers into the same
// ring (route REG); the route and tile are chosen from the shapes and
// strides before the launch (kernels.linear_plan). The epilogue goes
// through a shared f32 C tile of its own (PANEL: the next tile's W loads
// run during it; STREAM: the producer warpgroup joins it), then rows of 4
// columns per thread: 16-byte (f32) or 8-byte (bf16) coalesced stores
// where the column-group store and the alignment allow. What bounds it
// now (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): the K = 192
// classes stay ~10x over their byte bound: one or two blocks a SM wait
// out the panel's loads and each tile's epilogue in turn (an epilogue
// giving each thread fixed columns with batched loads, and one shared
// with the producer's idle warps, both measured slower).

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
#include "wgmma.cuh"

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
  int tile;              // LinearTile (kernels.linear_plan)
  int route_a, route_w;  // wg::Route: TMA or REG (PANEL: TMA loads the panel)
};

namespace {

constexpr int PANEL_KMAX = 1472;  // the deepest A panel (64 rows, 184 KB)
constexpr int WHOLE_KMAX = 256;   // the deepest 128-row panel
// the tiles: (BM, BN, PANEL)
enum LinearTile { STREAM_128 = 0, STREAM_64 = 1, PANEL_128 = 2, PANEL_64_128 = 3, PANEL_64 = 4 };

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
// columns 0..KP (zero past K and past M), in the swizzled K-major layout
// wgmma reads (KP / 64 blocks of BM rows x 128 bytes, wg::swz), built by
// the NTH consumer threads. One warp per row, 4-column chunks, 16-byte
// loads where aligned; the LayerNorm's statistics and normalisation are
// common.cuh's (ln_row_stats, ln_apply4), which layernorm_kernel calls
// too. For K <= 256 a lane holds its 8 values of PANEL_RG rows in
// registers, so the loads of those rows are in flight together and each is
// read once; deeper rows are read once per pass.
constexpr int PANEL_RG = 4;

__device__ __forceinline__ void panel_store(unsigned char* Ap, int r, int c, int BM, uint2 v) {
  *reinterpret_cast<uint2*>(Ap + wg::swz(r, c, BM)) = v;
}

// the LayerNorm's weight and bias, staged in shared memory (lns: K
// weights, then K biases): read per row from device memory, their
// latency tripled the panel's build
__device__ __forceinline__ uint2 panel_row_values(const LinearParams& p, const float* lns, int c,
                                                  int K, float mean, float rstd, float (&v)[4]) {
  if (p.ln_g) {
    float g[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g[e] = c + e < K ? lns[c + e] : 0.f;
      b[e] = c + e < K ? lns[K + c + e] : 0.f;
    }
    ln_apply4(v, c, K, mean, rstd, g, b);
  }
  return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

template <int BM>
__device__ void build_panel(const LinearParams& p, int m0, int KP, unsigned char* Ap,
                            const float* lns, int tid, int nthreads) {
  const int lane = tid % 32, warp = tid / 32, warps = nthreads / 32;
  const int es = p.a_f32 ? 4 : 2;
  const unsigned long long al = reinterpret_cast<unsigned long long>(p.a) |
                                static_cast<unsigned long long>(p.lda * es) |
                                reinterpret_cast<unsigned long long>(p.a2);
  const bool vec = al % (4 * es) == 0;   // a2 (bf16 A only) is in `al` too
  const int K = static_cast<int>(p.K);
  const float invK = ln_inv(K);
  if (KP <= 256) {
    for (int r0 = warp * PANEL_RG; r0 < BM; r0 += warps * PANEL_RG) {
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
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 4 * lane + 128 * h;
          if (c >= KP) continue;
          panel_store(Ap, r0 + g, c, BM,
                      live ? panel_row_values(p, lns, c, K, mean, rstd, v[g][h]) : make_uint2(0u, 0u));
        }
      }
    }
    return;
  }
  for (int r = warp; r < BM; r += warps) {
    const int m = m0 + r;
    if (m >= p.M) {
      for (int c = 4 * lane; c < KP; c += 128) panel_store(Ap, r, c, BM, make_uint2(0u, 0u));
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
      panel_store(Ap, r, c, BM, panel_row_values(p, lns, c, K, mean, rstd, v));
    }
  }
}

// the epilogue's 4-wide accesses are aligned and the store has no column
// groups (decided once per launch)
struct EpiVec {
  bool out, res, aux, flat;
};

// The residual's 4 columns n..n+3 of row m (cnt of them inside N)
__device__ __forceinline__ void load_res4(const LinearParams& p, int m, int n, int cnt,
                                          const EpiVec& vec, float (&r)[4]) {
  r[0] = r[1] = r[2] = r[3] = 0.f;
  if (!p.res) return;
  const long long ro = static_cast<long long>(m) * p.ldr + n;
  if (vec.res && cnt == 4) {
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
    return;
  }
  for (int e = 0; e < cnt; ++e) {
    r[e] = p.res_f32 ? static_cast<const float*>(p.res)[ro + e]
                     : bf2f(static_cast<const bf16*>(p.res)[ro + e]);
  }
}


// The epilogue of 4 columns n..n+3 of row m (cnt of them inside N): bias,
// aux before the activation, GELU/ReLU, the dropout mask, aux after it,
// `res + dp * gamma * y`, the (column-group) store.
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
    float r[4];
    load_res4(p, m, n, cnt, vec, r);
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
    const long long oc = orow + (vec.flat ? n : (n / p.ogrp) * p.ogstride + n % p.ogrp);
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

// The epilogue of one C tile (rows m0.., columns n0..) from the shared f32
// C tile, by thread tid of NT: rows of 4 columns per thread, coalesced
// along n.
template <int BM, int BN>
__device__ __forceinline__ void linear_epilogue(const LinearParams& p, const float* Cs, int m0,
                                                int n0, const EpiVec& vec, int tid, int NT) {
  constexpr int LDC = BN + 8;
  const int N = static_cast<int>(p.N);
#pragma unroll 2
  for (int idx = tid; idx < BM * BN / 4; idx += NT) {
    const int r = idx / (BN / 4), c4 = (idx % (BN / 4)) * 4;
    const int m = m0 + r, n = n0 + c4;
    if (m >= p.M || n >= N) continue;
    const float4 v4 = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
    float y[4] = {v4.x, v4.y, v4.z, v4.w};
    epilogue4(p, m, n, min(4, N - n), y, vec);
  }
}

// the LayerNorm's weight and bias into shared memory (the C tile, free
// until the first tile's products), by thread tid of nthreads
__device__ __forceinline__ void stage_ln(const LinearParams& p, float* lns, int tid, int nthreads) {
  if (!p.ln_g) return;
  const int K = static_cast<int>(p.K);
  for (int i = tid; i < K; i += nthreads) {
    lns[i] = __ldg(p.ln_g + i);
    lns[K + i] = __ldg(p.ln_b + i);
  }
}

// A launch: the parameters, the tensor maps of A (PANEL: the panel's
// boxes; STREAM: the ring's) and W, and the shared memory's layout (bytes
// from its 1024-aligned start): the panel, the f32 C tile, the ring (a
// stage: A's k tile (STREAM), then W's), the barriers.
struct LinearLaunch {
  CUtensorMap ma, mw;
  LinearParams p;
  int stages;
  unsigned ctile_off, ring_off, stage_bytes, off_w, bar_off;
};

// C tile BM x BN: BM / 64 consumer warpgroups of m64nBN products and one
// producer warpgroup. PANEL: block (x, y) owns rows x*BM.. and the N tiles
// y, y + gridDim.y, ...; STREAM: columns x*BN.., rows y*BM...
template <int BM, int BN, bool PANEL>
__global__ void __launch_bounds__((BM / 64 + 1) * 128, BM == 128 ? 1 : 2)
    linear_kernel(const __grid_constant__ LinearLaunch L) {
  constexpr int NWG = BM / 64, NTHC = NWG * 128;
  constexpr int LDC = BN + 8;
  const LinearParams& p = L.p;
  extern __shared__ unsigned char lsmem_raw[];
  unsigned char* sm = wg::align1024(lsmem_raw);
  const uint32_t base = smem_u32(sm);
  const wg::Ring g = {base + L.ring_off, L.stage_bytes, base + L.bar_off, L.stages};
  const uint32_t pbar = base + L.bar_off + 16 * L.stages;   // the panel's TMA loads
  const int K = static_cast<int>(p.K), N = static_cast<int>(p.N);
  const int nk = (K + wg::BK - 1) / wg::BK;
  // PANEL: x the row block, y the first N tile; STREAM: x the N tile, y
  // the row block (the N tiles of a row block run side by side)
  const int m0 = (PANEL ? blockIdx.x : blockIdx.y) * BM;
  const int nb = PANEL ? blockIdx.y : blockIdx.x, ng = PANEL ? gridDim.y : 1;
  const int ntiles = (N + BN - 1) / BN;
  const int T = PANEL ? (ntiles - nb + ng - 1) / ng : 1;
  auto tile_n0 = [&](int i) { return (nb + i * ng) * BN; };
  if (threadIdx.x == 0) {
    wg::ring_init(g, p.route_w != wg::TMA || (!PANEL && p.route_a != wg::TMA), 4 * NWG);
    if (PANEL) wg::mbar_init(pbar, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();

  const EpiVec vec = {
      (p.ogrp >= N || (p.ogrp % 4 == 0 && p.ogstride % 4 == 0)) && p.ldo % 4 == 0 &&
          reinterpret_cast<unsigned long long>(p.out) % (p.out_f32 ? 16 : 8) == 0,
      p.res && p.ldr % 4 == 0 &&
          reinterpret_cast<unsigned long long>(p.res) % (p.res_f32 ? 16 : 8) == 0,
      p.aux && p.ldaux % 4 == 0 && reinterpret_cast<unsigned long long>(p.aux) % 16 == 0,
      p.ogrp >= N};
  float* Cs = reinterpret_cast<float*>(sm + L.ctile_off);
  // the threads of the panel's build and of the epilogue (named barrier
  // 2): the consumers and, for STREAM's one tile, the producer warpgroup
  // once it has issued every load
  const int P = NTHC + (PANEL ? 0 : 128);
  const bool build = PANEL && p.route_a != wg::TMA;

  if (wg::warpgroup() == NWG) {
    const int t = threadIdx.x - NTHC;
    if (PANEL && p.route_a == wg::TMA && t == 0) {
      wg::mbar_expect_tx(pbar, nk * BM * 128);
      for (int q = 0; q < nk; ++q) wg::tma_load(base + q * BM * 128, &L.ma, pbar, q * wg::BK, m0, 0, 0);
    }
    wg::RingOperand a, w;
    a.map = &L.ma;
    a.route = p.route_a;
    a.km = true;
    a.R = BM;
    a.C = wg::BK;
    a.off = 0;
    a.soff = 0;
    a.src = make_src(p.a, 0, 0, p.lda, 1, p.M, K);   // STREAM: a plain bf16 A
    a.sr0 = m0;
    a.sc0 = 0;
    a.mn0 = m0;
    w.map = &L.mw;
    w.route = p.route_w;
    w.km = true;
    w.R = BN;
    w.C = wg::BK;
    w.off = L.off_w;
    w.soff = 0;
    w.src = make_src(p.w, 0, 0, K, 1, N, K);
    w.sc0 = 0;
    a.z2 = a.z1 = w.z2 = w.z1 = 0;
    a.kbase = w.kbase = 0;
    wg::produce<BM * wg::BK, BN * wg::BK>(
        g, a, w, !PANEL, t, sm + L.ring_off,
        [&](int i, wg::RingOperand&, wg::RingOperand& wo, int& kt) {
          wo.mn0 = tile_n0(i / nk);
          wo.sr0 = wo.mn0;
          kt = i % nk;
          return i < T * nk;
        });
    if (!PANEL) {   // STREAM: the producer warpgroup joins the tile's epilogue
      wg::named_sync(2, P);
      linear_epilogue<BM, BN>(p, Cs, m0, tile_n0(0), vec, threadIdx.x, P);
      wg::named_sync(2, P);
    }
    return;
  }
  if (PANEL) {
    if (build) {
      stage_ln(p, Cs, threadIdx.x, P);
      wg::named_sync(2, P);
      build_panel<BM>(p, m0, nk * wg::BK, sm, Cs, threadIdx.x, P);
      wg::fence_proxy_async();
      wg::named_sync(2, P);
    } else {
      wg::mbar_wait(pbar, 0);
    }
  }
  const uint32_t arow = wg::warpgroup() * wg::BK * 128;   // the warpgroup's 64 rows
  float acc[BN / 2];   // set by each tile's first k tile (nk >= 1)
  for (int i = 0; i < T; ++i) {
    for (int kt = 0; kt < nk; ++kt) {
      const int t = i * nk + kt;
      wg::mbar_wait(g.full(t), g.parity(t));
      const uint32_t ta = (PANEL ? base + kt * BM * 128 : g.stage(t)) + arow;
      wg::mma_tile<BN, true, true>(acc, ta, g.stage(t) + L.off_w, kt == 0);
      wg::wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 32 == 0) wg::mbar_arrive(g.empty(t - 1));
    }
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(g.empty(i * nk + nk - 1));
    wg::acc_to_tile<BN>(acc, Cs, LDC, 1.f);
    wg::named_sync(2, P);   // the C tile is written
    linear_epilogue<BM, BN>(p, Cs, m0, tile_n0(i), vec, threadIdx.x, P);
    wg::named_sync(2, P);   // and read: the next tile's may go there
  }
}

template <int BM, int BN, bool PANEL>
int launch_linear(const LinearParams* p, cudaStream_t s) {
  LinearLaunch L;
  L.p = *p;
  const long long K = p->K;
  const long long nk = (K + wg::BK - 1) / wg::BK;
  const bool plain = !p->ln_g && !p->a2 && !p->a_f32;
  // the routes: TMA for A only where it is read as it is (a plain bf16 A),
  // and wherever TMA's alignment rule holds
  if (p->route_a == wg::TMA) {
    const long long dims[4] = {K, p->M, 1, 1};
    long long strides[3] = {p->lda * 2, 0, 0};
    if (!plain || !wg_host::encode(&L.ma, p->a, 2, dims, strides, wg::BK, BM)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (p->route_a != wg::REG || (!PANEL && !plain)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p->route_w == wg::TMA) {
    const long long dims[4] = {K, p->N, 1, 1};
    long long strides[3] = {K * 2, 0, 0};
    if (!wg_host::encode(&L.mw, p->w, 2, dims, strides, wg::BK, BN)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (p->route_w != wg::REG) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the panel, the C tile, then as many stages of the ring as fit
  const unsigned panel = PANEL ? static_cast<unsigned>(nk) * BM * 128 : 0;
  const unsigned ctile = (BM * (BN + 8) * 4 + 1023) / 1024 * 1024;
  L.ctile_off = panel;
  L.ring_off = panel + ctile;
  L.off_w = PANEL ? 0 : BM * 128;
  L.stage_bytes = L.off_w + BN * 128;
  L.stages = wg::ring_stages(L.stage_bytes, 0, L.ring_off, PANEL ? wg::MAX_STAGES : nk, BM == 64);
  L.bar_off = L.ring_off + L.stages * L.stage_bytes;
  const size_t smem = 1024 + L.bar_off + 16 * L.stages + 8;
  if (smem > static_cast<size_t>(wg::SMEM_MAX)) return static_cast<int>(cudaErrorInvalidValue);
  static size_t sized = 0;   // the shared-memory limit, raised as needed
  if (smem > sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(linear_kernel<BM, BN, PANEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = smem;
  }
  const long long gm = (p->M + BM - 1) / BM, nt = (p->N + BN - 1) / BN;
  // PANEL: a block takes several N tiles, so the panel (and its LayerNorm)
  // is built once per block
  dim3 grid;
  if (PANEL) {
    // the N tiles split gy ways: the gy with the least makespan, waves of
    // blocks times the tiles a block takes (plus about one and a half tiles
    // for its panel), over the blocks the card holds at once
    const long long slots =
        (smem * 2 + 2048 <= static_cast<size_t>(wg::SMEM_PER_SM) && BM == 64 ? 2 : 1) * sm_count();
    long long gy = 1, best = -1;
    for (long long y = 1; y <= std::min(nt, 65535LL); ++y) {
      const long long cost = (gm * y + slots - 1) / slots * (2 * ((nt + y - 1) / y) + 3);
      if (best < 0 || cost < best) {
        best = cost;
        gy = y;
      }
    }
    if (gm > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(static_cast<unsigned>(gm), static_cast<unsigned>(gy));
  } else {
    if (gm > 65535 || nt > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(static_cast<unsigned>(nt), static_cast<unsigned>(gm));
  }
  linear_kernel<BM, BN, PANEL><<<grid, (BM / 64 + 1) * 128, smem, s>>>(L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile and the routes come from the caller's plan (kernels.linear_plan):
// a transformed A (LayerNorm, a2, f32 rows) or any K <= 256 through the
// panel (128 x 128 for K <= 256, 64 x 128 up to K = 1024, 64 x 64 up to
// PANEL_KMAX), a plain bf16 A past K = 256 through the stream (128 x 128
// where the grid fills every SM, else 64 x 64).
extern "C" int spe_linear(const LinearParams* p, void* stream) {
  if (p->M <= 0 || p->N <= 0 || p->K <= 0 || p->ogrp <= 0 || p->M > 2147483647LL ||
      p->N > 2147483647LL || p->K > 2147483647LL ||
      ((p->drop_site || p->path_site) && (!p->seed || p->rps <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool plain = !p->ln_g && !p->a2 && !p->a_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->tile) {
    case STREAM_128:
      if (plain) return launch_linear<128, 128, false>(p, s);
      break;
    case STREAM_64:
      if (plain) return launch_linear<64, 64, false>(p, s);
      break;
    case PANEL_128:
      if (p->K <= WHOLE_KMAX) return launch_linear<128, 128, true>(p, s);
      break;
    case PANEL_64_128:
      if (p->K <= PANEL_KMAX) return launch_linear<64, 128, true>(p, s);
      break;
    case PANEL_64:
      if (p->K <= PANEL_KMAX) return launch_linear<64, 64, true>(p, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

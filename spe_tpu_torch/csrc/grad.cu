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
// What bounds it on the H100: gemm_kernel, the product under every backward
// (rows 1b-4b, 7b and 9 of PERF.md, and B5's logit planes). Its largest
// calls are write- or read-bound (f32 (B, H, N, N) planes of the logits and
// of dY . V^T written, bf16 planes of zd and dl read, f32 dY read); the
// rest are products of 10^8-10^10 multiply-adds. The design:
// - mma.sync.m16n8k16 on bf16 operands with f32 accumulators; operands
//   rounded to bf16 at the load, as the TPU kernels round them
//   (`.astype(in_dt)` before each dot).
// - bf16 shared tiles 32 deep in a 2-stage ring. Each operand's tile keeps
//   its global unit-stride index contiguous: a bf16 operand with 16-byte
//   rows goes in by cp.async; an f32 operand, a misaligned one or one
//   without a unit stride by vector (or scalar) loads to registers,
//   rounded at the shared store, fetched one k tile ahead. A transposed
//   operand is read by ldmatrix.trans.
// - Two tiles, chosen in spe_gemm from M, N and the batch: 128 x 128 (8
//   warps of 64 x 32) where its grid fills every SM, 64 x 64 (4 warps of 32
//   x 32) for the per-head products 24 or 48 wide or deep and for small
//   grids; K is zero-padded to the tile's depth.
// - The epilogue (alpha, dropout, GELU'/ReLU, column groups, accumulate)
//   per accumulator element with the (m, n) semantics of before; no float
//   atomics, so two backwards give the same bits.
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

constexpr int NT = 256;
constexpr int LN_ROWS = 32;    // rows per block of the LayerNorm/branch backward

__device__ __forceinline__ float ld_any(const void* p, long long i, int f32) {
  return f32 ? static_cast<const float*>(p)[i] : bf2f(static_cast<const bf16*>(p)[i]);
}

// ---- gemm_kernel: the tensor-core batched product ----
constexpr int GBK = 32;        // depth of a k tile
// resident warps per SM the register budget is cut for (8 warps of 64 x 32
// or 4 of 32 x 32 per block: 2 or 4 blocks; a few spilled registers cost
// less than the occupancy they buy)
constexpr int GEMM_MIN_WARPS = 16;

constexpr int GSTAGES = 4;     // the shared ring: cp.async runs 3 k tiles ahead

// the dynamic shared memory of a gemm_kernel instantiation: the ring of
// k tiles, then (reusing it) the f32 C tile of the epilogue, rows padded
// by 8 against bank conflicts
template <int BM, int BN, bool A_KM, bool B_KM, int NTH>
constexpr size_t gemm_smem_bytes() {
  const size_t ring = sizeof(bf16) * GSTAGES *
                      (static_cast<size_t>(TileIO<A_KM ? BM : GBK, A_KM ? GBK : BM, NTH>::ELEMS) +
                       TileIO<B_KM ? BN : GBK, B_KM ? GBK : BN, NTH>::ELEMS);
  const size_t ctile = sizeof(float) * BM * (BN + 8);
  return ring > ctile ? ring : ctile;
}

// the epilogue of one element (alpha applied): the dropout mask keyed
// (sample, 0, row, n), then the activation derivative (act 1: GELU' of u,
// 2: the ReLU mask of u)
__device__ __forceinline__ float epilogue_value(float y, int drop_site, unsigned key, unsigned row,
                                             unsigned n, unsigned thr, float scale, int act,
                                             float u) {
  if (drop_site) y = keep_bit(key, row, n, thr) ? y * scale : 0.f;
  if (act == 1) y *= gelu_tanh_grad(u);
  if (act == 2) y = u > 0.f ? y : 0.f;
  return y;
}

// C tile BM x BN per block of WM x WN warps; each warp a (BM/WM) x (BN/WN)
// tile of m16n8k16 products. A_KM: A's shared tile is [m][k] (k
// contiguous), else [k][m] (read through ldmatrix.trans); B_KM: B's is
// [n][k], else [k][n] (ldmatrix.trans).
template <int BM, int BN, int WM, int WN, bool A_KM, bool B_KM>
__global__ void __launch_bounds__(WM * WN * 32, GEMM_MIN_WARPS / (WM * WN))
    gemm_kernel(GemmParams p) {
  constexpr int NTH = WM * WN * 32;
  constexpr int MT = BM / WM / 16, NT8 = BN / WN / 8;
  static_assert(MT >= 1 && NT8 % 2 == 0, "warp tile");
  using IOA = TileIO<A_KM ? BM : GBK, A_KM ? GBK : BM, NTH>;
  using IOB = TileIO<B_KM ? BN : GBK, B_KM ? GBK : BN, NTH>;
  extern __shared__ __align__(16) unsigned char gsmem[];
  bf16* As = reinterpret_cast<bf16*>(gsmem);          // GSTAGES x IOA::ELEMS
  bf16* Bs = As + GSTAGES * IOA::ELEMS;                // GSTAGES x IOB::ELEMS

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  const int z = blockIdx.z;
  const int z1 = z / p.nb2, z2 = z % p.nb2;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const long long n0 = static_cast<long long>(blockIdx.y) * BN;
  long long K = p.K;
  if (p.split) K = min(static_cast<long long>(p.K), p.kmax - static_cast<long long>(z1) * p.K);
  const long long aoff = z1 * p.a_s1 + z2 * p.a_s2;
  const long long boff = z1 * p.b_s1 + z2 * p.b_s2;
  const Src a = A_KM ? make_src(p.a, p.a_f32, aoff, p.a_sm, p.a_sk, p.M, K)
                     : make_src(p.a, p.a_f32, aoff, p.a_sk, p.a_sm, K, p.M);
  const Src b = B_KM ? make_src(p.b, p.b_f32, boff, p.b_sn, p.b_sk, p.N, K)
                     : make_src(p.b, p.b_f32, boff, p.b_sk, p.b_sn, K, p.N);

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  unsigned ra[IOA::UNITS][4], rb[IOB::UNITS][4];
  // the origins of a k tile in each operand's (row, contiguous) indices
  auto a_r0 = [&](long long k0) { return A_KM ? m0 : k0; };
  auto a_c0 = [&](long long k0) { return A_KM ? k0 : m0; };
  auto b_r0 = [&](long long k0) { return B_KM ? n0 : k0; };
  auto b_c0 = [&](long long k0) { return B_KM ? k0 : n0; };
  // the cp.async operands of k tile kt into its stage, as one group (empty
  // past the last tile)
  auto issue = [&](int kt, int nk) {
    if (kt < nk) {
      const long long k0 = static_cast<long long>(kt) * GBK;
      const int st = kt % GSTAGES;
      if (a.mode == 0) IOA::async(a, a_r0(k0), a_c0(k0), As + st * IOA::ELEMS);
      if (b.mode == 0) IOB::async(b, b_r0(k0), b_c0(k0), Bs + st * IOB::ELEMS);
    }
    cp_async_commit();
  };

  const int nk = static_cast<int>((K + GBK - 1) / GBK);
#pragma unroll
  for (int kt = 0; kt < GSTAGES - 1; ++kt) issue(kt, nk);
  if (a.mode != 0) {
    IOA::fetch(a, a_r0(0), a_c0(0), ra);
    IOA::store(a.f32, ra, As);
  }
  if (b.mode != 0) {
    IOB::fetch(b, b_r0(0), b_c0(0), rb);
    IOB::store(b.f32, rb, Bs);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    issue(kt + GSTAGES - 1, nk);
    // the register operands of the next tile, stored after this one's products
    if (more) {
      const long long k1 = static_cast<long long>(kt + 1) * GBK;
      if (a.mode != 0) IOA::fetch(a, a_r0(k1), a_c0(k1), ra);
      if (b.mode != 0) IOB::fetch(b, b_r0(k1), b_c0(k1), rb);
    }
    cp_async_wait<GSTAGES - 1>();   // this tile's group has landed
    __syncthreads();
    const bf16* at = As + (kt % GSTAGES) * IOA::ELEMS;
    const bf16* bt = Bs + (kt % GSTAGES) * IOB::ELEMS;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      unsigned af[MT][4], bfr[NT8][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mrow = wm0 + 16 * i;
        if (A_KM) {
          ldsm_x4(af[i], smem_u32(at + (mrow + lane % 16) * IOA::LD + kk + (lane / 16) * 8));
        } else {
          ldsm_x4_t(af[i], smem_u32(at + (kk + lane % 8 + (lane / 16) * 8) * IOA::LD +
                                    mrow + ((lane / 8) % 2) * 8));
        }
      }
#pragma unroll
      for (int jp = 0; jp < NT8 / 2; ++jp) {
        const int ncol = wn0 + 16 * jp;
        unsigned r[4];
        if (B_KM) {
          ldsm_x4(r, smem_u32(bt + (ncol + lane % 8 + (lane / 16) * 8) * IOB::LD + kk +
                              ((lane / 8) % 2) * 8));
        } else {
          ldsm_x4_t(r, smem_u32(bt + (kk + lane % 8 + ((lane / 8) % 2) * 8) * IOB::LD +
                                ncol + (lane / 16) * 8));
        }
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
      const int st = (kt + 1) % GSTAGES;
      if (a.mode != 0) IOA::store(a.f32, ra, As + st * IOA::ELEMS);
      if (b.mode != 0) IOB::store(b.f32, rb, Bs + st * IOB::ELEMS);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // epilogue: the accumulators (times alpha) through a shared f32 C tile,
  // then rows of 4 columns per thread, coalesced along n: the dropout mask,
  // the activation derivative, the column-group store, accumulate
  constexpr int LDC = BN + 8;
  float* Cs = reinterpret_cast<float*>(gsmem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float2 v = make_float2(p.alpha * acc[i][j][2 * hr], p.alpha * acc[i][j][2 * hr + 1]);
        *reinterpret_cast<float2*>(Cs + (wm0 + 16 * i + lane / 4 + 8 * hr) * LDC + wn0 + 8 * j +
                                   (lane % 4) * 2) = v;
      }
  __syncthreads();
  const long long coff = z1 * p.c_s1 + z2 * p.c_s2;
  const int act = p.act_aux ? p.act_grad : 0;
  const int rps = static_cast<int>(p.rps);
  const bool grouped = p.cgrp < p.N;
  const int vec = p.c_f32 ? 16 : 8;   // bytes of 4 values
  const bool vec_ok = p.c_sn == 1 && reinterpret_cast<unsigned long long>(p.c) % vec == 0 &&
                      (p.c_sm * (p.c_f32 ? 4 : 2)) % vec == 0 &&
                      (coff * (p.c_f32 ? 4 : 2)) % vec == 0 && !grouped;
  // the activation's aux rows as float4 where aligned
  const bool aux4 = act && p.ld_aux % 4 == 0 &&
                    reinterpret_cast<unsigned long long>(p.act_aux) % 16 == 0;
  // unrolled so that the loads of several iterations are in flight together
#pragma unroll 4
  for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NTH) {
    const int r = idx / (BN / 4), c4 = (idx % (BN / 4)) * 4;
    const long long m = m0 + r;
    const int n = static_cast<int>(n0) + c4;
    if (m >= p.M || n >= p.N) continue;
    const float4 v4 = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
    float y[4] = {v4.x, v4.y, v4.z, v4.w};
    if (p.drop_site || act) {
      const int mi = static_cast<int>(m);
      const unsigned key =
          p.drop_site ? head_key(*p.seed, p.drop_site, static_cast<unsigned>(mi / rps), 0u) : 0u;
      const unsigned row = p.drop_site ? static_cast<unsigned>(mi % rps) : 0u;
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      if (act) {
        const float* ar = p.act_aux + m * p.ld_aux + n;
        if (aux4 && n + 4 <= p.N) {
          const float4 a4 = *reinterpret_cast<const float4*>(ar);
          u[0] = a4.x;
          u[1] = a4.y;
          u[2] = a4.z;
          u[3] = a4.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) u[e] = n + e < p.N ? ar[e] : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n + e < p.N) {
          y[e] = epilogue_value(y[e], p.drop_site, key, row, static_cast<unsigned>(n + e),
                                p.drop_thr, p.drop_scale, act, u[e]);
        }
      }
    }
    const long long roff = coff + m * p.c_sm;
    if (vec_ok && n + 4 <= p.N) {
      if (p.c_f32) {
        float4* c = reinterpret_cast<float4*>(static_cast<float*>(p.c) + roff + n);
        float4 o = make_float4(y[0], y[1], y[2], y[3]);
        if (p.accumulate) {
          const float4 w = *c;
          o.x += w.x;
          o.y += w.y;
          o.z += w.z;
          o.w += w.w;
        }
        *c = o;
      } else {
        uint2* c = reinterpret_cast<uint2*>(static_cast<bf16*>(p.c) + roff + n);
        if (p.accumulate) {
          const uint2 w = *c;
          const __nv_bfloat162 w0 = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
          const __nv_bfloat162 w1 = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
          y[0] += bf2f(w0.x);
          y[1] += bf2f(w0.y);
          y[2] += bf2f(w1.x);
          y[3] += bf2f(w1.y);
        }
        *c = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
      }
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ne = n + e;
      if (ne >= p.N) break;
      const long long o = roff + (grouped ? static_cast<long long>(ne / p.cgrp) * p.cgstride +
                                                static_cast<long long>(ne % p.cgrp) * p.c_sn
                                          : ne * p.c_sn);
      if (p.c_f32) {
        float* c = static_cast<float*>(p.c);
        c[o] = p.accumulate ? c[o] + y[e] : y[e];
      } else {
        bf16* c = static_cast<bf16*>(p.c);
        c[o] = f2bf(p.accumulate ? bf2f(c[o]) + y[e] : y[e]);
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

namespace {

template <int BM, int BN, int WM, int WN, bool A_KM, bool B_KM>
int launch_layout(const GemmParams* p, dim3 grid, cudaStream_t s) {
  constexpr int nth = WM * WN * 32;
  constexpr size_t smem = gemm_smem_bytes<BM, BN, A_KM, B_KM, nth>();
  static bool sized = false;   // the shared-memory limit, raised once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<BM, BN, WM, WN, A_KM, B_KM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  gemm_kernel<BM, BN, WM, WN, A_KM, B_KM><<<grid, nth, smem, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int WM, int WN>
int launch_gemm(const GemmParams* p, bool a_km, bool b_km, cudaStream_t s) {
  const long long gm = (p->M + BM - 1) / BM, gn = (p->N + BN - 1) / BN;
  const long long gz = static_cast<long long>(p->nb1) * p->nb2;
  if (gn > 65535 || gz > 65535 || gm > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gm), static_cast<unsigned>(gn), static_cast<unsigned>(gz));
  if (a_km && b_km) return launch_layout<BM, BN, WM, WN, true, true>(p, grid, s);
  if (a_km) return launch_layout<BM, BN, WM, WN, true, false>(p, grid, s);
  if (b_km) return launch_layout<BM, BN, WM, WN, false, true>(p, grid, s);
  return launch_layout<BM, BN, WM, WN, false, false>(p, grid, s);
}

}  // namespace

// The tile: large (128 x 128, 8 warps of 64 x 32) where both output
// dimensions exceed 64 and its grid fills every SM at least once; narrow
// (64 x 64, 4 warps of 32 x 32) otherwise: the per-head products whose
// width or depth is a head (24 or 48) and the products too small to fill
// the card with large tiles. Each operand's shared tile keeps its global
// contiguous index contiguous (k for A = [m][k] unless A is m-contiguous;
// k for B = [n][k] unless B is n-contiguous).
extern "C" int spe_gemm(const GemmParams* p, void* stream) {
  if (p->M <= 0 || p->N <= 0 || p->K <= 0 || p->nb1 <= 0 || p->nb2 <= 0 || p->cgrp <= 0 ||
      (p->drop_site && (!p->seed || p->rps <= 0)) ||
      (p->act_aux && p->act_grad != 1 && p->act_grad != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool a_km = !(p->a_sm == 1 && p->a_sk != 1);
  const bool b_km = p->b_sn != 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long large = ((p->M + 127) / 128) * ((p->N + 127) / 128) *
                          static_cast<long long>(p->nb1) * p->nb2;
  if (p->M > 64 && p->N > 64 && large >= sm_count()) {
    return launch_gemm<128, 128, 2, 4>(p, a_km, b_km, s);
  }
  return launch_gemm<64, 64, 2, 2>(p, a_km, b_km, s);
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

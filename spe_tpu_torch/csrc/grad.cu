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
//                      pass of the weight gradients, dW = dY^T X over row
//                      chunks: no float atomics, so two runs give the same
//                      bits; reduce_thread_kernel, one thread an output, at
//                      ~83% of its byte bound there);
//   spe_colsum_f32     column sums of f32 rows (bias gradients), one launch;
//   spe_ln_backward    LayerNorm backward of whole rows plus a residual,
//                      dgamma/dbeta summed in the same launch;
//   spe_branch_backward  the LayerScale/DropPath/dropout branch
//                      `x + dp * gamma * drop(y)`: d(y), dgamma summed in
//                      the same launch (without val: the elementwise pass
//                      alone, the dropout mask's gradient);
//   spe_dropout_mask   the counter masks themselves (common.cuh), for
//                      holding them against the torch version bit for bit.
//
// Replaces the backward products and reductions inside the TPU kernels
// spe_tpu/ops/pallas_block.py:225 _block_bwd_kernel,
// spe_tpu/ops/pallas_ca_block.py:104 _ca_bwd_kernel,
// spe_tpu/ops/pallas_encoder.py:181 _enc_bwd_kernel and
// spe_tpu/ops/pallas_decoder.py:292 _dec_bwd_kernel. The TPU kernels run the
// batch as a sequential grid and add each sample's parameter gradients into
// a resident output; Hopper blocks run in no order, so a cross-block sum
// here is either written as partials and reduced by spe_reduce (the weight
// gradients, whose split-K chunks gemm_kernel writes) or finished inside
// its one launch in a fixed order (colsum_f32_kernel, ln_bwd_kernel,
// branch_bwd_kernel here, th_bwd_rows_kernel and th_dq_kernel in
// th_train.cu: see their notes).
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
#include <cooperative_groups.h>
#include <stdint.h>

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
  float* out;       // (C)
  long long M, ld;
  long long run;    // rows per block: block k of a cluster sums [k*run, (k+1)*run)
  int C;
  int strip;        // columns per cluster (a power of two, 4 to 128)
  int cluster;      // blocks per cluster, 1 to 16
  int vec;          // 16-byte loads: C % 4 == 0, ld % 4 == 0, x 16-byte aligned
};

struct LNBwdParams {
  const float* dy;    // (M, D) f32, stride ld_dy
  const void* x;      // (M, D) LayerNorm input (bf16 or f32), stride ld_x
  const float* g;     // (D)
  const float* res;   // optional (M, D) f32 added to dx, stride ld_res
  void* dx;           // (M, D) contiguous, bf16 or f32 (dx_f32)
  float* dwb;         // (2, D): dgamma then dbeta
  float* ws;          // (ws_rows, 2, D): one row per cluster
  unsigned* ticket;   // (cluster): one per slice, 0 between launches (reset by its last block)
  long long M, ld_dy, ld_x, ld_res;
  long long run;      // rows per warp: warp w of the grid takes [w*run, (w+1)*run)
  int D, x_f32, dx_f32;
  int blocks;         // the grid
  int cluster;        // blocks per cluster: 1, 2, 4 or 8, dividing the grid
  int ws_rows;
  float eps;
};

struct BranchBwdParams {
  const float* dres;    // (M, D) f32 contiguous: gradient of the residual stream
  const float* val;     // optional (M, D) f32 contiguous: the branch after its dropout
  const float* gamma;   // optional (D), 1 without
  const unsigned* seed;
  float* d;             // (M, D) f32: drop(dres * dp * gamma)
  float* dgamma;        // (D): sum over the rows of dres * dp * val (with val)
  long long M, rps;
  long long run;        // rows per block: block k of a strip's cluster takes [k*run, (k+1)*run)
  int D;
  int strip;            // columns per cluster (a power of two, 4 to 128)
  int cluster;          // blocks per strip, 1 to 16 (a thread-block cluster with val)
  int vec;              // 16-byte accesses: D % 4 == 0, dres, val and d 16-byte aligned
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

// colsum_f32_kernel: the bias gradients, column sums of (M, C) f32 rows
// (dY of every Dense layer in the four backward TPU kernels above). What
// bounds it: the bytes of x, read once (6.3 MB at (8192, 192): 1.9 us at
// 3.35 TB/s; 67 MB at (8192, 2048)). The design: one thread-block cluster
// of `cluster` blocks (8, or the non-portable 16) per strip of `strip`
// columns; block k of a cluster sums rows [k*run, (k+1)*run). A thread
// owns one unit of W columns (W = 4: one 16-byte load a row, W = 1: the
// scalar path of a misaligned view or C % 4 != 0, where no row after the
// first keeps 16-byte alignment) and every groups-th row of the run,
// CF_BATCH rows' loads in flight before any is summed. The row groups of a
// warp meet in a fixed shuffle tree, the block's warps in order through
// shared memory; each block stores its partial row into block 0's shared
// memory (distributed shared memory), and after one cluster barrier block
// 0 sums the rows in rank order. No workspace, no atomics, one launch:
// two runs give the same bits. The strip and cluster
// come from kernels.colsum_f32_plan: the widest strip whose grid puts a
// block on every SM, in clusters of 8 unless that leaves strips under 16
// columns (at (8192, 192): clusters of 16, strips of 16, 192 blocks).
// A block may store into another block's shared memory only once that
// block has started: each block arrives (relaxed) at a cluster barrier as
// it starts and waits on it just before its first remote store, by when
// every block has long arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

constexpr int CF_NT = 256;
constexpr int CF_BATCH = 8;
constexpr int CF_MAX_STRIP = 128;
constexpr int CF_MAX_CLUSTER = 16;

// The shared memory of cluster_colsum: the block's partial rows (its
// warps' when units < 32, else its row groups'; at most CF_NT * 4 values)
// and, in block 0, the cluster's rows.
struct ClusterColsumSmem {
  __align__(16) float red[CF_NT * 4];
  float gather[CF_MAX_CLUSTER * CF_MAX_STRIP];
};

// The finish of a strip's column sums over a cluster (colsum_f32_kernel,
// branch_bwd_kernel): thread (u, g) of the block holds the W column sums
// `acc` of unit u (columns [u*W, (u+1)*W) of the strip) over its row
// group g. The row groups of a warp meet in a fixed butterfly (units <
// 32), the block's warps or row groups in order through shared memory;
// each block then stores its row into block 0's shared memory
// (distributed shared memory), and after one cluster barrier block 0
// sums the rows in rank order into out[0, cols). Every block must have
// called cluster_arrive_relaxed() as it started: its first remote store
// waits on that barrier. No atomics: two runs give the same bits.
template <int W>
__device__ __forceinline__ void cluster_colsum(float (&acc)[W], int strip, int cols,
                                               int csize, ClusterColsumSmem& sm, float* out) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int units = strip / W;
  const int u = threadIdx.x % units, g = threadIdx.x / units;
  int rows;  // partial rows in red
  if (units < 32) {
    // the warp's row groups in a fixed butterfly; every lane ends with the sum
    for (int o = units; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (lane < units) {
#pragma unroll
      for (int e = 0; e < W; ++e) sm.red[warp * strip + u * W + e] = acc[e];
    }
    rows = CF_NT / 32;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) sm.red[g * strip + u * W + e] = acc[e];
    rows = CF_NT / units;
  }
  __syncthreads();
  // the block's row into block 0's shared memory, then one barrier
  cluster_wait();
  float* dst = cluster.map_shared_rank(sm.gather, 0) + rank * strip;
  for (int c = threadIdx.x; c < strip; c += CF_NT) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += sm.red[r * strip + c];
    dst[c] = s;
  }
  cluster.sync();  // every block's row has landed; none is read remotely after it
  if (rank == 0) {
    for (int c = threadIdx.x; c < cols; c += CF_NT) {
      float s = 0.f;
      for (int r = 0; r < csize; ++r) s += sm.gather[r * strip + c];
      out[c] = s;
    }
  }
}

// (rows counted in 32 bits: ptxas holds the kernel to 64 registers, and
// 64-bit row counters made it spill)
template <int W>
__global__ void __launch_bounds__(CF_NT) colsum_f32_kernel(ColsumF32Params p) {
  __shared__ ClusterColsumSmem sm;
  const int rank = static_cast<int>(blockIdx.x % p.cluster);
  const int c0 = static_cast<int>(blockIdx.x / p.cluster) * p.strip;
  const int cols = min(p.strip, p.C - c0);
  const int units = p.strip / W;
  const int groups = CF_NT / units;
  const int u = threadIdx.x % units, g = threadIdx.x / units;
  const int r0 = static_cast<int>(min(p.M, rank * p.run));
  const int r1 = static_cast<int>(min(p.M, r0 + p.run));
  cluster_arrive_relaxed();
  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
  if (u * W < cols) {
    const float* src = p.x + c0 + u * W;
    for (int n = r0 + g; n < r1; n += CF_BATCH * groups) {
      float v[CF_BATCH][W];
#pragma unroll
      for (int k = 0; k < CF_BATCH; ++k) {
        const int m = n + k * groups;
        if (m >= r1) continue;
        if constexpr (W == 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(src + static_cast<long long>(m) * p.ld));
          v[k][0] = t.x;
          v[k][1] = t.y;
          v[k][2] = t.z;
          v[k][3] = t.w;
        } else {
          v[k][0] = __ldg(src + static_cast<long long>(m) * p.ld);
        }
      }
#pragma unroll
      for (int k = 0; k < CF_BATCH; ++k) {
        if (n + k * groups >= r1) continue;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[e] += v[k][e];
      }
    }
  }
  cluster_colsum<W>(acc, p.strip, cols, p.cluster, sm, p.out + c0);
}

// branch_bwd_kernel<W, SUM>: the backward of the residual branch
// `x + dp * gamma * drop(y)` of the patch blocks and the class attention
// (pallas_block.py:332-334 and :349-351, pallas_ca_block.py likewise), for
// (M, D) f32 rows: d = drop(dres * dp * gamma) and, with SUM (val given),
// dgamma = sum over the rows of dres * dp * val; without val it is the
// elementwise pass of the encoder's and decoder's dropout gradients. What
// bounds it: bytes, dres and val read once and d written once (18.9 MB at
// the patch blocks' (8192, 192): 5.6 us at 3.35 TB/s). The design is
// colsum_f32_kernel's grid (kernels.branch_backward_plan): a cluster of
// `cluster` blocks per strip of `strip` columns, block k of it over rows
// [k*run, (k+1)*run); a thread owns one unit of W columns (W = 4: 16-byte
// loads and stores, W = 1: the scalar path) and every groups-th row of
// the run, CF_BATCH rows' loads in flight before any is used. A row's
// DropPath factor and dropout key come from the sample's key, made once
// per sample a thread meets, and the row's key once per row. dgamma is
// finished in the same launch by cluster_colsum (no partials, no atomics:
// two runs give the same bits).
template <int W, bool SUM>
__global__ void __launch_bounds__(CF_NT) branch_bwd_kernel(BranchBwdParams p) {
  const int rank = static_cast<int>(blockIdx.x % p.cluster);
  const int c0 = static_cast<int>(blockIdx.x / p.cluster) * p.strip;
  const int cols = min(p.strip, p.D - c0);
  const int units = p.strip / W;
  const int groups = CF_NT / units;
  const int u = threadIdx.x % units, g = threadIdx.x / units;
  const long long r0 = rank * p.run, r1 = min(p.M, r0 + p.run);
  if constexpr (SUM) cluster_arrive_relaxed();
  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
  if (u * W < cols) {
    const int c = c0 + u * W;
    const float* __restrict__ dres = p.dres + c;
    const float* __restrict__ val = SUM ? p.val + c : nullptr;
    float* __restrict__ dst = p.d + c;
    float gm[W];
#pragma unroll
    for (int e = 0; e < W; ++e) gm[e] = p.gamma ? __ldg(p.gamma + c + e) : 1.f;
    const bool drop = p.drop_site != 0, path = p.path_site != 0;
    const unsigned seed = drop || path ? __ldg(p.seed) : 0u;
    const unsigned rps = static_cast<unsigned>(p.rps);
    unsigned sample = 0xffffffffu, hkey = 0u;
    float dp = 1.f;
    for (long long n = r0 + g; n < r1; n += static_cast<long long>(CF_BATCH) * groups) {
      float dr[CF_BATCH][W], vl[CF_BATCH][W];
#pragma unroll
      for (int k = 0; k < CF_BATCH; ++k) {
        const long long m = n + static_cast<long long>(k) * groups;
        if (m >= r1) continue;
        if constexpr (W == 4) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(dres + m * p.D));
          dr[k][0] = a.x;
          dr[k][1] = a.y;
          dr[k][2] = a.z;
          dr[k][3] = a.w;
          if constexpr (SUM) {
            const float4 b = __ldg(reinterpret_cast<const float4*>(val + m * p.D));
            vl[k][0] = b.x;
            vl[k][1] = b.y;
            vl[k][2] = b.z;
            vl[k][3] = b.w;
          }
        } else {
          dr[k][0] = __ldg(dres + m * p.D);
          if constexpr (SUM) vl[k][0] = __ldg(val + m * p.D);
        }
      }
#pragma unroll
      for (int k = 0; k < CF_BATCH; ++k) {
        const long long m = n + static_cast<long long>(k) * groups;
        if (m >= r1) continue;
        unsigned rk = 0u;
        if (drop || path) {
          const unsigned mi = static_cast<unsigned>(m);
          const unsigned b = mi / rps;
          if (b != sample) {   // the sample's DropPath factor and dropout key
            sample = b;
            if (path) dp = path_bit(seed, p.path_site, b, p.path_thr) ? p.path_scale : 0.f;
            if (drop) hkey = head_key(seed, p.drop_site, b, 0u);
          }
          if (drop) rk = row_key(hkey, mi - b * rps);
        }
        float o[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float x = dr[k][e] * dp;
          if constexpr (SUM) acc[e] += x * vl[k][e];
          o[e] = x * gm[e];
          if (drop) {
            o[e] = keep_col(rk, static_cast<unsigned>(c + e), p.drop_thr) ? o[e] * p.drop_scale
                                                                           : 0.f;
          }
        }
        if constexpr (W == 4) {
          *reinterpret_cast<float4*>(dst + m * p.D) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
          dst[m * p.D] = o[0];
        }
      }
    }
  }
  if constexpr (SUM) {
    __shared__ ClusterColsumSmem sm;
    cluster_colsum<W>(acc, p.strip, cols, p.cluster, sm, p.dgamma + c0);
  }
}

// ln_bwd_kernel: LayerNorm backward of (M, D) rows, D = 192, 256, 288, 384
// or 768 (the `_ln_bwd` of the four backward TPU kernels above, at every
// backbone's width): dx (+ a residual) and dgamma/dbeta summed over every
// row. What bounds it: bytes, each row of dy (f32), x (bf16 or f32), the
// residual (f32) read once and dx written once: 19 MB at the patch blocks'
// (8192, 192) with a residual and bf16 x and dx, 5.6 us at 3.35 TB/s. The
// design:
// - A warp holds a row in registers, read once with 16-byte loads (8-byte
//   for bf16 x): lane l owns 4 columns at 128k + 4l of each whole chunk of
//   128 and T = (D % 128) / 32 columns at 128K + T*l of the tail (LnCols).
//   Mean, variance and the two dx sums come from those registers; the next
//   row's loads go out before this row's reductions (up to D = 384: at 768
//   a row's 24 columns a lane, three times over, would not fit the
//   registers); dx leaves in vector stores.
// - A one-wave grid of LNB_NT-thread blocks (kernels.ln_backward_plan,
//   sized by the card's occupancy query: 3 blocks a SM at D = 192, 2 at
//   D = 256, less what clusters of 8 leave unused); warp w walks the fixed
//   run of rows [w*run, (w+1)*run), its lanes keeping their columns'
//   dgamma/dbeta in registers across the run.
// - The same launch finishes the sums in a fixed order: the block's warps
//   in order through shared memory (at D = 768 dgamma, then dbeta: both at
//   once would pass the 48 KB of static shared memory); the cluster's
//   blocks in rank order,
//   block r owning a slice of 2D / cluster columns: every block stores its
//   sums of each slice into the owner's shared memory (distributed shared
//   memory, one cluster barrier), and the owner writes the cluster's row
//   of that slice to `ws`; then a ticket per slice (threadfence, one
//   atomicAdd a block): the last of the slice's owners to arrive sums it
//   over the cluster rows in index order, its threads splitting the rows
//   in fixed runs, and resets the ticket. The order depends on the shape
//   alone, never on who arrives last, so two runs give the same bits. The
//   cluster step cuts the rows a last block sums from one per block
//   (~360) to one per cluster, and spreads the columns over `cluster`
//   last blocks.
constexpr int LNB_NT = 256;
constexpr int LNB_WARPS = LNB_NT / 32;
constexpr int LNB_BATCH = 16;   // cluster rows a thread of the last cluster loads at once

// a lane's E = D / 32 columns of a row: 4 at 128k + 4*lane of each of the K
// whole chunks of 128, T at 128K + T*lane of the tail
template <int D>
struct LnCols {
  static_assert(D == 192 || D == 256 || D == 288 || D == 384 || D == 768,
                "ln_bwd_kernel takes D = 192, 256, 288, 384 or 768");
  static constexpr int K = D / 128;
  static constexpr int T = D % 128 / 32;
  static constexpr int E = 4 * K + T;
  static __device__ __forceinline__ int col(int lane, int i) {
    return i < 4 * K ? 128 * (i / 4) + 4 * lane + i % 4 : 128 * K + T * lane + (i - 4 * K);
  }
  static __device__ __forceinline__ void load_f32(const float* row, int lane, float (&v)[E]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + 128 * k + 4 * lane));
      v[4 * k] = a.x;
      v[4 * k + 1] = a.y;
      v[4 * k + 2] = a.z;
      v[4 * k + 3] = a.w;
    }
    if constexpr (T == 2) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(row + 128 * K + 2 * lane));
      v[4 * K] = b.x;
      v[4 * K + 1] = b.y;
    } else if constexpr (T == 1) {
      v[4 * K] = __ldg(row + 128 * K + lane);
    }
  }
  static __device__ __forceinline__ void load_bf16(const bf16* row, int lane, float (&v)[E]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(row + 128 * k + 4 * lane));
      unpack2(a.x, v[4 * k], v[4 * k + 1]);
      unpack2(a.y, v[4 * k + 2], v[4 * k + 3]);
    }
    if constexpr (T == 2) {
      unpack2(__ldg(reinterpret_cast<const unsigned*>(row + 128 * K + 2 * lane)), v[4 * K],
              v[4 * K + 1]);
    } else if constexpr (T == 1) {
      v[4 * K] = bf2f(row[128 * K + lane]);
    }
  }
  static __device__ __forceinline__ void store_f32(float* row, int lane, const float (&v)[E]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      *reinterpret_cast<float4*>(row + 128 * k + 4 * lane) =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
    if constexpr (T == 2) {
      *reinterpret_cast<float2*>(row + 128 * K + 2 * lane) = make_float2(v[4 * K], v[4 * K + 1]);
    } else if constexpr (T == 1) {
      row[128 * K + lane] = v[4 * K];
    }
  }
  static __device__ __forceinline__ void store_bf16(bf16* row, int lane, const float (&v)[E]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      *reinterpret_cast<uint2*>(row + 128 * k + 4 * lane) =
          make_uint2(pack_bf16(v[4 * k], v[4 * k + 1]), pack_bf16(v[4 * k + 2], v[4 * k + 3]));
    }
    if constexpr (T == 2) {
      *reinterpret_cast<unsigned*>(row + 128 * K + 2 * lane) = pack_bf16(v[4 * K], v[4 * K + 1]);
    } else if constexpr (T == 1) {
      row[128 * K + lane] = f2bf(v[4 * K]);
    }
  }
};

// two blocks a SM up to D = 256 (no spill), one past it
template <int D>
__global__ void __launch_bounds__(LNB_NT, D <= 256 ? 2 : 1) ln_bwd_kernel(LNBwdParams p) {
  using L = LnCols<D>;
  constexpr int E = L::E;
  constexpr bool PREFETCH = D <= 384;       // the next row's loads in flight
  constexpr int PASSES = D > 384 ? 2 : 1;   // the block's dgamma | dbeta through red
  constexpr int RW = 2 * D / PASSES;        // red's columns a pass
  __shared__ float red[LNB_WARPS * RW];     // the warps' dgamma | dbeta, then the last sums
  __shared__ float gather[2 * D];           // the cluster's blocks' rows of this block's slice
  __shared__ int last;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long w = static_cast<long long>(blockIdx.x) * LNB_WARPS + warp;
  const long long m0 = min(p.M, w * p.run), m1 = min(p.M, m0 + p.run);
  const float invD = 1.f / static_cast<float>(D);
  cluster_arrive_relaxed();
  float gw[E], dg[E], db[E];
  L::load_f32(p.g, lane, gw);
#pragma unroll
  for (int i = 0; i < E; ++i) dg[i] = db[i] = 0.f;

  float x[E], dy[E], rs[E];
  auto load = [&](long long m, float (&xv)[E], float (&dyv)[E], float (&rv)[E]) {
    if (p.x_f32) {
      L::load_f32(static_cast<const float*>(p.x) + m * p.ld_x, lane, xv);
    } else {
      L::load_bf16(static_cast<const bf16*>(p.x) + m * p.ld_x, lane, xv);
    }
    L::load_f32(p.dy + m * p.ld_dy, lane, dyv);
    if (p.res) L::load_f32(p.res + m * p.ld_res, lane, rv);
  };
  if (PREFETCH && m0 < m1) load(m0, x, dy, rs);
  for (long long m = m0; m < m1; ++m) {
    float nx[PREFETCH ? E : 1], ndy[PREFETCH ? E : 1], nrs[PREFETCH ? E : 1];
    if constexpr (PREFETCH) {
      if (m + 1 < m1) load(m + 1, nx, ndy, nrs);
    } else {
      load(m, x, dy, rs);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) s += x[i];
    const float mean = warp_sum(s) * invD;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float d = x[i] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) * invD + p.eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float xh = (x[i] - mean) * rstd;
      const float dxh = dy[i] * gw[i];
      x[i] = xh;
      s1 += dxh;
      s2 += dxh * xh;
      dg[i] += dy[i] * xh;
      db[i] += dy[i];
    }
    s1 = warp_sum(s1) * invD;
    s2 = warp_sum(s2) * invD;
    float out[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      out[i] = (dy[i] * gw[i] - s1 - x[i] * s2) * rstd;
      if (p.res) out[i] += rs[i];
    }
    if (p.dx_f32) {
      L::store_f32(static_cast<float*>(p.dx) + m * D, lane, out);
    } else {
      L::store_bf16(static_cast<bf16*>(p.dx) + m * D, lane, out);
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        x[i] = nx[i];
        dy[i] = ndy[i];
        rs[i] = nrs[i];
      }
    }
  }

  // 1. the block: its warps in order (dgamma | dbeta at once, or in two
  // passes). 2. the cluster: block r owns the columns [r*per, (r+1)*per)
  // of 2D; each block stores its sums of every slice into the owner's
  // shared memory, then one barrier, and the owner sums them in rank order
  // into the cluster's row of ws
  const int cl = p.cluster;
  const int per = 2 * D / cl;
  const long long cid = blockIdx.x / cl;
  const long long nclusters = gridDim.x / cl;
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if constexpr (PASSES == 1) {
        red[warp * RW + L::col(lane, i)] = dg[i];
        red[warp * RW + D + L::col(lane, i)] = db[i];
      } else {
        red[warp * RW + L::col(lane, i)] = pass ? db[i] : dg[i];
      }
    }
    __syncthreads();
    if (pass == 0) cluster_wait();
    for (int c = threadIdx.x; c < RW; c += LNB_NT) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < LNB_WARPS; ++r) s += red[r * RW + c];
      const int cc = pass * RW + c;
      cluster.map_shared_rank(gather, cc / per)[rank * per + cc % per] = s;
    }
    if constexpr (PASSES > 1) __syncthreads();   // red is rewritten next pass
  }
  cluster.sync();  // every slice has landed; none is read remotely after it
  for (int j = threadIdx.x; j < per; j += LNB_NT) {
    float s = 0.f;
    for (int r = 0; r < cl; ++r) s += gather[r * per + j];
    p.ws[cid * 2 * D + rank * per + j] = s;
  }
  // 3. the ticket of this slice: the last of the nclusters blocks that own
  // it sums it over the cluster rows and resets the ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(p.ticket + rank, 1u) == static_cast<unsigned>(nclusters - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the cluster rows in index order: thread slice s sums rows [s*chunk,
  // (s+1)*chunk) of column j, LNB_BATCH loads in flight before any is
  // summed, then slice 0's thread the slices in order
  const int slices = per >= LNB_NT ? 1 : LNB_NT / per;
  const long long chunk = (nclusters + slices - 1) / slices;
  for (int idx = threadIdx.x; idx < slices * per; idx += LNB_NT) {
    const int j = idx % per, sl = idx / per;
    const float* col = p.ws + rank * per + j;
    const long long k1 = min(nclusters, (sl + 1) * chunk);
    float s = 0.f;
    for (long long k0 = sl * chunk; k0 < k1; k0 += LNB_BATCH) {
      float t[LNB_BATCH];
#pragma unroll
      for (int b = 0; b < LNB_BATCH; ++b) {
        if (k0 + b < k1) t[b] = __ldcg(col + (k0 + b) * 2 * D);
      }
#pragma unroll
      for (int b = 0; b < LNB_BATCH; ++b) {
        if (k0 + b < k1) s += t[b];
      }
    }
    red[sl * per + j] = s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < per; j += LNB_NT) {
    float s = 0.f;
    for (int sl = 0; sl < slices; ++sl) s += red[sl * per + j];
    p.dwb[rank * per + j] = s;
  }
  if (threadIdx.x == 0) p.ticket[rank] = 0u;
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

namespace {

// a launch of `blocks` blocks in clusters of `cluster` (cudaLaunchKernelEx:
// the cluster size is the plan's, not a compile-time attribute)
template <typename Params>
int launch_clustered(void (*kernel)(Params), const Params& p, long long blocks, int threads,
                     int cluster, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// a clustered launch of CF_NT-thread blocks whose clusters may hold up to
// 16 blocks (the H100's non-portable size, allowed once per kernel)
template <typename Params, void (*Kernel)(Params)>
int launch_wide_clusters(const Params& p, long long blocks, int cluster, cudaStream_t s) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  return launch_clustered(Kernel, p, blocks, CF_NT, cluster, s);
}

// the strips of a colsum_f32_kernel / branch_bwd_kernel grid over C
// columns, 0 if the strip is not a power of two from 4 to CF_MAX_STRIP
long long strips_of(int strip, int C) {
  const bool pow2 = strip >= 4 && strip <= CF_MAX_STRIP && (strip & (strip - 1)) == 0;
  return pow2 && C > 0 ? (C + strip - 1) / strip : 0;
}

// the widths ln_bwd_kernel is built for (kernels.LN_BWD_WIDTHS)
bool ln_width(int D) { return D == 192 || D == 256 || D == 288 || D == 384 || D == 768; }

bool aligned(const void* ptr, long long ld, int bytes, int elem) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0 && (ld * elem) % bytes == 0;
}

}  // namespace

extern "C" int spe_colsum_f32(const ColsumF32Params* p, void* stream) {
  const long long strips = strips_of(p->strip, p->C);
  if (p->M <= 0 || p->M > 2147483647LL || strips == 0 || p->cluster < 1 ||
      p->cluster > CF_MAX_CLUSTER ||
      p->run <= 0 || p->run * p->cluster < p->M || strips * p->cluster > 2147483647LL ||
      (p->vec && (p->C % 4 || !aligned(p->x, p->ld, 16, 4)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = strips * p->cluster;
  return p->vec ? launch_wide_clusters<ColsumF32Params, colsum_f32_kernel<4>>(*p, blocks,
                                                                             p->cluster, s)
                : launch_wide_clusters<ColsumF32Params, colsum_f32_kernel<1>>(*p, blocks,
                                                                             p->cluster, s);
}

extern "C" int spe_ln_backward(const LNBwdParams* p, void* stream) {
  const int cl = p->cluster;
  const int xb = p->x_f32 ? 16 : 8, xe = p->x_f32 ? 4 : 2;
  if (p->M <= 0 || !ln_width(p->D) || p->run <= 0 ||
      (cl != 1 && cl != 2 && cl != 4 && cl != 8) || p->blocks <= 0 || p->blocks % cl ||
      p->blocks / cl > p->ws_rows ||
      static_cast<long long>(p->blocks) * LNB_WARPS * p->run < p->M || !p->ws || !p->ticket ||
      !p->dwb || !aligned(p->dy, p->ld_dy, 16, 4) || !aligned(p->x, p->ld_x, xb, xe) ||
      (p->res && !aligned(p->res, p->ld_res, 16, 4)) ||
      !aligned(p->dx, 0, p->dx_f32 ? 16 : 8, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->D) {
    case 192: return launch_clustered(ln_bwd_kernel<192>, *p, p->blocks, LNB_NT, cl, s);
    case 256: return launch_clustered(ln_bwd_kernel<256>, *p, p->blocks, LNB_NT, cl, s);
    case 288: return launch_clustered(ln_bwd_kernel<288>, *p, p->blocks, LNB_NT, cl, s);
    case 384: return launch_clustered(ln_bwd_kernel<384>, *p, p->blocks, LNB_NT, cl, s);
    default: return launch_clustered(ln_bwd_kernel<768>, *p, p->blocks, LNB_NT, cl, s);
  }
}

// the blocks of one wave of ln_bwd_kernel<D> in clusters of `cluster`:
// the clusters of that size the card can run at once (the occupancy
// query), times the size
extern "C" int spe_ln_backward_wave(int D, int cluster, int* blocks) {
  if (!ln_width(D) || cluster < 1 || cluster > 8 || !blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(LNB_NT);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t err;
  switch (D) {
    case 192: err = cudaOccupancyMaxActiveClusters(&n, ln_bwd_kernel<192>, &cfg); break;
    case 256: err = cudaOccupancyMaxActiveClusters(&n, ln_bwd_kernel<256>, &cfg); break;
    case 288: err = cudaOccupancyMaxActiveClusters(&n, ln_bwd_kernel<288>, &cfg); break;
    case 384: err = cudaOccupancyMaxActiveClusters(&n, ln_bwd_kernel<384>, &cfg); break;
    default: err = cudaOccupancyMaxActiveClusters(&n, ln_bwd_kernel<768>, &cfg); break;
  }
  *blocks = n * cluster;
  return static_cast<int>(err);
}

// With val: clusters of p->cluster blocks (dgamma summed in the launch);
// without: the same grid, no cluster.
extern "C" int spe_branch_backward(const BranchBwdParams* p, void* stream) {
  const long long strips = strips_of(p->strip, p->D);
  if (p->M <= 0 || p->M > 2147483647LL || strips == 0 || p->cluster < 1 ||
      p->cluster > CF_MAX_CLUSTER || p->run <= 0 || p->run * p->cluster < p->M ||
      strips * p->cluster > 2147483647LL || !p->dres || !p->d || (p->val && !p->dgamma) ||
      ((p->drop_site || p->path_site) && (!p->seed || p->rps <= 0)) ||
      (p->vec && (p->D % 4 || !aligned(p->dres, 0, 16, 1) || !aligned(p->d, 0, 16, 1) ||
                  (p->val && !aligned(p->val, 0, 16, 1))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = strips * p->cluster;
  if (p->val) {
    return p->vec ? launch_wide_clusters<BranchBwdParams, branch_bwd_kernel<4, true>>(
                        *p, blocks, p->cluster, s)
                  : launch_wide_clusters<BranchBwdParams, branch_bwd_kernel<1, true>>(
                        *p, blocks, p->cluster, s);
  }
  const unsigned grid = static_cast<unsigned>(blocks);
  if (p->vec) {
    branch_bwd_kernel<4, false><<<grid, CF_NT, 0, s>>>(*p);
  } else {
    branch_bwd_kernel<1, false><<<grid, CF_NT, 0, s>>>(*p);
  }
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

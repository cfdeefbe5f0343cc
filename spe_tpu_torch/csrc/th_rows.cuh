// The talking-heads training row passes, th_fwd_rows_kernel and
// th_bwd_rows_kernel (th_train.cu's header comment says what they compute
// and which TPU code they replace) at H <= 8 heads. Templates on the
// heads H, the standalone form's pre-softmax mix WL and the units U of 4
// columns a thread holds (rows of at most 4 * TH_NT * U keys). th_train.cu
// builds the stock instantiations (U = 1: rows of at most 1024 keys),
// th_wide.cu U = 2 (up to 2048 keys), compilation units of their own so
// that nvcc builds them at once. The M backbones' 16 heads have a design
// of their own on the tensor cores (th_h16.cu), which shares this file's
// parameters, ticket and finish.
#pragma once

#include <stdint.h>

#include "common.cuh"

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
  float* ws;          // backward only, scratch: each block's width sums, block-major
  int B, H, N;
  int drop;           // attention dropout on
  unsigned thr;
  float scale;
  const float* wl;    // optional (H, H) pre-softmax mix, torch Linear layout:
                      // m_g = sum_h wl[g*H+h] s_h + bl_g
  int site;           // the dropout site of the keys (seed, site, b, g, i, j)
};

// the backward's: the row pass's parameters and its one-launch sums (a
// struct of its own, so the forward kernel's parameters keep their layout)
struct THBwdParams {
  THRowParams row;
  unsigned* ticket;   // 0 between launches (reset by the last block)
  float* sums;        // (width): dww[g,h] (H*H), dbw[g], dbl[g]; with wl
                      // (width = 2H*H + 2H) then dwl[g,h]
  long long ws_size;  // floats of row.ws
};

// th_bwd_rows_kernel: one wave of blocks (th_wave: the blocks a SM holds x
// the SMs, at most TH_BLOCKS) of TH_NT threads, each over a fixed run of
// rows_per_block consecutive (sample, query) rows; a thread keeps U units
// of 4 consecutive columns of every head in registers (unit k at column
// 4 (t + TH_NT k), so a warp's unit is 512 contiguous bytes; H, WL and U
// are template parameters, so every per-head array is indexed at compile
// time). Per row: one 16-byte load of each head's logits and dzd a unit,
// issued a row ahead where the registers allow it (PREFETCH, th_bwd_fetch:
// the next row's loads are in flight during this row's reduction and
// stores), 8-byte stores of zd and ds, one block reduction of the H values
// rowsum(dp_h p_h), the dropout keep bits as masks (no branch per
// element); the parameter partials accumulate in registers over the
// block's rows and are reduced once at its end into the block's row of the
// scratch ws. The parameter sums finish in the same launch: one thread a
// block takes a ticket after the block's barrier (ticket_arrive: a
// release, and an acquire for the last block), and the last block sums the
// rows (th_bwd_finish) and resets the ticket. These sums replace the TPU
// kernels' resident accumulators of dww, dbw, dbl (and dwl) over the
// sequential grid (spe_tpu/ops/pallas_block.py:513 `_bwd_call`,
// spe_tpu/ops/pallas_attention_bwd.py:136 `_bwd_call`). At the recipe
// shapes (B = 8, H = 4, N = 1024) the row pass moves 402 MB (s and dzd
// read, zd and ds written, 0.120 ms at 3.35 TB/s) and its sums are 256
// rows of 24 floats (131 of 40 with wl): 25 KB read from L2 by the last
// block, ~1.5 us after the last block arrives, where a second launch
// (spe_reduce) cost ~3 us. One wave keeps the release's wait for the
// block's stores to one per SM slot (with 1024 blocks, ~4 waves, it cost
// ~6 us). The sums' order is fixed by the shape and the card (two runs
// give the same bits; no float atomics).
constexpr int TH_NT = 256;
constexpr int TH_BLOCKS = 1024;
constexpr int TH_MAXU = 2;   // rows of at most 4 * TH_NT * TH_MAXU = 2048 keys

// the wide instantiations: H <= 8 at U = 2 (th_wide.cu); 16 heads
// (th_h16.cu, th16_fwd_rows_kernel and th16_bwd_rows_kernel)
int th_rows_wide(const THBwdParams* p, int backward, cudaStream_t s);
int th_rows_h16(const THBwdParams* p, int backward, cudaStream_t s);

namespace {

// The ticket of a one-launch sum, taken by one thread after its block's
// barrier: a release (fence.acq_rel, then the add; cumulative over the
// block's writes before the barrier) and, for the block that comes last,
// an acquire (the same fence after it) -> the count before this block.
__device__ __forceinline__ unsigned ticket_arrive(unsigned* ticket) {
  unsigned prev;
  asm volatile(
      "fence.acq_rel.gpu;\n\t"
      "atom.relaxed.gpu.global.add.u32 %0, [%1], 1;\n\t"
      "fence.acq_rel.gpu;"
      : "=r"(prev)
      : "l"(ticket)
      : "memory");
  return prev;
}

constexpr int TH_FIN_E = 40;     // entries the last block sums in one pass
constexpr int TH_FIN_G = 8;      // row groups of its second step

// The Z rows of ws (WIDTH floats each, written by the other blocks: read
// from L2) summed into out in a fixed order, TH_FIN_E entries a pass (24
// past 160 entries, the 16-head widths, to keep the kernel's static shared
// memory under 48 KB): thread t sums rows t, t + TH_NT, ... (16-byte loads
// where the rows allow) into st[t]; thread (g, j) sums st rows g*32 ..
// g*32 + 31 of entry j in turn; thread j the TH_FIN_G groups in turn. Not
// inlined: its loads in flight do not add to the row pass's registers.
template <int WIDTH>
__device__ __noinline__ void th_bwd_finish(const float* ws, int Z, float* out) {
  // equal passes of at most FE entries (a multiple of 4 where the rows are
  // whole 16-byte units)
  constexpr int FE = WIDTH > 4 * TH_FIN_E ? 24 : TH_FIN_E;
  constexpr int NP = (WIDTH + FE - 1) / FE;
  constexpr int EQ = (WIDTH + NP - 1) / NP;
  constexpr int EC = WIDTH % 4 == 0 ? (EQ + 3) / 4 * 4 : EQ;
  constexpr int SE = EC + 1;  // padded: a warp's column reads hit distinct banks
  constexpr bool VEC = WIDTH % 4 == 0 && EC % 4 == 0;
  static_assert(TH_FIN_G * 32 == TH_NT, "a row group is a warp's rows");
  __shared__ float st[TH_NT * SE];
  __shared__ float part[TH_FIN_G][EC];
  const int t = threadIdx.x;
#pragma unroll 1
  for (int e0 = 0; e0 < WIDTH; e0 += EC) {
    const int ec = min(EC, WIDTH - e0);
    float acc[EC];
#pragma unroll
    for (int j = 0; j < EC; ++j) acc[j] = 0.f;
    for (int z = t; z < Z; z += TH_NT) {
      const float* row = ws + static_cast<long long>(z) * WIDTH + e0;
      if constexpr (VEC) {
        float4 v[EC / 4];
#pragma unroll
        for (int q = 0; q < EC / 4; ++q) {
          if (4 * q < ec) v[q] = __ldcg(reinterpret_cast<const float4*>(row) + q);
        }
#pragma unroll
        for (int q = 0; q < EC / 4; ++q) {
          if (4 * q < ec) {
            acc[4 * q] += v[q].x;
            acc[4 * q + 1] += v[q].y;
            acc[4 * q + 2] += v[q].z;
            acc[4 * q + 3] += v[q].w;
          }
        }
      } else {
        float v[EC];
#pragma unroll
        for (int j = 0; j < EC; ++j) {
          if (j < ec) v[j] = __ldcg(row + j);
        }
#pragma unroll
        for (int j = 0; j < EC; ++j) {
          if (j < ec) acc[j] += v[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < EC; ++j) st[t * SE + j] = acc[j];
    __syncthreads();
    for (int u = t; u < TH_FIN_G * ec; u += TH_NT) {
      const int g = u / ec, j = u - g * ec;
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < 32; ++r) s += st[(g * 32 + r) * SE + j];
      part[g][j] = s;
    }
    __syncthreads();
    if (t < ec) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < TH_FIN_G; ++g) s += part[g][t];
      out[e0 + t] = s;
    }
    __syncthreads();
  }
}

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

// a thread's U units of a row: unit k is the 4 columns at c0 + 4 TH_NT k
// (c0 = 4 * threadIdx.x), element 4k + e of v
template <int U>
__device__ __forceinline__ void load_units(const float* row, int c0, int n, bool vec,
                                           float (&v)[4 * U]) {
#pragma unroll
  for (int k = 0; k < U; ++k) {
    float t[4];
    load_row4(row, c0 + 4 * TH_NT * k, n, vec, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[4 * k + e] = t[e];
  }
}

template <int U>
__device__ __forceinline__ void store_units(bf16* row, int c0, int n, bool vec,
                                            const float (&v)[4 * U]) {
#pragma unroll
  for (int k = 0; k < U; ++k) {
    float t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] = v[4 * k + e];
    store_row4(row, c0 + 4 * TH_NT * k, n, vec, t);
  }
}

// the column of element e of a thread's units
template <int U>
__device__ __forceinline__ int unit_col(int c0, int e) {
  return c0 + 4 * TH_NT * (e / 4) + e % 4;
}

// row r's loads for th_bwd_rows_kernel: each head's logits and dzd (a
// thread's U units) and log-sum-exp
template <int H, int U>
__device__ __forceinline__ void th_bwd_fetch(const THRowParams& p, int r, int c0, bool vec,
                                             float (&l)[H][4 * U], float (&dd)[H][4 * U],
                                             float (&ls)[H]) {
  const int N = p.N, b = r / N, i = r % N;
  const long long row0 = (static_cast<long long>(b) * H * N + i) * N;
  const long long hstride = static_cast<long long>(N) * N;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    load_units<U>(p.s + row0 + h * hstride, c0, N, vec, l[h]);
    load_units<U>(p.dzd + row0 + h * hstride, c0, N, vec, dd[h]);
    ls[h] = p.lse[(static_cast<long long>(b) * H + h) * N + i];
  }
}

// The H x H mixes in registers (H <= 8)
template <int H, bool WL>
struct THMix {
  float ww[H * H], wl[WL ? H * H : 1];
  __device__ __forceinline__ float w(int e) const { return ww[e]; }
  __device__ __forceinline__ float l(int e) const { return wl[e]; }
};

template <int H, bool WL>
__device__ __forceinline__ void th_load_mix(const THRowParams& p, THMix<H, WL>& mx) {
#pragma unroll
  for (int e = 0; e < H * H; ++e) {
    mx.ww[e] = p.ww[e];
    if constexpr (WL) mx.wl[e] = p.wl[e];
  }
}

// two blocks a SM where the row's registers allow it (H <= 4 without wl
// at U = 1: 128 registers, no spill), so one block's row latency hides the
// other's
template <int H, bool WL, int U>
__global__ void __launch_bounds__(TH_NT, (!WL && H <= 4 && U == 1) ? 2 : 1)
    th_bwd_rows_kernel(THBwdParams pb, int rows_per_block) {
  static_assert(H <= 8, "16 heads: th16_bwd_rows_kernel (th_h16.cu)");
  const THRowParams& p = pb.row;
  constexpr int NW = TH_NT / 32;
  constexpr int E = 4 * U;                    // a thread's columns of a row
  // the stock instantiations prefetch; at two units a thread only where
  // both rows' arrays fit the registers (H = 4 with wl spilled with it)
  constexpr bool PREFETCH = U == 1 || H * U <= (WL ? 4 : 8);
  // with wl, dwl takes the row's own logits after the mixes: kept in a
  // copy where the next row's prefetch overwrites them, else read in place
  // (at H = 4, two units a thread, the copy spilled)
  constexpr bool LG = WL && PREFETCH;
  constexpr int HH = H * H;
  constexpr int WIDTH = (WL ? 2 * HH : HH) + 2 * H;
  __shared__ float red[2][NW][H];
  __shared__ float fin[NW][WIDTH];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int N = p.N;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(p.B * N, r0 + rows_per_block);
  const int c0 = 4 * threadIdx.x;            // this thread's first column
  const bool on = c0 < N;
  const bool vec = N % 4 == 0;                // 16-byte rows
  const float sc = p.drop ? p.scale : 1.f;

  THMix<H, WL> mx;
  th_load_mix<H, WL>(p, mx);
  float bl[H], bw[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    bl[h] = p.bl[h];
    bw[h] = p.bw[h];
  }
  float a_ww[HH], a_wl[WL ? HH : 1], a_bw[H], a_bl[H];
#pragma unroll
  for (int e = 0; e < HH; ++e) {
    a_ww[e] = 0.f;
    if constexpr (WL) a_wl[e] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < H; ++h) a_bw[h] = a_bl[h] = 0.f;

  // the row's loads, issued a row ahead (PREFETCH): row r + 1's are in
  // flight while row r's reduction and stores run
  float l[H][E], dd[H][E], ls[H];
  if constexpr (PREFETCH) {
    if (on && r0 < r1) th_bwd_fetch<H, U>(p, r0, c0, vec, l, dd, ls);
  }
  for (int r = r0; r < r1; ++r) {
    const int b = r / N, i = r % N;
    // row (b, h, i) of a (B, H, N, N) plane starts at ((b * H + h) * N + i) * N
    const long long row0 = (static_cast<long long>(b) * H * N + i) * N;
    const long long hstride = static_cast<long long>(N) * N;
    if constexpr (!PREFETCH) {
      if (on) th_bwd_fetch<H, U>(p, r, c0, vec, l, dd, ls);
    }
    float pr[H][E], dpv[H][E], lg[LG ? H : 1][E], dot[H];
    float dz[H][E];
#pragma unroll
    for (int h = 0; h < H; ++h) dot[h] = 0.f;
    if (on) {
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const float lse = ls[g];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float m;
          if constexpr (WL) {
            m = 0.f;
#pragma unroll
            for (int h = 0; h < H; ++h) m += mx.l(g * H + h) * l[h][e];
            m += bl[g];
          } else {
            m = l[g][e] + bl[g];
          }
          pr[g][e] = unit_col<U>(c0, e) < N ? expf(m - lse) : 0.f;
        }
      }
      if constexpr (LG) {
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int e = 0; e < E; ++e) lg[h][e] = l[h][e];
      }
#pragma unroll
      for (int g = 0; g < H; ++g) {
        // the keep bits as masks (all ones: kept), so a dropped element is
        // +0 by a bitwise and: no branch per element
        unsigned km[E];
#pragma unroll
        for (int e = 0; e < E; ++e) km[e] = ~0u;
        if (p.drop) {
          const unsigned rk = row_key(head_key(*p.seed, p.site, b, g), i);
#pragma unroll
          for (int e = 0; e < E; ++e) km[e] = keep_col(rk, unit_col<U>(c0, e), p.thr) ? ~0u : 0u;
        }
        float zo[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float z = bw[g];
#pragma unroll
          for (int h = 0; h < H; ++h) z += mx.w(g * H + h) * pr[h][e];
          zo[e] = __uint_as_float(__float_as_uint(z * sc) & km[e]);
          dz[g][e] = __uint_as_float(__float_as_uint(dd[g][e] * sc) & km[e]);
          a_bw[g] += dz[g][e];
#pragma unroll
          for (int h = 0; h < H; ++h) a_ww[g * H + h] += pr[h][e] * dz[g][e];
        }
        store_units<U>(p.zd + row0 + g * hstride, c0, N, vec, zo);
      }
      if constexpr (PREFETCH) {
        if (r + 1 < r1) th_bwd_fetch<H, U>(p, r + 1, c0, vec, l, dd, ls);
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float d = 0.f;
#pragma unroll
          for (int g = 0; g < H; ++g) d += mx.w(g * H + h) * dz[g][e];
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
    const float(&dp)[H][E] = dpv;
    float dm[H][E];
#pragma unroll
    for (int g = 0; g < H; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dm[g][e] = pr[g][e] * (dp[g][e] - S[g]);
        a_bl[g] += dm[g][e];
      }
    if constexpr (!WL) {
#pragma unroll
      for (int g = 0; g < H; ++g) store_units<U>(p.ds + row0 + g * hstride, c0, N, vec, dm[g]);
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float dl[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dl[e] = 0.f;
#pragma unroll
          for (int g = 0; g < H; ++g) {
            dl[e] += mx.l(g * H + h) * dm[g][e];
            if constexpr (LG) {
              a_wl[g * H + h] += lg[h][e] * dm[g][e];
            } else {
              a_wl[g * H + h] += l[h][e] * dm[g][e];
            }
          }
        }
        store_units<U>(p.ds + row0 + h * hstride, c0, N, vec, dl);
      }
    }
  }
  // the block's partials: [dww (H*H) | dbw (H) | dbl (H) | dwl (H*H)]
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
    float v = 0.f;
    if (e < HH) {
      v = a_ww[e];
    } else if (e < HH + H) {
      v = a_bw[e - HH];
    } else if (e < HH + 2 * H) {
      v = a_bl[e - HH - H];
    } else if constexpr (WL) {
      v = a_wl[e - HH - 2 * H];
    }
    v = warp_sum(v);
    if (lane == 0) fin[warp][e] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < WIDTH; e += TH_NT) {
    float t = 0.f;
    for (int w = 0; w < NW; ++w) t += fin[w][e];
    p.ws[static_cast<long long>(blockIdx.x) * WIDTH + e] = t;
  }
  // the ticket: one thread, a release after the block's barrier (the
  // block's rows of ws go with it); the last block acquires and sums the
  // rows
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = ticket_arrive(pb.ticket) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  th_bwd_finish<WIDTH>(p.ws, gridDim.x, pb.sums);
  if (threadIdx.x == 0) *pb.ticket = 0u;
}

// th_fwd_rows_kernel: th_bwd_rows_kernel's layout (a thread's U units of
// 4 columns of every head, fixed runs of consecutive rows; one wave of
// blocks, at most TH_BLOCKS). Per row: the mixed logits m_g (+ bl_g) from
// the H logits loaded during the row before (at H * U <= 16, PREFETCH;
// else at the top of the row), the next row's loads issued, then two block
// reductions of H values (the row maxima, then the sums of exp(m - max)),
// lse = max + log(sum), p_h = exp(m_h - lse_h) as th_bwd_rows_kernel
// recomputes it, z_g = sum_h ww[g, h] p_h + bw_g, the counter mask (the
// head keys made once per sample) and 8-byte stores of zd. The mixes in
// registers, as in th_bwd_rows_kernel.
template <int H, bool WL, int U>
__global__ void __launch_bounds__(TH_NT) th_fwd_rows_kernel(THRowParams p, int rows_per_block) {
  static_assert(H <= 8, "16 heads: th16_fwd_rows_kernel (th_h16.cu)");
  constexpr int NW = TH_NT / 32;
  constexpr int E = 4 * U;
  constexpr bool PREFETCH = H * U <= 16;
  __shared__ float red_max[NW][H], red_sum[NW][H];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int N = p.N;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(p.B * N, r0 + rows_per_block);
  const int c0 = 4 * threadIdx.x;            // this thread's first column
  const bool on = c0 < N;
  const bool vec = N % 4 == 0;                // 16-byte rows
  const float sc = p.drop ? p.scale : 1.f;
  const long long hstride = static_cast<long long>(N) * N;

  THMix<H, WL> mx;
  th_load_mix<H, WL>(p, mx);
  float bl[H], bw[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    bl[h] = p.bl[h];
    bw[h] = p.bw[h];
  }
  unsigned key[H];
  int key_b = -1;                             // the sample of key[]
#pragma unroll
  for (int h = 0; h < H; ++h) key[h] = 0u;

  // row (b, h, i) of a (B, H, N, N) plane starts at ((b * H + h) * N + i) * N
  float nx[H][E];                             // the logits of the (next) row
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int e = 0; e < E; ++e) nx[h][e] = 0.f;
  int b = r0 / N, i = r0 % N;
  long long row0 = (static_cast<long long>(b) * H * N + i) * N;
  if constexpr (PREFETCH) {
    if (on && r0 < r1) {
#pragma unroll
      for (int h = 0; h < H; ++h) load_units<U>(p.s + row0 + h * hstride, c0, N, vec, nx[h]);
    }
  }
  for (int r = r0; r < r1; ++r) {
    if constexpr (!PREFETCH) {
      if (on) {
#pragma unroll
        for (int h = 0; h < H; ++h) load_units<U>(p.s + row0 + h * hstride, c0, N, vec, nx[h]);
      }
    }
    float m[H][E];
#pragma unroll
    for (int g = 0; g < H; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float v;
        if constexpr (WL) {
          v = 0.f;
#pragma unroll
          for (int h = 0; h < H; ++h) v += mx.l(g * H + h) * nx[h][e];
          v += bl[g];
        } else {
          v = nx[g][e] + bl[g];
        }
        m[g][e] = v;
      }
    if (c0 + 4 * TH_NT * (U - 1) + 4 > N) {   // -inf past the row's end
#pragma unroll
      for (int g = 0; g < H; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (unit_col<U>(c0, e) >= N) m[g][e] = -INFINITY;
    }
    // the next row (b, i + 1), or (b + 1, 0) after the sample's last
    const long long next = i + 1 < N ? row0 + N : static_cast<long long>(b + 1) * H * N * N;
    if constexpr (PREFETCH) {
      if (on && r + 1 < r1) {
#pragma unroll
        for (int h = 0; h < H; ++h) load_units<U>(p.s + next + h * hstride, c0, N, vec, nx[h]);
      }
    }
    // the row maxima, then the sums: each a fixed shuffle tree, then the
    // warps in order (red_max of the next row is written only after every
    // thread passed this row's second barrier). The sums take the fast
    // exponential and logarithm: lse moves by a few f32 ulps, and p below
    // is the exact expf(m - lse) that th_bwd_rows_kernel recomputes.
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float t = fmaxf(fmaxf(m[g][0], m[g][1]), fmaxf(m[g][2], m[g][3]));
#pragma unroll
      for (int e = 4; e < E; ++e) t = fmaxf(t, m[g][e]);
      t = warp_max(t);
      if (lane == 0) red_max[warp][g] = t;
    }
    __syncthreads();
    float mxr[H];
#pragma unroll
    for (int g = 0; g < H; ++g) {
      mxr[g] = red_max[0][g];
      for (int w = 1; w < NW; ++w) mxr[g] = fmaxf(mxr[g], red_max[w][g]);
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) t += __expf(m[g][e] - mxr[g]);
      t = warp_sum(t);
      if (lane == 0) red_sum[warp][g] = t;
    }
    __syncthreads();
    float lse[H];
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float l = 0.f;
      for (int w = 0; w < NW; ++w) l += red_sum[w][g];
      lse[g] = mxr[g] + __logf(l);
      if (threadIdx.x == g) p.lse[(static_cast<long long>(b) * H + g) * N + i] = lse[g];
    }
    if (on) {
      if (p.drop && b != key_b) {
#pragma unroll
        for (int g = 0; g < H; ++g) key[g] = head_key(*p.seed, p.site, b, g);
        key_b = b;
      }
      float pr[H][E];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e) pr[h][e] = expf(m[h][e] - lse[h]);   // 0 past the row's end
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const unsigned rk = row_key(key[g], static_cast<unsigned>(i));
        float zo[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float z = bw[g];
#pragma unroll
          for (int h = 0; h < H; ++h) z += mx.w(g * H + h) * pr[h][e];
          const bool keep =
              !p.drop || keep_col(rk, static_cast<unsigned>(unit_col<U>(c0, e)), p.thr);
          zo[e] = keep ? z * sc : 0.f;
        }
        store_units<U>(p.zd + row0 + g * hstride, c0, N, vec, zo);
      }
    }
    row0 = next;
    if (++i == N) {
      i = 0;
      ++b;
    }
  }
}

// a row kernel's blocks in one wave on this card (at most TH_BLOCKS)
template <typename Kernel>
int th_wave(Kernel kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TH_NT, 0) != cudaSuccess ||
      n <= 0) {
    n = 1;
  }
  return n * sm_count() < TH_BLOCKS ? n * sm_count() : TH_BLOCKS;
}

// the backward's grid: the blocks of one wave, each over an equal run of
// rows (one fence and ticket a block, the blocks ending together)
template <int H, bool WL, int U>
int launch_th_bwd_form(const THBwdParams* p, cudaStream_t s) {
  static const int wave = th_wave(th_bwd_rows_kernel<H, WL, U>);
  const long long rows = static_cast<long long>(p->row.B) * p->row.N;
  const long long per = (rows + wave - 1) / wave;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  const long long width = (WL ? 2 : 1) * H * H + 2 * H;
  if (!p->row.ws || !p->ticket || !p->sums || blocks * width > p->ws_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  th_bwd_rows_kernel<H, WL, U><<<blocks, TH_NT, 0, s>>>(*p, static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

// the forward's grid: the blocks of one wave (at most TH_BLOCKS), each
// over an equal run of rows
template <int H, bool WL, int U>
int launch_th_fwd_form(const THRowParams* p, cudaStream_t s) {
  static const int wave = th_wave(th_fwd_rows_kernel<H, WL, U>);
  const long long rows = static_cast<long long>(p->B) * p->N;
  const long long per = (rows + wave - 1) / wave;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  th_fwd_rows_kernel<H, WL, U><<<blocks, TH_NT, 0, s>>>(*p, static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

template <int H, int U>
int launch_th_rows(const THBwdParams* p, int backward, cudaStream_t s) {
  if (backward) {
    return p->row.wl ? launch_th_bwd_form<H, true, U>(p, s) : launch_th_bwd_form<H, false, U>(p, s);
  }
  return p->row.wl ? launch_th_fwd_form<H, true, U>(&p->row, s)
                   : launch_th_fwd_form<H, false, U>(&p->row, s);
}

}  // namespace

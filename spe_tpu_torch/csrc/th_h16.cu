// The talking-heads training row passes (th_train.cu's header says what
// they compute and which TPU code they replace) at the M36/M48 backbones'
// 16 heads, for rows of up to 2048 keys: th16_fwd_rows_kernel and
// th16_bwd_rows_kernel, with and without the standalone form's
// pre-softmax mix wl. A compilation unit of its own, so nvcc builds it
// beside th_train.cu and th_wide.cu.
//
// What bounds them: bytes. At M48's shape (B = 8, H = 16, N = 1024) the
// backward reads s and dzd (f32) and writes zd and ds (bf16), 12 bytes per
// plane element: 1.61 GB, 0.481 ms at 3.35 TB/s; the forward reads s and
// writes zd, 6 bytes: 0.805 GB, 0.240 ms. The 16 x 16 mixes are 16
// multiply-adds per element and product (z = ww p, dp = ww^T dz, the dww
// partials; with wl also m = wl L, dL = wl^T dm and the dwl partials): on
// the f32 pipes with every weight broadcast from shared memory they would
// take longer than the bytes, so they run on the tensor cores.
//
// The design. Blocks of TH_NT threads (8 warps), each over a fixed run of
// consecutive (sample, query) rows, one wave of them (the backward and the
// wl forward one a SM, the forward without wl two); a row is walked in
// chunks of 256 columns, warp w taking the stripe of 32 columns at 32 w of
// each chunk.
// - What a thread holds: lane l = 4 g + t keeps 4 heads (2t, 2t + 1,
//   2t + 8, 2t + 9) x 4 consecutive columns (4g .. 4g + 3) of its warp's
//   stripe: 16 values a plane, no thread holds all 16 heads of a column.
//   That set is at once the A fragment and the accumulator of
//   mma.sync.m16n8k8 (TF32) on the transposed product z^T = p^T ww^T with
//   the contracted head index permuted (k = t -> head 2t, k = t + 4 ->
//   2t + 1): two 16-column tiles x two 8-head tiles x two 8-head k steps
//   are 8 mma a mix, and its output lies where its input did, so
//   p -> z and dz -> dp need no exchange between lanes. The mixes are B
//   fragments in registers for the kernel's life (8 registers each).
// - The parameter partials contract over columns, which the lanes hold
//   by g, not by t: after the mixes a lane writes its p and dz (TF32) over
//   the s and dzd it has read from the chunk's shared-memory slot, and the
//   warp reads them back as the A (dz, 16 heads x 8 columns) and B (p)
//   fragments of dww += dz p^T, 8 mma a stripe, accumulated in 8
//   registers a lane over all of the block's rows (no per-row reduction).
//   With wl, dwl += dm L^T likewise from dm and the row's own logits.
// - Staging: each warp streams its stripes through a private ring of
//   shared-memory slots (16 head rows of 32 columns, padded to 36 floats
//   so that the fragment reads and the 16-byte reads and writes are free
//   of bank conflicts), filled by cp.async (16-byte pieces where N % 4 ==
//   0 and the planes are aligned, else 4 bytes), the next slots' copies in
//   flight while one is computed; a warp waits only on its own copies
//   (cp.async.wait_group, then __syncwarp), so no block barrier serves the
//   staging.
// - Two passes a row. The backward's first pass recomputes p = exp(s +
//   bl - lse), draws the dropout keep bits (kept in shared memory, 16 a
//   lane a chunk, for the second pass), stores zd, forms dz and dp and
//   sums rowsum(dp p) and the partials; one block barrier then finishes
//   rowsum(dp_h p_h) (a fixed shuffle tree over the 8 lanes of a head set,
//   then the warps in order); the second pass reloads the chunks (from
//   L2: a block's row is 128 KB), recomputes p and dp bit for bit and
//   stores ds = p (dp - rowsum) (with wl dL = wl^T dm). The forward's
//   first pass keeps a running maximum and sum of exponentials a lane and
//   head, merged by the same tree and order into lse; its second pass
//   reloads, mixes and stores zd. (Keeping the forward's row in shared
//   memory for its second pass measured no faster on an H100.)
// - No branch an element: the exponentials are 2^y by the special function
//   unit on y = (m - lse) log2(e), one multiply-add an element, -inf past
//   the row in its last chunk only; the keep bits are a 16-bit mask.
// - Precision: TF32 operands rounded to nearest (ties away, as cvt.rna;
//   one add and one and an element), f32 accumulation; the pre-softmax mix
//   with wl splits each f32 operand into TF32 hi + lo and sums lo hi + hi lo
//   + hi hi (3xTF32), so lse keeps f32's accuracy.
// - Fixed order: every sum's order is fixed by the shape and the card (the
//   mma's own, the shuffle trees, the warps in order, the block's rows in
//   order, then the blocks by th_bwd_finish after the ticket), so two runs
//   give the same bits; no float atomics.
// Registers: the mixes' fragments and a chunk's 16-value arrays: at most
// 128 a thread in the forward without wl (two blocks a SM), under 255 in
// the others (no local memory; chip_smoke's build phase checks). Shared
// memory: the backward's 3 slots of s and dzd a warp (108 KB) and its keep
// bits (4 KB) beside th_bwd_finish's 26 KB; the forward's 4 slots of s (72
// KB). On an H100 deeper rings measured slower in the backward and no
// faster in the forward.
#include "th_rows.cuh"

namespace {

constexpr int T16_H = 16;
constexpr int T16_NW = TH_NT / 32;                   // warps a block
constexpr int T16_STRIPE = 32;                       // a warp's columns of a chunk
constexpr int T16_CHUNK = T16_NW * T16_STRIPE;       // 256 columns a chunk
constexpr int T16_MAXC = 4 * TH_NT * TH_MAXU / T16_CHUNK;  // 8 chunks: 2048 keys
constexpr int T16_LD = 36;                           // a stripe's head row, padded
constexpr int T16_ARR = T16_H * T16_LD;              // floats of one plane's stripe
constexpr int T16_BWD_SLOTS = 3;                     // a warp's ring: s and dzd
constexpr int T16_FWD_SLOTS = 4;                     // s
// dynamic shared memory: the rings (and the backward's keep bits, 16 a lane
// and chunk)
constexpr int T16_BWD_RING = T16_NW * T16_BWD_SLOTS * 2 * T16_ARR;   // floats
constexpr int T16_BWD_SMEM = T16_BWD_RING * 4 + T16_NW * T16_MAXC * 32 * 2;
constexpr int T16_FWD_SMEM = T16_NW * T16_FWD_SLOTS * T16_ARR * 4;

// x rounded to TF32 (nearest, ties away from zero: cvt.rna.tf32's rounding
// of finite values) by two integer operations
__device__ __forceinline__ unsigned t16_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a . b: mma.sync m16n8k8 on TF32 operands with f32 accumulators. PTX's
// fragments: lane 4g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); B (t, g), (t + 4, g); C/D (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// head hh (0..3) of lane 4g + t: 2t, 2t + 1, 2t + 8, 2t + 9
__device__ __forceinline__ int t16_head(int hh, int t) { return 8 * (hh >> 1) + 2 * t + (hh & 1); }

// The B fragments of out_n = sum_k M[n, k] in_k, M = W (TRANS false) or
// W^T, W (16, 16) row-major: k step kq, output heads 8q .. 8q + 7, entry e
// at the permuted k = t + 4e -> head 8kq + 2t + e; with lo, W = hi + lo
template <bool TRANS, bool SPLIT = false>
__device__ __forceinline__ void t16_frag(const float* W, int g, int t, unsigned (&hi)[2][2][2],
                                         unsigned (&lo)[2][2][2]) {
#pragma unroll
  for (int kq = 0; kq < 2; ++kq)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * q + g, k = 8 * kq + 2 * t + e;
        const float w = TRANS ? W[k * T16_H + n] : W[n * T16_H + k];
        hi[kq][q][e] = t16_tf32(w);
        if constexpr (SPLIT) lo[kq][q][e] = t16_tf32(w - __uint_as_float(hi[kq][q][e]));
      }
}

template <bool TRANS>
__device__ __forceinline__ void t16_frag(const float* W, int g, int t, unsigned (&hi)[2][2][2]) {
  t16_frag<TRANS, false>(W, g, t, hi, hi);
}

// out += M . x over the lane's 4 heads x 4 columns (x as TF32 bits, out in
// place): m tile j holds columns 4g + 2j (row g) and 4g + 2j + 1 (row
// g + 8); A = x's heads of k step kq, D = out's heads of n tile q
__device__ __forceinline__ void t16_mix(const unsigned (&x)[4][4], const unsigned (&bf)[2][2][2],
                                        float (&out)[4][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float d[4] = {out[2 * q][2 * j], out[2 * q + 1][2 * j], out[2 * q][2 * j + 1],
                    out[2 * q + 1][2 * j + 1]};
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        const unsigned a[4] = {x[2 * kq][2 * j], x[2 * kq][2 * j + 1], x[2 * kq + 1][2 * j],
                               x[2 * kq + 1][2 * j + 1]};
        mma_tf32(d, a, bf[kq][q][0], bf[kq][q][1]);
      }
      out[2 * q][2 * j] = d[0];
      out[2 * q + 1][2 * j] = d[1];
      out[2 * q][2 * j + 1] = d[2];
      out[2 * q + 1][2 * j + 1] = d[3];
    }
}

// the TF32 bits of x, rounded to nearest
__device__ __forceinline__ void t16_round(const float (&x)[4][4], unsigned (&u)[4][4]) {
#pragma unroll
  for (int hh = 0; hh < 4; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) u[hh][e] = t16_tf32(x[hh][e]);
}

// out += M . x in 3xTF32: x and M split into hi + lo, lo hi + hi lo, then
// hi hi (f32's accuracy for the pre-softmax mix)
__device__ __forceinline__ void t16_mix3(const float (&x)[4][4], const unsigned (&bh)[2][2][2],
                                         const unsigned (&bl)[2][2][2], float (&out)[4][4]) {
  unsigned xh[4][4], xl[4][4];
  t16_round(x, xh);
#pragma unroll
  for (int hh = 0; hh < 4; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) xl[hh][e] = t16_tf32(x[hh][e] - __uint_as_float(xh[hh][e]));
  t16_mix(xl, bh, out);
  t16_mix(xh, bl, out);
  t16_mix(xh, bh, out);
}

// acc[n] += X Y^T over a stripe's 32 columns, X and Y (16 head rows of
// T16_LD floats, TF32 bits) in shared memory: entry (g', h) = sum_c
// X[g', c] Y[h, c], lane 4g + t's acc[n] at (g, 8n + 2t), (g, 8n + 2t +
// 1), (g + 8, 8n + 2t), (g + 8, 8n + 2t + 1)
__device__ __forceinline__ void t16_pair_sums(const float* X, const float* Y, int g, int t,
                                              float (&acc)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < T16_STRIPE / 8; ++kk) {
    const int c = 8 * kk + t;
    const float* x0 = X + g * T16_LD + c;
    const float* x1 = X + (g + 8) * T16_LD + c;
    const unsigned a[4] = {__float_as_uint(x0[0]), __float_as_uint(x1[0]), __float_as_uint(x0[4]),
                           __float_as_uint(x1[4])};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float* y = Y + (8 * n + g) * T16_LD + c;
      mma_tf32(acc[n], a, __float_as_uint(y[0]), __float_as_uint(y[4]));
    }
  }
}

// the lane's 4 columns of head hh from / into a stripe array
__device__ __forceinline__ void t16_ld(const float* arr, int hh, int g, int t, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(arr + t16_head(hh, t) * T16_LD + 4 * g);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void t16_st(float* arr, int hh, int g, int t, const unsigned (&u)[4]) {
  *reinterpret_cast<uint4*>(arr + t16_head(hh, t) * T16_LD + 4 * g) =
      make_uint4(u[0], u[1], u[2], u[3]);
}

// A chunk's stripe of NA planes (s, then dzd) for row (b, i) into a slot,
// by cp.async: 16-byte pieces (VEC: N % 4 == 0, aligned planes; a piece is
// whole or past the row) or 4-byte elements; past the row zero-filled.
template <int NA>
__device__ __forceinline__ void t16_fetch(const float* a0, const float* a1, long long row0,
                                          long long hs, int N, int c0, bool vec, float* slot,
                                          int lane) {
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const float* src = a ? a1 : a0;
    float* dst = slot + a * T16_ARR;
    if (vec) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int piece = lane + 32 * j, h = piece >> 3, u = piece & 7, c = c0 + 4 * u;
        const int n = c < N ? 16 : 0;
        cp_async<16>(smem_u32(dst + h * T16_LD + 4 * u), n ? src + row0 + h * hs + c : src, n);
      }
    } else {
      const int c = c0 + lane, n = c < N ? 4 : 0;
#pragma unroll
      for (int h = 0; h < T16_H; ++h) {
        cp_async<4>(smem_u32(dst + h * T16_LD + lane), n ? src + row0 + h * hs + c : src, n);
      }
    }
  }
}

// A warp's walk over its block's visits (each row's chunks, k = 0 .. NC -
// 1, in the first pass, then again in the second), by increments: no
// division a visit. row0 is row (b, i)'s offset in a (B, H, N, N) plane.
struct T16Cursor {
  int k, rr, b, i;
  bool second;
  long long row0;
  __device__ __forceinline__ void start(int r0, int N) {
    k = rr = 0;
    second = false;
    b = r0 / N;
    i = r0 - b * N;
    row0 = (static_cast<long long>(b) * T16_H * N + i) * N;
  }
  __device__ __forceinline__ void next(int NC, int N) {
    if (++k < NC) return;
    k = 0;
    second = !second;
    if (second) return;
    ++rr;
    if (++i < N) {
      row0 += N;
    } else {
      i = 0;
      ++b;
      row0 = static_cast<long long>(b) * T16_H * N * N;
    }
  }
};

// the copies of the visit at cursor f into a slot of the warp's ring
template <int NA>
__device__ __forceinline__ void t16_fetch_visit(const THRowParams& p, const float* a1,
                                                const T16Cursor& f, bool vec, float* slot, int warp,
                                                int lane) {
  t16_fetch<NA>(p.s, a1, f.row0, static_cast<long long>(p.N) * p.N, p.N,
                f.k * T16_CHUNK + T16_STRIPE * warp, vec, slot, lane);
}

// the lane's 4 heads x 4 columns (from column c) of a chunk into a (B, H,
// N, N) bf16 plane at row0: 8-byte stores where the 4 columns are whole
// (full: N % 4 == 0, aligned, inside the row), else element by element
// inside the row; one branch a chunk
__device__ __forceinline__ void t16_store(bf16* out, long long row0, long long hs, int t, int c,
                                          int N, bool full, const float (&v)[4][4]) {
  if (full) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      *reinterpret_cast<uint2*>(out + row0 + t16_head(hh, t) * hs + c) =
          make_uint2(pack_bf16(v[hh][0], v[hh][1]), pack_bf16(v[hh][2], v[hh][3]));
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e < N) out[row0 + t16_head(hh, t) * hs + c + e] = f2bf(v[hh][e]);
      }
  }
}

// the sum of v over the 8 lanes of a head set (the lanes of one t): a
// fixed xor tree, every lane left with the same bits
__device__ __forceinline__ float t16_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// per row: the dropout row keys of the lane's heads (their head keys made
// once a sample)
__device__ __forceinline__ void t16_row(const THRowParams& p, unsigned seed, int b, int i, int t,
                                        int& key_b, unsigned (&hk)[4], unsigned (&rk)[4]) {
  if (!p.drop) return;
  if (b != key_b) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) hk[hh] = head_key(seed, p.site, b, t16_head(hh, t));
    key_b = b;
  }
#pragma unroll
  for (int hh = 0; hh < 4; ++hh) rk[hh] = row_key(hk[hh], static_cast<unsigned>(i));
}

// the dropout keep bits of the lane's chunk as a mask, bit 4 hh + e (no
// branch an element)
__device__ __forceinline__ unsigned t16_keep(const unsigned (&rk)[4], int c, unsigned thr) {
  unsigned km = 0u;
#pragma unroll
  for (int hh = 0; hh < 4; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      km |= keep_col(rk[hh], static_cast<unsigned>(c + e), thr) ? 1u << (4 * hh + e) : 0u;
  return km;
}

// x where bit 4 hh + e of km is set, else +0
__device__ __forceinline__ float t16_kept(float x, unsigned km, int hh, int e) {
  return __uint_as_float(__float_as_uint(x) & (0u - ((km >> (4 * hh + e)) & 1u)));
}

constexpr float T16_LOG2E = 1.4426950408889634f, T16_LN2 = 0.6931471805599453f;

// 2^x by the special function unit (ex2.approx.ftz: 2^-inf = 0)
__device__ __forceinline__ float t16_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// y = (m + off) log2(e) for the lane's chunk, m the mixed logits (+ bl):
// one multiply-add an element without wl; -inf past the row (set only in
// the row's last chunk, `edge`: no branch an element)
template <bool WL>
__device__ __forceinline__ void t16_logits2(const float (&x)[4][4], const float (&blv)[4],
                                            const float (&off)[4], const unsigned (&lh)[2][2][2],
                                            const unsigned (&ll)[2][2][2], int c, int N, bool edge,
                                            float (&y)[4][4]) {
  if constexpr (WL) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[hh][e] = blv[hh];
    t16_mix3(x, lh, ll, y);
#pragma unroll
    for (int hh = 0; hh < 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[hh][e] = fmaf(y[hh][e], T16_LOG2E, off[hh] * T16_LOG2E);
  } else {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[hh][e] = fmaf(x[hh][e], T16_LOG2E, (blv[hh] + off[hh]) * T16_LOG2E);
  }
  if (edge) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e >= N) y[hh][e] = -INFINITY;
  }
}

// p = exp(m - lse) of the lane's chunk, 0 past the row, by the special
// function unit (a relative error of ~1e-6 beside the products' TF32
// rounding of ~2e-4); the same bits in both passes and in
// th16_fwd_rows_kernel
template <bool WL>
__device__ __forceinline__ void t16_probs(const float (&x)[4][4], const float (&blv)[4],
                                          const float (&ls)[4], const unsigned (&lh)[2][2][2],
                                          const unsigned (&ll)[2][2][2], int c, int N, bool edge,
                                          float (&pr)[4][4]) {
  const float off[4] = {-ls[0], -ls[1], -ls[2], -ls[3]};
  t16_logits2<WL>(x, blv, off, lh, ll, c, N, edge, pr);
#pragma unroll
  for (int hh = 0; hh < 4; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) pr[hh][e] = t16_exp2(pr[hh][e]);
}

template <bool WL>
__global__ void __launch_bounds__(TH_NT, 1)
    th16_bwd_rows_kernel(THBwdParams pb, int rows_per_block) {
  const THRowParams& p = pb.row;
  constexpr int HH = T16_H * T16_H;
  constexpr int WIDTH = (WL ? 2 * HH : HH) + 2 * T16_H;
  constexpr int SLOTS = T16_BWD_SLOTS;
  extern __shared__ __align__(16) float t16_sm[];
  __shared__ float red[2][T16_NW][T16_H];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = p.N, NC = (N + T16_CHUNK - 1) / T16_CHUNK;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(p.B * N, r0 + rows_per_block);
  const int V = (r1 - r0) * 2 * NC;             // visits: each row's chunks twice
  float* ring = t16_sm + warp * (SLOTS * 2 * T16_ARR);
  unsigned short* kbits =
      reinterpret_cast<unsigned short*>(t16_sm + T16_BWD_RING) + warp * T16_MAXC * 32 + lane;
  const bool vec = N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.s) | reinterpret_cast<uintptr_t>(p.dzd)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.zd) | reinterpret_cast<uintptr_t>(p.ds)) % 8 == 0;
  const float sc = p.drop ? p.scale : 1.f;
  const unsigned seed = p.drop ? *p.seed : 0u;
  const long long hs = static_cast<long long>(N) * N;

  // the copies run SLOTS - 1 visits ahead of the visit computed (fc ahead
  // of vc); visit v's slot is v % SLOTS
  T16Cursor fc, vc;
  fc.start(r0, N);
  vc = fc;
  for (int u = 0; u < SLOTS - 1; ++u) {
    if (u < V) {
      t16_fetch_visit<2>(p, p.dzd, fc, vec, ring + u * 2 * T16_ARR, warp, lane);
      fc.next(NC, N);
    }
    cp_async_commit();
  }
  unsigned wz[2][2][2], wd[2][2][2], lh[2][2][2], ll[2][2][2], ld[2][2][2];
  t16_frag<false>(p.ww, g, t, wz);
  t16_frag<true>(p.ww, g, t, wd);
  if constexpr (WL) {
    t16_frag<false, true>(p.wl, g, t, lh, ll);
    t16_frag<true>(p.wl, g, t, ld);
  }
  float bwv[4], blv[4], a_bw[4], a_bl[4], dot[4], ls[4], S[4];
  float dww[2][4], dwl[2][4];
  unsigned hk[4], rk[4];
#pragma unroll
  for (int hh = 0; hh < 4; ++hh) {
    bwv[hh] = p.bw[t16_head(hh, t)];
    blv[hh] = p.bl[t16_head(hh, t)];
    a_bw[hh] = a_bl[hh] = dot[hh] = S[hh] = ls[hh] = 0.f;
    hk[hh] = rk[hh] = 0u;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) dww[n][q] = dwl[n][q] = 0.f;
  int key_b = -1, slot = 0;

  for (int v = 0; v < V; ++v, vc.next(NC, N), slot = slot + 1 < SLOTS ? slot + 1 : 0) {
    if (v + SLOTS - 1 < V) {   // into the slot visit v - 1 freed
      t16_fetch_visit<2>(p, p.dzd, fc, vec, ring + (slot ? slot - 1 : SLOTS - 1) * 2 * T16_ARR,
                         warp, lane);
      fc.next(NC, N);
    }
    cp_async_commit();
    cp_async_wait<SLOTS - 1>();                  // this visit's copies landed
    __syncwarp();                                 // ... and the warp's lanes see them
    const int k = vc.k, b = vc.b, i = vc.i;
    const bool second = vc.second;
    const long long row0 = vc.row0;
    float* xs = ring + slot * 2 * T16_ARR;        // s, then dzd
    float* ys = xs + T16_ARR;
    if (!second && k == 0) {                      // a new row
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        ls[hh] = p.lse[(static_cast<long long>(b) * T16_H + t16_head(hh, t)) * N + i];
        dot[hh] = 0.f;
      }
      t16_row(p, seed, b, i, t, key_b, hk, rk);
    }
    if (second && k == 0) {                       // rowsum(dp_h p_h) of the row
      const int par = vc.rr & 1;
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        const float s8 = t16_sum8(dot[hh]);
        if (g == 0) red[par][warp][t16_head(hh, t)] = s8;
      }
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        float s8 = 0.f;
#pragma unroll
        for (int w = 0; w < T16_NW; ++w) s8 += red[par][w][t16_head(hh, t)];
        S[hh] = s8;
      }
    }
    const int c = k * T16_CHUNK + T16_STRIPE * warp + 4 * g;   // the lane's first column
    const bool edge = (k + 1) * T16_CHUNK > N, full = vec && c + 4 <= N;
    float x[4][4], y[4][4], pr[4][4];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      t16_ld(xs, hh, g, t, x[hh]);
      t16_ld(ys, hh, g, t, y[hh]);
    }
    t16_probs<WL>(x, blv, ls, lh, ll, c, N, edge, pr);
    // the keep bits as masks (bit 4 hh + e; all ones: kept)
    unsigned km = 0xffffu;
    if (p.drop) {
      if (!second) {
        km = t16_keep(rk, c, p.thr);
        kbits[k * 32] = static_cast<unsigned short>(km);
      } else {
        km = kbits[k * 32];
      }
    }
    float dz[4][4], dp[4][4];
    unsigned dzt[4][4];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dz[hh][e] = t16_kept(y[hh][e] * sc, km, hh, e);
        dp[hh][e] = 0.f;
      }
    t16_round(dz, dzt);
    t16_mix(dzt, wd, dp);                         // dp = ww^T dz
    if (!second) {
      unsigned pt[4][4];
      float z[4][4];
      t16_round(pr, pt);
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[hh][e] = bwv[hh];
      t16_mix(pt, wz, z);                         // z = ww p + bw
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          z[hh][e] = t16_kept(z[hh][e] * sc, km, hh, e);
          a_bw[hh] += dz[hh][e];
          dot[hh] += dp[hh][e] * pr[hh][e];
        }
      t16_store(p.zd, row0, hs, t, c, N, full, z);
      // dww += dz p^T: p and dz over the stripe's s and dzd (each lane its
      // own elements), then read back by columns
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        t16_st(xs, hh, g, t, pt[hh]);
        t16_st(ys, hh, g, t, dzt[hh]);
      }
      __syncwarp();
      t16_pair_sums(ys, xs, g, t, dww);
    } else {
      float dm[4][4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dm[hh][e] = pr[hh][e] * (dp[hh][e] - S[hh]);
          a_bl[hh] += dm[hh][e];
        }
      if constexpr (!WL) {
        t16_store(p.ds, row0, hs, t, c, N, full, dm);
      } else {
        // dL = wl^T dm into ds; dwl += dm L^T from dm and the row's logits
        unsigned dmt[4][4], xt[4][4];
        float dl[4][4];
        t16_round(dm, dmt);
        t16_round(x, xt);
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) dl[hh][e] = 0.f;
        t16_mix(dmt, ld, dl);
        t16_store(p.ds, row0, hs, t, c, N, full, dl);
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          t16_st(xs, hh, g, t, xt[hh]);
          t16_st(ys, hh, g, t, dmt[hh]);
        }
        __syncwarp();
        t16_pair_sums(ys, xs, g, t, dwl);
      }
    }
    __syncwarp();                                 // the slot is free for its next copy
  }
  cp_async_wait<0>();
  // the block's partials [dww (HH) | dbw (H) | dbl (H) | dwl (HH)]: each
  // warp's into the head of its own ring, then the warps in order
  float* fin = ring;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = (g + 8 * (q >> 1)) * T16_H + 8 * n + 2 * t + (q & 1);
      fin[e] = dww[n][q];
      if constexpr (WL) fin[HH + 2 * T16_H + e] = dwl[n][q];
    }
#pragma unroll
  for (int hh = 0; hh < 4; ++hh) {
    const float sb = t16_sum8(a_bw[hh]), sl = t16_sum8(a_bl[hh]);
    if (g == 0) {
      fin[HH + t16_head(hh, t)] = sb;
      fin[HH + T16_H + t16_head(hh, t)] = sl;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < WIDTH; e += TH_NT) {
    float s8 = 0.f;
    for (int w = 0; w < T16_NW; ++w) s8 += t16_sm[w * (SLOTS * 2 * T16_ARR) + e];
    p.ws[static_cast<long long>(blockIdx.x) * WIDTH + e] = s8;
  }
  // the ticket: one thread, a release after the block's barrier; the last
  // block acquires and sums the blocks' rows in order
  __syncthreads();
  if (threadIdx.x == 0) last = ticket_arrive(pb.ticket) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  th_bwd_finish<WIDTH>(p.ws, gridDim.x, pb.sums);
  if (threadIdx.x == 0) *pb.ticket = 0u;
}

template <bool WL>
__global__ void __launch_bounds__(TH_NT, WL ? 1 : 2)
    th16_fwd_rows_kernel(THRowParams p, int rows_per_block) {
  constexpr int SLOTS = T16_FWD_SLOTS;
  extern __shared__ __align__(16) float t16_sm[];
  __shared__ float red_m[2][T16_NW][T16_H], red_s[2][T16_NW][T16_H];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = p.N, NC = (N + T16_CHUNK - 1) / T16_CHUNK;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(p.B * N, r0 + rows_per_block);
  const int V = (r1 - r0) * 2 * NC;
  float* ring = t16_sm + warp * (SLOTS * T16_ARR);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(p.s) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.zd) % 8 == 0;
  const float sc = p.drop ? p.scale : 1.f;
  const unsigned seed = p.drop ? *p.seed : 0u;
  const long long hs = static_cast<long long>(N) * N;

  T16Cursor fc, vc;
  fc.start(r0, N);
  vc = fc;
  for (int u = 0; u < SLOTS - 1; ++u) {
    if (u < V) {
      t16_fetch_visit<1>(p, nullptr, fc, vec, ring + u * T16_ARR, warp, lane);
      fc.next(NC, N);
    }
    cp_async_commit();
  }
  unsigned wz[2][2][2], lh[2][2][2], ll[2][2][2];
  t16_frag<false>(p.ww, g, t, wz);
  if constexpr (WL) t16_frag<false, true>(p.wl, g, t, lh, ll);
  float bwv[4], blv[4], mx[4], sm[4], ls[4];
  unsigned hk[4], rk[4];
#pragma unroll
  for (int hh = 0; hh < 4; ++hh) {
    bwv[hh] = p.bw[t16_head(hh, t)];
    blv[hh] = p.bl[t16_head(hh, t)];
    mx[hh] = -INFINITY;
    sm[hh] = ls[hh] = 0.f;
    hk[hh] = rk[hh] = 0u;
  }
  int key_b = -1, slot = 0;

  for (int v = 0; v < V; ++v, vc.next(NC, N), slot = slot + 1 < SLOTS ? slot + 1 : 0) {
    if (v + SLOTS - 1 < V) {
      t16_fetch_visit<1>(p, nullptr, fc, vec, ring + (slot ? slot - 1 : SLOTS - 1) * T16_ARR, warp,
                         lane);
      fc.next(NC, N);
    }
    cp_async_commit();
    cp_async_wait<SLOTS - 1>();
    __syncwarp();
    const int k = vc.k, b = vc.b, i = vc.i;
    const bool second = vc.second;
    const long long row0 = vc.row0;
    const float* xs = ring + slot * T16_ARR;
    if (!second && k == 0) {
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        mx[hh] = -INFINITY;
        sm[hh] = 0.f;
      }
      t16_row(p, seed, b, i, t, key_b, hk, rk);
    }
    if (second && k == 0) {
      // the row's maxima and sums of 2^(y - max) (y = m log2(e)): the
      // lanes' running pairs merged by a fixed xor tree, then the warps in
      // order (the special function unit's 2^x and log2: lse moves by a few
      // f32 ulps)
      const int par = vc.rr & 1;
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        float a = mx[hh], s = sm[hh];
#pragma unroll
        for (int o = 4; o <= 16; o *= 2) {
          const float oa = __shfl_xor_sync(0xffffffffu, a, o);
          const float os = __shfl_xor_sync(0xffffffffu, s, o);
          const float na = fmaxf(a, oa);
          s = na == -INFINITY ? 0.f : s * t16_exp2(a - na) + os * t16_exp2(oa - na);
          a = na;
        }
        if (g == 0) {
          red_m[par][warp][t16_head(hh, t)] = a;
          red_s[par][warp][t16_head(hh, t)] = s;
        }
      }
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        const int h = t16_head(hh, t);
        float a = red_m[par][0][h];
        for (int w = 1; w < T16_NW; ++w) a = fmaxf(a, red_m[par][w][h]);
        float s = 0.f;   // (a is finite: column 0 lies in warp 0's stripe)
#pragma unroll
        for (int w = 0; w < T16_NW; ++w) s += red_s[par][w][h] * t16_exp2(red_m[par][w][h] - a);
        ls[hh] = (a + __log2f(s)) * T16_LN2;
        if (warp == 0 && g == 0) p.lse[(static_cast<long long>(b) * T16_H + h) * N + i] = ls[hh];
      }
    }
    const int c = k * T16_CHUNK + T16_STRIPE * warp + 4 * g;
    const bool edge = (k + 1) * T16_CHUNK > N, full = vec && c + 4 <= N;
    float x[4][4];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) t16_ld(xs, hh, g, t, x[hh]);
    if (!second) {
      // the running maximum and sum of 2^(y - max) of each head, y = m
      // log2(e)
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
      float y[4][4];
      t16_logits2<WL>(x, blv, zero, lh, ll, c, N, edge, y);
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        float cm = -INFINITY;
#pragma unroll
        for (int e = 0; e < 4; ++e) cm = fmaxf(cm, y[hh][e]);
        // (a lane with no column yet: base 0, every term 2^-inf = 0)
        const float na = fmaxf(mx[hh], cm), base = na == -INFINITY ? 0.f : na;
        float s = sm[hh] * t16_exp2(mx[hh] - base);
#pragma unroll
        for (int e = 0; e < 4; ++e) s += t16_exp2(y[hh][e] - base);
        sm[hh] = s;
        mx[hh] = na;
      }
    } else {
      float pr[4][4], z[4][4];
      unsigned pt[4][4];
      t16_probs<WL>(x, blv, ls, lh, ll, c, N, edge, pr);
      t16_round(pr, pt);
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[hh][e] = bwv[hh];
      t16_mix(pt, wz, z);
      const unsigned km = p.drop ? t16_keep(rk, c, p.thr) : 0xffffu;
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[hh][e] = t16_kept(z[hh][e] * sc, km, hh, e);
      t16_store(p.zd, row0, hs, t, c, N, full, z);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// a kernel's blocks in one wave at its dynamic shared memory (at most
// TH_BLOCKS), the attribute set once
template <typename Kernel>
int t16_wave(Kernel kernel, int smem, int& wave) {
  if (wave) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TH_NT, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  wave = n * sm_count() < TH_BLOCKS ? n * sm_count() : TH_BLOCKS;
  return 0;
}

// the grid of one wave, each block over an equal run of rows (the
// backward's: one fence and ticket a block, its sums a row of ws)
template <bool WL>
int launch_th16_bwd(const THBwdParams* p, cudaStream_t s) {
  static int wave = 0;
  const int err = t16_wave(th16_bwd_rows_kernel<WL>, T16_BWD_SMEM, wave);
  if (err) return err;
  const long long rows = static_cast<long long>(p->row.B) * p->row.N;
  const long long per = (rows + wave - 1) / wave;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  const long long width = (WL ? 2 : 1) * T16_H * T16_H + 2 * T16_H;
  if (!p->row.ws || !p->ticket || !p->sums || blocks * width > p->ws_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  th16_bwd_rows_kernel<WL><<<blocks, TH_NT, T16_BWD_SMEM, s>>>(*p, static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

template <bool WL>
int launch_th16_fwd(const THRowParams* p, cudaStream_t s) {
  static int wave = 0;
  const int err = t16_wave(th16_fwd_rows_kernel<WL>, T16_FWD_SMEM, wave);
  if (err) return err;
  const long long rows = static_cast<long long>(p->B) * p->N;
  const long long per = (rows + wave - 1) / wave;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  th16_fwd_rows_kernel<WL><<<blocks, TH_NT, T16_FWD_SMEM, s>>>(*p, static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int th_rows_h16(const THBwdParams* p, int backward, cudaStream_t s) {
  if (p->row.N > T16_CHUNK * T16_MAXC) return static_cast<int>(cudaErrorInvalidValue);
  if (backward) return p->row.wl ? launch_th16_bwd<true>(p, s) : launch_th16_bwd<false>(p, s);
  return p->row.wl ? launch_th16_fwd<true>(&p->row, s) : launch_th16_fwd<false>(&p->row, s);
}

// Talking-heads attention in training, and the class-attention softmax
// backward. With attention dropout after the post-softmax mix the eval
// kernel's trick (moving the mix past PV) no longer holds, so the training
// form materialises the (B, H, N, N) planes of one block call and works on
// whole rows:
//   th_fold        q~_g = bf16(q (.) row_g), the wl-fold of the pre-softmax
//                  mix into the q side (spe_tpu/ops/pallas_block.py:104);
//   th_fwd_rows    after s_g = q~_g . k^T (spe_gemm): per row the
//                  log-sum-exp of each mixed head (saved for the backward),
//                  then p_h = exp(s_h + bl_h - lse_h),
//                  z_g = sum_h ww[g, h] p_h + bw_g, counter dropout, written
//                  in bf16 for the product with V_g (spe_gemm);
//   th_bwd_rows    from s (recomputed), lse and dzd_g = do_g . V_g^T: zd_g
//                  (for dV = zd^T do), dz = M (.) dzd / keep,
//                  dp_h = sum_g ww[g, h] dz_g, ds_g = p_g (dp_g - rowsum(dp_g p_g))
//                  in bf16 (for dq~ = ds . K and dK = sum_g ds_g^T q~_g), and
//                  dww, dbw and dbl, summed in the same launch;
//   th_dq          dQ = sum_g dq~_g (.) row_g and dwl, summed in the same
//                  launch;
//   th_*_rows with wl  the standalone talking-heads attention
//                  (spe_tpu/ops/pallas_attention.py:30 _kernel and
//                  pallas_attention_bwd.py:40 _bwd_kernel): s holds each
//                  head's own logits L_h = dh^-0.5 q_h . k_h^T and the row
//                  passes mix them, m_g = sum_h wl[g, h] L_h + bl_g, as the
//                  TPU kernels do in f32 (no wl-fold); the backward writes
//                  dL_h = sum_g wl[g, h] dm_g in bf16 in place of dm (for
//                  dQ_h = scale dL_h . K_h and dK_h = scale dL_h^T . Q_h) and
//                  adds dwl[g, h] = <L_h, dm_g> to its sums;
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
// th_fwd_rows reads s (f32) and writes zd (bf16), 6 bytes per plane
// element: 0.060 ms at B=8, H=4, N=1024. th_bwd_rows reads s and dzd (f32)
// and writes zd and ds (bf16), 12 bytes per plane element: 0.12 ms at that
// shape. Both share one design: H (and wl) are template parameters, so
// no per-head array is indexed at run time; each thread keeps its 4
// columns of every head in registers, read once with one 16-byte load per
// head (8-byte stores); a fixed grid walks fixed runs of consecutive rows.
// The forward needs two block reductions a row (the H row maxima, then the
// H sums of exp(m - max)), each a fixed shuffle tree and the warps in
// order, and loads the next row's logits before them. On the H100 it runs
// at about 1.7x its byte bound: two exponentials and a counter hash per
// element and head make its instruction issue about as long as its memory
// time. The backward needs
// one reduction (rowsum(dp_h p_h), H values), loads each row a row ahead
// and accumulates the parameter partials (dww, dbw, dbl, dwl) in
// registers, reduced once per block, then across blocks by the launch's
// last block in a fixed order (a ticket, no float atomics), so two runs
// give the same bits.
// Both take N <= 4 * TH_NT = 1024 (a larger N waits for a
// columns-per-thread template).
// attn_bwd_rows (12 bytes per element: 0.24 ms for the encoder's 64 x
// 1024 x 1024 at B=8) has no parameter partials: a row's s and dzd are
// read once into registers by a group of W warps (U units of 4 columns a
// thread, both template parameters chosen from Nk), each element's
// exponential and keep bit computed once, the row sum a fixed shuffle tree
// (then the group's warps in order), 16-byte loads and 8-byte stores where
// Nk % 4 == 0 and scalar ones otherwise.
#include <stdint.h>

#include "common.cuh"

constexpr int MAXH = 8;
// th_fold's rows in shared memory: at most the H100's 227 KB a block
constexpr long long FOLD_MAX_SMEM = 232448;

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

struct THDqParams {
  const float* dqt;   // (B, H, N, D) dq~_g, contiguous
  const bf16* q;      // (B, N, D) rows with strides q_sb, q_sn
  const float* rows;  // (H, D) contiguous
  float* dq;          // (B, N, D) rows with strides o_sb, o_sn
  float* dwl;         // (H, H): dwl[g, h]
  float* ws;          // (ws_size): the blocks' (H, H) sums, block-major
  unsigned* ticket;   // 0 between launches (reset by the last block)
  long long q_sb, q_sn, o_sb, o_sn;
  long long run;      // rows (b, i) per block: block k takes [k*run, (k+1)*run)
  long long ws_size;
  int B, H, N, D;
  int group;          // threads per row (a chunk of V columns each, per pass)
  int vec;            // 16-byte dq~/rows/dQ and 8-byte q accesses (V = 4)
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

// th_fold_kernel replaces `(qf * rows[g]).astype(in_dt)` of the TPU block
// kernels' _attention (spe_tpu/ops/pallas_block.py:136, the rows from
// _mix_rows at :104), run inside the block's forward (:495) and backward
// (:530) pallas_calls. What bounds it: bytes. At the stock step's (B, H,
// N, D) = (8, 4, 1024, 192) it reads 3.1 MB of q (a view of qkv with row
// stride 3D) and writes 12.6 MB: 0.0047 ms at 3.35 TB/s. The design: a
// work item is W consecutive columns of one (sample, row) of q, W = 8 (one
// 16-byte load, then H 16-byte stores, one to each head's output row)
// where D % 8 == 0 and q's rows are 16-byte aligned, W = 1 otherwise; q is
// read once for all H heads. rows (H x D f32) sits in shared memory, read
// once per block. A thread keeps one unit column and steps over rows, its
// (sample, row) kept by increments (one division a thread); the next
// item's load is issued before the current item's stores. A grid of
// FOLD_BLOCKS blocks per SM (one wave) walks the B * N rows in fixed runs
// of slabs of FOLD_NT / units rows. f2bf rounds to nearest even, as the
// plain version's .to(bfloat16) does: the output equals it bit for bit.
constexpr int FOLD_NT = 256;
constexpr int FOLD_BLOCKS = 4;

template <int W>
__device__ __forceinline__ void fold_load(const bf16* src, float (&x)[W]) {
  if constexpr (W == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    unpack2(v.x, x[0], x[1]);
    unpack2(v.y, x[2], x[3]);
    unpack2(v.z, x[4], x[5]);
    unpack2(v.w, x[6], x[7]);
  } else {
    x[0] = bf2f(*src);
  }
}

template <int W>
__global__ void __launch_bounds__(FOLD_NT, FOLD_BLOCKS) th_fold_kernel(THFoldParams p, int slabs) {
  extern __shared__ float rows_s[];  // (H, D)
  const int units = p.D / W;
  const int ustep = min(units, FOLD_NT);
  const int rpb = FOLD_NT / ustep;  // rows of a slab
  const int rr = threadIdx.x / ustep;
  const int R = p.B * p.N;
  // this block's run of slabs, in even shares
  const int s0 = static_cast<int>(static_cast<long long>(blockIdx.x) * slabs / gridDim.x);
  const int s1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * slabs / gridDim.x);
  const int rend = min(R, s1 * rpb);
  int r = s0 * rpb + rr, u = threadIdx.x % ustep;
  int b = r / p.N, n = r - b * p.N;
  const bool live = rr < rpb && r < rend;
  float x[W];
  if (live) fold_load<W>(p.q + b * p.q_sb + n * p.q_sn + u * W, x);
  for (int i = threadIdx.x; i < p.H * p.D; i += FOLD_NT) rows_s[i] = p.rows[i];
  __syncthreads();
  if (!live) return;
  const long long plane = static_cast<long long>(p.N) * p.D;
  for (;;) {
    bf16* dst = p.out + (static_cast<long long>(b) * p.H * p.N + n) * p.D + u * W;
    const float* w = rows_s + u * W;
    float y[W];
#pragma unroll
    for (int e = 0; e < W; ++e) y[e] = x[e];
    // the next item: the next unit of this row, else this unit of the
    // row one slab further
    int nu = u + ustep, nr = r, nb = b, nn = n;
    if (nu >= units) {
      nu = threadIdx.x % ustep;
      nr += rpb;
      nn += rpb;
      while (nn >= p.N) {
        nn -= p.N;
        ++nb;
      }
    }
    const bool more = nr < rend;
    if (more) fold_load<W>(p.q + nb * p.q_sb + nn * p.q_sn + nu * W, x);
    for (int g = 0; g < p.H; ++g, dst += plane, w += p.D) {
      if constexpr (W == 8) {
        const float4 w0 = *reinterpret_cast<const float4*>(w);
        const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bf16(y[0] * w0.x, y[1] * w0.y), pack_bf16(y[2] * w0.z, y[3] * w0.w),
                       pack_bf16(y[4] * w1.x, y[5] * w1.y), pack_bf16(y[6] * w1.z, y[7] * w1.w));
      } else {
        *dst = f2bf(y[0] * w[0]);
      }
    }
    if (!more) break;
    u = nu;
    r = nr;
    b = nb;
    n = nn;
  }
}

// th_bwd_rows_kernel: one wave of blocks (th_wave: the blocks a SM holds x
// the SMs, at most TH_BLOCKS) of TH_NT threads, each over a fixed run of
// rows_per_block consecutive (sample, query) rows; a thread keeps 4
// consecutive columns of every head in registers (H is a template
// parameter, so every per-head array is indexed at compile time). Per row:
// one 16-byte load of each head's logits and dzd, issued a row ahead
// (th_bwd_fetch: the next row's loads are in flight during this row's
// reduction and stores), 8-byte stores of zd and ds, one block reduction
// of the H values rowsum(dp_h p_h), the dropout keep bits as masks (no
// branch per element); the parameter partials accumulate in registers over
// the block's rows and are reduced once at its end into the block's row of
// the scratch ws. The parameter sums finish in the same launch: one thread
// a block takes a ticket after the block's barrier (ticket_arrive: a
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
// from L2) summed into out in a fixed order, TH_FIN_E entries a pass:
// thread t sums rows t, t + TH_NT, ... (16-byte loads where the rows allow)
// into st[t]; thread (g, j) sums st rows g*32 .. g*32 + 31 of entry j in
// turn; thread j the TH_FIN_G groups in turn. Not inlined: its loads in
// flight do not add to the row pass's registers.
template <int WIDTH>
__device__ __noinline__ void th_bwd_finish(const float* ws, int Z, float* out) {
  // equal passes of at most TH_FIN_E entries (a multiple of 4 where the
  // rows are whole 16-byte units)
  constexpr int NP = (WIDTH + TH_FIN_E - 1) / TH_FIN_E;
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

// row r's loads for th_bwd_rows_kernel: each head's logits and dzd (a
// thread's 4 columns) and log-sum-exp
template <int H>
__device__ __forceinline__ void th_bwd_fetch(const THRowParams& p, int r, int c0, bool vec,
                                             float (&l)[H][4], float (&dd)[H][4],
                                             float (&ls)[H]) {
  const int N = p.N, b = r / N, i = r % N;
  const long long row0 = (static_cast<long long>(b) * H * N + i) * N;
  const long long hstride = static_cast<long long>(N) * N;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    load_row4(p.s + row0 + h * hstride, c0, N, vec, l[h]);
    load_row4(p.dzd + row0 + h * hstride, c0, N, vec, dd[h]);
    ls[h] = p.lse[(static_cast<long long>(b) * H + h) * N + i];
  }
}

// two blocks a SM where the row's registers allow it (H <= 4 without wl:
// 128 registers, no spill), so one block's row latency hides the other's
template <int H, bool WL>
__global__ void __launch_bounds__(TH_NT, (!WL && H <= 4) ? 2 : 1) th_bwd_rows_kernel(THBwdParams pb, int rows_per_block) {
  const THRowParams& p = pb.row;
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

  // the row's loads, issued a row ahead: row r + 1's are in flight while
  // row r's reduction and stores run
  float l[H][4], dd[H][4], ls[H];
  if (on && r0 < r1) th_bwd_fetch<H>(p, r0, c0, vec, l, dd, ls);
  for (int r = r0; r < r1; ++r) {
    const int b = r / N, i = r % N;
    // row (b, h, i) of a (B, H, N, N) plane starts at ((b * H + h) * N + i) * N
    const long long row0 = (static_cast<long long>(b) * H * N + i) * N;
    const long long hstride = static_cast<long long>(N) * N;
    float pr[H][4], dpv[H][4], lg[WL ? H : 1][4], dot[H];
#pragma unroll
    for (int h = 0; h < H; ++h) dot[h] = 0.f;
    if (on) {
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const float lse = ls[g];
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
        // the keep bits as masks (all ones: kept), so a dropped element is
        // +0 by a bitwise and: no branch per element
        unsigned km[4] = {~0u, ~0u, ~0u, ~0u};
        if (p.drop) {
          const unsigned rk = row_key(head_key(*p.seed, p.site, b, g), i);
#pragma unroll
          for (int e = 0; e < 4; ++e) km[e] = keep_col(rk, c0 + e, p.thr) ? ~0u : 0u;
        }
        float zo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float z = bw[g];
#pragma unroll
          for (int h = 0; h < H; ++h) z += ww[g * H + h] * pr[h][e];
          zo[e] = __uint_as_float(__float_as_uint(z * sc) & km[e]);
          dz[g][e] = __uint_as_float(__float_as_uint(dd[g][e] * sc) & km[e]);
          a_bw[g] += dz[g][e];
#pragma unroll
          for (int h = 0; h < H; ++h) a_ww[g * H + h] += pr[h][e] * dz[g][e];
        }
        store_row4(p.zd + row0 + g * hstride, c0, N, vec, zo);
      }
      if (r + 1 < r1) th_bwd_fetch<H>(p, r + 1, c0, vec, l, dd, ls);
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

// th_fwd_rows_kernel: th_bwd_rows_kernel's layout (a thread's 4 columns of
// every head, fixed runs of consecutive rows; one wave of blocks, at most
// TH_BLOCKS). Per row: the mixed logits m_g (+ bl_g) from the H logits
// loaded during the row before, the next row's loads issued, then two block
// reductions of H values (the row maxima, then the sums of exp(m - max)),
// lse = max + log(sum), p_h = exp(m_h - lse_h) as th_bwd_rows_kernel
// recomputes it, z_g = sum_h ww[g, h] p_h + bw_g, the counter mask (the
// head keys made once per sample) and 8-byte stores of zd.
template <int H, bool WL>
__global__ void __launch_bounds__(TH_NT) th_fwd_rows_kernel(THRowParams p, int rows_per_block) {
  constexpr int NW = TH_NT / 32;
  __shared__ float red_max[NW][H], red_sum[NW][H];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int N = p.N;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(p.B * N, r0 + rows_per_block);
  const int c0 = 4 * threadIdx.x;            // this thread's 4 columns
  const bool on = c0 < N;
  const bool vec = N % 4 == 0;                // 16-byte rows
  const float sc = p.drop ? p.scale : 1.f;
  const long long hstride = static_cast<long long>(N) * N;

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
  unsigned key[H];
  int key_b = -1;                             // the sample of key[]
#pragma unroll
  for (int h = 0; h < H; ++h) key[h] = 0u;

  // row (b, h, i) of a (B, H, N, N) plane starts at ((b * H + h) * N + i) * N
  float nx[H][4];                             // the logits of the next row
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) nx[h][e] = 0.f;
  int b = r0 / N, i = r0 % N;
  long long row0 = (static_cast<long long>(b) * H * N + i) * N;
  if (on && r0 < r1) {
#pragma unroll
    for (int h = 0; h < H; ++h) load_row4(p.s + row0 + h * hstride, c0, N, vec, nx[h]);
  }
  for (int r = r0; r < r1; ++r) {
    float m[H][4];
#pragma unroll
    for (int g = 0; g < H; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v;
        if constexpr (WL) {
          v = 0.f;
#pragma unroll
          for (int h = 0; h < H; ++h) v += wl[g * H + h] * nx[h][e];
          v += bl[g];
        } else {
          v = nx[g][e] + bl[g];
        }
        m[g][e] = v;
      }
    if (c0 + 4 > N) {                         // -inf past the row's end
#pragma unroll
      for (int g = 0; g < H; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + e >= N) m[g][e] = -INFINITY;
    }
    // the next row (b, i + 1), or (b + 1, 0) after the sample's last
    const long long next = i + 1 < N ? row0 + N : static_cast<long long>(b + 1) * H * N * N;
    if (on && r + 1 < r1) {
#pragma unroll
      for (int h = 0; h < H; ++h) load_row4(p.s + next + h * hstride, c0, N, vec, nx[h]);
    }
    // the row maxima, then the sums: each a fixed shuffle tree, then the
    // warps in order (red_max of the next row is written only after every
    // thread passed this row's second barrier). The sums take the fast
    // exponential and logarithm: lse moves by a few f32 ulps, and p below
    // is the exact expf(m - lse) that th_bwd_rows_kernel recomputes.
#pragma unroll
    for (int g = 0; g < H; ++g) {
      const float t = warp_max(fmaxf(fmaxf(m[g][0], m[g][1]), fmaxf(m[g][2], m[g][3])));
      if (lane == 0) red_max[warp][g] = t;
    }
    __syncthreads();
    float mx[H];
#pragma unroll
    for (int g = 0; g < H; ++g) {
      mx[g] = red_max[0][g];
      for (int w = 1; w < NW; ++w) mx[g] = fmaxf(mx[g], red_max[w][g]);
      float t = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) t += __expf(m[g][e] - mx[g]);
      t = warp_sum(t);
      if (lane == 0) red_sum[warp][g] = t;
    }
    __syncthreads();
    float lse[H];
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float l = 0.f;
      for (int w = 0; w < NW; ++w) l += red_sum[w][g];
      lse[g] = mx[g] + __logf(l);
      if (threadIdx.x == g) p.lse[(static_cast<long long>(b) * H + g) * N + i] = lse[g];
    }
    if (on) {
      if (p.drop && b != key_b) {
#pragma unroll
        for (int g = 0; g < H; ++g) key[g] = head_key(*p.seed, p.site, b, g);
        key_b = b;
      }
      float pr[H][4];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[h][e] = expf(m[h][e] - lse[h]);   // 0 past the row's end
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const unsigned rk = row_key(key[g], static_cast<unsigned>(i));
        float zo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float z = bw[g];
#pragma unroll
          for (int h = 0; h < H; ++h) z += ww[g * H + h] * pr[h][e];
          const bool keep = !p.drop || keep_col(rk, static_cast<unsigned>(c0 + e), p.thr);
          zo[e] = keep ? z * sc : 0.f;
        }
        store_row4(p.zd + row0 + g * hstride, c0, N, vec, zo);
      }
    }
    row0 = next;
    if (++i == N) {
      i = 0;
      ++b;
    }
  }
}

// th_dq_kernel<HM, V>: dQ = sum_g dq~_g (.) row_g and
// dwl[g, h] = scale * sum over the rows and head h's columns of q (.) dq~_g
// (pallas_block.py:430-438), for H <= HM heads. What bounds it: bytes,
// dq~ (f32, H planes) read once, q (bf16) read once, dQ (f32) written
// once: 34.6 MB at B=8, H=4, N=1024, D=192, 10.3 us at 3.35 TB/s. The
// design:
// - A group of `group` threads per row (b, i), DQ_NT / group rows a block;
//   a thread owns a chunk of V columns (V = 4: one 16-byte load of each
//   head's dq~ and of rows, an 8-byte load of q and a 16-byte store of dQ
//   where the views are aligned, else scalar; V = 1 where dh % 4 != 0), so
//   a chunk lies in one head. A pass takes `group` chunks of every row of
//   the block's run; D / V chunks take ceil(D / V / group) passes.
// - A one-wave grid of blocks (kernels.th_dq_plan), block k over the fixed
//   run of rows [k*run, (k+1)*run); a thread keeps its chunk's H sums of
//   q (.) dq~_g in registers across the rows of a pass, and its chunk's
//   rows (the H fold rows) across the pass.
// - dwl is finished in the same launch in a fixed order: after each pass
//   the block's row slots in order, then thread g*H + h sums the chunks of
//   head h in order through shared memory, into a register over the
//   passes; then a ticket (threadfence, one atomicAdd a block): the last
//   block sums the blocks' rows of ws in index order, its threads
//   splitting the blocks in fixed runs, and resets the ticket. The order
//   depends on the shape alone, so two runs give the same bits. No float
//   atomics, no dynamic shared memory.
constexpr int DQ_NT = 256;
constexpr int DQ_BATCH = 16;   // ws rows a thread of the last block loads at once

template <int V>
__device__ __forceinline__ void load_chunk(const float* src, bool vec, float (&v)[V]) {
  if constexpr (V == 4) {
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src));
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = __ldg(src + e);
}

template <int HM, int V>
__global__ void __launch_bounds__(DQ_NT) th_dq_kernel(THDqParams p) {
  __shared__ float red[DQ_NT * HM];
  __shared__ int last;
  const int H = p.H, N = p.N, D = p.D, HH = H * H;
  const int G = p.group, R = DQ_NT / G;
  const int t = threadIdx.x % G, r = threadIdx.x / G;
  const int chunks = D / V, per_head = D / H / V;
  const bool vec = V == 4 && p.vec;
  const long long BN = static_cast<long long>(p.B) * N;
  const long long m0 = min(BN, blockIdx.x * p.run), m1 = min(BN, m0 + p.run);
  const int k = threadIdx.x;   // the block's (g, h) = (k / H, k % H) for k < H*H
  float hs = 0.f;
  for (int j0 = 0; j0 < chunks; j0 += G) {
    const int j = j0 + t;
    const bool on = r < R && j < chunks;
    float acc[HM];
#pragma unroll
    for (int g = 0; g < HM; ++g) acc[g] = 0.f;
    if (on) {
      const int c = j * V;
      float wr[HM][V];
#pragma unroll
      for (int g = 0; g < HM; ++g) {
        if (g < H) {
          load_chunk<V>(p.rows + g * D + c, vec, wr[g]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) wr[g][e] = 0.f;
        }
      }
      for (long long m = m0 + r; m < m1; m += R) {
        const int mi = static_cast<int>(m), b = mi / N, i = mi - b * N;
        const bf16* qs = p.q + b * p.q_sb + i * p.q_sn + c;
        float qv[V];
        if constexpr (V == 4) {
          if (vec) {
            const uint2 a = __ldg(reinterpret_cast<const uint2*>(qs));
            unpack2(a.x, qv[0], qv[1]);
            unpack2(a.y, qv[2], qv[3]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) qv[e] = bf2f(qs[e]);
          }
        } else {
          qv[0] = bf2f(qs[0]);
        }
        const float* dsrc = p.dqt + (static_cast<long long>(b) * H * N + i) * D + c;
        float dv[HM][V];
#pragma unroll
        for (int g = 0; g < HM; ++g) {
          if (g < H) load_chunk<V>(dsrc + static_cast<long long>(g) * N * D, vec, dv[g]);
        }
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = 0.f;
#pragma unroll
        for (int g = 0; g < HM; ++g) {
          if (g < H) {
            float sq = 0.f;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              o[e] += dv[g][e] * wr[g][e];
              sq += qv[e] * dv[g][e];
            }
            acc[g] += sq;
          }
        }
        float* dst = p.dq + b * p.o_sb + i * p.o_sn + c;
        if (V == 4 && vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) dst[e] = o[e];
        }
      }
#pragma unroll
      for (int g = 0; g < HM; ++g) red[threadIdx.x * HM + g] = acc[g];
    }
    __syncthreads();
    // the pass's sums: each (chunk, g) over the row slots in order, into
    // row slot 0's place (only this thread reads or writes those places)
    const int live = min(G, chunks - j0);
    for (int idx = threadIdx.x; idx < live * H; idx += DQ_NT) {
      const int tc = idx / H, g = idx % H;
      float s = 0.f;
      for (int rr = 0; rr < R; ++rr) s += red[(rr * G + tc) * HM + g];
      red[tc * HM + g] = s;
    }
    __syncthreads();
    // then (g, h) over the chunks of head h in this pass, in order
    if (k < HH) {
      const int g = k / H, h = k % H;
      const int lo = max(h * per_head, j0), hi = min((h + 1) * per_head, j0 + live);
      for (int jj = lo; jj < hi; ++jj) hs += red[(jj - j0) * HM + g];
    }
    __syncthreads();
  }
  // the block's (H, H) sums into its row of ws; the last block sums the rows
  if (k < HH) p.ws[static_cast<long long>(blockIdx.x) * HH + k] = hs;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the blocks in index order: thread slice sl sums blocks [sl*chunk,
  // (sl+1)*chunk) of entry k, DQ_BATCH loads in flight, then thread k the
  // slices in order
  const int slices = DQ_NT / HH;
  const long long nb = gridDim.x, chunk = (nb + slices - 1) / slices;
  if (threadIdx.x < slices * HH) {
    const int kk = threadIdx.x % HH, sl = threadIdx.x / HH;
    const long long b1 = min(nb, (sl + 1) * chunk);
    float s = 0.f;
    for (long long b0 = sl * chunk; b0 < b1; b0 += DQ_BATCH) {
      float v[DQ_BATCH];
#pragma unroll
      for (int q = 0; q < DQ_BATCH; ++q) {
        if (b0 + q < b1) v[q] = __ldcg(p.ws + (b0 + q) * HH + kk);
      }
#pragma unroll
      for (int q = 0; q < DQ_BATCH; ++q) {
        if (b0 + q < b1) s += v[q];
      }
    }
    red[sl * HH + kk] = s;
  }
  __syncthreads();
  if (k < HH) {
    float s = 0.f;
    for (int sl = 0; sl < slices; ++sl) s += red[sl * HH + k];
    p.dwl[k] = p.scale * s;
  }
  if (threadIdx.x == 0) *p.ticket = 0u;
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

// attn_bwd_rows_kernel<U, W>: a group of W warps per row (AB_NT / (32 W)
// rows a block); thread t of a group holds U units of 4 columns, unit k at
// column 4 (t + 32 W k), so one unit of a warp is 512 contiguous bytes of a
// row. s and dzd are read once (16-byte loads where Nk % 4 == 0 and the
// rows are aligned, else scalar), each element's p, keep bit and masked dp
// made once and kept in registers across the row sum rowsum(dp p) (a fixed
// shuffle tree, then the group's warps in order through shared memory);
// zd is stored before the sum, dl after it (8-byte stores where aligned).
constexpr int AB_NT = 256;

template <int U, int W>
__global__ void __launch_bounds__(AB_NT) attn_bwd_rows_kernel(AttnRowParams p) {
  constexpr int G = 32 * W;                   // threads per row
  __shared__ float red[AB_NT / 32];
  const int warp = threadIdx.x / 32, t = threadIdx.x % G;
  const long long row = static_cast<long long>(blockIdx.x) * (AB_NT / G) + threadIdx.x / G;
  const bool live = row < static_cast<long long>(p.Z) * p.Nq;
  if (W == 1 && !live) return;                // W > 1: every thread meets the barrier
  const int Nk = p.Nk;
  const long long o = live ? row * Nk : 0;
  const int z = static_cast<int>(row / p.Nq);
  const unsigned i = static_cast<unsigned>(row % p.Nq);
  const float* kb = p.kbias ? p.kbias + (z / p.H) * p.kb_sb : nullptr;
  const bool drop = p.drop_site != 0;
  const float sc = drop ? p.drop_scale : 1.f;
  const unsigned long long al =
      reinterpret_cast<unsigned long long>(p.s) | reinterpret_cast<unsigned long long>(p.dzd);
  const unsigned long long al2 =
      reinterpret_cast<unsigned long long>(p.zd) | reinterpret_cast<unsigned long long>(p.dl);
  const bool vec = Nk % 4 == 0 && al % 16 == 0 && al2 % 8 == 0;
  const bool kvec = vec && reinterpret_cast<unsigned long long>(kb) % 16 == 0;
  float pr[U][4], dp[U][4];
  float acc = 0.f;
  if (live) {
    const float lse = p.lse[row];
    const unsigned rk =
        drop ? row_key(head_key(*p.seed, p.drop_site, z / p.mask_heads, z % p.mask_heads), i)
             : 0u;
    float sv[U][4], dv[U][4];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int c = 4 * (t + G * k);
      load_row4(p.s + o, c, Nk, vec, sv[k]);
      load_row4(p.dzd + o, c, Nk, vec, dv[k]);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int c = 4 * (t + G * k);
      float kv[4] = {0.f, 0.f, 0.f, 0.f};
      if (kb) load_row4(kb, c, Nk, kvec, kv);
      float zo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = c + e < Nk ? expf(sv[k][e] + kv[e] - lse) : 0.f;
        const bool keep = !drop || keep_col(rk, static_cast<unsigned>(c + e), p.drop_thr);
        zo[e] = keep ? pe * sc : 0.f;
        dp[k][e] = keep ? dv[k][e] * sc : 0.f;
        pr[k][e] = pe;
        acc += dp[k][e] * pe;
      }
      store_row4(p.zd + o, c, Nk, vec, zo);
    }
  }
  float sum = warp_sum(acc);
  if constexpr (W > 1) {
    if (threadIdx.x % 32 == 0) red[warp] = sum;
    __syncthreads();
    const int w0 = warp / W * W;
    sum = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) sum += red[w0 + w];
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < U; ++k) {
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = pr[k][e] * (dp[k][e] - sum);
    store_row4(p.dl + o, 4 * (t + G * k), Nk, vec, d);
  }
}

template <int U, int W>
int launch_attn_bwd(const AttnRowParams* p, long long rows, cudaStream_t s) {
  constexpr int RPB = AB_NT / (32 * W);
  const long long blocks = (rows + RPB - 1) / RPB;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_rows_kernel<U, W><<<static_cast<unsigned>(blocks), AB_NT, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Nk <= 8192: one warp a row with ceil(Nk / 128) units a thread up to
// Nk = 1152 (the class attention's 1045 included), else 2, 4 or 8 warps a
// row with 8 units a thread.
extern "C" int spe_attn_bwd_rows(const AttnRowParams* p, void* stream) {
  const long long rows = static_cast<long long>(p->Z) * p->Nq;
  if (p->Z <= 0 || p->H <= 0 || p->Nq <= 0 || p->Nk <= 0 || p->Nk > 8192 ||
      (p->drop_site && (!p->seed || p->mask_heads <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((p->Nk + 127) / 128) {
    case 1: return launch_attn_bwd<1, 1>(p, rows, s);
    case 2: return launch_attn_bwd<2, 1>(p, rows, s);
    case 3: return launch_attn_bwd<3, 1>(p, rows, s);
    case 4: return launch_attn_bwd<4, 1>(p, rows, s);
    case 5: return launch_attn_bwd<5, 1>(p, rows, s);
    case 6: return launch_attn_bwd<6, 1>(p, rows, s);
    case 7: return launch_attn_bwd<7, 1>(p, rows, s);
    case 8: return launch_attn_bwd<8, 1>(p, rows, s);
    case 9: return launch_attn_bwd<9, 1>(p, rows, s);
    default: break;
  }
  if (p->Nk <= 2048) return launch_attn_bwd<8, 2>(p, rows, s);
  if (p->Nk <= 4096) return launch_attn_bwd<8, 4>(p, rows, s);
  return launch_attn_bwd<8, 8>(p, rows, s);
}

namespace {

template <int W>
int launch_th_fold(const THFoldParams* p, int units, cudaStream_t s) {
  const int rpb = FOLD_NT / (units < FOLD_NT ? units : FOLD_NT);
  const long long slabs = (static_cast<long long>(p->B) * p->N + rpb - 1) / rpb;
  const long long most = static_cast<long long>(FOLD_BLOCKS) * sm_count();
  const unsigned blocks = static_cast<unsigned>(slabs < most ? slabs : most);
  const int smem = p->H * p->D * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        th_fold_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  th_fold_kernel<W><<<blocks, FOLD_NT, smem, s>>>(*p, static_cast<int>(slabs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spe_th_fold(const THFoldParams* p, void* stream) {
  if (p->B <= 0 || p->H <= 0 || p->H > MAXH || p->N <= 0 || p->D <= 0 ||
      static_cast<long long>(p->B) * p->N > 2147483647LL - FOLD_NT ||
      static_cast<long long>(p->H) * p->D * sizeof(float) > FOLD_MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = p->D % 8 == 0 && reinterpret_cast<uintptr_t>(p->q) % 16 == 0 &&
                   p->q_sb % 8 == 0 && p->q_sn % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_th_fold<8>(p, p->D / 8, s) : launch_th_fold<1>(p, p->D, s);
}

namespace {

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
template <int H, bool WL>
int launch_th_bwd_form(const THBwdParams* p, cudaStream_t s) {
  static const int wave = th_wave(th_bwd_rows_kernel<H, WL>);
  const long long rows = static_cast<long long>(p->row.B) * p->row.N;
  const long long per = (rows + wave - 1) / wave;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  const long long width = (WL ? 2 : 1) * H * H + 2 * H;
  if (!p->row.ws || !p->ticket || !p->sums || blocks * width > p->ws_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  th_bwd_rows_kernel<H, WL><<<blocks, TH_NT, 0, s>>>(*p, static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_th_bwd(const THBwdParams* p, cudaStream_t s) {
  return p->row.wl ? launch_th_bwd_form<H, true>(p, s) : launch_th_bwd_form<H, false>(p, s);
}

// the forward's grid: the blocks of one wave (at most TH_BLOCKS), each
// over an equal run of rows
template <int H, bool WL>
int launch_th_fwd_form(const THRowParams* p, cudaStream_t s) {
  static const int wave = th_wave(th_fwd_rows_kernel<H, WL>);
  const long long rows = static_cast<long long>(p->B) * p->N;
  const long long per = (rows + wave - 1) / wave;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  th_fwd_rows_kernel<H, WL><<<blocks, TH_NT, 0, s>>>(*p, static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_th_fwd(const THRowParams* p, cudaStream_t s) {
  return p->wl ? launch_th_fwd_form<H, true>(p, s) : launch_th_fwd_form<H, false>(p, s);
}

template <int H>
int launch_th_rows(const THBwdParams* p, int backward, cudaStream_t s) {
  return backward ? launch_th_bwd<H>(p, s) : launch_th_fwd<H>(&p->row, s);
}

}  // namespace

// the forward (backward == 0) or the backward (backward == 1) row pass,
// both for N <= 4 * TH_NT (a thread's 4 columns of a row), each on a
// one-wave grid. The backward writes its blocks' sums into ws as (blocks,
// width) rows, blocks = ceil(B*N / ceil(B*N / wave)), a function of the
// shape and the card, and their sum into sums in the same launch; launches
// on one stream at a time (they share the ticket).
extern "C" int spe_th_rows(const THBwdParams* p, int backward, void* stream) {
  const THRowParams& r = p->row;
  if (r.B <= 0 || r.H <= 0 || r.H > MAXH || r.N <= 0 || r.N > 4 * TH_NT ||
      static_cast<long long>(r.B) * r.N > 2147483647LL ||
      (r.drop && (!r.seed || r.site <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r.H) {
    case 1: return launch_th_rows<1>(p, backward, s);
    case 2: return launch_th_rows<2>(p, backward, s);
    case 3: return launch_th_rows<3>(p, backward, s);
    case 4: return launch_th_rows<4>(p, backward, s);
    case 5: return launch_th_rows<5>(p, backward, s);
    case 6: return launch_th_rows<6>(p, backward, s);
    case 7: return launch_th_rows<7>(p, backward, s);
    default: return launch_th_rows<8>(p, backward, s);
  }
}

namespace {

template <int HM>
int launch_th_dq(const THDqParams* p, int V, unsigned blocks, cudaStream_t s) {
  if (V == 4) {
    th_dq_kernel<HM, 4><<<blocks, DQ_NT, 0, s>>>(*p);
  } else {
    th_dq_kernel<HM, 1><<<blocks, DQ_NT, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// H <= 16 heads of dh = D / H columns; chunks of 4 columns where dh % 4
// == 0, of 1 otherwise. The grid is ceil(B*N / run) blocks.
extern "C" int spe_th_dq(const THDqParams* p, void* stream) {
  const long long rows = static_cast<long long>(p->B) * p->N;
  if (p->B <= 0 || p->H <= 0 || p->H * p->H > DQ_NT || p->N <= 0 || p->D <= 0 ||
      p->D % p->H != 0 || p->run <= 0 || rows > 2147483647LL || p->group <= 0 ||
      p->group > DQ_NT || !p->ticket || !p->ws || !p->dwl) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (rows + p->run - 1) / p->run;
  const int V = (p->D / p->H) % 4 == 0 ? 4 : 1;
  const uintptr_t al = reinterpret_cast<uintptr_t>(p->dqt) | reinterpret_cast<uintptr_t>(p->rows) |
                       reinterpret_cast<uintptr_t>(p->dq) |
                       static_cast<uintptr_t>((p->o_sb | p->o_sn) * 4);
  const uintptr_t alq = reinterpret_cast<uintptr_t>(p->q) |
                        static_cast<uintptr_t>((p->q_sb | p->q_sn) * 2);
  if (blocks * p->H * p->H > p->ws_size || (p->vec && (V != 4 || al % 16 || alq % 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (p->H <= 4) return launch_th_dq<4>(p, V, grid, s);
  if (p->H <= 8) return launch_th_dq<8>(p, V, grid, s);
  return launch_th_dq<16>(p, V, grid, s);
}

extern "C" int spe_softmax_backward(const SoftmaxBwdParams* p, void* stream) {
  if (p->R <= 0 || p->C <= 0 || p->R > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  softmax_bwd_kernel<<<static_cast<unsigned>(p->R), NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

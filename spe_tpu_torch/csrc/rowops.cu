// Row-wise stages of the fused layers that are not products:
//   layernorm  the LayerNorms that are not a product's prologue: the
//              post-norm LayerNorms of the encoder/decoder layers
//              (spe_tpu/ops/pallas_encoder.py:163,174 and
//              spe_tpu/ops/pallas_decoder.py:247,273,284, eps 1e-5) and
//              the patch and class-attention blocks' backward recompute
//              of their LN outputs (_ln_fwd, spe_tpu/ops/pallas_block.py:63,
//              eps 1e-6);
//   colsum     column sums of the talking-heads v (the bw term below);
//   th_mix     the talking-heads post-softmax H x H mix
//              (spe_tpu/ops/pallas_block.py:143-148). At eval there is no
//              attention dropout, so the op is linear after the softmax:
//                out_j = sum_g ww[j, g] (P_g V)_j + bw_j colsum(V_j)
//              where (P_g V) comes from the attention kernel run once per
//              pre-softmax mixed head g.
// Each reads its inputs once and writes its outputs once, so device memory
// bounds all three. On an H100 at 3.35 TB/s: layernorm moves 6.3-9.4 MB a
// call at the stock step's (8192, 192) and 12.6-25 MB at eval's (16384,
// 192) (0.002-0.008 ms); colsum reads 6.3 MB at the recipe's eval (16,
// 1024, 192) view (0.0019 ms); th_mix reads 50 MB of f32 P_g V and writes
// 6.3 MB there (0.017 ms).
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

struct LNParams {
  const void* x;   // (M, D) rows with stride ldx; bf16 or f32 (x_f32)
  const float* g;
  const float* b;
  float* out_f32;  // optional (M, D) contiguous
  bf16* out_bf16;  // optional (M, D) contiguous
  long long M, ldx;
  int D, x_f32;
  float eps;
  int vec;          // D % 4 == 0, x's rows 8-byte (bf16) or 16-byte (f32)
                    // aligned, g and b 16-byte aligned
  int blocks, run;  // the grid (blocks of LN_NT threads), rows a warp
};

struct ColsumParams {
  const bf16* v;   // element (b, n, c) at b*sb + n*sn + c
  float* out;      // (B, C)
  long long sb, sn;
  int B, N, C;
};

struct MixParams {
  const float* pv;     // (B*N, H, D) f32: row-major, P_g V for every mixed head g
  const float* colsum; // (B, D) contiguous
  const float* ww;     // (H, H) torch Linear layout: out head j uses ww[j*H + g]
  const float* bw;     // (H)
  bf16* out;           // (B*N, D)
  long long rows;      // B*N
  int N, H, D;         // D and D / H multiples of 8, the tensors 16-byte aligned
  int blocks, run;     // the grid (blocks of MIX_NT threads), rows a thread
};

namespace {

// layernorm_kernel replaces the LayerNorms above. What bounds it: the
// bytes of x read once and of the outputs written once, 6.3 MB (bf16 in,
// bf16 out) to 9.4 MB (f32 in) at the stock step's (8192, 192), 0.0019 to
// 0.0028 ms at 3.35 TB/s; a call lasts a few microseconds, so the latency
// and the instructions of its one pass over the rows bound it in practice.
// The design is linear_kernel's LayerNorm panel (linear.cu build_panel):
// one warp a row, lane l holding the 4-column chunks c = 4 l + 128 h (h <
// NC = ceil(D / 128)) in registers, read once with 8-byte (bf16) or
// 16-byte (f32) loads (VEC: D % 4 == 0 and the rows aligned; scalar loads
// and stores otherwise); ln_rows(NC) rows' loads in flight per warp; the
// mean, the centred variance and the normalisation by common.cuh's
// ln_row_stats / ln_apply4, the functions the panel calls, so the bf16
// output equals the panel's bit for bit; gamma and beta loaded once per
// warp; 16-byte f32 and 8-byte bf16 stores; the recipe's D = 192 compiled
// in (KC: the per-element bounds checks resolve at compile time, a fifth
// off a call). One wave of blocks (kernels.layernorm_plan): warp w takes
// rows [w run, (w + 1) run).
constexpr int LN_NT = 256;
constexpr int LN_MAX_NC = 6;   // D <= 768

// rows in flight per warp by chunks a lane, and the blocks a SM must hold
// (the register budget, without local memory): four (64 registers a
// thread) at the recipe's width compiled in (KC = 192), three (85) for
// NC <= 2 otherwise, two (128) above
__host__ __device__ constexpr int ln_rows(int nc) { return nc <= 4 ? 2 : 1; }
__host__ __device__ constexpr int ln_min_blocks(int nc, int kc) {
  return kc ? 4 : nc <= 2 ? 3 : 2;
}

// x's row at `base`, columns c..c+3 (0 past D) as f32
template <bool XF32, bool VEC>
__device__ __forceinline__ void ln_load4(const LNParams& p, long long base, int c,
                                         float (&v)[4]) {
  if constexpr (VEC) {
    if constexpr (XF32) {
      const float4 x = *reinterpret_cast<const float4*>(static_cast<const float*>(p.x) + base + c);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p.x) + base + c);
      unpack2(x.x, v[0], v[1]);
      unpack2(x.y, v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = c + e >= p.D ? 0.f
             : XF32      ? static_cast<const float*>(p.x)[base + c + e]
                         : bf2f(static_cast<const bf16*>(p.x)[base + c + e]);
    }
  }
}

// XF32: x is f32 (else bf16); VEC: whole-chunk loads and stores; KC: the
// width compiled in (0: p.D)
template <int NC, bool XF32, bool VEC, int KC>
__global__ void __launch_bounds__(LN_NT, ln_min_blocks(NC, KC)) layernorm_kernel(LNParams p) {
  constexpr int RG = ln_rows(NC);
  const int lane = threadIdx.x % 32;
  const long long warp = (static_cast<long long>(blockIdx.x) * LN_NT + threadIdx.x) / 32;
  const long long m0 = warp * p.run;
  if (m0 >= p.M) return;
  const long long m1 = min(p.M, m0 + p.run);
  const int K = KC ? KC : p.D;
  const float invK = ln_inv(K);
  float g[NC][4], b[NC][4];
#pragma unroll
  for (int h = 0; h < NC; ++h) {
    const int c = 4 * lane + 128 * h;
    if (VEC && c < K) {
      const float4 gv = *reinterpret_cast<const float4*>(p.g + c);
      const float4 bv = *reinterpret_cast<const float4*>(p.b + c);
      g[h][0] = gv.x;
      g[h][1] = gv.y;
      g[h][2] = gv.z;
      g[h][3] = gv.w;
      b[h][0] = bv.x;
      b[h][1] = bv.y;
      b[h][2] = bv.z;
      b[h][3] = bv.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        g[h][e] = c + e < K ? p.g[c + e] : 0.f;
        b[h][e] = c + e < K ? p.b[c + e] : 0.f;
      }
    }
  }
  for (long long m = m0; m < m1; m += RG) {
    float v[RG][NC][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        const int c = 4 * lane + 128 * h;
        if (m + r < m1 && c < K) {
          ln_load4<XF32, VEC>(p, (m + r) * p.ldx, c, v[r][h]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[r][h][e] = 0.f;
        }
      }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      if (m + r >= m1) break;   // warp-uniform
      float mean, rstd;
      ln_row_stats<NC>(v[r], lane, K, invK, p.eps, mean, rstd);
      const long long o = (m + r) * K;
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        const int c = 4 * lane + 128 * h;
        if (c >= K) continue;
        float(&y)[4] = v[r][h];
        ln_apply4(y, c, K, mean, rstd, g[h], b[h]);
        if constexpr (VEC) {
          if (p.out_f32) {
            *reinterpret_cast<float4*>(p.out_f32 + o + c) = make_float4(y[0], y[1], y[2], y[3]);
          }
          if (p.out_bf16) {
            *reinterpret_cast<uint2*>(p.out_bf16 + o + c) =
                make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e >= K) break;
            if (p.out_f32) p.out_f32[o + c + e] = y[e];
            if (p.out_bf16) p.out_bf16[o + c + e] = f2bf(y[e]);
          }
        }
      }
    }
  }
}

// colsum_kernel replaces the `+ bw_ref[g, 0]` term of the TPU block
// kernel's _attention (spe_tpu/ops/pallas_block.py:147-148), which the
// eval form turns into bw_j colsum(V_j). What bounds it: the bytes of v,
// 6.3 MB at the recipe's (16, 1024, 192) view of qkv (row stride 576):
// 0.0019 ms at 3.35 TB/s, so a call is launch-bound. The design: one
// cluster of CS_CLUSTER blocks per (sample, strip of CS_UNITS units of W
// columns); block k of a cluster sums a contiguous run of ceil(N /
// CS_CLUSTER) rows. A thread owns one unit of W columns (W = 8: one
// 16-byte load a row where the view allows it, W = 1 otherwise) and every
// groups-th row of the run, CS_BATCH rows' loads in flight at once;
// the block's row groups are summed in order through shared memory, and
// block 0 of the cluster sums the CS_CLUSTER partial rows in order through
// distributed shared memory. No workspace, no atomics, one launch: two
// runs give the same bits. 128 blocks of CS_NT threads at the recipe's
// shape, against (C / 128) x B = 32 blocks walking all N rows before.
constexpr int CS_NT = 512;
constexpr int CS_CLUSTER = 8;
constexpr int CS_UNITS = 32;
constexpr int CS_BATCH = 8;

template <int W>
__global__ void __cluster_dims__(CS_CLUSTER, 1, 1) __launch_bounds__(CS_NT)
    colsum_kernel(ColsumParams p) {
  __shared__ float red[CS_NT * W];
  __shared__ float part[CS_UNITS * W];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CS_CLUSTER;
  const int c0 = blockIdx.y * (CS_UNITS * W);
  const int cols = min(CS_UNITS * W, p.C - c0);
  const int units = cols / W;  // W = 8 only where C % 8 == 0
  const int groups = CS_NT / units;
  const int u = threadIdx.x % units, g = threadIdx.x / units;
  const int run = (p.N + CS_CLUSTER - 1) / CS_CLUSTER;
  const int n1 = min(p.N, (rank + 1) * run);
  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
  if (g < groups) {
    const bf16* src = p.v + b * p.sb + c0 + u * W;
    // CS_BATCH rows' loads issued before any is summed, in row order
    for (int n = rank * run + g; n < n1; n += CS_BATCH * groups) {
      uint4 x[CS_BATCH];
#pragma unroll
      for (int k = 0; k < CS_BATCH; ++k) {
        const int m = n + k * groups;
        if (m >= n1) continue;
        const bf16* row = src + m * p.sn;
        if constexpr (W == 8) {
          x[k] = *reinterpret_cast<const uint4*>(row);
        } else {
          x[k].x = *reinterpret_cast<const unsigned short*>(row);
        }
      }
#pragma unroll
      for (int k = 0; k < CS_BATCH; ++k) {
        if (n + k * groups >= n1) continue;
        if constexpr (W == 8) {
          float f[8];
          unpack2(x[k].x, f[0], f[1]);
          unpack2(x[k].y, f[2], f[3]);
          unpack2(x[k].z, f[4], f[5]);
          unpack2(x[k].w, f[6], f[7]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += f[e];
        } else {
          acc[0] += __uint_as_float(x[k].x << 16);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) red[g * cols + u * W + e] = acc[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += CS_NT) {
    float s = 0.f;
    for (int r = 0; r < groups; ++r) s += red[r * cols + c];
    part[c] = s;
  }
  cluster.sync();  // every block's partial row is written
  if (rank == 0) {
    for (int c = threadIdx.x; c < cols; c += CS_NT) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < CS_CLUSTER; ++r) s += cluster.map_shared_rank(part, r)[c];
      p.out[static_cast<long long>(b) * p.C + c0 + c] = s;
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

// th_mix_kernel replaces the post-softmax mix of the TPU block kernel's
// _attention (spe_tpu/ops/pallas_block.py:143-148) in its eval form. What
// bounds it: the bytes of pv read once (50 MB f32 at eval's (16, 1024, 4,
// 192)) and of out written once (6.3 MB bf16), 0.017 ms at 3.35 TB/s; H
// FMAs an output element. The design: a thread owns one unit of 8 columns
// of a row (dh % 8 == 0: a unit lies in one head; two 16-byte loads a head
// and one 16-byte store) and walks a contiguous run of rows with that
// unit, so its head's ww[j, 0..H) and bw[j] are loaded once into registers
// and the index math is done once; mix_rows(HB) rows' loads in flight;
// colsum[b] reloaded only when the run crosses into the next sample. One
// wave of blocks (kernels.th_mix_plan): thread t of the grid takes unit
// t % (D / 8) of rows [(t / (D / 8)) run, ... + run). Each sum
// keeps the first design's order, g = 0..H-1 by FMA, then + bw colsum, and
// so its bits.
constexpr int MIX_NT = 256;

__host__ __device__ constexpr int mix_rows(int hb) { return hb <= 4 ? 2 : 1; }

// 8 f32 from 16-byte-aligned memory
__device__ __forceinline__ void mix_load(const float* src, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 c = *reinterpret_cast<const float4*>(src + 4);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = c.x;
  x[5] = c.y;
  x[6] = c.z;
  x[7] = c.w;
}

// HB: H rounded up to 4, 8 or 16 (the heads past H are skipped)
template <int HB>
__global__ void __launch_bounds__(MIX_NT) th_mix_kernel(MixParams p) {
  constexpr int R = mix_rows(HB), W = 8;
  const int U = p.D / W;
  const int t = blockIdx.x * MIX_NT + threadIdx.x;
  const int slot = t / U, c = (t - slot * U) * W;
  const long long r0 = static_cast<long long>(slot) * p.run;
  if (r0 >= p.rows) return;
  const long long r1 = min(p.rows, r0 + p.run);
  const int H = p.H, D = p.D;
  const int j = c / (D / H);
  float ww[HB];
#pragma unroll
  for (int g = 0; g < HB; ++g) ww[g] = g < H ? p.ww[j * H + g] : 0.f;
  const float bw = p.bw[j];
  long long b = r0 / p.N;          // the sample of row r0, and where it ends
  long long next = (b + 1) * p.N;
  float cs[W];
  mix_load(p.colsum + b * D + c, cs);
  const long long hd = static_cast<long long>(H) * D;
  for (long long r = r0; r < r1; r += R) {
    float x[R][HB][W];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (r + k >= r1) break;
      const float* src = p.pv + (r + k) * hd + c;
#pragma unroll
      for (int g = 0; g < HB; ++g) {
        if (g < H) mix_load(src + g * D, x[k][g]);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (r + k >= r1) break;
      if (r + k >= next) {
        ++b;
        next += p.N;
        mix_load(p.colsum + b * D + c, cs);
      }
      float s[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        s[e] = 0.f;
#pragma unroll
        for (int g = 0; g < HB; ++g) {
          if (g < H) s[e] = __fmaf_rn(ww[g], x[k][g][e], s[e]);
        }
        s[e] = __fmaf_rn(bw, cs[e], s[e]);
      }
      *reinterpret_cast<uint4*>(p.out + (r + k) * D + c) =
          make_uint4(pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]), pack_bf16(s[4], s[5]),
                     pack_bf16(s[6], s[7]));
    }
  }
}

}  // namespace

template <bool XF32, bool VEC, typename F>
cudaError_t ln_dispatch_nc(int D, F&& f) {
  switch ((D + 127) / 128) {
    case 1: return f(layernorm_kernel<1, XF32, VEC, 0>);
    case 2:
      return VEC && D == 192 ? f(layernorm_kernel<2, XF32, VEC, 192>)
                             : f(layernorm_kernel<2, XF32, VEC, 0>);
    case 3: return f(layernorm_kernel<3, XF32, VEC, 0>);
    case 4: return f(layernorm_kernel<4, XF32, VEC, 0>);
    case 5: return f(layernorm_kernel<5, XF32, VEC, 0>);
    case 6: return f(layernorm_kernel<6, XF32, VEC, 0>);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t ln_dispatch(int D, int x_f32, int vec, F&& f) {
  if (x_f32) return vec ? ln_dispatch_nc<true, true>(D, f) : ln_dispatch_nc<true, false>(D, f);
  return vec ? ln_dispatch_nc<false, true>(D, f) : ln_dispatch_nc<false, false>(D, f);
}

extern "C" int spe_layernorm(const LNParams* p, void* stream) {
  const int es = p->x_f32 ? 4 : 2;
  const unsigned long long al = reinterpret_cast<unsigned long long>(p->x) |
                                static_cast<unsigned long long>(p->ldx * es);
  const unsigned long long ol = reinterpret_cast<unsigned long long>(p->out_f32) |
                                reinterpret_cast<unsigned long long>(p->out_bf16) |
                                reinterpret_cast<unsigned long long>(p->g) |
                                reinterpret_cast<unsigned long long>(p->b);
  if (p->M <= 0 || p->D <= 0 || p->D > 128 * LN_MAX_NC || p->blocks <= 0 || p->run <= 0 ||
      static_cast<long long>(p->blocks) * (LN_NT / 32) * p->run < p->M ||
      (p->vec && (p->D % 4 != 0 || al % (4 * es) != 0 || ol % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = ln_dispatch(p->D, p->x_f32, p->vec, [&](auto kernel) {
    kernel<<<p->blocks, LN_NT, 0, static_cast<cudaStream_t>(stream)>>>(*p);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// the blocks of one wave of the layernorm_kernel that spe_layernorm runs:
// the blocks a SM holds at once (the occupancy query) times the SMs
extern "C" int spe_layernorm_wave(int D, int x_f32, int vec, int* blocks) {
  if (D <= 0 || D > 128 * LN_MAX_NC || !blocks) return static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = ln_dispatch(D, x_f32, vec, [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, LN_NT, 0);
  });
  *blocks = n * sm_count();
  return static_cast<int>(err);
}

extern "C" int spe_colsum(const ColsumParams* p, void* stream) {
  const bool vec = p->C % 8 == 0 && reinterpret_cast<uintptr_t>(p->v) % 16 == 0 &&
                   p->sb % 8 == 0 && p->sn % 8 == 0;
  const int tile = CS_UNITS * (vec ? 8 : 1);
  const long long strips = (p->C + tile - 1) / tile;
  if (p->B <= 0 || p->C <= 0 || p->N < 0 ||
      static_cast<long long>(p->B) * CS_CLUSTER > 2147483647LL || strips > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(p->B * CS_CLUSTER, static_cast<unsigned>(strips));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    colsum_kernel<8><<<grid, CS_NT, 0, s>>>(*p);
  } else {
    colsum_kernel<1><<<grid, CS_NT, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
cudaError_t mix_dispatch(int H, F&& f) {
  if (H <= 0 || H > 16) return cudaErrorInvalidValue;
  return H <= 4 ? f(th_mix_kernel<4>) : H <= 8 ? f(th_mix_kernel<8>) : f(th_mix_kernel<16>);
}

extern "C" int spe_th_mix(const MixParams* p, void* stream) {
  const unsigned long long al = reinterpret_cast<unsigned long long>(p->pv) |
                                reinterpret_cast<unsigned long long>(p->colsum) |
                                reinterpret_cast<unsigned long long>(p->out);
  if (p->rows <= 0 || p->N <= 0 || p->D <= 0 || p->H <= 0 || p->D % p->H != 0 ||
      (p->D / p->H) % 8 != 0 || al % 16 != 0 || p->blocks <= 0 || p->run <= 0 ||
      static_cast<long long>(p->blocks) * MIX_NT / (p->D / 8) * p->run < p->rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = mix_dispatch(p->H, [&](auto kernel) {
    kernel<<<p->blocks, MIX_NT, 0, static_cast<cudaStream_t>(stream)>>>(*p);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// the blocks of one wave of th_mix_kernel for H heads, as spe_layernorm_wave
extern "C" int spe_th_mix_wave(int H, int* blocks) {
  if (!blocks) return static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = mix_dispatch(H, [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, MIX_NT, 0);
  });
  *blocks = n * sm_count();
  return static_cast<int>(err);
}

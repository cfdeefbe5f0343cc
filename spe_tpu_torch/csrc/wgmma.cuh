// The shared mainloop of the port's two product kernels, gemm_kernel
// (grad.cu) and linear_kernel (linear.cu), written for Hopper:
// - a ring of STAGES stages in shared memory, each holding a 64-deep bf16
//   k tile of both operands in the 128-byte-swizzled layout that wgmma
//   reads through its descriptors (an operand keeps its global contiguous
//   index contiguous: K-major [rows][64 k], or MN-major [64 k][mn], in
//   blocks of 64 mn);
// - one producer warpgroup: its first thread keeps TMA tile loads in
//   flight, each completing on the stage's `full` mbarrier; operands TMA
//   cannot read go through the warpgroup's registers (route REG); f32
//   operands arrive by TMA into an f32 staging tile of the stage (route
//   F32);
// - one or two consumer warpgroups: they round a stage's f32 staging tiles
//   into its bf16 tiles (while the previous k tile's products run), then
//   issue wgmma.mma_async m64nNk16 (bf16 in, f32 accumulators in
//   registers), and release the stage on its `empty` mbarrier once the
//   products that read it are done.
// The routes are chosen from the shapes and strides before the launch
// (kernels.gemm_plan / linear_plan); the C entry points refuse a TMA route
// whose alignment the tensor map cannot express.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace wg {

constexpr int BK = 64;          // depth of a k tile: one 128-byte swizzle row of bf16
constexpr int MAX_STAGES = 6;
constexpr int SMEM_MAX = 232448;      // a block's shared memory
constexpr int SMEM_PER_SM = 233472;   // a SM's, 1 KB of it reserved per block
// the routes of a ring operand (kernels.ROUTE_*)
enum Route { TMA = 0, F32 = 1, REG = 2 };

// this thread's warpgroup, as a value the compiler knows is the same
// across the warp (so a branch on it is not divergent around wgmma)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---- mbarriers, proxies, named barriers ----
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// an arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of the given parity has completed; a phase that
// has not completed 10 s after the wait began (a fault in the ring's
// protocol, never a slow load) traps, so the launch fails instead of
// holding the card
__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, tries = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (++tries % 4096 == 0) {
      const uint64_t now = globaltimer();
      if (!t0) {
        t0 = now;
      } else if (now - t0 > 10000000000ULL) {
        __trap();
      }
    }
  }
}

// this thread's generic-proxy writes to shared memory become visible to
// the async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- TMA: a box of a 4-d tensor map into shared memory ----
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// ---- wgmma ----
// The descriptor of a 128-byte-swizzled operand tile at shared address
// `addr` (1024-aligned but for the 32-byte k16 steps of a K-major tile):
// 8-row groups 1024 bytes apart (SBO); `lbo`: the distance between blocks
// of 64 mn of an MN-major tile (unused for K-major ones).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ULL << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (m64n64, f32) = A . B + (scale_d ? d : 0), A and B bf16 in shared
// memory through their descriptors; TA / TB: the operand is MN-major
// (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (m64n128, f32) = A . B + (scale_d ? d : 0), likewise
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


// one m64nBNk16 product of the warpgroup
template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  static_assert(BN == 64 || BN == 128, "wgmma width");
  if constexpr (BN == 64) {
    wgmma_m64n64<TA, TB>(d, da, db, scale_d);
  } else {
    wgmma_m64n128<TA, TB>(d, da, db, scale_d);
  }
}

// ---- the swizzled operand tiles ----
// byte offset of element (r, c) of an R x C bf16 tile: blocks of 64
// contiguous elements (128 bytes a row), each R rows; inside a block the
// 16-byte chunk index is XORed with the row mod 8 (TMA's SWIZZLE_128B,
// which is what wgmma's 128-byte layout reads)
__device__ __forceinline__ uint32_t swz(int r, int c, int R) {
  return static_cast<uint32_t>((c >> 6) * R * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                               ((c & 7) << 1));
}

// The producer warpgroup's fill of one R x C tile through registers
// (route REG): element (r, c) is src at (r0 + r, c0 + c), zero outside
// its rows and cols; units of 4 consecutive c, all of a thread's loads in
// flight (in batches of 8 units, so that the warpgroup's registers hold
// them beside its operands' state) before they are rounded and stored.
// ELEMS = R * C.
template <int ELEMS>
__device__ __forceinline__ void reg_fill(const Src& s, long long r0, long long c0, int R, int C,
                                         unsigned char* tile, int t) {
  constexpr int UNITS = ELEMS / (4 * 128);
  constexpr int BATCH = UNITS < 8 ? UNITS : 8;   // loads in flight at once
  static_assert(UNITS % BATCH == 0 && UNITS * 4 * 128 == ELEMS,
                "the tile does not divide among 128 threads");
  const int cu = C / 4;
#pragma unroll 1
  for (int i0 = 0; i0 < UNITS; i0 += BATCH) {
    unsigned raw[BATCH][4];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = t + (i0 + i) * 128;
      const int r = e / cu, c = (e % cu) * 4;
      const long long gr = r0 + r, gc = c0 + c;
      raw[i][0] = raw[i][1] = raw[i][2] = raw[i][3] = 0u;
      if (gr >= s.rows) continue;
      const long long base = gr * s.rs;
      if (s.mode != 2 && gc + 4 <= s.cols) {
        if (s.f32) {
          const float4 v =
              *reinterpret_cast<const float4*>(static_cast<const float*>(s.ptr) + base + gc);
          raw[i][0] = __float_as_uint(v.x);
          raw[i][1] = __float_as_uint(v.y);
          raw[i][2] = __float_as_uint(v.z);
          raw[i][3] = __float_as_uint(v.w);
        } else {
          const uint2 v =
              *reinterpret_cast<const uint2*>(static_cast<const bf16*>(s.ptr) + base + gc);
          raw[i][0] = v.x;
          raw[i][1] = v.y;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (gc + q < s.cols) {
            const long long off = base + (gc + q) * s.cs;
            if (s.f32) {
              raw[i][q] = __float_as_uint(static_cast<const float*>(s.ptr)[off]);
            } else {
              const unsigned u = static_cast<const unsigned short*>(s.ptr)[off];
              raw[i][q / 2] |= u << (16 * (q % 2));
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = t + (i0 + i) * 128;
      const int r = e / cu, c = (e % cu) * 4;
      uint2 w;
      if (s.f32) {
        w.x = pack_bf16(__uint_as_float(raw[i][0]), __uint_as_float(raw[i][1]));
        w.y = pack_bf16(__uint_as_float(raw[i][2]), __uint_as_float(raw[i][3]));
      } else {
        w.x = raw[i][0];
        w.y = raw[i][1];
      }
      *reinterpret_cast<uint2*>(tile + swz(r, c, R)) = w;
    }
  }
}

// The consumer warpgroups' rounding of an f32 staging tile (R x C, rows
// of C, as TMA wrote it unswizzled) into the R x C bf16 tile (route F32):
// thread t of NT takes every NT-th unit of 4 values. ELEMS = R * C.
template <int ELEMS, int NT>
__device__ __forceinline__ void convert_f32(const float* stage, int R, int C, unsigned char* tile,
                                            int t) {
  constexpr int UNITS = ELEMS / (4 * NT);
  static_assert(UNITS * 4 * NT == ELEMS, "the tile does not divide among the threads");
  const int cu = C / 4;
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int e = t + i * NT;
    const int r = e / cu, c = (e % cu) * 4;
    const float4 v = *reinterpret_cast<const float4*>(stage + r * C + c);
    *reinterpret_cast<uint2*>(tile + swz(r, c, R)) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// One operand of the ring as the producer sees it. km: K-major (the tile
// is [mn][64 k], R = the tile's mn extent, C = 64), else MN-major ([64
// k][mn], R = 64, C = the mn extent). The map's coordinates are
// (contiguous, row, z2, z1); kbase offsets k (a split product's chunk).
struct RingOperand {
  const CUtensorMap* map;
  Src src;            // route REG: at the block's batch offset
  int route;
  bool km;
  int R, C;
  uint32_t off, soff; // byte offsets in a stage of the bf16 tile and the f32 staging
  int mn0, z2, z1, kbase;
  long long sr0, sc0; // route REG: the tile origin in src's (row, col) at k tile 0
};

// TMA loads of k tile kt of operand o into the stage at `stage`, onto
// `full` (bf16 into its tile, f32 into its staging tile). The boxes were
// encoded on the host: bf16 K-major (64, R), bf16 MN-major (64, 64), f32
// K-major (64, R), f32 MN-major (C, 64).
__device__ __forceinline__ void tma_operand(const RingOperand& o, uint32_t stage, int kt,
                                            uint32_t full) {
  const int k0 = o.kbase + kt * BK;
  if (o.route == TMA) {
    if (o.km) {
      tma_load(stage + o.off, o.map, full, k0, o.mn0, o.z2, o.z1);
    } else {
      for (int q = 0; q < o.C / 64; ++q) {
        tma_load(stage + o.off + q * BK * 128, o.map, full, o.mn0 + 64 * q, k0, o.z2, o.z1);
      }
    }
  } else if (o.route == F32) {
    if (o.km) {
      tma_load(stage + o.soff, o.map, full, k0, o.mn0, o.z2, o.z1);
    } else {
      tma_load(stage + o.soff, o.map, full, o.mn0, k0, o.z2, o.z1);
    }
  }
}

__device__ __forceinline__ uint32_t tma_bytes(const RingOperand& o) {
  return o.route == TMA ? static_cast<uint32_t>(o.R * o.C * 2)
                        : o.route == F32 ? static_cast<uint32_t>(o.R * o.C * 4) : 0u;
}

// The ring's barriers: full[s], then empty[s] (8 bytes each)
struct Ring {
  uint32_t base;        // stage 0, 1024-aligned
  uint32_t stage_bytes;
  uint32_t bars;        // full[0..S), then empty
  int S;
  __device__ __forceinline__ uint32_t stage(int t) const { return base + (t % S) * stage_bytes; }
  __device__ __forceinline__ uint32_t full(int t) const { return bars + 8 * (t % S); }
  __device__ __forceinline__ uint32_t empty(int t) const { return bars + 8 * (S + t % S); }
  __device__ __forceinline__ uint32_t parity(int t) const { return (t / S) & 1; }
};

// thread 0: the ring's barriers. full: the producer's first thread (its
// expect_tx) and, when an operand is filled through registers, the
// producer warpgroup's 128 threads; empty: lane 0 of each consumer warp.
__device__ __forceinline__ void ring_init(const Ring& g, bool threads_fill, int consumer_warps) {
  for (int s = 0; s < g.S; ++s) {
    mbar_init(g.bars + 8 * s, 1 + (threads_fill ? 128 : 0));
    mbar_init(g.bars + 8 * (g.S + s), consumer_warps);
  }
}

// The producer warpgroup (thread t of 128) over the ring's k tiles i =
// 0, 1, ...: the first thread waits for a stage to be free and issues its
// TMA loads; an operand of route REG is then loaded by the whole
// warpgroup. `next(i, a, b, kt)` points the operands at k tile i (their
// origins, at an output tile's first k tile), sets its k tile kt and
// returns false past the block's last.
template <int ELEMS_A, int ELEMS_B, typename Next>
__device__ __forceinline__ void produce(const Ring& g, RingOperand& a, RingOperand& b, bool has_a,
                                        int t, unsigned char* smem_base, Next next) {
  const bool reg_a = has_a && a.route == REG, reg_b = b.route == REG;
  if (!reg_a && !reg_b && t != 0) return;
  const uint32_t txb = (has_a ? tma_bytes(a) : 0u) + tma_bytes(b);
  int kt = 0;
  for (int i = 0; next(i, a, b, kt); ++i) {
    mbar_wait(g.empty(i), g.parity(i) ^ 1);
    if (t == 0) {
      if (txb) {
        mbar_expect_tx(g.full(i), txb);
      } else {
        mbar_arrive(g.full(i));
      }
      if (has_a) tma_operand(a, g.stage(i), kt, g.full(i));
      tma_operand(b, g.stage(i), kt, g.full(i));
    }
    if (reg_a || reg_b) {
      unsigned char* st = smem_base + (g.stage(i) - g.base);
      const long long dk = static_cast<long long>(kt) * BK;
      if (reg_a) {
        reg_fill<ELEMS_A>(a.src, a.sr0 + (a.km ? 0 : dk), a.sc0 + (a.km ? dk : 0), a.R, a.C,
                          st + a.off, t);
      }
      if (reg_b) {
        reg_fill<ELEMS_B>(b.src, b.sr0 + (b.km ? 0 : dk), b.sc0 + (b.km ? dk : 0), b.R, b.C,
                          st + b.off, t);
      }
      fence_proxy_async();
      mbar_arrive(g.full(i));
    }
  }
}

// A consumer warpgroup's products of one k tile: four k16 steps of
// m64nBN from the A tile at `ta` (this warpgroup's 64 rows) and the B
// tile at `tb` (zero past the depth); K-major tiles step 32 bytes a k16,
// MN-major ones 16 rows (2048 bytes). The first k tile of an output tile
// overwrites the accumulators (wgmma's scale-d 0): they are never set by
// other instructions, which would make ptxas serialize the products.
template <int BN, bool A_KM, bool B_KM>
__device__ __forceinline__ void mma_tile(float (&acc)[BN / 2], uint32_t ta, uint32_t tb,
                                         bool first) {
  constexpr uint32_t SA = A_KM ? 32 : 2048, SB = B_KM ? 32 : 2048;
  constexpr uint32_t LA = A_KM ? 16 : BK * 128, LB = B_KM ? 16 : BK * 128;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_bf16<BN, A_KM ? 0 : 1, B_KM ? 0 : 1>(acc, desc(ta + j * SA, LA), desc(tb + j * SB, LB),
                                              j > 0 || !first);
  }
  wgmma_commit();
  fence_acc(acc);
}

// The accumulators of warpgroup w (rows 64w..) into an f32 C tile of row
// stride LDC, times alpha: element (r, c) of m64nBN's fragment
template <int BN>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[BN / 2], float* Cs, int LDC,
                                            float alpha) {
  const int w = warpgroup(), q = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = 64 * w + 16 * q + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(Cs + r0 * LDC + c) =
        make_float2(alpha * acc[4 * j], alpha * acc[4 * j + 1]);
    *reinterpret_cast<float2*>(Cs + (r0 + 8) * LDC + c) =
        make_float2(alpha * acc[4 * j + 2], alpha * acc[4 * j + 3]);
  }
}

// The ring's stages (host): as many as `fixed` bytes (the rest of the
// block's shared memory) leave room for, at most MAX_STAGES and one a k
// tile (nk); a 64-row tile (two_blocks) takes at most the stages that
// keep two blocks on a SM, where two stages fit, so that one block's
// epilogue runs beside the other's products. The ring may double as the
// f32 C tile (`overlay` bytes, gemm_kernel's), 0 if the C tile is apart.
inline int ring_stages(unsigned stage_bytes, unsigned overlay, unsigned fixed, long long nk,
                       bool two_blocks) {
  const long long barriers = 16LL * MAX_STAGES + 8;
  auto fit = [&](long long room) {
    const long long S = (room - 1024 - barriers - fixed) / stage_bytes;
    return std::min<long long>({S, static_cast<long long>(MAX_STAGES), std::max(nk, 1LL)});
  };
  if (two_blocks) {
    const long long half = SMEM_PER_SM / 2 - 1024;
    const long long S = fit(half);
    const long long used = 1024 + barriers + fixed + std::max<long long>(S * stage_bytes, overlay);
    if (S >= std::min(2LL, std::max(nk, 1LL)) && used <= half) return static_cast<int>(S);
  }
  return static_cast<int>(std::max(1LL, fit(SMEM_MAX)));
}

}  // namespace wg

// ---- host: tensor maps ----
namespace wg_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda), once
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA's rule: a 16-byte aligned base and strides that are positive
// multiples of 16 bytes below 2^40 (kernels.tma_ok states the same)
inline bool tma_stride(long long bytes) { return bytes > 0 && bytes % 16 == 0 && bytes < (1LL << 40); }

// A 4-d map of (contiguous, rows, z2, z1) elements of `es` bytes with the
// given byte strides of dims 1-3 (a dim of size 1 takes the row stride),
// box (b0, b1, 1, 1); bf16 boxes 128-byte swizzled (b0 = 64), f32 ones
// unswizzled. Returns false where the rule refuses it.
inline bool encode(CUtensorMap* map, const void* base, int es, const long long (&dims)[4],
                   long long (&strides)[3], int b0, int b1) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || !tma_stride(strides[0])) return false;
  for (int i = 1; i < 3; ++i) {
    if (dims[i + 1] <= 1) strides[i] = strides[0];
    if (!tma_stride(strides[i])) return false;
  }
  for (int i = 0; i < 4; ++i) {
    if (dims[i] < 1 || dims[i] > (1LL << 32)) return false;
  }
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t gd[4] = {static_cast<cuuint64_t>(dims[0]), static_cast<cuuint64_t>(dims[1]),
                            static_cast<cuuint64_t>(dims[2]), static_cast<cuuint64_t>(dims[3])};
  const cuuint64_t gs[3] = {static_cast<cuuint64_t>(strides[0]), static_cast<cuuint64_t>(strides[1]),
                            static_cast<cuuint64_t>(strides[2])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1u, 1u};
  const cuuint32_t one[4] = {1u, 1u, 1u, 1u};
  const bool f32 = es == 4;
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), gd, gs, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg_host

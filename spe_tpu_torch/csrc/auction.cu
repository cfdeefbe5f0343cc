// Batched forward-auction assignment (kernel 6 of the port).
//
// Replaces the TPU kernel spe_tpu/ops/pallas_auction.py:123
// `auction_phase_pallas` (pallas_call :156, body `_auction_kernel`
// :49-118), which runs the bidding fixpoint of
// spe_tpu/ops/assignment.py `_auction_phase` (:31-86) for every matching
// problem of a training step at once (S*L*B = 96 problems of 120 persons x
// 300 objects at the voc0712 recipe).
//
// One iteration, exactly as `_auction_phase` does it in f32 (Jacobi: every
// bid is made against the previous iteration's prices):
//   1. every unassigned valid person t takes values = benefit[t] - price,
//      its best object j = argmax (the FIRST index on ties) and the second
//      value top2 = max over the other objects (floored at -1e30), and bids
//      (benefit[t, j] - top2) + eps on j;
//   2. every object takes its highest bid, the LOWEST person index on ties:
//      a 64-bit atomicMax in shared memory over (order-preserving float
//      bits of the bid, ~person) gives exactly that;
//   3. each won object's previous owner drops to -1, the winner takes the
//      object, the object's price becomes the bid.
// The loop stops when the unassigned valid persons are no more than the
// excess over the objects (n_over), or after max_iters iterations, and
// writes each problem's own iteration and bid counts: the vmapped
// while_loop's per-problem semantics. Assignments (-1 unassigned, -2 padded
// person), iterations and bids equal the plain version's bit for bit.
//
// What bounds it on the H100: not device memory. Only the valid persons'
// rows are read, once: 9990 of the 11520 rows of kernel_checks'
// `auction_problems()` (96 x 120 x 300), 12.0 MB, 3.6 us at 3.35 TB/s, and
// far fewer in a real step, where an image has a few pseudo-boxes. Nor
// arithmetic (3 operations a bid and object). A problem is a chain of a few
// hundred short iterations (330 for the slowest of `auction_problems()`,
// whose persons are 5x near-duplicates that bid up the same objects eps at
// a time), and the blocks of different problems run side by side, so the
// launch takes as long as the latency of the slowest problem's chain.
//
// Design: one block of AU_NT = 1024 threads a problem (96 problems: one
// wave on 132 SMs), the state in shared memory, at most two barriers an
// iteration and no pass over all Q objects in one.
//   - The load: the valid persons' rows only, each by one TMA bulk copy
//     (cp.async.bulk, where Q * 4 is a multiple of 16 and the rows 16-byte
//     aligned; plain loads otherwise), completing on one mbarrier for each
//     32 persons: the first iteration (every price 0) starts on a person's
//     row as soon as its group has landed. Rows that do not fit in shared
//     memory beside the state are read from device memory (MODE 0).
//   - A bid, one warp a person (warp_bid): each lane keeps its best value
//     v1, its index i1 and its second value v2 over its objects (16-byte
//     loads of 4 consecutive objects of benefit and price; the prices run
//     on at +inf to a multiple of 128 objects, so every lane scans the same
//     count and the padding is never chosen), then three redux
//     instructions, exact integer reductions: the best key
//     (__reduce_max_sync of the float's order-preserving bits, -0 keyed as
//     +0 as the float compare takes it), the first index among the lanes
//     at that key (__reduce_min_sync) and top2 (__reduce_max_sync of v2 in
//     the lane that holds that index, v1 elsewhere).
//   - A. While there are more bidders than warps (the first iteration,
//     overfull problems): every warp ballots the 16-bit `asg` of the
//     persons, 4 groups of 32 at a time, and takes the bidders of rank w,
//     w + 32, ...; the lane holding the object bids (atomicMax) and notes
//     the object in `choice`. Barrier 1; then the thread of each person
//     that bid reads its object's word, and if the word holds its index,
//     takes the object (the owner back to -1, owner, price, its `asg`) and
//     clears the word. A displaced owner did not bid, so no two winners
//     write one person, and every word bid on has a winner, so the words
//     are all 0 again. Barrier 2 is __syncthreads_count(won a free object):
//     the unassigned count falls by exactly that.
//   - B. Once the bidders fit the warps (the count never grows again),
//     warp w keeps its bidder in a register: no ballots. It bids and reads
//     its object's owner before barrier 1 (only that object's winner
//     changes it), then its own word: a winner updates its object and, if
//     it displaced an owner, bids for that owner next; a loser bids again.
//   - C. The last unassigned person (no excess over the objects) always
//     wins: its warp runs the remaining iterations alone, with no barrier,
//     each win over an owner handing the turn to that owner. In the
//     contested problems this is the long tail: 186 of the slowest
//     problem's 330 iterations.
// The chain of an iteration, from clock() stamps of the slowest problem of
// `auction_problems()` on the H100 (PERF.md §6): in B ~1700 cycles
// (a bid ~900, up to ~1400 when 8-32 warps bid at once and share the four
// schedulers; the 64-bit atomic, a CAS loop, and the owner ~210; the
// update ~260; two barriers), in C ~680 (a bid ~530: 12 dependent compare
// steps, then the three dependent redux). The first design, with A's
// ballots and pass every iteration, took ~2700.
#include <stdint.h>

#include "common.cuh"

#define AUCTION_NEG (-1e30f)

constexpr int AU_NT = 1024;   // threads a block: 32 warps, one block a problem
constexpr int AU_SMEM = 227 * 1024;

struct AuctionParams {
  const float* benefit;   // (P, T, Q) contiguous, f32
  const uint8_t* mask;    // (P, T) contiguous, nonzero = valid person
  int* assigned;          // (P, T) object per person, -1 unassigned, -2 padded
  int* iters;             // (P,) iterations run on each problem
  int* bids;              // (P,) bids evaluated on each problem (sum over
                          // iterations of the unassigned valid persons)
  int P, T, Q, max_iters;
  float eps;
};

// Byte offsets of the shared state. MODE 0: the rows stay in device memory;
// 1: rows in shared memory, copied by plain loads; 2: by TMA bulk copies.
struct AuctionLayout {
  size_t word, rows, price, bar, owner, asg, choice, total;
};

// Rows in shared memory are Qs = Q rounded up to 4 floats apart; the prices
// run on to Qp = Q rounded up to 128, at +inf, so that every lane scans the
// same number of 16-byte groups (past a row's end it reads the next row or
// the prices: any value less +inf is never chosen and never top2).
__host__ __device__ inline int auction_qs(int Q, int mode) { return mode ? (Q + 3) / 4 * 4 : Q; }
__host__ __device__ inline int auction_qp(int Q, int mode) { return mode ? (Q + 127) / 128 * 128 : Q; }

__host__ __device__ inline size_t auction_align16(size_t b) { return (b + 15) / 16 * 16; }

// Every region starts on a 16-byte boundary, whatever T and Q: the 64-bit
// bid words and mbarriers, the rows' bulk copies and the 16-byte loads of
// rows and prices all need their alignment.
__host__ __device__ inline AuctionLayout auction_layout(int T, int Q, int mode) {
  AuctionLayout l;
  l.word = 0;
  l.rows = auction_align16(sizeof(unsigned long long) * Q);
  l.price = l.rows + (mode ? sizeof(float) * T * auction_qs(Q, mode) : 0);
  l.bar = auction_align16(l.price + sizeof(float) * auction_qp(Q, mode));
  l.owner = auction_align16(l.bar + (mode == 2 ? sizeof(unsigned long long) * ((T + 31) / 32) : 0));
  l.asg = auction_align16(l.owner + sizeof(int) * Q);
  l.choice = auction_align16(l.asg + sizeof(short) * T);
  l.total = l.choice + sizeof(short) * T;
  return l;
}

// float -> uint32 whose unsigned order is the float order
__device__ __forceinline__ uint32_t float_key(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// BYTES (a multiple of 16) from 16-byte aligned global memory into shared
// memory, counted on the mbarrier at `bar`
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one object's value v into a lane's best value v1, its index i1 and the
// second value v2, objects in increasing order: the first index keeps a
// tie; a NaN changes nothing
__device__ __forceinline__ void scan_step(float v, unsigned q, float& v1, unsigned& i1,
                                          float& v2) {
  const bool gt = v > v1;
  v2 = fmaxf(v2, gt ? v1 : v);
  v1 = fmaxf(v1, v);
  i1 = gt ? q : i1;
}

// the word of a bid: the bid's order-preserving bits over ~person, so that
// the 64-bit maximum is the highest bid, the lowest person on ties
__device__ __forceinline__ unsigned long long bid_word(float bid, int t) {
  return (static_cast<unsigned long long>(float_key(bid)) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(t));
}

struct WarpBid {
  uint32_t obj;  // the best object, the same in every lane
  bool mine;     // this lane holds it
  float bid;     // the bid, in the lane that holds it
};

// One person's bid by one warp: each lane scans its objects (16-byte loads
// of 4 consecutive objects, unrolled 3 deep; from device memory one object
// in 32 at a time), then three redux instructions take the best key, the
// first index at it and top2, and the lane that holds the object reads its
// benefit back for the bid.
template <int MODE>
__device__ __forceinline__ WarpBid warp_bid(const float* row, const float* price, int Q,
                                            int Qp, float eps, int lane) {
  constexpr unsigned full = 0xffffffffu;
  float v1 = -INFINITY, v2 = AUCTION_NEG;
  unsigned i1 = 0xffffffffu;
  if constexpr (MODE != 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(price);
#pragma unroll 3
    for (int f = lane; f < Qp / 4; f += 32) {
      const float4 b = r4[f], c = p4[f];
      const unsigned q = 4u * f;
      scan_step(b.x - c.x, q, v1, i1, v2);
      scan_step(b.y - c.y, q + 1, v1, i1, v2);
      scan_step(b.z - c.z, q + 2, v1, i1, v2);
      scan_step(b.w - c.w, q + 3, v1, i1, v2);
    }
  } else {
    for (int q = lane; q < Q; q += 32) {
      scan_step(__ldg(row + q) - price[q], q, v1, i1, v2);
    }
  }
  // the float compare takes -0 == +0: so does the key
  uint32_t k1 = float_key(v1);
  if (k1 == 0x7fffffffu) k1 = 0x80000000u;
  const uint32_t best = __reduce_max_sync(full, k1);
  WarpBid r;
  r.obj = __reduce_min_sync(full, k1 == best ? i1 : 0xffffffffu);
  r.mine = i1 == r.obj;
  const uint32_t top2 = __reduce_max_sync(full, float_key(r.mine ? v2 : v1));
  r.bid = r.mine ? (row[r.obj] - key_float(top2)) + eps : 0.0f;
  return r;
}

template <int MODE>
__global__ void __launch_bounds__(AU_NT, 1) auction_kernel(AuctionParams p) {
  constexpr unsigned full = 0xffffffffu;
  constexpr int NW = AU_NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, Q = p.Q, NC = (T + 31) / 32;
  const int Qs = auction_qs(Q, MODE), Qp = auction_qp(Q, MODE);
  const AuctionLayout l = auction_layout(T, Q, MODE);
  float* rows = reinterpret_cast<float*>(smem + l.rows);
  float* price = reinterpret_cast<float*>(smem + l.price);
  unsigned long long* word = reinterpret_cast<unsigned long long*>(smem + l.word);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + l.bar);
  int* owner = reinterpret_cast<int*>(smem + l.owner);
  short* asg = reinterpret_cast<short*>(smem + l.asg);      // object per person
  short* choice = reinterpret_cast<short*>(smem + l.choice);  // object bid on, -1
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned below = (1u << lane) - 1u;
  const long long prob = blockIdx.x;
  const float* ben = p.benefit + prob * T * Q;
  // person t's row; in the first iteration, once its group has landed
  auto row_of = [&](int t, int it) {
    if constexpr (MODE == 2)
      if (it == 0) mbar_wait(smem_u32(bar + (t >> 5)), 0);
    return (MODE ? rows + static_cast<long long>(t) * Qs : ben + static_cast<long long>(t) * Q);
  };

  for (int t = threadIdx.x; t < T; t += AU_NT) {
    asg[t] = p.mask[prob * T + t] ? -1 : -2;
    choice[t] = -1;
  }
  for (int q = threadIdx.x; q < Qp; q += AU_NT) {
    price[q] = q < Q ? 0.0f : INFINITY;
    if (q < Q) {
      word[q] = 0ull;
      owner[q] = -1;
    }
  }
  if (MODE == 2 && threadIdx.x < NC) {
    mbar_init(smem_u32(bar + threadIdx.x), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // valid persons, 32 at a time; warp w starts the copies of groups w, w + NW,
  // ... (none if no iteration runs: the first one reads every valid row)
  int n_valid = 0;
  for (int k = 0; k < NC; ++k) {
    const int t = 32 * k + lane;
    const unsigned m = __ballot_sync(full, t < T && asg[t] == -1);
    n_valid += __popc(m);
    if (MODE == 2 && k % NW == warp && p.max_iters > 0) {
      if (lane == 0) mbar_expect_tx(smem_u32(bar + k), __popc(m) * Q * 4u);
      __syncwarp();
      if (m >> lane & 1u)
        bulk_copy(smem_u32(rows + static_cast<long long>(t) * Qs),
                  ben + static_cast<long long>(t) * Q, Q * 4u, smem_u32(bar + k));
    }
  }
  if constexpr (MODE == 1) {
    for (int t = warp; t < T; t += NW)
      if (asg[t] == -1)
        for (int q = lane; q < Q; q += 32)
          rows[static_cast<long long>(t) * Qs + q] = ben[static_cast<long long>(t) * Q + q];
    __syncthreads();
  }
  const int n_over = max(n_valid - Q, 0);
  int n_un = n_valid;
  int it = 0;
  long long bids = 0;
  // fn(t) for the unassigned persons of rank g0, g0 + NW, ... (0-based,
  // in person order), from the ballots of 4 groups of 32 persons at a time
  auto for_ranks = [&](int g0, auto fn) {
    int g = g0;
    for (int k0 = 0, before = 0; k0 < NC && g < n_un; k0 += 4) {
      unsigned m[4];
      int c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 32 * (k0 + i) + lane;
        m[i] = __ballot_sync(full, t < T && asg[t] == -1);
        c[i] = __popc(m[i]);
      }
      const int end = before + c[0] + c[1] + c[2] + c[3];
      for (; g < end; g += NW) {
        int j = g - before, k = k0;
        unsigned mk = m[0];
        if (j >= c[0]) {
          j -= c[0], mk = m[1], k = k0 + 1;
          if (j >= c[1]) {
            j -= c[1], mk = m[2], k = k0 + 2;
            if (j >= c[2]) j -= c[2], mk = m[3], k = k0 + 3;
          }
        }
        fn(32 * k + __ffs(__ballot_sync(full, (mk >> lane & 1u) && __popc(mk & below) == j)) - 1);
      }
      before = end;
    }
  };

  // A. more bidders than warps (the first iteration, overfull problems):
  // warp w takes the bidders of rank w, w + NW, ...; each writes its object
  // into `choice`, and after the bids each person that bid checks its
  // object's word
  while (n_un > max(n_over, NW) && it < p.max_iters) {
    bids += n_un;
    for_ranks(warp, [&](int t) {
      const WarpBid b = warp_bid<MODE>(row_of(t, it), price, Q, Qp, p.eps, lane);
      if (b.mine) {
        atomicMax(word + b.obj, bid_word(b.bid, t));
        choice[t] = static_cast<short>(b.obj);
      }
    });
    __syncthreads();
    int won_free = 0;
    for (int t0 = 0; t0 < T; t0 += AU_NT) {
      const int t = t0 + threadIdx.x;
      int free_win = 0;
      if (t < T && choice[t] >= 0) {
        const int q = choice[t];
        choice[t] = -1;
        const unsigned long long w = word[q];
        if (static_cast<uint32_t>(w) == ~static_cast<uint32_t>(t)) {
          const int prev = owner[q];
          if (prev >= 0)
            asg[prev] = -1;
          else
            free_win = 1;
          owner[q] = t;
          price[q] = key_float(static_cast<uint32_t>(w >> 32));
          asg[t] = static_cast<short>(q);
          word[q] = 0ull;
        }
      }
      won_free += __syncthreads_count(free_win);
    }
    n_un -= won_free;
    ++it;
  }
  // B. a bidder a warp at most (from here on: the unassigned count never
  // grows): warp w keeps its bidder t in registers. A loser bids again, a
  // winner over an owner hands the turn to that owner, a winner of a free
  // object leaves the warp idle: no enumeration, and the update is the
  // bidder's own
  int t = -1;
  if (n_un > n_over && it < p.max_iters) for_ranks(warp, [&](int u) { t = u; });
  while (n_un > max(n_over, 1) && it < p.max_iters) {
    bids += n_un;
    WarpBid b;
    int prev = -1;
    if (t >= 0) {
      b = warp_bid<MODE>(row_of(t, it), price, Q, Qp, p.eps, lane);
      if (b.mine) atomicMax(word + b.obj, bid_word(b.bid, t));
      prev = owner[b.obj];  // only this object's winner changes it, below
    }
    __syncthreads();
    bool free_win = false;
    if (t >= 0) {
      const bool won = static_cast<uint32_t>(word[b.obj]) == ~static_cast<uint32_t>(t);
      __syncwarp();
      if (won && b.mine) {
        owner[b.obj] = t;
        price[b.obj] = b.bid;
        asg[t] = static_cast<short>(b.obj);
        if (prev >= 0) asg[prev] = -1;
        word[b.obj] = 0ull;
      }
      free_win = won && prev < 0;
      if (won) t = prev;
    }
    n_un -= __syncthreads_count(lane == 0 && free_win);
    ++it;
  }
  // C. the last unassigned person alone (n_over == 0): it always wins, so
  // its warp runs the iterations by itself, with no barrier
  const bool alone = n_un == 1 && n_over == 0 && it < p.max_iters;
  if (alone && t >= 0) {
    while (t >= 0 && it < p.max_iters) {
      const WarpBid b = warp_bid<MODE>(row_of(t, it), price, Q, Qp, p.eps, lane);
      const int prev = owner[b.obj];
      __syncwarp();
      if (b.mine) {
        owner[b.obj] = t;
        price[b.obj] = b.bid;
        asg[t] = static_cast<short>(b.obj);
        if (prev >= 0) asg[prev] = -1;
      }
      __syncwarp();
      t = prev;
      ++bids;
      ++it;
    }
    if (lane == 0) {
      p.iters[prob] = it;
      p.bids[prob] = static_cast<int>(bids);
    }
  }
  __syncthreads();
  for (int u = threadIdx.x; u < T; u += AU_NT) p.assigned[prob * T + u] = asg[u];
  if (threadIdx.x == 0 && !alone) {
    p.iters[prob] = it;
    p.bids[prob] = static_cast<int>(bids);
  }
}

namespace {

template <int MODE>
int launch_auction(const AuctionParams* p, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auction_kernel<MODE><<<p->P, AU_NT, smem, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spe_auction(const AuctionParams* p, void* stream) {
  if (p->P <= 0 || p->T <= 0 || p->Q <= 0 || p->max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = p->Q % 4 == 0 && reinterpret_cast<uintptr_t>(p->benefit) % 16 == 0;
  const size_t with_rows = auction_layout(p->T, p->Q, tma ? 2 : 1).total;
  if (with_rows <= AU_SMEM)
    return tma ? launch_auction<2>(p, with_rows, s) : launch_auction<1>(p, with_rows, s);
  // the state alone caps Q below 15000, so 16 bits hold an object index
  const size_t state = auction_layout(p->T, p->Q, 0).total;
  if (state > AU_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  return launch_auction<0>(p, state, s);
}

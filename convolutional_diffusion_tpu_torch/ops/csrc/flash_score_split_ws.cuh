// K2's per-row sums ('high', 'vpu', c <= 8: mode HIGH_VPU, with 1-D
// weights, per-seed weights (K5) or a prune mask (K6)) on a
// warp-specialised main loop. It replaces, for this mode alone, the
// split-dot loop of flash_score_split_rows.cuh, which the 'default' kernel
// and K2's wide modes still run; both stand for the one TPU kernel,
// convolutional_diffusion_tpu/ops/flash_score.py `_kernel_body` (the
// `precision != HIGHEST` dot, fp32 exp2, 'vpu' sums).
//
// What bounds it on an H100, per 128 x 128 pairs and k16 step: the three
// bf16 products (3 x 64 tensor-core cycles a warpgroup, 384 for the
// block); the exact hi.hi sum, seven fp32 instructions per accumulator (a
// TwoSum and the add of its error: 2 x 7 x 64 x 128 / 128 lanes = 896
// cycles, ~2.3x the products, the floor of this dot); and the bytes staged
// from L2. The loop before this one ran 2.8x above that fp32 floor
// because every k16 step and stage made its two warpgroups wait together
// (a wait for all products, a block-wide barrier per stage, a pairwise
// barrier per tile for the row max), so while they waited nothing issued.
// This one runs K2 1.4-1.5x faster at every k (PERF.md §6), ~2x above the
// floor: what is left is each warpgroup's wait for its own products, which
// the other's folds cover only in part.
//
// The design (one block of 384 threads per SM; per (query block of BQ =
// 128 rows, seed, split), as before):
// 1. A producer warpgroup (setmaxnreg down to PRODUCER_REGS). One thread
//    stages each stage of BK = 32 features, the hi and lo planes of the
//    query block and of the bank tile (128 rows each), by TMA from the
//    planes split_planes_kernel writes, in the 64-byte swizzle the
//    products read, into a ring of STAGES slots: one full mbarrier per
//    slot (the TMA's bytes), one empty mbarrier (the 8 consumer warps).
//    A second warp stages each tile's bias and values by cp.async into a
//    ring of TSLOTS tile slots, with its own pair of mbarriers. Nothing
//    else in the loop synchronises: no __syncthreads, no named barrier.
// 2. Two consumer warpgroups (setmaxnreg up to CONSUMER_REGS), each with
//    its own 64 query rows over the whole 128-row bank tile. A row's max,
//    rescale and sums stay in its warpgroup (quad shuffles; the state in
//    shared memory, one leader thread a row), so the two never wait for
//    each other and drift apart: one's TwoSum and epilogue issue while the
//    other's products are in the tensor pipe. Per k16 step a warpgroup
//    runs the hi.hi product a half tile (m64n64) at a time into one
//    32-register fragment and folds it into S and X, then issues both cross
//    terms over the whole tile (m64n128) with the next step's first half:
//    S, X and HH are 64 + 64 + 32 registers, which with the loop's state
//    fit the consumers' 240 with no spill (a second HH fragment, to issue
//    a step's second half before folding its first, spilled and gained
//    nothing; PERF.md §6). Every wait is for all products in flight, and
//    no accumulator is read or written while one is: ptxas then pipelines
//    the products of a step (otherwise it serialises the loop's, its notes
//    C7514 and C7515). The last step of a tile issues an unused half
//    product of its own stage, so that every step has one shape.
// 3. Fewer bytes per pair: a stage holds 128 query rows and 128 bank rows
//    per 32 features, 32 KB per 16384 pairs (24 KB per 8192 before).
//
// The dot is the loop's before it, per accumulator and step: the hi.hi
// product from zero, added into S by TwoSum with its error into X, then
// qh.kl and ql.kh accumulated into X; the logit is fmaf(S + X, dotscale,
// bias). So the logits are the same bits; m is the same; only the grouping
// of a row's partial s1 and s2 differs (fp32 rounding). The online-softmax
// step is the 128-row tile, the split plan and the merge pass are K2's.
//
// ptxas (sm_90a, -O3; PERF.md §6): every instantiation (C = 1..8, the 1-D
// and the list walks) reports 168 registers at launch (24 in the producer,
// 240 in the consumers), no spill stores or loads, and no wgmma
// serialisation note (C7514, C7515). The producer's 24 registers allow only
// 32-bit offsets and one contiguous copy of the tile's values.

#pragma once

#include <cuda.h>  // CUtensorMap and the types of its encoding (the entry point: the runtime's)

#include "flash_score_split_rows.cuh"

namespace cdt_split_rows {
namespace ws {

constexpr int BQ = 128;  // query rows per block: the two consumer warpgroups' 64 each
static_assert(BQ == K2_SPLIT_BQ, "ops/_build.py SPLIT_BQ holds this block's rows");
static_assert(BQ == BP, "one tensor-map box serves the query block and the bank tile");
constexpr int NT = 384;      // the producer warpgroup, then two consumer warpgroups
constexpr int NACC = 64;     // m64n128 fp32 accumulator registers per thread
constexpr int STAGES = 5;    // stage ring slots
constexpr int TSLOTS = 4;    // tile ring slots (bias, values)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 = 384 x 168
constexpr int CONSUMER_WARPS = 8;
constexpr int PLANE = BQ * BK * 2;  // bytes of a staged plane: 128 rows of 64 bytes
constexpr int STAGE = 4 * PLANE;    // Qh, Ql, Kh, Kl
static_assert(PLANE % 1024 == 0, "the planes stay on the swizzle's alignment");

using cdt_splitbank::smem_u32;

// dynamic shared memory, bytes from the 1024-aligned base: the stage ring,
// the tile ring (bias [BP], values [BP][C] f32 a slot), the mbarriers
// (full, empty per stage slot; full, empty per tile slot), the online
// softmax state of the block's rows (m, s1, s2[C] f32 a row), then the tile
// list's count and entries (K5, K6)
template <int C>
struct Smem {
  static constexpr int TILE = 4 * BP * (1 + C);
  static constexpr size_t TILES = (size_t)STAGES * STAGE;
  static constexpr size_t BARS = TILES + (size_t)TSLOTS * TILE;
  static constexpr size_t STATE = BARS + 8 * (2 * STAGES + 2 * TSLOTS);
  static constexpr size_t LIST = STATE + 4 * (size_t)BQ * (2 + C);
  static_assert(BARS % 8 == 0, "mbarriers are 8-byte aligned");
};

// the block's shared memory, from its 1024-aligned base (the swizzle's
// pattern follows address bits)
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

// the hi and lo planes of the queries and of the chunk, [rows, dp] bf16:
// tensor maps of a box of BK features by 128 rows, 64-byte swizzle
struct Planes {
  CUtensorMap qh, ql, kh, kl;
};

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
// until the phase of `parity` has completed (parity 1 of a fresh barrier:
// at once)
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(b))
               : "memory");
}
// arrive, and expect `bytes` of asynchronous copies in this phase
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}
// arrive once this thread's cp.async copies issued so far have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
// the box at (feature x, row y) of `map` into dst; its bytes complete on b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(b))
      : "memory");
}

// d = A.B^T (+ d if accumulate): A 64 x 16 and B 128 x 16 bf16, K-major,
// from shared memory; issued asynchronously
__device__ __forceinline__ void wgmma128(float (&d)[NACC], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d = A.B^T, A 64 x 16 and B 64 x 16 bf16 from shared memory (a half
// tile's hi.hi product): d is written, not read, so its old value is dead
// for the register allocator
__device__ __forceinline__ void wgmma64_zero(float (&d)[NACC / 2], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The consumer warpgroups' part of `loop`. It keeps in registers only the
// accumulators and the ring positions: the rows' state lives in shared
// memory (read once a tile by the row's quad, written by its leader), and
// what the epilogue and the exit need is read again from the kernel's
// parameters and the block's indices, so that the loop's S, X and HH (160
// registers) fit the consumers' budget with no spill.
template <int C, bool LIST>
__device__ __forceinline__ void consume(float dotscale, float* __restrict__ part, int64_t M,
                                        int64_t rps, int64_t P, int dp, int64_t split_rows) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  using L = Smem<C>;
  unsigned char* const smem = smem_base();
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* const empty = full + STAGES;
  uint64_t* const tfull = empty + STAGES;
  uint64_t* const tempty = tfull + TSLOTS;
  const int lane = threadIdx.x & 31;
  // consumer warpgroup (uniform across the warp as ptxas can see): query
  // rows 64 wg .. 64 wg + 63
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
  const int wr = (threadIdx.x >> 5) & 3;  // its warp: rows 64 wg + 16 wr + g, + 8
  const int g = lane >> 2;
  const int t4 = lane & 3;  // columns 8 j + 2 t4, + 1 of n8 block j
  const int lr0 = wg * 64 + wr * 16 + g;  // rows lr0, lr0 + 8
  // row lr0 + 8 i's state: m, s1, s2[C]
  auto state = [&](int i) {
    return reinterpret_cast<float*>(smem + L::STATE) + (lr0 + 8 * i) * (2 + C);
  };
  const int64_t p_begin = (int64_t)blockIdx.z * split_rows;
  const int* const list = reinterpret_cast<const int*>(smem + L::LIST);
  const cdt_splitbank::SplitTiles<BQ, BP, LIST> tiles{
      (int)(p_begin / BP),
      LIST ? list[0]
           : (int)(((p_begin + split_rows < P ? p_begin + split_rows : P) + BP - 1) / BP -
                   p_begin / BP),
      list + 1};
  const int nk = dp / BK;  // stages per tile

  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      state(i)[0] = NEG_INF;
#pragma unroll
      for (int k = 1; k < 2 + C; ++k) state(i)[k] = 0.f;
    }
  }
  __syncwarp();
  float S[NACC], X[NACC], H[NACC / 2];

  int slot = 0, ts = 0;
  uint32_t phase = 0, tphase = 0;
  auto advance = [&]() {
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  };
  auto release = [&](uint64_t* b) {  // this warp is done with a slot
    __syncwarp();
    if (lane == 0) bar_arrive(b);
  };
  auto release_tile = [&]() {
    release(tempty + ts);
    if (++ts == TSLOTS) {
      ts = 0;
      tphase ^= 1;
    }
  };
  // the k16 step's operand descriptors in a stage slot: A (this warpgroup's
  // 64 query rows), B (the tile's bank rows from 64 h); plane 0 hi, 1 lo
  auto qd = [&](int s, int plane, int ks) {
    return desc(smem + s * STAGE + plane * PLANE + wg * 64 * 64 + ks * 32);
  };
  auto kd = [&](int s, int plane, int ks, int h) {
    return desc(smem + s * STAGE + (2 + plane) * PLANE + h * 64 * 64 + ks * 32);
  };
  auto issue_hh = [&](int s, int ks, int h) {  // H = qh.kh of half h, from zero
    wgmma_fence();
    wgmma64_zero(H, qd(s, 0, ks), kd(s, 0, ks, h));
    wgmma_commit();
  };
  // half h's HH (done, as are the cross terms before it) into S by TwoSum,
  // its errors into X. The pins keep every read of a product's registers
  // after the wait and every write of X before the next product is issued:
  // ptxas serialises all the loop's products when an accumulator is
  // defined while one is in flight (its note C7515)
  auto fold = [&](int h) {
    pin(X);
    pin(H);
#pragma unroll
    for (int i = 0; i < NACC / 2; ++i) {
      float err;
      S[32 * h + i] = two_sum(S[32 * h + i], H[i], err);
      X[32 * h + i] = __fadd_rn(X[32 * h + i], err);
    }
    pin(X);
    pin(H);
  };

  for (int ti = 0; ti < tiles.n; ++ti) {
    if (tiles.skipped(ti, wg)) {  // K6: this warpgroup's mask row skips the tile
      for (int kt = 0; kt < nk; ++kt) {
        bar_wait(full + slot, phase);
        release(empty + slot);
        advance();
      }
      bar_wait(tfull + ts, tphase);
      release_tile();
      continue;
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) S[i] = X[i] = 0.f;  // (0 + err is err, as before)
    pin(X);
    bar_wait(full + slot, phase);
    issue_hh(slot, 0, 0);
    int prev = slot;
    // k16 step s: wait for HH_s of half 0 (and the cross terms X_{s-1});
    // fold it; issue HH_s of half 1; wait; fold it; issue X_s (both halves,
    // one m64n128 product per cross term) and HH_{s+1} of half 0 (after the
    // tile's last step an unused product of its own stage, so that every
    // step has one shape). Nothing is read while a product is in flight.
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = slot;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        wgmma_wait<0>();
        if (ks == 0 && kt > 0) release(empty + prev);  // X_{s-1} read it last
        fold(0);
        issue_hh(cur, ks, 1);
        wgmma_wait<0>();
        fold(1);
        int ns = cur, nks = ks;
        if (ks + 1 < KS) {
          nks = ks + 1;
        } else if (kt + 1 < nk) {
          advance();
          bar_wait(full + slot, phase);
          ns = slot;
          nks = 0;
        }
        pin(X);
        wgmma_fence();
        wgmma128(X, qd(cur, 0, ks), kd(cur, 1, ks, 0), 1);
        wgmma128(X, qd(cur, 1, ks), kd(cur, 0, ks, 0), 1);
        wgmma64_zero(H, qd(ns, 0, nks), kd(ns, 0, nks, 0));
        wgmma_commit();
      }
      prev = cur;
    }
    wgmma_wait<0>();
    pin(X);
    release(empty + slot);
    advance();

    // dot tile complete: online-softmax epilogue. Accumulator element
    // 4 j + e: row lr0 + 8 (e / 2), column 8 j + 2 t4 + (e % 2); the logits
    // replace X
    bar_wait(tfull + ts, tphase);
    const float* const sb = reinterpret_cast<const float*>(smem + L::TILES + ts * L::TILE);
    const float* const sv = sb + BP;
    const int64_t p0 = tiles.tile(ti) * BP;
    float mx[2] = {NEG_INF, NEG_INF};  // rows lr0, lr0 + 8
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        const int i = 4 * j + e;
        X[i] = p0 + col < P ? fmaf(S[i] + X[i], dotscale, sb[col]) : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], X[i]);
      }
    float m_new[2], m_safe[2], scale[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m = state(i)[0];  // the quad's leader writes it after the shuffles below
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m, mx[i]);
      m_safe[i] = (m_new[i] <= NEG_INF * 0.5f) ? 0.f : m_new[i];
      scale[i] = (m <= NEG_INF * 0.5f) ? 0.f : exp2f(m - m_safe[i]);
    }
    float t1[2] = {0.f, 0.f}, t2[2][C];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int cc = 0; cc < C; ++cc) t2[i][cc] = 0.f;
    // per column its C values, read once for both rows; each row's sums
    // take the columns in order
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = j * 8 + 2 * t4 + h;
        float v[C];
#pragma unroll
        for (int cc = 0; cc < C; ++cc) v[cc] = sv[col * C + cc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x = exp2f(X[4 * j + 2 * i + h] - m_safe[i]);
          t1[i] += x;
#pragma unroll
          for (int cc = 0; cc < C; ++cc) t2[i][cc] = fmaf(x, v[cc], t2[i][cc]);
        }
      }
    release_tile();
    // the tile's sums of each row over its quad (all under the same m),
    // added by the quad's leader into the row's rescaled sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        t1[i] += __shfl_xor_sync(0xffffffffu, t1[i], o);
#pragma unroll
        for (int cc = 0; cc < C; ++cc) t2[i][cc] += __shfl_xor_sync(0xffffffffu, t2[i][cc], o);
      }
      if (t4 == 0) {
        float* const sr = state(i);
        sr[0] = m_new[i];
        sr[1] = fmaf(sr[1], scale[i], t1[i]);
#pragma unroll
        for (int cc = 0; cc < C; ++cc) sr[2 + cc] = fmaf(sr[2 + cc], scale[i], t2[i][cc]);
      }
    }
  }

  // the split's partial state of each row
  const int64_t row0 = (int64_t)blockIdx.y * rps + (int64_t)blockIdx.x * BQ;
  const int64_t seed_end = ((int64_t)blockIdx.y + 1) * rps;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = row0 + lr0 + 8 * i;
    if (t4 == 0 && r < seed_end && r < row0 + BQ) {
      const float* const sr = state(i);
      float* const o = part + ((int64_t)blockIdx.z * M + r) * (2 + C);
#pragma unroll
      for (int k = 0; k < 2 + C; ++k) o[k] = sr[k];
    }
  }
}

// The loop. Threads 0..127 are the producer warpgroup (warp 0 lane 0 the
// TMA, warp 1 the tile ring; warp 0 also builds the tile list, K5 and K6,
// before the roles split), threads 128..383 the consumer warpgroups wg = 0,
// 1, with query rows 64 wg .. 64 wg + 63 of the block. A listed tile that
// the mask row of a consumer warpgroup skips (K6: a 128-row block spans two
// mask rows) is passed over by that warpgroup alone, which leaves its rows'
// state bit for bit (split_bank.cuh). The partial state of each row goes to
// part [nsplit][M][2 + C], as the merge pass reads it.
template <int C, bool LIST>
__device__ __forceinline__ void loop(const Planes& planes, const float* __restrict__ bias,
                                     const float* __restrict__ values, float dotscale,
                                     float* __restrict__ part, int64_t M, int64_t rps,
                                     int64_t P, int dp, int64_t split_rows,
                                     const int* __restrict__ mask, int64_t mask_stride,
                                     const int* __restrict__ tile_live, int* __restrict__ walked) {
  using L = Smem<C>;
  unsigned char* const smem = smem_base();
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* const empty = full + STAGES;
  uint64_t* const tfull = empty + STAGES;
  uint64_t* const tempty = tfull + TSLOTS;
  int* const list = reinterpret_cast<int*>(smem + L::LIST);  // count, then entries

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the warpgroup, uniform across the warp as ptxas can see (its register
  // budget per role follows from the branch on it)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int64_t seed = blockIdx.y;
  const int64_t row0 = seed * rps + (int64_t)blockIdx.x * BQ;
  bias += seed * P;
  const int64_t p_begin = (int64_t)blockIdx.z * split_rows;
  const int64_t p_end = p_begin + split_rows < P ? p_begin + split_rows : P;
  const int64_t pt_begin = p_begin / BP, pt_end = (p_end + BP - 1) / BP;

  if (warp == 0) {
    if constexpr (LIST) {
      const int n = cdt_splitbank::warp_list_tiles<BQ, BP>(
          mask, mask_stride,
          tile_live == nullptr ? nullptr : tile_live + seed * ((P + BP - 1) / BP), row0,
          (M + PRUNE_ROWS - 1) / PRUNE_ROWS, pt_begin, pt_end, list + 1);
      if (lane == 0) {
        list[0] = n;
        if (walked != nullptr)
          walked[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = n;
      }
    }
    if (lane == 0) {
      for (int s = 0; s < STAGES; ++s) {
        bar_init(full + s, 1);
        bar_init(empty + s, CONSUMER_WARPS);
      }
      for (int s = 0; s < TSLOTS; ++s) {
        bar_init(tfull + s, 32);
        bar_init(tempty + s, CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const cdt_splitbank::SplitTiles<BQ, BP, LIST> tiles{
      (int)pt_begin, LIST ? list[0] : (int)(pt_end - pt_begin), list + 1};
  const int nk = dp / BK;  // stages per tile

  if (role == 0) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // 32-bit offsets (`launch_ws` refuses M or P C of 2^31 or more) keep
    // the producer within its registers
    if (warp == 0 && lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int ti = 0; ti < tiles.n; ++ti) {
        const int p0 = (int)tiles.tile(ti) * BP;
        for (int kt = 0; kt < nk; ++kt) {
          bar_wait(empty + slot, phase ^ 1);
          unsigned char* const st = smem + slot * STAGE;
          bar_expect(full + slot, STAGE);
          tma_load(st, &planes.qh, kt * BK, (int)row0, full + slot);
          tma_load(st + PLANE, &planes.ql, kt * BK, (int)row0, full + slot);
          tma_load(st + 2 * PLANE, &planes.kh, kt * BK, p0, full + slot);
          tma_load(st + 3 * PLANE, &planes.kl, kt * BK, p0, full + slot);
          if (++slot == STAGES) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    } else if (warp == 1) {
      int ts = 0;
      uint32_t tphase = 0;
      const int rows = (int)P;
      for (int ti = 0; ti < tiles.n; ++ti) {
        const int p0 = (int)tiles.tile(ti) * BP;
        bar_wait(tempty + ts, tphase ^ 1);
        float* const sb = reinterpret_cast<float*>(smem + L::TILES + ts * L::TILE);
        float* const sv = sb + BP;
        for (int e = lane; e < BP; e += 32)
          cdt_splitbank::cp_async<4>(sb + e, bias + (p0 + e), bias, p0 + e < rows);
        // the tile's values [BP][C], contiguous in values [P][C]
        for (int e = lane; e < BP * C; e += 32)
          cdt_splitbank::cp_async<4>(sv + e, values + (p0 * C + e), values, p0 * C + e < rows * C);
        bar_arrive_copies(tfull + ts);
        if (++ts == TSLOTS) {
          ts = 0;
          tphase ^= 1;
        }
      }
      cdt_splitbank::cp_async_wait<0>();
    }
  } else {
    consume<C, LIST>(dotscale, part, M, rps, P, dp, split_rows);
  }
}

}  // namespace ws

// The kernel of K2's per-row sums: ws::loop, one instantiation per (C,
// LIST) under the split-dot loop's name (the profiler's readers find the
// split family by it), MODE HIGH_VPU
template <int C, int MODE, bool LIST>
__global__ void __launch_bounds__(ws::NT, 1) rows_kernel(
    const __grid_constant__ ws::Planes planes, const float* __restrict__ bias,
    const float* __restrict__ values, float dotscale,
    float* __restrict__ part, int64_t M, int64_t rps, int64_t P, int dp, int64_t split_rows,
    const int* __restrict__ mask, int64_t mask_stride, const int* __restrict__ tile_live,
    int* __restrict__ walked) {
  static_assert(MODE == HIGH_VPU, "the warp-specialised loop takes K2's per-row sums");
  ws::loop<C, LIST>(planes, bias, values, dotscale, part, M, rps, P, dp, split_rows,
                    mask, mask_stride, tile_live, walked);
}

namespace ws {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// the map of a plane [rows, dp] bf16 (rows of dp * 2 bytes, a multiple of
// 64; a 16-byte aligned base): boxes of BK features by 128 rows, zeros past
// its rows; false if the encoding is refused
inline bool encode_plane(CUtensorMap* map, const void* base, int64_t rows, int dp) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)dp, (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)dp * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)BQ};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ws

// K2's per-row sums: the pre-split, K5's live-tile flags, the loop and
// the merge pass, on the scratch layout of `launch`
template <int C>
int launch_ws(const void* q, const void* bias, const void* bank, const void* values,
              float dotscale, int64_t M, int64_t rps, int64_t P, int d, const int* mask,
              int64_t mask_stride, int* live, int* walked, void* scratch, int64_t split_rows,
              const State& w, cudaStream_t stream) {
  // the values are [P, C] ('vpu'); the tensor maps' coordinates and the
  // producer's offsets are 32-bit
  if (w.vstride != C || M >= ((int64_t)1 << 31) || P * C >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t nsplit = cdt_splitbank::n_splits(P, split_rows);
  const int dp = padded(d);
  Scratch sc;
  cudaError_t err =
      split_inputs(q, bias, bank, M, rps, P, d, C, nsplit, live, scratch, sc, stream);
  if (err != cudaSuccess) return (int)err;
  ws::Planes planes;
  if (!ws::encode_plane(&planes.qh, sc.qh, M, dp) ||
      !ws::encode_plane(&planes.ql, sc.ql, M, dp) ||
      !ws::encode_plane(&planes.kh, sc.kh, P, dp) || !ws::encode_plane(&planes.kl, sc.kl, P, dp))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((rps + ws::BQ - 1) / ws::BQ), (unsigned)(M / rps),
                  (unsigned)nsplit);
  const bool list = mask != nullptr || live != nullptr;
  using Kernel = void (*)(ws::Planes, const float*, const float*, float, float*,
                          int64_t, int64_t, int64_t, int, int64_t, const int*, int64_t,
                          const int*, int*);
  const Kernel kernel = list ? (Kernel)rows_kernel<C, HIGH_VPU, true>
                             : (Kernel)rows_kernel<C, HIGH_VPU, false>;
  // LIST: room for the count and the entries of a split's tile list
  const size_t smem = ws::Smem<C>::LIST + 1024 +
      (list ? 4 * (size_t)(((split_rows < P ? split_rows : P) + BP - 1) / BP + 1) : 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, ws::NT, smem, stream>>>(planes, (const float*)bias, (const float*)values,
                                         dotscale, sc.part, M, rps, P, dp, split_rows, mask,
                                         mask_stride, live, walked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cdt_splitbank::merge_splits(w.m_in, w.s1_in, w.s2_in, sc.part, w.m_out,
                                          w.s1_out, w.s2_out, M, (int)nsplit, C, stream);
}

}  // namespace cdt_split_rows

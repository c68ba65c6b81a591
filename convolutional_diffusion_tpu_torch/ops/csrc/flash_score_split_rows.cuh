// The split-dot main loop of the 'default' kernel (flash_score_fast.cu: the
// bf16x3 split dot, bf16 exponential) in every value strategy and of K2's
// wide modes (flash_score_bf16x3.cu, 'high' 'mxu', 'inbank' and 'vpu' past
// 8 channels), with K5 and K6: a loop that does no global loads, split
// arithmetic or transposes, and whose tensor-core products run under its
// exact fp32 sum. K2's per-row sums (HIGH_VPU) run the warp-specialised
// loop of flash_score_split_ws.cuh on the same planes and dot, which keeps
// this file's pre-split pass, descriptors and products; `sweep` at the
// bottom routes a launch to its mode for both entry points. The epilogue
// modes (flash_score_split.cuh) differ only in the exponential, the value
// sums and where the state starts.
//
// 1. Split once per launch. `split_planes_kernel` writes the bf16 hi and lo
//    parts of the queries [M, d] and of the bank chunk [P, d] as planes
//    [rows, dp] (dp: d rounded up to the BK-feature stage, zeros past d)
//    into the wrapper's scratch: the chunk is split once, not once per
//    query block.
// 2. Stage asynchronously. Each stage of BK = 32 features (the query
//    block's and the bank tile's hi and lo rows, 16-byte cp.async, as
//    64-byte rows in the 64-byte swizzle the warpgroup product reads; the
//    tile's bias and, per-row modes, values with its last stage) goes into a
//    ring of STAGES shared-memory slots, STAGES - 2 stages ahead, one
//    barrier per stage. (Unswizzled 8-row x 16-byte core matrices gave the
//    same bits and ran ~1.3x slower, PERF.md §6.)
// 3. One block of two warpgroups per (query block of BQ = 64 rows, seed),
//    walking the chunk's tiles (split_bank.cuh `split_tiles`): every one
//    with 1-D weights, its seed's live ones with per-seed weights (K5), the
//    ones its mask row keeps under a prune mask (K6; a 64-row block is one
//    mask row, so a listed tile has no skipped rows), from the carried
//    state: the bf16 exponential rounds x = logit - m against the m of each
//    tile, so splitting the bank axis would change its function, and K2's
//    wide modes keep the 'default' kernel's state handling (128 blocks at
//    M = 8192, one wave).
// 4. Overlap the products with the exact sum. Warpgroup wc owns bank
//    columns 64 wc .. +64 of each 128-row tile: per k16 step s, three
//    wgmma.mma_async m64n64k16 (bf16 from shared memory, fp32 in
//    registers): HH_s = qh.kh from zero (scale-d false) into one of two
//    fragments, then qh.kl and ql.kh into the cross-term accumulator X.
//    The exact sum needs X to take the TwoSum error of step s before
//    step s's cross terms, so the steps are software-pipelined:
//      issue HH_{s+1};  TwoSum(S, HH_s) -> err_s, while the tensor pipe
//      runs X_{s-1} and HH_{s+1};  wait for both;  X += err_s;  issue X_s
//    so the fp32 pipe works while all three products of a step are in
//    flight. The wait is for every group: when X is read while the later
//    HH is still in flight, which a wait for the older group alone would
//    allow, ptxas serialises every product of the loop (its note C7514).
//    Registers: S, X and the two HH fragments are 4 x 32 per thread, one
//    block of 8 warps per SM (the exact sum keeps four accumulators live,
//    which leaves no room for a second block).
//
// The dot: per k16 step the hi.hi product from a zero accumulator (the
// tensor core rounds the exact 16-product sum toward zero to fp32 in ~97%
// of inexact steps, wgmma as mma.sync, ops/k2_numerics.py), added into the
// running sum by TwoSum with its error into the cross-term accumulator,
// then qh.kl and ql.kh accumulated there; the logit is fmaf(S + X,
// dotscale, bias). The logits are the same bits in every mode of both
// loops.
//
// The epilogue works on the accumulator layout: the accumulator of warp wr
// of warpgroup wc holds query rows 16 wr + g, +8 and, for n8 block j, bank
// columns 64 wc + 8 j + 2 t4, +1 (mma.sync's m16n8 layout, so two adjacent
// n8 blocks of exponentials are the A fragment of an m16n8k16 value
// product); the row max goes over the quad by shuffles and over the two
// warpgroups through shared memory (one buffer per tile parity), with a
// named barrier for the pair of warps that share the rows; per-thread
// partial s1 / s2 under that max are summed once, at exit. The wide modes
// keep s2 in the rows of the state they write (value_sums.cuh) and pass
// each tile's values through shared memory under block-wide barriers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_score_split.cuh"
#include "split_bank.cuh"
#include "value_sums.cuh"

namespace cdt_split_rows {

using namespace cdt_split;  // split_pair, two_sum, mma_bf16, pack_bf16, the modes
using cdt_splitbank::cp_async;
using cdt_vals::bf16r;
using cdt_vals::fast_exp;

constexpr int BQ = 64;      // query rows per block: 4 warp rows x 16
static_assert(BQ == SPLIT_DOT_BQ, "ops/_build.py SPLIT_BQ holds this block's rows");
constexpr int BK = 32;      // features per stage
constexpr int KS = BK / 16; // k16 steps per stage
constexpr int NT = 256;     // 2 warpgroups
constexpr int NACC = 32;    // m64n64 fp32 accumulator registers per thread
constexpr int STAGES = 5;   // ring slots
constexpr int CH = BK / 8;  // 16-byte chunks per row and plane in a stage
constexpr int SBO = 8 * BK * 2;  // bytes between 8-row groups of a staged plane
constexpr float NEG_INF = -1e30f;
static_assert(KS == 2, "the pipeline alternates two HH fragments, one per step of a stage");
static_assert(BK * 2 == 64, "a staged row is one 64-byte swizzle row");
using ValueTile = cdt_vals::ValueTile<BQ, BP, NT>;

template <int MODE>
struct Traits {
  static constexpr bool WIDE = MODE >= SIMT_HIGH;  // runtime c, s2 in device memory
  static constexpr bool SIMT = MODE == SIMT_HIGH || MODE == SIMT_FAST;
  static constexpr bool MMAV = MODE == MMAV_SPLIT || MODE == MMAV_FAST;
  static constexpr bool SPLITV = MODE == MMAV_SPLIT;  // the split value product
  static constexpr bool BF16_EXP = MODE == FAST_VPU || MODE == FAST_MMA ||
                                   MODE == SIMT_FAST || MODE == MMAV_FAST;
  static constexpr bool ROWSUM = MODE == FAST_VPU;  // s1, s2 per row
  static_assert(MODE != HIGH_VPU, "K2's per-row sums run flash_score_split_ws.cuh");
};

// dynamic shared memory, bytes: STAGES slots of (Qh, Ql [BQ x BK bf16],
// Kh, Kl [BP x BK bf16], bias [BP] f32, values [BP][CV] f32), then the
// warpgroups' row maxima [2 tile parities][2][BQ] and warpgroup 1's sums at
// exit [BQ][PW], then the wide modes' value tile (ValueTile or MmaTile),
// then the tile list (K5, K6)
template <int C, int MODE>
struct Smem {
  using T = Traits<MODE>;
  static constexpr int CV = T::WIDE ? 0 : C;  // value channels staged per tile
  static constexpr int NV = (C + 8) / 8;      // n8 tiles of [V | 1] (FAST_MMA)
  static constexpr int PW = MODE == FAST_MMA ? NV * 8 : 1 + CV;
  static constexpr int Q = BQ * BK * 2, K = BP * BK * 2;
  static constexpr int STAGE = 2 * Q + 2 * K + 4 * BP + 4 * BP * CV;
  static_assert(STAGE % 128 == 0, "slots stay 128-byte aligned");
  static constexpr size_t TAIL = 4 * (4 * BQ + BQ * PW);
  static constexpr size_t EXTRA =
      T::SIMT ? ValueTile::bytes : T::MMAV ? MmaTile<T::SPLITV>::bytes : 0;
  static constexpr size_t bytes = (size_t)STAGES * STAGE + TAIL + EXTRA;
  static constexpr size_t alloc = bytes + 1024;  // room to align the slots
};

// the values' row stride (the bank's row for 'inbank'), the wide modes' c
// and product rule, and the carried state in and out
struct State {
  int64_t vstride;
  int c;
  int rule;
  const float* m_in;
  const float* s1_in;
  const float* s2_in;
  float* m_out;
  float* s1_out;
  float* s2_out;
};

// d rounded up to the stage width: the planes' row length
__host__ __device__ __forceinline__ int padded(int d) { return (d + BK - 1) / BK * BK; }

// byte offset of row r, 16-byte chunk ch (features 8 ch ..) in a staged
// plane: rows of 64 bytes, the chunks of a row permuted by the 64-byte
// swizzle the warpgroup product reads through (address bits 4-5 XOR bits
// 7-8), so the 8 rows of a core matrix fall in distinct banks
__device__ __forceinline__ int swz_offset(int r, int ch) {
  return r * 64 + ((ch ^ ((r >> 1) & 3)) << 4);
}

// x [rows, d] -> hi, lo [rows, dp] as bf16 pairs (words [rows, dp / 2]):
// hi = bf16(x), lo = bf16(x - hi), round to nearest even; zeros past d
__global__ void split_planes_kernel(const float* __restrict__ x, int64_t rows,
                                    int d, int dp, uint32_t* __restrict__ hi,
                                    uint32_t* __restrict__ lo) {
  const int64_t wpr = dp / 2;
  const int64_t n = rows * wpr;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / wpr;
    const int k = 2 * (int)(i % wpr);
    const float a = k < d ? x[r * d + k] : 0.f;
    const float b = k + 1 < d ? x[r * d + k + 1] : 0.f;
    split_pair(a, b, hi[i], lo[i]);
  }
}

// shared-memory matrix descriptor of a K-major operand in the 64-byte
// swizzle (layout type 2; the plane's base 512-byte aligned): 8-row groups
// SBO apart, the leading byte offset unused; the k16 step's start is
// 32 bytes into the row, and the swizzle applies to the address formed
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = cdt_splitbank::smem_u32(p);
  return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)1 << 16) |
         ((uint64_t)(SBO >> 4) << 32) | ((uint64_t)2 << 62);
}

// d = A.B^T (+ d if accumulate): A 64 x 16 and B 64 x 16 bf16, K-major,
// from shared memory; issued asynchronously (wgmma_commit / wgmma_wait)
__device__ __forceinline__ void wgmma64(float (&d)[NACC], uint64_t a, uint64_t b,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// orders the registers of d against the asynchronous products: the
// compiler neither reads them early nor moves them across this point
__device__ __forceinline__ void pin(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's product groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int C, int MODE, bool LIST>
__global__ void __launch_bounds__(NT, 1) rows_kernel(
    const uint32_t* __restrict__ qh, const uint32_t* __restrict__ ql,
    const uint32_t* __restrict__ kh, const uint32_t* __restrict__ kl,
    const float* __restrict__ bias, const float* __restrict__ values,
    float dotscale, float* __restrict__ part, int64_t M, int64_t rps,
    int64_t P, int dp, int64_t split_rows, const int* __restrict__ mask,
    int64_t mask_stride, const int* __restrict__ tile_live, int* __restrict__ walked,
    State w) {
  using T = Traits<MODE>;
  using S = Smem<C, MODE>;
  constexpr int NV = S::NV, PW = S::PW, CV = S::CV;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle's pattern follows address bits: slots start 1024-aligned
  unsigned char* const smem =
      smem_raw + ((1024 - (cdt_splitbank::smem_u32(smem_raw) & 1023)) & 1023);
  float* const rmax_s = reinterpret_cast<float*>(smem + STAGES * S::STAGE);
  float* const part_s = rmax_s + 4 * BQ;
  float* const extra = part_s + BQ * PW;
  const ValueTile vt(extra);
  const MmaTile<T::SPLITV> mt(extra);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp & 3;   // warp of its warpgroup: query rows 16 wr .. 16 wr + 15
  const int wc = warp >> 2;  // warpgroup: tile columns 64 wc .. 64 wc + 63
  const int g = lane >> 2;   // rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;   // columns 2 t4, 2 t4 + 1 of an n8 block
  const int64_t seed = blockIdx.y;
  const int64_t row0 = seed * rps + (int64_t)blockIdx.x * BQ;
  const int64_t seed_end = (seed + 1) * rps;
  const int64_t row_end = row0 + BQ < seed_end ? row0 + BQ : seed_end;
  const int nrows = (int)(row_end - row0);
  bias += seed * P;
  const int64_t split = blockIdx.z;
  const int64_t p_begin = split * split_rows;
  const int64_t p_end = p_begin + split_rows < P ? p_begin + split_rows : P;
  // the split's tiles (K5: its seed's live ones; K6: the ones its mask row
  // keeps; listed after the block's other shared memory)
  const auto tiles = cdt_splitbank::split_tiles<BQ, BP, LIST, NT>(
      mask, mask_stride, tile_live == nullptr ? nullptr : tile_live + seed * ((P + BP - 1) / BP),
      row0, (M + PRUNE_ROWS - 1) / PRUNE_ROWS, p_begin / BP, (p_end + BP - 1) / BP,
      reinterpret_cast<int*>(smem + S::bytes));
  static_assert(cdt_splitbank::SplitTiles<BQ, BP, LIST>::ROWS == 1,
                "a listed tile has no skipped rows");
  if (LIST && walked != nullptr && tid == 0)  // a 1-D walk takes every tile of its split
    walked[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = tiles.n;
  const int nk = dp / BK;  // stages per tile
  const int64_t nstages = (int64_t)tiles.n * nk;
  const int64_t wpr = dp / 2;  // words per plane row
  const int lr[2] = {wr * 16 + g, wr * 16 + g + 8};
  const int c = T::WIDE ? w.c : C;

  // The state: the carried one. m is the same in all 8 threads of a row; s1
  // and the per-row s2 are per-thread partials under it, summed at exit, the
  // thread (wc == 0, t4 == 0) starting from the carried values. FAST_MMA: sv
  // in the product's accumulator layout (element e: row lr[e / 2], column
  // 2 t4 + (e % 2) of n8 tile nv; columns < C are s2, column C is s1),
  // warpgroup 0 starting from the carried values. The wide modes: s2 in the
  // output rows (MMAV: warpgroup 1's sums in the scratch's rows).
  const bool owner = wc == 0 && t4 == 0;
  float m[2], s1[2] = {0.f, 0.f}, s2[2][T::ROWSUM ? C : 1], sv[NV][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = row0 + lr[i];
    const bool carried = r < row_end;
    m[i] = carried ? w.m_in[r] : NEG_INF;
    if (MODE != FAST_MMA && carried && owner) s1[i] = w.s1_in[r];
    if constexpr (T::ROWSUM) {
#pragma unroll
      for (int cc = 0; cc < C; ++cc) s2[i][cc] = carried && owner ? w.s2_in[r * C + cc] : 0.f;
    }
  }
  if constexpr (MODE == FAST_MMA) {
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = row0 + lr[e >> 1];
        const int col = nv * 8 + 2 * t4 + (e & 1);
        float v = 0.f;
        if (wc == 0 && r < row_end)
          v = col < C ? w.s2_in[r * C + col] : (col == C ? w.s1_in[r] : 0.f);
        sv[nv][e] = v;
      }
  }
  if constexpr (T::WIDE) {  // read by the first epilogue after a barrier of the loop
    for (int i = tid; i < nrows * c; i += NT) {
      w.s2_out[row0 * c + i] = w.s2_in[row0 * c + i];
      if constexpr (T::MMAV) part[row0 * c + i] = 0.f;
    }
  }

  auto load = [&](int slot, int64_t pt, int kt) {
    unsigned char* const sqh = smem + slot * S::STAGE;
    unsigned char* const skh = sqh + 2 * S::Q;
    const int64_t w0 = (int64_t)kt * (BK / 2);
    const int64_t p0 = pt * BP;
#pragma unroll
    for (int j = 0; j < 2 * BQ * CH / NT; ++j) {
      const int e = tid + j * NT;
      const int lo = e / (BQ * CH);
      const int r = (e % (BQ * CH)) / CH, ch = e % CH;
      const int64_t gr = row0 + r;
      cp_async<16>(sqh + lo * S::Q + swz_offset(r, ch),
                   (lo ? ql : qh) + gr * wpr + w0 + ch * 4, qh, gr < row_end);
    }
#pragma unroll
    for (int j = 0; j < 2 * BP * CH / NT; ++j) {
      const int e = tid + j * NT;
      const int lo = e / (BP * CH);
      const int r = (e % (BP * CH)) / CH, ch = e % CH;
      const int64_t p = p0 + r;
      cp_async<16>(skh + lo * S::K + swz_offset(r, ch),
                   (lo ? kl : kh) + p * wpr + w0 + ch * 4, kh, p < P);
    }
    if (kt == nk - 1) {  // the tile's bias and values, read by its epilogue
      float* const sbias = reinterpret_cast<float*>(skh + 2 * S::K);
      float* const svals = sbias + BP;
      if (tid < BP) cp_async<4>(sbias + tid, bias + p0 + tid, bias, p0 + tid < P);
      for (int e = tid; e < BP * CV; e += NT) {
        const int64_t p = p0 + e / CV;
        cp_async<4>(svals + e, values + p * w.vstride + e % CV, values, p < P);
      }
    }
  };

  // producer: stage (tile pi, kt pkt) into slot pslot, one group each
  // (empty past the last stage, so the group count stays the stage count)
  int pi = 0, pkt = 0, pslot = 0;
  auto issue = [&]() {
    if (pi < tiles.n) {
      load(pslot, tiles.tile(pi), pkt);
      if (++pkt == nk) {
        pkt = 0;
        ++pi;
      }
    }
    cdt_splitbank::cp_async_commit();
    pslot = pslot + 1 == STAGES ? 0 : pslot + 1;
  };
  // the next stage is in shared memory for every thread and for the async
  // proxy; then its slot's predecessor two back (read by no product in
  // flight: the last one waited on was the previous stage's first cross
  // term) is refilled STAGES - 2 stages ahead
  auto enter = [&]() {
    cdt_splitbank::cp_async_wait<STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue();
  };

  // the k16 step's operand descriptors in a slot: A (all BQ rows), B (this
  // warpgroup's 64 bank rows)
  auto qdesc = [&](const unsigned char* st, int plane, int ks) {
    return desc(st + plane * S::Q + ks * 32);
  };
  auto kdesc = [&](const unsigned char* st, int plane, int ks) {
    return desc(st + 2 * S::Q + plane * S::K + wc * 8 * SBO + ks * 32);
  };

  float acc_hh[NACC], acc_x[NACC], hh0[NACC], hh1[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc_hh[i] = acc_x[i] = hh0[i] = hh1[i] = 0.f;

  // k16 step s, HH_s in h (no product in flight but X_{s-1}): issue
  // HH_{s+1} (slot nst, step nks) into hn; TwoSum of HH_s into S, its
  // errors into h, while the tensor pipe runs X_{s-1} and HH_{s+1}; wait
  // for both; X += errors (X = the errors at a tile's first step); issue X_s
  auto step = [&](float (&h)[NACC], float (&hn)[NACC], const unsigned char* st, int ks,
                  const unsigned char* nst, int nks, bool first) {
    pin(hn);
    wgmma_fence();
    wgmma64(hn, qdesc(nst, 0, nks), kdesc(nst, 0, nks), 0);
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      float err;
      acc_hh[i] = two_sum(acc_hh[i], h[i], err);
      h[i] = err;
    }
    wgmma_wait<0>();
    pin(acc_x);
    pin(hn);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc_x[i] = __fadd_rn(first ? 0.f : acc_x[i], h[i]);
    pin(acc_x);
    wgmma_fence();
    wgmma64(acc_x, qdesc(st, 0, ks), kdesc(st, 1, ks), 1);
    wgmma64(acc_x, qdesc(st, 1, ks), kdesc(st, 0, ks), 1);
    wgmma_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) issue();
  if (nstages > 0) {
    enter();
    pin(hh0);
    wgmma_fence();
    wgmma64(hh0, qdesc(smem, 0, 0), kdesc(smem, 0, 0), 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(hh0);
  }

  int ti = 0, kt = 0, slot = 0;
  for (int64_t u = 0; u < nstages; ++u) {
    const unsigned char* const st = smem + slot * S::STAGE;
    const int next = slot + 1 == STAGES ? 0 : slot + 1;
    step(hh0, hh1, st, 0, st, 1, kt == 0);
    // HH of the next stage's step 0 (after the last stage a product of this
    // one, unused, so that every step has the same shape)
    const unsigned char* nst = st;
    if (u + 1 < nstages) {
      enter();
      nst = smem + next * S::STAGE;
    }
    step(hh1, hh0, st, 1, nst, 0, false);

    // dot tile complete: online-softmax epilogue. It reads X after the
    // wait and writes no product's registers (X restarts at the next
    // tile's first step), so a step that skips it keeps its products in
    // flight without a register copy
    if (kt == nk - 1) {
      wgmma_wait<0>();
      const float* const sbias = reinterpret_cast<const float*>(st + 2 * S::Q + 2 * S::K);
      const float* const svals = sbias + BP;
      const int64_t p0 = tiles.tile(ti) * BP;
      // accumulator element 4 j + e: row lr[e / 2], column
      // wc * 64 + j * 8 + 2 t4 + (e % 2)
      auto logit = [&](int j, int e) {
        const int col = wc * 64 + j * 8 + 2 * t4 + (e & 1);
        return p0 + col < P
                   ? fmaf(acc_hh[4 * j + e] + acc_x[4 * j + e], dotscale, sbias[col])
                   : NEG_INF;
      };
      float* const rmax = rmax_s + (ti & 1) * 2 * BQ;  // a tile's readers never meet the next's writers
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], logit(j, e));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (t4 == 0) rmax[wc * BQ + lr[i]] = mx[i];
      }
      // the two warps of warp row wr, one of each warpgroup (64 threads)
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wr), "r"(64) : "memory");
      float m_safe[2], scale[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], fmaxf(rmax[lr[i]], rmax[BQ + lr[i]]));
        m_safe[i] = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
        scale[i] = (m[i] <= NEG_INF * 0.5f) ? 0.f : exp2f(m[i] - m_safe[i]);
        if constexpr (MODE != FAST_MMA) {
          s1[i] *= scale[i];
          if constexpr (T::ROWSUM) {
#pragma unroll
            for (int cc = 0; cc < C; ++cc) s2[i][cc] *= scale[i];
          }
        }
        m[i] = m_new;
      }
      auto ex = [&](int j, int e) {
        const float x = logit(j, e) - m_safe[e >> 1];
        return T::BF16_EXP ? fast_exp(x) : exp2f(x);
      };
      if constexpr (T::ROWSUM) {
        float t1[2] = {0.f, 0.f}, t2[2][C];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int cc = 0; cc < C; ++cc) t2[i][cc] = 0.f;
        // per column its C values (bf16(v) with the bf16 exponential), read
        // once for both rows; each row's sums take the columns in order
#pragma unroll
        for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = wc * 64 + j * 8 + 2 * t4 + h;
            float v[C];
#pragma unroll
            for (int cc = 0; cc < C; ++cc)
              v[cc] = T::BF16_EXP ? bf16r(svals[col * C + cc]) : svals[col * C + cc];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float x = ex(j, 2 * i + h);
              t1[i] += x;
#pragma unroll
              for (int cc = 0; cc < C; ++cc)
                t2[i][cc] = T::BF16_EXP ? t2[i][cc] + bf16r(x * v[cc]) : fmaf(x, v[cc], t2[i][cc]);
            }
          }
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc_hh[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s1[i] += t1[i];
#pragma unroll
          for (int cc = 0; cc < C; ++cc) s2[i][cc] += t2[i][cc];
        }
      } else if constexpr (MODE == FAST_MMA) {
        // e @ [V | 1 | 0..]: B[k][n] of k16 step s is V'[r0 + k][n], r0 the
        // step's first bank row in the warpgroup's 64
        auto vb = [&](int p, int n) {
          return n < C ? bf16r(svals[p * C + n]) : (n == C ? 1.f : 0.f);
        };
        float tv[NV][4];
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < 4; ++e) tv[nv][e] = 0.f;
#pragma unroll
        for (int s = 0; s < NACC / 8; ++s) {
          // n8 blocks 2s, 2s+1 are the k16 A fragment: a0 (g, k 2t4..),
          // a1 (g+8, k 2t4..), a2 (g, k 2t4+8..), a3 (g+8, k 2t4+8..)
          float x[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) x[h][e] = ex(2 * s + h, e);
          const uint32_t a[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[0][2], x[0][3]),
                                 pack_bf16(x[1][0], x[1][1]), pack_bf16(x[1][2], x[1][3])};
          const int r0 = wc * 64 + s * 16 + 2 * t4;
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            const int n = nv * 8 + g;
            mma_bf16(tv[nv], a, pack_bf16(vb(r0, n), vb(r0 + 1, n)),
                     pack_bf16(vb(r0 + 8, n), vb(r0 + 9, n)));
          }
        }
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc_hh[i] = 0.f;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < 4; ++e) sv[nv][e] = fmaf(sv[nv][e], scale[e >> 1], tv[nv][e]);
      } else {
        // the wide modes: e of the tile, its fp32 row sums, and e to shared
        // memory (SIMT) or the A fragments of the value product (MMAV; n8
        // blocks 2s, 2s+1 are k16 step s, as in FAST_MMA; hi and, SPLITV,
        // lo parts)
        float t1[2] = {0.f, 0.f};
        uint32_t ah[T::MMAV ? NACC / 8 : 1][4], al[T::SPLITV ? NACC / 8 : 1][4];
#pragma unroll
        for (int s = 0; s < NACC / 8; ++s) {
          float x[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 2 * s + h;
              x[h][e] = ex(j, e);
              t1[e >> 1] += x[h][e];
              if constexpr (T::SIMT)
                vt.e[lr[e >> 1] * ValueTile::ES + wc * 64 + j * 8 + 2 * t4 + (e & 1)] = x[h][e];
            }
          if constexpr (T::MMAV) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if constexpr (T::SPLITV) {
                split_pair(x[h][0], x[h][1], ah[s][2 * h], al[s][2 * h]);
                split_pair(x[h][2], x[h][3], ah[s][2 * h + 1], al[s][2 * h + 1]);
              } else {
                ah[s][2 * h] = pack_bf16(x[h][0], x[h][1]);
                ah[s][2 * h + 1] = pack_bf16(x[h][2], x[h][3]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc_hh[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) s1[i] += t1[i];
        if constexpr (T::SIMT) {
          if (owner) {
#pragma unroll
            for (int i = 0; i < 2; ++i) vt.scale[lr[i]] = scale[i];
          }
          __syncthreads();
          vt.accumulate(values, w.vstride, p0, P, c, w.rule, w.s2_out + row0 * c, nrows, tid);
        } else {
          float* const slab = wc == 0 ? w.s2_out : part;  // this warpgroup's state rows
          const int cp = (c + 7) / 8 * 8;
          for (int g0 = 0; g0 < c; g0 += CG) {
            __syncthreads();  // every read of the values staged before is done
            for (int i = tid; i < BP * CG; i += NT) {
              const int64_t p = p0 + i / CG;
              const int ch = g0 + i % CG;
              const float v = (p < P && ch < c) ? values[p * w.vstride + ch] : 0.f;
              const __nv_bfloat16 hi = __float2bfloat16_rn(v);
              mt.vh[(i % CG) * VSTR + i / CG] = hi;
              if constexpr (T::SPLITV)
                mt.vl[(i % CG) * VSTR + i / CG] = __float2bfloat16_rn(v - __bfloat162float(hi));
            }
            __syncthreads();
            const int n_nv = min(CG, cp - g0) / 8;
            for (int nv = 0; nv < n_nv; ++nv) {
              float tv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int s = 0; s < NACC / 8; ++s) {
                // B fragments: bank rows r0, r0+1 (b0) and r0+8, r0+9 (b1)
                // of value column n = g of n8 tile nv
                const int vo = (nv * 8 + g) * VSTR + wc * 64 + s * 16 + 2 * t4;
                const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(&mt.vh[vo]);
                const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(&mt.vh[vo + 8]);
                mma_bf16(tv, ah[s], bh0, bh1);
                if constexpr (T::SPLITV) {
                  const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(&mt.vl[vo]);
                  const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(&mt.vl[vo + 8]);
                  mma_bf16(tv, ah[s], bl0, bl1);
                  mma_bf16(tv, al[s], bh0, bh1);
                }
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int64_t r = row0 + lr[e >> 1];
                const int ch = g0 + nv * 8 + 2 * t4 + (e & 1);
                if (r < row_end && ch < c) {
                  float& x = slab[r * c + ch];
                  x = fmaf(x, scale[e >> 1], tv[e]);
                }
              }
            }
          }
        }
      }
    }

    if (++kt == nk) {
      kt = 0;
      ++ti;
    }
    slot = next;
  }
  wgmma_wait<0>();
  cdt_splitbank::cp_async_wait<0>();

  if constexpr (MODE == FAST_MMA) {
    // warpgroup 1 hands its partial sums to warpgroup 0
    if (wc == 1) {
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part_s[lr[e >> 1] * PW + nv * 8 + 2 * t4 + (e & 1)] = sv[nv][e];
    }
    __syncthreads();
    if (wc == 0) {
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t r = row0 + lr[e >> 1];
          const int col = nv * 8 + 2 * t4 + (e & 1);
          const float v = sv[nv][e] + part_s[lr[e >> 1] * PW + col];
          if (r < row_end) {
            if (col < C) w.s2_out[r * C + col] = v;
            if (col == C) w.s1_out[r] = v;
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t r = row0 + lr[i];
        if (t4 == 0 && r < row_end) w.m_out[r] = m[i];
      }
    }
  } else {
    // sum the per-thread partials of each row (all under the same m): over
    // the quad by shuffles, then warpgroup 1 hands its sums to warpgroup 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
        if constexpr (T::ROWSUM) {
#pragma unroll
          for (int cc = 0; cc < C; ++cc) s2[i][cc] += __shfl_xor_sync(0xffffffffu, s2[i][cc], o);
        }
      }
      if (wc == 1 && t4 == 0) {
        part_s[lr[i] * PW] = s1[i];
        if constexpr (T::ROWSUM) {
#pragma unroll
          for (int cc = 0; cc < C; ++cc) part_s[lr[i] * PW + 1 + cc] = s2[i][cc];
        }
      }
    }
    __syncthreads();
    if (owner) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t r = row0 + lr[i];
        if (r < row_end) {
          w.m_out[r] = m[i];
          w.s1_out[r] = s1[i] + part_s[lr[i] * PW];
          if constexpr (T::ROWSUM) {
#pragma unroll
            for (int cc = 0; cc < C; ++cc)
              w.s2_out[r * C + cc] = s2[i][cc] + part_s[lr[i] * PW + 1 + cc];
          }
        }
      }
    }
    // MMAV: the two warpgroups' state rows, complete since the barrier
    if constexpr (T::MMAV) {
      for (int i = tid; i < nrows * c; i += NT) w.s2_out[row0 * c + i] += part[row0 * c + i];
    }
  }
}

// Scratch layout (the wrapper allocates it, ops/flash_score.py
// `scratch_numel`): the partials [nsplit][M][2 + c] float32 (K2's per-row
// sums, `launch_ws`; MMAV keeps warpgroup 1's state rows [M][c] there),
// rounded up to 4 floats, then the planes qh, ql [M][dp] and kh, kl [P][dp]
// bf16.
struct Scratch {
  float* part;
  uint32_t *qh, *ql, *kh, *kl;
};

// The passes before a launch's main loop, on the stream: the queries and
// the chunk split into their planes in the scratch, and with per-seed
// weights (live not null, K5) the seeds' live-tile flags
inline cudaError_t split_inputs(const void* q, const void* bias, const void* bank, int64_t M,
                                int64_t rps, int64_t P, int d, int c, int64_t nsplit,
                                int* live, void* scratch, Scratch& sc, cudaStream_t stream) {
  static_assert(BP == SPLIT_TILE, "the live-tile flags are per SPLIT_TILE rows");
  const int dp = padded(d);
  sc.part = (float*)scratch;
  sc.qh = (uint32_t*)(sc.part + (nsplit * M * (2 + c) + 3) / 4 * 4);
  sc.ql = sc.qh + M * dp / 2;
  sc.kh = sc.ql + M * dp / 2;
  sc.kl = sc.kh + P * dp / 2;
  constexpr int T = 256;
  auto blocks = [](int64_t n) {
    const int64_t b = (n + T - 1) / T;
    return (unsigned)(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);
  };
  split_planes_kernel<<<blocks(M * dp / 2), T, 0, stream>>>((const float*)q, M, d, dp, sc.qh,
                                                           sc.ql);
  split_planes_kernel<<<blocks(P * dp / 2), T, 0, stream>>>((const float*)bank, P, d, dp, sc.kh,
                                                           sc.kl);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && live != nullptr)  // K5: the live-tile flags of the seeds
    err = cdt_splitbank::live_tiles<BP>(bias, M / rps, P, live, stream);
  return err;
}

// This loop's modes take split_rows >= P, one split.
template <int C, int MODE>
int launch(const void* q, const void* bias, const void* bank, const void* values,
           float dotscale, int64_t M, int64_t rps, int64_t P, int d, const int* mask,
           int64_t mask_stride, int* live, int* walked, void* scratch, int64_t split_rows,
           const State& w, cudaStream_t stream) {
  const int64_t nsplit = cdt_splitbank::n_splits(P, split_rows);
  const int dp = padded(d);
  Scratch sc;
  cudaError_t err =
      split_inputs(q, bias, bank, M, rps, P, d, w.c, nsplit, live, scratch, sc, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((rps + BQ - 1) / BQ), (unsigned)(M / rps), (unsigned)nsplit);
  const bool list = mask != nullptr || live != nullptr;
  // this loop's instantiations (the warp-specialised loop's kernel is an
  // overload of the same name)
  using Kernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*, const uint32_t*,
                          const float*, const float*, float, float*, int64_t, int64_t, int64_t,
                          int, int64_t, const int*, int64_t, const int*, int*, State);
  const Kernel kernel = list ? (Kernel)rows_kernel<C, MODE, true>
                             : (Kernel)rows_kernel<C, MODE, false>;
  // LIST: room for the tile list of a split
  const size_t smem = Smem<C, MODE>::alloc +
      (list ? 4 * cdt_splitbank::split_tiles_ints<BP>(split_rows < P ? split_rows : P) : 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(
      sc.qh, sc.ql, sc.kh, sc.kl, (const float*)bias, (const float*)values, dotscale, sc.part,
      M, rps, P, dp, split_rows, mask, mask_stride, live, walked, w);
  return (int)cudaGetLastError();
}

// K2's per-row sums (HIGH_VPU): the warp-specialised loop of
// flash_score_split_ws.cuh, which K2's entry point includes; the arguments
// are `launch`'s
template <int C>
int launch_ws(const void* q, const void* bias, const void* bank, const void* values,
              float dotscale, int64_t M, int64_t rps, int64_t P, int d, const int* mask,
              int64_t mask_stride, int* live, int* walked, void* scratch, int64_t split_rows,
              const State& w, cudaStream_t stream);

// the launch of mode MODE at c = C: HIGH_VPU on the warp-specialised loop,
// the others on this one
template <int C, int MODE, typename... A>
int launch_mode(A... a) {
  if constexpr (MODE == HIGH_VPU) return launch_ws<C>(a...);
  else return launch<C, MODE>(a...);
}

// launch_mode<c, MODE> for the per-row modes' c in 1 .. 8
template <int MODE, typename... A>
int launch_c(int c, A... a) {
  switch (c) {
    case 1: return launch_mode<1, MODE>(a...);
    case 2: return launch_mode<2, MODE>(a...);
    case 3: return launch_mode<3, MODE>(a...);
    case 4: return launch_mode<4, MODE>(a...);
    case 5: return launch_mode<5, MODE>(a...);
    case 6: return launch_mode<6, MODE>(a...);
    case 7: return launch_mode<7, MODE>(a...);
    case 8: return launch_mode<8, MODE>(a...);
  }
  return (int)cudaErrorInvalidValue;
}

// The checks and the routing of the C entry points (BF16_EXP: the 'default'
// kernel's bf16 exponential, else K2's fp32 exp2): launches on `stream`
// without synchronising; returns cudaGetLastError() after the launches
// (0 = launched). bias is [M / rows_per_seed, P]; rows_per_seed = M for 1-D
// weights. mask is null or, with 1-D weights only, the int32 skip mask
// [ceil(M / PRUNE_ROWS), mask_stride] (K6). live is null (walk every tile)
// or, with per-seed weights, an int32 workspace [M / rows_per_seed,
// ceil(P / BP)] that the launch fills with the live-tile flags and walks by
// (K5); not both. walked is null or int32, one per thread block (x fastest,
// then seed, then split): the tiles each walked, written by the list walks
// (K5, K6) only. strategy: 0 'vpu', 1 'mxu1'
// (bf16 exponential only), 2 'inbank' (values may be null; V =
// bank[:, col0 : col0 + c]), 3 'mxu'. Up to 8 channels, 'vpu' (and with the
// bf16 exponential 'mxu1' and 'inbank') keep their per-row sums; the rest
// take the wide modes (flash_score_split.cuh). scratch is the float32
// scratch of `launch`; split_rows the rows per split of K2's per-row sums
// (ops/flash_score.py `split_plan`), which the other modes do not read.
template <bool BF16_EXP>
int sweep(const void* q, const void* bias, const void* bank, const void* values,
          float dotscale, const void* m_in, const void* s1_in, const void* s2_in,
          void* m_out, void* s1_out, void* s2_out, long long M, long long rows_per_seed,
          long long P, int d, int c, const void* mask, long long mask_stride, int strategy,
          int col0, void* scratch, long long split_rows, void* live, void* walked,
          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaSuccess;
  if (rows_per_seed <= 0 || M % rows_per_seed != 0 ||
      M / rows_per_seed > 65535 || c < 1 || strategy < 0 || strategy > 3 ||
      (strategy == 1 && !BF16_EXP) || scratch == nullptr ||
      (strategy == 2 && (col0 < 0 || col0 + c > d)) ||
      (mask != nullptr &&
       (rows_per_seed != M || mask_stride < (P + PRUNE_BLOCK - 1) / PRUNE_BLOCK)) ||
      (mask != nullptr && live != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* mk = (const int*)mask;
  int* const lv = (int*)live;
  int* const wk = (int*)walked;
  // V is the values [P, c] or the bank's center columns
  const bool inbank = strategy == 2;
  const void* vals = inbank ? (const void*)((const float*)bank + col0) : values;
  State w{inbank ? (int64_t)d : (int64_t)c, c,
          BF16_EXP ? (int)cdt_vals::V_BF16_PRODUCT : (int)cdt_vals::V_FP32,
          (const float*)m_in, (const float*)s1_in, (const float*)s2_in,
          (float*)m_out, (float*)s1_out, (float*)s2_out};
  if constexpr (!BF16_EXP) {
    if (strategy == 0 && c <= 8) {  // K2's per-row sums, split
      if (!cdt_splitbank::valid_split(P, split_rows)) return (int)cudaErrorInvalidValue;
      return launch_c<HIGH_VPU>(c, q, bias, bank, vals, dotscale, (int64_t)M,
                                (int64_t)rows_per_seed, (int64_t)P, d, mk,
                                (int64_t)mask_stride, lv, wk, scratch, (int64_t)split_rows, w,
                                s);
    }
  }
  // one split, from the carried state
  const int64_t whole = P > 0 ? P : 1;
  auto wide = [&](auto mode) {
    return launch<0, decltype(mode)::value>(q, bias, bank, vals, dotscale, M, rows_per_seed,
                                            P, d, mk, mask_stride, lv, wk, scratch, whole, w,
                                            s);
  };
  if constexpr (BF16_EXP) {
    if (c <= 8 && strategy == 0)
      return launch_c<FAST_VPU>(c, q, bias, bank, vals, dotscale, (int64_t)M,
                                (int64_t)rows_per_seed, (int64_t)P, d, mk,
                                (int64_t)mask_stride, lv, wk, scratch, whole, w, s);
    if (c <= 8)  // 'mxu1', 'inbank': e @ [V | 1] per row
      return launch_c<FAST_MMA>(c, q, bias, bank, vals, dotscale, (int64_t)M,
                                (int64_t)rows_per_seed, (int64_t)P, d, mk,
                                (int64_t)mask_stride, lv, wk, scratch, whole, w, s);
    if (strategy == 0)  // 'vpu' past 8 channels: bf16(e * bf16(v))
      return wide(std::integral_constant<int, SIMT_FAST>{});
    return wide(std::integral_constant<int, MMAV_FAST>{});  // bf16(e) @ bf16(V)
  } else {
    if (inbank)  // the split product eh.vh + eh.vl + el.vh
      return wide(std::integral_constant<int, MMAV_SPLIT>{});
    return wide(std::integral_constant<int, SIMT_HIGH>{});  // 'mxu', 'vpu' past 8: fp32
  }
}

}  // namespace cdt_split_rows

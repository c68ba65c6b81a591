// Fused flash-score sweep after fp32 dots ('highest' tier), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel convolutional_diffusion_tpu/ops/flash_score.py
// `_kernel` / `_kernel_body` (the one `pl.pallas_call` of that package) in
// its precision='highest' variants: v_strategy='vpu' with the fp32 exp2
// (variant K1), the matrix value sums 'mxu' (e @ V, any c; what 'auto'
// takes at c > 8) and 'inbank' (e @ the bank tile's center columns, no
// values operand), both K4, and the bf16 exponential after fp32 dots
// (fast_exp=True at 'highest', K3) in 'vpu', 'mxu1', 'inbank' and 'mxu';
// each with 1-D weights or per-seed weights (variant K5: the JAX wrapper's
// vmap of the kernel over seeds, `flash_score_update` with 2-D w and
// rows_per_seed), and with 1-D weights the prune skip bit (variant K6:
// `_kernel`'s `prune` branch, one skip flag per query block and bank block).
//
// What it computes, for queries q [M, d] against one bank chunk K [P, d] with
// per-patch bias [P] and values V [P, C], carrying an online-softmax state
// (m [M], s1 [M], s2 [M, C]) in base-2 log space:
//   logit[r, p] = dot(q[r], K[p]) * dotscale + bias[p]
//   m_new  = max(m, max_p logit)
//   s1     = s1 * 2^(m - m_new) + sum_p 2^(logit - m_new)
//   s2[c]  = s2[c] * 2^(m - m_new) + sum_p 2^(logit - m_new) * V[p, c]
// The wrapper (ops/flash_score.py) folds -a^2 |p|^2 / (2 beta^2) * log2(e)
// and log2(w) into `bias` (-1e30 where w = 0) and moves the per-query
// -|q|^2 / (2 beta^2) offset into m, exactly as the TPU wrapper does. Rows
// whose max is still the -1e30 sentinel keep exp offsets from 0, so a tile of
// excluded patches leaves the state exactly unchanged.
//
// Per-seed weights (K5): the M query rows are S = M / rows_per_seed
// seed-major blocks and `bias` is [S, P]; seed s's rows use bias row s.
// Every grid has a seed axis: a block owns rows of one seed (up to the
// seed's end) and stages one bias row. 1-D weights are the case S = 1,
// rows_per_seed = M, and walk every tile. With per-seed weights a pass
// (split_bank.cuh `live_tiles`) first flags, per seed and 128-row tile,
// whether the seed's bias admits any of the tile's patches, and each block
// walks only its seed's live tiles (under a label filter about one in ten:
// the patches of the seed's label's images). A dead tile would leave the
// state bit for bit as it was, so the result is the walk over every tile's.
// The bound counts the work of the live (seed, tile) pairs: the 1-D
// kernel's for the same M, P, d times their share, and the bias bytes
// S * P.
//
// What bounds it on an H100: the QK^T dot, 2*M*P*d operations, in true fp32.
// The 1/(2 beta^2) logit scale turns a TF32 or bf16 rounding (2^-10 .. 2^-9)
// into ~19% posterior error, so the dot cannot use the tensor cores as they
// are; it runs as fp32 FFMA, 67 TFLOP/s published. The bank chunk is read
// once per query block but stays far below the 3.35 TB/s memory rate.
//
// One main loop for every variant (namespace `rows` below), on the
// split-bank grid (split_bank.cuh): block (x, s, z) owns BQ query rows of
// seed s and the bank tiles of split z, computes BQ x 128 dot tiles as a
// register-blocked SGEMM (8 x 8 per thread at BQ = 128) staged through a
// ring of cp.async slots, and hands each finished tile to one of three
// epilogues (template parameter EPI):
//  PER_ROW    'vpu', c <= 8 (template C), fp32 exp2: every launch of the
//             'highest' ELS, pruned and conditional machines. Row sums in
//             shared memory, the tile's values staged with its last stage.
//  WIDE       'mxu', 'inbank', 'vpu' past 8 channels, fp32 exp2, any c at
//             runtime: per chunk of CV = 16 channels of V staged in shared
//             memory (the bank's center columns through a row stride of d
//             for 'inbank'), row by row, each thread sums e * V over its 8
//             columns, the row's 16 threads add their sums by shuffles, and
//             the split's partial s2 rows in the scratch take
//             s2 * scale + sum, one rounding per tile, as the TPU kernel's
//             per-block product does. Nothing in shared memory grows with
//             c, and a row's accumulators are free once its sums are taken,
//             so the block keeps the ring and two blocks per SM at any
//             c <= 256.
//  WIDE_FAST  the bf16 exponential e = bf16(expf(bf16(bf16(x) * bf16(ln 2))))
//             of x = logit - m in every strategy, any c: m is re-based once
//             per 128-row bank tile, and x is rounded against the m of its
//             tile, so the bank axis is never split; the block starts from
//             the carried state and writes the new one (s2 in the output
//             rows), BQ = 64 so that M = 8192 still gives 128 blocks. The
//             products follow the JAX kernel's dtypes (value_sums.cuh
//             rules): 'vpu' bf16(e * bf16(v)), 'mxu'/'mxu1' e * bf16(v),
//             'inbank' e * v (HIGHEST promotes the bf16 e); s1 is the fp32
//             row sum ('mxu1' is 'mxu' here).
// The other epilogues write their split's partial state, and a merge pass
// folds the splits into the carried state in order. Every copy of a stage
// lands in its feature-major place ([feature][row], stride BQ + 4 floats),
// so the transpose costs no register round trip and no store instruction,
// and a thread reads per feature two float4s of the query tile and two of
// the bank tile for 64 FFMAs (one float4 for 32 at BQ = 64).
//
// The numbers: each dot is the fp32 FMA chain over the features 0 .. d-1
// in order, then fmaf(acc, dotscale, bias), so every variant's logits are
// the bits of the per-block loop the port ran before (`fs.fp32_logits_in_
// order` repeats them); only the order of the fp32 sums s1 and s2 changes
// (per tile across a row's 16 threads, then across splits in the merge).
// The walk (template parameter LIST, split_bank.cuh `split_tiles`): every
// tile of the split with 1-D weights; a list of tiles built once per block
// with per-seed weights (K5: its seed's live tiles) or a prune mask (K6: a
// block of 128 rows covers two PRUNE_ROWS mask rows and walks the tiles
// either keeps). The LIST instantiations stage each tile's bias once per
// mask row (NB copies), -inf in the copy of a mask row that skips the tile,
// so the epilogue is the unmasked one with the half's bias row: a skipped
// cell's logit is -inf, whose row max and exponential are those of the
// plain version's -1e30 masked cell, and a split whose tiles are all
// skipped leaves the state as it was. Both walks keep two blocks per SM.
// Offsets formed from row indices are 64-bit. Built without fast-math:
// exp2f and the dot stay full fp32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_bank.cuh"
#include "value_sums.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

namespace rows {

enum Epi { PER_ROW = 0, WIDE = 1, WIDE_FAST = 2 };

constexpr int BP = 128;     // bank rows per tile
constexpr int BK = 16;      // features per stage
constexpr int NT = 256;     // threads: 16 row groups x 16 column groups
constexpr int TJ = 8;       // columns per thread: 4 tx + j, 64 + 4 tx + j
constexpr int STAGES = 4;   // ring slots: STAGES - 1 stages in flight
constexpr int LB = BP + 4;  // feature-major strides in floats: float4 reads,
                            // 2-way bank conflicts on the copies' writes
constexpr int CV = 16;      // channels of V per chunk of the wide value sums
constexpr int VS = CV + 4;  // their row stride in floats: 8 consecutive rows' float4s
                            // fall in 8 distinct bank groups

// query rows per block (two PRUNE_ROWS mask rows; one with the bf16
// exponential, which cannot split the bank axis) and rows per thread
template <int EPI>
struct Rows {
  static constexpr int BQ = EPI == WIDE_FAST ? K1_FAST_BQ : K1_SPLIT_BQ;
  static constexpr int TI = BQ / 16;
  static constexpr int LA = BQ + 4;
};
static_assert(Rows<PER_ROW>::BQ == 128 && Rows<WIDE_FAST>::BQ == 64,
              "ops/_build.py SPLIT_BQ holds these blocks' rows");
static_assert(PRUNE_ROWS == 64, "rows 4 h .. 4 h + 3 of a thread lie in mask row h");

// -inf: the staged bias of a mask row that skips a listed tile
__device__ __forceinline__ float neg_inf() { return __int_as_float((int)0xff800000u); }

// the thread's i-th row (rows 4 ty + i of each 64-row half) and j-th column
// of the tile
__device__ __forceinline__ int row_of(int ty, int i) { return (i / 4) * 64 + 4 * ty + i % 4; }
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 60) + 4 * tx + j; }
// the staged row of bank row p in a chunk of values: rows p, p + 4, .. in
// consecutive slots, so the 8 threads of a quarter warp (columns 4 tx + j)
// read 8 consecutive rows; the thread's j-th column is row
// vslot(col_of(tx, j)) = tx + the constant jslot(j)
__device__ __forceinline__ int vslot(int p) { return (p & 3) * (BP / 4) + (p >> 2); }
__device__ __forceinline__ int jslot(int j) { return (j & 3) * (BP / 4) + (j >> 2) * 16; }

// dynamic shared memory in floats: STAGES slots of (queries [BK][LA],
// bank rows [BK][LB], bias [NB][BP], values [BP][C]), then the row state
// [BQ][W1], each row's kept by its tx == 0 thread: (s1, s2) per row, or in
// the wide epilogues (s1, m: registers are the 128-register budget of two
// blocks per SM), then the wide epilogues' values of one chunk [BP][VS],
// then (LIST) the tile list. NB: the bias copies, one per mask row of the
// block when LIST (a listed tile's skipped rows read -inf), else one.
template <int C, int EPI, bool LIST>
struct Smem {
  static constexpr int A = BK * Rows<EPI>::LA, B = BK * LB;
  static constexpr int NB = LIST ? cdt_splitbank::SplitTiles<Rows<EPI>::BQ, BP, true>::ROWS : 1;
  static_assert(NB == 1 || NB * BP == NT, "one thread stages each bias entry");
  static constexpr int W1 = EPI == PER_ROW ? 1 + C : 2;
  static constexpr int STAGE = A + B + NB * BP + BP * C;
  static_assert(STAGE % 4 == 0, "slots stay 16-byte aligned");
  static constexpr int ROWS = STAGES * STAGE;  // the row state
  static constexpr int VALS = ROWS + Rows<EPI>::BQ * W1;
  static_assert(VALS % 4 == 0, "float4 reads of a chunk's values");
  static constexpr int WORDS = VALS + (EPI == PER_ROW ? 0 : BP * VS);  // then the K6 tile list
  static constexpr size_t bytes = sizeof(float) * (size_t)WORDS;
};

// the wide epilogues' operands: V (values [P, c], or the bank's center
// columns) with its row stride, c, the product rule, and WIDE_FAST's
// carried state in and out
struct Wide {
  const float* vals;
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

template <int C, int EPI, bool LIST>
__global__ void __launch_bounds__(NT, 2) rows_kernel(
    const float* __restrict__ q, const float* __restrict__ bias,
    const float* __restrict__ bank, const float* __restrict__ values,
    float dotscale, float* __restrict__ part, int64_t M, int64_t rps,
    int64_t P, int d, int64_t split_rows, const int* __restrict__ mask,
    int64_t mask_stride, const int* __restrict__ tile_live, int* __restrict__ walked,
    Wide w) {
  constexpr int BQ = Rows<EPI>::BQ, TI = Rows<EPI>::TI, LA = Rows<EPI>::LA;
  constexpr bool CARRY = EPI == WIDE_FAST;  // from the carried state, no split
  using S = Smem<C, EPI, LIST>;
  constexpr int NB = S::NB;
  constexpr int W1 = S::W1;
  using cdt_splitbank::cp_async;
  extern __shared__ float4 dyn_smem[];
  float* const smem = reinterpret_cast<float*>(dyn_smem);
  float* const st = smem + S::ROWS;
  float* const vs = smem + S::VALS;  // wide: one chunk's values [BP][VS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t seed = blockIdx.y;
  const int64_t row0 = seed * rps + (int64_t)blockIdx.x * BQ;
  const int64_t seed_end = (seed + 1) * rps;
  const int64_t row_end = row0 + BQ < seed_end ? row0 + BQ : seed_end;
  bias += seed * P;
  // this split's tiles (K5: its seed's live ones; K6: the ones its mask
  // rows keep; listed after the block's other shared memory)
  const int64_t split = blockIdx.z;
  const int64_t p_begin = split * split_rows;
  const int64_t p_end = p_begin + split_rows < P ? p_begin + split_rows : P;
  const auto tiles = cdt_splitbank::split_tiles<BQ, BP, LIST, NT>(
      mask, mask_stride, tile_live == nullptr ? nullptr : tile_live + seed * ((P + BP - 1) / BP),
      row0,
      (M + PRUNE_ROWS - 1) / PRUNE_ROWS, p_begin / BP, (p_end + BP - 1) / BP,
      reinterpret_cast<int*>(smem) + S::WORDS);
  if (LIST && walked != nullptr && tid == 0)  // a 1-D walk takes every tile of its split
    walked[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = tiles.n;
  const int nk = (d + BK - 1) / BK;
  const int c = EPI == PER_ROW ? C : w.c;
  const int rule = EPI == WIDE ? (int)cdt_vals::V_FP32 : w.rule;
  // the wide epilogues' s2 rows: the carried state's or the split's partials
  float* const s2blk = CARRY ? w.s2_out + row0 * c : part + (split * M + row0) * (2 + c) + 2;
  const int s2stride = CARRY ? c : 2 + c;

  // m of each row: registers (PER_ROW) or the row state's second entry
  float m[TI];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int lr = row_of(ty, i);
    const bool live = row0 + lr < row_end;
    if constexpr (EPI == PER_ROW) m[i] = NEG_INF;
    if (tx == 0) {
#pragma unroll
      for (int cc = 0; cc < W1; ++cc) st[lr * W1 + cc] = 0.f;
      if (CARRY && live) st[lr * W1] = w.s1_in[row0 + lr];
      if (EPI != PER_ROW) st[lr * W1 + 1] = CARRY && live ? w.m_in[row0 + lr] : NEG_INF;
    }
    if constexpr (EPI != PER_ROW) {  // s2 of channel ch belongs to thread tx = ch % CV
      if (live)
        for (int ch = tx; ch < c; ch += CV)
          s2blk[lr * s2stride + ch] = CARRY ? w.s2_in[(row0 + lr) * c + ch] : 0.f;
    }
  }

  // The per-row epilogue's copies: copy j of a thread stages feature cf of
  // row cr + j * RS of the query block and of the bank tile (NT is a
  // multiple of BK), two indices for all copies. With one index pair per
  // copy, as the wide epilogues keep (where two indices spilled more), the
  // per-row list walk spilled past the 128-register budget of two blocks
  // per SM (PERF.md §6).
  constexpr int RS = NT / BK;
  const int cr = tid / BK, cf = tid % BK;
  const int nrows = (int)(row_end - row0);
  const float* const qrow = q + (row0 + cr) * d + cf;
  // stage (entry i's tile, kt) into ring slot `slot`; zeros past the rows
  // and features
  auto load = [&](int slot, int i, int kt) {
    float* const sa = smem + slot * S::STAGE;
    float* const sb = sa + S::A;
    const int k0 = kt * BK;
    const int64_t p0 = tiles.tile(i) * BP;
    if constexpr (EPI == PER_ROW) {
      const bool fin = k0 + cf < d;
#pragma unroll
      for (int j = 0; j < BQ / RS; ++j)
        cp_async<4>(sa + cf * LA + cr + j * RS, qrow + (int64_t)(j * RS) * d + k0, q,
                    cr + j * RS < nrows && fin);
      const float* const brow = bank + (p0 + cr) * d + cf;
#pragma unroll
      for (int j = 0; j < BP / RS; ++j)
        cp_async<4>(sb + cf * LB + cr + j * RS, brow + (int64_t)(j * RS) * d + k0, bank,
                    p0 + cr + j * RS < P && fin);
    } else {
#pragma unroll
      for (int j = 0; j < BQ * BK / NT; ++j) {
        const int e = tid + j * NT;
        const int r = e / BK, kk = e % BK;
        const int64_t gr = row0 + r;
        cp_async<4>(sa + kk * LA + r, q + gr * d + k0 + kk, q, gr < row_end && k0 + kk < d);
      }
#pragma unroll
      for (int j = 0; j < BP * BK / NT; ++j) {
        const int e = tid + j * NT;
        const int r = e / BK, kk = e % BK;
        const int64_t p = p0 + r;
        cp_async<4>(sb + kk * LB + r, bank + p * d + k0 + kk, bank, p < P && k0 + kk < d);
      }
    }
    if (kt == nk - 1) {  // the tile's bias (LIST: copy h is mask row h's) and values
      float* const sbias = sb + S::B;
      float* const sv = sbias + NB * BP;
      if constexpr (NB > 1) {  // every thread: -inf where its mask row skips the tile
        const int col = tid % BP;
        if (tiles.skipped(i, tid / BP))
          sbias[tid] = neg_inf();  // the slot is free; a barrier precedes its reads
        else
          cp_async<4>(sbias + tid, bias + p0 + col, bias, p0 + col < P);
      } else if (tid < BP) {
        cp_async<4>(sbias + tid, bias + p0 + tid, bias, p0 + tid < P);
      }
      for (int e = tid; e < BP * C; e += NT)
        cp_async<4>(sv + e, values + p0 * C + e, values, p0 * C + e < P * C);
    }
  };

  float acc[TI][TJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;

  // the producer runs STAGES - 1 stages ahead of the consumer over the same
  // sequence: (pt, kt) for the split's live tiles pt, kt = 0 .. nk - 1
  int pi = 0, pkt = 0, pslot = 0;
  auto issue = [&]() {
    if (pi < tiles.n) {
      load(pslot, pi, pkt);
      if (++pkt == nk) {
        pkt = 0;
        ++pi;
      }
    }
    cdt_splitbank::cp_async_commit();  // an empty group past the end
    pslot = pslot + 1 == STAGES ? 0 : pslot + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();

  int ti = 0, kt = 0, slot = 0;
  while (ti < tiles.n) {
    cdt_splitbank::cp_async_wait<STAGES - 2>();  // this thread's copies of the stage
    __syncthreads();  // everyone's copies landed; the slot issued next is free
    issue();

    const float* const sa = smem + slot * S::STAGE;
    const float* const sb = sa + S::A;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {  // features in order
      float av[TI];
#pragma unroll
      for (int h = 0; h < TI / 4; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(sa + kk * LA + 64 * h + 4 * ty);
        av[4 * h] = a.x;
        av[4 * h + 1] = a.y;
        av[4 * h + 2] = a.z;
        av[4 * h + 3] = a.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * LB + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * LB + 64 + 4 * tx);
      const float bv[TJ] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }

    if (kt == nk - 1) {  // dot tile complete: online-softmax epilogue
      const float* const sbias = sb + S::B;
      const int64_t p0 = tiles.tile(ti) * BP;
      if constexpr (EPI == PER_ROW) {
        const float* const sv = sbias + NB * BP;
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          const int lr = row_of(ty, i);
          const float* const sbi = sbias + (NB > 1 ? (i / 4) * BP : 0);  // row i's mask row's copy
          float lg[TJ];
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const int col = col_of(tx, j);
            lg[j] = p0 + col < P ? fmaf(acc[i][j], dotscale, sbi[col]) : NEG_INF;
            mx = fmaxf(mx, lg[j]);
            acc[i][j] = 0.f;
          }
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[i], mx);
          const float m_safe = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
          const float scale = (m[i] <= NEG_INF * 0.5f) ? 0.f : exp2f(m[i] - m_safe);
          float t1 = 0.f, t2[C];
#pragma unroll
          for (int cc = 0; cc < C; ++cc) t2[cc] = 0.f;
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const int col = col_of(tx, j);
            const float e = exp2f(lg[j] - m_safe);
            t1 += e;
#pragma unroll
            for (int cc = 0; cc < C; ++cc) t2[cc] = fmaf(e, sv[col * C + cc], t2[cc]);
          }
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) {
            t1 += __shfl_xor_sync(0xffffffffu, t1, o);
#pragma unroll
            for (int cc = 0; cc < C; ++cc) t2[cc] += __shfl_xor_sync(0xffffffffu, t2[cc], o);
          }
          if (tx == 0) {
            float* const sr = st + lr * W1;
            sr[0] = fmaf(sr[0], scale, t1);
#pragma unroll
            for (int cc = 0; cc < C; ++cc) sr[1 + cc] = fmaf(sr[1 + cc], scale, t2[cc]);
          }
          m[i] = m_new;
        }
      } else {
        // The wide sums, row by row as the per-row epilogue: the row's
        // exponentials (its accumulators are free from then on, so the
        // 128-register budget of two blocks per SM holds) and s1, then per
        // chunk of CV channels of V staged in shared memory its sums e @ V
        // over its 8 columns, 4 channels at a time, added across the row's
        // 16 threads, and s2 <- s2 * scale + sum by the thread that owns
        // the channel. Up to CV channels the chunk is staged once per tile,
        // past them once per row and chunk.
        const bool once = c <= CV;
        // stage channels g0 .. g0 + CV of the tile's values (those below c)
        auto stage = [&](int g0) {
          const int cw = min(CV, (c - g0 + 3) / 4 * 4);
          __syncthreads();  // the chunk staged before is read
          for (int e = tid; e < BP * cw; e += NT) {
            const int p = e / cw, ch = g0 + e % cw;
            const float x = (p0 + p < P && ch < c) ? w.vals[(p0 + p) * w.vstride + ch] : 0.f;
            vs[vslot(p) * VS + e % cw] = rule == cdt_vals::V_FP32 ? x : cdt_vals::bf16r(x);
          }
          __syncthreads();
        };
        if (once) stage(0);
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          const int lr = row_of(ty, i);
          const float* const sbi = sbias + (NB > 1 ? (i / 4) * BP : 0);
          float ex[TJ];
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const int col = col_of(tx, j);
            ex[j] = p0 + col < P ? fmaf(acc[i][j], dotscale, sbi[col]) : NEG_INF;
            mx = fmaxf(mx, ex[j]);
            acc[i][j] = 0.f;
          }
          const float m_old = st[lr * W1 + 1];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m_old, mx);
          const float m_safe = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
          const float scale = (m_old <= NEG_INF * 0.5f) ? 0.f : exp2f(m_old - m_safe);
          float t1 = 0.f;
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const float x = ex[j] - m_safe;
            ex[j] = EPI == WIDE_FAST ? cdt_vals::fast_exp(x) : exp2f(x);
            t1 += ex[j];
          }
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) t1 += __shfl_xor_sync(0xffffffffu, t1, o);
          if (tx == 0) {
            st[lr * W1] = fmaf(st[lr * W1], scale, t1);
            st[lr * W1 + 1] = m_new;
          }
          const bool live = row0 + lr < row_end;
          for (int g0 = 0; g0 < c; g0 += CV) {
            if (!once) stage(g0);
#pragma unroll
            for (int q4 = 0; q4 < CV / 4; ++q4) {
              if (g0 + 4 * q4 >= c) break;
              float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int j = 0; j < TJ; ++j) {
                const float4 x = *reinterpret_cast<const float4*>(vs + (tx + jslot(j)) * VS + 4 * q4);
                const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  t[u] = rule == cdt_vals::V_BF16_PRODUCT ? t[u] + cdt_vals::bf16r(ex[j] * v[u])
                                                          : fmaf(ex[j], v[u], t[u]);
              }
#pragma unroll
              for (int o = 8; o > 0; o >>= 1)
#pragma unroll
                for (int u = 0; u < 4; ++u) t[u] += __shfl_xor_sync(0xffffffffu, t[u], o);
              // channel g0 + tx belongs to thread tx
              if ((tx >> 2) == q4 && g0 + tx < c && live) {
                const int u = tx & 3;
                const float tv = u == 0 ? t[0] : u == 1 ? t[1] : u == 2 ? t[2] : t[3];
                float* const s2 = s2blk + lr * s2stride + g0 + tx;
                *s2 = fmaf(*s2, scale, tv);
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
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  cdt_splitbank::cp_async_wait<0>();

  // the state of the block's rows: the split's partial, or the new state
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int lr = row_of(ty, i);
      const int64_t r = row0 + lr;
      if (r < row_end) {
        const float mi = EPI == PER_ROW ? m[i] : st[lr * W1 + 1];
        if constexpr (CARRY) {
          w.m_out[r] = mi;
          w.s1_out[r] = st[lr * W1];
        } else {
          float* const o = part + (split * M + r) * (2 + c);
          o[0] = mi;
          o[1] = st[lr * W1];
#pragma unroll
          for (int cc = 0; cc < C; ++cc) o[2 + cc] = st[lr * W1 + 1 + cc];
        }
      }
    }
  }
}

// the sweep (K5: after the live-tile flags of its seeds), then (but
// WIDE_FAST) the merge of its splits into (m_out, s1_out, s2_out); scratch
// holds the partials [nsplit][M][2 + c]
template <int C, int EPI>
int launch(const void* q, const void* bias, const void* bank, const void* values,
           float dotscale, int64_t M, int64_t rps, int64_t P, int d, const int* mask,
           int64_t mask_stride, int* live, int* walked, void* scratch, int64_t split_rows,
           const Wide& w, cudaStream_t stream) {
  static_assert(BP == SPLIT_TILE, "the live-tile flags are per SPLIT_TILE rows");
  constexpr int BQ = Rows<EPI>::BQ;
  const int64_t nsplit = cdt_splitbank::n_splits(P, split_rows);
  const dim3 grid((unsigned)((rps + BQ - 1) / BQ), (unsigned)(M / rps), (unsigned)nsplit);
  const bool list = mask != nullptr || live != nullptr;
  auto kernel = list ? rows_kernel<C, EPI, true> : rows_kernel<C, EPI, false>;
  // LIST: room for the tile list of a split
  const size_t smem =
      (list ? Smem<C, EPI, true>::bytes +
                  4 * cdt_splitbank::split_tiles_ints<BP>(split_rows < P ? split_rows : P)
            : Smem<C, EPI, false>::bytes);
  if (live != nullptr) {
    const cudaError_t e = cdt_splitbank::live_tiles<BP>(bias, M / rps, P, live, stream);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)bias, (const float*)bank, (const float*)values,
      dotscale, (float*)scratch, M, rps, P, d, split_rows, mask, mask_stride, live, walked, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || EPI == WIDE_FAST) return (int)err;
  return (int)cdt_splitbank::merge_splits(w.m_in, w.s1_in, w.s2_in, (const float*)scratch,
                                          w.m_out, w.s1_out, w.s2_out, M, (int)nsplit,
                                          w.c, stream);
}

}  // namespace rows

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and does not
// synchronise; returns cudaGetLastError() after the launches (0 = launched).
// bias is [M / rows_per_seed, P]; rows_per_seed = M for 1-D weights. mask is
// null or, with 1-D weights only, the int32 skip mask
// [ceil(M / PRUNE_ROWS), mask_stride] (K6, see the top). live is null (walk
// every tile) or, with per-seed weights, an int32 workspace
// [M / rows_per_seed, ceil(P / 128)] that the launch fills with the live-tile
// flags and walks by (K5); not both. walked is null or int32, one per thread
// block (x fastest, then seed, then split): the tiles each walked, written by
// the list walks (K5, K6) only. strategy: 0 'vpu',
// 1 'mxu1' (bf16 exponential only), 2 'inbank' (values may be null; V =
// bank[:, col0 : col0 + c]), 3 'mxu'; fast 1 for the bf16 exponential.
// With the fp32 exp2 the sweep splits the bank axis: scratch is float32
// [nsplit][M][2 + c] with nsplit = ceil(P / split_rows) (at least 1), which
// the wrapper allocates (ops/flash_score.py `split_plan`,
// `scratch_numel`); with the bf16 exponential it takes neither.
extern "C" int flash_score_f32(const void* q, const void* bias,
                               const void* bank, const void* values,
                               float dotscale, const void* m_in,
                               const void* s1_in, const void* s2_in,
                               void* m_out, void* s1_out, void* s2_out,
                               long long M, long long rows_per_seed,
                               long long P, int d, int c, const void* mask,
                               long long mask_stride, int strategy, int col0,
                               int fast, void* scratch, long long split_rows,
                               void* live, void* walked, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaSuccess;
  if (rows_per_seed <= 0 || M % rows_per_seed != 0 ||
      M / rows_per_seed > 65535 || c < 1 || strategy < 0 || strategy > 3 ||
      (strategy == 1 && !fast) ||
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
  const rows::Wide w{inbank ? (const float*)bank + col0 : (const float*)values,
                     inbank ? (int64_t)d : (int64_t)c,
                     c,
                     !fast ? cdt_vals::V_FP32
                     : strategy == 0 ? cdt_vals::V_BF16_PRODUCT
                     : inbank ? cdt_vals::V_FP32 : cdt_vals::V_BF16,
                     (const float*)m_in, (const float*)s1_in, (const float*)s2_in,
                     (float*)m_out, (float*)s1_out, (float*)s2_out};
  if (fast)  // one split, from the carried state
    return rows::launch<0, rows::WIDE_FAST>(q, bias, bank, values, dotscale, M, rows_per_seed,
                                            P, d, mk, mask_stride, lv, wk, nullptr,
                                            P > 0 ? P : 1, w, s);
  if (scratch == nullptr || !cdt_splitbank::valid_split(P, split_rows))
    return (int)cudaErrorInvalidValue;
  if (strategy == 0 && c <= 8) {  // per-row 'vpu' sums
    switch (c) {
#define CDT_CASE(CC)                                                                  \
  case CC:                                                                            \
    return rows::launch<CC, rows::PER_ROW>(q, bias, bank, values, dotscale, M,        \
                                           rows_per_seed, P, d, mk, mask_stride, lv,  \
                                           wk, scratch, split_rows, w, s);
      CDT_CASE(1)
      CDT_CASE(2)
      CDT_CASE(3)
      CDT_CASE(4)
      CDT_CASE(5)
      CDT_CASE(6)
      CDT_CASE(7)
      CDT_CASE(8)
#undef CDT_CASE
    }
  }
  return rows::launch<0, rows::WIDE>(q, bias, bank, values, dotscale, M, rows_per_seed, P, d,
                                     mk, mask_stride, lv, wk, scratch, split_rows, w, s);
}

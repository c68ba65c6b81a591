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
// rows_per_seed = M. The bound is the 1-D kernel's for the same M, P, d;
// only the bias bytes grow to S * P.
//
// What bounds it on an H100: the QK^T dot, 2*M*P*d operations, in true fp32.
// The 1/(2 beta^2) logit scale turns a TF32 or bf16 rounding (2^-10 .. 2^-9)
// into ~19% posterior error, so the dot cannot use the tensor cores as they
// are; it runs as fp32 FFMA, 67 TFLOP/s published. The bank chunk is read
// once per query block but stays far below the 3.35 TB/s memory rate.
//
// Per-row sums ('vpu', c <= 8, fp32 exp2: every launch of the 'highest'
// ELS, pruned and conditional machines) run on the split-bank grid
// (split_bank.cuh, namespace `rows` below): block (x, s, z) owns 128 query
// rows of seed s and the bank tiles of split z, computes 128 x 128 dot
// tiles as a register-blocked SGEMM (8 x 8 per thread) staged through a
// ring of cp.async slots, writes its partial state, and a merge pass folds
// the splits into the carried state in order. The dot is the fp32 FMA chain
// over the features in order, so the logits are the bits the per-block
// design before it gave (`fs.fp32_logits_in_order` repeats them). Prune mask
// (K6, the PRUNE instantiation): a block of 128 rows covers two PRUNE_ROWS
// mask rows and walks the tiles either keeps; inside a walked tile the rows
// of a mask row that skips it take -1e30 logits, so the result is the
// plain version's with its masked cells, and a split whose tiles are all
// skipped leaves the state as it was.
//
// Wide value sums (the WIDE instantiations: 'mxu', 'inbank', 'vpu' past 8
// channels, and every strategy with the bf16 exponential) keep the
// per-block design (flash_score_f32_kernel): one block of 64 query rows
// walks the whole chunk, 4 x 8 microtile per thread, the next stage's loads
// issued into registers before the current stage's FFMAs and stored
// transposed; the K6 walk of prune_tiles.cuh. s2 [BQ, c] lives in dynamic
// shared memory and each bank tile's exponentials go through shared memory
// into a small fp32 product e @ V (value_sums.cuh ValueTile), so any c runs
// without an instantiation per c. The product rule follows the JAX
// kernel's dtypes: fp32 products with the fp32 exp2 (every strategy); with
// the bf16 exponential e = bf16(expf(bf16(bf16(x) * bf16(ln 2)))) of
// x = logit - m, 'vpu' rounds each product e * bf16(v) to bf16,
// 'mxu'/'mxu1' take the exact products e * bf16(v), and 'inbank' e * v with
// v in fp32 (HIGHEST promotes the bf16 e). 'mxu1' is 'mxu' here: s1 is the
// fp32 row sum either way. m is re-based once per 128-row bank tile, which
// with the bf16 exponential is part of the function (x is rounded against
// the tile's m), so those never split the bank axis; the plain version
// re-bases at the same rows. 'inbank' reads the center columns col0 ..
// col0 + c of each bank row from device memory (the rows the tile just
// staged, so from L2) through a row stride of d. Offsets formed from row
// indices are 64-bit. Built without fast-math: exp2f and the dot stay full
// fp32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prune_tiles.cuh"
#include "split_bank.cuh"
#include "value_sums.cuh"

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BP = 128;     // bank rows per tile
constexpr int BK = 16;      // features per shared-memory stage
constexpr int NT = 256;     // threads: 16 row groups x 16 column groups
constexpr int TM = 4;       // rows per thread
constexpr int TN = 8;       // columns per thread: tx*4 + j and 64 + tx*4 + j
constexpr int AS = BQ + 4;  // padded strides: float4-aligned reads, at most
constexpr int BS = BP + 4;  // 2-way bank conflicts on the transposing store
constexpr int QL = BQ * BK / NT;  // query elements each thread stages
constexpr int KL = BP * BK / NT;  // bank elements each thread stages
constexpr float NEG_INF = -1e30f;

using ValueTile = cdt_vals::ValueTile<BQ, BP, NT>;

// The wide value sums (s2 in shared memory, runtime c, `rule`); FAST: the
// bf16 exponential. The per-row sums run on the split-bank grid (`rows`).
template <bool FAST, bool PRUNE>
__global__ void __launch_bounds__(NT) flash_score_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ bias,
    const float* __restrict__ bank, const float* __restrict__ values,
    float dotscale, const float* __restrict__ m_in,
    const float* __restrict__ s1_in, const float* __restrict__ s2_in,
    float* __restrict__ m_out, float* __restrict__ s1_out,
    float* __restrict__ s2_out, int64_t rps, int64_t P, int d,
    const int* __restrict__ mask, int64_t mask_stride, int c_wide,
    int64_t vstride, int rule) {

  __shared__ __align__(16) float As[BK][AS];
  __shared__ __align__(16) float Bs[BK][BS];
  __shared__ float bias_s[BP];
  extern __shared__ float4 dyn_smem[];  // ValueTile
  const ValueTile vt(reinterpret_cast<float*>(dyn_smem));

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // this block's rows: [row0, row_end), inside seed blockIdx.y's rows
  const int64_t seed = blockIdx.y;
  const int64_t row0 = seed * rps + (int64_t)blockIdx.x * BQ;
  const int64_t seed_end = (seed + 1) * rps;
  const int64_t row_end = row0 + BQ < seed_end ? row0 + BQ : seed_end;
  bias += seed * P;  // the seed's bias row

  // Carried state. m is the same in all 16 threads of a row; s1 is a
  // per-thread partial sum under that m (thread tx == 0 starts from the
  // carried value), summed across the row's threads at exit; s2 lives in
  // shared memory (ValueTile).
  float m[TM], s1[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty * TM + i;
    const bool live = r < row_end;
    m[i] = live ? m_in[r] : NEG_INF;
    s1[i] = (live && tx == 0) ? s1_in[r] : 0.f;
  }
  vt.load_state(s2_in, row0, row_end, c_wide, tid);

  const int nk = (d + BK - 1) / BK;
  // the live bank tiles (all of them without a mask), K6
  const cdt_prune::TileWalk<BQ, BP, PRUNE> tiles(mask, mask_stride, blockIdx.x, P);

  float rq[QL], rk[KL], rb = NEG_INF;

  // global -> registers for stage (pt, kt); zero / sentinel past the edges
  auto load = [&](int64_t pt, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < QL; ++j) {
      const int e = tid + j * NT;
      const int64_t r = row0 + (e / BK);
      const int kk = k0 + (e % BK);
      rq[j] = (r < row_end && kk < d) ? q[r * d + kk] : 0.f;
    }
    const int64_t p0 = pt * BP;
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      const int e = tid + j * NT;
      const int64_t p = p0 + (e / BK);
      const int kk = k0 + (e % BK);
      rk[j] = (p < P && kk < d) ? bank[p * d + kk] : 0.f;
    }
    if (kt == 0) rb = (tid < BP && p0 + tid < P) ? bias[p0 + tid] : NEG_INF;
  };
  // registers -> shared memory, transposed so the FFMA loop reads float4s
  auto store = [&](int kt) {
#pragma unroll
    for (int j = 0; j < QL; ++j) {
      const int e = tid + j * NT;
      As[e % BK][e / BK] = rq[j];
    }
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      const int e = tid + j * NT;
      Bs[e % BK][e / BK] = rk[j];
    }
    if (kt == 0 && tid < BP) bias_s[tid] = rb;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // stages (pt, kt) over the live tiles pt, kt = 0 .. nk-1; stage (first
  // live tile, 0) is loaded before the loop, each next stage's loads are
  // issued before the current stage's FFMAs. Without PRUNE every tile is
  // live and the loop counts its n_it stages, as it did before the mask.
  const int64_t n_it = tiles.n_pt * nk;
  int64_t pt = tiles.live(0);
  if (PRUNE ? pt < tiles.n_pt : n_it > 0) {
    load(pt, 0);
    store(0);
  }
  __syncthreads();

  int kt = 0;
  for (int64_t it = 0; PRUNE ? pt < tiles.n_pt : it < n_it; ++it) {
    const int kt_next = (kt + 1 == nk) ? 0 : kt + 1;
    const int64_t pt_next = (kt + 1 == nk) ? tiles.live(pt + 1) : pt;
    const bool has_next = PRUNE ? pt_next < tiles.n_pt : it + 1 < n_it;
    if (has_next) load(pt_next, kt_next);

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }

    if (kt == nk - 1) {  // dot tile complete: online-softmax epilogue
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float lg[TN];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
          lg[j] = fmaf(acc[i][j], dotscale, bias_s[col]);
          mx = fmaxf(mx, lg[j]);
          acc[i][j] = 0.f;
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float m_safe = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
        const float scale =
            (m[i] <= NEG_INF * 0.5f) ? 0.f : exp2f(m[i] - m_safe);
        float t1 = 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
          const float e =
              FAST ? cdt_vals::fast_exp(lg[j] - m_safe) : exp2f(lg[j] - m_safe);
          t1 += e;
          vt.e[(ty * TM + i) * ValueTile::ES + col] = e;
        }
        s1[i] = s1[i] * scale + t1;
        if (tx == 0) vt.scale[ty * TM + i] = scale;
        m[i] = m_new;
      }
      // s2 <- s2 * scale + e @ V of this tile
      __syncthreads();
      vt.accumulate(values, vstride, pt * BP, P, c_wide, rule, tid);
    }

    __syncthreads();  // every thread is done reading this stage
    if (has_next) store(kt_next);
    __syncthreads();
    kt = kt_next;
    pt = pt_next;
  }

  // sum the per-thread partials of s1 of each row (all under the same m)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
    const int64_t r = row0 + ty * TM + i;
    if (tx == 0 && r < row_end) {
      m_out[r] = m[i];
      s1_out[r] = s1[i];
    }
  }
  // the loop's last __syncthreads ordered every update of the shared s2
  vt.store_state(s2_out, row0, row_end, c_wide, tid);
}

template <bool FAST>
int launch(const void* q, const void* bias, const void* bank,
           const void* values, float dotscale, const void* m_in,
           const void* s1_in, const void* s2_in, void* m_out, void* s1_out,
           void* s2_out, int64_t M, int64_t rps, int64_t P, int d,
           const int* mask, int64_t mask_stride, int c, int64_t vstride,
           int rule, cudaStream_t stream) {
  const dim3 grid((unsigned)((rps + BQ - 1) / BQ), (unsigned)(M / rps));
  auto kernel = mask != nullptr ? flash_score_f32_kernel<FAST, true>
                                : flash_score_f32_kernel<FAST, false>;
  const size_t smem = ValueTile::bytes(c);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)bias, (const float*)bank,
      (const float*)values, dotscale, (const float*)m_in,
      (const float*)s1_in, (const float*)s2_in, (float*)m_out,
      (float*)s1_out, (float*)s2_out, rps, P, d, mask, mask_stride, c,
      vstride, rule);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The per-row sweep ('vpu', c <= 8, fp32 exp2; K1 with K5 and K6) on the
// split-bank grid (split_bank.cuh): block (x, s, z) owns BQ = 128 query rows
// of seed s and the bank tiles of split z, and writes its partial state to
// the scratch; merge_splits folds the partials into the carried state.
// 256 threads, each an 8 x 8 microtile (rows 4 ty + i and 64 + 4 ty + i,
// columns 4 tx + j and 64 + 4 tx + j). Tiles of BP bank rows are staged BK
// features at a time through a ring of STAGES shared-memory slots filled by
// 4-byte cp.async (rows of d = k^2 c floats are never 16-byte aligned on
// the RGB path), one barrier per stage: the copies of STAGES - 1 stages are
// in flight while a stage's FFMAs run. Each copy lands in its feature-major
// place ([feature][row], stride 132 floats), so the transpose costs no
// register round trip and no store instruction, and a thread reads per
// feature two float4s of the query tile and two of the bank tile for 64
// FFMAs.
//
// The numbers are the parent's: each dot is the fp32 FMA chain over the
// features 0 .. d-1 in order, then fmaf(acc, dotscale, bias), so the logits
// are the same bits; only the order of the fp32 sums s1 and s2 changes
// (per tile across the row's 16 threads, then across splits in the merge).
namespace rows {

constexpr int BQ = 128;     // query rows per block (two PRUNE_ROWS mask rows)
static_assert(BQ == K1_SPLIT_BQ, "ops/_build.py SPLIT_BQ holds this block's rows");
constexpr int BP = 128;     // bank rows per tile
constexpr int BK = 16;      // features per stage
constexpr int NT = 256;     // threads: 16 row groups x 16 column groups
constexpr int TI = 8;       // rows per thread: 4 ty + i, 64 + 4 ty + i
constexpr int TJ = 8;       // columns per thread: 4 tx + j, 64 + 4 tx + j
constexpr int STAGES = 4;   // ring slots: STAGES - 1 stages in flight
constexpr int LA = BQ + 4;  // feature-major strides in floats: float4 reads,
constexpr int LB = BP + 4;  // 2-way bank conflicts on the copies' writes
static_assert(PRUNE_ROWS == BQ / 2, "rows i < 4 lie in mask row 0, the rest in 1");

// the thread's i-th row and j-th column of the 128 x 128 tile
__device__ __forceinline__ int row_of(int ty, int i) { return (i < 4 ? 0 : 60) + 4 * ty + i; }
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 60) + 4 * tx + j; }

// dynamic shared memory in floats: STAGES slots of (queries [BK][LA],
// bank rows [BK][LB], bias [BP], values [BP][C]), then the row sums
// [BQ][1 + C] (s1, s2), each row's kept by its tx == 0 thread
template <int C>
struct Smem {
  static constexpr int A = BK * LA, B = BK * LB;
  static constexpr int STAGE = A + B + BP + BP * C;
  static_assert(STAGE % 4 == 0, "slots stay 16-byte aligned");
  static constexpr int WORDS = STAGES * STAGE + BQ * (1 + C);  // then the K6 tile list
  static constexpr size_t bytes = sizeof(float) * (size_t)WORDS;
};

template <int C, bool PRUNE>
__global__ void __launch_bounds__(NT, PRUNE ? 1 : 2) rows_kernel(
    const float* __restrict__ q, const float* __restrict__ bias,
    const float* __restrict__ bank, const float* __restrict__ values,
    float dotscale, float* __restrict__ part, int64_t M, int64_t rps,
    int64_t P, int d, int64_t split_rows, const int* __restrict__ mask,
    int64_t mask_stride) {
  using S = Smem<C>;
  using cdt_splitbank::cp_async;
  extern __shared__ float4 dyn_smem[];
  float* const smem = reinterpret_cast<float*>(dyn_smem);
  float* const st = smem + STAGES * S::STAGE;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t seed = blockIdx.y;
  const int64_t row0 = seed * rps + (int64_t)blockIdx.x * BQ;
  const int64_t seed_end = (seed + 1) * rps;
  const int64_t row_end = row0 + BQ < seed_end ? row0 + BQ : seed_end;
  bias += seed * P;
  // this split's tiles
  const int64_t split = blockIdx.z;
  const int64_t p_begin = split * split_rows;
  const int64_t p_end = p_begin + split_rows < P ? p_begin + split_rows : P;
  // the split's tiles (K6: the ones its mask rows keep, listed after the
  // block's other shared memory)
  const auto tiles = cdt_splitbank::split_tiles<BQ, BP, PRUNE>(
      mask, mask_stride, row0, (M + PRUNE_ROWS - 1) / PRUNE_ROWS, p_begin / BP,
      (p_end + BP - 1) / BP, reinterpret_cast<int*>(smem) + S::WORDS);
  const int nk = (d + BK - 1) / BK;

  float m[TI];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    m[i] = NEG_INF;
    if (tx == 0) {
#pragma unroll
      for (int c = 0; c <= C; ++c) st[row_of(ty, i) * (1 + C) + c] = 0.f;
    }
  }

  // stage (pt, kt) into ring slot `slot`; zeros past the rows and features
  auto load = [&](int slot, int64_t pt, int kt) {
    float* const sa = smem + slot * S::STAGE;
    float* const sb = sa + S::A;
    const int k0 = kt * BK;
    const int64_t p0 = pt * BP;
#pragma unroll
    for (int j = 0; j < BQ * BK / NT; ++j) {
      const int e = tid + j * NT;
      const int r = e / BK, kk = e % BK;
      const int64_t gr = row0 + r;
      cp_async<4>(sa + kk * LA + r, q + gr * d + k0 + kk, q,
                  gr < row_end && k0 + kk < d);
    }
#pragma unroll
    for (int j = 0; j < BP * BK / NT; ++j) {
      const int e = tid + j * NT;
      const int r = e / BK, kk = e % BK;
      const int64_t p = p0 + r;
      cp_async<4>(sb + kk * LB + r, bank + p * d + k0 + kk, bank,
                  p < P && k0 + kk < d);
    }
    if (kt == nk - 1) {  // the tile's bias and values, read by its epilogue
      float* const sbias = sb + S::B;
      float* const sv = sbias + BP;
      if (tid < BP) cp_async<4>(sbias + tid, bias + p0 + tid, bias, p0 + tid < P);
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
      load(pslot, tiles.tile(pi), pkt);
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
      const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * LA + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + kk * LA + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * LB + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * LB + 64 + 4 * tx);
      const float av[TI] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TJ] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }

    if (kt == nk - 1) {  // dot tile complete: online-softmax epilogue
      const float* const sbias = sb + S::B;
      const float* const sv = sbias + BP;
      const int64_t p0 = tiles.tile(ti) * BP;
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        // K6: rows of a mask row that skips this tile take -1e30 logits
        const bool dead = tiles.skipped(ti, i < 4 ? 0 : 1);
        float lg[TJ];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int col = col_of(tx, j);
          lg[j] = (!dead && p0 + col < P) ? fmaf(acc[i][j], dotscale, sbias[col]) : NEG_INF;
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
        for (int c = 0; c < C; ++c) t2[c] = 0.f;
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int col = col_of(tx, j);
          const float e = exp2f(lg[j] - m_safe);
          t1 += e;
#pragma unroll
          for (int c = 0; c < C; ++c) t2[c] = fmaf(e, sv[col * C + c], t2[c]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
          t1 += __shfl_xor_sync(0xffffffffu, t1, o);
#pragma unroll
          for (int c = 0; c < C; ++c) t2[c] += __shfl_xor_sync(0xffffffffu, t2[c], o);
        }
        if (tx == 0) {
          float* const sr = st + row_of(ty, i) * (1 + C);
          sr[0] = fmaf(sr[0], scale, t1);
#pragma unroll
          for (int c = 0; c < C; ++c) sr[1 + c] = fmaf(sr[1 + c], scale, t2[c]);
        }
        m[i] = m_new;
      }
    }

    if (++kt == nk) {
      kt = 0;
      ++ti;
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  cdt_splitbank::cp_async_wait<0>();

  // this split's partial state of the block's rows
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int lr = row_of(ty, i);
      const int64_t r = row0 + lr;
      if (r < row_end) {
        float* const o = part + (split * M + r) * (2 + C);
        o[0] = m[i];
#pragma unroll
        for (int c = 0; c <= C; ++c) o[1 + c] = st[lr * (1 + C) + c];
      }
    }
  }
}

// the sweep, then the merge of its splits into (m_out, s1_out, s2_out);
// scratch holds the partials [nsplit][M][2 + C]
template <int C>
int launch(const void* q, const void* bias, const void* bank, const void* values,
           float dotscale, const void* m_in, const void* s1_in, const void* s2_in,
           void* m_out, void* s1_out, void* s2_out, int64_t M, int64_t rps,
           int64_t P, int d, const int* mask, int64_t mask_stride, void* scratch,
           int64_t split_rows, cudaStream_t stream) {
  const int64_t nsplit = cdt_splitbank::n_splits(P, split_rows);
  const dim3 grid((unsigned)((rps + BQ - 1) / BQ), (unsigned)(M / rps), (unsigned)nsplit);
  auto kernel = mask != nullptr ? rows_kernel<C, true> : rows_kernel<C, false>;
  // K6: room for the tile list of a split
  const size_t smem = Smem<C>::bytes +
      (mask != nullptr ? 4 * cdt_splitbank::split_tiles_ints<BP>(
                                 split_rows < P ? split_rows : P)
                       : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)bias, (const float*)bank, (const float*)values,
      dotscale, (float*)scratch, M, rps, P, d, split_rows, mask, mask_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cdt_splitbank::merge_splits<C>(m_in, s1_in, s2_in, (const float*)scratch,
                                             m_out, s1_out, s2_out, M, (int)nsplit,
                                             stream);
}

}  // namespace rows

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and does not
// synchronise; returns cudaGetLastError() after the launches (0 = launched).
// bias is [M / rows_per_seed, P]; rows_per_seed = M for 1-D weights. mask is
// null or, with 1-D weights only, the int32 skip mask
// [ceil(M / PRUNE_ROWS), mask_stride] (K6, see the top). strategy: 0 'vpu',
// 1 'mxu1' (bf16 exponential only), 2 'inbank' (values may be null; V =
// bank[:, col0 : col0 + c]), 3 'mxu'; fast 1 for the bf16 exponential.
// The per-row sums ('vpu', c <= 8, fp32 exp2) run on the split-bank grid:
// scratch is float32 [nsplit][M][2 + c] with nsplit = ceil(P / split_rows)
// (at least 1), which the wrapper allocates (ops/flash_score.py
// `split_plan`); the wide instantiations take neither.
extern "C" int flash_score_f32(const void* q, const void* bias,
                               const void* bank, const void* values,
                               float dotscale, const void* m_in,
                               const void* s1_in, const void* s2_in,
                               void* m_out, void* s1_out, void* s2_out,
                               long long M, long long rows_per_seed,
                               long long P, int d, int c, const void* mask,
                               long long mask_stride, int strategy, int col0,
                               int fast, void* scratch, long long split_rows,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaSuccess;
  if (rows_per_seed <= 0 || M % rows_per_seed != 0 ||
      M / rows_per_seed > 65535 || c < 1 || strategy < 0 || strategy > 3 ||
      (strategy == 1 && !fast) ||
      (strategy == 2 && (col0 < 0 || col0 + c > d)) ||
      (mask != nullptr &&
       (rows_per_seed != M || mask_stride < (P + PRUNE_BLOCK - 1) / PRUNE_BLOCK)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!fast && strategy == 0 && c <= 8) {  // per-row 'vpu' sums, split-bank grid
    if (scratch == nullptr || !cdt_splitbank::valid_split(P, split_rows))
      return (int)cudaErrorInvalidValue;
    switch (c) {
#define CDT_CASE(CC)                                                           \
  case CC:                                                                     \
    return rows::launch<CC>(q, bias, bank, values, dotscale, m_in, s1_in,      \
                            s2_in, m_out, s1_out, s2_out, M, rows_per_seed, P, \
                            d, (const int*)mask, mask_stride, scratch,         \
                            split_rows, s);
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
  // the wide value sums: V is the values [P, c] or the bank's center columns
  const bool inbank = strategy == 2;
  const void* vals = inbank ? (const void*)((const float*)bank + col0) : values;
  const int64_t vstride = inbank ? d : c;
  const int rule = !fast ? cdt_vals::V_FP32
                   : strategy == 0 ? cdt_vals::V_BF16_PRODUCT
                   : inbank ? cdt_vals::V_FP32 : cdt_vals::V_BF16;
  auto wide = fast ? launch<true> : launch<false>;
  return wide(q, bias, bank, vals, dotscale, m_in, s1_in, s2_in, m_out, s1_out,
              s2_out, M, rows_per_seed, P, d, (const int*)mask, mask_stride, c,
              vstride, rule, s);
}

// The bf16x3 split-dot flash-score sweep shared by the 'high' kernel
// (flash_score_bf16x3.cu, variant K2) and the 'default' kernel
// (flash_score_fast.cu, variants K3 and K4 'inbank'): staging, hi/lo split,
// tensor-core products, the exact hi.hi sum and the online softmax are one
// template; the tiers differ only in the exponential and the value sums of
// the epilogue (template parameter MODE).
//
// Design (see flash_score_bf16x3.cu for the numerics of the dot): one
// thread block owns BQ = 64 query rows of one seed and loops over the whole
// chunk; 8 warps, warp (wr, wc) owns query rows 16*wr .. +16 and bank
// columns 64*wc .. +64 of each bank tile of BP (128) rows, i.e. eight m16n8
// accumulator tiles. d is staged BK = 32 features at a time: the next
// stage's fp32 global loads are issued into registers before the current
// stage's mma's, then split into hi/lo bf16 pairs and stored in shared
// memory (row stride 40 bf16 = 20 words: conflict-free fragment reads). The
// per-seed grid (variant K5) is (query block, seed): block (x, s) owns seed
// s's rows x * BQ .. up to the seed's end and stages bias row s; 1-D
// weights are S = 1, rows_per_seed = M.
//
// Prune mask (variant K6, 1-D weights only; the PRUNE instantiation, so an
// unmasked launch walks every tile as before): the block's mask row
// (prune_tiles.cuh) decides which bank tiles it walks. The first stage
// loaded before the loop is the first live tile's, each prefetch targets the
// next live tile, and a block with no live tile writes its carried state
// through unchanged. A skipped tile is not a tile: the 'default' modes
// re-base m only on the tiles they visit, which is what the plain version's
// -1e30 logits on the skipped cells give (m does not move there and every
// exponential is 0).
//
// Epilogue modes:
//  HIGH      fp32 exp2 of the logit, fp32 per-channel sums of e * v (K2);
//  FAST_VPU  e = bf16(expf(bf16(bf16(x) * bf16(ln 2)))), x = logit - m:
//            the JAX lowering of jnp.exp2 on a bf16 array; s1 = sum_f32 e,
//            s2 = sum_f32 bf16(e * bf16(v)) per channel (K3, 'vpu');
//  FAST_MMA  the same e; s2 and s1 as one tensor-core product
//            e @ [V | 1 | 0..] with bf16 operands and fp32 accumulation
//            (K3 'mxu1', K4 'inbank'). The m16n8 accumulator fragments of
//            two adjacent logit tiles are exactly the A fragment of one
//            m16n8k16 product (the FlashAttention-2 register reuse), so each
//            warp turns its 16 x 64 tile of bf16(e) into four k16 steps
//            against a [64 bank rows x 8] bf16 B tile: c value columns, a
//            ones column, zero padding (two n8 tiles for c = 8). Each tile's
//            four steps start from zero and are added into the running sums
//            with fp32 adds after the rescale. V is bf16(values) ('mxu1') or,
//            with col0 >= 0 ('inbank'), the bank's own columns col0 ..
//            col0 + c: their bf16 values are the hi parts the dot already
//            stages, kept aside as their stage is stored, so nothing extra
//            is read from device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prune_tiles.cuh"

namespace cdt_split {

#ifndef SPLIT_TILE
#error "SPLIT_TILE (bank rows per tile) comes from ops/_build.py's nvcc flags"
#endif

constexpr int BQ = 64;        // query rows per block: 4 warp rows x 16
// bank rows per tile: 2 warp columns x 64. Set in ops/_build.py, where the
// plain version reads it too: the 'default' tier re-bases m once per tile.
constexpr int BP = SPLIT_TILE;
constexpr int BK = 32;        // features per shared-memory stage (2 k16 steps)
constexpr int NT = 256;       // threads: 8 warps
constexpr int NTILE = 8;      // m16n8 tiles per warp (64 bank columns)
static_assert(BP == 2 * NTILE * 8, "a tile is 2 warp columns of NTILE n8 tiles");
constexpr int SW = BK / 2 + 4;  // shared row stride in 32-bit words (bf16 pairs)
constexpr int PAIRS = BK / 2;   // feature pairs per row per stage
constexpr int QP = BQ * PAIRS / NT;  // query pairs each thread stages (4)
constexpr int KP = BP * PAIRS / NT;  // bank pairs each thread stages (8)
constexpr int VSTR = BP + 8;  // bf16 row stride of the value tile (68 words:
                              // the B-fragment reads are conflict-free)
constexpr float NEG_INF = -1e30f;
constexpr float LN2_BF16 = 0.69140625f;  // ln 2 rounded to bf16

enum Mode { HIGH = 0, FAST_VPU = 1, FAST_MMA = 2 };

// (a, b) -> bf16 pairs hi = (bf16(a), bf16(b)), lo = (bf16(a - hi.a),
// bf16(b - hi.b)); the lower-indexed feature in the low 16 bits, as the mma
// fragments read them.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// s + e == a + b exactly (Knuth's TwoSum; the intrinsics are never
// contracted or reordered)
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

// c += a(16x16, row) . b(16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to bf16 (to nearest even), as a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the 'default' tier's exponential of x = logit - m <= 0 (see the top)
__device__ __forceinline__ float fast_exp(float x) {
  return bf16r(expf(bf16r(bf16r(x) * LN2_BF16)));
}

// two floats that are bf16 values already -> one bf16 pair (a low)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int C, int MODE, bool PRUNE>
__global__ void __launch_bounds__(NT, 1) split_sweep_kernel(
    const float* __restrict__ q, const float* __restrict__ bias,
    const float* __restrict__ bank, const float* __restrict__ values,
    float dotscale, const float* __restrict__ m_in,
    const float* __restrict__ s1_in, const float* __restrict__ s2_in,
    float* __restrict__ m_out, float* __restrict__ s1_out,
    float* __restrict__ s2_out, int64_t rps, int64_t P, int d, int col0,
    const int* __restrict__ mask, int64_t mask_stride) {
  constexpr int VL = (BP * C + NT - 1) / NT;  // value elements each thread stages
  constexpr int NV = (C + 8) / 8;  // n8 tiles of [V | 1] (FAST_MMA)
  constexpr int VR = MODE == FAST_MMA ? NV * 8 : C;  // rows of the bf16 value tile
  constexpr int PW = MODE == FAST_MMA ? NV * 8 : C + 1;  // exit partials per row
  const bool inbank = MODE == FAST_MMA && col0 >= 0;

  __shared__ __align__(16) uint32_t Qh[BQ][SW];
  __shared__ __align__(16) uint32_t Ql[BQ][SW];
  __shared__ __align__(16) uint32_t Kh[BP][SW];
  __shared__ __align__(16) uint32_t Kl[BP][SW];
  __shared__ float bias_s[BP];
  __shared__ float v_s[MODE == HIGH ? C : 1][BP];  // fp32 values (HIGH)
  __shared__ __align__(16) __nv_bfloat16 vb_s[MODE == HIGH ? 1 : VR][VSTR];
  __shared__ float rmax_s[2][BQ];       // per-tile row max of each column warp
  __shared__ float part_s[BQ][PW];      // column warp 1's partial sums at exit

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp & 3;   // warp row: query rows 16*wr .. 16*wr+15
  const int wc = warp >> 2;  // warp column: tile columns 64*wc .. 64*wc+63
  const int g = lane >> 2;   // mma group: rows g and g+8 of the warp's 16
  const int t4 = lane & 3;   // thread in group: columns 2*t4, 2*t4+1 of an n8 tile
  // this block's rows: [row0, row_end), inside seed blockIdx.y's rows
  const int64_t seed = blockIdx.y;
  const int64_t row0 = seed * rps + (int64_t)blockIdx.x * BQ;
  const int64_t seed_end = (seed + 1) * rps;
  const int64_t row_end = row0 + BQ < seed_end ? row0 + BQ : seed_end;
  bias += seed * P;  // the seed's bias row
  const int lr[2] = {wr * 16 + g, wr * 16 + g + 8};  // this thread's local rows

  // Carried state. m is the same in all 8 threads of a row (4 per column
  // warp); the sums are per-thread partials under that m. HIGH / FAST_VPU:
  // s1, s2 per row, the thread (wc == 0, t4 == 0) starting from the carried
  // values. FAST_MMA: sv in the product's accumulator layout (element e:
  // row lr[e / 2], column 2*t4 + (e % 2) of n8 tile nv; columns < C are s2,
  // column C is s1), column warp 0 starting from the carried values.
  const bool owner = (wc == 0 && t4 == 0);
  float m[2], s1[2], s2[2][C], sv[NV][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = row0 + lr[i];
    const bool live = r < row_end;
    m[i] = live ? m_in[r] : NEG_INF;
    s1[i] = (live && owner) ? s1_in[r] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      s2[i][c] = (live && owner) ? s2_in[r * C + c] : 0.f;
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
          v = col < C ? s2_in[r * C + col] : (col == C ? s1_in[r] : 0.f);
        sv[nv][e] = v;
      }
    // the ones column and the zero padding of [V | 1 | 0..]; rows < C are
    // staged per tile
    for (int e = tid; e < (VR - C) * VSTR; e += NT)
      vb_s[C + e / VSTR][e % VSTR] =
          __float2bfloat16_rn(e / VSTR == 0 ? 1.f : 0.f);
  }

  const int nk = (d + BK - 1) / BK;
  // the live bank tiles (all of them without a mask), K6
  const cdt_prune::TileWalk<BQ, BP, PRUNE> tiles(mask, mask_stride, blockIdx.x, P);

  float rq[QP][2], rk[KP][2], rb = NEG_INF, rv[VL];

  // global -> registers for stage (pt, kt); zero / sentinel past the edges
  auto load = [&](int64_t pt, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < QP; ++j) {
      const int e = tid + j * NT;
      const int64_t r = row0 + e / PAIRS;
      const int kk = k0 + 2 * (e % PAIRS);
      const bool live = r < row_end;
      rq[j][0] = (live && kk < d) ? q[r * d + kk] : 0.f;
      rq[j][1] = (live && kk + 1 < d) ? q[r * d + kk + 1] : 0.f;
    }
    const int64_t p0 = pt * BP;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const int e = tid + j * NT;
      const int64_t p = p0 + e / PAIRS;
      const int kk = k0 + 2 * (e % PAIRS);
      const bool live = p < P;
      rk[j][0] = (live && kk < d) ? bank[p * d + kk] : 0.f;
      rk[j][1] = (live && kk + 1 < d) ? bank[p * d + kk + 1] : 0.f;
    }
    if (kt == 0) {
      rb = (tid < BP && p0 + tid < P) ? bias[p0 + tid] : NEG_INF;
      if (!inbank) {
#pragma unroll
        for (int j = 0; j < VL; ++j) {
          const int e = tid + j * NT;
          rv[j] = (e < BP * C && p0 + e / C < P) ? values[p0 * C + e] : 0.f;
        }
      }
    }
  };
  // registers -> shared memory, split into bf16 hi/lo pairs
  auto store = [&](int kt) {
    // 'inbank': this stage holds some of the center columns
    const bool centers = inbank && kt * BK < col0 + C && col0 < (kt + 1) * BK;
#pragma unroll
    for (int j = 0; j < QP; ++j) {
      const int e = tid + j * NT;
      split_pair(rq[j][0], rq[j][1], Qh[e / PAIRS][e % PAIRS],
                 Ql[e / PAIRS][e % PAIRS]);
    }
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const int e = tid + j * NT;
      split_pair(rk[j][0], rk[j][1], Kh[e / PAIRS][e % PAIRS],
                 Kl[e / PAIRS][e % PAIRS]);
      if (centers) {  // the center columns' hi parts are the bf16 values
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = kt * BK + 2 * (e % PAIRS) + h - col0;
          if (ch >= 0 && ch < C)
            vb_s[ch][e / PAIRS] = __float2bfloat16_rn(rk[j][h]);
        }
      }
    }
    if (kt == 0) {
      if (tid < BP) bias_s[tid] = rb;
      if (!inbank) {
#pragma unroll
        for (int j = 0; j < VL; ++j) {
          const int e = tid + j * NT;
          if (e < BP * C) {
            if constexpr (MODE == HIGH)
              v_s[e % C][e / C] = rv[j];
            else
              vb_s[e % C][e / C] = __float2bfloat16_rn(rv[j]);
          }
        }
      }
    }
  };

  float acc_hh[NTILE][4], acc_x[NTILE][4];
#pragma unroll
  for (int j = 0; j < NTILE; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_hh[j][e] = acc_x[j][e] = 0.f;

  // stages (pt, kt) over the live tiles pt, kt = 0 .. nk-1; stage (first
  // live tile, 0) is loaded before the loop, each next stage's loads are
  // issued before the current stage's mma's. Without PRUNE every tile is
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
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A fragments (rows g, g+8; features 2*t4.. and 2*t4+8..)
      const int w0 = ks * 8 + t4;
      uint32_t ah[4], al[4];
      ah[0] = Qh[lr[0]][w0];
      ah[1] = Qh[lr[1]][w0];
      ah[2] = Qh[lr[0]][w0 + 4];
      ah[3] = Qh[lr[1]][w0 + 4];
      al[0] = Ql[lr[0]][w0];
      al[1] = Ql[lr[1]][w0];
      al[2] = Ql[lr[0]][w0 + 4];
      al[3] = Ql[lr[1]][w0 + 4];
#pragma unroll
      for (int j = 0; j < NTILE; ++j) {
        // B fragments: bank row (column n = g of the tile), same features
        const int br = wc * 64 + j * 8 + g;
        const uint32_t bh0 = Kh[br][w0], bh1 = Kh[br][w0 + 4];
        const uint32_t bl0 = Kl[br][w0], bl1 = Kl[br][w0 + 4];
        // hi.hi: this k16 step from a zero accumulator, added into the
        // running sum by TwoSum; its rounding error joins the cross terms
        float hh[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(hh, ah, bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float err;
          acc_hh[j][e] = two_sum(acc_hh[j][e], hh[e], err);
          acc_x[j][e] = __fadd_rn(acc_x[j][e], err);
        }
        mma_bf16(acc_x[j], ah, bl0, bl1);
        mma_bf16(acc_x[j], al, bh0, bh1);
      }
    }

    if (kt == nk - 1) {  // dot tile complete: online-softmax epilogue
      // accumulator element e of tile j: row lr[e / 2], column
      // wc*64 + j*8 + 2*t4 + (e % 2)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = wc * 64 + j * 8 + 2 * t4 + (e & 1);
          const float lg =
              fmaf(acc_hh[j][e] + acc_x[j][e], dotscale, bias_s[col]);
          mx[e >> 1] = fmaxf(mx[e >> 1], lg);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (t4 == 0) rmax_s[wc][lr[i]] = mx[i];
      }
      __syncthreads();
      float m_safe[2], scale[2], t1[2], t2[2][C];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new =
            fmaxf(m[i], fmaxf(rmax_s[0][lr[i]], rmax_s[1][lr[i]]));
        m_safe[i] = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
        scale[i] = (m[i] <= NEG_INF * 0.5f) ? 0.f : exp2f(m[i] - m_safe[i]);
        if constexpr (MODE != FAST_MMA) {
          s1[i] *= scale[i];
#pragma unroll
          for (int c = 0; c < C; ++c) s2[i][c] *= scale[i];
        }
        m[i] = m_new;
        t1[i] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) t2[i][c] = 0.f;
      }
      if constexpr (MODE != FAST_MMA) {
#pragma unroll
        for (int j = 0; j < NTILE; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int col = wc * 64 + j * 8 + 2 * t4 + (e & 1);
            const float lg =
                fmaf(acc_hh[j][e] + acc_x[j][e], dotscale, bias_s[col]);
            if constexpr (MODE == HIGH) {
              const float ex = exp2f(lg - m_safe[i]);
              t1[i] += ex;
#pragma unroll
              for (int c = 0; c < C; ++c)
                t2[i][c] = fmaf(ex, v_s[c][col], t2[i][c]);
            } else {
              const float ex = fast_exp(lg - m_safe[i]);
              t1[i] += ex;
#pragma unroll
              for (int c = 0; c < C; ++c)
                t2[i][c] += bf16r(ex * __bfloat162float(vb_s[c][col]));
            }
            acc_hh[j][e] = 0.f;
            acc_x[j][e] = 0.f;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s1[i] += t1[i];
#pragma unroll
          for (int c = 0; c < C; ++c) s2[i][c] += t2[i][c];
        }
      } else {
        float tv[NV][4];
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < 4; ++e) tv[nv][e] = 0.f;
#pragma unroll
        for (int s = 0; s < NTILE / 2; ++s) {
          // tiles 2s, 2s+1 (bank rows 16s .. 16s+15 of the warp's 64) are
          // the k16 A fragment: a0 (g, k 2t4..), a1 (g+8, k 2t4..),
          // a2 (g, k 2t4+8..), a3 (g+8, k 2t4+8..)
          float ex[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 2 * s + h;
              const int col = wc * 64 + j * 8 + 2 * t4 + (e & 1);
              const float lg =
                  fmaf(acc_hh[j][e] + acc_x[j][e], dotscale, bias_s[col]);
              ex[h][e] = fast_exp(lg - m_safe[e >> 1]);
              acc_hh[j][e] = 0.f;
              acc_x[j][e] = 0.f;
            }
          const uint32_t a[4] = {
              pack_bf16(ex[0][0], ex[0][1]), pack_bf16(ex[0][2], ex[0][3]),
              pack_bf16(ex[1][0], ex[1][1]), pack_bf16(ex[1][2], ex[1][3])};
          // B fragments: bank rows r0, r0+1 (b0) and r0+8, r0+9 (b1) of
          // value column n = g of each n8 tile
          const int r0 = wc * 64 + s * 16 + 2 * t4;
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            const uint32_t b0 =
                *reinterpret_cast<const uint32_t*>(&vb_s[nv * 8 + g][r0]);
            const uint32_t b1 =
                *reinterpret_cast<const uint32_t*>(&vb_s[nv * 8 + g][r0 + 8]);
            mma_bf16(tv[nv], a, b0, b1);
          }
        }
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sv[nv][e] = fmaf(sv[nv][e], scale[e >> 1], tv[nv][e]);
      }
    }

    __syncthreads();  // every thread is done reading this stage (and rmax_s)
    if (has_next) store(kt_next);
    __syncthreads();
    kt = kt_next;
    pt = pt_next;
  }

  if constexpr (MODE == FAST_MMA) {
    // column warp 1 hands its partial sums to warp 0
    if (wc == 1) {
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part_s[lr[e >> 1]][nv * 8 + 2 * t4 + (e & 1)] = sv[nv][e];
    }
    __syncthreads();
    if (wc == 0) {
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t r = row0 + lr[e >> 1];
          const int col = nv * 8 + 2 * t4 + (e & 1);
          const float v = sv[nv][e] + part_s[lr[e >> 1]][col];
          if (r < row_end) {
            if (col < C) s2_out[r * C + col] = v;
            if (col == C) s1_out[r] = v;
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t r = row0 + lr[i];
        if (t4 == 0 && r < row_end) m_out[r] = m[i];
      }
    }
  } else {
    // sum the per-thread partials of each row (all under the same m): over
    // the quad by shuffles, then column warp 1 hands its sums to warp 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
#pragma unroll
        for (int c = 0; c < C; ++c)
          s2[i][c] += __shfl_xor_sync(0xffffffffu, s2[i][c], o);
      }
      if (wc == 1 && t4 == 0) {
        part_s[lr[i]][0] = s1[i];
#pragma unroll
        for (int c = 0; c < C; ++c) part_s[lr[i]][1 + c] = s2[i][c];
      }
    }
    __syncthreads();
    if (owner) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t r = row0 + lr[i];
        if (r < row_end) {
          m_out[r] = m[i];
          s1_out[r] = s1[i] + part_s[lr[i]][0];
#pragma unroll
          for (int c = 0; c < C; ++c)
            s2_out[r * C + c] = s2[i][c] + part_s[lr[i]][1 + c];
        }
      }
    }
  }
}

template <int C, int MODE>
void launch(const void* q, const void* bias, const void* bank,
            const void* values, float dotscale, const void* m_in,
            const void* s1_in, const void* s2_in, void* m_out, void* s1_out,
            void* s2_out, int64_t M, int64_t rps, int64_t P, int d, int col0,
            const int* mask, int64_t mask_stride, cudaStream_t stream) {
  const dim3 grid((unsigned)((rps + BQ - 1) / BQ), (unsigned)(M / rps));
  auto kernel = mask != nullptr ? split_sweep_kernel<C, MODE, true>
                                : split_sweep_kernel<C, MODE, false>;
  kernel<<<grid, NT, 0, stream>>>(
      (const float*)q, (const float*)bias, (const float*)bank,
      (const float*)values, dotscale, (const float*)m_in,
      (const float*)s1_in, (const float*)s2_in, (float*)m_out,
      (float*)s1_out, (float*)s2_out, rps, P, d, col0, mask, mask_stride);
}

// The checks and the channel switch of the C entry points: launches
// launch<c, MODE> on `stream` without synchronising; returns
// cudaGetLastError() after the launch (0 = launched). bias is
// [M / rows_per_seed, P]; rows_per_seed = M for 1-D weights. mask is null
// or, with 1-D weights only, the int32 skip mask
// [ceil(M / PRUNE_ROWS), mask_stride] (K6).
template <int MODE>
int launch_checked(const void* q, const void* bias, const void* bank,
                   const void* values, float dotscale, const void* m_in,
                   const void* s1_in, const void* s2_in, void* m_out,
                   void* s1_out, void* s2_out, long long M,
                   long long rows_per_seed, long long P, int d, int c,
                   const void* mask, long long mask_stride, int col0,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaSuccess;
  if (rows_per_seed <= 0 || M % rows_per_seed != 0 ||
      M / rows_per_seed > 65535 ||
      (mask != nullptr &&
       (rows_per_seed != M || mask_stride < (P + PRUNE_BLOCK - 1) / PRUNE_BLOCK)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
#define CDT_CASE(CC)                                                      \
  case CC:                                                                \
    launch<CC, MODE>(q, bias, bank, values, dotscale, m_in, s1_in, s2_in, \
                     m_out, s1_out, s2_out, M, rows_per_seed, P, d, col0, \
                     (const int*)mask, mask_stride, s);                   \
    break;
    CDT_CASE(1)
    CDT_CASE(2)
    CDT_CASE(3)
    CDT_CASE(4)
    CDT_CASE(5)
    CDT_CASE(6)
    CDT_CASE(7)
    CDT_CASE(8)
#undef CDT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace cdt_split

// The bf16x3 split-dot flash-score sweep of the 'default' kernel
// (flash_score_fast.cu, variants K3 and K4) and of the 'high' kernel's wide
// modes (flash_score_bf16x3.cu: 'inbank' / 'mxu', K4; K2's per-row sums run
// on the split-bank grid, flash_score_split_rows.cuh, which takes its dot
// arithmetic from here): staging,
// hi/lo split, tensor-core products, the exact hi.hi sum and the online
// softmax are one template; the tiers differ only in the exponential and
// the value sums of the epilogue (template parameter MODE). `sweep` at the
// bottom routes a value strategy and c to a mode for both entry points.
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
// The modes above hold c <= 8 channels per row in registers (template
// parameter C). The wide modes take any c (C is 1 and unused), with s2 in
// dynamic shared memory (value_sums.cuh):
//  SIMT_HIGH, SIMT_FAST  the fp32 exp2 or the bf16 exponential, e of each
//            tile through shared memory into ValueTile's product on the
//            fp32 pipe: 'mxu' after the fp32 exp2 is a true fp32 e @ V
//            (JAX clamps HIGH to HIGHEST there; never TF32, never one bf16
//            pass), and 'vpu' past 8 channels keeps its own rounding;
//  MMAV_SPLIT, MMAV_FAST  the tensor-core value sums of a runtime number
//            of channels: the logit tile's accumulator registers become
//            the A fragments (as FAST_MMA), held for the tile, and each
//            pass of CG channels stages V [BP rows x CG] as bf16 in shared
//            memory (the bank's columns col0 .. col0 + c through a row
//            stride of d for 'inbank', so no values operand) and runs one
//            m16n8k16 product per n8 tile and k16 step. MMAV_FAST ('mxu',
//            and 'mxu1'/'inbank' past 8 channels, bf16 exponential) takes
//            bf16(e) @ bf16(V), exact products summed in fp32. MMAV_SPLIT
//            ('inbank' with the fp32 exp2) takes JAX's split product
//            eh.vh + eh.vl + el.vh, three products per step. Each warp
//            column adds its partial sums into its own slab of the state
//            [2][BQ][c rounded up to 8], in the accumulator layout (each
//            thread updates only its own entries, so the slabs need no
//            synchronisation); the slabs are added at exit. s1 is the fp32
//            row sum of e in every wide mode.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prune_tiles.cuh"
#include "value_sums.cuh"

namespace cdt_split {

using cdt_vals::bf16r;
using cdt_vals::fast_exp;

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
constexpr int CG = 32;  // channels per pass of the wide tensor-core sums (4 n8 tiles)

enum Mode {
  FAST_VPU = 1, FAST_MMA = 2,  // c <= 8 per row
  SIMT_HIGH = 3, SIMT_FAST = 4, MMAV_SPLIT = 5, MMAV_FAST = 6,  // any c
};

using ValueTile = cdt_vals::ValueTile<BQ, BP, NT>;

// Shared-memory carve-up of the MMAV modes for c channels (cp = c rounded
// up to 8): the state slabs [2][BQ][cp] (one per warp column), then the
// staged values' hi parts [CG][VSTR] and, with SPLIT, their lo parts.
template <bool SPLIT>
struct MmaTile {
  float* sv;
  __nv_bfloat16* vh;
  __nv_bfloat16* vl;

  static constexpr size_t bytes(int c) {
    return sizeof(float) * 2 * BQ * (size_t)((c + 7) / 8 * 8) +
           sizeof(__nv_bfloat16) * CG * VSTR * (SPLIT ? 2 : 1);
  }

  __device__ __forceinline__ MmaTile(void* smem, int cp)
      : sv(reinterpret_cast<float*>(smem)),
        vh(reinterpret_cast<__nv_bfloat16*>(sv + 2 * BQ * cp)),
        vl(vh + CG * VSTR) {}
};

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

// two floats that are bf16 values already -> one bf16 pair (a low)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The wide modes take `values` with row stride vstride (the bank's center
// columns for 'inbank'), c_wide channels and, SIMT, the product rule.
template <int C, int MODE, bool PRUNE>
__global__ void __launch_bounds__(NT, 1) split_sweep_kernel(
    const float* __restrict__ q, const float* __restrict__ bias,
    const float* __restrict__ bank, const float* __restrict__ values,
    float dotscale, const float* __restrict__ m_in,
    const float* __restrict__ s1_in, const float* __restrict__ s2_in,
    float* __restrict__ m_out, float* __restrict__ s1_out,
    float* __restrict__ s2_out, int64_t rps, int64_t P, int d, int col0,
    const int* __restrict__ mask, int64_t mask_stride, int c_wide,
    int64_t vstride, int rule) {
  constexpr bool WIDE = MODE >= SIMT_HIGH;
  constexpr bool SIMT = MODE == SIMT_HIGH || MODE == SIMT_FAST;
  constexpr bool SPLIT = MODE == MMAV_SPLIT;  // the split value product
  constexpr bool BF16_EXP = MODE == FAST_VPU || MODE == FAST_MMA ||
                            MODE == SIMT_FAST || MODE == MMAV_FAST;
  constexpr int VL = (BP * C + NT - 1) / NT;  // value elements each thread stages
  constexpr int NV = (C + 8) / 8;  // n8 tiles of [V | 1] (FAST_MMA)
  constexpr int VR = MODE == FAST_MMA ? NV * 8 : C;  // rows of the bf16 value tile
  constexpr int PW = MODE == FAST_MMA ? NV * 8 : C + 1;  // exit partials per row
  const bool inbank = MODE == FAST_MMA && col0 >= 0;
  // the wide modes' state in dynamic shared memory (cp: c_wide rounded up to 8)
  extern __shared__ float4 dyn_smem[];
  const int cp = (c_wide + 7) / 8 * 8;
  const ValueTile vt(reinterpret_cast<float*>(dyn_smem));
  const MmaTile<SPLIT> mt(dyn_smem, cp);

  __shared__ __align__(16) uint32_t Qh[BQ][SW];
  __shared__ __align__(16) uint32_t Ql[BQ][SW];
  __shared__ __align__(16) uint32_t Kh[BP][SW];
  __shared__ __align__(16) uint32_t Kl[BP][SW];
  __shared__ float bias_s[BP];
  __shared__ __align__(16) __nv_bfloat16 vb_s[MODE == FAST_VPU || MODE == FAST_MMA ? VR : 1][VSTR];
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
  // warp); the sums are per-thread partials under that m. FAST_VPU:
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
    if constexpr (!WIDE) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        s2[i][c] = (live && owner) ? s2_in[r * C + c] : 0.f;
    }
  }
  if constexpr (SIMT) vt.load_state(s2_in, row0, row_end, c_wide, tid);
  if constexpr (WIDE && !SIMT) {  // slab 0 from the carried state, slab 1 zero
    for (int i = tid; i < 2 * BQ * cp; i += NT) {
      const int64_t r = row0 + (i / cp) % BQ;
      const int ch = i % cp;
      mt.sv[i] = (i < BQ * cp && ch < c_wide && r < row_end)
                     ? s2_in[r * c_wide + ch] : 0.f;
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
      if (!WIDE && !inbank) {
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
      if (!WIDE && !inbank) {
#pragma unroll
        for (int j = 0; j < VL; ++j) {
          const int e = tid + j * NT;
          if (e < BP * C) {
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
          if constexpr (!WIDE) {
#pragma unroll
            for (int c = 0; c < C; ++c) s2[i][c] *= scale[i];
          }
        }
        m[i] = m_new;
        t1[i] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) t2[i][c] = 0.f;
      }
      if constexpr (WIDE) {
        // e of the tile: its fp32 row sums, and e to shared memory (SIMT)
        // or the A fragments of the value product (MMAV; tiles 2s, 2s+1 are
        // k16 step s, as in FAST_MMA; hi and, SPLIT, lo parts)
        uint32_t ah[NTILE / 2][4], al[NTILE / 2][4];
#pragma unroll
        for (int s = 0; s < NTILE / 2; ++s) {
          float ex[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 2 * s + h;
              const int col = wc * 64 + j * 8 + 2 * t4 + (e & 1);
              const float lg =
                  fmaf(acc_hh[j][e] + acc_x[j][e], dotscale, bias_s[col]);
              const float x = lg - m_safe[e >> 1];
              ex[h][e] = BF16_EXP ? fast_exp(x) : exp2f(x);
              t1[e >> 1] += ex[h][e];
              if constexpr (SIMT) vt.e[lr[e >> 1] * ValueTile::ES + col] = ex[h][e];
              acc_hh[j][e] = 0.f;
              acc_x[j][e] = 0.f;
            }
          if constexpr (!SIMT) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if constexpr (SPLIT) {
                split_pair(ex[h][0], ex[h][1], ah[s][2 * h], al[s][2 * h]);
                split_pair(ex[h][2], ex[h][3], ah[s][2 * h + 1], al[s][2 * h + 1]);
              } else {
                ah[s][2 * h] = pack_bf16(ex[h][0], ex[h][1]);
                ah[s][2 * h + 1] = pack_bf16(ex[h][2], ex[h][3]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) s1[i] += t1[i];
        if constexpr (SIMT) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (wc == 0 && t4 == 0) vt.scale[lr[i]] = scale[i];
          __syncthreads();
          vt.accumulate(values, vstride, pt * BP, P, c_wide, rule, tid);
        } else {
          for (int g0 = 0; g0 < c_wide; g0 += CG) {
            if (g0 > 0) __syncthreads();  // the last pass's B reads are done
            for (int i = tid; i < BP * CG; i += NT) {
              const int64_t p = pt * BP + i / CG;
              const int ch = g0 + i % CG;
              const float x = (p < P && ch < c_wide) ? values[p * vstride + ch] : 0.f;
              const __nv_bfloat16 hi = __float2bfloat16_rn(x);
              mt.vh[(i % CG) * VSTR + i / CG] = hi;
              if constexpr (SPLIT)
                mt.vl[(i % CG) * VSTR + i / CG] =
                    __float2bfloat16_rn(x - __bfloat162float(hi));
            }
            __syncthreads();
            const int n_nv = min(CG, cp - g0) / 8;
            for (int nv = 0; nv < n_nv; ++nv) {
              float tv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int s = 0; s < NTILE / 2; ++s) {
                // B fragments: bank rows r0, r0+1 (b0) and r0+8, r0+9 (b1)
                // of value column n = g of n8 tile nv
                const int r0 = wc * 64 + s * 16 + 2 * t4;
                const int vo = (nv * 8 + g) * VSTR + r0;
                const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(&mt.vh[vo]);
                const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(&mt.vh[vo + 8]);
                mma_bf16(tv, ah[s], bh0, bh1);
                if constexpr (SPLIT) {
                  const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(&mt.vl[vo]);
                  const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(&mt.vl[vo + 8]);
                  mma_bf16(tv, ah[s], bl0, bl1);
                  mma_bf16(tv, al[s], bh0, bh1);
                }
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float& sv = mt.sv[(wc * BQ + lr[e >> 1]) * cp + g0 + nv * 8 +
                                  2 * t4 + (e & 1)];
                sv = fmaf(sv, scale[e >> 1], tv[e]);
              }
            }
          }
        }
      } else if constexpr (MODE != FAST_MMA) {
#pragma unroll
        for (int j = 0; j < NTILE; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int col = wc * 64 + j * 8 + 2 * t4 + (e & 1);
            const float lg =
                fmaf(acc_hh[j][e] + acc_x[j][e], dotscale, bias_s[col]);
            const float ex = fast_exp(lg - m_safe[i]);
            t1[i] += ex;
#pragma unroll
            for (int c = 0; c < C; ++c)
              t2[i][c] += bf16r(ex * __bfloat162float(vb_s[c][col]));
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
        if constexpr (!WIDE) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            s2[i][c] += __shfl_xor_sync(0xffffffffu, s2[i][c], o);
        }
      }
      if (wc == 1 && t4 == 0) {
        part_s[lr[i]][0] = s1[i];
        if constexpr (!WIDE) {
#pragma unroll
          for (int c = 0; c < C; ++c) part_s[lr[i]][1 + c] = s2[i][c];
        }
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
          if constexpr (!WIDE) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              s2_out[r * C + c] = s2[i][c] + part_s[lr[i]][1 + c];
          }
        }
      }
    }
    // the wide state in shared memory, final since the loop's last
    // __syncthreads
    if constexpr (SIMT) vt.store_state(s2_out, row0, row_end, c_wide, tid);
    if constexpr (WIDE && !SIMT) {
      for (int i = tid; i < BQ * c_wide; i += NT) {
        const int64_t r = row0 + i / c_wide;
        const int ch = i % c_wide;
        if (r < row_end)
          s2_out[r * c_wide + ch] = mt.sv[(i / c_wide) * cp + ch] +
                                    mt.sv[(BQ + i / c_wide) * cp + ch];
      }
    }
  }
}

template <int C, int MODE>
int launch(const void* q, const void* bias, const void* bank,
           const void* values, float dotscale, const void* m_in,
           const void* s1_in, const void* s2_in, void* m_out, void* s1_out,
           void* s2_out, int64_t M, int64_t rps, int64_t P, int d, int col0,
           const int* mask, int64_t mask_stride, int c, int64_t vstride,
           int rule, cudaStream_t stream) {
  const dim3 grid((unsigned)((rps + BQ - 1) / BQ), (unsigned)(M / rps));
  auto kernel = mask != nullptr ? split_sweep_kernel<C, MODE, true>
                                : split_sweep_kernel<C, MODE, false>;
  size_t smem = 0;
  if constexpr (MODE == SIMT_HIGH || MODE == SIMT_FAST)
    smem = ValueTile::bytes(c);
  else if constexpr (MODE == MMAV_SPLIT || MODE == MMAV_FAST)
    smem = MmaTile<MODE == MMAV_SPLIT>::bytes(c);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)bias, (const float*)bank,
      (const float*)values, dotscale, (const float*)m_in,
      (const float*)s1_in, (const float*)s2_in, (float*)m_out,
      (float*)s1_out, (float*)s2_out, rps, P, d, col0, mask, mask_stride, c,
      vstride, rule);
  return (int)cudaGetLastError();
}

// The checks and the routing of the C entry points (BF16_EXP: the 'default'
// kernel's bf16 exponential, else the 'high' kernel's fp32 exp2): launches
// on `stream` without synchronising; returns cudaGetLastError() after the
// launch (0 = launched). bias is [M / rows_per_seed, P]; rows_per_seed = M
// for 1-D weights. mask is null or, with 1-D weights only, the int32 skip
// mask [ceil(M / PRUNE_ROWS), mask_stride] (K6). strategy: 0 'vpu', 1
// 'mxu1' (bf16 exponential only), 2 'inbank' (values may be null; V =
// bank[:, col0 : col0 + c]), 3 'mxu'. Up to 8 channels, 'vpu' (and with the
// bf16 exponential 'mxu1' and 'inbank') keep their per-row sums; the rest
// take the wide modes (see the top).
template <bool BF16_EXP>
int sweep(const void* q, const void* bias, const void* bank,
          const void* values, float dotscale, const void* m_in,
          const void* s1_in, const void* s2_in, void* m_out, void* s1_out,
          void* s2_out, long long M, long long rows_per_seed, long long P,
          int d, int c, const void* mask, long long mask_stride, int strategy,
          int col0, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaSuccess;
  if (rows_per_seed <= 0 || M % rows_per_seed != 0 ||
      M / rows_per_seed > 65535 || c < 1 || strategy < 0 || strategy > 3 ||
      (strategy == 1 && !BF16_EXP) ||
      (strategy == 2 && (col0 < 0 || col0 + c > d)) ||
      (mask != nullptr &&
       (rows_per_seed != M || mask_stride < (P + PRUNE_BLOCK - 1) / PRUNE_BLOCK)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* mk = (const int*)mask;
  const bool inbank = strategy == 2;
  if constexpr (!BF16_EXP) {  // the 'high' kernel sends its per-row sums elsewhere
    if (c <= 8 && strategy == 0) return (int)cudaErrorInvalidValue;
  }
  if constexpr (BF16_EXP) {
    if (c <= 8 && strategy == 0) {  // per-row 'vpu' sums
      switch (c) {
#define CDT_CASE(CC)                                                          \
  case CC:                                                                    \
    return launch<CC, FAST_VPU>(q, bias, bank, values, dotscale, m_in, s1_in, \
                                s2_in, m_out, s1_out, s2_out, M,              \
                                rows_per_seed, P, d, -1, mk, mask_stride, c,  \
                                c, 0, s);
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
    if (c <= 8 && (strategy == 1 || inbank)) {  // e @ [V | 1] per row
      switch (c) {
#define CDT_CASE(CC)                                                        \
  case CC:                                                                  \
    return launch<CC, FAST_MMA>(q, bias, bank, values, dotscale, m_in,      \
                                s1_in, s2_in, m_out, s1_out, s2_out, M,     \
                                rows_per_seed, P, d, inbank ? col0 : -1, mk, \
                                mask_stride, c, c, 0, s);
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
  }
  // the wide modes: V is the values [P, c] or the bank's center columns
  const void* vals = inbank ? (const void*)((const float*)bank + col0) : values;
  const int64_t vstride = inbank ? d : c;
  if constexpr (BF16_EXP) {
    if (strategy == 0)  // 'vpu' past 8 channels: bf16(e * bf16(v))
      return launch<1, SIMT_FAST>(
          q, bias, bank, vals, dotscale, m_in, s1_in, s2_in, m_out, s1_out,
          s2_out, M, rows_per_seed, P, d, -1, mk, mask_stride, c, vstride,
          cdt_vals::V_BF16_PRODUCT, s);
    return launch<1, MMAV_FAST>(  // bf16(e) @ bf16(V)
        q, bias, bank, vals, dotscale, m_in, s1_in, s2_in, m_out, s1_out,
        s2_out, M, rows_per_seed, P, d, -1, mk, mask_stride, c, vstride, 0, s);
  } else {
    if (inbank)  // the split product eh.vh + eh.vl + el.vh
      return launch<1, MMAV_SPLIT>(
          q, bias, bank, vals, dotscale, m_in, s1_in, s2_in, m_out, s1_out,
          s2_out, M, rows_per_seed, P, d, -1, mk, mask_stride, c, vstride, 0, s);
    return launch<1, SIMT_HIGH>(  // 'mxu', and 'vpu' past 8 channels: fp32
        q, bias, bank, vals, dotscale, m_in, s1_in, s2_in, m_out, s1_out,
        s2_out, M, rows_per_seed, P, d, -1, mk, mask_stride, c, vstride,
        cdt_vals::V_FP32, s);
  }
}

}  // namespace cdt_split

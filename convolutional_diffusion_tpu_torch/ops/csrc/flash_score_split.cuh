// What the split-dot kernels share (K2, flash_score_bf16x3.cu, and the
// 'default' kernel, flash_score_fast.cu; both run the one main loop of
// flash_score_split_rows.cuh): the bank tile, the epilogue modes, the
// carve-up of the tensor-core value sums, and the arithmetic of the bf16x3
// split and of its exact sum.
//
// Epilogue modes (the value strategy and the exponential of a launch;
// flash_score_split_rows.cuh `sweep` routes them):
//  HIGH_VPU  K2's per-row sums: fp32 exp2, s2 = sum_f32 e * v per channel,
//            c <= 8 (template parameter C); the only mode that splits the
//            bank axis (one block per split, partials merged in order).
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
//            with fp32 adds after the rescale. V is bf16(values) ('mxu1') or
//            the bank's own columns col0 .. col0 + c ('inbank'), whose bf16
//            values are the hi parts of the split.
// The modes above hold c <= 8 channels per row in registers. The wide
// modes take any c at runtime (C is 0), with s2 in the rows of the state
// they write, in device memory, so no shared memory grows with c:
//  SIMT_HIGH, SIMT_FAST  the fp32 exp2 or the bf16 exponential, e of each
//            tile through shared memory into ValueTile's product on the
//            fp32 pipe (value_sums.cuh): 'mxu' after the fp32 exp2 is a true
//            fp32 e @ V (JAX clamps HIGH to HIGHEST there; never TF32, never
//            one bf16 pass), and 'vpu' past 8 channels keeps its own
//            rounding;
//  MMAV_SPLIT, MMAV_FAST  the tensor-core value sums of a runtime number
//            of channels: the logit tile's accumulator registers become the
//            A fragments (as FAST_MMA), held for the tile, and each pass of
//            CG channels stages V [BP rows x CG] as bf16 in shared memory
//            (MmaTile; the bank's columns col0 .. col0 + c through a row
//            stride of d for 'inbank') and runs one m16n8k16 product per n8
//            tile and k16 step. MMAV_FAST ('mxu', and 'mxu1'/'inbank' past 8
//            channels, bf16 exponential) takes bf16(e) @ bf16(V), exact
//            products summed in fp32. MMAV_SPLIT ('inbank' with the fp32
//            exp2) takes JAX's split product eh.vh + eh.vl + el.vh, three
//            products per step. Each warpgroup adds its partial sums into
//            its own copy of the state (the output rows, and rows in the
//            scratch), each thread only its own entries; the two are added
//            at exit. s1 is the fp32 row sum of e in every wide mode.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cdt_split {

#ifndef SPLIT_TILE
#error "SPLIT_TILE (bank rows per tile) comes from ops/_build.py's nvcc flags"
#endif

// bank rows per tile: 2 warpgroups x 64. Set in ops/_build.py, where the
// plain version reads it too: the 'default' tier re-bases m once per tile.
constexpr int BP = SPLIT_TILE;
static_assert(BP == 128, "a tile is 2 warpgroups of 64 bank columns");
constexpr int CG = 32;        // channels per pass of the wide tensor-core sums (4 n8 tiles)
constexpr int VSTR = BP + 8;  // bf16 row stride of a staged value pass (68 words:
                              // the B-fragment reads are conflict-free)

enum Mode {
  HIGH_VPU = 0, FAST_VPU = 1, FAST_MMA = 2,                     // c <= 8 per row
  SIMT_HIGH = 3, SIMT_FAST = 4, MMAV_SPLIT = 5, MMAV_FAST = 6,  // any c
};

// Shared-memory carve-up of the MMAV modes: one pass of staged values, the
// hi parts [CG][VSTR] and, with SPLIT, their lo parts.
template <bool SPLIT>
struct MmaTile {
  __nv_bfloat16* vh;
  __nv_bfloat16* vl;

  static constexpr size_t bytes = sizeof(__nv_bfloat16) * CG * VSTR * (SPLIT ? 2 : 1);

  __device__ __forceinline__ explicit MmaTile(void* smem)
      : vh(reinterpret_cast<__nv_bfloat16*>(smem)), vl(vh + CG * VSTR) {}
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

}  // namespace cdt_split

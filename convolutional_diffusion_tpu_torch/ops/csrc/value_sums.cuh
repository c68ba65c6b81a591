// What the flash-score kernels share around the value sums: the bf16
// exponential of the 'default' tier, the product rules, and the fp32 value
// product of the split-dot loop's wide modes, whose state lives in device
// memory, so that any number of value channels c runs without an
// instantiation per c and without shared memory that grows with c.
//
// The TPU kernel (convolutional_diffusion_tpu/ops/flash_score.py
// `_kernel_body`) takes s2 as a matrix product on its matrix unit in the
// 'mxu' and 'inbank' strategies: s2 <- s2 * scale + e @ V per bank block,
// V [BP, c] being the values tile ('mxu') or the bank tile's center
// columns ('inbank'). A block's state s2 [BQ, c] for c channels would not
// fit in registers beside the dot's accumulators, nor, at the c = 256 the
// kernels take, in shared memory beside their staging rings, so the wide
// sums keep it in the rows of the device-memory state they write (each
// thread updates its own entries; the rows stay in L2 between tiles):
//
//  ValueTile (the fp32 products of the split-dot loop's SIMT modes: 'mxu'
//      at 'high', 'vpu' past the per-row sums' 8 channels): the epilogue
//      writes the tile's exponentials e [BQ, BP] and each row's rescale
//      factor to shared memory; then every thread owns 4 channels of one
//      query row and sums e[r, p] * V[p, ch] over the BP bank rows on the
//      fp32 pipe, CT = 16 channels per pass, the values of a pass staged in
//      shared memory from device memory (a row stride lets 'inbank' read
//      the bank's center columns, with no values operand). The products
//      follow `rule`: V_FP32 fp32 products, V_BF16 exact products
//      e * bf16(v) (e a bf16 value already), V_BF16_PRODUCT bf16(e * bf16(v))
//      (JAX's bf16 'vpu' product); each pass is added into s2 as
//      s2 * scale + sum, one rounding.
//
// K1's wide epilogues (flash_score.cu) take the same rules row by row, with
// V staged per chunk of channels in shared memory; the tensor-core value
// sums of the split-dot loop (bf16 products on mma.sync) keep their own
// layout (flash_score_split.cuh MmaTile).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cdt_vals {

constexpr float LN2_BF16 = 0.69140625f;  // ln 2 rounded to bf16

// x rounded to bf16 (to nearest even), as a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the 'default' tier's exponential of x = logit - m <= 0: JAX's lowering of
// jnp.exp2 on a bf16 array, exp(bf16(ln 2) * x) with the product in bf16,
// i.e. e = bf16(expf(bf16(bf16(x) * 0.69140625))) = 2^(0.9975 x)
__device__ __forceinline__ float fast_exp(float x) {
  return bf16r(expf(bf16r(bf16r(x) * LN2_BF16)));
}

// how e meets the values (see the top)
enum Rule { V_FP32 = 0, V_BF16 = 1, V_BF16_PRODUCT = 2 };

constexpr int CT = 16;  // channels per pass of ValueTile

// Shared-memory carve-up of ValueTile for a block of BQ query rows, BP bank
// rows and NT threads: e [BQ][BP + 1] (odd stride: the rows a warp reads at
// one bank row fall in distinct banks), the staged values [BP][CT] and each
// row's rescale factor [BQ].
template <int BQ, int BP, int NT>
struct ValueTile {
  static_assert(NT == 4 * BQ, "each thread owns 4 channels of one row per pass");
  static_assert(CT == 16, "4 threads of 4 channels per row and pass");
  static constexpr int ES = BP + 1;
  static constexpr size_t bytes = sizeof(float) * ((size_t)BQ * ES + (size_t)BP * CT + BQ);

  float* e;
  float* v;
  float* scale;

  __device__ __forceinline__ explicit ValueTile(float* smem)
      : e(smem), v(smem + BQ * ES), scale(smem + BQ * ES + BP * CT) {}

  // s2[r][ch] = s2[r][ch] * scale[r] + sum_p e[r][p] * V[p0 + p][ch] over
  // the tile's BP bank rows, V[p][ch] = vals[p * vstride + ch] (0 past P),
  // for the block's first `rows` rows; s2 is the block's state [rows][c]
  // in device memory. Every thread of the block calls it after e and scale
  // are written and a __syncthreads; it returns after a __syncthreads, so
  // the caller may overwrite e, v and scale.
  __device__ __forceinline__ void accumulate(const float* __restrict__ vals,
                                             int64_t vstride, int64_t p0,
                                             int64_t P, int c, int rule,
                                             float* __restrict__ s2, int rows,
                                             int tid) const {
    const int r = tid >> 2;         // the thread's query row
    const int cg = (tid & 3) * 4;   // its first channel in a pass
    const float* er = e + r * ES;
    for (int c0 = 0; c0 < c; c0 += CT) {
      for (int i = tid; i < BP * CT; i += NT) {
        const int64_t p = p0 + i / CT;
        const int ch = c0 + i % CT;
        const float x = (p < P && ch < c) ? vals[p * vstride + ch] : 0.f;
        v[i] = rule == V_FP32 ? x : bf16r(x);
      }
      __syncthreads();
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (rule == V_BF16_PRODUCT) {
#pragma unroll 4
        for (int p = 0; p < BP; ++p) {
          const float ev = er[p];
          const float4 w = *reinterpret_cast<const float4*>(&v[p * CT + cg]);
          acc[0] += bf16r(ev * w.x);
          acc[1] += bf16r(ev * w.y);
          acc[2] += bf16r(ev * w.z);
          acc[3] += bf16r(ev * w.w);
        }
      } else {
#pragma unroll 4
        for (int p = 0; p < BP; ++p) {
          const float ev = er[p];
          const float4 w = *reinterpret_cast<const float4*>(&v[p * CT + cg]);
          acc[0] = fmaf(ev, w.x, acc[0]);
          acc[1] = fmaf(ev, w.y, acc[1]);
          acc[2] = fmaf(ev, w.z, acc[2]);
          acc[3] = fmaf(ev, w.w, acc[3]);
        }
      }
      const float sc = scale[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = c0 + cg + j;
        if (r < rows && ch < c) s2[r * c + ch] = fmaf(s2[r * c + ch], sc, acc[j]);
      }
      __syncthreads();  // every thread is done with this pass's values
    }
  }
};

}  // namespace cdt_vals

// Fused flash-score sweep, 'default' tier (bf16x3 split dot on the tensor
// cores, bf16 exponential, fp32 sums), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel convolutional_diffusion_tpu/ops/flash_score.py
// `_kernel` / `_kernel_body` (the one `pl.pallas_call` of that package) in
// its precision='default' variants: the manual bf16x3 QK dot (as 'high'),
// fast_exp (`e = jnp.exp2(bf16(logits - m))`, variant K3) and the value
// strategies 'vpu' (per-channel sums of the bf16 products e * bf16(v)),
// 'mxu1' (one bf16 product e @ [V | 1] giving s2 and s1, K3) and 'inbank'
// (the same product against the bank's own center columns, no values
// operand, K4), with 1-D weights or per-seed weights (2-D w with
// rows_per_seed, variant K5), and with 1-D weights the prune skip bit
// (variant K6, split_bank.cuh).
//
// The dot, the online softmax, the -1e30 sentinel and `m_new <= NEG_INF/2`
// guards and the (query block, seed) grid are the 'high' kernel's: both run
// the one split-dot main loop of flash_score_split_rows.cuh (pre-split
// bf16 planes, a cp.async ring, wgmma products pipelined under the exact
// sum), so the two tiers' logits are the same bits. The exponential is JAX's lowering
// of `jnp.exp2` on a bf16 array, exp(bf16(ln 2) * x) with the factor
// 0.69140625 and the product rounded to bf16:
//   e = bf16(expf(bf16(bf16(logit - m) * 0.69140625)))
// i.e. 2^(0.9975 x), not 2^x; the port follows the reference. The rounding
// points are those of the Pallas kernel's dtypes: e is bf16, 'vpu's e * v a
// bf16 product, 'mxu1'/'inbank' exact bf16 products summed in fp32 by the
// tensor core. The plain version (ops/flash_score.py sweep_plain) rounds at
// the same points. Built without fast-math: expf and the sums stay fp32.
//
// What bounds it on an H100: the three bf16 products of the dot,
// 3 * 2 * M * P * d_pad operations, at the dense bf16 tensor-core rate
// (989 TFLOP/s published), against one exponential per pair at the SFU
// rate (16 per clock per SM, ~4.2 T/s at 132 SMs and 1.98 GHz) and the
// per-pair elementwise work at the fp32 rate (67 TFLOP/s); at d_pad = 32
// (k = 3 on RGB) the exponentials are the limit, from d_pad ~ 48 up the
// products. The bf16 exponential rounds x = logit - m against the m of each
// 128-row bank tile, so the kernel never splits the bank axis: each block of
// 64 query rows walks the whole chunk from the carried state (128 blocks at
// M = 8192, one wave). 'mxu1' and 'inbank' take their value sums on the
// tensor cores, reusing the logit tile's accumulator registers as the A
// operand.

#include "flash_score_split_rows.cuh"

// Plain C entry point (bound with ctypes). strategy: 0 'vpu', 1 'mxu1',
// 2 'inbank' (values may be null; V = bank[:, col0 : col0 + c]), 3 'mxu';
// fast must be 1. Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launches (0 = launched). bias is
// [M / rows_per_seed, P]; rows_per_seed = M for 1-D weights. mask is null or
// the K6 skip mask of 1-D weights; live null or, with per-seed weights, the
// K5 live-tile workspace; walked null or each block's walked tiles (all as
// flash_score_split_rows.cuh `sweep`, which routes them). scratch is float32 [M][2 + c] rounded up to 4 (the tensor-core wide
// sums' second state rows), then the bf16 planes (ops/flash_score.py
// `scratch_numel`); split_rows is not read: one split, since the bf16
// exponential rounds x against the m of each tile.
extern "C" int flash_score_fast(const void* q, const void* bias,
                                const void* bank, const void* values,
                                float dotscale, const void* m_in,
                                const void* s1_in, const void* s2_in,
                                void* m_out, void* s1_out, void* s2_out,
                                long long M, long long rows_per_seed,
                                long long P, int d, int c, const void* mask,
                                long long mask_stride, int strategy,
                                int col0, int fast, void* scratch,
                                long long split_rows, void* live, void* walked,
                                int device, void* stream) {
  if (fast != 1) return (int)cudaErrorInvalidValue;
  return cdt_split_rows::sweep<true>(q, bias, bank, values, dotscale, m_in, s1_in, s2_in,
                                     m_out, s1_out, s2_out, M, rows_per_seed, P, d, c, mask,
                                     mask_stride, strategy, col0, scratch, split_rows, live,
                                     walked, device, stream);
}

// Fused flash-score sweep, 'high' tier (bf16x3 split dot on the tensor
// cores, fp32 elementwise, per-channel value sums), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel convolutional_diffusion_tpu/ops/flash_score.py
// `_kernel` / `_kernel_body` (the one `pl.pallas_call` of that package) in
// its precision='high' variant: the manual bf16x3 QK dot (`_kernel_body`,
// the `precision != HIGHEST` branch), fp32 exp2 (fast_exp off),
// v_strategy='vpu', with 1-D weights (variant K2) or per-seed weights
// (variant K5 at this tier: 2-D w with rows_per_seed), and with 1-D weights
// the prune skip bit (variant K6, flash_score_split.cuh).
//
// What it computes is what the fp32 kernel (flash_score.cu) computes, with
// the same arguments, bias row, -1e30 sentinel and `m_new <= NEG_INF/2`
// guards, and the same per-seed grid for 2-D weights (a (query block, seed)
// grid; block (x, s) owns seed s's rows x * BQ .. up to the seed's end and
// stages bias row s; 1-D weights are S = 1, rows_per_seed = M); only the dot
// differs. Each fp32 input x is split into bf16 parts
// hi = bf16(x), lo = bf16(x - hi) (round to nearest even, as the TPU
// kernel's casts), and
//   dot(q, k) = qh.kh + (qh.kl + ql.kh)
// with every product of two bf16 values exact in fp32 and summed in fp32:
// about 2^-16 relative dot error, the tier's contract. The dropped ql.kl
// term is 2^-16 of the dot.
//
// What bounds it on an H100: the three bf16 products, 3 * 2 * M * P * d_pad
// operations, at the dense bf16 tensor-core rate (989 TFLOP/s published),
// against the per-pair elementwise work, (6 + 2c) * M * P at the fp32 rate
// (67 TFLOP/s): the products are the larger from d_pad = 32 up (k = 3 on
// RGB, narrowly). The exact hi.hi sum below costs seven fp32 instructions
// per accumulator per k16 step, which puts a floor of ~6.3 ms under a
// 65536-row chunk at M = 8192, k = 17 (2.8 ms of tensor-core bound).
//
// The per-row sums ('vpu', c <= 8, the sweeps of every module at this
// tier) run a warp-specialised loop (flash_score_split_ws.cuh): the inputs
// are split into bf16 hi/lo planes once per launch; a producer warpgroup
// stages them by TMA into a ring of shared-memory slots under mbarriers,
// and two consumer warpgroups, each with its own 64 of a block's 128 query
// rows over whole 128-row bank tiles, run wgmma m64n128k16 products
// pipelined under the exact sum and never wait for each other. The bank
// axis is split: one block per (query block, seed, split) writes a partial
// state that a merge pass folds in split order. The wide modes ('inbank'
// any c, 'mxu', 'vpu' past 8 channels; flash_score_split.cuh) run the
// 'default' kernel's split-dot loop (flash_score_split_rows.cuh: cp.async
// staging, 64-row query blocks, two warpgroups that split each tile's
// columns) from the carried state, one split. d is zero-padded to the stage
// width (zero features add exact zeros).
//
// The hi.hi sum is exact over the k16 slices the tensor core returns: each
// k16 hi.hi product starts from a zero accumulator (the tensor core returns
// the exact 16-product sum rounded toward zero to fp32; measured on an
// H100) and is added into the running fp32 sum by an error-free TwoSum,
// whose rounding errors go into the cross-term accumulator; the cross terms
// (2^-8 of the dot) accumulate inside the tensor core. The epilogue adds
// the two sums once, so the dot is rounded once. The logit scale
// 1/(2 beta^2) makes the posterior sensitive to the dot's last bits: two
// fp32 summation orders of the same split differ by up to ~0.5% on the
// posterior mean at the sharpest softmax (d = 867), so the kernel sums the
// hi.hi part exactly, and the plain version (ops/flash_score.py
// `_split_dot`) repeats this sum step by step in float64.
//
// The online-softmax epilogue works on the mma accumulator layout (a
// thread holds 2 rows of a tile, 32 columns of them in the per-row sums'
// loop): the row max over the four threads of a quad by shuffles (and, in
// the wide modes' loop, over the two column warpgroups through shared
// memory), so every thread of a row holds the same running max; partial
// s1/s2 under that max are summed over the quad (per tile in the per-row
// loop, at exit in the wide modes'). The carried state is read at entry and
// written once at exit. Offsets formed from row indices are 64-bit. Built
// without fast-math: exp2f and the fp32 sums stay exact fp32.

#include "flash_score_split_ws.cuh"

// Plain C entry point (bound with ctypes). Launches on `stream` and does not
// synchronise; returns cudaGetLastError() after the launches (0 = launched).
// bias is [M / rows_per_seed, P]; rows_per_seed = M for 1-D weights. mask is
// null or the K6 skip mask of 1-D weights; live null or, with per-seed
// weights, the K5 live-tile workspace; walked null or each block's walked
// tiles (all as flash_score_split_rows.cuh `sweep`). strategy: 0 'vpu', 2 'inbank'
// (values may be null; V = bank[:, col0 : col0 + c]), 3 'mxu'; fast must be
// 0 (the bf16 exponential after split dots is flash_score_fast's). scratch
// is float32: the partial states [nsplit][M][2 + c], nsplit =
// ceil(P / split_rows) (at least 1; one for the wide modes), then the bf16
// planes (ops/flash_score.py `scratch_numel`).
extern "C" int flash_score_bf16x3(const void* q, const void* bias,
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
  if (fast != 0) return (int)cudaErrorInvalidValue;
  return cdt_split_rows::sweep<false>(q, bias, bank, values, dotscale, m_in, s1_in, s2_in,
                                      m_out, s1_out, s2_out, M, rows_per_seed, P, d, c,
                                      mask, mask_stride, strategy, col0, scratch, split_rows,
                                      live, walked, device, stream);
}

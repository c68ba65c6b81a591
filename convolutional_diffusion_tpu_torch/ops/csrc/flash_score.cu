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
// seed-major blocks and `bias` is [S, P]; seed s's rows use bias row s. The
// grid is (ceil(rows_per_seed / BQ), S): block (x, s) owns rows
// s * rows_per_seed + x * BQ up to the seed's end, so a block never mixes
// seeds and stages one bias row. 1-D weights are the case S = 1,
// rows_per_seed = M, the same launch as without the seed axis. The bound is
// the 1-D kernel's for the same M, P, d; only the bias bytes grow to S * P.
//
// What bounds it on an H100: the QK^T dot, 2*M*P*d operations, in true fp32.
// The 1/(2 beta^2) logit scale turns a TF32 or bf16 rounding (2^-10 .. 2^-9)
// into ~19% posterior error, so the dot cannot use the tensor cores as they
// are; it runs as fp32 FFMA, 67 TFLOP/s published. The bank chunk is read
// once per query block (M/64 times) but stays far below the 3.35 TB/s memory
// rate (e.g. k=17: 227 MB chunk x 128 query blocks per ~10^12 operations).
//
// Design: one thread block owns BQ = 64 query rows and loops over the whole
// chunk inside the block (the TPU grid's sequential bank axis becomes that
// loop; blocks run independently, so no cross-block reduction). Per BP = 128
// bank rows it computes a 64 x 128 dot tile as a register-blocked SGEMM:
// d is tiled through shared memory BK = 16 features at a time (d reaches 867
// on the CIFAR path and 2187 at 64x64, so a query row cannot stay resident),
// each of the 256 threads keeps a 4 x 8 fp32 accumulator tile, and the next
// stage's global loads are issued into registers before the current stage's
// FFMAs so their latency hides behind them. The softmax epilogue runs in
// registers: row max over the 16 threads of a row by warp shuffles, exp2f,
// rescale, and per-thread partial s1/s2 that share the row's m and are summed
// across the 16 threads once, at exit. The carried state is read at entry
// and written once at exit. Offsets formed from row indices are 64-bit.
// Built without fast-math: exp2f and the dot stay full fp32.
//
// Prune mask (K6): with a mask (the PRUNE instantiation; without one the
// loop walks every tile as before, prune_tiles.cuh), block x reads row
// x * BQ / PRUNE_ROWS of the int32 mask [ceil(M / PRUNE_ROWS), mask_stride],
// one flag per PRUNE_BLOCK bank rows (ops/prune.py builds it), and walks only
// the tiles whose flag is 0: the first load targets the first such tile,
// each prefetch the next one.
// A skipped tile leaves the state as its logits at -1e30 would (m does not
// move, every exp2 is 0), so the plain version masks logits instead. A block
// with every tile skipped writes its carried state through unchanged. All
// threads of a block read the same flags: no divergence.
//
// Wide value sums (the WIDE instantiations: 'mxu', 'inbank', 'vpu' past 8
// channels, and every strategy with the bf16 exponential): s2 [BQ, c] lives
// in dynamic shared memory and each bank tile's exponentials go through
// shared memory into a small fp32 product e @ V (value_sums.cuh ValueTile),
// so any c runs without an instantiation per c and without holding a
// c-wide state in registers. The product rule follows the JAX kernel's
// dtypes: fp32 products with the fp32 exp2 (every strategy); with the bf16
// exponential e = bf16(expf(bf16(bf16(x) * bf16(ln 2)))) of x = logit - m,
// 'vpu' rounds each product e * bf16(v) to bf16, 'mxu'/'mxu1' take the
// exact products e * bf16(v), and 'inbank' e * v with v in fp32 (HIGHEST
// promotes the bf16 e). 'mxu1' is 'mxu' here: s1 is the fp32 row sum either
// way. m is re-based once per 128-row bank tile, which with the bf16
// exponential is part of the function (x is rounded against the tile's m);
// the plain version re-bases at the same rows. 'inbank' reads the center
// columns col0 .. col0 + c of each bank row from device memory (the rows
// the tile just staged, so from L2) through a row stride of d. The
// per-row 'vpu' instantiations (c <= 8, fp32 exp2) are the code they were.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prune_tiles.cuh"
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

// WIDE: the wide value sums (s2 in shared memory, runtime c, `rule`; C is
// 1 and unused); FAST: the bf16 exponential (WIDE only). Otherwise the
// per-row 'vpu' sums of C channels with the fp32 exp2.
template <int C, bool WIDE, bool FAST, bool PRUNE>
__global__ void __launch_bounds__(NT) flash_score_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ bias,
    const float* __restrict__ bank, const float* __restrict__ values,
    float dotscale, const float* __restrict__ m_in,
    const float* __restrict__ s1_in, const float* __restrict__ s2_in,
    float* __restrict__ m_out, float* __restrict__ s1_out,
    float* __restrict__ s2_out, int64_t rps, int64_t P, int d,
    const int* __restrict__ mask, int64_t mask_stride, int c_wide,
    int64_t vstride, int rule) {
  static_assert(WIDE || !FAST, "the bf16 exponential runs in the wide mode");
  constexpr int VL = WIDE ? 1 : (BP * C + NT - 1) / NT;  // value elements each thread stages

  __shared__ __align__(16) float As[BK][AS];
  __shared__ __align__(16) float Bs[BK][BS];
  __shared__ float bias_s[BP];
  __shared__ float v_s[WIDE ? 1 : C][BP];
  extern __shared__ float4 dyn_smem[];  // WIDE: ValueTile
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

  // Carried state. m is the same in all 16 threads of a row; s1/s2 are
  // per-thread partial sums under that m (thread tx == 0 starts from the
  // carried values), summed across the row's threads at exit.
  float m[TM], s1[TM], s2[TM][C];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty * TM + i;
    const bool live = r < row_end;
    m[i] = live ? m_in[r] : NEG_INF;
    s1[i] = (live && tx == 0) ? s1_in[r] : 0.f;
    if constexpr (!WIDE) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        s2[i][c] = (live && tx == 0) ? s2_in[r * C + c] : 0.f;
    }
  }
  if constexpr (WIDE) vt.load_state(s2_in, row0, row_end, c_wide, tid);

  const int nk = (d + BK - 1) / BK;
  // the live bank tiles (all of them without a mask), K6
  const cdt_prune::TileWalk<BQ, BP, PRUNE> tiles(mask, mask_stride, blockIdx.x, P);

  float rq[QL], rk[KL], rb = NEG_INF, rv[VL];

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
    if (kt == 0) {
      rb = (tid < BP && p0 + tid < P) ? bias[p0 + tid] : NEG_INF;
      if constexpr (!WIDE) {
#pragma unroll
        for (int j = 0; j < VL; ++j) {
          const int e = tid + j * NT;
          rv[j] = (e < BP * C && p0 + e / C < P) ? values[p0 * C + e] : 0.f;
        }
      }
    }
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
    if (kt == 0) {
      if (tid < BP) bias_s[tid] = rb;
      if constexpr (!WIDE) {
#pragma unroll
        for (int j = 0; j < VL; ++j) {
          const int e = tid + j * NT;
          if (e < BP * C) v_s[e % C][e / C] = rv[j];
        }
      }
    }
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
        float t1 = 0.f, t2[C];
#pragma unroll
        for (int c = 0; c < C; ++c) t2[c] = 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
          const float e =
              FAST ? cdt_vals::fast_exp(lg[j] - m_safe) : exp2f(lg[j] - m_safe);
          t1 += e;
          if constexpr (WIDE) {
            vt.e[(ty * TM + i) * ValueTile::ES + col] = e;
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c) t2[c] = fmaf(e, v_s[c][col], t2[c]);
          }
        }
        s1[i] = s1[i] * scale + t1;
        if constexpr (WIDE) {
          if (tx == 0) vt.scale[ty * TM + i] = scale;
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) s2[i][c] = s2[i][c] * scale + t2[c];
        }
        m[i] = m_new;
      }
      if constexpr (WIDE) {  // s2 <- s2 * scale + e @ V of this tile
        __syncthreads();
        vt.accumulate(values, vstride, pt * BP, P, c_wide, rule, tid);
      }
    }

    __syncthreads();  // every thread is done reading this stage
    if (has_next) store(kt_next);
    __syncthreads();
    kt = kt_next;
    pt = pt_next;
  }

  // sum the per-thread partials of each row (all under the same m)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
      if constexpr (!WIDE) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          s2[i][c] += __shfl_xor_sync(0xffffffffu, s2[i][c], o);
      }
    }
    const int64_t r = row0 + ty * TM + i;
    if (tx == 0 && r < row_end) {
      m_out[r] = m[i];
      s1_out[r] = s1[i];
      if constexpr (!WIDE) {
#pragma unroll
        for (int c = 0; c < C; ++c) s2_out[r * C + c] = s2[i][c];
      }
    }
  }
  // the loop's last __syncthreads ordered every update of the shared s2
  if constexpr (WIDE) vt.store_state(s2_out, row0, row_end, c_wide, tid);
}

template <int C, bool WIDE, bool FAST>
int launch(const void* q, const void* bias, const void* bank,
           const void* values, float dotscale, const void* m_in,
           const void* s1_in, const void* s2_in, void* m_out, void* s1_out,
           void* s2_out, int64_t M, int64_t rps, int64_t P, int d,
           const int* mask, int64_t mask_stride, int c, int64_t vstride,
           int rule, cudaStream_t stream) {
  const dim3 grid((unsigned)((rps + BQ - 1) / BQ), (unsigned)(M / rps));
  auto kernel = mask != nullptr ? flash_score_f32_kernel<C, WIDE, FAST, true>
                                : flash_score_f32_kernel<C, WIDE, FAST, false>;
  size_t smem = 0;
  if constexpr (WIDE) {
    smem = ValueTile::bytes(c);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)bias, (const float*)bank,
      (const float*)values, dotscale, (const float*)m_in,
      (const float*)s1_in, (const float*)s2_in, (float*)m_out,
      (float*)s1_out, (float*)s2_out, rps, P, d, mask, mask_stride, c,
      vstride, rule);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and does not
// synchronise; returns cudaGetLastError() after the launch (0 = launched).
// bias is [M / rows_per_seed, P]; rows_per_seed = M for 1-D weights. mask is
// null or, with 1-D weights only, the int32 skip mask
// [ceil(M / PRUNE_ROWS), mask_stride] (K6, see the top). strategy: 0 'vpu',
// 1 'mxu1' (bf16 exponential only), 2 'inbank' (values may be null; V =
// bank[:, col0 : col0 + c]), 3 'mxu'; fast 1 for the bf16 exponential.
extern "C" int flash_score_f32(const void* q, const void* bias,
                               const void* bank, const void* values,
                               float dotscale, const void* m_in,
                               const void* s1_in, const void* s2_in,
                               void* m_out, void* s1_out, void* s2_out,
                               long long M, long long rows_per_seed,
                               long long P, int d, int c, const void* mask,
                               long long mask_stride, int strategy, int col0,
                               int fast, int device, void* stream) {
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
  if (!fast && strategy == 0 && c <= 8) {  // per-row 'vpu' sums
    switch (c) {
#define CDT_CASE(CC)                                                         \
  case CC:                                                                   \
    return launch<CC, false, false>(q, bias, bank, values, dotscale, m_in,   \
                                    s1_in, s2_in, m_out, s1_out, s2_out, M,  \
                                    rows_per_seed, P, d, (const int*)mask,   \
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
  // the wide value sums: V is the values [P, c] or the bank's center columns
  const bool inbank = strategy == 2;
  const void* vals = inbank ? (const void*)((const float*)bank + col0) : values;
  const int64_t vstride = inbank ? d : c;
  const int rule = !fast ? cdt_vals::V_FP32
                   : strategy == 0 ? cdt_vals::V_BF16_PRODUCT
                   : inbank ? cdt_vals::V_FP32 : cdt_vals::V_BF16;
  auto wide = fast ? launch<1, true, true> : launch<1, true, false>;
  return wide(q, bias, bank, vals, dotscale, m_in, s1_in, s2_in, m_out, s1_out,
              s2_out, M, rows_per_seed, P, d, (const int*)mask, mask_stride, c,
              vstride, rule, s);
}

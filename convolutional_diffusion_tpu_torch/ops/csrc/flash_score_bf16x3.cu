// Fused flash-score sweep, 'high' tier (bf16x3 split dot on the tensor
// cores, fp32 elementwise, per-channel value sums), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel convolutional_diffusion_tpu/ops/flash_score.py
// `_kernel` / `_kernel_body` (the one `pl.pallas_call` of that package) in
// its precision='high' variant: the manual bf16x3 QK dot (`_kernel_body`,
// the `precision != HIGHEST` branch), fp32 exp2 (fast_exp off),
// v_strategy='vpu', no prune, with 1-D weights (variant K2) or per-seed
// weights (variant K5 at this tier: 2-D w with rows_per_seed).
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
// RGB, narrowly); the elementwise work only below d_pad ~ 30 (grayscale
// k = 3). This first version issues warp-level mma.sync (m16n8k16), not
// wgmma, stages tiles with ordinary loads, not TMA, and pays seven fp32
// adds per accumulator per k16 step for the exact sum below, so it reaches
// a fraction of that rate; its design keeps the structure simple and right.
//
// Design: one thread block owns BQ = 64 query rows and loops over the whole
// chunk (the TPU grid's sequential bank axis becomes that loop; blocks run
// independently). 8 warps: warp (wr, wc) owns query rows 16*wr .. +16 and
// bank columns 64*wc .. +64 of each BP = 128-row bank tile, i.e. eight
// m16n8 accumulator tiles. d is staged BK = 32 features at a time: the next
// stage's fp32 global loads are issued into registers before the current
// stage's mma's, then split into hi/lo bf16 pairs and stored in shared
// memory (row stride 40 bf16 = 20 words, so the fragment reads are free of
// bank conflicts). d is zero-padded up to the stage width; zero features add
// exact zeros.
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
// posterior mean at the sharpest softmax (d = 867), so the kernel sums it
// exactly, and the plain version (ops/flash_score.py sweep_plain) computes
// the same exact sum in float64.
//
// The online-softmax epilogue works on the mma accumulator layout (each
// thread holds 2 rows x 16 columns of a tile): row max over the four
// threads of a quad by shuffles, then over the two column warps through
// shared memory, so every thread of a row holds the same running max;
// per-thread partial s1/s2 under that max are summed once, at exit. The carried state is read at
// entry and written once at exit. Offsets formed from row indices are
// 64-bit. Built without fast-math: exp2f and the fp32 sums stay exact fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block: 4 warp rows x 16
constexpr int BP = 128;       // bank rows per tile: 2 warp columns x 64
constexpr int BK = 32;        // features per shared-memory stage (2 k16 steps)
constexpr int NT = 256;       // threads: 8 warps
constexpr int NTILE = 8;      // m16n8 tiles per warp (64 bank columns)
constexpr int SW = BK / 2 + 4;  // shared row stride in 32-bit words (bf16 pairs)
constexpr int PAIRS = BK / 2;   // feature pairs per row per stage
constexpr int QP = BQ * PAIRS / NT;  // query pairs each thread stages (4)
constexpr int KP = BP * PAIRS / NT;  // bank pairs each thread stages (8)
constexpr float NEG_INF = -1e30f;

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

template <int C>
__global__ void __launch_bounds__(NT, 1) flash_score_bf16x3_kernel(
    const float* __restrict__ q, const float* __restrict__ bias,
    const float* __restrict__ bank, const float* __restrict__ values,
    float dotscale, const float* __restrict__ m_in,
    const float* __restrict__ s1_in, const float* __restrict__ s2_in,
    float* __restrict__ m_out, float* __restrict__ s1_out,
    float* __restrict__ s2_out, int64_t rps, int64_t P, int d) {
  constexpr int VL = (BP * C + NT - 1) / NT;  // value elements each thread stages

  __shared__ __align__(16) uint32_t Qh[BQ][SW];
  __shared__ __align__(16) uint32_t Ql[BQ][SW];
  __shared__ __align__(16) uint32_t Kh[BP][SW];
  __shared__ __align__(16) uint32_t Kl[BP][SW];
  __shared__ float bias_s[BP];
  __shared__ float v_s[C][BP];
  __shared__ float rmax_s[2][BQ];       // per-tile row max of each column warp
  __shared__ float part_s[BQ][C + 1];   // column warp 1's partial s1, s2 at exit

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
  // warp); s1/s2 are per-thread partial sums under that m, and the thread
  // (wc == 0, t4 == 0) starts from the carried values.
  const bool owner = (wc == 0 && t4 == 0);
  float m[2], s1[2], s2[2][C];
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

  const int nk = (d + BK - 1) / BK;
  const int64_t n_it = ((P + BP - 1) / BP) * nk;

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
#pragma unroll
      for (int j = 0; j < VL; ++j) {
        const int e = tid + j * NT;
        rv[j] = (e < BP * C && p0 + e / C < P) ? values[p0 * C + e] : 0.f;
      }
    }
  };
  // registers -> shared memory, split into bf16 hi/lo pairs
  auto store = [&](int kt) {
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
    }
    if (kt == 0) {
      if (tid < BP) bias_s[tid] = rb;
#pragma unroll
      for (int j = 0; j < VL; ++j) {
        const int e = tid + j * NT;
        if (e < BP * C) v_s[e % C][e / C] = rv[j];
      }
    }
  };

  float acc_hh[NTILE][4], acc_x[NTILE][4];
#pragma unroll
  for (int j = 0; j < NTILE; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_hh[j][e] = acc_x[j][e] = 0.f;

  if (n_it > 0) {
    load(0, 0);
    store(0);
  }
  __syncthreads();

  int kt = 0;
  int64_t pt = 0;
  for (int64_t it = 0; it < n_it; ++it) {
    const bool has_next = it + 1 < n_it;
    const int kt_next = (kt + 1 == nk) ? 0 : kt + 1;
    const int64_t pt_next = (kt + 1 == nk) ? pt + 1 : pt;
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
      float m_safe[2], t1[2], t2[2][C];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new =
            fmaxf(m[i], fmaxf(rmax_s[0][lr[i]], rmax_s[1][lr[i]]));
        m_safe[i] = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
        const float scale =
            (m[i] <= NEG_INF * 0.5f) ? 0.f : exp2f(m[i] - m_safe[i]);
        s1[i] *= scale;
#pragma unroll
        for (int c = 0; c < C; ++c) s2[i][c] *= scale;
        m[i] = m_new;
        t1[i] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) t2[i][c] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = wc * 64 + j * 8 + 2 * t4 + (e & 1);
          const float lg =
              fmaf(acc_hh[j][e] + acc_x[j][e], dotscale, bias_s[col]);
          const float ex = exp2f(lg - m_safe[i]);
          t1[i] += ex;
#pragma unroll
          for (int c = 0; c < C; ++c) t2[i][c] = fmaf(ex, v_s[c][col], t2[i][c]);
          acc_hh[j][e] = 0.f;
          acc_x[j][e] = 0.f;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s1[i] += t1[i];
#pragma unroll
        for (int c = 0; c < C; ++c) s2[i][c] += t2[i][c];
      }
    }

    __syncthreads();  // every thread is done reading this stage (and rmax_s)
    if (has_next) store(kt_next);
    __syncthreads();
    kt = kt_next;
    pt = pt_next;
  }

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

template <int C>
void launch(const void* q, const void* bias, const void* bank,
            const void* values, float dotscale, const void* m_in,
            const void* s1_in, const void* s2_in, void* m_out, void* s1_out,
            void* s2_out, int64_t M, int64_t rps, int64_t P, int d,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((rps + BQ - 1) / BQ), (unsigned)(M / rps));
  flash_score_bf16x3_kernel<C><<<grid, NT, 0, stream>>>(
      (const float*)q, (const float*)bias, (const float*)bank,
      (const float*)values, dotscale, (const float*)m_in,
      (const float*)s1_in, (const float*)s2_in, (float*)m_out,
      (float*)s1_out, (float*)s2_out, rps, P, d);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and does not
// synchronise; returns cudaGetLastError() after the launch (0 = launched).
// bias is [M / rows_per_seed, P]; rows_per_seed = M for 1-D weights.
extern "C" int flash_score_bf16x3(const void* q, const void* bias,
                                  const void* bank, const void* values,
                                  float dotscale, const void* m_in,
                                  const void* s1_in, const void* s2_in,
                                  void* m_out, void* s1_out, void* s2_out,
                                  long long M, long long rows_per_seed,
                                  long long P, int d, int c, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaSuccess;
  if (rows_per_seed <= 0 || M % rows_per_seed != 0 ||
      M / rows_per_seed > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
#define CDT_CASE(CC)                                                        \
  case CC:                                                                  \
    launch<CC>(q, bias, bank, values, dotscale, m_in, s1_in, s2_in, m_out, \
               s1_out, s2_out, M, rows_per_seed, P, d, s);                  \
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

// The split-bank grid shared by the per-row sweeps of K1 (flash_score.cu)
// and K2 (flash_score_bf16x3.cu): what lets a sweep over one bank chunk
// fill all the SMs of the card when its query count alone would not.
//
// The TPU kernel (convolutional_diffusion_tpu/ops/flash_score.py
// `_kernel`) walks the bank axis as the sequential axis of its grid,
// carrying the online-softmax state (m, s1, s2) from one bank block to the
// next. On Hopper a block that owns a query block and walks the whole
// chunk gives M / BQ blocks: 128 at M = 8192, fewer than the 132 SMs, one
// block of 8 warps on each. So the chunk's bank axis is also cut into
// `nsplit` contiguous ranges of `split_rows` rows (a multiple of
// PRUNE_BLOCK, so of every kernel's bank tile and of the prune cell;
// ops/flash_score.py `split_plan` chooses it from P alone), one block per
// (query block, seed, split). Each block starts from the empty state and
// writes its partial state (m, s1, s2[0..c)) to the scratch
// [nsplit][M][2 + c] the wrapper allocates; `merge_splits` then folds the
// partials into the carried state in split order, one thread per row: no
// float atomics, so a launch is deterministic. A split whose tiles were
// all skipped, or whose logits are all -1e30, leaves m at the sentinel;
// the merge passes over it, and a row with no live partial gets its
// carried state through bit for bit.
//
// Also here: the cp.async helpers of the pipelined staging, and the tile
// walk of a split (`split_tiles`): every tile with 1-D weights; with
// per-seed weights (variant K5) only the tiles the block's seed admits,
// from the flags `live_tiles` writes once per launch; under a prune mask
// (variant K6) only the tiles some mask row of the block keeps. A tile
// that is left out is one whose logits are all at or below the -1e30
// sentinel for the rows concerned (a bias of -1e30 or below: fmaf(dot,
// dotscale, -1e30) rounds to -1e30 for any |dot * dotscale| < 2^75; a
// masked cell is -1e30 by definition): such a tile leaves (m, s1, s2) bit
// for bit as it was (m does not move, its exponentials are 0 and the
// rescale factor is 1, or 0 on an empty row, whose sums are 0), so
// skipping it changes no bit of a launch, in any epilogue, the bf16
// exponential's per-tile re-basing of m included.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(PRUNE_ROWS) || !defined(PRUNE_BLOCK)
#error "PRUNE_ROWS and PRUNE_BLOCK come from ops/_build.py's nvcc flags"
#endif

namespace cdt_splitbank {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `bytes` (4 or 16) from src to shared dst, asynchronously; zeros where
// !valid (src is then not read, and `base` stands in for it)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         const void* base, bool valid) {
  static_assert(BYTES == 4 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(valid ? src : base), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(valid ? src : base), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bank tiles of BP rows that a block of BQ query rows walks in its
// split, tiles [pt_begin, pt_end): without LIST all of them, entry i being
// tile pt_begin + i (1-D weights). With LIST, `split_tiles` lists in shared
// memory, in order, the tiles the block walks, each as tile * 4 + flags:
//  - per-seed weights (K5): the tiles whose `live_tiles` flag is set for the
//    block's seed (a block never mixes seeds), flags 0;
//  - a prune mask (K6): the block's query rows fall in ROWS mask rows of the
//    int32 mask [n_mask_rows, stride] (one flag per PRUNE_ROWS query rows
//    and PRUNE_BLOCK bank rows; 1 = skip; rows past the mask's end, query
//    rows past M, count as set); the tiles some mask row keeps, flag bit r
//    set where mask row r skips the tile. Inside a listed tile the rows of
//    a mask row that skips it take the logits of a staged bias of -inf (K1,
//    whose 128-row block spans two mask rows; `skipped`), which give the
//    row max and the exponentials that the plain version's -1e30 masked
//    cells give, bit for bit; a 64-row block is one mask row, so a listed
//    tile is never skipped there.
// The list is built once per block by all its threads, so the pipelined
// loop reads no mask or flag in device memory and keeps no pointer to one.
template <int BQ, int BP, bool LIST>
struct SplitTiles {
  static_assert(PRUNE_ROWS % BQ == 0 || BQ % PRUNE_ROWS == 0,
                "a query block lies in one mask row or covers whole ones");
  static_assert(PRUNE_BLOCK % BP == 0, "a bank tile lies in one prune cell");
  static constexpr int ROWS = BQ > PRUNE_ROWS ? BQ / PRUNE_ROWS : 1;
  static_assert(ROWS <= 2, "two flag bits per entry");

  int begin;        // the split's first tile
  int n;            // tiles to walk
  const int* list;  // LIST: the entries, in shared memory

  // bank tile of entry i
  __device__ __forceinline__ int64_t tile(int i) const {
    return LIST ? (int64_t)(list[i] >> 2) : (int64_t)begin + i;
  }
  // whether mask row r of the block skips entry i (K6 with two mask rows)
  __device__ __forceinline__ bool skipped(int i, int r) const {
    return LIST && ROWS > 1 && ((list[i] >> r) & 1);
  }
};

constexpr int LIST_WARPS = 8;  // warps of the blocks that build a tile list

// shared-memory ints `split_tiles` needs for a split of up to `rows` bank
// rows (LIST): the warps' counts, the entries' count, the entries
template <int BP>
__host__ __forceinline__ size_t split_tiles_ints(int64_t rows) {
  return (size_t)((rows + BP - 1) / BP) + 1 + LIST_WARPS;
}

// Every thread of the block (NT = 32 LIST_WARPS) calls it. LIST: `room` is
// split_tiles_ints ints of shared memory; one of `mask` (K6) and `live`
// (K5: the block's seed's row of the `live_tiles` flags, indexed by tile)
// is set. The threads take NT tiles at a time, count the walked ones per
// warp by ballots, and write them in order. Ends with a barrier when LIST
// and the split has tiles.
template <int BQ, int BP, bool LIST, int NT>
__device__ __forceinline__ SplitTiles<BQ, BP, LIST> split_tiles(
    const int* __restrict__ mask, int64_t stride, const int* __restrict__ live,
    int64_t row0, int64_t n_mask_rows, int64_t pt_begin, int64_t pt_end, int* room) {
  using T = SplitTiles<BQ, BP, LIST>;
  const int nt = (int)(pt_end - pt_begin);
  if constexpr (!LIST) {
    return T{(int)pt_begin, nt, nullptr};
  } else {
    static_assert(NT == 32 * LIST_WARPS, "one count per warp");
    constexpr int64_t PER = PRUNE_BLOCK / BP;  // tiles per prune cell
    constexpr int NONE = (1 << T::ROWS) - 1;   // flags of a tile no row walks
    int* const counts = room;
    int* const list = room + LIST_WARPS + 1;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int n = 0;
    for (int base = 0; base < nt; base += NT) {
      const int i = base + tid;
      const int64_t pt = pt_begin + i;
      int f = NONE;
      if (i < nt) {
        if (mask != nullptr) {
          f = 0;
#pragma unroll
          for (int r = 0; r < T::ROWS; ++r) {
            const int64_t mr = row0 / PRUNE_ROWS + r;
            if (mr >= n_mask_rows || mask[mr * stride + pt / PER] != 0) f |= 1 << r;
          }
        } else {
          f = live[pt] != 0 ? 0 : NONE;
        }
      }
      const bool walked = f != NONE;
      const unsigned b = __ballot_sync(0xffffffffu, walked);
      if (lane == 0) counts[warp] = __popc(b);
      __syncthreads();
      int at = n;
#pragma unroll
      for (int w = 0; w < LIST_WARPS; ++w) {
        const int cw = counts[w];
        if (w < warp) at += cw;
        n += cw;
      }
      if (walked) list[at + __popc(b & ((1u << lane) - 1u))] = (int)pt * 4 + f;
      __syncthreads();  // the counts are read; at the end, the list is written
    }
    return T{(int)pt_begin, n, list};
  }
}

// The list `split_tiles` makes (LIST), built by the one warp that calls it
// (the warp-specialised loop's producer warp, before its block's roles
// split; no barrier inside): the entries into `list`, in order, 32 tiles a
// ballot; returns their count to every lane. ROWS flag bits as there.
template <int BQ, int BP>
__device__ __forceinline__ int warp_list_tiles(const int* __restrict__ mask, int64_t stride,
                                               const int* __restrict__ live, int64_t row0,
                                               int64_t n_mask_rows, int64_t pt_begin,
                                               int64_t pt_end, int* list) {
  using T = SplitTiles<BQ, BP, true>;
  constexpr int64_t PER = PRUNE_BLOCK / BP;
  constexpr int NONE = (1 << T::ROWS) - 1;
  const int nt = (int)(pt_end - pt_begin);
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < nt; base += 32) {
    const int i = base + lane;
    const int64_t pt = pt_begin + i;
    int f = NONE;
    if (i < nt) {
      if (mask != nullptr) {
        f = 0;
#pragma unroll
        for (int r = 0; r < T::ROWS; ++r) {
          const int64_t mr = row0 / PRUNE_ROWS + r;
          if (mr >= n_mask_rows || mask[mr * stride + pt / PER] != 0) f |= 1 << r;
        }
      } else {
        f = live[pt] != 0 ? 0 : NONE;
      }
    }
    const unsigned b = __ballot_sync(0xffffffffu, f != NONE);
    if (f != NONE) list[n + __popc(b & ((1u << lane) - 1u))] = (int)pt * 4 + f;
    n += __popc(b);
  }
  return n;
}

// Per-seed weights (K5): live[s * nt + t] = 1 where some entry of
// bias[s, t BP .. min(P, t BP + BP)) lies above the -1e30 sentinel (a NaN
// counts as live: the walk keeps what it cannot prove empty), else 0; nt =
// ceil(P / BP). The wrapper folds log2(w) into the bias with -1e30 where
// w = 0, so a dead tile is one whose patches the seed's weights exclude.
// One warp per (seed, tile), 32 consecutive entries a load.
template <int BP>
__global__ void live_tiles_kernel(const float* __restrict__ bias, int64_t S, int64_t P,
                                  int* __restrict__ live) {
  const int64_t nt = (P + BP - 1) / BP;
  const int lane = threadIdx.x & 31;
  const int64_t stride = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t wi = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; wi < S * nt;
       wi += stride) {
    const int64_t s = wi / nt, p0 = (wi % nt) * BP;
    bool any = false;
#pragma unroll
    for (int j = lane; j < BP; j += 32)
      if (p0 + j < P) any |= !(bias[s * P + p0 + j] <= NEG_INF);
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) live[wi] = any ? 1 : 0;
  }
}

template <int BP>
inline cudaError_t live_tiles(const void* bias, int64_t S, int64_t P, int* live,
                              cudaStream_t stream) {
  constexpr int T = 256;
  const int64_t warps = S * ((P + BP - 1) / BP);
  if (warps <= 0) return cudaSuccess;
  const int64_t blocks = (warps * 32 + T - 1) / T;
  live_tiles_kernel<BP><<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), T, 0, stream>>>(
      (const float*)bias, S, P, live);
  return cudaGetLastError();
}

// The splits of a chunk of P bank rows: ceil(P / split_rows), at least one.
__host__ __device__ __forceinline__ int64_t n_splits(int64_t P, int64_t split_rows) {
  return P <= 0 ? 1 : (P + split_rows - 1) / split_rows;
}

// Whether split_rows is a plan the kernels take for a chunk of P rows: the
// whole chunk, or whole prune cells (so whole tiles), at most 65535 splits
// (the grid's z).
__host__ __forceinline__ bool valid_split(int64_t P, int64_t split_rows) {
  if (P > 0 && split_rows < P && (split_rows <= 0 || split_rows % PRUNE_BLOCK != 0))
    return false;
  return n_splits(P, split_rows) <= 65535;
}

// Fold the partial states part [nsplit][M][2 + c] (m, s1, s2) into the
// carried state, in split order, one thread per row:
//   m   = max(m_in, m_j)
//   s1  = s1_in * 2^(m_in - m) + sum_j s1_j * 2^(m_j - m)
//   s2  likewise per channel,
// with the sentinel guards of the sweep (a term whose m is at the
// sentinel adds nothing). A row whose partials are all at the sentinel is
// its carried state, bit for bit. c is a runtime count (the per-row sums'
// c <= 8 and the wide sums' c <= 256 alike): each channel repeats the
// split loop, with the same factors, so every sum takes the same steps.
__global__ void merge_splits_kernel(const float* __restrict__ m_in,
                                    const float* __restrict__ s1_in,
                                    const float* __restrict__ s2_in,
                                    const float* __restrict__ part,
                                    float* __restrict__ m_out,
                                    float* __restrict__ s1_out,
                                    float* __restrict__ s2_out, int64_t M,
                                    int nsplit, int c) {
  const int64_t W = 2 + c;
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const float m0 = m_in[r];
  float m = m0;
  bool any = false;
  for (int j = 0; j < nsplit; ++j) {
    const float mj = part[((int64_t)j * M + r) * W];
    any = any || mj > NEG_INF * 0.5f;
    m = fmaxf(m, mj);
  }
  if (!any) {
    m_out[r] = m0;
    s1_out[r] = s1_in[r];
    for (int ch = 0; ch < c; ++ch) s2_out[r * c + ch] = s2_in[r * c + ch];
    return;
  }
  const float f0 = m0 <= NEG_INF * 0.5f ? 0.f : exp2f(m0 - m);
  // sum k: s1 (k = 0) or channel k - 1 of s2
  for (int k = 0; k <= c; ++k) {
    float s = (k == 0 ? s1_in[r] : s2_in[r * c + k - 1]) * f0;
    for (int j = 0; j < nsplit; ++j) {
      const float* pj = part + ((int64_t)j * M + r) * W;
      if (!(pj[0] > NEG_INF * 0.5f)) continue;
      s = fmaf(pj[1 + k], exp2f(pj[0] - m), s);
    }
    if (k == 0) s1_out[r] = s;
    else s2_out[r * c + k - 1] = s;
  }
  m_out[r] = m;
}

inline cudaError_t merge_splits(const void* m_in, const void* s1_in, const void* s2_in,
                                const float* part, void* m_out, void* s1_out,
                                void* s2_out, int64_t M, int nsplit, int c,
                                cudaStream_t stream) {
  constexpr int T = 256;
  merge_splits_kernel<<<(unsigned)((M + T - 1) / T), T, 0, stream>>>(
      (const float*)m_in, (const float*)s1_in, (const float*)s2_in, part,
      (float*)m_out, (float*)s1_out, (float*)s2_out, M, nsplit, c);
  return cudaGetLastError();
}

}  // namespace cdt_splitbank

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
// walk of a split under a prune mask (variant K6) for blocks of any number
// of PRUNE_ROWS mask rows.

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
// split, tiles [pt_begin, pt_end): without PRUNE all of them, entry i being
// tile pt_begin + i. With PRUNE (variant K6) the block's query rows fall in
// ROWS mask rows of the int32 mask [n_mask_rows, stride] (one flag per
// PRUNE_ROWS query rows and PRUNE_BLOCK bank rows; 1 = skip; rows past the
// mask's end, query rows past M, count as set), and `split_tiles` lists in
// shared memory, in order, the tiles some mask row keeps, each as
// tile * 4 + flags (bit r: mask row r skips it). Inside a listed tile the
// rows of a mask row that skips it take -1e30 logits, which is what the
// plain version's masked cells give. The list is built once per block by
// one warp, so the pipelined loop reads no mask and keeps no mask pointer.
template <int BQ, int BP, bool PRUNE>
struct SplitTiles {
  static_assert(PRUNE_ROWS % BQ == 0 || BQ % PRUNE_ROWS == 0,
                "a query block lies in one mask row or covers whole ones");
  static_assert(PRUNE_BLOCK % BP == 0, "a bank tile lies in one prune cell");
  static constexpr int ROWS = BQ > PRUNE_ROWS ? BQ / PRUNE_ROWS : 1;
  static_assert(ROWS <= 2, "two flag bits per entry");

  int begin;        // the split's first tile
  int n;            // tiles to walk
  const int* list;  // PRUNE: the entries, in shared memory

  // bank tile of entry i
  __device__ __forceinline__ int64_t tile(int i) const {
    return PRUNE ? (int64_t)(list[i] >> 2) : (int64_t)begin + i;
  }
  // whether mask row r skips entry i
  __device__ __forceinline__ bool skipped(int i, int r) const {
    return PRUNE && ((list[i] >> r) & 1);
  }
};

// shared-memory ints `split_tiles` needs for a split of up to `rows` bank
// rows (PRUNE): the entries and their count
template <int BP>
__host__ __forceinline__ size_t split_tiles_ints(int64_t rows) {
  return (size_t)((rows + BP - 1) / BP) + 1;
}

// Every thread of the block calls it; `room` is split_tiles_ints ints of
// shared memory (PRUNE). Ends with a barrier when PRUNE.
template <int BQ, int BP, bool PRUNE>
__device__ __forceinline__ SplitTiles<BQ, BP, PRUNE> split_tiles(
    const int* __restrict__ mask, int64_t stride, int64_t row0,
    int64_t n_mask_rows, int64_t pt_begin, int64_t pt_end, int* room) {
  using T = SplitTiles<BQ, BP, PRUNE>;
  const int nt = (int)(pt_end - pt_begin);
  if constexpr (!PRUNE) {
    return T{(int)pt_begin, nt, nullptr};
  } else {
    constexpr int64_t PER = PRUNE_BLOCK / BP;  // tiles per prune cell
    int* const list = room + 1;
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int n = 0;
      for (int base = 0; base < nt; base += 32) {
        const int i = base + lane;
        int f = 0;
        if (i < nt) {
#pragma unroll
          for (int r = 0; r < T::ROWS; ++r) {
            const int64_t mr = row0 / PRUNE_ROWS + r;
            if (mr >= n_mask_rows || mask[mr * stride + (pt_begin + i) / PER] != 0) f |= 1 << r;
          }
        }
        const bool live = i < nt && f != (1 << T::ROWS) - 1;
        const unsigned b = __ballot_sync(0xffffffffu, live);
        if (live) list[n + __popc(b & ((1u << lane) - 1u))] = (int)(pt_begin + i) * 4 + f;
        n += __popc(b);
      }
      if (lane == 0) room[0] = n;
    }
    __syncthreads();
    return T{(int)pt_begin, room[0], list};
  }
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

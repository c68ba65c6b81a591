// The prune skip bit (variant K6) shared by the flash-score kernels: which
// bank tiles a thread block visits. The int32 mask [ceil(M / PRUNE_ROWS),
// stride] holds one flag per PRUNE_ROWS query rows and PRUNE_BLOCK bank
// rows (1 = skip; ops/prune.py builds it, ops/_build.py passes both sizes
// as -D flags, and the plain version reads the same values). A kernel's
// query block and bank tile nest in that cell, so a block reads one mask
// row and a tile one flag.
//
// The mask is a compile-time flag of the kernels (template parameter
// PRUNE): the instantiation without it walks every tile in order, with no
// mask read and no skip test in its loop, so an unmasked launch runs the
// loop it ran before the skip bit existed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(PRUNE_ROWS) || !defined(PRUNE_BLOCK)
#error "PRUNE_ROWS and PRUNE_BLOCK come from ops/_build.py's nvcc flags"
#endif

namespace cdt_prune {

// The bank tiles of BP rows a block walks: tile pt holds bank rows
// pt * BP .. pt * BP + BP - 1, all inside prune block pt / (PRUNE_BLOCK / BP).
template <int BQ, int BP, bool PRUNE>
struct TileWalk {
  static_assert(PRUNE_ROWS % BQ == 0, "a query block lies in one mask row");
  static_assert(PRUNE_BLOCK % BP == 0, "a bank tile lies in one prune block");
  static constexpr int64_t PER = PRUNE_BLOCK / BP;  // tiles per prune block

  const int* row;  // the block's mask row (PRUNE only)
  int64_t n_pt;    // tiles in the chunk

  // query block `qblock` of a chunk of P bank rows, with the mask (PRUNE)
  __device__ __forceinline__ TileWalk(const int* mask, int64_t stride,
                                      int64_t qblock, int64_t P)
      : row(PRUNE ? mask + (qblock * BQ / PRUNE_ROWS) * stride : nullptr),
        n_pt((P + BP - 1) / BP) {}

  // the first tile >= pt whose flag is 0, or n_pt if there is none (pt <=
  // n_pt); a set flag skips its whole prune block at once. Without PRUNE,
  // pt itself.
  __device__ __forceinline__ int64_t live(int64_t pt) const {
    if constexpr (PRUNE) {
      while (pt < n_pt && row[pt / PER] != 0) pt = (pt / PER + 1) * PER;
      return pt < n_pt ? pt : n_pt;
    } else {
      return pt;
    }
  }
};

}  // namespace cdt_prune

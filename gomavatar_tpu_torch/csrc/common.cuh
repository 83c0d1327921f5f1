// What the kernels of this directory share: the tile and chunk geometry,
// the round-to-nearest arithmetic that keeps them bit-equal to their plain
// versions, and the rule that maps a chunk of the entry buffer to its tile.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;  // pixels of a tile
constexpr int CHUNK = 128;      // entries of a chunk

// Round-to-nearest multiply, add and subtract, which the compiler never
// contracts into FMAs: each rounds exactly as the plain version's separate
// operation does.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The tile whose swept segment (the first min(tile_count / CHUNK, ncmax)
// chunks from tile_start) holds chunk `slot` of the entry buffer, or -1
// when none does; the lowest tile id if several did.  Binning lays the
// non-empty tiles' segments out back to back, and buffer clamping makes
// only EMPTY tiles share a tile_start; an empty tile sweeps no chunk, so a
// swept slot has one owner, as in a kernel that runs one block per tile.
// Every thread of the block calls it; `s_owner` is a shared int.
__device__ inline int owner_of(long long slot, const int32_t* __restrict__ tile_start,
                        const int32_t* __restrict__ tile_count, int num_tiles, int ncmax, int* s_owner) {
  if (threadIdx.x == 0) *s_owner = INT_MAX;
  __syncthreads();
  for (int i = threadIdx.x; i < num_tiles; i += blockDim.x) {
    const int n = min(tile_count[i] / CHUNK, ncmax);
    const long long s0 = tile_start[i] / CHUNK;
    if (n > 0 && slot >= s0 && slot < s0 + n) atomicMin(s_owner, i);
  }
  __syncthreads();
  const int t = *s_owner;
  return t == INT_MAX ? -1 : t;
}

}  // namespace

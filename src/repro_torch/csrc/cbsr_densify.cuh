// Warp-level CBSR row scatter shared by the DR-SpMM kernels.
//
// A CBSR row is k (value, column) pairs; zero-value duplicates of column 0
// are legal padding.  A warp owns one dense row of at most 32*DPL columns:
// lane l owns columns l, l+32, ..., so every column has exactly one writer
// and the row is summed without atomics, in a fixed order.
#pragma once

#include <cuda_runtime.h>

constexpr unsigned kFullMask = 0xffffffffu;

// Broadcast scatter, any k: the pairs are loaded 32 at a time (one per
// lane) and broadcast with __shfl_sync; each lane adds the pairs that land
// on its own columns, in pair order, so repeated columns all accumulate.
// acc[j] (column lane + 32*j) += scale * densify(vals, cols).  Every lane
// of the warp must call it.
template <int DPL>
__device__ __forceinline__ void accumulate_cbsr_row(
    float (&acc)[DPL], const float* __restrict__ vals,
    const int* __restrict__ cols, int k, float scale, int lane) {
  for (int t0 = 0; t0 < k; t0 += 32) {
    const int t = t0 + lane;
    float my_p = 0.f;
    int my_c = -1;
    if (t < k) {
      my_p = scale * vals[t];
      my_c = cols[t];
    }
    const int nt = min(32, k - t0);
    for (int s = 0; s < nt; ++s) {
      const float p = __shfl_sync(kFullMask, my_p, s);
      const int c = __shfl_sync(kFullMask, my_c, s);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        if (c == lane + 32 * j) acc[j] += p;
      }
    }
  }
}

// Permutation scatter of one row of at most 32 pairs already in registers
// (lane t holds pair t: value p, column c; idle lanes hold p = 0).  Each
// lane with a non-zero pair records itself as the owner of its column in
// the warp's shared-memory table ``owner`` (32*DPL ints, all -1 on entry and
// on exit); every lane then pulls the pair of each of its columns with one
// shuffle -- a few shared-memory operations per row instead of 32
// broadcasts.  Zero-valued pairs add nothing and are skipped; columns
// outside [0, dim) match no output column.  If non-zero pairs repeat a
// column (the table read-back shows a lost write), the row falls back to
// the broadcast order, adding every pair.  Every lane must call it.
template <int DPL>
__device__ __forceinline__ void scatter_row_pairs(float (&acc)[DPL],
                                                  int* owner, float p, int c,
                                                  int dim, int lane) {
  const bool act = p != 0.f && (unsigned)c < (unsigned)dim;
  if (!__any_sync(kFullMask, act)) return;
  if (act) owner[c] = lane;
  __syncwarp();
  const bool lost = act && owner[c] != lane;
  if (__any_sync(kFullMask, lost)) {
    __syncwarp();
    if (act) owner[c] = -1;
    __syncwarp();
    for (int s = 0; s < 32; ++s) {
      const float ps = __shfl_sync(kFullMask, p, s);
      const int cs = __shfl_sync(kFullMask, c, s);
      if (ps != 0.f) {
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          if (cs == lane + 32 * j) acc[j] += ps;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int o = owner[lane + 32 * j];
    const float q = __shfl_sync(kFullMask, p, o & 31);
    if (o >= 0) acc[j] += q;
  }
  __syncwarp();
  if (act) owner[c] = -1;
  __syncwarp();
}

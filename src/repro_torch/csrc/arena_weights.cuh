// Weight sources of the arena walks (arena_fwd_walk.cuh,
// arena_bwd_walk.cuh): where the weight of arena slot s comes from.
//
//  * FixedWeights: the arena's own fp32 table w[s] (0 on padding), the
//    fixed-weight DR-SpMM kernels;
//  * CanonWeights: a canonical per-edge weight vector gathered through the
//    arena's edge-id table, wc[eid[s]] with eid -1 (padding) giving 0, the
//    learnable-edge kernels.  The gather happens in the kernel, so no
//    arena-shaped weight copy is ever written.
#pragma once

#include <cuda_runtime.h>

struct FixedWeights {
  const float* __restrict__ w;
  __device__ __forceinline__ float operator()(long long s) const {
    return w[s];
  }
};

struct CanonWeights {
  const int* __restrict__ eid;
  const float* __restrict__ wc;
  __device__ __forceinline__ float operator()(long long s) const {
    const int id = eid[s];
    return id >= 0 ? wc[id] : 0.f;
  }
};

// The two loads of a slot's weight, so that the wide walks can issue the
// first (the weight itself, or the slot's edge id) one window before the
// second (nothing, or the gather of w_canon at that id).  pad() is the first
// stage of a slot past the run's end; its weight is 0.
template <class W> struct WeightStages;

template <> struct WeightStages<FixedWeights> {
  using Raw = float;
  __device__ static Raw pad() { return 0.f; }
  __device__ static Raw first(const FixedWeights& w, long long s) {
    return w.w[s];
  }
  __device__ static float second(const FixedWeights&, Raw x) { return x; }
};

template <> struct WeightStages<CanonWeights> {
  using Raw = int;
  __device__ static Raw pad() { return -1; }
  __device__ static Raw first(const CanonWeights& w, long long s) {
    return w.eid[s];
  }
  __device__ static float second(const CanonWeights& w, Raw id) {
    return id >= 0 ? w.wc[id] : 0.f;
  }
};

// Slot s of the chunk run that starts at chunk c0, for row r of a block of
// br rows (ec = 1 << sh slots a chunk row): its neighbour, and its weight's
// first stage in ``raw``.  A slot at or past n is padding.
template <class W>
__device__ __forceinline__ int run_slot(const int* __restrict__ nbr,
                                        const W& wsrc, int s, int n, int c0,
                                        int br, int r, int sh,
                                        typename WeightStages<W>::Raw& raw) {
  raw = WeightStages<W>::pad();
  if (s >= n) return 0;
  const long long a =
      (((long long)(c0 + (s >> sh)) * br + r) << sh) + (s & ((1 << sh) - 1));
  raw = WeightStages<W>::first(wsrc, a);
  return nbr[a];
}

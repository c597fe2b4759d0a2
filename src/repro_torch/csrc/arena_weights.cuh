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

// DR-SpMM arena forward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_fwd_fused (src/repro/kernels/drspmm.py),
// entered through drspmm_fwd_multi for a relation plan's super-arena:
//
//   Y[blk*BR + r] = sum over the block's chunks c, slots e of
//                   w[c,r,e] * densify(x_vals[nbr[c,r,e]], x_idx[nbr[c,r,e]])
//
// The row walk, its bound on the H100 and what its design does about it
// are in arena_fwd_walk.cuh; here the weights are the arena's own table.
// ``sched`` is the arena's launch order (drspmm.py, _arena_sched).
#include "arena_fwd_walk.cuh"

extern "C" int drspmm_arena_fwd(const int* sched,
                                const int* nbr, const float* w,
                                const float* xv, const int* xi, float* out,
                                int n_blocks, int row_block, int ec, int k,
                                int dim, cudaStream_t stream) {
  return arena_fwd_dispatch(sched, nbr, FixedWeights{w}, xv, xi,
                            out, n_blocks, row_block, ec, k, dim, stream);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

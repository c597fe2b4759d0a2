// Learnable-edge DR-SpMM arena forward for Hopper (sm_90a).
//
// Replaces the TPU kernel drspmm_fwd_learnable_fused
// (src/repro/kernels/drspmm.py): the arena forward of an edge-id arena
// whose weights are a canonical per-edge vector, differentiable upstream,
//
//   Y[blk*BR + r] = sum over the block's chunks c, slots e of
//                   w_canon[eid[c,r,e]] * densify(x_vals[nbr], x_idx[nbr])
//
// with eid -1 (padding) weighing 0.  It is kernel drspmm_arena_fwd.cu with
// the weight gathered in the kernel (CanonWeights, arena_weights.cuh): the
// row walk, its bound and its design are in arena_fwd_walk.cuh.  The
// homogeneous GAT baselines call it with a dense operand written as CBSR
// (k = dim, x_idx = iota); it takes any CBSR operand, repeated columns
// included.  The gather adds one dependent load per chunk row (eid, then
// w_canon at it); w_canon (4 bytes an edge) stays in L2.
#include "arena_fwd_walk.cuh"

extern "C" int drspmm_learnable_fwd(const int* sched,
                                    const int* nbr, const int* eid,
                                    const float* w_canon, const float* xv,
                                    const int* xi, float* out, int n_blocks,
                                    int row_block, int ec, int k, int dim,
                                    cudaStream_t stream) {
  return arena_fwd_dispatch(sched, nbr, CanonWeights{eid, w_canon},
                            xv, xi, out, n_blocks, row_block, ec, k, dim,
                            stream);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
